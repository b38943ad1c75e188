"""End to end: the JAX CLI trains and saves a checkpoint; the port's CLI
and Python API serve it (--device cpu) and must agree with the JAX CLI's
serve-only run on the same checkpoint: the same `eval loss`/`eval auc` line,
eval numbers within 1e-5, and predictions equal line by line within 2e-6
(one unit in the sixth decimal, plus a rounding flip)."""

import functools
import io
import sys

import numpy as np
import pytest
import torch

import ftrl_ffm_tpu.ops.ffm_pallas as fp
from ftrl_ffm_tpu.cli import main as jax_main
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.io.checkpoint import load_checkpoint as j_load
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch.cli import main as torch_main
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint, state_from_jax_arrays
from ftrl_ffm_tpu_torch.train import Trainer
from tests.test_torch_models import write_7field

MODEL_FLAGS = [
    "--model_type", "FFM", "--n_fields", "7", "--n_factors", "16",
    "--n_feats", "60", "--batch_size", "16",
    "--w_alpha", "0.05", "--w_l1", "0.15", "--w_l2", "1.0",
]
SHAPE = dict(
    model_type="FFM", n_fields=7, n_factors=16, n_feats=60, batch_size=16,
    w_alpha=0.05, w_l1=0.15, w_l2=1.0,
)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Train two epochs with the JAX CLI, then serve the checkpoint with
    both CLIs: (paths, JAX eval line, port eval line)."""
    d = tmp_path_factory.mktemp("serve")
    train = write_7field(d / "train.ffm", n=64, seed=0)
    evald = write_7field(d / "eval.ffm", n=50, seed=1)
    ckpt = str(d / "model.ckpt")
    assert jax_main(
        ["--train_data", train, "--n_epochs", "2", "--model_path", ckpt, *MODEL_FLAGS]
    ) == 0
    lines = {}
    for name, main, extra in (
        ("jax", jax_main, []),
        ("torch", torch_main, ["--device", "cpu"]),
    ):
        out = io.StringIO()
        old, sys.stdout = sys.stdout, out
        try:
            rc = main([
                "--load_model", ckpt, "--eval_data", evald,
                "--predict_data", evald, "--predict_output", str(d / f"{name}.txt"),
                *MODEL_FLAGS, *extra,
            ])
        finally:
            sys.stdout = old
        assert rc == 0
        lines[name] = [l for l in out.getvalue().splitlines() if l.startswith("eval")]
    return d, ckpt, evald, lines


def test_cli_eval_line_matches_jax(served):
    _, _, _, lines = served
    assert len(lines["jax"]) == 1 and lines["jax"][0].startswith("eval loss: ")
    assert lines["torch"] == lines["jax"]


def test_cli_predictions_match_jax(served):
    d = served[0]
    ref = (d / "jax.txt").read_text().splitlines()
    got = (d / "torch.txt").read_text().splitlines()
    assert len(got) == len(ref) == 50
    assert all(len(l) == 8 for l in got)  # "%.6f" of a probability
    np.testing.assert_allclose(
        np.array(got, np.float64), np.array(ref, np.float64), rtol=0, atol=2e-6
    )


def _trainers(ckpt, evald, **kw):
    jstate, _ = j_load(ckpt)
    jtr = JTrainer(JConfig(eval_data=evald, **SHAPE, **kw), state=jstate)
    tstate, _ = load_checkpoint(ckpt)
    ttr = Trainer(
        TConfig(eval_data=evald, device="cpu", **SHAPE, **kw),
        state=state_from_jax_arrays(tstate, "cpu"),
    )
    return jtr, ttr


@pytest.mark.parametrize(
    "kw", [{}, {"online": False}, {"auc_mode": "exact"}, {"eval_auc": False}]
)
def test_api_evaluate_matches_jax(served, kw):
    _, ckpt, evald, _ = served
    jtr, ttr = _trainers(ckpt, evald, **kw)
    (jl, ja), (tl, ta) = jtr.evaluate(), ttr.evaluate()
    assert np.isfinite(tl) and np.isfinite(ta)
    assert abs(tl - jl) <= 1e-5
    assert abs(ta - ja) <= 1e-5


def test_api_predict_stdin_to_stdout(served, monkeypatch, capsys):
    d, ckpt, evald, _ = served
    _, ttr = _trainers(ckpt, evald, file_type="libffm", max_nnz=7)
    with open(evald) as f:
        monkeypatch.setattr(sys, "stdin", f)
        n = ttr.predict_file("-", "-")
    got = capsys.readouterr().out.splitlines()
    assert n == 50
    assert got == (d / "torch.txt").read_text().splitlines()


def test_api_predict_file_counts_real_rows(served, tmp_path):
    _, ckpt, evald, _ = served
    _, ttr = _trainers(ckpt, evald)
    out = tmp_path / "p.txt"
    assert ttr.predict_file(evald, str(out)) == 50
    probs = np.array(out.read_text().split(), np.float64)
    assert probs.shape == (50,) and ((probs > 0) & (probs < 1)).all()


def test_train_raises_naming_roadmap(served, tmp_path):
    """Training arrived (item 2): Trainer.train from the served checkpoint
    follows the JAX Trainer's history.  Profiling arrived too (item 9):
    train(profile_dir=...) writes epoch 1's torch.profiler trace there and
    returns the unprofiled run's history bit for bit."""
    d, ckpt, evald, _ = served
    jtr, ttr = _trainers(ckpt, evald, train_data=str(d / "train.ffm"))
    hist, ref = ttr.train(), jtr.train()
    for key in ("train_loss", "eval_loss", "eval_auc"):
        np.testing.assert_allclose(hist[key], ref[key], rtol=0, atol=1e-4)
    _, ptr = _trainers(ckpt, evald, train_data=str(d / "train.ffm"))
    prof = tmp_path / "prof"
    assert ptr.train(profile_dir=str(prof)) == hist
    assert all(torch.equal(a, b) for a, b in zip(ptr.state, ttr.state))
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


@pytest.mark.parametrize(
    "flags,item",
    [
        # items 2 (training) and 3 (checkpoints and reference models) have
        # arrived: these train, and the item-3 flags write their file
        (["--train_data", "TRAIN"], 2),
        (["--cmd", "true"], 2),
        (["--model_path", "m.ckpt"], 3),
        (["--export_reference_model", "m.zst"], 3),
        (["--import_reference_model", "m.zst"], 3),
        (["--profile_dir", "prof"], 9),
        # item 8 has arrived: steps_per_call > 1 on a mesh (here a group
        # of one) trains, as one device does
        (["--train_data", "TRAIN", "--mesh_data", "0", "--steps_per_call", "2"], 8),
        (["--save_every", "10"], 3),
    ],
)
def test_cli_training_flags_raise(served, flags, item, monkeypatch, capsys, tmp_path):
    """The flags of the port's later slices work: the training flags
    train (item 8's on a mesh too), the checkpoint and reference-model
    flags write (or read) their file, and --profile_dir (item 9) writes
    epoch 1's trace."""
    train = served[0] / "train.ffm"
    argv = [str(train) if a == "TRAIN" else a for a in flags]
    argv += [*MODEL_FLAGS, "--file_type", "libffm", "--max_nnz", "7", "--device", "cpu"]
    if item == 9:
        prof = tmp_path / "prof"
        argv[argv.index("prof")] = str(prof)
        assert torch_main([*argv, "--train_data", str(train)]) == 0
        assert "epoch 1 train time: " in capsys.readouterr().out
        assert len(list(prof.glob("*.pt.trace.json"))) == 1
        return
    if item == 8:
        assert torch_main(argv) == 0
        assert "epoch 1 train time: " in capsys.readouterr().out
        return
    if item == 2:
        with open(train) as f:
            monkeypatch.setattr(sys, "stdin", f)
            assert torch_main(argv) == 0
        assert "epoch 1 train time: " in capsys.readouterr().out
        return
    if item == 3:
        from ftrl_ffm_tpu_torch.io.checkpoint import (
            export_reference_model,
            import_reference_model,
        )
        from ftrl_ffm_tpu_torch.models import make_model

        argv = [str(tmp_path / a) if a.startswith("m.") else a for a in argv]
        ckpt = str(tmp_path / "m.ckpt")
        if "--save_every" in argv:
            argv += ["--model_path", ckpt]
        model = make_model(TConfig(device="cpu", **SHAPE))
        if "--import_reference_model" in argv:
            jstate, _ = load_checkpoint(served[1])
            export_reference_model(
                str(tmp_path / "m.zst"),
                *model.materialize_weights(state_from_jax_arrays(jstate, "cpu")),
            )
        assert torch_main([*argv, "--train_data", str(train)]) == 0
        out = capsys.readouterr().out
        assert "epoch 1 train time: " in out
        if "--model_path" in argv:
            state, extra = load_checkpoint(ckpt)
            assert int(state.step) == 4 and extra["model_config"]["n_feats"] == 60
            assert "checkpoint saved to" in out
        elif "--export_reference_model" in argv:
            _, lin_w, vec_w = import_reference_model(str(tmp_path / "m.zst"), 60, 7 * 16)
            assert lin_w.shape == (60,) and vec_w.shape == (60, 112)
        else:
            assert "imported reference model" in out


def test_cli_requires_a_model_to_serve(capsys):
    assert torch_main(["--eval_data", "e.ffm", "--device", "cpu"]) == 2
    assert "--load_model" in capsys.readouterr().err


@pytest.mark.parametrize(
    "kw,match",
    [
        # item 8 has arrived: these serve on a mesh (a group of one), and
        # evaluate as one device does (match None)
        ({"mesh_data": 0, "steps_per_call": 2}, None),
        ({"mesh_data": 0, "device_cache": "on", "device_cache_layout": "shard"}, None),
        ({"steps_per_call": 4, "auc_mode": "exact"}, "auc_mode=exact"),
        ({"use_pallas": "off"}, "no counterpart"),
    ],
)
def test_unported_config_raises(served, kw, match):
    """A config the port does not serve raises; those item 8 brought
    (match None) evaluate the served state as one device does, bit for
    bit."""
    _, ckpt, evald, _ = served
    tstate, _ = load_checkpoint(ckpt)

    def make(**extra):
        return Trainer(
            TConfig(eval_data=evald, device="cpu", file_type="libffm", max_nnz=7,
                    **{**SHAPE, **extra}),
            state=state_from_jax_arrays(tstate, "cpu"),
        )

    if match is None:
        assert make(**kw).evaluate() == make().evaluate()
        return
    with pytest.raises((NotImplementedError, ValueError), match=match):
        make(**kw)


@pytest.mark.parametrize(
    "kw",
    [
        {"update_mode": "inplace"},
        {"update_mode": "sparse"},
        # n_feats=100k at B=16: the in-place update at JAX auto's shape
        # (the port's auto takes "dense2" there)
        {"n_feats": 100_000, "update_mode": "inplace"},
        # once refused (Queue 1 item 4): a bf16 table, a bf16 payload
        {"table_dtype": "bfloat16"},
        {"acc_dtype": "bfloat16"},
        # once refused (Queue 1 item 6): the device-resident dataset, which
        # "on" engages for a single online epoch too
        {"device_cache": "on"},
    ],
)
def test_update_kinds_train_and_match_jax(served, kw, monkeypatch):
    """The training settings the port once refused train one epoch with
    eval, from the JAX Trainer's init, to the JAX Trainer's losses.  A bf16
    payload is held against the JAX Trainer on its fused Pallas kernel
    (interpret mode), the only JAX path that emits one."""
    d, _, evald, _ = served
    cfg = dict(train_data=str(d / "train.ffm"), eval_data=evald, n_epochs=1,
               file_type="libffm", max_nnz=7, **{**SHAPE, **kw})
    if "acc_dtype" in kw:
        for fn_name in ("ffm_fused_logits_grads", "ffm_fused_logits"):
            monkeypatch.setattr(
                fp, fn_name, functools.partial(getattr(fp, fn_name), interpret=True)
            )
        cfg["use_pallas"] = "on"
    jtr = JTrainer(JConfig(**cfg))
    tr = Trainer(TConfig(device="cpu", **cfg), state=state_from_jax_arrays(jtr.state, "cpu"))
    hist, j_hist = tr.train(), jtr.train()
    if "device_cache" in kw:
        assert tr._dev_cache["train"] is not None and tr._dev_cache["eval"] is not None
    for key in ("train_loss", "eval_loss", "eval_auc"):
        np.testing.assert_allclose(hist[key], j_hist[key], rtol=1e-5, err_msg=key)


def test_trainer_needs_a_state(served):
    """Without a state the Trainer starts from a fresh init seeded with
    cfg.seed (Model.init), and serves it."""
    _, _, evald, _ = served
    tr = Trainer(TConfig(eval_data=evald, device="cpu", **SHAPE))
    for got, want in zip(tr.state, tr.model.init()):
        assert torch.equal(got, want)
    loss, auc = tr.evaluate()
    assert np.isfinite(loss) and np.isfinite(auc)
