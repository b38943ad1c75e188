"""The port writes what the JAX package writes (ROADMAP.md Queue 1 item 3):
FTRLTPU1 checkpoints, reference-format weight blobs and text models, the
mid-training saves of `Trainer` and the CLI's save, resume, auto-resume,
import and export flows, on the CPU.

Twins of tests/test_checkpoint.py (but the sharded test, which goes with
item 8), of tests/test_train.py::test_save_every_mid_training_checkpoint,
tests/test_device_cache.py::test_cached_save_every_fires and the
import/export tests of tests/test_field_pad.py; then the two packages
against each other on the same seeded numpy inputs: checkpoints cross in
both directions with equal arrays (LR, FM, FFM; f32 and bf16 tables),
reference blobs decompress to identical bytes, text models are
byte-identical, and a checkpoint written by one CLI serves the same eval
line in the other.  The zstd binding (io/zstd.py) round-trips against the
`zstandard` package both ways.  Exact equality throughout, but for the
bias weight read back through the closed form (rtol 1e-6, as in the JAX
suite) and the text round trip (the JAX suite's rtol 1e-5, atol 1e-7:
str(float) of a float32 parses back to it, so it is exact in fact)."""

import io
import os
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import zstandard

from ftrl_ffm_tpu.cli import main as jax_main
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.io import checkpoint as jck
from ftrl_ffm_tpu.models import make_model as j_make_model
from ftrl_ffm_tpu_torch.cli import main as torch_main
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.io import checkpoint as ck
from ftrl_ffm_tpu_torch.io import zstd
from ftrl_ffm_tpu_torch.io.checkpoint import (
    IncompatibleStateError,
    export_reference_model,
    export_reference_text_model,
    import_reference_model,
    import_reference_text_model,
    load_checkpoint,
    save_checkpoint,
    state_from_jax_arrays,
)
from ftrl_ffm_tpu_torch.models import make_model
from ftrl_ffm_tpu_torch.models.base import Batch, ModelState
from ftrl_ffm_tpu_torch.train import Trainer
from tests.common import write_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FEATS, N_FIELDS, K = 50, 4, 3
MODEL_TYPES = ("LR", "FM", "FFM")
DTYPES = ("float32", "bfloat16")


def _compress(data, level=3):
    """One zstd frame of `data` through io/zstd.py's streaming compressor,
    recording its content size."""
    sink = io.BytesIO()
    with zstd.Compressor(sink, level, size=len(data)) as c:
        c.write(data)
        c.end()
    return sink.getvalue()


def _write_ffm_file(path, n=64, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, N_FEATS))}:1" for c in range(N_FIELDS)
            ]
            f.write(" ".join(toks) + "\n")
    return str(path)


def _batch(rng, b=8, f=N_FIELDS, r=N_FEATS):
    return Batch(
        fields=torch.from_numpy(np.tile(np.arange(f, dtype=np.int32), (b, 1))),
        feats=torch.from_numpy(rng.integers(0, r, (b, f)).astype(np.int32)),
        vals=torch.from_numpy((rng.random((b, f)) + 0.1).astype(np.float32)),
        y=torch.from_numpy((rng.random(b) > 0.5).astype(np.float32)),
        sample_w=torch.ones(b),
    )


def _cfg(model_type="FFM", **kw):
    return Config(model_type=model_type, n_feats=N_FEATS, n_fields=N_FIELDS,
                  n_factors=K, device="cpu", max_nnz=N_FIELDS, **kw)


def _trained_state(model_type="FFM", steps=5, **kw):
    """A port state after a few train steps (tests/test_checkpoint.py::
    _trained_state)."""
    model = make_model(_cfg(model_type, w_alpha=0.05, **kw))
    state = model.init()
    rng = np.random.default_rng(0)
    for _ in range(steps):
        model.train_step(state, _batch(rng))
    return model, state


def _random_state(model_type, table_dtype, seed=0):
    """A port-shaped state with every table random (numpy, seeded), as host
    arrays: float32 tables, a bf16 vec_w as ml_dtypes.bfloat16, step 17."""
    cfg = JConfig(model_type=model_type, n_feats=N_FEATS, n_fields=N_FIELDS,
                  n_factors=K, table_dtype=table_dtype)
    rng = np.random.default_rng(seed)
    fields = {}
    for name, a in j_make_model(cfg).init()._asdict().items():
        if a is None:
            fields[name] = None
        elif name == "step":
            fields[name] = np.asarray(17, np.int32)
        else:
            v = (rng.standard_normal(np.shape(a)) * 0.3).astype(np.float32)
            fields[name] = v.astype(ml_dtypes.bfloat16) if a.dtype == jnp.bfloat16 else v
    return cfg, fields


def _states_equal(a, b):
    """Two ModelStates or field dicts (tensors or host arrays) hold the
    same bits."""
    a, b = (s if isinstance(s, dict) else s._asdict() for s in (a, b))
    for name in ModelState._fields:
        x, y = a[name], b[name]
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        x, y = (t.view(torch.int16).numpy() if isinstance(t, torch.Tensor)
                and t.dtype == torch.bfloat16 else np.asarray(t) for t in (x, y))
        if x.dtype == ml_dtypes.bfloat16:
            x = x.view(np.int16)
        if y.dtype == ml_dtypes.bfloat16:
            y = y.view(np.int16)
        assert x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


# ------------------------------------------------ twins of test_checkpoint.py
def test_full_checkpoint_roundtrip(tmp_path):
    _, state = _trained_state("FFM")
    path = str(tmp_path / "ckpt.zst")
    save_checkpoint(path, state, extra={"note": "hi"})
    loaded, extra = load_checkpoint(path)
    assert extra == {"note": "hi"}
    _states_equal(state, loaded)


def test_checkpoint_resume_training_is_exact(tmp_path):
    """Full (n, z, w) state: resume == uninterrupted training, bit for bit."""
    model = make_model(_cfg("FM", w_alpha=0.05))
    rng = np.random.default_rng(1)
    batches = [_batch(rng) for _ in range(6)]
    s = model.init()
    for b in batches[:3]:
        model.train_step(s, b)
    path = str(tmp_path / "mid.zst")
    save_checkpoint(path, s)
    s_resume = state_from_jax_arrays(load_checkpoint(path)[0], "cpu")
    for b in batches[3:]:
        model.train_step(s, b)
        model.train_step(s_resume, b)
    _states_equal(s, s_resume)


def test_lr_checkpoint_roundtrip(tmp_path):
    _, state = _trained_state("LR")
    path = str(tmp_path / "lr.zst")
    save_checkpoint(path, state)
    loaded, _ = load_checkpoint(path)
    assert loaded.vec_n is None and loaded.vec_w is None
    np.testing.assert_array_equal(state.lin_z.numpy(), loaded.lin_z)


def test_reference_blob_roundtrip(tmp_path):
    model, state = _trained_state("FFM")
    bias, lin_w, vec_w = model.materialize_weights(state)
    path = str(tmp_path / "model.zst")
    export_reference_model(path, float(bias), lin_w, vec_w)
    b2, l2, v2 = import_reference_model(path, N_FEATS, N_FIELDS * K)
    assert b2 == np.float32(bias)
    np.testing.assert_array_equal(lin_w.numpy(), l2)
    np.testing.assert_array_equal(vec_w.numpy(), v2)


def test_reference_text_roundtrip(tmp_path):
    model, state = _trained_state("FFM")
    bias, lin_w, vec_w = model.materialize_weights(state)
    path = str(tmp_path / "model.txt")
    export_reference_text_model(path, float(bias), lin_w, vec_w)
    b2, l2, v2 = import_reference_text_model(path, N_FEATS, N_FIELDS * K)
    assert b2 == pytest.approx(float(bias), abs=1e-6)
    np.testing.assert_allclose(lin_w.numpy(), l2, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(vec_w.numpy(), v2, rtol=1e-5, atol=1e-7)


MODEL_FLAGS = ["--model_type", "FFM", "--n_fields", str(N_FIELDS),
               "--n_feats", str(N_FEATS), "--n_factors", str(K)]


def test_cli_end_to_end_with_checkpoint(tmp_path, capsys):
    data = _write_ffm_file(tmp_path / "train.ffm")
    ckpt = str(tmp_path / "model.ckpt")
    ref = str(tmp_path / "model.zst")
    assert torch_main([
        "--train_data", data, "--eval_data", data, *MODEL_FLAGS,
        "--n_epochs", "2", "--batch_size", "32", "--device", "cpu",
        "--model_path", ckpt, "--export_reference_model", ref,
    ]) == 0
    out = capsys.readouterr().out
    assert "epoch 1 train time" in out and "eval loss" in out
    state, extra = load_checkpoint(ckpt)
    assert int(state.step) == 4  # 64 samples / 32 batch * 2 epochs
    assert extra["config"]["model_type"] == "FFM"
    _, l2, _ = import_reference_model(ref, N_FEATS, N_FIELDS * K)
    assert l2.shape == (N_FEATS,)
    assert torch_main([
        "--train_data", data, *MODEL_FLAGS, "--batch_size", "32",
        "--device", "cpu", "--load_model", ckpt,
    ]) == 0
    assert "resumed" in capsys.readouterr().out


def test_cli_predict_output(tmp_path):
    data = _write_ffm_file(tmp_path / "train.ffm", n=50)
    out = str(tmp_path / "preds.txt")
    assert torch_main([
        "--train_data", data, *MODEL_FLAGS, "--batch_size", "16", "--device", "cpu",
        "--predict_data", data, "--predict_output", out,
    ]) == 0
    preds = [float(x) for x in open(out)]
    assert len(preds) == 50 and all(0.0 < p < 1.0 for p in preds)


def test_cli_serve_only_predict_and_eval(tmp_path, capsys):
    data = _write_ffm_file(tmp_path / "train.ffm")
    ckpt = str(tmp_path / "model.ckpt")
    assert torch_main([
        "--train_data", data, *MODEL_FLAGS, "--batch_size", "32", "--device", "cpu",
        "--model_path", ckpt,
    ]) == 0
    capsys.readouterr()
    out = str(tmp_path / "preds.txt")
    assert torch_main([
        *MODEL_FLAGS, "--batch_size", "16", "--device", "cpu", "--load_model", ckpt,
        "--predict_data", data, "--predict_output", out,
    ]) == 0
    assert len(open(out).readlines()) == 64
    assert torch_main([
        *MODEL_FLAGS, "--batch_size", "16", "--device", "cpu", "--load_model", ckpt,
        "--eval_data", data,
    ]) == 0
    assert "eval loss:" in capsys.readouterr().out


def test_bfloat16_table_dtype_trains(tmp_path):
    data = _write_ffm_file(tmp_path / "train.ffm", n=256)
    kw = dict(train_data=data, model_type="FFM", n_fields=N_FIELDS, n_feats=N_FEATS,
              n_factors=K, batch_size=32, n_epochs=2, w_alpha=0.05, device="cpu")
    t16 = Trainer(Config(**kw, table_dtype="bfloat16"))
    h16 = t16.train()
    h32 = Trainer(Config(**kw)).train()
    assert t16.state.vec_w.dtype == torch.bfloat16
    assert abs(h16["train_loss"][-1] - h32["train_loss"][-1]) < 5e-3
    path = str(tmp_path / "bf16.ckpt")
    save_checkpoint(path, t16.state)
    loaded, _ = load_checkpoint(path)
    assert loaded.vec_w.dtype == torch.bfloat16
    assert torch.equal(loaded.vec_w, t16.state.vec_w)


def test_import_reference_model_exact_and_trainable(tmp_path, capsys):
    data = _write_ffm_file(tmp_path / "train.ffm")
    tr = Trainer(Config(train_data=data, model_type="FFM", n_fields=N_FIELDS,
                        n_feats=N_FEATS, n_factors=K, batch_size=32, w_alpha=0.05,
                        device="cpu"))
    tr.train()
    bias, lin_w, vec_w = tr.model.materialize_weights(tr.logical_state)
    blob = str(tmp_path / "ref.zst")
    export_reference_model(blob, float(bias), lin_w, vec_w)
    model = make_model(_cfg())
    st = model.init_from_weights(*import_reference_model(blob, N_FEATS, N_FIELDS * K))
    b3, l3, v3 = model.materialize_weights(st)
    np.testing.assert_allclose(float(b3), float(bias), rtol=1e-6)
    assert torch.equal(l3, lin_w) and torch.equal(v3, vec_w)
    assert torch_main([
        "--train_data", data, *MODEL_FLAGS, "--batch_size", "32", "--device", "cpu",
        "--import_reference_model", blob,
    ]) == 0
    assert "imported reference model" in capsys.readouterr().out


def test_cli_auto_resume(tmp_path, capsys):
    data = _write_ffm_file(tmp_path / "train.ffm")
    ckpt = str(tmp_path / "model.ckpt")
    args = ["--train_data", data, *MODEL_FLAGS, "--batch_size", "32", "--device", "cpu",
            "--model_path", ckpt, "--auto_resume", "true"]
    assert torch_main(args) == 0
    assert "resumed" not in capsys.readouterr().out  # first run: nothing to resume
    st1, _ = load_checkpoint(ckpt)
    assert torch_main(args) == 0
    assert "resumed from" in capsys.readouterr().out
    st2, _ = load_checkpoint(ckpt)
    assert int(st2.step) == 2 * int(st1.step)


@pytest.mark.parametrize("bad", [
    ["--n_factors", str(K + 1)], ["--n_feats", str(N_FEATS * 2)],
    ["--n_fields", str(N_FIELDS + 2)], ["--model_type", "FM"],
    ["--table_dtype", "bfloat16"],
])
def test_resume_mismatched_config_raises(tmp_path, bad):
    data = _write_ffm_file(tmp_path / "train.ffm")
    ckpt = str(tmp_path / "model.ckpt")
    base = ["--train_data", data, *MODEL_FLAGS, "--batch_size", "32", "--device", "cpu"]
    assert torch_main([*base, "--model_path", ckpt]) == 0
    argv = [*base, "--load_model", ckpt]
    flag, val = bad
    if flag in argv:
        argv[argv.index(flag) + 1] = val
    else:
        argv += [flag, val]
    with pytest.raises(IncompatibleStateError, match="different model"):
        torch_main(argv)


def test_trainer_state_shape_validation(tmp_path):
    data = _write_ffm_file(tmp_path / "train.ffm")
    _, state = _trained_state("FFM")
    kw = dict(train_data=data, model_type="FFM", n_fields=N_FIELDS, n_factors=K,
              batch_size=32, device="cpu")
    Trainer(Config(**kw, n_feats=N_FEATS), state=state)
    with pytest.raises(IncompatibleStateError, match="n_feats"):
        Trainer(Config(**kw, n_feats=N_FEATS + 7), state=state)
    with pytest.raises(IncompatibleStateError, match="factor"):
        Trainer(Config(**{**kw, "n_factors": K + 1}, n_feats=N_FEATS), state=state)
    with pytest.raises(IncompatibleStateError, match="has factor tables"):
        Trainer(Config(train_data=data, model_type="LR", n_feats=N_FEATS, batch_size=32,
                       device="cpu"), state=state)
    with pytest.raises(IncompatibleStateError, match="table_dtype"):
        Trainer(Config(**kw, n_feats=N_FEATS, table_dtype="bfloat16"), state=state)


def test_import_reference_model_size_mismatch_raises(tmp_path):
    model, state = _trained_state("FFM")
    path = str(tmp_path / "model.zst")
    export_reference_model(path, *model.materialize_weights(state))
    import_reference_model(path, N_FEATS, N_FIELDS * K)
    for n, w in ((N_FEATS, (N_FIELDS + 1) * K), (N_FEATS + 1, N_FIELDS * K), (N_FEATS, 0)):
        with pytest.raises(IncompatibleStateError, match="floats"):
            import_reference_model(path, n, w)


def test_import_reference_text_model_validation(tmp_path):
    model, state = _trained_state("FFM")
    bias, lin_w, vec_w = model.materialize_weights(state)
    path = str(tmp_path / "model.txt")
    export_reference_text_model(path, float(bias), lin_w, vec_w)
    import_reference_text_model(path, N_FEATS, N_FIELDS * K)
    with pytest.raises(IncompatibleStateError, match="lines"):
        import_reference_text_model(path, N_FEATS + 3, N_FIELDS * K)
    for w in (N_FIELDS * K + 1, N_FIELDS * K - 1):
        with pytest.raises(IncompatibleStateError, match="factor rows"):
            import_reference_text_model(path, N_FEATS, w)
    bad = str(tmp_path / "bad.txt")
    with open(path) as f, open(bad, "w") as g:
        g.write(f.read().replace("0.", "x.", 1))
    with pytest.raises(IncompatibleStateError, match="malformed"):
        import_reference_text_model(bad, N_FEATS, N_FIELDS * K)


def test_cli_text_model_roundtrip(tmp_path, capsys):
    data = _write_ffm_file(tmp_path / "train.ffm")
    txt, ckpt = str(tmp_path / "model.txt"), str(tmp_path / "trained.ckpt")
    base = ["--train_data", data, *MODEL_FLAGS, "--batch_size", "32", "--device", "cpu"]
    assert torch_main([*base, "--model_path", ckpt, "--export_reference_text_model", txt]) == 0
    assert "text-format model saved" in capsys.readouterr().out
    model = make_model(_cfg())
    b0, l0, v0 = model.materialize_weights(state_from_jax_arrays(load_checkpoint(ckpt)[0], "cpu"))
    st = model.init_from_weights(*import_reference_text_model(txt, N_FEATS, N_FIELDS * K))
    b3, l3, v3 = model.materialize_weights(st)
    np.testing.assert_allclose(float(b3), float(b0), rtol=1e-6)
    assert torch.equal(l3, l0) and torch.equal(v3, v0)
    assert torch_main([*base, "--import_reference_text_model", txt]) == 0
    assert "imported reference model" in capsys.readouterr().out
    assert torch_main([
        "--train_data", data, "--model_type", "LR", "--n_feats", str(N_FEATS),
        "--batch_size", "32", "--device", "cpu",
        "--export_reference_text_model", str(tmp_path / "lr.txt"),
    ]) == 2
    assert torch_main([*base, "--import_reference_model", txt,
                       "--import_reference_text_model", txt]) == 2


def _mid_cfg(data, **kw):
    return Config(train_data=data, model_type="FFM", n_fields=N_FIELDS, n_feats=N_FEATS,
                  n_factors=K, batch_size=16, n_epochs=1, save_every=2, device="cpu", **kw)


def test_async_mid_checkpoint_matches_sync(tmp_path):
    data = _write_ffm_file(tmp_path / "t.ffm", n=64, seed=3)
    cka, cks = str(tmp_path / "a.ckpt"), str(tmp_path / "s.ckpt")
    ta = Trainer(_mid_cfg(data, model_path=cka, async_checkpoint=True, device_cache="off"))
    ts = Trainer(_mid_cfg(data, model_path=cks, async_checkpoint=False, device_cache="off"))
    ta.train_epoch()
    ts.train_epoch()
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    sa, ea = load_checkpoint(cka)
    ss, es = load_checkpoint(cks)
    assert ea["mid_training_step"] == es["mid_training_step"] == 4
    _states_equal(sa, ss)
    assert [r["snapshot"] for r in ta.checkpoint_log] == ["device_copy"] * 2
    assert [r["snapshot"] for r in ts.checkpoint_log] == ["sync"] * 2


@pytest.mark.parametrize("fits", [True, False])
def test_async_snapshot_survives_later_steps(tmp_path, monkeypatch, fits):
    """An async save through the device copy (fits) or the host copy (the
    copy made not to fit): steps taken before the join update the tables
    in place, and the file holds the state as it was at the save.  The
    writer is held until the steps are done."""
    import threading

    import ftrl_ffm_tpu_torch.train as train_mod

    data = _write_ffm_file(tmp_path / "t.ffm", n=64, seed=5)
    path = str(tmp_path / "a.ckpt")
    tr = Trainer(_mid_cfg(data, model_path=path, device_cache="off"))
    monkeypatch.setattr(tr, "_snapshot_copy_fits", lambda state: fits)
    tr.train_epoch()
    before = ModelState(*(None if t is None else t.clone() for t in tr.logical_state))
    stepped = threading.Event()
    save = train_mod.save_checkpoint

    def held_save(*args, **kw):
        stepped.wait(60)
        return save(*args, **kw)

    monkeypatch.setattr(train_mod, "save_checkpoint", held_save)
    tr._save_mid_checkpoint(tr._steps_done)
    for b in [tr._place_batch(a) for a in tr._train_batches(np.random.default_rng(0))]:
        tr.model.train_step(tr.state, b)
    stepped.set()
    tr._join_pending_checkpoint()
    assert tr.checkpoint_log[-1]["snapshot"] == ("device_copy" if fits else "inline")
    assert not torch.equal(tr.state.vec_z, before.vec_z)
    _states_equal(load_checkpoint(path)[0], before)


def test_checkpoint_write_is_crash_atomic(tmp_path, monkeypatch):
    """A crash artifact at <path>.tmp.<pid> never affects loading, and a
    write that fails mid-stream neither truncates the previous checkpoint
    nor leaves its temp file behind."""
    _, state = _trained_state("FFM")
    path = str(tmp_path / "ckpt.zst")
    save_checkpoint(path, state, extra={"v": 1})
    good = open(path, "rb").read()
    open(path + ".tmp.99999", "wb").write(b"garbage not a checkpoint")
    assert load_checkpoint(path)[1] == {"v": 1}

    class Boom(Exception):
        pass

    calls = []
    real = zstd.Compressor.write

    def write(self, data):
        calls.append(1)
        if len(calls) == 4:  # the header, then tables: fail inside lin_n..
            raise Boom()
        return real(self, data)

    monkeypatch.setattr(zstd.Compressor, "write", write)
    with pytest.raises(Boom):
        save_checkpoint(path, state, extra={"v": 2})
    monkeypatch.undo()
    assert open(path, "rb").read() == good
    assert not [f for f in os.listdir(tmp_path) if f.endswith(f".tmp.{os.getpid()}")]
    assert load_checkpoint(path)[1] == {"v": 1}


def test_async_checkpoint_failure_raises_at_join(tmp_path):
    data = _write_ffm_file(tmp_path / "t.ffm", n=64, seed=3)
    # model_path is a directory: open() in the writer thread fails
    tr = Trainer(_mid_cfg(data, model_path=str(tmp_path), device_cache="off"))
    with pytest.raises(RuntimeError, match="background checkpoint") as e:
        tr.train_epoch()
    assert isinstance(e.value.__cause__, OSError)
    assert tr._ckpt_thread is None and tr._ckpt_exc is None


# ------------------------------- twins of test_train, test_device_cache, field_pad
def test_save_every_mid_training_checkpoint(tmp_path):
    path = str(tmp_path / "train.ffm")
    rng = np.random.default_rng(1)
    with open(path, "w") as f:
        for _ in range(64):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 50))}:1" for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    ckpt = str(tmp_path / "mid.ckpt")
    tr = Trainer(Config(train_data=path, model_type="FFM", n_fields=4, n_feats=50,
                        n_factors=2, batch_size=16, n_epochs=1, save_every=2,
                        model_path=ckpt, device="cpu"))
    tr.train_epoch()
    assert "train" not in tr._dev_cache  # one online epoch streams
    _, extra = load_checkpoint(ckpt)
    assert extra["mid_training_step"] == 4  # 64/16 = 4 steps, saved at 2 and 4


def test_cached_save_every_fires(tmp_path):
    train = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    ckpt = str(tmp_path / "mid.ckpt")
    tr = Trainer(Config(train_data=train, model_type="FFM", n_fields=4, n_feats=40,
                        n_factors=4, n_epochs=1, batch_size=16, save_every=2,
                        model_path=ckpt, device_cache="on", device="cpu"))
    tr.train_epoch()
    assert tr._dev_cache["train"] is not None
    _, extra = load_checkpoint(ckpt)
    assert extra["mid_training_step"] == 4  # 64/16 steps, saved at 2 and 4


def test_export_import_roundtrip_with_padding():
    """Reference export drops the dead lanes, import zeroes them;
    materialized weights round-trip exactly (tests/test_field_pad.py)."""
    cfg = Config(model_type="FFM", n_fields=39, n_feats=64, n_factors=16, device="cpu")
    m = make_model(cfg)
    state = m.init()
    bias, lin_w, vec_w = m.materialize_weights(state)
    assert tuple(vec_w.shape) == (64, 624)
    st2 = m.init_from_weights(bias, lin_w, vec_w)
    bias2, lin_w2, vec_w2 = m.materialize_weights(st2)
    assert torch.equal(vec_w2, vec_w) and torch.equal(lin_w2, lin_w)
    dead = (torch.arange(640) % 40) >= 39
    dead[39] = False  # the mirror lane
    assert not st2.vec_w[:, dead].any()


def test_import_reference_restores_mirror():
    cfg = Config(model_type="FFM", n_fields=39, n_feats=32, n_factors=16,
                 factor_semantics="reference", device="cpu")
    m = make_model(cfg)
    rng = np.random.default_rng(5)
    lin_w = rng.normal(size=(32,)).astype(np.float32) * 0.1
    vec_w = rng.normal(size=(32, 624)).astype(np.float32) * 0.1
    st = m.init_from_weights(np.float32(0.3), lin_w, vec_w)
    np.testing.assert_array_equal(st.vec_w[:, 39].numpy(), lin_w)
    assert torch.equal(st.vec_z[:, 39], st.lin_z) and torch.equal(st.vec_n[:, 39], st.lin_n)


# ------------------------------------------------ the port against JAX
@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_port_checkpoint_loads_in_jax(tmp_path, model_type, table_dtype):
    jcfg, fields = _random_state(model_type, table_dtype)
    state = state_from_jax_arrays(fields, "cpu")
    path = str(tmp_path / "p.ckpt")
    cfg = Config(model_type=model_type, n_feats=N_FEATS, n_fields=N_FIELDS, n_factors=K,
                 table_dtype=table_dtype, device="cpu")
    save_checkpoint(path, state, extra={"model_config": ck.model_signature(cfg)})
    j_state, j_extra = jck.load_checkpoint(path)
    _states_equal(state, j_state)
    jck.validate_header_compat(jcfg, j_extra, path)
    if table_dtype == "bfloat16" and model_type != "LR":
        assert np.asarray(j_state.vec_w).dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_jax_checkpoint_loads_in_port(tmp_path, model_type, table_dtype):
    jcfg, fields = _random_state(model_type, table_dtype, seed=1)
    path = str(tmp_path / "j.ckpt")
    jck.save_checkpoint(path, jck.ModelState(**{k: None if v is None else jnp.asarray(v)
                                                for k, v in fields.items()}),
                        extra={"model_config": jck.model_signature(jcfg)})
    loaded, extra = load_checkpoint(path)
    _states_equal(loaded, fields)
    if table_dtype == "bfloat16" and model_type != "LR":
        assert loaded.vec_w.dtype == torch.bfloat16
    cfg = Config(model_type=model_type, n_feats=N_FEATS, n_fields=N_FIELDS, n_factors=K,
                 table_dtype=table_dtype, device="cpu")
    ck.validate_header_compat(cfg, extra, path)
    _states_equal(state_from_jax_arrays(loaded, "cpu"), fields)


def test_checkpoint_bytes_match_jax(tmp_path):
    """The same state and header decompress to the same bytes from either
    package: the format is one, not two that read each other."""
    _, fields = _random_state("FFM", "bfloat16", seed=2)
    jstate = jck.ModelState(**{k: None if v is None else jnp.asarray(v) for k, v in fields.items()})
    jck.save_checkpoint(str(tmp_path / "j.ckpt"), jstate, extra={"a": 1})
    save_checkpoint(str(tmp_path / "p.ckpt"), state_from_jax_arrays(fields, "cpu"), extra={"a": 1})
    raw = [zstandard.ZstdDecompressor().stream_reader(open(tmp_path / n, "rb")).read()
           for n in ("j.ckpt", "p.ckpt")]
    assert raw[0] == raw[1] and len(raw[0]) > 1000


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_reference_blob_bytes_match_jax(tmp_path, model_type):
    """materialize_weights of one state in both packages, exported by both:
    the blobs decompress to identical bytes, and each package imports the
    other's into the same weights."""
    jcfg, fields = _random_state(model_type, "float32", seed=3)
    jm = j_make_model(jcfg)
    jw = jm.materialize_weights(jck.ModelState(
        **{k: None if v is None else jnp.asarray(v) for k, v in fields.items()}))
    tm = make_model(Config(model_type=model_type, n_feats=N_FEATS, n_fields=N_FIELDS,
                           n_factors=K, device="cpu"))
    tw = tm.materialize_weights(state_from_jax_arrays(fields, "cpu"))
    jp, tp = str(tmp_path / "j.zst"), str(tmp_path / "t.zst")
    jck.export_reference_model(jp, float(jw[0]), jw[1], jw[2])
    export_reference_model(tp, float(tw[0]), tw[1], tw[2])
    raws = [zstandard.ZstdDecompressor().decompress(open(p, "rb").read()) for p in (jp, tp)]
    assert raws[0] == raws[1]
    assert zstd.decompress(open(jp, "rb").read()) == raws[0]
    width = jcfg.ref_row_width
    for got in (import_reference_model(jp, N_FEATS, width),
                jck.import_reference_model(tp, N_FEATS, width)):
        want = jck.import_reference_model(jp, N_FEATS, width)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        if width:
            np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("model_type", ("FM", "FFM"))
def test_text_model_bytes_match_jax(tmp_path, model_type):
    jcfg, fields = _random_state(model_type, "float32", seed=4)
    jw = j_make_model(jcfg).materialize_weights(jck.ModelState(
        **{k: None if v is None else jnp.asarray(v) for k, v in fields.items()}))
    tw = make_model(Config(model_type=model_type, n_feats=N_FEATS, n_fields=N_FIELDS,
                           n_factors=K, device="cpu")).materialize_weights(
        state_from_jax_arrays(fields, "cpu"))
    jp, tp = tmp_path / "j.txt", tmp_path / "t.txt"
    jck.export_reference_text_model(str(jp), float(jw[0]), jw[1], jw[2])
    export_reference_text_model(str(tp), float(tw[0]), tw[1], tw[2])
    assert jp.read_bytes() == tp.read_bytes()
    got = import_reference_text_model(str(jp), N_FEATS, jcfg.ref_row_width)
    want = jck.import_reference_text_model(str(tp), N_FEATS, jcfg.ref_row_width)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_init_from_weights_matches_jax(model_type, table_dtype):
    """The warm start's tables equal the JAX package's bit for bit (the
    closed-form inversion, the layout, the dead lanes and the mirror)."""
    kw = dict(model_type=model_type, n_feats=N_FEATS, n_fields=N_FIELDS, n_factors=K,
              table_dtype=table_dtype, w_alpha=0.05, w_l1=0.15, w_l2=1.0)
    jcfg = JConfig(**kw)
    rng = np.random.default_rng(6)
    lin_w = (rng.standard_normal(N_FEATS) * 0.2).astype(np.float32)
    lin_w[::5] = 0.0
    vec_w = None
    if jcfg.ref_row_width:
        vec_w = (rng.standard_normal((N_FEATS, jcfg.ref_row_width)) * 0.2).astype(np.float32)
        vec_w[::3, ::2] = 0.0
    js = j_make_model(jcfg).init_from_weights(np.float32(-0.4), lin_w, vec_w)
    ts = make_model(Config(**kw, device="cpu")).init_from_weights(np.float32(-0.4), lin_w, vec_w)
    _states_equal(ts, js._replace(step=np.asarray(js.step)))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cli_checkpoint_serves_the_same_eval_line(tmp_path, direction, capsys):
    """One CLI trains with --model_path, the other serves the checkpoint
    with --load_model: the eval line equals the writer's own serve-only
    run's."""
    train = _write_ffm_file(tmp_path / "train.ffm", seed=0)
    evald = _write_ffm_file(tmp_path / "eval.ffm", n=40, seed=1)
    ckpt = str(tmp_path / "m.ckpt")
    port = (torch_main, ["--device", "cpu"])
    jax = (jax_main, [])
    writer, reader = (port, jax) if direction == "port_to_jax" else (jax, port)
    base = [*MODEL_FLAGS, "--batch_size", "16", "--w_alpha", "0.05"]
    assert writer[0](["--train_data", train, "--n_epochs", "2", "--model_path", ckpt,
                      *base, *writer[1]]) == 0
    capsys.readouterr()
    lines = []
    for main, extra in (writer, reader):
        assert main(["--load_model", ckpt, "--eval_data", evald, *base, *extra]) == 0
        lines.append([l for l in capsys.readouterr().out.splitlines() if l.startswith("eval")])
    assert lines[0] == lines[1] and len(lines[0]) == 1


def test_inplace_checkpoint_holds_the_mirror(tmp_path):
    """Under the in-place update the linear tables ride stale; a checkpoint
    (mid-training and final) holds them reconciled from the mirror lane."""
    data = write_fixture(tmp_path / "t.ffm", "libffm", seed=0)
    ckpt = str(tmp_path / "m.ckpt")
    tr = Trainer(Config(train_data=data, model_type="FFM", n_fields=7, n_feats=40,
                        n_factors=16, batch_size=16, update_mode="inplace", save_every=3,
                        model_path=ckpt, device="cpu", w_alpha=0.05))
    tr.train_epoch()
    mid, extra = load_checkpoint(ckpt)
    assert extra["mid_training_step"] == 3
    lane = 7  # field_pad 8 with K=16: lane (0, 7) mirrors the linear table
    for name in ("lin_n", "lin_z", "lin_w"):
        np.testing.assert_array_equal(getattr(mid, name), getattr(mid, "vec_" + name[4:])[:, lane])
    tr.save_checkpoint(ckpt)
    final, _ = load_checkpoint(ckpt)
    assert np.abs(final.lin_z).max() > 0
    np.testing.assert_array_equal(final.lin_w, final.vec_w[:, lane])


# ------------------------------------------------ io/zstd.py
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_roundtrip_against_zstandard(level):
    rng = np.random.default_rng(level)
    a = rng.standard_normal(300_000).astype(np.float32)
    a[::3] = 0.0
    raw = a.tobytes()
    ours = _compress(raw, level)
    theirs = zstandard.ZstdCompressor(level=level).compress(raw)
    assert zstandard.ZstdDecompressor().decompress(ours) == raw
    assert zstd.decompress(theirs) == raw
    assert zstandard.get_frame_parameters(ours).content_size == len(raw)
    # streamed both ways, in uneven pieces, without a content size
    sink = io.BytesIO()
    with zstd.Compressor(sink, level) as c:
        for i in range(0, len(raw), 77_777):
            c.write(raw[i:i + 77_777])
        c.end()
    assert zstandard.ZstdDecompressor().stream_reader(io.BytesIO(sink.getvalue())).read() == raw
    sink2 = io.BytesIO()
    with zstandard.ZstdCompressor(level=level, write_content_size=False).stream_writer(
            sink2, closefd=False) as w:
        w.write(raw)
    assert zstd.decompress(sink2.getvalue()) == raw
    r = zstd.Reader(io.BytesIO(sink2.getvalue()))
    out = np.empty(len(raw), np.uint8)
    assert r.readinto(out[:1000]) == 1000 and r.readinto(out[1000:]) == len(raw) - 1000
    assert out.tobytes() == raw and r.readinto(np.empty(8, np.uint8)) == 0


def test_zstd_errors_are_loud(monkeypatch):
    frame = _compress(b"x" * 100_000)
    with pytest.raises(zstd.ZstdError, match="truncated"):
        zstd.decompress(frame[: len(frame) // 2])
    with pytest.raises(zstd.ZstdError, match="ZSTD_decompressStream"):
        zstd.decompress(b"not a zstd frame at all")
    monkeypatch.setattr(zstd, "_locate", lambda: "/nonexistent/libzstd.so.1")
    zstd.lib.cache_clear()
    try:
        with pytest.raises(zstd.ZstdUnavailable, match="libzstd"):
            _compress(b"abc")
    finally:
        monkeypatch.undo()
        zstd.lib.cache_clear()


def test_save_and_load_without_zstandard_or_ml_dtypes(tmp_path):
    """On a host with neither package (a CUDA image may have only the
    system's libzstd) the port saves, loads and exchanges reference
    models all the same."""
    code = f"""
import sys
sys.modules["zstandard"] = None
sys.modules["ml_dtypes"] = None
import numpy as np, torch
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.io import checkpoint as ck
from ftrl_ffm_tpu_torch.models import make_model
cfg = Config(model_type="FFM", n_fields=4, n_feats=30, n_factors=4, device="cpu",
             table_dtype="bfloat16")
m = make_model(cfg)
s = m.init()
path = {str(tmp_path / "x.ckpt")!r}
ck.save_checkpoint(path, s, extra={{"model_config": ck.model_signature(cfg)}})
back, extra = ck.load_checkpoint(path)
assert back.vec_w.dtype == torch.bfloat16 and torch.equal(back.vec_w, s.vec_w)
assert np.array_equal(back.lin_z, s.lin_z.numpy()) and int(back.step) == 0
blob = {str(tmp_path / "x.zst")!r}
ck.export_reference_model(blob, *m.materialize_weights(s))
b, l, v = ck.import_reference_model(blob, 30, 16)
assert np.array_equal(v, m.materialize_weights(s)[2].float().numpy())
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
