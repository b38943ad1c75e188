"""End to end: the port's Trainer.train and CLI training (--device cpu)
against the JAX package's, from one carried initial state.

Histories within 1e-4 (f32 sums in another order, closed in float64);
states within the chained-step bound rtol=2e-3, atol=5e-5 (see
tests/test_torch_train.py); CLI epoch lines equal up to a flip of their last
printed digit; predictions within 2e-5 after two epochs of training from
one checkpoint (the trained states differ by f32 rounding)."""

import io
import re
import sys

import numpy as np
import pytest

from ftrl_ffm_tpu.cli import main as jax_main
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch.cli import main as torch_main
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
from ftrl_ffm_tpu_torch.train import Trainer
from tests.test_torch_models import write_7field
from tests.test_torch_serve import MODEL_FLAGS, SHAPE
from tests.test_torch_train import _assert_states_close


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer")
    return write_7field(d / "train.ffm", n=100, seed=0), write_7field(d / "eval.ffm", n=40, seed=1)


def _same_history(got: dict, ref: dict) -> None:
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(
            np.array(got[key], np.float64), np.array(ref[key], np.float64),
            rtol=0, atol=1e-4, err_msg=key,
        )


@pytest.mark.parametrize("mode", ["online", "offline", "cmd"])
def test_trainer_train_matches_jax(data, mode, monkeypatch, capsys):
    """Online streaming, offline epochs shuffled by default_rng(seed), and
    --cmd stdin streaming (whose second epoch finds stdin spent, as the JAX
    package's does), 2 epochs with eval after each."""
    train, evald = data
    kw = dict(SHAPE, train_data=train, eval_data=evald, n_epochs=2,
              file_type="libffm", max_nnz=7)
    if mode == "offline":
        kw["online"] = False
    if mode == "cmd":
        kw.update(cmd=True, train_data="")
    jtr = JTrainer(JConfig(**kw))
    ttr = Trainer(TConfig(device="cpu", **kw), state=state_from_jax_arrays(jtr.state, "cpu"))
    hist = {}
    for name, tr in (("jax", jtr), ("torch", ttr)):
        with open(train) as f:
            monkeypatch.setattr(sys, "stdin", f)
            hist[name] = tr.train()
    _same_history(hist["torch"], hist["jax"])
    assert np.isfinite(hist["torch"]["train_loss"][0])
    _assert_states_close(ttr.state, jtr.state)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("epoch")]
    assert len(lines) == 8 and lines[0].startswith("epoch 1 train time: ")


def test_train_epoch_without_rng_shuffles_anew(data):
    """Repeated train_epoch() calls draw from one persistent default_rng
    (ftrl_ffm_tpu/train.py::train_epoch): the same losses as JAX's."""
    train, _ = data
    kw = dict(SHAPE, train_data=train, online=False, max_nnz=7)
    jtr = JTrainer(JConfig(**kw))
    ttr = Trainer(TConfig(device="cpu", **kw), state=state_from_jax_arrays(jtr.state, "cpu"))
    for _ in range(2):
        assert abs(ttr.train_epoch() - jtr.train_epoch()) <= 1e-4
    assert ttr._steps_done == jtr._steps_done == 14


def _epoch_numbers(out: str):
    """The loss and AUC numbers of the epoch lines (times dropped), and
    the lines' count."""
    lines = [l for l in out.splitlines() if l.startswith("epoch")]
    return [float(x) for x in re.findall(r"(?:loss|auc): ([0-9.]+)", "\n".join(lines))], len(lines)


def test_cli_resumes_and_trains_a_jax_checkpoint(data, tmp_path):
    train, evald = data
    ckpt = str(tmp_path / "m.ckpt")
    assert jax_main(["--train_data", train, "--model_path", ckpt, *MODEL_FLAGS]) == 0
    outs = {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        buf = io.StringIO()
        old, sys.stdout = sys.stdout, buf
        try:
            rc = main([
                "--load_model", ckpt, "--train_data", train, "--eval_data", evald,
                "--n_epochs", "2", "--predict_data", evald,
                "--predict_output", str(tmp_path / f"{name}.txt"), *MODEL_FLAGS, *extra,
            ])
        finally:
            sys.stdout = old
        assert rc == 0
        outs[name] = buf.getvalue()
    assert "resumed from" in outs["torch"]
    (got, n_got), (ref, n_ref) = _epoch_numbers(outs["torch"]), _epoch_numbers(outs["jax"])
    assert n_got == n_ref == 4 and len(got) == len(ref) == 6
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.01e-4)
    p_got = np.loadtxt(tmp_path / "torch.txt")
    p_ref = np.loadtxt(tmp_path / "jax.txt")
    assert p_got.shape == p_ref.shape == (40,)
    np.testing.assert_allclose(p_got, p_ref, rtol=0, atol=2e-5)


def test_cli_trains_from_stdin(data, tmp_path, monkeypatch, capsys):
    train, _ = data
    with open(train) as f:
        monkeypatch.setattr(sys, "stdin", f)
        assert torch_main([
            "--cmd", "true", "--file_type", "libffm", "--max_nnz", "7",
            *MODEL_FLAGS, "--device", "cpu",
        ]) == 0
    assert re.search(r"epoch 1 train time: [0-9.]+s, train loss: 0\.[0-9]{4}",
                     capsys.readouterr().out)


@pytest.mark.parametrize(
    "flags,msg",
    [
        (["--cmd", "true"], "--file_type"),
        (["--cmd", "true", "--file_type", "libffm"], "--max_nnz"),
    ],
)
def test_cmd_needs_format_and_nnz(flags, msg):
    with pytest.raises(ValueError, match=msg):
        torch_main([*flags, *MODEL_FLAGS, "--device", "cpu"])
