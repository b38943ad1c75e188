"""The port reads the JAX package's FTRLTPU1 checkpoints."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.io.checkpoint import model_signature as j_signature
from ftrl_ffm_tpu.io.checkpoint import save_checkpoint as j_save
from ftrl_ffm_tpu.models import make_model as j_make_model
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import (
    IncompatibleStateError,
    load_checkpoint,
    model_signature,
    state_from_jax_arrays,
    validate_header_compat,
)
from ftrl_ffm_tpu_torch.train import Trainer

SHAPE = dict(model_type="FFM", n_feats=50, n_fields=7, n_factors=16)


@pytest.fixture
def saved(tmp_path):
    """A JAX FFM state with every table non-trivial, saved as the JAX
    Trainer saves it (header with model_config)."""
    jcfg = JConfig(**SHAPE)
    state = j_make_model(jcfg).init()
    rng = np.random.default_rng(0)
    state = state._replace(
        **{
            name: jnp.asarray(rng.random(np.shape(a)).astype(np.float32))
            for name, a in state._asdict().items()
            if name not in ("step",) and a is not None
        },
        step=jnp.asarray(17, jnp.int32),
    )
    path = str(tmp_path / "m.ckpt")
    j_save(path, state, extra={"model_config": j_signature(jcfg)})
    return path, state


def test_jax_checkpoint_loads_into_port(saved):
    path, state = saved
    loaded, extra = load_checkpoint(path)
    for name, a in state._asdict().items():
        got = getattr(loaded, name)
        assert got.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(got, np.asarray(a))
    cfg = TConfig(device="cpu", **SHAPE)
    assert extra["model_config"] == model_signature(cfg)
    validate_header_compat(cfg, extra, path)
    placed = state_from_jax_arrays(loaded, "cpu")
    assert placed.vec_w.dtype == torch.float32 and placed.step.dtype == torch.int32
    assert int(placed.step) == 17


@pytest.mark.parametrize(
    "change", [{"n_feats": 51}, {"n_factors": 8}, {"n_fields": 8}, {"model_type": "FM"}]
)
def test_header_mismatch_raises(saved, change):
    path, _ = saved
    _, extra = load_checkpoint(path)
    cfg = TConfig(device="cpu", **{**SHAPE, **change})
    with pytest.raises(IncompatibleStateError, match="different model config"):
        validate_header_compat(cfg, extra, path)


def test_legacy_cli_config_header_is_compared(saved):
    path, _ = saved
    extra = {"config": {"model_type": "ffm", "n_feats": 50, "n_fields": 9}}
    with pytest.raises(IncompatibleStateError, match="n_fields"):
        validate_header_compat(TConfig(device="cpu", **SHAPE), extra, path)


def test_trainer_refuses_mis_shaped_state(saved, tmp_path):
    """A state that passes no header check still meets the shape check."""
    path, _ = saved
    loaded, _ = load_checkpoint(path)
    data = tmp_path / "e.ffm"
    data.write_text("1 0:1:1 1:2:1\n")
    cfg = TConfig(device="cpu", eval_data=str(data), **{**SHAPE, "n_feats": 40})
    with pytest.raises(IncompatibleStateError, match="n_feats=40"):
        Trainer(cfg, state=state_from_jax_arrays(loaded, "cpu"))


def test_not_a_checkpoint(tmp_path):
    import zstandard

    bad = tmp_path / "x.ckpt"
    bad.write_bytes(zstandard.ZstdCompressor().compress(b"NOTMAGIC" + b"\0" * 8))
    with pytest.raises(ValueError, match="not a ftrl_ffm_tpu checkpoint"):
        load_checkpoint(str(bad))


def test_bf16_table_refused():
    """A bfloat16 table is no longer refused: it crosses bit for bit (as
    int16 bits viewed as torch.bfloat16).  A dtype the port has no table
    of (float64) still is."""
    import ml_dtypes

    vec_w = (np.arange(32, dtype=np.float32).reshape(4, 8) / 7 - 2).astype(ml_dtypes.bfloat16)
    state = {
        "bias_n": np.zeros((), np.float32), "bias_z": np.zeros((), np.float32),
        "lin_n": np.zeros(4, np.float32), "lin_z": np.zeros(4, np.float32),
        "lin_w": np.zeros(4, np.float32), "vec_n": None, "vec_z": None,
        "vec_w": vec_w, "step": np.zeros((), np.int32),
    }
    got = state_from_jax_arrays(state, "cpu").vec_w
    assert got.dtype == torch.bfloat16 and got.shape == (4, 8)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), vec_w.view(np.int16))
    with pytest.raises(IncompatibleStateError, match="float32 and bfloat16"):
        state_from_jax_arrays({**state, "vec_w": np.zeros((4, 8))}, "cpu")
