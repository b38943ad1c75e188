"""The port's train step (models/base.py::Model.train_step, FFM's fused
gradient and the in-place update, on the CPU with their plain versions)
against the JAX package's train step and the per-sample reference oracle,
from one carried initial state; Model.init; determinism.

Chained steps are held to rtol=2e-3, atol=5e-5 on the accumulators: the
bound the JAX suite holds its own Pallas and XLA step trajectories to
(tests/test_ffm_pallas.py::test_train_step_pallas_aug_matches_xla), since
ulp-level differences in the gradient pass through the closed form's
|z| <= l1 threshold.  The B=1 oracle trajectory uses tests/test_models.py's
bounds."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ftrl_ffm_tpu.ops.ffm_pallas as fp
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.models import Batch as JBatch
from ftrl_ffm_tpu.models import make_model as j_make_model
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
from ftrl_ffm_tpu_torch.models import make_model as t_make_model
from ftrl_ffm_tpu_torch.models.base import Batch as TBatch
from ftrl_ffm_tpu_torch.ops.layout import kmajor_to_reference
from ftrl_ffm_tpu_torch.train import Trainer
from tests.reference_oracle import Oracle

CHAIN_RTOL, CHAIN_ATOL = 2e-3, 5e-5
HP = dict(w_alpha=0.05, w_l1=0.15, w_l2=1.0)
# 7 fields at K=16 pad to field_pad 8: dead lane 7 carries the linear
# gradient.  8 fields at K=16 need no padding: no dead lane, the linear
# stats take their own [N, 2] payload.
SEVEN = dict(model_type="FFM", n_fields=7, n_factors=16, n_feats=60, batch_size=16, **HP)
EIGHT = dict(model_type="FFM", n_fields=8, n_factors=16, n_feats=60, batch_size=16, **HP)


def _batch(rng, b, f, c, r):
    """Random occurrences with a padding column and a padded last sample."""
    fields = rng.integers(0, c, (b, f)).astype(np.int32)
    feats = rng.integers(0, r, (b, f)).astype(np.int32)
    vals = (rng.random((b, f)) + 0.05).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    fields[:, -1], feats[:, -1], vals[:, -1] = 0, r, 0.0
    fields[-1], feats[-1], vals[-1], y[-1], sw[-1] = 0, r, 0.0, 0.0, 0.0
    return fields, feats, vals, y, sw


def _assert_states_close(t_state, j_state, rtol=CHAIN_RTOL, atol=CHAIN_ATOL):
    for name in ("bias_z", "lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w"):
        np.testing.assert_allclose(
            getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
            rtol=rtol, atol=atol, err_msg=name,
        )
    assert int(t_state.step) == int(j_state.step)


@pytest.mark.parametrize("shape", [SEVEN, EIGHT], ids=["aug", "no_dead_lane"])
@pytest.mark.parametrize("pallas", ["on", "off"])
def test_train_step_matches_jax(monkeypatch, shape, pallas):
    """3 chained steps from one JAX-made init: against the JAX step through
    its fused Pallas kernel (interpret mode, the aug payload where a dead
    lane exists) and through its XLA path."""
    if pallas == "on":
        for fn_name in ("ffm_fused_logits_grads", "ffm_fused_logits"):
            monkeypatch.setattr(
                fp, fn_name, functools.partial(getattr(fp, fn_name), interpret=True)
            )
    b, f, r, c = shape["batch_size"], 6, shape["n_feats"], shape["n_fields"]
    jm = j_make_model(JConfig(use_pallas=pallas, max_nnz=f, **shape))
    tm = t_make_model(TConfig(device="cpu", max_nnz=f, **shape))
    j_state = jm.init()
    t_state = state_from_jax_arrays(j_state, "cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        arrays = _batch(rng, b, f, c, r)
        j_out = jm.train_step(j_state, JBatch(*(jnp.asarray(a) for a in arrays)))
        t_out = tm.train_step(t_state, TBatch(*(torch.from_numpy(a) for a in arrays)))
        assert t_out.state is t_state  # updated in place
        j_state = j_out.state
        np.testing.assert_allclose(t_out.logits.numpy(), np.asarray(j_out.logits),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(t_out.loss_sum), float(j_out.loss_sum), rtol=1e-5)
        assert float(t_out.count) == float(j_out.count) == b - 1
    _assert_states_close(t_state, j_state)


@pytest.mark.parametrize("semantics", ["keep_init", "reference"])
def test_b1_trajectory_matches_oracle(semantics):
    """Twin of tests/test_models.py::test_b1_trajectory_matches_oracle for
    FFM: 4 fields, K=3 (no dead lane), batch size 1, from the port's own
    init.  update_mode=dense: at B=1 the JAX package's auto picks its
    in-place huge-table form, whose math is the same."""
    n_feats, n_fields, k = 50, 4, 3
    cfg = TConfig(model_type="FFM", n_feats=n_feats, n_fields=n_fields, n_factors=k,
                  factor_semantics=semantics, batch_size=1, update_mode="dense",
                  device="cpu")
    model = t_make_model(cfg)
    state = model.init()
    vec_init = None
    if semantics == "keep_init":
        vec_init = kmajor_to_reference(state.vec_w, n_fields, k).numpy().copy()
    oracle = Oracle("FFM", n_feats, n_fields, k, vec_init=vec_init)
    rng = np.random.default_rng(7)
    for t in range(30):
        ids = rng.choice(n_feats, size=4, replace=False)
        fl = rng.integers(0, n_fields, size=4)
        vl = rng.random(4).astype(np.float32) + 0.1
        y = int(rng.random() < 0.5)
        fields = np.zeros((1, 6), np.int32)
        feats = np.full((1, 6), n_feats, np.int32)
        vals = np.zeros((1, 6), np.float32)
        fields[0, :4], feats[0, :4], vals[0, :4] = fl, ids, vl
        batch = TBatch(*(torch.from_numpy(a) for a in (
            fields, feats, vals, np.array([y], np.float32), np.ones(1, np.float32))))
        out = model.train_step(state, batch)
        ref_logit = oracle.train(fl, ids, vl, y)
        assert float(out.logits[0]) == pytest.approx(ref_logit, rel=2e-3, abs=2e-4), t
    np.testing.assert_allclose(state.lin_z.numpy(), oracle.lin_z, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(state.lin_n.numpy(), oracle.lin_n, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(
        kmajor_to_reference(state.vec_z, n_fields, k).numpy(), oracle.vec_z,
        rtol=2e-2, atol=2e-4,
    )


def test_model_init():
    model = t_make_model(TConfig(device="cpu", **SEVEN))
    a, b = model.init(), model.init()
    for x, y in zip(a, b):  # seeded with cfg.seed: reproducible
        assert torch.equal(x, y)
    other = model.init(torch.Generator().manual_seed(1))
    assert not torch.equal(other.vec_w, a.vec_w)
    lane_field = torch.arange(128) % 8
    assert (a.vec_w[:, lane_field == 7] == 0).all()  # dead lane: the mirror
    live = a.vec_w[:, lane_field < 7]
    assert (live != 0).all()
    assert abs(float(live.std()) - 0.02) < 0.002 and abs(float(live.mean())) < 0.002
    for name in ("bias_n", "bias_z", "lin_n", "lin_z", "lin_w", "vec_n", "vec_z"):
        assert (getattr(a, name) == 0).all()
    assert a.step.dtype == torch.int32 and int(a.step) == 0
    assert a.vec_w.shape == (60, 128) and a.vec_w.is_contiguous()
    ref = t_make_model(TConfig(device="cpu", factor_semantics="reference", **SEVEN)).init()
    assert (ref.vec_w == 0).all()
    # no dead lane: every slot starts random
    assert (t_make_model(TConfig(device="cpu", **EIGHT)).init().vec_w != 0).all()


@pytest.mark.parametrize("table", ["linear", "factor", "any"])
def test_has_zero_weights_matches_jax(table, tmp_path):
    from ftrl_ffm_tpu.train import Trainer as JTrainer
    from tests.test_torch_models import write_7field

    path = write_7field(tmp_path / "train.ffm", n=64, seed=2)
    jtr = JTrainer(JConfig(train_data=path, n_epochs=2, max_nnz=7, **SEVEN))
    jtr.train()
    tm = t_make_model(TConfig(device="cpu", **SEVEN))
    got = tm.has_zero_weights(state_from_jax_arrays(jtr.state, "cpu"), table)
    assert got == jtr.model.has_zero_weights(jtr.state, table)
    with pytest.raises(ValueError, match="unknown table"):
        tm.has_zero_weights(state_from_jax_arrays(jtr.state, "cpu"), "bias")


@pytest.mark.parametrize(
    "kw,kind",
    [({"update_mode": "inplace"}, "inplace"), ({"update_mode": "sparse"}, "sparse2"),
     ({"n_feats": 100_000, "update_mode": "inplace"}, "inplace"),
     # once refused (Queue 1 item 4): a bf16 payload, then a bf16 table too
     ({"acc_dtype": "bfloat16"}, "dense2"),
     ({"acc_dtype": "bfloat16", "table_dtype": "bfloat16"}, "dense2")],
)
def test_train_step_takes_every_update_kind(monkeypatch, kw, kind):
    """The updates the port once refused train and match the JAX step from
    one JAX-made init; the in-place form also at n_feats=100k, B=16 (the
    shape where JAX's auto takes it; the port's auto takes "dense2",
    ftrl.py::update_form, so both sides force it).  A bf16 payload is held against the JAX step through its fused
    Pallas kernel (interpret mode), the only JAX path that emits one; a
    bf16 w within one bf16 ulp (rtol 2^-7): an f32 w one ulp off can round
    to the neighbouring bf16."""
    cfg = {**SEVEN, **kw}
    pallas = "on" if "acc_dtype" in kw else "off"
    if pallas == "on":
        for fn_name in ("ffm_fused_logits_grads", "ffm_fused_logits"):
            monkeypatch.setattr(
                fp, fn_name, functools.partial(getattr(fp, fn_name), interpret=True)
            )
    jm = j_make_model(JConfig(use_pallas=pallas, max_nnz=6, **cfg))
    model = t_make_model(TConfig(device="cpu", max_nnz=6, **cfg))
    assert model.form == kind
    j_state = jm.init()
    state = state_from_jax_arrays(j_state, "cpu")
    arrays = _batch(np.random.default_rng(0), 16, 6, 7, 60)
    out = model.train_step(state, TBatch(*(torch.from_numpy(a) for a in arrays)))
    j_out = jm.train_step(j_state, JBatch(*(jnp.asarray(a) for a in arrays)))
    np.testing.assert_allclose(float(out.loss_sum), float(j_out.loss_sum), rtol=1e-5)
    for name in ("bias_z", "lin_n", "lin_z", "lin_w", "vec_n", "vec_z"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(j_out.state, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(state.vec_w.float().numpy(),
                               np.asarray(j_out.state.vec_w).astype(np.float32),
                               rtol=2.0 ** -7 if "table_dtype" in kw else 1e-5, atol=1e-6)
    assert int(state.step) == int(j_out.state.step) == 1


def _write_4field(path, n=96, seed=0):
    """tests/test_determinism.py's data: 4 fields, 50 ids, values 1."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 50))}:1" for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    return str(path)


@pytest.mark.parametrize("online", [True, False])
def test_training_is_bit_deterministic(tmp_path, online):
    """Twin of tests/test_determinism.py::test_training_is_bit_deterministic:
    two fresh port trainings give the same bits."""
    path = _write_4field(tmp_path / "d.ffm")
    kw = dict(train_data=path, model_type="FFM", n_fields=4, n_feats=50, n_factors=3,
              batch_size=16, n_epochs=2, online=online, device="cpu")
    states = []
    for _ in range(2):
        tr = Trainer(TConfig(**kw))
        tr.train()
        states.append(tr.state)
    for a, b in zip(*states):
        assert torch.equal(a, b)
    assert int(states[0].step) == 12
