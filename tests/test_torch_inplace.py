"""The port's huge-table training path on the CPU against the JAX package:
the closed-form pass (ftrl.py::closed_form_pass_plain, the plain version of
csrc/ftrl_pass.cu) against the Pallas `_pass_kernel` in interpret mode and
the fori-loop form, the in-place and sparse table updates, the split
payload of kernel #2, Model.train_step under "inplace" and "sparse", the
Trainer's stale linear tables and their reconcile from the mirror lane,
has_zero_weights, and the device-memory estimate.  The same seeded numpy
inputs go through both packages.

Tolerances: the pass and the table updates rtol=1e-6, atol=1e-7 (the same
f32 operations; duplicate ids summed in another order, and the port adds a
row's sum of g to z where JAX adds each g in turn); one train step
rtol=1e-5, atol=1e-6; chained steps and whole runs the JAX suite's
kernel-vs-XLA bound rtol=2e-3, atol=5e-5, and the Trainer's linear tables
tests/test_train.py's bounds."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ftrl_ffm_tpu.ops.ffm_pallas as fp
from ftrl_ffm_tpu import ftrl as jftrl
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.models import Batch as JBatch
from ftrl_ffm_tpu.models import make_model as j_make_model
from ftrl_ffm_tpu.ops.ftrl_pallas import closed_form_pass_pallas
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu.train import estimate_hbm_bytes as j_estimate
from ftrl_ffm_tpu_torch import ftrl as tftrl
from ftrl_ffm_tpu_torch.config import Config as TConfig
from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
from ftrl_ffm_tpu_torch.models import make_model as t_make_model
from ftrl_ffm_tpu_torch.models.base import Batch as TBatch
from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits_grads
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import (
    closed_form_pass,
    ftrl_update_inplace,
    ftrl_update_linear,
    za_scatter,
    za_scatter_plain,
)
from ftrl_ffm_tpu_torch.train import Trainer, estimate_hbm_bytes
from tests.common import write_fixture
from tests.test_torch_ftrl import P, _ids, _tables
from tests.test_torch_fused_kernel import _inputs
from tests.test_torch_train import EIGHT, SEVEN, _batch

RTOL, ATOL = 1e-6, 1e-7
CHAIN_RTOL, CHAIN_ATOL = 2e-3, 5e-5


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, ref, rtol=RTOL, atol=ATOL):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=atol)


def _pass_inputs(seed, r, d):
    """n, z', w as training leaves them, and A zero on 40% of coordinates."""
    rng = np.random.default_rng(seed)
    n, z, w = _tables(rng, r, d)
    a = (rng.random((r, d)) * 0.5).astype(np.float32)
    a[rng.random((r, d)) < 0.4] = 0.0
    return n, z, w, a


def test_plain_pass_matches_pallas_interpret():
    """closed_form_pass_plain == ops/ftrl_pallas.py's _pass_kernel
    (interpret mode) at its own test shape; A = 0 keeps n and z bits."""
    n, z, w, a = _pass_inputs(0, 64, 128)
    ref = closed_form_pass_pallas(
        *(jnp.asarray(x) for x in (n, z, w, a)), jftrl.FtrlParams(*P), interpret=True
    )
    assert ref is not None
    got = tftrl.closed_form_pass_plain(*_t((n, z, w, a)), tftrl.FtrlParams(*P))
    _close(got, ref)
    zero = a == 0
    np.testing.assert_array_equal(got[0].numpy()[zero], n[zero])
    np.testing.assert_array_equal(got[1].numpy()[zero], z[zero])


@pytest.mark.parametrize("r,d,block_rows", [(41, 6, 16), (64, 128, 131072)])
def test_dense_update_inplace_matches_jax(r, d, block_rows):
    """The in-place update: z += per-row sum of g, A = per-row sum of g^2
    (duplicate and sentinel ids), then the pass, against JAX's fori-loop
    form (R=41, D=6: blocks of 16 and a tail of 9)."""
    rng = np.random.default_rng(r + d)
    tables = _tables(rng, r, d)
    ids = _ids(rng, r, 3 * r)
    g = (rng.normal(size=(3 * r, d)) * 0.2).astype(np.float32)
    ref = jftrl.dense_ftrl_update_inplace(
        *(jnp.asarray(x) for x in (*tables, ids, g, g * g)), jftrl.FtrlParams(*P),
        block_rows=block_rows,
    )
    got = tftrl.dense_ftrl_update_inplace(*_t((*tables, ids, g, g * g)), tftrl.FtrlParams(*P))
    _close(got, ref)
    # rows no id touches keep n and z bits
    for g_t, before in zip(got[:2], tables[:2]):
        np.testing.assert_array_equal(g_t.numpy()[r - 3:], before[r - 3:])


@pytest.mark.parametrize("d", [16, 640])
def test_scatter_on_hot_ids_matches_jax(d):
    """FM's [R, 16] and FFM's 640-wide rows with two ids in most payload
    rows (segments of ~900 and ~500 rows, the column-split kernels' case on
    the card): za_scatter_plain gives JAX's z.at[ids].add(g) and
    zeros.at[ids].add(g2) bit for bit (g a multiple of 2^-10 and z of
    2^-6, so every partial sum is exact in f32 and the order of the adds
    cannot show), and dense_ftrl_update_inplace the JAX form's tables
    within rtol=1e-6, atol=1e-7 (the same f32 operations)."""
    rng = np.random.default_rng(d)
    r, nnz = 64, 2000
    tables = _tables(rng, r, d)
    tables[1] = np.round(tables[1] * 64) / 64
    ids = _ids(rng, r, nnz)
    hot = rng.random(nnz)
    ids[hot < 0.45] = 5
    ids[(hot >= 0.45) & (hot < 0.7)] = 9
    assert min(int((ids == 5).sum()), int((ids == 9).sum())) > 64
    g = (rng.integers(-64, 65, (nnz, d)) / 1024).astype(np.float32)
    z_ref = jnp.asarray(tables[1]).at[ids].add(g, mode="drop")
    a_ref = jnp.zeros((r, d), jnp.float32).at[ids].add(g * g, mode="drop")
    z_got, a_got = za_scatter_plain(*_t((tables[1], ids, g, g * g)))
    np.testing.assert_array_equal(z_got.numpy(), np.asarray(z_ref))
    np.testing.assert_array_equal(a_got.numpy(), np.asarray(a_ref))
    ref = jftrl.dense_ftrl_update_inplace(
        *(jnp.asarray(x) for x in (*tables, ids, g, g * g)), jftrl.FtrlParams(*P))
    got = tftrl.dense_ftrl_update_inplace(*_t((*tables, ids, g, g * g)), tftrl.FtrlParams(*P))
    _close(got, ref)


@pytest.mark.parametrize("width", [0, 6])
def test_sparse_update2_matches_jax(width):
    rng = np.random.default_rng(11)
    r, nnz = 20, 48
    shape = (r, width) if width else (r,)
    tables = _tables(rng, *shape)
    ids = _ids(rng, r, nnz)
    g = (rng.normal(size=(nnz, max(1, width))) * 0.2).astype(np.float32)
    gg2 = np.concatenate([g, g * g], axis=-1)
    ref = jftrl.sparse_ftrl_update2(
        *(jnp.asarray(x) for x in (*tables, ids, gg2)), jftrl.FtrlParams(*P)
    )
    got = tftrl.sparse_ftrl_update2(*_t((*tables, ids, gg2)), tftrl.FtrlParams(*P))
    _close(got, ref)
    for g_t, before in zip(got, tables):
        np.testing.assert_array_equal(g_t.numpy()[r - 3:], before[r - 3:])


def test_inplace_wrappers_update_in_place_on_the_cpu():
    """ftrl_update_inplace, za_scatter, closed_form_pass and
    ftrl_update_linear on CPU tensors write their plain version's result
    into the given tables and launch nothing."""
    rng = np.random.default_rng(12)
    r, d, nnz = 24, 8, 64
    p_t = tftrl.FtrlParams(*P)
    tables = _tables(rng, r, d)
    ids = _ids(rng, r, nnz)
    g = (rng.normal(size=(nnz, d)) * 0.2).astype(np.float32)
    counts = [f.launches for f in (za_scatter, closed_form_pass)]
    ts = _t((*tables, ids, g, g * g))
    ftrl_update_inplace(*ts, p_t)
    for got, want in zip(ts[:3], tftrl.dense_ftrl_update_inplace(*_t((*tables, ids, g, g * g)), p_t)):
        assert torch.equal(got, want)
    z, a = torch.from_numpy(tables[1].copy()), torch.zeros((r, d))
    za_scatter(z, a, *_t((ids, g, g * g)))
    for got, want in zip((z, a), za_scatter_plain(*_t((tables[1], ids, g, g * g)))):
        assert torch.equal(got, want)
    n_, z_, w_, a_ = _t(_pass_inputs(13, r, d))
    want = tftrl.closed_form_pass_plain(n_, z_, w_, a_, p_t)
    closed_form_pass(n_, z_, w_, a_, p_t)
    for got, w_ref in zip((n_, z_, w_), want):
        assert torch.equal(got, w_ref)
    lin = _t(_tables(rng, r))
    gl = g[:, 0]
    gg2_lin = np.stack([gl, gl * gl], axis=-1)
    ref = jftrl.dense_ftrl_update2(
        *(jnp.asarray(x) for x in (*[t.numpy().copy() for t in lin], ids, gg2_lin)),
        jftrl.FtrlParams(*P),
    )
    ftrl_update_linear(*lin, *_t((ids, gg2_lin)), p_t)
    _close(lin, ref)
    assert [f.launches for f in (za_scatter, closed_form_pass)] == counts


@pytest.mark.parametrize("b,f,c,k,aug", [(24, 3, 7, 16, 6), (8, 8, 8, 4, -1), (16, 10, 40, 16, 39)])
def test_split_payload_matches_pallas_interpret(b, f, c, k, aug):
    """Kernel #2's split output (combined_out=False): the plain version
    against the Pallas kernel in interpret mode, with and without the
    linear gradient in aug_lane."""
    arrays = _inputs(b, f, c, k, 6)
    logits, g, g2 = ffm_fused_logits_grads(
        *(torch.from_numpy(a) for a in arrays), c, k, aug_lane=aug, combined_out=False
    )
    ref_logits, ref_g, ref_g2 = fp.ffm_fused_logits_grads(
        *(jnp.asarray(a) for a in arrays), c, k,
        compute_grads=True, block_b=8, interpret=True, aug_lane=aug, combined_out=False,
    )
    assert g.shape == g2.shape == (b * f, c * k)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g2.numpy(), np.asarray(ref_g2), rtol=1e-4, atol=1e-6)
    # the halves of the combined output, bit for bit
    _, gg2 = ffm_fused_logits_grads(*(torch.from_numpy(a) for a in arrays), c, k, aug_lane=aug)
    assert torch.equal(g, gg2[:, : c * k]) and torch.equal(g2, gg2[:, c * k:])


def _assert_states_close(t_state, j_state, rtol=CHAIN_RTOL, atol=CHAIN_ATOL):
    for name in ("bias_z", "lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w"):
        np.testing.assert_allclose(
            getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
            rtol=rtol, atol=atol, err_msg=name,
        )
    assert int(t_state.step) == int(j_state.step)


def _steps_against_jax(monkeypatch, shape, pallas, n_steps, **kw):
    """n_steps chained train steps of both packages from one JAX-made
    init; returns [(port state, JAX state)] after each step."""
    if pallas == "on":
        for fn_name in ("ffm_fused_logits_grads", "ffm_fused_logits"):
            monkeypatch.setattr(
                fp, fn_name, functools.partial(getattr(fp, fn_name), interpret=True)
            )
    cfg = {**shape, **kw}
    b, f, r, c = cfg["batch_size"], 6, cfg["n_feats"], cfg["n_fields"]
    jm = j_make_model(JConfig(use_pallas=pallas, max_nnz=f, **cfg))
    tm = t_make_model(TConfig(device="cpu", max_nnz=f, **cfg))
    j_state = jm.init()
    t_state = state_from_jax_arrays(j_state, "cpu")
    rng = np.random.default_rng(7)
    states = []
    for _ in range(n_steps):
        arrays = _batch(rng, b, f, c, r)
        j_out = jm.train_step(j_state, JBatch(*(jnp.asarray(a) for a in arrays)))
        t_out = tm.train_step(t_state, TBatch(*(torch.from_numpy(a) for a in arrays)))
        assert t_out.state is t_state
        j_state = j_out.state
        np.testing.assert_allclose(t_out.logits.numpy(), np.asarray(j_out.logits),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(t_out.loss_sum), float(j_out.loss_sum), rtol=1e-5)
        states.append((_clone(t_state), j_state))
    return states


@pytest.mark.parametrize("shape", [SEVEN, EIGHT], ids=["aug", "no_dead_lane"])
@pytest.mark.parametrize("mode", ["inplace", "sparse"])
@pytest.mark.parametrize("pallas", ["on", "off"])
def test_train_step_matches_jax(monkeypatch, shape, mode, pallas):
    """One step, then two more chained, under update_mode=inplace (split
    payload; with the dead-lane mirror the linear tables ride stale in both
    packages) and sparse, against the JAX step through its Pallas kernel
    (interpret mode) and its XLA path."""
    states = _steps_against_jax(monkeypatch, shape, pallas, 3, update_mode=mode)
    _assert_states_close(*states[0], rtol=1e-5, atol=1e-6)
    t_state, j_state = states[-1]
    _assert_states_close(t_state, j_state)
    stale = mode == "inplace" and shape is SEVEN
    assert bool((t_state.lin_z == 0).all()) == stale


def _write_7field_ffm(path, n=64, seed=0):
    """tests/test_train.py::_write_7field_ffm's data."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 60))}:1" for c in range(7)
            ]
            f.write(" ".join(toks) + "\n")
    return str(path)


def _mirror_cfg(train, **kw):
    """tests/test_train.py::_mirror_cfg: C=7, K=16 -> C'=8, a dead lane."""
    return dict(train_data=train, model_type="FFM", n_feats=60, n_fields=7, n_factors=16,
                n_epochs=2, online=True, batch_size=16, w_alpha=0.05, w_l1=0.15,
                w_l2=1.0, **kw)


def _clone(state):
    return type(state)(*(None if t is None else t.clone() for t in state))


def test_inplace_skips_lin_update_and_syncs_from_mirror(tmp_path):
    """Twin of tests/test_train.py::test_inplace_skips_lin_update_and_
    syncs_from_mirror, from one JAX-made init: the in-place run leaves the
    linear tables stale, logical_state reconciles them to the dense run's,
    and both match the JAX package's in-place run."""
    train = _write_7field_ffm(tmp_path / "train.ffm")
    jtr = JTrainer(JConfig(**_mirror_cfg(train, update_mode="inplace")))
    init = state_from_jax_arrays(jtr.state, "cpu")
    t_in = Trainer(TConfig(device="cpu", **_mirror_cfg(train, update_mode="inplace")),
                   state=_clone(init))
    assert t_in.model._lin_mirror_maintained()
    assert t_in._step.lin_rides_stale
    h_in = t_in.train()
    t_dn = Trainer(TConfig(device="cpu", **_mirror_cfg(train, update_mode="dense")),
                   state=_clone(init))
    assert not t_dn._step.lin_rides_stale
    h_dn = t_dn.train()
    np.testing.assert_allclose(h_in["train_loss"], h_dn["train_loss"], rtol=1e-6)
    assert (t_in.state.lin_z == 0).all()
    assert (t_dn.state.lin_z != 0).any()
    s_in, s_dn = t_in.logical_state, t_dn.logical_state
    np.testing.assert_allclose(s_in.lin_z.numpy(), s_dn.lin_z.numpy(), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(s_in.lin_n.numpy(), s_dn.lin_n.numpy(), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(s_in.lin_w.numpy(), s_dn.lin_w.numpy(), rtol=1e-5, atol=1e-8)
    # the reconciled tables are the mirror lane, bit for bit
    for t in "nzw":
        assert torch.equal(getattr(s_in, f"lin_{t}"), getattr(s_in, f"vec_{t}")[:, 7])
    h_j = jtr.train()
    np.testing.assert_allclose(h_in["train_loss"], h_j["train_loss"], rtol=1e-5)
    _assert_states_close(s_in, jtr.logical_state)


def test_mirror_off_keeps_exact_lin(tmp_path):
    """Twin of tests/test_train.py::test_mirror_off_keeps_exact_lin:
    without a dead lane the in-place run keeps the linear update (the
    linear-only form of the update kernel), and matches JAX's run."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    kw = dict(train_data=train, model_type="FFM", n_feats=40, n_fields=4, n_factors=4,
              n_epochs=2, online=True, batch_size=16, w_alpha=0.05, w_l1=0.15, w_l2=1.0,
              update_mode="inplace")
    jtr = JTrainer(JConfig(**kw))
    t = Trainer(TConfig(device="cpu", **kw), state=state_from_jax_arrays(jtr.state, "cpu"))
    assert t.model._lin_lane() == -1
    assert not t._step.lin_rides_stale
    h = t.train()
    assert (t.state.lin_z != 0).any()
    assert all(np.isfinite(h["train_loss"]))
    h_j = jtr.train()
    np.testing.assert_allclose(h["train_loss"], h_j["train_loss"], rtol=1e-5)
    _assert_states_close(t.state, jtr.state)


@pytest.mark.parametrize("mode", ["auto", "inplace", "sparse"])
def test_linear_mirror_invariant_all_paths(mode):
    """Twin of tests/test_field_pad.py::test_linear_mirror_invariant_all_
    paths: lane (0, n_fields) mirrors the linear table after training
    through the dense, the forced in-place (after the reconcile) and the
    sparse update."""
    b, c, k, r, f = 16, 39, 16, 64, 5
    cfg = TConfig(model_type="FFM", n_fields=c, n_feats=r, n_factors=k, batch_size=b,
                  max_nnz=f, update_mode=mode, device="cpu")
    m = t_make_model(cfg)
    st = m.init()
    rng = np.random.default_rng(4)
    for _ in range(3):
        batch = TBatch(
            torch.from_numpy(rng.integers(0, c, (b, f)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, r, (b, f)).astype(np.int32)),
            torch.from_numpy(rng.random((b, f)).astype(np.float32)),
            torch.from_numpy((rng.random(b) > 0.5).astype(np.float32)),
            torch.ones(b),
        )
        m.train_step(st, batch)
    if mode == "inplace":
        assert (st.lin_z == 0).all()  # stale by design
        st = m.sync_lin_from_mirror(st)
    np.testing.assert_allclose(st.vec_z[:, 39].numpy(), st.lin_z.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(st.vec_w[:, 39].numpy(), st.lin_w.numpy(), rtol=1e-5, atol=1e-8)
    assert st.lin_z.abs().max() > 0  # training happened


@pytest.mark.parametrize("table", ["linear", "factor", "any"])
def test_has_zero_weights_after_inplace_run(table, tmp_path):
    """has_zero_weights reconciles the stale linear tables first: the
    in-place run answers as the dense run and as the JAX package's
    in-place run."""
    train = _write_7field_ffm(tmp_path / "train.ffm", seed=2)
    jtr = JTrainer(JConfig(**_mirror_cfg(train, update_mode="inplace")))
    init = state_from_jax_arrays(jtr.state, "cpu")
    answers = []
    for mode in ("inplace", "dense"):
        tr = Trainer(TConfig(device="cpu", **_mirror_cfg(train, update_mode=mode)),
                     state=_clone(init))
        tr.train()
        answers.append(tr.model.has_zero_weights(tr.state, table))
    jtr.train()
    assert answers == [jtr.model.has_zero_weights(jtr.state, table)] * 2
    if table != "factor":
        assert answers[0]  # L1 zeroed some touched linear weights


def test_estimate_hbm_bytes_single_device_regimes():
    """Twin of tests/test_train.py::test_hbm_estimator_single_device_
    regimes: the resident state and the in-place kind's one [R, D]
    accumulator as the JAX package's; "dense2" allocates no [R, 2D]
    accumulator in the port (its kernel updates the touched rows in
    place), and the port's auto takes "dense2" at 1.2M rows, where JAX's
    takes "inplace" (ftrl.py::update_form); forced, the in-place
    kind's working set is JAX's."""
    kw = dict(model_type="FFM", n_fields=39, n_factors=16, max_nnz=39, batch_size=8192)
    w = TConfig(**kw).row_width
    nnz = 8192 * 39
    est = {r: estimate_hbm_bytes(TConfig(**kw, n_feats=r)) for r in (100_000, 1_200_000)}
    ref = {r: j_estimate(JConfig(**kw, n_feats=r)) for r in (100_000, 1_200_000)}
    assert est[100_000]["work"] == 3 * nnz * w * 4
    assert est[100_000]["work"] == ref[100_000]["work"] - 2 * 100_000 * w * 4
    assert est[1_200_000]["work"] == 3 * nnz * w * 4
    forced = estimate_hbm_bytes(TConfig(**kw, n_feats=1_200_000, update_mode="inplace"))
    assert forced["work"] == 1_200_000 * w * 4 + 3 * nnz * w * 4 == ref[1_200_000]["work"]
    for r in est:
        assert est[r]["state"] == ref[r]["state"] == r * w * 12 + 3 * r * 4
        assert est[r]["route"] == 0
        assert est[r]["total"] == est[r]["state"] + est[r]["work"]


def test_trainer_warns_when_the_estimate_nears_device_memory(monkeypatch):
    import ftrl_ffm_tpu_torch.train as ttrain

    cfg = dict(device="cpu", max_nnz=6, **SEVEN)
    monkeypatch.setattr(ttrain, "device_memory_bytes", lambda device: 10_000)
    with pytest.warns(UserWarning, match="estimated device memory need"):
        Trainer(TConfig(**cfg))
    monkeypatch.setattr(ttrain, "device_memory_bytes", lambda device: 1 << 40)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Trainer(TConfig(**cfg))
