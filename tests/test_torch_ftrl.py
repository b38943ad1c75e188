"""The port's FTRL accumulator step, bias update and dense table updates
(ftrl_ffm_tpu_torch/ftrl.py, and the in-place wrapper of
ops/ftrl_cuda.py on the CPU) against the JAX package's, on the same numpy
inputs with duplicate and sentinel ids.  rtol=1e-6, atol=1e-7: the same f32
operations, with duplicate sums in another order."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ftrl_ffm_tpu import ftrl as jftrl
from ftrl_ffm_tpu_torch import ftrl as tftrl
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update, ftrl_update_plain

RTOL, ATOL = 1e-6, 1e-7
P = (0.05, 1.0, 0.15, 1.0)


def _tables(rng, *shape):
    """(n, z, w) as training leaves them: some coordinates untouched (n = 0,
    w = init), the others w = closed form."""
    n = (rng.random(shape) * 2).astype(np.float32)
    n[rng.random(shape) < 0.3] = 0.0
    z = rng.normal(size=shape).astype(np.float32)
    init = (rng.normal(size=shape) * 0.02).astype(np.float32)
    w = np.where(
        n > 0, np.asarray(jftrl.ftrl_weights(jnp.asarray(n), jnp.asarray(z), jftrl.FtrlParams(*P))),
        init,
    ).astype(np.float32)
    return [n, z, w]


def _ids(rng, r, n):
    """Duplicates (ids from [0, r - 3), so the top rows stay untouched)
    and the padding sentinel r."""
    ids = rng.integers(0, r - 3, n).astype(np.int32)
    ids[rng.random(n) < 0.1] = r
    return ids


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_accumulate_and_bias_update_match_jax():
    rng = np.random.default_rng(0)
    n, z, w = _tables(rng, 64)
    g = (rng.normal(size=64) * 0.3).astype(np.float32)
    p_j, p_t = jftrl.FtrlParams(*P), tftrl.FtrlParams(*P)
    ref = jftrl.ftrl_accumulate(*(jnp.asarray(a) for a in (n, z, w, g, g * g)), p_j)
    _close(tftrl.ftrl_accumulate(*_t((n, z, w, g, g * g)), p_t), ref)
    bn, bz = np.float32(0.7), np.float32(-0.3)
    ref = jftrl.bias_update(jnp.asarray(bn), jnp.asarray(bz), jnp.asarray(g), p_j)
    _close(tftrl.bias_update(torch.tensor(bn), torch.tensor(bz), torch.from_numpy(g), p_t), ref)


@pytest.mark.parametrize("width", [0, 6])
def test_dense_update2_matches_jax(width):
    rng = np.random.default_rng(1)
    r, nnz = 20, 48
    shape = (r, width) if width else (r,)
    tables = _tables(rng, *shape)
    ids = _ids(rng, r, nnz)
    g = (rng.normal(size=(nnz, max(1, width))) * 0.2).astype(np.float32)
    gg2 = np.concatenate([g, g * g], axis=-1)
    ref = jftrl.dense_ftrl_update2(
        *(jnp.asarray(a) for a in (*tables, ids, gg2)), jftrl.FtrlParams(*P)
    )
    got = tftrl.dense_ftrl_update2(*_t((*tables, ids, gg2)), tftrl.FtrlParams(*P))
    _close(got, ref)
    # rows no id touches keep n, z and w
    for g_t, before in zip(got, tables):
        np.testing.assert_array_equal(g_t.numpy()[r - 3:], before[r - 3:])


def _aug_inputs(seed, r=24, d=8, nnz=64, lane=5):
    rng = np.random.default_rng(seed)
    tables = _tables(rng, r, d) + _tables(rng, r)
    ids = _ids(rng, r, nnz)
    g = (rng.normal(size=(nnz, d)) * 0.2).astype(np.float32)
    g[:, lane] = (rng.normal(size=nnz) * 0.2).astype(np.float32)  # linear grad
    return tables, ids, np.concatenate([g, g * g], axis=-1), lane


def test_dense_update2_aug_matches_jax():
    tables, ids, gg2, lane = _aug_inputs(2)
    (vj, lj) = jftrl.dense_ftrl_update2_aug(
        *(jnp.asarray(a) for a in (*tables, ids, gg2)), lane, jftrl.FtrlParams(*P)
    )
    (vt, lt) = tftrl.dense_ftrl_update2_aug(
        *_t((*tables, ids, gg2)), lane, tftrl.FtrlParams(*P)
    )
    _close(vt, vj)
    _close(lt, lj)


def test_update_wrapper_updates_in_place_on_the_cpu():
    """ftrl_update on CPU tensors writes ftrl_update_plain's result into the
    given tables, with and without a dead lane."""
    tables, ids, gg2, lane = _aug_inputs(3)
    p = tftrl.FtrlParams(*P)
    ts = _t((*tables, ids, gg2))
    vec, lin = ftrl_update_plain(*ts, lane, p)
    before = ftrl_update.launches
    ftrl_update(*ts, lane, p)
    assert ftrl_update.launches == before  # no kernel launched
    for got, want in zip(ts[:6], (*vec, *lin)):
        assert torch.equal(got, want)
    # no dead lane: the linear stats from their own [N, 2] payload
    gl = gg2[:, lane]
    gg2_lin = np.stack([gl, gl * gl], axis=-1)
    ts = _t((*tables, ids, gg2))
    ftrl_update(*ts, -1, p, torch.from_numpy(gg2_lin))
    ref_lin = jftrl.dense_ftrl_update2(
        *(jnp.asarray(a) for a in (*tables[3:], ids, gg2_lin)), jftrl.FtrlParams(*P)
    )
    ref_vec = jftrl.dense_ftrl_update2(
        *(jnp.asarray(a) for a in (*tables[:3], ids, gg2)), jftrl.FtrlParams(*P)
    )
    _close(ts[:3], ref_vec)
    _close(ts[3:6], ref_lin)


def test_update_wants_exactly_one_source_of_linear_stats():
    tables, ids, gg2, lane = _aug_inputs(4)
    ts = _t((*tables, ids, gg2))
    p = tftrl.FtrlParams(*P)
    with pytest.raises(ValueError, match="not both or neither"):
        ftrl_update(*ts, -1, p)
    with pytest.raises(ValueError, match="not both or neither"):
        ftrl_update(*ts, lane, p, torch.zeros((ids.shape[0], 2)))
    with pytest.raises(ValueError, match="outside the row"):
        ftrl_update(*ts, 8, p, None)


@pytest.mark.parametrize(
    "n_rows,width,nnz,mode",
    [
        (100_000, 640, 16384 * 39, "auto"),   # bench.py's model: dense2
        (1_000_000, 640, 16384 * 39, "auto"),  # JAX inplace, the port dense2
        (1_000_000, 0, 16384 * 39, "auto"),
        (2_000_000, 640, 16384 * 39, "auto"),  # sparse2
        (50, 48, 6, "auto"),                   # B=1 oracle shape: as at 1M
        (50, 48, 6, "dense"),
        (50, 48, 6, "sparse"),
        (50, 48, 6, "inplace"),
        (50, 0, 6, "inplace"),
    ],
)
def test_select_update_kind_matches_jax(n_rows, width, nnz, mode):
    """The port's one-device forms (ftrl.py::update_form) are the JAX
    package's kinds, but for its deliberate choice under auto: where JAX
    picks "inplace", the port picks "dense2" (its touched-rows update keeps
    no table-shaped accumulator and beat "inplace" on the card at every
    shape measured, PERF.md section 6); update_mode=inplace still selects
    "inplace"."""
    want = jftrl.select_update_kind(n_rows, width, nnz, mode)
    if mode == "auto" and want == "inplace":
        want = "dense2"
    cfg = SimpleNamespace(update_mode=mode, row_width=width, batch_size=nnz, max_nnz=1)
    assert tftrl.update_form(cfg, n_rows) == want
