"""The port's FFM logits (ops/ffm_cuda.py, ops/interactions.py) against the
JAX package's Pallas kernel (interpret mode) and its XLA formulation, on the
same numpy inputs.  Tolerance rtol=1e-5, atol=1e-6: the bound the JAX suite
holds its own Pallas and XLA paths to (tests/test_ffm_pallas.py), since the
sums run in another order.  The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits as jax_fused_logits
from ftrl_ffm_tpu.ops.interactions import ffm_logits_and_grads, linear_logits
from ftrl_ffm_tpu_torch.ops import interactions as t_inter
from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits

RTOL, ATOL = 1e-5, 1e-6


def _inputs(b, f, c, k, seed, mirror_lane=-1, n_real_fields=None):
    """v [B*F, E] factor-major rows, fields drawn from the real fields,
    values in (0, 1), lin [B]; with mirror_lane >= 0 that dead lane holds a
    linear weight, as in a trained state."""
    rng = np.random.default_rng(seed)
    e = c * k
    v = (rng.normal(size=(b * f, e)) * 0.1).astype(np.float32)
    if mirror_lane >= 0:
        v[:, mirror_lane] = rng.normal(size=b * f).astype(np.float32) * 0.3
    fields = rng.integers(0, n_real_fields or c, (b, f)).astype(np.int32)
    vals = rng.random((b, f)).astype(np.float32)
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    return v, fields, vals, lin


def _plain(v, fields, vals, lin, c, k):
    return ffm_fused_logits(
        torch.from_numpy(v), torch.from_numpy(fields), torch.from_numpy(vals),
        torch.from_numpy(lin), c, k,
    ).numpy()


# (B, F, C', K, mirror lane, real fields): the JAX suite's small shape, the
# Criteo shape with the linear mirror in dead lane 39, and the 7-field
# field_pad-8 shape of tests/test_train.py
CASES = [
    (16, 5, 4, 8, -1, None),
    (32, 39, 40, 16, 39, 39),
    (16, 7, 8, 16, 7, 7),
]


@pytest.mark.parametrize("b,f,c,k,lane,real", CASES)
def test_plain_matches_pallas_interpret(b, f, c, k, lane, real):
    v, fields, vals, lin = _inputs(b, f, c, k, 0, lane, real)
    ref = jax_fused_logits(
        jnp.asarray(v), jnp.asarray(fields), jnp.asarray(vals), jnp.asarray(lin),
        c, k, block_b=8, interpret=True,
    )
    np.testing.assert_allclose(
        _plain(v, fields, vals, lin, c, k), np.asarray(ref), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("b,f,c,k,lane,real", CASES)
def test_bf16_rows_match_pallas_interpret_on_widened_rows(b, f, c, k, lane, real):
    """bf16 rows (a bf16 table's, gathered as they are) against the JAX
    package's Pallas kernel in interpret mode on the same rows widened to
    f32, as ftrl_ffm_tpu/models/base.py widens them before that kernel:
    rtol=1e-5, atol=1e-6 as above; and bit for bit the port's logits of
    the widened f32 rows (the plain version widens, then sums)."""
    v, fields, vals, lin = _inputs(b, f, c, k, 8, lane, real)
    vh = torch.from_numpy(v).to(torch.bfloat16)
    wide = vh.float().numpy()
    ref = jax_fused_logits(
        jnp.asarray(wide), jnp.asarray(fields), jnp.asarray(vals), jnp.asarray(lin),
        c, k, block_b=8, interpret=True,
    )
    got = ffm_fused_logits(
        vh, torch.from_numpy(fields), torch.from_numpy(vals), torch.from_numpy(lin), c, k,
    ).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, _plain(wide, fields, vals, lin, c, k))


def test_rows_of_another_dtype_raise():
    v, fields, vals, lin = _inputs(4, 3, 4, 4, 9)
    with pytest.raises(ValueError, match="float64"):
        ffm_fused_logits(
            torch.from_numpy(v).double(), torch.from_numpy(fields), torch.from_numpy(vals),
            torch.from_numpy(lin), 4, 4,
        )


@pytest.mark.parametrize("b,f,c,k,lane,real", CASES)
def test_plain_matches_xla_formulation(b, f, c, k, lane, real):
    v, fields, vals, lin = _inputs(b, f, c, k, 1, lane, real)
    ref, _ = ffm_logits_and_grads(
        jnp.asarray(v.reshape(b, f, -1)), jnp.asarray(fields), jnp.asarray(vals),
        jnp.asarray(lin), c, k, compute_grads=False,
    )
    np.testing.assert_allclose(
        _plain(v, fields, vals, lin, c, k), np.asarray(ref), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("b,f,c,k,lane,real", CASES)
def test_lin_lane_matches_xla(b, f, c, k, lane, real):
    """ffm_logits reading the linear weights from the mirror lane."""
    if lane < 0:
        lane = c - 1
    v, fields, vals, lin = _inputs(b, f, c, k, 2, lane, real)
    ref, _ = ffm_logits_and_grads(
        jnp.asarray(v.reshape(b, f, -1)), jnp.asarray(fields), jnp.asarray(vals),
        jnp.asarray(lin), c, k, compute_grads=False, lin_lane=lane,
    )
    got = t_inter.ffm_logits(
        torch.from_numpy(v.reshape(b, f, -1)), torch.from_numpy(fields),
        torch.from_numpy(vals), torch.from_numpy(lin), c, k, lin_lane=lane,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_padding_occurrences_are_inert():
    """Padded occurrences (field 0, value 0) change nothing, whatever their
    rows hold; fully padded samples give exactly lin."""
    b, f, c, k = 8, 6, 4, 4
    v, fields, vals, lin = _inputs(b, f, c, k, 3)
    vals[:, 4:] = 0.0
    fields[:, 4:] = 0
    fields[5:] = 0
    vals[5:] = 0.0
    got = _plain(v, fields, vals, lin, c, k)
    short = _plain(
        v.reshape(b, f, -1)[:, :4].reshape(b * 4, -1), fields[:, :4].copy(),
        vals[:, :4].copy(), lin, c, k,
    )
    np.testing.assert_allclose(got[:5], short[:5], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[5:], lin[5:])


@pytest.mark.parametrize("bad", [4, 7, -1])
def test_out_of_range_fields_select_nothing(bad):
    """A field outside [0, C') contributes nothing (the one-hot form): the
    same as dropping that occurrence, and equal to the JAX XLA path."""
    b, f, c, k = 8, 5, 4, 4
    v, fields, vals, lin = _inputs(b, f, c, k, 4)
    fields[:, 2] = bad
    got = _plain(v, fields, vals, lin, c, k)
    ref, _ = ffm_logits_and_grads(
        jnp.asarray(v.reshape(b, f, -1)), jnp.asarray(fields), jnp.asarray(vals),
        jnp.asarray(lin), c, k, compute_grads=False,
    )
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    keep = [0, 1, 3, 4]
    dropped = _plain(
        v.reshape(b, f, -1)[:, keep].reshape(b * 4, -1), fields[:, keep].copy(),
        vals[:, keep].copy(), lin, c, k,
    )
    np.testing.assert_allclose(got, dropped, rtol=RTOL, atol=ATOL)


def test_linear_logits_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(16, 7)).astype(np.float32)
    x = rng.random((16, 7)).astype(np.float32)
    bias = np.float32(0.25)
    ref = linear_logits(jnp.asarray(w), jnp.asarray(x), jnp.asarray(bias))
    got = t_inter.linear_logits(
        torch.from_numpy(w), torch.from_numpy(x), torch.tensor(bias)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_plain_is_the_interactions_ground_truth():
    """The kernel's plain version is ops/interactions.py::ffm_logits on the
    [B, F, E] view — bit for bit."""
    b, f, c, k = 8, 5, 4, 4
    v, fields, vals, lin = _inputs(b, f, c, k, 6)
    got = _plain(v, fields, vals, lin, c, k)
    ref = t_inter.ffm_logits(
        torch.from_numpy(v.reshape(b, f, -1)), torch.from_numpy(fields),
        torch.from_numpy(vals), torch.from_numpy(lin), c, k,
    ).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wrong_row_width_raises():
    v, fields, vals, lin = _inputs(4, 3, 4, 4, 7)
    with pytest.raises(ValueError, match="row width"):
        _plain(v, fields, vals, lin, 4, 3)
