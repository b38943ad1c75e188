"""The port's training payload (ops/ffm_cuda.py::ffm_fused_logits_grads, its
plain version on the CPU) against the JAX package's Pallas kernel in
interpret mode and its XLA formulation, on the same numpy inputs.  Logits
within rtol=1e-5, atol=1e-6 and the payload within rtol=1e-4, atol=1e-6:
the bounds the JAX suite holds its own Pallas and XLA paths to
(tests/test_ffm_pallas.py's shape sweep), since sums run in another order.
The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits_grads as jax_fused
from ftrl_ffm_tpu.ops.interactions import ffm_logits_and_grads as jax_logits_and_grads
from ftrl_ffm_tpu_torch.ops import interactions as t_inter
from ftrl_ffm_tpu_torch.ops.ffm_cuda import (
    ffm_fused_logits_grads,
    ffm_fused_logits_grads_plain,
)
from tests.test_torch_cuda import spec_fused_inputs

L_RTOL, L_ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-6


def _inputs(b, f, c, k, seed, n_real=None):
    """v [B*F, E], fields from the first n_real fields (default c - 1, so
    the top field is dead), values in (0, 1), lin, labels, weights with one
    padded sample."""
    rng = np.random.default_rng(seed)
    e = c * k
    v = (rng.normal(size=(b * f, e)) * 0.1).astype(np.float32)
    fields = rng.integers(0, n_real or max(1, c - 1), (b, f)).astype(np.int32)
    vals = rng.random((b, f)).astype(np.float32)
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    sw[-1] = 0.0
    return v, fields, vals, lin, y, sw


def _port(arrays, c, k, aug):
    logits, gg2 = ffm_fused_logits_grads(*(torch.from_numpy(a) for a in arrays), c, k, aug_lane=aug)
    return logits.numpy(), gg2.numpy()


def _pallas(arrays, c, k, aug):
    logits, gg2 = jax_fused(
        *(jnp.asarray(a) for a in arrays), c, k,
        compute_grads=True, block_b=8, interpret=True, aug_lane=aug,
    )
    return np.asarray(logits), np.asarray(gg2)


# (B, F, C', K, aug lane): tests/test_ffm_pallas.py's sweep shapes (aug on
# the dead top field, F == C, odd B with K=32, the flagship padded row with
# dead lane 39), and the 7-field field_pad-8 shape with its mirror lane
SWEEP = [
    (24, 3, 7, 16, 6),
    (8, 8, 8, 4, -1),
    (40, 6, 5, 32, -1),
    (16, 10, 40, 16, 39),
    (16, 7, 8, 16, 7),
]


@pytest.mark.parametrize("b,f,c,k,aug", SWEEP)
def test_plain_matches_pallas_interpret(b, f, c, k, aug):
    arrays = _inputs(b, f, c, k, 0)
    logits, gg2 = _port(arrays, c, k, aug)
    ref_logits, ref_gg2 = _pallas(arrays, c, k, aug)
    assert gg2.shape == (b * f, 2 * c * k)
    np.testing.assert_allclose(logits, ref_logits, rtol=L_RTOL, atol=L_ATOL)
    np.testing.assert_allclose(gg2, ref_gg2, rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("b,f,c,k,aug", SWEEP)
def test_plain_matches_xla_grads_times_gs(b, f, c, k, aug):
    """g = gs * d logit / d v of the XLA formulation, g^2 its square."""
    arrays = _inputs(b, f, c, k, 1)
    v, fields, vals, lin, y, sw = arrays
    ref_logits, dv = jax_logits_and_grads(
        jnp.asarray(v.reshape(b, f, -1)), jnp.asarray(fields), jnp.asarray(vals),
        jnp.asarray(lin), c, k, True, grad_lane=aug,
    )
    gs = (jax.nn.sigmoid(ref_logits) - y) * sw
    g_ref = np.asarray(gs[:, None, None] * dv).reshape(b * f, -1)
    logits, gg2 = _port(arrays, c, k, aug)
    e = c * k
    np.testing.assert_allclose(logits, np.asarray(ref_logits), rtol=L_RTOL, atol=L_ATOL)
    np.testing.assert_allclose(gg2[:, :e], g_ref, rtol=G_RTOL, atol=G_ATOL)
    np.testing.assert_allclose(gg2[:, e:], g_ref * g_ref, rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("b,f,aug", [(8, 39, -1), (8, 39, 39), (16, 39, 39), (8, 40, 39),
                                     (8, 13, -1), (8, 13, 39)])
def test_c40_inputs_match_pallas_interpret(b, f, aug):
    """The inputs of the card's C'=40, K=16 cases
    (tests/test_torch_cuda.py::spec_fused_inputs: shuffled fields, a
    repeated field, out-of-range fields, padding) through the plain version
    and the Pallas kernel in interpret mode."""
    arrays = spec_fused_inputs(b, f, b + f + aug)
    logits, gg2 = _port(arrays, 40, 16, aug)
    ref_logits, ref_gg2 = _pallas(arrays, 40, 16, aug)
    np.testing.assert_allclose(logits, ref_logits, rtol=L_RTOL, atol=L_ATOL)
    np.testing.assert_allclose(gg2, ref_gg2, rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("bad", [8, 9, -1])
def test_out_of_range_fields_and_padding(bad):
    """An occurrence whose field is outside [0, C') has a zero factor
    gradient and selects nothing; padding occurrences (value 0) give zero
    rows; the aug lane carries gs * x whatever the field — all as the
    Pallas kernel."""
    b, f, c, k, aug = 16, 6, 8, 4, 7
    arrays = _inputs(b, f, c, k, 2)
    v, fields, vals = arrays[:3]
    fields[:, 1] = bad
    vals[:, 4:] = 0.0
    fields[:, 4:] = 0
    logits, gg2 = _port(arrays, c, k, aug)
    ref_logits, ref_gg2 = _pallas(arrays, c, k, aug)
    np.testing.assert_allclose(logits, ref_logits, rtol=L_RTOL, atol=L_ATOL)
    np.testing.assert_allclose(gg2, ref_gg2, rtol=G_RTOL, atol=G_ATOL)
    rows = gg2.reshape(b, f, -1)
    e = c * k
    dead_field = np.ones(2 * e, bool)
    dead_field[[aug, e + aug]] = False
    assert (rows[:, 1][:, dead_field] == 0).all()
    assert (rows[:, 4:] == 0).all()
    assert (rows[-1] == 0).all()  # the padded sample: gs = 0


def test_aug_lane_carries_the_linear_gradient():
    b, f, c, k = 16, 5, 5, 8
    arrays = _inputs(b, f, c, k, 3, n_real=4)
    logits, gg2 = _port(arrays, c, k, 4)
    _, plain = _port(arrays, c, k, -1)
    y, sw, vals = arrays[4], arrays[5], arrays[2]
    gs = (1 / (1 + np.exp(-logits.astype(np.float64))) - y) * sw
    g_lin = (gs[:, None] * vals).reshape(-1)
    e = c * k
    np.testing.assert_allclose(gg2[:, 4], g_lin, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gg2[:, e + 4], g_lin * g_lin, rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(plain[:, 4], 0.0)  # dead lane without aug
    keep = np.ones(2 * e, bool)
    keep[[4, e + 4]] = False
    np.testing.assert_array_equal(gg2[:, keep], plain[:, keep])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    arrays = [torch.from_numpy(a) for a in _inputs(8, 4, 5, 4, 4)]
    before = ffm_fused_logits_grads.launches
    by_instance = dict(ffm_fused_logits_grads.launches_by_instance)
    got = ffm_fused_logits_grads(*arrays, 5, 4, aug_lane=4)
    ref = ffm_fused_logits_grads_plain(*arrays, 5, 4, aug_lane=4)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    assert ffm_fused_logits_grads.launches == before  # no kernel launched
    assert ffm_fused_logits_grads.launches_by_instance == by_instance


def test_interactions_grads_match_jax_xla():
    """ops/interactions.py::ffm_logits_and_grads with the mirror read and
    the gradient lane, against the JAX XLA formulation."""
    b, f, c, k = 12, 7, 8, 16
    v, fields, vals, lin, _, _ = _inputs(b, f, c, k, 5, n_real=7)
    v3 = v.reshape(b, f, -1)
    ref_logits, ref_dv = jax_logits_and_grads(
        jnp.asarray(v3), jnp.asarray(fields), jnp.asarray(vals), jnp.asarray(lin),
        c, k, True, lin_lane=7, grad_lane=7,
    )
    logits, dv = t_inter.ffm_logits_and_grads(
        torch.from_numpy(v3), torch.from_numpy(fields), torch.from_numpy(vals),
        torch.from_numpy(lin), c, k, lin_lane=7, grad_lane=7,
    )
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=L_RTOL, atol=L_ATOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(ref_dv), rtol=G_RTOL, atol=G_ATOL)
    assert t_inter.ffm_logits_and_grads(
        torch.from_numpy(v3), torch.from_numpy(fields), torch.from_numpy(vals),
        torch.from_numpy(lin), c, k, compute_grads=False,
    )[1] is None
