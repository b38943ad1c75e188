"""Card-only checks of the port's CUDA kernels: each kernel against its
plain PyTorch version on the same device tensors.  Marked `cuda`; they skip
where there is no card.  This file imports nothing of JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX for the rest of the suite).
f32 sums in another order: logits rtol=1e-4, atol=1e-5; training payload
rtol=1e-4, atol=1e-6; updated table rows rtol=1e-5, atol=1e-6, rows no id
touches bit-identical, and the update kernel bit-identical run to run."""

import numpy as np
import pytest
import torch

from ftrl_ffm_tpu_torch.ftrl import UNTOUCHED_N, FtrlParams, ftrl_weights
from ftrl_ffm_tpu_torch.ops.ffm_cuda import (
    ffm_fused_logits,
    ffm_fused_logits_grads,
    ffm_fused_logits_grads_plain,
    ffm_fused_logits_plain,
)
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update, ftrl_update_plain


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


# (B, F, C', K, real fields): the Criteo shape with the linear mirror in
# dead lane 39, odd B, F above 39 (staged, then too big to stage), the
# 7-field field_pad-8 shape, and a row width not a multiple of 4
SHAPES = [
    (16, 5, 4, 8, 4),
    (256, 39, 40, 16, 39),
    (33, 39, 40, 16, 39),
    (17, 64, 40, 16, 39),
    (9, 100, 40, 16, 39),
    (16, 7, 8, 16, 7),
    (5, 6, 5, 3, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,c,k,real", SHAPES)
def test_ffm_logits_kernel_matches_plain(b, f, c, k, real):
    dev = _card()
    rng = np.random.default_rng(b * f + c)
    v = (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32)
    if real < c:
        v[:, real] = rng.normal(size=b * f).astype(np.float32) * 0.3
    fields = rng.integers(0, real, (b, f)).astype(np.int32)
    fields[:, 0] = c + 3  # out of range: selects nothing
    vals = rng.random((b, f)).astype(np.float32)
    vals[:, -1] = 0.0  # padding occurrences
    vals[-1] = 0.0  # a padded sample
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (v, fields, vals, lin)]
    before = ffm_fused_logits.launches
    got = ffm_fused_logits(*args, c, k)
    torch.cuda.synchronize()
    assert ffm_fused_logits.launches == before + 1
    ref = ffm_fused_logits_plain(*args, c, k)
    np.testing.assert_allclose(
        got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5
    )


@pytest.mark.cuda
def test_ffm_logits_kernel_checks_its_inputs():
    dev = _card()
    b, f, c, k = 4, 3, 4, 2
    v = torch.zeros((b * f, c * k), device=dev)
    fields = torch.zeros((b, f), dtype=torch.int32, device=dev)
    vals = torch.zeros((b, f), device=dev)
    lin = torch.zeros((b,), device=dev)
    with pytest.raises(ValueError, match="dtype|is torch"):
        ffm_fused_logits(v, fields.long(), vals, lin, c, k)
    with pytest.raises(ValueError, match="shape"):
        ffm_fused_logits(v[:-1], fields, vals, lin, c, k)
    with pytest.raises(ValueError, match="contiguous"):
        ffm_fused_logits(v, fields.t().contiguous().t(), vals, lin, c, k)


# (B, F, C', K, real fields, aug lane): the shapes above with the linear
# gradient in the dead lane where one exists
FUSED = [
    (16, 5, 4, 8, 4, -1),
    (256, 39, 40, 16, 39, 39),
    (33, 39, 40, 16, 39, 39),
    (17, 64, 40, 16, 39, 39),
    (9, 100, 40, 16, 39, 39),
    (16, 7, 8, 16, 7, 7),
    (16, 8, 8, 16, 8, -1),
    (5, 6, 5, 3, 4, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,c,k,real,aug", FUSED)
def test_ffm_fused_kernel_matches_plain(b, f, c, k, real, aug):
    dev = _card()
    rng = np.random.default_rng(b * f + c + 1)
    v = (rng.normal(size=(b * f, c * k)) * 0.1).astype(np.float32)
    fields = rng.integers(0, real, (b, f)).astype(np.int32)
    fields[:, 0] = c + 3  # out of range: no factor gradient
    vals = rng.random((b, f)).astype(np.float32)
    vals[:, -1] = 0.0  # padding occurrences
    vals[-1] = 0.0  # a padded sample
    lin = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    sw[-1] = 0.0
    args = [torch.from_numpy(a).to(dev) for a in (v, fields, vals, lin, y, sw)]
    before = ffm_fused_logits_grads.launches
    logits, gg2 = ffm_fused_logits_grads(*args, c, k, aug_lane=aug)
    torch.cuda.synchronize()
    assert ffm_fused_logits_grads.launches == before + 1
    ref_logits, ref_gg2 = ffm_fused_logits_grads_plain(*args, c, k, aug_lane=aug)
    np.testing.assert_allclose(
        logits.cpu().numpy(), ref_logits.cpu().numpy(), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(gg2.cpu().numpy(), ref_gg2.cpu().numpy(), rtol=1e-4, atol=1e-6)


def _update_inputs(dev, r, e, n, lane, seed):
    """Tables as training leaves them (w = closed form where n > 0, the
    init elsewhere), ids with duplicates and the sentinel r, rows r-3..r-1
    untouched, payloads with g^2 = g * g."""
    rng = np.random.default_rng(seed)
    p = FtrlParams(alpha=0.05, l1=0.15, l2=1.0)

    def table(*shape):
        n_tab = torch.from_numpy((rng.random(shape) * 2).astype(np.float32))
        n_tab[torch.from_numpy(rng.random(shape) < 0.3)] = 0.0
        z = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        init = torch.from_numpy((rng.normal(size=shape) * 0.02).astype(np.float32))
        w = torch.where(n_tab > UNTOUCHED_N, ftrl_weights(n_tab, z, p), init)
        return [t.to(dev) for t in (n_tab, z, w)]

    tables = table(r, e) + table(r)
    ids = rng.integers(0, r - 3, n).astype(np.int32)
    ids[rng.random(n) < 0.05] = r
    g = (rng.normal(size=(n, e)) * 0.2).astype(np.float32)
    gl = g[:, max(lane, 0)]
    gg2_lin = None if lane >= 0 else torch.from_numpy(np.stack([gl, gl * gl], -1)).to(dev)
    gg2 = torch.from_numpy(np.concatenate([g, g * g], -1)).to(dev)
    return tables, torch.from_numpy(ids).to(dev), gg2, gg2_lin, p


@pytest.mark.cuda
@pytest.mark.parametrize(
    "r,e,n,lane", [(64, 640, 4000, 39), (64, 128, 4000, -1), (20, 15, 300, 4), (300, 80, 10, 7)]
)
def test_ftrl_update_kernel_matches_plain_and_repeats(r, e, n, lane):
    dev = _card()
    tables, ids, gg2, gg2_lin, p = _update_inputs(dev, r, e, n, lane, r + e + n)
    runs = []
    for _ in range(2):
        got = [t.clone() for t in tables]
        before = ftrl_update.launches
        ftrl_update(*got, ids, gg2, lane, p, gg2_lin)
        torch.cuda.synchronize()
        assert ftrl_update.launches == before + 1
        runs.append(got)
    vec, lin = ftrl_update_plain(*tables, ids, gg2, lane, p, gg2_lin)
    touched = torch.zeros(r, dtype=torch.bool, device=dev)
    touched[ids[ids < r].long()] = True
    assert not touched[r - 3:].any()
    for got, want, before, again in zip(runs[0], (*vec, *lin), tables, runs[1]):
        np.testing.assert_allclose(
            got[touched].cpu().numpy(), want[touched].cpu().numpy(), rtol=1e-5, atol=1e-6
        )
        assert torch.equal(got[~touched], before[~touched])
        assert torch.equal(got, again)  # the same bits on every run


@pytest.mark.cuda
def test_training_kernels_check_their_inputs():
    dev = _card()
    b, f, c, k = 4, 3, 4, 2
    v = torch.zeros((b * f, c * k), device=dev)
    fields = torch.zeros((b, f), dtype=torch.int32, device=dev)
    x = torch.zeros((b, f), device=dev)
    per = [torch.zeros((b,), device=dev) for _ in range(3)]
    with pytest.raises(ValueError, match="dtype|is torch"):
        ffm_fused_logits_grads(v, fields.long(), x, *per, c, k)
    with pytest.raises(ValueError, match="aug_lane"):
        ffm_fused_logits_grads(v, fields, x, *per, c, k, aug_lane=c * k)
    tables, ids, gg2, _, p = _update_inputs(dev, 10, 8, 12, 3, 0)
    with pytest.raises(ValueError, match="shape"):
        ftrl_update(*tables, ids, gg2[:, :-1].contiguous(), 3, p)
    with pytest.raises(ValueError, match="dtype|is torch"):
        ftrl_update(*tables, ids.long(), gg2, 3, p)

