"""Card-only checks of the port's CUDA kernels: each kernel against its
plain PyTorch version on the same device tensors.  Marked `cuda`; they skip
where there is no card.  This file imports nothing of JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX for the rest of the suite).
f32 sums in another order: rtol=1e-4, atol=1e-5."""

import numpy as np
import pytest
import torch

from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits, ffm_fused_logits_plain


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
