"""FFM inference logits on the card: the counterpart of
ftrl_ffm_tpu/ops/ffm_pallas.py::ffm_fused_logits.

`ffm_fused_logits` takes the same arguments in the same layout as the JAX
entry point.  For CUDA tensors it launches the hand-written kernel of
csrc/ffm_logits.cu or raises; for CPU tensors it runs
`ffm_fused_logits_plain`, the plain PyTorch version, which the tests hold
against the JAX package and the card holds the kernel against.
"""

from __future__ import annotations

import torch

from ftrl_ffm_tpu_torch.ops.interactions import ffm_logits


def ffm_fused_logits_plain(
    v: torch.Tensor,
    fields: torch.Tensor,
    vals: torch.Tensor,
    lin: torch.Tensor,
    n_fields: int,
    n_factors: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ops/interactions.py::ffm_logits
    on the [B, F, E] view of the rows."""
    b, f = fields.shape
    return ffm_logits(v.reshape(b, f, -1), fields, vals, lin, n_fields, n_factors)


def ffm_fused_logits(
    v: torch.Tensor,       # [B*F, E] gathered factor rows (factor-major)
    fields: torch.Tensor,  # [B, F] int32
    vals: torch.Tensor,    # [B, F] f32
    lin: torch.Tensor,     # [B] bias + linear logits
    n_fields: int,         # the rows' field stride C' (Config.field_pad)
    n_factors: int,
) -> torch.Tensor:
    """Inference-only FFM logits [B] — the serving/eval hot path."""
    if v.device.type == "cpu":
        return ffm_fused_logits_plain(v, fields, vals, lin, n_fields, n_factors)
    if v.device.type != "cuda":
        raise ValueError(f"ffm_fused_logits: no kernel for device {v.device}")
    b, f = fields.shape
    e = n_fields * n_factors
    for name, t, shape, dtype in (
        ("v", v, (b * f, e), torch.float32),
        ("fields", fields, (b, f), torch.int32),
        ("vals", vals, (b, f), torch.float32),
        ("lin", lin, (b,), torch.float32),
    ):
        if t.device != v.device:
            raise ValueError(f"ffm_fused_logits: {name} on {t.device}, v on {v.device}")
        if t.dtype != dtype:
            raise ValueError(f"ffm_fused_logits: {name} is {t.dtype}, expect {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"ffm_fused_logits: {name} has shape {tuple(t.shape)}, expect {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"ffm_fused_logits: {name} is not contiguous")
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    out = torch.empty((b,), dtype=torch.float32, device=v.device)
    if b == 0:
        return out
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        code = lib.ffm_logits_launch(
            v.data_ptr(), fields.data_ptr(), vals.data_ptr(), lin.data_ptr(),
            out.data_ptr(), b, f, n_fields, n_factors, stream,
        )
    _build.check(code, "ffm_logits_launch")
    ffm_fused_logits.launches += 1
    return out


# Kernel launches since the count was last set to 0 (chip_smoke.py reads it
# to show that the serving path went through the kernel).
ffm_fused_logits.launches = 0
