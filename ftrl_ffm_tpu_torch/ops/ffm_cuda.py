"""FFM logits and training payload on the card: the counterparts of
ftrl_ffm_tpu/ops/ffm_pallas.py::ffm_fused_logits and ::ffm_fused_logits_grads.

Each entry point takes the same arguments in the same layout as the JAX one.
For CUDA tensors it launches its hand-written kernel (csrc/ffm_logits.cu,
csrc/ffm_fused.cu) or raises; for CPU tensors it runs its `*_plain` version,
the plain PyTorch form that the tests hold against the JAX package and the
card holds the kernel against.  Each entry point counts its launches in its
`launches` attribute, and by kernel instance and dtype in
`launches_by_instance`.
"""

from __future__ import annotations

import ctypes

import torch

from ftrl_ffm_tpu_torch.ops.interactions import ffm_logits, ffm_logits_and_grads


def _check_inputs(what: str, v: torch.Tensor, specs) -> None:
    """Raise unless every (name, tensor, shape, dtype) of `specs` is a
    contiguous tensor of that shape and dtype on v's device."""
    for name, t, shape, dtype in specs:
        if t.device != v.device:
            raise ValueError(f"{what}: {name} on {t.device}, v on {v.device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, expect {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{what}: {name} has shape {tuple(t.shape)}, expect {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _device_kind(what: str, v: torch.Tensor) -> str:
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {v.device}")
    return v.device.type


def ffm_fused_logits_plain(
    v: torch.Tensor,
    fields: torch.Tensor,
    vals: torch.Tensor,
    lin: torch.Tensor,
    n_fields: int,
    n_factors: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ops/interactions.py::ffm_logits
    on the [B, F, E] view of the rows, widened to f32 first (a bf16
    table's rows, as ftrl_ffm_tpu/models/base.py widens them)."""
    b, f = fields.shape
    return ffm_logits(v.float().reshape(b, f, -1), fields, vals, lin, n_fields, n_factors)


def ffm_fused_logits(
    v: torch.Tensor,       # [B*F, E] gathered factor rows (factor-major), f32 or bf16
    fields: torch.Tensor,  # [B, F] int32
    vals: torch.Tensor,    # [B, F] f32
    lin: torch.Tensor,     # [B] bias + linear logits
    n_fields: int,         # the rows' field stride C' (Config.field_pad)
    n_factors: int,
) -> torch.Tensor:
    """Inference-only FFM logits [B] — the serving/eval hot path.  bf16
    rows (a bf16 table's, gathered as they are) are widened inside the
    kernel: the logits equal those of the f32 rows they widen to."""
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ffm_fused_logits: v is {v.dtype}, expect torch.float32 or "
                         "torch.bfloat16")
    if _device_kind("ffm_fused_logits", v) == "cpu":
        return ffm_fused_logits_plain(v, fields, vals, lin, n_fields, n_factors)
    b, f = fields.shape
    bf16 = v.dtype == torch.bfloat16
    _check_inputs("ffm_fused_logits", v, (
        ("v", v, (b * f, n_fields * n_factors), v.dtype),
        ("fields", fields, (b, f), torch.int32),
        ("vals", vals, (b, f), torch.float32),
        ("lin", lin, (b,), torch.float32),
    ))
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    out = torch.empty((b,), dtype=torch.float32, device=v.device)
    instance = ctypes.c_int(-2)  # the launcher writes the instance it picks
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        code = lib.ffm_logits_launch(
            v.data_ptr(), fields.data_ptr(), vals.data_ptr(), lin.data_ptr(),
            out.data_ptr(), b, f, n_fields, n_factors, int(bf16), stream,
            ctypes.byref(instance),
        )
    if instance.value == -1:
        raise ValueError(
            f"ffm_fused_logits: no kernel instance takes F={f}, C'={n_fields}, K={n_factors}"
        )
    _build.check(code, "ffm_logits_launch")
    if b == 0:
        return out
    ffm_fused_logits.launches += 1
    name = INSTANCES[instance.value] + ("_bf16" if bf16 else "")
    ffm_fused_logits.launches_by_instance[name] += 1
    return out


def ffm_fused_logits_grads_plain(
    v: torch.Tensor,
    fields: torch.Tensor,
    vals: torch.Tensor,
    lin: torch.Tensor,
    y: torch.Tensor,
    sample_w: torch.Tensor,
    n_fields: int,
    n_factors: int,
    aug_lane: int = -1,
    combined_out: bool = True,
    out_dtype: torch.dtype = torch.float32,
):
    """Plain PyTorch version of the training kernel:
    ops/interactions.py::ffm_logits_and_grads on the [B, F, E] view, scaled
    by gs = (sigmoid(logit) - y) * sample_w; g and g^2 side by side, or
    apart with combined_out=False.  The payload is stored in out_dtype:
    g and the f32 g * g each rounded once, as ffm_pallas.py's store does."""
    b, f = fields.shape
    logits, dv = ffm_logits_and_grads(
        v.reshape(b, f, -1), fields, vals, lin, n_fields, n_factors,
        grad_lane=aug_lane,
    )
    gs = (torch.sigmoid(logits) - y) * sample_w
    g = (gs[:, None, None] * dv).reshape(b * f, -1)
    g, g2 = g.to(out_dtype), (g * g).to(out_dtype)
    if not combined_out:
        return logits, g, g2
    return logits, torch.cat([g, g2], dim=-1)


def ffm_fused_logits_grads(
    v: torch.Tensor,         # [B*F, E] gathered factor rows (factor-major)
    fields: torch.Tensor,    # [B, F] int32
    vals: torch.Tensor,      # [B, F] f32
    lin: torch.Tensor,       # [B] bias + linear logits
    y: torch.Tensor,         # [B] labels
    sample_w: torch.Tensor,  # [B] sample weights (0 for padded samples)
    n_fields: int,           # the rows' field stride C' (Config.field_pad)
    n_factors: int,
    aug_lane: int = -1,
    combined_out: bool = True,
    out_dtype: torch.dtype = torch.float32,
):
    """FFM logits and the FTRL payload of one train step, the outputs of
    ffm_pallas.py::ffm_fused_logits_grads.  combined_out=True gives
    (logits [B], gg2 [B*F, 2E]) with the factor gradient, already scaled by
    gs = (sigmoid(logit) - y) * sample_w, in lanes [:E] and its square in
    [E:]; combined_out=False gives (logits, g [B*F, E], g2 [B*F, E]) for
    the huge-table in-place update.  aug_lane >= 0 (a dead lane of the
    padded row) carries the linear gradient gs * x instead, in either
    layout.  out_dtype torch.bfloat16 (the combined layout only, the one
    the JAX package emits in bf16) rounds g and the f32 g * g to bf16 at
    the store."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ffm_fused_logits_grads: out_dtype {out_dtype}, expect f32 or bf16")
    bf16 = out_dtype == torch.bfloat16
    if bf16 and not combined_out:
        raise ValueError("ffm_fused_logits_grads: a bf16 payload comes only combined")
    if _device_kind("ffm_fused_logits_grads", v) == "cpu":
        return ffm_fused_logits_grads_plain(
            v, fields, vals, lin, y, sample_w, n_fields, n_factors, aug_lane,
            combined_out, out_dtype,
        )
    b, f = fields.shape
    e = n_fields * n_factors
    if not -1 <= aug_lane < e:
        raise ValueError(f"ffm_fused_logits_grads: aug_lane {aug_lane} outside [-1, {e})")
    _check_inputs("ffm_fused_logits_grads", v, (
        ("v", v, (b * f, e), torch.float32),
        ("fields", fields, (b, f), torch.int32),
        ("vals", vals, (b, f), torch.float32),
        ("lin", lin, (b,), torch.float32),
        ("y", y, (b,), torch.float32),
        ("sample_w", sample_w, (b,), torch.float32),
    ))
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    logits = torch.empty((b,), dtype=torch.float32, device=v.device)
    if combined_out:
        payload = (torch.empty((b * f, 2 * e), dtype=out_dtype, device=v.device),)
    else:
        payload = tuple(
            torch.empty((b * f, e), dtype=torch.float32, device=v.device) for _ in range(2)
        )
    if b == 0:
        return logits, *payload
    instance = ctypes.c_int(-2)  # the launcher writes the instance it picks
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        code = lib.ffm_fused_launch(
            v.data_ptr(), fields.data_ptr(), vals.data_ptr(), lin.data_ptr(),
            y.data_ptr(), sample_w.data_ptr(), logits.data_ptr(), payload[0].data_ptr(),
            None if combined_out else payload[1].data_ptr(),
            b, f, n_fields, n_factors, aug_lane, int(bf16), stream,
            ctypes.byref(instance),
        )
    if instance.value == -1:
        raise ValueError(
            f"ffm_fused_logits_grads: no kernel instance takes F={f}, "
            f"C'={n_fields}, K={n_factors} (its rows overflow shared memory)"
        )
    _build.check(code, "ffm_fused_launch")
    ffm_fused_logits_grads.launches += 1
    name = INSTANCES[instance.value] + ("_bf16" if bf16 else "")
    ffm_fused_logits_grads.launches_by_instance[name] += 1
    return logits, *payload


# The kernel instances of csrc/ffm_logits.cu and csrc/ffm_fused.cu, by the
# code their launchers report: the one specialised to C'=40, K=16, F <= 40
# (the bench's shape), and the general one with its rows in shared or in
# device memory.  Each has an f32 and a bf16 form (kernel #1's bf16 rows,
# kernel #2's bf16 store), counted apart under "<name>_bf16".
INSTANCES = {2: "c40_k16", 1: "general", 0: "general_device_memory"}


# Kernel launches since the count was last set to 0 (chip_smoke.py reads
# them to show that a path went through the kernels), and the same
# launches by kernel instance and dtype.
ffm_fused_logits.launches = 0
ffm_fused_logits_grads.launches = 0
for _fn in (ffm_fused_logits, ffm_fused_logits_grads):
    _fn.launches_by_instance = dict.fromkeys(
        [*INSTANCES.values(), *(f"{n}_bf16" for n in INSTANCES.values())], 0
    )
del _fn
