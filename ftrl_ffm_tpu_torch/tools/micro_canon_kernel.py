"""Probe: the canonical-fields FFM kernel against the general one, on the
card: the port of tools/micro_canon_kernel.py.

For one-feature-per-field data in canonical slot order (fields[b] ==
[0..C'-1] for every sample — the bench workload, and real Criteo after the
usual preparation) the FFM interaction algebra collapses:

    s_t[b, m, (k, c')] = xv[b, c', (k, m)]      xv = x * v, no field sort
    self term: slot (k, c) of row m counts only where c == m (static mask)

so the kernel (csrc/micro_canon.cu) needs no counting sort and no field
buckets.  It is held against the general training kernel (kernel #2,
ops/ffm_cuda.py::ffm_fused_logits_grads) on canonical fields and timed
beside it.  Env: BATCH (8192); NOTR set times the variant without the
field crossing (s_t = xv + 1).  `--device cpu` runs on the CPU.

    python -m ftrl_ffm_tpu_torch.tools.micro_canon_kernel
"""

from __future__ import annotations

import os
import sys

import torch

from ftrl_ffm_tpu_torch.ops.ffm_cuda import _check_inputs, _device_kind, ffm_fused_logits_grads
from ftrl_ffm_tpu_torch.tools import split_device, time_ms
from ftrl_ffm_tpu_torch.train import resolve_device

C = 39          # real fields
CP = 40         # padded fields (field_pad)
K = 16
E = CP * K      # 640
AUG_LANE = C    # dead lane (k=0, c=39)


def canon_plain(v, vals, lin, y, sw, notr: bool = False):
    """Plain PyTorch version (the body of
    tools/micro_canon_kernel.py::_canon_kernel): (logits [B], (g || g^2)
    [B*CP, 2E]) for v [B*CP, E], vals [B, CP] with field m in slot m."""
    b = vals.shape[0]
    xv = v.reshape(b, CP, E) * vals[:, :, None]  # xv[b, m, :] = x_m * v_m
    if notr:
        s_t = xv + 1.0  # timing variant: no field crossing
    else:
        # s_t[b, m, (k, c')] = xv[b, c', (k, m)]
        s_t = xv.reshape(b, CP, K, CP).permute(0, 3, 2, 1).reshape(b, CP, E)
    slot_field = torch.arange(E, device=v.device) % CP
    self_mask = (slot_field[None, :] == torch.arange(CP, device=v.device)[:, None]).to(v.dtype)
    self_sq = torch.sum(self_mask * xv * xv, dim=(1, 2))
    cross = torch.sum(xv * s_t, dim=(1, 2))
    logits = lin + 0.5 * (cross - self_sq)
    gs = (torch.sigmoid(logits) - y) * sw
    gx = gs[:, None] * vals
    g = gx[:, :, None] * (s_t - self_mask * xv)
    g[:, :, AUG_LANE] = gx
    g = g.reshape(b * CP, E)
    return logits, torch.cat([g, g * g], dim=-1)


def canon(
    v: torch.Tensor,     # [B*CP, E] f32 gathered rows, row m of a sample = field m
    vals: torch.Tensor,  # [B, CP] f32
    lin: torch.Tensor,   # [B] bias + linear logits
    y: torch.Tensor,     # [B] labels
    sw: torch.Tensor,    # [B] sample weights
    notr: bool = False,
):
    """(logits [B], (g || g^2) [B*CP, 2E]) on canonical fields, the linear
    gradient in lane AUG_LANE: the port of
    tools/micro_canon_kernel.py::_canon_kernel (csrc/micro_canon.cu), any
    B.  notr=True is the probe's variant without the field crossing."""
    if _device_kind("canon", v) == "cpu":
        return canon_plain(v, vals, lin, y, sw, notr)
    b = vals.shape[0] if vals.dim() == 2 else -1
    _check_inputs("canon", v, (
        ("v", v, (b * CP, E), torch.float32),
        ("vals", vals, (b, CP), torch.float32),
        ("lin", lin, (b,), torch.float32),
        ("y", y, (b,), torch.float32),
        ("sw", sw, (b,), torch.float32),
    ))
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    logits = torch.empty((b,), dtype=torch.float32, device=v.device)
    out = torch.empty((b * CP, 2 * E), dtype=torch.float32, device=v.device)
    if b == 0:
        return logits, out
    with torch.cuda.device(v.device):
        code = lib.micro_canon_launch(
            v.data_ptr(), vals.data_ptr(), lin.data_ptr(), y.data_ptr(), sw.data_ptr(),
            logits.data_ptr(), out.data_ptr(), b, int(notr),
            torch.cuda.current_stream(v.device).cuda_stream,
        )
    _build.check(code, "micro_canon_launch")
    canon.launches += 1
    return logits, out


# Kernel launches since the count was last set to 0.
canon.launches = 0


def main(argv: list[str] | None = None, device: str = "cuda") -> dict[str, float]:
    """Check the canonical kernel against the general one and time both;
    returns {"general": ms, "canonical": ms}."""
    del argv  # the probe takes no arguments
    dev = resolve_device(device)
    b = int(os.environ.get("BATCH", 8192))
    notr = bool(os.environ.get("NOTR"))
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn((b * CP, E), generator=gen, device=dev) * 0.1
    lin = torch.randn((b,), generator=gen, device=dev) * 0.1
    y = (torch.rand((b,), generator=gen, device=dev) > 0.5).to(torch.float32)
    sw = torch.ones((b,), device=dev)
    fields = torch.arange(CP, dtype=torch.int32, device=dev).repeat(b, 1)
    # the pad column's values are 0, as in a real batch (columns >= C)
    vals_in = torch.ones((b, CP), device=dev)
    vals_in[:, C:] = 0.0

    def general():
        return ffm_fused_logits_grads(v, fields, vals_in, lin, y, sw, CP, K,
                                      aug_lane=AUG_LANE, combined_out=True)

    if not notr:
        lo_ref, gg_ref = general()
        lo, gg = canon(v, vals_in, lin, y, sw)
        print("logit err:", float((lo - lo_ref).abs().max()),
              " gg2 err:", float((gg - gg_ref).abs().max()), flush=True)
        del lo_ref, gg_ref, lo, gg
    t_gen = time_ms(general, dev, 12)
    t_can = time_ms(lambda: canon(v, vals_in, lin, y, sw, notr=notr), dev, 12)
    print(f"general: {t_gen:.2f} ms   canonical: {t_can:.2f} ms  (B={b}, device={dev}"
          f"{', NOTR' if notr else ''})", flush=True)
    return {"general": t_gen, "canonical": t_can}


if __name__ == "__main__":
    _device, _argv = split_device(sys.argv[1:])
    main(_argv, _device)
