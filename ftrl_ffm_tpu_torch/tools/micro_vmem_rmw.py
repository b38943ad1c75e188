"""Probe: dynamic-row read-modify-write throughput into fast memory, on the
card: the port of tools/micro_vmem_rmw.py.

The field-window aggregation design (in place of a scatter-add) hinges on
how fast a kernel can do

    acc[idx[b], :] += payload[b, :]

one dynamic row at a time, acc resident in fast memory (here shared
memory, csrc/micro_rmw.cu's base variant).  This measures that rate for a
single field-shaped problem, acc [PER_PAD, E] f32, payload [B, E], random
idx, and extrapolates to the full step (39 fields, E2=1280 as two halves).
Env: B (8192), PER (2564), E (640), BLK (512: the TPU's block of payload
rows; the rows past the last whole block are dropped, as its grid drops
them), DTYPE (float32 or bfloat16, the payload's); `--device cpu` runs on
the CPU.

    python -m ftrl_ffm_tpu_torch.tools.micro_vmem_rmw
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ftrl_ffm_tpu_torch.ops.ffm_cuda import _device_kind
from ftrl_ffm_tpu_torch.tools import split_device, time_ms
from ftrl_ffm_tpu_torch.tools.micro_vmem_rmw2 import PAY_DTYPES, launch_rmw, rmw_plain
from ftrl_ffm_tpu_torch.train import resolve_device


def rmw(
    idx: torch.Tensor,  # [N] or [1, N] int32 acc rows
    pay: torch.Tensor,  # [N, E] f32 or bf16 (cast to f32 as it is added)
    rows: int,          # acc rows: PER rounded up to a multiple of 8
) -> torch.Tensor:
    """acc [rows, E] f32 = zeros with acc[idx[b]] += pay[b] in payload
    order: the port of tools/micro_vmem_rmw.py::_rmw_kernel (the base
    variant of csrc/micro_rmw.cu)."""
    if _device_kind("rmw", pay) == "cpu":
        return rmw_plain(idx, pay, "base", rows)
    out = launch_rmw("rmw", idx, pay, "base", rows)
    rmw.launches += 1
    return out


# Kernel launches since the count was last set to 0.
rmw.launches = 0


def main(argv: list[str] | None = None, device: str = "cuda") -> dict[str, float]:
    """Check the kernel against numpy's add.at and time it; returns
    {"rmw": ms}."""
    del argv  # the probe takes no arguments
    dev = resolve_device(device)
    b = int(os.environ.get("B", 8192))
    per = int(os.environ.get("PER", 2564))
    e = int(os.environ.get("E", 640))
    blk = int(os.environ.get("BLK", 512))
    dtype = getattr(torch, os.environ.get("DTYPE", "float32"), None)
    if dtype not in PAY_DTYPES:
        raise SystemExit(f"DTYPE={os.environ.get('DTYPE')}: float32 or bfloat16")
    rows = -(-per // 8) * 8
    rng = np.random.default_rng(0)
    used = b // blk * blk  # the TPU grid's whole blocks
    idx_np = rng.integers(0, per, (1, b)).astype(np.int32)[:, :used]
    pay = torch.from_numpy(rng.normal(0, 1, (b, e)).astype(np.float32)[:used]).to(dtype)
    idx = torch.from_numpy(idx_np).to(dev)
    pay_d = pay.to(dev)

    t0 = time.perf_counter()
    out = rmw(idx, pay_d, rows).cpu().numpy()  # the first call builds the kernels
    first = time.perf_counter() - t0
    ref = np.zeros((rows, e), np.float32)
    np.add.at(ref, idx_np[0], pay.to(torch.float32).numpy())
    err = float(np.abs(out - ref).max()) if out.size else 0.0
    name = str(dtype).removeprefix("torch.")
    print(f"B={b} PER={per} E={e} BLK={blk} dtype={name}  max_err={err:.2e} device={dev}",
          flush=True)

    print(f"  first call {first:.1f}s", flush=True)

    ms = time_ms(lambda: rmw(idx, pay_d, rows), dev, 12)
    ns_row = ms * 1e6 / max(used, 1)
    # full step: 39 such fields, x2 for E2=1280 as two 640-wide halves
    print(f"  rmw: {ms:.3f} ms per {used} rows -> {ns_row:.1f} ns/row; "
          f"full step (39 fields, E2=1280) ~ {ms * 39 * 2:.1f} ms", flush=True)
    return {"rmw": ms}


if __name__ == "__main__":
    _device, _argv = split_device(sys.argv[1:])
    main(_argv, _device)
