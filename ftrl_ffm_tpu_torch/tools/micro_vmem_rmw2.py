"""RMW probe v2 on the card: what sets the cost of a dynamic-row
read-modify-write into fast memory?  The port of tools/micro_vmem_rmw2.py.

Variants over the single-field shape (acc [PER_PAD, E] f32 in shared
memory, csrc/micro_rmw.cu; payload [B, E]):

  base        one RMW per payload row
  unroll8     eight payload loads in flight before their eight RMWs (on
              the card every variant has a chunk of loads in flight, so
              unroll8 runs base's code)
  dual        pairs of rows; a duplicate within a pair is merged into the
              first RMW and the second goes to the dump row (acc row
              PER_PAD - 8), so the two RMWs of a pair are independent
  wo          write-only (acc[idx] = row, no read-modify): the last row wins
  rd          read-only (acc[idx] read and summed): the output is zeros

Every variant sums (or writes) each element in payload order, so each is
bit for bit its plain PyTorch version.  Env: B (8192), PER (2564), E (640),
BLK (512, a multiple of 8: the TPU's block of payload rows; the rows past
the last whole block are dropped, as its grid drops them); arguments: the
variants (all by default), `--device cpu` for the CPU.

    python -m ftrl_ffm_tpu_torch.tools.micro_vmem_rmw2 [base dual ...]
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from ftrl_ffm_tpu_torch.ops.ffm_cuda import _check_inputs, _device_kind
from ftrl_ffm_tpu_torch.tools import split_device, time_ms
from ftrl_ffm_tpu_torch.train import resolve_device

VARIANTS = ("base", "unroll8", "dual", "wo", "rd")
PAY_DTYPES = (torch.float32, torch.bfloat16)


def per_pad(per: int) -> int:
    """acc rows for PER live rows: a multiple of 8, plus the dump row's 8."""
    return -(-per // 8) * 8 + 8


def rmw_plain(idx, pay, variant: str, rows: int) -> torch.Tensor:
    """Plain PyTorch version: acc [rows, E] f32 from zero after the
    variant's payload-order updates (ids outside [0, rows) dropped); see the
    module docstring and csrc/micro_rmw.cu."""
    if variant not in VARIANTS:
        raise ValueError(f"rmw: unknown variant {variant!r}; choose from {VARIANTS}")
    if variant == "dual" and (idx.numel() % 2 or rows < 8):
        raise ValueError(f"rmw: dual needs an even N ({idx.numel()}) and 8+ rows ({rows})")
    idx = idx.reshape(-1).to(torch.int64)
    pay = pay.to(torch.float32)
    out = torch.zeros((rows, pay.shape[-1]), dtype=torch.float32, device=pay.device)
    if variant == "rd":  # reads of zeros, summed back in: zeros
        return out
    if variant == "dual":
        i0, i1 = idx[0::2], idx[1::2]
        same = i0 == i1
        r0 = pay[0::2] + torch.where(same[:, None], pay[1::2], 0.0)
        r1 = torch.where(same[:, None], 0.0, pay[1::2])
        i1 = torch.where(same, rows - 8, i1)
        idx = torch.stack([i0, i1], dim=1).reshape(-1)
        pay = torch.stack([r0, r1], dim=1).reshape(-1, pay.shape[-1])
    keep = (idx >= 0) & (idx < rows)
    idx, pay = idx[keep], pay[keep]
    if variant == "wo":
        pos = torch.arange(idx.shape[0], device=idx.device)
        last = torch.full((rows,), -1, dtype=torch.int64, device=idx.device)
        last.scatter_reduce_(0, idx, pos, "amax")
        written = last >= 0
        out[written] = pay[last[written]]
        return out
    # CPU index_add_ adds the rows in index order: the kernel's order
    return out.index_add_(0, idx, pay)


def launch_rmw(what: str, idx, pay, variant: str, rows: int) -> torch.Tensor:
    """Check the inputs and launch csrc/micro_rmw.cu; returns acc."""
    if variant not in VARIANTS:
        raise ValueError(f"{what}: unknown variant {variant!r}; choose from {VARIANTS}")
    n = idx.numel()
    if pay.dim() != 2 or pay.dtype not in PAY_DTYPES:
        raise ValueError(f"{what}: pay must be [N, E] f32 or bf16, got {pay.dtype} "
                         f"{tuple(pay.shape)}")
    e = pay.shape[1]
    if rows < 1:
        raise ValueError(f"{what}: {rows} acc rows")
    if variant == "dual" and (n % 2 or rows < 8):
        raise ValueError(f"{what}: dual needs an even N ({n}) and 8+ rows ({rows})")
    _check_inputs(what, pay, (
        ("idx", idx.reshape(-1), (n,), torch.int32),
        ("pay", pay, (n, e), pay.dtype),
    ))
    if not idx.is_contiguous():
        raise ValueError(f"{what}: idx is not contiguous")
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    out = torch.empty((rows, e), dtype=torch.float32, device=pay.device)
    # the events binned by row class (csrc/micro_rmw.cu's first kernel)
    scratch = torch.empty(
        (lib.micro_rmw_scratch_ints(n),), dtype=torch.int32, device=pay.device
    )
    # the probe's kernels take a few microseconds, so the dispatch is kept
    # lean: no device switch when pay is on the current device, and the
    # current stream's raw handle without building a torch.cuda.Stream
    dev = pay.device
    switch = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        code = lib.micro_rmw_launch(
            idx.data_ptr(), pay.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, rows, e,
            VARIANTS.index(variant), int(pay.dtype == torch.bfloat16),
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    _build.check(code, "micro_rmw_launch")
    return out


def run_kernel(
    idx: torch.Tensor,  # [N] or [1, N] int32 acc rows
    pay: torch.Tensor,  # [N, E] f32 or bf16
    variant: str,
    rows: int,          # acc rows (per_pad(PER)); dual's dump row is rows - 8
) -> torch.Tensor:
    """acc [rows, E] f32 after the variant's updates: the port of
    tools/micro_vmem_rmw2.py::make(variant).kern (csrc/micro_rmw.cu)."""
    if _device_kind("run_kernel", pay) == "cpu":
        return rmw_plain(idx, pay, variant, rows)
    out = launch_rmw("run_kernel", idx, pay, variant, rows)
    run_kernel.launches += 1
    return out


# Kernel launches since the count was last set to 0.
run_kernel.launches = 0


def main(argv: list[str] | None = None, device: str = "cuda") -> dict[str, float]:
    """Run the variants named in argv (all by default), each checked and
    timed; returns {variant: ms}."""
    dev = resolve_device(device)
    b = int(os.environ.get("B", 8192))
    per = int(os.environ.get("PER", 2564))
    e = int(os.environ.get("E", 640))
    blk = int(os.environ.get("BLK", 512))
    if blk < 8 or blk % 8:
        raise SystemExit(f"BLK={blk}: a multiple of 8 (unroll8 and dual take whole groups)")
    rows = per_pad(per)
    rng = np.random.default_rng(0)
    idx_np = rng.integers(0, per, (1, b)).astype(np.int32)
    pay_np = rng.normal(0, 1, (b, e)).astype(np.float32)
    used = b // blk * blk  # the TPU grid's whole blocks
    idx = torch.from_numpy(idx_np[:, :used]).to(dev)
    pay = torch.from_numpy(pay_np[:used]).to(dev)

    variants = list(argv) if argv else list(VARIANTS)
    print(f"B={b} PER={per} E={e} BLK={blk} device={dev}", flush=True)
    results: dict[str, float] = {}
    for v in variants:
        out = run_kernel(idx, pay, v, rows).cpu().numpy()
        if v in ("base", "unroll8", "dual"):
            ref = np.zeros((rows, e), np.float32)
            np.add.at(ref, idx_np[0, :used], pay_np[:used])
            err = float(np.abs(out[:per] - ref[:per]).max()) if per else 0.0
        else:
            err = -1.0
        ms = time_ms(lambda: run_kernel(idx, pay, v, rows), dev, 48)
        results[v] = ms
        print(f"  {v:8s} {ms:7.3f} ms  {ms * 1e6 / max(used, 1):6.1f} ns/row  "
              f"max_err={err:.2e}", flush=True)
    return results


if __name__ == "__main__":
    _device, _argv = split_device(sys.argv[1:])
    main(_argv, _device)
