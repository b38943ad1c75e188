"""Probe: per-row gather rate through a permutation, summed, on the card:
the port of tools/micro_dma_gather.py.

The fused sorted-segment scatter design (in place of a scatter that
materialises the permuted payload, about twice the bytes it needs) reads
one payload row per occurrence through the sort permutation from inside
the kernel.  The kernel (csrc/micro_gather.cu) gathers payload[perm[j]]
and folds the rows into a sum; the report gives ns/row beside the library
gather, `pay.index_select(0, perm)` (XLA's take() in the TPU probe).

Env: NNZ (319488), E2 (1280), BLK (512: the TPU's block of rows; the rows
past the last whole block are dropped, as its grid drops them), DTYPE
(float32 or bfloat16); `--device cpu` runs on the CPU.

    python -m ftrl_ffm_tpu_torch.tools.micro_dma_gather
"""

from __future__ import annotations

import os
import sys

import torch

from ftrl_ffm_tpu_torch.ops.ffm_cuda import _check_inputs, _device_kind
from ftrl_ffm_tpu_torch.tools import split_device, time_ms
from ftrl_ffm_tpu_torch.train import resolve_device

PAY_DTYPES = (torch.float32, torch.bfloat16)


def dma_gather_sum_plain(perm: torch.Tensor, pay: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [8, E2] f32, row 0 the sum over j of
    pay[perm[j]] (in f32), rows 1-7 zero."""
    out = torch.zeros((8, pay.shape[-1]), dtype=torch.float32, device=pay.device)
    out[0] = pay.index_select(0, perm.to(torch.int64)).to(torch.float32).sum(dim=0)
    return out


def dma_gather_sum(
    perm: torch.Tensor,  # [N] int32, each a row of pay
    pay: torch.Tensor,   # [M, E2] f32 or bf16
) -> torch.Tensor:
    """[8, E2] f32: row 0 the sum of the N rows pay[perm[j]], rows 1-7
    zero: the port of tools/micro_dma_gather.py::_gather_kernel
    (csrc/micro_gather.cu).  Deterministic: fixed partial sums, no atomics.
    perm must hold rows of pay (on the card nothing checks it)."""
    if _device_kind("dma_gather_sum", pay) == "cpu":
        return dma_gather_sum_plain(perm, pay)
    if pay.dim() != 2 or pay.dtype not in PAY_DTYPES:
        raise ValueError(f"dma_gather_sum: pay must be [M, E2] f32 or bf16, got "
                         f"{pay.dtype} {tuple(pay.shape)}")
    n = perm.shape[0] if perm.dim() == 1 else -1
    _check_inputs("dma_gather_sum", pay, (
        ("perm", perm, (n,), torch.int32),
        ("pay", pay, tuple(pay.shape), pay.dtype),
    ))
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    e2 = pay.shape[1]
    out = torch.empty((8, e2), dtype=torch.float32, device=pay.device)
    if e2 == 0:
        return out
    with torch.cuda.device(pay.device):
        chunks = lib.micro_gather_chunks(n, e2)
        _build.check(-min(chunks, 0), "micro_gather_chunks")
        partial = torch.empty((chunks, e2), dtype=torch.float32, device=pay.device)
        code = lib.micro_gather_launch(
            perm.data_ptr(), pay.data_ptr(), partial.data_ptr(), out.data_ptr(), n, e2,
            chunks, int(pay.dtype == torch.bfloat16),
            torch.cuda.current_stream(pay.device).cuda_stream,
        )
    _build.check(code, "micro_gather_launch")
    dma_gather_sum.launches += 1
    return out


# Kernel launches since the count was last set to 0.
dma_gather_sum.launches = 0


def main(argv: list[str] | None = None, device: str = "cuda") -> dict[str, float]:
    """Check the kernel against a float64 sum and time it beside
    index_select; returns {"gather_sum": ms, "index_select": ms}."""
    del argv  # the probe takes no arguments
    dev = resolve_device(device)
    nnz = int(os.environ.get("NNZ", 319488))
    e2 = int(os.environ.get("E2", 1280))
    blk = int(os.environ.get("BLK", 512))
    dtype = getattr(torch, os.environ.get("DTYPE", "float32"), None)
    if dtype not in PAY_DTYPES:
        raise SystemExit(f"DTYPE={os.environ.get('DTYPE')}: float32 or bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    perm_all = torch.randperm(nnz, generator=gen, device=dev).to(torch.int32)
    pay = torch.randn((nnz, e2), generator=gen, device=dev).to(dtype)
    perm = perm_all[: nnz // blk * blk]  # the TPU grid's whole blocks

    out = dma_gather_sum(perm, pay)
    ref = pay.index_select(0, perm.to(torch.int64)).to(torch.float64).sum(dim=0)
    err = float((out[0].double() / ref - 1).abs().max()) if e2 else 0.0
    name = str(dtype).removeprefix("torch.")
    print(f"NNZ={nnz} E2={e2} BLK={blk} dtype={name}  rel_err={err:.2e} device={dev}",
          flush=True)

    results: dict[str, float] = {}
    for label, fn in (("gather_sum", lambda: dma_gather_sum(perm, pay)),
                      ("index_select", lambda: pay.index_select(0, perm))):
        ms = time_ms(fn, dev, 12)
        results[label] = ms
        print(f"  {label:12s} {ms:8.3f} ms  {ms * 1e6 / max(perm.shape[0], 1):6.2f} ns/row",
              flush=True)
    return results


if __name__ == "__main__":
    _device, _argv = split_device(sys.argv[1:])
    main(_argv, _device)
