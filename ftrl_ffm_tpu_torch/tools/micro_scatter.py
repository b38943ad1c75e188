"""Micro-benchmarks of torch's sort, gather and scatter-add calls on the
card, at the train step's payload shape (the twin of tools/micro_scatter.py,
which has no Pallas kernel; this launches no hand-written kernel either).

They price the choices the port makes around its own update and scatter
kernels (ops/ftrl_cuda.py: a stable sort of the ids before each launch)
against what one torch call does:

  sanity_mm     a 1024^2 f32 matmul (is the card there, at its rate?)
  sort_flat     torch.sort (stable) of the flat [B*C] id stream
  sort_cols     a per-column torch.sort (stable) of the [B, C] ids
  argsort_flat  torch.argsort (stable) of the flat ids
  take_perm     payload permute-gather [B*C, 2E] (index_select by a perm)
  scat_full     index_add_ of all B*C payload rows into zeros [R, 2E]
  scat_uniq     index_add_ of the deduplicated ids' rows only (the rest
                sent to a sentinel row, as the JAX probe drops them)
  seg_sorted    index_add_ on the sorted ids (jax.ops.segment_sum with
                indices_are_sorted in the JAX probe)
  scat_sorted   index_add_ on the sorted ids (lax.scatter_add with
                indices_are_sorted): torch has no sorted-index hint, so the
                two sorted phases run the same call, and their spread is
                the method's

Each is timed with the difference method: two chained runs of 4 and 16
calls, each call's input perturbed by the previous result times 1e-30,
one read-back (torch.cuda.synchronize) each; the result reduced by a max
or an index-weighted max, which no call can skip.  Each call allocates
its outputs, as the JAX probe's jitted functions do.

Env: BATCH (8192), N_FEATS (100000), C (39), E (640), DTYPE (bfloat16).

    python -m ftrl_ffm_tpu_torch.tools.micro_scatter [phase ...] [--device cpu]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ftrl_ffm_tpu_torch.tools import split_device, synchronize
from ftrl_ffm_tpu_torch.train import resolve_device

PHASES = ("sanity_mm", "sort_flat", "sort_cols", "argsort_flat", "take_perm",
          "scat_full", "scat_uniq", "seg_sorted", "scat_sorted")


def chain_time(f, x0: torch.Tensor, *args, iters=(4, 16)) -> float:
    """Difference-method ms per call of y = f(x, *args), chained through
    x (a 0-dim f32 tensor): x = f(x, *args) * 1e-30."""
    device = x0.device
    f(x0, *args)
    synchronize(device)

    def run(n: int) -> float:
        t0 = time.perf_counter()
        xx = x0
        for _ in range(n):
            xx = f(xx, *args) * 1e-30
        xx.item()
        synchronize(device)
        return time.perf_counter() - t0

    run(1)
    t1, t2 = run(iters[0]), run(iters[1])
    return (t2 - t1) / (iters[1] - iters[0]) * 1e3


def _wmax(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32).max()


def main(argv: Optional[list[str]] = None, device: str = "cuda") -> dict[str, float]:
    """Time the phases named in argv (all by default); returns
    {phase: ms}."""
    b = int(os.environ.get("BATCH", 8192))
    c = int(os.environ.get("C", 39))
    r = int(os.environ.get("N_FEATS", 100_000))
    e2 = 2 * int(os.environ.get("E", 640))
    dt = getattr(torch, os.environ.get("DTYPE", "bfloat16"))
    nnz = b * c
    which = list(argv or PHASES)
    for name in which:
        if name not in PHASES:
            raise SystemExit(f"unknown phase {name!r}; phases: {' '.join(PHASES)}")
    dev = resolve_device(device)

    rng = np.random.default_rng(0)
    per = r // c
    ids2d_np = (rng.integers(0, per, (b, c)) + np.arange(c) * per).astype(np.int32)
    uniq_np = np.unique(ids2d_np.reshape(-1))
    n_uniq = uniq_np.size
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    # int32 ids, as the port's wrappers sort and the JAX probe scatters them
    ids = put(ids2d_np.reshape(-1).copy())
    ids_2d = put(ids2d_np)
    # deduplicated ids, padded with the sentinel row R (dropped in the JAX
    # probe; here the scatters' tables carry one row for it)
    uniq = put(np.pad(uniq_np, (0, nnz - n_uniq), constant_values=r).astype(np.int32))
    perm = put(rng.permutation(nnz).astype(np.int32))
    sids = put(np.sort(ids2d_np.reshape(-1)))
    payload = put(rng.normal(0, 1, (nnz, e2)).astype(np.float32)).to(dt)
    mm = put(rng.normal(0, 1, (1024, 1024)).astype(np.float32))
    x0 = torch.zeros((), dtype=torch.float32, device=dev)
    print(f"B={b} C={c} R={r} E2={e2} dtype={str(dt).removeprefix('torch.')} nnz={nnz} "
          f"uniq={n_uniq} device={dev}", flush=True)

    flat_w = torch.arange(nnz, device=dev)
    col_w = torch.arange(b, device=dev)[:, None]

    def sort_flat(x, i):
        return _wmax(torch.sort(i + x.to(i.dtype), stable=True).values * flat_w)

    def sort_cols(x, i):
        return _wmax(torch.sort(i + x.to(i.dtype), dim=0, stable=True).values * col_w)

    def argsort_flat(x, i):
        return _wmax(torch.argsort(i + x.to(i.dtype), stable=True) * flat_w)

    def take_perm(x, p, pay):
        return _wmax((pay + x.to(dt)).index_select(0, p))

    def scat(x, i, pay):
        acc = torch.zeros((r + 1, e2), dtype=dt, device=dev)
        return _wmax(acc.index_add_(0, i, pay + x.to(dt)))

    def sanity_mm(x, m):
        return torch.mm(m + x, m).max()

    table = {
        "sanity_mm": (sanity_mm, mm),
        "sort_flat": (sort_flat, ids),
        "sort_cols": (sort_cols, ids_2d),
        "argsort_flat": (argsort_flat, ids),
        "take_perm": (take_perm, perm, payload),
        "scat_full": (scat, ids, payload),
        "scat_uniq": (scat, uniq, payload),
        "seg_sorted": (scat, sids, payload),
        "scat_sorted": (scat, sids, payload),
    }
    results: dict[str, float] = {}
    for name in PHASES:
        if name not in which:
            continue
        f, *args = table[name]
        ms = chain_time(f, x0, *args)
        results[name] = ms
        print(f"  {name:12s} {ms:8.2f} ms", flush=True)
    return results


if __name__ == "__main__":
    _device, _argv = split_device(sys.argv[1:])
    main(_argv, _device)
