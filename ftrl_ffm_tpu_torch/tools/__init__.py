"""The TPU probes of `tools/micro_*.py`, ported to the card.

Each module here is the counterpart of the probe of the same name: the
same environment variables with the same defaults, the same arguments,
the same report lines.  Its hand-written CUDA kernel (csrc/micro_*.cu)
has a wrapper that launches it for CUDA tensors or raises, and runs its
plain PyTorch version for CPU tensors, and counts its launches.  Timing
uses CUDA events on the card (the host clock on the CPU, where a number
is only a check that the probe runs).

    python -m ftrl_ffm_tpu_torch.tools.<name> [arguments] [--device cpu]

runs a probe on the card (the default) or on the CPU.  `kernel_ab.py`
times kernels #1 and #2, the update kernel, the z/A scatter and the RMW
probe kernel of one copy of the package, for A/B runs of two commits (see
its docstring).
"""

from __future__ import annotations

import argparse
import time

import torch


def split_device(argv: list[str]) -> tuple[str, list[str]]:
    """(device name, the other arguments) from a probe's command line:
    `--device NAME` or `--device=NAME`, "cuda" when absent."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    known, rest = parser.parse_known_args(argv)
    return known.device, rest


def time_ms(fn, device: torch.device, iters: int) -> float:
    """Milliseconds per call of fn after one warm-up call: CUDA events
    around `iters` calls on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device milliseconds per call of fn on the current card: `iters`
    calls captured in one CUDA graph, replayed between CUDA events, so the
    host's dispatch (Python, checks, allocation, launch calls) is left out;
    the median of 5 replays.  fn runs once first, outside the capture."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[len(times) // 2]


def profile_ms(fn, iters: int) -> list[tuple[str, float]]:
    """(kernel, device milliseconds per call of fn) on the current card,
    from torch.profiler over `iters` calls after a warm-up call, largest
    first; memory copies and fills count as kernels.  A profiler run may
    leave the host's launch path slower for the rest of the process: time
    the host's side before it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / iters) for e in prof.key_averages()
            if e.device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])
