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

The measurement tools of tools/*.py have twins here too, with the same
names, environment variables, rows or phases and output keys:
`bench_matrix` (the end-to-end matrix, one subprocess a row),
`profile_step` (one train or eval step by the difference method, beside
its roofline floor), `roofline` (the bytes a train step of the port's
design moves) and `micro_scatter` (torch's sort, gather and scatter-add
calls timed; no hand-written kernel).  The headline benchmark is
`python -m ftrl_ffm_tpu_torch.bench`.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ftrl_ffm_tpu_torch.ops import counted_wrappers


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them
    (`--query-gpu=name,power.limit --format=csv,noheader`), for the line
    of every number measured on it; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return out[index].strip()


def reset_launch_counts() -> None:
    """Every counted wrapper's launches, by instance and by dtype too, set
    to 0."""
    for fn in counted_wrappers():
        fn.launches = 0
        for counts in (getattr(fn, "launches_by_instance", {}),
                       getattr(fn, "launches_by_dtype", {})):
            for name in counts:
                counts[name] = 0


def read_launch_counts() -> dict:
    """Each counted wrapper's launches since the last reset, by its name;
    then the update kernel's and kernel #3's by dtype, and kernels #1 and
    #2, the update kernel and the scatter by kernel instance (the entries
    that ran)."""
    fns = counted_wrappers()
    out = {fn.__name__: fn.launches for fn in fns}
    out["logits_by_instance"] = {k: v for k, v in fns[0].launches_by_instance.items() if v}
    out["fused_by_instance"] = {k: v for k, v in fns[1].launches_by_instance.items() if v}
    out["update_by_dtype"] = {k: v for k, v in fns[2].launches_by_dtype.items() if v}
    out["pass_by_dtype"] = {k: v for k, v in fns[4].launches_by_dtype.items() if v}
    out["update_by_instance"] = {k: v for k, v in fns[2].launches_by_instance.items() if v}
    out["scatter_by_instance"] = {k: v for k, v in fns[3].launches_by_instance.items() if v}
    return out


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (the read-back that closes a timed
    region); nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
