"""The TPU probes of `tools/micro_*.py`, ported to the card.

Each module here is the counterpart of the probe of the same name: the
same environment variables with the same defaults, the same arguments,
the same report lines.  Its hand-written CUDA kernel (csrc/micro_*.cu)
has a wrapper that launches it for CUDA tensors or raises, and runs its
plain PyTorch version for CPU tensors, and counts its launches.  Timing
uses CUDA events on the card (the host clock on the CPU, where a number
is only a check that the probe runs).

    python -m ftrl_ffm_tpu_torch.tools.<name> [arguments] [--device cpu]

runs a probe on the card (the default) or on the CPU.
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
