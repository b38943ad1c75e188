"""The traced sub-window: torch.profiler over some train epochs and eval
passes, read back from its Chrome trace.

The harness marks each call it times with a record_function span
("bench.train" or "bench.eval"), which closes after the call's
synchronize, so every device operation of the call lies inside its span.
From the trace:

  ops      device operations (kernels, copies, fills): name, start, dur;
  spans    the harness's spans by role;
  host     host-side events (operators, runtime calls, spans), for
           naming what the host did while the device idled.

Times are in microseconds of the profiler's clock.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SPAN = "bench."


def span(role: str):
    """The harness's span around one timed call of `role`."""
    return torch.profiler.record_function(SPAN + role)


def start() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop(prof: torch.profiler.profile, read: bool = True) -> dict:
    """Stop the profiler and read its trace (through a file in the
    temporary directory, removed at once); without read, stop it alone
    (a rank whose trace no metric reads)."""
    prof.stop()
    if not read:
        return {}
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    ops, host, spans = [], [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat in DEVICE_CATS:
            ops.append((name, *iv))
        elif cat in HOST_CATS:
            host.append((name, *iv))
            if cat == "user_annotation" and name.startswith(SPAN):
                spans[name[len(SPAN):]].append(iv)
    return {"ops": ops, "host": host, "spans": dict(spans)}


def union(intervals) -> list:
    """The union of intervals, as disjoint sorted intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def role_ops(tr: dict, role: str) -> list:
    """The device operations that start inside the role's spans."""
    spans = tr["spans"].get(role, [])
    return [op for op in tr["ops"] if any(a <= op[1] < b for a, b in spans)]


def busy_us(tr: dict, role: str | None = None) -> tuple[float, float]:
    """(device-busy microseconds, wall microseconds) over the role's
    spans, or over the whole traced window (first span's start to the
    last one's end) where role is None."""
    if role is None:
        all_spans = [iv for ivs in tr["spans"].values() for iv in ivs]
        lo, hi = min(a for a, _ in all_spans), max(b for _, b in all_spans)
        windows = [(lo, hi)]
    else:
        windows = tr["spans"].get(role, [])
    busy = union([(a, b) for _, a, b in tr["ops"]])
    used = sum(b - a for w0, w1 in windows for a, b in clip(busy, w0, w1))
    return used, sum(b - a for a, b in windows)


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time (seconds, summed by
    name) and the longest idle gaps, summed by what the host was doing
    (the innermost host event at the gap's middle)."""
    by_op: dict = defaultdict(float)
    for name, a, b in tr["ops"]:
        by_op[name] += (b - a) * 1e-6
    all_spans = [iv for ivs in tr["spans"].values() for iv in ivs]
    lo, hi = min(a for a, _ in all_spans), max(b for _, b in all_spans)
    busy = union([(a, b) for _, a, b in tr["ops"]])
    edges = [lo] + [x for iv in clip(busy, lo, hi) for x in iv] + [hi]
    # sweep the gaps in time order: the host events begun by a gap's middle
    # enter a heap keyed by the latest start (the innermost of nested
    # events); those ended by then leave it for good
    host = sorted(tr["host"], key=lambda h: h[1])
    active: list = []
    i = 0
    by_gap: dict = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while i < len(host) and host[i][1] <= mid:
            heapq.heappush(active, (-host[i][1], host[i][2], host[i][0]))
            i += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        by_gap[active[0][2] if active else "(no host event)"] += (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}
