"""Readers of the mesh layer (the program's parallel/sharded.py and
parallel/dist.py, and NCCL's kernels), for the metric files of
benchmark/metrics/ that read a cell on more than one card.  Each reads
rank 0's record: its trace, its spans and its counters.  Where the
program has no such span or counter (a build without them), or the trace
no NCCL kernel, a reader returns None."""

from __future__ import annotations

import re

from benchmark.spans import PREFIX, program_counters, program_spans
from benchmark.trace import clip, role_ops, union

NCCL = re.compile(r"nccl", re.IGNORECASE)
# the spans of the route's exchange and of a step's all_reduce of its sums
MESH_SPANS = ("route.ids", "route.rows", "route.update", "mesh.sums")


def is_nccl(name: str) -> bool:
    """Whether a device operation is one of NCCL's kernels."""
    return bool(NCCL.search(name))


def nccl_share(rec: dict, role: str):
    """100 x the device time of NCCL's kernels over all device-busy time
    (each the union of its operations' intervals) inside the role's
    traced calls."""
    tr = rec.get("trace")
    if tr is None:
        return None
    windows = tr["spans"].get(role, [])
    ops = role_ops(tr, role)
    nccl = [(a, b) for name, a, b in ops if is_nccl(name)]
    if not nccl:
        return None

    def covered(intervals) -> float:
        merged = union(intervals)
        return sum(b - a for w0, w1 in windows for a, b in clip(merged, w0, w1))

    busy = covered([(a, b) for _, a, b in ops])
    return 100.0 * covered(nccl) / busy if busy > 0 else None


def collective_bytes_per_step(rec: dict, role: str):
    """The bytes that the rank handed to collectives inside the sharded
    steps of `role`, over those steps (counters mesh.<role>.bytes and
    mesh.<role>.steps, the whole run)."""
    c = program_counters(rec)
    if not c or not c.get(f"mesh.{role}.steps"):
        return None
    return c.get(f"mesh.{role}.bytes", 0) / c[f"mesh.{role}.steps"]


def route_host_ms_per_step(rec: dict, role: str):
    """The host's time a step of the role's traced calls in the route's
    exchange and the step's all_reduce: the summed durations of their
    MESH_SPANS spans over their steps, in ms."""
    steps = sum(c["steps"] for c in rec["calls"] if c["role"] == role and c.get("traced"))
    names = tuple(PREFIX + n for n in MESH_SPANS)
    durs = [b - a for n, a, b in program_spans(rec, role) if n in names]
    if not durs or not steps:
        return None
    return sum(durs) / steps * 1e-3
