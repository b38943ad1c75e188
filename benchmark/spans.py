"""Readers of the program's own spans and counters (ftrl_ffm_tpu_torch/
tracing.py), for the metric files of benchmark/metrics/ that read them.

The spans are torch.profiler record_function ranges named "ftrl.<name>",
in the traced sub-window's host events (`rec["trace"]["host"]`: name,
start, end in microseconds of the profiler's clock, the device's clock
too).  A span belongs to a role where it starts inside one of the
harness's spans of that role ("bench.train", "bench.eval").  The counters
are the program's registry (`tracing.read()`), which the harness sets
to 0 before port.build: the record's "counters_build" are its reading
after the build (the resident datasets' parse), its "counters" the
reading after the window (the whole run); where a record holds neither,
the program in this process is read.
Where the program has no such span or counter (a build without them),
each reader returns None.
"""

from __future__ import annotations

PREFIX = "ftrl."


def program_spans(rec: dict, role: str) -> list:
    """(name, start, end) of the program's spans that start inside the
    harness's spans of `role`, in the traced sub-window."""
    tr = rec.get("trace")
    if tr is None:
        return []
    windows = tr["spans"].get(role, [])
    return [(n, a, b) for n, a, b in tr["host"]
            if n.startswith(PREFIX) and any(w0 <= a < w1 for w0, w1 in windows)]


def epoch_start_ms(rec: dict):
    """Mean over the traced train epochs of the time from the start of
    the epoch's "ftrl.train.epoch" span to the start of its first step,
    gather or group span: the epoch start on the host (its resident
    dataset's shuffle, index table and upload), in ms."""
    spans = program_spans(rec, "train")
    firsts = ("ftrl.train.step", "ftrl.train.gather", "ftrl.train.group")
    gaps = []
    for name, a, b in spans:
        if name != "ftrl.train.epoch":
            continue
        starts = [s for n, s, _ in spans if n in firsts and a <= s <= b]
        if starts:
            gaps.append(min(starts) - a)
    return sum(gaps) / len(gaps) * 1e-3 if gaps else None


def host_ms_per_step(rec: dict, role: str):
    """The host's time a step of the role's traced calls: the summed
    durations of their "ftrl.<role>.step" and "ftrl.<role>.gather" spans
    (one step a dispatch), or of their "ftrl.<role>.group" spans (S steps a
    dispatch), over their steps, in ms."""
    steps = sum(c["steps"] for c in rec["calls"] if c["role"] == role and c.get("traced"))
    names = tuple(f"{PREFIX}{role}.{k}" for k in ("step", "gather", "group"))
    durs = [b - a for n, a, b in program_spans(rec, role) if n in names]
    if not durs or not steps:
        return None
    return sum(durs) / steps * 1e-3


def program_counters(rec: dict, key: str = "counters"):
    """The program's counters of the record under `key` ("counters": the
    whole run; "counters_build": the build), or None."""
    if rec.get(key) is not None:
        return rec[key]
    try:
        from ftrl_ffm_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.read()


def parse_numpy_share(rec: dict):
    """100 x the rows that the numpy parser took over all rows parsed in
    the build."""
    c = program_counters(rec, "counters_build")
    if not c:
        return None
    native, numpy = c.get("parse.rows.native", 0), c.get("parse.rows.numpy", 0)
    if native + numpy == 0:
        return None
    return 100.0 * numpy / (native + numpy)
