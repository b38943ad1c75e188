"""What the metric files of benchmark/metrics/ read from a run's record,
where more than one file reads it; each metric file's `read` is one of
these or its own.

The record (benchmark/run.py's run_cell): "config"; "calls", one entry
a timed train_epoch() or evaluate() call (role, seconds, examples,
steps, and for training the epoch's index; "traced" where it ran under
the profiler); "setup_s" and "resident_build_s"; with --trace 1 also
"trace" (benchmark/trace.py's read of the profiler), "launches_train"
(the program's launch counters over the traced train epochs) and
"unique_rows" (the rows and distinct rows of each global step, for the
floors); "cards", the cards of the run.  A reader that finds nothing
to read returns None and the metric is left out.
"""

from __future__ import annotations

from benchmark import floors
from benchmark.trace import busy_us


def rate(rec: dict, role: str):
    """Examples a second of the role's calls: all their examples over all
    their seconds."""
    calls = [c for c in rec["calls"] if c["role"] == role]
    if not calls:
        return None
    return sum(c["examples"] for c in calls) / sum(c["seconds"] for c in calls)


def train_rate(rec: dict):
    return rate(rec, "train")


def eval_rate(rec: dict):
    return rate(rec, "eval")


def setup_s(rec: dict):
    return rec["setup_s"]


def resident_build_s(rec: dict):
    return rec.get("resident_build_s")


def launches_per_train_step(rec: dict):
    lt = rec.get("launches_train")
    if not lt or not lt["steps"]:
        return None
    return lt["launches"] / lt["steps"]


def _steps(rec: dict, call: dict) -> list:
    """(rows, distinct rows) of each step of a timed call."""
    key = ("train", call["epoch"]) if call["role"] == "train" else ("eval", 0)
    return rec["unique_rows"][key]


def share(rec: dict, role: str, traced: bool, floor, seconds) -> float | None:
    """100 x the floors of the role's (traced or untraced) calls' steps
    over `seconds` (a function of those calls), a card's share: on N
    cards each is held to 1/N of a global step's floor."""
    if rec.get("unique_rows") is None or (traced and rec.get("trace") is None):
        return None
    calls = [c for c in rec["calls"] if c["role"] == role and c["traced"] == traced]
    if not calls:
        return None
    t = seconds(calls)
    if t <= 0:
        return None
    cfg = rec["config"]
    total = sum(floor(cfg, rows, u) for c in calls for rows, u in _steps(rec, c))
    return 100.0 * total / rec.get("cards", 1) / t


def train_step_mfu(rec: dict):
    """The train steps' floor over their wall seconds, untraced epochs."""
    return share(rec, "train", False, floors.train_step_floor,
                  lambda calls: sum(c["seconds"] for c in calls))


def eval_step_mfu(rec: dict):
    """The eval steps' floor over their wall seconds, untraced passes."""
    return share(rec, "eval", False, floors.eval_step_floor,
                  lambda calls: sum(c["seconds"] for c in calls))


def idle(rec: dict, role: str):
    """The share of the role's traced calls' wall time in which no
    operation ran on the device (profiler: the union of kernels, copies
    and fills inside the harness's spans), in percent."""
    if rec.get("trace") is None:
        return None
    busy, wall = busy_us(rec["trace"], role)
    return 100.0 * (1.0 - busy / wall) if wall > 0 else None


def train_idle(rec: dict):
    return idle(rec, "train")


def eval_idle(rec: dict):
    return idle(rec, "eval")
