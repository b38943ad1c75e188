"""Kernels layer: the update stage's floor (benchmark/floors.py) over its
device time, in percent, traced train epochs.

The update stage's device operations are named here.  By name: the
stable sort of the ids (cub's radix sort and torch's sort helpers), the
update kernel (ftrl_update*), the z/A scatter (za_scatter*) and the
closed-form pass (ftrl_pass*).  By position: a memset or a fill counts
where the next device operation after it, in time order, that is no
memset or fill is one of those: the update's launchers clear the hot
list's length (and, in the in-place form, zero A) right before their
kernels, while a memset or fill before the gather, the interaction or
the loss counts with them.  Every other train operation is the
interaction stage's (metrics/interaction_roofline.py).
"""

from __future__ import annotations

import re

from benchmark import floors
from benchmark.readers import share
from benchmark.trace import role_ops

BY_NAME = re.compile(
    r"ftrl_update|za_scatter|ftrl_pass|RadixSort|radixSort|radix_sort|sort_postprocess"
    r"|fill_index_and_segment|fill_reverse_indices"
)
CLEARS = re.compile(r"Memset|FillFunctor")


def is_update(ops: list) -> list:
    """For device operations (name, start, end) in time order: whether
    each belongs to the update stage."""
    flags = [bool(BY_NAME.search(name)) for name, _, _ in ops]
    following = False
    for i in range(len(ops) - 1, -1, -1):
        if CLEARS.search(ops[i][0]):
            flags[i] = following
        else:
            following = flags[i]
    return flags


def stage_seconds(rec: dict, update: bool) -> float:
    """Device seconds of the traced train epochs' update-stage operations
    (update=True) or of all the others."""
    ops = sorted(role_ops(rec["trace"], "train"), key=lambda op: op[1])
    return sum(b - a for (_, a, b), f in zip(ops, is_update(ops)) if f == update) * 1e-6


def read(rec: dict):
    return share(rec, "train", True, lambda cfg, rows, u: floors.update_floor(cfg, u),
                 lambda calls: stage_seconds(rec, True))
