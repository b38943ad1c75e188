"""Kernels layer of the four-card route cell: the interaction stage's
floor (benchmark/floors.py) over the device time, on rank 0, of every
traced train operation that is neither the update stage's
(metrics/update_roofline.py names those) nor NCCL's (benchmark/mesh.py):
kernel #2 (here its C'=40, K=16 instance), the gather of the routed rows,
the loss and the bias; in percent, rank 0 held to a quarter of each
global step's floor (readers.share)."""

from benchmark import floors
from benchmark.mesh import is_nccl
from benchmark.metrics.update_roofline import is_update
from benchmark.readers import share
from benchmark.trace import role_ops


def stage_seconds(rec: dict) -> float:
    ops = sorted(role_ops(rec["trace"], "train"), key=lambda op: op[1])
    return sum(b - a for (name, a, b), upd in zip(ops, is_update(ops))
               if not upd and not is_nccl(name)) * 1e-6


def read(rec: dict):
    return share(rec, "train", True, floors.interaction_floor,
                 lambda calls: stage_seconds(rec))
