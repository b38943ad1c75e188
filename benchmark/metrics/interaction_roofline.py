"""Kernels layer: the interaction stage's floor (benchmark/floors.py) over
the device time of every train operation that is not the update stage's
(metrics/update_roofline.py names those): the row gather, the interaction
kernel or FM's plain chain, the loss, the bias; in percent, traced
epochs."""

from benchmark import floors
from benchmark.metrics.update_roofline import stage_seconds
from benchmark.readers import share


def read(rec: dict):
    return share(rec, "train", True, floors.interaction_floor,
                 lambda calls: stage_seconds(rec, False))
