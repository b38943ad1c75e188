"""Kernels layer of the four-card route cell: the update stage's floor
(benchmark/floors.py) over its device time on rank 0, in percent, traced
train epochs.  On a (1, N) route mesh the stage is the routed update:
the sort of the route, the z/A scatter into the send slots and into z
(za_scatter*) and kernel #3's in-place pass over the rank's whole shard
(ftrl_pass*), named as metrics/update_roofline.py names them; the floor
is rank 0's share of each step's distinct rows (readers.share)."""

from benchmark.metrics.update_roofline import read  # noqa: F401
