"""Train step layer of the four-card route cell: the steps' floor
(benchmark/floors.py) over their seconds, in percent, untraced epochs;
rank 0 held to a quarter of each global step's floor (readers.share)."""

from benchmark.readers import train_step_mfu as read  # noqa: F401
