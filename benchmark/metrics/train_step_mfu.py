"""Train step layer: the steps' floor (benchmark/floors.py) over their
seconds, in percent, untraced epochs."""

from benchmark.readers import train_step_mfu as read  # noqa: F401
