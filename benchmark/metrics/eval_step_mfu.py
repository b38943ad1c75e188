"""Eval step layer: the eval steps' floor (benchmark/floors.py) over their
seconds, in percent, untraced passes."""

from benchmark.readers import eval_step_mfu as read  # noqa: F401
