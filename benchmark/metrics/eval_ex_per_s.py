"""End to end: eval examples a second over the window's evaluate() calls
(loss and AUC read back)."""

from benchmark.readers import eval_rate as read  # noqa: F401
