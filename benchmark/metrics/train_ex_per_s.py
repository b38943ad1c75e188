"""End to end: training examples a second over the window's
train_epoch() calls, each closed by a synchronize."""

from benchmark.readers import train_rate as read  # noqa: F401
