"""Device layer of the four-card route cell: the share of the traced
train_epoch() calls' wall time with no device operation running on rank
0, in percent."""

from benchmark.readers import train_idle as read  # noqa: F401
