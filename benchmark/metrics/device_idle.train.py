"""Device layer: the share of the traced train_epoch() calls' wall time
with no device operation running, in percent."""

from benchmark.readers import train_idle as read  # noqa: F401
