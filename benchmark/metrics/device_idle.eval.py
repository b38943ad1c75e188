"""Device layer: the share of the traced evaluate() calls' wall time with
no device operation running, in percent."""

from benchmark.readers import eval_idle as read  # noqa: F401
