"""End to end: seconds from the start of the run's module to the window's
start, less the check's norms (benchmark/run.py)."""

from benchmark.readers import setup_s as read  # noqa: F401
