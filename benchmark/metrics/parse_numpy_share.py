"""Resident dataset layer: the share of the resident build's rows that the
numpy parser took rather than the native one (the program's counters
parse.rows.numpy and parse.rows.native), in percent."""

from benchmark.spans import parse_numpy_share as read  # noqa: F401
