"""Resident dataset layer: the host's epoch start, from the program's span
"ftrl.train.epoch" to its first step, gather or group span (the shuffle,
the index table and its upload), mean of the traced train epochs, in ms."""

from benchmark.spans import epoch_start_ms as read  # noqa: F401
