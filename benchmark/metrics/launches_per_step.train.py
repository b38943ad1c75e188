"""Trainer layer: hand-written kernel launches a train step (the program's
counters; a replay adds its capture's), traced epochs."""

from benchmark.readers import launches_per_train_step as read  # noqa: F401
