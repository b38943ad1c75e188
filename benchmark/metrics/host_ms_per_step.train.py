"""Trainer layer: the host's dispatch time a train step, from the program's
"ftrl.train.step" and "ftrl.train.gather" spans (or "ftrl.train.group"
at S > 1) of the traced epochs, in ms."""

from benchmark.spans import host_ms_per_step


def read(rec: dict):
    return host_ms_per_step(rec, "train")
