"""Eval step layer: the host's dispatch time an eval step, from the
program's "ftrl.eval.step" and "ftrl.eval.gather" spans (or
"ftrl.eval.group" at S > 1) of the traced passes, in ms."""

from benchmark.spans import host_ms_per_step


def read(rec: dict):
    return host_ms_per_step(rec, "eval")
