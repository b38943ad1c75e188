"""Eval step layer, FFM cell: host_ms_per_step.eval in the cell that
reports no end-to-end eval rate (metrics/eval_ex_per_s.ffm1m.py says
why)."""

from benchmark.spans import host_ms_per_step


def read(rec: dict):
    return host_ms_per_step(rec, "eval")
