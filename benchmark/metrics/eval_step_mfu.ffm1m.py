"""Eval step layer, FFM cell: eval_step_mfu in the cell that reports no
end-to-end eval rate (metrics/eval_ex_per_s.ffm1m.py says why)."""

from benchmark.readers import eval_step_mfu as read  # noqa: F401
