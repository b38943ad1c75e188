"""Eval step layer, FFM cell: eval examples a second over the window's
evaluate() calls (loss and AUC read back), as eval_ex_per_s reads it.
A per-layer metric there: the FFM eval pass is paced by the host, and its
runs spread too wide for an end-to-end bound."""

from benchmark.readers import eval_rate as read  # noqa: F401
