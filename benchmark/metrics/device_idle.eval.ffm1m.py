"""Device layer, FFM cell: device_idle.eval in the cell that reports no
end-to-end eval rate (metrics/eval_ex_per_s.ffm1m.py says why)."""

from benchmark.readers import eval_idle as read  # noqa: F401
