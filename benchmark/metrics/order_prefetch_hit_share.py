"""Resident dataset layer: the share of the shuffled resident epochs that
took the permutation drawn ahead on the program's order thread (its
counters order.prefetch.hit and order.prefetch.miss, over the process:
the warm-up epoch and the window's), in percent."""

from benchmark.spans import program_counters


def read(rec: dict):
    c = program_counters(rec)
    if not c:
        return None
    hit, miss = c.get("order.prefetch.hit", 0), c.get("order.prefetch.miss", 0)
    if hit + miss == 0:
        return None
    return 100.0 * hit / (hit + miss)
