"""Mesh layer: the share of the routed table updates that took the
touched-rows launch on the received slots (the program's counters
route.update.touched over route.update.touched + route.update.pass,
parallel/sharded.py::_update_routed, on rank 0, the whole run: the warm-up
epoch and the window's), in percent.  A program without those counters
reads nothing."""

from benchmark.spans import program_counters


def read(rec: dict):
    c = program_counters(rec)
    if not c:
        return None
    touched, passes = c.get("route.update.touched", 0), c.get("route.update.pass", 0)
    if touched + passes == 0:
        return None
    return 100.0 * touched / (touched + passes)
