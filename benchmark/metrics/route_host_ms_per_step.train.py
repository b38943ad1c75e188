"""Mesh layer: the host's ms a traced train step in the program's
"ftrl.route.ids", "ftrl.route.rows", "ftrl.route.update" and
"ftrl.mesh.sums" spans (parallel/sharded.py), rank 0."""

from benchmark.mesh import route_host_ms_per_step


def read(rec: dict):
    return route_host_ms_per_step(rec, "train")
