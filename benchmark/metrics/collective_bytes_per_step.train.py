"""Mesh layer: the bytes rank 0 hands to collectives a train step, from the
program's counters mesh.train.bytes and mesh.train.steps (parallel/
dist.py), the whole run."""

from benchmark.mesh import collective_bytes_per_step


def read(rec: dict):
    return collective_bytes_per_step(rec, "train")
