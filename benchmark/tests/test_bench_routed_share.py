"""The Mesh layer's routed_touched_share on records made by hand: the
share of routed updates that took the touched-rows launch, from the
program's counters route.update.touched and route.update.pass, and
nothing read from a program that has neither (a record of the parent,
whose routed update always passed over the shard uncounted)."""

import pytest

from benchmark import run
from benchmark.tests.test_bench_mesh_metrics import _mesh_rec


def _share(counters: dict):
    return run.load_metric("routed_touched_share")(dict(_mesh_rec(), counters=counters))


def test_touched_updates_alone_read_100():
    assert _share({"mesh.train.steps": 10, "route.update.touched": 80}) == 100.0


def test_mixed_updates_read_their_share():
    assert _share({"route.update.touched": 30, "route.update.pass": 10}) == pytest.approx(75.0)
    assert _share({"route.update.pass": 12}) == 0.0


def test_nothing_read_without_the_counters():
    # the parent's record: the mesh counters, no route.update.* counter
    assert _share(_mesh_rec()["counters"]) is None
    assert _share({"route.update.touched": 0, "route.update.pass": 0}) is None
