"""The readers of the mesh layer (benchmark/mesh.py) and the four-card
cell's metric files on a record made by hand: NCCL's share of the busy
device time, the collective bytes a train step, the host's time in the
route's spans, and nothing read where the program has none of them."""

import pytest

from benchmark import mesh, run
from benchmark.tests.test_bench_harness import _rec


def _mesh_rec() -> dict:
    rec = _rec()
    rec["cards"] = 4
    tr = rec["trace"]
    # train spans (0, 100) and (200, 300): NCCL 20-30 inside the fused
    # kernel's 10-40 counts once; 250-260 after the gather's 210-250
    tr["ops"] = tr["ops"] + [("ncclDevKernel_SendRecv", 20.0, 30.0),
                             ("ncclDevKernel_AllReduce", 250.0, 260.0),
                             ("ncclDevKernel_SendRecv", 120.0, 130.0)]
    tr["host"] = [("ftrl.route.ids", 10.0, 12.0), ("ftrl.route.rows", 12.0, 15.0),
                  ("ftrl.route.update", 50.0, 58.0), ("ftrl.mesh.sums", 40.0, 41.0),
                  ("ftrl.mesh.sums", 120.0, 121.0), ("ftrl.train.step", 5.0, 90.0)]
    rec["counters"] = {"mesh.train.steps": 10, "mesh.train.bytes": 2500,
                       "mesh.eval.steps": 4, "mesh.eval.bytes": 100}
    return rec


def test_nccl_share_of_the_busy_train_time():
    # busy: 5-6, 10-90, 210-260 = 131 us; NCCL: 20-30, 250-260 = 20 us
    assert mesh.nccl_share(_mesh_rec(), "train") == pytest.approx(100 * 20 / 131)
    assert mesh.nccl_share(_rec(), "train") is None


def test_collective_bytes_per_train_step():
    assert mesh.collective_bytes_per_step(_mesh_rec(), "train") == 250
    assert mesh.collective_bytes_per_step(dict(_rec(), counters={}), "train") is None


def test_route_host_ms_per_train_step():
    # 2 + 3 + 8 + 1 us of the train spans over the traced epoch's 8 steps
    assert mesh.route_host_ms_per_step(_mesh_rec(), "train") == pytest.approx(14e-3 / 8)
    assert mesh.route_host_ms_per_step(_rec(), "train") is None


def test_route4_metric_files():
    rec = _mesh_rec()
    got = {m: run.load_metric(m)(rec) for m in (
        "train_step_mfu.route4", "update_roofline.route4", "interaction_roofline.route4",
        "nccl_share.train", "collective_bytes_per_step.train", "route_host_ms_per_step.train",
        "device_idle.train.route4")}
    assert all(v is not None for v in got.values()), got
    # the interaction stage leaves NCCL's kernels out
    one = dict(_rec(), cards=4)
    assert got["interaction_roofline.route4"] == pytest.approx(
        run.load_metric("interaction_roofline")(one))
    assert got["update_roofline.route4"] == run.load_metric("update_roofline")(one)
