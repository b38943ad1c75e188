"""steps_per_call > 1 on meshes of gloo ranks: S sharded steps a dispatch
(Trainer._run_group, eager on the CPU) give the S = 1 run's bits, on the
(2, 1) replicate, (1, 2) route and (2, 2) meshes, streamed (the grouped
feeder) and resident (the shard layout's grouped gathers), in training
and in eval (the Kahan chain of the S = 1 pass, the route drops in it).

The file holds ten global batches of 64 rows and a partial eleventh, so
S = 2 and S = 3 end on a group padded with inert steps, and the slices of
four ranks differ in length (lockstep inert steps).  One spawn a process
count (tests/test_torch_mesh_cache.py::spawn_trainers); each config's
check is a test of its own.
"""

import numpy as np
import pytest

from tests.test_torch_mesh_cache import SHAPE, assert_same_bits, spawn_trainers, write_fixed_width_ffm

MESHES = {"2x1": (2, dict()), "1x2route": (2, dict(mesh_model=2, lookup_mode="route")),
          "2x2": (4, dict(mesh_data=2, mesh_model=2))}
# streamed: online batches through the grouped feeder; resident: offline
# shuffled epochs from the shard layout
PATHS = {"streamed": dict(device_cache="off", online=True),
         "resident": dict(device_cache="on", online=False, shuffle=True)}
CASES = [(m, p, s) for m in MESHES for p in PATHS for s in (2, 3)]


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"groups{world}")
            data = write_fixed_width_ffm(tmp / "d.ffm", 650, seed=3)
            cases = [
                {"name": f"{m}_{p}_{s}", "init": None,
                 "cfg": dict(**SHAPE, train_data=data, eval_data=data, batch_size=64,
                             n_epochs=2, steps_per_call=s, **MESHES[m][1], **PATHS[p])}
                for m in MESHES if MESHES[m][0] == world for p in PATHS for s in (1, 2, 3)
            ]
            done[world] = spawn_trainers(tmp, world, cases)
        return done[world]

    return get


@pytest.mark.parametrize("mesh,path,s", CASES, ids=[f"{m}-{p}-S{s}" for m, p, s in CASES])
def test_groups_give_one_step_bits(group_runs, mesh, path, s):
    runs = group_runs(MESHES[mesh][0])
    for grouped, single in zip(runs[f"{mesh}_{path}_{s}"], runs[f"{mesh}_{path}_1"]):
        want = {"streamed": {"train": "streamed", "eval": "streamed"},
                "resident": {"train": "shard", "eval": "shard"}}[path]
        assert grouped["layout"] == single["layout"] == want
        # on the CPU every group runs eagerly: no graph to capture
        assert grouped["dispatch"] == {"eager": 0, "captures": 0, "replays": 0}
        h = grouped["hist"]
        assert len(h["train_loss"]) == len(h["eval_auc"]) == 2
        assert all(np.isfinite(h["train_loss"] + h["eval_loss"] + h["eval_auc"]))
        assert_same_bits(grouped, single)
    if mesh == "1x2route":
        assert all(r["hist"]["route_overflow"] == [0, 0] for r in runs[f"{mesh}_{path}_{s}"])
