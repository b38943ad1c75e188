"""A mesh Trainer's own init drawn on each rank alone (Model.init's shard,
parallel/mesh.py::init_shard), over gloo ranks on the CPU.

- Each rank's default init equals shard_state of the one-process init of
  the same seed, bit for bit, on (1, 2) and (1, 4) meshes, with blocks of
  16 ids (models/base.py::INIT_BLOCK) so that a table of 50 rows spans
  four blocks and the last shard holds padding rows.
- A rank counts its rows (init.rows) and makes no tensor of n_feats rows
  while the Trainer is built (every tensor an operator returns watched).
- Trainer(cfg, state) takes a state of the rank's own rows as it is and
  trains to the bits of the same Trainer given the whole state.
- Under the profiler a (1, 2) route run emits the route's spans and the
  init's, and the registry's collectives.bytes.<kind> and
  collectives.<kind> agree with parallel/dist.py's trace.

One spawn of the ranks a mesh (a module-scoped fixture); each check is a
test of its own.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.common import write_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 5
BLOCK = 16
SHAPE = dict(model_type="FFM", n_fields=4, n_feats=50, n_factors=4, max_nnz=4,
             batch_size=16, seed=SEED)
TABLES = ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w")
SPANS = ("ftrl.route.ids", "ftrl.route.rows", "ftrl.route.update", "ftrl.mesh.sums",
         "ftrl.init.shard")

# Runs in each rank (python -c, the repo on sys.path): joins the gloo
# group; builds a default Trainer on a (1, world) route mesh under a
# dispatch mode that notes the most rows of any tensor made; trains the
# fixture file from the whole init and from a copy of the rank's own
# rows; and, under the profiler with dist.trace on, builds and trains
# once more.  Writes one .npz a rank.
_WORKER = r"""
import json, sys
import numpy as np, torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from ftrl_ffm_tpu_torch import tracing
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.models import base, make_model
from ftrl_ffm_tpu_torch.parallel import dist
from ftrl_ffm_tpu_torch.train import Trainer

coord, world, rank, spec_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
spec = json.load(open(spec_path))
base.INIT_BLOCK = spec["block"]
dist.initialize(coord, world, rank, "cpu")


class MostRows(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dim():
                self.most = max(self.most, t.shape[0])
        return out


def cfg(**kw):
    return Config(**{**dict(device="cpu", mesh_data=1, mesh_model=world, lookup_mode="route",
                            online=False, n_epochs=2, **spec["shape"]), **kw})


out = {}
tracing.reset()
with MostRows() as watch:
    tr = Trainer(cfg())
out["most_rows"] = watch.most
out["init_rows"] = tracing.read().get("init.rows", 0)
for k, t in tr.state._asdict().items():
    out["init_" + k] = t.numpy()
local = type(tr.state)(*(t.clone() for t in tr.state))
whole = make_model(cfg()).init(torch.Generator().manual_seed(spec["shape"]["seed"]))
for name, state in (("whole", whole), ("local", local)):
    t = Trainer(cfg(train_data=spec["train"]), state=state)
    out[name + "_hist"] = np.array(json.dumps(t.train()))
    for k, x in t.logical_state._asdict().items():
        out[name + "_" + k] = x.numpy()
if spec["profile"]:
    dist.trace = []
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        Trainer(cfg(train_data=spec["train"], n_epochs=1)).train()
    out["spans"] = np.array(json.dumps(sorted({e.name for e in prof.events()
                                               if e.name.startswith("ftrl.")})))
    out["dist_trace"] = np.array(json.dumps(dist.trace))
    out["counters"] = np.array(json.dumps(tracing.read()))
np.savez(f"{spec['out']}/rank{rank}.npz", **out)
dist.destroy()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp, world: int, profile: bool) -> list:
    train = write_fixture(tmp / "train.ffm")
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"shape": SHAPE, "block": BLOCK, "train": train,
                                "profile": profile, "out": str(tmp)}))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, coord, str(world), str(r),
                               str(spec)], env=env, cwd=str(tmp), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh2"), 2, profile=True)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh4"), 4, profile=False)


def _outs(world, ranks2, ranks4):
    return ranks2 if world == 2 else ranks4


@pytest.mark.parametrize("world", [2, 4])
def test_rank_init_is_the_placement_of_the_whole_init(world, ranks2, ranks4, monkeypatch):
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.models import base, make_model
    from ftrl_ffm_tpu_torch.parallel.mesh import Mesh, shard_state

    monkeypatch.setattr(base, "INIT_BLOCK", BLOCK)
    whole = make_model(Config(device="cpu", **SHAPE)).init(
        torch.Generator().manual_seed(SEED))
    for r, out in enumerate(_outs(world, ranks2, ranks4)):
        want = shard_state(whole, Mesh(1, world, r, torch.device("cpu"), None, None))
        for k, t in want._asdict().items():
            np.testing.assert_array_equal(out["init_" + k], t.numpy(), err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_rank_draws_its_rows_alone(world, ranks2, ranks4):
    rows_local = -(-SHAPE["n_feats"] // world)
    for out in _outs(world, ranks2, ranks4):
        assert int(out["init_rows"]) == rows_local == out["init_vec_w"].shape[0]
        assert int(out["most_rows"]) < SHAPE["n_feats"]
        assert (out["init_vec_w"] != 0).any()


@pytest.mark.parametrize("world", [2, 4])
def test_rank_local_state_trains_as_the_whole_state(world, ranks2, ranks4):
    for r, out in enumerate(_outs(world, ranks2, ranks4)):
        assert str(out["local_hist"]) == str(out["whole_hist"]), r
        for k in ("bias_n", "bias_z", *TABLES, "step"):
            np.testing.assert_array_equal(out["local_" + k], out["whole_" + k],
                                          err_msg=f"rank {r} {k}")


def test_route_spans_and_collective_bytes(ranks2):
    for out in ranks2:
        assert set(SPANS) <= set(json.loads(str(out["spans"])))
        trace = json.loads(str(out["dist_trace"]))
        counters = json.loads(str(out["counters"]))
        for kind in ("all_to_all", "all_reduce", "all_gather"):
            sent = [n for k, n in trace if k == kind]
            assert counters["collectives." + kind] == len(sent), kind
            assert counters.get("collectives.bytes." + kind, 0) == sum(sent), kind
        assert counters["collectives.bytes.all_to_all"] > 0
        assert counters["mesh.train.steps"] == 4  # 64 rows, 16 a global step
        assert 0 < counters["mesh.train.bytes"] < sum(n for _, n in trace)
