"""A tiny sibling of the benchmark's configuration ffm-criteo-16m-k16 on a
(1, 4) route mesh of gloo ranks on the CPU: its widths (39 fields, k=16,
so field_pad 40 and rows of 640 lanes), 4,096 rows, B=256, three steps
on rows of the benchmark's generator from its seeded S0.

- The loss, the logits and the stitched tables match the benchmark's
  plain reference (benchmark/reference/model.py) within the cell's
  limits (benchmark/limits/ffm16m-criteo-route4.json, read as the harness
  reads them: relative loss, logits over their rms, a table's gap over
  the reference's change of it).
- The stitched tables and the logits match the one-process run of the
  uncut table at tests/test_torch_sharded.py's tolerances (sums over the
  mesh in another order than one device's).
- The configuration file loads through benchmark.spec.cell: rows of 640
  lanes, a state of 2^24 rows that no 80 GB card holds and whose quarter
  one does.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import generator, port, spec
from benchmark.models import ffm as ffm_model
from benchmark.reference import model as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "ffm16m-criteo-route4"
SEED = 2**31 + 23
STEPS, BATCH, RANKS = 3, 256, 4
TINY = dict(n_feats=4096, batch_size=BATCH, train_rows=STEPS * BATCH, eval_rows=BATCH,
            n_threads=1)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-7)
TABLES = ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w")

# Runs in each rank (python -c, the repo on sys.path): the sharded step on
# a (1, 4) route mesh from the rank's rows of S0, each global batch's
# quarter `rank` on this rank; writes its logits and the global loss sums,
# and on rank 0 the stitched logical tables.
_WORKER = r"""
import json, sys
import numpy as np, torch
from benchmark import port
from ftrl_ffm_tpu_torch.models import Batch, make_model
from ftrl_ffm_tpu_torch.parallel import ShardedStep, dist, make_mesh, shard_state, unshard_state

coord, world, rank, spec_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
spec = json.load(open(spec_path))
dist.initialize(coord, world, rank, "cpu")
mesh = make_mesh(1, world, "cpu")
config = spec["config"]
cfg = port.program_config(config, {}, "", "", spec["seed"], torch.device("cpu"))
model = make_model(cfg)
state = shard_state(port.program_state(config, cfg, spec["seed"], torch.device("cpu")), mesh)
step = ShardedStep(cfg, mesh, model, state)
data = np.load(spec["data"])
b, f = config["batch_size"] // world, config["n_fields"]
out = {}
for s in range(spec["steps"]):
    lo = s * config["batch_size"] + rank * b
    batch = Batch(fields=torch.arange(f, dtype=torch.int32).expand(b, f).contiguous(),
                  feats=torch.from_numpy(data["ids"][lo:lo + b]),
                  vals=torch.ones((b, f)), y=torch.from_numpy(data["y"][lo:lo + b]),
                  sample_w=torch.ones(b))
    res = step.train_step(state, batch)
    out[f"logits{s}"] = res.logits.numpy()
    out[f"loss{s}"] = np.array([float(res.loss_sum), float(res.count),
                                float(res.route_overflow)])
logical = unshard_state(state, mesh, config["n_feats"])
if rank == 0:
    for k in ("bias_n", "bias_z", "lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w"):
        out["state_" + k] = getattr(logical, k).numpy()
np.savez(f"{spec['out']}/rank{rank}.npz", **out)
dist.destroy()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config() -> dict:
    return dict(spec.cell(CELL).config, **TINY)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(config, rows, labels, the ranks' outputs)."""
    tmp = tmp_path_factory.mktemp("route_k16")
    config = _config()
    data = generator.generate(config, spec.cell(CELL).traffic, SEED)
    ids, y = data.train_ids.astype(np.int32), data.train_y.astype(np.float32)
    np.savez(tmp / "data.npz", ids=ids, y=y)
    (tmp / "spec.json").write_text(json.dumps({"config": config, "seed": SEED, "steps": STEPS,
                                               "data": str(tmp / "data.npz"),
                                               "out": str(tmp)}))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, coord, str(RANKS), str(r),
                               str(tmp / "spec.json")], env=env, cwd=str(tmp),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(RANKS)]
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
    outs = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]
    return config, ids, y, outs


def _global_logits(outs, s):
    # rank r held rows [r * B/4, (r + 1) * B/4) of each global batch
    return np.concatenate([o[f"logits{s}"] for o in outs])


def _reference(config, ids, y):
    """The plain reference's pre-step logits and mean losses, and its
    tables after the steps (and S0's), logical layout, every row."""
    rows = torch.arange(config["n_feats"])
    st = ref.initial_state(config, SEED, torch.device("cpu"), rows)
    s0 = ref.initial_state(config, SEED, torch.device("cpu"), rows)
    logits, losses = [], []
    for s in range(STEPS):
        sl = slice(s * BATCH, (s + 1) * BATCH)
        b = torch.from_numpy(ids[sl]).to(torch.int64)
        logits.append(ref.forward(config, st, b, torch.ones(b.shape), False)[0].numpy())
        losses.append(ref.train_step(config, st, b, torch.from_numpy(y[sl]), BATCH) / BATCH)
    return logits, losses, st, s0


def _logical(state_rows: np.ndarray, config: dict) -> np.ndarray:
    cfg = port.program_config(config, {}, "", "", SEED, torch.device("cpu"))
    return ffm_model.logical_view(torch.from_numpy(state_rows), config, cfg.field_pad).numpy()


def test_route_k16_matches_the_reference(runs):
    config, ids, y, outs = runs
    limits = spec.cell(CELL).limits
    logits, losses, st, s0 = _reference(config, ids, y)
    for s in range(STEPS):
        loss_sum, count, drops = outs[0][f"loss{s}"]
        assert count == BATCH and drops == 0
        assert abs(loss_sum / count - losses[s]) / abs(losses[s]) <= limits["loss"], s
        got = _global_logits(outs, s)
        rms = float(np.sqrt(np.mean(logits[s].astype(np.float64) ** 2)))
        assert np.max(np.abs(got - logits[s])) / rms <= limits["logit"], s
    for k in TABLES:
        got = outs[0]["state_" + k]
        if k.startswith("vec"):
            got = _logical(got, config)
        want, start = getattr(st, k).numpy(), getattr(s0, k).numpy()
        moved = np.linalg.norm((want - start).astype(np.float64))
        assert moved > 0, k
        assert np.linalg.norm((got - want).astype(np.float64)) / moved <= limits["change"], k


def test_route_k16_matches_the_uncut_table(runs):
    from ftrl_ffm_tpu_torch.models import Batch, make_model

    config, ids, y, outs = runs
    cfg = port.program_config(config, {}, "", "", SEED, torch.device("cpu"))
    assert (cfg.field_pad, cfg.row_width) == (40, 640)
    model = make_model(cfg)
    state = port.program_state(config, cfg, SEED, torch.device("cpu"))
    f = config["n_fields"]
    for s in range(STEPS):
        sl = slice(s * BATCH, (s + 1) * BATCH)
        batch = Batch(fields=torch.arange(f, dtype=torch.int32).expand(BATCH, f).contiguous(),
                      feats=torch.from_numpy(ids[sl]), vals=torch.ones((BATCH, f)),
                      y=torch.from_numpy(y[sl]), sample_w=torch.ones(BATCH))
        res = model.train_step(state, batch)
        np.testing.assert_allclose(_global_logits(outs, s), res.logits.numpy(), **LOGIT_TOL)
        np.testing.assert_allclose(outs[0][f"loss{s}"][0], float(res.loss_sum), rtol=1e-5)
    state = model.sync_lin_from_mirror(state)
    for k in ("bias_n", "bias_z", *TABLES):
        np.testing.assert_allclose(outs[0]["state_" + k], getattr(state, k).numpy(),
                                   **TABLE_TOL, err_msg=k)


def test_configuration_loads_at_its_widths():
    cell = spec.cell(CELL)
    config = cell.config
    assert cell.chips == RANKS and config["mesh_model"] == RANKS
    assert config["lookup_mode"] == "route" and config["mesh_data"] == 1
    cfg = port.program_config(config, cell.traffic["protocol"], "", "", SEED,
                              torch.device("cpu"))
    assert (cfg.n_fields, cfg.n_factors, cfg.field_pad, cfg.row_width) == (39, 16, 40, 640)
    state_bytes = config["n_feats"] * cfg.row_width * 3 * 4
    assert config["n_feats"] == 2**24 and state_bytes > 80e9 > state_bytes / RANKS
