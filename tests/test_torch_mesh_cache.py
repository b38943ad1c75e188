"""The port's resident datasets and exact-AUC refusals on meshes of gloo
ranks (one process a device), against the JAX package's runs of the same
configs and the port's streamed run of the same mesh.

- The shard layout (each rank its byte-range slice, padded to the largest
  slice + 1): the twins of tests/test_multihost.py's shard-cache tests
  (2 processes offline, 4 processes offline, 2 processes online) on their
  one-global-batch files, held against the JAX package's one-process run
  at that file's tolerances (losses rtol 2e-5, AUC 1e-4: f32 sums over
  the mesh in another order); and on files of several global batches, bit
  for bit the port's streamed run of the same mesh, online and offline,
  shuffled or not.
- device_cache_layout=replicate on more than one process streams, as the
  JAX package's does, and says so: on a file of four global batches the
  run is the streamed one's, and the JAX package's multi-process run's at
  rtol 2e-5.
- auc_mode=exact raises the JAX package's errors on more than one process
  and with the shard layout.

Every 2-process config runs in one spawn of two ranks and every 4-process
config in one of four (`mesh_runs`); each config's check is a test of its
own.  The ranks load the JAX package's init of the config (a factor
model's init is random), so the runs start from the same state.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("lin_z", "lin_n", "vec_z", "vec_n", "vec_w")
SHAPE = dict(model_type="FFM", n_fields=4, n_feats=50, n_factors=4)

# Runs in each rank (python -c, the repo on sys.path): joins the gloo
# group, then trains every case of the spec in turn on its own mesh over
# that group, and writes one .npz a case and rank: the history, which
# roles ran resident and in which layout, how the groups were dispatched,
# the collectives counted, stderr, the logical state, or the error raised.
_WORKER = r"""
import contextlib, io, json, sys
import numpy as np
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint, state_from_jax_arrays
from ftrl_ffm_tpu_torch.parallel import dist
from ftrl_ffm_tpu_torch.train import Trainer

coord, world, rank, spec_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
spec = json.load(open(spec_path))
dist.initialize(coord, world, rank, "cpu")
for case in spec["cases"]:
    out, err = {}, io.StringIO()
    state = None
    if case.get("init"):
        state = state_from_jax_arrays(load_checkpoint(case["init"])[0], "cpu")
    try:
        with contextlib.redirect_stderr(err):
            tr = Trainer(Config(**case["cfg"], device="cpu"), state=state)
            for k in dist.counts:
                dist.counts[k] = 0
            hist = tr.train()
        out["collectives"] = np.array(json.dumps(dict(dist.counts)))
        out["hist"] = np.array(json.dumps(hist))
        out["layout"] = np.array(json.dumps(
            {r: getattr(tr._dev_cache.get(r), "layout", "streamed") for r in ("train", "eval")}))
        out["rows_loc"] = np.array(json.dumps(
            {r: e.rows_loc for r, e in tr._dev_cache.items() if e is not None}))
        out["dispatch"] = np.array(json.dumps(tr.group_dispatch))
        out["mesh"] = np.array([tr._mesh.data, tr._mesh.model])
        for k, t in tr.logical_state._asdict().items():
            if t is not None:
                out["state_" + k] = t.float().numpy()
    except (ValueError, RuntimeError) as e:
        out["error"] = np.array(str(e))
    out["stderr"] = np.array(err.getvalue())
    np.savez(f"{spec['out']}/{case['name']}_{rank}.npz", **out)
dist.destroy()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_trainers(tmp, world, cases, timeout=400):
    """Run every case (name, cfg: Config keywords, init: a checkpoint or
    None) on `world` gloo ranks; {name: [per-rank outputs]}."""
    spec = str(tmp / "spec.json")
    json.dump({"cases": cases, "out": str(tmp)}, open(spec, "w"))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, coord, str(world), str(r), spec],
                         env=env, cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log}"
    runs = {}
    for c in cases:
        runs[c["name"]] = []
        for r in range(world):
            z = dict(np.load(tmp / f"{c['name']}_{r}.npz"))
            rec = {k: (json.loads(str(v)) if k in ("hist", "layout", "rows_loc", "dispatch",
                                                     "collectives") else v)
                   for k, v in z.items()}
            for k in ("error", "stderr"):
                if k in rec:
                    rec[k] = str(rec[k])
            runs[c["name"]].append(rec)
    return runs


def write_fixed_width_ffm(path, n, seed=0):
    """tests/test_multihost.py::_write_fixed_width_ffm: equal-length lines,
    so that N byte ranges hold n / N lines each."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(10, 50)):02d}:1" for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    return str(path)


def jax_init(tmp, name, **kw):
    """(JAX one-process history, init checkpoint) of a config: the JAX
    Trainer saves its init, then trains (tests/test_multihost.py's
    references)."""
    from ftrl_ffm_tpu.config import Config as JConfig
    from ftrl_ffm_tpu.train import Trainer as JTrainer

    jt = JTrainer(JConfig(**SHAPE, **kw))
    init = str(tmp / f"{name}.ckpt")
    jt.save_checkpoint(init)
    return jt.train(), init


def assert_same_bits(a, b):
    """Two ranks' runs are one: histories and logical states bit for bit."""
    assert a["hist"] == b["hist"]
    for k in a:
        if k.startswith("state_"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_matches(hist, ref):
    np.testing.assert_allclose(hist["train_loss"], ref["train_loss"], rtol=2e-5)
    np.testing.assert_allclose(hist["eval_loss"], ref["eval_loss"], rtol=2e-5)
    np.testing.assert_allclose(hist["eval_auc"], ref["eval_auc"], rtol=1e-4)


# The one-global-batch file of tests/test_multihost.py (256 lines, B=256)
# and a file of four global batches, its last one partial (1000 lines:
# the ranks' slices differ by one line on four ranks, so the lockstep
# count and the inert rows matter).
ONE, FOUR = 256, 1000
BASE = dict(**SHAPE, batch_size=256, n_epochs=2)


def _cfg(data, **kw):
    return dict(BASE, train_data=data, eval_data=data, **kw)


# The JAX twins: (name, processes, JAX one-process config, port flags).
TWINS = [
    # tests/test_multihost.py:396: 2 processes, a route mesh over both,
    # offline, shuffle off
    ("offline2", 2, dict(online=False, shuffle=False),
     dict(mesh_model=2, lookup_mode="route", online=False, shuffle=False)),
    # :435: a (1, 4) route mesh over 4 processes, offline
    ("offline4", 4, dict(online=False, shuffle=False),
     dict(mesh_model=4, lookup_mode="route", online=False, shuffle=False)),
    # :466: 2 processes online; shuffle on, which online ignores
    ("online2", 2, dict(online=True),
     dict(mesh_model=2, lookup_mode="route", online=True, shuffle=True)),
]
# Shard layout against the streamed run, bit for bit, on the four-batch
# file: (name, processes, flags).
AGAINST_STREAMED = [
    ("offline2", 2, TWINS[0][3]),
    ("offline4", 4, TWINS[1][3]),
    ("online2", 2, TWINS[2][3]),
    ("shuffled_route2", 2, dict(mesh_model=2, lookup_mode="route", online=False, shuffle=True)),
    ("shuffled_data2", 2, dict(online=False, shuffle=True)),
    ("online_data2", 2, dict(online=True)),
    ("shuffled_hybrid4", 4, dict(mesh_data=2, mesh_model=2, online=False, shuffle=True)),
]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{world: (runs by case name, JAX references by twin name)}: one
    spawn a process count, on first use."""
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"ranks{world}")
            one = write_fixed_width_ffm(tmp / "one.ffm", ONE)
            four = write_fixed_width_ffm(tmp / "four.ffm", FOUR, seed=1)
            refs, cases = {}, []
            for name, procs, jkw, kw in TWINS:
                if procs != world:
                    continue
                refs[name], init = jax_init(tmp, name, train_data=one, eval_data=one,
                                            batch_size=256, n_epochs=2, device_cache="off",
                                            **jkw)
                cases.append({"name": f"twin_{name}", "init": init,
                              "cfg": _cfg(one, device_cache="on", **kw)})
            _, init4 = jax_init(tmp, "four", train_data=four, batch_size=256, n_epochs=0)
            for name, procs, kw in AGAINST_STREAMED:
                if procs != world:
                    continue
                for cache in ("on", "off"):
                    cases.append({"name": f"{name}_{cache}", "init": init4,
                                  "cfg": _cfg(four, device_cache=cache, **kw)})
            if world == 2:
                # one line on two ranks: rank 1's slice is empty, and both
                # still take the shard layout (and its collectives) together
                tiny = write_fixed_width_ffm(tmp / "tiny.ffm", 1, seed=2)
                for cache in ("on", "off"):
                    cases.append({"name": f"tiny_{cache}", "init": init4,
                                  "cfg": _cfg(tiny, device_cache=cache, online=False)})
                # the replicate layout on 2 processes, online, four global
                # batches (its streamed twin is online_data2_off)
                cases.append({"name": "replicate2", "init": init4,
                              "cfg": _cfg(four, device_cache="on",
                                          device_cache_layout="replicate", online=True)})
                cases.append({"name": "exact2", "init": None,
                              "cfg": _cfg(four, auc_mode="exact")})
            done[world] = (spawn_trainers(tmp, world, cases), refs, tmp, four, init4)
        return done[world]

    return get


@pytest.mark.parametrize("name,procs", [(t[0], t[1]) for t in TWINS],
                         ids=[t[0] for t in TWINS])
def test_shard_cache_matches_jax_one_process(mesh_runs, name, procs):
    """tests/test_multihost.py's shard-cache tests: on the one-global-batch
    file both roles run from the shard layout, and the losses and AUC are
    the JAX package's one-process run's."""
    runs, refs, *_ = mesh_runs(procs)
    for r in runs[f"twin_{name}"]:
        assert r["layout"] == {"train": "shard", "eval": "shard"}
        # ceil(256 / procs) lines the largest slice, plus the inert row
        assert r["rows_loc"] == {"train": 256 // procs + 1, "eval": 256 // procs + 1}
        assert_matches(r["hist"], refs[name])
    assert_same_bits(runs[f"twin_{name}"][0], runs[f"twin_{name}"][-1])


@pytest.mark.parametrize("name,procs", [(t[0], t[1]) for t in AGAINST_STREAMED],
                         ids=[t[0] for t in AGAINST_STREAMED])
def test_shard_cache_is_the_streamed_run_bit_for_bit(mesh_runs, name, procs):
    """On four global batches (uneven slices) the shard layout gives the
    port's streamed run of the same mesh bit for bit: the same rows in the
    same order (file order online; offline the slice's permutation that
    epoch_rng.shuffle draws for both), inert rows where the stream pads."""
    runs, *_ = mesh_runs(procs)
    # every rank holds the largest slice + 1 rows: the same step count
    assert len({json.dumps(r["rows_loc"]) for r in runs[f"{name}_on"]}) == 1
    for cached, streamed in zip(runs[f"{name}_on"], runs[f"{name}_off"]):
        assert cached["layout"] == {"train": "shard", "eval": "shard"}
        assert streamed["layout"] == {"train": "streamed", "eval": "streamed"}
        assert len(cached["hist"]["train_loss"]) == 2
        assert_same_bits(cached, streamed)


def test_shard_cache_with_an_empty_slice(mesh_runs):
    """A file of one line on 2 ranks: rank 1's slice is empty and holds
    the inert row alone; the ranks agree on the layout and the step count,
    and the run is the streamed one's bit for bit."""
    runs, *_ = mesh_runs(2)
    for cached, streamed in zip(runs["tiny_on"], runs["tiny_off"]):
        assert cached["layout"] == {"train": "shard", "eval": "shard"}
        assert cached["rows_loc"] == {"train": 2, "eval": 2}
        assert_same_bits(cached, streamed)


def test_replicate_layout_streams_on_two_processes(mesh_runs):
    """device_cache_layout=replicate on 2 processes streams, as the JAX
    package's does (train.py:1522-1531), with a note on rank 0's stderr:
    on four global batches the run is the streamed run, bit for bit."""
    runs, *_ = mesh_runs(2)
    rep, streamed = runs["replicate2"], runs["online_data2_off"]
    for r, s in zip(rep, streamed):
        assert r["layout"] == {"train": "streamed", "eval": "streamed"}
        assert_same_bits(r, s)
    assert "replicate layout needs the whole dataset" in rep[0]["stderr"]
    assert "replicate layout" not in rep[1]["stderr"]
    assert "not in the PyTorch port" not in rep[0]["stderr"]


def test_replicate_layout_on_two_processes_matches_jax_multiprocess(mesh_runs):
    """The same run against the JAX package's 2-process run of the config
    (tests/multihost_worker.py: a (2, 1) mesh, online, streamed): global
    batch t is the ranks' t-th local batches, so the epoch losses agree at
    rtol 2e-5 on a file of four global batches."""
    runs, _, tmp, four, _ = mesh_runs(2)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_PLATFORMS", None)
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    outs = [str(tmp / f"jax_mh{p}.json") for p in range(2)]
    # argv: mesh_model lookup ckpt pred epochs model update online cache
    procs = [subprocess.Popen([sys.executable, worker, coord, "2", str(p), four, outs[p],
                               "1", "auto", "", "", "2", "FFM", "auto", "1", "off"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for p in range(2)]
    logs = [p.communicate(timeout=540)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"JAX worker failed:\n{log}"
    for out, r in zip(outs, runs["replicate2"]):
        jh = json.load(open(out))
        assert jh["process_count"] == 2
        assert r["mesh"].tolist() == [2, 1]
        assert_matches(r["hist"], jh)


def test_exact_auc_refused_on_two_processes(mesh_runs):
    """auc_mode=exact on 2 processes raises the JAX package's error at
    construction, on every rank (ftrl_ffm_tpu/train.py:389-393)."""
    from ftrl_ffm_tpu_torch.train import EXACT_AUC_MULTIPROCESS

    runs, *_ = mesh_runs(2)
    for r in runs["exact2"]:
        assert r["error"] == EXACT_AUC_MULTIPROCESS
        assert "auc_mode=exact collects all scores on one host" in r["error"]


def test_exact_auc_refused_with_the_shard_layout(tmp_path):
    """auc_mode=exact with device_cache_layout=shard raises the JAX
    package's error at construction (ftrl_ffm_tpu/train.py:395-400), on one
    device and on a mesh of one rank; evaluate raises it again where a
    shard cache was built without the config naming it (:2740-2745)."""
    from ftrl_ffm_tpu.config import Config as JConfig
    from ftrl_ffm_tpu.train import Trainer as JTrainer
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import EXACT_AUC_SHARD, Trainer

    data = write_fixed_width_ffm(tmp_path / "d.ffm", 64)
    kw = dict(_cfg(data, batch_size=16, n_epochs=1), device_cache="on",
              device_cache_layout="shard", auc_mode="exact")
    with pytest.raises(ValueError) as jerr:
        JTrainer(JConfig(**kw))
    assert str(jerr.value) == EXACT_AUC_SHARD
    for mesh in ({}, {"mesh_data": 0}):
        with pytest.raises(ValueError) as err:
            Trainer(Config(**kw, **mesh, device="cpu"))
        assert str(err.value) == EXACT_AUC_SHARD
    # the backstop: a shard cache built by hand on a mesh of one rank
    tr = Trainer(Config(**dict(kw, device_cache_layout="replicate"), mesh_data=0, device="cpu"))
    ds = tr._dataset("eval")
    tr._dev_cache["eval"] = tr._build_device_cache(ds, "shard", None)
    with pytest.raises(ValueError) as err:
        tr.evaluate()
    assert str(err.value) == EXACT_AUC_SHARD


@pytest.mark.parametrize("online", [True, False], ids=["online", "offline"])
def test_shard_build_on_one_rank_is_the_replicate_run(tmp_path, online):
    """On a mesh of one rank the shard build is a single slice plus one
    inert row (rows_loc = n + 1): its epochs give the replicate layout's
    bits, shuffled offline or in file order online (chip_smoke phase 11
    runs this at bench.py's width on the card)."""
    import torch

    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import Trainer

    data = write_fixed_width_ffm(tmp_path / "d.ffm", 100)
    kw = dict(_cfg(data, batch_size=16, n_epochs=2), mesh_data=0, device_cache="on",
              online=online, shuffle=True, device="cpu")
    rep = Trainer(Config(**kw))
    hist_rep = rep.train()
    assert rep._dev_cache["train"].layout == "replicate"
    sh = Trainer(Config(**kw))
    for role in ("train", "eval"):
        entry = sh._build_device_cache(sh._dataset(role), "shard", None)
        assert entry.layout == "shard" and entry.rows_loc == entry.n + 1 == 101
        sh._dev_cache[role] = entry
    assert sh.train() == hist_rep
    for a, b in zip(sh.logical_state, rep.logical_state):
        assert (a is None and b is None) or torch.equal(a, b)
