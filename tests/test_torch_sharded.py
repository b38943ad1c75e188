"""The port's sharded step (ftrl_ffm_tpu_torch/parallel) over gloo ranks
against the JAX package's ShardedStep on the same mesh shape (conftest's
8 CPU devices) and against the port's one-device step: the twin of
tests/test_sharded.py.

One spawn of D * M rank processes a mesh shape (a module-scoped fixture)
runs every case of that shape; each case stays a test of its own.  Inputs
are made here from numpy seeds, with the JAX package's init carried
across, and handed to the ranks in .npz files.

Tolerances are tests/test_sharded.py's: logits and loss sums rtol 1e-5 /
atol 1e-6, tables rtol 1e-4 / atol 1e-7 (sums over the mesh in another
order than one device's); a bf16 table's after two steps at the suite's
chained-step bound, rtol 2e-3 / atol 5e-5 (a bf16 w rounds to another
neighbour where z moved by an ulp).  Data replicas of one shard hold the
same bits.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w")
FIELDS = ("bias_n", "bias_z", *TABLES, "step")
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-7)
# a bf16 w rounds to another neighbour where z differs in an ulp, and the
# next step's gradients carry it: the suite's chained-step bound on n and
# z (tests/test_torch_bf16.py)
BF16_CHAIN_TOL = dict(rtol=2e-3, atol=5e-5)

# Runs in each rank process (python -c, the repo on sys.path): joins the
# gloo group, builds the mesh, runs every case of the spec, writes one
# .npz per case and rank.
_WORKER = r"""
import json, sys
import numpy as np, torch
from ftrl_ffm_tpu_torch import tracing
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.models import Batch, ModelState, make_model
from ftrl_ffm_tpu_torch.parallel import ShardedStep, dist, make_mesh, shard_state, unshard_state

TABLES = ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w")
coord, world, rank, spec_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
spec = json.load(open(spec_path))
dist.initialize(coord, world, rank, "cpu")
mesh = make_mesh(spec["mesh"][0], spec["mesh"][1], "cpu")


def state_of(z):
    # a bf16 table arrives as its int16 bits under "<name>.bf16"
    def get(k):
        if k + ".bf16" in z:
            return torch.from_numpy(z[k + ".bf16"]).view(torch.bfloat16)
        return torch.from_numpy(z[k]) if k in z else None

    return ModelState(*(get(k) for k in ModelState._fields))


for case in spec["cases"]:
    out = {}
    if case["kind"] == "trainer":
        from ftrl_ffm_tpu_torch.train import Trainer
        hist = Trainer(Config(**case["cfg"], device="cpu")).train()
        out["overflow"] = np.array(hist["route_overflow"])
        try:
            Trainer(Config(**case["cfg"], device="cpu", route_overflow_policy="error")).train()
            out["raised"] = np.array("")
        except RuntimeError as e:
            out["raised"] = np.array(str(e))
    else:
        cfg = Config(**case["cfg"], device="cpu")
        model = make_model(cfg)
        z = np.load(case["init"])
        st = shard_state(state_of(z), mesh)
        step = ShardedStep(cfg, mesh, model, st)
        out["form"] = np.array(step.form)
        out["mode"] = np.array(step.mode)
        out["route_k"] = np.array(step.route_k)
        b = np.load(case["batch"])
        sl = slice(step.shard_index * step.local_batch, (step.shard_index + 1) * step.local_batch)
        batch = Batch(*(torch.from_numpy(np.ascontiguousarray(b[k][sl]))
                        for k in ("fields", "feats", "vals", "y", "sample_w")))
        tracing.reset()
        for i in range(case.get("steps", 2)):
            dist.trace = [] if i == 0 else None
            o = step.train_step(st, batch)
            if i == 0:
                out["trace"] = np.array([(k, n) for k, n in dist.trace], dtype=object)
            out[f"logits{i}"] = o.logits.numpy()
            out[f"loss{i}"] = o.loss_sum.numpy()
            out[f"count{i}"] = o.count.numpy()
            out[f"overflow{i}"] = np.array(-1 if o.route_overflow is None else o.route_overflow)
        counters = tracing.read()
        for k in ("touched", "pass"):
            out["route_" + k] = np.array(counters.get("route.update." + k, 0))
        ls, ct, lg, _, _, _ = step.eval_step(st, batch)
        out["eval_loss"], out["eval_count"], out["eval_logits"] = ls.numpy(), ct.numpy(), lg.numpy()
        for k in TABLES:
            t = getattr(st, k)
            if t is not None:
                out["local_" + k] = t.float().numpy()
        logical = unshard_state(st, mesh, cfg.n_feats)
        for k, t in logical._asdict().items():
            if t is not None:
                out["state_" + k] = t.float().numpy()
    np.savez(f"{spec['out']}/{case['name']}_{rank}.npz", **out)
dist.destroy()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp, mesh_shape, cases, timeout=240):
    """Run `cases` on D * M gloo ranks; {case name: [per-rank outputs]}."""
    d, m = mesh_shape
    world = d * m
    spec = str(tmp / "spec.json")
    json.dump({"mesh": list(mesh_shape), "cases": cases, "out": str(tmp)}, open(spec, "w"))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, coord, str(world), str(r), spec],
                         env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
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
    return {
        c["name"]: [dict(np.load(tmp / f"{c['name']}_{r}.npz", allow_pickle=True))
                    for r in range(world)]
        for c in cases
    }


# ---------------------------------------------------------------- inputs
def _random_batch(rng, b, f, n_feats, n_fields, pad_tail=2):
    """tests/test_sharded.py::_random_batch."""
    fields = rng.integers(0, n_fields, (b, f)).astype(np.int32)
    feats = rng.integers(0, n_feats, (b, f)).astype(np.int32)
    vals = rng.random((b, f)).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sample_w = np.ones(b, np.float32)
    feats[:, -1] = n_feats
    vals[:, -1] = 0.0
    fields[:, -1] = 0
    if pad_tail:
        sample_w[-pad_tail:] = 0.0
        vals[-pad_tail:] = 0.0
        feats[-pad_tail:] = n_feats
        y[-pad_tail:] = 0.0
    return (fields, feats, vals, y, sample_w)


def _zipf_batch(rng, b, f, n_feats, n_fields, s=1.1):
    """tests/test_sharded.py::_zipf_batch."""
    ranks = rng.zipf(s, size=(b, f))
    feats = np.minimum(ranks - 1, n_feats - 1).astype(np.int32)
    fields = rng.integers(0, n_fields, (b, f)).astype(np.int32)
    vals = np.ones((b, f), np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    return (fields, feats, vals, y, np.ones(b, np.float32))


def _kw(model_type, **kw):
    base = dict(model_type=model_type, n_feats=50, n_fields=4, n_factors=4, batch_size=16,
                max_nnz=5)
    base.update(kw)
    return base


def _case(tmp, name, kw, arrays, seed_init=0):
    """A steps case: the JAX init and the batch written for the ranks."""
    from ftrl_ffm_tpu.config import Config as JConfig
    from ftrl_ffm_tpu.models import make_model as j_make_model

    init = j_make_model(JConfig(**kw)).init()
    init_path, batch_path = str(tmp / f"{name}_init.npz"), str(tmp / f"{name}_batch.npz")
    arrays_of = {}
    for k, v in init._asdict().items():
        if v is None:
            continue
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            arrays_of[k + ".bf16"] = v.view(np.int16)  # ranks have no ml_dtypes
        else:
            arrays_of[k] = v
    np.savez(init_path, **arrays_of)
    np.savez(batch_path, **dict(zip(("fields", "feats", "vals", "y", "sample_w"), arrays)))
    return {"kind": "steps", "name": name, "cfg": kw, "init": init_path, "batch": batch_path}


def _base_cases(tmp, mesh_shape):
    cases = []
    for mt in ("LR", "FM", "FFM"):
        for lookup in ("replicate", "route"):
            if lookup == "route" and mesh_shape[1] == 1:
                continue
            kw = _kw(mt, lookup_mode=lookup)
            arrays = _random_batch(np.random.default_rng(0), 16, 5, 50, 4)
            cases.append(_case(tmp, f"{mt}_{lookup}", kw, arrays))
    return cases


def _mesh_cases(tmp, mesh_shape):
    rng = np.random.default_rng
    if mesh_shape == (4, 2):
        # tests/test_sharded.py:498's config: 39 fields padded to 40, K=16
        # (E = 640), the dense regime's accumulator form on D = 4
        b = rng(2)
        cfg = dict(model_type="FFM", n_feats=512, n_fields=39, n_factors=16, batch_size=64,
                   max_nnz=4, lookup_mode="replicate", update_mode="dense")
        arrays = (b.integers(0, 39, (64, 4)).astype(np.int32),
                  b.integers(0, 512, (64, 4)).astype(np.int32), np.ones((64, 4), np.float32),
                  (b.random(64) > 0.5).astype(np.float32), np.ones(64, np.float32))
        return [{**_case(tmp, "accumulator", cfg, arrays), "steps": 1}]
    cases = _base_cases(tmp, mesh_shape)
    if mesh_shape == (2, 2):
        for mt in ("LR", "FFM"):
            cases.append(_case(tmp, f"sparse_{mt}", _kw(mt, update_mode="sparse",
                                                         lookup_mode="replicate"),
                               _random_batch(rng(4), 16, 5, 50, 4)))
        hot = _random_batch(rng(7), 16, 5, 50, 4, pad_tail=0)
        hot = (hot[0], np.full_like(hot[1], 3), *hot[2:])
        cases.append(_case(tmp, "hot_id", _kw("LR", lookup_mode="route", route_capacity=0.01),
                           hot))
        for lookup in ("replicate", "route"):
            cases.append(_case(tmp, f"bf16_{lookup}", _kw("FFM", lookup_mode=lookup,
                                                           table_dtype="bfloat16"),
                               _random_batch(rng(5), 16, 5, 50, 4)))
        for mt in ("LR", "FFM"):
            z = _zipf_batch(rng(11), 16, 5, 50, 4)
            for lookup in ("route", "replicate"):
                cases.append(_case(tmp, f"zipf_{mt}_{lookup}", _kw(mt, lookup_mode=lookup), z))
    if mesh_shape == (1, 4):
        for mt in ("FM", "FFM"):
            for um in ("inplace", "sparse"):
                cases.append(_case(tmp, f"route_{um}_{mt}", _kw(mt, lookup_mode="route",
                                                               update_mode=um),
                                   _random_batch(rng(21 if um == "inplace" else 33), 16, 5,
                                                 50, 4)))
        # 16 distinct ids, all owned by model rank 0: 16 > K = 8 a peer
        ov = _random_batch(rng(9), 16, 5, 64, 4, pad_tail=0)
        feats = (4 * (np.arange(16 * 5) % 16)).reshape(16, 5).astype(np.int32)
        cases.append(_case(tmp, "overflow", dict(_kw("LR", n_feats=64, lookup_mode="route",
                                                     route_capacity=0.01)),
                           (ov[0], feats, *ov[2:])))
        b = np.random.default_rng(0)
        cfg = dict(model_type="FFM", n_feats=8192, n_fields=4, n_factors=4, batch_size=64,
                   max_nnz=4, lookup_mode="route")
        arrays = (b.integers(0, 4, (64, 4)).astype(np.int32),
                  b.integers(0, 8192, (64, 4)).astype(np.int32), np.ones((64, 4), np.float32),
                  (b.random(64) > 0.5).astype(np.float32), np.ones(64, np.float32))
        cases.append({**_case(tmp, "collectives", cfg, arrays), "steps": 1})
        path = str(tmp / "adversarial.ffm")
        r = np.random.default_rng(13)
        with open(path, "w") as f:
            for i in range(64):
                toks = [str(int(r.random() > 0.5))] + [
                    f"{c}:{4 * ((4 * i + c) % 16)}:1" for c in range(4)
                ]
                f.write(" ".join(toks) + "\n")
        cases.append({"kind": "trainer", "name": "policy", "cfg": dict(
            train_data=path, model_type="LR", n_fields=4, n_feats=64, batch_size=16,
            n_epochs=1, online=True, mesh_data=1, mesh_model=4, lookup_mode="route",
            route_capacity=0.01)})
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh shape: (cases by name, rank outputs by name)}, spawned once
    a shape, on first use."""
    done = {}

    def get(mesh_shape):
        if mesh_shape not in done:
            tmp = tmp_path_factory.mktemp("mesh_" + "x".join(map(str, mesh_shape)))
            cases = _mesh_cases(tmp, mesh_shape)
            done[mesh_shape] = ({c["name"]: c for c in cases}, _spawn(tmp, mesh_shape, cases))
        return done[mesh_shape]

    return get


# ---------------------------------------------------------------- references
def _init_arrays(case):
    """The case's init, field by field (ModelState order), a bf16 table
    as ml_dtypes' bfloat16."""
    import ml_dtypes

    z = np.load(case["init"])
    out = []
    for k in FIELDS:
        if k + ".bf16" in z:
            out.append(z[k + ".bf16"].view(ml_dtypes.bfloat16))
        else:
            out.append(z[k] if k in z else None)
    return out


def _jax_run(case, mesh_shape, steps=2):
    """The JAX ShardedStep on the same mesh shape: per step (logits,
    loss_sum, count, overflow), the eval (loss, count, logits) and the
    logical state after the steps."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.config import Config as JConfig
    from ftrl_ffm_tpu.models import ModelState as JState
    from ftrl_ffm_tpu.parallel import ShardedStep, make_mesh, shard_state, unshard_state

    cfg = JConfig(**case["cfg"])
    init = JState(*(None if v is None else jnp.asarray(v) for v in _init_arrays(case)))
    b = np.load(case["batch"])
    arrays = tuple(b[k] for k in ("fields", "feats", "vals", "y", "sample_w"))
    mesh = make_mesh(*mesh_shape)
    st = shard_state(init, mesh)
    step = ShardedStep(cfg, mesh, st)
    sb = step.place_batch(arrays)
    outs = []
    for _ in range(steps):
        st, logits, ls, ct, of = step.train_step(st, sb)
        outs.append((np.asarray(logits), float(ls), float(ct), None if of is None else int(of)))
    eval_out = step.eval_step(st, sb)
    logical = unshard_state(st, mesh.shape["model"], cfg.n_feats)
    return step, outs, eval_out, logical


def _torch_one_device(case, steps=2):
    """The port's one-device step from the same init: per step (logits,
    loss_sum), and the state after."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
    from ftrl_ffm_tpu_torch.models import Batch, make_model

    cfg = Config(**case["cfg"], device="cpu")
    model = make_model(cfg)
    st = state_from_jax_arrays(dict(zip(FIELDS, _init_arrays(case))), "cpu")
    b = np.load(case["batch"])
    batch = Batch(*(torch.from_numpy(b[k]) for k in ("fields", "feats", "vals", "y", "sample_w")))
    outs = []
    for _ in range(steps):
        o = model.train_step(st, batch)
        outs.append((o.logits.numpy(), float(o.loss_sum)))
    return outs, model.sync_lin_from_mirror(st)


def _global_logits(outs, key, mode, mesh_shape):
    """The global batch's logits from the ranks' slices: route splits the
    batch over every rank in rank order, replicate over the data ranks
    (model rank 0 of each)."""
    d, m = mesh_shape
    ranks = range(d * m) if mode == "route" else range(0, d * m, m)
    return np.concatenate([outs[r][key] for r in ranks])


def _check_replicas(outs, mesh_shape):
    """The data replicas of each model shard hold the same bits."""
    d, m = mesh_shape
    for k in outs[0]:
        if not k.startswith("local_"):
            continue
        for mi in range(m):
            ref = outs[mi][k]
            for di in range(1, d):
                np.testing.assert_array_equal(outs[di * m + mi][k], ref, err_msg=k)


def _check_against_references(case, outs, mesh_shape, table_tol=TABLE_TOL):
    mode = str(outs[0]["mode"])
    step, j_outs, j_eval, j_state = _jax_run(case, mesh_shape, case.get("steps", 2))
    assert mode == step.mode
    t_outs, t_state = _torch_one_device(case, case.get("steps", 2))
    for i, (j_logits, j_loss, j_count, j_of) in enumerate(j_outs):
        logits = _global_logits(outs, f"logits{i}", mode, mesh_shape)
        np.testing.assert_allclose(logits, j_logits, **LOGIT_TOL)
        np.testing.assert_allclose(logits, t_outs[i][0], **LOGIT_TOL)
        for r in outs:
            np.testing.assert_allclose(float(r[f"loss{i}"]), j_loss, rtol=1e-5)
            np.testing.assert_allclose(float(r[f"loss{i}"]), t_outs[i][1], rtol=1e-5)
            assert float(r[f"count{i}"]) == j_count
            if j_of is not None:
                assert int(r[f"overflow{i}"]) == j_of
    e_loss, e_count, e_logits, _ = j_eval
    np.testing.assert_allclose(float(outs[0]["eval_loss"]), float(e_loss), rtol=1e-5)
    assert float(outs[0]["eval_count"]) == float(e_count)
    np.testing.assert_allclose(_global_logits(outs, "eval_logits", mode, mesh_shape),
                               np.asarray(e_logits), **LOGIT_TOL)
    for k in ("lin_z", "lin_n", "vec_z", "vec_n"):
        got = outs[0].get("state_" + k)
        if got is None:
            continue
        np.testing.assert_allclose(got, np.asarray(getattr(j_state, k)), **table_tol, err_msg=k)
        np.testing.assert_allclose(got, getattr(t_state, k).numpy(), **table_tol, err_msg=k)
    # the bias's z is an accumulator as the tables' are
    np.testing.assert_allclose(float(outs[0]["state_bias_z"]), float(j_state.bias_z),
                               **table_tol)
    _check_replicas(outs, mesh_shape)
    return step


_SHAPES = [(4, 1), (2, 2), (1, 4)]
_BASE = [(s, mt, lk) for s in _SHAPES for mt in ("LR", "FM", "FFM")
         for lk in ("replicate", "route") if not (lk == "route" and s[1] == 1)]


@pytest.mark.parametrize("mesh_shape,model_type,lookup", _BASE,
                         ids=[f"{s[0]}x{s[1]}-{mt}-{lk}" for s, mt, lk in _BASE])
def test_sharded_matches_jax_and_one_device(runs, mesh_shape, model_type, lookup):
    cases, outs = runs(mesh_shape)
    name = f"{model_type}_{lookup}"
    _check_against_references(cases[name], outs[name], mesh_shape)


@pytest.mark.parametrize("model_type", ["LR", "FFM"])
def test_sparse_form_matches(runs, model_type):
    """update_mode=sparse on D > 1: the (ids, payload) stream gathered over
    "data" and the touched-rows update (tests/test_sharded.py::
    test_sharded_sparse_update_matches_single_device)."""
    cases, outs = runs((2, 2))
    name = f"sparse_{model_type}"
    assert str(outs[name][0]["form"]) == "allgather"
    _check_against_references(cases[name], outs[name], (2, 2))


@pytest.mark.parametrize("model_type", ["FM", "FFM"])
@pytest.mark.parametrize("update_mode", ["inplace", "sparse"])
def test_route_inplace_form_matches(runs, model_type, update_mode):
    """(1, N) route meshes under update_mode=inplace update in place (z
    scattered, kernel #3's pass), and in the sparse2 regime on the received
    slots by the touched-rows update; both match the JAX package, whose
    routed update is in place in both (tests/test_sharded.py::
    test_route_inplace_update_matches_single_device, ::
    test_route_sparse2_takes_inplace_form_and_matches)."""
    cases, outs = runs((1, 4))
    name = f"route_{update_mode}_{model_type}"
    assert str(outs[name][0]["mode"]) == "route"
    assert all(int(r["overflow0"]) == 0 for r in outs[name])
    _check_against_references(cases[name], outs[name], (1, 4))


# (mesh, case, the owner's update form): auto ("dense2" at these sizes)
# and sparse on (1, 4) take the touched-rows launch, update_mode=inplace
# the pass over the shard, and route meshes with D > 1 the accumulator form
_ROUTE_FORMS = [
    *(((1, 4), f"{mt}_route", "dense2") for mt in ("LR", "FM", "FFM")),
    *(((1, 4), f"route_sparse_{mt}", "sparse2") for mt in ("FM", "FFM")),
    *(((1, 4), f"route_inplace_{mt}", "inplace") for mt in ("FM", "FFM")),
    *(((2, 2), f"{mt}_route", "accumulator") for mt in ("LR", "FM", "FFM")),
]


@pytest.mark.parametrize("mesh_shape,name,form", _ROUTE_FORMS,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n, _ in _ROUTE_FORMS])
def test_route_update_form_and_counters(runs, mesh_shape, name, form):
    """The routed update's form follows the mesh and update_mode
    (ftrl.py::update_form, ShardedStep.form), and its counters say which
    ran on every rank: route.update.touched once a train step for the
    touched-rows launch on the received slots, route.update.pass once a
    step for a pass over the shard (kernel #3, in place or after the
    accumulator's all_reduce), never both; the tables match the JAX
    package's and the one-device step's."""
    cases, outs = runs(mesh_shape)
    o = outs[name]
    steps = cases[name].get("steps", 2)
    touched = form in ("dense2", "sparse2")
    for r in o:
        assert str(r["mode"]) == "route" and str(r["form"]) == form
        assert int(r["route_touched"]) == (steps if touched else 0)
        assert int(r["route_pass"]) == (0 if touched else steps)
    _check_against_references(cases[name], o, mesh_shape)


@pytest.mark.parametrize("lookup", ["replicate", "route"])
def test_bf16_table_matches(runs, lookup):
    """A bf16 factor weight table on a mesh: the rows all_reduced (one
    owner a row: exact) or routed in bf16 and widened to f32 for kernel
    #2; logits at the same tolerance, the tables after two steps at the
    chained-step bound."""
    cases, outs = runs((2, 2))
    _check_against_references(cases[f"bf16_{lookup}"], outs[f"bf16_{lookup}"], (2, 2),
                              BF16_CHAIN_TOL)


def test_route_hot_id_exact_at_tiny_capacity(runs):
    """Every occurrence one id: one slot, no overflow even at
    route_capacity=0.01 (K clamped to 8)."""
    cases, outs = runs((2, 2))
    o = outs["hot_id"]
    assert str(o[0]["mode"]) == "route" and int(o[0]["route_k"]) == 8
    assert all(int(r["overflow0"]) == 0 for r in o)
    _check_against_references(cases["hot_id"], o, (2, 2))


@pytest.mark.parametrize("model_type", ["LR", "FFM"])
def test_route_zipf_skew_exact(runs, model_type):
    """Zipf (s=1.1) ids at the default capacity: no drop, and route equals
    replicate within the table tolerance (and both their references)."""
    cases, outs = runs((2, 2))
    route, repl = outs[f"zipf_{model_type}_route"], outs[f"zipf_{model_type}_replicate"]
    assert all(int(r["overflow0"]) == 0 and int(r["overflow1"]) == 0 for r in route)
    for k in ("lin_z", "vec_z"):
        if "state_" + k in route[0]:
            np.testing.assert_allclose(route[0]["state_" + k], repl[0]["state_" + k],
                                       **TABLE_TOL)
    np.testing.assert_allclose(float(route[0]["loss1"]), float(repl[0]["loss1"]), rtol=1e-5)
    _check_against_references(cases[f"zipf_{model_type}_route"], route, (2, 2))


def test_route_distinct_id_overflow_counted(runs):
    """More distinct ids owned by one peer than K: the drops are counted,
    equal to the JAX step's count, the step stays finite, and the ids that
    fit still update (only shard-0 ids were in the batch)."""
    cases, outs = runs((1, 4))
    o = outs["overflow"]
    assert int(o[0]["route_k"]) == 8
    assert int(o[0]["overflow0"]) > 0
    assert np.isfinite(float(o[0]["loss0"]))
    _, j_outs, _, _ = _jax_run(cases["overflow"], (1, 4), 2)
    assert int(o[0]["overflow0"]) == j_outs[0][3]
    z = o[0]["state_lin_z"]
    touched = np.flatnonzero(z)
    assert len(touched) > 0 and np.all(touched % 4 == 0)


def test_route_overflow_policy_error_raises(runs):
    """The Trainer counts the drops in history["route_overflow"] and raises
    under route_overflow_policy="error", on every rank."""
    _, outs = runs((1, 4))
    for r in outs["policy"]:
        assert int(r["overflow"][0]) > 0
        assert "bucket overflow" in str(r["raised"])


def test_route_mesh_has_no_table_sized_collective(runs):
    """A (1, N) route step moves no collective of O(rows_local * E): the
    all_to_all bytes are exactly the route buffers (ids [M*K] int32,
    linear rows [M*K], factor rows [M*K, E], the linear payload [M*K, 2]
    and the factor payload [M*K, 2E], f32), and the rest is the step's
    small all_reduce (tests/test_sharded.py::
    test_route_mesh_has_no_table_sized_collective)."""
    cases, outs = runs((1, 4))
    o = outs["collectives"][0]
    k = int(o["route_k"])
    e = 4 * 4
    rows_local = 8192 // 4
    trace = [(str(kind), int(n)) for kind, n in o["trace"]]
    assert trace, "no collective traced"
    assert all(n < rows_local * e * 4 for _, n in trace)
    mk = 4 * k
    assert sum(n for kind, n in trace if kind == "all_to_all") == mk * 4 * (1 + 1 + e + 2 + 2 * e)
    assert [kind for kind, _ in trace if kind != "all_to_all"] == ["all_reduce"]


def test_hybrid_mesh_accumulator_allreduce_matches_scaling_model(runs):
    """tests/test_sharded.py::
    test_hybrid_mesh_accumulator_allreduce_matches_scaling_model: on a
    (4, 2) mesh in the dense regime the step all_reduces the accumulator
    over "data" (parallel/sharded.py::_accumulate_pass), exactly r_loc *
    2E * 4 bytes by dist.trace, which is the scaling twin's psum_acc
    volume (ftrl_ffm_tpu_torch/tools/scaling_model.py::model_step); every
    other all_reduce of the step is smaller."""
    from ftrl_ffm_tpu_torch.tools.scaling_model import model_step

    _, outs = runs((4, 2))
    d, m = 4, 2
    r_loc, e = 512 // m, 40 * 16
    model = model_step(d, m, 64 // (d * m), 39, 16, 512)
    assert model["psum_acc_bytes"] == r_loc * 2 * e * 4
    for o in outs["accumulator"]:
        assert str(o["form"]) == "accumulator" and str(o["mode"]) == "replicate"
        sizes = sorted(int(n) for kind, n in o["trace"] if str(kind) == "all_reduce")
        assert sizes[-1] == model["psum_acc_bytes"]
        assert sizes.count(sizes[-1]) == 1
