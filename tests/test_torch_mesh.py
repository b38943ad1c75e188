"""The port's mesh placement (ftrl_ffm_tpu_torch/parallel/mesh.py) against
the JAX package's (ftrl_ffm_tpu/parallel/mesh.py) on the same numpy
inputs: exact equality.  No processes: a rank's shard is built from a
Mesh that names the rank, and the grid checks run on a group of one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.models import make_model as j_make_model
from ftrl_ffm_tpu.parallel import mesh as jmesh
from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
from ftrl_ffm_tpu_torch.parallel import mesh as tmesh

SHARDS = [1, 2, 3, 4, 8]


@pytest.mark.parametrize("n_rows", [1, 7, 50, 64, 100])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_row_counts(n_rows, n_shards):
    assert tmesh.rows_per_shard(n_rows, n_shards) == jmesh.rows_per_shard(n_rows, n_shards)
    assert tmesh.padded_rows(n_rows, n_shards) == jmesh.padded_rows(n_rows, n_shards)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_interleave_ids(n_shards):
    n_feats = 50
    rl = jmesh.rows_per_shard(n_feats, n_shards)
    rng = np.random.default_rng(n_shards)
    # valid ids, the padding sentinel, out-of-range and negative ids
    ids = np.concatenate([rng.integers(0, n_feats, 200), [n_feats, n_feats + 7, -1, 0,
                                                          n_feats - 1]]).astype(np.int32)
    want = np.asarray(jmesh.interleave_ids(jnp.asarray(ids), n_shards, rl, n_feats))
    got = tmesh.interleave_ids(torch.from_numpy(ids), n_shards, rl, n_feats).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("width", [0, 5])
def test_interleave_tables(n_shards, width):
    rows = jmesh.padded_rows(50, n_shards)
    tab = np.random.default_rng(width).random((rows, width) if width else rows).astype(np.float32)
    want = jmesh.interleave_table(tab, n_shards)
    got = tmesh.interleave_table(torch.from_numpy(tab), n_shards).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tmesh.deinterleave_table(torch.from_numpy(want), n_shards).numpy(),
        jmesh.deinterleave_table(want, n_shards),
    )
    np.testing.assert_array_equal(tmesh.deinterleave_table(torch.from_numpy(got), n_shards)
                                  .numpy(), tab)


def _jax_state(model_type, n_feats=50):
    return j_make_model(JConfig(model_type=model_type, n_feats=n_feats, n_fields=4,
                                n_factors=4)).init()


@pytest.mark.parametrize("model_type", ["LR", "FFM"])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_pad_state_tables(model_type, n_shards):
    js = _jax_state(model_type)
    want = jmesh.pad_state_tables(js, n_shards)
    got = tmesh.pad_state_tables(state_from_jax_arrays(js, "cpu"), n_shards)
    for name in ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w"):
        w, g = getattr(want, name), getattr(got, name)
        if g is None:
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("model_type", ["FM", "FFM"])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 2), (2, 4), (1, 8)])
def test_shard_state_blocks(model_type, mesh_shape):
    """Every rank's shard is its model rank's block of the JAX package's
    placed (padded, interleaved) state; bias and step whole."""
    d, m = mesh_shape
    js = _jax_state(model_type)
    placed = jmesh.shard_state(js, jmesh.make_mesh(d, m))
    logical = state_from_jax_arrays(js, "cpu")
    for rank in range(d * m):
        mesh = tmesh.Mesh(d, m, rank, torch.device("cpu"), None, None)
        shard = tmesh.shard_state(logical, mesh)
        idx = rank % m
        for name, t in shard._asdict().items():
            if t is None:
                continue
            full = np.asarray(getattr(placed, name))
            if name.startswith(("lin_", "vec_")):
                rl = full.shape[0] // m
                full = full[idx * rl : (idx + 1) * rl]
            np.testing.assert_array_equal(t.numpy(), full, err_msg=f"{name} rank {rank}")


def test_unshard_state_inverts_shard_state_on_one_model_rank():
    from ftrl_ffm_tpu_torch.parallel import dist

    dist.ensure_group("cpu")
    mesh = tmesh.make_mesh(0, 1, "cpu")
    logical = state_from_jax_arrays(_jax_state("FFM"), "cpu")
    back = tmesh.unshard_state(tmesh.shard_state(logical, mesh), mesh, 50)
    for a, b in zip(back, logical):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,match", [
    ((0, 2), "1 devices not divisible by model=2"),
    ((2, 1), "need 2 devices, have 1"),
])
def test_make_mesh_counts_raise_as_jax(shape, match):
    from ftrl_ffm_tpu_torch.parallel import dist

    dist.ensure_group("cpu")
    with pytest.raises(ValueError, match=match):
        tmesh.make_mesh(*shape, "cpu")
    # the JAX package raises the same on one device
    import jax

    with pytest.raises(ValueError, match=match):
        jmesh.make_mesh(*shape, devices=jax.devices()[:1])


@pytest.mark.parametrize("mesh,lookup", [((1, 4), "route"), ((2, 2), "route"),
                                         ((4, 1), "replicate")])
@pytest.mark.parametrize("model_type", ["FM", "FFM"])
def test_estimate_hbm_bytes_mesh_terms(mesh, lookup, model_type):
    """The per-device estimate's r_loc state and route buffers are the JAX
    package's to the byte (ftrl_ffm_tpu/train.py::estimate_hbm_bytes); the
    work term is the port's own allocations (train.py's docstring)."""
    from ftrl_ffm_tpu.train import estimate_hbm_bytes as j_estimate
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import estimate_hbm_bytes

    kw = dict(model_type=model_type, n_feats=100_003, n_fields=39, n_factors=16,
              batch_size=16384, max_nnz=39, mesh_data=mesh[0], mesh_model=mesh[1],
              lookup_mode=lookup)
    want = j_estimate(JConfig(**kw))
    got = estimate_hbm_bytes(Config(**kw, device="cpu"))
    assert got["state"] == want["state"]
    assert got["route"] == want["route"]
    assert (got["route"] > 0) == (lookup == "route")
    assert got["total"] == got["state"] + got["work"] + got["route"]


@pytest.mark.parametrize("kw", [
    {"model_type": "FFM"},
    {"model_type": "FFM", "update_mode": "inplace"},
    {"model_type": "FFM", "update_mode": "sparse", "online": False},
    {"model_type": "FFM", "device_cache": "on"},
    {"model_type": "FM", "update_mode": "inplace"},
    {"model_type": "LR", "auc_mode": "exact"},
], ids=["ffm", "ffm-inplace", "ffm-sparse-offline", "ffm-resident", "fm-inplace", "lr-exact"])
def test_trainer_on_a_one_rank_mesh_is_the_one_device_trainer(tmp_path, kw):
    """--mesh_data 0 in one process (a gloo group of one): the histories,
    the logical state, the checkpoint's bytes once decompressed and the
    predictions are the one-device Trainer's, bit for bit."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.io import zstd
    from ftrl_ffm_tpu_torch.train import Trainer

    rng = np.random.default_rng(5)
    path = tmp_path / "d.ffm"
    with open(path, "w") as f:
        for _ in range(150):
            f.write(" ".join([str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 60))}:{rng.integers(1, 9)}" for c in range(7)]) + "\n")
    base = dict(train_data=str(path), eval_data=str(path), n_fields=7, n_feats=60,
                n_factors=16, batch_size=32, n_epochs=2, w_alpha=0.05, w_l1=0.15, device="cpu")
    base.update(kw)
    one = Trainer(Config(**base))
    mesh = Trainer(Config(**base, mesh_data=0),
                   state=type(one.state)(*(None if t is None else t.clone() for t in one.state)))
    assert mesh._mesh.shape == {"data": 1, "model": 1}
    assert one.train() == mesh.train()
    for a, b in zip(one.logical_state, mesh.logical_state):
        assert (a is None and b is None) or torch.equal(a, b)
    outs = []
    for tr, name in ((one, "one"), (mesh, "mesh")):
        tr.save_checkpoint(str(tmp_path / f"{name}.ckpt"))
        tr.predict_file(str(path), str(tmp_path / f"{name}.txt"))
        outs.append((zstd.decompress(open(tmp_path / f"{name}.ckpt", "rb").read()),
                     open(tmp_path / f"{name}.txt").read()))
    assert outs[0] == outs[1]
