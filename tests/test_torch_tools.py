"""The port's measurement tools (ftrl_ffm_tpu_torch/tools/profile_step.py,
roofline.py, micro_scatter.py) against their JAX twins in tools/, on the
CPU at small sizes.

profile_step's batch equals the JAX tool's bit for bit; its timers return
finite positive numbers on the CPU (a check that they run, not a device
time); the phase the port does not serve (xla) raises.  roofline counts the
JAX model's bytes for each pass both designs share, and for "dense2"
differs from it by exactly the [R, 2E] accumulator's traffic at the
factor and linear widths, less the port's id sort.  micro_scatter runs
each phase."""

import importlib.util
import math
import os
import sys

import numpy as np
import pytest

from ftrl_ffm_tpu_torch.tools import micro_scatter as tscatter
from ftrl_ffm_tpu_torch.tools import profile_step as tprofile
from ftrl_ffm_tpu_torch.tools import roofline as troofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_loaded = 0


def _jax_tool(monkeypatch, name):
    """A fresh copy of tools/<name>.py (which inserts the repo root into
    sys.path when imported)."""
    global _loaded
    monkeypatch.setattr(sys, "path", list(sys.path))
    _loaded += 1
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}_{_loaded}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_step(monkeypatch):
    for key, value in (("BATCH", "256"), ("N_FEATS", "3900")):
        monkeypatch.setenv(key, value)
    for key in ("UPDATE_MODE", "ACC_DTYPE", "TABLE_DTYPE", "MODEL"):
        monkeypatch.delenv(key, raising=False)


def test_profile_step_build_matches_jax(monkeypatch, small_step):
    jtool = _jax_tool(monkeypatch, "profile_step")
    jcfg, _, _, jbatch = jtool.build()
    cfg, _, state, batch = tprofile.build(device="cpu")
    for name in ("batch_size", "n_feats", "n_fields", "n_factors", "max_nnz", "model_type",
                 "update_mode", "acc_dtype", "table_dtype"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for name, got, want in zip(batch._fields, batch, jbatch):
        if want is None:  # feats_base: no id tier in the built batch
            assert got is None, name
            continue
        assert np.array_equal(got.numpy(), np.asarray(want)), name
        assert got.numpy().dtype == np.asarray(want).dtype, name
    assert state.vec_w.shape == (3900, 640)


@pytest.mark.parametrize("timer", ["time_train", "time_infer"])
def test_profile_step_timers_run_on_cpu(small_step, monkeypatch, timer):
    # a batch whose 12 steps of difference outlast the host's noise
    monkeypatch.setenv("BATCH", "1024")
    cfg, model, state, batch = tprofile.build(device="cpu")
    ms = getattr(tprofile, timer)(cfg, model, state, batch)
    assert math.isfinite(ms) and ms > 0


def test_profile_step_phases_on_cpu(small_step, monkeypatch, capsys):
    """Every phase the port serves runs and prints its line; huge honours
    UPDATE_MODE and prints its roofline floor."""
    monkeypatch.setenv("UPDATE_MODE", "inplace")
    res = tprofile.main(["pallas", "infer", "huge", "trace", "tiny"], device="cpu")
    out = capsys.readouterr().out
    assert res["pallas"]["update_kind"] == res["huge"]["update_kind"] == "inplace"
    for phase in ("pallas", "huge"):
        assert res[phase]["floor_ms"] == pytest.approx(troofline.floor_ms(
            troofline.step_bytes(256, 39, 39, 16, 3900, "FFM", "inplace")))
        assert res[phase]["share"] is None and f"{phase}: " in out
    assert math.isfinite(res["infer"]["ms"]) and "trace: top CPU ops" in out
    assert "tiny: ok" in out
    assert res["trace"] and all(ms >= 0 for _, ms in res["trace"])


def test_profile_step_refuses_xla_and_sharded(small_step, capsys):
    """xla has no counterpart and raises; sharded, once refused (item 8),
    times ShardedStep on a 1x1 mesh over a gloo group of one and prints
    its line beside the cuda phase's, with the same update kind and
    roofline floor."""
    with pytest.raises(ValueError, match="no counterpart in the PyTorch port"):
        tprofile.main(["xla"], device="cpu")
    res = tprofile.main(["cuda", "sharded"], device="cpu")
    out = capsys.readouterr().out
    assert "sharded: " in out and "cuda: " in out
    assert math.isfinite(res["sharded"]["ms"])
    for key in ("update_kind", "floor_ms"):
        assert res["sharded"][key] == res["cuda"][key]


# (batch, nnz per sample, fields, factors, table rows, model): FFM at 40
# fields (K=16: no padding, so the JAX model's C*K row is the stored one)
# and FM at an assumed hashing-trick table of 2^22 rows
ROOF_SHAPES = [(16384, 40, 40, 16, 100_000, "FFM"), (16384, 39, 39, 16, 1 << 22, "FM")]


@pytest.mark.parametrize("shape", ROOF_SHAPES)
@pytest.mark.parametrize("update", ["dense2", "inplace", "sparse2"])
def test_roofline_shares_jax_passes(monkeypatch, shape, update):
    """Each pass both designs count carries the JAX model's name and
    bytes; "sparse2" costs what "dense2" costs (the same kernel)."""
    jroof = _jax_tool(monkeypatch, "roofline")
    want = jroof.step_bytes(*shape, update=update)
    got = troofline.step_bytes(*shape, update=update)
    shared = set(got) & set(want)
    assert "v-row gather (rows in, [nnz,E] out)" in shared
    assert "fused kernel ([nnz,E] in, [nnz,2E] out)" in shared
    if update == "inplace":
        assert "factor closed-form (n,z,acc,w in; n,z,w out)" in shared
    for name in shared:
        assert got[name] == want[name], name
    if update == "sparse2":
        assert got == troofline.step_bytes(*shape, update="dense2")


@pytest.mark.parametrize("shape", ROOF_SHAPES)
def test_roofline_dense2_drops_the_accumulator(monkeypatch, shape):
    """The JAX "dense2" total less the port's is the accumulator's traffic,
    (10R - 2U) * width * 4 at the factor width and at the linear one (its
    zero-init, read-modify-write of the touched rows, read by the closed
    form, and the closed form over the untouched rows), less the port's
    stable sort of the ids (12 bytes an occurrence)."""
    jroof = _jax_tool(monkeypatch, "roofline")
    batch, nps, c, k, r, model = shape
    nnz = batch * nps
    width = c * k if model == "FFM" else k
    u = r * (1 - math.exp(-nnz / r))
    acc = (10 * r - 2 * u) * 4
    want = sum(jroof.step_bytes(*shape, update="dense2").values())
    got = sum(troofline.step_bytes(*shape, update="dense2").values())
    assert want - got == pytest.approx(acc * width + acc - 12 * nnz, rel=1e-12)


def test_roofline_port_rows_are_padded():
    """At 39 fields (K=16) the port's FFM rows are field_pad 40 wide: the
    gather and the fused kernel move what the JAX model counts at 40
    fields, and the linear tables ride the dead lane (only their touched
    rows' n, z, w under "dense2"; nothing under "inplace")."""
    got = troofline.step_bytes(16384, 39, 39, 16, 100_000)
    at40 = troofline.step_bytes(16384, 39, 40, 16, 100_000)
    for name in ("v-row gather (rows in, [nnz,E] out)",
                 "fused kernel ([nnz,E] in, [nnz,2E] out)"):
        assert got[name] == at40[name]
    lane = "linear path (touched n,z,w in/out; rides the dead lane)"
    assert got[lane] == 6 * troofline.unique_rows(100_000, 16384 * 39) * 4
    assert troofline.step_bytes(16384, 39, 39, 16, 10**6, update="inplace")[lane] == 0
    assert troofline.main(["--batch", "16384"]) == pytest.approx(
        troofline.floor_ms(got, 3350.0))


def test_micro_scatter_runs_each_phase_on_cpu(monkeypatch, capsys):
    for key, value in (("BATCH", "32"), ("N_FEATS", "400"), ("C", "39"), ("E", "8"),
                       ("DTYPE", "float32")):
        monkeypatch.setenv(key, value)
    res = tscatter.main(None, device="cpu")
    assert tuple(res) == tscatter.PHASES
    assert all(math.isfinite(ms) for ms in res.values())
    out = capsys.readouterr().out
    assert "B=32 C=39 R=400 E2=16 dtype=float32 nnz=1248" in out
    assert tscatter.main(["sort_flat"], device="cpu").keys() == {"sort_flat"}
