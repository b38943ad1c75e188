"""The port's bench twin (ftrl_ffm_tpu_torch/bench.py) and bench matrix
twin (ftrl_ffm_tpu_torch/tools/bench_matrix.py) against bench.py and
tools/bench_matrix.py on the CPU, at 2,000 rows.

Data: each ensure_data writes the JAX tool's file byte for byte (the JAX
modules' row counts are set on the module; tools/bench_matrix.py's
hard-coded /tmp path is redirected into the test's directory through the
module's `os` and `open` names, so no JAX file changes and nothing is
written outside the test's directory).  Losses: the twin's protocol from
a JAX Trainer's init reaches the JAX Trainer's per-epoch losses within
atol=1e-4 (the bound of tests/test_torch_serve.py's training check).  The
table is cut to 3,900 rows (100 a field) so the states stay small."""

import importlib.util
import json
import os
import sys
import tempfile
import types

import numpy as np
import pytest

import bench as jbench
from ftrl_ffm_tpu.config import Config as JConfig
from ftrl_ffm_tpu.train import Trainer as JTrainer
from ftrl_ffm_tpu_torch import bench as tbench
from ftrl_ffm_tpu_torch.io.checkpoint import state_from_jax_arrays
from ftrl_ffm_tpu_torch.tools import bench_matrix as tmatrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 2000
SMALL_FEATS = 3900
# the keys of bench.py's JSON line
JAX_BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_note", "runs",
                  "device_cache")
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


def _redirect_tmp(mod, monkeypatch, where_dir):
    """Send the module's file operations on /tmp/<name> to where_dir/<name>
    (its `os.path.exists`, `os.path.getsize`, `os.replace` and `open`)."""
    real_open = open

    def where(p):
        p = str(p)
        return os.path.join(where_dir, os.path.basename(p)) if p.startswith("/tmp/") else p

    shim = types.SimpleNamespace(
        path=types.SimpleNamespace(exists=lambda p: os.path.exists(where(p)),
                                   getsize=lambda p: os.path.getsize(where(p))),
        replace=lambda a, b: os.replace(where(a), where(b)),
        environ=os.environ,
    )
    monkeypatch.setattr(mod, "os", shim)
    monkeypatch.setattr(mod, "open", lambda p, *a, **k: real_open(where(p), *a, **k),
                        raising=False)
    return where


def test_bench_ensure_data_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jbench, "N_SAMPLES", ROWS)
    monkeypatch.setattr(tbench, "N_SAMPLES", ROWS)
    want = jbench.ensure_data(str(tmp_path / "jax.txt"))
    got = tbench.ensure_data(str(tmp_path / "port.txt"))
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.count(b"\n") == ROWS
    # the same path is the one file bench.py writes (under the system's
    # temporary directory)
    assert os.path.basename(tbench.DATA_PATH) == os.path.basename(jbench.DATA_PATH)
    assert not os.path.exists(got + ".tmp")


@pytest.mark.parametrize("variant", ["uniform", "zipf", "numeric", "noncanon"])
def test_matrix_ensure_data_and_stats_match_jax(monkeypatch, tmp_path, variant):
    jmatrix = _jax_tool(monkeypatch, "bench_matrix")
    monkeypatch.setattr(jmatrix, "N_SAMPLES", ROWS)
    monkeypatch.setattr(tmatrix, "N_SAMPLES", ROWS)
    (tmp_path / "jax").mkdir()
    where = _redirect_tmp(jmatrix, monkeypatch, str(tmp_path / "jax"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    want = where(jmatrix.ensure_data(100_000, variant))
    got = tmatrix.ensure_data(100_000, variant)
    assert os.path.dirname(got) == str(tmp_path)
    assert os.path.basename(got) == os.path.basename(want)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.count(b"\n") == ROWS
    monkeypatch.setattr(jmatrix, "os", os)
    assert tmatrix.data_stats(got, batch=256) == jmatrix.data_stats(want, batch=256)


def _small_bench(monkeypatch, tmp_path):
    monkeypatch.setattr(tbench, "N_SAMPLES", ROWS)
    monkeypatch.setattr(tbench, "N_FEATS", SMALL_FEATS)
    return tbench.ensure_data(str(tmp_path / "bench.txt"))


def test_bench_run_matches_jax_trainer(monkeypatch, tmp_path):
    """bench.py's protocol from a JAX Trainer's init: the warm-up epoch and
    the three timed ones reach the JAX Trainer's losses; the record holds
    bench.py's keys, the batch, the device and the launches."""
    path = _small_bench(monkeypatch, tmp_path)
    cfg = tbench.make_config(path, "cpu", batch_size=256)
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "train_data", "model_type", "n_fields", "n_feats", "n_factors", "online",
        "n_epochs", "batch_size", "max_nnz", "n_threads")})
    jtr = JTrainer(jcfg)
    state = state_from_jax_arrays(jtr.state, "cpu")
    res = tbench.run(cfg, state=state)
    want = [jtr.train_epoch() for _ in range(4)]
    np.testing.assert_allclose(res["losses"], want, rtol=0, atol=1e-4)
    assert res["losses"][-1] < res["losses"][0]
    for key in (*JAX_BENCH_KEYS, "batch", "device", "launches"):
        assert key in res
    assert res["metric"] == "ffm_k16_criteo_scale_online_train_throughput"
    assert res["batch"] == 256 and res["device"] == "cpu" and res["device_cache"]
    assert len(res["runs"]) == 3 and all(r > 0 for r in res["runs"])
    assert res["value"] == max(res["runs"])
    assert res["vs_baseline"] == round(res["value"] / tbench.BASELINE_EXAMPLES_PER_S, 3)
    # the CPU runs the plain versions: no kernel launched
    assert set(res["launches"]) == {"ffm_fused_logits", "ffm_fused_logits_grads",
                                    "ftrl_update", "za_scatter", "closed_form_pass"}
    assert not any(res["launches"].values())
    assert res["steps"] == 4 * -(-ROWS // 256)


def test_bench_main_prints_one_json_line(monkeypatch, tmp_path, capsys):
    path = _small_bench(monkeypatch, tmp_path)
    monkeypatch.setattr(tbench, "BATCH", 256)
    line = tbench.main(["--device", "cpu", "--data", path])
    out = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(out) == 1 and json.loads(out[0]) == line
    assert tuple(line) == tbench.PRINTED
    assert set(JAX_BENCH_KEYS) <= set(line) and line["batch"] == 256


@pytest.mark.parametrize("row", ["fm", "lr", "zipf", "eval"])
def test_matrix_row_runs_on_cpu(monkeypatch, tmp_path, row):
    """A row's JSON keys: the JAX tool's, plus the device and the update
    kind; the non-uniform variants report their stats and the forms the
    port uploads."""
    monkeypatch.setattr(tmatrix, "N_SAMPLES", ROWS)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("N_FEATS", str(SMALL_FEATS))
    out = tmatrix.run_row(row, "cpu")
    assert out["row"] == row and out["examples_per_s"] > 0 and out["device"] == "cpu"
    assert out["update_kind"] == (None if row == "lr" else "dense2")
    assert np.isfinite(out["eval_loss" if row == "eval" else "train_loss"])
    # n_epochs=1 online: training streams, as in the JAX tool
    assert row == "eval" or out["device_cache"] == "streamed"
    if row == "zipf":
        assert 0 < out["dedup_ratio"] <= 1 and 0 <= out["delta_hit_rate"] <= 1
        # the first streamed batch's transfer-tier form (JAX's bench_matrix
        # reports the same): the one batch of 2,000 rows at B=8,192 is
        # padded, so its all-1 values go up int8 (not the marker), its ids
        # as uint16 deltas
        assert (out["vals_upload"], out["feats_upload"]) == ("int8", "uint16")
        assert 0 < out["upload_bytes"] < 8192 * (39 * 12 + 8)  # below the parsed arrays
