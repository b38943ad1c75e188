"""The harness end to end at a tiny size on the CPU (its look for a card
skipped): the result line, the control and planted faults that `correct`
must catch, the metric readers, and BENCHMARK.json against the contract
it is written to.  The run on the card is marked `cuda`."""

import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, compare, run, spec

ROOT = spec.ROOT
CELLS = ["ffm1m-criteo-resident", "fm1m-criteo-resident"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny(name: str) -> spec.Cell:
    """The cell at a size a test holds: its configuration with few rows,
    a small table and a small batch; its traffic and limits as they are."""
    c = spec.cell(name)
    small = {"n_feats": 3900,
             "batch_size": 64, "train_rows": 512, "eval_rows": 256, "n_threads": 1}
    return spec.Cell(name, dict(c.config, **small), c.traffic, 1, c.limits,
                     c.end_to_end, c.per_layer)


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "trace"])
def test_result_line(trace):
    cell = tiny(CELLS[1])
    line = run.run_cell(cell, 2**31 + 7, 0.3, trace, torch.device("cpu"))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and set(line["checks"]) == set(compare.NAMES)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    wanted = cell.per_layer if trace else cell.end_to_end
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in wanted}
    for name, m in line["metrics"].items():
        assert math.isfinite(m["value"]) and UNIT.match(m["unit"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    json.dumps(line, default=run._plain)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("variant", ["sound", "control", "half", "altered", "unchanged"])
def test_correct_catches_control_and_faults(cell, variant):
    got = calibrate.reading(tiny(cell), variant, 2**31 + 99, 0.0, torch.device("cpu"))
    assert got["correct"] is (variant == "sound"), got


def test_no_card_no_line():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_bare_checkout_fails(tmp_path):
    # BENCHMARK.json and benchmark/ alone: no program to measure
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-c", "import sys; from benchmark import port; "
         "port.program_config({}, {}, '', '', 0, None)"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "ftrl_ffm_tpu_torch" in out.stderr


def _rec():
    cfg = tiny(CELLS[0]).config
    span = {"train": [(0.0, 100.0), (200.0, 300.0)], "eval": [(100.0, 150.0)]}
    ops = [("Memset (Device)", 5.0, 6.0), ("ffm_fused_c40", 10.0, 40.0),
           ("Memset (Device)", 40.0, 41.0), ("ftrl_update_kernel", 41.0, 90.0),
           ("ffm_logits_c40", 110.0, 120.0), ("vectorized_gather_kernel", 210.0, 250.0)]
    steps = 8
    return {
        "config": cfg, "setup_s": 3.0, "resident_build_s": 1.0,
        "calls": [{"role": "train", "seconds": 0.5, "examples": 512, "steps": steps,
                   "epoch": 2, "traced": False},
                  {"role": "eval", "seconds": 0.1, "examples": 256, "steps": 4, "traced": False},
                  {"role": "train", "seconds": 0.6, "examples": 512, "steps": steps,
                   "epoch": 3, "traced": True}],
        "trace": {"ops": ops, "host": [], "spans": span},
        "launches_train": {"launches": 16, "steps": steps},
        "unique_rows": {("train", 2): [(64, 100)] * steps, ("train", 3): [(64, 90)] * steps,
                        ("eval", 0): [(64, 50)] * 4},
    }


def test_metric_readers():
    rec = _rec()
    names = [os.path.basename(p)[:-3] for p in
             sorted(glob.glob(os.path.join(ROOT, "benchmark", "metrics", "*.py")))]
    got = {m: run.load_metric(m)(rec) for m in names}
    assert got["train_ex_per_s"] == pytest.approx(1024 / 1.1)
    assert got["eval_ex_per_s"] == pytest.approx(2560)
    assert got["launches_per_step.train"] == 2
    # train spans 200 us, busy 1 (5-6) + 80 (10-90) + 40 (210-250)
    assert got["device_idle.train"] == pytest.approx(100 * (1 - 121 / 200))
    assert got["device_idle.eval"] == pytest.approx(100 * (1 - 10 / 50))
    for name in ("train_step_mfu", "eval_step_mfu", "update_roofline", "interaction_roofline"):
        assert 0 < got[name] < 100
    bare = dict(rec, trace=None, unique_rows=None, launches_train=None)
    for name in ("launches_per_step.train", "train_step_mfu", "update_roofline",
                 "interaction_roofline", "device_idle.train"):
        assert run.load_metric(name)(bare) is None


def test_update_stage_takes_the_memsets_before_its_kernels():
    from benchmark.metrics import update_roofline as upd

    ops = [("Memset (Device)", 0, 1), ("vectorized_gather_kernel", 1, 2),
           ("Memset (Device)", 2, 3), ("FillFunctor", 3, 4),
           ("DeviceRadixSortOnesweepKernel", 4, 5), ("Memset (Device)", 5, 6),
           ("ftrl_update_hot", 6, 7), ("reduce_kernel", 7, 8), ("Memset (Device)", 8, 9)]
    assert upd.is_update(ops) == [False, False, True, True, True, True, True, False, False]
    # the record's trace: 1 us of memset before the update kernel's 49
    assert upd.stage_seconds(_rec(), True) == pytest.approx(50e-6)
    assert upd.stage_seconds(_rec(), False) == pytest.approx(71e-6)


def test_benchmark_json_follows_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    # 24 cells at this length fit the check's 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in bench["workloads"]] + [
        c["name"] for c in bench["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and 0 < len(m["layer"]) <= 200
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        c = spec.cell(w["name"])
        assert set(c.limits) >= set(compare.NAMES)
        assert c.end_to_end and c.per_layer
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert all(k in cfg["reduced"] for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and len(c["source"]) <= 200


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_tiny_run_on_the_card(card):
    line = run.run_cell(tiny(CELLS[0]), 2**31 + 5, 0.5, True, card)
    assert line["correct"] is True and line["device"]["busy_s"] > 0
