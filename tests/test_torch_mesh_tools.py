"""The port's mesh tools on the CPU: the twins of tools/scaling_model.py
and tools/bench_multichip.py (ftrl_ffm_tpu_torch/tools/), against the JAX
tools' structure and tests/test_bench_multichip.py's contract.  The
bench twin's numbers time gloo ranks on the CPU: the assertions are
about plumbing and accounting, not speed."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from ftrl_ffm_tpu_torch.tools import scaling_model as tsm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_scaling_model():
    spec = importlib.util.spec_from_file_location(
        "_jax_scaling_model", os.path.join(REPO, "tools", "scaling_model.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scaling_model_is_calibrated_on_the_one_card_step():
    """At bench.py's shape on one card the modeled legs are PERF.md
    section 5's FFM-100k step (PR 11 run F): gather 1.085, kernel #2 2.061
    and the update kernel 2.179 ms, and no collective or table-wide leg."""
    r = tsm.model_step(1, 1, 16_384, 39, 16, 100_000)
    assert r["gather_ms"] == pytest.approx(1.085)
    assert r["kernel_ms"] == pytest.approx(2.061)
    assert r["scatter_ms"] == pytest.approx(2.179)
    assert r["a2a_ms"] == r["psum_acc_ms"] == r["pass_ms"] == r["r_legs_ms"] == 0
    assert r["total_ms"] == pytest.approx(1.085 + 2.061 + 2.179)


@pytest.mark.parametrize("d,m", [(1, 2), (2, 2), (4, 1), (4, 2), (8, 8)])
def test_scaling_model_keeps_the_jax_tools_legs(d, m):
    """The JAX tool's keys and collective volumes on every shape: the
    accumulator all_reduce is R/M * 2E * 4 bytes over a ring of 2(D-1)/D,
    the route legs (M - 1) / M of occ * 3E * 4 bytes; the times are the
    card's own."""
    jsm = _jax_scaling_model()
    want = jsm.model_step(d, m, 2048, 39, 16, 1_000_000, 45.0)
    got = tsm.model_step(d, m, 2048, 39, 16, 1_000_000, 370.0, 300.0)
    assert set(want) <= set(got)
    e = 40 * 16
    r_loc = 1_000_000 / m
    assert got["psum_acc_bytes"] == (r_loc * 2 * e * 4 if d > 1 else 0)
    ring = 2 * (d - 1) / d
    assert got["psum_acc_ms"] == pytest.approx(ring * got["psum_acc_bytes"] / 370e9 * 1e3)
    # the JAX model's legs at its ICI rate carry the same volumes
    assert want["psum_acc_ms"] == pytest.approx(ring * got["psum_acc_bytes"] / 45e9 * 1e3)
    assert got["a2a_bytes"] == (2048 * 39 * 3 * e * 4 if m > 1 else 0)
    assert want["a2a_ms"] == pytest.approx((m - 1) / m * got["a2a_bytes"] / 45e9 * 1e3)
    assert got["throughput"] == pytest.approx(2048 * d * m / got["total_ms"] * 1e3)


def test_scaling_model_main_names_the_card(capsys):
    rows = tsm.main(["--b_dev", "16384", "--r", "100000"])
    out = capsys.readouterr().out
    assert "NVIDIA H100 80GB HBM3" in out and "assumed" in out
    assert rows[0]["mesh"] == "1x1" and rows[0]["eff"] == 1.0
    assert {r["mesh"] for r in rows} >= {"4x1", "1x4", "2x2"}


def test_bench_multichip_two_rank_route_shape():
    """tests/test_bench_multichip.py::test_two_device_route_shape: 1x1 and
    1x2 over gloo ranks (--virtual 2), the JAX tool's last-line keys."""
    out = subprocess.run(
        [sys.executable, "-m", "ftrl_ffm_tpu_torch.tools.bench_multichip", "--virtual", "2",
         "--meshes", "1x1,1x2,2x2", "--steps", "2", "--warmup", "1", "--rows", "512",
         "--b_dev", "16", "--distinct", "2"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert "# skip 2x2: needs 4 devices" in lines
    rep = json.loads(lines[-1])
    assert rep["harness"] == "bench_multichip" and rep["virtual"] is True
    assert rep["backend"] == "gloo"
    meshes = {r["mesh"]: r for r in rep["meshes"]}
    assert set(meshes) == {"1x1", "1x2"}
    one, two = meshes["1x1"], meshes["1x2"]
    assert one["mode"] == "replicate" and one["eff_vs_first"] == 1.0
    assert two["mode"] == "route" and two["n_dev"] == 2
    assert two["global_batch"] == 32 and one["global_batch"] == 16
    # the 1x2 route mesh has all_to_all legs: the probe must time them
    assert two["coll_probe_ms"] > 0.0
    assert 0.0 < two["coll_share"] < 1.0
    assert one["coll_probe_ms"] == 0.0
    assert all(r["model_ms"] > 0 for r in rep["meshes"])
    assert all("eff_vs_first" in r and "device" not in r for r in rep["meshes"])
