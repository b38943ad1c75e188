"""The port's probes (ftrl_ffm_tpu_torch/tools) against the TPU probes they
replace (tools/micro_*.py) on the CPU.

Each plain PyTorch version (what the probe's wrapper runs for CPU tensors,
and what the card holds its CUDA kernel against) takes the same numpy
inputs as the JAX probe's Pallas kernel, run in interpret mode.  The tools
read their sizes from the environment when they are imported, so each test
loads a fresh copy of the JAX probe after setting them; nothing in tools/
changes.

Tolerances: the no-w pass rtol=1e-6, atol=1e-7 (the same f32 operations,
each rounded alike); the canonical-fields kernel rtol=1e-4, atol=1e-6 (f32
sums in another order); the read-modify-write variants bit for bit (both
add each element in payload order); the gathered sum 1e-5 of the largest
|sum| (f32 sums in another order)."""

import functools
import importlib.util
import os
import subprocess
import sys

import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits_grads
from ftrl_ffm_tpu_torch.tools import split_device
from ftrl_ffm_tpu_torch.tools import micro_canon_kernel as t_canon
from ftrl_ffm_tpu_torch.tools import micro_dma_gather as t_gather
from ftrl_ffm_tpu_torch.tools import micro_lazy as t_lazy
from ftrl_ffm_tpu_torch.tools import micro_vmem_rmw as t_rmw
from ftrl_ffm_tpu_torch.tools import micro_vmem_rmw2 as t_rmw2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PALLAS_CALL = jpl.pallas_call
_loaded = 0


def _jax_probe(monkeypatch, name, **env):
    """A fresh copy of tools/<name>.py, imported with `env` set and its
    Pallas kernels in interpret mode."""
    global _loaded
    for key, value in env.items():
        monkeypatch.setenv(key, str(value))
    monkeypatch.setattr(jpl, "pallas_call", functools.partial(_PALLAS_CALL, interpret=True))
    monkeypatch.setattr(sys, "path", list(sys.path))  # the tools insert the repo root
    _loaded += 1
    spec = importlib.util.spec_from_file_location(
        f"_jax_probe_{name}_{_loaded}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("r,e", [(64, 256), (40, 128), (16, 8)])
def test_pass3_plain_matches_pallas_interpret(monkeypatch, r, e):
    jmod = _jax_probe(monkeypatch, "micro_lazy")
    rng = np.random.default_rng(r + e)
    n = (rng.random((r, e)) * 3).astype(np.float32)
    n[rng.random((r, e)) < 0.3] = 0.0
    z = rng.normal(size=(r, e)).astype(np.float32)
    a = (rng.random((r, e)) * 0.5).astype(np.float32)
    a[rng.random((r, e)) < 0.4] = 0.0
    want = jmod.pass3(jnp.asarray(n), jnp.asarray(z), jnp.asarray(a))
    got = [torch.from_numpy(n.copy()), torch.from_numpy(z.copy())]
    t_lazy.pass3(*got, torch.from_numpy(a))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _canon_inputs(b, seed, pad=True):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(b * t_canon.CP, t_canon.E)) * 0.1).astype(np.float32)
    vals = rng.random((b, t_canon.CP)).astype(np.float32)
    if pad:
        vals[:, t_canon.C:] = 0.0  # the pad column, as in a real batch
    lin = (rng.normal(size=b) * 0.1).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = np.ones(b, np.float32)
    sw[-1] = 0.0
    return v, vals, lin, y, sw


@pytest.mark.parametrize("b,notr,pad", [(32, False, True), (64, False, False), (32, True, True)])
def test_canon_plain_matches_pallas_interpret(monkeypatch, b, notr, pad):
    if notr:
        monkeypatch.setenv("NOTR", "1")  # read while the kernel is traced
    jmod = _jax_probe(monkeypatch, "micro_canon_kernel", BATCH=b)
    args = _canon_inputs(b, b + notr, pad)
    want_logits, want_gg2 = jmod.canon(*(jnp.asarray(x) for x in args))
    got_logits, got_gg2 = t_canon.canon(*(torch.from_numpy(x) for x in args), notr=notr)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_gg2.numpy(), np.asarray(want_gg2), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("pad", [True, False])
def test_canon_plain_matches_kernel2_on_canonical_fields(pad):
    """The probe's own check: the general training kernel's plain version
    on fields 0..39 gives the canonical kernel's logits and payload."""
    b = 16
    args = [torch.from_numpy(x) for x in _canon_inputs(b, 7, pad)]
    fields = torch.arange(t_canon.CP, dtype=torch.int32).repeat(b, 1)
    got = t_canon.canon(*args)
    want = ffm_fused_logits_grads(args[0], fields, *args[1:], t_canon.CP, t_canon.K,
                                  aug_lane=t_canon.AUG_LANE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-6)


RMW_ENV = dict(B=64, PER=20, E=256, BLK=16)


def _rmw_inputs(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, RMW_ENV["PER"], (1, RMW_ENV["B"])).astype(np.int32)
    idx[0, 1::2][::3] = idx[0, 0::2][::3]  # duplicate pairs, for dual
    pay = rng.normal(0, 1, (RMW_ENV["B"], RMW_ENV["E"])).astype(np.float32)
    return idx, pay


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmw_plain_matches_pallas_interpret(monkeypatch, dtype):
    jmod = _jax_probe(monkeypatch, "micro_vmem_rmw", DTYPE=dtype, **RMW_ENV)
    idx, pay = _rmw_inputs(3)
    want = np.asarray(jmod.rmw(jnp.asarray(idx), jnp.asarray(pay).astype(jmod.DT)))
    got = t_rmw.rmw(torch.from_numpy(idx), torch.from_numpy(pay).to(getattr(torch, dtype)),
                    jmod.PER_PAD)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", t_rmw2.VARIANTS)
def test_rmw2_plain_matches_pallas_interpret(monkeypatch, variant):
    jmod = _jax_probe(monkeypatch, "micro_vmem_rmw2", **RMW_ENV)
    idx, pay = _rmw_inputs(4)
    want = np.asarray(jmod.run_kernel(jnp.asarray(idx), jnp.asarray(pay), variant))
    rows = t_rmw2.per_pad(RMW_ENV["PER"])
    assert rows == jmod.PER_PAD
    got = t_rmw2.run_kernel(torch.from_numpy(idx), torch.from_numpy(pay), variant, rows)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("nnz,dtype", [(64, "float32"), (70, "float32"), (64, "bfloat16")])
def test_dma_gather_plain_matches_pallas_interpret(monkeypatch, nnz, dtype):
    """70 rows in blocks of 16: the JAX grid sums the first 64, and so does
    the port given those 64 ids."""
    blk = 16
    jmod = _jax_probe(monkeypatch, "micro_dma_gather", NNZ=nnz, E2=256, BLK=blk, DTYPE=dtype)
    rng = np.random.default_rng(nnz)
    perm = rng.permutation(nnz).astype(np.int32)
    pay = rng.normal(0, 1, (nnz, 256)).astype(np.float32)
    want = np.asarray(jmod.dma_gather_sum(jnp.asarray(perm), jnp.asarray(pay).astype(jmod.DT)))
    used = nnz // blk * blk
    got = t_gather.dma_gather_sum(torch.from_numpy(perm[:used]),
                                  torch.from_numpy(pay).to(getattr(torch, dtype))).numpy()
    assert got.shape == want.shape
    assert np.abs(got[0] - want[0]).max() <= 1e-5 * np.abs(want[0]).max()
    assert (got[1:] == 0).all()  # the TPU kernel leaves rows 1-7 unwritten


# tiny sizes for each probe's main(device="cpu")
MAIN_ENV = {
    "micro_lazy": dict(BATCH=8, N_FEATS=200, C=4, E=16),
    "micro_canon_kernel": dict(BATCH=4),
    "micro_vmem_rmw": dict(B=48, PER=11, E=24, BLK=16, DTYPE="bfloat16"),
    "micro_vmem_rmw2": dict(B=40, PER=9, E=24, BLK=16),
    "micro_dma_gather": dict(NNZ=70, E2=24, BLK=16),
}
MAIN_KEYS = {
    "micro_lazy": set(t_lazy.PROBES),
    "micro_canon_kernel": {"general", "canonical"},
    "micro_vmem_rmw": {"rmw"},
    "micro_vmem_rmw2": set(t_rmw2.VARIANTS),
    "micro_dma_gather": {"gather_sum", "index_select"},
}


@pytest.mark.parametrize("name", sorted(MAIN_ENV))
def test_probe_main_runs_on_cpu(monkeypatch, capsys, name):
    """Each probe's entry point at tiny sizes on the CPU: every sub-probe
    reports, and the probe's own correctness line holds."""
    for key in ("BATCH", "N_FEATS", "C", "E", "B", "PER", "BLK", "DTYPE", "NNZ", "E2", "NOTR"):
        monkeypatch.delenv(key, raising=False)
    for key, value in MAIN_ENV[name].items():
        monkeypatch.setenv(key, str(value))
    mod = {"micro_lazy": t_lazy, "micro_canon_kernel": t_canon, "micro_vmem_rmw": t_rmw,
           "micro_vmem_rmw2": t_rmw2, "micro_dma_gather": t_gather}[name]
    res = mod.main(device="cpu")
    out = capsys.readouterr().out
    assert set(res) == MAIN_KEYS[name]
    assert all(np.isfinite(ms) and ms >= 0 for ms in res.values())
    assert "device=cpu" in out
    if name in ("micro_vmem_rmw", "micro_vmem_rmw2"):
        errs = [float(tok.split("=")[1]) for tok in out.split() if tok.startswith("max_err=")]
        # dual adds a duplicate pair's sum, a rounding apart from add.at's;
        # -1: a variant with no reference
        assert errs and all(err == -1.0 or 0.0 <= err <= 1e-5 for err in errs)
    if name == "micro_canon_kernel":
        assert "logit err: " in out and "canonical:" in out
    if name == "micro_dma_gather":
        assert "rel_err=" in out and "gather_sum" in out


def test_split_device_and_module_entry():
    """`--device` comes off a probe's command line; `python -m` runs a probe
    on the CPU with the other arguments as its own."""
    assert split_device(["pass3", "--device", "cpu"]) == ("cpu", ["pass3"])
    assert split_device(["--device=cpu", "base", "rd"]) == ("cpu", ["base", "rd"])
    assert split_device([]) == ("cuda", [])
    env = dict(os.environ, PYTHONPATH=REPO, BATCH="8", N_FEATS="200", C="4", E="16")
    out = subprocess.run(
        [sys.executable, "-m", "ftrl_ffm_tpu_torch.tools.micro_lazy", "pass3", "pass4",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = [ln.split()[0] for ln in out.stdout.splitlines()[1:]]
    assert lines == ["pass4", "pass3"]
