"""The PyTorch port never imports jax, nor the JAX package.

A subprocess, because this test process already imported jax
(tests/conftest.py)."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ftrl_ffm_tpu_torch")

_MODULES = (
    "ftrl_ffm_tpu_torch",
    "ftrl_ffm_tpu_torch.train",
    "ftrl_ffm_tpu_torch.transfer",
    "ftrl_ffm_tpu_torch.cli",
    "ftrl_ffm_tpu_torch.ops",
    "ftrl_ffm_tpu_torch.ops.ffm_cuda",
    "ftrl_ffm_tpu_torch.ops.ftrl_cuda",
    "ftrl_ffm_tpu_torch.ops.interactions",
    "ftrl_ffm_tpu_torch.ops._build",
    "ftrl_ffm_tpu_torch.ftrl",
    "ftrl_ffm_tpu_torch.config",
    "ftrl_ffm_tpu_torch.models",
    "ftrl_ffm_tpu_torch.models.base",
    "ftrl_ffm_tpu_torch.models.ffm",
    "ftrl_ffm_tpu_torch.models.fm",
    "ftrl_ffm_tpu_torch.models.lr",
    "ftrl_ffm_tpu_torch.io",
    "ftrl_ffm_tpu_torch.io.checkpoint",
    "ftrl_ffm_tpu_torch.io.zstd",
    "ftrl_ffm_tpu_torch.metrics",
    "ftrl_ffm_tpu_torch.data",
    "ftrl_ffm_tpu_torch.tools",
    "ftrl_ffm_tpu_torch.tools.micro_lazy",
    "ftrl_ffm_tpu_torch.tools.micro_canon_kernel",
    "ftrl_ffm_tpu_torch.tools.micro_vmem_rmw",
    "ftrl_ffm_tpu_torch.tools.micro_vmem_rmw2",
    "ftrl_ffm_tpu_torch.tools.micro_dma_gather",
    "ftrl_ffm_tpu_torch.tools.kernel_ab",
    "ftrl_ffm_tpu_torch.bench",
    "ftrl_ffm_tpu_torch.tools.roofline",
    "ftrl_ffm_tpu_torch.tools.profile_step",
    "ftrl_ffm_tpu_torch.tools.bench_matrix",
    "ftrl_ffm_tpu_torch.tools.micro_scatter",
    "ftrl_ffm_tpu_torch.tools.scaling_model",
    "ftrl_ffm_tpu_torch.tools.bench_multichip",
    "ftrl_ffm_tpu_torch.tools.generate_data",
    "ftrl_ffm_tpu_torch.parallel",
    "ftrl_ffm_tpu_torch.parallel.dist",
    "ftrl_ffm_tpu_torch.parallel.mesh",
    "ftrl_ffm_tpu_torch.parallel.sharded",
)


def test_torch_no_jax():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in _MODULES)
        + "bad = sorted(m for m in sys.modules"
        " if m == 'jax' or m.startswith('jax.')"
        " or m == 'ftrl_ffm_tpu' or m.startswith('ftrl_ffm_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_name_no_jax_import():
    """No source of the port, nor chip_smoke.py (which drives the port on
    the card, where there is no jax), names jax or the JAX package in an
    import."""
    pat = re.compile(r"^\s*(import|from) (jax|ftrl_ffm_tpu)\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, fn) for fn in files if fn.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            if pat.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
    assert len(paths) > 1


def test_kernel_wrapper_refuses_other_devices():
    """The wrapper takes its plain version only for CPU tensors: any other
    device launches the CUDA kernel or raises."""
    from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits

    b, f, c, k = 2, 3, 4, 2
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ffm_fused_logits(
            torch.empty((b * f, c * k), device=meta),
            torch.empty((b, f), dtype=torch.int32, device=meta),
            torch.empty((b, f), device=meta),
            torch.empty((b,), device=meta),
            c, k,
        )


def test_training_wrappers_refuse_other_devices():
    """The training kernels' wrappers, like the logits one, take their plain
    versions only for CPU tensors."""
    from ftrl_ffm_tpu_torch.ftrl import FtrlParams
    from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits_grads
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update

    b, f, c, k, r = 2, 3, 4, 2, 5
    meta = torch.device("meta")
    e = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=meta)  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for device"):
        ffm_fused_logits_grads(
            e(b * f, c * k), e(b, f, dtype=torch.int32), e(b, f), e(b), e(b), e(b), c, k
        )
    with pytest.raises(ValueError, match="no kernel for device"):
        ftrl_update(
            e(r, c * k), e(r, c * k), e(r, c * k), e(r), e(r), e(r),
            e(b * f, dtype=torch.int32), e(b * f, 2 * c * k), 0, FtrlParams(),
        )


def test_inplace_wrappers_refuse_other_devices():
    """The huge-table update's wrappers take their plain versions only for
    CPU tensors too."""
    from ftrl_ffm_tpu_torch.ftrl import FtrlParams
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import (
        closed_form_pass,
        ftrl_update_inplace,
        ftrl_update_linear,
        za_scatter,
    )

    r, e, n = 5, 8, 6
    meta = torch.device("meta")
    t = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=meta)  # noqa: E731
    ids = t(n, dtype=torch.int32)
    calls = (
        lambda: ftrl_update_inplace(t(r, e), t(r, e), t(r, e), ids, t(n, e), t(n, e), FtrlParams()),
        lambda: za_scatter(t(r, e), t(r, e), ids, t(n, e), t(n, e)),
        lambda: closed_form_pass(t(r, e), t(r, e), t(r, e), t(r, e), FtrlParams()),
        lambda: ftrl_update_linear(t(r), t(r), t(r), ids, t(n, 2), FtrlParams()),
    )
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device"):
            call()


def test_probe_wrappers_refuse_other_devices():
    """The probe kernels' wrappers take their plain versions only for CPU
    tensors too."""
    from ftrl_ffm_tpu_torch.tools.micro_canon_kernel import canon
    from ftrl_ffm_tpu_torch.tools.micro_dma_gather import dma_gather_sum
    from ftrl_ffm_tpu_torch.tools.micro_lazy import pass3
    from ftrl_ffm_tpu_torch.tools.micro_vmem_rmw import rmw
    from ftrl_ffm_tpu_torch.tools.micro_vmem_rmw2 import run_kernel

    meta = torch.device("meta")
    t = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=meta)  # noqa: E731
    idx = t(6, dtype=torch.int32)
    calls = (
        lambda: pass3(t(4, 8), t(4, 8), t(4, 8)),
        lambda: canon(t(2 * 4, 8), t(2, 4), t(2), t(2), t(2)),
        lambda: rmw(idx, t(6, 8), 8),
        lambda: run_kernel(idx, t(6, 8), "dual", 16),
        lambda: dma_gather_sum(idx, t(6, 8)),
    )
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device"):
            call()


def test_cuda_device_without_card_raises():
    from ftrl_ffm_tpu_torch.train import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
