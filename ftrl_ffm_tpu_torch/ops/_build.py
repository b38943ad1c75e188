"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` (one process per source, all started
together) and links them into one shared library with a plain C
interface for sm_90a (Hopper), at first use, into `build/` inside the
package (listed in .gitignore).  The sources: the training and serving
path's `ffm_logits.cu`, `ffm_fused.cu`, `ftrl_update.cu` and
`ftrl_pass.cu`, and the probe kernels of `ftrl_ffm_tpu_torch/tools/`
(the counterparts of the TPU probes in `tools/micro_*.py`):
`micro_pass3.cu`, `micro_canon.cu`, `micro_rmw.cu` and
`micro_gather.cu`.  The library's name carries a hash of the sources and
flags, so an edited kernel is never shadowed by a stale build.  It is
loaded with ctypes: no PyTorch headers in the build, which keeps it to
seconds.  A failed build raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ftrl_ffm_tpu_torch import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of every kernel, for the build log
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build printed (nvcc's -Xptxas -v report) and how long it
# took; empty and None when the library came from an earlier build
build_log = ""
build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "ftrl_ffm_tpu_torch are built from source at first use"
    )


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _so_path(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libftrl_ffm_kernels-{h.hexdigest()[:16]}.so")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
    lib.ffm_logits_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p, ctypes.POINTER(i)]
    lib.ffm_logits_launch.restype = i
    lib.ffm_fused_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p,
                                     ctypes.POINTER(i)]
    lib.ffm_fused_launch.restype = i
    lib.ftrl_update_launch.argtypes = [
        p, p, i, p, p, ctypes.c_longlong, i, p, p, p, p, p, p, p, i, i, i, i, i, f, f, f, f, p,
        ctypes.POINTER(i), p,
    ]
    lib.ftrl_update_launch.restype = i
    lib.ftrl_update_scratch_ints.argtypes = [i]
    lib.ftrl_update_scratch_ints.restype = i
    lib.ftrl_update_hot_rows.argtypes = []
    lib.ftrl_update_hot_rows.restype = i
    lib.za_scatter_launch.argtypes = [p, p, i, p, p, p, p, i, i, p, ctypes.POINTER(i), p]
    lib.za_scatter_launch.restype = i
    lib.ftrl_pass_launch.argtypes = [p, p, p, p, n, i, f, f, f, f, p]
    lib.ftrl_pass_launch.restype = i
    lib.micro_pass3_launch.argtypes = [p, p, p, n, f, f, f, f, p]
    lib.micro_pass3_launch.restype = i
    lib.micro_canon_launch.argtypes = [p, p, p, p, p, p, p, i, i, p]
    lib.micro_canon_launch.restype = i
    lib.micro_rmw_scratch_ints.argtypes = [i]
    lib.micro_rmw_scratch_ints.restype = ctypes.c_longlong
    lib.micro_rmw_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.micro_rmw_launch.restype = i
    lib.micro_gather_chunks.argtypes = [i, i]
    lib.micro_gather_chunks.restype = i
    lib.micro_gather_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.micro_gather_launch.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def _compile(sources: list[str], so: str) -> str:
    """Compile and link `sources` into `so` (atomically); nvcc's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    procs: list[subprocess.Popen] = []
    try:
        for src, obj in zip(sources, objs):
            procs.append(subprocess.Popen(
                [_nvcc(), *FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building "
                    f"{os.path.basename(src)}:\n{log}"
                )
        link = subprocess.run(
            [_nvcc(), *ARCH, "-shared", "-o", tmp, *objs],
            capture_output=True, text=True, timeout=600,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({link.returncode}) linking "
                f"{', '.join(map(os.path.basename, sources))}:\n"
                f"{link.stdout}{link.stderr}"
            )
    finally:
        for proc in procs:  # none outlives a failed build
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)  # atomic: concurrent builders race safely
    return "".join(logs) + link.stdout + link.stderr


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call; raises if it cannot be.
    A build runs in the span "kernels.build" and counts kernels.builds
    and kernels.build_s (tracing)."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        so = _so_path(sources)
        if not os.path.exists(so):
            t0 = time.perf_counter()
            with tracing.span("kernels.build"):
                log = _compile(sources, so)
            build_seconds = time.perf_counter() - t0
            build_log = log
            tracing.count("kernels.builds")
            tracing.count("kernels.build_s", build_seconds)
        cdll = ctypes.CDLL(so)
        _declare(cdll)
        _lib = cdll
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib().cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
