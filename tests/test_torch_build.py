"""The kernel build (ops/_build.py): a missing toolchain raises — there is no
fallback — and the library name follows the sources and flags."""

import os

import pytest

from ftrl_ffm_tpu_torch.ops import _build


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_follows_sources_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build._so_path([str(src)])
    assert first == _build._so_path([str(src)])
    assert os.path.dirname(first) == _build.BUILD_DIR
    src.write_text("// two\n")
    second = _build._so_path([str(src)])
    assert second != first
    monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ("-lineinfo",))
    assert _build._so_path([str(src)]) != second


def test_every_kernel_source_is_built():
    names = [os.path.basename(s) for s in _build._sources()]
    assert "ffm_logits.cu" in names
    assert "ffm_fused.cu" in names and "ftrl_update.cu" in names
    assert "ftrl_pass.cu" in names


def test_every_kernel_is_declared():
    """Each C entry point the wrappers call has its ctypes signature."""
    import ctypes

    class Lib:
        def __getattr__(self, name):
            fn = _Fn()
            setattr(self, name, fn)
            return fn

    class _Fn:
        argtypes = None
        restype = None

    lib = Lib()
    _build._declare(lib)
    for name in ("ffm_logits_launch", "ffm_fused_launch", "ftrl_update_launch",
                 "za_scatter_launch", "ftrl_pass_launch"):
        fn = getattr(lib, name)
        assert fn.restype is ctypes.c_int and ctypes.c_void_p in fn.argtypes
    assert lib.ftrl_update_launch.argtypes.count(ctypes.c_float) == 4
    assert lib.ftrl_pass_launch.argtypes.count(ctypes.c_float) == 4
    # the pass counts R * E floats in a size_t: a 1M x 640 table is 640M
    assert ctypes.c_size_t in lib.ftrl_pass_launch.argtypes
