"""zstd through the system's libzstd (the port's stand-in for the
`zstandard` package, which a CUDA host may lack).

A ctypes binding of the few functions the checkpoint and reference-model
formats need: a streaming compressor at a given level
(`ZSTD_compressStream2`), a streaming decompressor with a `readinto`
reader (`ZSTD_decompressStream`) and a one-shot `decompress` that also
takes frames without a content size.  The library is bound through
`ctypes.CDLL`, which releases the GIL around every call, so a background
writer compresses while the training thread keeps dispatching.  Buffers
cross by pointer (numpy arrays, bytes, CPU tensors viewed as numpy): a
table is never copied into a Python bytes object.  Every return value is
checked with `ZSTD_isError`; a missing libzstd raises ZstdUnavailable,
naming it: there is no second codec and no uncompressed output.

The bytes are zstd frames, as `zstandard` writes and reads them: either
side decompresses the other's output.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

# ZSTD_cParameter and ZSTD_EndDirective values (zstd.h, stable API)
_C_COMPRESSION_LEVEL = 100
_E_CONTINUE = 0
_E_END = 2
# output slab of the compressor: larger than ZSTD_CStreamOutSize() so that a
# table's bytes cross in few calls
_OUT_BYTES = 4 << 20


class ZstdUnavailable(OSError):
    """The system's libzstd could not be loaded."""


class ZstdError(ValueError):
    """libzstd reported an error (corrupt or truncated input, bad level)."""


class _Buffer(ctypes.Structure):
    # ZSTD_inBuffer {const void* src; size_t size; size_t pos} and
    # ZSTD_outBuffer {void* dst; size_t size; size_t pos}: the same layout
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _locate() -> str | None:
    return ctypes.util.find_library("zstd")


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The system's libzstd, loaded once, with every function the port
    calls declared."""
    path = _locate() or "libzstd.so.1"
    try:
        z = ctypes.CDLL(path)
    except OSError as e:
        raise ZstdUnavailable(
            f"libzstd not found ({path}: {e}): the PyTorch port reads and "
            "writes checkpoints and reference models through the system's "
            "libzstd (libzstd.so.1); install it (e.g. the libzstd1 package)"
        ) from e
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    buf = ctypes.POINTER(_Buffer)
    for name, restype, argtypes in (
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
        ("ZSTD_versionString", ctypes.c_char_p, []),
        ("ZSTD_createCCtx", vp, []),
        ("ZSTD_freeCCtx", size_t, [vp]),
        ("ZSTD_CCtx_setParameter", size_t, [vp, ctypes.c_int, ctypes.c_int]),
        ("ZSTD_CCtx_setPledgedSrcSize", size_t, [vp, ctypes.c_ulonglong]),
        ("ZSTD_compressStream2", size_t, [vp, buf, buf, ctypes.c_int]),
        ("ZSTD_createDCtx", vp, []),
        ("ZSTD_freeDCtx", size_t, [vp]),
        ("ZSTD_decompressStream", size_t, [vp, buf, buf]),
        ("ZSTD_DStreamInSize", size_t, []),
    ):
        fn = getattr(z, name)
        fn.restype, fn.argtypes = restype, argtypes
    return z


def version() -> str:
    return lib().ZSTD_versionString().decode()


def _check(ret: int, what: str) -> int:
    z = lib()
    if z.ZSTD_isError(ret):
        raise ZstdError(f"{what}: {z.ZSTD_getErrorName(ret).decode()}")
    return ret


def _u8(data) -> np.ndarray:
    """A contiguous uint8 view of `data` (numpy array, bytes, bytearray,
    memoryview), without a copy where it already is contiguous."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


class Compressor:
    """A zstd stream written into the binary file `f` at `level`: `write`
    the bytes in order, then `end` closes the frame.  With `size` (the
    total bytes that will be written) the frame records its content size,
    as a one-shot compress does."""

    def __init__(self, f, level: int = 3, size: int | None = None):
        self._cctx = None
        z = lib()
        self._f = f
        self._cctx = z.ZSTD_createCCtx()
        if not self._cctx:
            raise MemoryError("ZSTD_createCCtx failed")
        self._out = np.empty(_OUT_BYTES, np.uint8)
        _check(z.ZSTD_CCtx_setParameter(self._cctx, _C_COMPRESSION_LEVEL, int(level)),
               f"zstd level {level}")
        if size is not None:
            _check(z.ZSTD_CCtx_setPledgedSrcSize(self._cctx, int(size)), "zstd content size")

    def _drive(self, src: np.ndarray, directive: int) -> None:
        z = lib()
        inb = _Buffer(src.ctypes.data if src.size else None, src.nbytes, 0)
        out = _Buffer(self._out.ctypes.data, self._out.nbytes, 0)
        while True:
            out.pos = 0
            left = _check(
                z.ZSTD_compressStream2(self._cctx, ctypes.byref(out), ctypes.byref(inb), directive),
                "ZSTD_compressStream2",
            )
            if out.pos:
                self._f.write(memoryview(self._out)[: out.pos])
            done = inb.pos == inb.size
            if done and (directive == _E_CONTINUE or left == 0):
                return

    def write(self, data) -> None:
        """Compress `data` (numpy array, bytes or a buffer), passed by
        pointer; the GIL is free while libzstd works."""
        src = _u8(data)
        if src.size:
            self._drive(src, _E_CONTINUE)

    def end(self) -> None:
        """Flush and close the frame."""
        self._drive(np.empty(0, np.uint8), _E_END)

    def close(self) -> None:
        if self._cctx:
            lib().ZSTD_freeCCtx(self._cctx)
            self._cctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    __del__ = close


class Reader:
    """Decompress the zstd stream of the binary file `f` (one frame or
    several in a row) on demand: `readinto` fills a buffer, `read` returns
    bytes."""

    def __init__(self, f):
        self._dctx = None
        z = lib()
        self._f = f
        self._dctx = z.ZSTD_createDCtx()
        if not self._dctx:
            raise MemoryError("ZSTD_createDCtx failed")
        self._in = np.empty(max(int(z.ZSTD_DStreamInSize()), 1 << 20), np.uint8)
        self._inb = _Buffer(self._in.ctypes.data, 0, 0)
        self._eof = False
        # True when the last call ended a frame (and none has begun since)
        self.frame_done = True

    def readinto(self, buf) -> int:
        """Fill `buf` (a writable numpy array or buffer) with decompressed
        bytes; returns how many, fewer only at the end of the stream."""
        z = lib()
        dst = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
        if not dst.flags.c_contiguous or not dst.flags.writeable:
            raise ValueError("readinto needs a writable contiguous buffer")
        out = _Buffer(dst.ctypes.data, dst.nbytes, 0)
        while out.pos < out.size:
            if self._inb.pos == self._inb.size and not self._eof:
                n = self._f.readinto(memoryview(self._in))
                if n:
                    self._inb.size, self._inb.pos = n, 0
                else:
                    self._eof = True
            before_out, before_in = out.pos, self._inb.pos
            ret = _check(
                z.ZSTD_decompressStream(self._dctx, ctypes.byref(out), ctypes.byref(self._inb)),
                "ZSTD_decompressStream",
            )
            if out.pos > before_out or self._inb.pos > before_in:
                self.frame_done = ret == 0
            elif self._eof:
                break
        return out.pos

    def read(self, n: int) -> bytes:
        b = bytearray(n)
        got = self.readinto(b)
        return bytes(b[:got])

    def close(self) -> None:
        if self._dctx:
            lib().ZSTD_freeDCtx(self._dctx)
            self._dctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    __del__ = close


def decompress(data) -> bytes:
    """The bytes of the zstd frames in `data`, whether or not a frame
    records its content size.  A truncated frame raises ZstdError."""
    import io

    out = bytearray()
    buf = bytearray(max(1 << 20, 4 * len(data)))
    with Reader(io.BytesIO(data)) as r:
        while True:
            got = r.readinto(buf)
            out += memoryview(buf)[:got]
            if got < len(buf):
                break
        if not r.frame_done:
            raise ZstdError("zstd stream ends inside a frame (truncated)")
    return bytes(out)
