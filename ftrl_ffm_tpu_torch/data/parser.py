"""libsvm / libffm text parsing into fixed-shape padded numpy arrays.

The reference parses line-by-line with string scanning into per-sample tuple
vectors (reference: src/data/parser.cpp:11-41 libsvm, :62-103 libffm).  A TPU
feeds on fixed-shape tensors, so here a whole chunk of text is parsed at once,
fully vectorized in numpy:

  1. replace ':' with ' '  ->  every token is a number,
  2. one `np.fromstring`-style pass over the whole chunk,
  3. scatter the (field, feat, value) triples into padded [N, F] arrays with
     arange/repeat index arithmetic — no Python-level per-token loop.

An optional C++ parser (ftrl_ffm_tpu/native) accelerates step 1-2; this module
is the always-available fallback and ground truth.

Parity notes (reference behaviors preserved):
  * labels binarized y > 0 -> 1 (src/data/parser.cpp:16, :67)
  * zero-valued features dropped (src/data/parser.cpp:37, :99) — represented
    here by the inert padding encoding (value 0, feat id = sentinel)
  * out-of-range field/feat ids filtered like remove_out_range
    (src/model/ftrl_model.cpp:36-42, src/model/ffm.cpp:30-36)
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple

import numpy as np

from ftrl_ffm_tpu_torch import tracing


class ParsedChunk(NamedTuple):
    fields: np.ndarray  # [N, F] int32
    feats: np.ndarray   # [N, F] int32  (== sentinel for padding)
    vals: np.ndarray    # [N, F] float32 (0 for padding)
    y: np.ndarray       # [N] float32 in {0, 1}
    nnz: np.ndarray     # [N] int32 true nnz per sample (pre-truncation)


def _numbers(text: str) -> np.ndarray:
    """All whitespace-separated numbers in `text`, one vectorized pass."""
    try:
        with warnings.catch_warnings():
            # text-mode np.fromstring is deprecated but is by far the
            # fastest pure-numpy tokenizer; the C++ parser replaces it on
            # the hot path anyway
            warnings.simplefilter("ignore", DeprecationWarning)
            return np.fromstring(text, dtype=np.float64, sep=" ")
    except (AttributeError, TypeError):
        # numpy finally removed text-mode fromstring: slower but always
        # available (this path only runs when the native library is absent)
        return np.array(text.split(), dtype=np.float64)


def parse_lines(
    lines: list[str],
    file_type: str,
    max_nnz: int,
    n_feats: int,
    n_fields: int,
    n_threads: int = 1,
) -> ParsedChunk:
    return parse_text(
        "\n".join(lines) + "\n", file_type, max_nnz, n_feats, n_fields,
        n_threads=n_threads,
    )


def parse_text(
    text: str | bytes,
    file_type: str,
    max_nnz: int,
    n_feats: int,
    n_fields: int,
    use_native: bool = True,
    n_threads: int = 1,
) -> ParsedChunk:
    """Parse a chunk of libsvm/libffm text into padded arrays.

    Uses the C++ fast path (ftrl_ffm_tpu/native) when available — raw bytes
    go straight to it, no decode, and n_threads > 1 parses newline-aligned
    sub-ranges concurrently inside the library (GIL released); the
    vectorized-numpy implementation below is the always-available fallback
    and numerical ground truth (tests assert both agree).  The rows and
    seconds of each chunk count under the parser that took it
    (tracing: parse.rows.native / .numpy, parse.s.native / .numpy)."""
    t0 = time.perf_counter()
    out, path = None, "native"
    if use_native:
        out = parse_text_native(
            text, file_type, max_nnz, n_feats, n_fields, n_threads
        )
    if out is None:
        path = "numpy"
        if isinstance(text, bytes):
            text = text.decode()
        out = parse_text_numpy(text, file_type, max_nnz, n_feats, n_fields)
    tracing.count("parse.rows." + path, out.y.shape[0])
    tracing.count("parse.s." + path, time.perf_counter() - t0)
    return out


def parse_text_native(
    text: str | bytes,
    file_type: str,
    max_nnz: int,
    n_feats: int,
    n_fields: int,
    n_threads: int = 1,
) -> ParsedChunk | None:
    """C++ chunk parse; returns None if the native library is unavailable."""
    from ftrl_ffm_tpu_torch import native

    cdll = native.lib()
    if cdll is None:
        return None
    if file_type not in ("libsvm", "libffm"):
        raise ValueError(f"unknown file format: {file_type}")
    stride = 3 if file_type == "libffm" else 2
    raw = text.encode() if isinstance(text, str) else text
    cap = raw.count(b"\n") + 1

    import ctypes

    # np.empty throughout: the C++ parser fully initializes every row it
    # reports (incl. padding triples), and rows [n, cap) are sliced off —
    # zeros-memsets here cost ~5 MB per 4 MB chunk for nothing
    fields = np.empty((cap, max_nnz), np.int32)
    feats = np.empty((cap, max_nnz), np.int32)
    vals = np.empty((cap, max_nnz), np.float32)
    y = np.empty(cap, np.float32)
    nnz = np.empty(cap, np.int32)
    n = cdll.ftrl_parse_chunk_mt(
        raw,
        len(raw),
        stride,
        max_nnz,
        n_feats,
        n_fields,
        fields.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nnz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
        max(1, n_threads),
    )
    if n < 0:
        raise ValueError("wrong input: malformed libsvm/libffm line")
    return ParsedChunk(fields[:n], feats[:n], vals[:n], y[:n], nnz[:n])


def parse_text_numpy(
    text: str,
    file_type: str,
    max_nnz: int,
    n_feats: int,
    n_fields: int,
) -> ParsedChunk:
    """Parse a chunk of libsvm/libffm text into padded arrays.

    Args:
      text: one or more newline-separated samples.
      file_type: "libsvm" (label feat:val ...) or "libffm"
        (label field:feat:val ...).
      max_nnz: pad/truncate each sample's feature list to this length.
      n_feats / n_fields: valid id ranges; out-of-range entries are disabled
        in place (the batched analogue of remove_out_range).
    """
    if file_type not in ("libsvm", "libffm"):
        raise ValueError(f"unknown file format: {file_type}")
    stride = 3 if file_type == "libffm" else 2

    # '\n'-only line splitting and space/tab/CR-only blank detection: the
    # byte semantics of the native parser and count_lines(nonblank=True) —
    # str.splitlines()/strip() would additionally treat \x0b/\x0c/\x85/
    # U+2028 as breaks/whitespace and desync line accounting (e.g. the
    # multi-host predict offset math) between the two parser paths
    lines = text.split("\n")
    if lines and not lines[-1]:
        lines.pop()  # trailing newline artifact, not a blank line
    # tokens per line: label + stride * nnz
    colon_counts = np.array([ln.count(":") for ln in lines], dtype=np.int64)
    keep = np.array([bool(ln.strip(" \t\r")) for ln in lines], dtype=bool)
    if not keep.all():
        lines = [ln for ln, k in zip(lines, keep) if k]
        colon_counts = colon_counts[keep]
        text = "\n".join(lines) + "\n"
    n = len(lines)
    if n == 0:
        # empty / all-blank chunk: a legal no-op, same as the native parser
        return ParsedChunk(
            fields=np.zeros((0, max_nnz), np.int32),
            feats=np.zeros((0, max_nnz), np.int32),
            vals=np.zeros((0, max_nnz), np.float32),
            y=np.zeros((0,), np.float32),
            nnz=np.zeros((0,), np.int32),
        )
    nnz = colon_counts // (stride - 1) if stride == 3 else colon_counts
    if stride == 3 and np.any(colon_counts % 2):
        raise ValueError("wrong input: malformed libffm line (odd ':' count)")

    flat = _numbers(text.replace(":", " "))
    expected = int(n + (stride * nnz).sum())
    if flat.size != expected:
        raise ValueError(
            f"wrong input: token count mismatch (got {flat.size}, want {expected})"
        )

    line_len = 1 + stride * nnz
    offs = np.concatenate([[0], np.cumsum(line_len)[:-1]])  # start of each line

    y = (flat[offs] > 0).astype(np.float32)  # label binarization

    out_fields = np.zeros((n, max_nnz), dtype=np.int32)
    out_feats = np.full((n, max_nnz), n_feats, dtype=np.int32)  # sentinel
    out_vals = np.zeros((n, max_nnz), dtype=np.float32)

    kept = np.minimum(nnz, max_nnz)
    total = int(kept.sum())
    if total:
        row = np.repeat(np.arange(n), kept)
        excl = np.concatenate([[0], np.cumsum(kept)[:-1]])
        col = np.arange(total) - np.repeat(excl, kept)
        base = np.repeat(offs + 1, kept) + stride * col
        if stride == 3:
            f_field = flat[base].astype(np.int32)
            f_feat = flat[base + 1].astype(np.int32)
            f_val = flat[base + 2].astype(np.float32)
        else:
            f_field = np.zeros(total, dtype=np.int32)  # dummy field 0
            f_feat = flat[base].astype(np.int32)
            f_val = flat[base + 1].astype(np.float32)

        # remove_out_range + zero-value drop: disable entry in place.
        bad = (f_feat < 0) | (f_feat >= n_feats) | (f_val == 0.0)
        if stride == 3:
            bad |= (f_field < 0) | (f_field >= n_fields)
        f_feat = np.where(bad, n_feats, f_feat)
        f_val = np.where(bad, np.float32(0.0), f_val)
        f_field = np.where(bad, 0, f_field)

        out_fields[row, col] = f_field
        out_feats[row, col] = f_feat
        out_vals[row, col] = f_val

    return ParsedChunk(out_fields, out_feats, out_vals, y, nnz.astype(np.int32))


def warn_truncation(source: str, seen_nnz: int, max_nnz: int) -> None:
    """Loud, once-per-source warning when samples carry more features than
    max_nnz and are being truncated.  The reference never truncates
    (src/data/parser.cpp parses every token), so silent truncation would be
    a silent numerics divergence; it can only happen with an explicit
    --max_nnz below the data's true maximum (the sniff scans whole files)."""
    if source in _truncation_warned:
        return
    _truncation_warned.add(source)
    warnings.warn(
        f"{source}: sample(s) with up to {seen_nnz} features exceed "
        f"max_nnz={max_nnz} and are being TRUNCATED (extra features "
        f"dropped) — raise --max_nnz for reference-exact parsing",
        stacklevel=2,
    )


_truncation_warned: set[str] = set()


def sniff_max_nnz(path: str, file_type: str, sample_lines: int = 0) -> int:
    """Max nnz per sample over the WHOLE file (used when cfg.max_nnz==0).

    A capped sample would silently truncate any later, longer sample — the
    reference never truncates (it parses every token, src/data/parser.cpp),
    so the sniff must see every line.  One colon-counting pass at memchr
    speed: the native counter when available, else a vectorized-numpy scan.
    sample_lines > 0 restricts the scan to the first N lines (explicit
    opt-in for huge ad-hoc inspection only)."""
    stride = 3 if file_type == "libffm" else 2
    if sample_lines > 0:
        stride_div = stride - 1
        best = 1
        with open(path, "r") as f:
            for i, ln in enumerate(f):
                if i >= sample_lines:
                    break
                best = max(best, ln.count(":") // stride_div)
        return best

    from ftrl_ffm_tpu_torch import native

    cdll = native.lib()
    if cdll is not None:
        import ctypes

        best = 1
        with open(path, "rb") as f:
            while True:
                blk = f.read(8 << 20)
                if not blk:
                    break
                if not blk.endswith(b"\n"):
                    blk += f.readline()  # complete the split line
                lines = ctypes.c_int64()
                mx = ctypes.c_int64()  # already colons // (stride - 1)
                cdll.ftrl_count_chunk(
                    blk, len(blk), stride,
                    ctypes.byref(lines), ctypes.byref(mx),
                )
                best = max(best, int(mx.value))
        return best

    best_colons = 0
    carry = 0
    with open(path, "rb") as f:
        while True:
            blk = f.read(8 << 20)
            if not blk:
                break
            arr = np.frombuffer(blk, np.uint8)
            cs = np.cumsum(arr == 58)  # ':'
            nl = np.flatnonzero(arr == 10)
            if nl.size:
                at = cs[nl]
                per = np.diff(np.concatenate([[0], at]))
                per[0] += carry
                best_colons = max(best_colons, int(per.max()))
                carry = int(cs[-1] - at[-1])
            elif arr.size:
                carry += int(cs[-1])
    best_colons = max(best_colons, carry)  # final unterminated line
    return max(1, best_colons // (stride - 1))
