"""Model serialization on one device (ftrl_ffm_tpu/io/checkpoint.py).

Two formats, byte for byte the JAX package's once decompressed:

1. **Full checkpoints** (`FTRLTPU1`): the magic, a little-endian u32
   header length, a JSON header (`fields`: each ModelState field's name,
   dtype name and shape, in ModelState order; `extra`), then each field's
   raw little-endian bytes, all in one zstd stream.  Either package reads
   the other's.  The write is crash-atomic (`<path>.tmp.<pid>`, fsync,
   rename); a table on the card leaves it one <= CHUNK_BYTES slab at a
   time through one reused pinned staging buffer.
2. **Reference-compatible weights** (reference: src/compression/
   compress.cpp:15-51, src/model/ffm.cpp:138-200): an unframed float32
   [bias, lin_w..., vec_w...] blob in one zstd frame, and the FFM
   plain-text layout.

zstd goes through the system's libzstd (io/zstd.py): neither `zstandard`
nor `ml_dtypes` is needed.  A bfloat16 field is written from, and read
into, its int16 bits.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import time

import numpy as np
import torch

from ftrl_ffm_tpu_torch.io import zstd
from ftrl_ffm_tpu_torch.models.base import ModelState

MAGIC = b"FTRLTPU1"


class IncompatibleStateError(ValueError):
    """A loaded checkpoint does not match the current model-defining config
    (ftrl_ffm_tpu/io/checkpoint.py::IncompatibleStateError)."""


# Config keys that define the model's table shapes and semantics;
# field_pad and row_width are derived but persisted explicitly (the same
# keys as ftrl_ffm_tpu/io/checkpoint.py::_SIG_KEYS: headers written by
# either package compare equal).
_SIG_KEYS = (
    "model_type",
    "n_feats",
    "n_fields",
    "n_factors",
    "table_dtype",
    "factor_semantics",
)


def model_signature(cfg) -> dict:
    """The model-defining subset of a Config, as stored in checkpoint
    headers and compared on every load."""
    sig = {k: getattr(cfg, k) for k in _SIG_KEYS}
    sig["field_pad"] = cfg.field_pad
    sig["row_width"] = cfg.row_width
    return sig


def validate_header_compat(cfg, extra: dict, source: str) -> None:
    """Raise IncompatibleStateError if `extra` (a checkpoint header) records
    a model config that mismatches `cfg`.  Headers carry "model_config"
    (model_signature) or, when older, only the CLI "config" dict; headers
    with neither pass, and the Trainer's shape check still applies."""
    saved = (extra or {}).get("model_config")
    if saved is None:
        c = (extra or {}).get("config") or {}
        saved = {k: c[k] for k in _SIG_KEYS if k in c}
        if "model_type" in saved:  # Config.__post_init__ upper-cases
            saved["model_type"] = str(saved["model_type"]).upper()
    if not saved:
        return
    cur = model_signature(cfg)
    bad = {k: (saved[k], cur[k]) for k in saved if k in cur and saved[k] != cur[k]}
    if bad:
        detail = ", ".join(
            f"{k}: checkpoint has {a!r}, config has {b!r}"
            for k, (a, b) in sorted(bad.items())
        )
        raise IncompatibleStateError(
            f"{source} was saved under a different model config — {detail}. "
            f"Resume with the original flags, or retrain."
        )


# ---------------------------------------------------------------- checkpoints
CHUNK_BYTES = 64 << 20  # max bytes of a table on the host at a time while writing

# the header's dtype names (numpy's, as the JAX package writes them)
_DTYPE_NAMES = {torch.float32: "float32", torch.int32: "int32", torch.bfloat16: "bfloat16"}


def _chunk_rows(shape, itemsize) -> int:
    row_bytes = itemsize * (int(np.prod(shape[1:])) if len(shape) > 1 else 1)
    return max(1, CHUNK_BYTES // max(1, row_bytes))


def _host_slabs(t: torch.Tensor, staging, timer: dict):
    """The bytes of tensor `t` in row order, as uint8 host arrays of at most
    CHUNK_BYTES (the one-device form of ftrl_ffm_tpu/io/checkpoint.py::
    _logical_row_chunks).  A CPU tensor's slabs are views of its memory; a
    CUDA tensor's pass through the pinned `staging` buffer on the current
    stream, one at a time (each is compressed before the next is copied).
    Adds the seconds spent pulling slabs off the card to timer["pull_s"]."""
    flat = t.reshape(-1)
    rows = t.shape[0] if t.dim() else 1
    step = _chunk_rows(tuple(t.shape) or (1,), t.element_size())
    per_row = flat.numel() // max(rows, 1)
    for a in range(0, rows, step):
        part = flat[a * per_row : min(rows, a + step) * per_row].view(torch.uint8)
        if part.device.type == "cpu":
            yield part.contiguous().numpy()
            continue
        t0 = time.perf_counter()
        dst = staging[: part.numel()]
        dst.copy_(part, non_blocking=True)
        torch.cuda.current_stream(part.device).synchronize()
        timer["pull_s"] += time.perf_counter() - t0
        yield dst.numpy()


_TABLES = ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w")


def _logical_row_chunks(t: torch.Tensor, mesh, n_feats: int, staging, timer: dict):
    """The bytes of a row-sharded table in logical row order, chunk by
    chunk (ftrl_ffm_tpu/io/checkpoint.py::_logical_row_chunks): each chunk
    of at most CHUNK_BYTES is all-gathered over the model group (a whole
    number of rows from every model rank: logical rows a.. a+M*c are local
    rows a/M.. a/M+c of each rank, interleaved), and rank 0 pulls it to the
    host, where it yields it; the other ranks yield None.  No rank holds a
    whole table on the host."""
    from ftrl_ffm_tpu_torch.parallel import dist

    m = mesh.model
    row_bytes = t.element_size() * (t.numel() // max(t.shape[0], 1))
    step = max(m, _chunk_rows((n_feats, *t.shape[1:]), t.element_size()) // m * m)
    for a in range(0, n_feats, step):
        b = min(n_feats, a + step)
        lo, cnt = a // m, -(-b // m) - a // m
        part = t[lo : lo + cnt].contiguous().view(torch.uint8).reshape(cnt, row_bytes)
        if m > 1:
            part = dist.all_gather(part, mesh.model_group)
            part = part.reshape(m, cnt, row_bytes).transpose(0, 1).reshape(m * cnt, row_bytes)
        if mesh.rank != 0:
            yield None
            continue
        part = part[: b - a].reshape(-1)
        if part.device.type == "cpu":
            yield part.contiguous().numpy()
            continue
        t0 = time.perf_counter()
        dst = staging[: part.numel()]
        dst.copy_(part, non_blocking=True)
        torch.cuda.current_stream(part.device).synchronize()
        timer["pull_s"] += time.perf_counter() - t0
        yield dst.numpy()


def save_checkpoint(path: str, state: ModelState, level: int = 3,
                    extra: dict | None = None, mesh=None, n_feats: int = 0) -> dict:
    """Stream a full-state checkpoint to zstd at `level`
    (ftrl_ffm_tpu/io/checkpoint.py::save_checkpoint).  The tables may lie
    on the card or the CPU.  With `mesh` (parallel/mesh.py::Mesh), `state`
    is this rank's shard: the tables' n_feats logical rows are gathered to
    rank 0 a chunk at a time (_logical_row_chunks) and rank 0 writes the
    file, the bytes a one-device save of the logical state writes; the
    ranks of rank 0's model group join the gathers, the others return at
    once.  Returns the write's seconds (pull_s: off the card; compress_s:
    compression and the file writes; fsync_s) and its raw and file bytes
    (an empty dict on the ranks that do not write)."""
    if mesh is not None and mesh.data_index != 0:
        return {}
    meta = {"fields": [], "extra": extra or {}}
    tables = []
    for name, val in state._asdict().items():
        if val is None:
            meta["fields"].append({"name": name, "none": True})
            continue
        if val.dtype not in _DTYPE_NAMES:
            raise IncompatibleStateError(
                f"state field {name} is {val.dtype}: checkpoints hold float32 "
                f"and bfloat16 tables and an int32 step"
            )
        shape = list(val.shape)
        if mesh is not None and name in _TABLES:
            shape[0] = n_feats
        meta["fields"].append({"name": name, "dtype": _DTYPE_NAMES[val.dtype], "shape": shape})
        tables.append((name, val, int(np.prod(shape)) * val.element_size()))
    header = json.dumps(meta).encode()
    staging = None
    if any(t.device.type == "cuda" for _, t, _ in tables):
        big = max(nbytes for _, _, nbytes in tables)
        staging = torch.empty(min(big, CHUNK_BYTES), dtype=torch.uint8, pin_memory=True)
    stats = {"pull_s": 0.0, "compress_s": 0.0, "fsync_s": 0.0,
             "raw_bytes": 12 + len(header) + sum(nbytes for _, _, nbytes in tables)}
    if mesh is not None and mesh.rank != 0:
        # join the gathers of rank 0's model group; rank 0 writes
        for name, t, _ in tables:
            if name in _TABLES:
                for _ in _logical_row_chunks(t, mesh, n_feats, staging, stats):
                    pass
        return {}

    def slabs(name, t):
        if mesh is not None and name in _TABLES:
            return _logical_row_chunks(t, mesh, n_feats, staging, stats)
        return _host_slabs(t, staging, stats)
    # crash-atomic: compress into a sibling temp file, fsync, then rename —
    # a crash mid-write leaves the previous checkpoint intact (at worst a
    # stray .tmp file), never a truncated checkpoint at `path`
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            with zstd.Compressor(f, level) as zf:
                zf.write(MAGIC + struct.pack("<I", len(header)) + header)
                for name, t, _ in tables:
                    for slab in slabs(name, t):
                        t0 = time.perf_counter()
                        zf.write(slab)
                        stats["compress_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                zf.end()
                stats["compress_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            f.flush()
            os.fsync(f.fileno())
            stats["fsync_s"] = time.perf_counter() - t0
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    stats["file_bytes"] = os.path.getsize(path)
    return stats


def load_checkpoint(path: str) -> tuple[ModelState, dict]:
    """Stream-read a checkpoint: each table decompresses straight into its
    host buffer.  Returns (ModelState, header extra): float32 and int32
    fields as numpy arrays, a bfloat16 field (read as its int16 bits) as a
    torch.bfloat16 CPU tensor; `state_from_jax_arrays` places it on a
    device."""
    with open(path, "rb") as f, zstd.Reader(f) as zf:
        head = zf.read(12)
        if head[:8] != MAGIC:
            raise ValueError(f"{path}: not a ftrl_ffm_tpu checkpoint")
        hlen = struct.unpack("<I", head[8:12])[0]
        meta = json.loads(zf.read(hlen))
        kwargs = {}
        for fld in meta["fields"]:
            if fld.get("none"):
                kwargs[fld["name"]] = None
                continue
            bf16 = fld["dtype"] == "bfloat16"
            arr = np.empty(tuple(fld["shape"]), np.int16 if bf16 else np.dtype(fld["dtype"]))
            view = arr.reshape(-1).view(np.uint8)
            if zf.readinto(view) < view.nbytes:
                raise ValueError(f"{path}: truncated checkpoint")
            kwargs[fld["name"]] = torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr
    return ModelState(**kwargs), meta["extra"]


_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
}


def _to_tensor(name: str, a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor.  A bfloat16 array (ml_dtypes' numpy
    type, found by its name so that ml_dtypes need not be importable here)
    crosses bit for bit: its bits as int16, viewed as torch.bfloat16."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16
        )
    if a.dtype not in _TORCH_DTYPES:
        raise IncompatibleStateError(
            f"state field {name} is {a.dtype}: the PyTorch port takes "
            f"float32 and bfloat16 tables and an int32 step"
        )
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy()  # JAX hands out read-only views
    return torch.from_numpy(a)


def state_from_jax_arrays(state, device) -> ModelState:
    """Carry a state across from the JAX package or from load_checkpoint:
    each field of `state` (a ModelState of either package, or anything with
    the same field names, holding numpy arrays, JAX arrays, tensors or
    None) becomes a tensor on `device`.
    The port takes float32 and bfloat16 tables (a table_dtype=bfloat16
    vec_w) and an int32 step."""
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    out = {}
    for name in ModelState._fields:
        a = fields[name]
        if a is None:
            out[name] = None
        elif isinstance(a, torch.Tensor):
            if a.dtype not in _DTYPE_NAMES:
                raise IncompatibleStateError(
                    f"state field {name} is {a.dtype}: the PyTorch port takes "
                    f"float32 and bfloat16 tables and an int32 step"
                )
            out[name] = a.to(device)
        else:
            out[name] = _to_tensor(name, np.asarray(a)).to(device)
    return ModelState(**out)


# ------------------------------------------- reference-compatible weight blob
def _f32_host(x) -> np.ndarray:
    """A weight table (tensor on any device, numpy array or number) as a
    contiguous little-endian float32 host array (a bf16 table widens
    exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().contiguous().numpy()
    return np.ascontiguousarray(np.asarray(x, "<f4"))


def export_reference_model(path: str, bias, lin_w, vec_w=None, level: int = 3):
    """Write [bias, lin_w..., vec_w...] float32, zstd, no framing — readable
    by the reference's load_compressed_model and by import_reference_model
    of either package.  The frame records its content size, as a one-shot
    compress does."""
    parts = [np.array([float(bias)], "<f4"), _f32_host(lin_w).reshape(-1)]
    if vec_w is not None:
        parts.append(_f32_host(vec_w).reshape(-1))
    raw = sum(p.nbytes for p in parts)
    with open(path, "wb") as f:
        with zstd.Compressor(f, level, size=raw) as zf:
            for p in parts:
                zf.write(p)
            zf.end()
    # stderr: stdout may be carrying the --predict_output - probability
    # stream (cli.py's one-probability-per-line contract)
    print(f"compress file size: {raw} -> {os.path.getsize(path)}", file=sys.stderr)


def import_reference_model(path: str, n_feats: int, row_width: int = 0):
    """Read a reference compressed model -> (bias, lin_w[, vec_w]) as host
    float32 arrays (ftrl_ffm_tpu/io/checkpoint.py::import_reference_model).

    The blob is unframed (raw [bias, lin_w..., vec_w...] floats,
    reference: src/model/ffm.cpp:138-159), so the only consistency check
    possible is the exact float count: a silent slice of a mismatched blob
    would scramble every weight past the first table."""
    with open(path, "rb") as f:
        raw = zstd.decompress(f.read())
    flat = np.frombuffer(raw, "<f4")
    expect = 1 + n_feats + n_feats * row_width
    if flat.size != expect:
        raise IncompatibleStateError(
            f"{path}: reference model blob holds {flat.size} floats, but "
            f"the config (n_feats={n_feats}, factor row width {row_width}) "
            f"expects exactly {expect} (1 bias + n_feats linear"
            + (f" + n_feats*{row_width} factors" if row_width else "")
            + ") — wrong --n_feats/--n_fields/--n_factors/--model_type for "
            "this blob?"
        )
    bias = float(flat[0])
    lin_w = flat[1 : 1 + n_feats].copy()
    vec_w = None
    if row_width:
        vec_w = flat[1 + n_feats :].reshape(n_feats, row_width).copy()
    return bias, lin_w, vec_w


# --------------------------------------------------- FFM plain-text format
def export_reference_text_model(path: str, bias, lin_w, vec_w):
    """FFM text layout: bias line, one lin_w per line, one factor row per
    line (reference: src/model/ffm.cpp:161-177).  Each value is
    str(float(x)) of its float32, as the JAX package writes it, so both
    write the same bytes."""
    with open(path, "w") as f:
        f.write(f"{float(bias)}\n")
        f.writelines(f"{w}\n" for w in _f32_host(lin_w).reshape(-1).astype(np.float64).tolist())
        for row in _f32_host(vec_w).astype(np.float64).tolist():
            f.write(" ".join(map(str, row)) + "\n")


def import_reference_text_model(path: str, n_feats: int, row_width: int):
    """Read the FFM plain-text layout (reference: src/model/ffm.cpp:179-200;
    ftrl_ffm_tpu/io/checkpoint.py::import_reference_text_model).

    Validated like the blob import: line counts and factor-row widths must
    match the config exactly, with a named error instead of float('')."""
    with open(path, "r") as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    expect = 1 + 2 * n_feats
    if len(lines) != expect:
        raise IncompatibleStateError(
            f"{path}: FFM text model has {len(lines)} lines, but the config "
            f"(n_feats={n_feats}) expects exactly {expect} "
            f"(1 bias + n_feats linear + n_feats factor rows)"
        )
    try:
        bias = float(lines[0])
        lin_w = np.array(lines[1 : 1 + n_feats], np.float32)
        rows = [np.array(row.split(), np.float32) for row in lines[1 + n_feats :]]
        widths = {r.shape[0] for r in rows}
        if len(widths) > 1:
            raise IncompatibleStateError(
                f"{path}: ragged factor rows (widths {sorted(widths)})"
            )
        vec_w = np.stack(rows)
    except IncompatibleStateError:
        raise
    except ValueError as e:
        raise IncompatibleStateError(f"{path}: malformed number: {e}") from e
    if vec_w.shape[-1] != row_width:
        # exact match only: a wider import would otherwise silently drop
        # factor lanes (e.g. a k=8 model warm-started under k=4)
        raise IncompatibleStateError(
            f"{path}: factor rows have {vec_w.shape[-1]} values, but the "
            f"config (n_fields * n_factors) expects exactly {row_width}"
        )
    return bias, lin_w, vec_w
