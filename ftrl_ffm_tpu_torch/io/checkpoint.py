"""Full-checkpoint reading (the serving subset of
ftrl_ffm_tpu/io/checkpoint.py).

Reads the same `FTRLTPU1` bytes the JAX package writes: the magic, a
little-endian u32 header length, a JSON header, then each ModelState field's
raw array, all in one zstd stream.  `zstandard` and `ml_dtypes` are imported
inside the functions that need them, so the rest of the port runs where they
are missing.  Writing checkpoints and the reference-format blobs arrives
with ROADMAP.md Queue 1 item 3.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

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


def load_checkpoint(path: str) -> tuple[ModelState, dict]:
    """Stream-read a checkpoint into host numpy arrays (each table
    decompresses straight into its buffer).  Returns (ModelState of numpy
    arrays, header extra); `state_from_jax_arrays` places it on a device."""
    import ml_dtypes  # noqa: F401  registers bfloat16 with numpy
    import zstandard

    dctx = zstandard.ZstdDecompressor()
    with open(path, "rb") as f, dctx.stream_reader(f) as zf:
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
            arr = np.empty(tuple(fld["shape"]), dtype=np.dtype(fld["dtype"]))
            view = arr.reshape(-1).view(np.uint8)
            got = zf.readinto(view)
            while got < view.nbytes:
                n = zf.readinto(view[got:])
                if not n:
                    raise ValueError(f"{path}: truncated checkpoint")
                got += n
            kwargs[fld["name"]] = arr
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
    """Carry a state across from the JAX package: each field of `state`
    (a ModelState of either package, or anything with the same field names,
    holding numpy arrays, JAX arrays or None) becomes a tensor on `device`.
    The port takes float32 and bfloat16 tables (a table_dtype=bfloat16
    vec_w) and an int32 step."""
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    out = {}
    for name in ModelState._fields:
        a = fields[name]
        out[name] = None if a is None else _to_tensor(name, np.asarray(a)).to(device)
    return ModelState(**out)
