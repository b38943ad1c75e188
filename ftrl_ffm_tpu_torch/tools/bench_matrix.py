"""End-to-end benchmark matrix of the PyTorch port (the twin of
tools/bench_matrix.py).

Each row is a full Trainer run (host parse, upload or device-resident
replay, the card's kernels) on synthetic Criteo-shaped data, timed like
bench.py: the best epoch of 2 after a warm-up epoch, each closed by
torch.cuda.synchronize.  Rows run in a subprocess each, as in the JAX
tool:

    python -m ftrl_ffm_tpu_torch.tools.bench_matrix [row ...] [--device cpu]

rows (default: ffm fm lr):
    ffm      FFM k=16, 100k feats, online        (the bench.py headline)
    fm       FM k=16, online
    lr       LR, online
    ffm1m    FFM k=16, 1M feature rows, online   (the huge table)
    offline  FFM k=16, offline (in-memory, shuffled)
    eval     FFM k=16 eval/serving throughput (kernel #1)
    zipf     FFM k=16 on Zipf(s=1.1)-skewed ids  (hot-key CTR data; also
             reports the dedup ratio and the delta-encode hit rate)
    numeric  FFM k=16 with one real-valued field
    noncanon FFM k=16 on fully non-canonical data: fractional values,
             variable nnz (short lines pad, long ones truncate with the
             loader's warning), shuffled token order
Each prints one JSON line with the JAX tool's keys ("row",
"examples_per_s", "train_loss" or "eval_loss", "device_cache", and for the
non-uniform variants "dedup_ratio", "delta_hit_rate", "vals_upload",
"feats_upload") plus "device" (the card's name and power limit, as
nvidia-smi prints them), "update_kind" (the factor tables' kind: None
for LR) and, beside the two upload keys, "upload_bytes".  The three report
what the port uploads: a streamed row's first batch in its transfer-tier
form (Trainer._compact, as the JAX tool reports it: "ones-marker", int8,
bfloat16, uint8 for DEC6 values; uint16 ids), or the resident dataset's
stored form ("ones-marker" for values that are all 1, uint8 under the
compact form) and its bytes a row.

Env: ROWS_SAMPLES (400000), ACC_DTYPE, TABLE_DTYPE, DEVICE_CACHE,
DEVICE_CACHE_COMPACT and FEED_WORKERS forwarded to Config as in the JAX
tool (FEED_WORKERS sets the streamed rows' feeder threads; the result
is the same at every count); the port's own:
UPDATE_MODE (auto; "inplace" or "dense" to time both kinds) and N_FEATS
(the row's table size in place of its 100k or 1M).  Data files go to the
system's temporary directory under the JAX tool's names, so both tools
share them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

N_SAMPLES = int(os.environ.get("ROWS_SAMPLES", 400_000))
N_FIELDS = 39
ROWS = ("ffm", "fm", "lr", "ffm1m", "offline", "eval", "zipf", "numeric", "noncanon")


def data_path(n_feats: int, variant: str = "uniform") -> str:
    """The JAX tool's file name for a variant, under the temporary
    directory."""
    name = f"ftrl_ffm_tpu_bench_{N_SAMPLES}_{n_feats}_{variant}.txt"
    if variant == "uniform":  # the JAX tool keeps its round-1/2 cache name
        name = f"ftrl_ffm_tpu_bench_{N_SAMPLES}_{n_feats}.txt"
    return os.path.join(tempfile.gettempdir(), name)


def ensure_data(n_feats: int, variant: str = "uniform") -> str:
    """Synthetic Criteo-shaped libffm data (tools/bench_matrix.py::
    ensure_data's generator, byte for byte).  Variants:
    uniform — one uniform-random feature per field, all values 1.0;
    zipf    — Zipf(s=1.1)-skewed ids within each field's vocab;
    numeric — field 0 carries a real-valued feature;
    noncanon — variable nnz (8..60), fractional values, shuffled fields.
    """
    path = data_path(n_feats, variant)
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return path
    rng = np.random.default_rng(7)
    per = n_feats // N_FIELDS
    if variant == "zipf":
        ranks = rng.zipf(1.1, (N_SAMPLES, N_FIELDS))
        ids = np.minimum(ranks - 1, per - 1) + np.arange(N_FIELDS) * per
    else:
        ids = (
            rng.integers(0, per, (N_SAMPLES, N_FIELDS))
            + np.arange(N_FIELDS) * per
        )
    w = rng.normal(0, 0.3, n_feats)
    logit = w[ids].sum(axis=1) + rng.normal(0, 1, N_SAMPLES)
    y = (logit > 0).astype(int)
    numeric = (
        rng.random(N_SAMPLES).round(6) if variant == "numeric" else None
    )
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        if variant == "noncanon":
            for i in range(N_SAMPLES):
                nnz = int(rng.integers(8, 61))
                fs = (
                    rng.permutation(N_FIELDS)[:nnz]
                    if nnz <= N_FIELDS
                    else rng.integers(0, N_FIELDS, nnz)
                )
                toks = [str(y[i])] + [
                    f"{c}:{int(c) * per + int(rng.integers(0, per))}"
                    f":{rng.random() * 0.95 + 0.05:.6f}"
                    for c in fs
                ]
                f.write(" ".join(toks) + "\n")
        else:
            for i in range(N_SAMPLES):
                toks = [str(y[i])] + [
                    f"{c}:{ids[i, c]}:1" for c in range(N_FIELDS)
                ]
                if numeric is not None:
                    # zero values are dropped by the parse, so floor at 1e-6
                    toks[1] = f"0:{ids[i, 0]}:{max(numeric[i], 1e-6):.6f}"
                f.write(" ".join(toks) + "\n")
    os.replace(tmp, path)
    return path


def data_stats(path: str, batch: int = 8192) -> dict:
    """Host-side realism metrics over the first 16 batches: the dedup
    ratio (unique ids / occurrences a batch) and the delta-encode hit rate
    (batches whose per-column id ranges fit uint16), as the JAX tool
    computes them, over the port's StreamReader."""
    from ftrl_ffm_tpu_torch.data.stream import StreamReader

    reader = StreamReader(path, "libffm", batch, N_FIELDS, 10**9, N_FIELDS,
                          log_every=0)
    uniq_ratios, delta_hits, n = [], 0, 0
    for arrays in reader.batches():
        feats = arrays[1]
        uniq_ratios.append(np.unique(feats).size / feats.size)
        lo = feats.min(axis=0)
        hi = feats.max(axis=0)
        delta_hits += bool(((hi - lo) <= 65534).all())
        n += 1
        if n >= 16:
            break
    return {
        "dedup_ratio": round(float(np.mean(uniq_ratios)), 4),
        "delta_hit_rate": round(delta_hits / max(n, 1), 4),
    }


def row_config(row: str, device: str = "cuda"):
    """The row's Config: the JAX tool's, on `device`, with the env."""
    from ftrl_ffm_tpu_torch.config import Config

    n_feats = int(os.environ.get("N_FEATS", 1_000_000 if row == "ffm1m" else 100_000))
    variant = row if row in ("zipf", "numeric", "noncanon") else "uniform"
    path = ensure_data(n_feats, variant)
    kw = dict(
        train_data=path,
        model_type={"fm": "FM", "lr": "LR"}.get(row, "FFM"),
        n_fields=N_FIELDS,
        n_feats=n_feats,
        n_factors=16,
        online=row != "offline",
        n_epochs=1,
        batch_size=16384 if row in ("ffm", "ffm1m", "offline") else 8192,
        max_nnz=N_FIELDS,
        n_threads=3,
        acc_dtype=os.environ.get("ACC_DTYPE", "float32"),
        table_dtype=os.environ.get("TABLE_DTYPE", "float32"),
        device_cache=os.environ.get("DEVICE_CACHE", "auto"),
        device_cache_compact=os.environ.get("DEVICE_CACHE_COMPACT", "auto"),
        feed_workers=int(os.environ.get("FEED_WORKERS", "1")),
        update_mode=os.environ.get("UPDATE_MODE", "auto"),
        device=device,
    )
    if kw["model_type"] == "FFM":
        kw["file_type"] = "libffm"
    return Config(**kw), variant


def _uploads(trainer) -> tuple[str, str, int]:
    """(vals_upload, feats_upload, upload_bytes): the forms the port moves
    to the card, and their bytes (a streamed batch's, or a resident row's)."""
    from ftrl_ffm_tpu_torch.transfer import describe_upload, nbytes

    cache = trainer._dev_cache.get("train")
    if cache is not None:
        vals, feats = cache.ds[2], cache.ds[1]
        marker = vals.shape[0] == 0
        rows = feats.shape[0]
        return ("ones-marker" if marker else str(vals.dtype).removeprefix("torch."),
                str(feats.dtype).removeprefix("torch."),
                nbytes(t for t in cache.ds if t.shape[0]) // rows)
    arrays = next(iter(trainer._train_batches(np.random.default_rng(0))))
    up = trainer._compact(arrays, "train")
    tiers, size = describe_upload(up)
    return ("ones-marker" if "ones" in tiers else str(up[2].dtype).removeprefix("torch."),
            str(up[1].dtype), size)


def run_row(row: str, device: str = "cuda") -> dict:
    from ftrl_ffm_tpu_torch.tools import card_name, synchronize
    from ftrl_ffm_tpu_torch.tools.profile_step import update_kind
    from ftrl_ffm_tpu_torch.train import Trainer

    cfg, variant = row_config(row, device)
    path = cfg.train_data
    trainer = Trainer(cfg)
    dev = trainer.device
    trainer.train_epoch()  # warm-up: the kernels' build and load
    synchronize(dev)
    cache = trainer._dev_cache.get("train")
    cache_tag = cache.layout if cache is not None else "streamed"
    extra = {"device": card_name(dev),
             "update_kind": update_kind(cfg) if cfg.row_width else None}

    if row == "eval":
        trainer.cfg.eval_data = path
        trainer.evaluate()  # warm-up
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            loss, auc = trainer.evaluate()
            synchronize(dev)
            times.append(time.perf_counter() - t0)
        ec = trainer._dev_cache.get("eval")
        return {"row": row, "examples_per_s": round(N_SAMPLES / min(times), 1),
                "eval_loss": round(loss, 4),
                "device_cache": ec.layout if ec is not None else "streamed", **extra}

    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        loss = trainer.train_epoch()
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    out = {
        "row": row,
        "examples_per_s": round(N_SAMPLES / min(times), 1),
        "train_loss": round(loss, 4),
        "device_cache": cache_tag,
    }
    if variant != "uniform":
        out.update(data_stats(path))
        out["vals_upload"], out["feats_upload"], out["upload_bytes"] = _uploads(trainer)
    out.update(extra)
    return out


def main(argv: Optional[list[str]] = None, device: str = "cuda") -> list[dict]:
    """Run the rows: one subprocess each when there are several (rows
    contaminate each other in one process: device state and host threads
    left behind), in this process when there is one.  Returns the rows'
    JSON objects."""
    from ftrl_ffm_tpu_torch.tools import split_device

    device, rows = split_device([f"--device={device}", *(argv or [])])
    rows = rows or ["ffm", "fm", "lr"]
    for row in rows:
        if row not in ROWS:
            raise SystemExit(f"unknown row {row!r}; rows: {' '.join(ROWS)}")
    if len(rows) > 1:
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        out = []
        for row in rows:
            proc = subprocess.run(
                [sys.executable, "-m", "ftrl_ffm_tpu_torch.tools.bench_matrix", row,
                 f"--device={device}"],
                check=True, stdout=subprocess.PIPE, text=True, env=env,
            )
            sys.stdout.write(proc.stdout)
            sys.stdout.flush()
            out.append(json.loads([ln for ln in proc.stdout.splitlines()
                                   if ln.startswith("{")][-1]))
        return out
    res = run_row(rows[0], device)
    print(json.dumps(res), flush=True)
    return [res]


if __name__ == "__main__":
    main(sys.argv[1:])
