"""Headline benchmark of the PyTorch port: FFM (k=16) training throughput
at Criteo scale on one card (the twin of bench.py).

    python -m ftrl_ffm_tpu_torch.bench [--device cpu] [--data PATH]

Prints ONE JSON line with bench.py's keys:
  {"metric": ..., "value": N, "unit": "examples/s", "vs_baseline": N,
   "baseline_note": ..., "runs": [...], "device_cache": ...}
and three of its own: "batch" (the effective batch size), "device" (the
card's name and power limit, as nvidia-smi prints them; "cpu" on the
CPU) and "launches" (the kernel launches of the three timed epochs, by
wrapper: kernel #2 and the update kernel once a step on this workload).

Workload (bench.py's): synthetic Criteo-shaped libffm data, 400k samples,
39 fields, one feature per field, 100k feature ids (ensure_data: the same
generator, seed and file, so both benchmarks read the same bytes),
trained with FFM n_factors=16, FTRL defaults, online, n_epochs=4 (so
device_cache=auto replays the device-resident dataset), max_nnz=39,
n_threads=3.  Protocol: one warm-up train_epoch(), then the best of 3,
each epoch closed by torch.cuda.synchronize.

There is no fallback: a kernel that fails to build or launch raises and
the run exits non-zero (bench.py's retry on its XLA path has no
counterpart; use_pallas=off raises in the port).

Baseline: the reference C++ binary (massquantity/Ftrl-FFM, -O3) on the
4 CPU threads of the host it was measured on, same data and config
(BASELINE.md "measured" section); the ratio carries the baseline's date.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np

# Measured reference baseline (examples/s), copied from bench.py: the
# reference binary on 4 threads, FFM k=16, the same 400k-example data
# (best epoch: 400000 / 39.1641 s), measured 2026-08-16.
BASELINE_EXAMPLES_PER_S = 10213.0
BASELINE_DATE = "2026-08-16"

N_SAMPLES = 400_000
N_FIELDS = 39
N_FEATS = 100_000
N_FACTORS = 16
BATCH = int(os.environ.get("FTRL_BENCH_BATCH", "16384"))
# bench.py's path under the system's temporary directory (/tmp unless
# TMPDIR says otherwise): both benchmarks share the file
DATA_PATH = os.path.join(tempfile.gettempdir(), "ftrl_ffm_tpu_bench_data_400k.txt")
METRIC = "ffm_k16_criteo_scale_online_train_throughput"


def ensure_data(path: str = DATA_PATH) -> str:
    """Deterministic synthetic Criteo-shaped libffm file (bench.py::
    ensure_data's generator, byte for byte)."""
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return path
    rng = np.random.default_rng(7)
    per = N_FEATS // N_FIELDS
    ids = rng.integers(0, per, (N_SAMPLES, N_FIELDS)) + np.arange(N_FIELDS) * per
    w = rng.normal(0, 0.3, N_FEATS)
    logit = w[ids].sum(axis=1) + rng.normal(0, 1, N_SAMPLES)
    y = (logit > 0).astype(int)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for i in range(N_SAMPLES):
            toks = [str(y[i])] + [f"{c}:{ids[i, c]}:1" for c in range(N_FIELDS)]
            f.write(" ".join(toks) + "\n")
    os.replace(tmp, path)
    return path


def make_config(path: str, device: str = "cuda", **overrides):
    """bench.py's Config on `device` (overrides: any other field, e.g. a
    table dtype for a variant cell)."""
    from ftrl_ffm_tpu_torch.config import Config

    kw = dict(
        train_data=path,
        model_type="FFM",
        n_fields=N_FIELDS,
        n_feats=N_FEATS,
        n_factors=N_FACTORS,
        online=True,
        # a 4-epoch run (1 warm-up + 3 timed): device_cache=auto's online
        # replay gate (n_epochs > 1) sees the truth, and epochs 2+ replay
        # the resident dataset in file order
        n_epochs=4,
        batch_size=BATCH,
        max_nnz=N_FIELDS,
        n_threads=3,
        device=device,
    )
    kw.update(overrides)
    return Config(**kw)


def run(cfg, state=None, trainer=None) -> dict:
    """bench.py's protocol on a Trainer of `cfg` (a fresh seeded init, or
    `state`; or `trainer`, built by a caller that shares a resident dataset
    between Trainers), whose data holds N_SAMPLES rows: one warm-up train_epoch(),
    then 3 timed ones, each closed by a device synchronize.  Returns bench.py's JSON keys plus "batch", "device", "launches", and,
    for callers that check more: "losses" (the 4 epochs' mean losses),
    "times" (the timed epochs' seconds), "build_s" (the resident dataset's
    parse and upload), "warmup_s" (that and the warm-up epoch), "steps",
    "counts" (every launch count, by instance and dtype too, of the timed
    epochs) and "trainer"."""
    from ftrl_ffm_tpu_torch.tools import (
        card_name,
        read_launch_counts,
        reset_launch_counts,
        synchronize,
    )
    from ftrl_ffm_tpu_torch.train import Trainer

    if trainer is None:
        trainer = Trainer(cfg, state=state)
    device = trainer.device
    # the resident dataset's parse and upload (where one engages), then the
    # warm-up epoch: the kernels' build and load (excluded, as the
    # reference's per-epoch timer excludes its init)
    t0 = time.perf_counter()
    trainer._fresh_cache("train")
    synchronize(device)
    build_s = time.perf_counter() - t0
    losses = [trainer.train_epoch()]
    synchronize(device)
    warmup_s = time.perf_counter() - t0
    reset_launch_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch())
        synchronize(device)
        times.append(time.perf_counter() - t0)
    counts = read_launch_counts()
    eps = N_SAMPLES / min(times)
    return {
        "metric": METRIC,
        "value": round(eps, 1),
        "unit": "examples/s",
        "vs_baseline": round(eps / BASELINE_EXAMPLES_PER_S, 3),
        "baseline_note": (
            "C++ reference, 4 threads (all cores of this host), "
            f"measured {BASELINE_DATE}"
        ),
        "runs": [round(N_SAMPLES / t, 1) for t in times],
        "device_cache": trainer._dev_cache.get("train") is not None,
        "batch": cfg.batch_size,
        "device": card_name(device),
        "launches": {k: v for k, v in counts.items() if isinstance(v, int)},
        "losses": losses,
        "times": times,
        "build_s": build_s,
        "warmup_s": warmup_s,
        "steps": trainer._steps_done,
        "counts": counts,
        "trainer": trainer,
    }


# the keys of the printed line: bench.py's, then the port's three
PRINTED = ("metric", "value", "unit", "vs_baseline", "baseline_note", "runs",
           "device_cache", "batch", "device", "launches")


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain versions)")
    ap.add_argument("--data", default=DATA_PATH,
                    help="the data file, written by ensure_data when absent")
    args = ap.parse_args(argv)
    cfg = make_config(ensure_data(args.data), args.device)
    res = run(cfg)
    line = {k: res[k] for k in PRINTED}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
