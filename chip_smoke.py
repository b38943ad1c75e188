"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve,
train, time.

    python3 chip_smoke.py

Drives the port's serving and training paths (ftrl_ffm_tpu_torch) at full
width: FFM with 39 fields (field_pad 40), 16 factors, 640-float
factor-major rows and batches of 16,384 — serving a seeded random state of a
1,000,000-row table, training a fresh 100,000-row one (bench.py's model,
the "dense2" update) and a fresh 1,000,000-row one (the README quick
start's table, the huge-table "inplace" update, forced) — on Criteo-shaped libffm
files; LR and FM (K=16) at bench.py's 100,000 rows and FM at an assumed
hashing-trick table of 2^22 rows (forced "inplace"); then the probes of ftrl_ffm_tpu_torch/tools
(the ports of the TPU probes in tools/micro_*.py) at the TPU probes'
default sizes; then bench.py's protocol from the device-resident dataset.  Phases 4-5 stream
their files (device_cache="off"), phase 7 reads them from device memory.
Phases, each printing its own lines:

  1. no card      -> exit 1 at once, no result printed
  2. build        -> nvcc builds every kernel from csrc/ (build seconds)
  3. kernels      -> the logits kernel against its plain PyTorch version on
                     the same device tensors, at the main path's shape and in
                     a sweep of edge shapes (f32 sums in another order:
                     rtol=1e-4, atol=1e-5), with the instance each shape
                     runs (C'=40, K=16, F <= 40: the persistent c40_k16);
                     on bf16 rows too: bit for bit the f32 launch on the
                     widened rows; the bench shape's second launches
                     bit-identical
  3b. fused       -> the training kernel (logits + payload) against its plain
                     version, the same way (logits rtol=1e-4, atol=1e-5;
                     payload rtol=1e-4, atol=1e-6), combined and split
                     output, with the kernel instance each shape runs; the
                     bench shape runs the C'=40, K=16 instance and a second
                     launch gives the same bits
  3c. update      -> the FTRL update kernel against its plain version on
                     random tables with duplicate and sentinel ids, uniform
                     and skewed (skewed_ids: three hot ids, ~14,500 payload
                     rows each, which take the column-split kernel), in
                     every payload/w dtype pair, with the instance each
                     shape runs: touched rows rtol=1e-5, atol=1e-6 (a bf16
                     payload, and every narrow row of at most 32 columns,
                     bit for bit under ordered sums), untouched rows
                     bit-identical, the same call twice bit-identical
  3d. scatter     -> the z/A scatter against its plain version bit for bit
                     under ordered sums, with the instance each shape runs,
                     on uniform ids and on hot ones (skewed_ids at the 1M
                     shape, Zipf ids at FM's: za_scatter_hot); untouched z
                     bit-identical, untouched A exactly 0, repeats
                     bit-identical
  3e. pass        -> the closed-form pass (kernel #3) against its plain
                     version at R=1M, E=640 and edge shapes: rtol=1e-6,
                     atol=1e-7; coordinates with A = 0 keep their n and z
                     bits; the same call twice bit-identical
  3g. LR/FM forms -> in 3c-3e, the same way: the update kernel at FM's
                     E=16 with the linear stats in gg2_lin (lane -1), f32
                     and bf16 w, uniform and skewed ids (ftrl_update_narrow);
                     the scatter (uniform and Zipf ids) and the pass (f32
                     and bf16 w) at [2^22, 16]; and the update kernel with
                     no factor columns (E=0: LR's update, ftrl_update_linear,
                     its "linear" instance) at 100k (uniform, skewed) and
                     2^22 rows (uniform, Zipf) against the plain dense step,
                     bit for bit under ordered sums
  3h. routed      -> a (1, N) route mesh's update under auto at the route
                     cell's shapes (R=2^22, E=640, 319,488 received slots
                     from 4 peers, ~80% empty): ftrl_update on the split
                     payload, one "rows" launch and no pass, against its
                     plain version on the touched rows and the in-place
                     form (za_scatter, kernel #3) it replaces: touched
                     rows rtol=1e-5, atol=1e-6, every other row keeps its
                     bits, a repeat bit-identical; both forms' ms a step
  4. serving      -> Trainer.evaluate() and Trainer.predict_file() with the
                     launch counts set to 0 just before and read just after
                     (every batch on kernel #1's c40_k16 instance; a bf16
                     table's, in 4e, on c40_k16_bf16: its rows reach the
                     kernel unwidened); outputs held against the plain
                     version and a CPU run
  4b. training    -> each TRAIN_CELLS cell (bench.py's FFM model at 100k
                     rows, then LR and FM: 4f) through Trainer(cfg).train()
                     for 2 epochs with eval, the launch counts (by instance
                     and dtype too: every FFM step runs kernel #2's C'=40,
                     K=16 instance, every eval batch kernel #1's) set to 0
                     just before and read just after, against
                     expected_counts; 3 chained train_steps against the same
                     steps on the plain versions, two runs bit-identical;
                     small runs (FFM, and LR from a libsvm file) on the CPU
                     and the card from one init; each cell's device train
                     step by CUDA events (phase 5's part)
  5. timings      -> kernel and plain milliseconds per batch (kernel #1 on
                     f32 and bf16 rows, with its device time from a CUDA
                     graph), eval examples/s, the card's name and power
                     limit beside them
  5b. train time  -> the training kernels and their plain versions (kernel
                     #2's launches by instance; the update kernel also on
                     the skewed batch), the device train step, host parse,
                     train_epoch() examples/s
  4c. 1M training -> the same for the 1M-row table under
                     update_mode=inplace (kernel #3 and the scatter): launch counts, the stale linear
                     tables and their reconcile, chained steps against the
                     plain versions and against update_mode=dense, two runs
                     bit-identical, a small in-place run on the CPU and the
                     card; device memory peaks
  5c. 1M time     -> the pass, the scatter and the split kernel against their
                     plain versions, the device train step under inplace and
                     dense, host parse, train_epoch() examples/s
  4f. LR and FM   -> in 4b's loop: LR and FM cells' launch counts (the
                     update kernel by dtype, the scatter, the pass by dtype;
                     kernels #1 and #2 never), chained steps (2^22, under
                     update_mode=inplace: also against update_mode=dense),
                     evaluate() and predict_file() against a CPU Trainer on
                     the same state
  5e. LR/FM time  -> the update kernel at E=16 (f32, bf16 w) and E=0, the
                     scatter (uniform and Zipf ids) and the pass at
                     [2^22, 16] against their plain versions beside their
                     bounds and the stable sort of the same ids alone (the
                     scatter also beside two index_add_)
  3f. probes      -> after 4c's state is freed: the probe kernels against
                     their plain versions at the probes' default shapes and
                     edge shapes — the no-w pass (rtol=1e-6, atol=1e-7,
                     repeats bit-identical), the canonical-fields FFM kernel
                     (against its plain version and kernel #2: logits
                     rtol=1e-4, atol=1e-5, payload rtol=1e-4, atol=1e-6), the
                     read-modify-write variants and dtypes (bit-identical to
                     the plain version on CPU copies), the gathered sum
                     (1e-5 of the largest |sum|)
  5d. probes' main -> each probe's main(device="cuda") at its defaults, the
                     launch counts set to 0 just before and read just after;
                     then each probe kernel against its plain version and
                     its one-call PyTorch equivalent, beside its bound; each
                     probe kernel (and index_add) also in device time
                     (calls replayed from a CUDA graph, the host's dispatch
                     left out: "device_ms" in their records)
  7. resident     -> the device-resident dataset (Config.device_cache):
                     evaluate() of phase 4's state and rows from device
                     memory (kernel #1's launches; the streamed pass's loss
                     and AUC bit for bit), the DEC6 decode over all 2^24
                     keys against float64, then the bench twin's protocol
                     (ftrl_ffm_tpu_torch/bench.py::run: 400,000 rows of
                     bench.py's generator, online, n_epochs=4, n_threads=3,
                     one warm-up train_epoch() after the build, best of 3)
                     at 100k, 100k-bf16 and 1M rows ("inplace", forced):
                     examples/s, build seconds, device_cache, the launch
                     counts of the timed epochs; the
                     tables bit-identical to a streamed twin's, and at 100k
                     to compact storage's; the offline shuffle's index
                     table against a row uploaded a step; one epoch's step
                     loop under torch.cuda.set_sync_debug_mode("error");
                     the same protocol for LR and FM at 100k and FM at 2^22
                     (update_mode=inplace and dense, on uniform
                     and on Zipf-skewed ids, whose every step has segments
                     over 64 rows; the two kinds' states bit-identical),
                     launches also by kernel instance
  8. checkpoints  -> at bench.py's full width (FFM-100k, 640-float rows,
                     B=16,384, phase 7's 400,000 rows and upload): an epoch
                     with model_path and save_every = its steps (async,
                     zstd level 3), the file against a clone of the state
                     at the save and a fresh Trainer resumed from it
                     against the uninterrupted run, bit for bit; a
                     synchronous save and an async one through the host
                     copy (forced) give the same file; a `checkpoint
                     ffm-100k: {json}` line: each save's inline stall and
                     snapshot path, the writer's pull, compress and fsync
                     seconds, the join's wait, raw and file bytes, load
                     seconds, train_epoch() examples/s with the save and
                     without, the card's name and power limit; the
                     reference blob of 1 + 100k + 100k x 624 floats
                     exported and imported into a fresh card Trainer
                     (lin_w and vec_w bit for bit, the bias within rtol
                     1e-6, lane 39 = lin_w; the text form at 2,000 rows);
                     LR-100k, FM-100k and FFM-100k-bf16 round trips bit
                     for bit; one async write of phase 7's 1M "inplace"
                     state (7.7 GB, level 1), its linear tables against the
                     mirror lane, where 20 GB are free
  10. multi-step  -> steps_per_call=S>1 (CUDA-graph groups) on phase 7's
                     resident datasets through the bench twin's config:
                     LR-100k, FM-100k and FM-2^22 "dense" (S=4, 8), FM-2^22
                     "inplace" on Zipf ids, FFM-100k, -bf16 and 1M
                     "inplace" (S=4; LR and FFM-100k also S=5, which
                     divides the 25 steps: no inert step) against
                     S=1 from one init: 2 epochs and an eval pass
                     bit-identical, launches by kernel instance
                     ceil(25/S)*S an epoch, every group after the first of
                     its kind a replay, peak memory above the state; the
                     bench twin's run protocol (examples/s, S=1 beside);
                     streamed FFM-100k epochs through the feeder
                     (feed_workers 1 with the transfer tiers on and off,
                     2, and 2 at S=4, whose second epoch captures nothing
                     new) bit-identical to the resident one, with their
                     bytes a batch and tiers; a state swap captured again
                     and equal to an eager run; one replayed epoch under
                     set_sync_debug_mode("error"); then a traced epoch
                     each (idle share; the streamed ones' H2D ms a batch)
  10b. tiers      -> the transfer tiers phase 10's file does not reach
                     (split ids, DEC6 values, packed fields) on a small
                     streamed file at bench.py's width: an epoch, eval and
                     predict_file with the tiers on and off bit for bit,
                     each batch's tiers counted; the DEC6 probe passes on
                     the card; widen_batch's device time a batch
  6. profiles     -> after every timed phase (a profiler run may slow the
                     host's side for the rest of the process): the
                     torch.profiler breakdown by kernel of the train steps
                     of 5b and 5c, LR and FM's steps by part (gather, the
                     plain PyTorch ops with their largest, sort, update
                     kernel, scatter, fills, pass), and one traced
                     train_epoch() per training cell, streamed and
                     resident: the device's
                     busy time (kernels, copies, fills) over the traced
                     epoch's wall time
  9. tools        -> the measurement tools through their entry points, each
                     in a process of its own, its exit code and output
                     checked: `python -m ftrl_ffm_tpu_torch.bench` on phase
                     7's file (75 launches each of kernel #2 and the update
                     kernel in its timed epochs); bench_matrix's nine rows
                     at ROWS_SAMPLES=65536, ffm1m under update_mode inplace
                     and dense; profile_step cuda, infer, huge and trace
                     (huge under both kinds, beside its roofline floor);
                     roofline of the 100k "dense2" and 1M "inplace" steps;
                     micro_scatter at its defaults; the matrix's numeric
                     and noncanon files timed and traced here with the
                     transfer tiers on and off (examples/s, idle share,
                     bytes and H2D ms a batch, the same bits); the
                     pandas-free data generator on a csv, and FFM on its
                     output (DEC6 values, the same bits on and off); then
                     one CLI training run with --profile_dir, whose trace
                     names kernel #2 and the update kernel

  11. mesh        -> last: bench.py's FFM-100k model through the CLI's
                     three multi-process flags (--mesh_data 0: a world-size-1
                     NCCL group), 2 epochs from phase 7's file with the
                     replicate-layout resident dataset and eval, a
                     checkpoint and predict_file, in a process of its own:
                     the history, the checkpoint's tables and the
                     predictions bit for bit the one-card Trainer's from the
                     same init; launches (kernel #2 and #1 on c40_k16, the
                     update kernel on "rows") and collectives (one
                     all_reduce a step and an eval batch) counted; examples/s
                     beside the one-card Trainer's; the same at
                     --steps_per_call 5 (x1's bits, the groups captured
                     with their NCCL all_reduce and replayed, collectives
                     and launches counted per replay) and from the shard
                     layout built by hand (the replicate run's bits);
                     profile_step's sharded phase beside its cuda phase and
                     bench_multichip on the 1x1 mesh; where more than one
                     card is visible (mesh_cards_phase), (N, 1), (1, N)
                     route under auto and in place, and (2, 2) meshes of N
                     NCCL ranks from the shard layout against the streamed
                     run of the same shape, bit for bit, each routed
                     update's form from its own launches and counters (auto:
                     one "rows" update a step, no kernel #3), with epoch
                     1's device idle share and NCCL kernel time

Each phase prints its seconds ("phase <name>: <s> s") as the next starts.

Every kernel's record carries its bound: the larger of the bytes it must
move (each input read once, each output written once) over the H100's
3.35 TB/s and its operations over the 67 TFLOP/s of f32 outside the tensor
cores (NVIDIA's data sheet, SXM part, at 700 W).

Any failure raises and ends the run with a non-zero code.  The next-to-last
line is the kernels' JSON record, the last line the device record.  It
imports nothing of JAX: the port is the program under test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FIELDS = 39
N_FACTORS = 16
N_FEATS = 1_000_000
BATCH = 16384
N_ROWS = 8 * BATCH  # 131,072 eval or train rows: 8 batches per pass
TRAIN_FEATS = 100_000  # bench.py's table
HASH_FEATS = 1 << 22  # 4,194,304: an assumed hashing-trick table size (FM's big cell)
BENCH_ROWS = 400_000  # bench.py::ensure_data's rows
RTOL, ATOL = 1e-4, 1e-5  # kernel against plain: f32 sums in another order
GRAD_ATOL = 1e-6  # payload: the JAX suite's kernel-vs-XLA bound
UPD_RTOL, UPD_ATOL = 1e-5, 1e-6  # update kernel against plain, touched rows
# the closed-form pass against plain: the same operations, each rounded on
# its own (the JAX suite's Pallas-vs-XLA bound, tests/test_ffm_pallas.py)
PASS_RTOL, PASS_ATOL = 1e-6, 1e-7
# chained train steps, kernels against plain versions: ulp noise compounds
# through the closed form's |z| <= l1 threshold (the JAX suite's bound)
CHAIN_RTOL, CHAIN_ATOL = 2e-3, 5e-5
# a bf16 table's w, chained: one bf16 ulp, relative
BF16_RTOL = 2.0 ** -7
# the probes' gathered sum: f32 sums in another order, relative to its scale
GATHER_RTOL = 1e-5
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate
F32_OPS_PER_S = 67e12      # H100 SXM peak f32 rate outside the tensor cores
# the environment the probes read (ftrl_ffm_tpu_torch/tools): 5d runs them
# at their defaults
PROBE_ENV = ("BATCH", "N_FEATS", "C", "E", "B", "PER", "BLK", "DTYPE", "NNZ", "E2", "NOTR")


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    `bytes_moved` and do `ops` f32 operations."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def within_bf16_ulp(got, want, atol: float = 0.0) -> bool:
    """Each element within one bf16 ulp of the larger magnitude of the two,
    plus atol (values near 0 whose f32 forms differ by up to atol)."""
    a, b = got.float(), want.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), 0.0)
    return bool(((a - b).abs() <= ulp + atol).all())


def touched_rows(ids, r: int) -> int:
    return int(torch.unique(ids[(ids >= 0) & (ids < r)]).numel())


def offset_copy(t, off: int):
    """t's values `off` floats into a fresh buffer (off = 1: 4 bytes off
    16-byte alignment)."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    buf[off:] = t.reshape(-1)
    return buf[off:].view(t.shape)


def ran_instance(counts: dict, before: dict) -> str:
    """The kernel instance whose launch count rose since `before` (one)."""
    (name,) = {k for k, v in counts.items() if v > before[k]}
    return name


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    from ftrl_ffm_tpu_torch.tools import card_name

    return card_name(torch.device("cuda", torch.cuda.current_device()))


def write_criteo_like(path: str, n_rows: int, n_feats: int, seed: int = 7,
                      zipf: bool = False) -> np.ndarray:
    """Criteo-shaped libffm data: one feature per field, ids spread over the
    table, labels from a random linear model (bench.py::ensure_data's
    generator, at this run's row and id counts; with zipf, the ids of
    tools/bench_matrix.py::ensure_data's "zipf" variant).  Returns the
    [n_rows, N_FIELDS] ids."""
    return write_criteo_split([(path, n_rows)], n_feats, seed, zipf=zipf)


def write_criteo_split(parts, n_feats: int, seed: int = 7, libsvm: bool = False,
                       zipf: bool = False) -> np.ndarray:
    """write_criteo_like's rows, one generator, cut into consecutive files:
    parts = [(path, rows), ...] (train and eval rows of one model); with
    libsvm, the same rows without their fields ("id:1"); with zipf,
    Zipf(s=1.1) ranks within each field's ids, the last id taking the tail.
    Returns the [rows, N_FIELDS] ids of all parts."""
    n_rows = sum(rows for _, rows in parts)
    rng = np.random.default_rng(seed)
    ids = criteo_ids(rng, n_rows, n_feats, zipf)
    w = rng.normal(0, 0.3, n_feats)
    y = (w[ids].sum(axis=1) + rng.normal(0, 1, n_rows) > 0).astype(int)
    start = 0
    for path, rows in parts:
        with open(path, "w") as f:
            for i in range(start, start + rows):
                toks = [str(y[i])] + [f"{ids[i, c]}:1" if libsvm else f"{c}:{ids[i, c]}:1"
                                      for c in range(N_FIELDS)]
                f.write(" ".join(toks) + "\n")
        start += rows
    return ids


def criteo_ids(rng, n_rows: int, n_feats: int, zipf: bool = False) -> np.ndarray:
    """write_criteo_split's [n_rows, N_FIELDS] ids from rng: field c's ids
    in [c * per, (c + 1) * per), per = n_feats // N_FIELDS, uniform or,
    with zipf, Zipf(s=1.1) ranks, the field's last id taking the tail."""
    per = n_feats // N_FIELDS
    if zipf:
        ranks = rng.zipf(1.1, (n_rows, N_FIELDS))
        return np.minimum(ranks - 1, per - 1) + np.arange(N_FIELDS) * per
    return rng.integers(0, per, (n_rows, N_FIELDS)) + np.arange(N_FIELDS) * per


def zipf_ids(n: int, r: int, device, seed: int = 7):
    """[N] int32 payload row ids of N // N_FIELDS samples (row b*N_FIELDS +
    c is sample b's field c, as the trainer lays them out) with Zipf ids
    over r rows: the first batch of write_criteo_split(zipf=True)'s data
    with this seed.  Each field's clamped tail is a segment of thousands
    of rows at B=16,384."""
    ids = criteo_ids(np.random.default_rng(seed), n // N_FIELDS, r, zipf=True)
    return torch.from_numpy(ids.reshape(-1).astype(np.int32)).to(device)


def seeded_state(cfg, device, seed: int):
    """A serving state built on the device from one torch.Generator:
    factor weights N(0, 0.02) on the live lanes, linear weights N(0, 0.1)
    in lin_w and in the mirror lane (k=0, c=n_fields), a nonzero bias."""
    from ftrl_ffm_tpu_torch.models import ModelState

    g = torch.Generator(device=device).manual_seed(seed)
    r, cp, e = cfg.n_feats, cfg.field_pad, cfg.row_width
    vec_w = torch.randn((r, e), generator=g, device=device) * 0.02
    live = torch.arange(e, device=device) % cp < cfg.n_fields
    vec_w *= live
    lin_w = torch.randn((r,), generator=g, device=device) * 0.1
    vec_w[:, cfg.n_fields] = lin_w
    zeros = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return ModelState(
        bias_n=zeros(),
        # bias weight = closed form at n=0: -(z + l1) / (l2 + beta/alpha)
        bias_z=torch.tensor(-500.0, device=device),
        lin_n=zeros(r), lin_z=zeros(r), lin_w=lin_w,
        vec_n=zeros(r, e), vec_z=zeros(r, e), vec_w=vec_w,
        step=torch.tensor(1, dtype=torch.int32, device=device),
    )


def kernel_inputs(b, f, cp, k, gen, device, fields="iota", n_real=None, pad=True):
    """Device inputs of ffm_fused_logits: rows N(0, 0.1) with the mirror
    lane filled, fields iota (canonical CTR) or random with repeats, and,
    with pad, padding occurrences and a padded sample."""
    e = cp * k
    v = torch.randn((b * f, e), generator=gen, device=device) * 0.1
    if n_real is not None and n_real < cp:
        v[:, n_real] = torch.randn((b * f,), generator=gen, device=device) * 0.3
    if fields == "iota":
        fld = torch.arange(f, dtype=torch.int32, device=device).remainder(cp).expand(b, f)
    else:
        hi = n_real or cp
        fld = torch.randint(0, hi, (b, f), generator=gen, device=device, dtype=torch.int32)
        if fields == "out_of_range":
            fld[:, ::3] = cp + 1
            fld[:, 1::5] = -1
    fld = fld.contiguous()
    vals = torch.rand((b, f), generator=gen, device=device)
    if pad:
        vals[:, -2:] = 0.0
        fld[:, -2:] = 0
        vals[-1] = 0.0
    lin = torch.randn((b,), generator=gen, device=device) * 0.1
    return v, fld, vals, lin


def fused_inputs(b, f, cp, k, gen, device, fields, n_real):
    """kernel_inputs plus labels and sample weights; with B > 1 the last
    sample is padding (values 0, weight 0)."""
    v, fld, vals, lin = kernel_inputs(b, f, cp, k, gen, device, fields, n_real, pad=b > 1)
    y = torch.randint(0, 2, (b,), generator=gen, device=device).to(torch.float32)
    sw = torch.ones((b,), device=device)
    if b > 1:
        sw[-1] = 0.0
    return v, fld, vals, lin, y, sw


def ftrl_tables(gen, device, p, *shape):
    """(n, z, w) as training leaves them: a touched coordinate (n > 0, 70%)
    holds w = closed form of (n, z), an untouched one its init."""
    from ftrl_ffm_tpu_torch.ftrl import UNTOUCHED_N, ftrl_weights

    n_tab = torch.rand(shape, generator=gen, device=device) * 3 + 1e-3
    n_tab = torch.where(torch.rand(shape, generator=gen, device=device) < 0.7, n_tab, 0.0)
    z_tab = torch.randn(shape, generator=gen, device=device)
    init = torch.randn(shape, generator=gen, device=device) * 0.02
    w_tab = torch.where(n_tab > UNTOUCHED_N, ftrl_weights(n_tab, z_tab, p), init)
    return [n_tab, z_tab, w_tab]


def random_ids(n, hi, r, gen, device):
    """[N] int32 ids that repeat, drawn from [0, hi) so rows hi..r-1 stay
    untouched, 2% of them the padding sentinel r."""
    ids = torch.randint(0, hi, (n,), generator=gen, device=device, dtype=torch.int32)
    ids[torch.randperm(n, generator=gen, device=device)[: n // 50]] = r
    return ids


def skewed_ids(n, hi, r, gen, device, hot_fields=3, share=0.9):
    """[N] int32 ids of a skewed batch, the payload rows of N // N_FIELDS
    samples of N_FIELDS fields (row b*N_FIELDS + c is sample b's field c, as
    the trainer lays them out): fields 0..hot_fields-1 carry one hot id each
    in `share` of the samples, every other id is uniform over [0, hi), and
    2% of all are the padding sentinel r.  At the bench shape each hot id
    has ~14,500 payload rows (real Criteo has such ids; the synthetic data
    has none)."""
    b = n // N_FIELDS
    ids = torch.randint(0, hi, (b, N_FIELDS), generator=gen, device=device, dtype=torch.int32)
    hot = torch.randperm(hi, generator=gen, device=device)[:hot_fields].to(torch.int32)
    pick = torch.rand((b, hot_fields), generator=gen, device=device) < share
    ids[:, :hot_fields] = torch.where(pick, hot, ids[:, :hot_fields])
    ids = ids.reshape(-1)
    ids[torch.randperm(n, generator=gen, device=device)[: n // 50]] = r
    return ids


def ordered_segment_sums(segment_sums, n_out, slot, rows):
    """ftrl.py::_segment_sums (given as segment_sums, which sums a bf16
    payload rank by rank already) with an f32 payload summed the same way:
    step r adds every slot's r-th row, so each slot adds its rows in
    ascending payload order, one f32 add at a time."""
    if rows.dtype != torch.float32 or slot.numel() == 0:
        return segment_sums(n_out, slot, rows)
    acc = torch.zeros((n_out, rows.shape[-1]), dtype=rows.dtype, device=rows.device)
    sslot, perm = torch.sort(slot, stable=True)
    pos = torch.arange(sslot.numel(), device=slot.device)
    starts = torch.ones_like(sslot, dtype=torch.bool)
    starts[1:] = sslot[1:] != sslot[:-1]
    rank = pos - torch.cummax(torch.where(starts, pos, 0), dim=0).values
    by_rank = torch.argsort(rank, stable=True)
    at = 0
    for count in torch.bincount(rank).tolist():
        sel = by_rank[at:at + count]
        dst = sslot[sel]
        acc[dst] = acc[dst] + rows[perm[sel]]
        at += count
    return acc


def update_inputs(r, e, n, hi, gen, device, p, lane, skewed=False):
    """Tables, ids and payloads for ftrl_update (ftrl_tables, random_ids or
    skewed_ids)."""
    tables = ftrl_tables(gen, device, p, r, e) + ftrl_tables(gen, device, p, r)
    ids = (skewed_ids if skewed else random_ids)(n, hi, r, gen, device)
    g = torch.randn((n, e), generator=gen, device=device) * 0.1
    gl = torch.randn((n,), generator=gen, device=device) * 0.1
    gg2_lin = None if lane >= 0 else torch.stack([gl, gl * gl], dim=-1)
    return tables, ids, torch.cat([g, g * g], dim=-1), gg2_lin


def scatter_inputs(r, e, n, hi, gen, device):
    """z [R, E], ids (random_ids) and a split payload g, g^2 for za_scatter."""
    z = torch.randn((r, e), generator=gen, device=device)
    g = torch.randn((n, e), generator=gen, device=device) * 0.1
    return z, random_ids(n, hi, r, gen, device), g, g * g


def recv_slots(rng, r: int, m: int, k: int, fill: float, hot) -> np.ndarray:
    """A route's received slots [M*K] int32 as parallel/sharded.py::_route
    lays them out: from each of M peers a block of K slots, its first
    ~fill*K holding distinct local rows in ascending order (a peer sends
    each id once), the rest r (empty).  Half of a peer's rows come from the
    `hot` rows every peer draws from, so a row arrives from up to M peers."""
    slots = np.full(m * k, r, np.int32)
    for peer in range(m):
        u = int(rng.binomial(k, fill))
        rows = np.union1d(rng.choice(hot, u // 2, replace=False),
                          rng.choice(r, u - u // 2, replace=False))
        slots[peer * k: peer * k + rows.size] = rows
    return slots


def pass_inputs(r, e, gen, device, p):
    """n, z', w (ftrl_tables) and A for closed_form_pass; A is 0 on 40% of
    the coordinates (rows and lanes no id touched)."""
    a = torch.rand((r, e), generator=gen, device=device) * 0.5
    a = torch.where(torch.rand((r, e), generator=gen, device=device) < 0.6, a, 0.0)
    return (*ftrl_tables(gen, device, p, r, e), a)


def clone_state(state):
    return type(state)(*(None if t is None else t.clone() for t in state))


@contextlib.contextmanager
def plain_kernels():
    """Within: Model.train_step runs the plain PyTorch versions of the
    training kernels (the in-place updates copy the plain result in)."""
    import ftrl_ffm_tpu_torch.models.base as mbase
    import ftrl_ffm_tpu_torch.models.ffm as mffm
    from ftrl_ffm_tpu_torch.ftrl import dense_ftrl_update2, dense_ftrl_update_inplace
    from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits_grads_plain
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update_plain

    def update(*args, **kw):
        vec, lin = ftrl_update_plain(*args, **kw)
        for dst, src in zip(args[:6], (*vec, *lin)):
            dst.copy_(src)

    def linear(*args):
        for dst, src in zip(args[:3], dense_ftrl_update2(*args)):
            dst.copy_(src)

    def inplace(vec_n, vec_z, vec_w, ids, g, g2, p, lin_tables=None, gg2_lin=None):
        for dst, src in zip((vec_n, vec_z, vec_w),
                            dense_ftrl_update_inplace(vec_n, vec_z, vec_w, ids, g, g2, p)):
            dst.copy_(src)
        if lin_tables is not None:
            linear(*lin_tables, ids, gg2_lin, p)

    names = ("ftrl_update", "_inplace_step", "ftrl_update_linear")
    saved = mffm.ffm_fused_logits_grads, *(getattr(mbase, n) for n in names)
    mffm.ffm_fused_logits_grads = ffm_fused_logits_grads_plain
    mbase.ftrl_update, mbase._inplace_step, mbase.ftrl_update_linear = update, inplace, linear
    try:
        yield
    finally:
        mffm.ffm_fused_logits_grads = saved[0]
        for n, f in zip(names, saved[1:]):
            setattr(mbase, n, f)


def interleaved_ms(kern, plain, kern_iters: int, plain_iters: int):
    """Kernel and plain ms per call, runs in the order plain, kernel,
    kernel, plain; returns (runs, kernel median, plain median)."""
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn, iters = (kern, kern_iters) if which == "kernel" else (plain, plain_iters)
        runs[which].append(cuda_ms(fn, iters))
    return runs, float(np.median(runs["kernel"])), float(np.median(runs["plain"]))


def print_breakdown(label: str, rows, where: str) -> None:
    total = sum(ms for _, ms in rows)
    parts = ", ".join(f"{name[:60]} {ms:.3f}" for name, ms in rows[:8])
    print(f"profile: {label}: device {total:.3f} ms per step: {parts} [{where}]")


def cuda_ms(fn, iters: int) -> float:
    """ms per call of fn on the card (CUDA events, after a warm-up call)."""
    from ftrl_ffm_tpu_torch.tools import time_ms

    return time_ms(fn, torch.device("cuda"), iters)


# ---- the training cells through the entry points (phases 4b, 4f and
# their parts of 5, 6 and 7) ----

# (cell, model_type, n_feats, data seed, extra config, the factor tables'
# update kind): bench.py's FFM model and table at 100k rows; LR and FM
# there (f32, and a bf16 table whose payload stays f32); FM at an assumed
# hashing-trick table of 2^22 rows under update_mode=inplace (the scatter
# and kernel #3 at K=16, held against update_mode=dense)
TRAIN_CELLS = (
    ("train-ffm-100k", "FFM", TRAIN_FEATS, 7, {}, "dense2"),
    ("train-lr-100k", "LR", TRAIN_FEATS, 17, {}, None),
    ("train-fm-100k", "FM", TRAIN_FEATS, 17, {}, "dense2"),
    ("train-fm-100k-bf16", "FM", TRAIN_FEATS, 17,
     {"table_dtype": "bfloat16", "acc_dtype": "bfloat16"}, "dense2"),
    ("train-fm-4m", "FM", HASH_FEATS, 19, {"update_mode": "inplace"}, "inplace"),
    ("train-fm-4m-bf16", "FM", HASH_FEATS, 19,
     {"table_dtype": "bfloat16", "update_mode": "inplace"}, "inplace"),
)
# the tables an FFM chain is held on: its w may flip across the closed
# form's |z| <= l1 threshold on one ulp of z, over 640 columns a row
FFM_CHAIN_TABLES = ("lin_z", "vec_z")


def reset_counts() -> None:
    """Every kernel wrapper's launch counts, by instance and by dtype too,
    set to 0."""
    from ftrl_ffm_tpu_torch.tools import reset_launch_counts

    reset_launch_counts()


def read_counts() -> dict:
    """Each wrapper's launches and the entries that ran by instance and
    dtype (ftrl_ffm_tpu_torch/tools::read_launch_counts)."""
    from ftrl_ffm_tpu_torch.tools import read_launch_counts

    return read_launch_counts()


def expected_counts(model_type: str, kind, table_dtype: str, steps: int,
                    evals: int = 0) -> dict:
    """The launches `steps` train steps (and `evals` FFM eval batches) must
    make.  FFM's "dense2" (an f32 table): kernel #2 and the update kernel
    once a step on their C'=40, K=16 and "rows" instances, kernel #1 once
    an eval batch.  LR and FM: no FFM kernel; the update kernel on an f32
    payload (FM's payload is f32 under every acc_dtype), with a bf16 w
    where the factor table is bf16, FM's K=16 row on its narrow instance;
    FM's "inplace" runs the scatter (narrow) and the pass, then the
    linear-only update; LR's and that linear-only update run the "linear"
    instance (E = 0)."""
    w = "bf16" if table_dtype == "bfloat16" else "f32"
    out = {"ffm_fused_logits": 0, "ffm_fused_logits_grads": 0, "ftrl_update": steps,
           "za_scatter": 0, "closed_form_pass": 0, "logits_by_instance": {},
           "fused_by_instance": {}, "update_by_dtype": {"f32/f32": steps},
           "pass_by_dtype": {}, "update_by_instance": {"linear": steps},
           "scatter_by_instance": {}}
    if model_type == "FFM":
        out.update(ffm_fused_logits=evals, ffm_fused_logits_grads=steps,
                   fused_by_instance={"c40_k16": steps}, update_by_instance={"rows": steps})
        if evals:
            out["logits_by_instance"] = {"c40_k16": evals}
    elif model_type == "FM" and kind == "inplace":
        out.update(za_scatter=steps, closed_form_pass=steps, pass_by_dtype={w: steps},
                   scatter_by_instance={"narrow": steps})
    elif model_type == "FM":
        out["update_by_dtype"] = {f"f32/{w}": steps}
        out["update_by_instance"] = {"narrow": steps}
    return out


def states_close(a, b, names=None) -> tuple[bool, dict]:
    """Two states within the chained bound on the tables `names` (all by
    default; a bf16 w within one bf16 ulp, relative), and the largest
    |difference| of every table; absent tables (LR's factor tables)
    absent on both."""
    ok, err = True, {}
    for name, x, y in zip(a._fields, a, b):
        if x is None or y is None:
            ok &= x is None and y is None
            continue
        if name == "step":
            ok &= torch.equal(x, y)
            continue
        bf16 = x.dtype == torch.bfloat16
        err[name] = (x.float() - y.float()).abs().max().item()
        if names is None or name in names:
            ok &= torch.allclose(x.float(), y.float(), rtol=BF16_RTOL if bf16 else CHAIN_RTOL,
                                 atol=CHAIN_ATOL)
    return ok, err


def step_categories(rows) -> tuple[dict, tuple]:
    """A train step's device ms (profile_ms rows) summed by what ran: the
    port's kernels by name, torch's sort, gathers, fills and copies, and
    the rest: the plain PyTorch ops (FM's interaction chain, the payload,
    the loss and the bias).  Returns (sums, the largest op of the rest)."""
    sums = dict.fromkeys(("ftrl_update", "za_scatter", "ftrl_pass", "sort", "gather",
                          "fill/copy", "other ops"), 0.0)
    largest = ("", 0.0)
    for name, ms in rows:
        if "ftrl_update" in name:
            key = "ftrl_update"
        elif "za_scatter" in name:
            key = "za_scatter"
        elif "ftrl_pass" in name:
            key = "ftrl_pass"
        elif "Sort" in name or "sort" in name:
            key = "sort"
        elif "gather" in name or "indexSelect" in name or "index_elementwise" in name:
            key = "gather"
        elif any(w in name for w in ("Fill", "Memset", "Memcpy", "memset", "memcpy")):
            key = "fill/copy"
        else:
            key = "other ops"
            if ms > largest[1]:
                largest = (name[:80], ms)
        sums[key] += ms
    return sums, largest


def train_cells(tmp: str, device, where: str) -> dict:
    """Phases 4b and 4f, and their part of phase 5: each cell of
    TRAIN_CELLS through Trainer.train() (2 epochs with eval, streamed), its
    launches set to 0 just before and read just after (expected_counts);
    3 chained train steps against the plain versions and twice for the
    bits (an "inplace" cell also against update_mode=dense); LR and FM's
    evaluate() and predict_file() against a CPU Trainer (the plain PyTorch
    path) on the same state (FFM serving is held in phase 4); then the
    device train step by CUDA events.  After the cells, small runs on the
    CPU and the card from one init: FFM, and LR from a libsvm file.
    Returns, by cell: trainer, model, dense model, placed batches, counts,
    history, the chained-step errors and the step ms; and "small": (the
    small FFM model's settings, its train and eval files)."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.data.stream import StreamReader
    from ftrl_ffm_tpu_torch.models import make_model
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update
    from ftrl_ffm_tpu_torch.train import Trainer

    n_batches = N_ROWS // BATCH
    paths = {}
    t0 = time.perf_counter()
    for _, _, nf, seed, _, _ in TRAIN_CELLS:
        if (nf, seed) not in paths:
            paths[nf, seed] = (os.path.join(tmp, f"train{nf}_{seed}.ffm"),
                               os.path.join(tmp, f"eval{nf}_{seed}.ffm"))
            write_criteo_split([(paths[nf, seed][0], N_ROWS), (paths[nf, seed][1], BATCH)], nf,
                               seed=seed)
    print(f"train: wrote {N_ROWS} + {BATCH} Criteo-shaped rows for each of {sorted(paths)} "
          f"(n_feats, seed) in {time.perf_counter() - t0:.1f} s")
    out = {}
    for cell, mt, nf, seed, extra, want_kind in TRAIN_CELLS:
        train_p, eval_p = paths[nf, seed]
        cfg = Config(model_type=mt, n_fields=N_FIELDS, n_factors=N_FACTORS, n_feats=nf,
                     batch_size=BATCH, train_data=train_p, eval_data=eval_p, n_epochs=2,
                     device="cuda", n_threads=4, device_cache="off", **extra)
        tr = Trainer(cfg)
        model = tr.model
        kind = model.form if cfg.row_width else None
        require(kind == want_kind, f"{cell}: update_mode={cfg.update_mode} resolves to {kind!r}")
        reset_counts()
        t0 = time.perf_counter()
        hist = tr.train()
        t_train = time.perf_counter() - t0
        counts = read_counts()
        steps = tr._steps_done
        print(f"train {cell}: Trainer.train() 2 epochs with eval in {t_train:.2f} s (first): "
              f"{steps} steps, factor tables' update kind {kind!r}; launches {counts}; history "
              f"{hist}")
        require(steps == 2 * n_batches, f"{cell}: {steps} train steps, expect {2 * n_batches}")
        evals = 2 if mt == "FFM" else 0  # one eval batch an epoch
        require(counts == expected_counts(mt, kind, cfg.table_dtype, steps, evals),
                f"{cell}: the kernels launched {counts}")
        require(all(math.isfinite(x) for k in ("train_loss", "eval_loss", "eval_auc")
                    for x in hist[k]), f"{cell}: non-finite training history")
        require(hist["train_loss"][1] < hist["train_loss"][0],
                f"{cell}: epoch 2 train loss is not below epoch 1's")
        # at 2^22 rows an id recurs ~1.2 times in the training rows, so the
        # eval rows' AUC is not held there
        require(nf == HASH_FEATS or hist["eval_auc"][-1] > 0.5, f"{cell}: eval AUC not above 0.5")
        require((tr.state.vec_w is None) == (mt == "LR"), f"{cell}: factor tables {mt}")

        # 3 chained train steps from one state: kernels against the plain
        # versions, twice for the bits; an in-place cell also against dense
        placed = [tr._place_batch(a) for a in StreamReader(
            train_p, "libffm", BATCH, N_FIELDS, nf, N_FIELDS, n_parse_threads=4,
            log_every=0).batches()]
        base = tr.state  # not stepped below: each chain steps a clone
        names = FFM_CHAIN_TABLES if mt == "FFM" else None

        def chain(mdl, ctx=contextlib.nullcontext):
            s = clone_state(base)
            with ctx():
                losses = [mdl.train_step(s, b).loss_sum.item() for b in placed[:3]]
            return s, losses

        s_kern, l_kern = chain(model)
        s_again, _ = chain(model)
        same = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(s_kern, s_again))
        del s_again
        s_plain, l_plain = chain(model, plain_kernels)
        plain_ok, perr = states_close(s_kern, s_plain, names)
        ldiff = max(abs(a - b) / abs(b) for a, b in zip(l_kern, l_plain))
        del s_plain
        msg = ""
        dmodel = None
        if kind == "inplace":
            dmodel = make_model(dataclasses.replace(cfg, update_mode="dense"))
            ftrl_update.launches = 0
            s_dense, l_dense = chain(dmodel)
            dense_ok, derr = states_close(s_kern, s_dense)
            msg = (f"; inplace vs dense ({ftrl_update.launches} ftrl_update launches): max "
                   f"|diff| {derr}, losses {l_kern} vs {l_dense}")
            require(dense_ok and ftrl_update.launches == 3,
                    f"{cell}: in-place and dense steps from one state disagree")
            del s_dense
        held = "every table" if names is None else ", ".join(names)
        print(f"train {cell}: 3 chained steps, kernels vs plain: loss rel diff {ldiff:.2e}, max "
              f"|diff| {perr} (held: {held}); two kernel runs bit-identical={same}{msg}")
        require(plain_ok, f"{cell}: chained train steps disagree with the plain versions")
        require(same, f"{cell}: two runs of the same train steps differ")
        del s_kern

        if mt != "FFM":
            # serving: evaluate() and predict_file() on the card against a
            # CPU Trainer on the same state (LR and FM's logits are plain
            # PyTorch on both: no kernel launches)
            reset_counts()
            loss, auc = tr.evaluate()
            preds = os.path.join(tmp, f"{cell}.txt")
            n_pred = tr.predict_file(eval_p, preds)
            serve_counts = read_counts()
            ctr = Trainer(dataclasses.replace(cfg, device="cpu"),
                          state=type(tr.state)(*(None if t is None else t.cpu() for t in tr.state)))
            c_loss, c_auc = ctr.evaluate()
            ctr.predict_file(eval_p, preds + ".cpu")
            pdiff = float(np.abs(np.loadtxt(preds) - np.loadtxt(preds + ".cpu")).max())
            del ctr
            print(f"serve {cell}: evaluate loss={loss:.6f} auc={auc:.6f}, the CPU's "
                  f"{c_loss:.6f} {c_auc:.6f}; predict_file wrote {n_pred}, probability max "
                  f"|diff| {pdiff:.2e}; launches {serve_counts}")
            require(n_pred == BATCH, f"{cell}: predict_file scored {n_pred} of {BATCH}")
            require(abs(loss - c_loss) <= 1e-5 * max(1.0, c_loss) and abs(auc - c_auc) <= 1e-4,
                    f"{cell}: eval off the CPU's")
            require(pdiff <= 2e-6, f"{cell}: predictions off the CPU's")
            require(serve_counts["ffm_fused_logits"] == 0 and serve_counts["ftrl_update"] == 0,
                    f"{cell}: serving launched {serve_counts}")
        out[cell] = dict(trainer=tr, model=model, dense_model=dmodel, placed=placed,
                         counts=counts, hist=hist, chain_err=perr, kind=kind,
                         paths=(train_p, eval_p))

    # small runs on the CPU (plain versions) and on the card from one init:
    # FFM, and LR from a libsvm file (sniffed as such)
    small_ffm = dict(model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS,
                     n_feats=5000, batch_size=1024, n_epochs=2)
    small_lr = dict(small_ffm, model_type="LR")
    ffm_p = (os.path.join(tmp, "strain.ffm"), os.path.join(tmp, "seval.ffm"))
    lr_p = (os.path.join(tmp, "lr_train.svm"), os.path.join(tmp, "lr_eval.svm"))
    for label, small, (st_p, se_p), libsvm, init_seed in (
        ("ffm", small_ffm, ffm_p, False, SEED + 2),
        ("lr libsvm", small_lr, lr_p, True, None),
    ):
        write_criteo_split([(st_p, 3000), (se_p, 1000)], small["n_feats"], seed=11,
                           libsvm=libsvm)
        gen = None if init_seed is None else torch.Generator().manual_seed(init_seed)
        init = make_model(Config(device="cpu", **small)).init(gen)
        res = {}
        for dev in ("cpu", "cuda"):
            reset_counts()
            scfg = Config(train_data=st_p, eval_data=se_p, device=dev, **small)
            res[dev] = Trainer(scfg, state=clone_state(init)).train()
            require(scfg.file_type == ("libsvm" if libsvm else "libffm"),
                    f"the small {label} file sniffed as {scfg.file_type}")
        card_launches = ftrl_update.launches
        print(f"train small {label}: eval loss cpu={res['cpu']['eval_loss']} "
              f"cuda={res['cuda']['eval_loss']}; ftrl_update launches on the card "
              f"{card_launches}")
        require(abs(res["cpu"]["eval_loss"][-1] - res["cuda"]["eval_loss"][-1]) <= 1e-4,
                f"cpu and cuda {label} training reach different eval losses")
        require(card_launches == 2 * math.ceil(3000 / 1024),
                f"the small {label} run missed the update kernel")
    out["small"] = (small_ffm, *ffm_p)

    # ---- 5: the device train step by CUDA events ----
    for cell, rec in out.items():
        if cell == "small":
            continue
        tr, cycle = rec["trainer"], itertools.cycle(rec["placed"])
        n = len(rec["placed"])
        if rec["dense_model"] is None:
            rec["step_ms"] = [cuda_ms(lambda: rec["model"].train_step(tr.state, next(cycle)),
                                      2 * n) for _ in range(2)]
            msg = f"{rec['step_ms']} ms/batch"
        else:
            rec["step_ms"], rec["dense_step_ms"] = [], []
            for which in ("inplace", "dense", "dense", "inplace"):
                mdl = rec["model"] if which == "inplace" else rec["dense_model"]
                ms = cuda_ms(lambda: mdl.train_step(tr.state, next(cycle)), 2 * n)
                rec["step_ms" if which == "inplace" else "dense_step_ms"].append(ms)
            msg = (f"inplace {rec['step_ms']} ms/batch, update_mode=dense "
                   f"{rec['dense_step_ms']} ms/batch")
        print(f"timing: train_step {cell} on the device (CUDA events around {2 * n} steps, "
              f"the host's dispatch included): {msg} (n_feats={rec['trainer'].cfg.n_feats}, "
              f"B={BATCH}) [{where}]")
    return out


def lr_fm_kernel_times(gen, device, where: str, p) -> dict:
    """Phase 5e: the kernels at LR and FM's widths, at the main path's
    shapes, against their plain versions (runs plain, kernel, kernel,
    plain), beside their bounds and the stable sort of the same ids alone
    (each wrapper sorts before its kernels): the update kernel at E=16
    (uniform ids over 100k rows, f32 and bf16 w), at E=0 (LR's), the z/A
    scatter at [2^22, 16] on uniform and Zipf ids, and the pass at
    [2^22, 16].  Returns name -> {ms, plain_ms, bound, library_ms,
    sort_ms}."""
    from ftrl_ffm_tpu_torch.ftrl import closed_form_pass_plain, dense_ftrl_update2
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import (
        closed_form_pass,
        ftrl_update,
        ftrl_update_linear,
        ftrl_update_plain,
        za_scatter,
        za_scatter_plain,
    )

    n, k = BATCH * N_FIELDS, N_FACTORS
    out = {}

    def record(name, runs, bnd, shape, library_ms=None, extra="", ids=None):
        sort_ms = None if ids is None else cuda_ms(lambda: torch.sort(ids, stable=True), 10)
        out[name] = {"ms": float(np.median(runs["kernel"])),
                     "plain_ms": float(np.median(runs["plain"])), "bound": bnd,
                     "library_ms": library_ms, "sort_ms": sort_ms}
        sort = "" if sort_ms is None else f"; the stable sort alone {sort_ms:.4f} ms"
        print(f"timing: {name} {shape}: kernel {runs['kernel']} ms, plain {runs['plain']} ms; "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}){sort}{extra} [{where}]")

    for name, wdt in (("ftrl_update_k16", torch.float32), ("ftrl_update_k16_bf16_w", torch.bfloat16)):
        tables, ids, gg2, gg2_lin = update_inputs(TRAIN_FEATS, k, n, TRAIN_FEATS, gen, device, p, -1)
        tables[2] = tables[2].to(wdt)
        runs, _, _ = interleaved_ms(lambda: ftrl_update(*tables, ids, gg2, -1, p, gg2_lin),
                                    lambda: ftrl_update_plain(*tables, ids, gg2, -1, p, gg2_lin),
                                    10, 3)
        # reads the ids and both payloads; reads and writes n, z, w of the
        # touched factor rows and their three linear entries; ops: the
        # payload sums and ~20 per touched slot
        touched = touched_rows(ids, TRAIN_FEATS)
        wb = tables[2].element_size()
        bnd = bound(nbytes(ids, gg2, gg2_lin) + touched * (k * (4 + 4 + wb) * 2 + 3 * 4 * 2),
                    gg2.numel() + gg2_lin.numel() + touched * (k + 1) * 20)
        record(name, runs, bnd, f"R={TRAIN_FEATS} E={k} N={n} lane=-1 w {wdt} (stable sort "
               f"included)", extra=f"; {touched} touched rows", ids=ids)
        del tables, ids, gg2, gg2_lin
    lin = ftrl_tables(gen, device, p, TRAIN_FEATS)
    ids = random_ids(n, TRAIN_FEATS, TRAIN_FEATS, gen, device)
    gl = torch.randn((n,), generator=gen, device=device) * 0.1
    gg2_lin = torch.stack([gl, gl * gl], dim=-1)
    runs, _, _ = interleaved_ms(lambda: ftrl_update_linear(*lin, ids, gg2_lin, p),
                                lambda: dense_ftrl_update2(*lin, ids, gg2_lin, p), 10, 3)
    touched = touched_rows(ids, TRAIN_FEATS)
    bnd = bound(nbytes(ids, gg2_lin) + touched * 3 * 4 * 2, gg2_lin.numel() + touched * 20)
    record("ftrl_update_linear", runs, bnd, f"R={TRAIN_FEATS} E=0 N={n} (stable sort included)",
           extra=f"; {touched} touched rows", ids=ids)
    del lin, ids, gl, gg2_lin

    for name, zipf in (("za_scatter_k16", False), ("za_scatter_k16_zipf", True)):
        z, ids, g, g2 = scatter_inputs(HASH_FEATS, k, n, HASH_FEATS, gen, device)
        if zipf:
            ids = zipf_ids(n, HASH_FEATS, device)
        a = torch.zeros_like(z)
        runs, _, _ = interleaved_ms(lambda: za_scatter(z, a, ids, g, g2),
                                    lambda: za_scatter_plain(z, ids, g, g2), 10, 3)
        touched = touched_rows(ids, HASH_FEATS)
        bnd = bound(nbytes(ids, g, g2) + touched * k * 4 * 3, 2 * g.numel())
        # the same function in PyTorch: one index_add_ per output, into
        # tables with a row for the sentinel id
        z_ext = torch.zeros((HASH_FEATS + 1, k), device=device)
        a_ext = torch.zeros_like(z_ext)
        lib_ms = cuda_ms(lambda: (z_ext.index_add_(0, ids, g), a_ext.index_add_(0, ids, g2)), 10)
        zero_ms = cuda_ms(lambda: torch.zeros_like(z), 10)
        record(name, runs, bnd, f"R={HASH_FEATS} E={k} N={n}{' Zipf ids' if zipf else ''} "
               f"(stable sort included)", lib_ms, f"; two index_add_ {lib_ms:.4f} ms; zeroing A "
               f"{zero_ms:.4f} ms; {touched} touched rows", ids=ids)
        out[name]["zero_a_ms"] = zero_ms
        del z, ids, g, g2, a, z_ext, a_ext
    for name, wdt in (("ftrl_pass_k16", torch.float32), ("ftrl_pass_k16_bf16_w", torch.bfloat16)):
        tabs = list(pass_inputs(HASH_FEATS, k, gen, device, p))
        tabs[2] = tabs[2].to(wdt)
        runs, _, _ = interleaved_ms(lambda: closed_form_pass(*tabs, p),
                                    lambda: closed_form_pass_plain(*tabs, p), 10, 3)
        # five f32 streams (read n, z', A; write n, z), w read and written
        wb = tabs[2].element_size()
        bnd = bound(HASH_FEATS * k * (5 * 4 + 2 * wb), 20 * HASH_FEATS * k)
        record(name, runs, bnd, f"R={HASH_FEATS} E={k} w {wdt}")
        del tabs
    return out


def lr_fm_resident(bench_100k: str, tmp: str, device, where: str) -> tuple[dict, dict]:
    """LR and FM's part of phase 7: the bench twin's protocol
    (ftrl_ffm_tpu_torch/bench.py::run: 400,000 rows of its generator,
    online, n_epochs=4, n_threads=3, one warm-up train_epoch() after the
    build, best of 3 timed epochs) from the device-resident dataset, at
    100k rows (LR, FM) and 2^22 rows (FM under update_mode=inplace and
    dense), the 2^22 pair also on Zipf-skewed ids (tools/bench_matrix.py's
    "zipf" variant), which touch fewer rows a batch than uniform ones; a
    `resident <cell>:` line each, with the launches of the timed epochs.
    Returns (records, trainers) by cell."""
    from ftrl_ffm_tpu_torch import bench
    from ftrl_ffm_tpu_torch.ops import _build

    hot_rows = _build.lib().ftrl_update_hot_rows()
    data, longest = {}, {}
    for variant in ("uniform", "zipf"):
        path = os.path.join(tmp, f"bench_hash_{variant}.ffm")
        t0 = time.perf_counter()
        ids = write_criteo_like(path, BENCH_ROWS, HASH_FEATS, zipf=variant == "zipf")
        # rows a step's update touches: the distinct ids of each full batch
        touched = [np.unique(ids[i:i + BATCH]).size for i in range(0, BENCH_ROWS - BATCH + 1, BATCH)]
        # each step's longest segment (online steps take the file's order)
        longest[variant] = [int(np.bincount(ids[i:i + BATCH].ravel()).max())
                            for i in range(0, BENCH_ROWS, BATCH)]
        data[variant] = path
        print(f"resident lr/fm: wrote {BENCH_ROWS} bench rows ({variant} ids) at n_feats "
              f"{HASH_FEATS} in {time.perf_counter() - t0:.1f} s; distinct ids a batch: mean "
              f"{np.mean(touched):.0f}, min {min(touched)}, max {max(touched)}; a step's longest "
              f"segment: min {min(longest[variant])}, max {max(longest[variant])} rows")
    # every step of the Zipf cells has segments over hot_rows: the in-place
    # kind's scatter sends them to za_scatter_hot (launched with every
    # narrow scatter), the dense kind's update to ftrl_update_hot
    require(min(longest["zipf"]) > hot_rows >= max(longest["uniform"]),
            f"the Zipf data's steps miss segments over {hot_rows} rows")
    timed_steps = 3 * math.ceil(BENCH_ROWS / BATCH)
    records, trainers = {}, {}
    inplace, dense = {"update_mode": "inplace"}, {"update_mode": "dense"}
    for cell, mt, nf, variant, extra in (
        ("train-lr-100k-resident", "LR", TRAIN_FEATS, None, {}),
        ("train-fm-100k-resident", "FM", TRAIN_FEATS, None, {}),
        ("train-fm-4m-resident", "FM", HASH_FEATS, "uniform", inplace),
        ("train-fm-4m-dense-resident", "FM", HASH_FEATS, "uniform", dense),
        ("train-fm-4m-zipf-resident", "FM", HASH_FEATS, "zipf", inplace),
        ("train-fm-4m-zipf-dense-resident", "FM", HASH_FEATS, "zipf", dense),
    ):
        # the bench twin's protocol and config (ftrl_ffm_tpu_torch/bench.py)
        res = bench.run(bench.make_config(data.get(variant, bench_100k), "cuda",
                                          model_type=mt, n_feats=nf, **extra))
        rtr, counts = res["trainer"], res["counts"]
        entry = rtr._dev_cache.get("train")
        kind = None if mt == "LR" else ("inplace" if extra is inplace else "dense2")
        rec = {
            "cell": cell,
            "examples_per_s": res["value"],
            "runs": res["runs"],
            "build_s": res["build_s"],
            "warmup_s": res["warmup_s"],
            "device_cache": res["device_cache"],
            "losses": res["losses"],
            "steps": rtr._steps_done,
            "launches": res["launches"],
            **{k: v for k, v in counts.items() if not isinstance(v, int)},
            "card": where,
        }
        print(f"resident {cell}: {json.dumps(rec)}")
        require(entry is not None and entry.n == BENCH_ROWS,
                f"{cell}: the bench run did not take the resident dataset")
        require(rtr._steps_done == 4 * timed_steps // 3,
                f"{cell}: {rtr._steps_done} steps, expect {4 * timed_steps // 3}")
        require(counts == expected_counts(mt, kind, "float32", timed_steps),
                f"{cell}: the kernels launched {counts} in the timed epochs")
        losses = res["losses"]
        require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
                f"{cell}: resident losses {losses}")
        records[cell], trainers[cell] = rec, rtr
    # "inplace" against "dense2" after the same 100 steps (4f holds them bit
    # for bit over 3 chained steps; here over 4 epochs, for item 7's
    # thresholds)
    for variant in ("", "-zipf"):
        a, b = trainers[f"train-fm-4m{variant}-resident"], trainers[f"train-fm-4m{variant}-dense-resident"]
        diffs = {name: float((x.float() - y.float()).abs().max())
                 for name, x, y in zip(a.state._fields, a.state, b.state)
                 if x is not None and x.dim() > 0}
        same = all(x is None or torch.equal(x, y) for x, y in zip(a.state, b.state))
        print(f"resident train-fm-4m{variant}: inplace against dense after {a._steps_done} steps: "
              f"bit-identical {same}; max |diff| by table {json.dumps(diffs)}")
        require(same, f"train-fm-4m{variant}: the in-place and dense kinds' states differ")
    return records, trainers


def checkpoint_phase(bench_100k: str, tmp: str, device, where: str, r_trainers: dict,
                     lrfm_trainers: dict) -> dict:
    """Phase 8: checkpoints at bench.py's full width (FFM, 39 fields,
    640-float rows, K=16, B=16,384, 100k rows, phase 7's 400,000-row file
    and its resident upload).  (a) an epoch with model_path and save_every =
    the steps of an epoch (async, the default zstd level 3), the file's
    arrays against a clone of the state at the save, a fresh Trainer
    resumed from the file (the port's libzstd loader) against an
    uninterrupted run, bit for bit; (b) a synchronous save and an async one
    through the host copy (the device copy made not to fit) give the same
    file (level 1: the bits do not depend on it); (c) the times: each
    save's inline stall and snapshot path, the
    writer's seconds, the join, bytes, load seconds, train_epoch() ex/s
    with the save (epoch 1 of (a)) and without (the uninterrupted run's
    epoch 1, next to it); (d) the reference blob at full width exported
    and imported into a fresh card Trainer, the text form on a small
    table; (e) LR-100k, FM-100k and FFM-100k-bf16 round trips (level 1:
    the bits do not depend on it); (f) one async write of phase 7's 1M
    "inplace" state at level 1 (7.7 GB; level 3 takes minutes), its linear
    tables against the mirror lane, where 20 GB are free under `tmp`.
    Returns the records by name."""
    import ctypes.util
    import importlib.util
    import shutil

    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.io import checkpoint as ck
    from ftrl_ffm_tpu_torch.io import zstd
    from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits_grads
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update
    from ftrl_ffm_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    print(f"checkpoint: libzstd {zstd.version()} (find_library: "
          f"{ctypes.util.find_library('zstd')}); zstandard importable "
          f"{importlib.util.find_spec('zstandard') is not None}, ml_dtypes importable "
          f"{importlib.util.find_spec('ml_dtypes') is not None} (the port uses neither)")
    name, limit = (x.strip() for x in where.rsplit(",", 1))
    steps = math.ceil(BENCH_ROWS / BATCH)
    cache = r_trainers["100k"]._dev_cache["train"]
    base = Config(model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS, n_feats=TRAIN_FEATS,
                  batch_size=BATCH, train_data=bench_100k, online=True, n_epochs=2,
                  max_nnz=N_FIELDS, n_threads=3, device=device.type)
    paths = {k: os.path.join(tmp, f"ckpt_{k}.ckpt") for k in ("async", "sync", "inline", "1m")}

    def trainer(state=None, **kw):
        """A card Trainer on phase 7's resident upload of the same file."""
        trn = Trainer(dataclasses.replace(base, **kw), state=state)
        trn._dev_cache["train"] = cache
        return trn

    def same(a, b) -> bool:
        return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))

    def timed_epoch(trn) -> float:
        """One train_epoch() (a save's join included), examples/s."""
        t0 = time.perf_counter()
        trn.train_epoch()
        torch.cuda.synchronize()
        return BENCH_ROWS / (time.perf_counter() - t0)

    # (a) resume: epoch 1 with an async save at its last step; a fresh
    # Trainer loads the file and trains epoch 2
    a = trainer(model_path=paths["async"], save_every=steps)
    init = clone_state(a.state)
    u = trainer(state=clone_state(init))
    ffm_fused_logits_grads.launches = ftrl_update.launches = 0
    eps = {"save_every": [timed_epoch(a)]}
    a_launches = (ffm_fused_logits_grads.launches, ftrl_update.launches)
    at_save = clone_state(a.logical_state)
    eps["none"] = [timed_epoch(u)]
    u.train_epoch()
    t0 = time.perf_counter()
    host, extra = ck.load_checkpoint(paths["async"])
    st = ck.state_from_jax_arrays(host, device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    file_same = same(st, at_save)
    b = trainer(state=st)
    b.train_epoch()
    resumed_same = same(b.state, u.state)
    print(f"checkpoint (a): epoch 1 with save_every={steps} (async) launched kernel #2 "
          f"{a_launches[0]} and the update kernel {a_launches[1]} times; the file's arrays "
          f"bit-identical to a clone at the save={file_same} (mid_training_step "
          f"{extra.get('mid_training_step')}); a fresh Trainer loaded it in {load_s:.3f} s and "
          f"trained epoch 2: bit-identical to the uninterrupted run={resumed_same} [{where}]")
    require(a_launches == (steps, steps), f"phase 8's epoch launched {a_launches}")
    require(file_same and extra.get("mid_training_step") == steps, "the async file differs")
    require(resumed_same, "resume from the checkpoint differs from the uninterrupted run")
    del host, st, b, u

    # (b) a synchronous save and an async one through the host copy, from
    # the same init: the same file
    saves = {"device_copy": a.checkpoint_log[0]}
    for how, asyn in (("sync", False), ("inline", True)):
        s = trainer(state=clone_state(init), model_path=paths[how], save_every=steps,
                    async_checkpoint=asyn, compress_level=1)
        if how == "inline":
            s._snapshot_copy_fits = lambda state: False
        s.train_epoch()
        s_host, s_extra = ck.load_checkpoint(paths[how])
        ok = (s_extra["mid_training_step"] == extra["mid_training_step"]
              and same(ck.state_from_jax_arrays(s_host, device), at_save))
        saves[how] = dict(s.checkpoint_log[0], level=1)
        print(f"checkpoint (b): the {how} save's file equals the async device copy's={ok}")
        require(ok and saves[how]["snapshot"] == how, f"the {how} save differs")
        del s, s_host
    del init, at_save

    # (c) the times
    rec = {
        "cell": "train-ffm-100k-resident",
        "level": base.compress_level,
        "saves": saves,
        "load_s": load_s,
        "examples_per_s": eps,
        "name": name,
        "power.limit": limit,
    }
    print(f"checkpoint ffm-100k: {json.dumps(rec)}")
    require(a.checkpoint_log[0]["snapshot"] == "device_copy", "the 100k copy did not fit")
    require(all(r.get("file_bytes", 0) > 0 for r in rec["saves"].values()), "a save wrote nothing")

    # (d) the reference blob at full width, into a fresh card Trainer
    bias, lin_w, vec_w = a.model.materialize_weights(a.logical_state)
    blob = os.path.join(tmp, "ref100k.zst")
    t0 = time.perf_counter()
    ck.export_reference_model(blob, float(bias), lin_w, vec_w)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    weights = ck.import_reference_model(blob, TRAIN_FEATS, base.ref_row_width)
    w = trainer()
    w.state = w.model.init_from_weights(*weights, device=device)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    b2, l2, v2 = w.model.materialize_weights(w.logical_state)
    floats = 1 + TRAIN_FEATS + TRAIN_FEATS * base.ref_row_width
    ok = (torch.equal(l2, lin_w) and torch.equal(v2, vec_w)
          and abs(float(b2) - float(bias)) <= 1e-6 * abs(float(bias))
          and torch.equal(w.state.vec_w[:, N_FIELDS], w.state.lin_w))
    # the text form on a small table (Python writes it a float at a time)
    small = dataclasses.replace(base, n_feats=2000)
    sm = Trainer(small, state=seeded_state(small, device, 11))
    sb, sl, sv = sm.model.materialize_weights(sm.logical_state)
    txt = os.path.join(tmp, "ref2k.txt")
    ck.export_reference_text_model(txt, float(sb), sl, sv)
    st2 = sm.model.init_from_weights(*ck.import_reference_text_model(txt, 2000, small.ref_row_width),
                                     device=device)
    tb, tl, tv = sm.model.materialize_weights(st2)
    txt_ok = (torch.equal(tl, sl) and torch.equal(tv, sv)
              and abs(float(tb) - float(sb)) <= 1e-6 * abs(float(sb)))
    print(f"checkpoint (d): reference blob of {floats} floats ({os.path.getsize(blob)} bytes) "
          f"exported in {export_s:.3f} s, imported into a fresh card Trainer in {import_s:.3f} s: "
          f"lin_w and vec_w bit for bit, bias within 1e-6, lane {N_FIELDS} = lin_w: {ok}; the "
          f"text form at 2,000 rows the same: {txt_ok} [{where}]")
    require(ok and txt_ok, "the reference import/export does not round-trip")
    del w, weights, b2, l2, v2, bias, lin_w, vec_w, sm, st2, a
    os.unlink(blob)

    # (e) LR-100k, FM-100k and FFM-100k-bf16 (phase 7's trained states)
    tables = {}
    for label, trn in (("lr-100k", lrfm_trainers["train-lr-100k-resident"]),
                       ("fm-100k", lrfm_trainers["train-fm-100k-resident"]),
                       ("ffm-100k-bf16", r_trainers["100k-bf16"])):
        path = os.path.join(tmp, f"ckpt_{label}.ckpt")
        stats = ck.save_checkpoint(path, trn.logical_state, level=1,
                                   extra={"model_config": ck.model_signature(trn.cfg)})
        t0 = time.perf_counter()
        host, got_extra = ck.load_checkpoint(path)
        got = ck.state_from_jax_arrays(host, device)
        torch.cuda.synchronize()
        ck.validate_header_compat(trn.cfg, got_extra, path)
        tables[label] = {"same": same(got, trn.logical_state), "level": 1,
                         "load_s": time.perf_counter() - t0, **stats}
        require(tables[label]["same"], f"{label}: the checkpoint does not round-trip")
        os.unlink(path)
        del host, got
    print(f"checkpoint tables: {json.dumps(tables)} [{where}]")

    # (f) one async write of the 1M "inplace" state (7.7 GB) at level 1
    free = shutil.disk_usage(tmp).free
    big = {"free_disk_bytes": free, "level": 1}
    if free >= 20e9:
        r = r_trainers["1M"]
        cfg0 = r.cfg
        r.cfg = dataclasses.replace(cfg0, model_path=paths["1m"], compress_level=1)
        dev_free = torch.cuda.mem_get_info(device)[0]
        t0 = time.perf_counter()
        r._save_mid_checkpoint(r._steps_done)
        stall = time.perf_counter() - t0
        t0 = time.perf_counter()
        r.train_epoch()  # joins the write at its end
        epoch_s = time.perf_counter() - t0
        r.cfg = cfg0
        t0 = time.perf_counter()
        host, _ = ck.load_checkpoint(paths["1m"])
        load_1m_s = time.perf_counter() - t0
        mirror = all(np.array_equal(getattr(host, "lin_" + t), getattr(host, "vec_" + t)[:, N_FIELDS])
                     for t in ("n", "z", "w"))
        big.update(r.checkpoint_log[-1], stall_measured_s=stall, epoch_with_join_s=epoch_s,
                   load_s=load_1m_s, device_free_bytes=dev_free, mirror_equal=mirror,
                   touched_rows=float((host.lin_n > 0).mean()))
        del host
        os.unlink(paths["1m"])
        require(mirror, "the 1M checkpoint's linear tables differ from the mirror lane")
        require(big["snapshot"] == "device_copy", "the 1M copy did not fit beside phase 7's state")
    else:
        print(f"checkpoint (f): skipped: {free / 1e9:.1f} GB free under {tmp}, 20 GB needed")
    big.update(name=name, **{"power.limit": limit})
    print(f"checkpoint ffm-1m: {json.dumps(big)}")
    for p in paths.values():
        if os.path.exists(p):
            os.unlink(p)
    torch.cuda.empty_cache()
    print(f"checkpoint: phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return {"ffm-100k": rec, "tables": tables, "ffm-1m": big}


def scaled_counts(counts: dict, num: int, den: int) -> dict:
    """Launch counts (read_launch_counts' form) times num / den, by
    wrapper and by instance and dtype: the launches of a run whose steps
    are num for one of den."""
    return {k: (v * num // den if isinstance(v, int) else
                {i: n * num // den for i, n in v.items()}) for k, v in counts.items()}


def graph_pool_bytes() -> int:
    """Bytes the caching allocator holds in private pools: the captured
    CUDA graphs' memory."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def release_graphs(trainers) -> None:
    """Drop the trainers' captured groups and give their pools back to the
    card (the next grouped epoch captures again)."""
    for trn in trainers:
        trn._graphs.clear()
    torch.cuda.empty_cache()


def record_uploads(trn) -> list:
    """Record (bytes, tiers, host ms) of each upload form trn's feeder and
    predict_file take (Trainer._compact, wrapped and timed: the forms go
    on as they are; transfer.py::describe_upload names the tiers)."""
    from ftrl_ffm_tpu_torch.transfer import describe_upload

    log = []
    compact = trn._compact

    def rec(arrays, role="train"):
        t0 = time.perf_counter()
        up = compact(arrays, role)
        ms = (time.perf_counter() - t0) * 1e3
        tiers, size = describe_upload(up)
        log.append((size, tiers, ms))
        return up

    trn._compact = rec
    return log


def tier_counts(log) -> dict:
    """Batches of an upload log by tier."""
    counts: dict = {}
    for _, tiers, _ in log:
        for t in tiers:
            counts[t] = counts.get(t, 0) + 1
    return dict(sorted(counts.items()))


def multi_step_phase(device, where: str, r_trainers: dict, lrfm_r: dict) -> dict:
    """Phase 10: steps_per_call = S > 1, one CUDA-graph replay a group, on
    phase 7's resident datasets (400,000 rows, bench.py's config through
    the bench twin's make_config, online, B=16,384: 25 steps an epoch, 7
    groups at S=4, the last padded with 3 inert steps; 4 groups at S=8).
    Each cell trains an S = 1 Trainer and an S Trainer from one seeded
    init for 2 epochs and evaluates once: the tables, losses and eval
    bit-identical, the launches the S = 1 run's times ceil(25/S)*S/25 by
    kernel instance, every group after the first of its kind a replay,
    the peak device memory above the state (train and eval graphs alive);
    then the bench twin's run protocol on both (examples/s side by side);
    last, one traced epoch each (idle share).  Also: streamed FFM-100k
    epochs through the feeder (feed_workers 1 and 2, and 2 at S=4)
    bit-identical to the resident epoch, with the profiler's H2D copy ms
    a batch, the S=4 run's graph pool beside the resident S=4 run's, and
    _compact's host ms split into the native pass and the rest; a state swap (init_from_weights) that forces a new capture,
    then equal to an eager twin; one replayed epoch under
    set_sync_debug_mode("error").  Returns the S runs' launch counts by
    cell (train and eval), for the kernels' record."""
    from ftrl_ffm_tpu_torch import bench
    from ftrl_ffm_tpu_torch.models import make_model
    from ftrl_ffm_tpu_torch.tools import profile_ms, read_launch_counts, reset_launch_counts
    from ftrl_ffm_tpu_torch.train import Trainer

    t_phase = time.perf_counter()
    steps = math.ceil(BENCH_ROWS / BATCH)
    same = lambda a, b: all(  # noqa: E731
        (x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))
    gb = 1e9
    cells = (
        # S=5 divides the 25 steps: no inert step, the padding's cost apart
        ("lr-100k", lrfm_r["train-lr-100k-resident"], {"model_type": "LR"}, (4, 5, 8)),
        ("fm-100k", lrfm_r["train-fm-100k-resident"], {"model_type": "FM"}, (4, 8)),
        ("fm-4m-dense", lrfm_r["train-fm-4m-dense-resident"],
         {"model_type": "FM", "n_feats": HASH_FEATS, "update_mode": "dense"}, (4, 8)),
        ("fm-4m-zipf", lrfm_r["train-fm-4m-zipf-resident"],
         {"model_type": "FM", "n_feats": HASH_FEATS, "update_mode": "inplace"}, (4,)),
        ("ffm-100k", r_trainers["100k"], {}, (4, 5)),
        ("ffm-100k-bf16", r_trainers["100k-bf16"],
         {"table_dtype": "bfloat16", "acc_dtype": "bfloat16"}, (4,)),
        ("ffm-1m", r_trainers["1M"], {"n_feats": N_FEATS, "update_mode": "inplace"}, (4,)),
    )
    multi_counts, kept = {}, {}
    for label, src, over, s_values in cells:
        path, cache = src.cfg.train_data, src._dev_cache["train"]

        def config(s, **kw):
            # the bench twin's config; eval reads the same resident rows
            return bench.make_config(path, "cuda", eval_data=path, steps_per_call=s,
                                     **{**over, **kw})

        torch.cuda.empty_cache()
        init = make_model(config(1)).init(torch.Generator(device=device).manual_seed(SEED))
        trainers = {s: Trainer(config(s), state=clone_state(init)) for s in (1, *s_values)}
        del init
        runs = {}
        for s, trn in trainers.items():
            trn._dev_cache["train"] = trn._dev_cache["eval"] = cache  # no second upload
            torch.cuda.synchronize()
            base, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            losses = [trn.train_epoch()]
            if label == "ffm-100k" and s == 1:
                epoch1 = (clone_state(trn.state), losses[0])
            losses.append(trn.train_epoch())
            counts = read_launch_counts()
            train_dispatch = dict(trn.group_dispatch)
            train_pools = graph_pool_bytes()  # the train graphs alone
            reset_launch_counts()
            metrics = trn.evaluate()
            eval_counts = read_launch_counts()
            torch.cuda.synchronize()
            # the train and the eval graph alive: their private pools
            runs[s] = {"trainer": trn, "losses": losses, "counts": counts, "eval": metrics,
                       "eval_counts": eval_counts, "train_dispatch": train_dispatch,
                       "dispatch": dict(trn.group_dispatch),
                       "peak_above_state_gb": (torch.cuda.max_memory_allocated() - base) / gb,
                       "reserved_growth_gb": (torch.cuda.memory_reserved() - reserved0) / gb,
                       "train_graph_pools_gb": train_pools / gb,
                       "graph_pools_gb": graph_pool_bytes() / gb}
        one = runs[1]
        for s in s_values:
            r = runs[s]
            groups = math.ceil(steps / s)
            padded = groups * s
            ok = (same(r["trainer"].state, one["trainer"].state) and r["losses"] == one["losses"]
                  and r["eval"] == one["eval"])
            require(ok, f"multi-step {label} S={s}: tables, losses or eval differ from S=1 "
                        f"({r['losses']} {r['eval']} against {one['losses']} {one['eval']})")
            require(r["counts"] == scaled_counts(one["counts"], 2 * padded, 2 * steps),
                    f"multi-step {label} S={s}: launches {r['counts']}, S=1 {one['counts']}")
            require(r["eval_counts"] == scaled_counts(one["eval_counts"], padded, steps),
                    f"multi-step {label} S={s}: eval launches {r['eval_counts']}, S=1 "
                    f"{one['eval_counts']}")
            want = {"eager": 1, "captures": 1, "replays": 2 * groups - 1}
            require(r["train_dispatch"] == want,
                    f"multi-step {label} S={s}: train groups dispatched {r['train_dispatch']}")
            require(r["dispatch"] == {"eager": 2, "captures": 2,
                                      "replays": 2 * groups - 1 + groups - 1},
                    f"multi-step {label} S={s}: groups dispatched {r['dispatch']}")
        # the bench twin's protocol (a warm-up epoch, best of 3), S = 1 first
        for s in (1, *s_values):
            res = bench.run(config(s), trainer=runs[s]["trainer"])
            runs[s].update(examples_per_s=res["value"], runs=res["runs"],
                           timed_launches=res["launches"])
        for s in s_values:
            require(same(runs[s]["trainer"].state, one["trainer"].state),
                    f"multi-step {label} S={s}: the states differ after the bench protocol")
            padded = math.ceil(steps / s) * s
            require(runs[s]["timed_launches"] == scaled_counts(
                one["timed_launches"], padded, steps),
                f"multi-step {label} S={s}: the timed epochs launched "
                f"{runs[s]['timed_launches']}")
        rec = {"cell": label, "card": where, "steps_per_epoch": steps,
               **{f"S={s}": {k: v for k, v in r.items() if k not in ("trainer", "counts",
                                                                     "eval_counts")}
                  for s, r in runs.items()},
               "launches_S1": one["counts"],
               "launches_S": {s: runs[s]["counts"] for s in s_values}}
        print(f"multi-step {label}: {json.dumps(rec)}")
        s = s_values[0]
        multi_counts[label] = {"train": runs[s]["counts"], "eval": runs[s]["eval_counts"]}
        if label == "ffm-100k":
            resident_pools = {k: runs[4][k] for k in ("train_graph_pools_gb", "graph_pools_gb")}
        kept[label] = trainers
        release_graphs(trainers.values())  # captured again when traced

    # streamed FFM-100k through the feeder: one epoch from the 100k init,
    # the resident S=1 epoch's bits; feed_workers 1 with the transfer
    # tiers on (the default) and off, 2, and 2 at S=4, whose second epoch
    # captures nothing new (the full groups' key and the padded last
    # group's, whose tiers differ, were both captured in epoch 1)
    ffm = kept["ffm-100k"]
    path = ffm[1].cfg.train_data
    init = make_model(ffm[1].cfg).init(torch.Generator(device=device).manual_seed(SEED))
    streamed = {}
    for workers, s, compact in ((1, 1, True), (1, 1, False), (2, 1, True), (2, 4, True)):
        trn = Trainer(bench.make_config(path, "cuda", device_cache="off", feed_workers=workers,
                                        steps_per_call=s, compact_transfer=compact),
                      state=clone_state(init))
        log = record_uploads(trn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trn.train_epoch()
        wall = time.perf_counter() - t0
        require(same(trn.state, epoch1[0]) and loss == epoch1[1] and "train" not in trn._dev_cache,
                f"streamed feed_workers={workers} S={s} compact_transfer={compact}: differs "
                f"from the resident epoch")
        key = f"feed_workers={workers} S={s}" + ("" if compact else " compact_transfer=false")
        rec = {"trainer": trn, "examples_per_s": BENCH_ROWS / wall,
               "bytes_a_batch": sum(b for b, _, _ in log) / (len(log) * s),
               "compact_ms": sum(ms for _, _, ms in log) / (len(log) * s),
               "tiers": tier_counts(log)}
        if s > 1:
            first = dict(trn.group_dispatch)
            trn.train_epoch()
            rec["dispatch"] = [first, dict(trn.group_dispatch)]
            # two keys' graphs in one shared pool
            rec["graph_pools_gb"] = graph_pool_bytes() / gb
            require(first["captures"] == 2 and trn.group_dispatch["captures"] == 2
                    and trn.group_dispatch["eager"] == 2, f"streamed S={s}: groups dispatched "
                    f"{first} in epoch 1, {trn.group_dispatch} after epoch 2")
        release_graphs([trn])
        streamed[key] = rec
    on, off = streamed["feed_workers=1 S=1"], streamed["feed_workers=1 S=1 compact_transfer=false"]
    require({"delta", "ones", "iota"} <= set(on["tiers"]) and set(off["tiers"]) == {"off"},
            f"streamed tiers {on['tiers']} / {off['tiers']}")
    from ftrl_ffm_tpu_torch import native

    print(f"multi-step streamed ffm-100k: one epoch bit-identical to the resident one at "
          + ", ".join(f"{k} ({v['examples_per_s']:.0f} examples/s, {v['bytes_a_batch']:.0f} "
                      f"bytes a batch, _compact {v['compact_ms']:.3f} host ms a batch, tiers "
                      f"{v['tiers']})" for k, v in streamed.items())
          + f"; the native compaction pass {'built' if native.lib() else 'absent (numpy)'}"
          + f"; S=4 groups dispatched {streamed['feed_workers=2 S=4']['dispatch']} after "
            f"epochs 1 and 2, their graphs' pool "
            f"{streamed['feed_workers=2 S=4']['graph_pools_gb']:.6f} GB against the resident "
            f"S=4 run's {resident_pools['train_graph_pools_gb']:.6f} GB (train graph) and "
            f"{resident_pools['graph_pools_gb']:.6f} GB (train and eval graphs); host "
            f"os.cpu_count()={os.cpu_count()} [{where}]")

    # where _compact's host time goes on the file's full batches: the
    # native pass (at 1 thread, as _compact calls it, and at 4), the whole
    # call, and the whole call on the numpy path; the four interleaved,
    # 3 rounds, the best round of each
    trn = on["trainer"]
    batches = [a for _, a in zip(range(8), trn._train_batches(np.random.default_rng(0)))]
    f_dim = batches[0][1].shape[-1]
    real = native.compact_batch

    def numpy_path(arrays):
        native.compact_batch = lambda *a, **k: None
        try:
            Trainer._compact(trn, arrays, "train")
        finally:
            native.compact_batch = real

    ways = {
        "native pass 1 thread": lambda a: real(a[1], a[2], a[0], trn.cfg.n_feats, True, 1),
        "native pass 4 threads": lambda a: real(a[1], a[2], a[0], trn.cfg.n_feats, True, 4),
        "_compact": lambda a: Trainer._compact(trn, a, "train"),
        "_compact numpy path": numpy_path,
    }
    split = {k: math.inf for k in ways}
    for _ in range(3):
        for k, way in ways.items():
            t0 = time.perf_counter()
            for arrays in batches:
                way(arrays)
            split[k] = min(split[k], (time.perf_counter() - t0) * 1e3 / len(batches))
    print(f"multi-step streamed ffm-100k: _compact host ms a batch of {BATCH}x{f_dim} "
          f"(the mean over {len(batches)} batches, best of 3 interleaved rounds) "
          f"{json.dumps(split)} [{where}]")
    del batches

    # a state swap between epochs: new tensors, so a new capture; the next
    # epoch equals an eager run from the same weights
    trn = ffm[4]
    trn.state = trn.model.init_from_weights(
        *trn.model.materialize_weights(trn.logical_state), device=device)
    twin = Trainer(ffm[1].cfg, state=clone_state(trn.state))
    twin._dev_cache["train"] = trn._dev_cache["train"]
    before = dict(trn.group_dispatch)
    l_graph, l_eager = trn.train_epoch(), twin.train_epoch()
    groups = math.ceil(steps / 4)
    require(trn.group_dispatch == {"eager": before["eager"] + 1,
                                   "captures": before["captures"] + 1,
                                   "replays": before["replays"] + groups - 1},
            f"the swapped state was not captured again: {before} -> {trn.group_dispatch}")
    require(same(trn.state, twin.state) and l_graph == l_eager,
            "the epoch after a state swap differs from an eager run from the same weights")
    # one replayed epoch under the sync guard (its graph is captured)
    cache = trn._fresh_cache("train")
    before = dict(trn.group_dispatch)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sums = trn._train_groups(trn._cached_groups(cache, None))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g_loss = trn._epoch_loss(sums)
    require(trn.group_dispatch["replays"] == before["replays"] + groups
            and trn.group_dispatch["captures"] == before["captures"] and math.isfinite(g_loss),
            f"the guarded epoch: {before} -> {trn.group_dispatch}")
    print(f"multi-step ffm-100k S=4: a state swap (init_from_weights) captured again "
          f"({trn.group_dispatch}) and its epoch equals an eager run's (loss {l_graph}); one "
          f"epoch of {groups} replays under set_sync_debug_mode('error'): no host sync")
    del twin
    release_graphs([trn])

    # the traced epochs, last (profile_ms's untraced first epoch captures
    # the groups again, so the traced one replays them all): the device's
    # busy share of one epoch each
    def idle(trn):
        walls = []

        def epoch():
            t0 = time.perf_counter()
            trn.train_epoch()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)

        rows = profile_ms(epoch, 1)
        busy = sum(ms for _, ms in rows)
        return 1 - busy / walls[-1], rows

    device_step = {}  # device ms a step of each traced resident epoch
    for label, trns in kept.items():
        shares = {}
        for s, t in trns.items():
            shares[f"S={s}"], rows = idle(t)
            device_step[label, s] = sum(ms for _, ms in rows) / steps
            release_graphs([t])
        print(f"profile: multi-step {label} train_epoch() idle share {json.dumps(shares)}; "
              f"device ms a step {json.dumps({f'S={s}': device_step[label, s] for s in trns})} "
              f"[{where}]")
    for key, rec in streamed.items():
        share, rows = idle(rec["trainer"])
        release_graphs([rec["trainer"]])
        h2d = sum(ms for name, ms in rows if "HtoD" in name) / steps
        print(f"profile: multi-step streamed ffm-100k {key}: idle share {share:.4f}; H2D copies "
              f"{h2d:.4f} ms a batch of {rec['bytes_a_batch']:.0f} bytes against the resident "
              f"epoch's {device_step['ffm-100k', 1]:.4f} device ms a step [{where}]")
    print(f"multi-step: phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return multi_counts


def transfer_phase(bench_100k: str, tmp: str, where: str) -> dict:
    """Phase 10b: the transfer tiers that phase 10's file (one feature a
    field in slot order, per-field ids, values 1: delta ids, the all-ones
    and iota markers) does not reach, on a small streamed file at bench.py's
    width (FFM-100k, B=16,384, 39 fields): 2 full batches and a padded
    third, every row's ids drawn over the whole table (delta fails: the
    split tier), its fields in a shuffled order (the packed planes) and its
    values 6-decimal (DEC6).  One training epoch, an eval pass and
    predict_file with the tiers on and off: the losses, tables and
    prediction bytes bit for bit, and each batch's tiers counted.  The
    DEC6 probe must pass on the card.  Then the decode's device time:
    widen_batch on one uploaded batch of each form (this file's, and phase
    10's first full batch), 50 calls replayed from a CUDA graph, beside
    the same batch uploaded as parsed.  Returns the counts and times."""
    from ftrl_ffm_tpu_torch import bench
    from ftrl_ffm_tpu_torch.data.stream import StreamReader
    from ftrl_ffm_tpu_torch.models.base import widen_batch
    from ftrl_ffm_tpu_torch.tools import graph_ms
    from ftrl_ffm_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    n = 2 * BATCH + 3000
    rng = np.random.default_rng(11)
    ids = rng.integers(0, TRAIN_FEATS, (n, N_FIELDS))
    keys = rng.integers(0, 10**6, (n, N_FIELDS))
    order = np.argsort(rng.random((n, N_FIELDS)), axis=1)
    y = rng.integers(0, 2, n)
    path = os.path.join(tmp, "tiers.ffm")
    with open(path, "w") as f:
        for i in range(n):
            f.write(" ".join([str(y[i])] + [f"{c}:{ids[i, c]}:{keys[i, c] / 1e6:.6f}"
                                             for c in order[i]]) + "\n")
    runs = {}
    for compact in (True, False):
        trn = Trainer(bench.make_config(path, "cuda", eval_data=path, device_cache="off",
                                        compact_transfer=compact))
        log = record_uploads(trn)
        loss = trn.train_epoch()
        metrics = trn.evaluate()
        out = os.path.join(tmp, f"tiers_{compact}.txt")
        trn.predict_file(path, out)
        with open(out, "rb") as fh:
            runs[compact] = {"trainer": trn, "loss": loss, "eval": metrics, "pred": fh.read(),
                             "tiers": tier_counts(log),
                             "bytes_a_batch": sum(b for b, _, _ in log) / len(log),
                             "compact_ms": sum(ms for _, _, ms in log) / len(log)}
    on, off = runs[True], runs[False]
    require(on["loss"] == off["loss"] and on["eval"] == off["eval"] and on["pred"] == off["pred"]
            and all(torch.equal(a, b) for a, b in zip(on["trainer"].state, off["trainer"].state)
                    if a is not None),
            f"the tiers on and off differ: {on['loss']} {on['eval']} / {off['loss']} {off['eval']}")
    # 3 batches a pass: train, eval, predict
    require(all(on["tiers"].get(t) == 9 for t in ("split", "dec6", "packed"))
            and off["tiers"] == {"off": 9}, f"tiers taken: {on['tiers']} / {off['tiers']}")
    dec6_ok = on["trainer"]._dec6_device_ok()
    require(dec6_ok, "the DEC6 probe fails on the card")
    print(f"transfer tiers: a streamed epoch, eval ({on['eval']}) and predict_file bit for bit "
          f"with compact_transfer on and off (loss {on['loss']}); batches by tier on "
          f"{json.dumps(on['tiers'])}, off {json.dumps(off['tiers'])}; bytes a batch "
          f"{on['bytes_a_batch']:.0f} against {off['bytes_a_batch']:.0f}; _compact "
          f"{on['compact_ms']:.3f} host ms a batch; DEC6 probe on the card: {dec6_ok} [{where}]")

    decode = {}
    for label, src in (("split dec6 packed", path), ("delta ones iota", bench_100k)):
        arrays = next(iter(StreamReader(src, "libffm", BATCH, N_FIELDS, TRAIN_FEATS, N_FIELDS,
                                        log_every=0).batches()))
        for compact in (True, False):
            trn = runs[compact]["trainer"]
            trn._delta_ok = trn._dec6_ok = True  # each file's batch its own tiers
            up = trn._compact(arrays, "eval")
            batch = trn._place_batch(up)
            want = widen_batch(trn._place_batch(arrays))
            got = widen_batch(batch)
            require(all(torch.equal(a, b) for a, b in zip(got[:5], want[:5])),
                    f"the decode of {label} differs from the parsed batch")
            decode[f"{label} {'on' if compact else 'off'}"] = graph_ms(
                lambda b=batch: widen_batch(b), 50)
    print(f"transfer tiers: widen_batch device ms a batch (B={BATCH}, 50 calls replayed from a "
          f"CUDA graph) {json.dumps(decode)} [{where}]")
    del runs
    print(f"transfer tiers: phase 10b took {time.perf_counter() - t0:.1f} s")
    return {"decode_ms": decode}


def matrix_transfer(tmp: str, where: str) -> None:
    """Phase 9, after the matrix: its streamed numeric and noncanon rows'
    files (ROWS_SAMPLES=65,536 under TMPDIR), the row's config, with the
    tiers on and off in this process: a warm-up epoch, a timed one
    (examples/s; this process ran phase 6's profiler, so the host's side
    may be slower than in the matrix's own process, alike on and off) and
    a traced one (the idle share, H2D copy ms a batch), bytes a batch and
    the tiers each batch took; the epochs' bits on against off."""
    import glob

    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.tools import profile_ms
    from ftrl_ffm_tpu_torch.train import Trainer

    for row in ("numeric", "noncanon"):
        (path,) = glob.glob(os.path.join(tmp, f"ftrl_ffm_tpu_bench_65536_100000_{row}.txt"))
        out = {}
        for compact in (True, False):
            # bench_matrix.row_config's row, streamed
            trn = Trainer(Config(train_data=path, model_type="FFM", n_fields=N_FIELDS,
                                 n_feats=TRAIN_FEATS, n_factors=N_FACTORS, online=True,
                                 n_epochs=1, batch_size=8192, max_nnz=N_FIELDS, n_threads=3,
                                 file_type="libffm", compact_transfer=compact, device="cuda"))
            log = record_uploads(trn)
            walls, losses = [], []

            def epoch():
                t0 = time.perf_counter()
                losses.append(trn.train_epoch())
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)

            epoch()  # warm-up (the profile's warm-up epoch is the timed one)
            rows = profile_ms(epoch, 1)
            steps = len(log) // 3
            out[compact] = {
                "examples_per_s": 65536 / walls[1] * 1e3,
                "idle": 1 - sum(ms for _, ms in rows) / walls[-1],
                "h2d_ms": sum(ms for name, ms in rows if "HtoD" in name) / steps,
                "bytes_a_batch": sum(b for b, _, _ in log) / len(log),
                "compact_ms": sum(ms for _, _, ms in log) / len(log),
                "tiers": tier_counts(log[-steps:]), "losses": losses, "state": trn.state}
        on, off = out[True], out[False]
        require(on["losses"] == off["losses"] and all(
            torch.equal(a, b) for a, b in zip(on["state"], off["state"]) if a is not None),
            f"matrix {row}: the tiers on and off differ")
        print(f"transfer matrix {row}: " + "; ".join(
            f"compact_transfer {'on' if c else 'off'}: {r['examples_per_s']:.0f} examples/s, "
            f"idle share {r['idle']:.4f}, H2D {r['h2d_ms']:.4f} ms a batch of "
            f"{r['bytes_a_batch']:.0f} bytes, _compact {r['compact_ms']:.3f} host ms a batch, "
            f"tiers {json.dumps(r['tiers'])}"
            for c, r in out.items()) + f" [{where}]")


def generator_phase(tmp: str, where: str) -> None:
    """Phase 9: the pandas-free data generator (ftrl_ffm_tpu_torch/tools/
    generate_data.py) in a process of its own on a csv with a header,
    integer and string categoricals and two numeric columns (MinMax
    normalized, printed with 4 decimals), then an epoch and an eval pass of
    FFM on its libffm output with the tiers on and off: the same bits, and
    its values on the DEC6 tier."""
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.train import Trainer

    rng = np.random.default_rng(5)
    n = 40_000
    csv_path = os.path.join(tmp, "ratings.csv")
    with open(csv_path, "w") as f:
        f.write("rating,user,item,city,age,price\n")
        for i in range(n):
            f.write(f"{int(rng.integers(0, 6))},{int(rng.integers(1, 5000))},"
                    f"i{int(rng.integers(0, 3000))},c{int(rng.integers(0, 40))},"
                    f"{int(rng.integers(18, 90))},{rng.random() * 500:.2f}\n")
    train, evald = os.path.join(tmp, "gen_train.ffm"), os.path.join(tmp, "gen_eval.ffm")
    text, secs = run_tool("generate_data", [
        "ftrl_ffm_tpu_torch.tools.generate_data", "--data_path", csv_path,
        "--train_output_path", train, "--eval_output_path", evald, "--cat_cols", "1,2,3",
        "--num_cols", "4,5", "--normalize", "true", "--ffm", "true", "--threshold", "2"],
        {"TMPDIR": tmp}, 120)
    require(f"Output train size: {int(n * 0.8)}" in text, f"generate_data printed {text!r}")
    runs = {}
    for compact in (True, False):
        trn = Trainer(Config(train_data=train, eval_data=evald, model_type="FFM", n_fields=5,
                             n_feats=TRAIN_FEATS, n_factors=N_FACTORS, batch_size=4096,
                             device_cache="off", compact_transfer=compact, device="cuda"))
        log = record_uploads(trn)
        runs[compact] = (trn.train_epoch(), trn.evaluate(), trn.state, tier_counts(log))
    (l_on, e_on, s_on, t_on), (l_off, e_off, s_off, _) = runs[True], runs[False]
    require(l_on == l_off and e_on == e_off and math.isfinite(l_on) and all(
        torch.equal(a, b) for a, b in zip(s_on, s_off) if a is not None) and t_on.get("dec6"),
        f"generated data: tiers on {l_on} {e_on} {t_on}, off {l_off} {e_off}")
    print(f"tools generate_data: {n} csv rows in {secs:.1f} s; FFM on its output: train loss "
          f"{l_on:.6f}, eval {e_on}, the tiers on and off bit for bit, batches by tier "
          f"{json.dumps(t_on)} [{where}]")


def run_tool(label: str, args: list, env: dict, timeout: int) -> tuple[str, float]:
    """Phase 9: one tool of ftrl_ffm_tpu_torch as a subprocess (python -m
    <args>) from the repository's root with `env` added; its standard
    output (echoed, one line each, prefixed) and seconds.  A non-zero exit
    fails the smoke run."""
    root = os.path.dirname(os.path.abspath(__file__))
    full = dict(os.environ, **env)
    full["PYTHONPATH"] = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=root, env=full, text=True,
                          capture_output=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"tools {label}: {line}")
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
    require(proc.returncode == 0, f"{label} exited {proc.returncode}")
    print(f"tools {label}: {seconds:.1f} s")
    return proc.stdout, seconds


def json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def tools_phase(bench_100k: str, train_100k: str, tmp: str, where: str) -> dict:
    """Phase 9: the measurement tools through their entry points, each in
    its own process on the card (the bench twin on phase 7's file; the
    bench matrix's nine rows at 65,536 rows, ffm1m under update_mode
    inplace and dense; profile_step's cuda, infer, huge and trace phases,
    huge under both kinds; the roofline of the 100k "dense2" and the 1M
    "inplace" steps; micro_scatter at its defaults), then one CLI training
    run with --profile_dir in this process, whose trace must name kernel
    #2 and the update kernel.  Every tool's exit code and output are
    checked.  Returns what the tools printed, parsed."""
    from ftrl_ffm_tpu_torch import bench, cli
    from ftrl_ffm_tpu_torch.tools import bench_matrix, micro_scatter

    env = {"TMPDIR": tmp}
    out = {}
    steps = 3 * math.ceil(BENCH_ROWS / BATCH)
    text, _ = run_tool("bench", ["ftrl_ffm_tpu_torch.bench", "--data", bench_100k], env, 300)
    (line,) = json_lines(text)
    require(tuple(line) == bench.PRINTED and line["metric"] == bench.METRIC,
            f"the bench twin printed {line}")
    require(line["launches"]["ffm_fused_logits_grads"] == steps == line["launches"]["ftrl_update"],
            f"the bench twin's timed epochs launched {line['launches']}, expect {steps} of each")
    require(line["device_cache"] and line["batch"] == BATCH and line["device"] == where
            and line["value"] > 0, f"the bench twin printed {line}")
    out["bench"] = line

    rows = []
    matrix_env = dict(env, ROWS_SAMPLES="65536")
    others = [r for r in bench_matrix.ROWS if r != "ffm1m"]
    text, _ = run_tool("bench_matrix", ["ftrl_ffm_tpu_torch.tools.bench_matrix", *others],
                       matrix_env, 600)
    rows += json_lines(text)
    # the streamed rows whose data reaches the value tiers, with the tiers
    # on and off in this process
    matrix_transfer(tmp, where)
    generator_phase(tmp, where)
    for mode, kind in (("inplace", "inplace"), ("dense", "dense2")):
        text, _ = run_tool(f"bench_matrix ffm1m {mode}",
                           ["ftrl_ffm_tpu_torch.tools.bench_matrix", "ffm1m"],
                           dict(matrix_env, UPDATE_MODE=mode), 300)
        (row,) = json_lines(text)
        require(row["update_kind"] == kind, f"ffm1m under {mode} ran {row['update_kind']}")
        rows.append(row)
    require(sorted(r["row"] for r in rows) == sorted([*others, "ffm1m", "ffm1m"]),
            f"the matrix printed rows {[r['row'] for r in rows]}")
    for r in rows:
        loss = r.get("train_loss", r.get("eval_loss"))
        require(r["examples_per_s"] > 0 and math.isfinite(loss) and r["device"] == where
                and (r["update_kind"] is None) == (r["row"] == "lr"), f"matrix row {r}")
    out["matrix"] = rows

    prof = {}
    for mode, phases in (("dense", ["cuda", "infer", "huge", "trace"]), ("inplace", ["huge"])):
        text, _ = run_tool(f"profile_step {mode}",
                           ["ftrl_ffm_tpu_torch.tools.profile_step", *phases],
                           dict(env, UPDATE_MODE=mode), 300)
        for phase in phases:
            if phase == "trace":
                require("ffm_fused_c40" in text and "ftrl_update" in text,
                        "profile_step's trace names no kernel #2 or update kernel")
                continue
            (ln,) = [ln for ln in text.splitlines() if ln.startswith(f"{phase}: ")]
            ms = float(ln.split()[1])
            require(ms > 0 and (phase == "infer" or "roofline floor" in ln),
                    f"profile_step {phase}: {ln}")
            prof[f"{phase} {mode}" if phase == "huge" else phase] = ln
    out["profile_step"] = prof

    for label, args in (("dense2 100k", ["--batch", str(BATCH)]),
                        ("inplace 1M", ["--batch", str(BATCH), "--n_feats", str(N_FEATS),
                                        "--update", "inplace"])):
        text, _ = run_tool(f"roofline {label}", ["ftrl_ffm_tpu_torch.tools.roofline", *args],
                           env, 120)
        require("floor @ 3350 GB/s" in text, f"roofline {label} printed no floor")
        out[f"roofline {label}"] = text.splitlines()[-1]

    text, _ = run_tool("micro_scatter", ["ftrl_ffm_tpu_torch.tools.micro_scatter"], env, 300)
    got = {ln.split()[0] for ln in text.splitlines() if ln.startswith("  ")}
    require(got == set(micro_scatter.PHASES), f"micro_scatter printed {got}")

    # the CLI with --profile_dir (epoch 1 traced) on phase 4b's training rows
    prof_dir = os.path.join(tmp, "profile")
    t0 = time.perf_counter()
    rc = cli.main(["--train_data", train_100k, "--model_type", "FFM", "--n_fields", str(N_FIELDS),
                   "--n_factors", str(N_FACTORS), "--n_feats", str(TRAIN_FEATS),
                   "--batch_size", str(BATCH), "--n_epochs", "1", "--profile_dir", prof_dir])
    traces = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)
              if f.endswith(".pt.trace.json")] if os.path.isdir(prof_dir) else []
    body = open(traces[0]).read() if len(traces) == 1 else ""
    named = {k: k in body for k in ("ffm_fused_c40", "ftrl_update_kernel")}
    print(f"tools cli --profile_dir: rc {rc}, traces {[os.path.basename(t) for t in traces]} "
          f"({len(body)} bytes), kernel names in it {named}; {time.perf_counter() - t0:.1f} s")
    require(rc == 0 and all(named.values()), "the --profile_dir trace misses the kernels")
    return out


# The (1, N) route cell's owner-side update (ffm16m-criteo-route4): a
# rank's 2^22-row shard of 640-lane rows, receiving from M = 4 peers
# K = 79,872 slots each (route_capacity 2.0): 319,488 slots a step
ROUTE_ROWS, ROUTE_PEERS, ROUTE_K = 1 << 22, 4, 79_872
ROUTE_BLOCK = 1 << 18  # the shard's S0 is drawn, and checked, in blocks of rows
ROUTE_HOT = 40_000  # the rows every peer draws half of its rows from


def route_shard_block(b: int, e: int, p, device) -> list:
    """Rows [b * ROUTE_BLOCK, (b + 1) * ROUTE_BLOCK) of the shard's six
    tables at S0, from a generator of their own (the same bits at every
    call): ftrl_tables, then w as kernel #3 with A = 0 leaves it (the CPU's
    sqrt may differ by an ulp), so a pass over an untouched row keeps it."""
    gen = torch.Generator(device=device).manual_seed(SEED * 1000 + b)
    vec = ftrl_tables(gen, device, p, ROUTE_BLOCK, e)
    lin = ftrl_tables(gen, device, p, ROUTE_BLOCK)
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import closed_form_pass

    for tabs in (vec, [t.view(-1, 1) for t in lin]):
        closed_form_pass(*tabs, torch.zeros_like(tabs[0]), p)
    return vec + lin


def routed_update_phase(device, where: str) -> dict:
    """Phase 3h: the routed update of a (1, N) mesh at the route cell's
    shapes (R = 2^22, E = 640, 319,488 received slots, ~80% empty, a row
    from up to 4 peers; recv_slots), the split payload (g, g^2) and the
    linear tables' [M*K, 2] stack as parallel/sharded.py::_update_routed
    hands them to ftrl_update under auto: one launch of the "rows"
    instance, no pass or scatter.  Held against
    - itself: a second launch from the same S0 gives the same bits;
    - ftrl_update_plain on the touched rows alone (the whole-shard plain
      step would not fit beside the shard): rtol=1e-5, atol=1e-6;
    - the in-place form it replaces (update_mode=inplace: za_scatter into
      z and a zeroed A, kernel #3 over the shard, the linear tables the
      same on [R, 1] views): touched rows rtol=1e-5, atol=1e-6;
    and every row no slot names keeps S0's bits under both forms.  Then
    both forms' milliseconds a step beside the touched form's bound."""
    from ftrl_ffm_tpu_torch.ftrl import FtrlParams
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update, ftrl_update_inplace, ftrl_update_plain

    torch.cuda.empty_cache()
    r, m, k, e, p = ROUTE_ROWS, ROUTE_PEERS, ROUTE_K, 40 * N_FACTORS, FtrlParams()
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(recv_slots(rng, r, m, k, 0.2, rng.choice(r, ROUTE_HOT, replace=False)))
    ids = ids.to(device)
    empty = ids == r
    gen = torch.Generator(device=device).manual_seed(SEED)
    # a slot holds a row's sums over its sender's occurrences: g, and g^2
    # of 1-3 of them; the send slots of no id hold zeros
    g = torch.randn((m * k, e), generator=gen, device=device) * 0.1
    reps = torch.randint(1, 4, (m * k, 1), generator=gen, device=device).float()
    g_lin = torch.randn((m * k, 1), generator=gen, device=device) * 0.1
    g2, g2_lin = g * g * reps, g_lin * g_lin * reps
    for t in (g, g2, g_lin, g2_lin):
        t[empty] = 0
    gg2_lin = torch.cat([g_lin, g2_lin], dim=-1)
    touched = torch.zeros(r, dtype=torch.bool, device=device)
    touched[ids[~empty].long()] = True
    rows = touched.nonzero().squeeze(1)
    n_real, n_rows = int((~empty).sum()), rows.numel()
    longest = int(torch.bincount(ids[~empty].long()).max())

    tables = ([torch.empty((r, e), device=device) for _ in range(3)]
              + [torch.empty(r, device=device) for _ in range(3)])
    blocks = [slice(b * ROUTE_BLOCK, (b + 1) * ROUTE_BLOCK) for b in range(r // ROUTE_BLOCK)]
    for b, sl in enumerate(blocks):
        for t, s in zip(tables, route_shard_block(b, e, p, device)):
            t[sl] = s
    at_s0 = [t[rows] for t in tables]

    def untouched_kept() -> bool:
        ok = True
        for b, sl in enumerate(blocks):
            keep = ~touched[sl]
            for t, s in zip(tables, route_shard_block(b, e, p, device)):
                ok &= torch.equal(t[sl][keep], s[keep])
        return ok

    def back_to_s0() -> None:  # only the touched rows moved
        for t, s in zip(tables, at_s0):
            t[rows] = s

    def touched_form() -> None:
        ftrl_update(*tables, ids, (g, g2), -1, p, gg2_lin)

    def inplace_form() -> None:
        ftrl_update_inplace(*tables[:3], ids, g, g2, p)
        ftrl_update_inplace(*(t.view(-1, 1) for t in tables[3:]), ids, g_lin, g2_lin, p)

    reset_counts()
    touched_form()
    torch.cuda.synchronize()
    counts = read_counts()
    got = [t[rows] for t in tables]
    kept = untouched_kept()
    back_to_s0()
    touched_form()
    torch.cuda.synchronize()
    same = all(torch.equal(t[rows], x) for t, x in zip(tables, got))
    back_to_s0()
    reset_counts()
    inplace_form()
    torch.cuda.synchronize()
    inplace_counts = read_counts()
    in_place = [t[rows] for t in tables]
    kept_inplace = untouched_kept()
    # the plain step on the touched rows alone: ids renumbered into them,
    # the empty slots past the end
    local = torch.where(empty, n_rows, torch.searchsorted(rows, ids.long())).to(torch.int32)
    vec, lin = ftrl_update_plain(*at_s0, local, torch.cat([g, g2], dim=-1), -1, p, gg2_lin)
    torch.cuda.synchronize()

    def err_ok(a, b):
        return (max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b)),
                all(torch.allclose(x, y, rtol=UPD_RTOL, atol=UPD_ATOL) for x, y in zip(a, b)))

    plain_err, plain_ok = err_ok(got, [*vec, *lin])
    inplace_err, inplace_ok = err_ok(got, in_place)
    same_as_inplace = all(torch.equal(x, y) for x, y in zip(got, in_place))
    del at_s0, got, in_place, vec, lin, local
    torch.cuda.empty_cache()
    # milliseconds a step of each form (the tables drift: their values do
    # not change the work); the touched form's bound: each filled slot's
    # payload read, each touched row's six coordinates a lane read and
    # written
    touched_ms = cuda_ms(touched_form, 20)
    inplace_ms = cuda_ms(inplace_form, 5)
    floor_ms, _ = bound(n_real * 2 * e * 4 + n_rows * 6 * (e + 1) * 4, 0)
    l, li = counts, inplace_counts
    launches_ok = (l["ftrl_update"] == 1 and l["update_by_instance"] == {"rows": 1}
                   and l["closed_form_pass"] == 0 and l["za_scatter"] == 0
                   and li["ftrl_update"] == 0 and li["closed_form_pass"] == 2
                   and li["za_scatter"] == 2)
    print(f"kernel ftrl_update routed (1,{m}): R={r} E={e} slots={m * k} filled {n_real} "
          f"({n_real / (m * k):.1%}), touched rows {n_rows}, longest segment {longest}; launches "
          f"ftrl_update {l['ftrl_update']} {l['update_by_instance']}, closed_form_pass "
          f"{l['closed_form_pass']}, za_scatter {l['za_scatter']} (in-place form: "
          f"closed_form_pass {li['closed_form_pass']}, za_scatter {li['za_scatter']}); repeat "
          f"bit-identical={same}; "
          f"untouched rows kept: touched form {kept}, in-place form {kept_inplace}; against the "
          f"plain step max_abs_err={plain_err:.3e} {'ok' if plain_ok else 'MISMATCH'}; against "
          f"the in-place form max_abs_err={inplace_err:.3e} {'ok' if inplace_ok else 'MISMATCH'} "
          f"(bit-identical={same_as_inplace}); a step: touched form {touched_ms:.4f} ms (bound "
          f"{floor_ms:.4f}, {floor_ms / touched_ms:.1%}), in-place form {inplace_ms:.3f} ms "
          f"[{where}]")
    require(longest <= m, f"routed update: a row from {longest} slots, more than {m} peers")
    require(launches_ok, f"routed update launches {l}, in-place form {li}")
    require(same, "the routed update is not deterministic")
    require(kept and kept_inplace, "a routed update changed a row no slot names")
    require(plain_ok, "the routed update disagrees with the plain step")
    require(inplace_ok, "the routed update disagrees with the in-place form")
    del tables, ids, g, g2, g_lin, g2_lin, gg2_lin, touched, rows
    torch.cuda.empty_cache()
    return {"touched_ms": touched_ms, "inplace_ms": inplace_ms, "bound_ms": floor_ms,
            "plain_err": plain_err, "inplace_err": inplace_err, "touched_rows": n_rows}


# Phase 11's process (python -c, the repository on sys.path): the port's
# CLI with the given flags, Trainer.train wrapped to record what the run
# did (nothing it computes changes): each train_epoch's seconds, the
# history, the launch counts and the tracing counters (the sharded train
# steps, the routed update's form) set to 0 just before train() and read
# just after (the launches again after the CLI's predict pass), the
# sharded step's lookup, update and routed-update forms, the collectives
# issued, and epoch 1's torch.profiler trace read back: the device's busy
# union, NCCL's kernels.  The resident datasets are built before train(), so the
# epochs (and the trace) hold the steps alone.  Mode "one" first runs the
# one-card Trainer (no mesh) from the same seeded init on the same file;
# mode "shard" builds the shard layout by hand (Trainer._build_device_cache
# with layout "shard": on one process a single slice and one inert row).
MESH_RUN = r"""
import glob, json, os, sys, time
import torch
import ftrl_ffm_tpu_torch.train as T
from ftrl_ffm_tpu_torch import bench, tracing
from ftrl_ffm_tpu_torch.cli import main
from ftrl_ffm_tpu_torch.parallel import dist
from ftrl_ffm_tpu_torch.tools import read_launch_counts, reset_launch_counts

mode, out, data, argv = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]
rec = {"epochs": []}
train, train_epoch = T.Trainer.train, T.Trainer.train_epoch


def timed_epoch(self, *a, **k):
    t0 = time.perf_counter()
    loss = train_epoch(self, *a, **k)  # its loss readback waits for the steps
    rec["epochs"].append(time.perf_counter() - t0)
    return loss


def device_busy(trace_dir):
    # over the traced epoch's steady state (from its second train step's
    # kernel #2 to its last device event: the profiler's own start-up
    # slows the first step), the union of the device's kernel, copy and
    # fill intervals, the window, and NCCL's kernels alone (ms)
    (path,) = [p for p in glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
               if f"_{os.getpid()}." in os.path.basename(p)]
    evs = [e for e in json.load(open(path))["traceEvents"]
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    start = sorted(e["ts"] for e in evs if "ffm_fused" in e["name"])[1]
    evs = [e for e in evs if e["ts"] >= start]
    spans, busy, end = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs), 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    nccl = sum(e["dur"] for e in evs if e.get("cat") == "kernel" and "nccl" in e["name"].lower())
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    return busy / 1e3, window / 1e3, nccl / 1e3


def recorded(self, *a, **k):
    for role in ("train", "eval"):
        if mode == "shard":
            self._dev_cache[role] = self._build_device_cache(self._dataset(role), "shard", None)
            delattr(self, f"_{role}_ds")
        else:
            self._ensure_device_cache(role)
    torch.cuda.synchronize()
    reset_launch_counts()
    tracing.reset()
    dist.counts.update(dict.fromkeys(dist.counts, 0))
    h = train(self, *a, **k)
    rec["history"] = h
    rec["launches"] = read_launch_counts()
    rec["collectives"] = dict(dist.counts)
    rec["world"] = self._proc_n
    rec["mesh"] = None if self._mesh is None else [self._mesh.data, self._mesh.model]
    rec["form"] = None if self._sharded is None else [self._sharded.mode, self._sharded.form]
    rec["counters"] = {n: c for n, c in tracing.read().items()
                       if n.startswith(("mesh.train.", "route.update."))}
    rec["device_cache"] = {r: (e.layout if e is not None else "streamed")
                           for r, e in self._dev_cache.items()}
    rec["rows_loc"] = {r: e.rows_loc for r, e in self._dev_cache.items() if e is not None}
    rec["dispatch"] = dict(self.group_dispatch)
    if k.get("profile_dir"):
        rec["busy_ms"], rec["window_ms"], rec["nccl_ms"] = device_busy(k["profile_dir"])
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return h


if mode == "one":
    # the one-card Trainer: bench.py's config, 2 epochs, the resident
    # dataset (replicate layout), eval of the same file, a checkpoint and
    # predict_file
    cfg = bench.make_config(data, "cuda", n_epochs=2, eval_data=data, device_cache="on")
    T.Trainer.train_epoch = timed_epoch
    tr = T.Trainer(cfg)
    tr._ensure_device_cache("train")
    tr._ensure_device_cache("eval")
    one = {"history": tr.train()}
    one["epochs"], rec["epochs"] = rec["epochs"], []
    tr.save_checkpoint(out + ".one.ckpt")
    tr.predict_file(data, out + ".one.txt")
    rec["one"] = one
    del tr
    torch.cuda.empty_cache()
T.Trainer.train = recorded
T.Trainer.train_epoch = timed_epoch
dist.counts.update(dict.fromkeys(dist.counts, 0))
code = main(argv)
rec["after_predict"] = read_launch_counts()
rec["collectives_all"] = dict(dist.counts)
json.dump(rec, open(out, "w"))
sys.exit(code)
"""


def mesh_runs(data: str, tmp: str, n: int, mode: str, flags: list, timeout: int = 300) -> list:
    """Phase 11: the CLI on n processes, one card each (NCCL over the three
    multi-process flags), each recording its run (MESH_RUN); their records,
    rank by rank.  A process that fails, or outlasts `timeout`, fails the
    smoke run; every process is ended before this returns."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"localhost:{sock.getsockname()[1]}"
    outs = [os.path.join(tmp, f"mesh_{mode}_{n}_{p}.json") for p in range(n)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", MESH_RUN, mode, outs[p], data,
             "--coordinator_address", coord, "--num_processes", str(n), "--process_id", str(p),
             *flags],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(n)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode:
            print(log[-6000:], file=sys.stderr)
        require(p.returncode == 0, f"a mesh process exited {p.returncode}")
    for line in logs[0].splitlines():
        print(f"mesh {mode} x{n}: {line}")
    return [json.load(open(o)) for o in outs]


def mesh_model(bench_100k: str) -> list:
    """Phase 11's model flags: bench.py's FFM-100k model on phase 7's file,
    2 epochs with eval of the same file."""
    return ["--train_data", bench_100k, "--eval_data", bench_100k, "--model_type", "FFM",
            "--n_fields", str(N_FIELDS), "--n_feats", str(TRAIN_FEATS), "--n_factors",
            str(N_FACTORS), "--batch_size", str(BATCH), "--max_nnz", str(N_FIELDS),
            "--n_threads", "3", "--n_epochs", "2"]


def ckpt_tables(path: str):
    """A checkpoint's tables, on the CPU."""
    from ftrl_ffm_tpu_torch.io.checkpoint import load_checkpoint, state_from_jax_arrays

    return state_from_jax_arrays(load_checkpoint(path)[0], "cpu")


def mesh_report(label: str, rec: dict, ref_epochs: list, where: str,
                ref_label: str = "one-card Trainer") -> dict:
    """Print a phase 11 run's line (examples/s of its second epoch beside a
    reference run's, epoch 1's trace, collectives, launches, forms, peak)
    and return its figures."""
    steps = math.ceil(BENCH_ROWS / BATCH)
    eps = BENCH_ROWS / rec["epochs"][1]
    one_eps = BENCH_ROWS / ref_epochs[1]
    traced, idle = "epoch 1 not traced", None
    if "busy_ms" in rec:
        idle = 1 - rec["busy_ms"] / rec["window_ms"]
        traced = (f"epoch 1 traced, steps 2-{steps}: device busy {rec['busy_ms']:.2f} of "
                  f"{rec['window_ms']:.2f} ms (idle share {idle:.4f}), NCCL kernels "
                  f"{rec['nccl_ms']:.3f} ms")
    print(f"mesh {label}: examples/s {eps:.0f} ({ref_label} {one_eps:.0f}); epochs "
          f"{rec['epochs']} s; {traced}; collectives in train() {rec['collectives']}, with "
          f"the rest of the run {rec['collectives_all']}; launches "
          f"{json.dumps(rec['launches'])}; counters {rec['counters']}; form {rec['form']}; "
          f"peak {rec['peak_gb']:.2f} GB [{where}]")
    return {"examples_per_s": eps, "reference_examples_per_s": one_eps,
            "idle_share": idle, "nccl_ms": rec.get("nccl_ms"),
            "collectives": rec["collectives"], "launches": rec["launches"],
            "epochs": rec["epochs"], "dispatch": rec["dispatch"]}


def mesh_phase(bench_100k: str, tmp: str, where: str) -> dict:
    """Phase 11, the mesh (item 8): bench.py's FFM-100k model (39 fields,
    K=16, 640-float rows, B=16,384) on phase 7's 400,000-row file through
    the CLI's three multi-process flags, 2 epochs from the resident dataset
    with eval of the same file, each run in its own process:
    - x1: a world-size-1 NCCL group (--mesh_data 0), the replicate layout,
      a checkpoint (--model_path) and predict_file, against the one-card
      Trainer from the same seeded init, run first in the same process;
      losses, eval, the checkpoint's tables and the predictions bit for
      bit (at D = M = 1 the sharded step runs the one-device update on the
      one shard, and its sums' all_reduce over a group of one keeps their
      bits);
    - x1 at --steps_per_call 5 (25 steps an epoch: no inert step): x1's
      bits, the groups captured with their NCCL all_reduce and replayed,
      the collectives and launches counted per replay as x1's;
    - x1 on the shard layout, built by hand (Trainer._build_device_cache):
      a single slice and one inert row, the replicate run's bits;
    - profile_step's sharded phase beside its cuda phase, and
      bench_multichip on the 1x1 mesh, at this model's width;
    - where more than one card is visible, mesh_cards_phase.
    Prints examples/s (the second epoch, its steps only) beside a reference
    run's, the collectives, each kernel's launches by instance."""
    t_phase = time.perf_counter()
    model = mesh_model(bench_100k)
    base = [*model, "--device_cache", "on", "--device_cache_layout", "replicate"]
    steps = math.ceil(BENCH_ROWS / BATCH)
    out = {}

    # ---- one card: a world-size-1 NCCL group against the one-card Trainer
    # (untraced: its only collectives are the sums' all_reduce)
    ckpt = os.path.join(tmp, "mesh1.ckpt")
    pred = os.path.join(tmp, "mesh1.txt")
    (rec,) = mesh_runs(bench_100k, tmp, 1, "one", [*base, "--mesh_data", "0", "--model_path",
                                                   ckpt, "--predict_data", bench_100k,
                                                   "--predict_output", pred])
    one = rec["one"]
    one_path = os.path.join(tmp, "mesh_one_1_0.json")
    require(rec["world"] == 1 and rec["mesh"] == [1, 1], f"world-size-1 mesh: {rec['mesh']}")
    require(rec["device_cache"] == {"train": "replicate", "eval": "replicate"},
            f"mesh resident layout {rec['device_cache']}")
    same_hist = rec["history"] == one["history"]
    a, b = ckpt_tables(ckpt), ckpt_tables(one_path + ".one.ckpt")
    same_tables = all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))
    same_pred = open(pred, "rb").read() == open(one_path + ".one.txt", "rb").read()
    print(f"mesh x1: NCCL world size 1, mesh (1, 1), lookup/update {rec['form']}: history "
          f"bit-identical to the one-card Trainer's={same_hist} ({rec['history']}), "
          f"checkpoint tables bit-identical={same_tables}, predictions byte-identical="
          f"{same_pred} ({BENCH_ROWS} lines)")
    require(same_hist and same_tables and same_pred, "the world-size-1 mesh differs from one card")
    l = rec["launches"]
    require(l["ffm_fused_logits_grads"] == 2 * steps
            and l["fused_by_instance"] == {"c40_k16": 2 * steps}, f"mesh kernel #2: {l}")
    require(l["ffm_fused_logits"] == 2 * steps and l["logits_by_instance"] == {"c40_k16": 2 * steps},
            f"mesh kernel #1: {l}")
    require(l["ftrl_update"] == 2 * steps and l["update_by_instance"] == {"rows": 2 * steps},
            f"mesh update kernel: {l}")
    require(rec["after_predict"]["ffm_fused_logits"] == 3 * steps, "mesh predict_file's kernel #1")
    require(rec["collectives"] == {"all_reduce": 4 * steps, "all_gather": 0, "all_to_all": 0},
            f"collectives {rec['collectives']}")
    out["x1"] = mesh_report("x1", rec, one["epochs"], where)
    out["x1"]["after_predict"] = rec["after_predict"]

    # ---- x1 at steps_per_call 5: the groups captured with their NCCL
    # all_reduce; x1's bits, collectives and launches, counted per replay
    (rec5,) = mesh_runs(bench_100k, tmp, 1, "s5", [*base, "--mesh_data", "0",
                                                   "--steps_per_call", "5"])
    d5 = rec5["dispatch"]
    print(f"mesh x1 S=5: history bit-identical to x1 S=1's={rec5['history'] == rec['history']}; "
          f"groups {d5}; collectives {rec5['collectives']} (S=1 {rec['collectives']}); "
          f"launches equal S=1's={rec5['launches'] == rec['launches']}")
    require(rec5["history"] == rec["history"], "x1 at S=5 differs from S=1")
    require(d5["captures"] >= 1 and d5["replays"] >= 1, f"x1 S=5 dispatch {d5}")
    require(rec5["collectives"] == rec["collectives"], "x1 S=5's collectives, counted per replay")
    require(rec5["launches"] == rec["launches"], f"x1 S=5 launches {rec5['launches']}")
    out["x1_s5"] = mesh_report("x1 S=5", rec5, rec["epochs"], where, "x1 S=1")

    # ---- x1 on the shard layout: a single slice and one inert row
    (rec_sh,) = mesh_runs(bench_100k, tmp, 1, "shard", [*model, "--mesh_data", "0"])
    print(f"mesh x1 shard layout: {rec_sh['device_cache']}, rows_loc {rec_sh['rows_loc']}; "
          f"history bit-identical to the replicate run's={rec_sh['history'] == rec['history']}")
    require(rec_sh["device_cache"] == {"train": "shard", "eval": "shard"}
            and rec_sh["rows_loc"] == {"train": BENCH_ROWS + 1, "eval": BENCH_ROWS + 1},
            f"x1 shard layout {rec_sh['device_cache']} {rec_sh['rows_loc']}")
    require(rec_sh["history"] == rec["history"], "the shard layout differs from the replicate")
    out["x1_shard"] = mesh_report("x1 shard", rec_sh, rec["epochs"], where, "x1 replicate")

    # ---- the mesh tools at this model's width: the sharded step beside
    # the one-card step, and the multi-card harness on the 1x1 mesh
    prof, _ = run_tool("profile_step sharded", ["ftrl_ffm_tpu_torch.tools.profile_step",
                                                "cuda", "sharded"], {}, 300)
    ms = {m_.group(1): float(m_.group(2)) for m_ in
          re.finditer(r"^(cuda|sharded): ([0-9.]+) ms/step", prof, re.M)}
    require(set(ms) == {"cuda", "sharded"}, f"profile_step phases {ms}")
    bm, _ = run_tool("bench_multichip", [
        "ftrl_ffm_tpu_torch.tools.bench_multichip", "--meshes", "1x1", "--fields",
        str(N_FIELDS), "--factors", str(N_FACTORS), "--max_nnz", str(N_FIELDS), "--b_dev",
        str(BATCH), "--rows", str(TRAIN_FEATS), "--steps", "20"], {}, 300)
    (row,) = json_lines(bm)[-1]["meshes"]
    require(row["mesh"] == "1x1" and row["device"] == card() and row["ex_s"] > 0,
            f"bench_multichip 1x1 {row}")
    out["tools"] = {"profile_step_ms": ms, "bench_multichip": row}
    print(f"mesh tools: profile_step cuda {ms['cuda']:.3f} ms, sharded {ms['sharded']:.3f} ms a "
          f"step (B=8,192); bench_multichip 1x1 {row['step_ms']} ms a step, {row['ex_s']} ex/s, "
          f"model {row['model_ms']:.3f} ms [{where}]")

    out.update(mesh_cards_phase(bench_100k, tmp, where))
    print(f"mesh: phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return out


def mesh_cards_phase(bench_100k: str, tmp: str, where: str) -> dict:
    """Phase 11's meshes of N > 1 NCCL ranks, one card each (nothing where
    one card is visible), from the shard layout, each against the N-rank
    streamed run of the same shape: the ranks agree, and losses, eval and
    the checkpoint's tables are bit for bit the streamed run's.  The
    shapes: (N, 1) replicate; (1, N) route under auto (the owner's
    touched-rows update on its received slots: one ftrl_update launch of
    the "rows" instance a train step, route.update.touched counted once a
    step, no kernel #3) and under update_mode=inplace (za_scatter into z
    and kernel #3 over the shard, twice a step: the factor and the linear
    tables; route.update.pass); (2, 2) route where N >= 4 (the accumulator
    form: kernel #3 twice a step).  Launches and counters are each run's
    own, set to 0 just before its train().  Prints each run's line with
    epoch 1's device idle share and NCCL kernel time (--profile_dir), and
    how far the (1, N) forms' tables lie apart."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"mesh: one card visible ({n}): the N-rank NCCL meshes need more than one")
        return {}
    model = mesh_model(bench_100k)
    route = ["--lookup_mode", "route"]
    # (label, D, M, flags, the routed update's form)
    shapes = [(f"{n}x1", n, 1, [], None), (f"1x{n}", 1, n, route, "touched"),
              (f"1x{n} inplace", 1, n, [*route, "--update_mode", "inplace"], "inplace")]
    if n >= 4:
        shapes.append(("2x2", 2, 2, route, "accumulator"))
    out, ckpts = {}, {}
    for label, d, m, extra, routed in shapes:
        tag = label.replace(" ", "_")
        flags = [*model, "--mesh_data", str(d), "--mesh_model", str(m), *extra]
        path, path_s = (os.path.join(tmp, f"mesh{tag}{x}.ckpt") for x in ("", "s"))
        recs = mesh_runs(bench_100k, tmp, d * m, tag, [
            *flags, "--device_cache", "on", "--device_cache_layout", "shard", "--model_path",
            path, "--profile_dir", os.path.join(tmp, f"mesh_prof_{tag}")])
        streamed = mesh_runs(bench_100k, tmp, d * m, tag + "s", [
            *flags, "--device_cache", "off", "--model_path", path_s])
        r0, s0 = recs[0], streamed[0]
        require(r0["mesh"] == [d, m] and r0["device_cache"] == {"train": "shard", "eval": "shard"},
                f"mesh {r0['mesh']} {r0['device_cache']}")
        for r in (*recs, *streamed):
            require(r["history"] == r0["history"], f"{label}: the ranks or the paths disagree")
        a, b = ckpt_tables(path), ckpt_tables(path_s)
        same = all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))
        print(f"mesh {label}: shard layout {r0['history']}; bit-identical to the streamed "
              f"run's history and checkpoint tables: {same}")
        require(same, f"{label} tables differ from the streamed run's")
        for r in (*recs, *streamed):
            steps, l, c = r["counters"].get("mesh.train.steps", 0), r["launches"], r["counters"]
            touched, passes = c.get("route.update.touched", 0), c.get("route.update.pass", 0)
            if routed == "touched":
                ok = (r["form"][0] == "route" and r["form"][1] in ("dense2", "sparse2")
                      and touched == steps and passes == 0
                      and l["ftrl_update"] == steps and l["update_by_instance"] == {"rows": steps}
                      and l["closed_form_pass"] == 0)
            elif routed is not None:
                ok = (r["form"] == ["route", "inplace" if routed == "inplace" else "accumulator"]
                      and passes == steps and touched == 0 and l["ftrl_update"] == 0
                      and l["closed_form_pass"] == 2 * steps)
            else:
                ok = r["form"][0] == "replicate"
            require(steps > 0 and ok, f"{label}: the update's form or launches: {r['form']}, "
                                      f"{steps} train steps, counters {c}, launches {l}")
        ckpts[label] = a
        out[label] = mesh_report(label, r0, s0["epochs"], where, "streamed")
    touched_t, inplace_t = ckpts[f"1x{n}"], ckpts[f"1x{n} inplace"]
    gap = max(((x.float() - y.float()).abs().max().item() for x, y in zip(touched_t, inplace_t)
               if x is not None and x.numel()), default=0.0)
    identical = all(x is None or torch.equal(x, y) for x, y in zip(touched_t, inplace_t))
    print(f"mesh 1x{n}: the touched-rows and in-place forms' checkpoint tables after 2 epochs: "
          f"bit-identical={identical}, max_abs_diff={gap:.3e}")
    return out



def main() -> int:
    # ---- 1. no card ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from ftrl_ffm_tpu_torch.config import Config
    from ftrl_ffm_tpu_torch.data.stream import StreamReader
    from ftrl_ffm_tpu_torch.ftrl import FtrlParams
    from ftrl_ffm_tpu_torch.models import make_model
    from ftrl_ffm_tpu_torch.models.base import local_rows, widen_batch
    from ftrl_ffm_tpu_torch.ops import _build
    from ftrl_ffm_tpu_torch.ops.ffm_cuda import (
        ffm_fused_logits,
        ffm_fused_logits_grads,
        ffm_fused_logits_grads_plain,
        ffm_fused_logits_plain,
    )
    from ftrl_ffm_tpu_torch.ftrl import closed_form_pass_plain
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import (
        closed_form_pass,
        ftrl_update,
        ftrl_update_plain,
        za_scatter,
        za_scatter_plain,
    )
    from ftrl_ffm_tpu_torch.train import Trainer, _draw_rows

    device = torch.device("cuda", torch.cuda.current_device())
    device_name = torch.cuda.get_device_name(device)
    by_instance = ffm_fused_logits_grads.launches_by_instance

    def zero_instances():
        """Zero the launch counts by kernel instance and by dtype."""
        for counts in (by_instance, ffm_fused_logits.launches_by_instance,
                       ftrl_update.launches_by_dtype, closed_form_pass.launches_by_dtype,
                       ftrl_update.launches_by_instance, za_scatter.launches_by_instance):
            for name in counts:
                counts[name] = 0

    def serving_reference(trainer, data: str, what: str):
        """The plain version's eval of `data` on the same device tensors,
        batch by batch, closed on the host in float64: (loss, the logits'
        max_abs_err, the probabilities of the weighted rows)."""
        model = trainer.model
        loss_sum, count, probs, max_err = 0.0, 0.0, [], 0.0
        reader = StreamReader(data, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS, log_every=0)
        for arrays in reader.batches():
            batch = widen_batch(trainer._place_batch(arrays))
            got = model.predict_logits(trainer.state, batch)
            rows = local_rows(batch.feats)
            vrows = rows(trainer.state.vec_w)
            lin = model._lin_logits(trainer.state, batch, rows,
                                    model.bias_weight(trainer.state), vrows)
            ref = ffm_fused_logits_plain(vrows, batch.fields, batch.vals, lin,
                                         model.field_pad, model.n_factors)
            require(torch.allclose(got, ref, rtol=RTOL, atol=ATOL),
                    f"{what} logits disagree with the plain version")
            max_err = max(max_err, (got - ref).abs().max().item())
            r = ref.double().cpu().numpy()
            y = arrays[3].astype(np.float64)
            m = arrays[4] > 0
            loss_sum += float(np.sum((np.logaddexp(r, 0) - y * r)[m]))
            count += float(m.sum())
            probs.append(1 / (1 + np.exp(-r[m])))
        return loss_sum / count, max_err, np.concatenate(probs)

    where = card()
    print(f"device: {device_name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {where}")

    # each phase's seconds, printed as the next one starts
    t_phase = [time.perf_counter(), "1-2"]

    def phase_done(next_phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {t_phase[1]}: {now - t_phase[0]:.1f} s")
        t_phase[:] = [now, next_phase]

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Compiling")):
            print(f"build: {line.strip()}")

    phase_done("3")
    # ---- 3. kernels against their plain versions ----
    gen = torch.Generator(device=device).manual_seed(SEED)
    cp = Config(model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS).field_pad
    require(cp == 40, f"field_pad {cp} != 40")
    # (label, B, F, C', K, fields, real fields): the C'=40, K=16 instance on
    # canonical, repeated, out-of-range and padding fields at F = 39, 40 and
    # 13, then the general instance (staged, and too big to stage)
    cases = [
        ("criteo", BATCH, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS),
        ("odd_b", 333, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS),
        ("b1", 1, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS),
        ("repeated", 257, N_FIELDS, cp, N_FACTORS, "random", N_FIELDS),
        ("f40_out_of_range", 129, 40, cp, N_FACTORS, "out_of_range", N_FIELDS),
        ("f13_out_of_range", 300, 13, cp, N_FACTORS, "out_of_range", N_FIELDS),
        ("f64", 129, 64, cp, N_FACTORS, "random", N_FIELDS),
        ("f100_unstaged", 65, 100, cp, N_FACTORS, "random", N_FIELDS),
        ("c8_k16", 511, 7, 8, 16, "random", 7),
        ("out_of_range", 97, 12, 8, 16, "out_of_range", 8),
        ("e15_scalar", 31, 6, 5, 3, "random", 5),
    ]
    logits_instances = ffm_fused_logits.launches_by_instance
    criteo_err = criteo_bf16_err = None
    for label, b, f, c, k, kind, real in cases:
        v, fld, vals, lin = kernel_inputs(b, f, c, k, gen, device, kind, real)
        before = dict(logits_instances)
        got = ffm_fused_logits(v, fld, vals, lin, c, k)
        torch.cuda.synchronize()
        instance = next(n for n, count in logits_instances.items() if count > before[n])
        ref = ffm_fused_logits_plain(v, fld, vals, lin, c, k)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = torch.allclose(got, ref, rtol=RTOL, atol=ATOL)
        print(f"kernel ffm_logits {label}: B={b} F={f} C'={c} K={k} instance {instance} "
              f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
        require(ok and bool(torch.isfinite(got).all()), f"ffm_logits {label} disagrees")
        require((instance == "c40_k16") == (c == 40 and k == 16 and f <= 40),
                f"ffm_logits {label} ran instance {instance}")
        # the bf16 rows of a bf16 table: against the plain version, and bit
        # for bit the f32 launch on the rows they widen to
        vh = v.to(torch.bfloat16)
        before = dict(logits_instances)
        got_h = ffm_fused_logits(vh, fld, vals, lin, c, k)
        torch.cuda.synchronize()
        instance_h = next(n for n, count in logits_instances.items() if count > before[n])
        widened = ffm_fused_logits(vh.float(), fld, vals, lin, c, k)
        ref_h = ffm_fused_logits_plain(vh, fld, vals, lin, c, k)
        torch.cuda.synchronize()
        err_h = (got_h - ref_h).abs().max().item()
        same = torch.equal(got_h, widened)
        ok = torch.allclose(got_h, ref_h, rtol=RTOL, atol=ATOL) and same
        print(f"kernel ffm_logits bf16 rows {label}: instance {instance_h} max_abs_err="
              f"{err_h:.3e} {'ok' if ok else 'MISMATCH'}; the f32 launch on the widened rows "
              f"bit for bit={same}")
        require(ok and instance_h == instance + "_bf16", f"ffm_logits bf16 {label} disagrees")
        if label == "criteo":
            criteo_err, criteo_bf16_err = err, err_h
            again = (ffm_fused_logits(v, fld, vals, lin, c, k),
                     ffm_fused_logits(vh, fld, vals, lin, c, k))
            same = torch.equal(again[0], got) and torch.equal(again[1], got_h)
            print(f"kernel ffm_logits {label}: second launches bit-identical={same}")
            require(same, "ffm_logits is not deterministic")
        del v, vh, fld, vals, lin

    phase_done("3b")
    # ---- 3b. the training kernel against its plain version ----
    # (label, B, F, C', K, fields, real fields, aug lane)
    fused_cases = [
        ("criteo", BATCH, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS, N_FIELDS),
        ("odd_b", 333, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS, N_FIELDS),
        ("b1", 1, N_FIELDS, cp, N_FACTORS, "iota", N_FIELDS, N_FIELDS),
        ("repeated", 257, N_FIELDS, cp, N_FACTORS, "random", N_FIELDS, N_FIELDS),
        ("f64", 129, 64, cp, N_FACTORS, "random", N_FIELDS, N_FIELDS),
        ("f100_unstaged", 65, 100, cp, N_FACTORS, "random", N_FIELDS, N_FIELDS),
        ("c8_k16_aug7", 511, 7, 8, 16, "random", 7, 7),
        ("out_of_range", 97, 12, 8, 16, "out_of_range", 8, -1),
        ("no_aug", 200, 8, 8, 16, "random", 8, -1),
        ("e15_scalar", 31, 6, 5, 3, "random", 4, 4),
    ]
    # the split output (g, g^2 apart, the in-place update's payload) on
    # these cases: against the plain split, and bit for bit the halves of
    # the combined output
    split_cases = {"criteo", "odd_b", "out_of_range", "e15_scalar"}
    fused_err = split_err = None
    for label, b, f, c, k, kind, real, aug in fused_cases:
        args = fused_inputs(b, f, c, k, gen, device, kind, real)
        before = dict(by_instance)
        logits, gg2 = ffm_fused_logits_grads(*args, c, k, aug_lane=aug)
        torch.cuda.synchronize()
        instance = next(n for n, count in by_instance.items() if count > before[n])
        ref_logits, ref_gg2 = ffm_fused_logits_grads_plain(*args, c, k, aug_lane=aug)
        torch.cuda.synchronize()
        err = max((logits - ref_logits).abs().max().item(), (gg2 - ref_gg2).abs().max().item())
        ok = (torch.allclose(logits, ref_logits, rtol=RTOL, atol=ATOL)
              and torch.allclose(gg2, ref_gg2, rtol=RTOL, atol=GRAD_ATOL)
              and bool(torch.isfinite(gg2).all()))
        print(f"kernel ffm_fused {label}: B={b} F={f} C'={c} K={k} aug={aug} instance "
              f"{instance} max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
        require(ok, f"ffm_fused {label} disagrees")
        if label == "criteo":
            fused_err = err
            again = ffm_fused_logits_grads(*args, c, k, aug_lane=aug)
            same = torch.equal(again[0], logits) and torch.equal(again[1], gg2)
            print(f"kernel ffm_fused {label}: a second launch bit-identical={same}")
            require(instance == "c40_k16" and same,
                    "the bench shape did not run the C'=40, K=16 instance, or it is not "
                    "deterministic")
            del again
        del ref_logits, ref_gg2
        if label in split_cases:
            e = c * k
            s_logits, g, g2 = ffm_fused_logits_grads(*args, c, k, aug_lane=aug,
                                                     combined_out=False)
            torch.cuda.synchronize()
            same = (torch.equal(s_logits, logits) and torch.equal(g, gg2[:, :e])
                    and torch.equal(g2, gg2[:, e:]))
            del gg2
            ref = ffm_fused_logits_grads_plain(*args, c, k, aug_lane=aug, combined_out=False)
            torch.cuda.synchronize()
            err = max((x - y).abs().max().item() for x, y in zip((s_logits, g, g2), ref))
            ok = (torch.allclose(s_logits, ref[0], rtol=RTOL, atol=ATOL)
                  and all(torch.allclose(x, y, rtol=RTOL, atol=GRAD_ATOL)
                          for x, y in zip((g, g2), ref[1:])))
            print(f"kernel ffm_fused split {label}: g, g2 [{b * f}, {e}] max_abs_err={err:.3e} "
                  f"{'ok' if ok else 'MISMATCH'}; the combined output's halves bit for "
                  f"bit={same}")
            require(ok and same, f"ffm_fused split {label} disagrees")
            if label == "criteo":
                split_err = err
            del s_logits, g, g2, ref
        del args, logits

    # the bf16 store (acc_dtype=bfloat16; combined only) on the same shapes:
    # logits as above, the payload within one bf16 ulp of the plain
    # version's (plus GRAD_ATOL near 0), and bit for bit the f32 launch's
    # values rounded to bf16; counted under the instance's "_bf16" name
    bf16 = torch.bfloat16
    fused_bf16_err = None
    for label, b, f, c, k, kind, real, aug in fused_cases:
        args = fused_inputs(b, f, c, k, gen, device, kind, real)
        before = dict(by_instance)
        logits, gg2 = ffm_fused_logits_grads(*args, c, k, aug_lane=aug, out_dtype=bf16)
        torch.cuda.synchronize()
        instance = next(n for n, count in by_instance.items() if count > before[n])
        ref_logits, ref_gg2 = ffm_fused_logits_grads_plain(*args, c, k, aug_lane=aug,
                                                           out_dtype=bf16)
        f32_logits, f32_gg2 = ffm_fused_logits_grads(*args, c, k, aug_lane=aug)
        torch.cuda.synchronize()
        err = max((logits - ref_logits).abs().max().item(),
                  (gg2.float() - ref_gg2.float()).abs().max().item())
        rounded = torch.equal(f32_logits, logits) and torch.equal(f32_gg2.to(bf16), gg2)
        ok = (torch.allclose(logits, ref_logits, rtol=RTOL, atol=ATOL)
              and within_bf16_ulp(gg2, ref_gg2, GRAD_ATOL) and rounded
              and bool(torch.isfinite(gg2).all()) and instance.endswith("_bf16"))
        print(f"kernel ffm_fused bf16 {label}: B={b} F={f} C'={c} K={k} aug={aug} instance "
              f"{instance} max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}; the f32 "
              f"launch's values rounded={rounded}")
        require(ok, f"ffm_fused bf16 {label} disagrees")
        if label == "criteo":
            fused_bf16_err = err
            again = ffm_fused_logits_grads(*args, c, k, aug_lane=aug, out_dtype=bf16)
            same = torch.equal(again[0], logits) and torch.equal(again[1], gg2)
            print(f"kernel ffm_fused bf16 {label}: a second launch bit-identical={same}")
            require(instance == "c40_k16_bf16" and same,
                    "the bench shape's bf16 store did not run the C'=40, K=16 instance, or "
                    "it is not deterministic")
            del again
        del args, logits, gg2, ref_logits, ref_gg2, f32_logits, f32_gg2

    phase_done("3c")
    # ---- 3c. the update kernel against its plain version ----
    p = FtrlParams()

    @contextlib.contextmanager
    def ordered_sums(ordered):
        """Within, with ordered: the plain versions' f32 row sums add each
        row's payload rows rank by rank, in ascending payload order as the
        kernels and the bf16 accumulator do, so a kernel can be held bit for
        bit: the card's index_add_ sums in no fixed order (a hot id's
        ~14,500 rows ~1e-4 off at that length)."""
        import ftrl_ffm_tpu_torch.ftrl as tftrl

        saved = tftrl._segment_sums
        if ordered:
            tftrl._segment_sums = functools.partial(ordered_segment_sums, saved)
        try:
            yield
        finally:
            tftrl._segment_sums = saved

    def update_reference(tables, ids, gg2, lane, p, gg2_lin, ordered):
        """The plain version's six tables after the step, on the same card
        tensors (ordered_sums)."""
        with ordered_sums(ordered):
            want = list(itertools.chain(*ftrl_update_plain(*tables, ids, gg2, lane, p, gg2_lin)))
        torch.cuda.synchronize()
        return want

    # (label, R, E, N, ids drawn from [0, hi), linear lane, skewed ids): the
    # skewed batch's hot ids take the column-split kernel; fm_k16 is FM's
    # K=16 row (phase 3g: no dead lane, the linear stats in gg2_lin)
    update_cases = [
        ("bench_aug", TRAIN_FEATS, cp * N_FACTORS, BATCH * N_FIELDS, TRAIN_FEATS, N_FIELDS, False),
        ("bench_skewed", TRAIN_FEATS, cp * N_FACTORS, BATCH * N_FIELDS, TRAIN_FEATS, N_FIELDS,
         True),
        ("no_aug", 5000, 128, 8000, 4000, -1, False),
        ("no_aug_skewed", 5000, 128, 8000 // N_FIELDS * N_FIELDS, 4000, -1, True),
        ("e15_dups", 50, 15, 1000, 40, 4, False),
        ("fm_k16", TRAIN_FEATS, N_FACTORS, BATCH * N_FIELDS, TRAIN_FEATS, -1, False),
        ("fm_k16_skewed", TRAIN_FEATS, N_FACTORS, BATCH * N_FIELDS, TRAIN_FEATS, -1, True),
    ]
    update_err = update_skew_err = None
    # max_abs_err of phase 3g's forms: FM's K=16 rows and LR's linear-only
    # update, by label
    narrow_err = {}
    hot_rows = lib.ftrl_update_hot_rows()  # longer segments: the column-split kernel
    for label, r, e, n, hi, lane, skew in update_cases:
        tables, ids, gg2, gg2_lin = update_inputs(r, e, n, hi, gen, device, p, lane, skew)
        runs = []
        before_inst = dict(ftrl_update.launches_by_instance)
        for _ in range(2):
            got = [t.clone() for t in tables]
            ftrl_update(*got, ids, gg2, lane, p, gg2_lin)
            torch.cuda.synchronize()
            runs.append(got)
        instance = ran_instance(ftrl_update.launches_by_instance, before_inst)
        # FM's narrow rows: bit for bit the plain version under ordered sums
        narrow = instance == "narrow"
        want = update_reference(tables, ids, gg2, lane, p, gg2_lin, skew or narrow)
        touched = torch.zeros(r, dtype=torch.bool, device=device)
        touched[ids[ids < r].long()] = True
        err, ok = 0.0, True
        for got, want, before in zip(runs[0], want, tables):
            err = max(err, (got[touched] - want[touched]).abs().max().item())
            if narrow:
                ok &= torch.equal(got[touched], want[touched])
            else:
                ok &= torch.allclose(got[touched], want[touched], rtol=UPD_RTOL, atol=UPD_ATOL)
            ok &= torch.equal(got[~touched], want[~touched])
            ok &= torch.equal(got[~touched], before[~touched])
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        longest = int(torch.bincount(ids[ids < r].long()).max())
        print(f"kernel ftrl_update {label}: R={r} E={e} N={n} lane={lane} instance {instance} "
              f"touched rows {int(touched.sum())}, longest segment {longest} rows; "
              f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'} (bit for bit: {narrow}); "
              f"repeat bit-identical={same}")
        require(instance == ("scalar" if e % 4 else "narrow" if e <= 32 else "rows"),
                f"ftrl_update {label} ran instance {instance}")
        require(longest > hot_rows if skew else longest <= hot_rows,
                f"ftrl_update {label}: the longest segment ({longest}) misses its kernel")
        require(ok, f"ftrl_update {label} disagrees")
        require(same, f"ftrl_update {label} is not deterministic")
        if label == "bench_aug":
            update_err = err
        if label == "bench_skewed":
            update_skew_err = err
        if label.startswith("fm_"):
            narrow_err[label] = err
        del tables, ids, gg2, gg2_lin, runs, want

    # the bf16 forms: a bf16 payload against the plain version on the same
    # card tensors bit for bit on the touched rows (the same bf16
    # accumulator, rounded after every add in payload order, and the same
    # correctly rounded operations), the linear tables too where the
    # payload's lane carries them (with lane = -1 they sum the f32 gg2_lin,
    # whose plain index_add_ on the card sums in no fixed order: as above);
    # an f32 payload with a bf16 w: n, z and the linear tables as above, w
    # within one bf16 ulp; FM's narrow rows in every dtype pair bit for bit
    # under ordered sums
    # (label, R, E, N, ids drawn from [0, hi), linear lane, payload, w,
    # skewed ids): every dtype pair on the bench's uniform and skewed batches
    bench = (TRAIN_FEATS, cp * N_FACTORS, BATCH * N_FIELDS, TRAIN_FEATS, N_FIELDS)
    update_bf16_cases = [
        ("bench_aug_bf16", *bench, bf16, bf16, False),
        ("bench_aug_bf16_payload", *bench, bf16, torch.float32, False),
        ("bench_aug_bf16_w", *bench, torch.float32, bf16, False),
        ("bench_skewed_bf16", *bench, bf16, bf16, True),
        ("bench_skewed_bf16_payload", *bench, bf16, torch.float32, True),
        ("bench_skewed_bf16_w", *bench, torch.float32, bf16, True),
        ("no_aug_bf16", 5000, 128, 8000, 4000, -1, bf16, bf16, False),
        ("no_aug_skewed_bf16", 5000, 128, 8000 // N_FIELDS * N_FIELDS, 4000, -1, bf16, bf16,
         True),
        ("e15_dups_bf16", 50, 15, 1000, 40, 4, bf16, torch.float32, False),
        # FM's K=16 row with a bf16 table (its payload stays f32)
        ("fm_k16_bf16_w", TRAIN_FEATS, N_FACTORS, BATCH * N_FIELDS, TRAIN_FEATS, -1,
         torch.float32, bf16, False),
        ("fm_k16_skewed_bf16_w", TRAIN_FEATS, N_FACTORS, BATCH * N_FIELDS, TRAIN_FEATS, -1,
         torch.float32, bf16, True),
    ]
    update_bf16_err = None
    for label, r, e, n, hi, lane, pay, wdt, skew in update_bf16_cases:
        tables, ids, gg2, gg2_lin = update_inputs(r, e, n, hi, gen, device, p, lane, skew)
        tables[2] = tables[2].to(wdt)
        gg2 = gg2.to(pay)
        runs = []
        before_inst = dict(ftrl_update.launches_by_instance)
        for _ in range(2):
            got = [t.clone() for t in tables]
            ftrl_update(*got, ids, gg2, lane, p, gg2_lin)
            torch.cuda.synchronize()
            runs.append(got)
        narrow = ran_instance(ftrl_update.launches_by_instance, before_inst) == "narrow"
        require(narrow == (e <= 32 and e % 4 == 0), f"ftrl_update {label}: narrow={narrow}")
        want = update_reference(tables, ids, gg2, lane, p, gg2_lin, skew or narrow)
        touched = torch.zeros(r, dtype=torch.bool, device=device)
        touched[ids[ids < r].long()] = True
        err, ok = 0.0, True
        for i, (got, want, before) in enumerate(zip(runs[0], want, tables)):
            g_t, w_t = got[touched], want[touched]
            err = max(err, (g_t.float() - w_t.float()).abs().max().item())
            if narrow or (pay == bf16 and (i < 3 or lane >= 0)):
                ok &= torch.equal(g_t, w_t)
            elif i == 2:
                ok &= within_bf16_ulp(g_t, w_t, UPD_ATOL)
            else:
                ok &= torch.allclose(g_t, w_t, rtol=UPD_RTOL, atol=UPD_ATOL)
            ok &= got.dtype == want.dtype and torch.equal(got[~touched], before[~touched])
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        longest = int(torch.bincount(ids[ids < r].long()).max())
        require(longest > hot_rows if skew else longest <= hot_rows,
                f"ftrl_update {label}: the longest segment ({longest}) misses its kernel")
        print(f"kernel ftrl_update {label}: R={r} E={e} N={n} lane={lane} payload {pay} w {wdt} "
              f"touched rows {int(touched.sum())}, longest segment {longest} rows; "
              f"max_abs_err={err:.3e} "
              f"{'ok' if ok else 'MISMATCH'} (bit for bit: {narrow or pay == bf16}); repeat "
              f"bit-identical={same}")
        require(ok, f"ftrl_update {label} disagrees")
        require(same, f"ftrl_update {label} is not deterministic")
        if label == "bench_aug_bf16":
            update_bf16_err = err
        if label.startswith("fm_"):
            narrow_err[label] = err
        del tables, ids, gg2, gg2_lin, runs, want

    phase_done("3g")
    # ---- 3g. the update kernel with no factor columns (E = 0) ----
    # LR's whole update and FM's in-place linear step (ftrl_update_linear,
    # the "linear" instance) against the plain dense step on the same card
    # tensors under ordered sums: touched rows bit for bit, untouched rows
    # and repeats bit-identical; at LR's 100k table on uniform and skewed
    # ids and at FM's 2^22 table on uniform and Zipf ids (the hot ids take
    # the column-split kernel)
    from ftrl_ffm_tpu_torch.ftrl import dense_ftrl_update2
    from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update_linear

    for label, r, skew in (("lr", TRAIN_FEATS, None), ("lr_skewed", TRAIN_FEATS, "skewed"),
                           ("lr_4m", HASH_FEATS, None), ("lr_4m_zipf", HASH_FEATS, "zipf")):
        n = BATCH * N_FIELDS
        lin = ftrl_tables(gen, device, p, r)
        ids = (zipf_ids(n, r, device) if skew == "zipf" else
               (skewed_ids if skew else random_ids)(n, r, r, gen, device))
        gl = torch.randn((n,), generator=gen, device=device) * 0.1
        gg2_lin = torch.stack([gl, gl * gl], dim=-1)
        runs = []
        before_inst = dict(ftrl_update.launches_by_instance)
        for _ in range(2):
            got = [t.clone() for t in lin]
            ftrl_update_linear(*got, ids, gg2_lin, p)
            torch.cuda.synchronize()
            runs.append(got)
        instance = ran_instance(ftrl_update.launches_by_instance, before_inst)
        with ordered_sums(True):
            want = dense_ftrl_update2(*lin, ids, gg2_lin, p)
        torch.cuda.synchronize()
        touched = torch.zeros(r, dtype=torch.bool, device=device)
        touched[ids[ids < r].long()] = True
        err = max((g_[touched] - w_[touched]).abs().max().item() for g_, w_ in zip(runs[0], want))
        ok = all(torch.equal(g_[touched], w_[touched]) and torch.equal(g_[~touched], b_[~touched])
                 for g_, w_, b_ in zip(runs[0], want, lin))
        same = all(torch.equal(a_, b_) for a_, b_ in zip(*runs))
        longest = int(torch.bincount(ids[ids < r].long()).max())
        print(f"kernel ftrl_update_linear {label}: R={r} E=0 N={n} instance {instance} touched "
              f"rows {int(touched.sum())}, longest segment {longest} rows; max_abs_err={err:.3e} "
              f"{'ok' if ok else 'MISMATCH'} (bit for bit); repeat bit-identical={same}")
        require(instance == "linear", f"ftrl_update_linear {label} ran instance {instance}")
        require(longest > hot_rows if skew else longest <= hot_rows,
                f"ftrl_update_linear {label}: the longest segment ({longest}) misses its kernel")
        require(ok, f"ftrl_update_linear {label} disagrees")
        require(same, f"ftrl_update_linear {label} is not deterministic")
        narrow_err[label] = err
        del lin, ids, gl, gg2_lin, runs, want, touched

    phase_done("3h")
    # ---- 3h. a (1, N) route mesh's update at the route cell's shapes ----
    routed = routed_update_phase(device, where)

    phase_done("3d")
    # ---- 3d. the z/A scatter against its plain version ----
    # bit for bit the plain version on the same card tensors under ordered
    # sums, untouched z bit-identical, untouched A exactly 0, repeats
    # bit-identical.  (label, R, E, N, ids drawn from [0, hi), hot ids):
    # main_1m is the 1M path's shape, about 472k distinct rows of 1M
    # touched (za_scatter_rows), fm_4m FM's in-place path (phase 3g;
    # za_scatter_narrow); on skewed_ids' three hot ids at the 1M shape and
    # on Zipf ids at FM's (the first batch of phase 7's Zipf data: ~735
    # segments over 64 rows) the long segments take za_scatter_hot
    scatter_cases = [
        ("main_1m", N_FEATS, cp * N_FACTORS, BATCH * N_FIELDS, N_FEATS, None),
        ("main_1m_skewed", N_FEATS, cp * N_FACTORS, BATCH * N_FIELDS, N_FEATS, "skewed"),
        ("fm_4m", HASH_FEATS, N_FACTORS, BATCH * N_FIELDS, HASH_FEATS, None),
        ("fm_4m_zipf", HASH_FEATS, N_FACTORS, BATCH * N_FIELDS, HASH_FEATS, "zipf"),
        ("small", 5000, 128, 8000, 4000, None),
        ("e15_dups", 50, 15, 1000, 40, None),
    ]
    scatter_err = None
    for label, r, e, n, hi, skew in scatter_cases:
        z, ids, g, g2 = scatter_inputs(r, e, n, hi, gen, device)
        if skew == "zipf":
            ids = zipf_ids(n, r, device)
        elif skew:
            ids = skewed_ids(n, hi, r, gen, device)
        runs = []
        before_inst = dict(za_scatter.launches_by_instance)
        for _ in range(2):
            got = (z.clone(), torch.zeros_like(z))
            za_scatter(*got, ids, g, g2)
            torch.cuda.synchronize()
            runs.append(got)
        instance = ran_instance(za_scatter.launches_by_instance, before_inst)
        with ordered_sums(True):
            want = za_scatter_plain(z, ids, g, g2)
        torch.cuda.synchronize()
        touched = torch.zeros(r, dtype=torch.bool, device=device)
        touched[ids[ids < r].long()] = True
        err = max((x[touched] - y[touched]).abs().max().item() for x, y in zip(runs[0], want))
        ok = all(torch.equal(x[touched], y[touched]) for x, y in zip(runs[0], want))
        ok &= torch.equal(runs[0][0][~touched], z[~touched])
        ok &= bool((runs[0][1][~touched] == 0).all())
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        counts = torch.bincount(ids[(ids >= 0) & (ids < r)].long())
        longest, n_hot = int(counts.max()), int((counts > hot_rows).sum())
        print(f"kernel za_scatter {label}: R={r} E={e} N={n} instance {instance} touched rows "
              f"{int(touched.sum())}, longest segment {longest} rows, {n_hot} over {hot_rows}; "
              f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'} (bit for bit); repeat "
              f"bit-identical={same}")
        require(instance == ("scalar" if e % 4 else "narrow" if e <= 32 else "rows"),
                f"za_scatter {label} ran instance {instance}")
        require(longest > hot_rows if skew else longest <= hot_rows,
                f"za_scatter {label}: the longest segment ({longest}) misses its kernel")
        require(ok, f"za_scatter {label} disagrees")
        require(same, f"za_scatter {label} is not deterministic")
        if label == "main_1m":
            scatter_err = err
        if label == "fm_4m":
            narrow_err["za_scatter fm_4m"] = err
        if label == "fm_4m_zipf":
            narrow_err["za_scatter fm_4m_zipf"] = err
        del z, ids, g, g2, runs, want, touched, counts

    phase_done("3e")
    # ---- 3e. the closed-form pass (kernel #3) against its plain version ----
    # (label, R, E, offset): the 1M path's tables, FM's 2^22-row K=16 table
    # (phase 3g), odd and prime R with E not a multiple of 4, and tables 4
    # bytes off 16-byte alignment (offset 1: the scalar loop)
    pass_cases = [
        ("main_1m", N_FEATS, cp * N_FACTORS, 0),
        ("fm_4m", HASH_FEATS, N_FACTORS, 0),
        ("r41_e15", 41, 15, 0),
        ("prime_r_e641", 7919, 641, 0),
        ("e1", 1001, 1, 0),
        ("unaligned", 333, 128, 1),
    ]
    pass_err = None
    for label, r, e, off in pass_cases:
        tabs = pass_inputs(r, e, gen, device, p)
        runs = []
        for _ in range(2):
            got = [offset_copy(t, off) for t in tabs]
            closed_form_pass(*got, p)
            torch.cuda.synchronize()
            runs.append(got[:3])
            del got
        want = closed_form_pass_plain(*tabs, p)
        torch.cuda.synchronize()
        errs = {t: (x - y).abs().max().item() for t, x, y in zip("nzw", runs[0], want)}
        err = max(errs.values())
        ok = all(torch.allclose(x, y, rtol=PASS_RTOL, atol=PASS_ATOL)
                 for x, y in zip(runs[0], want))
        idle = tabs[3] == 0
        kept = all(torch.equal(x[idle], y[idle]) for x, y in zip(runs[0][:2], tabs[:2]))
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        print(f"kernel ftrl_pass {label}: R={r} E={e} offset={off} max_abs_err={err:.3e} {errs} "
              f"{'ok' if ok else 'MISMATCH'}; A=0 coordinates keep n, z bits={kept}; "
              f"repeat bit-identical={same}")
        require(ok and kept, f"ftrl_pass {label} disagrees")
        require(same, f"ftrl_pass {label} is not deterministic")
        if label == "main_1m":
            pass_err = err
        if label == "fm_4m":
            narrow_err["ftrl_pass fm_4m"] = err
        del tabs, runs, want, idle

    # with a bf16 w (table_dtype=bfloat16): bit for bit the plain version on
    # the same card tensors, as the f32 form; n, z and, where touched, w
    # keep their bits where A = 0
    pass_bf16_err = None
    for label, r, e, off in pass_cases:
        tabs = list(pass_inputs(r, e, gen, device, p))
        tabs[2] = tabs[2].to(bf16)
        runs = []
        for _ in range(2):
            got = [offset_copy(t, off) for t in tabs]
            closed_form_pass(*got, p)
            torch.cuda.synchronize()
            runs.append(got[:3])
            del got
        want = closed_form_pass_plain(*tabs, p)
        torch.cuda.synchronize()
        err = max((x.float() - y.float()).abs().max().item() for x, y in zip(runs[0], want))
        ok = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(runs[0], want))
        idle = tabs[3] == 0
        kept = all(torch.equal(x[idle], y[idle]) for x, y in zip(runs[0][:2], tabs[:2]))
        idle_w = idle & (tabs[0] > 0)
        kept &= torch.equal(runs[0][2][idle_w], tabs[2][idle_w])
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        print(f"kernel ftrl_pass bf16 w {label}: R={r} E={e} offset={off} max_abs_err={err:.3e} "
              f"bit for bit={ok}; A=0 coordinates keep n, z (and touched w) bits={kept}; "
              f"repeat bit-identical={same}")
        require(ok and kept, f"ftrl_pass bf16 w {label} disagrees")
        require(same, f"ftrl_pass bf16 w {label} is not deterministic")
        if label == "main_1m":
            pass_bf16_err = err
        if label == "fm_4m":
            narrow_err["ftrl_pass_bf16 fm_4m"] = err
        del tabs, runs, want, idle, idle_w

    phase_done("4")
    # ---- 4. serving through the entry points ----
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "eval.ffm")
        t0 = time.perf_counter()
        write_criteo_like(data, N_ROWS, N_FEATS)
        print(f"serve: wrote {N_ROWS} Criteo-shaped rows in {time.perf_counter() - t0:.1f} s")
        # phases 4-5 stream their files (device_cache="off"), as before the
        # resident dataset existed; phase 7 drives the resident path
        cfg = Config(
            model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS, n_feats=N_FEATS,
            batch_size=BATCH, eval_data=data, device="cuda", n_threads=4, device_cache="off",
        )
        state = seeded_state(cfg, device, SEED)
        trainer = Trainer(cfg, state=state)
        require(trainer.cfg.max_nnz == N_FIELDS, f"sniffed max_nnz {trainer.cfg.max_nnz}")
        model = trainer.model
        preds = os.path.join(tmp, "preds.txt")
        n_batches = math.ceil(N_ROWS / BATCH)

        ffm_fused_logits.launches = 0
        zero_instances()
        t0 = time.perf_counter()
        loss, auc = trainer.evaluate()
        t_eval = time.perf_counter() - t0
        serve_metrics = (loss, auc)
        n_pred = trainer.predict_file(data, preds)
        launches = ffm_fused_logits.launches
        serve_instances = dict(ffm_fused_logits.launches_by_instance)
        print(f"serve: evaluate loss={loss:.6f} auc={auc:.6f} ({t_eval:.2f} s, first pass); "
              f"predict_file wrote {n_pred}; ffm_logits launches={launches}, by instance "
              f"{serve_instances}")
        require(launches == 2 * n_batches == serve_instances["c40_k16"],
                f"ffm_logits launched {serve_instances}, expect {2 * n_batches} c40_k16")
        require(math.isfinite(loss) and math.isfinite(auc), "non-finite eval metrics")
        require(n_pred == N_ROWS, f"predict_file scored {n_pred} of {N_ROWS}")
        probs = np.loadtxt(preds)
        require(probs.shape == (N_ROWS,) and ((probs > 0) & (probs < 1)).all(),
                "predictions are not one probability per row")

        ref_loss, max_err, plain_probs = serving_reference(trainer, data, "serving")
        pdiff = float(np.abs(probs - plain_probs).max())
        print(f"serve: plain-version reference loss={ref_loss:.6f} "
              f"(|diff| {abs(ref_loss - loss):.2e}), logits max_abs_err={max_err:.2e}, "
              f"probability max |diff| {pdiff:.2e}")
        require(abs(ref_loss - loss) <= 1e-5 * max(1.0, ref_loss), "eval loss off the reference")
        require(pdiff <= 2e-6, "predictions off the reference")

        # small input: the same serving path on the CPU (plain versions)
        # and on the card agree
        small = dict(model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS,
                     n_feats=5000, batch_size=1024)
        sdata = os.path.join(tmp, "small.ffm")
        write_criteo_like(sdata, 3000, small["n_feats"], seed=11)
        res = {}
        for dev in ("cpu", "cuda"):
            scfg = Config(eval_data=sdata, device=dev, **small)
            sstate = seeded_state(scfg, torch.device("cpu"), SEED + 1)
            res[dev] = Trainer(scfg, state=sstate).evaluate()
        print(f"serve: small input cpu loss/auc={res['cpu']} cuda={res['cuda']}")
        require(abs(res["cpu"][0] - res["cuda"][0]) <= 1e-5, "cpu and cuda eval loss differ")
        require(abs(res["cpu"][1] - res["cuda"][1]) <= 1e-4, "cpu and cuda eval auc differ")

        phase_done("4b/4f")
        # ---- 4b and 4f. training through the entry points: bench.py's FFM
        # model at 100k rows, LR and FM (TRAIN_CELLS), with their device
        # steps (phase 5's part) ----
        cells = train_cells(tmp, device, where)
        small_t, st_p, se_p = cells.pop("small")
        frec = cells["train-ffm-100k"]
        ttrainer, tmodel, tplaced, hist = frec["trainer"], frec["model"], frec["placed"], frec["hist"]
        tcfg, train_p = ttrainer.cfg, frec["paths"][0]
        batches = tplaced[:3]
        fused_launches = frec["counts"]["ffm_fused_logits_grads"]
        update_launches = frec["counts"]["ftrl_update"]
        lrfm = {cell: rec for cell, rec in cells.items() if rec["model"].cfg.model_type != "FFM"}
        del cells

        phase_done("5")
        # ---- 5. timings (the card's name and power limit beside each) ----
        v, fld, vals, lin = kernel_inputs(BATCH, N_FIELDS, cp, N_FACTORS, gen, device,
                                          "iota", N_FIELDS, pad=False)
        runs, k_ms, p_ms = interleaved_ms(
            lambda: ffm_fused_logits(v, fld, vals, lin, cp, N_FACTORS),
            lambda: ffm_fused_logits_plain(v, fld, vals, lin, cp, N_FACTORS), 20, 5)
        gbps = v.numel() * 4 / (k_ms * 1e-3) / 1e9
        # reads v, fields, values, lin; writes the logits.  Ops: the pair
        # sum, each unordered pair once (F(F-1)/2 pairs, K multiply-adds
        # and two multiplies each)
        pair_ops = BATCH * N_FIELDS * (N_FIELDS - 1) // 2 * (2 * N_FACTORS + 2)
        logits_bound = bound(nbytes(v, fld, vals, lin) + BATCH * 4, pair_ops)
        # device time: 20 launches replayed from a CUDA graph (the host's
        # dispatch left out)
        from ftrl_ffm_tpu_torch.tools import graph_ms

        k_dev_ms = graph_ms(lambda: ffm_fused_logits(v, fld, vals, lin, cp, N_FACTORS), 20)
        print(f"timing: ffm_logits B={BATCH} F={N_FIELDS} E={cp * N_FACTORS}: kernel "
              f"{runs['kernel']} ms (device {k_dev_ms:.4f} ms), plain {runs['plain']} ms; "
              f"kernel reads v at {gbps:.0f} GB/s; bound {logits_bound[0]:.4f} ms "
              f"({logits_bound[1]}) [{where}]")
        vh = v.to(torch.bfloat16)
        hruns, kh_ms, ph_ms = interleaved_ms(
            lambda: ffm_fused_logits(vh, fld, vals, lin, cp, N_FACTORS),
            lambda: ffm_fused_logits_plain(vh, fld, vals, lin, cp, N_FACTORS), 20, 5)
        kh_dev_ms = graph_ms(lambda: ffm_fused_logits(vh, fld, vals, lin, cp, N_FACTORS), 20)
        logits_bf16_bound = bound(nbytes(vh, fld, vals, lin) + BATCH * 4, pair_ops)
        print(f"timing: ffm_logits bf16 rows B={BATCH} F={N_FIELDS} E={cp * N_FACTORS}: kernel "
              f"{hruns['kernel']} ms (device {kh_dev_ms:.4f} ms), plain {hruns['plain']} ms; "
              f"bound {logits_bf16_bound[0]:.4f} ms ({logits_bf16_bound[1]}); the f32 rows "
              f"{k_ms:.4f} ms [{where}]")
        del vh

        # where the time of one eval pass goes: device compute per batch on
        # pre-placed batches, host parse per batch, and the whole pass
        placed = [trainer._place_batch(a) for a in StreamReader(
            data, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS,
            n_parse_threads=4, log_every=0).batches()]
        cycle = itertools.cycle(placed)
        dev_ms = cuda_ms(lambda: model.eval_step(trainer.state, next(cycle)), 2 * len(placed))
        t0 = time.perf_counter()
        for _ in StreamReader(data, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS,
                              n_parse_threads=4, log_every=0).batches():
            pass
        parse_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            trainer.evaluate()
            passes.append(time.perf_counter() - t0)
        eps = [N_ROWS / t for t in passes]
        print(f"timing: eval_step on the device {dev_ms:.3f} ms/batch; host parse "
              f"{parse_ms:.3f} ms/batch; evaluate() streamed {eps} examples/s "
              f"(n_feats={N_FEATS}, B={BATCH}, {N_ROWS} rows) [{where}]")

        phase_done("5b")
        # ---- 5b. training timings ----
        args = fused_inputs(BATCH, N_FIELDS, cp, N_FACTORS, gen, device, "iota", N_FIELDS)
        zero_instances()
        fruns, f_ms, fp_ms = interleaved_ms(
            lambda: ffm_fused_logits_grads(*args, cp, N_FACTORS, aug_lane=N_FIELDS),
            lambda: ffm_fused_logits_grads_plain(*args, cp, N_FACTORS, aug_lane=N_FIELDS),
            10, 3)
        e = cp * N_FACTORS
        gbps = BATCH * N_FIELDS * e * 4 * 3 / (f_ms * 1e-3) / 1e9
        # reads the rows and per-sample inputs, writes logits and payload;
        # ops: the pair sum and about 4 per payload slot
        fused_bound = bound(nbytes(*args) + BATCH * 4 + BATCH * N_FIELDS * 2 * e * 4,
                            4 * BATCH * N_FIELDS * (N_FIELDS - 1) * N_FACTORS
                            + 4 * BATCH * N_FIELDS * e)
        print(f"timing: ffm_fused B={BATCH} F={N_FIELDS} E={e}: kernel {fruns['kernel']} "
              f"ms, plain {fruns['plain']} ms; kernel moves v + payload at {gbps:.0f} GB/s; "
              f"bound {fused_bound[0]:.4f} ms ({fused_bound[1]}); launches by instance "
              f"{dict(by_instance)} [{where}]")
        del args
        tables, ids, gg2, _ = update_inputs(TRAIN_FEATS, e, BATCH * N_FIELDS, TRAIN_FEATS,
                                            gen, device, p, N_FIELDS)
        uruns, u_ms, up_ms = interleaved_ms(
            lambda: ftrl_update(*tables, ids, gg2, N_FIELDS, p),
            lambda: ftrl_update_plain(*tables, ids, gg2, N_FIELDS, p), 10, 3)
        # reads the payload and ids, reads and writes n, z, w of the touched
        # factor and linear rows; ops: a payload sum, ~20 per touched slot
        touched = touched_rows(ids, TRAIN_FEATS)
        update_bound = bound(nbytes(ids, gg2) + touched * (e + 1) * 4 * 6,
                             gg2.numel() + touched * (e + 1) * 20)
        print(f"timing: ftrl_update R={TRAIN_FEATS} E={e} N={BATCH * N_FIELDS}: kernel "
              f"{uruns['kernel']} ms, plain {uruns['plain']} ms; {touched} touched rows, bound "
              f"{update_bound[0]:.4f} ms ({update_bound[1]}) [{where}]")
        del tables, ids, gg2

        def time_skewed(pay, wdt, plain_iters):
            """The update kernel on the skewed batch (its hot ids take the
            column-split kernel) beside its bound and the uniform batch's
            time: (kernel ms, plain ms or None, bound)."""
            tables, ids, gg2, _ = update_inputs(TRAIN_FEATS, e, BATCH * N_FIELDS, TRAIN_FEATS,
                                                gen, device, p, N_FIELDS, skewed=True)
            tables[2] = tables[2].to(wdt)
            gg2 = gg2.to(pay)
            call = lambda: ftrl_update(*tables, ids, gg2, N_FIELDS, p)  # noqa: E731
            ms = [cuda_ms(call, 10) for _ in range(2)]
            plain = (cuda_ms(lambda: ftrl_update_plain(*tables, ids, gg2, N_FIELDS, p),
                             plain_iters) if plain_iters else None)
            touched = touched_rows(ids, TRAIN_FEATS)
            wb = tables[2].element_size()
            sb = bound(nbytes(ids, gg2) + touched * (e * (4 + 4 + wb) * 2 + 3 * 4 * 2),
                       gg2.numel() + touched * (e + 1) * 20)
            longest = int(torch.bincount(ids[ids < TRAIN_FEATS].long()).max())
            print(f"timing: ftrl_update skewed payload {pay} w {wdt} R={TRAIN_FEATS} E={e} "
                  f"N={BATCH * N_FIELDS}: kernel {ms} ms, plain {plain} ms; {touched} touched "
                  f"rows, longest segment {longest} rows; bound {sb[0]:.4f} ms ({sb[1]}) "
                  f"[{where}]")
            return float(np.median(ms)), plain, sb

        skew_ms, skew_plain_ms, skew_bound = time_skewed(torch.float32, torch.float32, 3)
        tcycle = itertools.cycle(tplaced)
        step_ms = float(np.median(frec["step_ms"]))
        t0 = time.perf_counter()
        for _ in StreamReader(train_p, "libffm", BATCH, N_FIELDS, TRAIN_FEATS, N_FIELDS,
                              n_parse_threads=4, log_every=0).batches():
            pass
        tparse_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        epochs = []
        for _ in range(3):
            t0 = time.perf_counter()
            ttrainer.train_epoch()
            torch.cuda.synchronize()
            epochs.append(time.perf_counter() - t0)
        teps = [N_ROWS / t for t in epochs]
        print(f"timing: train_step on the device {step_ms:.3f} ms/batch; host parse "
              f"{tparse_ms:.3f} ms/batch; train_epoch() streamed {teps} examples/s "
              f"(n_feats={TRAIN_FEATS}, B={BATCH}, {N_ROWS} rows) [{where}]")

        phase_done("4d")
        # ---- 4d. bf16 tables and payload through the entry points ----
        # bench.py's model with table_dtype and acc_dtype bfloat16: "dense2"
        # with kernel #2's bf16 store and the update kernel on a bf16
        # payload and a bf16 w
        hcfg = dataclasses.replace(tcfg, table_dtype="bfloat16", acc_dtype="bfloat16")
        htrainer = Trainer(hcfg)
        hmodel = htrainer.model
        require(htrainer.state.vec_w.dtype == bf16, "the bf16 init is not bf16")
        for fn in (ffm_fused_logits_grads, ftrl_update, ffm_fused_logits):
            fn.launches = 0
        zero_instances()
        t0 = time.perf_counter()
        hhist = htrainer.train()
        t_h = time.perf_counter() - t0
        h_launches = {"ffm_fused_logits_grads": ffm_fused_logits_grads.launches,
                      "ftrl_update": ftrl_update.launches,
                      "ffm_fused_logits": ffm_fused_logits.launches}
        h_instances, h_update_dtypes = dict(by_instance), dict(ftrl_update.launches_by_dtype)
        hsteps = htrainer._steps_done
        print(f"train bf16: Trainer.train() 2 epochs in {t_h:.2f} s (first): {hsteps} steps; "
              f"launches {h_launches}; ffm_fused by instance {h_instances}; ftrl_update by "
              f"payload/w dtype {h_update_dtypes}; history {hhist}")
        require(hsteps == 2 * n_batches, f"{hsteps} bf16 train steps, expect {2 * n_batches}")
        require(h_instances["c40_k16_bf16"] == hsteps == h_launches["ffm_fused_logits_grads"],
                f"the bf16 path ran kernel #2's instances {h_instances}")
        require(h_update_dtypes["bf16/bf16"] == hsteps == h_launches["ftrl_update"],
                f"the bf16 path ran the update kernel's instances {h_update_dtypes}")
        require(h_launches["ffm_fused_logits"] == 2, "bf16 eval did not run through ffm_logits")
        # the eval batches of a bf16 table reach kernel #1 as bf16 rows: no
        # widening pass before it
        require(ffm_fused_logits.launches_by_instance["c40_k16_bf16"] == 2,
                f"bf16 eval ran kernel #1's instances {ffm_fused_logits.launches_by_instance}")
        require(all(math.isfinite(x) for k in ("train_loss", "eval_loss", "eval_auc")
                    for x in hhist[k]), "non-finite bf16 training history")
        require(hhist["train_loss"][1] < hhist["train_loss"][0],
                "bf16: epoch 2 train loss is not below epoch 1's")
        require(hhist["eval_auc"][-1] > 0.5, "bf16: eval AUC not above 0.5")
        print(f"train bf16: eval loss {hhist['eval_loss']} against the f32 run's "
              f"{hist['eval_loss']} (one init seed, one data)")

        # 3 chained train_steps, kernels against plain versions from one
        # state: the payload may round to the neighbouring bf16, so the
        # chained bound, and vec_w within one bf16 ulp (rtol 2^-7)
        base = clone_state(htrainer.state)
        s_kern, s_plain, s_again = (clone_state(base) for _ in range(3))
        loss_diff = 0.0
        for batch in batches:
            out_k = hmodel.train_step(s_kern, batch)
            with plain_kernels():
                out_p = hmodel.train_step(s_plain, batch)
            hmodel.train_step(s_again, batch)
            loss_diff = max(loss_diff, abs(out_k.loss_sum.item() - out_p.loss_sum.item())
                            / abs(out_p.loss_sum.item()))
        herr = {name: (getattr(s_kern, name).float() - getattr(s_plain, name).float())
                .abs().max().item() for name in ("lin_z", "vec_n", "vec_z", "vec_w")}
        chain_ok = all(torch.allclose(getattr(s_kern, name), getattr(s_plain, name),
                                      rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
                       for name in ("lin_n", "lin_z", "vec_n", "vec_z"))
        chain_ok &= torch.allclose(s_kern.vec_w.float(), s_plain.vec_w.float(),
                                   rtol=BF16_RTOL, atol=CHAIN_ATOL)
        same = all(torch.equal(a, b) for a, b in zip(s_kern, s_again))
        print(f"train bf16: 3 chained steps, kernels vs plain: loss rel diff {loss_diff:.2e}, "
              f"max |diff| {herr}; two kernel runs bit-identical={same}")
        require(chain_ok, "chained bf16 train steps disagree with the plain versions")
        require(same, "two runs of the same bf16 train steps differ")
        del base, s_kern, s_plain, s_again

        # small bf16 training on the CPU (plain versions) and on the card
        small_h = dict(small_t, table_dtype="bfloat16", acc_dtype="bfloat16")
        init = make_model(Config(device="cpu", **small_h)).init(
            torch.Generator().manual_seed(SEED + 4))
        hres = {}
        for dev in ("cpu", "cuda"):
            scfg = Config(train_data=st_p, eval_data=se_p, device=dev, **small_h)
            hres[dev] = Trainer(scfg, state=clone_state(init)).train()
        print(f"train bf16: small run eval loss cpu={hres['cpu']['eval_loss']} "
              f"cuda={hres['cuda']['eval_loss']}")
        require(abs(hres["cpu"]["eval_loss"][-1] - hres["cuda"]["eval_loss"][-1]) <= 1e-4,
                "cpu and cuda bf16 training reach different eval losses")

        phase_done("5b bf16")
        # ---- 5b, bf16: the bf16 forms' timings, the bf16 train step ----
        args = fused_inputs(BATCH, N_FIELDS, cp, N_FACTORS, gen, device, "iota", N_FIELDS)
        hfruns, hf_ms, hfp_ms = interleaved_ms(
            lambda: ffm_fused_logits_grads(*args, cp, N_FACTORS, aug_lane=N_FIELDS,
                                           out_dtype=bf16),
            lambda: ffm_fused_logits_grads_plain(*args, cp, N_FACTORS, aug_lane=N_FIELDS,
                                                 out_dtype=bf16),
            10, 3)
        # reads the rows and per-sample inputs, writes logits and the bf16
        # payload; ops as the f32 form's
        fused_bf16_bound = bound(nbytes(*args) + BATCH * 4 + BATCH * N_FIELDS * 2 * e * 2,
                                 4 * BATCH * N_FIELDS * (N_FIELDS - 1) * N_FACTORS
                                 + 4 * BATCH * N_FIELDS * e)
        print(f"timing: ffm_fused bf16 B={BATCH} F={N_FIELDS} E={e}: kernel {hfruns['kernel']} "
              f"ms, plain {hfruns['plain']} ms; bound {fused_bf16_bound[0]:.4f} ms "
              f"({fused_bf16_bound[1]}); the f32 store {f_ms:.4f} ms [{where}]")
        del args
        update_bf16_time = {}
        for pay, wdt in ((bf16, bf16), (torch.float32, bf16)):
            tables, ids, gg2, _ = update_inputs(TRAIN_FEATS, e, BATCH * N_FIELDS, TRAIN_FEATS,
                                                gen, device, p, N_FIELDS)
            tables[2] = tables[2].to(wdt)
            gg2 = gg2.to(pay)
            uruns_h, uh_ms, uhp_ms = interleaved_ms(
                lambda: ftrl_update(*tables, ids, gg2, N_FIELDS, p),
                lambda: ftrl_update_plain(*tables, ids, gg2, N_FIELDS, p), 10, 3)
            # reads the payload and ids; reads and writes n, z (f32) and w
            # (bf16) of the touched rows and their three linear entries
            touched = touched_rows(ids, TRAIN_FEATS)
            ub = bound(nbytes(ids, gg2) + touched * (e * (4 + 4 + 2) * 2 + 3 * 4 * 2),
                       gg2.numel() + touched * (e + 1) * 20)
            update_bf16_time[f"{str(pay)[6:]}/{str(wdt)[6:]}"] = (uh_ms, uhp_ms, ub)
            print(f"timing: ftrl_update payload {pay} w {wdt} R={TRAIN_FEATS} E={e} "
                  f"N={BATCH * N_FIELDS}: kernel {uruns_h['kernel']} ms, plain "
                  f"{uruns_h['plain']} ms; {touched} touched rows, bound {ub[0]:.4f} ms "
                  f"({ub[1]}); the f32 form {u_ms:.4f} ms [{where}]")
            del tables, ids, gg2
        # the plain version's bf16 accumulator takes one step per rank of the
        # hot ids' ~14,500: not timed here
        time_skewed(bf16, bf16, 0)
        hcycle = itertools.cycle(tplaced)
        hstep_ms = cuda_ms(lambda: hmodel.train_step(htrainer.state, next(hcycle)),
                           2 * len(tplaced))
        epochs = []
        for _ in range(3):
            t0 = time.perf_counter()
            htrainer.train_epoch()
            torch.cuda.synchronize()
            epochs.append(time.perf_counter() - t0)
        heps = [N_ROWS / t for t in epochs]
        print(f"timing: bf16 train_step on the device {hstep_ms:.3f} ms/batch (f32 "
              f"{step_ms:.3f}); train_epoch() streamed {heps} examples/s (n_feats={TRAIN_FEATS}, "
              f"B={BATCH}, table and payload bf16) [{where}]")

        phase_done("4c")
        # ---- 4c. training the 1M-row table through the entry points ----
        # the serving state goes first: the 1M state is 7.7 GB, its
        # accumulator A 2.56 GB, rows and payload 4.9 GB, each clone 7.7 GB
        # (the 100k state, 0.8 GB, stays for phase 6)
        del trainer, state, model, placed, cycle
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        b_mem0 = torch.cuda.memory_allocated(device)
        big_p, big_e = os.path.join(tmp, "train1m.ffm"), os.path.join(tmp, "eval1m.ffm")
        t0 = time.perf_counter()
        write_criteo_split([(big_p, N_ROWS), (big_e, BATCH)], N_FEATS, seed=13)
        print(f"train 1M: wrote {N_ROWS} + {BATCH} Criteo-shaped rows in "
              f"{time.perf_counter() - t0:.1f} s")
        bcfg = Config(
            model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS, n_feats=N_FEATS,
            batch_size=BATCH, train_data=big_p, eval_data=big_e, n_epochs=2,
            device="cuda", n_threads=4, device_cache="off", update_mode="inplace",
        )
        btrainer = Trainer(bcfg)
        bmodel = btrainer.model
        kind = bmodel.form
        require(kind == "inplace", f"update_mode=inplace resolves to {kind!r} at 1M")
        counted = (ffm_fused_logits_grads, za_scatter, closed_form_pass, ftrl_update,
                   ffm_fused_logits)
        for fn in counted:
            fn.launches = 0
        zero_instances()
        t0 = time.perf_counter()
        bhist = btrainer.train()
        t_big = time.perf_counter() - t0
        big = {fn.__name__: fn.launches for fn in counted}
        big_instances = dict(by_instance)
        bsteps = btrainer._steps_done
        b_peak = torch.cuda.max_memory_allocated(device)
        print(f"train 1M: Trainer.train() 2 epochs in {t_big:.2f} s (first): {bsteps} steps, "
              f"update kind {kind!r}; launches {big}; ffm_fused launches by instance "
              f"{big_instances}; history {bhist}; device memory peak {b_peak / 1e9:.2f} GB "
              f"({(b_peak - b_mem0) / 1e9:.2f} GB above the {b_mem0 / 1e9:.2f} GB resident "
              f"before)")
        require(bsteps == 2 * n_batches, f"{bsteps} train steps, expect {2 * n_batches}")
        for fn in ("ffm_fused_logits_grads", "za_scatter", "closed_form_pass"):
            require(big[fn] == bsteps, f"{fn} launched {big[fn]} times in {bsteps} steps")
        require(za_scatter.launches_by_instance["rows"] == bsteps,
                f"the 640-wide scatter ran instances {za_scatter.launches_by_instance}")
        require(big_instances["c40_k16"] == bsteps,
                f"the in-place path ran kernel #2's instances {big_instances}")
        require(big["ftrl_update"] == 0, "the in-place path launched the linear update")
        require(big["ffm_fused_logits"] == 2, "eval did not run through ffm_logits")
        require(ffm_fused_logits.launches_by_instance["c40_k16"] == 2,
                f"1M eval ran kernel #1's instances {ffm_fused_logits.launches_by_instance}")
        require(all(math.isfinite(x) for k in ("train_loss", "eval_loss", "eval_auc")
                    for x in bhist[k]), "non-finite training history")
        require(bhist["train_loss"][1] < bhist["train_loss"][0],
                "epoch 2 train loss is not below epoch 1's")
        require(bhist["eval_auc"][-1] > 0.5, "eval AUC not above 0.5")
        # the linear tables ride stale; logical_state takes them from the
        # mirror lane
        stale = bool((btrainer.state.lin_z == 0).all() and (btrainer.state.lin_n == 0).all())
        lstate = btrainer.logical_state
        mirrored = all(torch.equal(getattr(lstate, f"lin_{t}"), getattr(lstate, f"vec_{t}")[:, N_FIELDS])
                       for t in "nzw")
        print(f"train 1M: raw lin_z, lin_n all zero={stale}; logical_state lin tables = "
              f"mirror lane {N_FIELDS} bit for bit={mirrored}; has_zero_weights(linear)="
              f"{bmodel.has_zero_weights(btrainer.state)}")
        require(stale and mirrored and bool((lstate.lin_n > 0).any()),
                "the stale linear tables or their reconcile are off")

        # 3 chained train_steps from one state: the kernels against the
        # plain versions, twice for the bits, and update_mode=dense
        bbatches = [btrainer._place_batch(a) for a in itertools.islice(StreamReader(
            big_p, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS, log_every=0
        ).batches(), 3)]
        base = btrainer.state  # not stepped below: each chain steps a clone

        def chain(mdl, ctx=contextlib.nullcontext):
            s = clone_state(base)
            with ctx():
                losses = [mdl.train_step(s, b).loss_sum.item() for b in bbatches]
            return s, losses

        torch.cuda.reset_peak_memory_stats(device)
        s_kern, l_kern = chain(bmodel)
        s_again, _ = chain(bmodel)
        same = all(torch.equal(a, b) for a, b in zip(s_kern, s_again))
        del s_again
        s_plain, l_plain = chain(bmodel, plain_kernels)
        names = ("vec_n", "vec_z", "vec_w")
        perr = {n: (getattr(s_kern, n) - getattr(s_plain, n)).abs().max().item() for n in names}
        plain_ok = all(torch.allclose(getattr(s_kern, n), getattr(s_plain, n),
                                      rtol=CHAIN_RTOL, atol=CHAIN_ATOL) for n in names)
        ldiff = max(abs(a - b) / abs(b) for a, b in zip(l_kern, l_plain))
        del s_plain
        dmodel = make_model(dataclasses.replace(bcfg, update_mode="dense"))
        ftrl_update.launches = 0
        s_dense, l_dense = chain(dmodel)
        dense_launches = ftrl_update.launches
        s_sync = bmodel.sync_lin_from_mirror(s_kern)
        names = ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w")
        derr = {n: (getattr(s_sync, n) - getattr(s_dense, n)).abs().max().item() for n in names}
        dense_ok = all(torch.allclose(getattr(s_sync, n), getattr(s_dense, n),
                                      rtol=CHAIN_RTOL, atol=CHAIN_ATOL) for n in names)
        print(f"train 1M: 3 chained steps, kernels vs plain: loss rel diff {ldiff:.2e}, "
              f"max |diff| {perr}; two kernel runs bit-identical={same}; inplace vs dense "
              f"({dense_launches} ftrl_update launches): max |diff| {derr}, losses "
              f"{l_kern} vs {l_dense}; device memory peak "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
        require(plain_ok, "chained in-place steps disagree with the plain versions")
        require(same, "two runs of the same in-place steps differ")
        require(dense_ok and dense_launches == len(bbatches),
                "in-place and dense steps from one state disagree")
        del s_kern, s_dense, s_sync, base, lstate

        # small in-place training on the CPU (plain versions) and on the
        # card, one init
        small_i = dict(small_t, update_mode="inplace")
        init = make_model(Config(device="cpu", **small_i)).init(
            torch.Generator().manual_seed(SEED + 3))
        ires = {}
        for dev in ("cpu", "cuda"):
            scfg = Config(train_data=st_p, eval_data=se_p, device=dev, **small_i)
            ires[dev] = Trainer(scfg, state=clone_state(init)).train()
        print(f"train 1M: small in-place run eval loss cpu={ires['cpu']['eval_loss']} "
              f"cuda={ires['cuda']['eval_loss']}")
        require(abs(ires["cpu"]["eval_loss"][-1] - ires["cuda"]["eval_loss"][-1]) <= 1e-4,
                "cpu and cuda in-place training reach different eval losses")

        phase_done("5c")
        # ---- 5c. 1M training timings ----
        e = cp * N_FACTORS
        tabs = pass_inputs(N_FEATS, e, gen, device, p)
        pruns, pass_ms, pass_plain_ms = interleaved_ms(
            lambda: closed_form_pass(*tabs, p), lambda: closed_form_pass_plain(*tabs, p), 10, 3)
        gbps = 7 * N_FEATS * e * 4 / (pass_ms * 1e-3) / 1e9
        pass_bound = bound(7 * N_FEATS * e * 4, 20 * N_FEATS * e)  # ~20 ops a slot
        print(f"timing: ftrl_pass R={N_FEATS} E={e}: kernel {pruns['kernel']} ms, plain "
              f"{pruns['plain']} ms; kernel streams its 7 tables at {gbps:.0f} GB/s; bound "
              f"{pass_bound[0]:.4f} ms ({pass_bound[1]}) [{where}]")
        zero_ms = cuda_ms(lambda: torch.zeros_like(tabs[0]), 10)
        del tabs
        z, ids, g, g2 = scatter_inputs(N_FEATS, e, BATCH * N_FIELDS, N_FEATS, gen, device)
        a = torch.zeros_like(z)
        sruns, sc_ms, sc_plain_ms = interleaved_ms(
            lambda: za_scatter(z, a, ids, g, g2), lambda: za_scatter_plain(z, ids, g, g2), 10, 3)
        # reads g, g^2 and the ids, reads and writes z and writes A on the
        # touched rows; ops: two adds a payload slot
        touched = touched_rows(ids, N_FEATS)
        scatter_bound = bound(nbytes(ids, g, g2) + touched * e * 4 * 3, 2 * g.numel())
        # the same function in PyTorch: one index_add_ per output, into
        # tables with a row for the sentinel id
        z_ext = torch.zeros((N_FEATS + 1, e), device=device)
        a_ext = torch.zeros_like(z_ext)
        sc_lib_ms = cuda_ms(lambda: (z_ext.index_add_(0, ids, g), a_ext.index_add_(0, ids, g2)), 10)
        del z_ext, a_ext
        print(f"timing: za_scatter R={N_FEATS} E={e} N={BATCH * N_FIELDS} (stable sort "
              f"included): kernel {sruns['kernel']} ms, plain {sruns['plain']} ms, two "
              f"index_add_ {sc_lib_ms:.3f} ms; zeroing A {zero_ms:.3f} ms; {touched} touched "
              f"rows, bound {scatter_bound[0]:.4f} ms ({scatter_bound[1]}) [{where}]")
        del z, ids, g, g2, a
        args = fused_inputs(BATCH, N_FIELDS, cp, N_FACTORS, gen, device, "iota", N_FIELDS)
        zero_instances()
        sfruns, sf_ms, sf_plain_ms = interleaved_ms(
            lambda: ffm_fused_logits_grads(*args, cp, N_FACTORS, aug_lane=N_FIELDS,
                                           combined_out=False),
            lambda: ffm_fused_logits_grads_plain(*args, cp, N_FACTORS, aug_lane=N_FIELDS,
                                                 combined_out=False),
            10, 3)
        print(f"timing: ffm_fused split B={BATCH} F={N_FIELDS} E={e}: kernel {sfruns['kernel']} "
              f"ms, plain {sfruns['plain']} ms; launches by instance {dict(by_instance)} "
              f"[{where}]")
        del args
        bplaced = [btrainer._place_batch(a) for a in StreamReader(
            big_p, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS,
            n_parse_threads=4, log_every=0).batches()]
        bcycle = itertools.cycle(bplaced)
        step = {"inplace": [], "dense": []}
        for kind_ in ("inplace", "dense", "dense", "inplace"):
            mdl = bmodel if kind_ == "inplace" else dmodel
            step[kind_].append(cuda_ms(lambda: mdl.train_step(btrainer.state, next(bcycle)),
                                       2 * len(bplaced)))
        t0 = time.perf_counter()
        for _ in StreamReader(big_p, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS,
                              n_parse_threads=4, log_every=0).batches():
            pass
        bparse_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        epochs = []
        for _ in range(3):
            t0 = time.perf_counter()
            btrainer.train_epoch()
            torch.cuda.synchronize()
            epochs.append(time.perf_counter() - t0)
        beps = [N_ROWS / t for t in epochs]
        print(f"timing: train_step on the device at 1M: inplace {step['inplace']} ms/batch, "
              f"dense {step['dense']} ms/batch; host parse {bparse_ms:.3f} ms/batch; "
              f"train_epoch() streamed {beps} examples/s (n_feats={N_FEATS}, B={BATCH}, {N_ROWS} "
              f"rows, inplace) [{where}]")

        phase_done("4e")
        # ---- 4e. the 1M-row table with a bf16 w through the entry points ----
        # table_dtype=bfloat16 at 1M, "inplace" (4c's config) with an f32 split
        # payload (acc_dtype only narrows "dense2"), kernel #3 on a bf16 w,
        # and the separate linear update: the forward pass reads lin_w, not
        # the mirror lane, so the linear tables are kept every step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        e_mem0 = torch.cuda.memory_allocated(device)
        ecfg = dataclasses.replace(bcfg, table_dtype="bfloat16", acc_dtype="bfloat16")
        etrainer = Trainer(ecfg)
        emodel = etrainer.model
        require(not emodel._lin_mirror_maintained() and etrainer.state.vec_w.dtype == bf16,
                "the bf16 1M table keeps the mirror or is not bf16")
        for fn in counted:
            fn.launches = 0
        zero_instances()
        t0 = time.perf_counter()
        ehist = etrainer.train()
        t_e = time.perf_counter() - t0
        e_launches = {fn.__name__: fn.launches for fn in counted}
        e_instances = dict(by_instance)
        e_pass_dtypes = dict(closed_form_pass.launches_by_dtype)
        e_update_dtypes = dict(ftrl_update.launches_by_dtype)
        esteps = etrainer._steps_done
        e_peak = torch.cuda.max_memory_allocated(device)
        print(f"train 1M bf16: Trainer.train() 2 epochs in {t_e:.2f} s (first): {esteps} steps; "
              f"launches {e_launches}; ffm_fused by instance {e_instances}; ftrl_pass by w "
              f"dtype {e_pass_dtypes}; ftrl_update (the linear update) by dtype "
              f"{e_update_dtypes}; history {ehist}; device memory peak {e_peak / 1e9:.2f} GB "
              f"({(e_peak - e_mem0) / 1e9:.2f} GB above the {e_mem0 / 1e9:.2f} GB resident "
              f"before; the f32 table's 4c run {(b_peak - b_mem0) / 1e9:.2f} GB above its)")
        require(esteps == 2 * n_batches, f"{esteps} bf16 1M train steps, expect {2 * n_batches}")
        require(e_pass_dtypes["bf16"] == esteps == e_launches["closed_form_pass"],
                f"the bf16 1M path ran kernel #3's instances {e_pass_dtypes}")
        require(e_launches["za_scatter"] == esteps, "the bf16 1M path skipped the z/A scatter")
        require(e_instances["c40_k16"] == esteps,
                f"the bf16 1M path ran kernel #2's instances {e_instances}")
        require(e_update_dtypes["f32/f32"] == esteps == e_launches["ftrl_update"],
                f"the bf16 1M path's linear update ran {e_update_dtypes}")
        require(e_launches["ffm_fused_logits"] == 2, "bf16 1M eval did not run through ffm_logits")
        require(ffm_fused_logits.launches_by_instance["c40_k16_bf16"] == 2,
                f"bf16 1M eval ran kernel #1's instances {ffm_fused_logits.launches_by_instance}")
        require(all(math.isfinite(x) for k in ("train_loss", "eval_loss", "eval_auc")
                    for x in ehist[k]), "non-finite bf16 1M training history")
        require(ehist["train_loss"][1] < ehist["train_loss"][0],
                "bf16 1M: epoch 2 train loss is not below epoch 1's")
        require(ehist["eval_auc"][-1] > 0.5, "bf16 1M: eval AUC not above 0.5")
        ebase = etrainer.state  # not stepped below: each chain steps a clone

        def echain(ctx=contextlib.nullcontext):
            s_ = clone_state(ebase)
            with ctx():
                losses = [emodel.train_step(s_, b).loss_sum.item() for b in bbatches]
            return s_, losses

        s_kern, l_kern = echain()
        s_again, _ = echain()
        same = all(torch.equal(a, b) for a, b in zip(s_kern, s_again))
        del s_again
        s_plain, l_plain = echain(plain_kernels)
        names = ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z")
        eerr = {n: (getattr(s_kern, n).float() - getattr(s_plain, n).float()).abs().max().item()
                for n in (*names, "vec_w")}
        plain_ok = all(torch.allclose(getattr(s_kern, n), getattr(s_plain, n),
                                      rtol=CHAIN_RTOL, atol=CHAIN_ATOL) for n in names)
        plain_ok &= torch.allclose(s_kern.vec_w.float(), s_plain.vec_w.float(),
                                   rtol=BF16_RTOL, atol=CHAIN_ATOL)
        ldiff = max(abs(a - b) / abs(b) for a, b in zip(l_kern, l_plain))
        print(f"train 1M bf16: 3 chained steps, kernels vs plain: loss rel diff {ldiff:.2e}, "
              f"max |diff| {eerr}; two kernel runs bit-identical={same}")
        require(plain_ok, "chained bf16 in-place steps disagree with the plain versions")
        require(same, "two runs of the same bf16 in-place steps differ")
        del s_kern, s_plain, ebase

        # serving a seeded 1M state with a bf16 table: evaluate() and
        # predict_file() on phase 4's eval rows, against the plain version
        scfg_h = dataclasses.replace(cfg, table_dtype="bfloat16")
        hstate = seeded_state(scfg_h, device, SEED)
        hstate = hstate._replace(vec_w=hstate.vec_w.to(bf16))
        strainer = Trainer(scfg_h, state=hstate)
        del hstate
        ffm_fused_logits.launches = 0
        zero_instances()
        t0 = time.perf_counter()
        hloss, hauc = strainer.evaluate()
        t_heval = time.perf_counter() - t0
        hpreds = os.path.join(tmp, "preds_bf16.txt")
        n_hpred = strainer.predict_file(data, hpreds)
        hserve_launches = ffm_fused_logits.launches
        hserve_instances = dict(ffm_fused_logits.launches_by_instance)
        # every batch reaches kernel #1 as the table's bf16 rows: no
        # widening pass before it
        require(hserve_launches == 2 * n_batches == hserve_instances["c40_k16_bf16"],
                f"bf16 serving launched ffm_logits {hserve_instances}")
        require(n_hpred == N_ROWS, f"bf16 predict_file scored {n_hpred} of {N_ROWS}")
        href_loss, hmax_err, hplain_probs = serving_reference(strainer, data, "bf16 serving")
        hpdiff = float(np.abs(np.loadtxt(hpreds) - hplain_probs).max())
        print(f"serve bf16: evaluate loss={hloss:.6f} auc={hauc:.6f} ({t_heval:.2f} s, first "
              f"pass); predict_file wrote {n_hpred}; ffm_logits launches={hserve_launches} "
              f"{hserve_instances}; "
              f"plain-version loss {href_loss:.6f}, logits max_abs_err={hmax_err:.2e}, "
              f"probability max |diff| {hpdiff:.2e}")
        require(abs(href_loss - hloss) <= 1e-5 * max(1.0, hloss),
                "bf16 eval loss off the reference")
        require(hpdiff <= 2e-6, "bf16 predictions off the reference")
        passes = []
        for _ in range(2):
            t0 = time.perf_counter()
            strainer.evaluate()
            passes.append(time.perf_counter() - t0)
        hplaced = [strainer._place_batch(a) for a in StreamReader(
            data, "libffm", BATCH, N_FIELDS, N_FEATS, N_FIELDS,
            n_parse_threads=4, log_every=0).batches()]
        hcycle_e = itertools.cycle(hplaced)
        hdev_ms = cuda_ms(lambda: strainer.model.eval_step(strainer.state, next(hcycle_e)),
                          2 * len(hplaced))
        print(f"timing: bf16 eval_step on the device {hdev_ms:.3f} ms/batch (f32 table "
              f"{dev_ms:.3f}); bf16 evaluate() {[N_ROWS / t for t in passes]} examples/s "
              f"(n_feats={N_FEATS}, B={BATCH}, {N_ROWS} rows) [{where}]")
        del strainer, hplaced, hcycle_e
        torch.cuda.empty_cache()

        phase_done("5c bf16")
        # ---- 5c, bf16: kernel #3 on a bf16 w, the bf16 1M train step ----
        tabs = list(pass_inputs(N_FEATS, e, gen, device, p))
        tabs[2] = tabs[2].to(bf16)
        pruns_h, pass_bf16_ms, pass_bf16_plain_ms = interleaved_ms(
            lambda: closed_form_pass(*tabs, p), lambda: closed_form_pass_plain(*tabs, p), 10, 3)
        # five f32 streams (read n, z', A; write n, z) and two bf16 ones
        # (read and write w)
        pass_bf16_bound = bound(N_FEATS * e * (5 * 4 + 2 * 2), 20 * N_FEATS * e)
        print(f"timing: ftrl_pass bf16 w R={N_FEATS} E={e}: kernel {pruns_h['kernel']} ms, plain "
              f"{pruns_h['plain']} ms; bound {pass_bf16_bound[0]:.4f} ms ({pass_bf16_bound[1]}); "
              f"the f32 form {pass_ms:.4f} ms [{where}]")
        del tabs
        ecycle = itertools.cycle(bplaced)
        estep_ms = [cuda_ms(lambda: emodel.train_step(etrainer.state, next(ecycle)),
                            2 * len(bplaced)) for _ in range(2)]
        epochs = []
        for _ in range(2):
            t0 = time.perf_counter()
            etrainer.train_epoch()
            torch.cuda.synchronize()
            epochs.append(time.perf_counter() - t0)
        eeps = [N_ROWS / t for t in epochs]
        print(f"timing: bf16 train_step on the device at 1M (inplace): {estep_ms} ms/batch (f32 "
              f"{step['inplace']}); train_epoch() streamed {eeps} examples/s [{where}]")

        phase_done("5e")
        # ---- 5e. LR and FM's kernel forms timed (4f ran with 4b) ----
        narrow_time = lr_fm_kernel_times(gen, device, where, p)

        phase_done("3f")
        # ---- 3f. the probe kernels against their plain versions ----
        # the probes at their default sizes need ~25 GB beside 4c's state
        # (7.7 GB, kept for phase 6)
        del bbatches, batches
        torch.cuda.empty_cache()
        from ftrl_ffm_tpu_torch.tools import micro_canon_kernel as mcanon
        from ftrl_ffm_tpu_torch.tools import micro_dma_gather as mgather
        from ftrl_ffm_tpu_torch.tools import micro_lazy as mlazy
        from ftrl_ffm_tpu_torch.tools import micro_vmem_rmw as mrmw
        from ftrl_ffm_tpu_torch.tools import micro_vmem_rmw2 as mrmw2

        probe_err = {}
        # the no-w pass on 3e's shapes: micro_lazy's default R=1M, E=640 first
        for label, r, e, off in pass_cases:
            n_t, z_t, _, a = pass_inputs(r, e, gen, device, mlazy.P)
            runs = []
            for _ in range(2):
                got = [offset_copy(n_t, off), offset_copy(z_t, off)]
                mlazy.pass3(*got, offset_copy(a, off), mlazy.P)
                torch.cuda.synchronize()
                runs.append(got)
                del got
            want = mlazy.pass3_plain(n_t, z_t, a, mlazy.P)
            torch.cuda.synchronize()
            err = max((x - y).abs().max().item() for x, y in zip(runs[0], want))
            ok = all(torch.allclose(x, y, rtol=PASS_RTOL, atol=PASS_ATOL)
                     for x, y in zip(runs[0], want))
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            print(f"kernel micro_pass3 {label}: R={r} E={e} offset={off} max_abs_err={err:.3e} "
                  f"{'ok' if ok else 'MISMATCH'}; repeat bit-identical={same}")
            require(ok, f"micro_pass3 {label} disagrees")
            require(same, f"micro_pass3 {label} is not deterministic")
            if label == "main_1m":
                probe_err["micro_pass3"] = err
            del n_t, z_t, a, runs, want

        def canon_inputs(b, vals_kind):
            """micro_canon_kernel's inputs: rows N(0, 0.1), values 1 with the
            pad column 0 (the probe's) or uniform, the last sample padding."""
            v = torch.randn((b * mcanon.CP, mcanon.E), generator=gen, device=device) * 0.1
            if vals_kind == "pad":
                vals = torch.ones((b, mcanon.CP), device=device)
                vals[:, mcanon.C:] = 0.0
            else:
                vals = torch.rand((b, mcanon.CP), generator=gen, device=device)
            lin = torch.randn((b,), generator=gen, device=device) * 0.1
            y = torch.randint(0, 2, (b,), generator=gen, device=device).to(torch.float32)
            sw = torch.ones((b,), device=device)
            if b > 1:
                sw[-1] = 0.0
            return v, vals, lin, y, sw

        def iota_fields(b):
            return torch.arange(mcanon.CP, dtype=torch.int32, device=device).repeat(b, 1)

        # (label, B, NOTR, values): the probe's default batch, the main path's,
        # odd and single batches, uniform values in every column, the NOTR variant
        canon_cases = [
            ("probe_default", 8192, False, "pad"),
            ("main_batch", BATCH, False, "pad"),
            ("odd_b", 333, False, "uniform"),
            ("b1", 1, False, "pad"),
            ("notr", 333, True, "pad"),
        ]
        for label, b, notr, vals_kind in canon_cases:
            args = canon_inputs(b, vals_kind)
            logits, gg2 = mcanon.canon(*args, notr=notr)
            torch.cuda.synchronize()
            refs = {"plain": mcanon.canon_plain(*args, notr=notr)}
            if not notr:
                refs["kernel #2"] = ffm_fused_logits_grads(
                    args[0], iota_fields(b), *args[1:], mcanon.CP, mcanon.K, aug_lane=mcanon.AUG_LANE)
            torch.cuda.synchronize()
            for ref_name, (ref_logits, ref_gg2) in refs.items():
                err = max((logits - ref_logits).abs().max().item(), (gg2 - ref_gg2).abs().max().item())
                ok = (torch.allclose(logits, ref_logits, rtol=RTOL, atol=ATOL)
                      and torch.allclose(gg2, ref_gg2, rtol=RTOL, atol=GRAD_ATOL)
                      and bool(torch.isfinite(gg2).all()))
                print(f"kernel micro_canon {label}: B={b} NOTR={notr} values={vals_kind} against "
                      f"{ref_name}: max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
                require(ok, f"micro_canon {label} disagrees with {ref_name}")
                if label == "main_batch":
                    probe_err["micro_canon"] = max(probe_err.get("micro_canon", 0.0), err)
            del args, logits, gg2, refs

        # (label, N, PER, E): the probes' field shape, every id one row (PER=1)
        # at E=1, odd sizes; pairs of equal ids forced for dual
        rmw_cases = [("probe_default", 8192, 2564, 640), ("dups_e1", 1000, 1, 1), ("odd", 130, 333, 37)]
        for label, n, per, e in rmw_cases:
            idx = torch.randint(0, per, (n,), generator=gen, device=device, dtype=torch.int32)
            idx[1::2][::3] = idx[0::2][::3]
            pay = torch.randn((n, e), generator=gen, device=device)
            rows = mrmw2.per_pad(per)
            for variant in mrmw2.VARIANTS:
                got = [mrmw2.run_kernel(idx, pay, variant, rows) for _ in range(2)]
                torch.cuda.synchronize()
                want = mrmw2.rmw_plain(idx.cpu(), pay.cpu(), variant, rows)
                ok, same = torch.equal(got[0].cpu(), want), torch.equal(got[0], got[1])
                print(f"kernel micro_rmw2 {label} {variant}: N={n} PER={per} E={e} bit-identical to "
                      f"plain={ok}; repeat bit-identical={same}")
                require(ok and same, f"micro_rmw2 {label} {variant} disagrees")
            rows = -(-per // 8) * 8
            for dtype in mrmw2.PAY_DTYPES:
                p_t = pay.to(dtype)
                got = mrmw.rmw(idx, p_t, rows)
                torch.cuda.synchronize()
                ok = torch.equal(got.cpu(), mrmw2.rmw_plain(idx.cpu(), p_t.cpu(), "base", rows))
                print(f"kernel micro_rmw {label} {dtype}: N={n} PER={per} E={e} bit-identical to "
                      f"plain={ok}")
                require(ok, f"micro_rmw {label} {dtype} disagrees")
            del idx, pay, got, want
        probe_err["micro_rmw"] = probe_err["micro_rmw2"] = 0.0  # bit-identical above

        # (label, NNZ, E2, dtype, BLK): the probe's default, the main path's
        # nnz, bf16, a ragged tail at E2=1, odd sizes
        gather_cases = [
            ("probe_default", 319488, 1280, torch.float32, 512),
            ("main_nnz", BATCH * N_FIELDS, 1280, torch.float32, 512),
            ("probe_bf16", 319488, 1280, torch.bfloat16, 512),
            ("tail_e1", 1000, 1, torch.float32, 512),
            ("odd_bf16", 777, 37, torch.bfloat16, 16),
        ]
        for label, nnz, e2, dtype, blk in gather_cases:
            perm = torch.randperm(nnz, generator=gen, device=device).to(torch.int32)[: nnz // blk * blk]
            pay = torch.randn((nnz, e2), generator=gen, device=device).to(dtype)
            got = [mgather.dma_gather_sum(perm, pay) for _ in range(2)]
            want = mgather.dma_gather_sum_plain(perm, pay)
            torch.cuda.synchronize()
            err = (got[0] - want).abs().max().item()
            scale = want[0].abs().max().item()
            ok = err <= GATHER_RTOL * scale and bool((got[0][1:] == 0).all())
            same = torch.equal(got[0], got[1])
            print(f"kernel micro_gather {label}: NNZ={nnz} used={perm.numel()} E2={e2} {dtype} "
                  f"max_abs_err={err:.3e} (max |sum| {scale:.3e}) {'ok' if ok else 'MISMATCH'}; "
                  f"repeat bit-identical={same}")
            require(ok and same, f"micro_gather {label} disagrees")
            if label == "probe_default":
                probe_err["micro_gather"] = err
            del perm, pay, got, want

        phase_done("5d")
        # ---- 5d. the probes' entry points, then their kernels timed ----
        for key in PROBE_ENV:  # each probe at its defaults
            os.environ.pop(key, None)
        probe_fns = (mlazy.pass3, mcanon.canon, mrmw.rmw, mrmw2.run_kernel, mgather.dma_gather_sum)
        for fn in probe_fns:
            fn.launches = 0
        t0 = time.perf_counter()
        probe_ms = {}  # each probe's own times, reused below where 5d needs them
        for mod in (mlazy, mcanon, mrmw, mrmw2, mgather):
            name = mod.__name__.rsplit('.', 1)[1]
            print(f"probe {name}:")
            probe_ms[name] = mod.main(device="cuda")
        probe_launches = {fn.__name__: fn.launches for fn in probe_fns}
        print(f"probes: the five entry points in {time.perf_counter() - t0:.1f} s; launches "
              f"{probe_launches} [{where}]")
        for fn_name, count in probe_launches.items():
            require(count > 0, f"{fn_name} was not launched by its probe")
        torch.cuda.empty_cache()

        probe_time = {}

        def probe_timing(name, label, kern, plain, kern_iters, plain_iters, bytes_moved, ops,
                         library=None, device_iters=None):
            """Kernel, plain and one-call ms beside the bound; with
            device_iters, also the kernel's device time (that many calls
            replayed from a CUDA graph)."""
            runs, k_ms, p_ms = interleaved_ms(kern, plain, kern_iters, plain_iters)
            lib_ms = cuda_ms(library, kern_iters) if library is not None else None
            b_ms, b_by = bound(bytes_moved, ops)
            lib_txt = f", one PyTorch call {lib_ms:.4f} ms" if lib_ms is not None else ""
            probe_time[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib_ms)
            if device_iters:
                probe_time[name]["device_ms"] = graph_ms(kern, device_iters)
                lib_txt += f"; device {probe_time[name]['device_ms']:.4f} ms (CUDA graph)"
            print(f"timing: {name} {label}: kernel {runs['kernel']} ms, plain {runs['plain']} ms"
                  f"{lib_txt}; bound {b_ms:.4f} ms ({b_by}) [{where}]")
            return k_ms

        # the no-w pass at micro_lazy's default: read n, z, A, write n, z
        e = cp * N_FACTORS
        n_t, z_t, _, a = pass_inputs(N_FEATS, e, gen, device, mlazy.P)
        probe_timing("micro_pass3", f"R={N_FEATS} E={e}", lambda: mlazy.pass3(n_t, z_t, a),
                     lambda: mlazy.pass3_plain(n_t, z_t, a), 10, 3, 5 * N_FEATS * e * 4,
                     18 * N_FEATS * e, device_iters=5)
        del n_t, z_t, a

        # the canonical kernel at the probe's batch and the main path's (the
        # record's), beside kernel #2 on the same canonical inputs (the probe
        # timed kernel #2 at its own batch)
        for b in (8192, BATCH):
            args = canon_inputs(b, "pad")
            fields = iota_fields(b)
            gen_ms = probe_ms["micro_canon_kernel"]["general"] if b == 8192 else cuda_ms(
                lambda: ffm_fused_logits_grads(args[0], fields, *args[1:], mcanon.CP, mcanon.K,
                                               aug_lane=mcanon.AUG_LANE), 10)
            notr_ms = cuda_ms(lambda: mcanon.canon(*args, notr=True), 10)
            print(f"timing: micro_canon B={b}: kernel #2 on the same inputs {gen_ms:.4f} ms, "
                  f"NOTR variant {notr_ms:.4f} ms [{where}]")
            probe_timing("micro_canon", f"B={b}", lambda: mcanon.canon(*args),
                         lambda: mcanon.canon_plain(*args), 10, 3,
                         nbytes(*args) + b * 4 + b * mcanon.CP * 2 * mcanon.E * 4,
                         6 * b * mcanon.CP * mcanon.E, device_iters=5)
            del args, fields

        # read-modify-write at the probes' default field shape: reads the payload
        # and ids, writes acc (rd reads no payload)
        n, per, e = 8192, 2564, 640
        idx = torch.randint(0, per, (n,), generator=gen, device=device, dtype=torch.int32)
        pay = torch.randn((n, e), generator=gen, device=device)
        rows = -(-per // 8) * 8
        acc0 = torch.zeros((rows, e), device=device)
        # per call (events around 50 wrapper calls: the host's dispatch
        # included) and device time (50 calls replayed from a CUDA graph)
        rmw_call = lambda: mrmw.rmw(idx, pay, rows)  # noqa: E731
        add_call = lambda: acc0.index_add(0, idx, pay)  # noqa: E731
        probe_timing("micro_rmw", f"N={n} PER={per} E={e} f32", rmw_call,
                     lambda: mrmw2.rmw_plain(idx, pay, "base", rows), 50, 10,
                     nbytes(idx, pay) + rows * e * 4, n * e, library=add_call)
        probe_time["micro_rmw"]["device_ms"] = graph_ms(rmw_call, 50)
        probe_time["micro_rmw"]["library_device_ms"] = graph_ms(add_call, 50)
        pay_bf = pay.to(torch.bfloat16)
        bf_ms = cuda_ms(lambda: mrmw.rmw(idx, pay_bf, rows), 50)
        bf_dev_ms = graph_ms(lambda: mrmw.rmw(idx, pay_bf, rows), 50)
        bf_bound = bound(nbytes(idx, pay_bf) + rows * e * 4, n * e)
        print(f"timing: micro_rmw f32: device {probe_time['micro_rmw']['device_ms']:.4f} ms, "
              f"index_add device {probe_time['micro_rmw']['library_device_ms']:.4f} ms; bf16 "
              f"payload: kernel {bf_ms:.4f} ms per call, device {bf_dev_ms:.4f} ms; bound "
              f"{bf_bound[0]:.4f} ms [{where}]")
        rows2 = mrmw2.per_pad(per)
        acc0 = torch.zeros((rows2, e), device=device)
        # base, unroll8 and dual sum the same rows (dual up to rounding): one
        # index_add computes their function; wo (last row wins) and rd (zeros
        # after reads) have no one-call counterpart
        add_ms = cuda_ms(add_call, 50)
        add_dev_ms = graph_ms(add_call, 50)
        rmw2_variants = {}
        for variant in mrmw2.VARIANTS:
            reads = nbytes(idx) + (0 if variant == "rd" else nbytes(pay))
            call = lambda: mrmw2.run_kernel(idx, pay, variant, rows2)  # noqa: E731
            probe_timing("micro_rmw2", f"{variant} N={n} PER={per} E={e}", call,
                         lambda: mrmw2.rmw_plain(idx, pay, variant, rows2), 50, 10,
                         reads + rows2 * e * 4, n * e)
            rmw2_variants[variant] = probe_time.pop("micro_rmw2")
            rmw2_variants[variant]["device_ms"] = graph_ms(call, 50)
            if variant in ("base", "unroll8", "dual"):
                rmw2_variants[variant]["library_ms"] = add_ms
                rmw2_variants[variant]["library_device_ms"] = add_dev_ms
        # rd's output is zeros whether or not it reads: its time beside a launch
        # with no ids shows the reads happen
        empty = lambda: mrmw2.run_kernel(idx[:0], pay[:0], "rd", rows2)  # noqa: E731
        rd_empty_ms, rd_empty_dev_ms = cuda_ms(empty, 50), graph_ms(empty, 50)
        print("timing: micro_rmw2 device time (CUDA graph) beside per call: " + ", ".join(
            f"{v} {t['device_ms']:.4f} / {t['ms']:.4f}" for v, t in rmw2_variants.items())
            + f" ms; index_add {add_dev_ms:.4f} / {add_ms:.4f} ms; rd with no ids "
            f"{rd_empty_dev_ms:.4f} / {rd_empty_ms:.4f} ms [{where}]")
        probe_time["micro_rmw2"] = dict(rmw2_variants["base"], variants=rmw2_variants)
        del idx, pay, pay_bf, acc0

        # the gathered sum at the probe's default: reads the ids and the rows;
        # one embedding_bag (a single bag, summed) computes the same sum
        nnz, e2 = 319488, 1280
        perm = torch.randperm(nnz, generator=gen, device=device).to(torch.int32)
        pay = torch.randn((nnz, e2), generator=gen, device=device)
        bag = torch.zeros((1,), dtype=torch.int32, device=device)
        probe_timing("micro_gather", f"NNZ={nnz} E2={e2} f32",
                     lambda: mgather.dma_gather_sum(perm, pay),
                     lambda: mgather.dma_gather_sum_plain(perm, pay), 20, 5,
                     nbytes(perm, pay) + 8 * e2 * 4, nnz * e2,
                     library=lambda: torch.nn.functional.embedding_bag(perm, pay, bag, mode="sum"),
                     device_iters=20)
        bag_err = (torch.nn.functional.embedding_bag(perm, pay, bag, mode="sum")[0]
                   - mgather.dma_gather_sum(perm, pay)[0]).abs().max().item()
        pay_bf = pay.to(torch.bfloat16)
        gbf_ms = cuda_ms(lambda: mgather.dma_gather_sum(perm, pay_bf), 20)
        print(f"timing: micro_gather: index_select alone (the gather without the sum, the TPU "
              f"probe's baseline, from the probe) {probe_ms['micro_dma_gather']['index_select']:.4f}"
              f" ms; embedding_bag's sum within {bag_err:.3e} of the kernel's; bf16 payload "
              f"{gbf_ms:.4f} ms; {probe_time['micro_gather']['ms'] * 1e6 / nnz:.2f} ns/row f32 "
              f"[{where}]")
        del perm, pay, pay_bf, bag

        phase_done("7")
        # ---- 7. the device-resident dataset (Config.device_cache) ----
        # bench.py's protocol at full size: its data (write_criteo_like at
        # seed 7 is bench.py::ensure_data's generator; 400,000 rows), its
        # model (FFM, K=16, 39 fields, max_nnz 39, B=16,384, online,
        # n_epochs=4, n_threads=3), one warm-up train_epoch() (after the
        # parse and upload), then the best of 3 timed epochs; at 100k rows
        # (f32, and bf16 tables and payload) and at 1M ("inplace")
        from ftrl_ffm_tpu_torch.models.base import dec6_decode

        from ftrl_ffm_tpu_torch import bench

        t0 = time.perf_counter()
        bench_p = {nf: os.path.join(tmp, f"bench{nf}.ffm") for nf in (TRAIN_FEATS, N_FEATS)}
        # bench.py's file (the bench twin writes its bytes), and the same
        # generator over 1M ids
        bench.ensure_data(bench_p[TRAIN_FEATS])
        write_criteo_like(bench_p[N_FEATS], BENCH_ROWS, N_FEATS)
        print(f"resident: wrote {BENCH_ROWS} bench rows at n_feats {TRAIN_FEATS} and "
              f"{N_FEATS} in {time.perf_counter() - t0:.1f} s")
        bench_steps = math.ceil(BENCH_ROWS / BATCH)

        # the sync guard is live: a host sync under it raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch.zeros(1, device=device).item()
            guard_live = False
        except RuntimeError:
            guard_live = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        require(guard_live, "torch.cuda.set_sync_debug_mode('error') let a sync through")

        def guarded_epoch(trn, epoch_rng=None):
            """One resident epoch whose step loop (the gathers, the train
            steps, a shuffled epoch's index upload) runs under
            set_sync_debug_mode("error"): any host sync there raises.  The
            loss readback after it is outside.  (steps, mean loss)."""
            batches = trn._cached_batches(trn._fresh_cache("train"), epoch_rng)
            torch.cuda.set_sync_debug_mode("error")
            try:
                sums = trn._train_steps(batches)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            return len(sums), trn._epoch_loss(sums)

        def same_state(a, b) -> bool:
            return all(torch.equal(x, y) for x, y in zip(a, b))

        # (a) eval from the resident dataset: serve-ffm-1m's seeded state
        # and eval rows (phase 4), against phase 4's streamed evaluate()
        rcfg_e = dataclasses.replace(cfg, device_cache="auto")
        rserve = Trainer(rcfg_e, state=seeded_state(rcfg_e, device, SEED))
        ffm_fused_logits.launches = 0
        zero_instances()
        t0 = time.perf_counter()
        r_metrics = rserve.evaluate()
        t_first = time.perf_counter() - t0
        r_eval_launches = ffm_fused_logits.launches
        r_eval_instances = dict(ffm_fused_logits.launches_by_instance)
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            rserve.evaluate()
            passes.append(time.perf_counter() - t0)
        r_eval_eps = [N_ROWS / t for t in passes]
        print(f"resident eval: serve-ffm-1m evaluate() resident {r_eval_eps} examples/s "
              f"(first pass, with the parse and upload, {t_first:.3f} s); streamed (phase 5) "
              f"{eps} examples/s; device_cache: {rserve._dev_cache.get('eval') is not None}; "
              f"loss/auc {r_metrics} against the streamed {serve_metrics}; ffm_logits launches "
              f"in the first pass {r_eval_launches}, by instance {r_eval_instances} [{where}]")
        require(rserve._dev_cache.get("eval") is not None, "eval did not take the resident dataset")
        require(r_eval_launches == n_batches == r_eval_instances["c40_k16"],
                f"resident eval ran kernel #1 {r_eval_instances}, expect {n_batches} c40_k16")
        require(r_metrics == serve_metrics, "resident and streamed eval differ")
        del rserve
        torch.cuda.empty_cache()

        # (b) DEC6 on the card: the compact values' decode over all 2^24 keys
        got = dec6_decode(torch.arange(1 << 24, dtype=torch.int32, device=device)).cpu().numpy()
        want = (np.arange(1 << 24, dtype=np.float64) / 1e6).astype(np.float32)
        dec6_off = int((got.view(np.uint32) != want.view(np.uint32)).sum())
        print(f"resident: dec6_decode on the card over all 2^24 keys: {dec6_off} differ from "
              f"float64 k / 1e6 rounded to f32")
        require(dec6_off == 0, "dec6_decode on the card is not correctly rounded")
        del got, want

        # (c) the bench protocol, cell by cell; its launches; the same bits
        # as a streamed twin from the same init
        resident = {}
        r_trainers = {}
        bf16_kw = dict(table_dtype="bfloat16", acc_dtype="bfloat16")
        for label, nf, extra in (("100k", TRAIN_FEATS, {}), ("100k-bf16", TRAIN_FEATS, bf16_kw),
                                 ("1M", N_FEATS, {"update_mode": "inplace"})):
            # the bench twin's config and protocol (ftrl_ffm_tpu_torch/bench.py)
            # from an init kept for the twins below (the Trainer's own seeded
            # init)
            rcfg = bench.make_config(bench_p[nf], "cuda", n_feats=nf, **extra)
            init = make_model(rcfg).init(torch.Generator(device=device).manual_seed(rcfg.seed))
            res = bench.run(rcfg, state=clone_state(init))
            rtr, counts, losses = res["trainer"], res["counts"], res["losses"]
            r_launch = res["launches"]
            r_inst, r_upd = counts["fused_by_instance"], counts["update_by_dtype"]
            entry = rtr._dev_cache.get("train")
            rec = {
                "cell": f"train-ffm-{label.lower()}-resident",
                "examples_per_s": res["value"],
                "runs": res["runs"],
                "build_s": res["build_s"],
                "warmup_s": res["warmup_s"],
                "device_cache": res["device_cache"],
                "losses": losses,
                "steps": rtr._steps_done,
                "launches": r_launch,
                "by_instance": r_inst,
                "update_by_dtype": r_upd,
                "pass_by_dtype": counts["pass_by_dtype"],
                "card": where,
            }
            print(f"resident {label}: {json.dumps(rec)}")
            require(entry is not None and not entry.compact and entry.n == BENCH_ROWS,
                    f"{label}: the bench run did not take the raw resident dataset")
            require(entry.ds[0].shape[0] == 0 and entry.ds[2].shape[0] == 0,
                    f"{label}: the Criteo-shaped rows did not take the iota and ones markers")
            require(rtr._steps_done == 4 * bench_steps,
                    f"{label}: {rtr._steps_done} steps, expect {4 * bench_steps}")
            steps = 3 * bench_steps  # the timed epochs' launches
            require(r_launch["ffm_fused_logits_grads"] == steps, f"{label}: kernel #2 {r_launch}")
            if nf == N_FEATS:
                require(r_launch["za_scatter"] == r_launch["closed_form_pass"] == steps
                        and r_launch["ftrl_update"] == 0 and r_inst == {"c40_k16": steps},
                        f"{label}: the in-place path ran {r_launch} {r_inst}")
            else:
                dt = "bf16/bf16" if extra else "f32/f32"
                inst = "c40_k16_bf16" if extra else "c40_k16"
                require(r_upd == {dt: steps} and r_inst == {inst: steps}
                        and r_launch["za_scatter"] == 0,
                        f"{label}: the dense2 path ran {r_launch} {r_inst} {r_upd}")
            require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
                    f"{label}: resident losses {losses}")

            if label == "100k":
                # compact storage (device_cache_compact=on): split ids,
                # decoded after each gather; the raw resident run's bits
                ctr = Trainer(dataclasses.replace(rcfg, device_cache_compact="on"),
                              state=clone_state(init))
                c_losses = [ctr.train_epoch() for _ in range(4)]
                centry = ctr._dev_cache["train"]
                c_same = same_state(ctr.state, rtr.state) and c_losses == losses
                print(f"resident {label}: device_cache_compact=on stores feats as "
                      f"{centry.ds[1].dtype} {tuple(centry.ds[1].shape)} "
                      f"({centry.ds[1].numel() / BENCH_ROWS:.0f} B a row, raw "
                      f"{4 * N_FIELDS}); 4 epochs bit-identical to the raw resident run="
                      f"{c_same}")
                require(centry.compact and centry.ds[1].dtype == torch.uint8 and c_same,
                        "compact resident storage differs from the raw one")
                del ctr, centry

                # the offline shuffled replay: the epoch's index table
                # uploaded once (train_epoch) against one row uploaded a
                # step; the same batches, so the same bits; then timed in
                # turns
                ocfg = dataclasses.replace(rcfg, online=False)
                o_tab = Trainer(ocfg, state=clone_state(rtr.state))
                o_row = Trainer(ocfg, state=clone_state(rtr.state))

                def row_upload_epoch(trn, epoch_rng):
                    cache = trn._fresh_cache("train")
                    idx, _ = _draw_rows(epoch_rng, cache.n, *trn._cache_steps(cache),
                                        trn._local_bs)
                    return trn._epoch_loss(trn._train_steps(
                        trn._take_cached(cache, trn._upload(row)) for row in idx))

                rng_tab, rng_row = np.random.default_rng(SEED), np.random.default_rng(SEED)
                l_tab = o_tab.train_epoch(rng_tab)
                o_row._dev_cache["train"] = o_tab._dev_cache["train"]  # one upload for both
                l_row = row_upload_epoch(o_row, rng_row)
                o_same = same_state(o_tab.state, o_row.state) and l_tab == l_row
                shuf = {"table": [], "rows": []}
                for which in ("table", "rows", "rows", "table", "table", "rows"):
                    t0 = time.perf_counter()
                    if which == "table":
                        o_tab.train_epoch(rng_tab)
                    else:
                        row_upload_epoch(o_row, rng_row)
                    torch.cuda.synchronize()
                    shuf[which].append(BENCH_ROWS / (time.perf_counter() - t0))
                o_steps, o_loss = guarded_epoch(o_tab, rng_tab)
                print(f"resident {label} offline shuffled: train_epoch() (index table uploaded "
                      f"once) {shuf['table']} examples/s; one row uploaded a step "
                      f"{shuf['rows']} examples/s; first epochs bit-identical={o_same}; one "
                      f"shuffled epoch's step loop ({o_steps} steps) under "
                      f"set_sync_debug_mode('error'): no sync [{where}]")
                require(o_same, "the shuffled replays with a table and with row uploads differ")
                require(o_steps == bench_steps and math.isfinite(o_loss), "guarded shuffled epoch")
                resident["offline"] = shuf
                del o_tab, o_row

            # the same bits as the streamed twin (device_cache=off) over the
            # same 4 epochs from the same init
            twin = Trainer(dataclasses.replace(rcfg, device_cache="off"), state=init)
            del init
            t0 = time.perf_counter()
            t_losses = [twin.train_epoch() for _ in range(4)]
            torch.cuda.synchronize()
            t_s = time.perf_counter() - t0
            same = same_state(rtr.state, twin.state) and t_losses == losses
            print(f"resident {label}: the six tables, bias and step after 4 epochs bit-identical "
                  f"to a streamed twin's (device_cache=off)={same}; losses {losses} vs "
                  f"{t_losses}; the twin's 4 streamed epochs {t_s:.2f} s "
                  f"({4 * BENCH_ROWS / t_s:.0f} examples/s) [{where}]")
            require(same and "train" not in twin._dev_cache,
                    f"{label}: resident and streamed runs differ")
            del twin
            torch.cuda.empty_cache()

            g_steps, g_loss = guarded_epoch(rtr)
            print(f"resident {label}: one epoch's step loop ({g_steps} steps) ran under "
                  f"torch.cuda.set_sync_debug_mode('error'): no host sync; loss {g_loss:.6f}")
            require(g_steps == bench_steps and math.isfinite(g_loss), "guarded resident epoch")
            resident[label] = rec
            r_trainers[label] = rtr
            del rtr, entry
        lrfm_resident, lrfm_r_trainers = lr_fm_resident(bench_p[TRAIN_FEATS], tmp, device, where)

        phase_done("8")
        # ---- 8. checkpoints: save, resume, reference import/export ----
        checkpoint_phase(bench_p[TRAIN_FEATS], tmp, device, where, r_trainers, lrfm_r_trainers)

        phase_done("10")
        # ---- 10. steps_per_call > 1: CUDA-graph groups, the feeder ----
        multi = multi_step_phase(device, where, r_trainers, lrfm_r_trainers)
        phase_done("10b")
        # ---- 10b. the transfer tiers phase 10's file does not reach ----
        transfer_phase(bench_p[TRAIN_FEATS], tmp, where)
        if "100k-bf16" in r_trainers:
            del r_trainers["100k-bf16"]  # phase 6 traces the f32 cells
        torch.cuda.empty_cache()

        phase_done("6")
        # ---- 6. profiles: after every timed phase ----
        # a profiler run may leave the host's launch path slower for the rest
        # of the process, so the device breakdowns of the train steps and the
        # traces of whole epochs come last
        from ftrl_ffm_tpu_torch.tools import profile_ms

        for label, mdl, trn, cyc, n in (
            ("n_feats=100k dense2", tmodel, ttrainer, tcycle, len(tplaced)),
            ("n_feats=100k dense2, bf16 table and payload", hmodel, htrainer, hcycle,
             len(tplaced)),
            ("n_feats=1M inplace", bmodel, btrainer, bcycle, len(bplaced)),
            ("n_feats=1M inplace, bf16 table", emodel, etrainer, ecycle, len(bplaced)),
            ("n_feats=1M dense", dmodel, btrainer, bcycle, len(bplaced)),
        ):
            print_breakdown(f"train_step {label}", profile_ms(
                lambda: mdl.train_step(trn.state, next(cyc)), n), where)
        # LR and FM's steps by part: gather, the plain PyTorch ops (FM's
        # interaction chain, the payload, the loss) with their largest, the
        # sort, the update kernel, the scatter, the fills (A's zeroing), the
        # pass; beside the step's CUDA-event time of phase 5
        for cell, rec in lrfm.items():
            cyc = itertools.cycle(rec["placed"])
            variants = [("", rec["model"], rec["step_ms"])]
            if rec["dense_model"] is not None:
                variants.append((" update_mode=dense", rec["dense_model"], rec["dense_step_ms"]))
            for suffix, mdl, event_ms in variants:
                rows = profile_ms(lambda: mdl.train_step(rec["trainer"].state, next(cyc)),
                                  len(rec["placed"]))
                parts, largest = step_categories(rows)
                print(f"profile: train_step {cell}{suffix}: device {sum(ms for _, ms in rows):.4f} "
                      f"ms per step by part {json.dumps(parts)}; largest other op {largest[0]} "
                      f"{largest[1]:.4f} ms; the step by CUDA events {event_ms} ms [{where}]")
                print_breakdown(f"train_step {cell}{suffix}", rows, where)
        # the device's busy share of one train_epoch(): device time (kernels,
        # copies, fills, on one stream) over the epoch's wall time, both from
        # the traced epoch
        # (label, trainer, untraced examples/s, rows an epoch): the streamed
        # cells, then the resident ones (bench.py's 400,000 rows)
        for label, trn, eps_untraced, rows in (
            ("n_feats=100k", ttrainer, teps, N_ROWS),
            ("n_feats=100k bf16", htrainer, heps, N_ROWS),
            ("n_feats=1M", btrainer, beps, N_ROWS),
            ("n_feats=1M bf16", etrainer, eeps, N_ROWS),
            ("n_feats=100k resident", r_trainers["100k"], resident["100k"]["runs"], BENCH_ROWS),
            ("n_feats=1M resident", r_trainers["1M"], resident["1M"]["runs"], BENCH_ROWS),
            *((cell, trn, lrfm_resident[cell]["runs"], BENCH_ROWS)
              for cell, trn in lrfm_r_trainers.items()),
        ):
            walls = []

            def epoch():
                t0 = time.perf_counter()
                trn.train_epoch()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)

            prof_rows = profile_ms(epoch, 1)
            busy, wall = sum(ms for _, ms in prof_rows), walls[-1]
            print(f"profile: train_epoch() {label}: device busy {busy:.3f} ms of {wall:.3f} ms "
                  f"traced wall time, idle {1 - busy / wall:.4f}; untraced epochs "
                  f"{[rows / x * 1e3 for x in eps_untraced]} ms [{where}]")
            if "resident" in label:
                print(f"profile: train_epoch() {label}, device ms per epoch by kernel: "
                      + ", ".join(f"{name[:60]} {ms:.3f}" for name, ms in prof_rows[:10]))
            if label in lrfm_r_trainers:
                steps = math.ceil(BENCH_ROWS / BATCH)
                parts, largest = step_categories(prof_rows)
                print(f"profile: train_epoch() {label}: device ms per step by part "
                      f"{json.dumps({k: v / steps for k, v in parts.items()})}; largest other op "
                      f"{largest[0]} {largest[1] / steps:.4f} ms")
        del ttrainer, tmodel, tplaced, tcycle, btrainer, bmodel, dmodel, bplaced, bcycle
        del htrainer, hmodel, hcycle, etrainer, emodel, ecycle, r_trainers, lrfm_r_trainers
        fm_counts = {cell: rec["counts"] for cell, rec in lrfm.items()}
        del lrfm, frec
        torch.cuda.empty_cache()

        phase_done("9")
        # ---- 9. the measurement tools, each through its entry point ----
        tools_phase(bench_p[TRAIN_FEATS], train_p, tmp, where)
        phase_done("11")
        # ---- 11. the mesh: the CLI's three flags, NCCL ----
        mesh = mesh_phase(bench_p[TRAIN_FEATS], tmp, where)
        phase_done("end")

    records = [
        {
            "name": "ffm_logits",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ffm_logits.cu",
            "replaces": "ftrl_ffm_tpu/ops/ffm_pallas.py:235",
            "launches": launches,
            "max_abs_err": criteo_err,
            "resident_launches": r_eval_launches,
            "ms": k_ms,
            "device_ms": k_dev_ms,
            "plain_ms": p_ms,
            "bound_ms": logits_bound[0],
            "bound_by": logits_bound[1],
            "library_ms": None,
        },
        {
            # kernel #1 on a bf16 table's rows, read as they are (4e's
            # serving launches)
            "name": "ffm_logits_bf16",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ffm_logits.cu",
            "replaces": "ftrl_ffm_tpu/ops/ffm_pallas.py:235",
            "launches": hserve_instances["c40_k16_bf16"],
            "max_abs_err": criteo_bf16_err,
            "ms": kh_ms,
            "device_ms": kh_dev_ms,
            "plain_ms": ph_ms,
            "bound_ms": logits_bf16_bound[0],
            "bound_by": logits_bf16_bound[1],
            "library_ms": None,
        },
        {
            "name": "ffm_fused",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ffm_fused.cu",
            "replaces": "ftrl_ffm_tpu/ops/ffm_pallas.py:38",
            # both training paths: combined (4b) and split (4c) output
            "launches": fused_launches + big["ffm_fused_logits_grads"],
            "resident_launches": (resident["100k"]["launches"]["ffm_fused_logits_grads"]
                                  + resident["1M"]["launches"]["ffm_fused_logits_grads"]),
            "max_abs_err": max(fused_err, split_err),
            "ms": f_ms,
            "plain_ms": fp_ms,
            "bound_ms": fused_bound[0],
            "bound_by": fused_bound[1],
            "library_ms": None,
        },
        {
            # no Pallas kernel: XLA's scatter-add and closed-form pass of
            # ftrl_ffm_tpu/ftrl.py::dense_ftrl_update2_aug
            "name": "ftrl_update",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ftrl_update.cu",
            "replaces": "ftrl_ffm_tpu/ftrl.py:249",
            "launches": update_launches,
            "max_abs_err": update_err,
            "resident_launches": resident["100k"]["launches"]["ftrl_update"],
            "ms": u_ms,
            "plain_ms": up_ms,
            "bound_ms": update_bound[0],
            "bound_by": update_bound[1],
            "library_ms": None,
        },
        {
            # the same wrapper on the skewed batch: its hot ids take the
            # column-split kernel (ftrl_update_hot), which every main-path
            # launch also runs, finding no hot id
            "name": "ftrl_update_skewed",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ftrl_update.cu",
            "replaces": "ftrl_ffm_tpu/ftrl.py:249",
            "launches": update_launches,
            "max_abs_err": update_skew_err,
            "ms": skew_ms,
            "plain_ms": skew_plain_ms,
            "bound_ms": skew_bound[0],
            "bound_by": skew_bound[1],
            "library_ms": None,
        },
        {
            # the same wrapper on a (1, N) route mesh's received slots, the
            # split payload at the route cell's shapes (3h); the in-place
            # form it replaces beside it
            "name": "ftrl_update_routed",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ftrl_update.cu",
            "replaces": "ftrl_ffm_tpu/ftrl.py:249",
            "launches": 1,
            "max_abs_err": routed["plain_err"],
            "inplace_max_abs_err": routed["inplace_err"],
            "ms": routed["touched_ms"],
            "inplace_ms": routed["inplace_ms"],
            "bound_ms": routed["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "ftrl_pass",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ftrl_pass.cu",
            "replaces": "ftrl_ffm_tpu/ops/ftrl_pallas.py:32",
            "launches": big["closed_form_pass"],
            "resident_launches": resident["1M"]["launches"]["closed_form_pass"],
            "max_abs_err": pass_err,
            "ms": pass_ms,
            "plain_ms": pass_plain_ms,
            "bound_ms": pass_bound[0],
            "bound_by": pass_bound[1],
            "library_ms": None,
        },
        {
            # no Pallas kernel: XLA's two scatter-adds of
            # ftrl_ffm_tpu/ftrl.py::dense_ftrl_update_inplace
            "name": "za_scatter",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ftrl_update.cu",
            "replaces": "ftrl_ffm_tpu/ftrl.py:375",
            "launches": big["za_scatter"],
            "resident_launches": resident["1M"]["launches"]["za_scatter"],
            "max_abs_err": scatter_err,
            "ms": sc_ms,
            "plain_ms": sc_plain_ms,
            "bound_ms": scatter_bound[0],
            "bound_by": scatter_bound[1],
            # one index_add_ per output table
            "library_ms": sc_lib_ms,
        },
    ]
    # the bf16 forms of kernel #2 (4d), the update kernel (4d: bf16 payload
    # and w) and kernel #3 (4e: bf16 w), each launched by its own
    # instantiation; launches from the bf16 training paths
    records += [
        {
            "name": "ffm_fused_bf16",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ffm_fused.cu",
            "replaces": "ftrl_ffm_tpu/ops/ffm_pallas.py:38",
            "launches": h_instances["c40_k16_bf16"],
            "resident_launches": resident["100k-bf16"]["launches"]["ffm_fused_logits_grads"],
            "max_abs_err": fused_bf16_err,
            "ms": hf_ms,
            "plain_ms": hfp_ms,
            "bound_ms": fused_bf16_bound[0],
            "bound_by": fused_bf16_bound[1],
            "library_ms": None,
        },
        {
            "name": "ftrl_update_bf16",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ftrl_update.cu",
            "replaces": "ftrl_ffm_tpu/ftrl.py:249",
            "launches": h_update_dtypes["bf16/bf16"],
            "resident_launches": resident["100k-bf16"]["launches"]["ftrl_update"],
            "max_abs_err": update_bf16_err,
            "ms": update_bf16_time["bfloat16/bfloat16"][0],
            "plain_ms": update_bf16_time["bfloat16/bfloat16"][1],
            "bound_ms": update_bf16_time["bfloat16/bfloat16"][2][0],
            "bound_by": update_bf16_time["bfloat16/bfloat16"][2][1],
            "library_ms": None,
        },
        {
            "name": "ftrl_pass_bf16",
            "route": "cuda",
            "source": "ftrl_ffm_tpu_torch/csrc/ftrl_pass.cu",
            "replaces": "ftrl_ffm_tpu/ops/ftrl_pallas.py:32",
            "launches": e_pass_dtypes["bf16"],
            "max_abs_err": pass_bf16_err,
            "ms": pass_bf16_ms,
            "plain_ms": pass_bf16_plain_ms,
            "bound_ms": pass_bf16_bound[0],
            "bound_by": pass_bf16_bound[1],
            "library_ms": None,
        },
    ]
    # LR and FM's forms of the update kernel (E=16 with the linear stats in
    # gg2_lin, f32 and bf16 w, ftrl_update_narrow; E=0, LR's, its "linear"
    # instance), the scatter (za_scatter_narrow, and on Zipf ids also
    # za_scatter_hot) and the pass at [2^22, 16] (f32 and bf16 w): errors
    # from 3c-3g, times from 5e, launches by kernel instance from 4f's entry
    # points and phase 7's resident cells (the Zipf scatter's from its
    # resident in-place cell, the main path on such ids)
    zipf_scatter = lrfm_resident["train-fm-4m-zipf-resident"]["scatter_by_instance"]["narrow"]
    for name, source, replaces, launches, resident_launches, err_key in (
        ("ftrl_update_k16", "ftrl_update.cu", "ftrl_ffm_tpu/ftrl.py:133",
         fm_counts["train-fm-100k"]["update_by_instance"]["narrow"],
         lrfm_resident["train-fm-100k-resident"]["update_by_instance"]["narrow"], "fm_k16"),
        ("ftrl_update_k16_bf16_w", "ftrl_update.cu", "ftrl_ffm_tpu/ftrl.py:133",
         fm_counts["train-fm-100k-bf16"]["update_by_instance"]["narrow"], None, "fm_k16_bf16_w"),
        ("ftrl_update_linear", "ftrl_update.cu", "ftrl_ffm_tpu/ftrl.py:219",
         fm_counts["train-lr-100k"]["update_by_instance"]["linear"],
         lrfm_resident["train-lr-100k-resident"]["update_by_instance"]["linear"], "lr"),
        ("za_scatter_k16", "ftrl_update.cu", "ftrl_ffm_tpu/ftrl.py:375",
         fm_counts["train-fm-4m"]["scatter_by_instance"]["narrow"],
         lrfm_resident["train-fm-4m-resident"]["scatter_by_instance"]["narrow"],
         "za_scatter fm_4m"),
        ("za_scatter_k16_zipf", "ftrl_update.cu", "ftrl_ffm_tpu/ftrl.py:375", zipf_scatter,
         zipf_scatter, "za_scatter fm_4m_zipf"),
        ("ftrl_pass_k16", "ftrl_pass.cu", "ftrl_ffm_tpu/ops/ftrl_pallas.py:32",
         fm_counts["train-fm-4m"]["closed_form_pass"],
         lrfm_resident["train-fm-4m-resident"]["launches"]["closed_form_pass"],
         "ftrl_pass fm_4m"),
        ("ftrl_pass_k16_bf16_w", "ftrl_pass.cu", "ftrl_ffm_tpu/ops/ftrl_pallas.py:32",
         fm_counts["train-fm-4m-bf16"]["closed_form_pass"], None, "ftrl_pass_bf16 fm_4m"),
    ):
        require(launches > 0, f"{name} was launched no time on the main path")
        t = narrow_time[name]
        rec = {
            "name": name,
            "route": "cuda",
            "source": f"ftrl_ffm_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": narrow_err[err_key],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        }
        if t["sort_ms"] is not None:
            rec["sort_ms"] = t["sort_ms"]
        if resident_launches is not None:
            rec["resident_launches"] = resident_launches
        records.append(rec)
    # the probe kernels: the TPU kernels of tools/micro_*.py, ported to
    # ftrl_ffm_tpu_torch/tools; launches from 5d's entry points
    for kname, source, replaces, counted in (
        ("micro_pass3", "micro_pass3.cu", "tools/micro_lazy.py:66", "pass3"),
        ("micro_canon", "micro_canon.cu", "tools/micro_canon_kernel.py:41", "canon"),
        ("micro_rmw", "micro_rmw.cu", "tools/micro_vmem_rmw.py:40", "rmw"),
        ("micro_rmw2", "micro_rmw.cu", "tools/micro_vmem_rmw2.py:40", "run_kernel"),
        ("micro_gather", "micro_gather.cu", "tools/micro_dma_gather.py:38", "dma_gather_sum"),
    ):
        records.append({
            "name": kname,
            "route": "cuda",
            "source": f"ftrl_ffm_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": probe_launches[counted],
            "max_abs_err": probe_err[kname],
            **probe_time[kname],
        })
    # the launches of phase 10's S = 4 runs (2 epochs and one eval pass,
    # every group after the first of its kind a CUDA-graph replay), by the
    # record of the kernel form they ran
    for name, cell, part, counter, key in (
        ("ffm_logits", "ffm-100k", "eval", "logits_by_instance", "c40_k16"),
        ("ffm_fused", "ffm-100k", "train", "fused_by_instance", "c40_k16"),
        ("ftrl_update", "ffm-100k", "train", "update_by_dtype", "f32/f32"),
        ("ftrl_pass", "ffm-1m", "train", "pass_by_dtype", "f32"),
        ("za_scatter", "ffm-1m", "train", "scatter_by_instance", "rows"),
        ("ffm_fused_bf16", "ffm-100k-bf16", "train", "fused_by_instance", "c40_k16_bf16"),
        ("ftrl_update_bf16", "ffm-100k-bf16", "train", "update_by_dtype", "bf16/bf16"),
        ("ftrl_update_k16", "fm-100k", "train", "update_by_instance", "narrow"),
        ("ftrl_update_linear", "lr-100k", "train", "update_by_instance", "linear"),
        ("za_scatter_k16_zipf", "fm-4m-zipf", "train", "scatter_by_instance", "narrow"),
        ("ftrl_pass_k16", "fm-4m-zipf", "train", "pass_by_dtype", "f32"),
    ):
        (rec,) = [r for r in records if r["name"] == name]
        rec["replayed_launches"] = multi[cell][part][counter].get(key, 0)
        require(rec["replayed_launches"] > 0, f"{name} was launched no time in phase 10")
    # the launches of phase 11's world-size-1 mesh runs (2 epochs with eval,
    # then predict_file; and at steps_per_call 5), by the record of the
    # kernel form they ran
    for name, counter, key in (
        ("ffm_logits", "logits_by_instance", "c40_k16"),
        ("ffm_fused", "fused_by_instance", "c40_k16"),
        ("ftrl_update", "update_by_dtype", "f32/f32"),
    ):
        (rec,) = [r for r in records if r["name"] == name]
        rec["mesh_launches"] = mesh["x1"]["after_predict"][counter].get(key, 0)
        require(rec["mesh_launches"] > 0, f"{name} was launched no time in phase 11")
        # and of its S = 5 run (train() alone: the groups' replays counted)
        rec["mesh_group_launches"] = mesh["x1_s5"]["launches"][counter].get(key, 0)
        require(rec["mesh_group_launches"] > 0,
                f"{name} was launched no time in phase 11's S = 5 run")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
