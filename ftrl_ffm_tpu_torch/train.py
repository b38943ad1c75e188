"""Training and serving orchestration on one device (the single-process
subset of ftrl_ffm_tpu/train.py).

`Trainer.train`, `train_epoch`, `evaluate` and `predict_file` behave as the
JAX package's: the same streamed (online, or --cmd stdin) or shuffled
(offline, numpy default_rng(seed)) fixed-shape batches, the same per-epoch
lines and history, per-step loss sums kept on the device and read back
once per epoch, the same masked eval log-loss with a compensated (Kahan)
f32 chain on the device, the same binned or exact AUC, the same
one-probability-per-line output.

The background feeder (_feed, _feed_interleaved, _device_feed): streamed
training and eval batches are placed by feed_workers threads ahead of the
steps, in stream order, through pinned host memory with non-blocking
copies on a CUDA stream of the feeder's, each handed over with an event
that the consuming stream waits on.

steps_per_call = S > 1 groups S steps into one dispatch (the JAX package's
lax.scan groups): on the card each group after the first of its kind is
one replay of a CUDA graph that holds the S steps (_run_group), on the
CPU the same S steps run eagerly.  The remainder group is padded with
inert batches, which change no table and count no step; the losses,
states and histories equal the S = 1 run's bit for bit.

Device-resident datasets (Config.device_cache, the single-device form of
the JAX package's): a training or eval file that fits next to the state
is parsed once and uploaded once, and its epochs gather their batches on
the device from index rows made there (file order) or uploaded once an
epoch (an offline shuffle): the streamed path's batches, bit for bit, with
no host parsing after the build.  `predict_file` always streams, on the
main thread.

Meshes (Config.mesh_data x mesh_model, or more than one process: the
JAX package's mesh branches): one process drives one device, and the
sharded step (parallel/sharded.py) runs on this rank's shard of the state,
one step a dispatch or S a group, from the stream or from the rank's
resident slice (the shard layout).  See Trainer for which rows each rank
reads.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from ftrl_ffm_tpu_torch import tracing
from ftrl_ffm_tpu_torch.config import (
    Config,
    check_ported,
    detect_file_type,
    uses_mesh,
)
from ftrl_ffm_tpu_torch.data.loader import batch_iterator, count_lines, load_file
from ftrl_ffm_tpu_torch.data.parser import sniff_max_nnz
from ftrl_ffm_tpu_torch.data.stream import StreamReader
from ftrl_ffm_tpu_torch.ftrl import update_form
from ftrl_ffm_tpu_torch.io.checkpoint import (
    IncompatibleStateError,
    model_signature,
    save_checkpoint,
)
from ftrl_ffm_tpu_torch.metrics import (
    AUC_BINS,
    LossAccumulator,
    StreamingAUC,
    exact_auc,
    kahan_add,
)
from ftrl_ffm_tpu_torch.models import Batch, ModelState, make_model
from ftrl_ffm_tpu_torch.models.base import dec6_decode, take_cached
from ftrl_ffm_tpu_torch.ops import add_launch_counts, launch_counts
from ftrl_ffm_tpu_torch.parallel import dist as pdist
from ftrl_ffm_tpu_torch.tracing import span, spanned
from ftrl_ffm_tpu_torch.transfer import TransferTiers, pack_bitplanes, unpack_bitplanes


class _DevCache(NamedTuple):
    """A device-resident dataset (Config.device_cache;
    ftrl_ffm_tpu/train.py::_DevCache, one device a process).

    layout: "replicate" (the whole dataset on the device, global indices)
    or "shard" (this rank's byte-range slice of the file, local indices).
    ds: (fields, feats, vals, y) on the device, rows_loc rows: the n real
    ones then inert pad rows, fields and vals possibly zero-size markers
    (models/base.py::take_cached).  n: the real rows held here (JAX's
    n_loc for "shard": one device a process).  rows_loc: n + 1 for
    "replicate"; for "shard" the largest slice of the mesh plus one inert
    row, agreed by an all-gather, so every rank runs the same steps.
    src_stat: (size, mtime_ns) of the file before the parse that built
    it, for online roles (Trainer._fresh_cache).  compact: the arrays
    hold the compact encodings (_compact_cache_arrays)."""

    layout: str
    ds: tuple
    n: int
    rows_loc: int
    src_stat: Optional[tuple] = None
    compact: bool = False


class _OrderJob(NamedTuple):
    """The next resident pass's index rows, made ahead on the trainer's
    order thread (Trainer._prefetch_order): the epoch rng they were drawn
    for, the state its copy started from, the pass's key (the dataset's
    id and row count, the steps, the pad row's index) and the future of
    _draw_ahead's (index rows, end state)."""

    rng: np.random.Generator
    state: dict
    key: tuple
    future: object


def _draw_rows(gen: np.random.Generator, n: int, n_steps: int, pad: int, lb: int) -> tuple:
    """([n_steps, lb] int32 index rows, gen's state after them): the
    permutation of 0..n-1 that gen.shuffle draws, the call batch_iterator
    makes, then the pad row's index.  The shuffle's draws depend on n
    alone, so shuffling int32 in place gives batch_iterator's int64
    permutation.  numpy alone: it runs on the order thread too, where the
    shuffle releases the GIL."""
    rows = np.full(n_steps * lb, pad, np.int32)
    order = rows[:n]
    order[:] = np.arange(n, dtype=np.int32)
    gen.shuffle(order)
    return rows.reshape(n_steps, lb), gen.bit_generator.state


def _draw_ahead(kind: type, state: dict, *shape) -> tuple:
    """_draw_rows(gen, *shape) on a fresh generator of bit-generator type
    `kind` set to `state`: the order thread's job, on its own copy of the
    rng."""
    bg = kind()
    bg.state = state
    return _draw_rows(np.random.Generator(bg), *shape)


def _same_state(a, b) -> bool:
    """Two bit-generator states are equal (some hold numpy arrays)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_state(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    return a == b


def _compact_cache_row_bytes(cfg: Config) -> int:
    """Conservative bytes a row of the compact resident form
    (Config.device_cache_compact; ftrl_ffm_tpu/train.py::
    _compact_cache_row_bytes): split feats and packed fields always count;
    vals count as f32 (DEC6 eligibility is only known at the build, so
    budgeting the wide form can only overestimate)."""
    f = cfg.max_nnz
    pb = (f + 7) // 8
    wf = int(cfg.n_feats).bit_length()
    feats_b = (2 * f + max(0, wf - 16) * pb) if wf <= 24 else 4 * f
    w = int(max(cfg.n_fields - 1, 1)).bit_length()
    fields_b = w * pb if w <= 8 and w * pb < f else f
    return fields_b + feats_b + 4 * f + 4


def _compact_cache_arrays(ds_host: tuple, cfg: Config) -> tuple:
    """Re-encode the assembled host arrays (fields, feats, vals, y) in their
    compact resident forms (ftrl_ffm_tpu/train.py::_compact_cache_arrays),
    each lossless and decided once a dataset:
      feats  [N, F] i32 -> [N, 2F + k·Pb] u8 (low bytes ‖ high bitplanes),
                           when every id (the pad sentinel too) fits 24 bits
      vals   [N, F] f32 -> [N, 3F] u8 DEC6 keys, when every value is
                           k / 1e6 for an integer 0 <= k < 2^24
      fields [N, F] i32 -> [N, w·Pb] u8 bitplanes (w <= 8 bits a field)
    Zero-size markers pass through; y stays f32.  _decode_cached_batch
    inverts each on the device."""
    fields_h, feats_h, vals_h, y_h = ds_host
    f = cfg.max_nnz
    pb = (f + 7) // 8
    wf = int(cfg.n_feats).bit_length()
    if wf <= 24 and feats_h.shape[0]:
        k = max(0, wf - 16)
        lo = (feats_h & 0xFFFF).astype(np.uint16)
        lo8 = np.empty((feats_h.shape[0], 2 * f), np.uint8)
        lo8[:, 0::2] = lo & 0xFF
        lo8[:, 1::2] = lo >> 8
        hi = pack_bitplanes((feats_h >> 16).astype(np.uint8), k)
        feats_h = np.concatenate([lo8, hi.reshape(feats_h.shape[0], k * pb)], axis=1)
    if vals_h.shape[0] and vals_h.dtype == np.float32:
        kv = np.rint(vals_h.astype(np.float64) * 1e6)
        if (
            (kv >= 0).all()
            and (kv < (1 << 24)).all()
            and np.array_equal(kv.astype(np.float32) / np.float32(1e6), vals_h)
        ):
            kv = kv.astype(np.uint32)
            enc = np.empty((vals_h.shape[0], 3 * f), np.uint8)
            enc[:, 0::3] = kv & 0xFF
            enc[:, 1::3] = (kv >> 8) & 0xFF
            enc[:, 2::3] = kv >> 16
            vals_h = enc
    if fields_h.shape[0] and fields_h.shape[-1]:
        w = int(max(cfg.n_fields - 1, 1)).bit_length()
        if w <= 8 and w * pb < f:
            fields_h = pack_bitplanes(fields_h.astype(np.uint8), w).reshape(
                fields_h.shape[0], w * pb
            )
    return (fields_h, feats_h, vals_h, y_h)


def _decode_cached_batch(b: Batch, cfg: Config) -> Batch:
    """Invert _compact_cache_arrays on a gathered batch, on the device
    (ftrl_ffm_tpu/train.py::_decode_cached_batch): a few elementwise ops on
    [B, F].  Leaves that kept their wide form pass through, so a batch
    equals the raw resident form's bit for bit."""
    f = cfg.max_nnz
    fields, feats, vals = b.fields, b.feats, b.vals
    if feats.dtype == torch.uint8:
        u = feats.to(torch.int32)
        out = u[..., 0 : 2 * f : 2] | (u[..., 1 : 2 * f : 2] << 8)
        k = max(0, int(cfg.n_feats).bit_length() - 16)
        if k:
            hi = u[..., 2 * f :].reshape(*u.shape[:-1], k, (f + 7) // 8)
            out = out | (unpack_bitplanes(hi, f) << 16)
        feats = out
    if vals.dtype == torch.uint8:
        u = vals.to(torch.int32)
        vals = dec6_decode(u[..., 0::3] | (u[..., 1::3] << 8) | (u[..., 2::3] << 16))
    if fields.dtype == torch.uint8 and fields.dim() == feats.dim():
        pb = (f + 7) // 8
        fields = unpack_bitplanes(fields.reshape(*fields.shape[:-1], -1, pb), f)
    return b._replace(fields=fields, feats=feats, vals=vals)


# The JAX package's refusals of auc_mode=exact (ftrl_ffm_tpu/train.py:
# 389-400, 2707-2712, 2740-2745), word for word.
EXACT_AUC_MULTIPROCESS = (
    "auc_mode=exact collects all scores on one host — use auc_mode=binned on "
    "multi-process runs"
)
EXACT_AUC_SHARD = (
    "auc_mode=exact needs per-example scores; the shard-layout device cache "
    "reduces to histograms inside shard_map — use --device_cache_layout "
    "replicate or --auc_mode binned"
)


def resolve_device(name: str) -> torch.device:
    """The torch device for Config.device.  "cuda" without a card raises:
    the port never moves a run to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r}: no CUDA device is available (pass "
                f"--device cpu to run the plain PyTorch versions on the CPU)"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _validate_state_shapes(cfg: Config, state: ModelState) -> None:
    """Table shapes and dtypes must be what this config's model reads
    (ftrl_ffm_tpu/train.py::_validate_state_shapes), with a named error
    instead of a shape failure deep inside the first batch.  On a mesh of
    M > 1 model shards the tables may also hold one rank's
    ceil(n_feats / M) rows (Trainer.load_state)."""
    for name, t in state._asdict().items():
        if t is not None and not isinstance(t, torch.Tensor):
            raise TypeError(
                f"state field {name} is {type(t).__name__}, expect a tensor "
                f"(io/checkpoint.py::state_from_jax_arrays converts arrays)"
            )
    r, w = cfg.n_feats, cfg.row_width
    if uses_mesh(cfg) and cfg.mesh_model > 1 and tuple(state.lin_n.shape) == (
            -(-r // cfg.mesh_model),):
        r = state.lin_n.shape[0]
    issues = []
    if tuple(state.lin_n.shape) != (r,):
        issues.append(
            f"linear tables have {tuple(state.lin_n.shape)} rows, config "
            f"n_feats={r} expects ({r},)"
        )
    if w:
        if state.vec_n is None:
            issues.append(
                f"state has no factor tables, but model_type="
                f"{cfg.model_type} expects [{r}, {w}]"
            )
        else:
            if tuple(state.vec_n.shape) != (r, w):
                issues.append(
                    f"factor tables are {tuple(state.vec_n.shape)}, config "
                    f"(model_type={cfg.model_type}, n_feats={cfg.n_feats}, "
                    f"n_fields={cfg.n_fields}, field_pad={cfg.field_pad}, "
                    f"n_factors={cfg.n_factors}) expects ({r}, {w})"
                )
            if state.vec_w.dtype != getattr(torch, cfg.table_dtype):
                issues.append(
                    f"factor weight table is {state.vec_w.dtype}, config "
                    f"table_dtype={cfg.table_dtype}"
                )
    elif state.vec_n is not None:
        issues.append(
            f"state has factor tables {tuple(state.vec_n.shape)}, but "
            f"model_type={cfg.model_type} has none"
        )
    if issues:
        raise IncompatibleStateError(
            "loaded state is incompatible with this config: "
            + "; ".join(issues)
            + ". Resume with the original flags, or retrain."
        )


def estimate_hbm_bytes(cfg: Config) -> dict:
    """Device-memory estimate for the train step on one device of the run:
    resident state, update working set and, in route mode, the all_to_all
    slot buffers (ftrl_ffm_tpu/train.py::estimate_hbm_bytes, whose r_loc
    and route terms these are: a mesh_model shard holds r_loc rows, and the
    route buffers are JAX's to the byte).  The port's own allocations: on
    one device (and on a shard no data replica shares) the in-place kind's
    one [R, D] accumulator, and no table-shaped accumulator for "dense2"
    and "sparse2", whose kernel updates the touched rows in place; on a
    mesh, the [r_loc, D] sums of the accumulator form (two: they are
    all_reduced over "data") and of a route's in-place form.  The form is
    the port's (ftrl.py::update_form): under auto it is "dense2" where the
    JAX package's is "inplace", so there the estimate holds no [R, D] term
    where JAX's does.  LR (row width 0) holds no
    factor tables: its state is the three linear tables, where the JAX
    package counts a one-wide factor table too.  Approximate by design:
    the big allocations only."""
    from ftrl_ffm_tpu_torch.parallel.sharded import resolves_to_route, route_slots

    w = cfg.row_width
    shards = max(1, cfg.mesh_model)
    mesh_data = max(1, cfg.mesh_data)
    r_loc = -(-cfg.n_feats // shards)
    nnz = cfg.batch_size * max(1, cfg.max_nnz)
    w_bytes = 2 if cfg.table_dtype == "bfloat16" else 4
    # resident: factor n/z (f32) + w (table_dtype) + three linear tables
    state_b = r_loc * w * (4 + 4 + w_bytes) + 3 * r_loc * 4
    routed = resolves_to_route(cfg)
    n_dev = shards * mesh_data
    nnz_loc = nnz if n_dev == 1 else nnz // n_dev
    mk = shards * route_slots(cfg, shards, mesh_data) if routed else 0
    form = update_form(cfg, r_loc, mesh_data, routed)
    work_b = {"inplace": 1, "accumulator": 2}.get(form, 0) * r_loc * w * 4
    # gathered rows + the (g, g^2) payload of the batch slice (LR: the
    # gathered linear weights and their [N, 2] payload)
    work_b += 3 * nnz_loc * max(1, w) * 4
    # route mode: send/recv slot pairs for the lookup leg ([M*K, w] x2) and
    # the update leg ([M*K, 2w] x2), sized by route_capacity
    wr = max(1, w)
    route_b = (2 * wr + 2 * 2 * wr) * mk * 4 if routed else 0
    return {"state": state_b, "work": work_b, "route": route_b,
            "total": state_b + work_b + route_b}


def device_memory_bytes(device: torch.device) -> Optional[int]:
    """The card's total memory, or None for the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


def _close_source(items_iter, threads) -> None:
    """Close a feeder's source generator (its own threads, e.g. the
    stream reader's, end with it) once none of the feeder's threads can
    still be inside it."""
    close = getattr(items_iter, "close", None)
    if close is not None and not any(t.is_alive() for t in threads):
        close()


def _tensor_key(tensors) -> tuple:
    """What a captured graph bakes in of each tensor it reads or writes:
    its address, shape, strides and dtype (None for an absent one)."""
    return tuple(
        None if t is None else (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
        for t in tensors
    )


def _host_tensor(a) -> torch.Tensor:
    """A host array of an upload as a CPU tensor, sharing its memory (a
    bfloat16 leaf of the transfer tiers is one already)."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(a)


# Captured groups kept a role (Trainer._run_group): a streamed run's
# full groups and its padded last group upload different tiers, and a
# multi-process run changes its dtypes once the ranks agree.
_GRAPH_KEYS = 4


class _GroupGraph:
    """One role's S-step group on the card (steps_per_call > 1): the CUDA
    graph that replays it, its static input and output buffers, and the
    kernel launches and collectives its capture recorded, kept under its
    key (Trainer._group_key: what the graph baked in, the state's and the
    resident dataset's tensors and the group's shapes and kinds; another
    key needs another capture).  On a mesh the graph holds the steps' NCCL collectives, which
    every rank captures and replays in the same order.  An absent input
    (a batch without feats_base) stays None."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: tuple = ()
        self.outputs: tuple = ()
        self.counts: dict = {}
        self.collectives: dict = {}
        self.counters: dict = {}
        self.trace: list = []

    def capture(self, fn, inputs: tuple, pool) -> None:
        """Record fn over static copies of `inputs` into the memory pool
        `pool` (torch.cuda.graph_pool_handle); nothing runs.  The
        wrappers count their launches, and parallel/dist.py its
        collectives (and their bytes where it traces, and the registry's
        counters of tracing.CAPTURED), while they are recorded: those are
        taken back here and added again at each replay.  Other threads (the feeder, a checkpoint writer, NCCL's
        watchdog) keep using the card: thread_local lets their calls
        through."""
        self.inputs = tuple(None if t is None else t.clone() for t in inputs)
        before = launch_counts()
        coll_before = dict(pdist.counts)
        reg_before = tracing.snapshot()
        trace_at = None if pdist.trace is None else len(pdist.trace)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                self.outputs = fn(*self.inputs)
        finally:
            after = launch_counts()
            self.counts = {k: n - before[k] for k, n in after.items() if n != before[k]}
            add_launch_counts({k: -n for k, n in self.counts.items()})
            self.collectives = {k: n - coll_before[k] for k, n in pdist.counts.items()}
            for k, n in self.collectives.items():
                pdist.counts[k] -= n
            self.counters = {k: n - reg_before.get(k, 0) for k, n in tracing.snapshot().items()
                             if n != reg_before.get(k, 0)}
            for k, n in self.counters.items():
                tracing.count(k, -n)
            if trace_at is not None:
                self.trace = pdist.trace[trace_at:]
                del pdist.trace[trace_at:]
        self.graph = graph

    def replay(self, inputs: tuple) -> tuple:
        """Copy `inputs` into the static buffers, replay, count the
        launches and collectives, and return copies of the outputs (on the
        device, no readback), which the next replay would overwrite."""
        for dst, src in zip(self.inputs, inputs):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        add_launch_counts(self.counts)
        for k, n in self.collectives.items():
            pdist.counts[k] += n
        for k, n in self.counters.items():
            tracing.count(k, n)
        if pdist.trace is not None:
            pdist.trace.extend(self.trace)
        return tuple(t.clone() for t in self.outputs)


class Trainer(TransferTiers):
    """Training and serving of one config (ftrl_ffm_tpu/train.py::Trainer).

    Every step goes through one interface, self._step: the model itself
    on one device (Model.train_step, Model.eval_step), the sharded step
    on a mesh (self._sharded, parallel/sharded.py::ShardedStep), each
    holding its update form (ftrl.py::update_form).

    On a mesh every rank feeds its own slice of each global batch of
    B = batch_size rows: local_batch = B / S rows, S the batch shards (D in
    replicate mode, where the ranks of one model group share a slice; D * M
    in route mode), slice s = the data rank (replicate) or the rank
    (route).  Streamed and offline passes read slice s's line-aligned byte
    range of the file (data/loader.py::process_byte_range(path, s, S)), so
    the ranks of one model group read the same range and global batch t is
    the slices' t-th local batches end to end: the JAX package's
    multi-process composition, which is the one-device batch t where the
    file is one global batch.  Every rank runs the same number of steps:
    the local counts are all-gathered (_global_steps) and short ranks pad
    with inert batches.  A resident pass reads the same rows: on more
    than one process the shard layout holds slice s on its rank and runs
    the largest slice's step count, in file order or in the permutation
    of the slice that the streamed pass draws, so it gives the streamed
    run's bits; the replicate layout (the whole dataset on every rank)
    streams there, as in the JAX package, and engages only on a mesh of
    one rank, whose one slice is the whole file.

    steps_per_call = S > 1 on a mesh groups S sharded steps a dispatch,
    streamed or resident, with the same bits as S = 1; on the card the
    graph of a group holds the steps' NCCL collectives.

    Streamed batches (training, eval, predict_file) go up in the transfer
    tiers' form (transfer.py::TransferTiers._compact; compact_transfer)."""

    def __init__(self, cfg: Config, state: Optional[ModelState] = None):
        """A trainer on cfg.device: a fresh seeded init (on a mesh the
        rank's own rows of it, parallel/mesh.py::init_shard), or `state`
        moved to the device (on a mesh: sharded, parallel/mesh.py::
        shard_state, or taken as it is where it holds the rank's rows).
        Training updates the state's tensors in place, so a state already
        on the device is trained as it is (clone it to keep it)."""
        # eval-/predict-only Trainers sniff format and nnz from eval_data
        sniff_src = cfg.train_data or cfg.eval_data
        if not cfg.file_type and sniff_src:
            cfg.file_type = detect_file_type(sniff_src)
        if cfg.cmd and not cfg.file_type:
            raise ValueError(
                "--cmd (stdin) streaming cannot auto-detect the format; "
                "pass --file_type libsvm|libffm"
            )
        if cfg.cmd and cfg.max_nnz <= 0:
            raise ValueError("--cmd (stdin) streaming cannot sniff nnz; pass --max_nnz")
        cfg.validate_file_type()
        if cfg.max_nnz <= 0 and sniff_src:
            cfg.max_nnz = sniff_max_nnz(sniff_src, cfg.file_type)
        if cfg.max_nnz <= 0:
            raise ValueError(
                "max_nnz unknown: pass --max_nnz or provide train/eval data to "
                "sniff it from"
            )
        # ---- multi-process: one process a device, a mesh over all of them
        self._proc_id, self._proc_n = pdist.world()
        # auc_mode=exact conflicts known now fail now, not at the first
        # evaluate() after a training epoch (evaluate keeps a backstop)
        if cfg.eval_auc and cfg.auc_mode == "exact":
            if self._proc_n > 1:
                raise ValueError(EXACT_AUC_MULTIPROCESS)
            if cfg.device_cache_layout == "shard":
                raise ValueError(EXACT_AUC_SHARD)
        if self._proc_n > 1:
            if cfg.cmd:
                raise ValueError("--cmd stdin streaming is single-process only")
            if cfg.mesh_data == 1 and cfg.mesh_model == 1:
                cfg.mesh_data = 0  # default: data parallel over every process
        check_ported(cfg)
        self.cfg = cfg
        self.model = make_model(cfg)
        self._mesh = self._sharded = None
        if uses_mesh(cfg):
            from ftrl_ffm_tpu_torch.parallel import make_mesh

            self._mesh = make_mesh(cfg.mesh_data, cfg.mesh_model, cfg.device)
            self.device = self._mesh.device
        else:
            self.device = resolve_device(cfg.device)
        self._warn_if_oversized()
        if state is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed)
            if self._mesh is None:
                state = self.model.init(gen)
            else:
                from ftrl_ffm_tpu_torch.parallel import init_shard

                state = init_shard(self.model, self._mesh, gen)
        else:
            _validate_state_shapes(cfg, state)
        self.load_state(state)
        self._local_bs = cfg.batch_size // (self._sharded.batch_shards if self._sharded else 1)
        self._steps_done = 0
        # per role: the step count every rank of a mesh agrees on
        self._global_step_counts: dict = {}
        # device-resident datasets (Config.device_cache), by role
        self._dev_cache: dict = {}
        # the background checkpoint write in flight and its failure, if any
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_exc: Optional[BaseException] = None
        self._ckpt_stream = None
        # one record a mid-training save: its step, the snapshot path
        # ("sync", "device_copy", "inline"), the stall on the training
        # thread and the writer's seconds and bytes (save_checkpoint's)
        self.checkpoint_log: list = []
        # the transfer tiers' state (transfer.py): the delta and DEC6
        # hysteresis (one batch that breaks a tier turns it off for the
        # run) and, on more than one process, each stream's first-pass
        # observations and the narrowings the ranks agreed
        self._delta_ok = True
        self._dec6_ok = True
        self._dyn_obs: dict = {}
        self._dyn_agreed: dict = {}
        # steps_per_call > 1 on the card: each role's ("train", "eval")
        # captured groups by key, oldest first, and how the groups were
        # dispatched: a key's first group eagerly and then captured, every
        # later one replayed; a role's graphs share one memory pool
        self._graphs: dict = {}
        self._graph_pools: dict = {}
        self.group_dispatch = {"eager": 0, "captures": 0, "replays": 0}
        # routed-lookup drops of the last training epoch (route mode)
        self._epoch_route_overflow = 0
        # the next resident pass's index rows, made ahead (_cached_order)
        # on one thread, started at the first shuffled resident pass
        self._order_pool = ThreadPoolExecutor(1, thread_name_prefix="ftrl-order")
        self._order_job: Optional[_OrderJob] = None

    def load_state(self, state: ModelState) -> None:
        """Make `state` (a logical state: id row order, n_feats rows) the
        trainer's: moved to the device, or sharded on a mesh, where the
        sharded step is built for it.  On a mesh of more than one model
        shard a state of the rank's own rows_local rows is taken as it
        is (parallel/mesh.py::place_state)."""
        if self._mesh is None:
            self.state = ModelState(*(None if t is None else t.to(self.device) for t in state))
            # the one-device step: the model's train_step and eval_step
            self._step = self.model
            return
        from ftrl_ffm_tpu_torch.parallel import ShardedStep, place_state

        self.state = place_state(state, self._mesh, self.cfg.n_feats)
        self._sharded = self._step = ShardedStep(self.cfg, self._mesh, self.model, self.state)

    def _warn_if_oversized(self) -> None:
        """Warn before the first step when the estimated state and update
        working set (estimate_hbm_bytes) come near the card's memory
        (ftrl_ffm_tpu/train.py::_warn_if_oversized, which reads the TPU's
        limit).  A warning only: the estimate is approximate."""
        limit = device_memory_bytes(self.device)
        if limit is None:
            return
        est = estimate_hbm_bytes(self.cfg)
        if est["total"] > 0.9 * limit:
            import warnings

            warnings.warn(
                f"estimated device memory need ~{est['total'] / 1e9:.1f} GB "
                f"(state {est['state'] / 1e9:.1f} + update working set "
                f"{est['work'] / 1e9:.1f}) vs ~{limit / 1e9:.0f} GB on "
                f"{self.device}: running out of device memory is likely (the "
                f"estimate ignores temporaries).  Reduce --batch_size or "
                f"--n_feats."
            )

    # ---- the linear tables of the in-place form ----
    @property
    def logical_state(self) -> ModelState:
        """The state in id row order with n_feats rows
        (ftrl_ffm_tpu/train.py::Trainer.logical_state): on one device with
        the linear tables reconciled from the mirror lane where the
        in-place form lets them ride stale; on a mesh gathered from the
        shards (parallel/mesh.py::unshard_state, host tensors on every
        rank, each shard's linear tables reconciled first).  Every read of
        the state outside training goes through this."""
        self._maybe_sync_lin()
        if self._mesh is not None:
            from ftrl_ffm_tpu_torch.parallel import unshard_state

            return unshard_state(self.state, self._mesh, self.cfg.n_feats)
        return self.state

    def _maybe_sync_lin(self) -> None:
        """Reconcile stale linear tables from the mirror lane; idempotent,
        at boundaries only."""
        if self._step.lin_rides_stale:
            self.state = self.model.sync_lin_from_mirror(self.state)

    # ---- batch plumbing ----
    def _place_batch(self, arrays, role: str = "train") -> Batch:
        """Upload one host batch of `role` as it is: (fields, feats, vals,
        y, sample_w[, feats_base]), a None leaf staying None."""
        return Batch(*(None if a is None else self._upload(a, role) for a in arrays))

    def _device_batch(self, arrays, role: str) -> Batch:
        """Upload one host batch in its transfer-tier form
        (ftrl_ffm_tpu/train.py::_device_batch), on this thread."""
        return self._place_batch(self._compact(arrays, role), role)

    def _dataset(self, role: str):
        """The offline in-memory dataset of `role` ("train" or "eval"),
        loaded once (reference: src/task/ftrl_offline.cpp:21-42): this
        rank's byte range of the file (_byte_range)."""
        attr = f"_{role}_ds"
        if not hasattr(self, attr):
            cfg = self.cfg
            path = cfg.train_data if role == "train" else cfg.eval_data
            setattr(self, attr, load_file(
                path, cfg.file_type, cfg.max_nnz, cfg.n_feats, cfg.n_fields,
                n_workers=cfg.n_threads, byte_range=self._byte_range(path),
            ))
        return getattr(self, attr)

    # ---- the batch slices of a mesh (ftrl_ffm_tpu/train.py:1441-1481) ----
    def _byte_range(self, path: str):
        """This rank's line-aligned slice of `path` (None: the whole file):
        slice s of the S batch shards (Trainer's docstring)."""
        if self._sharded is None or self._sharded.batch_shards == 1:
            return None
        from ftrl_ffm_tpu_torch.data.loader import process_byte_range

        return process_byte_range(path, self._sharded.shard_index, self._sharded.batch_shards)

    def _global_steps(self, role: str) -> Optional[int]:
        """The step count of a pass over `role`'s file that every rank of a
        mesh agrees on (the largest local count, all-gathered: collectives
        run in lockstep), or None off a mesh and for --cmd stdin.  Counted
        once a role; the all-gather runs at a group of one too."""
        cfg = self.cfg
        if self._mesh is None or (role == "train" and cfg.cmd):
            return None
        if role not in self._global_step_counts:
            path = cfg.train_data if role == "train" else cfg.eval_data
            n = count_lines(path, self._byte_range(path)) if cfg.online else self._dataset(role).n
            steps = -(-n // self._local_bs) if n else 0
            counts = pdist.process_allgather(np.array([steps], np.int64), self.device)
            self._global_step_counts[role] = int(counts.max())
        return self._global_step_counts[role]

    def _pad_to_steps(self, it, n_steps: Optional[int]):
        """`it`'s batches, then inert ones up to n_steps (None: as they are)."""
        k = 0
        for b in it:
            yield b
            k += 1
        while n_steps is not None and k < n_steps:
            yield self._inert_batch()
            k += 1

    # ---- device-resident datasets (ftrl_ffm_tpu/train.py:1516-2032) ----
    def _device_cache_fits(self, n: int, row_bytes: int = 0) -> bool:
        """Do n rows (plus the pad row) of row_bytes each (the raw form's by
        default) fit next to the state and the update working set, within
        80% of the card's memory?  True on the CPU, whose "device memory"
        already holds the parsed arrays, and under device_cache=on."""
        if self.cfg.device_cache == "on":
            return True
        limit = device_memory_bytes(self.device)
        if limit is None:
            return True
        ds_bytes = (n + 1) * (row_bytes or (12 * self.cfg.max_nnz + 4))
        return estimate_hbm_bytes(self.cfg)["total"] + ds_bytes <= 0.8 * limit

    def _resolve_cache_layout(self, n: int) -> Optional[str]:
        """The resident layout for this rank's n-row slice, or None to
        stream (ftrl_ffm_tpu/train.py::_resolve_cache_layout, one device a
        process).  On more than one process each rank has read only its
        byte range: the shard layout (that slice resident on the rank)
        under auto and shard where it fits, and under replicate, which
        would need the whole dataset on every rank, the role streams (and
        says so), as in the JAX package.  On one process, a mesh of one
        rank included, the shard layout degenerates to the replicate one
        on its one batch device: the raw form first, else (off a mesh) the
        compact form where only that fits (unless device_cache_compact=
        off).  Every rank of a mesh calls this in the same order, and
        the ranks agree on the shard layout (an all-gather of whether each
        slice fits): a resident and a streamed pass issue different
        collectives."""
        if self._proc_n > 1:
            if self.cfg.device_cache_layout == "replicate":
                if self._proc_id == 0:
                    print(f"device cache: the replicate layout needs the whole dataset on "
                          f"every rank, but each of the {self._proc_n} processes reads only "
                          f"its byte range: streaming, as the JAX package does",
                          file=sys.stderr)
                return None
            fits = pdist.process_allgather(np.array([self._device_cache_fits(n)]), self.device)
            return "shard" if fits.all() else None
        if self._device_cache_fits(n):
            return "replicate"
        if self._mesh is not None:
            return None
        if self.cfg.device_cache_compact != "off" and self._device_cache_fits(
            n, _compact_cache_row_bytes(self.cfg)
        ):
            return "replicate"
        return None

    def _cache_compact_mode(self, n: int) -> bool:
        """Compact resident storage for an n-row dataset?  auto: only when
        the raw arrays would not fit (so the default resident form is the
        raw one); on: always; off: never."""
        want = self.cfg.device_cache_compact
        if want != "auto":
            return want == "on"
        return not self._device_cache_fits(n) and self._device_cache_fits(
            n, _compact_cache_row_bytes(self.cfg)
        )

    def _ensure_device_cache(self, role: str) -> Optional[_DevCache]:
        """The device-resident dataset of `role`, built on first use, or
        None where the role streams (ftrl_ffm_tpu/train.py::
        _ensure_device_cache).  It streams under device_cache=off, for
        online training from --cmd stdin (stdin cannot be re-read), for
        online training under auto with n_epochs <= 1 (no replay would
        amortize the blocking build), for eval without eval_data, for an
        empty file, and under auto where the dataset does not fit."""
        cfg = self.cfg
        if cfg.device_cache == "off":
            return None
        if cfg.online and role == "train" and cfg.cmd:
            return None
        if cfg.online and role == "train" and cfg.device_cache == "auto" and cfg.n_epochs <= 1:
            return None
        if role == "eval" and not cfg.eval_data:
            return None
        if role not in self._dev_cache:
            path = cfg.train_data if role == "train" else cfg.eval_data
            t0 = time.perf_counter()
            pre_stat = None
            if cfg.online:
                # online passes never load the file: a parse-free line count
                # of this rank's range (blank lines overcount: conservative)
                # declines first
                n_lines = count_lines(path, self._byte_range(path))
                if self._resolve_cache_layout(max(n_lines, 1)) is None:
                    self._dev_cache[role] = None
                    return None
                # the file's identity BEFORE the parse: a write landing
                # during the parse shows as stale at the next pass
                st = os.stat(path)
                pre_stat = (st.st_size, st.st_mtime_ns)
            with span("data.parse"):
                ds = self._dataset(role)
            self._dev_cache[role] = None
            # on a mesh every rank resolves, an empty slice too (it holds
            # inert rows only): the ranks decide together
            layout = self._resolve_cache_layout(ds.n) if ds.n > 0 or self._proc_n > 1 else None
            if layout is not None:
                with span("data.upload"):
                    entry = self._build_device_cache(ds, layout, pre_stat)
                self._dev_cache[role] = entry
                # the parsed host copy is dead once the rows live on the device
                delattr(self, f"_{role}_ds")
                nbytes = sum(t.numel() * t.element_size() for t in entry.ds)
                print(
                    f"device cache: {role} dataset of {entry.n} rows resident on "
                    f"{self.device} ({nbytes / 1e6:.1f} MB, "
                    f"{'compact' if entry.compact else 'raw'}), parsed and "
                    f"uploaded in {time.perf_counter() - t0:.3f} s",
                    file=sys.stderr,
                )
        return self._dev_cache[role]

    def _fresh_cache(self, role: str) -> Optional[_DevCache]:
        """The role's device-resident dataset, rebuilt first when its file
        changed since the build (ftrl_ffm_tpu/train.py::_fresh_cache): a
        streamed online pass re-reads the file every epoch (the reference's
        rewind), so an online replay must not serve a stale snapshot.
        Offline datasets carry no src_stat (the reference loads them once)."""
        cache = self._ensure_device_cache(role)
        if cache is None or cache.src_stat is None:
            return cache
        st = os.stat(self.cfg.train_data if role == "train" else self.cfg.eval_data)
        if (st.st_size, st.st_mtime_ns) != cache.src_stat:
            print(
                f"WARNING: {role} file changed since the device cache was "
                "built — re-reading it (streamed-online rewind semantics)"
            )
            # drop every reference to the old device arrays before the
            # rebuild, so that a large dataset is never held twice
            del self._dev_cache[role]
            cache = None
            cache = self._ensure_device_cache(role)
        return cache

    def _build_device_cache(self, ds, layout: str, pre_stat) -> _DevCache:
        """Upload a parsed dataset once (ftrl_ffm_tpu/train.py::
        _build_device_cache, one device a process): the n real rows, then
        inert pad rows (field 0, feat id n_feats, value 0, y 0), and the
        dataset-level markers where fields or vals carry no information
        (fields 0..F-1 on every row, every value 1.0).  The markers hold
        for every model: LR and FM never read the fields, and a libsvm
        file's (all 0) never match the iota test.

        "replicate": one pad row.  "shard": `ds` is this rank's slice (its
        byte range: online in file order, offline the contiguous slice its
        epochs shuffle), padded to rows_loc rows, the largest slice of the
        mesh plus one inert row, agreed by an all-gather; on one process a
        single slice and one inert row."""
        cfg = self.cfg
        f = cfg.max_nnz
        max_loc = ds.n
        if layout == "shard" and self._proc_n > 1:
            max_loc = int(pdist.process_allgather(np.array([ds.n], np.int64), self.device).max())
        rows_loc = max_loc + 1

        def padded(a, pad_value):
            pad = np.full((rows_loc - ds.n, *a.shape[1:]), pad_value, a.dtype)
            return np.concatenate([a, pad])

        fields_h = (np.zeros((0, f), np.int32) if (ds.fields == np.arange(f, dtype=np.int32)).all()
                    else padded(ds.fields, 0))
        vals_h = np.zeros((0, f), np.float32) if (ds.vals == 1.0).all() else padded(ds.vals, 0)
        ds_host = (fields_h, padded(ds.feats, cfg.n_feats), vals_h, padded(ds.y, 0))
        compact = self._cache_compact_mode(ds.n)
        if compact:
            ds_host = _compact_cache_arrays(ds_host, cfg)
        ds_dev = tuple(torch.from_numpy(a).to(self.device) for a in ds_host)
        return _DevCache(layout, ds_dev, ds.n, rows_loc, pre_stat, compact)

    def _take_cached(self, cache: _DevCache, ix: torch.Tensor) -> Batch:
        """One batch gathered from a resident dataset by a [b] index row of
        this rank's rows, decoded where it is stored compact."""
        b = take_cached(cache.ds, ix, cache.n)
        return _decode_cached_batch(b, self.cfg) if cache.compact else b

    def _cache_steps(self, cache: _DevCache) -> tuple[int, int]:
        """(steps of one pass over a resident dataset, the pad row's index
        that padded index rows point at): ceil((rows_loc - 1) / b) and
        rows_loc - 1, which for "shard" is the largest slice's count, run
        by every rank in lockstep (ftrl_ffm_tpu/train.py::
        _cached_idx_shard), and for "replicate" ceil(n / b) and n."""
        pad = cache.rows_loc - 1
        return -(-pad // self._local_bs), pad

    def _iota_rows(self, step: int, pad: int) -> torch.Tensor:
        """[b] index row of step `step` in file order, made on the device:
        step * b + 0..b-1, clamped to the pad row's index `pad` (no
        upload).  Every index past the real rows is an inert row."""
        lb = self._local_bs
        ix = torch.arange(step * lb, (step + 1) * lb, dtype=torch.int32, device=self.device)
        return ix.clamp_(max=pad)

    def _cached_order(self, cache: _DevCache, epoch_rng, n_steps: int,
                      pad: int) -> Optional[torch.Tensor]:
        """This pass's permutation of the n real rows as [n_steps, b] int32
        index rows on the device, the tail padded with the pad row's index:
        None (file order) without epoch_rng, else the one epoch_rng.shuffle
        draws, the call batch_iterator makes, so the resident and streamed
        paths see the same permutation (on a mesh: of this rank's slice, as
        its streamed pass shuffles its byte range).

        The next pass's rows are made ahead, while this pass runs
        (_prefetch_order); that pass takes them where they still apply
        (_take_order: a hit), else draws here (a miss), with the same bits
        either way and epoch_rng left where this draw leaves it."""
        if epoch_rng is None:
            return None
        key = (id(cache), cache.n, n_steps, pad)
        with span("train.order"):
            rows = self._take_order(key, epoch_rng)
            tracing.count("order.prefetch.miss" if rows is None else "order.prefetch.hit")
            if rows is None:
                rows, _ = _draw_rows(epoch_rng, cache.n, n_steps, pad, self._local_bs)
        # upload before the next draw starts: on an H100's host a 4 MB copy
        # into pinned memory took 0.3 ms alone, 5.8 ms beside a shuffle
        idx = self._upload(rows)
        self._prefetch_order(key, epoch_rng)
        return idx

    def _take_order(self, key: tuple, rng) -> Optional[np.ndarray]:
        """The index rows made ahead, where they were drawn for this rng
        object in the state it still holds and for this pass's key: rng is
        then moved to the state the draw left its copy in.  Else None, and
        the job is dropped (it works on its own copy)."""
        job, self._order_job = self._order_job, None
        if (job is None or job.rng is not rng or job.key != key
                or not _same_state(rng.bit_generator.state, job.state)):
            return None
        try:
            rows, end = job.future.result()
        except Exception:  # noqa: BLE001 - the synchronous draw redoes the work and raises
            return None
        rng.bit_generator.state = end
        return rows

    def _prefetch_order(self, key: tuple, rng) -> None:
        """Start making the index rows that the next pass of this key
        (dataset id, n, n_steps, pad) would draw from `rng` as it stands,
        from a copy of its state, on the trainer's order thread."""
        state = rng.bit_generator.state
        job = self._order_pool.submit(_draw_ahead, type(rng.bit_generator), state, *key[1:],
                                      self._local_bs)
        self._order_job = _OrderJob(rng, state, key, job)

    def _cached_batches(self, cache: _DevCache, epoch_rng=None, role: str = "train"):
        """The batches of one pass over a resident dataset (those of
        ftrl_ffm_tpu/train.py::_train_epoch_cached and of evaluate's
        resident branch): in file order (online epochs, eval, offline
        without shuffle; epoch_rng None) or in _cached_order's permutation.
        A shuffled pass uploads its [S, b] index table once (non-blocking,
        from pinned memory); each step reads a row of it, a view.  Each
        batch's index row and gather run in the span "<role>.gather"."""
        n_steps, pad = self._cache_steps(cache)
        idx = self._cached_order(cache, epoch_rng, n_steps, pad)
        for s in range(n_steps):
            with span(role + ".gather"):
                batch = self._take_cached(cache, self._iota_rows(s, pad) if idx is None
                                          else idx[s])
            yield batch

    @spanned("upload")
    def _upload(self, a, role: str = "train") -> torch.Tensor:
        """A host array (or CPU tensor) of `role` on the run's device; on
        the card through pinned host memory with a non-blocking copy, which
        overlaps the kernels still queued and waits for nothing.  Its bytes
        count under upload.bytes.<role>."""
        t = _host_tensor(a)
        tracing.count("upload.bytes." + role, t.numel() * t.element_size())
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---- the background feeder (ftrl_ffm_tpu/train.py:733-920) ----
    def _feed_worker_count(self) -> int:
        """Resolved feeder thread count (Config.feed_workers).  --cmd stdin
        pins 1: an unbounded interactive stream gains nothing from
        read-ahead, and a worker blocked in next() would stall teardown.
        Multi-process runs pin 1, as the JAX package's do."""
        if self._proc_n > 1 or self.cfg.cmd:
            return 1
        return max(1, self.cfg.feed_workers)

    def _feed(self, items_iter, place):
        """Place items on a background thread ahead of the consumer, in
        order: host parsing and host-to-device copies overlap the steps
        (the reference's producer thread staying ahead of its consumers,
        src/concurrent/pc_task.cpp:34-55).  `place` maps one host item to
        its placed form.  A queue of 3 bounds the read-ahead.  When the
        consumer abandons the generator or fails, the thread is stopped,
        the queue drained and the thread joined, and then items_iter is
        closed (its own threads with it); a placing error reaches the
        consumer."""
        import queue as _queue

        workers = self._feed_worker_count()
        if workers > 1:
            yield from self._feed_interleaved(items_iter, place, workers)
            return

        q: _queue.Queue = _queue.Queue(maxsize=3)
        err: list[BaseException] = []
        stopped = threading.Event()
        # locals survive interpreter shutdown (module globals do not); the
        # unwind is skipped there, as in data/stream.py::batches
        empty_exc = _queue.Empty
        finalizing = sys.is_finalizing

        def upload():
            try:
                for item in items_iter:
                    if stopped.is_set():
                        return
                    q.put(place(item))
            except BaseException as e:  # surfaced to the consumer
                err.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=upload, name="ftrl-feed", daemon=True)
        t.start()
        try:
            while True:
                with span("feed.wait"):
                    b = q.get()
                if b is None:
                    break
                yield b
        finally:
            stopped.set()
            if not finalizing():
                while True:
                    try:
                        q.get_nowait()
                    except empty_exc:
                        break
                t.join(timeout=30)
                _close_source(items_iter, (t,))
        if err:
            raise err[0]

    def _feed_interleaved(self, items_iter, place, workers: int):
        """Order-preserving interleaved feeders: `workers` threads each run
        the whole place() for alternating batches, and a reorder buffer
        hands them over in stream order (FTRL's update order is part of
        the result).  Each batch crosses threads once; the legs that
        release the GIL (the copy into pinned memory, the device copy)
        overlap.  At most MAX_AHEAD placed batches wait beyond the
        consumer's."""
        cond = threading.Condition()
        iter_lock = threading.Lock()  # serializes (next(), ticket) draws
        buf: dict[int, object] = {}
        seq = [0]            # next ticket to hand out (guarded by iter_lock)
        total = [None]       # item count once items_iter is exhausted
        next_out = [0]       # next index the consumer will yield
        err: list[BaseException] = []
        stopped = threading.Event()
        finalizing = sys.is_finalizing
        MAX_AHEAD = 3        # placed batches held beyond the consumer

        # Lock order: iter_lock -> cond, never the reverse.  next() runs
        # under iter_lock only (an item and its ticket are drawn together),
        # so a worker blocked in next() never wedges the traffic on cond,
        # nor the consumer's teardown, which touches only cond.
        def worker():
            while not stopped.is_set():
                with iter_lock:
                    if total[0] is not None or err:
                        return
                    try:
                        item = next(items_iter)
                    except StopIteration:
                        total[0] = seq[0]
                        with cond:
                            cond.notify_all()
                        return
                    except BaseException as e:
                        with cond:
                            err.append(e)
                            cond.notify_all()
                        return
                    i = seq[0]
                    seq[0] += 1
                with cond:
                    # bound the memory held: do not run ahead of the
                    # consumer (i == next_out is always allowed, so the
                    # batch it waits for cannot deadlock)
                    while i - next_out[0] > MAX_AHEAD and not stopped.is_set() and not err:
                        cond.wait(0.2)
                    if stopped.is_set() or err:
                        return
                try:
                    placed = place(item)
                except BaseException as e:
                    with cond:
                        err.append(e)
                        cond.notify_all()
                    return
                with cond:
                    buf[i] = placed
                    cond.notify_all()

        threads = [threading.Thread(target=worker, name=f"ftrl-feed-{k}", daemon=True)
                   for k in range(workers)]
        for t in threads:
            t.start()
        try:
            while True:
                with cond:
                    with span("feed.wait"):
                        while (
                            next_out[0] not in buf
                            and not err
                            and (total[0] is None or next_out[0] < total[0])
                        ):
                            cond.wait(0.2)
                    if err or next_out[0] not in buf:
                        break
                    b = buf.pop(next_out[0])
                    next_out[0] += 1
                    cond.notify_all()
                yield b
        finally:
            stopped.set()
            with cond:
                cond.notify_all()
            if not finalizing():
                for t in threads:
                    t.join(timeout=30)
                _close_source(items_iter, threads)
            buf.clear()
        if err:
            raise err[0]

    def _place_async(self, arrays, role: str) -> tuple:
        """(Batch, ready event or None) of one host batch ([B, ...] or
        [S, B, ...]) of `role`, on a feeder thread: first its transfer-tier
        form (_compact, as ftrl_ffm_tpu/train.py::_device_batch), then on
        the card copied into pinned memory and to the device with
        non-blocking copies on a stream from PyTorch's pool, the event
        recorded behind them.  The caching host allocator keeps each pinned
        buffer until its copy has run.  On the CPU: the host arrays as
        tensors, nothing to wait for.  An absent feats_base stays None.
        Counts feed.batches, feed.place_s (the whole call), feed.compact_s
        (its _compact) and upload.bytes.<role>: the feeder's threads are
        not spanned (tracing)."""
        t0 = time.perf_counter()
        arrays = self._compact(arrays, role)
        t1 = time.perf_counter()
        host = [None if a is None else _host_tensor(a) for a in arrays]
        if self.device.type != "cuda":
            batch, ready = Batch(*host), None
        else:
            stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream):
                batch = Batch(*(None if t is None else
                                t.pin_memory().to(self.device, non_blocking=True)
                                for t in host))
                ready = torch.cuda.Event()
                ready.record(stream)
        tracing.count("upload.bytes." + role,
                      sum(t.numel() * t.element_size() for t in host if t is not None))
        tracing.count("feed.batches")
        tracing.count("feed.compact_s", t1 - t0)
        tracing.count("feed.place_s", time.perf_counter() - t0)
        return batch, ready

    def _adopt(self, batch: Batch, ready) -> Batch:
        """A fed batch, ready for the consumer's stream: that stream waits
        for the copies' event, and record_stream keeps the caching
        allocator from handing the batch's memory (allocated on the
        feeder's stream) to another allocation before the steps that read
        it have run."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch:
                if t is not None:
                    t.record_stream(stream)
        return batch

    def _device_feed(self, arrays_iter, role: str = "train"):
        """Host batches of `role` as device batches, placed on the feeder
        (ftrl_ffm_tpu/train.py::_device_feed)."""
        place = lambda a: self._place_async(a, role)  # noqa: E731
        for batch, ready in self._feed(arrays_iter, place):
            yield self._adopt(batch, ready)

    def _device_feed_multi(self, groups_iter, role: str = "train"):
        """Like _device_feed, for (stacked [S, B, ...] group, real steps)
        items (_grouped)."""
        place = lambda gr: (self._place_async(gr[0], role), gr[1])  # noqa: E731
        for (batch, ready), real in self._feed(groups_iter, place):
            yield self._adopt(batch, ready), real

    # ---- steps_per_call > 1: groups of S steps (ftrl_ffm_tpu/train.py:
    # 506-633, 1414-1472, 2034-2047) ----
    def _inert_batch(self) -> tuple:
        """One inert host batch of this rank's rows: sample_w 0, values 0,
        field 0 and the sentinel id n_feats everywhere, so it changes no
        table, adds no loss and counts no step."""
        b, f = self._local_bs, self.cfg.max_nnz
        return (
            np.zeros((b, f), np.int32),
            np.full((b, f), self.cfg.n_feats, np.int32),
            np.zeros((b, f), np.float32),
            np.zeros(b, np.float32),
            np.zeros(b, np.float32),
        )

    def _grouped(self, arrays_iter, s: int):
        """Stack host batches into [S, ...] groups: (group, real steps).
        The remainder group is padded with inert batches, so every group
        has one shape."""
        group: list[tuple] = []

        def stack(g):
            g = g + [self._inert_batch()] * (s - len(g))
            return tuple(np.stack([t[i] for t in g]) for i in range(5))

        for arrays in arrays_iter:
            group.append(arrays)
            if len(group) == s:
                yield stack(group), s
                group = []
        if group:
            yield stack(group), len(group)

    def _cached_idx_chunks(self, cache: _DevCache, epoch_rng=None):
        """([S, b] int32 index rows on the device, real steps) of one pass
        over a resident dataset, S = steps_per_call: the file order made on
        the device (epoch_rng None; _iota_rows' rows), or _cached_order's
        rows uploaded once.  The last group is padded with rows of the pad
        row's index: inert steps."""
        lb, s = self._local_bs, self.cfg.steps_per_call
        n_steps, pad = self._cache_steps(cache)
        n_groups = -(-n_steps // s)
        idx = self._cached_order(cache, epoch_rng, n_groups * s, pad)
        if idx is None:
            with span("index"):
                idx = torch.arange(n_groups * s * lb, dtype=torch.int32, device=self.device)
                idx = idx.clamp_(max=pad)
        idx = idx.view(n_groups, s, lb)
        for g in range(n_groups):
            yield idx[g], min(s, n_steps - g * s)

    @staticmethod
    def _unstack(leaves) -> list:
        """The S batches of a stacked [S, B, ...] group's leaves (an absent
        feats_base stays None)."""
        return [Batch(*(None if t is None else t[k] for t in leaves))
                for k in range(leaves[0].shape[0])]

    def _multi_train_impl(self, *leaves) -> tuple:
        """S train steps on a stacked [S, B, ...] group: ([S, 2] per-step
        (loss sum, count),)."""
        return self._train_chain(self._unstack(leaves))

    def _gather_train_impl(self, cache: _DevCache, idx: torch.Tensor) -> tuple:
        """S train steps on batches gathered from a resident dataset by
        the [S, B] index rows: ([S, 2] per-step (loss sum, count),)."""
        return self._train_chain(self._take_cached(cache, ix) for ix in idx)

    def _train_chain(self, batches) -> tuple:
        """Train on each batch in turn: ([k, 2] per-step (loss sum, count),)
        or on a mesh ([k, 3] with the route drops, _step_sums)."""
        return (torch.stack([self._train_one(b) for b in batches]),)

    def _train_one(self, batch: Batch) -> torch.Tensor:
        """One train step: its [2] (loss sum, count), or on a mesh its [3]
        (loss sum, count, route drops) over the batch axes."""
        out = self._step.train_step(self.state, batch)
        sums = [out.loss_sum, out.count]
        if out.route_overflow is not None:
            sums.append(out.route_overflow)
        return torch.stack(sums)

    def _multi_eval_impl(self, *args) -> tuple:
        """S eval batches of a stacked group, chained into the running
        sums: args = the group's leaves, the [S] real-step mask, the
        [2, P] running (sums, compensations); returns the new [2, P]."""
        *leaves, real, acc = args
        return self._eval_chain(self._unstack(leaves), real, acc)

    def _gather_eval_impl(self, cache: _DevCache, idx: torch.Tensor, real: torch.Tensor,
                          acc: torch.Tensor) -> tuple:
        """S eval batches gathered from a resident dataset, chained into
        the running sums, as _multi_eval_impl."""
        return self._eval_chain((self._take_cached(cache, ix) for ix in idx), real, acc)

    def _eval_part(self, batch: Batch, bins: int) -> tuple:
        """One eval batch's sums: (loss sum, count, pos, neg histograms)
        with bins > 0, else (loss sum, count, logits); on a mesh summed
        over the batch axes, with the route drops after the count in
        route mode (ShardedStep.eval_step)."""
        ls, ct, logits, of, pos, neg = self._step.eval_step(self.state, batch, bins)
        head = (ls[None], ct[None]) if of is None else (ls[None], ct[None], of[None])
        return (*head, pos, neg) if bins else (*head, logits)

    def _eval_chain(self, batches, real: torch.Tensor, acc: torch.Tensor) -> tuple:
        """Each real batch's sums (_eval_part: loss sum, count, [route
        drops,] pos and neg histograms), one row of P, Kahan-added into
        the running sums acc[0] with compensations acc[1]: the S = 1
        pass's chain, step by step, so the totals keep its bits (the drop
        counts are integers, which the chain adds exactly).  An inert
        step's add is discarded (torch.where on the mask), since adding
        zeros would still fold the compensation in."""
        tot, comp = acc[0], acc[1]
        for k, b in enumerate(batches):
            part = torch.cat(self._eval_part(b, AUC_BINS))
            (t2,), (c2,) = kahan_add((tot,), (comp,), (part,))
            tot, comp = torch.where(real[k], t2, tot), torch.where(real[k], c2, comp)
        return (torch.stack([tot, comp]),)

    def _group_key(self, key: tuple, inputs: tuple) -> tuple:
        """What a captured group bakes in: `key` (what its function reads
        besides its inputs), the inputs' shapes and kinds, and every state
        tensor's address, shape, strides and dtype.  The graph writes to
        the state's memory, so a swapped tensor (init_from_weights, the
        in-place form's linear-table reconcile, an assigned state) changes
        the key."""
        shapes = tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs)
        return key, shapes, _tensor_key(self.state)

    def _run_group(self, role: str, fn, inputs: tuple, key: tuple = ()) -> tuple:
        """Dispatch one S-step group: fn(*inputs) -> a tuple of tensors.
        On the CPU fn runs eagerly.  On the card the first group of a key
        (_group_key) runs eagerly (real work, and every kernel's first-use
        setup) and is then captured, and every later group of the key
        replays.  A role keeps the graphs of up to _GRAPH_KEYS keys, so the
        keys of a streamed run (its full groups and the padded last one,
        whose tiers differ) are captured in its first epoch and replayed
        after; a key of another state (a swapped tensor) drops the old
        state's graphs and their memory first.  A role's graphs share one
        memory pool: they replay one at a time on one stream and their
        outputs are copied out, so the pool holds about one group's
        scratch whatever the number of keys.  A capture or replay that
        fails raises: no key falls back to eager steps."""
        if self.device.type != "cuda":
            return fn(*inputs)
        key = self._group_key(key, inputs)
        graphs = self._graphs.setdefault(role, {})
        entry = graphs.get(key)
        if entry is not None:
            graphs[key] = graphs.pop(key)  # the most recently used last
            out = entry.replay(inputs)
            self.group_dispatch["replays"] += 1
            return out
        for k in [k for k in graphs if k[-1] != key[-1]]:
            del graphs[k]
        while len(graphs) >= _GRAPH_KEYS:
            del graphs[next(iter(graphs))]
        if not graphs:  # a pool no live graph uses is not shared again
            self._graph_pools[role] = torch.cuda.graph_pool_handle()
        out = fn(*inputs)
        self.group_dispatch["eager"] += 1
        entry = _GroupGraph()
        with span("graph.capture"):
            entry.capture(fn, inputs, self._graph_pools[role])
        graphs[key] = entry
        self.group_dispatch["captures"] += 1
        return out

    def _train_batches(self, epoch_rng: np.random.Generator):
        """This rank's host batches of one training pass (on a mesh, of its
        byte range, padded to the agreed step count)."""
        cfg = self.cfg
        if cfg.online:
            reader = StreamReader(
                sys.stdin if cfg.cmd else cfg.train_data,
                cfg.file_type,
                self._local_bs,
                cfg.max_nnz,
                cfg.n_feats,
                cfg.n_fields,
                n_parse_threads=cfg.n_threads,
                byte_range=None if cfg.cmd else self._byte_range(cfg.train_data),
            )
            it = reader.batches()
        else:
            it = batch_iterator(
                self._dataset("train"), self._local_bs, shuffle=cfg.shuffle,
                rng=epoch_rng, sentinel=cfg.n_feats,
            )
        return self._pad_to_steps(it, self._global_steps("train"))

    def _eval_batches(self):
        cfg = self.cfg
        if cfg.online:
            reader = StreamReader(
                cfg.eval_data,
                cfg.file_type,
                self._local_bs,
                cfg.max_nnz,
                cfg.n_feats,
                cfg.n_fields,
                n_parse_threads=cfg.n_threads,
                byte_range=self._byte_range(cfg.eval_data),
            )
            it = reader.batches()
        else:
            it = batch_iterator(
                self._dataset("eval"), self._local_bs, shuffle=False, sentinel=cfg.n_feats
            )
        return self._pad_to_steps(it, self._global_steps("eval"))

    # ---- training ----
    @spanned("train.epoch")
    def train_epoch(self, epoch_rng: Optional[np.random.Generator] = None) -> float:
        """One pass over the training data; returns its mean log-loss
        (ftrl_ffm_tpu/train.py::Trainer.train_epoch): from the
        device-resident dataset where one engages (_fresh_cache), else
        streamed through the feeder; one step a dispatch, or S
        (steps_per_call) a group.  The per-step loss sums stay on the
        device: one readback per epoch, closed on the host in float64 (the
        reference accumulates double over whole passes,
        src/task/ftrl_online.cpp:82-94)."""
        if epoch_rng is None:
            # persistent, so repeated calls do not repeat one permutation
            if not hasattr(self, "_epoch_rng"):
                self._epoch_rng = np.random.default_rng(self.cfg.seed)
            epoch_rng = self._epoch_rng
        grouped = self.cfg.steps_per_call > 1
        cache = self._fresh_cache("train")
        if cache is not None:
            # online epochs replay the file order (the reference rewinds and
            # re-reads, src/task/ftrl_online.cpp:42-58): no shuffle
            shuffle = self.cfg.shuffle and not self.cfg.online
            rng = epoch_rng if shuffle else None
            if grouped:
                sums = self._train_groups(self._cached_groups(cache, rng))
            else:
                sums = self._train_steps(self._cached_batches(cache, rng))
        else:
            if grouped:
                groups = self._grouped(self._train_batches(epoch_rng), self.cfg.steps_per_call)
                sums = self._train_groups(
                    (("multi",), self._multi_train_impl, tuple(b), real)
                    for b, real in self._device_feed_multi(groups))
            else:
                sums = self._train_steps(self._device_feed(self._train_batches(epoch_rng)))
            # the first streamed pass observed the whole stream: the ranks
            # agree its narrowings now (one all-gather; a no-op on one
            # process and once agreed)
            self._agree_dyn("train")
        # a checkpoint due within the epoch is durable once the epoch
        # returns (async writes joined; the atomic rename already landed)
        self._join_pending_checkpoint()
        return self._epoch_loss(sums)

    def _cached_groups(self, cache: _DevCache, epoch_rng=None):
        """The train groups of one pass over a resident dataset, in
        _train_groups' form, in file order (epoch_rng None) or in the
        permutation epoch_rng.shuffle draws (_cached_batches' order): the
        gather's key names the dataset's tensors and row count, which the
        captured gather reads."""
        key = ("gather", _tensor_key(cache.ds), cache.n, cache.compact)
        fn = functools.partial(self._gather_train_impl, cache)
        for idx, real in self._cached_idx_chunks(cache, epoch_rng):
            yield key, fn, (idx,), real

    def _maybe_save(self, step_now: int, step_prev: int) -> None:
        """With model_path and save_every, a mid-training checkpoint when
        the step count crossed a multiple of save_every
        (ftrl_ffm_tpu/train.py::train_epoch's maybe_save)."""
        save_every = self.cfg.save_every if self.cfg.model_path else 0
        if save_every and step_now // save_every > step_prev // save_every:
            self._save_mid_checkpoint(step_now)

    def _train_steps(self, batches) -> list:
        """Train on each batch in turn; the per-step [loss sum, count] pairs,
        left on the device.  Nothing here waits for the device.  A
        mid-training checkpoint where one falls due (_maybe_save), in
        streamed and resident epochs alike."""
        sums = []
        for batch in batches:
            with span("train.step"):
                sums.append(self._train_one(batch))
            done = self._steps_done + len(sums)
            self._maybe_save(done, done - 1)
        self._steps_done += len(sums)
        return sums

    def _train_groups(self, groups) -> list:
        """_train_steps for steps_per_call > 1: each (key, fn, inputs,
        real steps) group dispatched by _run_group; the [real, 2] per-step
        sums, inert steps dropped, left on the device.  A checkpoint falls
        due at a group's end, at the step count that crossed the multiple
        of save_every (JAX's maybe_save(step_now, step_prev))."""
        sums = []
        for key, fn, inputs, real in groups:
            with span("train.group"):
                (out,) = self._run_group("train", fn, inputs, key)
                sums.append(out[:real])
            prev = self._steps_done
            self._steps_done += real
            self._maybe_save(self._steps_done, prev)
        return sums

    @spanned("train.loss_close")
    def _epoch_loss(self, sums: list) -> float:
        """The epoch's mean log-loss from its per-step sums ([2] a step, or
        [k, 2] a group; on a mesh [3], the route drops third, whose total
        goes to _epoch_route_overflow): one readback."""
        self._epoch_route_overflow = 0
        if not sums:
            return float("nan")
        width = sums[0].shape[-1]
        ls_ct = torch.cat([s.reshape(-1, width) for s in sums]).cpu().numpy()
        if width == 3:
            self._epoch_route_overflow = int(np.sum(ls_ct[:, 2], dtype=np.float64))
        acc = LossAccumulator()
        acc.update(
            np.sum(ls_ct[:, 0], dtype=np.float64), np.sum(ls_ct[:, 1], dtype=np.float64)
        )
        return acc.mean

    def train(self, profile_dir: Optional[str] = None) -> dict:
        """The multi-epoch run: train, then evaluate after each epoch when
        eval_data is set, printing the reference's per-epoch lines
        (ftrl_ffm_tpu/train.py::Trainer.train; reference:
        src/task/ftrl_online.cpp:45-67).  Returns the history dict.

        profile_dir: if set, epoch 1 runs under torch.profiler (CPU and
        CUDA activities on the card, CPU only on the CPU), synchronized
        inside the profiled block, and its trace is written there in
        TensorBoard's format (tensorboard_trace_handler: one
        `*.pt.trace.json` a run), as the JAX package writes its
        jax.profiler trace.  Profiling changes no bits."""
        cfg = self.cfg
        history = {"train_loss": [], "eval_loss": [], "eval_auc": [], "route_overflow": []}
        rng = np.random.default_rng(cfg.seed)
        # more than one process: only the coordinator prints the lines
        log = print if self._proc_id == 0 else (lambda *a, **k: None)
        for epoch in range(1, cfg.n_epochs + 1):
            t0 = time.perf_counter()
            if profile_dir and epoch == 1:
                with self._profiled(profile_dir):
                    train_loss = self.train_epoch(rng)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            else:
                # the epoch's one loss readback waits for its last step
                train_loss = self.train_epoch(rng)
            dt = time.perf_counter() - t0
            log(f"epoch {epoch} train time: {dt:.4f}s, train loss: {train_loss:.4f}")
            history["train_loss"].append(train_loss)
            overflow = self._epoch_route_overflow
            history["route_overflow"].append(overflow)
            if overflow:
                # the reference updates every occurrence unconditionally
                # (src/model/ftrl_model.cpp:66-77): a drop must be loud
                log(f"epoch {epoch} WARNING: routed lookup dropped {overflow} occurrences "
                      f"(bucket capacity); raise --route_capacity for exact updates")
                if cfg.route_overflow_policy == "error":
                    raise RuntimeError(
                        f"route-mode bucket overflow: {overflow} occurrences dropped in "
                        f"epoch {epoch} (route_overflow_policy='error'); raise route_capacity"
                    )
            if cfg.eval_data:
                t0 = time.perf_counter()
                eval_loss, eval_auc = self.evaluate()
                dt = time.perf_counter() - t0
                if cfg.eval_auc:
                    log(
                        f"epoch {epoch} eval time: {dt:.4f}s, "
                        f"eval loss: {eval_loss:.4f}, eval auc: {eval_auc:.4f}"
                    )
                else:
                    log(f"epoch {epoch} eval time: {dt:.4f}s, eval loss: {eval_loss:.4f}")
                history["eval_loss"].append(eval_loss)
                history["eval_auc"].append(eval_auc)
        # no return with a checkpoint still being written in the background
        self._join_pending_checkpoint()
        return history

    def _profiled(self, profile_dir: str):
        """A torch.profiler context that writes its trace to profile_dir
        when it closes (Trainer.train's profile_dir)."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(profile_dir))

    # ---- checkpoints (ftrl_ffm_tpu/train.py::save_checkpoint and
    # _save_mid_checkpoint) ----
    def save_checkpoint(self, path: str, extra: Optional[dict] = None) -> dict:
        """Write the full state (the logical one: the in-place form's stale
        linear tables reconciled first) to `path`, synchronously, behind
        any write in flight.  The header always records the model-defining
        config (model_signature), which every load validates.  On a mesh
        every rank calls it: rank 0 writes the logical state, gathered a
        chunk at a time (io/checkpoint.py::save_checkpoint's mesh form),
        the bytes a one-device save of it writes.  Returns
        io/checkpoint.py::save_checkpoint's seconds and bytes."""
        self._join_pending_checkpoint()
        extra = dict(extra or {})
        extra.setdefault("model_config", model_signature(self.cfg))
        if self._mesh is not None:
            self._maybe_sync_lin()
            return save_checkpoint(path, self.state, level=self.cfg.compress_level,
                                   extra=extra, mesh=self._mesh, n_feats=self.cfg.n_feats)
        return save_checkpoint(path, self.logical_state, level=self.cfg.compress_level,
                               extra=extra)

    def _join_pending_checkpoint(self) -> None:
        """Wait for the background checkpoint write in flight, if any, and
        re-raise its failure: a silently lost --save_every checkpoint would
        defeat the crash-recovery contract.  The wait's seconds go to the
        write's checkpoint_log record ("join_wait_s")."""
        t = self._ckpt_thread
        if t is not None:
            t0 = time.perf_counter()
            with span("train.checkpoint"):
                t.join()
            self._ckpt_thread = None
            self.checkpoint_log[-1]["join_wait_s"] = time.perf_counter() - t0
        exc = self._ckpt_exc
        if exc is not None:
            self._ckpt_exc = None
            raise RuntimeError("background checkpoint write failed") from exc

    @spanned("train.checkpoint")
    def _save_mid_checkpoint(self, step: int) -> None:
        """A periodic full-state checkpoint at `step` (header
        "mid_training_step").  Synchronous unless cfg.async_checkpoint (and
        always on a mesh, whose save gathers over its groups); then
        only the snapshot happens on the training thread — it must, since
        the next step updates the tables in place — and a background
        thread compresses and writes (crash-atomic either way).  One write
        in flight: a new save joins the previous first.

        The snapshot: where a copy of the state fits on the device
        (_snapshot_copy_fits), a clone on the current stream, which orders
        it before the next step's kernels; the writer pulls it on its own
        stream after an event recorded behind the clone, and record_stream
        keeps the allocator from handing the copy's memory to a later step
        while the pull runs.  Otherwise the state is copied into (pageable)
        host memory, finished before this returns."""
        self._join_pending_checkpoint()
        extra = {"mid_training_step": step}
        t0 = time.perf_counter()
        # a mesh's save gathers over its groups: collectives stay on the
        # training thread, in every rank's order, so it writes in line
        if not self.cfg.async_checkpoint or self._mesh is not None:
            rec = {"step": step, "snapshot": "sync"}
            rec.update(self.save_checkpoint(self.cfg.model_path, extra=extra))
            rec["stall_s"] = time.perf_counter() - t0
            self.checkpoint_log.append(rec)
            return
        extra["model_config"] = model_signature(self.cfg)
        state = self.logical_state
        ready = None
        if self._snapshot_copy_fits(state):
            how = "device_copy"
            snap = ModelState(*(None if t is None else t.clone() for t in state))
            if self.device.type == "cuda":
                if self._ckpt_stream is None:
                    self._ckpt_stream = torch.cuda.Stream(self.device)
                ready = torch.cuda.Event()
                ready.record()
                for t in snap:
                    if t is not None:
                        t.record_stream(self._ckpt_stream)
        else:
            how = "inline"
            # pageable, as JAX's device_get: pinning a state too large for
            # the card would hold that much host memory pinned after the save
            snap = ModelState(*(None if t is None else t.to("cpu", copy=True) for t in state))
        rec = {"step": step, "snapshot": how, "stall_s": time.perf_counter() - t0}
        self.checkpoint_log.append(rec)
        path, level, stream = self.cfg.model_path, self.cfg.compress_level, self._ckpt_stream

        def write():
            w0 = time.perf_counter()
            try:
                if ready is None:
                    rec.update(save_checkpoint(path, snap, level=level, extra=extra))
                else:
                    with torch.cuda.device(self.device), torch.cuda.stream(stream):
                        stream.wait_event(ready)
                        rec.update(save_checkpoint(path, snap, level=level, extra=extra))
            except BaseException as e:  # surfaced at the next join
                self._ckpt_exc = e
            rec["writer_s"] = time.perf_counter() - w0

        self._ckpt_thread = threading.Thread(target=write, name="ftrl-ckpt-writer", daemon=True)
        self._ckpt_thread.start()

    def _snapshot_copy_fits(self, state: ModelState) -> bool:
        """Can a device copy of the state live beside everything else
        (ftrl_ffm_tpu/train.py::_snapshot_copy_fits, with the card's own
        numbers)?  Always on the CPU.  On the card: the state, the update's
        working set (estimate_hbm_bytes), the resident datasets and the
        copy within 80% of the card's memory, and the copy within what is
        free now (mem_get_info, plus what the caching allocator holds
        unused)."""
        if self.device.type != "cuda":
            return True
        copy_b = sum(t.numel() * t.element_size() for t in state if t is not None)
        cache_b = sum(
            t.numel() * t.element_size()
            for c in self._dev_cache.values() if c is not None for t in c.ds
        )
        free, total = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        need = estimate_hbm_bytes(self.cfg)["total"] + cache_b + copy_b
        return need <= 0.8 * total and copy_b <= free

    # ---- serving ----
    @spanned("eval.pass")
    def evaluate(self) -> tuple[float, float]:
        """(mean log-loss, AUC) over eval_data (ftrl_ffm_tpu/train.py::
        evaluate): from the device-resident dataset in file order where one
        engages, else streamed through the feeder; one batch a dispatch,
        or S (steps_per_call) a group.  Per-batch sums chain on the device
        with Kahan compensation; one readback at the end."""
        exact = self.cfg.eval_auc and self.cfg.auc_mode == "exact"
        if exact and self._proc_n > 1:
            raise ValueError(EXACT_AUC_MULTIPROCESS)
        if self.cfg.steps_per_call > 1:
            return self._evaluate_grouped()
        cache = self._fresh_cache("eval")
        if exact and cache is not None and cache.layout == "shard":
            # the runtime backstop where a shard cache was built without
            # the config naming it (Trainer.__init__ refuses the rest)
            raise ValueError(EXACT_AUC_SHARD)
        if cache is not None:
            batches = self._cached_batches(cache, role="eval")
        else:
            batches = self._device_feed(self._eval_batches(), "eval")
        score_rows: list = []
        tot = None
        for batch in batches:
            with span("eval.step"):
                part = self._eval_part(batch, 0 if exact else AUC_BINS)
                if exact:
                    # logits rank like sigmoid scores: the host ranks them
                    *part, logits = part
                    score_rows.append((logits, batch.y, batch.sample_w))
                part = torch.cat(part)
                if tot is None:
                    tot = (part, torch.zeros_like(part))
                else:
                    (t,), (c,) = kahan_add((tot[0],), (tot[1],), (part,))
                    tot = (t, c)
        self._agree_dyn("eval")
        if tot is None:
            return float("nan"), float("nan")
        loss, auc = self._close_eval(tot[0])
        if exact:
            # one process: every score is this rank's
            lg, yy, ww = (torch.cat([r[i] for r in score_rows]).cpu().numpy() for i in range(3))
            m = ww > 0  # drop padding rows
            return loss, exact_auc(lg[m], yy[m] > 0)
        return loss, auc

    @spanned("eval.close")
    def _close_eval(self, sums: torch.Tensor) -> tuple[float, float]:
        """(mean log-loss, binned AUC) of a pass from its summed row
        (_eval_part's parts: loss sum, count, [route drops,] and the pos
        and neg histograms where they were counted, else AUC nan): one
        readback; the route drops reported (_flush_eval_overflow)."""
        sums = sums.cpu().numpy()
        head = 3 if self._step.counts_drops else 2
        if head == 3:
            self._flush_eval_overflow(sums[2], "eval")
        loss = LossAccumulator()
        loss.update(sums[0], sums[1])
        if sums.shape[0] == head:
            return loss.mean, float("nan")
        auc = StreamingAUC(AUC_BINS)
        auc.update(sums[head : head + AUC_BINS], sums[head + AUC_BINS :])
        return loss.mean, auc.result()

    def _flush_eval_overflow(self, overflow, where: str) -> None:
        """Warn (on the coordinator) and, under route_overflow_policy=
        "error", raise where routed lookups of an eval or predict pass
        dropped occurrences: its metrics or predictions missed features
        (ftrl_ffm_tpu/train.py::_flush_eval_overflow).  One readback."""
        of = 0 if overflow is None else int(overflow)
        if of:
            msg = (f"routed lookup dropped {of} occurrences during {where} (bucket "
                   f"capacity): metrics/predictions computed with missing features; "
                   f"raise --route_capacity")
            if self._proc_id == 0:
                print(f"WARNING: {msg}")
            if self.cfg.route_overflow_policy == "error":
                raise RuntimeError(msg)

    def _evaluate_grouped(self) -> tuple[float, float]:
        """evaluate() for steps_per_call > 1: each group's batches chained
        into the running [2, P] sums and compensations (_eval_chain), one
        dispatch a group (_run_group), one readback at the end
        (_close_eval)."""
        s = self.cfg.steps_per_call
        cache = self._fresh_cache("eval")
        if cache is not None:
            key = ("gather", _tensor_key(cache.ds), cache.n, cache.compact)
            fn = functools.partial(self._gather_eval_impl, cache)
            groups = (((idx,), real) for idx, real in self._cached_idx_chunks(cache, None))
        else:
            key, fn = ("multi",), self._multi_eval_impl
            groups = ((tuple(b), real) for b, real in
                      self._device_feed_multi(self._grouped(self._eval_batches(), s), "eval"))
        head = 3 if self._step.counts_drops else 2
        acc = None
        for inputs, real in groups:
            with span("eval.group"):
                if acc is None:
                    acc = torch.zeros((2, head + 2 * AUC_BINS), dtype=torch.float32,
                                      device=self.device)
                mask = torch.arange(s, device=self.device) < real  # the real steps
                (acc,) = self._run_group("eval", fn, (*inputs, mask, acc), key)
        self._agree_dyn("eval")
        if acc is None:
            return float("nan"), float("nan")
        return self._close_eval(acc[0])

    def predict_file(self, data_path: str, out_path: str) -> int:
        """Score a libsvm/libffm file: one sigmoid probability per line,
        "%.6f" (ftrl_ffm_tpu/train.py::predict_file).  data_path "-" scores
        stdin and out_path "-" writes to stdout.  Returns the number of
        samples scored.  More than one process: _predict_file_multihost."""
        cfg = self.cfg
        if self._proc_n > 1:
            return self._predict_file_multihost(data_path, out_path)
        if data_path == "-" and not cfg.file_type:
            raise ValueError(
                "--predict_data -: stdin cannot be sniffed; set --file_type"
            )
        reader = StreamReader(
            sys.stdin if data_path == "-" else data_path,
            cfg.file_type or detect_file_type(data_path),
            cfg.batch_size,
            cfg.max_nnz,
            cfg.n_feats,
            cfg.n_fields,
            n_parse_threads=cfg.n_threads,
            # no progress prints: they would interleave with the probability
            # stream when out_path is stdout
            log_every=0,
        )
        total = 0
        out_cm = (
            contextlib.nullcontext(sys.stdout)
            if out_path == "-"
            else open(out_path, "w")
        )
        with out_cm as f:
            for arrays in reader.batches():
                logits = self._step.eval_step(self.state, self._device_batch(arrays, "predict"))[2]
                probs = torch.sigmoid(logits).cpu().numpy().astype(np.float64)
                mask = arrays[4] > 0  # drop padded tail samples
                f.write("".join(f"{p:.6f}\n" for p in probs[mask]))
                total += int(mask.sum())
        return total

    def _predict_file_multihost(self, data_path: str, out_path: str) -> int:
        """Ordered scoring on more than one process
        (ftrl_ffm_tpu/train.py::_predict_file_multihost): every batch shard
        scores its byte range in lockstep (inert-padded to a common step
        count), each batch's probabilities are all-gathered, and the
        coordinator writes each shard's fixed-width lines at their global
        line offsets: the file is byte for byte a one-process run's."""
        cfg = self.cfg
        if data_path == "-" or out_path == "-":
            raise ValueError(
                "multi-process predict_file needs real file paths (stdin/stdout "
                "streaming is single-process only)"
            )
        shards = self._sharded.batch_shards
        br = self._byte_range(data_path)
        # nonblank: the parsers skip blank lines, and one output row is one
        # nonblank line, so every later shard's offsets depend on it
        lines_local = count_lines(data_path, br, nonblank=True)
        counts = pdist.process_allgather(np.array([lines_local], np.int64), self.device)[:, 0]
        # one rank a shard: replicate mode's model groups read one range
        m = self._mesh.data * self._mesh.model // shards
        counts = counts[::m]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        total = int(counts.sum())
        lb = self._local_bs
        n_steps = int(-(-counts.max() // lb)) if total else 0
        row_bytes = 9  # every line is "0.xxxxxx\n" (a probability, %.6f)
        reader = StreamReader(
            data_path, cfg.file_type or detect_file_type(data_path), lb, cfg.max_nnz,
            cfg.n_feats, cfg.n_fields, n_parse_threads=cfg.n_threads, byte_range=br,
            log_every=0,
        )
        out_f = None
        if self._proc_id == 0:
            out_f = open(out_path, "wb")
            out_f.truncate(row_bytes * total)
        overflow = None
        try:
            for b_idx, arrays in enumerate(self._pad_to_steps(reader.batches(), n_steps)):
                _, _, logits, of, _, _ = self._step.eval_step(
                    self.state, self._device_batch(arrays, "predict"))
                if of is not None:
                    overflow = of if overflow is None else overflow + of
                gathered = pdist.process_allgather(torch.sigmoid(logits), self.device)[::m]
                if out_f is None:
                    continue
                base = b_idx * lb
                for p in range(shards):
                    valid = min(max(int(counts[p]) - base, 0), lb)
                    if valid <= 0:
                        continue
                    probs = gathered[p, :valid].astype(np.float64)
                    # the offsets hold only if every line is row_bytes long:
                    # a non-finite probability would misalign every later one
                    if not np.isfinite(probs).all():
                        raise FloatingPointError(
                            f"non-finite probabilities in predict batch {b_idx} (shard "
                            f"{p}): refusing to write a misaligned output file"
                        )
                    payload = "".join(f"{v:.6f}\n" for v in probs).encode()
                    out_f.seek(row_bytes * (int(starts[p]) + base))
                    out_f.write(payload)
        finally:
            if out_f is not None:
                out_f.close()
        self._flush_eval_overflow(overflow, "predict")
        return total
