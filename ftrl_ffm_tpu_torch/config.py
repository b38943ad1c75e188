"""Configuration for ftrl_ffm_tpu_torch.

A copy of ftrl_ffm_tpu/config.py (the flag surface of the reference, plus the
batching, mesh and dtype extras) with one field added: `device`, the torch
device every tensor of a run lives on.  The copy exists because
ftrl_ffm_tpu/config.py cannot be imported without loading jax (the package's
__init__ imports its jax modules).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # ---- reference flag surface (same names & defaults as the C++ CLI) ----
    # reference: src/include/utils/cmd_option.h:49-63
    model_path: str = ""
    train_data: str = ""
    eval_data: str = ""
    model_type: str = "FFM"          # LR | FM | FFM
    init_mean: float = 0.0
    init_stddev: float = 0.02
    w_alpha: float = 1e-4
    w_beta: float = 1.0
    w_l1: float = 0.1
    w_l2: float = 5.0
    n_threads: int = 1               # host-side parse workers (was CPU train threads)
    n_epochs: int = 1
    n_fields: int = 8
    n_feats: int = 10000
    n_factors: int = 16
    online: bool = True              # streaming (single pass/epoch) vs in-memory shuffled
    cmd: bool = False                # read training stream from stdin
    file_type: str = ""              # "libsvm" | "libffm" | "" = auto-detect

    # ---- TPU-native extras ----
    batch_size: int = 4096           # samples per device step (global batch)
    max_nnz: int = 0                 # fixed nnz padding per sample; 0 = sniff from data
    steps_per_call: int = 1          # train/eval steps per dispatch; >1 runs
                                     # S batches per dispatch (on the card one
                                     # CUDA-graph replay per S steps: for
                                     # steps whose host dispatch outlasts
                                     # their device time)
    seed: int = 42
    # Semantics of L1 on the factor tables:
    #   "reference": factor weight = closed_form(n, z) always.  Matches the
    #     reference exactly, including its property that a factor row collapses
    #     to zero on first touch (z=0 -> w=0) and never recovers
    #     (reference: src/model/ffm.cpp:72-88 materializes w=f(n,z) *before*
    #     the logit, so first-touch grads see w=0).
    #   "keep_init": untouched coordinates (n == 0) keep their random init so
    #     factors actually train (alphaFM-style).  Strictly better log-loss.
    factor_semantics: str = "keep_init"
    # Storage dtype for the materialized factor weight table vec_w.  The
    # FTRL accumulators (n, z) always stay float32 — only the gathered
    # forward weights are quantized.  bfloat16 halves the dominant
    # gather/scatter HBM traffic; weights round to 8 mantissa bits.
    table_dtype: str = "float32"     # "float32" | "bfloat16"
    use_pallas: str = "auto"         # "auto" (TPU only) | "on" | "off"
    # Compact host->device transfer of streamed batches (lossless; the
    # transfer tiers, transfer.py): fields int8/int16, bit-packed or an
    # iota marker, feature ids per-column uint16 deltas off an int32 base
    # row or split into uint16 low halves and high bitplanes, values an
    # all-ones marker, int8, bfloat16 or 6-decimal DEC6 where exact, else
    # f32, labels and integral sample weights int8 -- widened on the
    # device (models/base.py::widen_batch).  Every narrowing is verified
    # exact on the host per batch, so no bit of a run changes.
    compact_transfer: bool = True
    # FTRL table update strategy, the JAX package's modes: "dense" and
    # "sparse" force the combined-payload update of the touched rows (the
    # port's "dense2" and "sparse2"), "inplace" the huge-table form (g
    # scattered straight into z, then a pass over the table; with the FFM
    # dead-lane mirror it also skips the separate linear-table update and
    # reconciles the linear tables from the mirror at checkpoint/export
    # boundaries, see models/base.py::train_step); "auto" picks by the
    # table's size.  ftrl.py::update_form maps a mode to the form a step
    # runs, on one device and on every mesh.
    update_mode: str = "auto"
    # Gradient-accumulator dtype for the combined (g || g^2) payload +
    # scatter accumulator of the "dense2" update (the port's kernel #2 and
    # update kernel; "inplace" and "sparse2" keep an f32 payload, as in the
    # JAX package): "bfloat16" halves the bytes of
    # the dominant train-step pass (kernel payload write, scatter read + RMW,
    # accumulator zero-init + closed-form read) at ~3 significant digits per
    # per-occurrence gradient; (n, z, w) tables and the closed form stay f32.
    # Duplicate-id accumulation error is O(2^-8) relative per step.  Default
    # f32 preserves exact parity with the XLA path and the reference.
    acc_dtype: str = "float32"       # "float32" | "bfloat16"
    # mesh: data-parallel x model-parallel(row-sharded tables)
    mesh_data: int = 1
    mesh_model: int = 1
    # Sharded-lookup strategy (mesh_model > 1):
    #   "replicate": every table shard gathers its local rows for the full
    #     batch and a psum("model") assembles rows — simple, exact, but
    #     per-shard gather work is O(nnz * E) regardless of shard count.
    #   "route": batch shards over BOTH mesh axes; each device's ids are
    #     bucketed by owner shard (fixed capacity route_capacity * nnz/M,
    #     overflow dropped with a warning) and routed with all_to_all; rows
    #     come back the same way, gradients route forward to owners.  Traffic
    #     and per-device work are O(nnz * E / (data*model)) — the scalable
    #     form (SURVEY §2b/2c).
    #   "auto": route when mesh_model > 1 and shapes divide, else replicate.
    lookup_mode: str = "auto"
    # Fixed per-peer routing capacity as a multiple of the balanced share
    # (nnz_local / mesh_model).  Routing is by unique id (duplicates share a
    # slot — parallel/sharded.py::_route), so overflow requires more
    # DISTINCT ids owned by one peer than route_k: impossible for id skew,
    # only for adversarial id sets concentrated on one shard (ids ≡ r mod
    # mesh_model).  Overflowing ids' occurrences are dropped (gradient +
    # lookup), counted per epoch (history["route_overflow"]), and warned.
    route_capacity: float = 2.0
    # What to do when routed occurrences are dropped by bucket capacity:
    #   "warn"  — per-step jax.debug warning + per-epoch counter/log line.
    #   "error" — additionally raise at the end of the offending epoch (the
    #     reference's unconditional per-occurrence updates make any drop an
    #     exactness violation; src/model/ftrl_model.cpp:66-77).
    route_overflow_policy: str = "warn"
    eval_auc: bool = True            # new capability vs reference (log-loss only)
    # AUC estimator: "binned" = streaming histogram (O(1) memory, error
    # a-posteriori-bounded by StreamingAUC.error_bound — O(1/AUC_BINS) for
    # spread-out scores, honest about clustered ones); "exact" = rank
    # statistic over ALL eval scores collected host-side (the eval set's
    # scores must fit host memory; needs steps_per_call=1, a single
    # process and a device_cache_layout other than "shard", as in the JAX
    # package).
    auc_mode: str = "binned"         # "binned" | "exact"
    shuffle: bool = True             # offline mode epoch shuffle
    # Device-resident datasets: upload the parsed dataset to HBM once, then
    # run every epoch's batch gather + train steps entirely on device (host
    # supplies only a 4-byte/sample index row per step) — the TPU-native
    # form of the reference's in-memory offline mode
    # (src/task/ftrl_offline.cpp:21-42 loads everything into RAM; here
    # "memory" is HBM).  Offline epochs shuffle per `shuffle`; ONLINE train
    # epochs replay the cache in FILE ORDER — identical batches to the
    # streamed single-pass-per-epoch semantics (the reference rewinds and
    # re-reads the same file each epoch, src/task/ftrl_online.cpp:42-58),
    # including under the shard layout, whose online slices are stored in
    # stream-interleaved order so per-step global batch composition matches
    # the streamed sharded feed exactly — and --cmd stdin never caches (it
    # cannot be re-read).  Batches are identical to the streamed path's
    # (ulp-level jit-fusion slack only, like steps_per_call).  The cached
    # dataset is a SNAPSHOT of the file at build time; train_epoch re-stats
    # the file before each online replay epoch and rebuilds the cache if it
    # changed (matching the streamed rewind's re-read).  "auto" engages when
    # the dataset fits the per-device HBM budget next to the model state and
    # update working set AND (online train) n_epochs > 1 — a single online
    # pass keeps the overlapped streaming feed, since the blocking build
    # would never be amortized; "on" forces it (OOM risk accepted, engages
    # even for one epoch); "off" disables.
    device_cache: str = "auto"       # "auto" | "on" | "off"
    # How the cached dataset is laid out on a mesh (one process a device):
    #   "replicate" — every device holds the full dataset, which only a
    #     mesh of one process can: on more than one process each rank
    #     reads its byte range, so this layout streams there (as in the
    #     JAX package).
    #   "shard" — each rank holds its own byte-range slice (train.py::
    #     _byte_range), padded with inert rows to the largest slice + 1:
    #     offline epochs shuffle the slice, online ones replay its file
    #     order, so the batches are the streamed multi-process run's bit
    #     for bit.  Steps per epoch are ceil(max_slice / b_local), the
    #     multi-process lockstep count.  On one process it holds the
    #     whole dataset, as "replicate" does.
    #   "auto" — "shard" on more than one process, "replicate" on one,
    #     where the rows fit; else stream.
    device_cache_layout: str = "auto"  # "auto" | "replicate" | "shard"
    # Compact in-HBM storage for the cached dataset (single-device runs):
    # the same lossless transfer tiers (split feats, DEC6 vals, bit-packed
    # fields) applied to the RESIDENT arrays — ~1.7-2x more rows fit the
    # cache; batches decode on device right after the gather (a few
    # elementwise ops).  "auto" engages only when the raw arrays would NOT
    # fit next to the state (so the default cached path is byte-identical
    # to round 4's); "on" forces compact storage; "off" never.
    device_cache_compact: str = "auto"  # "auto" | "on" | "off"
    # Device-feed threads.  1 = the single background uploader thread
    # (train.py::_feed).  >1 = order-preserving interleaved feeders: each
    # thread runs the whole placement (pinned copy + device copy) for
    # alternating whole batches, with a reorder buffer so the consumer
    # still sees stream order (FTRL update order is semantics): the same
    # result for every value.  --cmd stdin pins 1 (train.py::
    # _feed_worker_count).
    feed_workers: int = 1
    save_every: int = 0              # checkpoint every N steps (0 = only at end)
    # Mid-training (--save_every) checkpoints: snapshot the state inline (a
    # device copy, or pageable host memory where the copy does not fit;
    # required, since the next step updates the tables in place), then
    # zstd-compress + write + atomic-rename on a background thread while
    # training continues (train.py::Trainer._save_mid_checkpoint).  One
    # save in flight at a time; failures re-raise at the next join.  The
    # final end-of-run save is always synchronous.
    async_checkpoint: bool = True
    compress_level: int = 3          # zstd level for checkpoints / model export
    # Torch device of the run: "cuda" (or "cuda:N") runs the hand-written
    # kernels on the card, "cpu" runs their plain PyTorch versions.  No
    # silent fallback: "cuda" without a card is an error (train.py::Trainer).
    device: str = "cuda"

    def __post_init__(self):
        self.model_type = self.model_type.upper()
        if self.model_type not in ("LR", "FM", "FFM"):
            raise ValueError(
                f"Invalid model_type: {self.model_type}, expect `LR`, `FM` or `FFM`."
            )
        if self.factor_semantics not in ("reference", "keep_init"):
            raise ValueError(f"invalid factor_semantics: {self.factor_semantics}")
        if self.use_pallas not in ("auto", "on", "off"):
            raise ValueError(f"invalid use_pallas: {self.use_pallas!r}")
        if self.update_mode not in ("auto", "dense", "sparse", "inplace"):
            raise ValueError(f"invalid update_mode: {self.update_mode}")
        if self.table_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"invalid table_dtype: {self.table_dtype}")
        if self.acc_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"invalid acc_dtype: {self.acc_dtype}")
        if self.device_cache not in ("auto", "on", "off"):
            raise ValueError(f"invalid device_cache: {self.device_cache}")
        if self.auc_mode not in ("binned", "exact"):
            raise ValueError(f"invalid auc_mode: {self.auc_mode}")
        if self.auc_mode == "exact" and self.steps_per_call > 1:
            raise ValueError(
                "auc_mode=exact needs per-batch scores (steps_per_call=1); "
                "the scan-grouped eval reduces to histograms on device"
            )
        if self.device_cache_compact not in ("auto", "on", "off"):
            raise ValueError(
                f"invalid device_cache_compact: {self.device_cache_compact}"
            )
        if self.device_cache_layout not in ("auto", "replicate", "shard"):
            raise ValueError(
                f"invalid device_cache_layout: {self.device_cache_layout}"
            )
        if self.lookup_mode not in ("auto", "replicate", "route"):
            raise ValueError(f"invalid lookup_mode: {self.lookup_mode}")
        if self.feed_workers < 1:
            raise ValueError(f"invalid feed_workers: {self.feed_workers}")
        if self.route_overflow_policy not in ("warn", "error"):
            raise ValueError(
                f"invalid route_overflow_policy: {self.route_overflow_policy}"
            )
        if self.device != "cpu" and not self.device.startswith("cuda"):
            raise ValueError(
                f"invalid device: {self.device!r}, expect `cuda`, `cuda:N` or `cpu`"
            )

    # Padded field count for FFM factor rows.  The interaction math treats
    # the model as having field_pad fields, of which fields
    # [n_fields, field_pad) simply never occur: all their contributions are
    # provably zero (no occurrence selects them), so results are identical
    # to the unpadded model while every factor row becomes an exact
    # multiple of the 128-lane TPU vector tile.  Aligned rows make XLA's
    # natural entry layout row-major (no transpose copies, no layout pins)
    # and give the gather/scatter exact-vreg rows.  Adopted only when the
    # row overhead stays <= 15% (e.g. K=16, C=39 -> C'=40, +2.6%); the
    # first dead lane additionally carries the linear-table gradient so a
    # single scatter updates both tables (see ftrl.py::
    # dense_ftrl_update2_aug).
    @property
    def field_pad(self) -> int:
        if self.model_type != "FFM":
            return self.n_fields
        import math

        c, k = self.n_fields, self.n_factors
        step = 128 // math.gcd(k, 128)
        cp = -(-c // step) * step
        return cp if (cp - c) * 20 <= 3 * c else c

    # Width of one feature row in the factor table (physical, padded).
    @property
    def row_width(self) -> int:
        if self.model_type == "LR":
            return 0
        if self.model_type == "FM":
            return self.n_factors
        return self.field_pad * self.n_factors

    # Width of one factor row in the reference's save format (logical).
    @property
    def ref_row_width(self) -> int:
        if self.model_type == "LR":
            return 0
        if self.model_type == "FM":
            return self.n_factors
        return self.n_fields * self.n_factors

    def validate_file_type(self) -> None:
        # reference: src/utils/cmd_option.cpp:110-113
        if self.model_type == "FFM" and self.file_type == "libsvm":
            raise ValueError("FFM model requires libffm data format...")


def detect_file_type(file_path: str) -> str:
    """Sniff libsvm vs libffm by counting ':' in the first feature token.

    reference: src/utils/cmd_option.cpp:35-59
    """
    with open(file_path, "r") as f:
        line = f.readline()
    tokens = line.split()
    if len(tokens) < 2:
        raise ValueError("unknown file format...")
    colon_count = tokens[1].count(":")
    if colon_count == 1:
        return "libsvm"
    if colon_count == 2:
        return "libffm"
    raise ValueError("unknown file format...")


def uses_mesh(cfg: Config) -> bool:
    """Does the config ask for a device mesh (mesh_data 0 means every
    device left over on the data axis)?"""
    return cfg.mesh_data != 1 or cfg.mesh_model != 1


def check_ported(cfg: Config) -> None:
    """Raise for use_pallas=off, the one config value that has no
    counterpart in the port."""
    if cfg.use_pallas == "off":
        # the port has no user switch between kernel and plain version: the
        # tensor's device picks (ops/ffm_cuda.py::ffm_fused_logits)
        raise ValueError(
            "use_pallas=off has no counterpart in the PyTorch port: a CUDA "
            "device runs the CUDA kernel, --device cpu its plain version"
        )
