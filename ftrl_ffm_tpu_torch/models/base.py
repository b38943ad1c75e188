"""Model base: state, fixed-shape batches, init, the one-device train and
eval steps and the linear and bias path (the counterpart of
ftrl_ffm_tpu/models/base.py).

A `ModelState` holds the (n, z, w) tables as tensors on the run's device.
Each model's forward pass (Model.forward) does its interaction on the rows
its caller gathers, one stored w row per occurrence as in the JAX package:
the one-device steps here with local_rows, the mesh step
(parallel/sharded.py) with its lookups.  Each train step refreshes w for
the rows it touches, by the form ftrl.py::update_form decides once
(Model.form): the combined-payload "dense2" and "sparse2" forms, or the
huge-table "inplace" form from a split payload, with an f32 or a bfloat16
w table (Config.table_dtype) and, for FFM's "dense2", an f32 or a bfloat16
payload (Config.acc_dtype).  LR has no factor tables (vec_n, vec_z and
vec_w are None) and updates its linear tables alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.ftrl import (
    UNTOUCHED_N,
    FtrlParams,
    _div,
    bias_update,
    ftrl_weights,
    update_form,
)
from ftrl_ffm_tpu_torch.metrics import StreamingAUC
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import (
    _inplace_step,
    ftrl_update,
    ftrl_update_linear,
)
from ftrl_ffm_tpu_torch.ops.interactions import linear_logits
from ftrl_ffm_tpu_torch.transfer import unpack_bitplanes


class Batch(NamedTuple):
    """One fixed-shape padded mini-batch.

    Padding convention (ftrl_ffm_tpu/models/base.py::Batch): padded
    occurrences have value 0.0, field 0 and feature id == n_feats (a drop
    sentinel for scatters; gathers clip).  Padded samples have sample_w 0.
    A streamed batch arrives in the transfer tiers' upload form
    (transfer.py; Config.compact_transfer), which widen_batch decodes:
    narrowed dtypes, uint16 feats read against feats_base (deltas off an
    int32 [F+1] base row, or the split tier's low halves under uint8 high
    bitplanes), DEC6 values, bit-packed fields, and the zero-size markers:
    fields [0, F] (every row's fields are 0..F-1), fields [B, 0] (LR and
    FM, which never read them) and vals [B, 0] (all values 1.0)."""

    fields: torch.Tensor    # [B, F] int32 (int8/int16, packed, or a marker)
    feats: torch.Tensor     # [B, F] int32 (or uint16, see feats_base)
    vals: torch.Tensor      # [B, F] float32 (int8/bf16, [B, 3F] uint8 DEC6,
                            # or the marker)
    y: torch.Tensor         # [B] float32 in {0, 1} (or int8)
    sample_w: torch.Tensor  # [B] float32 (or int8 when integral)
    feats_base: Optional[torch.Tensor] = None  # [F+1] int32 bases and the
                            # sentinel, or [B, k, ceil(F/8)] uint8 high planes


class ModelState(NamedTuple):
    """(n, z, w) tables, as in ftrl_ffm_tpu/models/base.py::ModelState.
    The bias weight is derived from (bias_n, bias_z) on the fly."""

    bias_n: torch.Tensor
    bias_z: torch.Tensor
    lin_n: torch.Tensor               # [R]
    lin_z: torch.Tensor               # [R]
    lin_w: torch.Tensor               # [R]
    vec_n: Optional[torch.Tensor]     # [R, D] or None
    vec_z: Optional[torch.Tensor]     # [R, D] or None
    vec_w: Optional[torch.Tensor]     # [R, D] or None
    step: torch.Tensor                # int32 scalar


class TrainOut(NamedTuple):
    """A train step's outputs, on one device and on a mesh (there global
    over the batch axes, the logits this rank's)."""

    state: ModelState
    logits: torch.Tensor    # [B] pre-update logits (train loss accounting,
                            # like reference src/task/ftrl_online.cpp:70-80)
    loss_sum: torch.Tensor  # scalar: sum of per-sample log-loss (masked)
    count: torch.Tensor     # scalar: number of real samples
    route_overflow: Optional[torch.Tensor] = None  # a mesh's route drops
                            # (0 without routed lookups); None on one device


def widen_batch(b: Batch) -> Batch:
    """Decode a batch's upload form to canonical dtypes on its device
    (ftrl_ffm_tpu/models/base.py::widen_batch, keyed off dtype and rank as
    it is): uint16 feats are deltas off feats_base[..., :F] (65535 the
    sentinel feats_base[..., F]) or, under a uint8 feats_base, the split
    tier's low halves; [..., 3F] uint8 vals are DEC6 keys; fields with one
    axis more than feats are bit-packed planes; [..., 0, F] fields become
    the iota 0..F-1 along the last axis and [..., B, 0] vals ones; other
    narrowed dtypes are cast.  A canonical batch passes through."""
    feats = b.feats.to(torch.int32)
    fb = b.feats_base
    if fb is not None and b.feats.dtype == torch.uint16:
        if fb.dtype == torch.uint8:
            # split tier: feats = id & 0xFFFF, fb holds bit 16+i of each id
            if fb.shape[-2]:
                feats = feats | (unpack_bitplanes(fb, feats.shape[-1]) << 16)
        else:
            base, sent = fb[..., :-1], fb[..., -1:]
            feats = torch.where(feats == 65535, sent, base + feats)
    if b.vals.shape[-1] == 0 and feats.shape[-1] != 0:
        vals = torch.ones(feats.shape, dtype=torch.float32, device=feats.device)
    elif b.vals.dtype == torch.uint8:
        # DEC6: k = 3 little-endian bytes a value, v = k / 1e6 correctly
        # rounded: the host checked that this gives its f32 values
        u = b.vals.to(torch.int32)
        vals = dec6_decode(u[..., 0::3] | (u[..., 1::3] << 8) | (u[..., 2::3] << 16))
    else:
        vals = b.vals.to(torch.float32)
    if b.fields.dim() == feats.dim() + 1 and b.fields.dtype == torch.uint8:
        # bit-packed fields: plane i = bit i of the field id
        fields = unpack_bitplanes(b.fields, feats.shape[-1])
    elif b.fields.dim() >= 2 and b.fields.shape[-2] == 0 and feats.shape[-1]:
        iota = torch.arange(feats.shape[-1], dtype=torch.int32, device=feats.device)
        fields = iota.expand(feats.shape).contiguous()
    else:
        fields = b.fields.to(torch.int32)
    return Batch(
        fields=fields,
        feats=feats,
        vals=vals,
        y=b.y.to(torch.float32),
        sample_w=b.sample_w.to(torch.float32),
    )


def dec6_decode(k: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 k / 1e6 of integer keys k < 2^24: the
    DEC6 value encoding of the transfer tier and of the compact
    device-resident dataset (ftrl_ffm_tpu/models/base.py::dec6_decode).  The JAX package needs a
    Veltkamp two-product there because the TPU divides by a reciprocal;
    here ftrl.py::_div divides correctly rounded on every device."""
    return _div(k.to(torch.float32), 1e6)


def take_cached(ds, ix: torch.Tensor, n_real: int) -> Batch:
    """Gather one batch from a device-resident dataset (Config.device_cache;
    ftrl_ffm_tpu/models/base.py::take_cached).

    ds: (fields, feats, vals, y) tensors carrying one extra inert tail row
    (field 0, feat id n_feats, value 0, y 0) at index n_real, at which the
    padded index rows ix point; sample_w marks those rows 0.  fields and
    vals may be dataset-level zero-size markers ([0, F]: every row's fields
    are 0..F-1; vals [0, F]: every value is 1.0), re-emitted in the marker
    shapes widen_batch expands: [0, F] fields and [B, 0] vals."""
    fields, feats, vals, y = ds
    return Batch(
        fields=fields if fields.shape[0] == 0 else fields.index_select(0, ix),
        feats=feats.index_select(0, ix),
        vals=vals.new_zeros((ix.shape[0], 0)) if vals.shape[0] == 0
        else vals.index_select(0, ix),
        y=y.index_select(0, ix),
        sample_w=(ix < n_real).to(torch.float32),
    )


def local_rows(feats: torch.Tensor):
    """rows(table, widen=True): the rows of `table` for the flat ids of
    `feats` on one device, the one-device steps' lookups
    (parallel/sharded.py::ShardedStep._rows is the mesh's).  The gather
    clips as the JAX package's jnp.take(mode="clip"): the padding sentinel
    id n_feats reads the last row, which its zero value then makes inert.
    The rows are widened to f32 (a bf16 table's too: the training kernel
    reads f32 rows), or with widen=False kept in the table's dtype (the
    eval kernel widens bf16 rows itself)."""
    ids = feats.reshape(-1)

    def rows(table: torch.Tensor, widen: bool = True) -> torch.Tensor:
        ix = ids.clamp(0, table.shape[0] - 1)
        # a 1-D table through aten::index, rows through index_select: the
        # device ops the one-device step is measured with
        got = table[ix] if table.dim() == 1 else table.index_select(0, ix)
        return got.to(torch.float32) if widen else got

    return rows


def binary_logloss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Numerically stable -y*log(s) - (1-y)*log(1-s) from the logit
    (softplus as jax.nn.softplus: logaddexp(x, 0))."""
    return torch.logaddexp(logits, torch.zeros_like(logits)) - y * logits


def loss_grad(logits: torch.Tensor, batch: Batch) -> torch.Tensor:
    """[B] dL/dlogit = (sigmoid(logit) - y) * sample_w (reference:
    src/model/ffm.cpp:44), which scales every table's gradient."""
    return (torch.sigmoid(logits) - batch.y) * batch.sample_w


# ids whose factor weights one generator draws (Model.init): block b of a
# table comes from a generator keyed by (seed, b), so that every placement
# of the table draws the same rows
INIT_BLOCK = 1 << 20


def block_seed(seed: int, block: int) -> int:
    """The seed of block `block`'s generator under `seed`: splitmix64's
    finalizer of seed + block * the golden ratio, a 64-bit seed."""
    x = (seed + block * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


class Model:
    """Shared init / step plumbing; subclasses provide the interaction math
    (forward).  A Model is also the one-device step: train_step and
    eval_step, by the update form decided once here (self.form)."""

    # a mesh step counts its route drops beside its eval sums
    # (parallel/sharded.py::ShardedStep); one device drops nothing
    counts_drops = False

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.params = FtrlParams(cfg.w_alpha, cfg.w_beta, cfg.w_l1, cfg.w_l2)
        self.form = update_form(cfg, cfg.n_feats)
        # a bf16 payload only for "dense2" from a producer that emits the
        # combined layout, as in ftrl_ffm_tpu/models/base.py::train_step:
        # the in-place update adds g into the f32 z table, and the sparse
        # form's segment sums stay f32
        self.payload_dtype = (
            torch.bfloat16
            if cfg.acc_dtype == "bfloat16" and self.form == "dense2" and self._emits_combined()
            else torch.float32
        )

    # ---- state ----
    def init(self, generator: Optional[torch.Generator] = None,
             shard: tuple = (0, 1)) -> ModelState:
        """A fresh state on the generator's device (ftrl_ffm_tpu/models/
        base.py::Model.init).  The generator defaults to one seeded with
        cfg.seed on cfg.device.  A row width of 0 (LR) gives no factor
        tables: vec_n, vec_z and vec_w are None.  Under keep_init semantics
        the factor weights start N(init_mean, init_stddev) on live lanes and
        zero on the dead lanes of a padded row (lane (0, n_fields) mirrors
        the linear table, which starts at 0); under reference semantics they
        start at zero.  They are drawn in f32 and then stored in
        cfg.table_dtype; n, z and the linear tables are f32.  A
        torch.Generator does not reproduce JAX's random stream: tests carry
        a JAX-made init across instead.

        The weights are drawn INIT_BLOCK ids at a time: block 0 from
        `generator`, block b > 0 from a generator seeded with
        block_seed(generator.initial_seed(), b), so a table of at most
        INIT_BLOCK rows is the generator's one draw.  `shard` = (index, M)
        gives the rows of model shard `index` of M alone
        (parallel/mesh.py's placement: the ids i with i % M == index, at
        row i // M, ceil(n_feats / M) rows, those past n_feats zero): the
        rows that shard_state takes from the whole init, with no tensor of
        n_feats rows made."""
        if generator is None:
            generator = torch.Generator(device=self.cfg.device)
            generator.manual_seed(self.cfg.seed)
        dev = generator.device
        index, m = shard
        n, e = self.cfg.n_feats, self.cfg.row_width
        r = -(-n // m)
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
        vec_n = vec_z = vec_w = None
        if e:
            vec_w = torch.zeros((r, e), dtype=getattr(torch, self.cfg.table_dtype), device=dev)
            # the reference materializes w = f(n=0, z=0) = 0 before the
            # first logit, so under its semantics factors never leave zero
            # (src/model/ffm.cpp:72-88)
            if self.cfg.factor_semantics != "reference":
                self._draw_factors(vec_w, generator, index, m)
            vec_n, vec_z = zeros(r, e), zeros(r, e)
        return ModelState(
            bias_n=zeros(), bias_z=zeros(),
            lin_n=zeros(r), lin_z=zeros(r), lin_w=zeros(r),
            vec_n=vec_n, vec_z=vec_z, vec_w=vec_w,
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def _draw_factors(self, vec_w: torch.Tensor, generator: torch.Generator, index: int,
                      m: int) -> None:
        """Gaussian init like the reference's utils::init_weights
        (src/include/utils/utils.h:38-61), kept until a row is touched:
        the rows of shard `index` of m (Model.init) written into vec_w
        block by block, the dead lanes of a padded row zero."""
        dev, n, e = vec_w.device, self.cfg.n_feats, vec_w.shape[1]
        cp = self.cfg.field_pad
        dead = None
        if cp > self.cfg.n_fields:
            dead = torch.arange(e, device=dev) % cp >= self.cfg.n_fields
        seed = generator.initial_seed()
        for b, lo in enumerate(range(0, n, INIT_BLOCK)):
            hi = min(n, lo + INIT_BLOCK)
            g = generator
            if b:
                g = torch.Generator(device=dev)
                g.manual_seed(block_seed(seed, b))
            first = lo + (index - lo) % m
            rows = torch.randn((hi - lo, e), generator=g, device=dev)[first - lo::m]
            rows.mul_(self.cfg.init_stddev).add_(self.cfg.init_mean)
            if dead is not None:
                rows.masked_fill_(dead, 0.0)
            vec_w[first // m:first // m + rows.shape[0]].copy_(rows)

    def bias_weight(self, state: ModelState) -> torch.Tensor:
        return ftrl_weights(state.bias_n, state.bias_z, self.params)

    def forward(self, state: ModelState, batch: Batch, rows, bias_w: torch.Tensor,
                train: bool, split: bool = False,
                payload_dtype: torch.dtype = torch.float32):
        """The model's math on a widened batch, its weights from `rows`
        (rows(table, widen=True) -> the batch's [B*F, ...] rows of a table:
        local_rows on one device, the mesh's lookups in parallel/
        sharded.py) and the bias weight bias_w: (logits [B], gs, payload,
        lane).  With train, gs = dL/dlogit (loss_grad) and the factor
        tables' payload already scaled by it, combined ((gg2 [B*F, 2E],),
        in payload_dtype) or, with split, (g [B*F, E], g2 [B*F, E]), or
        None where the model has no factor tables (LR); lane is the
        payload's lane that carries the linear gradient (-1: none, the
        linear tables take their own).  Without train, gs and the payload
        are None."""
        raise NotImplementedError

    def _lin_logits(self, state: ModelState, batch: Batch, rows, bias_w: torch.Tensor,
                    v: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B] bias plus linear term, the linear weights gathered from the
        linear table (FFM reads them from the factor rows v where it keeps
        a mirror of the table)."""
        return linear_logits(rows(state.lin_w).reshape(batch.feats.shape), batch.vals, bias_w)

    def _emits_combined(self) -> bool:
        """True when the gradient producer writes the combined (g || g^2)
        payload itself (FFM's kernel #2), which may then be bf16
        (ftrl_ffm_tpu/models/base.py::_emits_combined).  FM's payload stays
        f32 whatever acc_dtype says, as the JAX package's XLA payload of FM
        does."""
        return False

    def _lin_mirror_maintained(self) -> bool:
        """True when the factor tables' dead lane is a complete,
        forward-read replica of the linear tables
        (ftrl_ffm_tpu/models/base.py::_lin_mirror_maintained): the in-place
        update then skips the linear tables, which ride stale until
        sync_lin_from_mirror."""
        return False

    def sync_lin_from_mirror(self, state: ModelState) -> ModelState:
        """The state with its linear tables taken from the mirror lane
        (a no-op unless the model keeps one, see FFM)."""
        return state

    # ---- import (reference weights -> trainable state) ----
    def _import_vec_layout(self, vec_w: torch.Tensor) -> torch.Tensor:
        """Hook: the reference's factor-row layout -> the internal one
        (inverse of _export_vec_layout)."""
        return vec_w

    def init_from_weights(self, bias, lin_w, vec_w=None, device=None) -> ModelState:
        """A state on `device` (default cfg.device) whose materialized
        weights equal the given reference-layout weights (host arrays or
        tensors): the interop path for models trained by the C++ binary
        (ftrl_ffm_tpu/models/base.py::init_from_weights; reference:
        src/model/{lr,ffm}.cpp load paths, which likewise restore only w
        and leave n/z at zero).

        Exact inversion of the closed form at n = 0:
            w = -(z - sgn(z) l1) / (l2 + beta / alpha)
            => z = -w * (l2 + beta / alpha) - sign(w) * l1   (w != 0)
        so the first training touch sees exactly these weights.  The
        divisor d = l2 + beta / alpha is a Python float (float64, as in the
        JAX package) that multiplies as float32: no division runs on the
        device, so the card, the CPU and JAX give the same bits.  n stays
        0; a factor model given no vec_w keeps a fresh init's factors."""
        dev = torch.device(device or self.cfg.device)
        p = self.params
        d = p.l2 + p.beta / p.alpha

        def f32(x) -> torch.Tensor:
            # a copy: the state's tables never alias the caller's arrays
            return torch.as_tensor(x, dtype=torch.float32).to(dev, copy=True)

        def z_of(w: torch.Tensor) -> torch.Tensor:
            return torch.where(w != 0.0, -w * d - torch.sign(w) * p.l1, 0.0)

        r = self.cfg.n_feats
        lin = f32(lin_w).reshape(r)
        b = f32(bias).reshape(())
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
        vec_n = vec_z = vec_w_t = None
        if self.cfg.row_width:
            if vec_w is None:
                gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
                init = self.init(gen)
                vec_n, vec_z, vec_w_t = init.vec_n, init.vec_z, init.vec_w
            else:
                vw = self._import_vec_layout(f32(vec_w)).reshape(r, self.cfg.row_width)
                vec_n = zeros(r, self.cfg.row_width)
                vec_z = z_of(vw)
                vec_w_t = vw.to(getattr(torch, self.cfg.table_dtype)).contiguous()
        return ModelState(
            bias_n=zeros(), bias_z=z_of(b),
            lin_n=zeros(r), lin_z=z_of(lin), lin_w=lin,
            vec_n=vec_n, vec_z=vec_z, vec_w=vec_w_t,
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )

    # ---- export (reference weight-layout materialization) ----
    def _export_vec_layout(self, vec_w: torch.Tensor) -> torch.Tensor:
        """Hook: the internal factor-row layout -> the reference's (FFM rows
        are factor-major internally, see ops/layout.py)."""
        return vec_w

    def materialize_weights(self, state: ModelState):
        """(bias, lin_w[, vec_w]) in the reference's save layout
        (ftrl_ffm_tpu/models/base.py::materialize_weights; reference:
        src/model/ffm.cpp:138-147), tensors on the state's device, the
        tables sliced to n_feats.  The w tables are stored, so this is a
        read-out.  Pass Trainer.logical_state: the in-place form's linear
        tables ride stale until reconciled."""
        n = self.cfg.n_feats
        lin_w = state.lin_w[:n]
        vec_w = state.vec_w
        if vec_w is not None:
            vec_w = self._export_vec_layout(vec_w[:n])
        return self.bias_weight(state), lin_w, vec_w

    # ---- public API: the one-device step ----
    @property
    def lin_rides_stale(self) -> bool:
        """True when train steps skip the linear tables and leave them
        stale: the in-place form with the dead-lane mirror
        (_lin_mirror_maintained).  The port's auto never picks the in-place
        form (ftrl.py::update_form), so only update_mode=inplace does."""
        return self.form == "inplace" and self._lin_mirror_maintained()

    def predict_logits(self, state: ModelState, batch: Batch) -> torch.Tensor:
        batch = widen_batch(batch)
        return self.forward(state, batch, local_rows(batch.feats), self.bias_weight(state),
                            train=False)[0]

    def train_step(self, state: ModelState, batch: Batch) -> TrainOut:
        """One deterministic mini-batch FTRL step (ftrl_ffm_tpu/models/
        base.py::Model.train_step; reference FFM::train, src/model/
        ffm.cpp:38-50, over the batch), by self.form.

        The tables of `state` are updated IN PLACE — the PyTorch form of
        the JAX step's donated buffers — and the returned TrainOut.state is
        `state` itself.  To compare two steps from one state, clone it
        first.  No autograd: the gradient is the fused kernel's output."""
        p = self.params
        batch = widen_batch(batch)
        split = self.form == "inplace"
        logits, gs, payload, lane = self.forward(
            state, batch, local_rows(batch.feats), self.bias_weight(state), True, split,
            self.payload_dtype)
        bias_n, bias_z = bias_update(state.bias_n, state.bias_z, gs, p)
        # the linear tables take their own [nnz, 2] payload when no dead
        # lane carries their gradient through the factor update; the
        # in-place form with a maintained mirror skips them (they ride
        # stale, as in ftrl_ffm_tpu/models/base.py::train_step)
        lin_own = lane < 0 or (split and not self._lin_mirror_maintained())
        gg2_lin = None
        if lin_own:
            # linear table: g = gs * x (reference: src/model/ftrl_model.cpp:
            # 66-77)
            g_lin = (gs[:, None] * batch.vals).reshape(-1)
            gg2_lin = torch.stack([g_lin, g_lin * g_lin], dim=-1)
        self.apply_update(state, batch.feats.reshape(-1), payload, lane, gg2_lin, self.form)
        state.bias_n.copy_(bias_n)
        state.bias_z.copy_(bias_z)
        count = torch.sum(batch.sample_w)
        # inert (fully padded) batches do not count as steps
        state.step.add_((count > 0).to(torch.int32))
        per_loss = binary_logloss(logits, batch.y) * batch.sample_w
        return TrainOut(
            state=state, logits=logits, loss_sum=torch.sum(per_loss), count=count
        )

    def apply_update(self, state: ModelState, ids: torch.Tensor, payload, lane: int,
                     gg2_lin, kind) -> None:
        """The table update of one step, in place: `payload` (train_step's,
        or None for LR) on the rows `ids` (ids outside [0, R) drop) by the
        one-device form `kind`, and the linear tables from their own [N, 2]
        `gg2_lin` where it is given, else from the payload's lane `lane` (or
        not at all: the in-place form's stale tables).  The sharded step
        (parallel/sharded.py) runs it on a shard's rows."""
        p = self.params
        # JAX gives the linear tables' own payload a kind of its own, dense
        # or sparse; on a 1-D table both give the same bits, which
        # ftrl_update_linear's one step gives
        lin_tables = (state.lin_n, state.lin_z, state.lin_w)
        if payload is None:
            ftrl_update_linear(*lin_tables, ids, gg2_lin, p)
        elif kind == "inplace":
            # the factor tables' in-place step, then the linear tables' own,
            # from one sort of the ids
            _inplace_step(state.vec_n, state.vec_z, state.vec_w, ids, *payload, p,
                          None if gg2_lin is None else lin_tables, gg2_lin)
        else:
            ftrl_update(
                state.vec_n, state.vec_z, state.vec_w, *lin_tables,
                ids, payload[0], lane, p, gg2_lin, sparse=kind == "sparse2",
            )

    def eval_step(self, state: ModelState, batch: Batch, bins: int = 0):
        """(loss_sum, count, logits, None, pos, neg) of one eval batch
        (reference: src/eval/evaluate.cpp:23-33): the masked log-loss sum
        and count, and with bins > 0 the AUC histograms (metrics.py::
        StreamingAUC.bucket_counts), else pos and neg None.  The fourth
        item, a mesh step's route drops, is None on one device
        (parallel/sharded.py::ShardedStep.eval_step has the same shape)."""
        batch = widen_batch(batch)
        logits = self.predict_logits(state, batch)
        per_loss = binary_logloss(logits, batch.y) * batch.sample_w
        loss_sum, count = torch.sum(per_loss), torch.sum(batch.sample_w)
        pos = neg = None
        if bins:
            pos, neg = StreamingAUC.bucket_counts(logits, batch.y, batch.sample_w, bins)
        return loss_sum, count, logits, None, pos, neg

    def has_zero_weights(self, state: ModelState, table: str = "linear") -> bool:
        """True if L1 has produced exact zeros among touched weights of
        `table` ("linear", "factor" or "any"): the reference's
        sparsification check (ftrl_ffm_tpu/models/base.py::has_zero_weights;
        src/include/utils/utils.h:63-76).  Touched means n above
        UNTOUCHED_N; the dead lanes of a padded factor row (lane (0,
        n_fields) mirrors the linear table) do not count as factors."""
        if table not in ("linear", "factor", "any"):
            raise ValueError(f"unknown table {table!r}")
        # the in-place form leaves the linear tables stale (the mirror lane
        # holds them): reconcile first, a no-op elsewhere
        state = self.sync_lin_from_mirror(state)

        def zeros_among_touched(n_tab, w_tab) -> bool:
            return bool(torch.any((n_tab > UNTOUCHED_N) & (w_tab == 0.0)))

        lin = table in ("linear", "any") and zeros_among_touched(state.lin_n, state.lin_w)
        if lin or table == "linear":
            return lin
        if state.vec_n is None:
            return False
        vec_n = state.vec_n
        cp, c = self.cfg.field_pad, self.cfg.n_fields
        if cp > c:
            genuine = torch.arange(vec_n.shape[-1], device=vec_n.device) % cp < c
            vec_n = torch.where(genuine, vec_n, 0.0)
        return zeros_among_touched(vec_n, state.vec_w)
