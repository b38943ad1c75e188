"""The sharded FTRL train/eval step over a ("data", "model") mesh of
ranks (ftrl_ffm_tpu/parallel/sharded.py, whose shard_map body runs here on
each rank's own device).

Feature tables are row-sharded over "model" with modulo-interleaved
placement (parallel/mesh.py::interleave_ids); every rank feeds its own
slice of each global batch.  Two lookup modes (Config.lookup_mode):

**replicate**: the batch is split over "data" only, so the ranks of one
model group hold the same slice.  Each rank gathers its own rows of the
slice's ids (others read 0) and an all_reduce over "model" assembles whole
rows on every rank.

**route**: the batch is split over both axes.  Each rank buckets its
physical ids by owner into K slots a peer (route_slots), by UNIQUE id, so
that id skew cannot overflow the buckets; an all_to_all over "model"
delivers the requests, owners gather their rows, a second all_to_all
returns them, and the update routes the payloads to the owners through
the same slots.  Occurrences beyond K distinct ids a peer are dropped,
counted (route_overflow) and, under route_overflow_policy="error", raised.

The table updates (one deterministic update per row and step), by the form
ftrl.py::update_form decides once (ShardedStep.form):
- replicate on one data rank (D = 1): the one-device update on the rank's
  rows (Model.apply_update: "dense2" or "sparse2", the touched-rows kernel,
  or "inplace" under update_mode=inplace, whose linear tables ride stale
  on the mirror lane as on one device);
- replicate on D > 1: "accumulator" (za_scatter into zeroed [rows_local,
  E] sums, an all_reduce over "data", z += G, then kernel #3,
  closed_form_pass) or "allgather" (the (ids, payload) stream all_gathered
  over "data", then the touched-rows kernel on the local rows);
- route: the payloads summed into their send slots (za_scatter), an
  all_to_all each, then the owner's update of the slots it received.  On
  (1, N) meshes that is the one-device form of the shard: "dense2" or
  "sparse2" (auto, dense, sparse), the touched-rows kernel on the received
  slots, the factor and linear tables in one launch from the split payload
  as it arrives (empty slots drop), or "inplace" (update_mode=inplace:
  za_scatter into z, kernel #3 over the shard).  On D > 1 "accumulator".

The routing and the lookups are plain PyTorch, as the JAX package's are
XLA.  The model's own forward pass (Model.forward) runs on the rows the
lookups return (ShardedStep._rows), as the one-device step runs it on its
local gather: FFM through kernels #2 and #1, FM and LR through
ops/interactions.py.  The payload is f32 on a mesh, as the JAX package's
sharded step makes it (acc_dtype narrows only the one-device "dense2"
payload).

A collective over a group of one is skipped where it would copy a table-
or batch-sized tensor (the row all_reduce at M = 1, the accumulator's at
D = 1); the step's one small all_reduce of its sums always runs.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple

import torch

from ftrl_ffm_tpu_torch import tracing
from ftrl_ffm_tpu_torch.config import Config
from ftrl_ffm_tpu_torch.ftrl import FtrlParams, ftrl_accumulate, ftrl_weights, update_form
from ftrl_ffm_tpu_torch.metrics import StreamingAUC
from ftrl_ffm_tpu_torch.models.base import (
    Batch,
    Model,
    ModelState,
    TrainOut,
    binary_logloss,
    widen_batch,
)
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import (
    closed_form_pass,
    ftrl_update,
    ftrl_update_inplace,
    ftrl_update_linear,
    za_scatter,
)
from ftrl_ffm_tpu_torch.parallel import dist
from ftrl_ffm_tpu_torch.parallel.mesh import Mesh, interleave_ids


class Routing(NamedTuple):
    """A step's id routing (route mode), shared by lookup and update."""

    slot: torch.Tensor      # [n] int32 send slot of each occurrence (M*K = dropped);
                            # the occurrences of one id share a slot
    valid: torch.Tensor     # [n] bool: routed
    recv: torch.Tensor      # [M*K] int32 local rows requested of this rank (rl = none)
    overflow: torch.Tensor  # 0-dim: occurrences dropped by capacity


def _resolve_lookup_mode(cfg: Config, mesh: Mesh) -> str:
    m = mesh.model
    if m == 1 or cfg.lookup_mode == "replicate":
        return "replicate"
    n_dev = mesh.data * m
    if cfg.lookup_mode == "route":
        if cfg.batch_size % n_dev:
            raise ValueError(
                f"lookup_mode=route needs batch_size divisible by "
                f"{n_dev} devices, got {cfg.batch_size}"
            )
        return "route"
    return "route" if cfg.batch_size % n_dev == 0 else "replicate"


def route_slots(cfg: Config, n_shards: int, mesh_data: int) -> int:
    """K: route-mode slots a (rank, peer) pair (sharded.py::route_slots,
    shared with train.py::estimate_hbm_bytes)."""
    n_local = cfg.batch_size // (mesh_data * n_shards) * max(1, cfg.max_nnz)
    k = int(n_local / n_shards * cfg.route_capacity)
    return max(8, min(n_local, -(-k // 8) * 8))


def resolves_to_route(cfg: Config) -> bool:
    """Whether the config's mesh runs routed lookups (the config twin of
    _resolve_lookup_mode)."""
    m = max(1, cfg.mesh_model)
    if m == 1 or cfg.lookup_mode == "replicate":
        return False
    n_dev = max(1, cfg.mesh_data) * m
    return cfg.lookup_mode == "route" or cfg.batch_size % n_dev == 0


def _col(mask: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """A per-row mask shaped to broadcast over rows of `tab`."""
    return mask.reshape(-1, *([1] * (tab.dim() - 1)))


class ShardedStep:
    """The train and eval steps of one model config on one mesh, on this
    rank's shard of the state (parallel/mesh.py::shard_state).  Each call
    issues its collectives in a fixed order, the same on every rank."""

    def __init__(self, cfg: Config, mesh: Mesh, model: Model, state: ModelState):
        self.cfg = cfg
        self.mesh = mesh
        self.model = model
        self.params = FtrlParams(cfg.w_alpha, cfg.w_beta, cfg.w_l1, cfg.w_l2)
        self.n_feats = cfg.n_feats
        self.n_shards = mesh.model
        self.rows_local = state.lin_n.shape[0]
        self.mode = _resolve_lookup_mode(cfg, mesh)
        if self.mode == "route":
            # the batch axes are both: the whole group
            self.batch_group = None
            self.batch_shards = mesh.data * mesh.model
            self.shard_index = mesh.rank
            self.route_k = route_slots(cfg, self.n_shards, mesh.data)
        else:
            self.batch_group = mesh.data_group
            self.batch_shards = mesh.data
            self.shard_index = mesh.data_index
            self.route_k = 0
        if cfg.batch_size % self.batch_shards:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by {self.batch_shards} "
                f"batch shards of the {mesh.data} x {mesh.model} mesh"
            )
        self.local_batch = cfg.batch_size // self.batch_shards
        self.form = update_form(cfg, self.rows_local, mesh.data, self.mode == "route")
        # the eval sums carry the route drops (Model.counts_drops)
        self.counts_drops = self.mode == "route"
        # the one-device update of a shard no replica shares leaves the
        # linear tables stale as on one device (Model.lin_rides_stale)
        self.lin_rides_stale = (self.mode == "replicate" and self.form == "inplace"
                                and model._lin_mirror_maintained())
        if mesh.data > 1:
            acc_bytes = 2 * self.rows_local * max(1, cfg.row_width) * 4
            if acc_bytes > (256 << 20):
                warnings.warn(
                    f"mesh_data={mesh.data} replicates each table shard and "
                    f"all-reduces a {acc_bytes / 1e9:.1f} GB dense accumulator "
                    f"over the data axis EVERY step: an O(rows/mesh_model) "
                    f"leg that dominates at this table size.  Scale with "
                    f"mesh_data=1, mesh_model=N, lookup_mode=route instead "
                    f"(no O(table) collectives)."
                )

    # ---- ids and lookups ----
    def _phys_ids(self, feats: torch.Tensor) -> torch.Tensor:
        """Flat physical row ids of the local batch (sentinel M * rl)."""
        return interleave_ids(feats.reshape(-1), self.n_shards, self.rows_local, self.n_feats)

    def _local_ids(self, ids_phys: torch.Tensor) -> torch.Tensor:
        """This rank's local row of each physical id; rows_local (dropped by
        every update) for ids of other shards and the sentinel."""
        rl = self.rows_local
        lid = ids_phys - self.mesh.model_index * rl
        return torch.where((lid >= 0) & (lid < rl), lid, rl).to(torch.int32)

    def _lookup(self, tab: torch.Tensor, ids_phys: torch.Tensor) -> torch.Tensor:
        """Rows of `tab` for every id (replicate mode), in the table's dtype:
        this rank's rows, 0 for the others', then an all_reduce over
        "model" (exact, also in bf16: each row has one owner).  On one model
        rank the gather clamps as on one device, the sentinel reading the
        last row, which its zero value makes inert."""
        rl = self.rows_local
        if self.n_shards == 1:
            return tab.index_select(0, ids_phys.clamp(max=rl - 1))
        lid = self._local_ids(ids_phys)
        rows = tab.index_select(0, lid.clamp(max=rl - 1))
        rows = torch.where(_col(lid < rl, tab), rows, 0)
        return dist.all_reduce(rows, self.mesh.model_group)

    @tracing.spanned("route.ids")
    def _route(self, ids_phys: torch.Tensor) -> Routing:
        """Bucket this rank's physical ids by owner, by unique id, and
        exchange the requests over "model" (sharded.py::_route): the rank
        of an id among its owner's distinct ids, from one stable sort."""
        m, rl, k = self.n_shards, self.rows_local, self.route_k
        ids = ids_phys.to(torch.int64)
        owner = torch.div(ids, rl, rounding_mode="floor")  # the sentinel's is m
        local = (ids % rl).to(torch.int32)
        sid, order = torch.sort(ids, stable=True)  # id-sorted, so owner-sorted too
        sowner = owner.index_select(0, order)
        id_start = torch.ones_like(sid, dtype=torch.bool)
        id_start[1:] = sid[1:] != sid[:-1]
        owner_start = torch.ones_like(sid, dtype=torch.bool)
        owner_start[1:] = sowner[1:] != sowner[:-1]
        uniq = torch.cumsum(id_start.to(torch.int64), 0)  # 1-based
        # the distinct ids before this owner's first run, carried forward
        base = torch.cummax(torch.where(owner_start, uniq - 1, 0), 0).values
        rank_sorted = uniq - 1 - base
        valid_sorted = (sowner < m) & (rank_sorted < k)
        slot_sorted = torch.where(valid_sorted, sowner * k + rank_sorted, m * k)
        slot = torch.empty_like(slot_sorted).index_copy_(0, order, slot_sorted)
        # one spare entry takes the dropped occurrences' writes; the
        # occurrences of an id all write the same local row
        send = torch.full((m * k + 1,), rl, dtype=torch.int32, device=ids.device)
        send[slot] = local
        recv = dist.all_to_all(send[: m * k], self.mesh.model_group)
        overflow = ((sowner < m) & ~valid_sorted).sum()
        return Routing(slot=slot.to(torch.int32), valid=slot < m * k, recv=recv,
                       overflow=overflow)

    @tracing.spanned("route.rows")
    def _routed_rows(self, tab: torch.Tensor, rt: Routing) -> torch.Tensor:
        """Rows of the sharded table for this rank's occurrences, in the
        table's dtype: the owners' gather and an all_to_all back."""
        mk, rl = self.n_shards * self.route_k, self.rows_local
        rows = tab.index_select(0, rt.recv.clamp(max=rl - 1))
        back = dist.all_to_all(torch.where(_col(rt.recv < rl, tab), rows, 0),
                               self.mesh.model_group)
        out = back.index_select(0, rt.slot.clamp(max=mk - 1))
        return torch.where(_col(rt.valid, tab), out, 0)

    def _rows(self, ids_phys, rt, tab, widen: bool = True):
        """The rows of `tab` for this rank's occurrences: rows(tab, widen)
        of Model.forward once ids_phys and rt are bound (_lookups)."""
        rows = self._lookup(tab, ids_phys) if rt is None else self._routed_rows(tab, rt)
        return rows.to(torch.float32) if widen else rows

    # ---- table updates ----
    def _accumulate_pass(self, tables, ids, g, g2) -> None:
        """The accumulator form on (n, z, w) [rows_local, E] tables: g and
        g^2 summed into zeroed sums by row (za_scatter), the sums
        all_reduced over "data", z += G, then kernel #3."""
        n, z, w = tables
        acc = torch.zeros((2, *n.shape), dtype=torch.float32, device=n.device)
        za_scatter(acc[0], acc[1], ids, g, g2)
        dist.all_reduce(acc, self.mesh.data_group)
        z.add_(acc[0])
        closed_form_pass(n, z, w, acc[1], self.params)

    def _send(self, rt: Routing, g, g2):
        """(g, g^2) to their owners: summed into the send slots by
        za_scatter, an all_to_all each; the [M*K, E] sums this rank
        received, in rt.recv's slots."""
        mk, e = self.n_shards * self.route_k, g.shape[-1]
        send = torch.zeros((2, mk, e), dtype=torch.float32, device=g.device)
        za_scatter(send[0], send[1], rt.slot, g, g2)
        return (dist.all_to_all(send[0], self.mesh.model_group),
                dist.all_to_all(send[1], self.mesh.model_group))

    @tracing.spanned("route.update")
    def _update_routed(self, state: ModelState, rt: Routing, payload, g_lin, g2_lin) -> None:
        """The routed update (sharded.py::_table_update_routed): the factor
        payload, then the linear one, sent to the owners (_send); then the
        owner's update of its received slots by self.form, counted
        (route.update.touched or route.update.pass).

        "dense2" and "sparse2": one touched-rows launch (ftrl_update) on the
        slots, the split payload read as it arrived, the linear tables from
        the [M*K, 2] stack of theirs (lane -1; FFM's mirror lane is updated
        as a column of the row).  A row arrives from at most M peers, in
        slot order, which is the order za_scatter sums them in; empty slots
        (rows_local) drop unread.  A row no slot names keeps its bits, as
        kernel #3 leaves it (A = 0: n and z stay, w = f(n, z) or w0).

        "inplace" (a (1, N) mesh, update_mode=inplace) and "accumulator"
        (D > 1): each table's own pass over the shard (za_scatter into z,
        or into zeroed sums all_reduced over "data", then kernel #3)."""
        vec = None if payload is None else (state.vec_n, state.vec_z, state.vec_w)
        lin = (state.lin_n, state.lin_z, state.lin_w)
        pay = None if vec is None else self._send(rt, *payload)
        pay_lin = self._send(rt, g_lin, g2_lin)
        form = self.form
        if form in ("dense2", "sparse2"):
            tracing.count("route.update.touched")
            gg2_lin = torch.cat(pay_lin, dim=-1)
            if vec is None:
                ftrl_update_linear(*lin, rt.recv, gg2_lin, self.params)
            else:
                ftrl_update(*vec, *lin, rt.recv, pay, -1, self.params, gg2_lin,
                            sparse=form == "sparse2")
            return
        tracing.count("route.update.pass")
        lin2 = tuple(t.view(-1, 1) for t in lin)
        for tables, sums in ((vec, pay), (lin2, pay_lin)):
            if tables is None:
                continue
            if form == "inplace":
                ftrl_update_inplace(*tables, rt.recv, *sums, self.params)
            else:
                self._accumulate_pass(tables, rt.recv, *sums)

    def _update(self, state: ModelState, ids_phys, rt, payload, lane: int, g_lin) -> None:
        """This step's update of the shard's tables (the module docstring's
        forms): the factor tables from `payload` (its lane `lane` carrying
        the linear gradient, or -1), the linear ones from their own
        (g_lin, g_lin^2)."""
        g_lin = g_lin.reshape(-1, 1)
        g2_lin = g_lin * g_lin
        if rt is not None:
            self._update_routed(state, rt, payload, g_lin, g2_lin)
            return
        lin2 = tuple(t.view(-1, 1) for t in (state.lin_n, state.lin_z, state.lin_w))
        vec = None if payload is None else (state.vec_n, state.vec_z, state.vec_w)
        lid = self._local_ids(ids_phys)
        if self.form == "accumulator":
            if vec is not None:
                self._accumulate_pass(vec, lid, *payload)
            self._accumulate_pass(lin2, lid, g_lin, g2_lin)
            return
        gg2_lin = torch.cat([g_lin, g2_lin], dim=-1)
        if self.form == "allgather":
            group = self.mesh.data_group
            lid = dist.all_gather(lid, group)
            gg2_lin = dist.all_gather(gg2_lin, group)
            if payload is not None:
                payload = (dist.all_gather(payload[0], group),)
            self.model.apply_update(state, lid, payload, -1, gg2_lin, "sparse2")
            return
        # one data rank: the one-device update of this kind on the shard's
        # rows, the linear tables as there (riding stale on the in-place
        # form's mirror: Trainer.logical_state reconciles them)
        if payload is None or lane < 0 or (
            self.form == "inplace" and not self.model._lin_mirror_maintained()
        ):
            self.model.apply_update(state, lid, payload, -1, gg2_lin, self.form)
        else:
            self.model.apply_update(state, lid, payload, lane, None, self.form)

    # ---- steps ----
    def _lookups(self, state: ModelState, batch: Batch):
        """(physical ids, the routing or None, rows(table, widen), the bias
        weight) of this rank's slice."""
        ids_phys = self._phys_ids(batch.feats)
        rt = self._route(ids_phys) if self.mode == "route" else None
        rows = functools.partial(self._rows, ids_phys, rt)
        return ids_phys, rt, rows, ftrl_weights(state.bias_n, state.bias_z, self.params)

    def train_step(self, state: ModelState, batch: Batch) -> TrainOut:
        """One step on this rank's slice of the global batch; the tables of
        the shard are updated in place (state is returned).  Its
        collectives count under mesh.train (parallel/dist.py::step_role)."""
        with dist.step_role("train"):
            return self._train_step(state, batch)

    def _train_step(self, state: ModelState, batch: Batch) -> TrainOut:
        p = self.params
        batch = widen_batch(batch)
        ids_phys, rt, rows, bias_w = self._lookups(state, batch)
        # (g, g^2) apart for the scatter's forms and the routed update,
        # combined for the touched-rows kernel's
        split = rt is not None or self.form in ("accumulator", "inplace")
        logits, gs, payload, lane = self.model.forward(state, batch, rows, bias_w, True, split)
        per_loss = binary_logloss(logits, batch.y) * batch.sample_w
        # the bias's sums, the loss and the count, summed over the batch
        # axes in one all_reduce (and the route drops)
        parts = [gs.sum(), (gs * gs).sum(), per_loss.sum(), batch.sample_w.sum()]
        if rt is not None:
            parts.append(rt.overflow.to(torch.float32))
        with tracing.span("mesh.sums"):
            sums = dist.all_reduce(torch.stack(parts), self.batch_group)
        bias_n, bias_z = ftrl_accumulate(state.bias_n, state.bias_z, bias_w, sums[0], sums[1], p)
        self._update(state, ids_phys, rt, payload, lane, gs[:, None] * batch.vals)
        state.bias_n.copy_(bias_n)
        state.bias_z.copy_(bias_z)
        count = sums[3]
        # inert (fully padded) global batches do not count as steps
        state.step.add_((count > 0).to(torch.int32))
        overflow = sums[4] if rt is not None else count.new_zeros(())
        return TrainOut(state, logits, sums[2], count, overflow)

    def eval_step(self, state: ModelState, batch: Batch, bins: int = 0):
        """(loss_sum, count, local logits, route drops or None, pos, neg)
        of one eval slice, the sums over the batch axes in one all_reduce:
        with bins > 0 the AUC histograms (metrics.py::StreamingAUC.
        bucket_counts) too, else pos and neg are None (Model.eval_step's
        shape).  Its collectives count under mesh.eval (parallel/dist.py::
        step_role)."""
        with dist.step_role("eval"):
            return self._eval_step(state, batch, bins)

    def _eval_step(self, state: ModelState, batch: Batch, bins: int):
        batch = widen_batch(batch)
        _, rt, rows, bias_w = self._lookups(state, batch)
        logits = self.model.forward(state, batch, rows, bias_w, train=False)[0]
        per_loss = binary_logloss(logits, batch.y) * batch.sample_w
        parts = [per_loss.sum()[None], batch.sample_w.sum()[None]]
        if rt is not None:
            parts.append(rt.overflow.to(torch.float32)[None])
        if bins:
            parts += list(StreamingAUC.bucket_counts(logits, batch.y, batch.sample_w, bins))
        with tracing.span("mesh.sums"):
            sums = dist.all_reduce(torch.cat(parts), self.batch_group)
        k = 3 if rt is not None else 2
        pos = neg = None
        if bins:
            pos, neg = sums[k : k + bins], sums[k + bins :]
        return sums[0], sums[1], logits, (sums[2] if rt is not None else None), pos, neg
