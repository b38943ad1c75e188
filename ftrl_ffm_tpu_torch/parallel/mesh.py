"""The ("data", "model") process grid and the placement of a state on it
(ftrl_ffm_tpu/parallel/mesh.py).

A mesh of D x M devices is a process group of D * M ranks, one device
each.  Rank r sits at data coordinate r // M and model coordinate r % M:
the row-major order of the JAX package's grid.reshape(data, model).  The
two axes are torch.distributed.device_mesh's, named "data" and "model",
whose groups stand in for the JAX axis names.

Feature tables are row-sharded over "model" with modulo-interleaved
placement (interleave_ids): feature id i lives on model rank i % M at
local row i // M.  Each rank keeps its own contiguous physical block of
rows_local rows; bias_* and step are replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ftrl_ffm_tpu_torch import tracing
from ftrl_ffm_tpu_torch.models.base import Model, ModelState
from ftrl_ffm_tpu_torch.parallel import dist

_TABLES = ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w")


class Mesh(NamedTuple):
    """This rank's view of the grid: the axis sizes, its rank and device,
    and the groups of its data and model axes (None on the CPU-free
    paths that build no groups)."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: object
    model_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(data: int = 0, model: int = 1, device: str = "cuda") -> Mesh:
    """The ("data", "model") grid over the run's ranks (a group of one when
    no group was joined: parallel/dist.py::ensure_group).  data == 0 means
    every rank left over on the data axis.  The grid spans every rank of
    the group: one process drives one device."""
    dist.ensure_group(device)
    rank, world = dist.world()
    if model < 1:
        raise ValueError(f"mesh_model must be >= 1, got {model}")
    if data <= 0:
        if world % model:
            raise ValueError(f"{world} devices not divisible by model={model}")
        data = world // model
    n = data * model
    if n > world:
        raise ValueError(
            f"need {n} devices, have {world} (one process a device: start "
            f"{n} with --coordinator_address/--num_processes/--process_id)"
        )
    if n < world:
        raise ValueError(f"a {data} x {model} mesh leaves {world - n} of {world} ranks idle")
    dev = dist.rank_device(device)
    from torch.distributed.device_mesh import init_device_mesh

    grid = init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
    return Mesh(data, model, rank, dev, grid.get_group("data"), grid.get_group("model"))


def rows_per_shard(n_rows: int, n_shards: int) -> int:
    return -(-n_rows // n_shards)


def padded_rows(n_rows: int, n_shards: int) -> int:
    """Table rows padded so every "model" shard holds an equal block."""
    return rows_per_shard(n_rows, n_shards) * n_shards


def interleave_ids(ids: torch.Tensor, n_shards: int, rows_local: int, n_feats: int):
    """Feature id -> physical table row: id % M * rows_local + id // M.
    Ids outside [0, n_feats) (the batch padding sentinel and out-of-range
    ids) map to the global drop sentinel M * rows_local; M = 1 is the
    identity on the valid ids."""
    ok = (ids >= 0) & (ids < n_feats)
    if n_shards == 1:
        return torch.where(ok, ids, rows_local)
    p = (ids % n_shards) * rows_local + torch.div(ids, n_shards, rounding_mode="floor")
    return torch.where(ok, p, n_shards * rows_local)


def _interleave_index(n_rows: int, n_shards: int) -> torch.Tensor:
    """inv[p] = the logical row at physical row p."""
    rl = n_rows // n_shards
    p = torch.arange(n_rows)
    return (p % rl) * n_shards + p // rl


def interleave_table(tab, n_shards: int):
    """Logical (id-ordered) table rows -> physical interleaved placement."""
    if tab is None or n_shards == 1:
        return tab
    return tab[_interleave_index(tab.shape[0], n_shards)]


def deinterleave_table(tab, n_shards: int):
    """Physical interleaved rows -> logical id order."""
    if tab is None or n_shards == 1:
        return tab
    ids = torch.arange(tab.shape[0])
    rl = tab.shape[0] // n_shards
    return tab[(ids % n_shards) * rl + ids // n_shards]


def pad_state_tables(state: ModelState, n_shards: int) -> ModelState:
    """Zero-pad table row counts to a multiple of the model-shard count.
    Padding rows sit past n_feats and are never addressed."""
    r = state.lin_n.shape[0]
    rp = padded_rows(r, n_shards)
    if rp == r:
        return state

    def pad(x):
        if x is None:
            return None
        return torch.cat([x, x.new_zeros((rp - r, *x.shape[1:]))])

    return state._replace(**{k: pad(getattr(state, k)) for k in _TABLES})


def shard_state(state: ModelState, mesh: Mesh) -> ModelState:
    """This rank's part of a logical state, on its device: the tables
    padded and interleaved, then the rank's contiguous block of rows_local
    physical rows (those of the ids i with i % M == model_index, in order
    of i, which is the strided view padded[model_index::M]); bias_* and
    step whole.  The only place that says which tables are row-sharded."""
    m, idx = mesh.model, mesh.model_index
    state = pad_state_tables(state, m)

    def place(name, x):
        if x is None:
            return None
        if name in _TABLES:
            x = x[idx::m]
        return x.to(mesh.device).contiguous()

    return ModelState(*(place(k, x) for k, x in state._asdict().items()))


def init_shard(model: Model, mesh: Mesh, generator: torch.Generator) -> ModelState:
    """This rank's part of a fresh init, drawn on the rank alone
    (Model.init's shard): shard_state(model.init(generator), mesh) to the
    bit, with no tensor of n_feats rows made.  Span "init.shard"; counter
    init.rows, the rows the rank holds."""
    with tracing.span("init.shard"):
        state = model.init(generator, shard=(mesh.model_index, mesh.model))
    tracing.count("init.rows", state.lin_n.shape[0])
    return state


def place_state(state: ModelState, mesh: Mesh, n_feats: int) -> ModelState:
    """A state on this rank: a logical state (n_feats rows) through
    shard_state, or one that already holds the rank's rows_local rows (on
    more than one model shard: init_shard's, a rank's own) moved to its
    device as it is."""
    rl = rows_per_shard(n_feats, mesh.model)
    if rl != n_feats and state.lin_n.shape[0] == rl:
        return ModelState(*(None if x is None else x.to(mesh.device).contiguous()
                            for x in state))
    return shard_state(state, mesh)


def unshard_state(state: ModelState, mesh: Mesh, n_feats: int) -> ModelState:
    """Every rank's shards -> the logical state (id row order, sliced to
    n_feats rows) as host tensors: an all-gather over the model group, then
    the de-interleave.  The inverse of shard_state, for tests and exports;
    the JAX package returns host numpy here, and the port its host tensor
    (a bf16 table included)."""

    def back(name, x):
        if x is None:
            return None
        if name in _TABLES:
            if mesh.model > 1:
                x = dist.all_gather(x.contiguous(), mesh.model_group)
            x = deinterleave_table(x.cpu(), mesh.model)[:n_feats]
        return x.cpu().contiguous()

    return ModelState(*(back(k, x) for k, x in state._asdict().items()))
