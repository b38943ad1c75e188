"""The FTRL table updates of a train step on the card: csrc/ftrl_update.cu
and csrc/ftrl_pass.cu.

Every entry point updates the given tables IN PLACE.  For CUDA tensors it
launches its hand-written kernel or raises; for CPU tensors it runs the
plain PyTorch version (ftrl.py) and copies the result into the tables.
Each kernel's wrapper counts its launches in its `launches` attribute, and
by the dtypes of the kernel instance that ran in `launches_by_dtype`.

- `ftrl_update`: one step's combined (g || g^2) payload applied to the
  factor and linear tables, the arguments of
  ftrl_ffm_tpu/ftrl.py::dense_ftrl_update2_aug, or the same step from a
  split payload, the pair (g, g^2) of f32 [N, E] tensors read where they
  lie (a (1, N) route mesh's received slots, parallel/sharded.py::
  _update_routed; on the card the kernels' split instances, the same bits
  as the combined launch of the concatenated pair).  With no dead lane
  (`lane` = -1, a row of exactly n_fields * n_factors slots) the linear
  stats come from their own [N, 2] payload `gg2_lin`, as in
  ftrl_ffm_tpu/models/base.py's separate linear update.  On the card it is
  the deterministic touched-rows kernel for every update kind ("dense2" and
  "sparse2" differ only in their plain versions): rows of more than 32
  columns on ftrl_update_kernel, narrower ones (FM's 16) on
  ftrl_update_narrow; an id with more than 64 payload rows (kHotRows there:
  one id in most rows of a batch) is summed split by columns in a second
  kernel, with the same bits.  `ftrl_update_linear` is the same launch on
  the linear tables alone (E = 0: LR's update).
- `ftrl_update_inplace`: the huge-table form
  (ftrl_ffm_tpu/ftrl.py::dense_ftrl_update_inplace) from a split payload:
  `za_scatter` (z += sum g, A = sum g^2 per touched row) into a zeroed
  accumulator, then `closed_form_pass` (the port of
  ftrl_ffm_tpu/ops/ftrl_pallas.py::_pass_kernel) over the whole table.
  `_inplace_step` runs it and then, when given, the linear tables' own
  update from one stable sort of the ids (models/base.py's in-place step).
  It runs where the update kind is "inplace" (update_mode=inplace: the
  port's auto never picks it), on one device and on a mesh of one data
  rank, replicate or route.

The update and the scatter read the ids sorted stably (one torch.sort a
launch, one for both launches of `_inplace_step`), so the occurrences of
one id form a segment in ascending payload order, which fixes the order
of its float sums.  Their `launches_by_instance` counts each launch by
the kernel instance its launcher picked from E and alignment: "rows",
"narrow", "linear" (the update at E = 0) or "scalar"; every launch but a
scalar one also launches the column-split kernel for the long segments.

The factor weight table vec_w is f32 or bf16 (Config.table_dtype), and
ftrl_update's combined payload f32 or bf16 (Config.acc_dtype, summed in a
bf16 accumulator as the JAX package does); every other table and payload
is f32.  A bf16 form launches its own instance of the kernel, never the f32
one on widened copies.
"""

from __future__ import annotations

import ctypes

import torch

from ftrl_ffm_tpu_torch.ftrl import (
    FtrlParams,
    _row_sums,
    closed_form_pass_plain,
    dense_ftrl_update2,
    dense_ftrl_update2_aug,
    dense_ftrl_update_inplace,
    sparse_ftrl_update2,
)
from ftrl_ffm_tpu_torch.ops.ffm_cuda import _check_inputs, _device_kind


def _f32_or_bf16(what: str, name: str, t: torch.Tensor) -> torch.dtype:
    """The dtype of a tensor that may be f32 or bf16; raises for others."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: {name} is {t.dtype}, expect torch.float32 or torch.bfloat16")
    return t.dtype


def _check_lane(lane: int, width: int, gg2_lin) -> None:
    if lane >= width:
        raise ValueError(f"ftrl_update: lane {lane} outside the row of {width}")
    if (lane >= 0) == (gg2_lin is not None):
        raise ValueError(
            "ftrl_update: give the linear stats either in a dead lane "
            "(lane >= 0) or as gg2_lin (lane = -1), not both or neither"
        )


def _copy_into(tables, results) -> None:
    for dst, src in zip(tables, results):
        dst.copy_(src)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _short(t) -> str:
    """"bf16" for a bf16 tensor, else "f32" (also for an absent one: the
    kernel's f32 instance takes it)."""
    return "bf16" if t is not None and t.dtype == torch.bfloat16 else "f32"


def ftrl_update_plain(
    vec_n, vec_z, vec_w, lin_n, lin_z, lin_w, ids, gg2, lane: int, p: FtrlParams,
    gg2_lin=None, sparse: bool = False,
):
    """Plain PyTorch version: ((vec_n, vec_z, vec_w), (lin_n, lin_z, lin_w))
    after the step, as new tensors (the inputs are left as they were).
    sparse=True is the "sparse2" kind as ftrl_ffm_tpu/models/base.py runs
    it under update_mode=sparse: sparse_ftrl_update2 on the factor tables
    and on the linear ones (from the payload's lane, or gg2_lin).  (Where
    auto picks "sparse2" for the factor tables only, JAX gives the linear
    tables the dense update: on a 1-D table both give the same bits.)"""
    _check_lane(lane, vec_n.shape[-1], gg2_lin)
    if sparse:
        d = vec_n.shape[-1]
        if lane >= 0:
            gg2_lin = torch.stack([gg2[:, lane], gg2[:, d + lane]], dim=-1)
        return (
            sparse_ftrl_update2(vec_n, vec_z, vec_w, ids, gg2, p),
            sparse_ftrl_update2(lin_n, lin_z, lin_w, ids, gg2_lin, p),
        )
    if lane >= 0:
        return dense_ftrl_update2_aug(
            vec_n, vec_z, vec_w, lin_n, lin_z, lin_w, ids, gg2, lane, p
        )
    return (
        dense_ftrl_update2(vec_n, vec_z, vec_w, ids, gg2, p),
        dense_ftrl_update2(lin_n, lin_z, lin_w, ids, gg2_lin, p),
    )


def _sort(ids):
    """(sids, perm): the ids sorted stably, so a row's payload rows stay in
    ascending order, which fixes the order of its float sums."""
    return torch.sort(ids, stable=True)


def _hot_list(lib, n: int, device) -> torch.Tensor:
    """The scratch of a launch: the list of segments too long for the main
    kernel, which it fills and the column-split kernel reads (a count,
    zeroed by the launcher on the stream, then starts)."""
    return torch.empty(lib.ftrl_update_scratch_ints(n), dtype=torch.int32, device=device)


def _split(gg2):
    """(g, g2) of a split payload pair (g, g2); (gg2, None) of a combined
    payload or of None."""
    return tuple(gg2) if isinstance(gg2, (tuple, list)) else (gg2, None)


def _launch_update(what, ids, gg2, gg2_lin, tables, r: int, e: int, lane: int, p,
                   order=None) -> None:
    """Launch csrc/ftrl_update.cu's update on the six tables (the factor
    ones None when e = 0) from the combined payload gg2 or a split pair
    (g, g2), from `order` = _sort(ids) or, when None, a sort of its own."""
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    n = ids.shape[0]
    if n == 0:
        return
    g, g2 = _split(gg2)
    sids, perm = _sort(ids) if order is None else order
    hot = _hot_list(lib, n, ids.device)
    instance = ctypes.c_int(-1)  # the launcher writes the instance it picks
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    dtypes = _short(g), _short(tables[2])  # the payload's and vec_w's
    with torch.cuda.device(ids.device):
        code = lib.ftrl_update_launch(
            sids.data_ptr(), perm.data_ptr(), n, ptr(g), ptr(g2), e, int(g2 is not None),
            ptr(gg2_lin), *(ptr(t) for t in tables), r, e, lane,
            *(int(d == "bf16") for d in dtypes), p.alpha, p.beta, p.l1, p.l2, hot.data_ptr(),
            ctypes.byref(instance), _stream(ids),
        )
    _build.check(code, what)
    ftrl_update.launches += 1
    ftrl_update.launches_by_dtype["/".join(dtypes)] += 1
    ftrl_update.launches_by_instance[UPDATE_INSTANCES[instance.value]] += 1


def ftrl_update(
    vec_n: torch.Tensor,  # [R, E] f32, updated in place
    vec_z: torch.Tensor,
    vec_w: torch.Tensor,  # f32 or bf16
    lin_n: torch.Tensor,  # [R] f32, updated in place
    lin_z: torch.Tensor,
    lin_w: torch.Tensor,
    ids: torch.Tensor,    # [N] int32 payload row ids; ids outside [0, R) drop
    gg2: torch.Tensor | tuple[torch.Tensor, torch.Tensor],
                          # [N, 2E] f32 or bf16 combined payload, or the
                          # split pair (g, g2) of [N, E] f32 tensors
    lane: int,            # the payload's linear lane, or -1
    p: FtrlParams,
    gg2_lin: torch.Tensor | None = None,  # [N, 2] f32 when lane == -1
    sparse: bool = False,  # the "sparse2" kind's plain version on the CPU
) -> None:
    """One FTRL step on the factor and linear tables, in place.  The same
    input gives the same bits on every run, in either payload layout."""
    tables = (vec_n, vec_z, vec_w, lin_n, lin_z, lin_w)
    g, g2 = _split(gg2)
    if _device_kind("ftrl_update", vec_n) == "cpu":
        combined = g if g2 is None else torch.cat([g, g2], dim=-1)
        vec, lin = ftrl_update_plain(*tables, ids, combined, lane, p, gg2_lin, sparse)
        _copy_into(tables, (*vec, *lin))
        return
    r, e = vec_n.shape
    n = ids.shape[0]
    _check_lane(lane, e, gg2_lin)
    w_dtype = _f32_or_bf16("ftrl_update", "vec_w", vec_w)
    payload = (
        [("gg2", g, (n, 2 * e), _f32_or_bf16("ftrl_update", "gg2", g))] if g2 is None
        else [("g", g, (n, e), torch.float32), ("g2", g2, (n, e), torch.float32)]
    )
    specs = [
        *((name, t, (r, e), dtype)
          for name, t, dtype in zip(("vec_n", "vec_z", "vec_w"), tables[:3],
                                    (torch.float32, torch.float32, w_dtype))),
        *((name, t, (r,), torch.float32)
          for name, t in zip(("lin_n", "lin_z", "lin_w"), tables[3:])),
        ("ids", ids, (n,), torch.int32),
        *payload,
    ]
    if gg2_lin is not None:
        specs.append(("gg2_lin", gg2_lin, (n, 2), torch.float32))
    _check_inputs("ftrl_update", vec_n, specs)
    _launch_update("ftrl_update_launch", ids, gg2, gg2_lin, tables, r, e, lane, p)


def ftrl_update_linear(
    lin_n: torch.Tensor,    # [R] f32, updated in place
    lin_z: torch.Tensor,
    lin_w: torch.Tensor,
    ids: torch.Tensor,      # [N] int32; ids outside [0, R) drop
    gg2_lin: torch.Tensor,  # [N, 2] f32: (g, g^2) of the linear gradient
    p: FtrlParams,
) -> None:
    """The step of the linear tables alone, in place: LR's whole update,
    and the separate linear update of ftrl_ffm_tpu/models/base.py's
    huge-table path when no dead lane mirrors them.  On the card it is
    ftrl_update's launch with no factor tables (the "linear" instance), on
    the CPU dense_ftrl_update2: on a 1-D table the JAX package's dense and
    sparse steps give the same bits, so one step serves either kind.  Its
    launches count in ftrl_update.launches."""
    _update_linear(lin_n, lin_z, lin_w, ids, gg2_lin, p)


def _update_linear(lin_n, lin_z, lin_w, ids, gg2_lin, p, order=None) -> None:
    """ftrl_update_linear, from `order` = _sort(ids) when given."""
    tables = (lin_n, lin_z, lin_w)
    if _device_kind("ftrl_update_linear", lin_n) == "cpu":
        _copy_into(tables, dense_ftrl_update2(*tables, ids, gg2_lin, p))
        return
    r, n = lin_n.shape[0], ids.shape[0]
    _check_inputs("ftrl_update_linear", lin_n, [
        *((name, t, (r,), torch.float32)
          for name, t in zip(("lin_n", "lin_z", "lin_w"), tables)),
        ("ids", ids, (n,), torch.int32),
        ("gg2_lin", gg2_lin, (n, 2), torch.float32),
    ])
    _launch_update(
        "ftrl_update_launch (linear)", ids, None, gg2_lin, (None, None, None, *tables),
        r, 0, -1, p, order,
    )


def za_scatter_plain(z, ids, g, g2):
    """Plain PyTorch version of the scatter: (z + per-row sum of g, per-row
    sum of g^2) as new tensors, ids outside [0, R) dropped."""
    r = z.shape[0]
    return z + _row_sums(r, ids, g), _row_sums(r, ids, g2)


def za_scatter(
    z: torch.Tensor,    # [R, E] f32: z += per-row sum of g, in place
    a: torch.Tensor,    # [R, E] f32, zero on every row no id touches
    ids: torch.Tensor,  # [N] int32; ids outside [0, R) drop
    g: torch.Tensor,    # [N, E] f32
    g2: torch.Tensor,   # [N, E] f32
) -> None:
    """The z/A scatter of the in-place update (XLA's two scatter-adds at
    ftrl_ffm_tpu/ftrl.py::dense_ftrl_update_inplace), deterministic: the
    ids sorted stably, then csrc/ftrl_update.cu's za_scatter kernels add
    each touched row's sum of g to z and write its sum of g^2 to a (rows
    of more than 32 columns on za_scatter_rows, narrower ones on
    za_scatter_narrow, segments over 64 rows on za_scatter_hot)."""
    _scatter(z, a, ids, g, g2)


def _scatter(z, a, ids, g, g2, order=None) -> None:
    """za_scatter, from `order` = _sort(ids) when given."""
    if _device_kind("za_scatter", z) == "cpu":
        _copy_into((z, a), za_scatter_plain(z, ids, g, g2))
        return
    r, e = z.shape
    n = ids.shape[0]
    _check_inputs("za_scatter", z, (
        ("z", z, (r, e), torch.float32),
        ("a", a, (r, e), torch.float32),
        ("ids", ids, (n,), torch.int32),
        ("g", g, (n, e), torch.float32),
        ("g2", g2, (n, e), torch.float32),
    ))
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    if n == 0 or e == 0:
        return
    sids, perm = _sort(ids) if order is None else order
    hot = _hot_list(lib, n, z.device)
    instance = ctypes.c_int(-1)
    with torch.cuda.device(z.device):
        code = lib.za_scatter_launch(
            sids.data_ptr(), perm.data_ptr(), n, g.data_ptr(), g2.data_ptr(),
            z.data_ptr(), a.data_ptr(), r, e, hot.data_ptr(), ctypes.byref(instance), _stream(z),
        )
    _build.check(code, "za_scatter_launch")
    za_scatter.launches += 1
    za_scatter.launches_by_instance[SCATTER_INSTANCES[instance.value]] += 1


def closed_form_pass(
    n: torch.Tensor,  # [R, E] f32 (any shape, all four alike), in place
    z: torch.Tensor,  # z' = z + sum g on entry, the new z on return
    w: torch.Tensor,  # f32 or bf16
    a: torch.Tensor,  # sum g^2, read only
    p: FtrlParams,
) -> None:
    """The closed-form pass over whole tables, in place: the port of
    ftrl_ffm_tpu/ops/ftrl_pallas.py::_pass_kernel (csrc/ftrl_pass.cu),
    for any table shape, with an f32 or a bf16 w."""
    if _device_kind("closed_form_pass", n) == "cpu":
        _copy_into((n, z, w), closed_form_pass_plain(n, z, w, a, p))
        return
    shape = tuple(n.shape)
    w_dtype = _f32_or_bf16("closed_form_pass", "w", w)
    _check_inputs("closed_form_pass", n, [
        (name, t, shape, dtype) for name, t, dtype in (
            ("n", n, torch.float32), ("z", z, torch.float32), ("w", w, w_dtype),
            ("a", a, torch.float32))
    ])
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    if n.numel() == 0:
        return
    with torch.cuda.device(n.device):
        code = lib.ftrl_pass_launch(
            n.data_ptr(), z.data_ptr(), w.data_ptr(), a.data_ptr(), n.numel(),
            int(w_dtype == torch.bfloat16), p.alpha, p.beta, p.l1, p.l2, _stream(n),
        )
    _build.check(code, "ftrl_pass_launch")
    closed_form_pass.launches += 1
    closed_form_pass.launches_by_dtype[_short(w)] += 1


def ftrl_update_inplace(
    vec_n: torch.Tensor,  # [R, E] f32, updated in place
    vec_z: torch.Tensor,
    vec_w: torch.Tensor,  # f32 or bf16
    ids: torch.Tensor,    # [N] int32; ids outside [0, R) drop
    g: torch.Tensor,      # [N, E] f32 split payload
    g2: torch.Tensor,     # [N, E] f32
    p: FtrlParams,
) -> None:
    """The huge-table FTRL step on the factor tables, in place
    (ftrl_ffm_tpu/ftrl.py::dense_ftrl_update_inplace).  On the card: a
    zeroed [R, E] accumulator A each step, za_scatter, closed_form_pass."""
    _inplace_step(vec_n, vec_z, vec_w, ids, g, g2, p)


def _inplace_step(vec_n, vec_z, vec_w, ids, g, g2, p, lin_tables=None, gg2_lin=None) -> None:
    """ftrl_update_inplace on the factor tables, then, with lin_tables,
    ftrl_update_linear on them from gg2_lin: FM's in-place step.  On the
    card both launches read one stable sort of the ids."""
    if _device_kind("ftrl_update_inplace", vec_n) == "cpu":
        _copy_into(
            (vec_n, vec_z, vec_w), dense_ftrl_update_inplace(vec_n, vec_z, vec_w, ids, g, g2, p)
        )
        if lin_tables is not None:
            _update_linear(*lin_tables, ids, gg2_lin, p)
        return
    order = _sort(ids)
    a = torch.zeros_like(vec_n)
    _scatter(vec_z, a, ids, g, g2, order)
    closed_form_pass(vec_n, vec_z, vec_w, a, p)
    if lin_tables is not None:
        _update_linear(*lin_tables, ids, gg2_lin, p, order)


# Kernel launches since the count was last set to 0 (chip_smoke.py reads
# them to show that the training path went through the kernels).
ftrl_update.launches = 0
za_scatter.launches = 0
closed_form_pass.launches = 0
# the same launches by the dtypes of the kernel instance that ran: the
# update kernel's "<payload>/<vec_w>" and the pass's w, "f32" or "bf16"
ftrl_update.launches_by_dtype = {
    f"{a}/{b}": 0 for a in ("f32", "bf16") for b in ("f32", "bf16")
}
closed_form_pass.launches_by_dtype = {"f32": 0, "bf16": 0}
# the same launches by kernel instance (the launchers' UpdateInstance and
# ScatterInstance, in order)
UPDATE_INSTANCES = ("rows", "narrow", "linear", "scalar")
SCATTER_INSTANCES = ("rows", "narrow", "scalar")
ftrl_update.launches_by_instance = dict.fromkeys(UPDATE_INSTANCES, 0)
za_scatter.launches_by_instance = dict.fromkeys(SCATTER_INSTANCES, 0)
