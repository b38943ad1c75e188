"""FTRL-Proximal core: closed form, accumulator step, the dense table
updates and the choice of update form (the dense half of
ftrl_ffm_tpu/ftrl.py).

Closed form (reference: src/include/model/ftrl_model.h:28-33):

    w = 0                                             if |z| <= l1
    w = -(z - sgn(z) * l1) / (l2 + (beta + sqrt(n)) / alpha)   otherwise

Accumulator step for a batch-aggregated gradient (reference, per sample:
src/model/ftrl_model.cpp:66-77):

    sigma = (sqrt(n + sum_g2) - sqrt(n)) / alpha
    z    += sum_g - sigma * w
    n    += sum_g2

The table updates here are the plain PyTorch versions of the JAX package's
three forms: the dense one (the combined (g || g^2) payload summed per row
into a zeroed accumulator, the closed form over the whole table), the
in-place huge-table one (g summed straight into z, g^2 into one
accumulator A, then the closed-form pass) and the sparse one (the closed
form on the touched rows only).  They are the ground truth the CUDA kernels
(ops/ftrl_cuda.py) are held against, and what the wrappers run for CPU
tensors.  Like the JAX functions they return new tensors and leave their
inputs as they were.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FtrlParams(NamedTuple):
    """Static FTRL hyper-parameters."""

    alpha: float = 1e-4
    beta: float = 1.0
    l1: float = 0.1
    l2: float = 5.0


# "Has this coordinate ever been touched by a real gradient?" — the same
# threshold as ftrl_ffm_tpu/ftrl.py::UNTOUCHED_N, whose comment gives the
# reason (cancellation dust on untouched slots stays far below it).
UNTOUCHED_N = 1e-16


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, correctly rounded on every device.  On a CUDA tensor torch
    divides by a Python number by multiplying with its reciprocal (up to an
    ulp off), and 1 / alpha magnifies that ulp in sigma * w; a 0-dim divisor
    on x's device makes it a true division, as on the CPU, in JAX and in
    the CUDA kernels."""
    return x / x.new_full((), s)


def ftrl_weights(n: torch.Tensor, z: torch.Tensor, p: FtrlParams) -> torch.Tensor:
    """Closed-form FTRL-Proximal weight from accumulators, elementwise
    (ftrl_ffm_tpu/ftrl.py::ftrl_weights).  sgn(z) is only read where
    |z| > l1 >= 0, so its value at 0 never matters."""
    sgn_z = torch.where(z > 0, 1.0, -1.0).to(z.dtype)
    w = -(z - sgn_z * p.l1) / (p.l2 + _div(p.beta + torch.sqrt(n), p.alpha))
    return torch.where(torch.abs(z) <= p.l1, torch.zeros_like(w), w)


def ftrl_accumulate(n, z, w, sum_g, sum_g2, p: FtrlParams):
    """One accumulator step given batch-aggregated g and g^2
    (ftrl_ffm_tpu/ftrl.py::ftrl_accumulate).  `w` is the weight the
    gradients were computed against: the pre-update stored weight."""
    sigma = _div(torch.sqrt(n + sum_g2) - torch.sqrt(n), p.alpha)
    return n + sum_g2, z + sum_g - sigma * w


def bias_update(bias_n, bias_z, grad_per_sample, p: FtrlParams):
    """FTRL step on the global bias (ftrl_ffm_tpu/ftrl.py::bias_update;
    reference: src/model/ftrl_model.cpp:79-85).  grad_per_sample: [B]
    dL/dlogit, already masked for padding."""
    w = ftrl_weights(bias_n, bias_z, p)
    sum_g = torch.sum(grad_per_sample)
    sum_g2 = torch.sum(grad_per_sample * grad_per_sample)
    return ftrl_accumulate(bias_n, bias_z, w, sum_g, sum_g2, p)


def _segment_sums(n_out: int, slot: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[n_out, D] sums of the payload rows by slot (int64, every slot in
    [0, n_out)), in the payload's dtype.  An f32 payload sums through
    index_add_.  A bf16 payload sums as the JAX package's bf16 scatter-add
    does on its CPU: into a bf16 accumulator, rounded after every add, each
    slot's rows in ascending payload order (index_add_ would sum in f32 and
    round once).  The rows are sorted stably by slot and ranked within
    their slot; step r adds every slot's r-th row, so no step touches a
    slot twice and the result is the same on every device."""
    acc = torch.zeros((n_out, rows.shape[-1]), dtype=rows.dtype, device=rows.device)
    if rows.dtype != torch.bfloat16:
        return acc.index_add_(0, slot, rows)
    if slot.numel() == 0:
        return acc
    sslot, perm = torch.sort(slot, stable=True)
    pos = torch.arange(sslot.numel(), device=slot.device)
    starts = torch.ones_like(sslot, dtype=torch.bool)
    starts[1:] = sslot[1:] != sslot[:-1]
    rank = pos - torch.cummax(torch.where(starts, pos, 0), dim=0).values
    for r in range(int(rank.max()) + 1):
        at = rank == r
        dst, src = sslot[at], rows[perm[at]]
        acc[dst] = (acc[dst].float() + src.float()).to(torch.bfloat16)
    return acc


def _row_sums(n_rows: int, ids: torch.Tensor, gg2: torch.Tensor) -> torch.Tensor:
    """[n_rows, 2D] per-row sums of the payload rows (_segment_sums: f32,
    or a bf16 accumulator for a bf16 payload).  Ids outside [0, n_rows) —
    the padding sentinel n_feats — are dropped, as by the JAX scatter's
    mode="drop"."""
    ids = ids.reshape(-1).to(torch.int64)
    keep = (ids >= 0) & (ids < n_rows)
    return _segment_sums(n_rows, ids[keep], gg2[keep])


def _closed_step(n, z, w, sum_g, sum_g2, p: FtrlParams):
    """Accumulator step, then the closed form where the coordinate has been
    touched; untouched coordinates keep their stored weight (the init under
    keep_init semantics).  A bf16 w table or bf16 sums are widened to n's
    f32 first, and the new w is rounded to w's dtype at the store (the JAX
    package's w.astype(n.dtype) ... new_w.astype(w.dtype))."""
    wf = w.to(n.dtype)
    new_n, new_z = ftrl_accumulate(n, z, wf, sum_g.to(n.dtype), sum_g2.to(n.dtype), p)
    new_w = torch.where(new_n > UNTOUCHED_N, ftrl_weights(new_n, new_z, p), wf)
    return new_n, new_z, new_w.to(w.dtype)


def dense_ftrl_update2(n_tab, z_tab, w_tab, ids, gg2, p: FtrlParams):
    """One batched FTRL step over a whole (n, z, w) table from a combined
    payload (ftrl_ffm_tpu/ftrl.py::dense_ftrl_update2).

    Tables [R] or [R, D]; gg2 [N, 2D] with g in lanes [:D] and g^2 in [D:]
    ([N, 2] for a 1-D table); ids [N]."""
    acc = _row_sums(n_tab.shape[0], ids, gg2)
    d = gg2.shape[-1] // 2
    if n_tab.dim() == 1:
        sum_g, sum_g2 = acc[:, 0], acc[:, 1]
    else:
        sum_g, sum_g2 = acc[:, :d], acc[:, d:]
    return _closed_step(n_tab, z_tab, w_tab, sum_g, sum_g2, p)


def dense_ftrl_update2_aug(
    vec_n, vec_z, vec_w, lin_n, lin_z, lin_w, ids, gg2, lane: int, p: FtrlParams
):
    """One payload updates the factor AND the linear tables
    (ftrl_ffm_tpu/ftrl.py::dense_ftrl_update2_aug): lane `lane` of gg2's
    factor block (and D + lane of its squared block) carries the linear
    gradient.  The factor closed form also runs on that lane, on purpose:
    it keeps the dead-lane mirror of the linear table.

    Returns ((vec_n, vec_z, vec_w), (lin_n, lin_z, lin_w))."""
    acc = _row_sums(vec_n.shape[0], ids, gg2)
    d = gg2.shape[-1] // 2
    vec = _closed_step(vec_n, vec_z, vec_w, acc[:, :d], acc[:, d:], p)
    lin = _closed_step(lin_n, lin_z, lin_w, acc[:, lane], acc[:, d + lane], p)
    return vec, lin


def closed_form_pass_plain(n, z_prime, w, a, p: FtrlParams):
    """The closed-form pass of the in-place update over whole tables
    (the body of ftrl_ffm_tpu/ops/ftrl_pallas.py::_pass_kernel, and of
    ftrl_ffm_tpu/ftrl.py::dense_ftrl_update_inplace's blk()):

        sigma = (sqrt(n + A) - sqrt(n)) / alpha
        z     = z' - sigma * w          (z' already holds z + sum_g)
        n     = n + A
        w     = closed form (n, z)  where n > UNTOUCHED_N, else w

    A bf16 w is widened before the math and the new w rounded to bf16 at
    the store.  Returns the new (n, z, w)."""
    a = a.to(n.dtype)
    wf = w.to(n.dtype)
    sigma = _div(torch.sqrt(n + a) - torch.sqrt(n), p.alpha)
    new_z = z_prime - sigma * wf
    new_n = n + a
    new_w = torch.where(new_n > UNTOUCHED_N, ftrl_weights(new_n, new_z, p), wf)
    return new_n, new_z, new_w.to(w.dtype)


def dense_ftrl_update_inplace(n_tab, z_tab, w_tab, ids, g, g2, p: FtrlParams):
    """The huge-table update (ftrl_ffm_tpu/ftrl.py::dense_ftrl_update_inplace)
    from a split payload g, g2 [N, D]: z' = z + per-row sum of g, A = per-row
    sum of g^2 (ids outside [0, R) dropped), then the closed-form pass.  The
    JAX form adds each g into z in turn; this one adds the row's sum, as
    the CUDA scatter does.  Returns the new (n, z, w)."""
    r = n_tab.shape[0]
    z_prime = z_tab + _row_sums(r, ids, g)
    return closed_form_pass_plain(n_tab, z_prime, w_tab, _row_sums(r, ids, g2), p)


def sparse_ftrl_update2(n_tab, z_tab, w_tab, ids, gg2, p: FtrlParams):
    """One batched FTRL step on the touched rows only
    (ftrl_ffm_tpu/ftrl.py::sparse_ftrl_update2): the combined payload summed
    per distinct id, the accumulator step and closed form on those rows,
    every other row left as it was.  Tables [R] or [R, D]; gg2 [N, 2D]
    ([N, 2] for a 1-D table).  Returns the new (n, z, w)."""
    r = n_tab.shape[0]
    ids = ids.reshape(-1).to(torch.int64)
    keep = (ids >= 0) & (ids < r)
    rows, slot = torch.unique(ids[keep], return_inverse=True)
    sums = _segment_sums(rows.shape[0], slot, gg2[keep])
    d = gg2.shape[-1] // 2
    if n_tab.dim() == 1:
        sum_g, sum_g2 = sums[:, 0], sums[:, 1]
    else:
        sum_g, sum_g2 = sums[:, :d], sums[:, d:]
    new = _closed_step(n_tab[rows], z_tab[rows], w_tab[rows], sum_g, sum_g2, p)
    out = []
    for tab, rows_new in zip((n_tab, z_tab, w_tab), new):
        tab = tab.clone()
        tab[rows] = rows_new
        out.append(tab)
    return tuple(out)


def update_form(cfg, rows: int, mesh_data: int = 1, route: bool = False) -> str:
    """The table update that a step of `cfg` runs on its `rows`-row table
    (one device: n_feats; a mesh: the rank's shard), on a mesh of
    `mesh_data` data ranks with routed lookups or not.  The one decision
    of the form: the step objects hold it (Model.form,
    parallel/sharded.py::ShardedStep.form).

    Where no data replica shares the table (one device, or D = 1) the form
    is a one-device kind: "dense2" (the touched-rows update from the
    combined payload), "sparse2" (the same kernel on the card; on the CPU
    the plain segment-sum form the tests hold against the JAX package) or
    "inplace" (the z/A scatter and the closed-form pass over the whole
    table).  The modes are ftrl_ffm_tpu/ftrl.py::select_update_kind's;
    "auto" differs by design.  JAX's auto picks "inplace" for tables over
    4 x nnz rows (or a 2 GB accumulator) up to 4 GB, since its "dense2"
    scatters into an [R, 2D] accumulator and passes over every row.  The
    port's "dense2" updates only the rows a batch touches, with no
    table-shaped accumulator (ops/ftrl_cuda.py::ftrl_update), and beat
    "inplace" with the same bits at every shape measured on the card
    (PERF.md section 6: FFM at 1M and 4M rows, FM at 2^22), so auto takes
    "dense2" up to 4 GB and "sparse2" beyond, as JAX does.  A (1, N) route
    mesh's owner runs the same kind on the slots it receives.

    Where data replicas share the shard (D > 1) their sums must be
    combined over "data", and the reason for the port's moved threshold no
    longer holds; there the rule is JAX's select_ftrl_update2(rows,
    row_width, global nnz, update_mode): "accumulator" (a [rows, 2E] sum
    all_reduced over "data"; every routed update) under update_mode=dense
    or inplace, and under auto while the shard holds at most 4x the global
    nnz and the accumulator at most 2 GB; "allgather" (the (ids, payload)
    stream all_gathered over "data", then "sparse2" on the local rows)
    under update_mode=sparse and beyond those bounds."""
    mode, width = cfg.update_mode, cfg.row_width
    if mesh_data > 1:
        if route or mode in ("dense", "inplace"):
            return "accumulator"
        nnz = cfg.batch_size * max(1, cfg.max_nnz)
        d = max(1, width)
        if mode == "auto" and rows <= 4 * nnz and 2 * rows * d * 4 <= (2 << 30):
            return "accumulator"
        return "allgather"
    if mode == "dense":
        return "dense2"
    if mode == "sparse":
        return "sparse2"
    if mode == "inplace":
        return "inplace" if width else "dense2"
    if rows * max(1, width) * 4 <= (4 << 30):
        return "dense2"
    return "sparse2"
