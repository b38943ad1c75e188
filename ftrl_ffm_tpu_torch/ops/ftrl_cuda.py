"""The FTRL table update of a train step on the card: csrc/ftrl_update.cu.

`ftrl_update` applies one step's combined (g || g^2) payload to the factor
and linear tables IN PLACE.  For CUDA tensors it sorts the ids stably and
launches the deterministic touched-rows kernel, or raises; for CPU tensors
it runs `ftrl_update_plain` (ftrl.py's dense forms) and copies the result
into the tables.  Both take the arguments of
ftrl_ffm_tpu/ftrl.py::dense_ftrl_update2_aug.  With no dead lane (`lane` =
-1, a row of exactly n_fields * n_factors slots) the linear stats come from
their own [N, 2] payload `gg2_lin`, as in ftrl_ffm_tpu/models/base.py's
separate linear update.
"""

from __future__ import annotations

import torch

from ftrl_ffm_tpu_torch.ftrl import (
    FtrlParams,
    dense_ftrl_update2,
    dense_ftrl_update2_aug,
)
from ftrl_ffm_tpu_torch.ops.ffm_cuda import _check_inputs, _device_kind


def _check_lane(lane: int, width: int, gg2_lin) -> None:
    if lane >= width:
        raise ValueError(f"ftrl_update: lane {lane} outside the row of {width}")
    if (lane >= 0) == (gg2_lin is not None):
        raise ValueError(
            "ftrl_update: give the linear stats either in a dead lane "
            "(lane >= 0) or as gg2_lin (lane = -1), not both or neither"
        )


def ftrl_update_plain(
    vec_n, vec_z, vec_w, lin_n, lin_z, lin_w, ids, gg2, lane: int, p: FtrlParams,
    gg2_lin=None,
):
    """Plain PyTorch version: ((vec_n, vec_z, vec_w), (lin_n, lin_z, lin_w))
    after the step, as new tensors (the inputs are left as they were)."""
    _check_lane(lane, vec_n.shape[-1], gg2_lin)
    if lane >= 0:
        return dense_ftrl_update2_aug(
            vec_n, vec_z, vec_w, lin_n, lin_z, lin_w, ids, gg2, lane, p
        )
    return (
        dense_ftrl_update2(vec_n, vec_z, vec_w, ids, gg2, p),
        dense_ftrl_update2(lin_n, lin_z, lin_w, ids, gg2_lin, p),
    )


def ftrl_update(
    vec_n: torch.Tensor,  # [R, E] f32, updated in place
    vec_z: torch.Tensor,
    vec_w: torch.Tensor,
    lin_n: torch.Tensor,  # [R] f32, updated in place
    lin_z: torch.Tensor,
    lin_w: torch.Tensor,
    ids: torch.Tensor,    # [N] int32 payload row ids; ids outside [0, R) drop
    gg2: torch.Tensor,    # [N, 2E] f32 combined payload
    lane: int,            # the payload's linear lane, or -1
    p: FtrlParams,
    gg2_lin: torch.Tensor | None = None,  # [N, 2] f32 when lane == -1
) -> None:
    """One FTRL step on the factor and linear tables, in place.  The same
    input gives the same bits on every run."""
    tables = (vec_n, vec_z, vec_w, lin_n, lin_z, lin_w)
    if _device_kind("ftrl_update", vec_n) == "cpu":
        vec, lin = ftrl_update_plain(*tables, ids, gg2, lane, p, gg2_lin)
        for dst, src in zip(tables, (*vec, *lin)):
            dst.copy_(src)
        return
    r, e = vec_n.shape
    n = ids.shape[0]
    _check_lane(lane, e, gg2_lin)
    specs = [
        *((name, t, (r, e), torch.float32)
          for name, t in zip(("vec_n", "vec_z", "vec_w"), tables[:3])),
        *((name, t, (r,), torch.float32)
          for name, t in zip(("lin_n", "lin_z", "lin_w"), tables[3:])),
        ("ids", ids, (n,), torch.int32),
        ("gg2", gg2, (n, 2 * e), torch.float32),
    ]
    if gg2_lin is not None:
        specs.append(("gg2_lin", gg2_lin, (n, 2), torch.float32))
    _check_inputs("ftrl_update", vec_n, specs)
    from ftrl_ffm_tpu_torch.ops import _build

    lib = _build.lib()
    if n == 0:
        return
    # stable: a row's payload rows stay in ascending order, which fixes the
    # order of its float sums
    sids, perm = torch.sort(ids, stable=True)
    with torch.cuda.device(vec_n.device):
        stream = torch.cuda.current_stream(vec_n.device).cuda_stream
        code = lib.ftrl_update_launch(
            sids.data_ptr(), perm.data_ptr(), n, gg2.data_ptr(),
            None if gg2_lin is None else gg2_lin.data_ptr(),
            *(t.data_ptr() for t in tables), r, e, lane,
            p.alpha, p.beta, p.l1, p.l2, stream,
        )
    _build.check(code, "ftrl_update_launch")
    ftrl_update.launches += 1


# Kernel launches since the count was last set to 0 (chip_smoke.py reads it
# to show that the training path went through the kernel).
ftrl_update.launches = 0
