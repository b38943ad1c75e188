"""FFM (Juan et al., "Field-aware Factorization Machines for CTR
Prediction", RecSys 2016, eq. 3): for a row of occurrences i with feature
id_i, field f_i and value x_i,

  logit = b + sum_i w[id_i] x_i + sum_{i<j} <v[id_i, f_j], v[id_j, f_i]> x_i x_j

with a factor table v of [rows, n_fields, k].
"""

from __future__ import annotations

import torch


def factor_shape(config: dict) -> tuple:
    return (config["n_fields"], config["n_factors"])


def slots_per_row(config: dict) -> int:
    """One factor slot for each (other field it meets, factor) and one
    linear slot: the cells' rows hold one feature a field, so no
    occurrence reads or writes a row's slots for its own field:
    (n_fields - 1) * k + 1, whatever width the program stores.  A row that
    occurs in several fields touches more, never fewer."""
    return (config["n_fields"] - 1) * config["n_factors"] + 1


def forward_flops(config: dict, rows: int) -> float:
    """F(F-1)/2 field pairs, each a k-wide dot product (k multiplies and k
    adds): F(F-1)/2 * 2k a row.  The linear term and the bias (about 2F)
    are left out: the floor may count less than the work, never more."""
    f, k = config["n_fields"], config["n_factors"]
    return float(f * (f - 1) / 2 * 2 * k) * rows


def interaction(config: dict, v: torch.Tensor, x: torch.Tensor, need_grad: bool):
    """(the pairwise term [b], d term / d v [b, F, C, k] or None) of rows
    whose occurrence i (column i, field i) has factor rows v [b, F, C, k]
    and values x [b, F]."""
    f = x.shape[1]
    fields = torch.arange(f, device=x.device)  # column i holds field i
    a = v[:, :, fields, :]           # a[b, i, j] = v[id_i, f_j]
    at = a.transpose(1, 2)           # at[b, i, j] = v[id_j, f_i]
    off = ~torch.eye(f, dtype=torch.bool, device=x.device)
    xx = x[:, :, None] * x[:, None, :] * off
    inter = 0.5 * ((a * at).sum(-1) * xx).sum((1, 2))
    if not need_grad:
        return inter, None
    # d / d v[id_i, f_j] = x_i x_j v[id_j, f_i], j != i
    return inter, torch.zeros_like(v).index_add_(2, fields, at * xx[..., None])


def logical_view(rows: torch.Tensor, config: dict, field_pad: int) -> torch.Tensor:
    """The program's FFM rows are factor-major over field_pad fields (slot
    (k, c) at k * field_pad + c); the view [rows, n_fields, k] of the
    live slots."""
    k, c = config["n_factors"], config["n_fields"]
    return rows.view(rows.shape[0], k, field_pad)[:, :, :c].transpose(1, 2)
