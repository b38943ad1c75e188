"""FM (Rendle, "Factorization Machines", ICDM 2010, eq. 1 and its O(nk)
form): for a row of occurrences i with feature id_i and value x_i,

  logit = b + sum_i w[id_i] x_i + sum_{i<j} <v[id_i], v[id_j]> x_i x_j
        = b + sum_i w[id_i] x_i + 1/2 (|sum_i x_i v_i|^2 - sum_i x_i^2 |v_i|^2)

with a factor table v of [rows, k].
"""

from __future__ import annotations

import torch


def factor_shape(config: dict) -> tuple:
    return (config["n_factors"],)


def slots_per_row(config: dict) -> int:
    """k factor slots and one linear slot."""
    return config["n_factors"] + 1


def forward_flops(config: dict, rows: int) -> float:
    """By the sum-of-squares form: x*v, its sum over the occurrences, the
    squares and their sum, each F*k: 4 F k a row (the linear term and the
    bias left out)."""
    return float(4 * config["n_fields"] * config["n_factors"]) * rows


def interaction(config: dict, v: torch.Tensor, x: torch.Tensor, need_grad: bool):
    """(the pairwise term [b], d term / d v [b, F, k] or None) of rows whose
    occurrences have factor rows v [b, F, k] and values x [b, F]."""
    vx = v * x[..., None]
    s = vx.sum(1)
    inter = 0.5 * ((s * s).sum(-1) - (vx * vx).sum((1, 2)))
    if not need_grad:
        return inter, None
    return inter, x[..., None] * s[:, None, :] - v * (x * x)[..., None]


def logical_view(rows: torch.Tensor, config: dict, field_pad: int) -> torch.Tensor:
    """The program stores FM rows as they are: [rows, k]."""
    return rows
