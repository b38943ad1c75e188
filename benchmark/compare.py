"""The comparison that decides `correct`, and the numbers it compares.

A cell trains one Trainer from S0 (benchmark/state.py).  In set-up it
runs evaluate() on S0, then its first check_steps(config) steps through
the window's own call, train_epoch(), on the first batches of epoch 1's
permutation, then evaluate() again; the plain reference
(benchmark/reference/) does the same from the same S0 on the same rows.
Compared, each against its own limit (benchmark/limits/<cell>.json):

  loss       each step's mean loss, the worst relative gap;
  grad       the first step's gradient as FTRL received it, worked out
             from the state after one step (g = z1 - z0 + sigma w0, with
             sigma from n1 and n0), the worst leaf's gap of norms;
  change     the change of every state leaf over the checked steps, the
             worst leaf's gap of norms;
  eval_loss  the eval pass that follows the checked steps, its mean
             log-loss, relative gap;
  auc        the same pass's binned AUC, absolute gap;
  logit      the eval pass on S0: the logits that the program's eager
             calls return (every batch at one step a call; the first
             group's at S > 1, the rest being graph replays), the widest
             gap over the RMS of the reference's.  On S0, and not after
             the steps: there a coordinate whose summed g^2 lies within
             rounding of keep_init's threshold (untouched_n) keeps its
             initial weight on one side and not on the other, which moves
             the few logits that read it by far more than rounding.

A leaf's gap is | |prog| - |ref| | over the larger of the reference's
norm of that leaf and the median leaf's.  Leaves: the gradient's "vec"
(the factor table's live slots), "lin" and "bias"; the change's vec_n,
vec_z, vec_w, lin_n, lin_z, lin_w, bias_n and bias_z.  A change leaf
whose table's reference gradient is under a thousandth of the median
gradient leaf's moves by rounding alone and is left out.

Norms are taken over logical tables (`Tables`): FFM's factor slots as
[rows, n_fields, k], FM's as [rows, k], whatever layout holds them.
"""

from __future__ import annotations

import math
from typing import Iterator, Protocol

import numpy as np
import torch

from benchmark import state as s0

GRAD_LEAVES = ("vec", "lin", "bias")
CHANGE_LEAVES = ("vec_n", "vec_z", "vec_w", "lin_n", "lin_z", "lin_w", "bias_n", "bias_z")
NAMES = ("loss", "grad", "change", "eval_loss", "auc", "logit")
# a change leaf is left out where its table's reference gradient is under
# this share of the median gradient leaf's
NOUGHT = 1e-3


class Tables(Protocol):
    def vec_blocks(self) -> Iterator[tuple]:
        """(block, lo, hi, n, z, w): rows [lo, hi) of the factor tables,
        float32, logical layout (S0's blocks)."""

    def lin(self) -> tuple:
        """(n, z, w) of the linear tables, float32 [R]."""

    def bias(self) -> tuple:
        """(n, z) of the bias, 0-dim float32."""


def check_steps(config: dict) -> int:
    """Steps the reference follows: three at one step a call; two groups
    at steps_per_call S > 1, the first run eagerly and the second a graph
    replay, so that the replayed path is judged too."""
    s = config["steps_per_call"]
    return 3 if s == 1 else 2 * s


def _sq(t: torch.Tensor) -> float:
    t = t.to(torch.float32)
    return float((t * t).sum(dtype=torch.float64))


def grad_norms(tables: Tables, config: dict, seed: int) -> dict:
    """Norms of the first step's gradient by leaf, from the state after one
    step (n0 = z0 = 0 in S0): g = z1 + sqrt(n1) / alpha * w0."""
    alpha = config["ftrl"]["alpha"]
    vec = 0.0
    for b, lo, hi, n, z, _ in tables.vec_blocks():
        w0 = s0.w0_block(config, seed, b, lo, hi, n.device)
        vec += _sq(z + torch.sqrt(n) / alpha * w0)
    # the linear weights and the bias start at 0
    _, lz, _ = tables.lin()
    _, bz = tables.bias()
    return {"vec": math.sqrt(vec), "lin": math.sqrt(_sq(lz)), "bias": math.sqrt(_sq(bz))}


def change_norms(tables: Tables, config: dict, seed: int) -> dict:
    """Norms of (state - S0) by leaf."""
    acc = {k: 0.0 for k in ("vec_n", "vec_z", "vec_w")}
    for b, lo, hi, n, z, w in tables.vec_blocks():
        w0 = s0.w0_block(config, seed, b, lo, hi, n.device)
        acc["vec_n"] += _sq(n)
        acc["vec_z"] += _sq(z)
        acc["vec_w"] += _sq(w.to(torch.float32) - w0)
    ln, lz, lw = tables.lin()
    bn, bz = tables.bias()
    acc.update(lin_n=_sq(ln), lin_z=_sq(lz), lin_w=_sq(lw), bias_n=_sq(bn), bias_z=_sq(bz))
    return {k: math.sqrt(v) for k, v in acc.items()}


def leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """The worst leaf's | |prog| - |ref| | over max(|ref leaf|, median)."""
    med = float(np.median([ref[k] for k in leaves]))
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0
            else (0.0 if prog[k] == 0 else math.inf) for k in leaves]
    return max(gaps)


def counted_change_leaves(ref_grad: dict) -> list:
    """The change leaves whose table's reference gradient is not nought."""
    med = float(np.median([ref_grad[k] for k in GRAD_LEAVES]))
    return [k for k in CHANGE_LEAVES if ref_grad[k.split("_")[0]] >= NOUGHT * med]


def readings(prog: dict, ref: dict) -> dict:
    """The compared numbers.  prog and ref: "losses" (each checked step's
    mean loss), "grad" and "change" (norms by leaf), "eval_loss", "auc",
    and "logits" on S0 (prog: the rows its eager eval calls returned,
    first ones first; ref: every eval row)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    n = len(prog["logits"])
    rl = np.asarray(ref["logits"][:n], np.float64)
    pl = np.asarray(prog["logits"], np.float64)
    rms = float(np.sqrt(np.mean(rl * rl))) if n else 0.0
    return {
        "loss": float(max(losses)),
        "grad": leaf_gap(prog["grad"], ref["grad"], GRAD_LEAVES),
        "change": leaf_gap(prog["change"], ref["change"], counted_change_leaves(ref["grad"])),
        "eval_loss": abs(prog["eval_loss"] - ref["eval_loss"]) / abs(ref["eval_loss"]),
        "auc": abs(prog["auc"] - ref["auc"]),
        "logit": float(np.max(np.abs(pl - rl)) / rms) if n and rms > 0 else math.inf,
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
