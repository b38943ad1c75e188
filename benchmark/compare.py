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

On a mesh the program's norms are summed over its ranks (each rank's
sums of squares all-reduced before the square root, the bias counted
once), its logits gathered to rank 0 and placed at their rows, and one
more number is compared, exactly:

  route_drops  the occurrences that the route's buckets dropped over the
             checked steps (the steps' own counts); the reference drops
             none, so any drop is a different result.

A leaf's gap is | |prog| - |ref| | over the larger of the reference's
norm of that leaf and the median leaf's.  Leaves: the gradient's "vec"
(the factor table's live slots), "lin" and "bias"; the change's vec_n,
vec_z, vec_w, lin_n, lin_z, lin_w, bias_n and bias_z.  A change leaf
whose table's reference gradient is under a thousandth of the median
gradient leaf's moves by rounding alone and is left out.

Norms are taken over logical tables (`Tables`): FFM's factor slots as
[rows, n_fields, k], FM's as [rows, k], whatever layout holds them, over
the rows a side holds: a rank's share of the program's table, the rows
the reference touched.  Rows a side leaves out are S0's rows, which add
nothing to a norm of the gradient or of the change.
"""

from __future__ import annotations

import math
from typing import Iterator, Protocol

import numpy as np
import torch

GRAD_LEAVES = ("vec", "lin", "bias")
CHANGE_LEAVES = ("vec_n", "vec_z", "vec_w", "lin_n", "lin_z", "lin_w", "bias_n", "bias_z")
NAMES = ("loss", "grad", "change", "eval_loss", "auc", "logit")
# compared exactly where a run reports them: the route's drops on a mesh
EXACT = ("route_drops",)
# a change leaf is left out where its table's reference gradient is under
# this share of the median gradient leaf's
NOUGHT = 1e-3


class Tables(Protocol):
    def vec_blocks(self) -> Iterator[tuple]:
        """(n, z, w, w0): some rows of the factor tables, float32, logical
        layout, with S0's weights of the same rows; every row the side
        holds once, a block of S0 at a time."""

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


def grad_squares(tables: Tables, config: dict) -> dict:
    """Sums of squares of the first step's gradient by leaf, from the
    state after one step (n0 = z0 = 0 in S0): g = z1 + sqrt(n1) / alpha *
    w0."""
    alpha = config["ftrl"]["alpha"]
    vec = sum(_sq(z + torch.sqrt(n) / alpha * w0) for n, z, _, w0 in tables.vec_blocks())
    # the linear weights and the bias start at 0
    _, lz, _ = tables.lin()
    _, bz = tables.bias()
    return {"vec": float(vec), "lin": _sq(lz), "bias": _sq(bz)}


def change_squares(tables: Tables) -> dict:
    """Sums of squares of (state - S0) by leaf."""
    acc = {k: 0.0 for k in ("vec_n", "vec_z", "vec_w")}
    for n, z, w, w0 in tables.vec_blocks():
        acc["vec_n"] += _sq(n)
        acc["vec_z"] += _sq(z)
        acc["vec_w"] += _sq(w.to(torch.float32) - w0)
    ln, lz, lw = tables.lin()
    bn, bz = tables.bias()
    acc.update(lin_n=_sq(ln), lin_z=_sq(lz), lin_w=_sq(lw), bias_n=_sq(bn), bias_z=_sq(bz))
    return acc


def norms(squares: dict) -> dict:
    return {k: math.sqrt(v) for k, v in squares.items()}


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
    and "logits" on S0 (prog: the rows its eager eval calls returned, at
    the eval rows "logit_rows", or the first ones where it gives none;
    ref: every eval row); prog's "route_drops" where it reports them."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    n = len(prog["logits"])
    rows = prog.get("logit_rows")
    rl = np.asarray(ref["logits"][:n] if rows is None else ref["logits"][rows], np.float64)
    pl = np.asarray(prog["logits"], np.float64)
    rms = float(np.sqrt(np.mean(rl * rl))) if n else 0.0
    return {
        "loss": float(max(losses)),
        "grad": leaf_gap(prog["grad"], ref["grad"], GRAD_LEAVES),
        "change": leaf_gap(prog["change"], ref["change"], counted_change_leaves(ref["grad"])),
        "eval_loss": abs(prog["eval_loss"] - ref["eval_loss"]) / abs(ref["eval_loss"]),
        "auc": abs(prog["auc"] - ref["auc"]),
        "logit": float(np.max(np.abs(pl - rl)) / rms) if n and rms > 0 else math.inf,
        **{k: float(prog[k]) for k in EXACT if k in prog},
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit (0 for the exact ones)."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    checks.update({k: {"value": values[k], "limit": 0} for k in EXACT if k in values})
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
