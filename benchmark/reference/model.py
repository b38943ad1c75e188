"""Batched FTRL-Proximal over a factorization model, in plain PyTorch.

The model's logit is b + sum_i w[id_i] x_i + its pairwise term, for a row
of occurrences i with feature id_i and value x_i; the pairwise term is
the model's own (benchmark/models/<model_type>.py, from its published
definition).  McMahan et al., "Ad Click Prediction: a View from the
Trenches", KDD 2013, Algorithm 1, gives the step:

  loss = log(1 + e^logit) - y logit,  g_logit = sigmoid(logit) - y

A batch's gradients are summed per coordinate, g and g^2 apart (the
per-occurrence squares, as the C++ reference adds them one occurrence at
a time), and each touched coordinate takes one FTRL-Proximal step:

  n' = n + sum g^2,  sigma = (sqrt(n') - sqrt(n)) / alpha
  z' = z + sum g - sigma w
  w' = 0 if |z'| <= l1, else -(z' - sgn(z') l1) / (l2 + (beta + sqrt(n')) / alpha)

under keep_init semantics: a coordinate whose n' is still at most
`untouched_n` keeps its weight.  The bias is one more coordinate, with
g = g_logit summed over the batch.

The tables are logical: the factor weights [R, *factor_shape], the
linear [R], the bias a 0-dim tensor, over R rows of the model's table
that the caller names (initial_state); ids index those R rows.  Float32 throughout;
sums of losses in float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark import models

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass
class RefState:
    bias_n: torch.Tensor
    bias_z: torch.Tensor
    lin_n: torch.Tensor
    lin_z: torch.Tensor
    lin_w: torch.Tensor
    vec_n: torch.Tensor
    vec_z: torch.Tensor
    vec_w: torch.Tensor


def initial_state(config: dict, seed: int, device: torch.device,
                  ids: torch.Tensor) -> RefState:
    """S0 (benchmark/state.py) of the rows `ids` (sorted, distinct), made
    again from the seed: row i of the state is S0's row ids[i]."""
    from benchmark import state as s0

    vec_w = s0.w0_rows(config, seed, ids, device)
    r = ids.shape[0]
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=device)  # noqa: E731
    return RefState(zeros(), zeros(), zeros(r), zeros(r), zeros(r),
                    zeros(*vec_w.shape), zeros(*vec_w.shape), vec_w)


def ftrl_weight(n: torch.Tensor, z: torch.Tensor, p: dict) -> torch.Tensor:
    """The closed form of w from (n, z)."""
    w = -(z - torch.sign(z) * p["l1"]) / (p["l2"] + (p["beta"] + torch.sqrt(n)) / p["alpha"])
    return torch.where(torch.abs(z) <= p["l1"], torch.zeros_like(w), w)


def ftrl_step(n, z, w, g, g2, p: dict, untouched_n: float):
    """(n', z', w') of coordinates with summed gradients g and squares g2."""
    n2 = n + g2
    sigma = (torch.sqrt(n2) - torch.sqrt(n)) / p["alpha"]
    z2 = z + g - sigma * w
    w2 = torch.where(n2 > untouched_n, ftrl_weight(n2, z2, p), w)
    return n2, z2, w2


def forward(config: dict, st: RefState, ids: torch.Tensor, x: torch.Tensor,
            need_grad: bool):
    """Logits [b] of rows ids [b, F] (int64) with values x [b, F], and
    with need_grad d logit / d v of each occurrence's factor row (the
    model's interaction, benchmark/models/<model_type>.py)."""
    bias = ftrl_weight(st.bias_n, st.bias_z, config["ftrl"])
    lin = (st.lin_w[ids] * x).sum(1)
    inter, dv = models.of(config).interaction(config, st.vec_w[ids], x, need_grad)
    return bias + lin + inter, dv


def row_loss(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log(1 + e^logit) - y logit, a row."""
    return torch.nn.functional.softplus(logit) - y * logit


def train_step(config: dict, st: RefState, ids: torch.Tensor, y: torch.Tensor,
               block: int) -> float:
    """One FTRL step on a full batch (ids [B, F], labels y [B]), in place;
    returns the batch's summed loss (float64), from the pre-step state.
    The forward and backward run `block` rows at a time."""
    p, untouched = config["ftrl"], config["untouched_n"]
    ids = ids.to(torch.int64)
    y = y.to(torch.float32)
    x = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    touched, inv = torch.unique(ids.reshape(-1), return_inverse=True)
    inv = inv.view(ids.shape)
    fshape = st.vec_w.shape[1:]
    u = touched.shape[0]
    dev = ids.device
    sg = torch.zeros((u, *fshape), device=dev)
    sg2 = torch.zeros((u, *fshape), device=dev)
    lg = torch.zeros(u, device=dev)
    lg2 = torch.zeros(u, device=dev)
    bg = torch.zeros((), device=dev)
    bg2 = torch.zeros((), device=dev)
    loss = 0.0
    for lo in range(0, ids.shape[0], block):
        sl = slice(lo, lo + block)
        logit, dv = forward(config, st, ids[sl], x[sl], need_grad=True)
        gl = torch.sigmoid(logit) - y[sl]
        g = gl.view(-1, *[1] * (dv.dim() - 1)) * dv
        rows = inv[sl].reshape(-1)
        sg.index_add_(0, rows, g.reshape(-1, *fshape))
        sg2.index_add_(0, rows, (g * g).reshape(-1, *fshape))
        glin = (gl[:, None] * x[sl]).reshape(-1)
        lg.index_add_(0, rows, glin)
        lg2.index_add_(0, rows, glin * glin)
        bg = bg + gl.sum()
        bg2 = bg2 + (gl * gl).sum()
        loss += float(row_loss(logit, y[sl]).double().sum())
    st.vec_n[touched], st.vec_z[touched], st.vec_w[touched] = ftrl_step(
        st.vec_n[touched], st.vec_z[touched], st.vec_w[touched], sg, sg2, p, untouched)
    st.lin_n[touched], st.lin_z[touched], st.lin_w[touched] = ftrl_step(
        st.lin_n[touched], st.lin_z[touched], st.lin_w[touched], lg, lg2, p, untouched)
    bias_w = ftrl_weight(st.bias_n, st.bias_z, p)
    st.bias_n, st.bias_z, _ = ftrl_step(st.bias_n, st.bias_z, bias_w, bg, bg2, p, untouched)
    return loss


def eval_logits(config: dict, st: RefState, ids: torch.Tensor, block: int) -> torch.Tensor:
    """[M] logits of the rows ids [M, F], `block` rows at a time."""
    out = []
    for lo in range(0, ids.shape[0], block):
        b = ids[lo:lo + block].to(torch.int64)
        x = torch.ones(b.shape, dtype=torch.float32, device=b.device)
        out.append(forward(config, st, b, x, need_grad=False)[0])
    return torch.cat(out)


def binned_auc(logits: np.ndarray, y: np.ndarray, bins: int) -> float:
    """AUC over `bins` equal buckets of the score sigmoid(logit) in [0, 1]
    (the program's stated eval metric): a positive beats the negatives of
    lower buckets and ties half the negatives of its own."""
    score = 1.0 / (1.0 + np.exp(-logits.astype(np.float32)))
    b = np.clip((score * bins).astype(np.int64), 0, bins - 1)
    pos = np.bincount(b, weights=(y > 0).astype(np.float64), minlength=bins)
    neg = np.bincount(b, weights=(y <= 0).astype(np.float64), minlength=bins)
    below = np.cumsum(neg) - neg
    return float(np.sum(pos * (below + 0.5 * neg)) / (pos.sum() * neg.sum()))
