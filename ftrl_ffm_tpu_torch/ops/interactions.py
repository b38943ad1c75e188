"""Batched linear, FM and FFM logit math in plain PyTorch: the port's
numerical ground truth.

ftrl_ffm_tpu/ops/interactions.py::linear_logits, ::fm_logits_and_grads and
::ffm_logits_and_grads, FFM's written with the same field-bucketed
contraction, the same factor-major slot layout (slot (k, c) = k * C' + c,
ops/layout.py) and the same one-hot semantics: an occurrence whose field
is outside [0, C') selects nothing.

Shapes: B = batch, F = max nnz per sample (padded), C = fields (the padded
field count C' where rows are padded), K = factors, E = C * K.
"""

from __future__ import annotations

import torch

# The contraction below is f32 on purpose: JAX runs it at
# Precision.HIGHEST, and the kernels are held against it.  TF32 would keep
# about three decimal digits, so it stays off for f32 matmuls on the card
# (False is also PyTorch's default; stated here so nothing turns it on).
torch.backends.cuda.matmul.allow_tf32 = False


def linear_logits(
    w_lin: torch.Tensor, vals: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """logit_b = bias + sum_m w[b, m] * x[b, m]
    (reference: src/model/ftrl_model.cpp:44-50).

    w_lin, vals: [B, F]; bias: scalar tensor."""
    return bias + torch.sum(w_lin * vals, dim=-1)


def fm_logits_and_grads(
    v: torch.Tensor, vals: torch.Tensor, lin_logits: torch.Tensor,
    compute_grads: bool = True,
):
    """FM second-order logit by the sum-of-squares identity and the
    per-occurrence gradient (reference: src/model/fm.cpp:40-67 logit,
    :80-101 gradient g = grad * (x * sum_vx - v * x^2)):

        sum_vx[b, k]  = sum_m x_m * v[b, m, k]
        logit_b       = lin_b + 0.5 * sum_k (sum_vx[b, k]^2
                                             - sum_m (x_m * v[b, m, k])^2)
        dlogit/dv[b,m,k] = x_m * sum_vx[b, k] - v[b, m, k] * x_m^2

    Args:
      v:    [B, F, K] gathered factor rows (f32).
      vals: [B, F] values (0 for padding, which makes it inert).
      lin_logits: [B].
      compute_grads: False skips the gradient (returned as None).

    Returns: (logits [B], dlogit_dv [B, F, K] or None)."""
    vx = v * vals[..., None]
    sum_vx = torch.sum(vx, dim=1)  # [B, K]
    sum_sq = torch.sum(vx * vx, dim=(1, 2))
    logits = lin_logits + 0.5 * (torch.sum(sum_vx * sum_vx, dim=-1) - sum_sq)
    if not compute_grads:
        return logits, None
    dlogit_dv = vals[..., None] * sum_vx[:, None, :] - v * (vals * vals)[..., None]
    return logits, dlogit_dv


def ffm_logits(
    v: torch.Tensor,
    fields: torch.Tensor,
    vals: torch.Tensor,
    lin_logits: torch.Tensor,
    n_fields: int,
    n_factors: int,
    lin_lane: int = -1,
) -> torch.Tensor:
    """FFM logits [B] alone: ffm_logits_and_grads without the gradient."""
    logits, _ = ffm_logits_and_grads(
        v, fields, vals, lin_logits, n_fields, n_factors,
        compute_grads=False, lin_lane=lin_lane,
    )
    return logits


def ffm_logits_and_grads(
    v: torch.Tensor,
    fields: torch.Tensor,
    vals: torch.Tensor,
    lin_logits: torch.Tensor,
    n_fields: int,
    n_factors: int,
    compute_grads: bool = True,
    lin_lane: int = -1,
    grad_lane: int = -1,
):
    """FFM field-aware pairwise logit and per-occurrence gradient, batched
    (reference: src/model/ffm.cpp:57-70 logit, :107-123 gradient):

        S[b, c, d, k] = sum_{m: field_m = c} x_m * v[b, m, d, k]
        logit_b       = lin_b + 0.5 * ( sum_{c,d,k} S[b,c,d,k] * S[b,d,c,k]
                                        - sum_{m,k} (x_m * v[b,m,field_m,k])^2 )
        dlogit/dv[b,m,c,k] = x_m * ( S[b, c, field_m, k]
                                     - [c == field_m] * x_m * v[b,m,c,k] )

    Args:
      v:      [B, F, E] gathered factor rows, factor-major.
      fields: [B, F] int field per occurrence (0 for padding, which is inert
              because its value is 0).
      vals:   [B, F] values.
      lin_logits: [B].
      n_fields: C (the row's padded field count).  n_factors: K.
      compute_grads: False skips the gradient (returned as None).
      lin_lane: when >= 0, the rows' dead lane that mirrors the linear
        weight; its sum over the occurrences joins the logit here.
      grad_lane: when >= 0, the gradient's dead lane is set to x_m, so the
        per-occurrence gradient times gs doubles as the linear gradient
        g_lin = gs * x that keeps the mirror.

    Returns: (logits [B], dlogit_dv [B, F, E] or None).
    """
    b, f, e = v.shape
    c, k = n_fields, n_factors
    if e != c * k:
        raise ValueError(f"row width {e} != n_fields * n_factors = {c * k}")
    if lin_lane >= 0:
        lin_logits = lin_logits + torch.sum(v[:, :, lin_lane] * vals, dim=1)
    # one-hot by comparison (not F.one_hot, which raises on out-of-range
    # ids): a field outside [0, C) selects no bucket, as jax.nn.one_hot
    field_ids = torch.arange(c, device=v.device, dtype=fields.dtype)
    onehot = (fields[..., None] == field_ids).to(v.dtype)  # [B, F, C]
    xoh = onehot * vals[..., None]
    # s[b, c, (k,d)] = S[c, d, k]: one batched f32 matmul over occurrences
    s = torch.einsum("bmc,bme->bce", xoh, v)  # [B, C, E]
    # s_t[b, d, (k,c)] = s[b, c, (k,d)]
    s_t = s.reshape(b, c, k, c).permute(0, 3, 2, 1).reshape(b, c, e)
    cross = torch.sum(s * s_t, dim=(1, 2))
    # self term: slot (k, c) belongs to field c = slot % C
    slot_field = torch.arange(e, device=v.device, dtype=fields.dtype) % c
    oh_e = (fields[..., None] == slot_field).to(v.dtype)  # [B, F, E]
    xv = v * vals[..., None]
    self_sq = torch.sum(oh_e * xv * xv, dim=(1, 2))
    logits = lin_logits + 0.5 * (cross - self_sq)
    if not compute_grads:
        return logits, None
    # T[b, m, (k,c)] = S[c, field_m, k] = sum_d onehot[b,m,d] * s_t[b,d,(k,c)]
    t = torch.einsum("bmd,bde->bme", onehot, s_t)  # [B, F, E]
    dlogit_dv = vals[..., None] * (t - oh_e * xv)
    if grad_lane >= 0:
        # the dead lane's factor gradient is zero: the select only injects
        # d logit / d (linear weight) = x
        lane = torch.arange(e, device=v.device) == grad_lane
        dlogit_dv = torch.where(lane, vals[..., None], dlogit_dv)
    return logits, dlogit_dv
