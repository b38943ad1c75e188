"""Model base for serving: state, fixed-shape batches, the linear and bias
path (the serving subset of ftrl_ffm_tpu/models/base.py).

A `ModelState` holds the (n, z, w) tables as tensors on the run's device;
the forward pass gathers one stored w row per occurrence, as in the JAX
package.  Training (Model.train_step and the update dispatch) arrives with
ROADMAP.md Queue 1 item 2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ftrl_ffm_tpu_torch.config import Config, not_ported
from ftrl_ffm_tpu_torch.ftrl import FtrlParams, ftrl_weights


class Batch(NamedTuple):
    """One fixed-shape padded mini-batch.

    Padding convention (ftrl_ffm_tpu/models/base.py::Batch): padded
    occurrences have value 0.0, field 0 and feature id == n_feats (a drop
    sentinel for scatters; gathers clip).  Padded samples have sample_w 0.
    Two zero-size markers are understood by widen_batch: fields [0, F]
    (every row's fields are 0..F-1) and vals [B, 0] (all values 1.0)."""

    fields: torch.Tensor    # [B, F] int32
    feats: torch.Tensor     # [B, F] int32
    vals: torch.Tensor      # [B, F] float32
    y: torch.Tensor         # [B] float32 in {0, 1}
    sample_w: torch.Tensor  # [B] float32


class ModelState(NamedTuple):
    """(n, z, w) tables, as in ftrl_ffm_tpu/models/base.py::ModelState.
    The bias weight is derived from (bias_n, bias_z) on the fly."""

    bias_n: torch.Tensor
    bias_z: torch.Tensor
    lin_n: torch.Tensor               # [R]
    lin_z: torch.Tensor               # [R]
    lin_w: torch.Tensor               # [R]
    vec_n: Optional[torch.Tensor]     # [R, D] or None
    vec_z: Optional[torch.Tensor]     # [R, D] or None
    vec_w: Optional[torch.Tensor]     # [R, D] or None
    step: torch.Tensor                # int32 scalar


# dtypes of the JAX package's transfer tiers (uint16 delta/split feature
# ids, DEC6 uint8 values, bit-packed uint8 fields): their decode arrives
# with the feeder (ROADMAP.md Queue 1 item 5)
_TIER_DTYPES = (torch.uint16, torch.uint8)


def widen_batch(b: Batch) -> Batch:
    """Cast a batch to canonical dtypes and expand the zero-size markers
    (ftrl_ffm_tpu/models/base.py::widen_batch): [..., 0, F] fields become
    the iota 0..F-1 along the last axis, [..., B, 0] vals become ones.
    Narrowed plain dtypes (int8/int16 fields, int8/bf16 values, int8
    labels and weights) are widened by a cast."""
    for name, t in (("fields", b.fields), ("feats", b.feats), ("vals", b.vals)):
        if t.dtype in _TIER_DTYPES:
            raise not_ported(f"a {t.dtype} {name} transfer tier", 5)
    feats = b.feats.to(torch.int32)
    if b.vals.shape[-1] == 0 and feats.shape[-1] != 0:
        vals = torch.ones(feats.shape, dtype=torch.float32, device=feats.device)
    else:
        vals = b.vals.to(torch.float32)
    if b.fields.dim() >= 2 and b.fields.shape[-2] == 0 and feats.shape[-1]:
        iota = torch.arange(feats.shape[-1], dtype=torch.int32, device=feats.device)
        fields = iota.expand(feats.shape).contiguous()
    else:
        fields = b.fields.to(torch.int32)
    return Batch(
        fields=fields,
        feats=feats,
        vals=vals,
        y=b.y.to(torch.float32),
        sample_w=b.sample_w.to(torch.float32),
    )


def binary_logloss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Numerically stable -y*log(s) - (1-y)*log(1-s) from the logit
    (softplus as jax.nn.softplus: logaddexp(x, 0))."""
    return torch.logaddexp(logits, torch.zeros_like(logits)) - y * logits


class Model:
    """Shared serving plumbing; subclasses provide the interaction math."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.params = FtrlParams(cfg.w_alpha, cfg.w_beta, cfg.w_l1, cfg.w_l2)

    # ---- gathered weights (mode="clip" as the JAX package's jnp.take:
    # the padding sentinel id n_feats reads the last row, which its zero
    # value then makes inert) ----
    def _gather_linear(self, state: ModelState, feats: torch.Tensor) -> torch.Tensor:
        rows = state.lin_w.shape[0]
        return state.lin_w[feats.clamp(0, rows - 1)]

    def _gather_vec(self, state: ModelState, feats: torch.Tensor) -> torch.Tensor:
        rows = state.vec_w.shape[0]
        return state.vec_w.index_select(0, feats.reshape(-1).clamp(0, rows - 1)).reshape(
            *feats.shape, -1
        )

    def bias_weight(self, state: ModelState) -> torch.Tensor:
        return ftrl_weights(state.bias_n, state.bias_z, self.params)

    def _logits_and_grads(self, state: ModelState, batch: Batch, train: bool):
        """Returns (logits [B], factor gradients or None)."""
        raise NotImplementedError

    # ---- public API ----
    def predict_logits(self, state: ModelState, batch: Batch) -> torch.Tensor:
        logits, _ = self._logits_and_grads(state, widen_batch(batch), train=False)
        return logits

    def eval_step(self, state: ModelState, batch: Batch):
        """Masked log-loss sum, count and logits for one eval batch
        (reference: src/eval/evaluate.cpp:23-33)."""
        batch = widen_batch(batch)
        logits = self.predict_logits(state, batch)
        per_loss = binary_logloss(logits, batch.y) * batch.sample_w
        return torch.sum(per_loss), torch.sum(batch.sample_w), logits
