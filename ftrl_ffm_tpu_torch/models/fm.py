"""Factorization machine with FTRL (the counterpart of
ftrl_ffm_tpu/models/fm.py; reference: src/model/fm.cpp).

The O(F*K) sum-of-squares logit and the gradient
g = gs * (x * sum_vx - v * x^2) in plain PyTorch
(ops/interactions.py::fm_logits_and_grads: the JAX package runs them as
XLA ops, outside any Pallas kernel).  The reference's shared `sum_vx`
member was a cross-thread data race (src/include/model/fm.h:24); here it is
a per-sample tensor.  The factor rows are K wide with no dead lane, so the
linear tables take their own [N, 2] payload in every update kind.
"""

from __future__ import annotations

import torch

from ftrl_ffm_tpu_torch.models.base import Batch, Model, ModelState, loss_grad
from ftrl_ffm_tpu_torch.ops.interactions import fm_logits_and_grads


class FM(Model):
    def forward(self, state: ModelState, batch: Batch, rows, bias_w: torch.Tensor,
                train: bool, split: bool = False,
                payload_dtype: torch.dtype = torch.float32):
        """The linear term, then the interaction on the [B, F, K] rows, a
        bf16 table's widened to f32; the payload from d logit / d v
        (ftrl_ffm_tpu/models/base.py::Model._train_grads), always f32."""
        lin = self._lin_logits(state, batch, rows, bias_w)
        v = rows(state.vec_w).reshape(*batch.feats.shape, -1)
        logits, dv = fm_logits_and_grads(v, batch.vals, lin, compute_grads=train)
        if not train:
            return logits, None, None, -1
        gs = loss_grad(logits, batch)
        g = (gs[:, None, None] * dv).reshape(-1, dv.shape[-1])
        g2 = g * g
        return logits, gs, ((g, g2) if split else (torch.cat([g, g2], dim=-1),)), -1
