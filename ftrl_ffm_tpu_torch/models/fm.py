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

from ftrl_ffm_tpu_torch.models.base import Batch, Model, ModelState
from ftrl_ffm_tpu_torch.ops.interactions import fm_logits_and_grads, linear_logits


class FM(Model):
    def _logits_and_grads(self, state: ModelState, batch: Batch, train: bool):
        w = self._gather_linear(state, batch.feats)
        lin = linear_logits(w, batch.vals, self.bias_weight(state))
        # [B, F, K], a bf16 table's rows widened to f32
        v = self._gather_vec(state, batch.feats)
        return fm_logits_and_grads(v, batch.vals, lin, compute_grads=train)
