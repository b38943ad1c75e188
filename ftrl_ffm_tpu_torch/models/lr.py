"""Logistic regression with FTRL (the counterpart of
ftrl_ffm_tpu/models/lr.py; reference: src/model/lr.cpp:9-24).

The state has no factor tables: the train step updates the linear tables
alone, through ops/ftrl_cuda.py::ftrl_update_linear (the update kernel with
no factor columns on the card, its plain version on the CPU)."""

from __future__ import annotations

from ftrl_ffm_tpu_torch.models.base import Batch, Model, ModelState
from ftrl_ffm_tpu_torch.ops.interactions import linear_logits


class LR(Model):
    def _logits_and_grads(self, state: ModelState, batch: Batch, train: bool):
        w = self._gather_linear(state, batch.feats)
        return linear_logits(w, batch.vals, self.bias_weight(state)), None
