"""Logistic regression with FTRL (the counterpart of
ftrl_ffm_tpu/models/lr.py; reference: src/model/lr.cpp:9-24).

The state has no factor tables: the train step updates the linear tables
alone, through ops/ftrl_cuda.py::ftrl_update_linear (the update kernel with
no factor columns on the card, its plain version on the CPU)."""

from __future__ import annotations

import torch

from ftrl_ffm_tpu_torch.models.base import Batch, Model, ModelState, loss_grad


class LR(Model):
    def forward(self, state: ModelState, batch: Batch, rows, bias_w: torch.Tensor,
                train: bool, split: bool = False,
                payload_dtype: torch.dtype = torch.float32):
        logits = self._lin_logits(state, batch, rows, bias_w)
        return logits, (loss_grad(logits, batch) if train else None), None, -1
