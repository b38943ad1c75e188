"""Field-aware factorization machine (the counterpart of
ftrl_ffm_tpu/models/ffm.py; reference: src/model/ffm.cpp).

Rows are factor-major and lane-padded: slot (k, c) = k * field_pad + c
(Config.field_pad, ops/layout.py).  Dead lane (0, n_fields) mirrors the
linear table: every train step feeds it the linear gradient, so the forward
pass reads w_lin from the factor rows it already gathers.  The logits and
the training payload run in the CUDA kernels of ops/ffm_cuda.py on the
card, and in their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from ftrl_ffm_tpu_torch.models.base import Batch, Model, ModelState, loss_grad
from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits, ffm_fused_logits_grads
from ftrl_ffm_tpu_torch.ops.interactions import linear_logits
from ftrl_ffm_tpu_torch.ops.layout import kmajor_to_reference, reference_to_kmajor


class FFM(Model):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.n_fields = cfg.n_fields
        self.n_factors = cfg.n_factors
        # the interaction runs over field_pad >= n_fields fields; the extra
        # fields never occur, so their slots are inert (Config.field_pad)
        self.field_pad = cfg.field_pad

    def _export_vec_layout(self, vec_w: torch.Tensor) -> torch.Tensor:
        # factor-major padded rows -> the reference's field-major rows, the
        # dead lanes dropped
        return kmajor_to_reference(vec_w, self.n_fields, self.n_factors, self.field_pad)

    def _import_vec_layout(self, vec_w: torch.Tensor) -> torch.Tensor:
        # the reverse, the dead lanes zero
        return reference_to_kmajor(vec_w, self.n_fields, self.n_factors, self.field_pad)

    def init_from_weights(self, bias, lin_w, vec_w=None, device=None) -> ModelState:
        """Restore the dead-lane linear mirror on warm starts
        (ftrl_ffm_tpu/models/ffm.py::init_from_weights): reference blobs
        know nothing of the padded layout, so after the base import the
        linear w, z and n are copied into lane (0, n_fields) of the factor
        tables (see _lin_lane)."""
        state = super().init_from_weights(bias, lin_w, vec_w, device)
        lane = self._lin_lane()
        if lane < 0 or state.vec_w is None:
            return state
        state.vec_w[:, lane] = state.lin_w.to(state.vec_w.dtype)
        state.vec_z[:, lane] = state.lin_z
        state.vec_n[:, lane] = state.lin_n
        return state

    def _lin_lane(self) -> int:
        """Dead lane (k=0, c=n_fields) that mirrors the linear table when
        the factor row is padded (Config.field_pad)."""
        return self.n_fields if self.field_pad > self.n_fields else -1

    def _lin_read_lane(self) -> int:
        """Lane the forward pass reads w_lin from: the mirror lane, but only
        while the factor table is f32 (ftrl_ffm_tpu/models/ffm.py::
        _lin_read_lane: a bf16 mirror would quantize the linear term)."""
        lane = self._lin_lane()
        return lane if self.cfg.table_dtype == "float32" else -1

    def _lin_logits(self, state: ModelState, batch: Batch, rows, bias_w: torch.Tensor,
                    v: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B] bias plus linear term: w_lin from the mirror lane of the
        gathered [B*F, E] rows v while it is read (_lin_read_lane), else
        the linear table's rows."""
        lane = self._lin_read_lane()
        if lane < 0:
            return super()._lin_logits(state, batch, rows, bias_w)
        return linear_logits(v[:, lane].reshape(batch.feats.shape), batch.vals, bias_w)

    def forward(self, state: ModelState, batch: Batch, rows, bias_w: torch.Tensor,
                train: bool, split: bool = False,
                payload_dtype: torch.dtype = torch.float32):
        """Kernel #2's logits and payload, or kernel #1's logits
        (ftrl_ffm_tpu/models/ffm.py::FFM._train_grads, its Pallas path,
        and _logits_and_grads): a flat [B*F, E] gather, f32 for training
        and in the table's dtype for eval (kernel #1 widens bf16 rows
        itself); w_lin from the mirror lane of those rows; the linear
        gradient in the dead lane when the row has one, in the combined
        layout (f32 or bf16) or, with split, in g and g^2 apart."""
        v = rows(state.vec_w, widen=train)
        lin = self._lin_logits(state, batch, rows, bias_w, v)
        if not train:
            logits = ffm_fused_logits(
                v, batch.fields, batch.vals, lin, self.field_pad, self.n_factors
            )
            return logits, None, None, -1
        lane = self._lin_lane()
        logits, *payload = ffm_fused_logits_grads(
            v, batch.fields, batch.vals, lin, batch.y, batch.sample_w,
            self.field_pad, self.n_factors, aug_lane=lane, combined_out=not split,
            out_dtype=payload_dtype,
        )
        return logits, loss_grad(logits, batch), tuple(payload), lane

    def _emits_combined(self) -> bool:
        # kernel #2 writes the combined payload itself, in f32 or bf16
        return True

    def _lin_mirror_maintained(self) -> bool:
        # every payload folds g_lin into the dead lane and the forward pass
        # reads w_lin from it whenever _lin_read_lane() >= 0, so with f32
        # tables the mirror is a complete linear-table replica
        return self._lin_read_lane() >= 0

    def sync_lin_from_mirror(self, state: ModelState) -> ModelState:
        """lin_(n, z, w) := the factor tables' mirror lane, as new tensors
        (ftrl_ffm_tpu/models/ffm.py::sync_lin_from_mirror).  Exact: the lane
        starts at the linear init (0) and takes the same (g_lin, g_lin^2)
        stream through every update kind.  One strided column read per
        table, at boundaries only."""
        lane = self._lin_read_lane()
        if lane < 0 or state.vec_n is None:
            return state
        n = state.lin_n.shape[0]
        return state._replace(
            lin_n=state.vec_n[:n, lane].contiguous(),
            lin_z=state.vec_z[:n, lane].contiguous(),
            lin_w=state.vec_w[:n, lane].to(state.lin_w.dtype).contiguous(),
        )
