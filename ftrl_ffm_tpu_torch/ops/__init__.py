from ftrl_ffm_tpu_torch.ops.ffm_cuda import (
    ffm_fused_logits,
    ffm_fused_logits_grads,
    ffm_fused_logits_grads_plain,
    ffm_fused_logits_plain,
)
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import ftrl_update, ftrl_update_plain
from ftrl_ffm_tpu_torch.ops.interactions import (
    ffm_logits,
    ffm_logits_and_grads,
    linear_logits,
)
from ftrl_ffm_tpu_torch.ops.layout import kmajor_to_reference, reference_to_kmajor

__all__ = [
    "linear_logits",
    "ffm_logits",
    "ffm_logits_and_grads",
    "ffm_fused_logits",
    "ffm_fused_logits_plain",
    "ffm_fused_logits_grads",
    "ffm_fused_logits_grads_plain",
    "ftrl_update",
    "ftrl_update_plain",
    "kmajor_to_reference",
    "reference_to_kmajor",
]
