from ftrl_ffm_tpu_torch.ops.ffm_cuda import ffm_fused_logits, ffm_fused_logits_plain
from ftrl_ffm_tpu_torch.ops.interactions import ffm_logits, linear_logits
from ftrl_ffm_tpu_torch.ops.layout import kmajor_to_reference, reference_to_kmajor

__all__ = [
    "linear_logits",
    "ffm_logits",
    "ffm_fused_logits",
    "ffm_fused_logits_plain",
    "kmajor_to_reference",
    "reference_to_kmajor",
]
