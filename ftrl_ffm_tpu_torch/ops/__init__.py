from ftrl_ffm_tpu_torch.ops.ffm_cuda import (
    ffm_fused_logits,
    ffm_fused_logits_grads,
    ffm_fused_logits_grads_plain,
    ffm_fused_logits_plain,
)
from ftrl_ffm_tpu_torch.ops.ftrl_cuda import (
    closed_form_pass,
    ftrl_update,
    ftrl_update_plain,
    za_scatter,
)
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
    "counted_wrappers",
    "launch_counts",
    "add_launch_counts",
]


def counted_wrappers() -> tuple:
    """The kernel wrappers of the training and serving paths, each counting
    its launches: kernels #1 and #2, the update kernel, the z/A scatter and
    kernel #3."""
    return (ffm_fused_logits, ffm_fused_logits_grads, ftrl_update, za_scatter, closed_form_pass)


def launch_counts() -> dict:
    """Every counter of every counted wrapper, flat: {(wrapper, None):
    launches, (wrapper, attribute, key): launches by instance or dtype}."""
    out = {}
    for fn in counted_wrappers():
        out[(fn, None)] = fn.launches
        for attr in ("launches_by_instance", "launches_by_dtype"):
            for key, n in getattr(fn, attr, {}).items():
                out[(fn, attr, key)] = n
    return out


def add_launch_counts(delta: dict) -> None:
    """Add `delta` (launch_counts()'s keys) to the counters: a CUDA graph
    replay adds the launches its capture recorded, which the wrappers
    cannot count, since a replay runs no Python."""
    for key, n in delta.items():
        if key[1] is None:
            key[0].launches += n
        else:
            getattr(key[0], key[1])[key[2]] += n
