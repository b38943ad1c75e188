"""ftrl_ffm_tpu_torch — the PyTorch/CUDA port of ftrl_ffm_tpu.

The same FTRL-Proximal CTR system (LR / FM / FFM over libsvm/libffm data)
written in PyTorch, with every TPU kernel of the JAX package rewritten by
hand for NVIDIA Hopper (CUDA C++ under csrc/, built at first use).  The JAX
package ftrl_ffm_tpu is the reference the port is tested against; the port
never imports it, nor jax.

The port grows in slices (ROADMAP.md Queue 1).  It trains and serves LR,
FM and FFM on one device and on meshes of one process a card (parallel/:
NCCL, or gloo on the CPU), streamed or from device-resident datasets, one
step a dispatch or S as a CUDA graph: FTRL-Proximal epochs with FFM's fused
logits-and-gradient kernel (ops/ffm_cuda.py) and, for every model, the
deterministic table-update kernels (ops/ftrl_cuda.py), eval and scoring
with FFM's logits kernel (LR and FM's logits are plain PyTorch, as the JAX
package's are XLA), from a fresh init or a checkpoint of the JAX package.
tools/ holds the measurement tools (the twins of the repo's tools/) and
its TPU probes (tools/micro_*.py), ported to the card with their own
kernels.
"""

from ftrl_ffm_tpu_torch.config import Config

__version__ = "0.1.0"

__all__ = ["Config", "__version__"]
