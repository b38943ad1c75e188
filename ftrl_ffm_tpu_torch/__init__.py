"""ftrl_ffm_tpu_torch — the PyTorch/CUDA port of ftrl_ffm_tpu.

The same FTRL-Proximal CTR system (LR / FM / FFM over libsvm/libffm data)
written in PyTorch, with every TPU kernel of the JAX package rewritten by
hand for NVIDIA Hopper (CUDA C++ under csrc/, built at first use).  The JAX
package ftrl_ffm_tpu is the reference the port is tested against; the port
never imports it, nor jax.

The port grows in slices (ROADMAP.md Queue 1).  It serves FFM today: load a
checkpoint, stream eval or scoring data, compute logits with the CUDA kernel
of ops/ffm_cuda.py, report log-loss and AUC, write probabilities.
"""

from ftrl_ffm_tpu_torch.config import Config

__version__ = "0.1.0"

__all__ = ["Config", "__version__"]
