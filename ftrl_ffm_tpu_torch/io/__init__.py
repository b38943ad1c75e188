from ftrl_ffm_tpu_torch.io.checkpoint import (
    IncompatibleStateError,
    load_checkpoint,
    state_from_jax_arrays,
    validate_header_compat,
)

__all__ = [
    "IncompatibleStateError",
    "load_checkpoint",
    "state_from_jax_arrays",
    "validate_header_compat",
]
