"""Checkpoints, the float64 drift check and state conversion from the
JAX package (counterpart of ``erl_gaussian_process_tpu/utils``, main-path
subset)."""

from erl_gaussian_process_tpu_torch.utils.serialization import (
    eq_state,
    load_pytree,
    save_pytree,
)

__all__ = ["eq_state", "load_pytree", "save_pytree"]
