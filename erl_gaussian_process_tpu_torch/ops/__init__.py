"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes the plain version for CPU tensors and launches its
CUDA kernel for CUDA tensors; every launch adds one to the wrapper's
``launches`` count, so a run can show that it went through the kernels.
"""

from erl_gaussian_process_tpu_torch.ops.fitc import (
    fitc_update_cuda,
    fitc_update_plain,
)
from erl_gaussian_process_tpu_torch.ops.gram import (
    cross_gram_cuda,
    cross_gram_plain,
)

WRAPPERS = {"gram": cross_gram_cuda, "fitc": fitc_update_cuda}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "cross_gram_cuda",
    "cross_gram_plain",
    "fitc_update_cuda",
    "fitc_update_plain",
    "launch_counts",
    "reset_launch_counts",
]
