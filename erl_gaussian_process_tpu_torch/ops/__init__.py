"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper takes the plain version for CPU tensors and launches its
CUDA kernel for CUDA tensors; every launch adds one to the wrapper's
``launches`` count, so a run can show that it went through the kernels
(``ops/_library.note_launch``: a launch recorded into a CUDA graph counts
in ``captured``, and each replay of the graph adds it to ``launches``).
The gram and FITC wrappers call the ``torch.library`` ops of
``ops/_library.py`` (``egp::cross_gram``, ``egp::cross_gram_batched``,
``egp::fitc_update``), registered when this package is imported.
"""

from erl_gaussian_process_tpu_torch.ops.bank import (
    bank_cholesky_solve_cuda,
    bank_cholesky_solve_plain,
    bank_fit_cuda,
    bank_fit_plain,
    solve_alpha,
)
from erl_gaussian_process_tpu_torch.ops.chol import (
    chol_blocked,
    chol_blocked_gram,
    chol_blocked_gram_joint,
    chol_blocked_gram_joint_plain,
    chol_blocked_gram_plain,
    chol_blocked_plain,
    chol_update_wgmma,
    TILE,
    diag_tile_inverses,
)
from erl_gaussian_process_tpu_torch.ops.fitc import (
    fitc_update_cuda,
    fitc_update_plain,
)
from erl_gaussian_process_tpu_torch.ops.gram import (
    GramScale,
    cross_gram_batched_cuda,
    cross_gram_cuda,
    cross_gram_plain,
)
from erl_gaussian_process_tpu_torch.ops.trsm import (
    solve_lower_many,
    solve_lower_many_plain,
)
from erl_gaussian_process_tpu_torch.ops.trsv import (
    cho_solve_vec,
    inverses_from_chol_dinv,
    solve_lower,
    solve_lower_t,
    substitute_cuda,
    substitute_plain,
)

WRAPPERS = {"gram": cross_gram_cuda, "gram_batched": cross_gram_batched_cuda,
            "fitc": fitc_update_cuda, "bank_fit": bank_fit_cuda,
            "bank_chol": bank_cholesky_solve_cuda, "chol": chol_blocked,
            "chol_gram": chol_blocked_gram,
            "chol_gram_joint": chol_blocked_gram_joint,
            "chol_update_wgmma": chol_update_wgmma,
            "trsv": substitute_cuda, "trsm": solve_lower_many}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "GramScale",
    "TILE",
    "bank_cholesky_solve_cuda",
    "bank_cholesky_solve_plain",
    "bank_fit_cuda",
    "bank_fit_plain",
    "cho_solve_vec",
    "chol_blocked",
    "chol_blocked_gram",
    "chol_blocked_gram_joint",
    "chol_blocked_gram_joint_plain",
    "chol_blocked_gram_plain",
    "chol_blocked_plain",
    "chol_update_wgmma",
    "diag_tile_inverses",
    "cross_gram_batched_cuda",
    "cross_gram_cuda",
    "cross_gram_plain",
    "fitc_update_cuda",
    "fitc_update_plain",
    "inverses_from_chol_dinv",
    "launch_counts",
    "reset_launch_counts",
    "solve_alpha",
    "solve_lower",
    "solve_lower_many",
    "solve_lower_many_plain",
    "solve_lower_t",
    "substitute_cuda",
    "substitute_plain",
]
