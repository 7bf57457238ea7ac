"""Shared GP linear-algebra core, main-path subset (counterpart of
``erl_gaussian_process_tpu/models/gp_core.py:23-125,185-219``).

Dense factorizations and solves are plain torch (cuSOLVER/cuBLAS on the
card, LAPACK on the CPU). A failed Cholesky is signalled the way the JAX
package signals it, with NaN: ``torch.linalg.cholesky`` would raise, so
:func:`cholesky_nan` uses ``cholesky_ex`` and fills a factor whose ``info``
is non-zero with NaN, on the device and without a host sync.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

_LOG = logging.getLogger("erl_gaussian_process_tpu_torch")


def use_full_fp32_matmul() -> None:
    """The precision policy: float32 matrix products run in true FP32.

    TF32 keeps a 10-bit mantissa; the FITC weight 1/(lambda + var)
    amplifies GEMM error by up to 1/var (1e4 on the main path), which puts
    TF32 in the accuracy class the JAX package measured as three lost
    digits of map posterior for single-pass bf16. So TF32 stays off. These
    are PyTorch's process-wide settings; the models call this when they are
    built, and float64 is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def kahan_add(s: torch.Tensor, c: torch.Tensor, d: torch.Tensor):
    """One compensated (Kahan) accumulation step: returns ``(s', c')`` with
    the running sum recoverable as ``s' - c'`` to ~2 ulp of the term
    magnitudes, independent of how many terms have been accumulated.

    Eager PyTorch evaluates the four operations as written, so the
    cancellation survives; do not ``torch.compile`` this function, whose
    algebraic simplification could reassociate ``(t - s) - y`` to zero."""
    y = d - c
    t = s + y
    c_new = (t - s) - y
    return t, c_new


def cholesky_nan(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of K, all NaN where the factorization fails."""
    L, info = torch.linalg.cholesky_ex(K)
    return L.masked_fill(info != 0, float("nan"))


def robust_cholesky(K: torch.Tensor) -> torch.Tensor:
    """Cholesky with escalating relative jitter on failure: retries with
    jitter growing from 1e-14 (f64) or 1e-6 (f32) of the mean diagonal,
    x100 per step, up to 1. Zero retries, and one host sync, on the
    well-posed path."""
    L = cholesky_nan(K)
    scale = torch.mean(torch.diagonal(K))
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    j = 1e-14 if K.dtype == torch.float64 else 1e-6
    while bool(torch.isnan(L).any()) and j < 1.0:
        L = cholesky_nan(K + (j * scale) * eye)
        j *= 100.0
    return L


def host_jitter_retry(fit_once, check_arrays, jitters=(0.0, 1e-10, 1e-8,
                                                       1e-6, 1e-4, 1e-2)):
    """``fit_once(jitter)`` retried with the next jitter level while any of
    ``check_arrays(result)`` holds non-finite values. When the retry
    escalates, the effective observation noise changes, hence the warning."""
    result = None
    for j in jitters:
        result = fit_once(j)
        ok = all(bool(torch.isfinite(torch.as_tensor(a)).all())
                 for a in check_arrays(result))
        if ok:
            if j > 0:
                _LOG.warning(
                    "fit required jitter %g on the noise diagonal — the "
                    "requested noise leaves the gram numerically indefinite "
                    "at this dtype/problem size. Effective observation noise "
                    "changed; see gp_core.host_jitter_retry", j)
            return result
    return result


def cond_escalate_threshold(dtype) -> float:
    """The squared-pivot-ratio bound above which a device Cholesky of Q_M
    is escalated to the exact float64 host refactorization:
    ``ERL_GP_COND_ESCALATE`` if set, else 1e7 for float32 (~1/eps_f32/2)
    and 1e15 for float64. The one place the variable is read."""
    env = os.environ.get("ERL_GP_COND_ESCALATE")
    if env:
        return float(env)
    return 1e7 if np.dtype(dtype) == np.float32 else 1e15
