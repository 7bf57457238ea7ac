"""Shared GP linear-algebra core (counterpart of
``erl_gaussian_process_tpu/models/gp_core.py``).

The exact GPs' single large systems (``cholesky_fit(robust=False)`` and
:func:`solve_with_L`) run the hand-written blocked Cholesky and
triangular-solve kernels (``ops/chol.py``, ``ops/trsv.py``) on the card
and their plain versions on the CPU. The banks' small systems
(``robust=True``), :func:`whiten` and the SPGP's factorizations are plain
torch (cuSOLVER/cuBLAS on the card, LAPACK on the CPU), as the JAX package
leaves them to XLA. A failed Cholesky is signalled the way the JAX package
signals it, with NaN: ``torch.linalg.cholesky`` would raise, so
:func:`cholesky_nan` uses ``cholesky_ex`` and fills a factor whose ``info``
is non-zero with NaN, on the device and without a host sync.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

_LOG = logging.getLogger("erl_gaussian_process_tpu_torch")

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """The device of a model or state: the card unless the caller names
    another. Asking for CUDA where there is none raises; nothing falls back
    to the CPU without being asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available. The "
            "port's entry points run on the card by default; pass "
            "device='cpu' to run on the CPU")
    return dev


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


def kahan_add(s: torch.Tensor, c: torch.Tensor, d: torch.Tensor, out=None):
    """One compensated (Kahan) accumulation step: returns ``(s', c')`` with
    the running sum recoverable as ``s' - c'`` to ~2 ulp of the term
    magnitudes, independent of how many terms have been accumulated.

    ``out``: a pair of tensors (which may be ``s`` and ``c`` themselves)
    that receive ``(s', c')``, computed by the same operations in the same
    order, so bit for bit the new tensors' values (the CUDA graphs of
    ``models/pose_graph.py`` update the state in place this way).

    Eager PyTorch evaluates the four operations as written, so the
    cancellation survives; do not ``torch.compile`` this function, whose
    algebraic simplification could reassociate ``(t - s) - y`` to zero."""
    y = d - c
    t = s + y
    if out is None:
        return t, (t - s) - y
    s_out, c_out = out
    torch.sub(t, s, out=c_out)       # c is no longer read: y holds d - c
    c_out.sub_(y)
    s_out.copy_(t)
    return s_out, c_out


def cholesky_nan(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of K (..., n, n), all NaN in each matrix whose
    factorization fails."""
    L, info = torch.linalg.cholesky_ex(K)
    return L.masked_fill((info != 0)[..., None, None], float("nan"))


def robust_cholesky(K: torch.Tensor) -> torch.Tensor:
    """Cholesky of K (..., n, n) with escalating relative jitter on
    failure: each failed matrix retries with jitter growing from 1e-14
    (f64) or 1e-6 (f32) of its mean diagonal, x100 per step, up to 1, as
    the JAX package's (vmapped) loop does. Zero retries, and one host sync,
    on the well-posed path."""
    L = cholesky_nan(K)
    scale = torch.mean(torch.diagonal(K, dim1=-2, dim2=-1), dim=-1)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    j = 1e-14 if K.dtype == torch.float64 else 1e-6
    bad = torch.isnan(L).flatten(-2).any(-1)
    while bool(bad.any()) and j < 1.0:
        retry = cholesky_nan(K + (j * scale)[..., None, None] * eye)
        L = torch.where(bad[..., None, None], retry, L)
        bad = torch.isnan(L).flatten(-2).any(-1)
        j *= 100.0
    return L


def cholesky_fit(K: torch.Tensor, y: torch.Tensor, *, robust: bool = True):
    """L = chol(K); alpha = K^{-1} y. K (n, n) SPD (identity-padded for
    inactive rows), y (n, k).

    ``robust=True`` (the banks' small systems): :func:`robust_cholesky`'s
    jitter ladder and two triangular solves. ``robust=False`` (one large
    system): the blocked Cholesky (``ops/chol.chol_blocked``) and its
    diagonal-block inverses feeding :func:`solve_with_L`; a failed
    factorization gives NaN, and the caller retries on the host
    (:func:`host_jitter_retry`)."""
    if robust:
        L = robust_cholesky(K)
        a = torch.linalg.solve_triangular(L, y, upper=False)
        return L, torch.linalg.solve_triangular(L.mT, a, upper=True)
    from erl_gaussian_process_tpu_torch.ops.chol import chol_blocked

    L, dinv = chol_blocked(K, return_dinv=True)
    return L, solve_with_L(L, y, chol_dinv=dinv)


def solve_with_L(L: torch.Tensor, y: torch.Tensor, chol_dinv=None):
    """alpha = K^{-1} y from the Cholesky factor: the blocked substitution
    (``ops/trsv.cho_solve_vec``) for one (n, n) factor, two triangular
    solves for a batch. ``chol_dinv``: the blocked Cholesky's diagonal-tile
    inverses, which spare the substitution its block inversion."""
    if L.dim() == 2:
        from erl_gaussian_process_tpu_torch.ops.trsv import cho_solve_vec

        return cho_solve_vec(L, y, chol_dinv)
    a = torch.linalg.solve_triangular(L, y, upper=False)
    return torch.linalg.solve_triangular(L.mT, a, upper=True)


def mean_from_ktest(ktest: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Posterior mean(s): ktest (n, m), alpha (n, k) -> (m, k)."""
    return ktest.mT @ alpha


def variance_from_whitened(alpha_test: torch.Tensor,
                           reduced_rank: bool = False) -> torch.Tensor:
    """var_j = 1 - ||alpha_test[:, j]||^2 for normalized kernels, clamped at
    0 (rounding near a training point can push it below); the plain norm
    for reduced-rank kernels."""
    s = torch.sum(alpha_test * alpha_test, dim=0)
    return s if reduced_rank else torch.clamp(1.0 - s, min=0.0)


def whiten(L: torch.Tensor, ktest: torch.Tensor, dinv=None) -> torch.Tensor:
    """L^{-1} ktest; L (..., n, n), ktest (..., n, m).

    A triangular solve, except for one float32 factor given with ``dinv``,
    the inverses of its diagonal tiles from the blocked Cholesky
    (``ops/chol.py``): then the block forward substitution
    X_k = Dinv_k (B_k - L[k, :k] X[:k]) with the factor's own tile inverses,
    as the JAX package whitens at float32 on its TPU
    (``ops/blocked_solve.py``). Its products round as the factorization's
    did, so for queries near the training points, where 1 - ||L^{-1} k||^2
    cancels, the rounding cancels too: on the H100 at the exact-GP shape
    (n = 8192, 4096 queries, f32) the variance's max error against the f64
    fit is 2.9e-6 this way and 1.9e-5 by a triangular solve with the same
    factor (PERF.md). Float64 keeps the triangular solve."""
    if dinv is None or L.dim() != 2 or L.dtype != torch.float32:
        return torch.linalg.solve_triangular(L, ktest, upper=False)
    n = L.shape[0]
    tile = dinv.shape[1]
    out = torch.empty_like(ktest)
    for lo in range(0, n, tile):
        hi = min(n, lo + tile)
        rhs = ktest[lo:hi]
        if lo:
            rhs = torch.addmm(rhs, L[lo:hi, :lo], out[:lo], alpha=-1.0)
        torch.matmul(dinv[lo:hi, :hi - lo], rhs, out=out[lo:hi])
    return out


def with_tile_inverses(state):
    """An exact GP's state (a NamedTuple with ``L`` and ``dinv``) loaded
    from a checkpoint, which does not store ``dinv``: at float32 the
    inverses of its factor's diagonal tiles are rebuilt, for
    :func:`whiten`."""
    if state.L.dtype != torch.float32:
        return state
    from erl_gaussian_process_tpu_torch.ops.chol import diag_tile_inverses

    return state._replace(dinv=diag_tile_inverses(state.L))


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
