"""Marginal-likelihood kernel-scale selection (counterpart of
``erl_gaussian_process_tpu/utils/model_selection.py``).

The criterion is the exact negative log marginal likelihood of the
masked-GP model

    NLML(s) = 0.5 sum_q y_q^T alpha_q + q * sum_i log L_ii
              + 0.5 * n_valid * q * log(2 pi)

(the multi-output form with a shared kernel/L and per-column alpha, as the
vanilla GP models it). Masked rows are identity rows of the gram with
zeroed y, so they contribute log(1) = 0 and nothing to the quadratic
term.

Each sweep evaluates S candidate scales at once: the grams, Cholesky
factors and solves are plain torch ops batched over the candidates
(cuBLAS/cuSOLVER on the card), as the JAX module leaves them to XLA under
``vmap``. The SPGP criterion's cross-gram k(P, x) goes through the gram
kernel (``ops/gram.GramScale``, one launch a candidate), as the JAX
module's ``cross_gram`` routes it. ``fit_scale*`` runs Adam on log(scale)
with the gradient through the same sweep code: torch autograd through the
plain ops, and ``GramScale``'s plain-PyTorch backward for the kernel's
gram. Every entry point runs on ``device`` (the card unless the caller
names another) at the dtype of ``x``.
"""

from __future__ import annotations

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.models.gp_core import (
    DEFAULT_DEVICE,
    cholesky_nan,
    resolve_device,
    use_full_fp32_matmul,
)
from erl_gaussian_process_tpu_torch.ops.gram import (
    GramScale,
    apply_family,
    pairwise_sqdist,
)

_LOG_2PI = float(np.log(2.0 * np.pi))


def _log_diag_sum(L: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def nlml_sweep(x, y, var, mask, scales, *, kernel: str):
    """Exact NLML at each candidate scale. x (n, d); y (n, q); var/mask
    (n,); scales (S,) (a tensor, which may require grad). Returns (S,)."""
    use_full_fp32_matmul()
    yv = torch.where(mask[:, None], y, torch.zeros_like(y))
    n_valid = torch.sum(mask).to(x.dtype)
    q = y.shape[1]
    n = x.shape[0]
    k = apply_family(kernel, pairwise_sqdist(x, x)[None],
                     scales[:, None, None])
    k = k + torch.diag(torch.where(mask, var, torch.zeros_like(var)))
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    K = torch.where(mask[:, None] & mask[None, :], k, eye)
    L = cholesky_nan(K)
    a = torch.cholesky_solve(yv.expand(len(scales), n, q), L)
    quad = 0.5 * torch.sum(yv * a, dim=(1, 2))
    return quad + q * _log_diag_sum(L) + 0.5 * n_valid * q * _LOG_2PI


def nlml_sweep_nigp(x, y, grad, var_x, var_y, var_grad, sample_mask,
                    grad_mask, scales, *, kernel: str):
    """Exact NLML of the NIGP joint value/gradient system at each
    candidate scale. x (n, d); y (n, q); grad (n, d, q); var_* (n,);
    masks (n,) bool; scales (S,). Returns (S,). The joint observation
    vector is the [y; dim-major grads] packing ``nigp_fit`` solves
    against; masked joint rows are identity rows with zeroed observations,
    so they drop out of both terms."""
    from erl_gaussian_process_tpu_torch.kernels.gradient import (
        joint_mask,
        train_gram_with_gradient,
    )
    from erl_gaussian_process_tpu_torch.models.noisy_input_gp import (
        pack_alpha,
    )

    use_full_fp32_matmul()
    d = x.shape[1]
    obs = pack_alpha(y, grad, sample_mask, grad_mask)
    n_valid = torch.sum(joint_mask(sample_mask, grad_mask, d)).to(x.dtype)
    q = y.shape[1]

    def zero_outside(v, m):
        return torch.where(m, v, torch.zeros_like(v))

    K = torch.stack([train_gram_with_gradient(
        kernel, x, zero_outside(var_x, sample_mask),
        zero_outside(var_y, sample_mask), zero_outside(var_grad, grad_mask),
        sample_mask, grad_mask, s) for s in scales])
    L = cholesky_nan(K)
    a = torch.cholesky_solve(obs.expand(len(scales), *obs.shape), L)
    quad = 0.5 * torch.sum(obs * a, dim=(1, 2))
    return quad + q * _log_diag_sum(L) + 0.5 * n_valid * q * _LOG_2PI


def nlml_sweep_spgp(pseudo, x, y, var, mask, scales, *, kernel: str):
    """Exact FITC NLML at each candidate scale, for the SPGP model with
    fixed pseudo points (the occupancy map's configuration).

    The FITC marginal is y ~ N(0, Q_NN + diag(lambda + var)) with
    Q_NN = K_NM K_M^{-1} K_MN and lambda_i = 1 - ||L_M^{-1} k_i||^2 (the
    same residual, clamp at 0 included, as the update). Evaluated by
    Woodbury in the M-rank form: with V = L_M^{-1} K_MN and
    W = V / sqrt(D), D = lambda + var,

        log|Sigma| = sum_i log D_i + log|I_M + W W^T|
        y^T Sigma^{-1} y = y^T D^{-1} y - ||chol(A)^{-1} (W y/sqrt(D))||^2

    so each candidate costs one (M, M) Cholesky pair and (M, n) products.
    K_MN is the gram kernel's (one launch a candidate on the card). Masked
    rows get V column 0, D = 1 and y = 0 and drop out of both terms.

    pseudo (M, d); x (n, d); y (n, q); var/mask (n,); scales (S,).
    Returns (S,)."""
    use_full_fp32_matmul()
    yv = torch.where(mask[:, None], y, torch.zeros_like(y))
    n_valid = torch.sum(mask).to(x.dtype)
    q = y.shape[1]
    m = pseudo.shape[0]
    eye = torch.eye(m, dtype=pseudo.dtype, device=pseudo.device)
    km = apply_family(kernel, pairwise_sqdist(pseudo, pseudo)[None],
                      scales[:, None, None])
    L_m = cholesky_nan(km)
    kmn = torch.stack([GramScale.apply(kernel, pseudo, x, s)
                       for s in scales])
    V = torch.linalg.solve_triangular(L_m, kmn, upper=False)
    lam = torch.clamp(1.0 - torch.sum(V * V, dim=1), min=0.0)     # (S, n)
    D = torch.where(mask, lam + var, torch.ones_like(lam))
    sd = torch.sqrt(D)
    W = torch.where(mask, V, torch.zeros_like(V)) / sd[:, None, :]
    L_a = cholesky_nan(eye + W @ W.mT)
    wy = W @ (yv / sd[:, :, None])                                # (S, M, q)
    beta = torch.linalg.solve_triangular(L_a, wy, upper=False)
    quad = 0.5 * (torch.sum(yv * (yv / D[:, :, None]), dim=(1, 2))
                  - torch.sum(beta * beta, dim=(1, 2)))
    logdet = q * (_log_diag_sum(L_a) + 0.5 * torch.sum(torch.log(D), dim=1))
    return quad + logdet + 0.5 * n_valid * q * _LOG_2PI


def _auto_grid(x, mask, num: int = 24):
    """Default candidate grid: log-spaced from twice the median
    nearest-neighbor spacing (finest resolvable structure) to the domain
    extent. Needs >= 2 distinct valid points; coincident points (nn == 0)
    fall back to span-based bounds."""
    xv = _host(x)[_host(mask)]
    if xv.shape[0] < 2:
        raise ValueError(
            "select_scale auto grid needs >= 2 valid training points "
            f"(got {xv.shape[0]}); pass an explicit `scales` grid instead")
    span = float(np.linalg.norm(xv.max(0) - xv.min(0)))
    if not np.isfinite(span) or span <= 0.0:
        raise ValueError(
            "select_scale auto grid needs >= 2 distinct valid points "
            "(all inputs identical); pass an explicit `scales` grid")
    sub = xv[:: max(1, len(xv) // 512)]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = float(np.median(np.sqrt(d2.min(1))))
    if not np.isfinite(nn) or nn <= 0.0:
        # duplicated points: median-nn is 0 or the subsample missed all
        # distinct pairs — span-based lower bound
        nn = 5e-4 * span
    return np.geomspace(max(2.0 * nn, 1e-6 * span), span, num)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _refine_loop(sweep, scales, dtype, device, refine):
    """Evaluate the sweep, then re-grid (same size) between the best
    candidate's grid neighbors each round. NaN NLML (non-SPD at that scale
    for this noise floor) ranks last. Returns (best_scale, final scales,
    final nlml values)."""
    scales = np.asarray(scales, dtype)
    rounds = max(0, int(refine)) + 1
    for r in range(rounds):
        with torch.no_grad():
            vals = _host(sweep(torch.as_tensor(scales, device=device)))
        ranked = np.where(np.isfinite(vals), vals, np.inf)
        b = int(ranked.argmin())
        best = float(scales[b])
        lo = scales[max(b - 1, 0)]
        hi = scales[min(b + 1, len(scales) - 1)]
        if r == rounds - 1 or hi <= lo:
            break
        scales = np.geomspace(lo, hi, len(scales)).astype(scales.dtype)
    return best, scales, vals


def _inputs(device, x, y, *rest):
    """x (n, d) and y (n, q) as tensors on ``device`` at x's dtype (a 1-D
    y promoted), and the rest as tensors there (float ones at x's
    dtype)."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.atleast_2d(_host(x)), device=dev)
    y = torch.as_tensor(_host(y), dtype=x.dtype, device=dev)
    if y.ndim == 1:
        y = y[:, None]
    out = []
    for a in rest:
        t = torch.as_tensor(_host(a), device=dev)
        out.append(t if t.dtype == torch.bool else t.to(x.dtype))
    return (x, y, *out)


def _ones_mask(x):
    return torch.ones(x.shape[0], dtype=torch.bool, device=x.device)


def select_scale(x, y, var, mask=None, *, kernel: str, scales=None,
                 refine: int = 1, device=DEFAULT_DEVICE):
    """Pick the kernel scale by exact marginal likelihood.

    x (n, d); y (n, q) (a 1-D y is promoted); var (n,) observation noise;
    ``scales`` an initial candidate grid (default: :func:`_auto_grid`).
    Each ``refine`` round re-grids (same size) around the best candidate
    between its grid neighbors. Returns (best_scale, scales (S,),
    nlml (S,)) of the final round."""
    x, y, var = _inputs(device, x, y, var)
    mask = _ones_mask(x) if mask is None else \
        torch.as_tensor(_host(mask), device=x.device)
    if scales is None:
        scales = _auto_grid(x, mask)
    return _refine_loop(
        lambda s: nlml_sweep(x, y, var, mask, s, kernel=kernel),
        scales, _host(x).dtype, x.device, refine)


def _nigp_inputs(device, x, y, grad, var_x, var_y, var_grad, sample_mask,
                 grad_mask):
    x, y, grad, var_x, var_y, var_grad = _inputs(
        device, x, y, grad, var_x, var_y, var_grad)
    if grad.ndim == 2:
        grad = grad[:, :, None]
    sample_mask = _ones_mask(x) if sample_mask is None else \
        torch.as_tensor(_host(sample_mask), device=x.device)
    grad_mask = _ones_mask(x) if grad_mask is None else \
        torch.as_tensor(_host(grad_mask), device=x.device)
    return (x, y, grad, var_x, var_y, var_grad, sample_mask,
            grad_mask & sample_mask)


def select_scale_nigp(x, y, grad, var_x, var_y, var_grad, sample_mask=None,
                      grad_mask=None, *, kernel: str, scales=None,
                      refine: int = 1, device=DEFAULT_DEVICE):
    """Pick the kernel scale for the NIGP joint value/gradient system by
    exact marginal likelihood (:func:`nlml_sweep_nigp`), with the grid and
    refinement of :func:`select_scale`.

    x (n, d); y (n, q) (1-D promoted); grad (n, d, q) (an (n, d) grad is
    promoted for q = 1); var_* (n,) noise terms; masks (n,) bool. Returns
    (best_scale, scales (S,), nlml (S,))."""
    args = _nigp_inputs(device, x, y, grad, var_x, var_y, var_grad,
                        sample_mask, grad_mask)
    if scales is None:
        scales = _auto_grid(args[0], args[6])
    return _refine_loop(
        lambda s: nlml_sweep_nigp(*args, s, kernel=kernel),
        scales, _host(args[0]).dtype, args[0].device, refine)


def select_scale_spgp(pseudo, x, y, var, mask=None, *, kernel: str,
                      scales=None, refine: int = 1, device=DEFAULT_DEVICE):
    """Pick the kernel scale for a fixed-pseudo-point SPGP/FITC model by
    exact FITC marginal likelihood (:func:`nlml_sweep_spgp`), with the grid
    and refinement of :func:`select_scale` (the default grid from the
    samples' spacing).

    pseudo (M, d); x (n, d); y (n, q) (1-D promoted); var (n,); mask (n,)
    bool. Returns (best_scale, scales (S,), nlml (S,))."""
    x, y, var, pseudo = _inputs(device, x, y, var, np.atleast_2d(
        _host(pseudo)))
    mask = _ones_mask(x) if mask is None else \
        torch.as_tensor(_host(mask), device=x.device)
    if scales is None:
        scales = _auto_grid(x, mask)
    return _refine_loop(
        lambda s: nlml_sweep_spgp(pseudo, x, y, var, mask, s, kernel=kernel),
        scales, _host(x).dtype, x.device, refine)


# -- gradient-driven fitting ----------------------------------------------

def _fit_loop(loss_fn, log_s0: float, steps: int, lr: float, dtype, device):
    """Adam on log(scale) (``torch.optim.Adam``, the defaults of
    ``optax.adam``) with the gradient through the exact NLML, Cholesky
    included. A non-finite gradient counts as 0 (a candidate past the
    dtype's conditioning range must not poison the descent). Returns
    (best_scale, scales (steps,), nlml (steps,)), best = argmin over the
    whole trace: descent on a 1-D but non-convex criterion keeps the best
    visited, not the last."""
    log_s = torch.tensor(log_s0, dtype=dtype, device=device,
                         requires_grad=True)
    opt = torch.optim.Adam([log_s], lr=lr)
    scales, vals = [], []
    for _ in range(int(steps)):
        opt.zero_grad()
        val = loss_fn(log_s)
        val.backward()
        log_s.grad.masked_fill_(~torch.isfinite(log_s.grad), 0.0)
        scales.append(torch.exp(log_s.detach()))
        vals.append(val.detach())
        opt.step()
    scales = _host(torch.stack(scales))
    vals = _host(torch.stack(vals))
    best = int(np.argmin(np.where(np.isfinite(vals), vals, np.inf)))
    return float(scales[best]), scales, vals


def _init_scale(x, mask, init):
    if init is None:
        g = _auto_grid(x, mask)
        init = float(np.sqrt(g[0] * g[-1]))
    return float(np.log(init))


def fit_scale(x, y, var, mask=None, *, kernel: str, init=None,
              steps: int = 80, lr: float = 0.08, device=DEFAULT_DEVICE):
    """Fit the kernel scale by gradient descent on the exact NLML
    (criterion: :func:`nlml_sweep` with a singleton candidate, so the
    gradient flows through the same code the sweep ranks with). Returns
    (best_scale, per-step scales, per-step nlml)."""
    x, y, var = _inputs(device, x, y, var)
    mask = _ones_mask(x) if mask is None else \
        torch.as_tensor(_host(mask), device=x.device)
    return _fit_loop(
        lambda ls: nlml_sweep(x, y, var, mask, torch.exp(ls)[None],
                              kernel=kernel)[0],
        _init_scale(x, mask, init), steps, lr, x.dtype, x.device)


def fit_scale_nigp(x, y, grad, var_x, var_y, var_grad, sample_mask=None,
                   grad_mask=None, *, kernel: str, init=None,
                   steps: int = 80, lr: float = 0.08,
                   device=DEFAULT_DEVICE):
    """Gradient-driven scale fit for the NIGP joint value/gradient model
    (criterion: :func:`nlml_sweep_nigp`)."""
    args = _nigp_inputs(device, x, y, grad, var_x, var_y, var_grad,
                        sample_mask, grad_mask)
    return _fit_loop(
        lambda ls: nlml_sweep_nigp(*args, torch.exp(ls)[None],
                                   kernel=kernel)[0],
        _init_scale(args[0], args[6], init), steps, lr, args[0].dtype,
        args[0].device)


def fit_scale_spgp(pseudo, x, y, var, mask=None, *, kernel: str, init=None,
                   steps: int = 80, lr: float = 0.08, device=DEFAULT_DEVICE):
    """Gradient-driven scale fit for the fixed-pseudo-point FITC model
    (criterion: :func:`nlml_sweep_spgp`; its K_MN through the gram kernel
    and ``GramScale``'s backward)."""
    x, y, var, pseudo = _inputs(device, x, y, var, np.atleast_2d(
        _host(pseudo)))
    mask = _ones_mask(x) if mask is None else \
        torch.as_tensor(_host(mask), device=x.device)
    return _fit_loop(
        lambda ls: nlml_sweep_spgp(pseudo, x, y, var, mask,
                                   torch.exp(ls)[None], kernel=kernel)[0],
        _init_scale(x, mask, init), steps, lr, x.dtype, x.device)
