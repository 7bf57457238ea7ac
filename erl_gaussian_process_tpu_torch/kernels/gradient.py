"""Joint value/gradient grams for GPs with derivative observations
(counterpart of ``erl_gaussian_process_tpu/kernels/gradient.py``).

Layout, as in the JAX package and the reference:

- train gram rows/cols: ``[values(n); grad-dim0(n); grad-dim1(n); ...]``
  (dim-major gradient blocks; every sample has a gradient slot, and
  unflagged slots are masked to identity rows);
- test gram columns: ``[means(m); grad-dim0(m); ...]``.

Noise: value diagonal += ``var_x + var_y``, gradient diagonal +=
``var_grad``. The prior gradient variance of the predictive formulas is
``3 / scale^2`` for every family (the reference's Matern-3/2 quirk, kept for
parity). OU has no gradient gram (not differentiable at 0). Inputs are
row-major ``(n, d)`` tensors.
"""

from __future__ import annotations

import math

import torch

from erl_gaussian_process_tpu_torch.kernels.base import (
    mixture_params,
    resolve_kernel_name,
)


def gradient_prior_variance(scale: float) -> float:
    """Prior variance of each gradient component: 3/scale^2."""
    return 3.0 / (scale * scale)


def _rbf_blocks(x1, x2, scale):
    """k, dk/dx2, d2k/dx1 dx2 for the RBF kernel k = exp(-|d|^2 / 2 s^2)."""
    inv_s2 = 1.0 / (scale * scale)
    diff = x1[:, None, :] - x2[None, :, :]            # (n, m, d)
    r2 = torch.sum(diff * diff, dim=-1)
    k = torch.exp(-0.5 * inv_s2 * r2)
    dk = diff * (inv_s2 * k)[..., None]
    eye = torch.eye(x1.shape[-1], dtype=k.dtype, device=k.device)
    d2k = (eye[None, None] * inv_s2
           - diff[..., :, None] * diff[..., None, :] * (inv_s2 * inv_s2)) \
        * k[..., None, None]
    return k, dk, d2k


def _matern32_blocks(x1, x2, scale):
    """Matern-3/2: k = (1 + c r) e^{-c r}, c = sqrt(3)/s;
    dk/dx2_l = c^2 d_l e^{-cr}; d2k = c^2 e^{-cr} (delta_kl - c d_k d_l / r)."""
    c = math.sqrt(3.0) / scale
    diff = x1[:, None, :] - x2[None, :, :]
    r = torch.sqrt(torch.sum(diff * diff, dim=-1))
    e = torch.exp(-c * r)
    k = (1.0 + c * r) * e
    dk = diff * ((c * c) * e)[..., None]
    eye = torch.eye(x1.shape[-1], dtype=k.dtype, device=k.device)
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    outer = diff[..., :, None] * diff[..., None, :] / safe_r[..., None, None]
    d2k = (c * c) * e[..., None, None] * (eye[None, None] - c * outer)
    return k, dk, d2k


_GRAD_BLOCKS = {"rbf": _rbf_blocks, "matern32": _matern32_blocks}


def _family_blocks(base: str):
    try:
        return _GRAD_BLOCKS[base]
    except KeyError:
        raise NotImplementedError(
            f"kernel {base!r} has no gradient gram (OU is not "
            "differentiable at 0)") from None


def _blocks(name, x1, x2, scale):
    """(k, dk, d2k) of a family or a registered mixture (differentiation is
    linear: a mixture's blocks are the weighted sums of its components')."""
    key = resolve_kernel_name(name)
    mix = mixture_params(key)
    if mix is None:
        return _family_blocks(key)(x1, x2, scale)
    base, ratios, weights = mix
    fn = _family_blocks(base)
    k, dk, d2k = fn(x1, x2, scale * ratios[0])
    k, dk, d2k = weights[0] * k, weights[0] * dk, weights[0] * d2k
    for w, m in zip(weights[1:], ratios[1:]):
        kc, dkc, d2kc = fn(x1, x2, scale * m)
        k, dk, d2k = k + w * kc, dk + w * dkc, d2k + w * d2kc
    return k, dk, d2k


def _assemble(k, dk, d2k, neg_row_grad: bool):
    """The joint gram [[Kff, Kfg], [Kgf, Kgg]] with dim-major gradient
    blocks; gradient ROWS differentiate w.r.t. x1, so their
    value-covariances flip sign relative to dk (= d/dx2)."""
    n, m, d = dk.shape
    kfg = dk.permute(0, 2, 1).reshape(n, d * m)
    kgf = (-dk if neg_row_grad else dk).permute(2, 0, 1).reshape(d * n, m)
    kgg = d2k.permute(2, 0, 3, 1).reshape(d * n, d * m)
    return torch.cat([torch.cat([k, kfg], dim=1),
                      torch.cat([kgf, kgg], dim=1)], dim=0)


def joint_mask(sample_mask, grad_mask, d: int):
    """Row-activity mask of the joint system: values then d gradient
    blocks."""
    return torch.cat([sample_mask] + [grad_mask] * d, dim=0)


def train_gram_with_gradient(name, x, var_x, var_y, var_grad, sample_mask,
                             grad_mask, scale):
    """Joint train gram, identity-padded outside the active rows. x (n, d);
    var_* (n,); masks (n,) bool. Returns (n(1+d), n(1+d))."""
    n, d = x.shape
    big = _assemble(*_blocks(name, x, x, scale), neg_row_grad=True)
    noise = torch.cat([var_x + var_y] + [var_grad] * d).to(big.dtype)
    big = big + torch.diag(noise)
    act = joint_mask(sample_mask, grad_mask, d)
    eye = torch.eye(n * (1 + d), dtype=big.dtype, device=big.device)
    return torch.where(act[:, None] & act[None, :], big, eye)


def cross_gram_with_gradient(name, x_train, x_test, scale, sample_mask,
                             grad_mask, with_test_grad: bool,
                             with_train_grad: bool = True):
    """Joint cross gram: rows the train joint system (value rows only when
    ``with_train_grad`` is False), columns the queries (means, then
    dim-major gradient columns when ``with_test_grad``). Masked-out train
    rows are zeroed. Returns (n or n(1+d), m or m(1+d))."""
    n, d = x_train.shape
    m = x_test.shape[0]
    k, dk, d2k = _blocks(name, x_train, x_test, scale)
    if with_train_grad and with_test_grad:
        big = _assemble(k, dk, d2k, neg_row_grad=True)
    elif with_train_grad:
        big = torch.cat([k, (-dk).permute(2, 0, 1).reshape(d * n, m)], dim=0)
    elif with_test_grad:
        big = torch.cat([k, dk.permute(0, 2, 1).reshape(n, d * m)], dim=1)
    else:
        big = k
    act = joint_mask(sample_mask, grad_mask, d) if with_train_grad \
        else sample_mask
    return torch.where(act[:, None], big, torch.zeros_like(big))
