"""Stationary kernels and their grams (counterpart of
``erl_gaussian_process_tpu/kernels/stationary.py``).

Kernel families, all unit variance:

- ``rbf``      : k(r) = exp(-r^2 / (2 s^2))
- ``ou``       : k(r) = exp(-r / s)
- ``matern32`` : k(r) = (1 + c r) exp(-c r),  c = sqrt(3)/s

The family math is written once, in ``ops/gram.apply_family`` (the plain
version of ``csrc/family.cuh``); the registry's ``cross`` functions and
``cross_gram`` both use it. Inputs are row-major ``(n, d)``.
"""

from __future__ import annotations

import torch

from erl_gaussian_process_tpu_torch.kernels.base import (
    get_kernel,
    mixture_params,
    register_kernel,
)
from erl_gaussian_process_tpu_torch.ops.gram import (
    apply_family,
    cross_gram_cuda,
    pairwise_sqdist,
)


def _family_cross(name: str):
    def cross(x1, x2, scale):
        return apply_family(name, pairwise_sqdist(x1, x2), float(scale))
    return cross


for _name in ("rbf", "ou", "matern32"):
    register_kernel(_name, cross=_family_cross(_name))


def register_scale_mixture(base: str, scale_mix: float, weights: tuple) -> str:
    """Register (idempotently) a scale-mixture kernel over one base family
    and return its registry name: ``k_mix(r; s) = sum_i w_i k(r; s *
    scale_mix**i) / sum_i w_i`` (the contract of the JAX package,
    docs/parity.md)."""
    total = float(sum(weights))
    wn = tuple(float(w) / total for w in weights)
    ratios = tuple(float(scale_mix) ** i for i in range(len(wn)))
    name = "mix(%s;%g;%s)" % (base, float(scale_mix),
                              ",".join("%g" % w for w in weights))
    from erl_gaussian_process_tpu_torch.kernels import base as _base
    if name in _base._MIXTURES:
        return name
    _base._MIXTURES[name] = (base, ratios, wn)
    register_kernel(name, cross=_family_cross(name))
    return name


def kernel_fn(name: str):
    """Return the plain k(x1, x2, scale) -> (n, m) of a kernel name."""
    return get_kernel(name)["cross"]


def cross_gram(name: str, x1, x2, scale, mask1=None) -> torch.Tensor:
    """K[i, j] = k(x1_i, x2_j); rows with mask1 False are zeroed.

    Every registered family and mixture goes through ``cross_gram_cuda``:
    the gram kernel for CUDA tensors, its plain version for CPU tensors."""
    if x1.dim() == 2 and (name in ("rbf", "ou", "matern32")
                          or mixture_params(name) is not None):
        k = cross_gram_cuda(name, x1, x2, scale)
    else:
        k = kernel_fn(name)(x1, x2, scale)
    if mask1 is not None:
        k = torch.where(mask1[:, None], k, torch.zeros_like(k))
    return k


def train_gram(name: str, x, var, scale, mask=None) -> torch.Tensor:
    """K = k(x, x) + diag(var), identity-padded outside ``mask``."""
    k = kernel_fn(name)(x, x, scale)
    n = x.shape[0]
    k = k + torch.diag(var.to(k.dtype))
    if mask is not None:
        m2 = mask[:, None] & mask[None, :]
        eye = torch.eye(n, dtype=k.dtype, device=k.device)
        k = torch.where(m2, k, eye)
    return k
