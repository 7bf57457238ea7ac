"""Covariance kernels (counterpart of ``erl_gaussian_process_tpu/kernels``:
registry, the stationary families, scale mixtures, the joint
value/gradient grams and the reduced-rank basis). All kernels are
unit-variance (``k(x, x) = 1``)."""

from erl_gaussian_process_tpu_torch.kernels.base import (
    KernelSetting,
    get_kernel,
    is_mixture_setting,
    kernel_names,
    mixture_params,
    register_kernel,
    resolve_kernel_name,
    resolve_kernel_setting,
    validate_kernel_setting,
)
from erl_gaussian_process_tpu_torch.kernels.gradient import (
    cross_gram_with_gradient,
    gradient_prior_variance,
    joint_mask,
    train_gram_with_gradient,
)
from erl_gaussian_process_tpu_torch.kernels.reduced_rank import (
    ReducedRankBasis,
    ReducedRankSetting,
    parse_reduced_rank_name,
    spectral_density,
)
from erl_gaussian_process_tpu_torch.kernels.stationary import (
    cross_gram,
    kernel_fn,
    pairwise_dist,
    pairwise_sqdist,
    register_scale_mixture,
    train_gram,
)

__all__ = [
    "KernelSetting",
    "get_kernel",
    "is_mixture_setting",
    "kernel_names",
    "mixture_params",
    "register_kernel",
    "register_scale_mixture",
    "resolve_kernel_name",
    "resolve_kernel_setting",
    "validate_kernel_setting",
    "cross_gram",
    "cross_gram_with_gradient",
    "gradient_prior_variance",
    "joint_mask",
    "kernel_fn",
    "pairwise_dist",
    "pairwise_sqdist",
    "train_gram",
    "train_gram_with_gradient",
    "ReducedRankBasis",
    "ReducedRankSetting",
    "parse_reduced_rank_name",
    "spectral_density",
]
