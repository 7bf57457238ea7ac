"""Covariance kernels (counterpart of ``erl_gaussian_process_tpu/kernels``,
main-path subset: registry, the stationary families and scale mixtures).
All kernels are unit-variance (``k(x, x) = 1``)."""

from erl_gaussian_process_tpu_torch.kernels.base import (
    KernelSetting,
    get_kernel,
    mixture_params,
    register_kernel,
    resolve_kernel_name,
    resolve_kernel_setting,
)
from erl_gaussian_process_tpu_torch.kernels.stationary import (
    cross_gram,
    kernel_fn,
    register_scale_mixture,
    train_gram,
)
from erl_gaussian_process_tpu_torch.ops.gram import pairwise_sqdist

__all__ = [
    "KernelSetting",
    "get_kernel",
    "mixture_params",
    "register_kernel",
    "register_scale_mixture",
    "resolve_kernel_name",
    "resolve_kernel_setting",
    "cross_gram",
    "kernel_fn",
    "pairwise_sqdist",
    "train_gram",
]
