"""Cross-gram K[i, j] = k(x1_i, x2_j): the hand-written CUDA kernel
(``csrc/gram.cu``) and its plain PyTorch version.

Counterpart of ``erl_gaussian_process_tpu/ops/pallas_gram.py``. The JAX
package took its Pallas kernel only above 128x128 outputs; here every CUDA
``cross_gram`` of a registered family runs the kernel, whatever its size.
"""

from __future__ import annotations

import math

import torch

from erl_gaussian_process_tpu_torch.kernels.base import mixture_params
from erl_gaussian_process_tpu_torch.ops._build import double_array, load_library

FAMILY_IDS = {"rbf": 0, "ou": 1, "matern32": 2}
MAX_COMPONENTS = 8  # csrc/family.cuh kMaxComponents


def apply_family(name: str, r2: torch.Tensor, scale: float) -> torch.Tensor:
    """Kernel value from squared distance (unit variance), for the three
    families and their registered scale mixtures — the plain version of
    ``csrc/family.cuh`` (counterpart of ``pallas_gram._apply_family``)."""
    mix = mixture_params(name)
    if mix is not None:
        base, ratios, weights = mix
        out = weights[0] * apply_family(base, r2, scale * ratios[0])
        for w, m in zip(weights[1:], ratios[1:]):
            out = out + w * apply_family(base, r2, scale * m)
        return out
    if name == "rbf":
        return torch.exp(r2 * (-0.5 / (scale * scale)))
    r = torch.sqrt(r2)
    if name == "ou":
        return torch.exp(-r / scale)
    if name == "matern32":
        cr = (math.sqrt(3.0) / scale) * r
        return (1.0 + cr) * torch.exp(-cr)
    raise KeyError(f"gram: unknown kernel family {name!r}")


def pairwise_sqdist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared distances in the difference form (exact for far-point
    padding). x1: (m, d), x2: (n, d) -> (m, n)."""
    diff = x1[:, None, :] - x2[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def cross_gram_plain(name: str, x1: torch.Tensor, x2: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The plain PyTorch version of the gram kernel, on any device."""
    return apply_family(name, pairwise_sqdist(x1, x2), float(scale))


def family_args(name: str):
    """(family id, ratios, weights) of a family or registered mixture, as
    the kernel takes them."""
    mix = mixture_params(name)
    if mix is None:
        if name not in FAMILY_IDS:
            raise KeyError(f"gram: unknown kernel family {name!r}")
        return FAMILY_IDS[name], (1.0,), (1.0,)
    base, ratios, weights = mix
    if len(ratios) > MAX_COMPONENTS:
        raise ValueError(
            f"gram: mixture {name!r} has {len(ratios)} components; the CUDA "
            f"kernels take at most {MAX_COMPONENTS}")
    return FAMILY_IDS[base], tuple(ratios), tuple(weights)


def check_cuda_operands(what: str, dtype, *tensors) -> None:
    """Raise unless every tensor lies on the same CUDA device, has the given
    floating dtype and is contiguous."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {dtype} (the kernel takes float32 "
                        "and float64)")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device, "
                             f"got {[str(t.device) for t in tensors]}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: mixed dtypes {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def cross_gram_cuda(name: str, x1: torch.Tensor, x2: torch.Tensor,
                    scale) -> torch.Tensor:
    """K[i, j] = k(x1_i, x2_j). x1: (m, d); x2: (n, d) -> (m, n).

    CPU tensors take :func:`cross_gram_plain`; CUDA tensors launch
    ``csrc/gram.cu`` (counted in ``cross_gram_cuda.launches``) or raise."""
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return cross_gram_plain(name, x1, x2, scale)
    check_cuda_operands("cross_gram_cuda", x1.dtype, x1, x2)
    if x1.dim() != 2 or x2.dim() != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"cross_gram_cuda: shapes {tuple(x1.shape)} and "
                         f"{tuple(x2.shape)} (want (m, d) and (n, d))")
    fam, ratios, weights = family_args(name)
    m, d = x1.shape
    n = x2.shape[0]
    if m == 0 or n == 0 or d == 0:
        raise ValueError(f"cross_gram_cuda: empty operand, m={m} n={n} d={d}")
    out = torch.empty((m, n), dtype=x1.dtype, device=x1.device)
    kl = load_library()
    fn = kl.lib.egp_gram_f32 if x1.dtype == torch.float32 else \
        kl.lib.egp_gram_f64
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    code = fn(x1.data_ptr(), x2.data_ptr(), out.data_ptr(), m, n, d, fam,
              len(ratios), double_array(ratios), double_array(weights),
              float(scale), x1.device.index, stream)
    kl.check(code, "gram kernel launch")
    cross_gram_cuda.launches += 1
    return out


cross_gram_cuda.launches = 0
