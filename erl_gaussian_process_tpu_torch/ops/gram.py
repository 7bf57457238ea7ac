"""Cross-gram K[i, j] = k(x1_i, x2_j): the hand-written CUDA kernel
(``csrc/gram.cuh``) and its plain PyTorch version.

Counterpart of ``erl_gaussian_process_tpu/ops/pallas_gram.py``. The JAX
package took its Pallas kernel only above 128x128 outputs; here every CUDA
``cross_gram`` of a registered family runs the kernel, whatever its size.
:func:`cross_gram_batched_cuda` is the same kernel over a leading member
axis: the JAX package ``vmap``s ``cross_gram`` over bank members in the
sensor GPs' routed predict. Both take an optional row mask ``mask1``: a
masked row is written as exactly 0 in the kernel itself (the JAX package's
``where`` after its kernel, fused).

The kernels' family constants (one coefficient and one weight per mixture
component) are computed once on the host in float64
(:func:`family_components`) and handed to every kernel that includes
``csrc/family.cuh`` (:func:`packed_family`, cached per name and scale).
The plain version, :func:`apply_family`, computes its formulas itself, so
the kernels' constants and the reference they are held to come from
separate code.

Both wrappers call the registered ops ``egp::cross_gram`` and
``egp::cross_gram_batched`` (``ops/_library.py``), whose CPU
implementation is the plain version and whose CUDA implementation launches
the kernel or raises; ``torch.export`` records the same ops.
:class:`GramScale` is the gram with a tensor scale and a backward for it
(plain PyTorch), for the gradient of ``utils/model_selection.py``.
"""

from __future__ import annotations

import functools
import math

import torch

from erl_gaussian_process_tpu_torch.kernels.base import mixture_params
from erl_gaussian_process_tpu_torch.ops._build import double_array, load_library
from erl_gaussian_process_tpu_torch.ops._library import define

FAMILY_IDS = {"rbf": 0, "ou": 1, "matern32": 2}
MAX_COMPONENTS = 8  # csrc/family.cuh kMaxComponents


@functools.lru_cache(maxsize=256)
def family_spec(name: str) -> tuple:
    """(base family, scale ratios, weights) of a family or registered
    mixture: what the ops take in place of the name. A plain family is
    ``(name, (1.0,), (1.0,))``. Cached per name: a registered mixture
    never changes, and an unknown name raises (and is not cached)."""
    mix = mixture_params(name)
    base, ratios, weights = (name, (1.0,), (1.0,)) if mix is None else mix
    if base not in FAMILY_IDS:
        raise KeyError(f"gram: unknown kernel family {name!r}")
    return base, tuple(float(r) for r in ratios), tuple(float(w)
                                                         for w in weights)


def _base_family(base: str, r2, scale):
    if base == "rbf":
        return torch.exp(r2 * (-0.5 / (scale * scale)))
    r = torch.sqrt(r2)
    if base == "ou":
        return torch.exp(-r / scale)
    if base == "matern32":
        cr = (math.sqrt(3.0) / scale) * r
        return (1.0 + cr) * torch.exp(-cr)
    raise KeyError(f"gram: unknown kernel family {base!r}")


def apply_spec(base: str, ratios, weights, r2: torch.Tensor, scale):
    """Kernel value from squared distance for a :func:`family_spec`: the
    base family, or sum_i w_i k(r; scale * ratio_i) for a mixture.
    ``scale`` is a float or a tensor that broadcasts against ``r2``."""
    if tuple(ratios) == (1.0,) and tuple(weights) == (1.0,):
        return _base_family(base, r2, scale)
    out = weights[0] * _base_family(base, r2, scale * ratios[0])
    for w, m in zip(weights[1:], ratios[1:]):
        out = out + w * _base_family(base, r2, scale * m)
    return out


def apply_family(name: str, r2: torch.Tensor, scale) -> torch.Tensor:
    """Kernel value from squared distance (unit variance), for the three
    families and their registered scale mixtures — the plain version of
    ``csrc/family.cuh`` (counterpart of ``pallas_gram._apply_family``). It
    computes its own formulas, independent of :func:`family_components`."""
    return apply_spec(*family_spec(name), r2, scale)


def _coefficient(base: str, s: float) -> float:
    """A component's constant at scale s: rbf -0.5 / s^2, ou 1 / s,
    matern32 sqrt(3) / s (``csrc/family.cuh``)."""
    if base == "rbf":
        return -0.5 / (s * s)
    if base == "ou":
        return 1.0 / s
    return math.sqrt(3.0) / s


def family_components(name: str, scale: float) -> tuple:
    """(base family, coefficients, weights) of a family or registered
    mixture at ``scale``, in float64: component i has scale s_i = scale *
    ratio_i and the coefficient :func:`_coefficient` of s_i. The kernels'
    constants come from here (:func:`packed_family`)."""
    return _components(*family_spec(name), float(scale))


def _components(base, ratios, weights, scale: float) -> tuple:
    return (base, tuple(_coefficient(base, scale * r) for r in ratios),
            tuple(float(w) for w in weights))


def pairwise_sqdist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared distances in the difference form (exact for far-point
    padding). x1: (..., m, d), x2: (..., n, d) -> (..., m, n)."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def cross_gram_plain(name: str, x1: torch.Tensor, x2: torch.Tensor,
                     scale: float, mask1=None) -> torch.Tensor:
    """The plain PyTorch version of the gram kernel, on any device; leading
    axes of x1 and x2 are member axes (the plain version of
    :func:`cross_gram_batched_cuda` as well). Rows whose ``mask1`` (x1's
    shape without d) is False are 0."""
    return _plain_spec(x1, x2, mask1, *family_spec(name), float(scale))


def _plain_spec(x1, x2, mask1, base, ratios, weights, scale):
    k = apply_spec(base, ratios, weights, pairwise_sqdist(x1, x2), scale)
    if mask1 is not None:
        k = torch.where(mask1[..., :, None], k, torch.zeros_like(k))
    return k


def packed_family(name: str, scale: float) -> tuple:
    """(family id, component count, coefficients, weights) as a C entry
    takes them: the float64 constants of :func:`family_components`, which
    each launch casts to its dtype once."""
    return packed_spec(*family_spec(name), float(scale))


@functools.lru_cache(maxsize=256)
def packed_spec(base: str, ratios: tuple, weights: tuple,
                scale: float) -> tuple:
    """:func:`packed_family` of a :func:`family_spec`, built once per spec
    and scale; the ctypes arrays are read, never written, by the
    kernels."""
    _, coefs, weights = _components(base, ratios, weights, scale)
    if len(coefs) > MAX_COMPONENTS:
        raise ValueError(
            f"gram: a {base} mixture of {len(coefs)} components; the CUDA "
            f"kernels take at most {MAX_COMPONENTS}")
    return (FAMILY_IDS[base], len(coefs), double_array(coefs),
            double_array(weights))


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


def check_devices(what: str, *tensors) -> None:
    """Raise for a tensor that lies neither on the CPU nor on a CUDA device
    (a meta tensor would reach the op's fake implementation): the
    wrappers take the plain version or launch the kernel, nothing else."""
    if any(t.device.type not in ("cpu", "cuda") for t in tensors):
        check_cuda_operands(what, tensors[0].dtype, *tensors)


def _check_mask(what: str, mask1, x1: torch.Tensor) -> None:
    if mask1 is None:
        return
    if mask1.device != x1.device or mask1.dtype != torch.bool \
            or not mask1.is_contiguous() or mask1.shape != x1.shape[:-1]:
        raise ValueError(f"{what}: mask1 must be a contiguous bool tensor of "
                         f"shape {tuple(x1.shape[:-1])} on the operands' "
                         f"device, got {mask1.dtype} {tuple(mask1.shape)} on "
                         f"{mask1.device}")


def cross_gram_cuda(name: str, x1: torch.Tensor, x2: torch.Tensor,
                    scale, mask1=None) -> torch.Tensor:
    """K[i, j] = k(x1_i, x2_j), 0 on the rows whose ``mask1`` (m,) is
    False. x1: (m, d); x2: (n, d) -> (m, n).

    The op ``egp::cross_gram``: CPU tensors take :func:`cross_gram_plain`;
    CUDA tensors launch ``csrc/gram.cuh`` (counted in
    ``cross_gram_cuda.launches``) or raise."""
    check_devices("cross_gram_cuda", x1, x2)
    return torch.ops.egp.cross_gram(x1, x2, mask1, *family_spec(name),
                                    float(scale))


cross_gram_cuda.launches = 0


def cross_gram_batched_cuda(name: str, x1: torch.Tensor, x2: torch.Tensor,
                            scale, mask1=None) -> torch.Tensor:
    """K[b, i, j] = k(x1[b, i], x2[b, j]), 0 on the rows whose ``mask1``
    (B, m) is False. x1: (B, m, d); x2: (B, n, d) -> (B, m, n).

    The op ``egp::cross_gram_batched``: CPU tensors take
    :func:`cross_gram_plain`; CUDA tensors launch ``csrc/gram.cuh`` once
    over all members (counted in ``cross_gram_batched_cuda.launches``) or
    raise."""
    check_devices("cross_gram_batched_cuda", x1, x2)
    return torch.ops.egp.cross_gram_batched(x1, x2, mask1,
                                            *family_spec(name), float(scale))


cross_gram_batched_cuda.launches = 0


def _gram_cuda(x1, x2, mask1, base, ratios, weights, scale):
    check_cuda_operands("cross_gram_cuda", x1.dtype, x1, x2)
    if x1.dim() != 2 or x2.dim() != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"cross_gram_cuda: shapes {tuple(x1.shape)} and "
                         f"{tuple(x2.shape)} (want (m, d) and (n, d))")
    _check_mask("cross_gram_cuda", mask1, x1)
    m, d = x1.shape
    n = x2.shape[0]
    if m == 0 or n == 0 or d == 0:
        raise ValueError(f"cross_gram_cuda: empty operand, m={m} n={n} d={d}")
    out = _launch_gram((base, tuple(ratios), tuple(weights)), x1, x2, mask1,
                       scale, 1, m, n, d)[0]
    cross_gram_cuda.launches += 1
    return out


def _gram_batched_cuda(x1, x2, mask1, base, ratios, weights, scale):
    check_cuda_operands("cross_gram_batched_cuda", x1.dtype, x1, x2)
    if x1.dim() != 3 or x2.dim() != 3 or x1.shape[0] != x2.shape[0] \
            or x1.shape[2] != x2.shape[2]:
        raise ValueError(f"cross_gram_batched_cuda: shapes {tuple(x1.shape)} "
                         f"and {tuple(x2.shape)} (want (B, m, d) and "
                         "(B, n, d))")
    _check_mask("cross_gram_batched_cuda", mask1, x1)
    b, m, d = x1.shape
    n = x2.shape[1]
    if b == 0 or m == 0 or n == 0 or d == 0:
        raise ValueError(f"cross_gram_batched_cuda: empty operand, B={b} "
                         f"m={m} n={n} d={d}")
    out = _launch_gram((base, tuple(ratios), tuple(weights)), x1, x2, mask1,
                       scale, b, m, n, d)
    cross_gram_batched_cuda.launches += 1
    return out


def _launch_gram(spec, x1, x2, mask1, scale, batch, m, n, d) -> torch.Tensor:
    """One launch of the gram kernel over ``batch`` members -> (batch, m,
    n); the callers have checked the operands."""
    fam, ncomp, coefs, weights = packed_spec(*spec, float(scale))
    out = torch.empty((batch, m, n), dtype=x1.dtype, device=x1.device)
    kl = load_library()
    fn = kl.lib.egp_gram_f32 if x1.dtype == torch.float32 else \
        kl.lib.egp_gram_f64
    code = fn(x1.data_ptr(), x2.data_ptr(),
              None if mask1 is None else mask1.data_ptr(), out.data_ptr(),
              batch, m, n, d, fam, ncomp, coefs, weights, x1.device.index,
              torch.cuda.current_stream(x1.device).cuda_stream)
    kl.check(code, "gram kernel launch")
    return out


define("cross_gram(Tensor x1, Tensor x2, Tensor? mask1, str family, "
       "float[] ratios, float[] weights, float scale) -> Tensor",
       _plain_spec, _gram_cuda,
       lambda x1, x2, mask1, *_: x1.new_empty((x1.shape[0], x2.shape[0])))
define("cross_gram_batched(Tensor x1, Tensor x2, Tensor? mask1, str family, "
       "float[] ratios, float[] weights, float scale) -> Tensor",
       _plain_spec, _gram_batched_cuda,
       lambda x1, x2, mask1, *_: x1.new_empty(
           (x1.shape[0], x1.shape[1], x2.shape[1])))


def _dgram_dscale(spec, r2, scale: float):
    """dk/ds of :func:`apply_spec` at a float scale (plain PyTorch): rbf
    k r^2 / s^3, ou k r / s^2, matern32 c^2 r^2 exp(-c r) / s with
    c = sqrt(3) / s, each mixture component times its weight and ratio."""
    base, ratios, weights = spec
    out = 0.0
    for w, m in zip(weights, ratios):
        s = scale * m
        if base == "rbf":
            d = torch.exp(r2 * (-0.5 / (s * s))) * r2 / (s * s * s)
        elif base == "ou":
            r = torch.sqrt(r2)
            d = torch.exp(-r / s) * r / (s * s)
        else:
            cr = (math.sqrt(3.0) / s) * torch.sqrt(r2)
            d = cr * cr * torch.exp(-cr) / s
        out = out + (w * m) * d
    return out


class GramScale(torch.autograd.Function):
    """K = :func:`cross_gram_cuda` (name, x1, x2, scale, mask1) with
    ``scale`` a 0-dim tensor: the forward is the gram op (the kernel on
    CUDA), the backward dL/dscale = sum(dL/dK * dK/ds) in plain PyTorch;
    x1 and x2 get no gradient. Usage: ``GramScale.apply(name, x1, x2,
    scale, mask1)``."""

    @staticmethod
    def forward(ctx, name, x1, x2, scale, mask1=None):
        ctx.spec = family_spec(name)
        ctx.save_for_backward(x1, x2, scale, mask1)
        return torch.ops.egp.cross_gram(x1, x2, mask1, *ctx.spec,
                                        float(scale))

    @staticmethod
    def backward(ctx, grad):
        x1, x2, scale, mask1 = ctx.saved_tensors
        dk = _dgram_dscale(ctx.spec, pairwise_sqdist(x1, x2), float(scale))
        if mask1 is not None:
            dk = torch.where(mask1[:, None], dk, torch.zeros_like(dk))
        return None, None, None, torch.sum(grad * dk).reshape(
            scale.shape).to(scale.dtype), None
