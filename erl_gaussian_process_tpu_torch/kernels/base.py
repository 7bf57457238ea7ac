"""Kernel registry and settings (counterpart of
``erl_gaussian_process_tpu/kernels/base.py``: settings, name resolution,
scale-mixture resolution and validation; pure Python).

Replaces the reference's string-keyed covariance factory
(``Covariance::CreateCovariance(kernel_type, setting)``,
reference: src/vanilla_gp.cpp:820) with a plain name→family registry.
Reference C++ type names (e.g. ``erl::covariance::Matern32<float, 2>``) are
accepted and normalized (reference: config/spgp_occupancy_map_2d.yaml:2).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List

import numpy as np

_REGISTRY: Dict[str, Dict[str, Callable]] = {}

# erl::covariance::RadialBiasFunction<double, 1> -> radial_bias_function
_CPP_NAME_RE = re.compile(r"^erl::covariance::(\w+)\s*<.*>$")
_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")

_ALIASES = {
    "radial_bias_function": "rbf",
    "squared_exponential": "rbf",
    "ornstein_uhlenbeck": "ou",
    "exponential": "ou",
    "matern32": "matern32",
}


@dataclasses.dataclass
class KernelSetting:
    """Mirror of ``covariance::Covariance<Dtype>::Setting``
    (fields observable in reference: config/spgp_occupancy_map_2d.yaml:4-7).

    ``x_dim = -1`` means "any dimension" (reference: src/noisy_input_gp.cpp:709).
    ``scale_mix``/``weights`` exist for scale-mixture kernels in the reference
    YAML schema; kept for config round-trip compatibility.
    """

    x_dim: int = -1
    scale: float = 1.0
    scale_mix: float = 1.0
    weights: List[float] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelSetting":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in known})


# Scale-mixture kernel table: registered name -> (base family, component
# scale ratios (tuple), normalized weights (tuple)). Populated by
# ``stationary.register_scale_mixture``.
_MIXTURES: Dict[str, tuple] = {}


def mixture_params(name: str):
    """(base, ratios, weights) of a registered mixture kernel, else None."""
    return _MIXTURES.get(name)


def _mixture_terms(ks):
    """Normalize a KernelSetting's mixture fields to (scale_mix, weights)."""
    mix = float(getattr(ks, "scale_mix", 1.0))
    w = getattr(ks, "weights", None)
    w = [] if w is None else list(np.asarray(w).ravel()) if not isinstance(
        w, (list, tuple)) else list(w)
    return mix, [float(v) for v in w]


def is_mixture_setting(ks) -> bool:
    """True when the setting asks for a scale mixture (non-empty
    ``weights``; the neutral values are scale_mix=1, weights=[])."""
    _, w = _mixture_terms(ks)
    return len(w) > 0


def validate_kernel_setting(ks, context: str = "") -> None:
    """For code paths that cannot take a scale mixture (the reduced-rank
    basis is single-scale): raises on non-empty ``weights``, and on the
    half-specified ``scale_mix != 1`` with no weights."""
    mix, w = _mixture_terms(ks)
    if mix != 1.0 and len(w) == 0:
        raise ValueError(
            f"{context or 'kernel'}: scale_mix={mix!r} with empty weights "
            "specifies no mixture components — set weights (one per "
            "component) or leave scale_mix at 1")
    if len(w) > 0:
        raise NotImplementedError(
            f"{context or 'kernel'}: scale_mix={mix!r} / weights={w!r} "
            "request a scale-mixture kernel, which this code path cannot "
            "consume (reduced-rank bases are single-scale) — use "
            "scale_mix: 1 and weights: [] here; plain (non-reduced-rank) "
            "kernel types support mixtures")


def resolve_kernel_setting(kernel_type: str, ks, context: str = "") -> str:
    """Resolve a kernel-type string + Setting into a registry name,
    materializing a scale-mixture kernel when the setting's
    ``scale_mix``/``weights`` are non-neutral (erl_covariance builds its
    kernel from the full Setting, reference call site:
    src/vanilla_gp.cpp:820). Mixture contract (erl_covariance's source is
    not vendored in the snapshot; contract documented in docs/parity.md):
    component i has scale ``scale * scale_mix**i`` and weight
    ``weights[i]``; weights are normalized to sum 1 so the unit-variance
    invariant k(x,x)=1 — which every variance formula relies on — holds
    for mixtures too."""
    mix, w = _mixture_terms(ks)
    if mix != 1.0 and len(w) == 0:
        raise ValueError(
            f"{context or 'kernel'}: scale_mix={mix!r} with empty weights "
            "specifies no mixture components — set weights (one per "
            "component) or leave scale_mix at 1")
    base = resolve_kernel_name(kernel_type)
    if len(w) == 0:
        return base
    if any(v < 0 for v in w) or sum(w) <= 0:
        raise ValueError(
            f"{context or 'kernel'}: mixture weights must be non-negative "
            f"with a positive sum, got {w!r}")
    if mix <= 0:
        raise ValueError(
            f"{context or 'kernel'}: scale_mix must be positive, got {mix!r}")
    from erl_gaussian_process_tpu_torch.kernels.stationary import (
        register_scale_mixture,
    )
    return register_scale_mixture(base, mix, tuple(w))


def resolve_kernel_name(name: str) -> str:
    """Normalize a kernel name: accepts registry keys, aliases, and reference
    C++ type names like ``erl::covariance::OrnsteinUhlenbeck1d`` or
    ``erl::covariance::Matern32<float, 2>``."""
    raw = name.strip()
    direct = _ALIASES.get(raw.lower(), raw.lower())
    if direct in _REGISTRY:
        return direct
    m = _CPP_NAME_RE.match(raw)
    if m:
        raw = m.group(1)
    elif raw.startswith("erl::covariance::"):
        raw = raw[len("erl::covariance::"):]
    direct = _ALIASES.get(raw.lower(), raw.lower())
    if direct in _REGISTRY:
        return direct
    # strip trailing dtype/dim suffixes: RadialBiasFunction1d, OrnsteinUhlenbeck2d
    raw = re.sub(r"\d+[df]?$", "", raw)
    snake = _CAMEL_RE.sub("_", raw).lower().strip("_")
    snake = _ALIASES.get(snake, snake)
    if snake in _REGISTRY:
        return snake
    if raw.lower() in _REGISTRY:
        return raw.lower()
    raise KeyError(
        f"unknown kernel {name!r} (normalized {snake!r}); known: {sorted(_REGISTRY)}"
    )


def register_kernel(name: str, **fns: Callable) -> None:
    _REGISTRY[name] = fns


def get_kernel(name: str) -> Dict[str, Callable]:
    return _REGISTRY[resolve_kernel_name(name)]


def kernel_names() -> List[str]:
    """The registered kernel names, sorted (mixtures once materialized)."""
    return sorted(_REGISTRY)
