"""Invertible scalar transforms for distance-space regression (counterpart
of ``erl_gaussian_process_tpu/models/mapping.py``). ``inverse_sqrt`` is the
default for sensor GPs.

``map`` and ``inv`` are elementwise torch ops: a tensor stays a tensor on
its device (the fused scan train maps a range image on the card), and a
numpy array or scalar comes back as a numpy array (the host paths).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class MappingType(str, enum.Enum):
    IDENTITY = "kIdentity"
    INVERSE = "kInverse"
    INVERSE_SQRT = "kInverseSqrt"
    EXP = "kExp"
    LOG = "kLog"
    TANH = "kTanh"
    SIGMOID = "kSigmoid"

    @classmethod
    def parse(cls, v):
        if isinstance(v, cls):
            return v
        s = str(v)
        for m in cls:
            if s in (m.value, m.name, m.name.lower()):
                return m
        raise ValueError(f"unknown mapping type {v!r}")


@dataclasses.dataclass
class MappingSetting:
    type: MappingType = MappingType.IDENTITY
    scale: float = 1.0

    def to_dict(self):
        return {"type": self.type.value, "scale": self.scale}

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        return cls(type=MappingType.parse(d.get("type", "kIdentity")),
                   scale=float(d.get("scale", 1.0)))


def _forward_inverse(t: MappingType, s: float):
    if t == MappingType.IDENTITY:
        return (lambda x: x), (lambda y: y)
    if t == MappingType.INVERSE:
        return (lambda x: 1.0 / x), (lambda y: 1.0 / y)
    if t == MappingType.INVERSE_SQRT:
        return (lambda x: 1.0 / torch.sqrt(x)), (lambda y: 1.0 / (y * y))
    if t == MappingType.EXP:
        return (lambda x: torch.exp(-s * x)), (lambda y: -torch.log(y) / s)
    if t == MappingType.LOG:
        return (lambda x: torch.log(s * x)), (lambda y: torch.exp(y) / s)
    if t == MappingType.TANH:
        return (lambda x: torch.tanh(s * x)), (lambda y: torch.atanh(y) / s)
    if t == MappingType.SIGMOID:
        return ((lambda x: 1.0 / (1.0 + torch.exp(-s * x))),
                (lambda y: torch.log(y / (1.0 - y)) / s))
    raise ValueError(f"mapping type {t} is not supported")


def _elementwise(fn):
    def apply(x):
        if isinstance(x, torch.Tensor):
            return fn(x)
        return fn(torch.tensor(np.asarray(x))).numpy()
    return apply


class Mapping:
    Setting = MappingSetting
    Type = MappingType

    def __init__(self, setting: MappingSetting | None = None):
        self.setting = setting or MappingSetting()
        fwd, inv = _forward_inverse(self.setting.type,
                                    float(self.setting.scale))
        self.map = _elementwise(fwd)
        self.inv = _elementwise(inv)

    def inv_masked(self, y, valid):
        """``inv()`` over valid lanes only, on numpy arrays. Invalid lanes
        never reach the inverse, so a zero mean cannot raise a
        divide-by-zero warning; they yield ``+inf``. The placeholder 0.5 is
        in every mapping type's invertible domain."""
        y = np.asarray(y)
        valid = np.asarray(valid, bool)
        safe = np.where(valid, y, y.dtype.type(0.5))
        out = np.asarray(self.inv(safe))
        return np.where(valid, out, out.dtype.type(np.inf))

    @classmethod
    def create(cls, setting=None):
        return cls(setting)
