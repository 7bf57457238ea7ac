"""Axis-aligned bounding box (counterpart of
``erl_gaussian_process_tpu/geometry/aabb.py``; host-side numpy)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Aabb:
    center: np.ndarray
    half_sizes: np.ndarray

    @classmethod
    def from_min_max(cls, mn, mx):
        mn = np.asarray(mn, float)
        mx = np.asarray(mx, float)
        return cls(center=(mn + mx) / 2, half_sizes=(mx - mn) / 2)

    def min(self):
        return self.center - self.half_sizes

    def max(self):
        return self.center + self.half_sizes

    @property
    def dim(self):
        return self.center.shape[0]

    def __eq__(self, other):
        if not isinstance(other, Aabb):
            return NotImplemented
        return (np.array_equal(self.center, other.center)
                and np.array_equal(self.half_sizes, other.half_sizes))
