"""Uniform grid helper (counterpart of
``erl_gaussian_process_tpu/geometry/grid_map_info.py``; host-side numpy,
used to place pseudo-point grids)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class GridMapInfo:
    """A uniform N-D grid over a box: ``shape[i]`` cells along dim i, cell
    centers at ``min + (k + 0.5) * resolution``."""

    vmin: np.ndarray
    vmax: np.ndarray
    shape: tuple

    def __init__(self, vmin: Sequence[float], vmax: Sequence[float],
                 shape: Sequence[int]):
        self.vmin = np.asarray(vmin, float)
        self.vmax = np.asarray(vmax, float)
        self.shape = tuple(int(s) for s in shape)
        if not len(self.vmin) == len(self.vmax) == len(self.shape):
            raise ValueError("vmin, vmax and shape must have one entry per dim")

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def resolution(self) -> np.ndarray:
        return (self.vmax - self.vmin) / np.asarray(self.shape, float)

    def grid_to_meter(self, idx) -> np.ndarray:
        """Cell indices (n, dim) -> cell-center coordinates (n, dim)."""
        idx = np.atleast_2d(np.asarray(idx, float))
        return self.vmin + (idx + 0.5) * self.resolution

    def meter_to_grid(self, xy) -> np.ndarray:
        """Coordinates (n, dim) -> cell indices (n, dim), clipped to grid."""
        xy = np.atleast_2d(np.asarray(xy, float))
        idx = np.floor((xy - self.vmin) / self.resolution).astype(int)
        return np.clip(idx, 0, np.asarray(self.shape) - 1)

    def generate_meter_coordinates(self, flatten: bool = True) -> np.ndarray:
        """All cell centers: (prod(shape), dim) if flatten else
        shape + (dim,)."""
        axes = [self.vmin[i] + (np.arange(self.shape[i]) + 0.5)
                * self.resolution[i] for i in range(self.dim)]
        grids = np.meshgrid(*axes, indexing="ij")
        out = np.stack(grids, axis=-1)
        return out.reshape(-1, self.dim) if flatten else out


def GridMapInfo2D(vmin, vmax, shape):  # noqa: N802 — reference name
    g = GridMapInfo(vmin, vmax, shape)
    if g.dim != 2:
        raise ValueError(f"GridMapInfo2D needs 2 dims, got {g.dim}")
    return g


def GridMapInfo3D(vmin, vmax, shape):  # noqa: N802 — reference name
    g = GridMapInfo(vmin, vmax, shape)
    if g.dim != 3:
        raise ValueError(f"GridMapInfo3D needs 3 dims, got {g.dim}")
    return g
