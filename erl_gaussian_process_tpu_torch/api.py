"""Reference-compatible Python API surface (counterpart of
``erl_gaussian_process_tpu/api.py``).

Mirrors the names exported by the reference's pybind11 module
``pyerl_gaussian_process`` (reference: python/binding/*.cpp —
``VanillaGaussianProcessD/F`` bind_vanilla_gp.cpp:106-107,
``NoisyInputGaussianProcessD/F`` bind_noisy_input_gp.cpp:187-188,
``MappingD/F`` + ``MappingType`` bind_mapping.cpp:34-45,
``LidarGaussianProcess2Dd/f`` bind_lidar_gp_2d.cpp:113-114,
``RangeSensorGaussianProcess3Dd/f`` bind_range_sensor_gp_3d.cpp:131-132)
so code written against the reference's Python package ports by changing
the import line::

    from erl_gaussian_process_tpu_torch.api import (
        VanillaGaussianProcessD, MappingType, LidarGaussianProcess2Dd)

The dtype-suffixed classes pin float64 (``D``/``d``) or float32 (``F``/``f``)
exactly as the reference's explicit template instantiations do
(src/vanilla_gp.cpp:832-833). Beyond the reference's exports, the classes it
left unbound (SPGP and the occupancy map) are exported here too. Like every
model of this package they run on the card unless ``device="cpu"`` is
passed.
"""

from __future__ import annotations

import numpy as np

from erl_gaussian_process_tpu_torch.models.lidar_gp_2d import (
    LidarGaussianProcess2D,
)
from erl_gaussian_process_tpu_torch.models.mapping import Mapping, MappingType
from erl_gaussian_process_tpu_torch.models.noisy_input_gp import (
    NoisyInputGaussianProcess,
)
from erl_gaussian_process_tpu_torch.models.range_sensor_gp_3d import (
    RangeSensorGaussianProcess3D,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SparsePseudoInputGaussianProcess,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMap,
)
from erl_gaussian_process_tpu_torch.models.vanilla_gp import VanillaGaussianProcess


def _dtype_variant(base, name: str, dtype):
    """Subclass with the dtype pinned (reference's D/F explicit
    instantiations)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("dtype", dtype)
        base.__init__(self, *args, **kwargs)

    return type(name, (base,), {"__init__": __init__, "dtype_": dtype})


VanillaGaussianProcessD = _dtype_variant(
    VanillaGaussianProcess, "VanillaGaussianProcessD", np.float64)
VanillaGaussianProcessF = _dtype_variant(
    VanillaGaussianProcess, "VanillaGaussianProcessF", np.float32)
NoisyInputGaussianProcessD = _dtype_variant(
    NoisyInputGaussianProcess, "NoisyInputGaussianProcessD", np.float64)
NoisyInputGaussianProcessF = _dtype_variant(
    NoisyInputGaussianProcess, "NoisyInputGaussianProcessF", np.float32)
SparsePseudoInputGaussianProcessD = _dtype_variant(
    SparsePseudoInputGaussianProcess, "SparsePseudoInputGaussianProcessD",
    np.float64)
SparsePseudoInputGaussianProcessF = _dtype_variant(
    SparsePseudoInputGaussianProcess, "SparsePseudoInputGaussianProcessF",
    np.float32)
LidarGaussianProcess2Dd = _dtype_variant(
    LidarGaussianProcess2D, "LidarGaussianProcess2Dd", np.float64)
LidarGaussianProcess2Df = _dtype_variant(
    LidarGaussianProcess2D, "LidarGaussianProcess2Df", np.float32)
RangeSensorGaussianProcess3Dd = _dtype_variant(
    RangeSensorGaussianProcess3D, "RangeSensorGaussianProcess3Dd", np.float64)
RangeSensorGaussianProcess3Df = _dtype_variant(
    RangeSensorGaussianProcess3D, "RangeSensorGaussianProcess3Df", np.float32)
SpGpOccupancyMapD = _dtype_variant(
    SpGpOccupancyMap, "SpGpOccupancyMapD", np.float64)
SpGpOccupancyMapF = _dtype_variant(
    SpGpOccupancyMap, "SpGpOccupancyMapF", np.float32)

# Mapping is dtype-free here (pure scalar transforms); both reference names
# resolve to the same class (reference: bind_mapping.cpp:44-45).
MappingD = Mapping
MappingF = Mapping

__all__ = [
    "VanillaGaussianProcess", "VanillaGaussianProcessD",
    "VanillaGaussianProcessF",
    "NoisyInputGaussianProcess", "NoisyInputGaussianProcessD",
    "NoisyInputGaussianProcessF",
    "SparsePseudoInputGaussianProcess", "SparsePseudoInputGaussianProcessD",
    "SparsePseudoInputGaussianProcessF",
    "LidarGaussianProcess2D", "LidarGaussianProcess2Dd",
    "LidarGaussianProcess2Df",
    "RangeSensorGaussianProcess3D", "RangeSensorGaussianProcess3Dd",
    "RangeSensorGaussianProcess3Df",
    "SpGpOccupancyMap", "SpGpOccupancyMapD", "SpGpOccupancyMapF",
    "Mapping", "MappingD", "MappingF", "MappingType",
]
