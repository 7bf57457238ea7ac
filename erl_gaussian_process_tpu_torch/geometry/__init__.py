"""Geometry for the occupancy map: bounding box, grid coordinates, the
dataset sampler and the procedural 3D world (counterpart of
``erl_gaussian_process_tpu/geometry``)."""

from erl_gaussian_process_tpu_torch.geometry.aabb import Aabb
from erl_gaussian_process_tpu_torch.geometry.grid_map_info import (
    GridMapInfo,
    GridMapInfo2D,
    GridMapInfo3D,
)
from erl_gaussian_process_tpu_torch.geometry.occupancy_dataset import (
    compact_slots,
    generate_dataset_fixed,
    generate_dataset_np,
)
from erl_gaussian_process_tpu_torch.geometry.simulators import (
    TriangleMesh,
    replica_hotel_like_mesh,
)

__all__ = [
    "Aabb",
    "GridMapInfo",
    "GridMapInfo2D",
    "GridMapInfo3D",
    "TriangleMesh",
    "compact_slots",
    "generate_dataset_fixed",
    "generate_dataset_np",
    "replica_hotel_like_mesh",
]
