"""Geometry: bounding box, grid coordinates, the dataset sampler, the 3D
range-sensor frames and the procedural 3D worlds (counterpart of
``erl_gaussian_process_tpu/geometry``)."""

from erl_gaussian_process_tpu_torch.geometry.aabb import Aabb
from erl_gaussian_process_tpu_torch.geometry.frames_3d import (
    DepthFrame3D,
    DepthFrame3DSetting,
    LidarFrame3D,
    LidarFrame3DSetting,
    create_range_sensor_frame_3d,
)
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
    reference_room_mesh_3d,
    replica_hotel_like_mesh,
)

__all__ = [
    "Aabb",
    "DepthFrame3D",
    "DepthFrame3DSetting",
    "LidarFrame3D",
    "LidarFrame3DSetting",
    "GridMapInfo",
    "GridMapInfo2D",
    "GridMapInfo3D",
    "TriangleMesh",
    "compact_slots",
    "create_range_sensor_frame_3d",
    "generate_dataset_fixed",
    "generate_dataset_np",
    "reference_room_mesh_3d",
    "replica_hotel_like_mesh",
]
