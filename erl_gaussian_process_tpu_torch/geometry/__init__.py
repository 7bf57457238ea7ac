"""Geometry: bounding box, grid coordinates, the dataset sampler, the 2D
lidar frame, the 3D range-sensor frames and the procedural 2D and 3D
worlds (counterpart of ``erl_gaussian_process_tpu/geometry``)."""

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
from erl_gaussian_process_tpu_torch.geometry.lidar_frame_2d import (
    LidarFrame2D,
    LidarFrame2DSetting,
)
from erl_gaussian_process_tpu_torch.geometry.occupancy_dataset import (
    compact_slots,
    free_sample_fractions,
    generate_dataset_fixed,
    generate_dataset_np,
)
from erl_gaussian_process_tpu_torch.geometry.simulators import (
    Lidar2D,
    Space2D,
    TriangleMesh,
    reference_room_mesh_3d,
    reference_space_2d,
    reference_trajectory_2d,
    replica_hotel_like_mesh,
)

__all__ = [
    "Aabb",
    "DepthFrame3D",
    "DepthFrame3DSetting",
    "Lidar2D",
    "LidarFrame2D",
    "LidarFrame2DSetting",
    "LidarFrame3D",
    "LidarFrame3DSetting",
    "GridMapInfo",
    "GridMapInfo2D",
    "GridMapInfo3D",
    "Space2D",
    "TriangleMesh",
    "compact_slots",
    "free_sample_fractions",
    "create_range_sensor_frame_3d",
    "generate_dataset_fixed",
    "generate_dataset_np",
    "reference_room_mesh_3d",
    "reference_space_2d",
    "reference_trajectory_2d",
    "replica_hotel_like_mesh",
]
