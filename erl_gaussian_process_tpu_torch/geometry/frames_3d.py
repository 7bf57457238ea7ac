"""3D range-sensor frames (counterpart of
``erl_gaussian_process_tpu/geometry/frames_3d.py``, which is host numpy
there too, ported as is): ``LidarFrame3D`` / ``DepthFrame3D`` and their
string factory, the equivalent of ``geometry::RangeSensorFrame3D``
(API surface from the reference's call sites: GetFrameCoords,
UpdateRanges, ComputeFrameCoords, CoordsIsInFrame, GetHitMask,
DirWorldToFrame).

Frame-coordinate conventions (ours; the external erl_geometry impl is not
in-tree):
- LidarFrame3D: rows index azimuth, cols index elevation;
  frame coords = (azimuth, elevation) with az = atan2(y, x),
  el = atan2(z, hypot(x, y)).
- DepthFrame3D: pinhole camera, z forward / x right / y down;
  frame coords = (v_row, u_col) pixel coordinates from the intrinsics.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class _RangeFrame3DBase:
    def __init__(self, dtype=np.float64):
        self.dtype = np.dtype(dtype)
        self.rotation = np.eye(3, dtype=self.dtype)
        self.translation = np.zeros(3, dtype=self.dtype)
        self.ranges = None
        self.hit_mask = None

    def update_ranges(self, rotation, translation, ranges):
        self.rotation = np.asarray(rotation, self.dtype).reshape(3, 3)
        self.translation = np.asarray(translation, self.dtype).reshape(3)
        r = np.asarray(ranges, self.dtype)
        assert r.shape == self.shape, (r.shape, self.shape)
        self.ranges = r
        s = self.setting
        self.hit_mask = (np.isfinite(r) & (r >= s.valid_range_min)
                         & (r <= s.valid_range_max))

    def is_valid(self):
        return self.hit_mask is not None and bool(self.hit_mask.any())

    def dir_world_to_frame(self, directions):
        d = np.asarray(directions, self.dtype)
        return d @ self.rotation  # R^T per row

    # -- checkpoint (frame pose + measurement state) ------------------------
    def state_dict(self):
        return {"rotation": self.rotation, "translation": self.translation,
                "ranges": self.ranges, "hit_mask": self.hit_mask}

    def load_state_dict(self, d):
        self.rotation = np.asarray(d["rotation"], self.dtype)
        self.translation = np.asarray(d["translation"], self.dtype)
        self.ranges = None if d["ranges"] is None else np.asarray(
            d["ranges"], self.dtype)
        self.hit_mask = None if d["hit_mask"] is None else np.asarray(
            d["hit_mask"], bool)


@dataclasses.dataclass
class LidarFrame3DSetting:
    """Fields from the reference test (test_range_sensor_gp_3d.cpp:39-44)."""

    valid_range_min: float = 0.0
    valid_range_max: float = np.inf
    azimuth_min: float = -np.pi
    azimuth_max: float = np.pi
    elevation_min: float = -np.pi / 2
    elevation_max: float = np.pi / 2
    num_azimuth_lines: int = 360
    num_elevation_lines: int = 181

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in known})


class LidarFrame3D(_RangeFrame3DBase):
    Setting = LidarFrame3DSetting

    def __init__(self, setting: LidarFrame3DSetting | None = None,
                 dtype=np.float64):
        super().__init__(dtype)
        self.setting = setting or LidarFrame3DSetting()
        s = self.setting
        self.azimuths = np.linspace(
            s.azimuth_min, s.azimuth_max, s.num_azimuth_lines).astype(self.dtype)
        self.elevations = np.linspace(
            s.elevation_min, s.elevation_max, s.num_elevation_lines
        ).astype(self.dtype)
        self.shape = (s.num_azimuth_lines, s.num_elevation_lines)

    def frame_coords(self):
        """(rows, cols, 2): coords[r, c] = (azimuth_r, elevation_c)."""
        az = np.broadcast_to(self.azimuths[:, None], self.shape)
        el = np.broadcast_to(self.elevations[None, :], self.shape)
        return np.stack([az, el], axis=-1)

    def ray_directions_in_frame(self):
        az = self.azimuths[:, None]
        el = self.elevations[None, :]
        ca, sa = np.cos(az), np.sin(az)
        ce, se = np.cos(el), np.sin(el)
        return np.stack([ca * ce, sa * ce, np.broadcast_to(se, self.shape)],
                        axis=-1)

    def compute_frame_coords(self, dirs_local):
        """dirs (n, 3) -> (dist_scale=1, coords (n, 2), valid (n,)).
        For a lidar frame every direction maps to (az, el)."""
        d = np.asarray(dirs_local, self.dtype)
        az = np.arctan2(d[..., 1], d[..., 0])
        el = np.arctan2(d[..., 2], np.hypot(d[..., 0], d[..., 1]))
        coords = np.stack([az, el], axis=-1)
        return coords, np.isfinite(az) & np.isfinite(el)

    def coords_in_frame(self, coords):
        s = self.setting
        return ((coords[..., 0] >= s.azimuth_min)
                & (coords[..., 0] <= s.azimuth_max)
                & (coords[..., 1] >= s.elevation_min)
                & (coords[..., 1] <= s.elevation_max))


@dataclasses.dataclass
class DepthFrame3DSetting:
    """Pinhole depth camera (reference DepthFrame3D adds camera_intrinsic +
    image size, test_range_sensor_gp_3d.cpp:238)."""

    valid_range_min: float = 0.0
    valid_range_max: float = np.inf
    image_height: int = 480
    image_width: int = 640
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in known})


class DepthFrame3D(_RangeFrame3DBase):
    Setting = DepthFrame3DSetting

    def __init__(self, setting: DepthFrame3DSetting | None = None,
                 dtype=np.float64):
        super().__init__(dtype)
        self.setting = setting or DepthFrame3DSetting()
        s = self.setting
        self.shape = (s.image_height, s.image_width)

    @property
    def image_height(self):
        return self.setting.image_height

    @property
    def image_width(self):
        return self.setting.image_width

    def frame_coords(self):
        """(h, w, 2): coords[r, c] = (row r, col c) as floats."""
        h, w = self.shape
        rr = np.broadcast_to(
            np.arange(h, dtype=self.dtype)[:, None], self.shape)
        cc = np.broadcast_to(
            np.arange(w, dtype=self.dtype)[None, :], self.shape)
        return np.stack([rr, cc], axis=-1)

    def ray_directions_in_frame(self):
        """Unit directions, camera convention z forward / x right / y down."""
        s = self.setting
        c = self.frame_coords()
        x = (c[..., 1] - s.cx) / s.fx
        y = (c[..., 0] - s.cy) / s.fy
        d = np.stack([x, y, np.ones_like(x)], axis=-1)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    def compute_frame_coords(self, dirs_local):
        d = np.asarray(dirs_local, self.dtype)
        s = self.setting
        z = d[..., 2]
        valid = z > 1e-12
        zs = np.where(valid, z, 1.0)
        u = s.fx * d[..., 0] / zs + s.cx
        v = s.fy * d[..., 1] / zs + s.cy
        return np.stack([v, u], axis=-1), valid

    def coords_in_frame(self, coords):
        h, w = self.shape
        return ((coords[..., 0] >= 0) & (coords[..., 0] <= h - 1)
                & (coords[..., 1] >= 0) & (coords[..., 1] <= w - 1))

    def end_points_in_world(self):
        dirs = self.ray_directions_in_frame() @ self.rotation.T
        return self.translation + dirs * self.ranges[..., None]


_FRAME_TYPES = {
    "lidar": LidarFrame3D,
    "depth": DepthFrame3D,
}


def create_range_sensor_frame_3d(type_name: str, setting=None, dtype=np.float64):
    """String factory (reference: RangeSensorFrame3D::Create,
    src/range_sensor_gp_3d.cpp:184-188). Accepts our short names or the
    reference C++ type names."""
    t = type_name.lower()
    if "lidar" in t:
        cls = LidarFrame3D
    elif "depth" in t:
        cls = DepthFrame3D
    else:
        raise KeyError(f"unknown 3D frame type {type_name!r}")
    if isinstance(setting, dict):
        setting = cls.Setting.from_dict(setting)
    return cls(setting, dtype=dtype)
