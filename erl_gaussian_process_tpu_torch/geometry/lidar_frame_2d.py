"""2D lidar scan frame (counterpart of
``erl_gaussian_process_tpu/geometry/lidar_frame_2d.py``; the reference's
``geometry::LidarFrame2D``): ray angles, pose, ranges, hit and continuity
masks, and the world-to-frame transforms.

Host-side numpy: a scan is small (~10^3 rays); the lidar GP's train gathers
its partitions from the ranges on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LidarFrame2DSetting:
    """``discontinuity_detection``/``discontinuity_threshold`` gate the
    continuity mask: a ray is discontinuous when the range jump to either
    neighbor exceeds the threshold."""

    valid_range_min: float = 0.0
    valid_range_max: float = np.inf
    angle_min: float = -np.pi
    angle_max: float = np.pi
    num_rays: int = 360
    discontinuity_detection: bool = True
    discontinuity_threshold: float = 1.0

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in known})


class LidarFrame2D:
    Setting = LidarFrame2DSetting

    def __init__(self, setting: LidarFrame2DSetting | None = None,
                 dtype=np.float64):
        self.setting = setting or LidarFrame2DSetting()
        self.dtype = np.dtype(dtype)
        s = self.setting
        self.angles_in_frame = np.linspace(
            s.angle_min, s.angle_max, s.num_rays).astype(self.dtype)
        self.rotation = np.eye(2, dtype=self.dtype)
        self.translation = np.zeros(2, dtype=self.dtype)
        self.ranges = np.zeros(s.num_rays, dtype=self.dtype)
        self.hit_mask = np.zeros(s.num_rays, bool)
        self.continuity_mask = np.ones(s.num_rays, bool)

    def update_ranges(self, rotation, translation, ranges) -> bool:
        """Returns False, leaving the frame invalid (an all-miss hit mask),
        when the scan has the wrong ray count."""
        s = self.setting
        self.rotation = np.asarray(rotation, self.dtype).reshape(2, 2)
        self.translation = np.asarray(translation, self.dtype).reshape(2)
        r = np.asarray(ranges, self.dtype).reshape(-1)
        if r.shape[0] != s.num_rays:
            import logging
            logging.getLogger("erl_gaussian_process_tpu_torch").warning(
                "update_ranges: got %d ranges for a %d-ray frame — scan "
                "rejected, frame left invalid", r.shape[0], s.num_rays)
            self.ranges = np.zeros(s.num_rays, dtype=self.dtype)
            self.hit_mask = np.zeros(s.num_rays, bool)
            self.continuity_mask = np.ones(s.num_rays, bool)
            return False
        self.ranges = r
        finite = np.isfinite(r)
        self.hit_mask = finite & (r >= s.valid_range_min) & (r <= s.valid_range_max)
        # continuity: jump to either neighbor within threshold
        cont = np.ones_like(self.hit_mask)
        if s.num_rays > 1:
            jump = np.abs(np.diff(np.where(finite, r, 0.0)))
            big = jump > s.discontinuity_threshold
            cont[:-1] &= ~big
            cont[1:] &= ~big
        self.continuity_mask = cont
        return True

    def is_valid(self) -> bool:
        return bool(self.hit_mask.any())

    @property
    def num_hit_rays(self) -> int:
        return int(self.hit_mask.sum())

    @property
    def hit_ray_indices(self) -> np.ndarray:
        return np.flatnonzero(self.hit_mask)

    def dir_world_to_frame(self, direction):
        """R^T d for world directions; direction (2,) or (n, 2)."""
        d = np.asarray(direction, self.dtype)
        return d @ self.rotation  # (n,2)@(2,2) == (R^T d^T)^T

    def angles_world_to_frame(self, angles_world):
        d = np.stack([np.cos(angles_world), np.sin(angles_world)], axis=-1)
        local = self.dir_world_to_frame(d)
        return np.arctan2(local[..., 1], local[..., 0])

    def end_points_in_frame(self):
        c, s_ = np.cos(self.angles_in_frame), np.sin(self.angles_in_frame)
        return np.stack([self.ranges * c, self.ranges * s_], axis=-1)

    def end_points_in_world(self):
        return self.end_points_in_frame() @ self.rotation.T + self.translation

    # -- checkpoint ---------------------------------------------------------
    def state_dict(self):
        return {
            "setting": self.setting.to_dict(),
            "rotation": self.rotation,
            "translation": self.translation,
            "ranges": self.ranges,
            "hit_mask": self.hit_mask,
            "continuity_mask": self.continuity_mask,
        }

    def load_state_dict(self, d):
        self.setting = LidarFrame2DSetting.from_dict(d["setting"])
        self.angles_in_frame = np.linspace(
            self.setting.angle_min, self.setting.angle_max,
            self.setting.num_rays).astype(self.dtype)
        self.rotation = np.asarray(d["rotation"])
        self.translation = np.asarray(d["translation"])
        self.ranges = np.asarray(d["ranges"])
        self.hit_mask = np.asarray(d["hit_mask"])
        self.continuity_mask = np.asarray(d["continuity_mask"])

    def __eq__(self, other):
        if not isinstance(other, LidarFrame2D):
            return NotImplemented
        a, b = self.state_dict(), other.state_dict()
        return a["setting"] == b["setting"] and all(
            np.array_equal(a[k], b[k]) for k in a if k != "setting")
