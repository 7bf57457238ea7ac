"""Binary data loaders (counterpart of
``erl_gaussian_process_tpu/utils/loaders.py``, its numpy parse).

``load_lidar_log`` parses the packed 2D-lidar log format of
``data/double/train.dat`` (float64) and ``data/float/train.dat``
(float32): repeated frames of ``int32 numel | T angles[numel] |
T ranges[numel] | uint64 pose_size | T pose[pose_size]``, where pose is a
column-major 2x3 ``[t | R]`` matrix. The native parser of
``utils/native.py`` reads it when that library is available, numpy
otherwise; both give the same frames.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class LidarLogFrame:
    angles: np.ndarray       # (n,)
    ranges: np.ndarray       # (n,)
    position: np.ndarray     # (2,)
    rotation: np.ndarray     # (2, 2)


def load_lidar_log(path: str, dtype=np.float64) -> List[LidarLogFrame]:
    """Every frame of the log at ``path``, whose values are ``dtype``."""
    from erl_gaussian_process_tpu_torch.utils.native import (
        load_lidar_log_native,
    )

    native = load_lidar_log_native(path, dtype)
    if native is not None:
        frames = []
        for angles, ranges, pose in native:
            # the native parser fills float64 buffers; cast back to the
            # log's dtype so both paths return identical frames
            p = pose.astype(dtype).reshape(3, 2).T
            frames.append(LidarLogFrame(
                angles=angles.astype(dtype), ranges=ranges.astype(dtype),
                position=p[:, 0].copy(), rotation=p[:, 1:3].copy()))
        return frames
    raw = np.fromfile(path, dtype=np.uint8)
    frames = []
    off = 0
    item = np.dtype(dtype).itemsize
    while off < raw.size:
        numel = int(raw[off:off + 4].view(np.int32)[0])
        off += 4
        angles = raw[off:off + numel * item].view(dtype).copy()
        off += numel * item
        ranges = raw[off:off + numel * item].view(dtype).copy()
        off += numel * item
        pose_size = int(raw[off:off + 8].view(np.uint64)[0])
        off += 8
        pose = raw[off:off + pose_size * item].view(dtype).copy()
        off += pose_size * item
        p = pose.reshape(3, 2).T            # column-major 2x3 [t | R]
        frames.append(LidarLogFrame(
            angles=angles, ranges=ranges,
            position=p[:, 0].copy(), rotation=p[:, 1:3].copy()))
    return frames
