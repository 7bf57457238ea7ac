"""The hotel-0 workload (counterpart of
``erl_gaussian_process_tpu/workloads.py``): the 3D SPGP occupancy map
replaying the 983-pose replica-hotel-0 trajectory. Its configuration —
bounding box margins, mesh, kernel scale, pseudo grid, depth-ray grid —
is the JAX package's, value for value, so both packages run one problem.
"""

import os

import numpy as np

from erl_gaussian_process_tpu_torch.geometry.grid_map_info import GridMapInfo3D
from erl_gaussian_process_tpu_torch.geometry.simulators import (
    replica_hotel_like_mesh,
)
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SpGpSetting,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMapSetting,
)

_REPO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir)
HOTEL0_TRAJ = os.path.join(_REPO_ROOT, "data", "replica-hotel-0-traj.txt")
FREE_SLOTS_PER_RAY = 12  # the hotel-0 map's free_slots_per_ray


def load_hotel0_trajectory(path=HOTEL0_TRAJ, n_poses=None):
    """983 rows of a row-major 4x4 pose -> (n, 4, 4)."""
    poses = np.loadtxt(path).reshape(-1, 4, 4)
    return poses[:n_poses] if n_poses is not None else poses


def hotel0_setup(poses):
    """The fixed workload configuration for a pose set: bounding box,
    procedural mesh, SPGP map setting, pseudo-point grid (d, 1089), and the
    depth-camera-style 24x16 ray grid (sensor frame, forward = +z).

    Returns (setting, pseudo, lo, hi, mesh, d_local)."""
    pos = poses[:, :3, 3]
    lo = pos.min(axis=0) - 1.5
    hi = pos.max(axis=0) + 1.5
    mesh = replica_hotel_like_mesh(lo + 0.2, hi - 0.2)

    setting = SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(
            kernel_type="matern32",
            kernel=KernelSetting(x_dim=3, scale=float((hi - lo).max()) / 16.0),
            max_num_samples=2000),
        min_distance=0.05, max_distance=30.0,
        free_points_per_meter=2.0, free_sampling_margin=0.02,
        logodd_free=-1.0, logodd_occupied=1.0, logodd_variance=1e-4)

    pseudo = GridMapInfo3D(lo, hi, [11, 11, 9]).generate_meter_coordinates().T

    u = np.linspace(-0.45, 0.45, 24)
    v = np.linspace(-0.3, 0.3, 16)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    d_local = np.stack([uu.ravel(), vv.ravel(), np.ones(uu.size)], axis=-1)
    d_local /= np.linalg.norm(d_local, axis=-1, keepdims=True)

    return setting, pseudo, lo, hi, mesh, d_local


def hotel0_query_grid(lo, hi, shape=(16, 16, 8), margin=0.3):
    """The drift check's fixed posterior query grid: a lattice inset
    ``margin`` from the workload bounding box, (prod(shape), 3) float32."""
    axes = [np.linspace(lo[i] + margin, hi[i] - margin, shape[i])
            for i in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return g.astype(np.float32)


def hotel0_scan(mesh, pose, d_local, max_distance):
    """Raycast one pose's depth-style scan. Returns (sensor, points, hit):
    world-frame endpoints with misses collapsed onto the sensor origin
    (masked out by ``hit``)."""
    R, t = pose[:3, :3], pose[:3, 3]
    dirs = d_local @ R.T
    rng = mesh.cast_rays(t, dirs)
    hit = np.isfinite(rng) & (rng <= max_distance)
    pts = t + dirs * np.where(hit, rng, 0.0)[:, None]
    return t, pts, hit


def hotel0_workload(n_poses=None):
    """The scanned trajectory, as the replay consumes it: float32 sensor
    positions (B, 3), end points (B, 384, 3) and hit masks (B, 384), plus
    every hit point (for the surface gate), the trajectory positions (for
    the free-space gate) and ``hotel0_setup``'s setting, pseudo, lo, hi."""
    poses = load_hotel0_trajectory(n_poses=n_poses)
    setting, pseudo, lo, hi, mesh, d_local = hotel0_setup(poses)
    sensors, pts, masks, hits = [], [], [], []
    for T in poses:
        t, p, hit = hotel0_scan(mesh, T, d_local, setting.max_distance)
        sensors.append(t.astype(np.float32))
        pts.append(p.astype(np.float32))
        masks.append(hit)
        hits.append(p[hit])
    return (np.stack(sensors), np.stack(pts), np.stack(masks),
            np.concatenate(hits), poses[:, :3, 3].astype(np.float32),
            setting, pseudo, lo, hi)
