"""The workloads of the port.

- hotel-0 (counterpart of ``erl_gaussian_process_tpu/workloads.py``): the
  3D SPGP occupancy map replaying the 983-pose replica-hotel-0 trajectory.
  Its configuration (bounding box margins, mesh, kernel scale, pseudo
  grid, depth-ray grid) is the JAX package's, value for value, so both
  packages run one problem.
- The 3D range-sensor GP's reference protocols (the JAX package's
  ``tests/test_range_sensor_gp_3d.py:138-229``, value for value): one
  scan of the procedural reference room from its center at a seeded
  random orientation, then 10 000 uniform sphere directions against the
  raycast ground truth.
- The exact GPs (the JAX package's ``benchmarks/suite.py:174-208`` and
  ``:245-290``, value for value): the vanilla GP at n = 8192, and the
  noisy-input GP with gradients at n = 2500 padded to 2560 (a 7680^2 joint
  system); and the reference's largest noisy-input golden
  (``tests/test_noisy_input_gp.py:245-280``, reference
  ``test_noisy_input_gp.cpp:354-560``): a 50x50 grid with gradients, a
  7500^2 joint system, float64.
"""

import os

import numpy as np

from erl_gaussian_process_tpu_torch.geometry.frames_3d import (
    DepthFrame3DSetting,
    LidarFrame3DSetting,
)
from erl_gaussian_process_tpu_torch.geometry.grid_map_info import GridMapInfo3D
from erl_gaussian_process_tpu_torch.geometry.simulators import (
    reference_room_mesh_3d,
    replica_hotel_like_mesh,
)
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models.mapping import (
    MappingSetting,
    MappingType,
)
from erl_gaussian_process_tpu_torch.models.range_sensor_gp_3d import (
    RangeSensorGP3DSetting,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SpGpSetting,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMapSetting,
)
from erl_gaussian_process_tpu_torch.models.vanilla_gp import VanillaGPSetting

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


def euler_rotation(roll, pitch, yaw) -> np.ndarray:
    """R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr, cp, sp, cy, sy = (np.cos(roll), np.sin(roll), np.cos(pitch),
                              np.sin(pitch), np.cos(yaw), np.sin(yaw))
    return (np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
            @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]]))


def random_pose_and_queries(seed: int, n_test: int = 10000):
    """A seeded sensor orientation (roll, pitch within pi/4, any yaw) and
    ``n_test`` directions uniform in azimuth and elevation."""
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-1, 1, 3) * np.array([np.pi / 4, np.pi / 4, np.pi])
    R = euler_rotation(*rpy)
    az = rng.uniform(-np.pi, np.pi, n_test)
    el = rng.uniform(-np.pi / 2, np.pi / 2, n_test)
    dirs = np.stack([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el),
                     np.sin(el)], axis=-1)
    return R, dirs


def _sensor_setting(frame_type: str, frame, scale: float):
    return RangeSensorGP3DSetting(
        row_group_size=10, row_overlap_size=4, row_margin=0,
        col_group_size=10, col_overlap_size=4, col_margin=0,
        min_num_samples_per_group=10, sensor_range_var=0.01,
        max_valid_range_var=0.1, sensor_frame_type=frame_type,
        sensor_frame=frame,
        gp=VanillaGPSetting(kernel_type="ou",
                            kernel=KernelSetting(x_dim=2, scale=scale)),
        mapping=MappingSetting(type=MappingType.INVERSE_SQRT))


def lidar3d_setting() -> RangeSensorGP3DSetting:
    """The reference lidar protocol: 271x91 rays over azimuth +-3pi/4 and
    elevation +-pi/2, groups of 10 with overlap 4 (736 partitions of 100
    samples), OU at scale 0.3, inverse-sqrt mapping, range variance
    0.01."""
    return _sensor_setting("lidar", LidarFrame3DSetting(
        azimuth_min=-np.pi * 3 / 4, azimuth_max=np.pi * 3 / 4,
        elevation_min=-np.pi / 2, elevation_max=np.pi / 2,
        num_azimuth_lines=271, num_elevation_lines=91), 0.3)


def depth3d_setting() -> RangeSensorGP3DSetting:
    """The reference depth-camera protocol: a 120x160 pinhole image at
    fx = fy = 110, OU at scale 8 (pixels), otherwise as the lidar's."""
    return _sensor_setting("depth", DepthFrame3DSetting(
        valid_range_min=0.1, valid_range_max=40.0, image_height=120,
        image_width=160, fx=110.0, fy=110.0, cx=80.0, cy=60.0), 8.0)


def _reference_protocol(setting, seed: int):
    from erl_gaussian_process_tpu_torch.geometry.frames_3d import (
        create_range_sensor_frame_3d,
    )

    mesh = reference_room_mesh_3d()
    R, dirs_test = random_pose_and_queries(seed)
    t = mesh.center()
    frame = create_range_sensor_frame_3d(setting.sensor_frame_type,
                                         setting.sensor_frame)
    dirs_f = frame.ray_directions_in_frame()
    ranges = mesh.cast_rays(t, dirs_f.reshape(-1, 3) @ R.T)
    gt = mesh.cast_rays(t, dirs_test)
    return (setting, R, t, ranges.reshape(dirs_f.shape[:2]), dirs_test, gt,
            mesh)


def lidar3d_reference_workload():
    """(setting, R, t, ranges (271, 91), query directions (10000, 3) in the
    world frame, their raycast ground truth, mesh): the lidar protocol,
    pose and queries from seed 0. MSE gate 4.2e-4."""
    return _reference_protocol(lidar3d_setting(), 0)


def depth3d_reference_workload():
    """The depth protocol's (setting, R, t, ranges (120, 160), queries,
    ground truth, mesh), pose and queries from seed 1. Out-of-view queries
    are invalid. MSE gate 2.2e-4."""
    return _reference_protocol(depth3d_setting(), 1)


def lidar3d_replay_workload(n_scans: int = 64, seed: int = 0):
    """Offline replay of the lidar protocol: ``n_scans`` scans of the
    reference room, each from a seeded pose (orientation as in
    :func:`random_pose_and_queries`, position within +-1 x +-0.8 x +-0.4 m of
    the room's center, clear of the furniture). Returns (setting,
    rotations (S, 3, 3), positions (S, 3), ranges (S, 271, 91)); all rays
    are raycast in one call."""
    from erl_gaussian_process_tpu_torch.geometry.frames_3d import (
        create_range_sensor_frame_3d,
    )

    setting = lidar3d_setting()
    mesh = reference_room_mesh_3d()
    frame = create_range_sensor_frame_3d(setting.sensor_frame_type,
                                         setting.sensor_frame)
    dirs_f = frame.ray_directions_in_frame().reshape(-1, 3)
    rng = np.random.default_rng(seed)
    Rs, ts = [], []
    for _ in range(n_scans):
        rpy = rng.uniform(-1, 1, 3) * np.array([np.pi / 4, np.pi / 4, np.pi])
        Rs.append(euler_rotation(*rpy))
        ts.append(mesh.center() + rng.uniform(-1, 1, 3) * [1.0, 0.8, 0.4])
    Rs, ts = np.stack(Rs), np.stack(ts)
    dirs = np.einsum("sij,nj->sni", Rs, dirs_f).reshape(-1, 3)
    origins = np.repeat(ts, dirs_f.shape[0], axis=0)
    ranges = mesh.cast_rays(origins, dirs)
    return setting, Rs, ts, ranges.reshape((n_scans,) + frame.shape)


def exact_gp_workload(n: int = 8192, m_test: int = 4096, d: int = 2,
                      seed: int = 0):
    """The exact-GP fit and predict: x ~ U(-1, 1)^d, y ~ U(-1, 1), noise
    1e-2 (the f32-feasible noise: at n >= 4k the dense rbf gram's norm is
    ~1e3-1e4, so f32 storage rounding alone perturbs it by ~1e-4), rbf at
    scale 0.5, float32. Returns (x (n, d), y (n, 1), var (n,), queries
    (m_test, d), scale, kernel)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    y = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    var = np.full((n,), 1e-2, np.float32)
    xq = rng.uniform(-1, 1, (m_test, d)).astype(np.float32)
    return x, y, var, xq, 0.5, "rbf"


def nigp_workload(n: int = 2500, d: int = 2, m_test: int = 1024,
                  seed: int = 0):
    """The noisy-input GP with gradient observations at the reference's
    hardest test shape: n padded to a multiple of 128 (2560, so the joint
    system is 7680^2), x, y, gradients ~ U(-1, 1), var_x 1e-6, var_y =
    var_grad = 1e-2 (f32-feasible), rbf at scale 0.5, float32. Returns (x
    (n, d), y (n, 1), grad (n, d, 1), var_x, var_y, var_grad (n,), queries
    (m_test, d), scale, kernel)."""
    n = -(-n // 128) * 128
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    y = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    grad = rng.uniform(-1, 1, (n, d, 1)).astype(np.float32)
    var_x = np.full((n,), 1e-6, np.float32)
    var_y = np.full((n,), 1e-2, np.float32)
    var_grad = np.full((n,), 1e-2, np.float32)
    xq = rng.uniform(-1, 1, (m_test, d)).astype(np.float32)
    return x, y, grad, var_x, var_y, var_grad, xq, 0.5, "rbf"


def _grid_points(n, xmin, xmax, ymin, ymax):
    xs = np.linspace(xmin, xmax, n)
    ys = np.linspace(ymin, ymax, n)
    return np.array([[x, y] for x in xs for y in ys]).T   # reference order


# the reference's bounds (test_noisy_input_gp.cpp:556-558) and its recorded
# observations (:554) for the 50x50 golden: MAE, mean |gx err|, |gy err|
NIGP_GOLDEN_BOUNDS = (1.0e-5, 1.1e-4, 2.6e-4)
NIGP_GOLDEN_RECORDED = (9.516671456234042e-06, 1.0712550862064423e-04,
                        2.508214688791491e-04)


def nigp_golden_workload():
    """The reference's 2D noisy-input case with gradients at full size: z =
    2 sin(10 x) cos(5 y) and its gradient on a 50x50 grid over [-2, 2] x
    [-1, 1] (2500 samples, 7500^2 joint system), rbf at scale 0.1, noise
    1e-4 on values, inputs and gradients, float64; tested on a 100x100
    grid. Returns (setting, x (2, 2500), z, grad (2, 2500), noise, queries
    (2, 10000), z at the queries, (gx, gy) at the queries)."""
    from erl_gaussian_process_tpu_torch.models.noisy_input_gp import (
        NoisyInputGPSetting,
    )

    pts = _grid_points(50, -2, 2, -1, 1)
    z = 2 * np.sin(10 * pts[0]) * np.cos(5 * pts[1])
    grad = np.stack([20 * np.cos(10 * pts[0]) * np.cos(5 * pts[1]),
                     -10 * np.sin(10 * pts[0]) * np.sin(5 * pts[1])])
    setting = NoisyInputGPSetting(
        kernel_type="rbf", kernel=KernelSetting(x_dim=2, scale=0.1),
        max_num_samples=2500, no_gradient_observation=False)
    qt = _grid_points(100, -2, 2, -1, 1)
    zt = 2 * np.sin(10 * qt[0]) * np.cos(5 * qt[1])
    gt = (20 * np.cos(10 * qt[0]) * np.cos(5 * qt[1]),
          -10 * np.sin(10 * qt[0]) * np.sin(5 * qt[1]))
    return setting, pts, z, grad, 1e-4, qt, zt, gt
