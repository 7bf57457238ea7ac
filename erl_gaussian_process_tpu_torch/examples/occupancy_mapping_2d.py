"""2D online occupancy mapping demo: the reference's
test_spgp_occupancy_map_2d.cpp scenario end to end, with a headless
matplotlib artifact in place of the reference's OpenCV windows
(counterpart of the JAX package's ``examples/occupancy_mapping_2d.py``).

Usage: python -m erl_gaussian_process_tpu_torch.examples.occupancy_mapping_2d
       [--hinged-grid-size 31] [--test-grid-size 240] [--n-poses 50]
       [--config-file config/spgp_occupancy_map_2d.yaml] [--device cpu]

Without ``--config-file`` the map takes :func:`production_setting`, the
values of ``config/spgp_occupancy_map_2d.yaml`` built in code (reading the
YAML needs PyYAML). Writes occupancy_map_2d.png next to this script when
matplotlib is installed.
"""

import argparse
import os
import time

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.geometry import Aabb, GridMapInfo2D
from erl_gaussian_process_tpu_torch.geometry.simulators import (
    Lidar2D,
    reference_space_2d,
    reference_trajectory_2d,
)
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import (
    SpGpOccupancyMap,
    SpGpOccupancyMapSetting,
    SpGpSetting,
)

HERE = os.path.dirname(os.path.abspath(__file__))


def production_setting() -> SpGpOccupancyMapSetting:
    """``config/spgp_occupancy_map_2d.yaml``'s values: matern32 d = 2 at
    scale 0.18, 2000 samples, log-odds +-1 at variance 1e-4, 3 free points
    a meter up to 30 m, margin 0.01."""
    return SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=2, scale=0.18,
                                               scale_mix=1.0, weights=[]),
                          max_num_samples=2000, sparse_zero_threshold=1e-6,
                          use_sparse=False, diagonal_qm=False),
        min_distance=0.0, max_distance=30.0, free_points_per_meter=3.0,
        free_sampling_margin=0.01, parallel=True, logodd_free=-1.0,
        logodd_occupied=1.0, logodd_variance=1e-4)


def _cli():
    # mirrors the reference test's boost::program_options CLI
    # (test_spgp_occupancy_map_2d.cpp:385-401: --hinged-grid-size,
    # --test-grid-size, --config-file)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hinged-grid-size", type=int, default=31,
                    help="pseudo-point grid side length")
    ap.add_argument("--test-grid-size", type=int, default=240,
                    help="posterior raster side length")
    ap.add_argument("--config-file", default=None,
                    help="SpGpOccupancyMapSetting YAML (reference schema); "
                    "default: production_setting()")
    ap.add_argument("--n-poses", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap.parse_args()


def main():
    args = _cli()
    setting = production_setting() if args.config_file is None else \
        SpGpOccupancyMapSetting.from_yaml_file(args.config_file)
    dev = torch.device(args.device)
    m = args.hinged_grid_size
    pseudo = GridMapInfo2D([-3, -3], [3, 3], [m, m]) \
        .generate_meter_coordinates().T
    omap = SpGpOccupancyMap(setting, pseudo,
                            Aabb.from_min_max([-3, -3], [3, 3]),
                            seed=0, dtype=np.float32, device=dev)

    space = reference_space_2d()
    lidar = Lidar2D(Lidar2D.Setting(min_angle=-2.356, max_angle=2.356,
                                    num_lines=135), space)
    traj = reference_trajectory_2d(args.n_poses)

    def scan_of(pose):
        r = lidar.scan(pose[2], pose[:2])
        c, s = np.cos(pose[2]), np.sin(pose[2])
        dirs = lidar.ray_directions_in_frame() @ np.array([[c, -s], [s, c]]).T
        hit = np.isfinite(r)
        pts = pose[:2] + dirs * np.where(hit, r, 0.0)[:, None]
        return pose[:2].astype(np.float32), pts.astype(np.float32), hit

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    omap.update(*scan_of(traj[0]))   # warm-up: the graph's capture on CUDA
    sync()
    t0 = time.perf_counter()
    for pose in traj:
        omap.update(*scan_of(pose))
    sync()
    dt = time.perf_counter() - t0
    print(f"{len(traj)} updates in {dt:.2f}s ({len(traj) / dt:.0f} Hz, "
          f"after the warm-up, on {dev})")

    # rasterize the posterior
    tg = args.test_grid_size
    g = GridMapInfo2D([-3, -3], [3, 3], [tg, tg])
    q = g.generate_meter_coordinates().astype(np.float32)
    logodd, _ = omap.predict(q)
    img = logodd.cpu().numpy().reshape(tg, tg)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(img.T, origin="lower", extent=[-3, 3, -3, 3],
                   cmap="RdBu_r", vmin=-8, vmax=8)
    ax.plot(traj[:, 0], traj[:, 1], "k--", lw=1, label="trajectory")
    sv = space.surface_points(0.05)
    ax.plot(sv[:, 0], sv[:, 1], ".", ms=1, color="lime", label="true surface")
    ax.legend(loc="upper right")
    ax.set_title("SPGP occupancy map (logodds)")
    fig.colorbar(im, ax=ax, shrink=0.8)
    out = os.path.join(HERE, "occupancy_map_2d.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)


if __name__ == "__main__":
    main()
