"""Replica hotel-0 trajectory replay: 3D SPGP occupancy mapping at
production scale (counterpart of the JAX package's
``examples/replica_hotel_3d.py``).

The reference ships the 983-pose hotel-0 trajectory
(data/replica-hotel-0-traj.txt) but not its mesh, so the ranges come from a
procedural hotel-room triangle mesh sized to the trajectory's bounding box
(``geometry.simulators.replica_hotel_like_mesh``), raycast on the host.
Per-pose depth-style scans -> dataset sampling + FITC updates (one CUDA
graph replay a pose on the card) -> the 3D posterior.

Usage: python -m erl_gaussian_process_tpu_torch.examples.replica_hotel_3d
       [n_poses] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.geometry import Aabb
from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
from erl_gaussian_process_tpu_torch.workloads import (
    FREE_SLOTS_PER_RAY,
    hotel0_scan,
    hotel0_setup,
    load_hotel0_trajectory,
)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n_poses", type=int, nargs="?", default=983)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    poses = load_hotel0_trajectory(n_poses=args.n_poses)
    pos = poses[:, :3, 3]
    # the workload definition (bbox, mesh, setting, pseudo grid, ray grid)
    # is the one chip_smoke.py replays
    setting, pseudo, lo, hi, mesh, d_local = hotel0_setup(poses)
    omap = SpGpOccupancyMap(setting, pseudo, Aabb.from_min_max(lo, hi),
                            seed=0, dtype=np.float32,
                            free_slots_per_ray=FREE_SLOTS_PER_RAY,
                            device=dev)

    all_hits = []
    t0 = time.perf_counter()
    for T in poses:
        t, pts, hit = hotel0_scan(mesh, T, d_local, setting.max_distance)
        omap.update(t.astype(np.float32), pts.astype(np.float32), hit)
        all_hits.append(pts[hit])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{len(poses)} pose updates in {dt:.2f}s "
          f"({len(poses) / dt:.1f} updates/s, raycasts included, on {dev})")

    # quality at the OBSERVED surface (the accumulated hits) vs free space
    rng2 = np.random.default_rng(0)
    hits = np.concatenate(all_hits)
    hits = hits[rng2.choice(len(hits), 2000, replace=False)]
    lo_surf, _ = omap.predict(hits.astype(np.float32))
    lo_traj, _ = omap.predict(pos.astype(np.float32))
    print("observed-surface occupied frac: %.3f   trajectory free frac: %.3f"
          % (float((lo_surf > 0).float().mean()),
             float((lo_traj < 0).float().mean())))


if __name__ == "__main__":
    main()
