"""Deployment-artifact walkthrough: export the occupancy-map update and the
prepared-posterior predict as ``torch.export`` artifacts, then run a
50-pose mapping episode through the artifacts, as a serving host would,
with no model code traced in the serving loop (counterpart of the JAX
package's ``examples/deploy_serving.py``; ``utils/deploy.py`` says how the
contract differs from ``jax.export``'s: the update takes the sampler's
fractions ``u`` in place of ``(key, step)``, the scale is baked, one device
an artifact).

Usage: python -m erl_gaussian_process_tpu_torch.examples.deploy_serving
       [--device cpu]
"""

import argparse

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.geometry import free_sample_fractions
from erl_gaussian_process_tpu_torch.geometry.simulators import (
    Lidar2D,
    reference_space_2d,
    reference_trajectory_2d,
)
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import (
    SpGpOccupancyMapSetting,
    SpGpSetting,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    spgp_init,
    spgp_prepare,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    step_seed,
)
from erl_gaussian_process_tpu_torch.utils.deploy import (
    export_map_predict_step,
    export_map_update_step,
    load_fn,
)

N_RAYS = 135
SLOTS = 8
GRID = 21


def main(device: str = "cuda"):
    dev = torch.device(device)
    setting = SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=2, scale=0.25),
                          max_num_samples=1024),
        min_distance=0.0, max_distance=30.0, free_points_per_meter=2.0,
        free_sampling_margin=0.02, logodd_free=-1.0, logodd_occupied=1.0,
        logodd_variance=1e-4)

    # --- build side: export once, ship bytes -----------------------------
    update_blob = export_map_update_step(
        setting, n_pseudo=GRID * GRID, n_rays=N_RAYS, free_slots=SLOTS,
        device=dev)
    predict_blob = export_map_predict_step(
        n_pseudo=GRID * GRID, scale=0.25, n_queries=None,  # dynamic queries
        device=dev)
    print(f"artifacts: update {len(update_blob)/1e3:.1f} kB, "
          f"predict {len(predict_blob)/1e3:.1f} kB (torch.export, {dev})")

    # --- serving side: load bytes, run the episode ------------------------
    update = load_fn(update_blob)
    predict = load_fn(predict_blob)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    c = np.linspace(-3, 3, GRID, dtype=np.float32)
    pv, qv = np.meshgrid(c, c, indexing="ij")
    state = spgp_init(t(np.stack([pv.ravel(), qv.ravel()], axis=-1)), 0.25,
                      kernel="matern32")

    space = reference_space_2d()
    lidar = Lidar2D(Lidar2D.Setting(min_angle=-2.35, max_angle=2.35,
                                    num_lines=N_RAYS), space)
    gen = torch.Generator(device=dev)
    lo, hi = t([-3.0, -3.0]), t([3.0, 3.0])
    for k, pose in enumerate(reference_trajectory_2d(50)):
        r = lidar.scan(pose[2], pose[:2])
        cth, sth = np.cos(pose[2]), np.sin(pose[2])
        dirs = lidar.ray_directions_in_frame() @ np.array(
            [[cth, -sth], [sth, cth]], np.float32).T
        hit = np.isfinite(r)
        pts = (pose[:2] + dirs * np.where(hit, r, 0.0)[:, None]).astype(
            np.float32)
        # the sampler's draws for pose k + 1 of a map seeded with 0
        gen.manual_seed(step_seed(0, k + 1))
        u = free_sample_fractions(N_RAYS, SLOTS,
                                  setting.free_sampling_margin, gen,
                                  torch.float32, dev)
        state, n_used = update(state, u, t(pose[:2]), t(pts),
                               t(hit, torch.bool), lo, hi)

    L_qm, a = spgp_prepare(state)
    surf = space.surface_points(0.05).astype(np.float32)
    lo_surf, _ = predict(state, L_qm, a, t(surf))
    traj = reference_trajectory_2d(50)[:, :2].astype(np.float32)
    lo_traj, _ = predict(state, L_qm, a, t(traj))
    occ = float((lo_surf[:, 0] > 0).float().mean())
    free = float((lo_traj[:, 0] < 0).float().mean())
    print(f"map through artifacts: surface occupied {occ:.1%}, "
          f"trajectory free {free:.1%}")
    if not (occ > 0.9 and free > 0.95):
        raise SystemExit("deploy: the map through the artifacts fails its "
                         "quality gate")
    print("deploy OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
