#!/usr/bin/env python3
"""Time the SPGP map's main path of several checkouts of this repo, in
alternation, on one NVIDIA GPU.

    python3 main_path_ab.py DIR [DIR ...]

Each DIR is the root of a checkout (``.`` for this one); a DIR given twice
is timed twice, so ``PARENT . . PARENT`` runs parent, change, change,
parent. Each run is a process of its own that imports the PyTorch port and
that checkout's ``chip_smoke.py`` from DIR only, builds the kernels there
and reports, on the card whose name and power limit it prints:

- hotel-0 (983 poses, float32, ``workloads.hotel0_workload``) through
  ``SpGpOccupancyMap.update`` pose by pose: ms/pose, the median and range
  of REPLAYS replays after a two-pose warm-up;
- the 2D map at its production config (``chip_smoke.map2d_*``, 50 poses)
  likewise;
- row 1: ``fitc_update_cuda`` at M = 1152 (an 11 x 11 x 9 pseudo grid),
  N = 2048, d = 3, matern32 at scale 0.6, var 1e-4, float32;
- row 2a: ``cross_gram_cuda`` of the same pseudo points and samples;

both rows as CUDA-event ms (median of 20) and host ms a call. The numbers
of every run are printed as they come; the last line is one JSON object
with all of them. Only the call order, not the code measured, differs
between runs of one DIR.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPLAYS = 5


def child(tree: str) -> dict:
    """One run in this process, with the port imported from ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from erl_gaussian_process_tpu_torch.geometry import Aabb
    from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
    from erl_gaussian_process_tpu_torch.models.gp_core import (
        use_full_fp32_matmul,
    )
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        pad_pseudo_points,
        spgp_init,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        cross_gram_cuda,
        fitc_update_cuda,
    )
    from erl_gaussian_process_tpu_torch.ops._build import load_library
    from erl_gaussian_process_tpu_torch.workloads import (
        FREE_SLOTS_PER_RAY,
        hotel0_workload,
    )

    import erl_gaussian_process_tpu_torch as port

    for mod in (cs, port):
        assert os.path.abspath(mod.__file__).startswith(tree + os.sep), mod
    use_full_fp32_matmul()
    dev = torch.device("cuda", 0)
    load_library()

    def ms_per_pose(new_map, sensors, pts, masks):
        warm = new_map()
        for i in range(2):
            warm.update(sensors[i], pts[i], masks[i])
        out = []
        for _ in range(REPLAYS):
            m = new_map()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(len(sensors)):
                m.update(sensors[i], pts[i], masks[i])
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0) / len(sensors))
        return {"median": statistics.median(out), "range": [min(out),
                                                            max(out)],
                "all": out}

    sensors, pts, masks, _, _, setting, pseudo, lo, hi = hotel0_workload()
    box = Aabb.from_min_max(lo, hi)
    hotel0 = ms_per_pose(
        lambda: SpGpOccupancyMap(setting, pseudo, box, seed=0,
                                 dtype=torch.float32,
                                 free_slots_per_ray=FREE_SLOTS_PER_RAY,
                                 device=dev), sensors, pts, masks)
    s2, p2, m2 = cs.map2d_scans(cs.MAP2D_POSES)
    box2 = Aabb.from_min_max([-3.0, -3.0], [3.0, 3.0])
    map2d = ms_per_pose(
        lambda: SpGpOccupancyMap(cs.map2d_setting(), cs.map2d_pseudo(), box2,
                                 seed=0, dtype=torch.float32,
                                 free_slots_per_ray=cs.MAP2D_FREE_SLOTS,
                                 device=dev), s2, p2, m2)

    rng = np.random.default_rng(0)
    axes = [np.linspace(-1.5, 1.5, 11)] * 2 + [np.linspace(-1.2, 1.2, 9)]
    grid = np.stack([a.ravel() for a in np.meshgrid(*axes, indexing="ij")],
                    -1)
    st = spgp_init(torch.as_tensor(pad_pseudo_points(grid),
                                   dtype=torch.float32, device=dev), 0.6,
                   kernel="matern32")

    def t(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    x = t(rng.uniform(-1.5, 1.5, (2048, 3)))
    fitc_args = (st.pseudo, st.L_inv, x, t(rng.choice([-1.0, 1.0],
                                                      (2048, 1))),
                 t(np.full(2048, 1e-4)), t(rng.uniform(size=2048) < 0.9,
                                           torch.bool))
    rows = {}
    for name, fn in (
            ("row1_fitc", lambda: fitc_update_cuda("matern32", *fitc_args,
                                                   0.6)),
            ("row2a_gram", lambda: cross_gram_cuda("matern32", st.pseudo, x,
                                                   0.6))):
        rows[name] = {"event_ms": cs.cuda_ms(fn), "host_ms": cs.host_ms(fn)}
    return {"tree": tree, "card": cs.card_line(),
            "hotel0_ms_per_pose": hotel0, "map2d_ms_per_pose": map2d, **rows}


def main(trees) -> int:
    runs = []
    for tree in trees:
        root = os.path.abspath(tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], capture_output=True,
                             text=True, cwd=root)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(f"{tree} on {run['card']}: hotel-0 "
              f"{run['hotel0_ms_per_pose']['median']:.4f} ms/pose (median of "
              f"{REPLAYS}, range {run['hotel0_ms_per_pose']['range'][0]:.4f}-"
              f"{run['hotel0_ms_per_pose']['range'][1]:.4f}); 2D map "
              f"{run['map2d_ms_per_pose']['median']:.4f} ms/pose (range "
              f"{run['map2d_ms_per_pose']['range'][0]:.4f}-"
              f"{run['map2d_ms_per_pose']['range'][1]:.4f}); row 1 "
              f"{run['row1_fitc']['event_ms']:.4f} ms event, "
              f"{run['row1_fitc']['host_ms']:.4f} ms host; row 2a "
              f"{run['row2a_gram']['event_ms']:.4f} ms event, "
              f"{run['row2a_gram']['host_ms']:.4f} ms host", flush=True)
    for tree in dict.fromkeys(trees):
        mine = [r for r, t in zip(runs, trees) if t == tree]
        print(f"{tree}: medians over its {len(mine)} runs: " + "; ".join(
            f"{key}.{sub} " + " ".join(f"{r[key][sub]:.4f}" for r in mine)
            + f" (median {statistics.median(r[key][sub] for r in mine):.4f})"
            for key, sub in (("hotel0_ms_per_pose", "median"),
                             ("map2d_ms_per_pose", "median"),
                             ("row1_fitc", "event_ms"),
                             ("row1_fitc", "host_ms"),
                             ("row2a_gram", "event_ms"),
                             ("row2a_gram", "host_ms"))), flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
        sys.exit(0)
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
