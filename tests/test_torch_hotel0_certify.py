"""The main path's certification against the JAX reference: the port's
float32 hotel-0 map (full width: 1089 pseudo points padded to 1152, 384
rays, a 2048-sample budget) replays a prefix of the trajectory through
``update_batch(collect_datasets=True)``, and the datasets it consumed go
through the JAX package's float64 pipeline
(``erl_gaussian_process_tpu/utils/drift.replay_f64``). The posterior
log-odds on the drift grid must agree within ``bench.py``'s gate (relative
drift <= 0.2), the same comparison ``tests/test_torch_occupancy_map_2d.py``
makes for the 2D map, and within a tighter limit set from the 128-pose
reading (``CERTIFY_DRIFT``).

:func:`certify` is the whole check for any number of poses; the full
983-pose trajectory runs it as ``python -c "import sys; sys.path.insert(0,
'tests'); import conftest, test_torch_hotel0_certify as t;
print(t.certify(None))"`` from the repository root (a few minutes of CPU).
:func:`rounding_spread` (one seed a call) and :func:`fused_update_rounding`
run the same way.
"""

import time

import numpy as np

from erl_gaussian_process_tpu.utils.drift import drift_metric, replay_f64
from erl_gaussian_process_tpu_torch.geometry import Aabb
from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
from erl_gaussian_process_tpu_torch.utils.drift import sign_agreement
from erl_gaussian_process_tpu_torch.workloads import (
    FREE_SLOTS_PER_RAY,
    hotel0_query_grid,
    hotel0_workload,
)

DRIFT_GATE_MAX = 0.2  # bench.py:263
CERTIFY_POSES = 128
# The 128-pose drift reads 8.38e-4 on the CPU; the bench gate alone would pass a
# port fault that moved this posterior by a few percent, so the prefix is
# also held to ~12x its reading (the 983-pose replay reads 0.0875: float32
# rounding grows with the poses, which the bench gate is sized for).
CERTIFY_DRIFT = 1e-2


def certify(n_poses):
    """Replay hotel-0's first ``n_poses`` poses (all of them for None) on
    the port's float32 CPU map and its datasets through JAX's float64
    replay. Returns {drift, sign_agreement, n_used, seconds of each
    side}."""
    sensors, pts, masks, _, _, setting, pseudo, lo, hi = hotel0_workload(
        n_poses=n_poses)
    omap = SpGpOccupancyMap(setting, pseudo, Aabb.from_min_max(lo, hi),
                            seed=0, dtype=np.float32,
                            free_slots_per_ray=FREE_SLOTS_PER_RAY,
                            device="cpu")
    grid = hotel0_query_grid(lo, hi)
    t0 = time.perf_counter()
    n_used, (dx, dy, dm) = omap.update_batch(sensors, pts, masks,
                                             collect_datasets=True)
    lo32 = omap.predict(grid)[0].double().numpy()
    t_port = time.perf_counter() - t0
    t0 = time.perf_counter()
    lo64 = replay_f64(omap.state.pseudo.numpy(), setting.sp_gp.kernel.scale,
                      omap.sp_gp._kernel, dx.numpy(), dy.numpy(), dm.numpy(),
                      setting.logodd_variance, grid)
    t_jax = time.perf_counter() - t0
    assert np.isfinite(lo32).all() and np.isfinite(lo64).all()
    return {"poses": len(sensors), "drift": drift_metric(lo32, lo64),
            "sign_agreement": sign_agreement(lo32, lo64),
            "n_used": int(n_used.sum()), "port_s": t_port, "jax_s": t_jax,
            "pseudo": tuple(omap.state.pseudo.shape)}


def rounding_spread(n_poses, seed=0):
    """Two float32 hotel-0 maps a rounding order apart (``poses_per_step``
    1 and 4: the same datasets, summed in other groupings), for the port's
    map and the JAX package's, both seeded with ``seed``: how far their
    drift-grid posteriors land from each other (max |diff| / max, sign
    agreement) and from the float64 replay of each side's datasets. A port
    whose spread matches the reference's rounds no worse than it. Also, per
    side: the same gap with both states prepared exactly in float64 on the
    host (``spgp_prepare_exact_host``), whether each map's own prepare is
    that exact one (the second tier), and how far the c = 4 state's
    Q_M - Q_M_c lies from c = 1's (relative Frobenius). Returns
    {side: {...}}."""
    import jax.numpy as jnp
    import torch

    from erl_gaussian_process_tpu.geometry import Aabb as JaxAabb
    from erl_gaussian_process_tpu.models import sparse_pseudo_input_gp as jsp
    from erl_gaussian_process_tpu.models.spgp_occupancy_map import (
        SpGpOccupancyMap as JaxSpGpOccupancyMap,
    )
    from erl_gaussian_process_tpu_torch.models import (
        sparse_pseudo_input_gp as tsp,
    )
    from erl_gaussian_process_tpu.workloads import (
        hotel0_setup,
        load_hotel0_trajectory,
    )

    sensors, pts, masks, _, _, setting, pseudo, lo, hi = hotel0_workload(
        n_poses=n_poses)
    jax_setting = hotel0_setup(load_hotel0_trajectory(n_poses=n_poses))[0]
    grid = hotel0_query_grid(lo, hi)
    kw = dict(seed=seed, dtype=np.float32,
              free_slots_per_ray=FREE_SLOTS_PER_RAY)
    sides = {
        "port": lambda: SpGpOccupancyMap(setting, pseudo,
                                         Aabb.from_min_max(lo, hi),
                                         device="cpu", **kw),
        "jax": lambda: JaxSpGpOccupancyMap(jax_setting, pseudo,
                                           JaxAabb.from_min_max(lo, hi),
                                           **kw)}
    out = {}
    for side, new_map in sides.items():
        m1, m4 = new_map(), new_map()
        _, (dx, dy, dm) = m1.update_batch(sensors, pts, masks,
                                          collect_datasets=True)
        m4.update_batch(sensors, pts, masks, poses_per_step=4)
        lo1, lo4 = (np.asarray(m.predict(grid)[0], np.float64)
                    for m in (m1, m4))
        lo64 = replay_f64(np.asarray(m1.state.pseudo, np.float64),
                          setting.sp_gp.kernel.scale, m1.sp_gp._kernel,
                          np.asarray(dx), np.asarray(dy), np.asarray(dm),
                          setting.logodd_variance, grid)
        exact, tier2, qm = [], [], []
        for m in (m1, m4):
            st = m.sp_gp.state
            L, a = m.sp_gp._prepared()
            if side == "port":
                Le, ae = tsp.spgp_prepare_exact_host(st)
                lo_e = tsp.spgp_predict(st, Le, ae, torch.tensor(grid),
                                        m.sp_gp._scale,
                                        kernel=m.sp_gp._kernel,
                                        with_var=False)[0]
            else:
                Le, ae = jsp.spgp_prepare_exact_host(st)
                lo_e = jsp.spgp_predict(st, Le, ae, jnp.asarray(grid),
                                        m.sp_gp._scale,
                                        kernel=m.sp_gp._kernel,
                                        with_var=False)[0]
            exact.append(np.asarray(lo_e, np.float64)[:, 0])
            tier2.append(bool(np.array_equal(np.asarray(L), np.asarray(Le))))
            qm.append(np.asarray(st.qm, np.float64)
                      - np.asarray(st.qm_c, np.float64))
        out[side] = {"c4_vs_c1": drift_metric(lo4, lo1),
                     "c4_vs_c1_signs": float(np.mean(np.sign(lo4)
                                                     == np.sign(lo1))),
                     "drift_c1": drift_metric(lo1, lo64),
                     "drift_c4": drift_metric(lo4, lo64),
                     "c4_vs_c1_exact_prepare": drift_metric(exact[1],
                                                            exact[0]),
                     "exact_tier_c1_c4": tier2,
                     "qm_c4_vs_c1": float(np.linalg.norm(qm[1] - qm[0])
                                          / np.linalg.norm(qm[0]))}
    return out


def fused_update_rounding(n_poses=8, c=4):
    """The float32 FITC update's rounding, port (``fitc_update_plain``, the
    CPU version) against reference (JAX's ``fitc_delta`` with ``L_inv``),
    on hotel-0's datasets of the port's map: for each chunk of c poses,
    (a) one fused update (N = c x 2048, made as each side's map makes it:
    the port's summed pose by pose, ``block`` = 2048) against the float64
    sum of its c per-pose updates made the same way, and (b) each side's
    fused update against the float64 update of the same inputs; relative
    Frobenius of dQ. Returns {side: {"fused_vs_per_pose": [...],
    "vs_float64": [...]}}."""
    import jax.numpy as jnp
    import torch

    from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
        fitc_delta,
    )
    from erl_gaussian_process_tpu_torch.ops.fitc import fitc_update_plain

    sensors, pts, masks, _, _, setting, pseudo, lo, hi = hotel0_workload(
        n_poses=n_poses)
    omap = SpGpOccupancyMap(setting, pseudo, Aabb.from_min_max(lo, hi),
                            seed=0, dtype=np.float32,
                            free_slots_per_ray=FREE_SLOTS_PER_RAY,
                            device="cpu")
    _, (dx, dy, dm) = omap.update_batch(sensors, pts, masks,
                                        collect_datasets=True)
    kern, scale = omap.sp_gp._kernel, omap.sp_gp._scale
    P, Li = omap.state.pseudo.numpy(), omap.state.L_inv.numpy()

    def port(dt, *args, block=0):
        return fitc_update_plain(kern, *(torch.tensor(a).to(
            dt if a.dtype != bool else torch.bool) for a in (P, Li, *args)),
            scale, block)[0].double().numpy()

    def jax_(x, y, v, k, block=0):
        return np.asarray(fitc_delta(
            jnp.asarray(P), None, *map(jnp.asarray, (x, y, v, k)),
            np.float32(scale), kernel=kern, L_inv=jnp.asarray(Li))[0],
            np.float64)

    sides = {"port": lambda *a, block=0: port(torch.float32, *a,
                                              block=block), "jax": jax_}
    out = {s: {"fused_vs_per_pose": [], "vs_float64": []} for s in sides}
    for lo_ in range(0, n_poses - c + 1, c):
        parts = [(dx[i].numpy(), dy[i].numpy(),
                  np.full(dm.shape[1], setting.logodd_variance, np.float32),
                  dm[i].numpy()) for i in range(lo_, lo_ + c)]
        fused_in = [np.concatenate(t) for t in zip(*parts)]
        ref64 = port(torch.float64, *fused_in)
        for side, f in sides.items():
            fused = f(*fused_in, block=dm.shape[1])
            per_pose = sum(f(*p) for p in parts)
            out[side]["fused_vs_per_pose"].append(float(
                np.linalg.norm(fused - per_pose) / np.linalg.norm(per_pose)))
            out[side]["vs_float64"].append(float(
                np.linalg.norm(fused - ref64) / np.linalg.norm(ref64)))
    return out


def test_hotel0_prefix_f32_against_jax_f64_replay():
    out = certify(CERTIFY_POSES)
    assert out["poses"] == CERTIFY_POSES and out["pseudo"] == (1152, 3)
    assert out["n_used"] > 0
    assert out["drift"] <= DRIFT_GATE_MAX, out
    assert out["drift"] < CERTIFY_DRIFT, out
    # recorded beside the drift (PERF.md §6): the confident cells' sign
    # agreement of the float32 map with the float64 reference
    assert out["sign_agreement"] > 0.999, out


def test_fused_update_rounds_like_jax():
    """A fused update of c = 4 hotel-0 poses (the plain version summing
    pose by pose) departs from the sum of its per-pose updates no more
    than 1.5x as far as JAX's fused update does on the same datasets."""
    out = fused_update_rounding(8, 4)
    port, ref = out["port"]["fused_vs_per_pose"], \
        out["jax"]["fused_vs_per_pose"]
    assert len(port) == len(ref) == 2
    assert all(0 < p <= 1.5 * r for p, r in zip(port, ref)), out
    assert all(v < 2e-6 for side in out.values()
               for v in side["vs_float64"]), out
