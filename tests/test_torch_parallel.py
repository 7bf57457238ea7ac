"""The port's sharded paths (``erl_gaussian_process_tpu_torch/parallel``)
on gloo CPU ranks, against the JAX package's sharded functions on its
virtual 8-device mesh (``tests/test_parallel.py``'s cases, shapes and
tolerances) and against the port's one-process classes.

Each world size (8 ranks, and 2 and 4 for the weak-scaling shapes and the
graphed mesh) is spawned once for the module: its ranks initialise gloo
over a ``FileStore`` in a temporary directory, install the eager capture
stand-in (``tests/torch_graph_standin.py``), run every case of that size,
and each rank saves its results. The graphed cases give the CPU models
the graphs a capturable (NCCL) mesh builds on the card, so the ranks run
the captured bodies, their routing and their lockstep, each replay rerunning
its body's collectives. The tests then hold the results to their
references, and every rank's results to rank 0's (the outputs come back
replicated). The ranks import this module, so it keeps JAX out of module
scope: JAX is imported inside the tests and fixtures that need it.
"""

import datetime

import numpy as np
import pytest
import torch
import torch_graph_standin

from erl_gaussian_process_tpu_torch.geometry import Aabb, LidarFrame3DSetting
from erl_gaussian_process_tpu_torch.geometry.lidar_frame_2d import (
    LidarFrame2DSetting,
)
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import (
    LidarGaussianProcess2D,
    LidarGP2DSetting,
    RangeSensorGaussianProcess3D,
    RangeSensorGP3DSetting,
    SpGpOccupancyMap,
    VanillaGPSetting,
)
from erl_gaussian_process_tpu_torch.models.batch_gp import bank_fit
from erl_gaussian_process_tpu_torch.models.pose_graph import (
    PoseGraphs,
    pose_chunk_body,
)
from erl_gaussian_process_tpu_torch.models.sensor_graph import SensorGraphs
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SpGpSetting,
    SpGpState,
    spgp_init,
    spgp_predict,
    spgp_prepare,
    spgp_update,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMapSetting,
    step_seed,
)
from erl_gaussian_process_tpu_torch.parallel import (
    make_mesh,
    sharded_bank_fit,
    sharded_spgp_predict,
    sharded_spgp_update,
)
from erl_gaussian_process_tpu_torch.parallel.mesh import (
    Mesh,
    _pad_axis,
    all_reduce,
    runs_graphs,
    sharded_update_many,
    sharded_update_step,
)
from erl_gaussian_process_tpu_torch.parallel.spawn import spawn_world

WORLD = 8
WEAK_SIZES = (2, 4, 8)
RANK_TIMEOUT_S = 120    # init_process_group: a dead rank fails the others
JOIN_TIMEOUT_S = 420    # the whole world
N_PER = 192             # weak scaling: samples per rank

# -- inputs, made from numpy seeds (the same in the ranks and the tests) ---


def _bank_inputs(seed, B, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (B, n, 1)), rng.uniform(-1, 1, (B, n, 1)),
            np.full((B, n), 1e-3), rng.uniform(size=(B, n)) < 0.8)


def _update_inputs():
    rng = np.random.default_rng(1)
    c = np.linspace(-1, 1, 5)
    pv, qv = np.meshgrid(c, c, indexing="ij")
    pseudo = np.stack([pv.ravel(), qv.ravel()], axis=-1)
    n = 8 * 25
    return (pseudo, rng.uniform(-1, 1, (n, 2)), rng.uniform(-1, 1, (n, 1)),
            np.full((n,), 1e-3), rng.uniform(size=(n,)) < 0.9)


def _predict_inputs():
    rng = np.random.default_rng(0)
    pseudo = rng.uniform(-1, 1, (32, 2))
    n = 64
    x, y = rng.uniform(-1, 1, (n, 2)), rng.uniform(-1, 1, (n, 1))
    return pseudo, x, y, rng.uniform(-1, 1, (8 * 5, 2))


def _sparse_inputs():
    rng = np.random.default_rng(7)
    pseudo = rng.uniform(-1, 1, (16, 2))
    n = 8 * 6
    x, y = rng.uniform(-1, 1, (n, 2)), rng.uniform(-1, 1, (n, 1))
    return pseudo, x, y, rng.uniform(-1, 1, (8 * 4, 2))


SPARSE_ZT = 0.3


def _weak_inputs(D):
    c = np.linspace(-1, 1, 8)
    pv, qv = np.meshgrid(c, c, indexing="ij")
    pseudo = np.stack([pv.ravel(), qv.ravel()], -1).astype(np.float32)
    rng = np.random.default_rng(0)
    n = N_PER * D
    return (pseudo, rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            rng.uniform(-1, 1, (n, 1)).astype(np.float32))


def _t(a):
    return torch.tensor(np.asarray(a))


def _map_setting():
    return SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=2, scale=0.18),
                          max_num_samples=2000),
        min_distance=0.0, max_distance=30.0, free_points_per_meter=3.0,
        free_sampling_margin=0.01, logodd_free=-1.0, logodd_occupied=1.0,
        logodd_variance=1e-4)


def _make_map(mesh, dtype, seed=0):
    """tests/test_parallel.py's map: 21x21 pseudo points over [-3, 3]^2."""
    c = np.linspace(-3, 3, 21)
    pv, qv = np.meshgrid(c, c, indexing="ij")
    pseudo = np.stack([pv.ravel(), qv.ravel()], axis=0)
    return SpGpOccupancyMap(_map_setting(), pseudo,
                            Aabb.from_min_max([-3, -3], [3, 3]), seed=seed,
                            dtype=dtype, free_slots_per_ray=20, mesh=mesh,
                            device="cpu")


def _scan_batches(n_scans=4, n_rays=135, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_scans):
        origin = rng.uniform(-0.5, 0.5, 2)
        ang = np.linspace(-2.356, 2.356, n_rays) + 0.1 * k
        r = 2.0 + 0.4 * np.sin(3 * ang + k)
        pts = origin + np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)
        out.append((origin, pts))
    return out


# the 3D map of tests/test_torch_occupancy_map.py (5x5x5 pseudo points,
# 160 rays a pose), for the sharded step against JAX's with JAX's draws
STEP_RADIUS, STEP_SLOTS, STEP_POSES, STEP_RAYS, STEP_SEED = 1.5, 4, 5, 160, 7
STEP_SETTING = dict(min_distance=0.05, max_distance=10.0,
                    free_points_per_meter=2.0, free_sampling_margin=0.02,
                    logodd_free=-1.0, logodd_occupied=1.0,
                    logodd_variance=1e-4)


def _step_pseudo():
    c = np.linspace(-2, 2, 5)
    g = np.meshgrid(c, c, c, indexing="ij")
    return np.stack([a.ravel() for a in g], axis=0)


def _step_scans():
    rng = np.random.default_rng(2)
    sensors, pts, masks = [], [], []
    for _ in range(STEP_POSES):
        o = rng.uniform(-0.4, 0.4, 3)
        d = rng.normal(size=(STEP_RAYS, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        b = d @ o
        t = -b + np.sqrt(b * b + (STEP_RADIUS ** 2 - o @ o))
        sensors.append(o)
        pts.append(np.where((rng.uniform(size=STEP_RAYS) < 0.9)[:, None],
                            o + t[:, None] * d, 0.0))
        masks.append(np.any(pts[-1] != 0.0, axis=1))
    return np.stack(sensors), np.stack(pts), np.stack(masks)


def _step_kw(setting):
    return dict(kernel="matern32", diagonal_qm=False, free_slots=STEP_SLOTS,
                max_samples=int(setting.sp_gp.max_num_samples),
                min_distance=setting.min_distance,
                max_distance=setting.max_distance,
                free_sampling_margin=setting.free_sampling_margin,
                free_points_per_meter=setting.free_points_per_meter,
                logodd_occupied=setting.logodd_occupied,
                logodd_free=setting.logodd_free,
                logodd_variance=setting.logodd_variance)


def _step_setting():
    return SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=3, scale=0.6),
                          max_num_samples=256), **STEP_SETTING)


def _lidar2d(mesh):
    s = LidarGP2DSetting(sensor_frame=LidarFrame2DSetting(
        num_rays=180, angle_min=-2.356, angle_max=2.356))
    return LidarGaussianProcess2D(s, dtype=np.float64, mesh=mesh,
                                  device="cpu")


def _gp3d(mesh):
    s = RangeSensorGP3DSetting(
        row_group_size=12, row_overlap_size=4, row_margin=0,
        col_group_size=12, col_overlap_size=4, col_margin=0,
        min_num_samples_per_group=10, sensor_range_var=1e-4,
        sensor_frame=LidarFrame3DSetting(
            valid_range_min=0.1, valid_range_max=40.0, azimuth_min=-np.pi,
            azimuth_max=np.pi, elevation_min=-0.6, elevation_max=0.6,
            num_azimuth_lines=64, num_elevation_lines=33),
        gp=VanillaGPSetting(kernel_type="ou",
                            kernel=KernelSetting(x_dim=2, scale=0.5)))
    return RangeSensorGaussianProcess3D(s, dtype=np.float64, mesh=mesh,
                                        device="cpu")


def _gp3d_scan(gp):
    dirs = gp.sensor_frame.ray_directions_in_frame()
    az = np.arctan2(dirs[..., 1], dirs[..., 0])
    el = np.arctan2(dirs[..., 2], np.hypot(dirs[..., 0], dirs[..., 1]))
    ranges = 5.0 + 0.5 * np.sin(3 * az) * np.cos(2 * el)
    rng = np.random.default_rng(1)
    return np.where(rng.uniform(size=ranges.shape) < 0.2, np.inf, ranges)


# -- what each rank runs ---------------------------------------------------


def _np_out(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().numpy()
    if isinstance(obj, dict):
        return {k: _np_out(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_np_out(v) for v in obj]
    return obj


def _case_mesh(mesh, extra):
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
           "host_staging": mesh.host_staging, "axis": mesh.axis_name}
    try:
        make_mesh(mesh.size + 1, device="cpu")
    except ValueError:
        out["wrong_size_raises"] = True
    return out


def _case_bank(seed, B, n):
    def run(mesh, extra):
        x, y, var, mask = (_t(a) for a in _bank_inputs(seed, B, n))
        st = sharded_bank_fit(mesh, x, y, var, mask, 0.3, kernel="rbf")
        return {"L": st.L, "L_inv": st.L_inv, "alpha": st.alpha,
                "trained": st.trained}
    return run


def _case_update(mesh, extra):
    pseudo, x, y, var, mask = (_t(a) for a in _update_inputs())
    st = spgp_init(pseudo, 0.4, kernel="matern32")
    st = sharded_spgp_update(mesh, st, x, y, var, mask, 0.4,
                             kernel="matern32")
    return {"qm": st.qm, "alpha": st.alpha}


def _case_predict(mesh, extra):
    pseudo, x, y, xq = (_t(a) for a in _predict_inputs())
    st = spgp_init(pseudo, 0.4, kernel="matern32")
    n = x.shape[0]
    st = spgp_update(st, x, y, torch.full((n,), 1e-3, dtype=x.dtype),
                     torch.ones(n, dtype=torch.bool), 0.4, kernel="matern32")
    L_qm, a = spgp_prepare(st)
    mean, var = sharded_spgp_predict(mesh, st, L_qm, a, xq, 0.4,
                                     kernel="matern32")
    mean_r, _, var_r = spgp_predict(st, L_qm, a, xq, 0.4, kernel="matern32")
    return {"mean": mean, "var": var, "mean_local": mean_r,
            "var_local": var_r}


def _case_sparse(mesh, extra):
    pseudo, x, y, xq = (_t(a) for a in _sparse_inputs())
    n = x.shape[0]
    var = torch.full((n,), 1e-3, dtype=x.dtype)
    mask = torch.ones(n, dtype=torch.bool)
    st0 = spgp_init(pseudo, 0.25, kernel="matern32", diagonal_qm=True)
    sh = sharded_spgp_update(mesh, st0, x, y, var, mask, 0.25,
                             kernel="matern32", diagonal_qm=True,
                             zero_threshold=SPARSE_ZT)
    L_qm, a = spgp_prepare(sh, diagonal_qm=True)
    mean, var_q = sharded_spgp_predict(mesh, sh, L_qm, a, xq, 0.25,
                                       kernel="matern32",
                                       zero_threshold=SPARSE_ZT)
    return {"qm": sh.qm, "alpha": sh.alpha, "mean": mean, "var": var_q}


def _map_state(m):
    return {"qm": m.sp_gp.state.qm, "alpha": m.sp_gp.state.alpha,
            "step": m.step}


def _case_map(dtype):
    def run(mesh, extra):
        m = _make_map(mesh, dtype)
        used = [m.update(o.astype(dtype), p.astype(dtype))
                for o, p in _scan_batches()]
        q = _scan_batches(1)[0][1]
        q = q[::5] if dtype == np.float64 else q[::3]
        return {**_map_state(m), "used": torch.stack(used),
                "lo": m.predict(q.astype(dtype))[0]}
    return run


def _many_inputs(n_scans, dtype):
    scans = _scan_batches(n_scans=n_scans)
    sensors = np.stack([s for s, _ in scans]).astype(dtype)
    pts = np.stack([p for _, p in scans]).astype(dtype)
    return sensors, pts, np.ones(pts.shape[:2], bool)


def _case_many(n_scans, dtype):
    def run(mesh, extra):
        m = _make_map(mesh, dtype)
        used = m.update_batch(*_many_inputs(n_scans, dtype), poses_per_step=8)
        q = _scan_batches(1)[0][1][::5].astype(dtype)
        return {**_map_state(m), "used": used, "lo": m.predict(q)[0]}
    return run


def _case_lidar2d(mesh, extra):
    gp = _lidar2d(mesh)
    ang = gp.sensor_frame.angles_in_frame
    assert gp.train(np.eye(2), np.zeros(2), 2.0 + 0.3 * np.sin(4 * ang))
    mean, valid = gp.test(np.linspace(-2.0, 2.0, 57), True, True).get_mean()
    return {"L": gp.bank.L, "L_inv": gp.bank.L_inv, "alpha": gp.bank.alpha,
            "mean": mean, "valid": valid}


def _case_gp3d(mesh, extra):
    gp = _gp3d(mesh)
    assert gp.train(np.eye(3), np.zeros(3), _gp3d_scan(gp))
    q = gp.sensor_frame.ray_directions_in_frame().reshape(-1, 3)[::7]
    res = gp.test(q, True, True)
    raised = False
    try:
        gp.train_scan_batch(_gp3d_scan(gp)[None])
    except ValueError:
        raised = True
    return {"L": gp.bank.L, "L_inv": gp.bank.L_inv, "alpha": gp.bank.alpha,
            "trained": gp.bank.trained, "mean": res.get_mean()[0],
            "valid": res.get_mean()[1], "var": res.get_variance()[0],
            "scan_batch_raises": raised}


def _case_step(mesh, extra):
    setting = _step_setting()
    m = SpGpOccupancyMap(setting, _step_pseudo(),
                         Aabb.from_min_max([-2.0] * 3, [2.0] * 3),
                         seed=STEP_SEED, dtype=np.float64,
                         free_slots_per_ray=STEP_SLOTS, device="cpu")
    st, used = m.sp_gp.state, []
    for i, (o, p, mk) in enumerate(zip(*_step_scans())):
        st, n_used = sharded_update_step(
            mesh, st, STEP_SEED, i + 1, _t(o), _t(p), _t(mk), m._aabb_min,
            m._aabb_max, 0.6, u=_t(extra["step_u"][i]), **_step_kw(setting))
        used.append(n_used)
    return {"qm": st.qm, "alpha": st.alpha, "used": torch.stack(used)}


def _case_weak(mesh, extra):
    """The f32 update at N_PER samples a rank; records the shapes each
    rank's FITC call saw."""
    import erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp as sp

    shapes = []
    fitc = sp.fitc_update_cuda

    def spy(name, pseudo, linv, x, *args):
        shapes.append([list(pseudo.shape), list(x.shape)])
        return fitc(name, pseudo, linv, x, *args)

    pseudo, x, y = (_t(a) for a in _weak_inputs(mesh.size))
    st = spgp_init(pseudo, 0.3, kernel="matern32")
    n = x.shape[0]
    sp.fitc_update_cuda = spy
    try:
        out = sharded_spgp_update(
            mesh, st, x, y, torch.full((n,), 1e-3), torch.ones(n, dtype=bool),
            0.3, kernel="matern32")
    finally:
        sp.fitc_update_cuda = fitc
    return {"qm": out.qm, "fitc_shapes": shapes}


def _case_dead(mesh, extra):
    """Rank 1 dies before the collective rank 0 enters."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 dies before the collective")
    all_reduce(mesh, torch.ones(3))


# -- the graphed mesh (models/pose_graph.py, models/sensor_graph.py) --------

GRAPH_C = 4  # poses a chunk of the graphed chunk and map cases
STATE_KEYS = ("qm", "alpha", "qm_c", "alpha_c")


def _step_map():
    setting = _step_setting()
    return setting, SpGpOccupancyMap(
        setting, _step_pseudo(), Aabb.from_min_max([-2.0] * 3, [2.0] * 3),
        seed=STEP_SEED, dtype=np.float64, free_slots_per_ray=STEP_SLOTS,
        device="cpu")


def _state_out(st):
    return {k: getattr(st, k) for k in STATE_KEYS}


def _case_graph_body(mesh, extra):
    """The graphed chunk's body (``pose_chunk_body`` with ``mesh=``) on the
    step map: the 5 poses one by one with JAX's draws, beside the eager
    ``sharded_update_step`` with the same draws; GRAPH_C poses from the
    generators the map seeds, beside the eager ``sharded_update_many``;
    and GRAPH_C poses with JAX's draws (for JAX's sharded_update_many)."""
    setting, m = _step_map()
    kw = _step_kw(setting)
    sensors, pts, masks = (_t(a) for a in _step_scans())
    u = _t(extra["step_u"])
    args = (m._aabb_min, m._aabb_max, 0.6)

    def fresh():
        return SpGpState(*(t.clone() for t in m.sp_gp.state))

    body, eager, used, used_eager = fresh(), m.sp_gp.state, [], []
    for i in range(STEP_POSES):
        sl = slice(i, i + 1)
        used.append(pose_chunk_body(body, sensors[sl], pts[sl], masks[sl],
                                    *args, u=u[sl], mesh=mesh, **kw)[0])
        eager, n = sharded_update_step(mesh, eager, STEP_SEED, i + 1,
                                       sensors[i], pts[i], masks[i], *args,
                                       u=u[i], **kw)
        used_eager.append(n)
    c = GRAPH_C
    gens = [torch.Generator() for _ in range(c)]
    for i, g in enumerate(gens):
        g.manual_seed(step_seed(STEP_SEED, 1 + i))
    chunk = fresh()
    used_c = pose_chunk_body(chunk, sensors[:c], pts[:c], masks[:c], *args,
                             generators=gens, mesh=mesh, **kw)[0]
    many, used_many = sharded_update_many(
        mesh, m.sp_gp.state, STEP_SEED, 1, sensors[:c], pts[:c], masks[:c],
        *args, generator=torch.Generator(), **kw)
    chunk_u = fresh()
    used_u = pose_chunk_body(chunk_u, sensors[:c], pts[:c], masks[:c], *args,
                             u=u[:c], mesh=mesh, **kw)[0]
    return {"c1": _state_out(body), "c1_used": torch.cat(used),
            "c1_eager": _state_out(eager),
            "c1_eager_used": torch.stack(used_eager),
            "c": _state_out(chunk), "c_used": used_c,
            "c_eager": _state_out(many), "c_eager_used": used_many,
            "c_jax_draws": _state_out(chunk_u), "c_jax_draws_used": used_u}


def _graph_map_run(m):
    """3 poses through ``update``, 5 through ``update_batch`` at GRAPH_C
    (padded to 8), the predicts of 27 points (padded on the mesh) without
    and of 9 with the gradient."""
    sensors, pts, masks = _many_inputs(8, np.float64)
    used = [m.update(sensors[i], pts[i], masks[i]) for i in range(3)]
    used = torch.cat([torch.stack(used),
                      m.update_batch(sensors[3:], pts[3:], masks[3:],
                                     poses_per_step=GRAPH_C)])
    q = _scan_batches(1)[0][1][::5]
    return {**_state_out(m.state), "used": used, "lo": m.predict(q)[0],
            "grad": m.predict(q[:9], True)[1]}


def _case_graph_map(mesh, extra):
    """The map on the mesh, routed through the graphs a capturable mesh
    builds (``PoseGraphs`` with the mesh), beside the same calls on the
    eager mesh map (the CPU mesh's own: no graphs)."""
    eager = _make_map(mesh, np.float64)
    graphed = _make_map(mesh, np.float64)
    graphed._graphs = PoseGraphs("cpu", mesh)
    return {"graphed": _graph_map_run(graphed),
            "eager": _graph_map_run(eager),
            "keys": [g.key for g in graphed._graphs.captures],
            "replays": [g.replays for g in graphed._graphs.captures],
            "cpu_mesh_graphs": [eager._graphs is not None,
                                _lidar2d(mesh)._graphs is not None,
                                _gp3d(mesh)._graphs is not None]}


def _case_graph_predict(mesh, extra):
    """The graphed sharded predict (``PoseGraphs.predict`` on the mesh) of
    the predict case's 40 queries, beside the eager sharded predict."""
    pseudo, x, y, xq = (_t(a) for a in _predict_inputs())
    st = spgp_init(pseudo, 0.4, kernel="matern32")
    n = x.shape[0]
    st = spgp_update(st, x, y, torch.full((n,), 1e-3, dtype=x.dtype),
                     torch.ones(n, dtype=torch.bool), 0.4, kernel="matern32")
    L_qm, a = spgp_prepare(st)
    g = PoseGraphs("cpu", mesh)
    g.bind(st, torch.zeros(2, dtype=x.dtype), torch.zeros(2, dtype=x.dtype))
    mean, grad = g.predict((L_qm, a), xq.numpy(), 0.4, kernel="matern32",
                           with_grad=False)
    again, _ = g.predict((L_qm, a), xq.numpy(), 0.4, kernel="matern32",
                         with_grad=False)
    eager, _ = sharded_spgp_predict(mesh, st, L_qm, a, xq, 0.4,
                                    kernel="matern32", with_var=False)
    return {"mean": mean, "again": again, "eager": eager,
            "grad_none": grad is None}


def _sensor_runs(make, mesh, train, test):
    """Two trains (the capture, then a replay) and their tests on a model
    given the graphs a capturable mesh builds, and on the eager mesh
    model: the banks (cloned: a graph's outputs are static) and tests."""
    out = {}
    for name in ("graphed", "eager"):
        gp = make(mesh)
        if name == "graphed":
            gp._graphs = SensorGraphs("cpu")
        runs = []
        for s in range(2):
            assert train(gp, s)
            runs.append({"bank": {k: getattr(gp.bank, k).clone()
                                  for k in ("L", "L_inv", "alpha",
                                            "trained")},
                         "test": test(gp)})
        out[name] = runs
        if name == "graphed":
            out["fits"] = [g.replays for g in gp._graphs.captures
                           if g.key[0] == "fit"]
    return out


def _train3(gp, s):
    return gp.train(np.eye(3), np.zeros(3), _gp3d_scan(gp) * (1 + 0.01 * s))


def _test3(gp):
    q = gp.sensor_frame.ray_directions_in_frame().reshape(-1, 3)[::7]
    res = gp.test(q, True, True)
    return [*res.get_mean(), res.get_variance()[0]]


def _train2(gp, s):
    ang = gp.sensor_frame.angles_in_frame
    return gp.train(np.eye(2), np.zeros(2),
                    2.0 + 0.3 * np.sin(4 * ang + 0.1 * s))


def _test2(gp):
    return list(gp.test(np.linspace(-2.0, 2.0, 57), True, True).get_mean())


# the sensor GPs of the graphed case: (model, train(gp, s), test(gp))
GRAPH_SENSORS = {"gp3d": (_gp3d, _train3, _test3),
                 "gp2d": (_lidar2d, _train2, _test2)}


def _case_graph_sensors(mesh, extra):
    """The 3D range-sensor GP and the 2D lidar GP on the mesh, graphed
    (the sharded bank fit in the train's body) and eager."""
    return {name: _sensor_runs(make, mesh, train, test)
            for name, (make, train, test) in GRAPH_SENSORS.items()}


def _case_graph_keys(mesh, extra):
    """Every capture this rank made, in order (the stand-in's record)."""
    return [g.key for g in extra["captures"]]


GRAPH_CASES = {"graph_body": _case_graph_body, "graph_map": _case_graph_map,
               "graph_predict": _case_graph_predict,
               "graph_sensors": _case_graph_sensors,
               "graph_keys": _case_graph_keys}

CASES = {
    "dead": {"dead": _case_dead},
    WORLD: {"mesh": _case_mesh, "bank": _case_bank(0, 16, 12),
            "bank_pad": _case_bank(2, 13, 10), "update": _case_update,
            "predict": _case_predict, "sparse": _case_sparse,
            "map_f64": _case_map(np.float64), "map_f32": _case_map(np.float32),
            "many_f64": _case_many(16, np.float64),
            "many_f32": _case_many(8, np.float32), "lidar2d": _case_lidar2d,
            "gp3d": _case_gp3d, "step": _case_step, "weak": _case_weak},
    2: {"weak": _case_weak, **GRAPH_CASES},
    4: {"weak": _case_weak, **GRAPH_CASES},
}


def _rank_cases(rank, size, extra, cases):
    torch.set_num_threads(1)
    extra = dict(extra, captures=torch_graph_standin.install())
    mesh = make_mesh(size, device="cpu")
    return {name: _np_out(case(mesh, extra))
            for name, case in CASES[cases].items()}


def run_world(size, out_dir, extra, cases=None, timeout_s=RANK_TIMEOUT_S):
    """Spawn ``size`` gloo ranks that run ``CASES[cases]`` (``CASES[size]``
    by default) with collectives bounded by ``timeout_s``; returns each
    rank's results. Every join is bounded; a rank that fails or hangs
    fails the call with its traceback (``parallel/spawn.py``)."""
    return spawn_world(_rank_cases, size, out_dir, backend="gloo",
                       timeout_s=timeout_s, join_s=JOIN_TIMEOUT_S,
                       args=(extra, size if cases is None else cases))[0]


def _jax_step_draws():
    """The draws JAX's sampler makes for the step case's poses (the map's
    key folded with each step)."""
    import jax

    key = jax.random.PRNGKey(STEP_SEED)
    m = STEP_SETTING["free_sampling_margin"]
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, i + 1), (STEP_RAYS, STEP_SLOTS), minval=m,
        maxval=1.0 - m, dtype=np.float64)) for i in range(STEP_POSES)])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{size: rank 0's results} for every world size; every rank's results
    equal rank 0's bit for bit (replicated outputs)."""
    extra = {"step_u": _jax_step_draws()}
    out = {}
    for size in (WORLD, *[s for s in WEAK_SIZES if s != WORLD]):
        ranks = run_world(size, str(tmp_path_factory.mktemp(f"w{size}")),
                          extra)
        for r, res in enumerate(ranks[1:], 1):
            _assert_same(res, ranks[0], f"size {size} rank {r}")
        out[size] = ranks
    return out


def _assert_same(got, ref, where):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), where
        for k in ref:
            if k not in ("rank",):
                _assert_same(got[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert got == ref, where


def _res(worlds, name, size=WORLD):
    return worlds[size][0][name]


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


# -- the tests -------------------------------------------------------------


def test_make_mesh_describes_the_group(worlds):
    for r, res in enumerate(worlds[WORLD]):
        m = res["mesh"]
        assert (m["rank"], m["size"], m["device"], m["host_staging"],
                m["axis"]) == (r, WORLD, "cpu", False, "b")
        assert m["wrong_size_raises"]
    with pytest.raises(TypeError, match="make_mesh"):
        SpGpOccupancyMap(_map_setting(), np.zeros((2, 4)),
                         Aabb.from_min_max([-3, -3], [3, 3]), mesh=object(),
                         device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")
    one = Mesh(0, 1, torch.device("cpu"))
    assert one.axis_name == "b"
    m = _make_map(one, np.float64)
    sensors, pts, masks = _many_inputs(2, np.float64)
    with pytest.raises(ValueError, match="collect_datasets"):
        m.update_batch(sensors, pts, masks, collect_datasets=True)
    (a, b), n = _pad_axis([torch.ones(5, 2), torch.ones(5, dtype=bool)], 0,
                          4)
    assert n == 5 and a.shape == (8, 2) and b.shape == (8,)
    assert not a[5:].any() and not b[5:].any() and b[:5].all()


@pytest.mark.parametrize("case,B", [("bank", 16), ("bank_pad", 13)])
def test_sharded_bank_fit_matches_jax_sharded(worlds, case, B):
    """tests/test_parallel.py::test_sharded_bank_fit_matches_local and
    ::test_sharded_bank_fit_pads_non_divisible_bank: the bank fit sharded 8
    ways (padded with empty members when B is not a multiple) against the
    port's one-process bank fit at 1e-12, and against JAX's
    sharded_bank_fit on its 8-device mesh at 1e-12 of each result's
    maximum (alpha reaches ~4e2 at var 1e-3; two implementations' float64
    roundings differ there by ~1e-10 absolute)."""
    import jax.numpy as jnp

    from erl_gaussian_process_tpu.parallel import (
        make_mesh as jax_make_mesh,
        sharded_bank_fit as jax_sharded_bank_fit,
    )

    inputs = _bank_inputs(0, 16, 12) if case == "bank" \
        else _bank_inputs(2, 13, 10)
    got = _res(worlds, case)
    ref = jax_sharded_bank_fit(jax_make_mesh(8),
                               *(jnp.asarray(a) for a in inputs), 0.3,
                               kernel="rbf")
    assert got["L"].shape[0] == B
    for k in ("L", "alpha"):
        r = np.asarray(getattr(ref, k))
        _close(got[k], r, 0, 1e-12 * np.abs(r).max())
    np.testing.assert_array_equal(got["trained"], np.asarray(ref.trained))
    local = bank_fit(*(_t(a) for a in inputs), 0.3, kernel="rbf")
    for k in ("L", "L_inv", "alpha"):
        _close(got[k], getattr(local, k), 0, 1e-12)


def test_sharded_spgp_update_matches_jax_sharded(worlds):
    import jax.numpy as jnp

    from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
        spgp_init as jax_spgp_init,
    )
    from erl_gaussian_process_tpu.parallel import (
        make_mesh as jax_make_mesh,
        sharded_spgp_update as jax_sharded_spgp_update,
    )

    pseudo, x, y, var, mask = (jnp.asarray(a) for a in _update_inputs())
    ref = jax_sharded_spgp_update(
        jax_make_mesh(8), jax_spgp_init(pseudo, 0.4, kernel="matern32"), x,
        y, var, mask, 0.4, kernel="matern32")
    got = _res(worlds, "update")
    _close(got["qm"], ref.qm, 1e-10, 1e-10)
    _close(got["alpha"], ref.alpha, 1e-10, 1e-10)


def test_sharded_spgp_predict_matches_jax_sharded(worlds):
    """Query-sharded predict (40 queries over 8 ranks) against JAX's
    sharded predict on the same inputs, and against the port's one-process
    predict."""
    import jax.numpy as jnp

    from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
        spgp_init as jax_spgp_init,
        spgp_prepare as jax_spgp_prepare,
        spgp_update as jax_spgp_update,
    )
    from erl_gaussian_process_tpu.parallel import (
        make_mesh as jax_make_mesh,
        sharded_spgp_predict as jax_sharded_spgp_predict,
    )

    pseudo, x, y, xq = (jnp.asarray(a) for a in _predict_inputs())
    n = x.shape[0]
    st = jax_spgp_update(jax_spgp_init(pseudo, 0.4, kernel="matern32"), x, y,
                         jnp.full((n,), 1e-3), jnp.ones(n, bool), 0.4,
                         kernel="matern32")
    L_qm, a = jax_spgp_prepare(st)
    mean_j, var_j = jax_sharded_spgp_predict(jax_make_mesh(8), st, L_qm, a,
                                             xq, 0.4, kernel="matern32")
    got = _res(worlds, "predict")
    assert got["mean"].shape == (40, 1) and got["var"].shape == (40,)
    _close(got["mean"], mean_j, 1e-10, 1e-12)
    _close(got["var"], var_j, 1e-10, 1e-12)
    _close(got["mean"], got["mean_local"], 1e-12, 1e-14)
    _close(got["var"], got["var_local"], 1e-12, 1e-14)


def _one_process_map(dtype, n_scans=None, poses_per_step=None):
    """The one-process map, built and updated on one thread as the ranks
    are: the float32 factorization of K_M in ``spgp_init`` differs in its
    last bits between thread counts, and the FITC weight 1/(lambda + var)
    at var 1e-4 amplifies that to ~1e-3 of Q_M (the ranks' state would then
    differ from this one before any sharding)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = _make_map(None, dtype)
        if poses_per_step is None:
            used = torch.stack([m.update(o.astype(dtype), p.astype(dtype))
                                for o, p in _scan_batches()])
        else:
            used = m.update_batch(*_many_inputs(n_scans, dtype),
                                  poses_per_step=poses_per_step)
    finally:
        torch.set_num_threads(threads)
    return m, used.numpy()


def test_spgp_map_class_mesh_matches_one_process_f64(worlds):
    """SpGpOccupancyMap(mesh=) on 8 ranks against the one-process map: the
    sampler runs replicated from the same seeds, so the datasets (and the
    samples used) are the same; the state agrees to 1e-9 at float64, and
    the query-sharded predict with it."""
    got = _res(worlds, "map_f64")
    ref, used = _one_process_map(np.float64)
    np.testing.assert_array_equal(got["used"], used)
    assert got["step"] == ref.step == 4
    _close(got["qm"], ref.sp_gp.state.qm, 1e-9, 1e-9)
    _close(got["alpha"], ref.sp_gp.state.alpha, 1e-9, 1e-9)
    q = _scan_batches(1)[0][1][::5]
    _close(got["lo"], ref.predict(q)[0], 1e-9, 1e-9)


def _drift(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_spgp_map_class_mesh_f32_drift_production_shape(worlds):
    """The all_reduce reassociates the float32 sums: at the production
    shape (441 pseudo points, 135-ray scans) the sharded state stays
    within 5e-6 relative Frobenius of the one-process map, and the
    posterior agrees (1e-4 of the maximum, sign agreement > 0.999)."""
    got = _res(worlds, "map_f32")
    ref, _ = _one_process_map(np.float32)
    assert _drift(got["qm"], ref.sp_gp.state.qm) < 5e-6
    assert _drift(got["alpha"], ref.sp_gp.state.alpha) < 5e-6
    q = _scan_batches(1)[0][1][::3].astype(np.float32)
    lo_ref = ref.predict(q)[0].numpy()
    assert np.abs(got["lo"] - lo_ref).max() / np.abs(lo_ref).max() < 1e-4
    assert np.mean(np.sign(got["lo"]) == np.sign(lo_ref)) > 0.999


def test_lidar_gp_2d_class_mesh_matches_one_process(worlds):
    """LidarGaussianProcess2D(mesh=): the partition bank (B not a multiple
    of 8: the padded path) sharded over 8 ranks against the one-process
    class, 1e-12 at float64."""
    got = _res(worlds, "lidar2d")
    ref = _lidar2d(None)
    ang = ref.sensor_frame.angles_in_frame
    assert ref.train(np.eye(2), np.zeros(2), 2.0 + 0.3 * np.sin(4 * ang))
    assert ref.bank.L.shape[0] % WORLD
    _close(got["L"], ref.bank.L, 1e-12, 1e-12)
    _close(got["L_inv"], ref.bank.L_inv, 1e-12, 1e-12)
    _close(got["alpha"], ref.bank.alpha, 1e-12, 1e-12)
    mean, valid = ref.test(np.linspace(-2.0, 2.0, 57), True, True).get_mean()
    np.testing.assert_array_equal(got["valid"], valid)
    _close(got["mean"][valid], mean[valid], 1e-12, 1e-12)


def test_range_sensor_gp_3d_class_mesh_matches_one_process(worlds):
    """RangeSensorGaussianProcess3D(mesh=) (no JAX test has it): the
    partition bank sharded over 8 ranks against the one-process train and
    test, 1e-12 at float64; train_scan_batch refuses a mesh."""
    got = _res(worlds, "gp3d")
    ref = _gp3d(None)
    assert ref.train(np.eye(3), np.zeros(3), _gp3d_scan(ref))
    for k in ("L", "L_inv", "alpha"):
        _close(got[k], getattr(ref.bank, k), 1e-12, 1e-12)
    np.testing.assert_array_equal(got["trained"], ref.bank.trained.numpy())
    q = ref.sensor_frame.ray_directions_in_frame().reshape(-1, 3)[::7]
    res = ref.test(q, True, True)
    mean, valid = res.get_mean()
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.mean() > 0.5
    _close(got["mean"][valid], mean[valid], 1e-12, 1e-12)
    _close(got["var"][valid], res.get_variance()[0][valid], 1e-12, 1e-12)
    assert got["scan_batch_raises"]


def test_spgp_update_weak_scaling_shape(worlds):
    """At a fixed number of samples a rank, each rank's FITC call has the
    same shape at D = 2, 4, 8 (the per-rank work does not grow with the
    mesh; JAX's test compares the per-device program's flops), and every
    mesh size agrees with the one-process float32 update (5e-6)."""
    for D in WEAK_SIZES:
        for r, res in enumerate(worlds[D]):
            assert res["weak"]["fitc_shapes"] == [[[64, 2], [N_PER, 2]]], \
                (D, r)
        pseudo, x, y = (_t(a) for a in _weak_inputs(D))
        n = x.shape[0]
        ref = spgp_update(spgp_init(pseudo, 0.3, kernel="matern32"), x, y,
                          torch.full((n,), 1e-3),
                          torch.ones(n, dtype=bool), 0.3, kernel="matern32")
        assert _drift(_res(worlds, "weak", D)["qm"], ref.qm) < 5e-6, D


def test_sharded_spgp_sparse_semantics_match_jax_sharded(worlds):
    """diagonal_qm with zero_threshold > 0 (the reference's UpdateSparse /
    ComputeKtestSparse): the sharded update and predict against JAX's
    sharded functions, and the threshold is live (the dense result
    differs)."""
    import jax.numpy as jnp

    from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
        spgp_init as jax_spgp_init,
        spgp_prepare as jax_spgp_prepare,
    )
    from erl_gaussian_process_tpu.parallel import (
        make_mesh as jax_make_mesh,
        sharded_spgp_predict as jax_sharded_spgp_predict,
        sharded_spgp_update as jax_sharded_spgp_update,
    )

    pseudo, x, y, xq = (jnp.asarray(a) for a in _sparse_inputs())
    n = x.shape[0]
    mesh = jax_make_mesh(8)
    st = jax_sharded_spgp_update(
        mesh, jax_spgp_init(pseudo, 0.25, kernel="matern32",
                            diagonal_qm=True),
        x, y, jnp.full((n,), 1e-3), jnp.ones(n, bool), 0.25,
        kernel="matern32", diagonal_qm=True, zero_threshold=SPARSE_ZT)
    got = _res(worlds, "sparse")
    _close(got["qm"], st.qm, 1e-10, 1e-10)
    _close(got["alpha"], st.alpha, 1e-10, 1e-10)
    L_qm, a = jax_spgp_prepare(st, diagonal_qm=True)
    mean_j, var_j = jax_sharded_spgp_predict(mesh, st, L_qm, a, xq, 0.25,
                                             kernel="matern32",
                                             zero_threshold=SPARSE_ZT)
    _close(got["mean"], mean_j, 1e-10, 1e-12)
    _close(got["var"], var_j, 1e-10, 1e-12)
    tp, tx, ty, txq = (_t(a) for a in _sparse_inputs())
    dense = spgp_update(
        spgp_init(tp, 0.25, kernel="matern32", diagonal_qm=True), tx, ty,
        torch.full((n,), 1e-3, dtype=tx.dtype), torch.ones(n, dtype=bool),
        0.25, kernel="matern32", diagonal_qm=True)
    assert np.abs(got["alpha"] - dense.alpha.numpy()).max() > 1e-6
    mean_d, _, _ = spgp_predict(dense, *spgp_prepare(dense, diagonal_qm=True),
                                txq, 0.25, kernel="matern32")
    assert np.abs(got["mean"] - mean_d.numpy()).max() > 1e-6


def test_sharded_update_many_matches_one_process_chunked(worlds):
    """update_batch(poses_per_step=8) on 8 ranks (sharded_update_many)
    against the one-process chunked replay: the same samples used, the
    state to 1e-9 at float64, the predict to 1e-8."""
    got = _res(worlds, "many_f64")
    ref, used = _one_process_map(np.float64, 16, 8)
    np.testing.assert_array_equal(got["used"], used)
    assert got["step"] == ref.step == 16
    _close(got["qm"], ref.sp_gp.state.qm, 1e-9, 1e-9)
    _close(got["alpha"], ref.sp_gp.state.alpha, 1e-9, 1e-9)
    q = _scan_batches(1)[0][1][::5]
    _close(got["lo"], ref.predict(q)[0], 1e-8, 1e-9)


def test_sharded_update_many_f32_drift_production_shape(worlds):
    got = _res(worlds, "many_f32")
    ref, _ = _one_process_map(np.float32, 8, 8)
    assert _drift(got["qm"], ref.sp_gp.state.qm) < 5e-6


def test_sharded_update_step_matches_jax_sharded_step(worlds):
    """The whole sharded map step (sampler, labels, cap, compaction,
    sharded FITC, Kahan) for 5 poses with JAX's draws injected, against
    JAX's sharded_update_step on its 8-device mesh at float64: the samples
    used equal, Q_M and alpha to 1e-10 of their maximum."""
    import jax.numpy as jnp

    from erl_gaussian_process_tpu.parallel import make_mesh as jax_make_mesh
    from erl_gaussian_process_tpu.parallel.mesh import (
        sharded_update_step as jax_sharded_update_step,
    )

    js, jm = _jax_step_map()
    mesh = jax_make_mesh(8)
    st, used = jm.sp_gp.state, []
    for i, (o, p, mk) in enumerate(zip(*_step_scans())):
        st, n_used = jax_sharded_update_step(
            mesh, st, jm.key, i + 1, jnp.asarray(o), jnp.asarray(p),
            jnp.asarray(mk), jm._aabb_min, jm._aabb_max, np.float64(0.6),
            **_step_kw(js))
        used.append(int(n_used))
    got = _res(worlds, "step")
    np.testing.assert_array_equal(got["used"], used)
    _close_to_jax_state(got, st)


def _jax_step_map():
    """The step case's map in the JAX package: (setting, map)."""
    import erl_gaussian_process_tpu.models.spgp_occupancy_map as jmap
    from erl_gaussian_process_tpu.geometry import Aabb as JaxAabb
    from erl_gaussian_process_tpu.kernels import (
        KernelSetting as JaxKernelSetting,
    )
    from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
        SpGpSetting as JaxSpGpSetting,
    )

    js = jmap.SpGpOccupancyMapSetting(
        sp_gp=JaxSpGpSetting(kernel_type="matern32",
                             kernel=JaxKernelSetting(x_dim=3, scale=0.6),
                             max_num_samples=256), **STEP_SETTING)
    return js, jmap.SpGpOccupancyMap(
        js, _step_pseudo(), JaxAabb.from_min_max([-2.0] * 3, [2.0] * 3),
        seed=STEP_SEED, dtype=np.float64, free_slots_per_ray=STEP_SLOTS)


def _close_to_jax_state(got, st):
    """Q_M and alpha to 1e-10 of their maximum (the step case's gate)."""
    for name in ("qm", "alpha"):
        ref = np.asarray(getattr(st, name))
        _close(got[name], ref, 0, 1e-10 * np.abs(ref).max())


def test_a_dead_rank_fails_the_world(tmp_path):
    """A rank that raises before a collective: the rank waiting in it
    fails too (its peer's connection closes, or the process group's
    timeout ends the wait), and the world reports both, well inside the
    join limit."""
    t0 = datetime.datetime.now()
    with pytest.raises(RuntimeError, match="rank 1 dies") as err:
        run_world(2, str(tmp_path), {}, cases="dead", timeout_s=10)
    assert "rank 0:" in str(err.value) and "rank 1:" in str(err.value)
    assert (datetime.datetime.now() - t0).total_seconds() < 60


# -- the graphed mesh: the bodies and routing a capturable mesh replays -----

GRAPH_SIZES = (2, 4)


@pytest.mark.parametrize("D", GRAPH_SIZES)
def test_graphed_mesh_chunk_body_matches_eager_and_jax(worlds, D):
    """The graphed chunk's body on D gloo ranks: at c = 1 (5 poses, JAX's
    draws) bit for bit the eager sharded_update_step and within the step
    case's gate (1e-10 of the maximum) of JAX's sharded_update_step; at
    c = GRAPH_C from the map's generators bit for bit the eager
    sharded_update_many, and with JAX's draws within that gate of JAX's
    sharded_update_many; the samples used equal."""
    import jax.numpy as jnp

    from erl_gaussian_process_tpu.parallel import make_mesh as jax_make_mesh
    from erl_gaussian_process_tpu.parallel.mesh import (
        sharded_update_many as jax_sharded_update_many,
        sharded_update_step as jax_sharded_update_step,
    )

    got = _res(worlds, "graph_body", D)
    _assert_same(got["c1"], got["c1_eager"], f"D={D} c=1")
    _assert_same(got["c1_used"], got["c1_eager_used"], f"D={D} c=1 used")
    _assert_same(got["c"], got["c_eager"], f"D={D} c={GRAPH_C}")
    _assert_same(got["c_used"], got["c_eager_used"], f"D={D} used")
    mesh = jax_make_mesh(D)
    sensors, pts, masks = (jnp.asarray(a) for a in _step_scans())
    js, jm = _jax_step_map()
    st, used = jm.sp_gp.state, []
    for i in range(STEP_POSES):
        st, n_used = jax_sharded_update_step(
            mesh, st, jm.key, i + 1, sensors[i], pts[i], masks[i],
            jm._aabb_min, jm._aabb_max, np.float64(0.6), **_step_kw(js))
        used.append(int(n_used))
    np.testing.assert_array_equal(got["c1_used"], used)
    _close_to_jax_state(got["c1"], st)
    js, jm = _jax_step_map()
    st, used = jax_sharded_update_many(
        mesh, jm.sp_gp.state, jm.key, 1, sensors[:GRAPH_C], pts[:GRAPH_C],
        masks[:GRAPH_C], jm._aabb_min, jm._aabb_max, np.float64(0.6),
        **_step_kw(js))
    np.testing.assert_array_equal(got["c_jax_draws_used"], np.asarray(used))
    _close_to_jax_state(got["c_jax_draws"], st)


@pytest.mark.parametrize("D", GRAPH_SIZES)
def test_graphed_mesh_map_matches_eager_mesh_map(worlds, D):
    """The map on D gloo ranks routed through the graphs of a capturable
    mesh (3 poses through update, 5 through update_batch at GRAPH_C, the
    sharded predict, the gradient predict on the one-card graph), bit for
    bit the eager mesh map: Q_M, alpha, their compensations, the samples
    used, the log-odds and gradients. A graph a shape: an update at c = 1
    and at GRAPH_C, a predict with and without the gradient."""
    got = _res(worlds, "graph_map", D)
    _assert_same(got["graphed"], got["eager"], f"D={D}")
    assert [k[:3] for k in got["keys"]] == [
        ["update", 135, 1], ["update", 135, GRAPH_C], ["predict", 27, False],
        ["predict", 9, True]], got["keys"]
    assert got["replays"] == [3, 2, 1, 1]
    assert got["cpu_mesh_graphs"] == [False, False, False]


@pytest.mark.parametrize("D", GRAPH_SIZES)
def test_graphed_sharded_predict_matches_eager_and_jax(worlds, D):
    """The graphed sharded predict of 40 queries on D gloo ranks (capture,
    then a replay) bit for bit the eager sharded predict, and within the
    eager mesh's tolerance (1e-10, 1e-12) of JAX's sharded_spgp_predict."""
    import jax.numpy as jnp

    from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
        spgp_init as jax_spgp_init,
        spgp_prepare as jax_spgp_prepare,
        spgp_update as jax_spgp_update,
    )
    from erl_gaussian_process_tpu.parallel import (
        make_mesh as jax_make_mesh,
        sharded_spgp_predict as jax_sharded_spgp_predict,
    )

    got = _res(worlds, "graph_predict", D)
    _assert_same(got["mean"], got["eager"], f"D={D}")
    _assert_same(got["again"], got["eager"], f"D={D} replay")
    assert got["grad_none"] and got["mean"].shape == (40, 1)
    pseudo, x, y, xq = (jnp.asarray(a) for a in _predict_inputs())
    n = x.shape[0]
    st = jax_spgp_update(jax_spgp_init(pseudo, 0.4, kernel="matern32"), x, y,
                         jnp.full((n,), 1e-3), jnp.ones(n, bool), 0.4,
                         kernel="matern32")
    L_qm, a = jax_spgp_prepare(st)
    mean_j, _ = jax_sharded_spgp_predict(jax_make_mesh(D), st, L_qm, a, xq,
                                         0.4, kernel="matern32",
                                         with_var=False)
    _close(got["mean"], mean_j, 1e-10, 1e-12)


@pytest.mark.parametrize("D", GRAPH_SIZES)
@pytest.mark.parametrize("name", sorted(GRAPH_SENSORS))
def test_graphed_mesh_sensor_train_matches_eager_and_jax(worlds, name, D):
    """The 3D range-sensor GP and the 2D lidar GP on D gloo ranks, each
    train one replay of the sharded bank fit (the capture, then a replay
    on another scan): banks and tests bit for bit the eager mesh model's
    (but the 2D test's mean: its graph groups the 57 queries on the
    device into rows of 32 slots, the host into a bucket of 8, so its
    products may round otherwise; valid flags exact, the mean within
    1e-12 of its maximum, the float64 tolerance of
    tests/test_torch_routed_chunks.py), and the replay's bank within the
    bank case's gate (1e-12 of each result's maximum) of JAX's
    sharded_bank_fit on the same inputs."""
    import jax.numpy as jnp

    from erl_gaussian_process_tpu.parallel import (
        make_mesh as jax_make_mesh,
        sharded_bank_fit as jax_sharded_bank_fit,
    )

    got = _res(worlds, "graph_sensors", D)[name]
    for s, (g, e) in enumerate(zip(got["graphed"], got["eager"])):
        where = f"D={D} {name} train {s}"
        _assert_same(g["bank"], e["bank"], where)
        if name == "gp3d":
            _assert_same(g["test"], e["test"], where)
            continue
        (mean, valid), (e_mean, e_valid) = g["test"], e["test"]
        np.testing.assert_array_equal(valid, e_valid, err_msg=where)
        assert valid.any()
        fin = np.isfinite(e_mean)
        np.testing.assert_array_equal(np.isfinite(mean), fin, where)
        _close(mean[fin], e_mean[fin], 0, 1e-12 * np.abs(e_mean[fin]).max())
    assert len(got["graphed"]) == len(got["eager"]) == 2
    assert got["fits"] == [2]
    make, train, _ = GRAPH_SENSORS[name]
    ref = make(None)
    assert train(ref, 1)
    inputs = ref._gather_scans(ref.sensor_frame.ranges[None])
    jst = jax_sharded_bank_fit(jax_make_mesh(D),
                               *(jnp.asarray(t.numpy()) for t in inputs),
                               ref._scale, kernel=ref._kernel)
    bank = got["graphed"][1]["bank"]
    for k in ("L", "alpha"):
        r = np.asarray(getattr(jst, k))
        _close(bank[k], r, 0, 1e-12 * np.abs(r).max())
    np.testing.assert_array_equal(bank["trained"], np.asarray(jst.trained))


def test_graphed_mesh_ranks_capture_in_lockstep(worlds):
    """Every rank of a world captured the same graphs in the same order
    (updates, predicts, trains and routed tests): the keys hold only what
    is the same on every rank."""
    for D in GRAPH_SIZES:
        keys = [res["graph_keys"] for res in worlds[D]]
        assert len(keys) == D
        for r, k in enumerate(keys[1:], 1):
            assert k == keys[0], (D, r)
        kinds = {k[0] if isinstance(k[0], str) else k[0][0] for k in keys[0]}
        assert kinds == {"update", "predict", "fit"}, kinds


def test_only_a_capturable_mesh_builds_graphs():
    """``runs_graphs``, the one predicate the models read: a CUDA mesh
    over NCCL can be captured; a CUDA mesh over gloo (its collectives
    staged through the host) and a CPU mesh cannot, and a CPU mesh's map
    and sensor GPs build no graphs."""
    cuda0, cpu_dev = torch.device("cuda", 0), torch.device("cpu")
    nccl = Mesh(0, 1, cuda0)
    staged = Mesh(0, 2, cuda0, host_staging=True)
    cpu = Mesh(0, 1, cpu_dev)
    assert runs_graphs(cuda0, None) and runs_graphs(cuda0, nccl)
    assert not runs_graphs(cuda0, staged)
    assert not runs_graphs(cpu_dev, None) and not runs_graphs(cpu_dev, cpu)
    assert _make_map(cpu, np.float64)._graphs is None
    assert _lidar2d(cpu)._graphs is None and _gp3d(cpu)._graphs is None
