"""The PyTorch port's 2D occupancy map at its production config
(config/spgp_occupancy_map_2d.yaml: matern32 d=2 at scale 0.18, 31x31
pseudo points, 2000 samples, var 1e-4, 135 rays, 20 free slots a ray)
against the JAX package: the 2D simulators bit for bit, both YAML configs
and the setting registry, the update slice at float64 with JAX's draws
injected (1e-10 of each result's magnitude), the 50-pose quality gate, and
a 20-pose float32 replay against JAX's float64 replay of the same
datasets."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.models.spgp_occupancy_map as jmap
import erl_gaussian_process_tpu.utils.native as jnative
from erl_gaussian_process_tpu.geometry import Aabb as JaxAabb
from erl_gaussian_process_tpu.geometry import simulators as jsim
from erl_gaussian_process_tpu.utils import config as jconfig
from erl_gaussian_process_tpu_torch.geometry import Aabb, GridMapInfo2D
from erl_gaussian_process_tpu_torch.geometry import simulators as tsim
from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    spgp_init,
    spgp_predict,
    spgp_prepare,
    spgp_update,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMapSetting,
    update_step,
)
from erl_gaussian_process_tpu_torch.utils import config as tconfig
from erl_gaussian_process_tpu_torch.utils.convert import spgp_state_from_numpy

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
CONFIGS = [os.path.join(REPO, "config", f) for f in
           ("spgp_occupancy_map_2d.yaml", "spgp_occupancy_map_2d_float.yaml")]
FREE_SLOTS = 20
RAYS = 135


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """One float32 exp over every thread before the parity tests: this CPU
    build of torch got its first multi-threaded float32 exp of a process
    wrong in one thread's chunk now and then (tests/test_torch_gram.py)."""
    torch.exp(torch.zeros(1 << 20, dtype=torch.float32))


@pytest.fixture(params=["numpy", "native"])
def jax_numpy_raycast(request, monkeypatch):
    """Both packages' simulators on the same ray caster: each one's numpy
    branch, or each one's native OpenMP raycaster (the port's own copy of
    the C++ source)."""
    import erl_gaussian_process_tpu_torch.utils.native as tnative

    if request.param == "numpy":
        monkeypatch.setattr(jnative, "native_available", lambda: False)
        monkeypatch.setattr(tnative, "native_available", lambda: False)
    else:
        assert jnative.native_available() and tnative.native_available()


def _production_setting():
    return SpGpOccupancyMapSetting.from_yaml_file(CONFIGS[0])


def _hinged_grid(k=31):
    c = np.linspace(-3.0, 3.0, k)
    pv, qv = np.meshgrid(c, c, indexing="ij")
    return np.stack([pv.ravel(), qv.ravel()], axis=0)


def _lidar(mod):
    return mod.Lidar2D(mod.Lidar2D.Setting(
        min_angle=-135 / 180 * np.pi, max_angle=135 / 180 * np.pi,
        num_lines=RAYS), mod.reference_space_2d())


def _scans(n_poses):
    """(sensors (P, 2), end points (P, R, 2), hit masks (P, R)) of the
    reference ellipse."""
    lidar = _lidar(tsim)
    out = [tsim.lidar_scan_points_2d(lidar, p)
           for p in tsim.reference_trajectory_2d(n_poses)]
    traj = tsim.reference_trajectory_2d(n_poses)
    return (traj[:, :2], np.stack([o[1] for o in out]),
            np.stack([o[2] for o in out]))


def test_simulators_2d_match_jax_bit_for_bit(jax_numpy_raycast):
    js, ts = jsim.reference_space_2d(), tsim.reference_space_2d()
    np.testing.assert_array_equal(ts.seg_a, js.seg_a)
    np.testing.assert_array_equal(ts.seg_b, js.seg_b)
    np.testing.assert_array_equal(ts.surface_vertices, js.surface_vertices)
    np.testing.assert_array_equal(ts.surface_points(0.05),
                                  js.surface_points(0.05))
    for n in (50, 200):
        np.testing.assert_array_equal(tsim.reference_trajectory_2d(n, 2),
                                      jsim.reference_trajectory_2d(n, 2))
    jl, tl = _lidar(jsim), _lidar(tsim)
    np.testing.assert_array_equal(tl.ray_directions_in_frame(),
                                  jl.ray_directions_in_frame())
    for pose in tsim.reference_trajectory_2d(12):
        r = tl.scan(pose[2], pose[:2])
        np.testing.assert_array_equal(r, jl.scan(pose[2], pose[:2]))
        assert np.isfinite(r).all()
        _, pts, hit = tsim.lidar_scan_points_2d(tl, pose)
        c, s = np.cos(pose[2]), np.sin(pose[2])
        dirs = jl.ray_directions_in_frame() @ np.array([[c, -s], [s, c]]).T
        np.testing.assert_array_equal(pts, pose[:2] + dirs * r[:, None])
    # a bounded range and a miss: inf past max_range
    short = tsim.Lidar2D(tsim.Lidar2D.Setting(num_lines=64, max_range=1.0),
                         ts)
    jshort = jsim.Lidar2D(jsim.Lidar2D.Setting(num_lines=64, max_range=1.0),
                          js)
    r = short.scan(0.3, [1.5, 0.0])
    np.testing.assert_array_equal(r, jshort.scan(0.3, [1.5, 0.0]))
    assert np.isinf(r).any() and np.isfinite(r).any()


@pytest.mark.parametrize("path", CONFIGS, ids=["double", "float"])
def test_yaml_configs_load_the_same_settings(path, tmp_path):
    """Both production files load into the same settings as the JAX
    package's (C++ type tags included), through the setting's own helper
    and the module function, and write back unchanged."""
    js = jmap.SpGpOccupancyMapSetting.from_yaml_file(path)
    ts = SpGpOccupancyMapSetting.from_yaml_file(path)
    assert ts.to_dict() == js.to_dict()
    assert tconfig.from_yaml_file(SpGpOccupancyMapSetting, path).to_dict() \
        == js.to_dict()
    assert ts.sp_gp.kernel.scale == pytest.approx(0.18)
    assert ts.sp_gp.max_num_samples == 2000
    from erl_gaussian_process_tpu_torch.kernels import resolve_kernel_name
    assert resolve_kernel_name(ts.sp_gp.kernel_type) == "matern32"
    out = str(tmp_path / "cfg.yaml")
    ts.as_yaml_file(out)
    assert SpGpOccupancyMapSetting.from_yaml_file(out).to_dict() \
        == js.to_dict()
    text = tconfig.as_yaml_str(ts)
    assert text == jconfig.as_yaml_str(js)
    assert tconfig.from_yaml_str(SpGpOccupancyMapSetting, text).to_dict() \
        == js.to_dict()


def test_registry_resolves_the_same_names_and_type_strings():
    import erl_gaussian_process_tpu  # noqa: F401  (runs the JAX init())

    assert tconfig.setting_names() == jconfig.setting_names()
    names = jconfig.setting_names() + [
        "erl::gaussian_process::VanillaGaussianProcess<double>::Setting",
        "erl::gaussian_process::SpGpOccupancyMap<float, 2>::Setting",
        "erl::gaussian_process::LidarGaussianProcess2D<double>::Setting",
        "erl::covariance::Covariance<float>::Setting",
        "RangeSensorGaussianProcess3D", "NoisyInputGaussianProcess",
        "LidarFrame2D", "sp_gp"]
    for name in names:
        t, j = tconfig.create_setting(name), jconfig.create_setting(name)
        assert type(t).__name__ == type(j).__name__, name
        assert t.to_dict() == j.to_dict(), name
    s = tconfig.create_setting("sp_gp", {"max_num_samples": 77})
    assert s.max_num_samples == 77
    with pytest.raises(KeyError, match="unknown setting type"):
        tconfig.create_setting("no_such_setting")


def _jax_u(key, step, n, dtype=np.float64):
    m = 0.01
    return np.asarray(jax.random.uniform(
        jax.random.fold_in(key, step), (n, FREE_SLOTS), minval=m,
        maxval=1.0 - m, dtype=dtype))


def test_update_slice_2d_matches_jax_f64():
    """Three poses of the reference ellipse through the whole update slice
    (sampler, the 2000-sample cap, compaction of 135 x 21 slots into 2048,
    FITC at M = 961, unpadded at float64, Kahan) with JAX's draws
    injected, then the prepared
    posterior: port vs JAX at float64 to 1e-10 of each result's
    magnitude."""
    ts = _production_setting()
    jm = jmap.SpGpOccupancyMap(
        jmap.SpGpOccupancyMapSetting.from_yaml_file(CONFIGS[0]),
        _hinged_grid(), JaxAabb.from_min_max([-3.0, -3.0], [3.0, 3.0]),
        seed=0, dtype=np.float64, free_slots_per_ray=FREE_SLOTS)
    tm = SpGpOccupancyMap(ts, _hinged_grid(),
                          Aabb.from_min_max([-3.0, -3.0], [3.0, 3.0]),
                          seed=0, dtype=np.float64,
                          free_slots_per_ray=FREE_SLOTS, device="cpu")
    s = tm.setting
    kw = dict(kernel=tm.sp_gp._kernel, diagonal_qm=False,
              free_slots=FREE_SLOTS,
              max_samples=int(s.sp_gp.max_num_samples),
              min_distance=s.min_distance, max_distance=s.max_distance,
              free_sampling_margin=s.free_sampling_margin,
              free_points_per_meter=s.free_points_per_meter,
              logodd_occupied=s.logodd_occupied, logodd_free=s.logodd_free,
              logodd_variance=s.logodd_variance)
    sensors, pts, masks = _scans(50)
    jst = jm.state
    tst = spgp_state_from_numpy({k: np.array(v) for k, v in
                                 jst._asdict().items()}, device="cpu")
    for i in (0, 17, 33):
        step = i + 1
        p = np.where(masks[i][:, None], pts[i], 0.0)
        jst, jn = jmap.update_step(
            jst, jm.key, step, jnp.asarray(sensors[i]), jnp.asarray(p),
            jnp.asarray(masks[i]), jm._aabb_min, jm._aabb_max,
            np.float64(0.18), **kw)
        tst, tn, (dx, _, _) = update_step(
            tst, torch.tensor(sensors[i]), torch.tensor(p),
            torch.tensor(masks[i]), tm._aabb_min, tm._aabb_max, 0.18,
            u=torch.tensor(_jax_u(jm.key, step, RAYS)), **kw)
        assert int(tn) == int(jn) > 0
        assert dx.shape == (2048, 2) and tst.qm.shape == (961, 961)
    for name in ("qm", "alpha"):
        ref = np.asarray(getattr(jst, name))
        np.testing.assert_allclose(getattr(tst, name).numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())
    jm.sp_gp.state, jm.sp_gp._cache = jst, None
    tm.sp_gp.state = tst
    tm.sp_gp.invalidate()
    q = np.random.default_rng(0).uniform(-2.5, 2.5, (128, 2))
    jlo, jg = jm.predict(q, compute_gradient=True)
    tlo, tg = tm.predict(q, compute_gradient=True)
    np.testing.assert_allclose(tlo.numpy(), jlo, rtol=0,
                               atol=1e-10 * np.abs(jlo).max())
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-10 * np.abs(jg).max())


def test_online_mapping_2d_quality_gate():
    """The JAX suite's 2D quality gate (tests/test_spgp_occupancy_map.py:
    67-100) on the port at float32: 50 poses through ``update``, then
    surface > 0.9 occupied, trajectory > 0.95 free, every gradient
    finite."""
    m = SpGpOccupancyMap(_production_setting(), _hinged_grid(),
                         Aabb.from_min_max([-3.0, -3.0], [3.0, 3.0]), seed=0,
                         dtype=np.float32, free_slots_per_ray=FREE_SLOTS,
                         device="cpu")
    sensors, pts, masks = _scans(50)
    for i in range(50):
        assert int(m.update(sensors[i], pts[i], point_mask=masks[i])) > 0
    surf = tsim.reference_space_2d().surface_points(0.05)
    lo_surf, grad = m.predict(surf, compute_gradient=True)
    lo_traj, _ = m.predict(tsim.reference_trajectory_2d(50)[:, :2])
    assert float((lo_surf > 0).float().mean()) > 0.9
    assert float((lo_traj < 0).float().mean()) > 0.95
    assert bool(torch.isfinite(grad).all())


N_POSES = 20
NMAX = 2048


def _long_horizon_batches():
    """tests/test_long_horizon.py's datasets for the first N_POSES poses of
    its 200-pose ellipse: hits plus 4 free points a ray, at float32."""
    lidar = tsim.Lidar2D(tsim.Lidar2D.Setting(
        min_angle=-2.356, max_angle=2.356, num_lines=RAYS),
        tsim.reference_space_2d())
    rng = np.random.default_rng(0)
    dx = np.zeros((N_POSES, NMAX, 2), np.float32)
    dy = np.zeros((N_POSES, NMAX, 1), np.float32)
    dm = np.zeros((N_POSES, NMAX), bool)
    for i, pose in enumerate(tsim.reference_trajectory_2d(200)[:N_POSES]):
        _, pts, hit = tsim.lidar_scan_points_2d(lidar, pose)
        pts = pts[hit]
        t = rng.uniform(0.05, 0.95, (len(pts), 4))
        free = (pose[:2][None, :] + (pts - pose[:2][None, :])[:, None, :]
                * t[:, :, None]).reshape(-1, 2)
        X = np.concatenate([pts, free])[:NMAX]
        y = np.concatenate([np.ones(len(pts)), -np.ones(len(free))])[:NMAX]
        dx[i, :len(X)] = X
        dy[i, :len(X), 0] = y
        dm[i, :len(X)] = True
    return dx, dy, dm


def test_long_horizon_f32_replay_tracks_jax_f64():
    """tests/test_long_horizon.py's gates on the port's float32
    ``spgp_update`` chain (production config) over its first 20 poses,
    against the JAX package's float64 replay of the same datasets: drift
    < 1e-3, sign agreement > 0.999, mean relative error < 1e-4."""
    from erl_gaussian_process_tpu.utils.drift import replay_f64

    from erl_gaussian_process_tpu_torch.utils.drift import drift_metric

    dx, dy, dm = _long_horizon_batches()
    pseudo = GridMapInfo2D([-3, -3], [3, 3], [31, 31]) \
        .generate_meter_coordinates()
    grid = GridMapInfo2D([-2.5, -2.5], [2.5, 2.5], [31, 31]) \
        .generate_meter_coordinates().astype(np.float32)
    scale, var = 0.18, 1e-4
    st = spgp_init(torch.tensor(pseudo.astype(np.float32)), scale,
                   kernel="matern32")
    vv = torch.full((NMAX,), var, dtype=torch.float32)
    for i in range(N_POSES):
        st = spgp_update(st, torch.tensor(dx[i]), torch.tensor(dy[i]), vv,
                         torch.tensor(dm[i]), scale, kernel="matern32")
    L_qm, a = spgp_prepare(st)
    mean, _, _ = spgp_predict(st, L_qm, a, torch.tensor(grid), scale,
                              kernel="matern32", with_var=False)
    lo32 = mean[:, 0].double().numpy()
    assert np.isfinite(lo32).all()
    lo64 = replay_f64(pseudo, scale, "matern32", dx, dy, dm, var, grid)
    assert drift_metric(lo32, lo64) < 1e-3
    assert np.mean(np.sign(lo32) == np.sign(lo64)) > 0.999
    assert np.abs(lo32 - lo64).mean() / np.abs(lo64).max() < 1e-4
