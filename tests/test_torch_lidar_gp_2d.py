"""The PyTorch port's 2D lidar GP (erl_gaussian_process_tpu_torch/models/
lidar_gp_2d.py, with geometry/lidar_frame_2d.py and utils/loaders.py)
against the JAX package on the logged scans of data/double/train.dat and
data/float/train.dat (28 frames of 270 rays): the loader, the frame and
the partition tables exactly; the bank and the predictions to 1e-12 of
their magnitude at float64 and 1e-4 at float32 (the tolerances of the 3D
sensor GP's parity tests); the reference's MAE gates; the offline replay
bit for bit against per-scan training; state carried over from JAX; and
the fit cache's three invalidation cases."""

import os

import numpy as np
import pytest
import torch

from erl_gaussian_process_tpu.geometry.lidar_frame_2d import (
    LidarFrame2D as JaxFrame,
    LidarFrame2DSetting as JaxFrameSetting,
)
from erl_gaussian_process_tpu.models import lidar_gp_2d as jlidar
from erl_gaussian_process_tpu.utils.loaders import (
    load_lidar_log as jax_load_lidar_log,
)
from erl_gaussian_process_tpu_torch.geometry import (
    LidarFrame2D,
    LidarFrame2DSetting,
)
from erl_gaussian_process_tpu_torch.models import (
    LidarGaussianProcess2D,
    LidarGP2DSetting,
)
from erl_gaussian_process_tpu_torch.models import lidar_gp_2d as tlidar
from erl_gaussian_process_tpu_torch.utils.convert import lidar_gp_2d_from_numpy
from erl_gaussian_process_tpu_torch.utils.loaders import load_lidar_log

_REPO = os.path.join(os.path.dirname(__file__), os.pardir)
DATA = os.path.join(_REPO, "data", "double", "train.dat")
DATA_FLOAT = os.path.join(_REPO, "data", "float", "train.dat")
TOL = {np.float64: 1e-12, np.float32: 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """One float32 exp over every thread before the parity tests: this CPU
    build of torch got its first multi-threaded float32 exp of a process
    wrong in one thread's chunk now and then (tests/test_torch_gram.py)."""
    torch.exp(torch.zeros(1 << 20, dtype=torch.float32))


@pytest.fixture(scope="module")
def frames():
    return load_lidar_log(DATA)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, ref, tol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _setting_dict(angles, discontinuity: bool, kernel="ou", scale=0.05,
                  mapping="identity", **kw):
    """tests/test_lidar_gp_2d.py:25-50's setting (the reference's OU-1d,
    identity mapping, asymmetric 26/6 partitions) as a dict both packages
    load."""
    d = dict(partition_on_hit_rays=False, symmetric_partitions=False,
             group_size=26, overlap_size=6, margin=1, init_variance=1e6,
             sensor_range_var=0.01, discontinuity_var=100.0,
             max_valid_range_var=0.1,
             sensor_frame=dict(valid_range_min=0.1, valid_range_max=30.0,
                               angle_min=float(angles[0]),
                               angle_max=float(angles[-1]),
                               num_rays=int(angles.shape[0]),
                               discontinuity_detection=discontinuity),
             gp=dict(kernel_type=kernel,
                     kernel=dict(x_dim=1, scale=scale)),
             mapping=dict(type=mapping))
    d.update(kw)
    return d


def _pair(d, dtype=np.float64):
    return (LidarGaussianProcess2D(LidarGP2DSetting.from_dict(d),
                                   dtype=dtype, device="cpu"),
            jlidar.LidarGaussianProcess2D(
                jlidar.LidarGP2DSetting.from_dict(d), dtype=dtype))


def _bank_close(bank, jbank, tol):
    np.testing.assert_array_equal(_np(bank.mask), np.asarray(jbank.mask))
    np.testing.assert_array_equal(_np(bank.trained),
                                  np.asarray(jbank.trained))
    np.testing.assert_array_equal(_np(bank.x), np.asarray(jbank.x))
    _close(bank.L, jbank.L, tol)
    _close(bank.alpha, jbank.alpha, tol)


@pytest.mark.parametrize("path,dtype", [(DATA, np.float64),
                                        (DATA_FLOAT, np.float32)],
                         ids=["double", "float"])
def test_loader_matches_jax_on_both_logs(path, dtype):
    ours, ref = load_lidar_log(path, dtype), jax_load_lidar_log(path, dtype)
    assert len(ours) == len(ref) == 28
    for a, b in zip(ours, ref):
        assert a.angles.dtype == a.ranges.dtype == np.dtype(dtype)
        assert a.angles.shape == (270,)
        for k in ("angles", "ranges", "position", "rotation"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_frame_matches_jax(frames):
    f = frames[3]
    s = LidarFrame2DSetting(valid_range_min=0.1, valid_range_max=8.0,
                            angle_min=float(f.angles[0]),
                            angle_max=float(f.angles[-1]), num_rays=270,
                            discontinuity_threshold=0.5)
    ours = LidarFrame2D(s)
    ref = JaxFrame(JaxFrameSetting.from_dict(s.to_dict()))
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    ranges = f.ranges.copy()
    ranges[::17] = np.inf
    assert ours.update_ranges(R, [1.0, 2.0], ranges)
    assert ref.update_ranges(R, [1.0, 2.0], ranges)
    for k in ("angles_in_frame", "hit_mask", "continuity_mask",
              "hit_ray_indices"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    assert ours.num_hit_rays == ref.num_hit_rays and ours.is_valid()
    wa = np.linspace(-3, 3, 50)
    np.testing.assert_array_equal(ours.angles_world_to_frame(wa),
                                  ref.angles_world_to_frame(wa))
    np.testing.assert_array_equal(ours.end_points_in_world(),
                                  ref.end_points_in_world())
    assert not ours.update_ranges(R, [1.0, 2.0], ranges[:100])
    assert not ours.is_valid()


@pytest.mark.parametrize("n,group,overlap,margin", [
    (270, 26, 6, 1), (271, 20, 4, 0), (90, 26, 6, 1), (64, 12, 4, 2)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_angle_partitions_match_jax(n, group, overlap, margin, symmetric):
    coords = np.linspace(-2.3, 2.3, n)
    ours = tlidar.partition_on_angles(n, group, overlap, margin, symmetric,
                                      coords)
    ref = jlidar.partition_on_angles(n, group, overlap, margin, symmetric,
                                     coords)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


@pytest.mark.parametrize("last_hit", [True, False])
def test_hit_ray_partitions_match_jax(last_hit):
    """Including the right-edge clamp: the last partition's right index is
    num_rays when the last ray is a hit, its coord the last angle."""
    rng = np.random.default_rng(2)
    coords = np.linspace(-2.0, 2.0, 200)
    hit = rng.uniform(size=200) < 0.8
    hit[-1] = last_hit
    h = np.flatnonzero(hit)
    ours = tlidar.partition_on_hit_rays(h, len(h), 26, 6, coords)
    ref = jlidar.partition_on_hit_rays(h, len(h), 26, 6, coords)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    assert (ours[-1][1] == 200) == last_hit
    if last_hit:
        assert ours[-1][3] == coords[-1]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("discontinuity", [False, True])
def test_train_test_and_occ_match_jax(frames, dtype, discontinuity):
    """Frame 0 through train and test, at both dtypes, discontinuity
    detection off and on: the bank and the routed predictions against
    JAX, and the reference's MAE gates (0.022 off, 0.08 on; 0.04 at
    float32)."""
    f = frames[0]
    gp, jgp = _pair(_setting_dict(f.angles, discontinuity), dtype)
    assert gp.train(np.eye(2), np.zeros(2), f.ranges)
    assert jgp.train(np.eye(2), np.zeros(2), f.ranges)
    assert tuple(gp.bank.L.shape) == (14, 26, 26)
    tol = TOL[dtype]
    _bank_close(gp.bank, jgp.bank, tol)
    res = gp.test(f.angles, angles_are_local=False, un_map=True)
    jres = jgp.test(f.angles, angles_are_local=False, un_map=True)
    pred, valid = res.get_mean()
    jpred, jvalid = jres.get_mean()
    np.testing.assert_array_equal(valid, jvalid)
    assert pred.dtype == np.dtype(dtype) and valid.any()
    _close(pred[valid], jpred[valid], tol)
    var, vvalid = res.get_variance()
    _close(var, jres.get_variance()[0], tol)
    mae = np.abs(pred[valid] - f.ranges[valid]).mean()
    gate = 0.08 if discontinuity else (0.022 if dtype == np.float64 else 0.04)
    assert mae < gate, mae
    idx = np.arange(20, 250, 40)
    ang, r = f.angles[idx], f.ranges[idx]
    for frac in (0.5, 1.2):
        p = np.stack([frac * r * np.cos(ang), frac * r * np.sin(ang)], -1)
        ours, ref = gp.compute_occ(p), jgp.compute_occ(p)
        np.testing.assert_array_equal(ours[0], ref[0])
        for a, b in zip(ours[1:], ref[1:]):
            _close(a[ours[0]], np.asarray(b)[ours[0]], tol)
        occ = ours[3][ours[0]]
        assert (occ < -0.9).all() if frac < 1 else (occ > 0.9).all()
    one = gp.compute_occ(p[0])
    assert set(one) == {"success", "dist_pos", "range_pred", "occ"}


def test_float_log_golden_matches_jax():
    """data/float/train.dat's frame 0 at float32 (the reference's
    F-suffixed instantiation): against JAX, and MAE < 0.04."""
    f = load_lidar_log(DATA_FLOAT, np.float32)[0]
    gp, jgp = _pair(_setting_dict(f.angles, False), np.float32)
    assert gp.train(np.eye(2), np.zeros(2), f.ranges)
    assert jgp.train(np.eye(2), np.zeros(2), f.ranges)
    _bank_close(gp.bank, jgp.bank, 1e-4)
    pred, valid = gp.test(f.angles, False, True).get_mean()
    jpred, jvalid = jgp.test(f.angles, False, True).get_mean()
    np.testing.assert_array_equal(valid, jvalid)
    _close(pred[valid], jpred[valid], 1e-4)
    assert pred.dtype == np.float32
    assert np.abs(pred[valid] - f.ranges[valid]).mean() < 0.04


def test_world_frame_queries_and_transforms(frames):
    f = frames[0]
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    t = np.array([1.0, -2.0])
    gp, jgp = _pair(_setting_dict(f.angles, False))
    assert gp.train(R, t, f.ranges) and jgp.train(R, t, f.ranges)
    pred, valid = gp.test(f.angles + th, False, True).get_mean()
    jpred, jvalid = jgp.test(f.angles + th, False, True).get_mean()
    np.testing.assert_array_equal(valid, jvalid)
    _close(pred[valid], jpred[valid], 1e-12)
    assert np.abs(pred[valid] - f.ranges[valid]).mean() < 0.022
    rng = np.random.default_rng(0)
    d = rng.normal(size=(7, 2))
    p = rng.uniform(-2, 2, (7, 2))
    for name, arg in (("global_to_local_so2", d), ("local_to_global_so2", d),
                      ("global_to_local_se2", p), ("local_to_global_se2", p)):
        np.testing.assert_array_equal(getattr(gp, name)(arg),
                                      getattr(jgp, name)(arg))
    np.testing.assert_allclose(
        gp.local_to_global_se2(gp.global_to_local_se2(p)), p, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_train_scan_batch_matches_per_scan_train_and_jax(frames, dtype):
    """The 28 logged scans in one bank fit: each scan's slice bit for bit
    its own train (bank and routed predict), and against JAX's replay."""
    f0 = frames[0]
    d = _setting_dict(f0.angles, True)
    gp, jgp = _pair(d, dtype)
    rb = np.stack([f.ranges for f in frames])
    stacked = gp.train_scan_batch(rb)
    jstacked = jgp.train_scan_batch(rb)
    B = len(gp.partitions)
    assert tuple(stacked.L.shape) == (28 * B, 26, 26) and B == 14
    _bank_close(stacked, jstacked, TOL[dtype])
    q = np.linspace(-1.5, 1.5, 64)
    for s in (0, 9, 27):
        assert gp.train(np.eye(2), np.zeros(2), rb[s])
        sl = slice(s * B, (s + 1) * B)
        for a, b in zip(stacked, gp.bank):
            assert torch.equal(a[sl], b)
        ref = gp.test(q, True, False).get_mean()
        gp.use_scan_bank(stacked, s)
        got = gp.test(q, True, False).get_mean()
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    with pytest.raises(ValueError):
        gp.train_scan_batch(rb[:, :100])
    gp.setting.partition_on_hit_rays = True
    with pytest.raises(NotImplementedError, match="angle-partition"):
        gp.train_scan_batch(rb)


def test_hit_ray_partitions_train_matches_jax(frames):
    f = frames[5]
    gp, jgp = _pair(_setting_dict(f.angles, True,
                                  partition_on_hit_rays=True))
    assert gp.train(np.eye(2), np.zeros(2), f.ranges)
    assert jgp.train(np.eye(2), np.zeros(2), f.ranges)
    np.testing.assert_array_equal(np.asarray(gp.partitions),
                                  np.asarray(jgp.partitions))
    _bank_close(gp.bank, jgp.bank, 1e-12)
    pred, valid = gp.test(f.angles, True, True).get_mean()
    jpred, jvalid = jgp.test(f.angles, True, True).get_mean()
    np.testing.assert_array_equal(valid, jvalid)
    _close(pred[valid], jpred[valid], 1e-12)


def test_save_load_and_jax_state_carried_over(frames, tmp_path):
    f = frames[1]
    d = _setting_dict(f.angles, True, mapping="inverse_sqrt")
    gp, jgp = _pair(d)
    assert gp.train(np.eye(2), np.zeros(2), f.ranges)
    assert jgp.train(np.eye(2), np.zeros(2), f.ranges)
    path = str(tmp_path / "lidar.npz")
    gp.save(path)
    gp2 = LidarGaussianProcess2D(LidarGP2DSetting(
        sensor_frame=LidarFrame2DSetting(num_rays=30)), device="cpu")
    gp2.load(path)
    assert gp == gp2 and gp2.bank.L_inv is None
    q = np.linspace(-2.0, 2.0, 77)
    a, b = gp.test(q, True, True), gp2.test(q, True, True)
    np.testing.assert_array_equal(a.get_mean()[1], b.get_mean()[1])
    _close(a.get_mean()[0][a.get_mean()[1]], b.get_mean()[0][a.get_mean()[1]],
           1e-12)
    carried = lidar_gp_2d_from_numpy(jgp.state_dict(), device="cpu")
    assert carried.dtype == np.float64 and carried.is_trained
    jm, jv = jgp.test(q, True, True).get_mean()
    cm, cv = carried.test(q, True, True).get_mean()
    np.testing.assert_array_equal(cv, jv)
    _close(cm[cv], jm[jv], 1e-12)
    _close(carried.test(q, True, False).get_variance()[0],
           jgp.test(q, True, False).get_variance()[0], 1e-12)
    # and it keeps training: the next scan as the JAX model trains it
    assert carried.train(np.eye(2), np.zeros(2), frames[2].ranges)
    assert jgp.train(np.eye(2), np.zeros(2), frames[2].ranges)
    _bank_close(carried.bank, jgp.bank, 1e-12)


def test_gps_views_match_jax(frames):
    f = frames[0]
    gp, jgp = _pair(_setting_dict(f.angles, False))
    assert gp.gps == [] and jgp.gps == []
    gp.train(np.eye(2), np.zeros(2), f.ranges)
    jgp.train(np.eye(2), np.zeros(2), f.ranges)
    views, jviews = gp.gps, jgp.gps
    assert len(views) == len(jviews) == 14
    q = np.linspace(-0.3, 0.3, 9)[None]
    for b in (0, 6, 13):
        v, jv = views[b], jviews[b]
        assert v.is_trained == jv.is_trained
        assert v._train_set.num_samples == jv._train_set.num_samples
        _close(v.state.L, jv.state.L, 1e-12)
        _close(v.test(q).get_mean(), jv.test(q).get_mean(), 1e-12)


def _mk(n, **kw):
    angles = np.linspace(-2.2, 2.2, n)
    return LidarGaussianProcess2D(LidarGP2DSetting.from_dict(
        _setting_dict(angles, True, **kw)), device="cpu"), angles


def test_fit_cache_invalidated_by_load_state_dict():
    gp_a, ang_a = _mk(270)
    assert gp_a.train(np.eye(2), np.zeros(2), 3.0 + 0.1 * np.sin(ang_a))
    gp_b, ang_b = _mk(180)
    r_b = 4.0 + 0.1 * np.cos(ang_b)
    assert gp_b.train(np.eye(2), np.zeros(2), r_b)
    gp_a.load_state_dict(gp_b.state_dict())
    assert gp_a.train(np.eye(2), np.zeros(2), r_b)
    assert gp_a.bank.x.shape[0] == len(gp_b.partitions) == \
        len(gp_a.partitions)
    gp_c, _ = _mk(180)
    assert gp_c.train(np.eye(2), np.zeros(2), r_b)
    assert torch.equal(gp_a.bank.L, gp_c.bank.L)


def test_fit_cache_sees_live_setting_scalars():
    gp, ang = _mk(270)
    r = 3.0 + 0.1 * np.sin(ang)
    assert gp.train(np.eye(2), np.zeros(2), r)
    before = gp.bank.L.clone()
    gp.setting.sensor_range_var = 0.5
    assert gp.train(np.eye(2), np.zeros(2), r)
    assert float((gp.bank.L - before).abs().max()) > 1e-6
    from erl_gaussian_process_tpu_torch.models.batch_gp import bank_fit
    xs, ys, vs, ms = gp._assemble_bank_arrays()
    ref = bank_fit(*map(torch.as_tensor, (xs, ys, vs, ms)), gp._scale,
                   kernel=gp._kernel)
    assert torch.equal(gp.bank.L, ref.L)
    assert torch.equal(gp.bank.alpha, ref.alpha)


def test_fit_cache_invalidated_by_partition_mode_toggle():
    gp, ang = _mk(270)
    r = 3.0 + 0.1 * np.sin(ang)
    r[::7] = np.inf
    assert gp.train(np.eye(2), np.zeros(2), r)
    L_angle = gp.bank.L.clone()
    gp.setting.partition_on_hit_rays = True
    assert gp.train(np.eye(2), np.zeros(2), r)
    assert gp.bank.L.shape[0] != L_angle.shape[0] or \
        not torch.equal(gp.bank.L, L_angle)
    gp.setting.partition_on_hit_rays = False
    gp.partition_on_angles()
    assert gp.train(np.eye(2), np.zeros(2), r)
    assert torch.equal(gp.bank.L, L_angle)


def test_mesh_is_not_ported_and_bad_scans_do_not_train():
    # mesh= is ported (tests/test_torch_parallel.py): what is not a mesh
    with pytest.raises(TypeError, match="make_mesh"):
        LidarGaussianProcess2D(mesh=object(), device="cpu")
    gp, ang = _mk(90)
    assert not gp.train(np.eye(2), np.zeros(2), np.full(90, np.inf))
    assert not gp.train(np.eye(2), np.zeros(2), np.ones(50))
    assert gp.test(ang, True, True) is None and not gp.is_trained
    assert gp.get_memory_usage() == 0
    assert gp.train(np.eye(2), np.zeros(2), np.full(90, 2.0))
    assert gp.get_memory_usage() > 0
    gp.reset()
    assert not gp.is_trained and gp.bank is None
