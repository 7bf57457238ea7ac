"""The PyTorch port's 3D range-sensor GP
(erl_gaussian_process_tpu_torch/models/range_sensor_gp_3d.py, with
geometry/frames_3d.py and the reference workloads) against the JAX package
on the same scans: frames and partitions exactly, the bank and the
predictions to 1e-12 of their magnitude at float64 and 1e-4 at float32,
the offline replay bit for bit against per-scan training, state carried
over from JAX, and the reference protocols' MSE gates on the plain path."""

import functools

import numpy as np
import pytest
import torch

from erl_gaussian_process_tpu.geometry import frames_3d as jframes
from erl_gaussian_process_tpu.models.range_sensor_gp_3d import (
    RangeSensorGaussianProcess3D as JaxGP3D,
    RangeSensorGP3DSetting as JaxSetting3D,
    _grid_partitions as jax_grid_partitions,
)
from erl_gaussian_process_tpu_torch.geometry import (
    DepthFrame3DSetting,
    LidarFrame3DSetting,
    create_range_sensor_frame_3d,
)
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import (
    MappingSetting,
    MappingType,
    RangeSensorGaussianProcess3D,
    RangeSensorGP3DSetting,
    VanillaGPSetting,
)
from erl_gaussian_process_tpu_torch.models.range_sensor_gp_3d import (
    _grid_partitions,
)
from erl_gaussian_process_tpu_torch.utils.convert import (
    range_sensor_gp_3d_from_numpy,
)
from erl_gaussian_process_tpu_torch.workloads import (
    depth3d_reference_workload,
    lidar3d_reference_workload,
    lidar3d_replay_workload,
)

TOL = {np.float64: 1e-12, np.float32: 1e-4}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, ref, tol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _wavy_room_ranges(dirs):
    az = np.arctan2(dirs[..., 1], dirs[..., 0])
    el = np.arctan2(dirs[..., 2], np.hypot(dirs[..., 0], dirs[..., 1]))
    return 5.0 + 0.5 * np.sin(3 * az) * np.cos(2 * el)


def _setting(frame="lidar"):
    """The JAX package's analytic test setting: a 64x33 lidar scan, or a
    48x64 depth image."""
    s = RangeSensorGP3DSetting(
        row_group_size=12, row_overlap_size=4, row_margin=0,
        col_group_size=12, col_overlap_size=4, col_margin=0,
        min_num_samples_per_group=10, sensor_range_var=1e-4,
        max_valid_range_var=0.1, sensor_frame_type="lidar",
        sensor_frame=LidarFrame3DSetting(
            valid_range_min=0.1, valid_range_max=40.0,
            azimuth_min=-np.pi, azimuth_max=np.pi, elevation_min=-0.6,
            elevation_max=0.6, num_azimuth_lines=64, num_elevation_lines=33),
        gp=VanillaGPSetting(kernel_type="ou",
                            kernel=KernelSetting(x_dim=2, scale=0.5)),
        mapping=MappingSetting(type=MappingType.IDENTITY))
    if frame == "depth":
        s.sensor_frame_type = "depth"
        s.sensor_frame = DepthFrame3DSetting(
            valid_range_min=0.1, valid_range_max=40.0, image_height=48,
            image_width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0)
        s.gp.kernel.scale = 8.0
    return s


def _jax_gp(setting, dtype):
    return JaxGP3D(JaxSetting3D.from_dict(setting.to_dict()), dtype=dtype)


def _holed_scan(gp, seed=1, frac=0.2):
    """The analytic scan with a fraction of its rays missing, so masking
    and whole-group skipping engage."""
    ranges = _wavy_room_ranges(gp.sensor_frame.ray_directions_in_frame())
    rng = np.random.default_rng(seed)
    return np.where(rng.uniform(size=ranges.shape) < frac, np.inf, ranges)


_POSE = (np.array([[np.cos(0.4), -np.sin(0.4), 0.0],
                   [np.sin(0.4), np.cos(0.4), 0.0],
                   [0.0, 0.0, 1.0]]), np.array([1.0, 2.0, 0.5]))


# -- frames and partitions (host numpy in both packages: exact) ------------

@pytest.mark.parametrize("frame", ["lidar", "depth"])
def test_frames_match_jax_exactly(frame):
    s = _setting(frame)
    f = create_range_sensor_frame_3d(s.sensor_frame_type, s.sensor_frame)
    jf = jframes.create_range_sensor_frame_3d(
        s.sensor_frame_type, s.sensor_frame.to_dict())
    np.testing.assert_array_equal(f.frame_coords(), jf.frame_coords())
    dirs = f.ray_directions_in_frame()
    np.testing.assert_array_equal(dirs, jf.ray_directions_in_frame())
    rng = np.random.default_rng(0)
    d = rng.normal(size=(500, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c, ok = f.compute_frame_coords(d)
    jc, jok = jf.compute_frame_coords(d)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(f.coords_in_frame(c), jf.coords_in_frame(c))
    ranges = _wavy_room_ranges(dirs)
    f.update_ranges(*_POSE, ranges)
    jf.update_ranges(*_POSE, ranges)
    np.testing.assert_array_equal(f.hit_mask, jf.hit_mask)
    np.testing.assert_array_equal(f.dir_world_to_frame(d),
                                  jf.dir_world_to_frame(d))


@pytest.mark.parametrize("frame", ["lidar", "depth"])
def test_partitions_and_search_match_jax_exactly(frame):
    s = _setting(frame)
    gp = RangeSensorGaussianProcess3D(s, device="cpu")
    jgp = _jax_gp(s, np.float64)
    fc = gp.sensor_frame.frame_coords()
    for coords, g in ((fc[:, 0, 0], 12), (fc[0, :, 1], 10)):
        assert _grid_partitions(coords, g, 4, 1) == \
            jax_grid_partitions(coords, g, 4, 1)
    assert gp.row_partitions == jgp.row_partitions
    assert gp.col_partitions == jgp.col_partitions
    rng = np.random.default_rng(3)
    lo, hi = fc.reshape(-1, 2).min(0) - 0.2, fc.reshape(-1, 2).max(0) + 0.2
    q = np.concatenate([fc.reshape(-1, 2), rng.uniform(lo, hi, (400, 2))])
    idx = gp.search_partition(q)
    np.testing.assert_array_equal(idx, jgp.search_partition(q))
    assert (idx[: fc.shape[0] * fc.shape[1]] >= 0).mean() > 0.95


# -- training and prediction against JAX -----------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("frame", ["lidar", "depth"])
def test_train_test_and_compute_occ_match_jax(frame, dtype):
    """Bank L (lower triangle), alpha and mask, then test mean, variance
    and valid, and compute_occ, on the same holed scan at a rotated,
    translated pose."""
    s = _setting(frame)
    gp = RangeSensorGaussianProcess3D(s, dtype=dtype, device="cpu")
    jgp = _jax_gp(s, dtype)
    ranges = _holed_scan(gp)
    assert gp.train(*_POSE, ranges) and jgp.train(*_POSE, ranges)
    tol = TOL[dtype]
    np.testing.assert_array_equal(_np(gp.bank.mask), np.asarray(jgp.bank.mask))
    np.testing.assert_array_equal(_np(gp.bank.trained),
                                  np.asarray(jgp.bank.trained))
    _close(gp.bank.x, jgp.bank.x, 0)
    tri = np.tril(np.ones(gp.bank.L.shape[1:], bool))
    _close(np.where(tri, _np(gp.bank.L), 0),
           np.where(tri, np.asarray(jgp.bank.L), 0), tol)
    _close(gp.bank.alpha, jgp.bank.alpha, tol)
    dirs = gp.sensor_frame.ray_directions_in_frame().reshape(-1, 3)
    world = dirs[::7] @ _POSE[0].T
    res, jres = gp.test(world, False, True), jgp.test(world, False, True)
    mean, valid = res.get_mean()
    jmean, jvalid = jres.get_mean()
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.mean() > 0.5
    _close(mean[valid], jmean[valid], tol)
    _close(res.get_variance()[0], jres.get_variance()[0], tol)
    r = ranges.reshape(-1)[::11]
    near = dirs[::11] * np.where(np.isfinite(r), 0.6 * r, 1.0)[:, None]
    got, ref = gp.compute_occ(near), jgp.compute_occ(near)
    np.testing.assert_array_equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        _close(a[got[0]], np.asarray(b)[got[0]], tol)
    one, jone = gp.compute_occ(near[0]), jgp.compute_occ(near[0])
    assert one.keys() == jone.keys() and one["success"] == jone["success"]


def test_scan_gather_matches_the_host_assembled_arrays():
    """The device gather reproduces the host path slot for slot,
    including whole groups skipped below the sample floor."""
    s = _setting()
    s.min_num_samples_per_group = 100
    gp = RangeSensorGaussianProcess3D(s, device="cpu")
    assert gp.train(np.eye(3), np.zeros(3), _holed_scan(gp, frac=0.35))
    xs, ys, vs, ms = gp._assemble_bank_arrays()
    got = gp._gather_scans(gp.sensor_frame.ranges[None])
    for a, b in zip(got, (xs, ys, vs, ms)):
        np.testing.assert_array_equal(_np(a), b)
    assert int((~_np(gp.bank.trained)).sum()) > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_train_scan_batch_equals_per_scan_train(dtype):
    """S scans in one bank fit: each scan's slice equals its own train bit
    for bit, and use_scan_bank routes queries at it."""
    s, Rs, ts, rb = _replay(3)
    gp = RangeSensorGaussianProcess3D(s, dtype=dtype, device="cpu")
    stacked = gp.train_scan_batch(rb)
    B = gp.num_partitions[0] * gp.num_partitions[1]
    assert stacked.x.shape[0] == 3 * B
    q = gp.sensor_frame.ray_directions_in_frame().reshape(-1, 3)[::97]
    for k in (0, 2):
        assert gp.train(Rs[k], ts[k], rb[k])
        per = gp.bank
        ref_mean, ref_valid = gp.test(q, True, False).get_mean()
        gp.use_scan_bank(stacked, k)
        for a, b in zip(gp.bank, per):
            assert torch.equal(a, b)
        mean, valid = gp.test(q, True, False).get_mean()
        np.testing.assert_array_equal(valid, ref_valid)
        np.testing.assert_array_equal(mean, ref_mean)
    with pytest.raises(ValueError):
        gp.train_scan_batch(rb[:, :10, :])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_train_scan_batch_matches_jax(dtype):
    """The replay as one bank fit with no per-scan alpha solve against the
    JAX package's replay of the same 3 scans: mask, L (lower triangle) and
    alpha of every member."""
    s, _, _, rb = _replay(3)
    gp = RangeSensorGaussianProcess3D(s, dtype=dtype, device="cpu")
    stacked = gp.train_scan_batch(rb)
    jstacked = _jax_gp(s, dtype).train_scan_batch(rb)
    np.testing.assert_array_equal(_np(stacked.mask), np.asarray(jstacked.mask))
    tri = np.tril(np.ones(stacked.L.shape[1:], bool))
    tol = TOL[dtype]
    _close(np.where(tri, _np(stacked.L), 0),
           np.where(tri, np.asarray(jstacked.L), 0), tol)
    _close(stacked.alpha, jstacked.alpha, tol)


@functools.lru_cache(maxsize=None)
def _replay(n):
    return lidar3d_replay_workload(n)


def test_state_from_jax_gives_jax_predictions():
    s = _setting()
    jgp = _jax_gp(s, np.float64)
    assert jgp.train(*_POSE, _holed_scan(jgp))
    gp = range_sensor_gp_3d_from_numpy(jgp.state_dict(), device="cpu")
    assert gp.dtype == np.float64 and gp.is_trained
    assert gp.bank.L_inv is None
    q = gp.sensor_frame.ray_directions_in_frame().reshape(-1, 3)[::5]
    mean, valid = gp.test(q, True, True).get_mean()
    jmean, jvalid = jgp.test(q, True, True).get_mean()
    np.testing.assert_array_equal(valid, jvalid)
    _close(mean[valid], jmean[valid], 1e-12)
    _close(gp.test(q, True, True).get_variance()[0],
           jgp.test(q, True, True).get_variance()[0], 1e-12)


def test_save_load_round_trip(tmp_path):
    s = _setting()
    gp = RangeSensorGaussianProcess3D(s, device="cpu")
    assert gp.train(np.eye(3), np.zeros(3), _holed_scan(gp))
    p = str(tmp_path / "gp3d.npz")
    gp.save(p)
    gp2 = RangeSensorGaussianProcess3D(device="cpu")
    gp2.load(p)
    assert gp == gp2
    assert gp2.get_memory_usage() > 0
    assert gp.get_memory_usage() > gp2.get_memory_usage()   # L_inv
    q = gp.sensor_frame.ray_directions_in_frame().reshape(-1, 3)[::13]
    r1, v1 = gp.test(q, True, True).get_mean()
    r2, v2 = gp2.test(q, True, True).get_mean()
    np.testing.assert_array_equal(v1, v2)
    _close(r2[v1], r1[v1], 1e-12)
    gp2.reset()
    assert not gp2.is_trained and gp2.test(q, True, True) is None


# -- the reference protocols on the plain path -----------------------------

@functools.lru_cache(maxsize=None)
def _protocol(name):
    return {"lidar": lidar3d_reference_workload,
            "depth": depth3d_reference_workload}[name]()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,gate", [("lidar", 4.2e-4), ("depth", 2.2e-4)])
def test_reference_protocol_mse(name, gate, dtype):
    """The reference's lidar (271x91, 736 partitions of 100) and depth
    (120x160) protocols: scan the reference room from its center, test
    10 000 sphere directions against the raycast ground truth."""
    setting, R, t, ranges, q, gt, _ = _protocol(name)
    assert np.isfinite(ranges).all()
    gp = RangeSensorGaussianProcess3D(setting, dtype=dtype, device="cpu")
    assert gp.train(R, t, ranges)
    if name == "lidar":
        assert tuple(gp.bank.L.shape) == (736, 100, 100)
    pred, valid = gp.test(q, False, True).get_mean()
    assert valid.any()
    mse = np.mean((pred[valid] - gt[valid]) ** 2)
    assert mse <= gate, mse


# -- deferred features -----------------------------------------------------

def test_deferred_features_raise_naming_their_roadmap_item():
    """A mesh= that is not a mesh raises TypeError (the sharded fit is
    tests/test_torch_parallel.py's); a reduced-rank kernel type is
    ported: its frame-derived basis box and
    (m, m) bank as JAX's, the routed predictions to 1e-12 at float64 (the
    factors of the 1024 x 1024 information matrices at var 1e-4 to 1e-11:
    the products that build them sum ~10^2 samples of weight 1e4 in
    another order than XLA's)."""
    s = _setting()
    s.gp = VanillaGPSetting(kernel_type="reduced_rank_rbf",
                            kernel=KernelSetting(x_dim=2, scale=0.5))
    rr = RangeSensorGaussianProcess3D(s, device="cpu")
    jrr = JaxGP3D(JaxSetting3D.from_dict(_setting().to_dict() | {
        "gp": {"kernel_type": "reduced_rank_rbf",
               "kernel": {"x_dim": 2, "scale": 0.5}}}))
    assert rr.using_reduced_rank_kernel() and jrr.using_reduced_rank_kernel()
    assert rr.setting.gp.kernel.to_dict() == jrr.setting.gp.kernel.to_dict()
    ranges = _wavy_room_ranges(rr.sensor_frame.ray_directions_in_frame())
    for m in (rr, jrr):
        assert m.train(np.eye(3), np.zeros(3), ranges)
    nb = int(np.prod(rr.setting.gp.kernel.num_basis))
    assert tuple(rr.bank.L.shape)[1:] == (nb, nb)
    _close(rr.bank.L, jrr.bank.L, 1e-11)
    q = rr.sensor_frame.ray_directions_in_frame().reshape(-1, 3)[::7]
    a, b = rr.test(q, True, True), jrr.test(q, True, True)
    np.testing.assert_array_equal(a.get_mean()[1], b.get_mean()[1])
    v = a.get_mean()[1]
    assert v.mean() > 0.9
    _close(a.get_mean()[0][v], b.get_mean()[0][v], 1e-12)
    _close(a.get_variance()[0][v], b.get_variance()[0][v], 1e-12)
    assert (a.get_variance()[0][v] > 0).all()
    # mesh= is ported (tests/test_torch_parallel.py): what is not a mesh
    with pytest.raises(TypeError, match="make_mesh"):
        RangeSensorGaussianProcess3D(_setting(), mesh=object(), device="cpu")
    gp = RangeSensorGaussianProcess3D(_setting(), device="cpu")
    assert gp.gps == []            # untrained, no views
    assert not gp.using_reduced_rank_kernel()


def test_gps_views_match_jax():
    """The R x C grid of per-partition VanillaGaussianProcess views of a
    float64 model trained on one scan: the JAX grid's shape, each view's
    x, mask, L and alpha its member's slice of the bank, and two views'
    test means equal to the JAX views' to 1e-12."""
    s = _setting()
    gp = RangeSensorGaussianProcess3D(s, dtype=np.float64, device="cpu")
    jgp = _jax_gp(s, np.float64)
    ranges = _holed_scan(gp)
    assert gp.train(*_POSE, ranges) and jgp.train(*_POSE, ranges)
    grid, jgrid = gp.gps, jgp.gps
    R, C = gp.num_partitions
    assert len(grid) == len(jgrid) == R
    assert all(len(r) == len(jr) == C for r, jr in zip(grid, jgrid))
    for i in range(R):
        for j in range(C):
            b, v = i * C + j, grid[i][j]
            for name in ("x", "mask", "L", "alpha"):
                assert torch.equal(getattr(v.state, name),
                                   getattr(gp.bank, name)[b])
            assert v.is_trained == bool(gp.bank.trained[b])
    rng = np.random.default_rng(11)
    trained = [(i, j) for i in range(R) for j in range(C)
               if grid[i][j].is_trained]
    for i, j in (trained[0], trained[len(trained) // 2]):
        xq = grid[i][j].get_train_set().x[:, :5] \
            + rng.normal(scale=0.01, size=(2, 5))
        _close(grid[i][j].test(xq).get_mean(0),
               np.asarray(jgrid[i][j].test(xq).get_mean(0)), 1e-12)
