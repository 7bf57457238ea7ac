"""The sensor GPs' device-routed test on the CPU: the grouping into
fixed-shape rows (``models/batch_gp.group_chunks``), the partition search
on tensors (``RangeSensorGaussianProcess3D._route_tensor``) and the whole
graphed ``test`` and ``compute_occ`` (``bank_predict_chunked`` through
``SensorGraphs.routed_test``), run through the eager capture stand-in,
against the host path the CPU model takes (``route_directions``,
``group_queries``, ``bank_predict_assigned``): the same member for every
query, the same valid flags, and answers within the tolerances of
tests/test_torch_sensor_graph.py (float64 1e-12 and float32 1e-4 of each
result's magnitude). The lidar and depth frames, directions in the
sensor's frame and the world's, the plain and the reduced-rank kernel;
query counts off the padding's multiple, no valid query, every query on
one member, every member active. The 2D lidar GP's graphed test counts
as the 3D GP's (tests/test_torch_sensor_graph.py holds its answers)."""

import numpy as np
import pytest
import torch

from erl_gaussian_process_tpu_torch.models import (
    LidarGaussianProcess2D,
    LidarGP2DSetting,
    RangeSensorGaussianProcess3D,
    RangeSensorGP3DSetting,
)
from erl_gaussian_process_tpu_torch.models.batch_gp import (
    ROUTE_CHUNK,
    ROUTE_PAD,
    chunk_rows,
    group_chunks,
    group_queries,
)
from erl_gaussian_process_tpu_torch.models.sensor_graph import SensorGraphs
from erl_gaussian_process_tpu_torch.utils import timing
from erl_gaussian_process_tpu_torch.utils.loaders import load_lidar_log
from test_torch_range_sensor_gp_3d import _POSE, _holed_scan
from test_torch_range_sensor_gp_3d import _setting as _analytic_setting
from test_torch_sensor_graph import DATA as DATA_2D
from test_torch_sensor_graph import _scans_3d, _setting_2d, _setting_3d
from torch_graph_standin import eager_graphs  # noqa: F401 (fixture)

TOL = {np.float64: 1e-12, np.float32: 1e-4}
KINDS = ["lidar", "lidar_rr", "depth"]


def _models(kind, dtype):
    """(host-routed CPU model, graphed CPU model), both trained on the
    same scan at ``_POSE``."""
    if kind == "depth":
        setting = _analytic_setting("depth")
        make = lambda: RangeSensorGaussianProcess3D(  # noqa: E731
            setting, dtype=dtype, device="cpu")
    else:
        d = _setting_3d(kind.endswith("_rr"))
        make = lambda: RangeSensorGaussianProcess3D(  # noqa: E731
            RangeSensorGP3DSetting.from_dict(d), dtype=dtype, device="cpu")
    host, dev = make(), make()
    dev._graphs = SensorGraphs("cpu")
    scan = _holed_scan(host) if kind == "depth" else _scans_3d(host, 1)[0]
    for gp in (host, dev):
        assert gp.train(*_POSE, scan)
    return host, dev


def _directions(kind, m, seed):
    """m directions, about half of them inside the frame: the unit sphere
    for the lidar; for the depth camera's narrow frustum, rays through the
    image and a band around it, and some of the sphere."""
    rng = np.random.default_rng(seed)
    if kind == "depth":
        d = np.concatenate([rng.uniform(-1.2, 1.2, (m, 2)),
                            np.ones((m, 1))], axis=1)
        d[::5] = rng.normal(size=(len(d[::5]), 3))
    else:
        d = rng.normal(size=(m, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _same_answers(got, want, dtype):
    """(mean, var, valid) of the device path against the host path's."""
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    for a, b in zip(got[:2], want[:2]):
        _close(a, b, TOL[dtype])


def _result(res):
    return res._mean, res._var, res._valid


def _device_members(gp, dirs_local):
    """The member of each sensor-frame direction as the graph routes it."""
    coords, ok = gp.sensor_frame.compute_frame_coords(dirs_local)
    q = np.where(ok[:, None], coords, np.nan).astype(gp.dtype)
    return gp._route_tensor(torch.as_tensor(q)).numpy()


# -- the grouping ---------------------------------------------------------

def _group_reference(key, members, chunk):
    """group_chunks' contract in numpy: member b's queries, in order, fill
    ceil(c_b / chunk) consecutive rows from the first free one."""
    m = len(key)
    R = chunk_rows(m, members, chunk)
    src = np.full((R, chunk), m)
    mids = np.zeros(R, np.int64)
    slot = np.full(m, R * chunk)
    row = 0
    for b in range(members):
        qs = np.flatnonzero(key == b)
        for j, q in enumerate(qs):
            r, c = row + j // chunk, j % chunk
            src[r, c], mids[r], slot[q] = q, b, r * chunk + c
        row += -(-len(qs) // chunk)
    assert row <= R
    return src, mids, slot


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("fill", ["random", "one_member", "every_member",
                                  "none", "worst"])
def test_group_chunks_matches_its_contract(chunk, fill):
    """Random keys; every query on one member (many rows of it); every
    member active; no query answered; and the bound's worst case, every
    member's count one past a whole number of rows (sum_b ceil(c_b /
    chunk) at its largest for the count)."""
    rng = np.random.default_rng(chunk)
    members, m = 37, 3 * ROUTE_PAD
    if fill == "random":
        key = rng.integers(0, members + 1, m)
    elif fill == "one_member":
        key = np.where(rng.uniform(size=m) < 0.9, 5, members)
    elif fill == "every_member":
        key = np.concatenate([np.arange(members),
                              rng.integers(0, members, m - members)])
        rng.shuffle(key)
    elif fill == "none":
        key = np.full(m, members)
    else:
        per = chunk + 1
        key = np.repeat(np.arange(members), per)
        key = np.concatenate([key, np.full(m - len(key), members)])
        rng.shuffle(key)
    src, mids, slot = group_chunks(torch.as_tensor(key), members, chunk)
    want = _group_reference(key, members, chunk)
    for got, ref in zip((src, mids, slot), want):
        np.testing.assert_array_equal(got.numpy(), ref)
    R = chunk_rows(m, members, chunk)
    assert src.shape == (R, chunk) and mids.shape == (R,)
    answered = key < members
    # every answered query has a slot of its own
    assert len(set(slot.numpy()[answered])) == int(answered.sum())


# -- routing and answers: the device path against the host path ------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_device_route_equals_the_host_route(kind, local, seed,
                                           eager_graphs):
    """The member of every query (random directions, a count that is no
    multiple of the padding) and the graphed test's valid flags, means and
    variances against the host path's, at float64 and float32."""
    m = ROUTE_PAD + 477 + seed
    for dtype in (np.float64, np.float32):
        host, dev = _models(kind, dtype)
        d = _directions(kind, m, seed)
        local_d = d if local else host.global_to_local_so3(d)
        _, idx = host.route_directions(np.asarray(local_d, dtype))
        np.testing.assert_array_equal(
            _device_members(dev, np.asarray(local_d, dtype)), idx)
        assert (idx >= 0).any() and (idx < 0).any()
        _same_answers(_result(dev.test(d, local, False)),
                      _result(host.test(d, local, False)), dtype)


@pytest.mark.parametrize("kind", KINDS)
def test_device_compute_occ_equals_the_host(kind, eager_graphs):
    """``compute_occ`` of points along the directions, each at its own
    distance: valid flags exact, distances bit for bit, the predicted
    ranges and occupancies within the tolerance."""
    for dtype in (np.float64, np.float32):
        host, dev = _models(kind, dtype)
        d = _directions(kind, 900, 7)
        p = d * np.random.default_rng(8).uniform(1.0, 8.0, (len(d), 1))
        (hv, hd, hr, ho), (dv, dd, dr, do) = host.compute_occ(p), \
            dev.compute_occ(p)
        np.testing.assert_array_equal(dv, hv)
        assert dd.tobytes() == hd.tobytes()
        assert hv.any()
        for a, b in ((dr, hr), (do, ho)):
            _close(a[hv], b[hv], TOL[dtype])


@pytest.mark.parametrize("kind", ["lidar", "depth"])
def test_device_route_edge_cases(kind, eager_graphs):
    """No valid query (directions the frame does not hold); every query on
    one member (its queries fill many rows); every member active (the
    frame's own rays); each against the host path. One graph per padded
    count: the counts within one multiple share it."""
    dtype = np.float64
    host, dev = _models(kind, dtype)
    outside = np.tile([[0.0, 0.0, 1.0] if kind == "lidar"
                       else [0.0, 0.0, -1.0]], (50, 1))
    one = np.tile(host.sensor_frame.ray_directions_in_frame()[7, 5],
                  (3 * ROUTE_CHUNK * 11 + 5, 1))
    rays = host.sensor_frame.ray_directions_in_frame().reshape(-1, 3)
    for d in (outside, one, rays):
        got = _result(dev.test(d, True, False))
        _same_answers(got, _result(host.test(d, True, False)), dtype)
        _, idx = host.route_directions(d)
        if d is outside:
            assert not got[2].any()
        elif d is one:
            assert got[2].all() and len(set(idx)) == 1
        else:
            trained = host.bank.trained.numpy()
            assert set(idx[got[2]]) == set(np.flatnonzero(trained))
    routed = [g for g in eager_graphs if g.key[1] == "chunked"]
    pads = {g.key[2] for g in routed}
    assert len(routed) == len(pads) and ROUTE_PAD in pads


def _lidar_2d_graphed():
    """(a graphed 2D lidar GP trained on the log's first scan, 3000 query
    angles over its frame and past it, 4 angles outside it)."""
    frames = load_lidar_log(DATA_2D)
    f = frames[0]
    setting = LidarGP2DSetting.from_dict(_setting_2d(f.angles, False))
    gp = LidarGaussianProcess2D(setting, dtype=np.float32, device="cpu")
    gp._graphs = SensorGraphs("cpu")
    assert gp.train(np.eye(2), np.zeros(2), f.ranges)
    a = np.random.default_rng(3).uniform(-np.pi, np.pi, 3000)
    return gp, a, np.full(4, 3.1)


@pytest.mark.parametrize("kind", ["lidar", "2d"])
def test_a_graphed_test_counts_one_routed_replay(eager_graphs, kind):
    """One ``test`` on a graphed model (the 3D lidar GP, the 2D lidar GP)
    counts exactly one ``bank.routed_graphed`` and no
    ``bank.routed_eager``, and replays its graph once; a test that
    answers no query counts neither."""
    if kind == "2d":
        dev, d, outside = _lidar_2d_graphed()
    else:
        dev = _models("lidar", np.float32)[1]
        d = _directions("lidar", 3000, 3)
        outside = np.tile([[0.0, 0.0, 1.0]], (4, 1))
    for k in range(3):
        before = timing.counters()
        dev.test(d, True, False)
        after = timing.counters()
        assert after.get("bank.routed_graphed", 0) \
            - before.get("bank.routed_graphed", 0) == 1
        assert after.get("bank.routed_eager", 0) \
            == before.get("bank.routed_eager", 0)
    (g,) = [g for g in eager_graphs if g.key[1] == "chunked"]
    assert g.replays == 3
    before = timing.counters()
    res = dev.test(outside, True, False)
    assert not res._valid.any()
    assert timing.counters() == before


def test_the_grouping_takes_no_bucket_from_the_data():
    """The host grouping's bucket follows the queries; the device rows do
    not: two query sets of one count, one spread and one on a single
    member, give the host two buckets and the device one shape."""
    key_a = np.arange(2000) % 30
    key_b = np.zeros(2000, np.int64)
    trained = np.ones(30, bool)
    shapes = {group_queries(k, trained)[1].shape for k in (key_a, key_b)}
    assert len(shapes) == 2
    rows = {tuple(group_chunks(torch.as_tensor(k), 30, ROUTE_CHUNK)[0].shape)
            for k in (key_a, key_b)}
    assert rows == {(chunk_rows(2000, 30, ROUTE_CHUNK), ROUTE_CHUNK)}
