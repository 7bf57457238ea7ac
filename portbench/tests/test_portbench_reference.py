"""The plain references of ``portbench/reference`` held against the port at
a CPU test's size: the same inputs, the port's model through its public
API (float32, as the configurations state), the reference in float64."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import range_gp3d, spgp_map3d, worlds


def test_raycaster_hits_the_box_walls():
    tris = worlds.box_triangles([-1.0, -2.0, -3.0], [1.0, 2.0, 3.0])
    d = np.eye(3)
    r = worlds.cast_rays(tris, np.zeros(3), np.concatenate([d, -d]))
    np.testing.assert_allclose(r, [1, 2, 3, 1, 2, 3], rtol=0, atol=1e-12)
    assert np.isinf(worlds.cast_rays(tris, [5.0, 0, 0], [[1.0, 0, 0]]))[0]


def test_seed_schedule_is_frozen():
    # the map's per-pose generator seeds: a change here changes every draw
    assert worlds.step_seed(0, 1) == worlds.step_seed(2**64, 1)
    assert worlds.step_seed(7, 1) != worlds.step_seed(7, 2)
    assert worlds.step_seed(12345, 3) == int(np.random.SeedSequence(
        [12345, 3]).generate_state(1, np.uint64)[0])


def test_far_point_padding_is_exact():
    p = np.random.default_rng(0).uniform(-5, 5, (10, 3)).astype(np.float32)
    padded = spgp_map3d.pad_pseudo(p, 8)
    assert padded.shape == (16, 3)
    k = spgp_map3d.matern32(torch.as_tensor(padded).double(),
                            torch.as_tensor(padded).double(), 1.5)
    assert torch.equal(k[10:, 10:], torch.eye(6, dtype=torch.float64))
    assert torch.all(k[:10, 10:] == 0)


def _hotel0_cell(tiny, traffic=None, seed=123):
    from portbench.adapters import spgp_map3d as adapter
    from portbench.harness import ROOT

    spec, cache = tiny("hotel0.stream", traffic)
    cell = adapter.Cell(spec["config"], spec["traffic"], seed, "cpu", ROOT,
                        cache)
    return cell


def test_map_reference_agrees_with_the_port(tiny):
    cell = _hotel0_cell(tiny, "plan")
    cell.start_session(0)
    for k in range(cell.n):
        cell.update(k)
        cell.query(k)
    got = cell.collect()
    want = cell.replay(got)
    assert np.array_equal(got["used"], want["used"])
    assert got["used"].min() > 0
    assert np.linalg.norm(got["qm"] - want["qm"]) \
        < 1e-5 * np.linalg.norm(want["qm"])
    assert np.linalg.norm(got["alpha"] - want["alpha"]) \
        < 1e-5 * np.linalg.norm(want["alpha"])
    own = cell.own_state(got["answers"])
    for i, (m_ref, g_ref) in own.items():
        m, g = got["answers"][i][:2]
        np.testing.assert_allclose(m, m_ref, atol=1e-4 * np.abs(m_ref).max())
        np.testing.assert_allclose(g, g_ref, atol=1e-4 * np.abs(g_ref).max())
    # the replay's own predictions at the last pose agree too, at this size
    last = max(got["answers"])
    np.testing.assert_allclose(got["answers"][last][0],
                               want["answers"][last][0],
                               atol=1e-4 * np.abs(want["answers"][last][0]).max())


def test_map_reference_gradient_is_the_mean_s_derivative(tiny):
    cell = _hotel0_cell(tiny, "plan")
    cell.start_session(0)
    cell.update(0)
    got = cell.collect()
    ref = spgp_map3d.MapReference(cell.scene["pseudo"], cell.scene["scale"],
                                  cell.cfg)
    ref.Q = torch.as_tensor(got["qm"])
    ref.alpha = torch.as_tensor(got["alpha"])
    x = cell.queries[0][:5].astype(np.float64)
    mean, grad = ref.predict(x)
    h = 1e-6
    for j in range(3):
        dx = np.zeros(3)
        dx[j] = h
        up, _ = ref.predict(x + dx)
        dn, _ = ref.predict(x - dx)
        np.testing.assert_allclose((up - dn) / (2 * h), grad[:, j],
                                   rtol=1e-5, atol=1e-7)


def _lidar_cell(tiny, traffic=None, seed=321):
    from portbench.adapters import range_gp3d as adapter
    from portbench.harness import ROOT

    spec, cache = tiny("lidar3d.query", traffic)
    return adapter.Cell(spec["config"], spec["traffic"], seed, "cpu", ROOT,
                        cache)


def test_range_gp_reference_agrees_with_the_port(tiny):
    cell = _lidar_cell(tiny)
    for k in range(cell.n):
        cell.update(k)
        cell.query(k)
    got = cell.collect()
    want = cell.replay(got)
    assert np.array_equal(got["count"], want["count"])
    assert (want["count"] > 0).sum() > 10
    for j in np.flatnonzero(want["count"] > 0):
        n = want["count"][j]
        np.testing.assert_allclose(got["alpha"][j, :n], want["alpha"][j, :n],
                                   rtol=1e-4, atol=1e-4 * np.abs(
                                       want["alpha"][j, :n]).max())
    for i, (r_ref, v_ref, ok_ref) in want["answers"].items():
        r, v, ok = got["answers"][i]
        assert np.array_equal(ok, ok_ref) and ok.sum() > 50
        np.testing.assert_allclose(r[ok], r_ref[ok], rtol=1e-4)
        np.testing.assert_allclose(v[ok], v_ref[ok], atol=1e-5)


def test_partitions_follow_the_reference_constructor():
    # the reference lidar frame: 271 x 91 rays, groups of 10, overlap 4
    az = np.linspace(-3 * math.pi / 4, 3 * math.pi / 4, 271)
    el = np.linspace(-math.pi / 2, math.pi / 2, 91)
    rows = range_gp3d.grid_partitions(az, 10, 4, 0)
    cols = range_gp3d.grid_partitions(el, 10, 4, 0)
    assert (len(rows), len(cols)) == (46, 16)
    assert max(b - a for a, b, _, _ in rows) == 10
    assert rows[0][:2] == (0, 5) and rows[-1][:2] == (266, 271)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scan_reference_alpha_solves_its_system(dtype):
    cfg = {"frame": {"valid_range_min": 0.0, "valid_range_max": None,
                     "azimuth_min": -1.0, "azimuth_max": 1.0,
                     "elevation_min": -0.5, "elevation_max": 0.5,
                     "num_azimuth_lines": 21, "num_elevation_lines": 11},
           "row_group_size": 10, "row_overlap_size": 4, "row_margin": 0,
           "col_group_size": 10, "col_overlap_size": 4, "col_margin": 0,
           "min_num_samples_per_group": 10, "sensor_range_var": 0.01,
           "kernel_scale": 0.3}
    layout = range_gp3d.Layout(cfg)
    ranges = np.random.default_rng(1).uniform(1, 3, (21, 11)).astype(
        np.float32)
    ranges[3, 4] = np.inf
    ref = range_gp3d.ScanReference(layout, ranges, dtype=dtype)
    x, r, m = layout.gather(ranges)
    b = int(np.flatnonzero(ref.trained)[0])
    n = ref.count[b]
    xb = torch.as_tensor(x[b, :n]).double()
    K = range_gp3d.ou(xb, xb, 0.3) + 0.01 * torch.eye(int(n), dtype=torch.float64)
    y = 1.0 / torch.sqrt(torch.as_tensor(r[b, :n]).double())
    tol = 1e-8 if dtype == torch.float64 else 1e-3
    np.testing.assert_allclose(
        (K @ ref.alpha[b, :n].double()).numpy(), y.numpy(), rtol=tol,
        atol=tol)
