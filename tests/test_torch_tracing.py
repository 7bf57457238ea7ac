"""The port's spans and counters (``erl_gaussian_process_tpu_torch/utils/
timing.py`` ``span`` and ``count``) on the CPU: with no profiler recording
a span opens no profiler range; under ``torch.profiler`` the map
update, the scan train, the routed test and the exact and noisy-input
GPs' fits and tests emit their spans nested as their layers are, on the
host path and on the graphed one; the routed test counts the path each
call took, the SPGP prepare the tier that served it, the jitter retry the
fits that escalated and the exact and noisy-input GPs the whitening of
each first variance read; and the
``profile=`` phases of ``bank_predict_assigned`` open and close at the
statements its spans do."""

import types

import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu_torch.models.batch_gp as batch_gp
from erl_gaussian_process_tpu_torch.geometry import Aabb
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
import erl_gaussian_process_tpu_torch.models.gp_core as gp_core
from erl_gaussian_process_tpu_torch.models import (
    NoisyInputGaussianProcess,
    NoisyInputGPSetting,
    RangeSensorGaussianProcess3D,
    RangeSensorGP3DSetting,
    SpGpOccupancyMap,
    SpGpOccupancyMapSetting,
    SpGpSetting,
    VanillaGaussianProcess,
    VanillaGPSetting,
)
from erl_gaussian_process_tpu_torch.models.exact_graph import ExactGraphs
from erl_gaussian_process_tpu_torch.models.sensor_graph import SensorGraphs
from erl_gaussian_process_tpu_torch.utils import timing
from test_torch_routed_chunks import _lidar_2d_graphed
from test_torch_spgp import _ill_conditioned_gp
from torch_graph_standin import eager_graphs  # noqa: F401 (fixture)

BANK_PHASES = ["egp.bank.group", "egp.bank.h2d", "egp.bank.predict",
               "egp.bank.readback", "egp.bank.scatter"]


def _map():
    """A CPU map over a 3 x 3 x 3 pseudo grid and one scan of a sphere
    shell seen from its centre: (map, sensor, points, mask)."""
    c = np.linspace(-1.5, 1.5, 3)
    pseudo = np.stack([a.ravel() for a in np.meshgrid(c, c, c,
                                                      indexing="ij")])
    setting = SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=3, scale=0.6),
                          max_num_samples=64),
        min_distance=0.05, max_distance=10.0, free_points_per_meter=2.0)
    m = SpGpOccupancyMap(setting, pseudo, Aabb.from_min_max([-2.0] * 3,
                                                            [2.0] * 3),
                         seed=3, free_slots_per_ray=4, device="cpu")
    d = np.random.default_rng(0).normal(size=(32, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return m, np.zeros(3), 1.5 * d, np.ones(32, bool)


def _lidar():
    """A CPU 3D range-sensor GP at 40 x 20 rays and one scan of a wavy
    room (tests/test_torch_sensor_graph.py's setting): (model, pose,
    ranges, query directions)."""
    gp = RangeSensorGaussianProcess3D(RangeSensorGP3DSetting.from_dict(dict(
        row_group_size=12, row_overlap_size=4, col_group_size=12,
        col_overlap_size=4, min_num_samples_per_group=10,
        sensor_range_var=1e-4,
        sensor_frame=dict(valid_range_min=0.1, valid_range_max=40.0,
                          azimuth_min=-np.pi, azimuth_max=np.pi,
                          elevation_min=-0.6, elevation_max=0.6,
                          num_azimuth_lines=40, num_elevation_lines=20),
        gp=dict(kernel_type="ou", kernel=dict(x_dim=2, scale=0.5)),
        mapping=dict(type="inverse_sqrt"))), dtype=np.float32, device="cpu")
    dirs = gp.sensor_frame.ray_directions_in_frame()
    az = np.arctan2(dirs[..., 1], dirs[..., 0])
    ranges = 5.0 + 0.5 * np.sin(3 * az)
    return gp, (np.eye(3), np.zeros(3)), ranges, dirs.reshape(-1, 3)[::3]


def _run_paths():
    """A map update and a predict (its SPGP prepare), a scan train and a
    routed test; returns the map and the test's valid flags."""
    m, sensor, pts, mask = _map()
    m.update(sensor, pts, mask)
    m.predict(pts[:4])
    gp, pose, ranges, queries = _lidar()
    assert gp.train(*pose, ranges)
    res = gp.test(queries, True, False)
    return m, res._valid


def _delta(before, name):
    return timing.counters().get(name, 0) - before.get(name, 0)


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(timing, "_RANGE", refuse)
    before = timing.counters()
    _, valid = _run_paths()
    assert valid.any()
    # the paths ran: the prepare and the routed test counted
    assert _delta(before, "spgp.prepare.tier1") == 1
    assert _delta(before, "bank.routed_eager") == 1
    assert timing.span("x") is timing.span("y")


def _host_spans(prof) -> dict:
    """name -> [(start, end)] of the program's spans in a CPU trace."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("egp."):
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_spans_nest_under_the_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run_paths()
    spans = _host_spans(prof)
    assert len(spans["egp.map.init"]) == 1
    assert len(spans["egp.spgp.prepare"]) == 1
    (update,) = spans["egp.map.update"]
    (inputs,) = spans["egp.map.inputs"]
    assert _inside(inputs, update)
    (train,) = spans["egp.rsgp.train"]
    (frame,) = spans["egp.rsgp.frame"]
    assert _inside(frame, train)
    (test,) = spans["egp.rsgp.test"]
    (route,) = spans["egp.rsgp.route"]
    phases = [route] + [spans[name][0] for name in BANK_PHASES]
    assert all(len(spans[name]) == 1 for name in BANK_PHASES)
    # the route, then the five phases in order, one after the other,
    # each inside the test
    assert all(_inside(p, test) for p in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))
    # no span is left open past the profiler's recording
    assert not timing._profiler._is_profiler_enabled


def test_routed_counters_count_by_path(eager_graphs):
    gp, pose, ranges, queries = _lidar()
    assert gp.train(*pose, ranges)
    before = timing.counters()
    gp.test(queries, True, False)
    gp.test(queries, True, False)
    assert _delta(before, "bank.routed_eager") == 2
    assert _delta(before, "bank.routed_graphed") == 0
    # with graphs (the CPU stand-in) each sensor GP's test is one replay
    gp._graphs = SensorGraphs("cpu")
    assert gp.train(*pose, ranges)
    gp2d, angles, _ = _lidar_2d_graphed()
    for m, q in ((gp, queries), (gp2d, angles)):
        before = timing.counters()
        assert m.test(q, True, False)._valid.any()
        assert _delta(before, "bank.routed_graphed") == 1
        assert _delta(before, "bank.routed_eager") == 0
    # a call that answers no query takes neither path
    before = timing.counters()
    batch_gp.bank_predict_assigned(gp.bank, np.zeros((3, 2), np.float32),
                                   np.full(3, -1), 0.5, kernel="ou")
    assert _delta(before, "bank.routed_graphed") == 0
    assert _delta(before, "bank.routed_eager") == 0


def test_prepare_counts_its_tier():
    m, sensor, pts, mask = _map()
    m.update(sensor, pts, mask)
    before = timing.counters()
    m.sp_gp._prepared()
    m.sp_gp._prepared()         # a hit counts nothing
    assert _delta(before, "spgp.prepare.tier1") == 1
    gp, _ = _ill_conditioned_gp()
    before = timing.counters()
    gp._prepared()
    assert _delta(before, "spgp.prepare.tier2") == 1
    assert _delta(before, "spgp.prepare.tier1") == 0
    assert _delta(before, "spgp.prepare.tier3") == 0


def test_counters_add_copy_and_reset():
    saved = timing.counters()
    try:
        timing.reset_counters()
        timing.count("a")
        timing.count("a", 2)
        timing.count("ms", 0.5)
        got = timing.counters()
        assert got == {"a": 3, "ms": 0.5}
        got["a"] = 0
        assert timing.counters()["a"] == 3
        timing.reset_counters()
        assert timing.counters() == {}
    finally:
        timing.reset_counters()
        for k, v in saved.items():
            timing.count(k, v)


def test_profile_phases_open_and_close_with_the_spans(monkeypatch):
    """Each ``profile=`` clock reading falls between spans, never inside
    one, and between two readings exactly that phase's spans open and
    close."""
    gp, pose, ranges, queries = _lidar()
    assert gp.train(*pose, ranges)
    coords, idx = gp.route_directions(queries)
    log, stack = [], []

    class Span:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            stack.append(self.name)
            log.append(self.name)

        def __exit__(self, *exc):
            stack.pop()

    def clock():
        assert not stack, f"a profile= clock read inside {stack}"
        log.append("clock")
        return float(len(log))

    monkeypatch.setattr(batch_gp, "span", Span)
    monkeypatch.setattr(batch_gp, "time",
                        types.SimpleNamespace(perf_counter=clock))
    profile = {}
    batch_gp.bank_predict_assigned(gp.bank, coords, idx, gp._scale,
                                   kernel=gp._kernel, profile=profile)
    assert set(profile) == {"host_group", "h2d", "device", "d2h_scatter",
                            "bucket"}
    assert len(profile["bucket"]) == 2
    assert log == ["clock", "egp.bank.group", "clock", "egp.bank.h2d",
                   "clock", "egp.bank.predict", "clock", "egp.bank.readback",
                   "egp.bank.scatter", "clock"]


def test_graphed_test_spans_keep_their_order(eager_graphs):
    """The device-routed test (graphs through the CPU stand-in) under the
    profiler: the route, then the five phases in order, each inside the
    test, as on the host path; the copy in holds the graph's feed from the
    second test on."""
    gp, pose, ranges, queries = _lidar()
    gp._graphs = SensorGraphs("cpu")
    assert gp.train(*pose, ranges)
    gp.test(queries, True, False)           # the capture
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = gp.test(queries, True, False)
    assert res._valid.any()
    spans = _host_spans(prof)
    (test,) = spans["egp.rsgp.test"]
    (route,) = spans["egp.rsgp.route"]
    assert all(len(spans[name]) == 1 for name in BANK_PHASES)
    phases = [route] + [spans[name][0] for name in BANK_PHASES]
    assert all(_inside(p, test) for p in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))
    (feed,) = spans["egp.graph.feed"]
    assert _inside(feed, spans["egp.bank.h2d"][0])


@pytest.mark.parametrize("name", ["egp.map.update", "egp.bank.group"])
def test_span_records_under_the_profiler(name):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.span(name):
            torch.ones(4).sum()
    assert name in _host_spans(prof)


def _exact_gp(n=48, dtype=np.float64):
    """A CPU exact GP on n samples of a 2D surface: (model, queries)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, n))
    gp = VanillaGaussianProcess(VanillaGPSetting(
        kernel_type="rbf", kernel=KernelSetting(x_dim=2, scale=0.4),
        max_num_samples=n), dtype=dtype, device="cpu")
    assert gp.train(x, np.sin(3 * x[0]) * np.cos(3 * x[1]), 1e-3)
    return gp, x, rng.uniform(-1, 1, (2, 20))


def _run_exact(gp, x, xq):
    """A fit, ``train()`` refused after it, a test read back."""
    gp.train(x, np.cos(2 * x[0]), 1e-3)
    gp.train()
    res = gp.test(xq)
    return res.get_mean(0), res.get_variance()


@pytest.mark.parametrize("graphed", [False, True])
def test_exact_spans_nest_under_the_profiler(eager_graphs, graphed):
    gp, x, xq = _exact_gp()
    if graphed:
        gp._graphs = ExactGraphs("cpu")
        _run_exact(gp, x, xq)           # the captures
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run_exact(gp, x, xq)
    spans = _host_spans(prof)
    trains = spans["egp.exact.train"]
    assert len(trains) == 2             # train(x, y, var) and train()
    (inputs,) = spans["egp.exact.inputs"]
    (check,) = spans["egp.fit.check"]
    assert _inside(inputs, trains[0]) and _inside(check, trains[0])
    assert inputs[1] <= check[0]
    (test,) = spans["egp.exact.test"]
    (mean,) = spans["egp.exact.mean"]
    (var,) = spans["egp.exact.variance"]
    assert trains[1][1] <= test[0] and test[1] <= mean[0] \
        and mean[1] <= var[0]
    reads = sorted(spans["egp.exact.readback"])
    assert len(reads) == 2
    assert _inside(reads[0], mean) and _inside(reads[1], var)
    # the fit, the test and the variance were replays on the graphed path
    assert sum(g.replays for g in eager_graphs) == (6 if graphed else 0)
    assert not timing._profiler._is_profiler_enabled


def test_exact_path_opens_no_range_without_a_profiler(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(timing, "_RANGE", refuse)
    gp, x, xq = _exact_gp()
    mean, var = _run_exact(gp, x, xq)
    assert np.isfinite(mean).all() and np.isfinite(var).all()


def test_fit_jitter_counts_fits_that_escalated():
    def fit(bad):
        def once(j):
            return torch.tensor(np.nan if j < bad else 1.0)
        return once

    before = timing.counters()
    for bad in (0.0, 0.0, 1e-8, 1.0):   # clean, clean, two rungs, all fail
        gp_core.host_jitter_retry(fit(bad), lambda a: (a,))
    assert _delta(before, "fit.jitter") == 2
    # a float32 fit at no noise over duplicated points escalates
    x = np.repeat(np.linspace(-1, 1, 8), 8)[None]
    gp = VanillaGaussianProcess(VanillaGPSetting(
        kernel_type="rbf", kernel=KernelSetting(x_dim=1, scale=0.5),
        max_num_samples=64), dtype=np.float32, device="cpu")
    before = timing.counters()
    assert gp.train(x, np.sin(x[0]), 0.0)
    assert _delta(before, "fit.jitter") == 1
    assert np.isfinite(gp.state.alpha.numpy()).all()


def test_variance_counters_name_the_whitening(eager_graphs):
    for graphed in (False, True):
        gp, x, xq = _exact_gp()
        if graphed:
            gp._graphs = ExactGraphs("cpu")
            _run_exact(gp, x, xq)
        wide = np.tile(xq, (1, 30))      # 600 queries
        before = timing.counters()
        gp.train(x, np.cos(2 * x[0]), 1e-3)
        gp.test(xq).get_variance()       # the first query solves
        res = gp.test(xq)
        res.get_variance()               # a thin second one multiplies
        res.get_variance()               # a result read again counts nothing
        gp.test(wide).get_variance()     # a wide one solves
        assert _delta(before, "exact.var_solve") == 2
        assert _delta(before, "exact.var_product") == 1
        gp.test(xq).get_mean(0)          # a mean alone counts neither
        assert _delta(before, "exact.var_solve") == 2


def _nigp(n=24, dtype=np.float64):
    """A CPU noisy-input GP on n samples of a 2D surface and its gradient:
    (model, samples, queries)."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, n))
    gp = NoisyInputGaussianProcess(NoisyInputGPSetting(
        kernel_type="rbf", kernel=KernelSetting(x_dim=2, scale=0.4),
        max_num_samples=n), dtype=dtype, device="cpu")
    return gp, x, rng.uniform(-1, 1, (2, 12))


def _run_nigp(gp, x, xq):
    """A fit with gradients, ``train()`` refused after it, a test with
    gradients read back in its five answers."""
    y = np.sin(2 * x[0]) * np.cos(x[1])
    grad = np.stack([2 * np.cos(2 * x[0]) * np.cos(x[1]),
                     -np.sin(2 * x[0]) * np.sin(x[1])])
    assert gp.train(x, y, grad, 1e-3, 1e-3, 1e-3)
    gp.train()
    res = gp.test(xq, predict_gradient=True)
    return (res.get_mean(0), res.get_gradient(0), res.get_mean_variance(),
            res.get_gradient_variance(), res.get_covariance())


@pytest.mark.parametrize("graphed", [False, True])
def test_nigp_spans_nest_under_the_profiler(eager_graphs, graphed):
    gp, x, xq = _nigp()
    if graphed:
        gp._graphs = ExactGraphs("cpu")
        _run_nigp(gp, x, xq)            # the captures
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run_nigp(gp, x, xq)
    spans = _host_spans(prof)
    trains = spans["egp.nigp.train"]
    assert len(trains) == 2             # train(x, ...) and train()
    (inputs,) = spans["egp.nigp.inputs"]
    (check,) = spans["egp.fit.check"]
    assert _inside(inputs, trains[0]) and _inside(check, trains[0])
    assert inputs[1] <= check[0]
    (test,) = spans["egp.nigp.test"]
    (mean,) = spans["egp.nigp.mean"]
    (grad,) = spans["egp.nigp.gradient"]
    (var,) = spans["egp.nigp.variance"]   # the first of three reads
    assert trains[1][1] <= test[0] and test[1] <= mean[0] \
        and mean[1] <= grad[0] and grad[1] <= var[0]
    reads = sorted(spans["egp.nigp.readback"])
    assert len(reads) == 3
    assert _inside(reads[0], mean) and _inside(reads[1], grad) \
        and _inside(reads[2], var)
    # the fit, the test and the variance were replays on the graphed path
    assert sum(g.replays for g in eager_graphs) == (6 if graphed else 0)
    assert not timing._profiler._is_profiler_enabled


def test_nigp_path_opens_no_range_without_a_profiler(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(timing, "_RANGE", refuse)
    gp, x, xq = _nigp()
    for a in _run_nigp(gp, x, xq):
        assert np.isfinite(a).all()


def test_nigp_variance_counters_count_first_reads(eager_graphs):
    for graphed in (False, True):
        gp, x, xq = _nigp()
        if graphed:
            gp._graphs = ExactGraphs("cpu")
            _run_nigp(gp, x, xq)
        wide = np.tile(xq, (1, 50))      # 600 queries, 1800 columns
        before = timing.counters()
        _run_nigp(gp, x, xq)             # the first query solves
        res = gp.test(xq, predict_gradient=True)
        res.get_mean_variance()          # a thin second one multiplies
        res.get_gradient_variance()      # reads of one result count once
        res.get_covariance()
        gp.test(wide, predict_gradient=True).get_covariance()   # solves
        assert _delta(before, "nigp.var_solve") == 2
        assert _delta(before, "nigp.var_product") == 1
        res = gp.test(xq, predict_gradient=True)
        res.get_mean(0)                  # a mean and a gradient alone
        res.get_gradient(0)              # count neither
        assert _delta(before, "nigp.var_solve") == 2
        assert _delta(before, "nigp.var_product") == 1
