"""The readers of the program's spans and counters on a hand-made trace
and hand-made counts: the spans that start inside the slice, clipped to
it; self time less the program's spans inside; the base of each ratio;
and nothing, without an error, from a program that records neither."""

import importlib.util
import os

import pytest

from portbench import harness
from portbench.trace import Trace, WINDOW_SPAN


class _Event:
    def __init__(self, name, start, end):
        self._n, self._s, self._e = name, start, end

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def activity_type(self):
        return "user_annotation"


def _reader(name):
    path = os.path.join(harness.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(events, updates=0, queries=0, window_updates=0):
    ctx = harness.Ctx(None, {"updates": window_updates, "seconds": 1.0,
                             "latencies": []})
    ctx.trace = Trace([_Event(WINDOW_SPAN, 1_000, 101_000)]
                      + [_Event(*e) for e in events])
    ctx.traced = {"updates": updates, "queries": queries, "latencies": [],
                  "seconds": 1e-4, "launches": {}}
    return ctx


def test_span_sums_are_clipped_to_the_slice():
    ctx = _ctx([
        ("egp.map.update", 0, 3_000),           # starts before: left out
        ("egp.map.update", 10_000, 20_000),
        ("egp.map.inputs", 10_000, 12_000),     # a child: inside the parent
        ("egp.map.update", 95_000, 105_000),    # clipped to 101 000
        ("portbench.update", 9_000, 21_000),    # the harness's own
        ("egp.rsgp.train", 30_000, 38_000),
    ], updates=4)
    assert _reader("map_update_host_ms").read(ctx) == pytest.approx(
        1e-6 * (10_000 + 6_000) / 4)
    assert _reader("scan_train_host_ms").read(ctx) == pytest.approx(
        1e-6 * 8_000 / 4)


def test_routed_test_self_and_copy_times():
    ctx = _ctx([
        ("egp.rsgp.test", 2_000, 40_000),
        ("egp.rsgp.route", 2_000, 10_000),
        ("aten::where", 3_000, 9_000),          # an operator: its own work
        ("egp.bank.group", 10_000, 16_000),
        ("egp.bank.h2d", 16_000, 20_000),
        ("egp.graph.feed", 17_000, 19_000),
        ("egp.bank.predict", 20_000, 24_000),
        ("egp.bank.readback", 24_000, 30_000),
        ("egp.bank.scatter", 30_000, 40_000),
        # a scatter whose children overlap, one inside another, and a
        # span past its end: 20 000 - (6 000 + 1 000) of its own
        ("egp.bank.scatter", 50_000, 70_000),
        ("egp.x", 52_000, 58_000),
        ("egp.y", 53_000, 55_000),
        ("egp.z", 57_000, 59_000),
        ("egp.w", 69_000, 80_000),
    ], queries=2)
    own = 8_000 + 6_000 + 10_000 + (20_000 - 7_000)
    assert _reader("routed_test_host_ms").read(ctx) == pytest.approx(
        1e-6 * own / 2)
    assert _reader("routed_test_copy_ms").read(ctx) == pytest.approx(
        1e-6 * (4_000 + 6_000) / 2)


def test_span_readers_read_nothing_without_spans():
    ctx = _ctx([("portbench.update", 2_000, 9_000),
                ("portbench.query", 9_000, 20_000)], updates=3, queries=3)
    for name in ("map_update_host_ms", "scan_train_host_ms",
                 "routed_test_host_ms", "routed_test_copy_ms"):
        assert _reader(name).read(ctx) is None
    ctx = _ctx([("egp.map.update", 2_000, 9_000)])     # no updates
    assert _reader("map_update_host_ms").read(ctx) is None


def test_counter_readers_count_over_the_window_and_the_slice():
    from erl_gaussian_process_tpu_torch.utils import timing

    share = _reader("routed_graphed_share")
    capture = _reader("graph_capture_ms_per_kupdate")
    ctx = _ctx([], updates=100, window_updates=1900)
    timing.count("bank.routed_eager", 5)    # before install: not counted
    timing.count("graph.capture_ms", 40.0)
    share.install(ctx)
    capture.install(ctx)
    assert share.read(ctx) is None          # no routed call yet
    assert capture.read(ctx) == 0.0
    timing.count("bank.routed_graphed", 1)
    timing.count("bank.routed_eager", 3)
    timing.count("graph.capture_ms", 12.0)
    assert share.read(ctx) == pytest.approx(25.0)
    # 12 ms over 1900 + 100 updates
    assert capture.read(ctx) == pytest.approx(6.0)


def test_counter_readers_read_nothing_without_counters(monkeypatch):
    from erl_gaussian_process_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "counters")
    ctx = _ctx([], updates=10, window_updates=10)
    for name in ("routed_graphed_share", "graph_capture_ms_per_kupdate"):
        r = _reader(name)
        r.install(ctx)
        assert r.read(ctx) is None
