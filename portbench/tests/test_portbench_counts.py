"""The yardstick's arithmetic at the cells' shapes (``portbench/work.py``),
and the reduction of a trace (``portbench/trace.py``) on a hand-made one:
busy time, annotations, host calls, idle gaps, and a trace that lost
kernels made visible."""

import importlib.util
import os

import pytest

from portbench import harness, work
from portbench.trace import Trace, WINDOW_SPAN


def test_fitc_counts_at_the_hotel0_shape():
    m, n, d = 1152, 2000, 3
    flops = (m * n * (3 * d + 4) + m * (m + 1) * n + (2 * m * n + 3 * n
             + m * n) + m * (m + 1) * n + 2 * m * n)
    assert work.fitc_flops(m, n, d) == flops == 5_354_502_000
    read = 4 * (m * d + m * (m + 1) // 2 + n * (d + 2)) + n
    assert work.fitc_bytes(m, n, d) == read + 4 * (m * m + m) == 8_025_360
    assert work.fitc_flops(m, n, d) == work.fitc_flops(m, n, d)
    # compute-bound at this shape: 10.8 us at the TF32 peak
    assert work.least_seconds(work.fitc_flops(m, n, d),
                              work.fitc_bytes(m, n, d)) \
        == pytest.approx(5_354_502_000 / 495e12)


def test_bank_fit_counts_at_the_lidar_shape():
    assert work.bank_fit_bytes(736, 100, 2) == 736 * 100 * 17 \
        + 4 * 736 * (2 * 100 * 100 + 100) == 60_425_600
    assert work.bank_fit_flops([100, 0], 2) == pytest.approx(
        8 * 100 ** 2 + 2 * 100 ** 3 / 3 + 2 * 100 ** 2)
    # bytes-bound: the padded L and L^-1 written
    assert work.least_seconds(work.bank_fit_flops([100] * 736, 2),
                              work.bank_fit_bytes(736, 100, 2)) \
        == pytest.approx(60_425_600 / 3.35e12)


def test_routed_counts():
    assert work.routed_gram_flops([50, 60], 2) == 110 * 8
    assert work.routed_gram_bytes([50, 60], [50, 60], 2) \
        == 4 * (2 * 2 + 110 * 2 + 110)
    assert work.routed_test_flops([10], 2) == 8 * 10 + 20 + 110 + 20


class _Event:
    def __init__(self, name, dev, start, end, kind="kernel"):
        self._n, self._d, self._s, self._e, self._k = name, dev, start, end, kind

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def activity_type(self):
        return self._k


def _trace():
    return Trace([
        _Event(WINDOW_SPAN, "CPU", 0, 1000, "user_annotation"),
        _Event("portbench.update", "CPU", 0, 500, "user_annotation"),
        _Event("portbench.update", "CUDA", 100, 900, "gpu_user_annotation"),
        _Event("cudaGraphLaunch", "CPU", 10, 20, "cuda_runtime"),
        _Event("cudaStreamSynchronize", "CPU", 900, 1000, "cuda_runtime"),
        _Event("aten::copy_", "CPU", 550, 700),
        _Event("void egp::kmn_kernel<float>(float const*)", "CUDA", 100, 200),
        _Event("void egp::beta_tc_kernel(float const*)", "CUDA", 150, 300),
        _Event("Memcpy HtoD", "CUDA", 800, 900, "gpu_memcpy"),
        _Event("void egp::kmn_kernel<float>(float const*)", "CUDA", 2000,
               2100),
    ])


def test_trace_reduction():
    t = _trace()
    assert t.window_s == pytest.approx(1e-6)
    # the kernels' union (100-300) and the copy (800-900), not the
    # annotation's mirror on the device, nor a kernel past the window
    assert t.busy_s == pytest.approx(300e-9)
    assert t.kernel_count(work.KERNELS["fitc"][0]) == 2
    assert t.kernel_seconds(("kmn_kernel",)) == pytest.approx(100e-9)
    assert t.runtime_calls() == 1
    assert dict(t.device_ops())["egp::beta_tc_kernel"] == pytest.approx(
        150e-9)
    gaps = dict(t.idle_gaps())
    assert gaps["portbench.update"] == pytest.approx(100e-9)    # 0-100
    assert gaps["aten::copy_"] == pytest.approx(500e-9)         # 300-800
    assert gaps["(none)"] == pytest.approx(100e-9)              # 900-1000


def _reader(name):
    path = os.path.join(harness.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Cell:
    recording = None

    def fitc_shapes(self):
        return [(1152, 2000, 3)]


def test_a_trace_that_lost_kernels_is_reported():
    ctx = harness.Ctx(_Cell(), {"updates": 1, "seconds": 1.0,
                                "latencies": []})
    ctx.trace = _trace()
    ctx.traced = {"updates": 1, "queries": 0, "latencies": [],
                  "seconds": 1e-6, "launches": {"fitc": 1}}
    assert _reader("fitc_roofline").read(ctx) > 0
    assert _reader("device_idle.update").read(ctx) == pytest.approx(70.0)
    assert len(ctx.warnings) == 2 and all(
        "2 " in w and "3 launched" in w for w in ctx.warnings)
