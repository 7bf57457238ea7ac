"""The benchmark's noisy-input GP configuration (``portbench/configs/
nigp7680.json``) on the CPU at a small size (128 samples with gradients on
a patch of the domain as dense as the cell's, a 12 x 12 grid): the port's
``NoisyInputGaussianProcess`` against the plain reference
(``portbench/reference/noisy_input_gp.py``) in its five answers, the
cells' check passing on an unbroken run and failing on each fault it
exists to catch (a perturbed alpha, a perturbed factor, a fit that took a
jitter, answers served by the previous set's fit, a fit on half of the
samples, a fit without the gradient observations, the TF32 control), the
adapter's warm-up capturing every graph the window replays (through the
eager stand-in for the capture), and the yardstick's counts and the new
readers' arithmetic."""

import os
import sys
import time

import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu_torch.models.noisy_input_gp as nigp
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import (
    NoisyInputGaussianProcess,
    NoisyInputGPSetting,
)
from erl_gaussian_process_tpu_torch.models.exact_graph import ExactGraphs
from torch_graph_standin import eager_graphs  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import exact_work, harness, nigp_work, work  # noqa: E402
from portbench.adapters import noisy_input_gp as adapter  # noqa: E402
from portbench.reference import noisy_input_gp as ref  # noqa: E402
from portbench.trace import WINDOW_SPAN, Trace  # noqa: E402

CELLS = ("nigp7680.fit", "nigp7680.query")
# 128 samples on 0.5 of the domain's 8 units^2: 256 a unit^2, the cell's
# 2500 / 8 = 312 a unit^2 near enough that the scale-0.1 gram is as coupled
SMALL = {"samples": 128, "pool": 4, "test_grid": 12,
         "domain": [[-0.5, 0.5], [-0.25, 0.25]]}
SEEDS = (4_000_000_123, 2_718_281_828)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small tensors here run ~50x slower when
    torch's pool spins on a shared host, as the benchmark's runs set it
    (``portbench/env.py``); the earlier count restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small_spec(workload: str) -> dict:
    spec = harness.cell_spec(workload)
    spec["config"] = dict(spec["config"], **SMALL)
    if "query" in spec["traffic"]:
        spec["traffic"] = dict(spec["traffic"],
                               query=dict(spec["traffic"]["query"],
                                          grid=SMALL["test_grid"]))
    return spec


def _run(workload, tmp_path, seed=SEEDS[0], control=False):
    return harness.run_cell(_small_spec(workload), seed, 0.3, False, "cpu",
                            time.perf_counter(),
                            cache_dir=str(tmp_path / "cache"),
                            control=control)


def _failed(nums: dict, workload: str) -> list:
    limits = harness.cell_spec(workload)["limits"]
    return [k for k, v in nums.items() if not v <= limits[k]]


def _model(cfg, dtype):
    return NoisyInputGaussianProcess(
        NoisyInputGPSetting(kernel_type="rbf",
                            kernel=KernelSetting(x_dim=2,
                                                 scale=cfg["kernel_scale"]),
                            max_num_samples=cfg["samples"]),
        dtype=np.dtype(dtype), device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_port_agrees_with_the_reference(dtype, seed):
    cfg = dict(harness.cell_spec(CELLS[0])["config"],
               **dict(SMALL, pool=1, pool_seed=seed % 2**32))
    pool = adapter.make_inputs(cfg)
    x, y, g = pool["x"][0], pool["y"][0], pool["grad"][0]
    grid = ref.grid(cfg["test_grid"], cfg["domain"]).astype(np.float32)
    gp = _model(cfg, dtype)
    assert gp.train(x.T, y, g.T, cfg["var_x"], cfg["var_y"],
                    cfg["var_grad"], np.ones(len(y), bool))
    res = gp.test(grid.T, predict_gradient=True)
    got = (res.get_mean(0), res.get_gradient(0), res.get_mean_variance(),
           res.get_gradient_variance(), res.get_covariance())
    fit = ref.FitReference(x, y, g, cfg["var_x"] + cfg["var_y"],
                           cfg["var_grad"], cfg["kernel_scale"])
    want = fit.predict(grid)
    gaps = {name: float(np.abs(a - b).max())
            for name, a, b in zip(adapter.ANSWERS, got, want)}
    if dtype == "float64":
        # relative to each answer's scale: gradients reach 20 and their
        # prior variance is 3 / 0.1^2 = 300
        rel = {name: gaps[name] / max(1.0, float(np.abs(b).max()))
               for name, b in zip(adapter.ANSWERS, want)}
        assert max(rel.values()) < 1e-10, rel
        assert np.abs(gp.state.L.numpy() - fit.L.numpy()).max() < 1e-10
    else:
        limits = harness.cell_spec(CELLS[1])["limits"]
        assert all(v <= limits[k] for k, v in gaps.items()), (gaps, limits)
        assert ref.backward_rel(gp.state.L, x, cfg["var_x"] + cfg["var_y"],
                                cfg["var_grad"], cfg["kernel_scale"]) \
            <= harness.cell_spec(CELLS[0])["limits"]["backward_rel"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_unbroken_run_is_correct(tmp_path, workload, seed):
    out = _run(workload, tmp_path, seed)
    assert out["failed"] == 0 and out["correct"], out["checks"]
    assert out["checks"]["jitter_fits"]["value"] == 0
    want = {"jitter_fits", "backward_rel", "mean_gap", "grad_gap"} \
        if "fit" in workload else {"jitter_fits", *adapter.ANSWERS}
    assert set(out["checks"]) == want


def _alpha_perturbed(mp):
    real = nigp.nigp_fit

    def perturbed(*a, **k):
        st = real(*a, **k)
        alpha = st.alpha.clone()
        alpha[int(alpha.abs().argmax())] *= 1.1
        return st._replace(alpha=alpha)
    mp.setattr(nigp, "nigp_fit", perturbed)


def _factor_perturbed(mp):
    real = nigp.nigp_fit

    def perturbed(*a, **k):
        st = real(*a, **k)
        L = st.L.clone()
        L[-1, 0] += 0.1
        return st._replace(L=L)
    mp.setattr(nigp, "nigp_fit", perturbed)


def _jittered(mp):
    """Each fit's first try comes back non-finite, so the retry adds a
    jitter to the noise."""
    real = nigp.host_jitter_retry

    def retry(fit_once, check_arrays):
        def first_fails(j):
            st = fit_once(j)
            return st._replace(alpha=torch.full_like(st.alpha, np.nan)) \
                if j == 0 else st
        return real(first_fails, check_arrays)
    mp.setattr(nigp, "host_jitter_retry", retry)


def _stale(mp):
    """Each fit takes the training set of the call before it, so the model
    answers from the previous set's fit."""
    real = NoisyInputGaussianProcess.train
    held = {}

    def lagged(self, *args):
        before = held.get(id(self), args)
        held[id(self)] = args
        return real(self, *before)
    mp.setattr(NoisyInputGaussianProcess, "train", lagged)


def _half(mp):
    """Each fit keeps only the first half of its samples."""
    real = NoisyInputGaussianProcess.train

    def halved(self, x, y, grad, var_x, var_y, var_grad, flags):
        n = len(y) // 2
        return real(self, x[:, :n], y[:n], grad[:, :n], var_x, var_y,
                    var_grad, flags[:n])
    mp.setattr(NoisyInputGaussianProcess, "train", halved)


def _no_gradient(mp):
    """Each fit flags no sample's gradient: the value observations
    alone."""
    real = NoisyInputGaussianProcess.train

    def values_only(self, x, y, grad, var_x, var_y, var_grad, flags):
        return real(self, x, y, grad, var_x, var_y, var_grad,
                    np.zeros_like(flags))
    mp.setattr(NoisyInputGaussianProcess, "train", values_only)


FAULTS = (_alpha_perturbed, _factor_perturbed, _jittered, _stale, _half,
          _no_gradient)
CASES = [(w, f) for w in CELLS for f in FAULTS]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in CASES])
def test_broken_run_is_not_correct(tmp_path, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = _run(workload, tmp_path)
    assert out["failed"] == 0 and not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_fails_the_check(tmp_path, workload):
    out = _run(workload, tmp_path, control=True)
    assert out["correct"], out["checks"]
    assert _failed(out["control_numbers"], workload), out["control_numbers"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_warm_up_captures_every_graph(tmp_path, eager_graphs, workload):
    spec = _small_spec(workload)
    cell = adapter.Cell(spec["config"], spec["traffic"], SEEDS[1], "cpu",
                        ROOT, str(tmp_path / "cache"))
    cell.gp._graphs = ExactGraphs("cpu")
    cell.warm()
    made = len(eager_graphs)
    assert made == (1 if "fit" in workload else 3)   # fit [, test, variance]
    assert cell.joint_rows == 3 * SMALL["samples"]
    for k in range(2 * cell.n):
        cell.update(k)
        if cell.queries is not None:
            cell.query(k)
    assert len(eager_graphs) == made
    got = cell.collect()
    assert got["captures"] == 0 and got["jitter_fits"] == 0
    assert cell.diagnose(got)["captures_after_warmup"] == 0


def test_the_check_reads_the_padded_system_by_its_active_rows(tmp_path):
    """At float32 the model pads 2500 samples to 2560 (a 7680-row joint
    system); the check takes the rows that hold samples, in the
    reference's order."""
    spec = _small_spec(CELLS[0])
    cell = adapter.Cell(spec["config"], spec["traffic"], SEEDS[0], "cpu",
                        ROOT, str(tmp_path / "cache"))
    cell.cfg = dict(cell.cfg, samples=2500)
    idx = cell._active(7680)
    assert len(idx) == 7500
    assert (idx[:2500] == np.arange(2500)).all()
    assert idx[2500] == 2560 and idx[5000] == 5120 and idx[-1] == 7619


def test_counts_at_the_cells_shape():
    n, m, d = 2500, 10_000, 2
    big = 3 * n
    assert nigp_work.joint_rows(n, d) == 7500
    tri = n * (n + 1) // 2
    gram = tri * 8 + 2 * n * n * 2 + (n * n + 2 * tri) * 3
    assert nigp_work.chol_joint_flops(n, d) == pytest.approx(
        gram + big + big ** 3 / 3)
    assert nigp_work.chol_joint_bytes(n, d) == 4 * n * 4 + 2 * n \
        + 4 * (big * (big + 1) // 2 + 118 * 64 * 64)
    assert nigp_work.nigp_fit_flops(n, d) == pytest.approx(
        nigp_work.chol_joint_flops(n, d) + 2 * big * big)
    # a pair block: 8 + 4 x 2 + 4 x 3
    assert nigp_work.cross_entry_flops(d) == 28
    cols = 3 * m
    assert nigp_work.nigp_query_flops(n, m, d) == n * m * 28 \
        + 2 * big * cols + big * big * cols + (2 * big + 1) * cols \
        + 3 * m * 2 * big
    # the padded system the kernels factor: 120 tiles
    assert exact_work.chol_kernels(7680) == 3 * 120 - 1
    # the factorization is compute-bound: 0.28 ms at the TF32 peak
    least = work.least_seconds(nigp_work.chol_joint_flops(n, d),
                               nigp_work.chol_joint_bytes(n, d))
    assert least == pytest.approx(nigp_work.chol_joint_flops(n, d) / 495e12)
    assert 2.8e-4 < least < 2.9e-4


class _Event:
    def __init__(self, name, dev, start, end):
        self._n, self._d, self._s, self._e = name, dev, start, end

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def activity_type(self):
        return "kernel"


def _reader(name):
    return harness.load_file_module(
        os.path.join(harness.HERE, "metrics", name + ".py"),
        "m_" + name.replace(".", "_"))


class _Ctx:
    def __init__(self, trace, updates=0, queries=0, cell=None, launches=None):
        self.trace, self.cell = trace, cell
        self.traced = {"updates": updates, "queries": queries,
                       "launches": launches or {}}
        self.window = {"updates": 0, "seconds": 0.0}
        self.warnings = []

    def warn(self, msg):
        self.warnings.append(msg)


def test_span_time_less_nested_spans():
    t = Trace([_Event(WINDOW_SPAN, "CPU", 0, 1000),
               _Event("egp.nigp.train", "CPU", 0, 400),
               _Event("egp.nigp.inputs", "CPU", 10, 60),
               _Event("egp.fit.check", "CPU", 100, 350),
               _Event("egp.nigp.train", "CPU", 500, 1200),   # clipped
               _Event("egp.fit.check", "CPU", 600, 900),
               _Event("egp.fit.check", "CPU", 950, 1100),    # clipped
               _Event("egp.nigp.test", "CPU", 0, 100),
               _Event("egp.nigp.mean", "CPU", 100, 200),
               _Event("egp.nigp.readback", "CPU", 150, 190),
               _Event("egp.nigp.gradient", "CPU", 200, 300),
               _Event("egp.nigp.readback", "CPU", 250, 280),
               _Event("egp.nigp.variance", "CPU", 400, 700),
               _Event("egp.nigp.readback", "CPU", 600, 650)])
    # (400 - 250) + (500 - 300 - 50), over 2 fits
    assert _reader("nigp_train_host_ms").read(_Ctx(t, updates=2)) \
        == pytest.approx(150e-6)
    # 100 + 100 + 100 + 300 - (40 + 30 + 50), over 3 queries
    assert _reader("nigp_test_host_ms").read(_Ctx(t, queries=3)) \
        == pytest.approx(160e-6)
    bare = Trace([_Event(WINDOW_SPAN, "CPU", 0, 1000)])
    assert _reader("nigp_train_host_ms").read(_Ctx(bare, updates=2)) is None
    assert _reader("nigp_test_host_ms").read(_Ctx(bare, queries=2)) is None


class _FitCell:
    def __init__(self, fits):
        self.fits = fits

    def nigp_fit_shapes(self):
        return [(2500, 2, 7680)] * self.fits


def test_the_joint_roofline_counts_overlapping_kernels_once():
    reader = _reader("chol_joint_roofline")
    t = Trace([_Event(WINDOW_SPAN, "CPU", 0, 10 ** 7),
               _Event("void egp::chol_update_wgmma_kernel<egp::JointSource>",
                      "CUDA", 0, 3 * 10 ** 6),
               _Event("void egp::chol_diag_kernel<float>", "CUDA", 10 ** 6,
                      2 * 10 ** 6),
               _Event("void egp::chol_apply_kernel<float>", "CUDA",
                      2500000, 4 * 10 ** 6),
               _Event("void egp::trsv_kernel<float>", "CUDA", 4 * 10 ** 6,
                      5 * 10 ** 6)])
    least = work.least_seconds(nigp_work.chol_joint_flops(2500, 2),
                               nigp_work.chol_joint_bytes(2500, 2))
    # 3 of the 359 kernels of one launch traced, over 4 ms of them
    ctx = _Ctx(t, cell=_FitCell(1), launches={"chol_gram_joint": 1})
    got = reader.read(ctx)
    assert got == pytest.approx(100.0 * least * 3 / 359 / 4e-3)
    assert len(ctx.warnings) == 1 and "3 Cholesky kernels of the 359" \
        in ctx.warnings[0]
    # a trace that holds every launched kernel reads whole, unwarned
    ctx = _Ctx(t, cell=_FitCell(1), launches={})
    assert reader.read(ctx) == pytest.approx(100.0 * least / 4e-3)
    assert not ctx.warnings
    # nothing from a cell of another configuration or an empty slice
    assert reader.read(_Ctx(t, cell=object())) is None
    assert reader.read(_Ctx(t, cell=_FitCell(0))) is None


def test_the_mfu_readers_scale_by_the_work():
    fit = _reader("nigp_fit_mfu")
    ctx = _Ctx(Trace([_Event(WINDOW_SPAN, "CPU", 0, 10)]),
               cell=_FitCell(2))
    ctx.window = {"updates": 150, "seconds": 1.0}
    assert fit.read(ctx) == pytest.approx(
        100.0 * nigp_work.nigp_fit_flops(2500, 2) * 150 / 495e12)

    class _QueryCell:
        def nigp_query_shapes(self):
            return [(2500, 10_000, 2)] * 2

    query = _reader("nigp_query_mfu")
    ctx = _Ctx(None, cell=_QueryCell())
    ctx.traced["latencies"] = [0.03, 0.05]
    assert query.read(ctx) == pytest.approx(
        100.0 * 2 * nigp_work.nigp_query_flops(2500, 10_000, 2) / 0.08
        / 495e12)
