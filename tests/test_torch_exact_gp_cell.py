"""The benchmark's exact-GP configuration (``portbench/configs/
exact_gp8192.json``) on the CPU at a small size (a 16 x 16 grid): the
port's ``VanillaGaussianProcess`` against the plain reference
(``portbench/reference/exact_gp.py``) at 512 samples, and at 1024 (where
the control's error is clear of the limits) the cells' check passing on
an unbroken run and failing on each fault it exists to catch (a perturbed
alpha, a perturbed factor, the TF32 control, a fit that took a jitter,
answers served by the previous set's fit, a fit on half of the samples),
the adapter's warm-up capturing every graph the window replays (through
the eager stand-in for the capture), and the yardstick's counts and span
arithmetic for the new per-layer metrics."""

import os
import sys
import time

import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu_torch.models.vanilla_gp as vanilla_gp
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import (
    VanillaGaussianProcess,
    VanillaGPSetting,
)
from erl_gaussian_process_tpu_torch.models.exact_graph import ExactGraphs
from torch_graph_standin import eager_graphs  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import exact_work, harness  # noqa: E402
from portbench.adapters import exact_gp as adapter  # noqa: E402
from portbench.reference import exact_gp as ref  # noqa: E402
from portbench.trace import WINDOW_SPAN, Trace  # noqa: E402

CELLS = ("exact_gp8192.fit", "exact_gp8192.query")
SMALL = {"samples": 1024, "pool": 4, "test_grid": 16}
SEEDS = (4_000_000_123, 2_718_281_828)


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """One multi-threaded float32 exp first: torch's CPU build has got the
    first such call of a process wrong now and then
    (tests/test_torch_gram.py's ``_warm_torch_exp``)."""
    torch.exp(torch.zeros(1 << 20, dtype=torch.float32))


def _small_spec(workload: str) -> dict:
    spec = harness.cell_spec(workload)
    spec["config"] = dict(spec["config"], **SMALL)
    if "query" in spec["traffic"]:
        spec["traffic"] = dict(spec["traffic"],
                               query={"grid": SMALL["test_grid"]})
    return spec


def _run(workload, tmp_path, seed=SEEDS[0], control=False):
    return harness.run_cell(_small_spec(workload), seed, 0.3, False, "cpu",
                            time.perf_counter(),
                            cache_dir=str(tmp_path / "cache"),
                            control=control)


def _failed(nums: dict, workload: str) -> list:
    limits = harness.cell_spec(workload)["limits"]
    return [k for k, v in nums.items() if not v <= limits[k]]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_port_agrees_with_the_reference(dtype, seed):
    cfg = dict(harness.cell_spec(CELLS[0])["config"],
               **dict(SMALL, samples=512, pool=1, pool_seed=seed % 2**32))
    pool = adapter.make_inputs(cfg)
    x, y = pool["x"][0], pool["y"][0]
    grid = ref.grid(cfg["test_grid"], *cfg["domain"]).astype(np.float32)
    gp = VanillaGaussianProcess(
        VanillaGPSetting(kernel_type="rbf",
                         kernel=KernelSetting(x_dim=2,
                                              scale=cfg["kernel_scale"]),
                         max_num_samples=cfg["samples"]),
        dtype=np.dtype(dtype), device="cpu")
    assert gp.train(x.T, y, cfg["noise_var"])
    res = gp.test(grid.T)
    mean, var = res.get_mean(0), res.get_variance()
    want = ref.FitReference(x, y, cfg["noise_var"], cfg["kernel_scale"])
    m_ref, v_ref = want.predict(grid)
    mean_gap, var_gap = np.abs(mean - m_ref).max(), np.abs(var - v_ref).max()
    if dtype == "float64":
        assert mean_gap < 1e-10 and var_gap < 1e-10, (mean_gap, var_gap)
        assert np.abs(gp.state.L.numpy() - want.L.numpy()).max() < 1e-10
    else:
        limits = harness.cell_spec(CELLS[1])["limits"]
        assert mean_gap <= limits["mean_gap"], mean_gap
        assert var_gap <= limits["var_gap"], var_gap
        assert ref.backward_rel(gp.state.L, x, cfg["noise_var"],
                                cfg["kernel_scale"]) \
            <= harness.cell_spec(CELLS[0])["limits"]["backward_rel"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_unbroken_run_is_correct(tmp_path, workload, seed):
    out = _run(workload, tmp_path, seed)
    assert out["failed"] == 0 and out["correct"], out["checks"]
    assert out["checks"]["jitter_fits"]["value"] == 0
    want = {"jitter_fits", "backward_rel", "mean_gap"} if "fit" in workload \
        else {"jitter_fits", "mean_gap", "var_gap"}
    assert set(out["checks"]) == want


def _alpha_perturbed(mp):
    real = vanilla_gp.vanilla_fit

    def perturbed(*a, **k):
        st = real(*a, **k)
        alpha = st.alpha.clone()
        alpha[int(alpha.abs().argmax())] *= 1.1
        return st._replace(alpha=alpha)
    mp.setattr(vanilla_gp, "vanilla_fit", perturbed)


def _factor_perturbed(mp):
    real = vanilla_gp.vanilla_fit

    def perturbed(*a, **k):
        st = real(*a, **k)
        L = st.L.clone()
        L[-1, 0] += 0.1
        return st._replace(L=L)
    mp.setattr(vanilla_gp, "vanilla_fit", perturbed)


def _jittered(mp):
    """Each fit's first try comes back non-finite, so the retry adds a
    jitter to the noise."""
    real = vanilla_gp.host_jitter_retry

    def retry(fit_once, check_arrays):
        def first_fails(j):
            st = fit_once(j)
            return st._replace(alpha=torch.full_like(st.alpha, np.nan)) \
                if j == 0 else st
        return real(first_fails, check_arrays)
    mp.setattr(vanilla_gp, "host_jitter_retry", retry)


def _stale(mp):
    """Each fit takes the training set of the call before it, so the model
    answers from the previous set's fit."""
    real = VanillaGaussianProcess.train
    held = {}

    def lagged(self, *args):
        before = held.get(id(self), args)
        held[id(self)] = args
        return real(self, *before)
    mp.setattr(VanillaGaussianProcess, "train", lagged)


def _half(mp):
    """Each fit keeps only the first half of its samples."""
    real = VanillaGaussianProcess.train

    def halved(self, x, y, var):
        n = len(y) // 2
        return real(self, x[:, :n], y[:n], var)
    mp.setattr(VanillaGaussianProcess, "train", halved)


FAULTS = (_alpha_perturbed, _factor_perturbed, _jittered, _stale, _half)
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
    for k in range(2 * cell.n):
        cell.update(k)
        if cell.queries is not None:
            cell.query(k)
    assert len(eager_graphs) == made
    got = cell.collect()
    assert got["captures"] == 0 and got["jitter_fits"] == 0
    assert cell.diagnose(got)["captures_after_warmup"] == 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11), 3.0e-5])
    got = ref.round_tf32(a)
    assert got[:2].tolist() == a[:2].tolist()
    assert got[2] == 1.0 + 2.0 ** -10           # a tie rounds up
    assert got[3] == 1.0
    assert got[4] == -(1.0 + 2.0 ** -10)
    assert abs(got[5] - a[5]) <= a[5] * 2.0 ** -11


def test_block_substitution_is_a_triangular_solve():
    g = torch.Generator().manual_seed(0)
    n = 600   # not a multiple of the block
    L = torch.tril(torch.rand(n, n, generator=g, dtype=torch.float64)) \
        + n * torch.eye(n, dtype=torch.float64)
    B = torch.rand(n, 3, generator=g, dtype=torch.float64)
    for transpose in (False, True):
        want = torch.linalg.solve_triangular(L.T if transpose else L, B,
                                             upper=transpose)
        got = ref.solve_lower(L, B, transpose=transpose)
        assert torch.allclose(got, want, rtol=0, atol=1e-14)


def test_counts_at_the_cells_shape():
    n, m, d = 8192, 10_000, 2
    assert exact_work.chol_kernels(n) == 3 * 128 - 1
    assert exact_work.chol_kernels(n + 1) == 3 * 129 - 1
    gram = n * (n + 1) // 2 * (3 * d + 2) + n
    assert exact_work.chol_gram_flops(n, d) == pytest.approx(gram + n ** 3 / 3)
    assert exact_work.chol_gram_bytes(n, d) == 4 * n * 3 + n \
        + 4 * (n * (n + 1) // 2 + 128 * 64 * 64)
    assert exact_work.exact_fit_flops(n, d) == pytest.approx(
        gram + n ** 3 / 3 + 2 * n * n)
    assert exact_work.exact_query_flops(n, m, d) == n * m * 8 + 4 * n * m \
        + n * n * m + m
    # the factorization is compute-bound: 0.37 ms at the TF32 peak
    from portbench import work
    assert work.least_seconds(exact_work.chol_gram_flops(n, d),
                              exact_work.chol_gram_bytes(n, d)) \
        == pytest.approx(exact_work.chol_gram_flops(n, d) / 495e12)


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
    def __init__(self, trace, updates=0, queries=0):
        self.trace = trace
        self.traced = {"updates": updates, "queries": queries}


def test_span_time_less_nested_spans():
    t = Trace([_Event(WINDOW_SPAN, "CPU", 0, 1000),
               _Event("egp.exact.train", "CPU", 0, 400),
               _Event("egp.fit.check", "CPU", 100, 350),
               _Event("egp.exact.train", "CPU", 500, 1200),   # clipped
               _Event("egp.fit.check", "CPU", 600, 900),
               _Event("egp.fit.check", "CPU", 950, 1100),     # clipped
               _Event("egp.exact.test", "CPU", 0, 300),
               _Event("egp.exact.readback", "CPU", 100, 200),
               _Event("egp.exact.variance", "CPU", 400, 700),
               _Event("egp.exact.readback", "CPU", 600, 650)])
    # (400 - 250) + (500 - 300 - 50), over 2 fits
    assert _reader("exact_train_host_ms").read(_Ctx(t, updates=2)) \
        == pytest.approx(150e-6)
    # (300 - 100) + (300 - 50), over 3 queries
    assert _reader("exact_test_host_ms").read(_Ctx(t, queries=3)) \
        == pytest.approx(150e-6)
    bare = Trace([_Event(WINDOW_SPAN, "CPU", 0, 1000)])
    assert _reader("exact_train_host_ms").read(_Ctx(bare, updates=2)) is None
    assert _reader("exact_test_host_ms").read(_Ctx(bare, queries=2)) is None


def test_the_cholesky_time_counts_overlapping_kernels_once():
    reader = _reader("chol_roofline")
    t = Trace([_Event(WINDOW_SPAN, "CPU", 0, 1000),
               _Event("void egp::chol_update_wgmma_kernel<egp::GramSource>",
                      "CUDA", 0, 300),
               _Event("void egp::chol_diag_kernel<float>", "CUDA", 100, 200),
               _Event("void egp::chol_apply_kernel<float>", "CUDA", 250,
                      400),
               _Event("void egp::trsv_kernel<float>", "CUDA", 400, 500),
               _Event("void egp::chol_update_wgmma_kernel<egp::GramSource>",
                      "CUDA", 600, 700)])
    assert reader.busy_seconds(t, exact_work.CHOL_KERNELS) \
        == pytest.approx(500e-9)
    assert t.kernel_count(exact_work.CHOL_KERNELS) == 4
    assert t.busy_s == pytest.approx(600e-9)   # the trace left whole


def test_the_exact_test_gram_is_read_by_the_gram_roofline(tmp_path):
    spec = _small_spec(CELLS[1])
    cell = adapter.Cell(spec["config"], spec["traffic"], SEEDS[0], "cpu",
                        ROOT, str(tmp_path / "cache"))
    cell.query_log = [0, 1]
    n, m = SMALL["samples"], SMALL["test_grid"] ** 2
    (per_query, per_member, d), again = cell.routed_query_shapes()
    assert again == (per_query, per_member, d)
    from portbench import work
    assert work.routed_gram_flops(per_query, d) \
        == n * m * exact_work.rbf_entry_flops(d)
    assert work.routed_gram_bytes(per_query, per_member, d) \
        == 4 * (m * d + n * d + n * m)


@pytest.mark.parametrize("n", [300, 1024])
def test_a_sound_float32_factor_passes_backward_rel(n):
    """LAPACK's float32 factor of the cell's gram reads under the limit:
    the limit pins no one factorization's order of sums."""
    g = torch.Generator().manual_seed(n)
    x = (torch.rand(n, 2, generator=g) * 2 - 1).numpy()
    K = ref.train_gram(torch.as_tensor(x), 1e-3, 0.1)
    got = ref.backward_rel(torch.linalg.cholesky(K), x, 1e-3, 0.1)
    limit = harness.cell_spec(CELLS[0])["limits"]["backward_rel"]
    assert got <= limit / 5, (got, limit)
