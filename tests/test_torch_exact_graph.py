"""The exact and noisy-input GPs' CUDA-graph steps (erl_gaussian_process_tpu_
torch/models/exact_graph.py) on the CPU, through the eager stand-in for the
capture (tests/torch_graph_standin.py: each replay reruns the captured
body and overwrites the first run's outputs, as a graph's static buffers
are overwritten): every fit, test and variance variant of
``VanillaGaussianProcess`` and ``NoisyInputGaussianProcess`` (exact and
reduced-rank, with and without gradient observations, a scale mixture) at
float64 and float32, against the same eager model bit for bit (L, alpha,
Dinv, mean, gradient, variance, covariance) and against the JAX package's
one-dispatch jits on the same numpy inputs (to a tolerance times max(1,
each result's magnitude), the 1 being the prior variance, which a posterior
variance 1 - ||L^-1 k||^2 cancels against: 1e-12 at float64, at float32
2e-3, the F32_TOL of tests/test_torch_vanilla_gp.py and
tests/test_torch_noisy_input_gp.py);
then the graphs' hazards: the host jitter retry's replays, live results
across another test and across a retrain, ``state_dict`` copies and a
load, a mean-only test, the least recently used groups dropped, the scale
in every key, a failed capture raising, CPU models without graphs and the
launches a replay counts. The graphs themselves run
only on the card (tests/test_torch_cuda.py, chip_smoke.py phases 12-14)."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.models.noisy_input_gp as jn
import erl_gaussian_process_tpu.models.vanilla_gp as jv
import erl_gaussian_process_tpu_torch.models.pose_graph as pg
import erl_gaussian_process_tpu_torch.ops.chol as chol_ops
import erl_gaussian_process_tpu_torch.ops.trsv as trsv_ops
from erl_gaussian_process_tpu.kernels.reduced_rank import (
    rr_features as jax_rr_features,
)
from erl_gaussian_process_tpu.kernels.reduced_rank import (
    rr_ktest_joint as jax_rr_ktest_joint,
)
from erl_gaussian_process_tpu.kernels.stationary import (
    register_scale_mixture as jax_register_scale_mixture,
)
from erl_gaussian_process_tpu_torch.kernels import (
    KernelSetting,
    ReducedRankSetting,
    register_scale_mixture,
)
from erl_gaussian_process_tpu_torch.models import (
    NoisyInputGaussianProcess,
    NoisyInputGPSetting,
    VanillaGaussianProcess,
    VanillaGPSetting,
)
from erl_gaussian_process_tpu_torch.models.exact_graph import ExactGraphs
from erl_gaussian_process_tpu_torch.ops import (
    chol_blocked_gram,
    launch_counts,
    substitute_cuda,
)
from torch_graph_standin import StaticGraph, eager_graphs  # noqa: F401

F32_TOL = 2e-3
MIX = ("rbf", 0.5, (0.7, 0.3))
VARIANTS = ["vanilla", "vanilla_rr", "nigp", "nigp_mix", "nigp_nograd",
            "nigp_rr", "nigp_rr_nograd"]
RR = dict(x_dim=2, scale=0.6, num_basis=[16, 16], boundary=[2.0, 2.0],
          coord_origin=[0.0, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This file's torch ops are many and small: they run on one thread,
    the worker's thread count restored after. Six copies of the file run
    at once (as the suite's six workers run) took 262 s each with torch's
    default threads against 32 s with one. One thread also keeps clear of
    the first multi-threaded float32 ``torch.exp`` of a process, which can
    be off in one thread's chunk (tests/test_torch_gram.py's
    ``_warm_torch_exp``) and would show in the bitwise comparisons."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _bits(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


class Case:
    """One variant: a model factory, two train sets of one shape (samples
    in a larger padded budget) and two query batches of 64."""

    def __init__(self, variant, dtype, n=None):
        self.variant, self.dtype = variant, np.dtype(dtype)
        self.nigp = variant.startswith("nigp")
        self.rr = "_rr" in variant
        self.grad = self.nigp and not variant.endswith("nograd")
        self.n = n or (100 if self.nigp else 200)
        self.budget = 128 if self.nigp else 256
        rng = np.random.default_rng(11)
        self.x = rng.uniform(-0.9, 0.9, (2, self.n))
        x0, x1 = self.x
        self.ys = [np.sin(3 * x0) * np.cos(2 * x1),
                   np.cos(2 * x0) * np.sin(x1)]
        self.gs = [np.stack([3 * np.cos(3 * x0) * np.cos(2 * x1),
                             -2 * np.sin(3 * x0) * np.sin(2 * x1)]),
                   np.stack([-2 * np.sin(2 * x0) * np.sin(x1),
                             np.cos(2 * x0) * np.cos(x1)])]
        self.queries = [rng.uniform(-0.8, 0.8, (2, 64)) for _ in range(2)]

    def kernel(self):
        if self.rr:
            return ("rr_matern32" if not self.nigp else "rr_rbf",
                    ReducedRankSetting(**RR))
        if self.variant == "nigp_mix":
            assert register_scale_mixture(*MIX) == \
                jax_register_scale_mixture(*MIX)
            return "rbf", KernelSetting(x_dim=2, scale=0.5, scale_mix=0.5,
                                        weights=[0.7, 0.3])
        return "rbf", KernelSetting(x_dim=2, scale=0.5)

    def new(self, graphed=False):
        """A CPU model; ``graphed``: with graphs on the CPU, run through the
        ``eager_graphs`` stand-in."""
        kt, ks = self.kernel()
        if self.nigp:
            gp = NoisyInputGaussianProcess(NoisyInputGPSetting(
                kernel_type=kt, kernel=ks, max_num_samples=self.budget,
                no_gradient_observation=not self.grad), dtype=self.dtype,
                device="cpu")
        else:
            gp = VanillaGaussianProcess(VanillaGPSetting(
                kernel_type=kt, kernel=ks, max_num_samples=self.budget),
                dtype=self.dtype, device="cpu")
        assert gp._graphs is None
        if graphed:
            gp._graphs = ExactGraphs("cpu")
        return gp

    def train(self, gp, k=0):
        if self.nigp:
            return gp.train(self.x, self.ys[k], self.gs[k], var_x=1e-4,
                            var_y=1e-2, var_grad=1e-2)
        return gp.train(self.x, self.ys[k], 1e-2)

    def test(self, gp, k=0):
        return gp.test(self.queries[k], True) if self.nigp \
            else gp.test(self.queries[k])

    def outputs(self, res) -> dict:
        """Everything a result gives: the variances' whitening first."""
        if not self.nigp:
            return {"var": res.get_variance(), "mean": res.get_mean(0)}
        out = {"mean_var": res.get_mean_variance()}
        if self.grad:
            out.update(grad_var=res.get_gradient_variance(),
                       cov=res.get_covariance(), grad=res.get_gradient(0))
        out["mean"] = res.get_mean(0)
        return out


def _same_state(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
        else:
            _bits(x, y)


# -- (a) graphed against the eager model, bit for bit -----------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", VARIANTS)
def test_graphed_steps_equal_the_eager_model(eager_graphs, variant, dtype):
    """Two trains of one shape (the capture, then a replay on other data),
    after each two tests (the first variance query whitens by the factor,
    the second takes L^-1): state, ktest and every output bit for bit the
    eager model's. One fit graph, one test group with its three graphs, one
    L^-1 graph."""
    case = Case(variant, dtype)
    ref, got = case.new(), case.new(graphed=True)
    for k in range(2):
        for m in (ref, got):
            assert case.train(m, k)
        _same_state(ref.state, got.state)
        for q in range(2):
            a, b = case.test(ref, q), case.test(got, q)
            _bits(a._ktest, b._ktest)
            oa, ob = case.outputs(a), case.outputs(b)
            assert oa.keys() == ob.keys()
            for key in oa:
                _bits(oa[key], ob[key])
        assert got._L_inv is not None
    kinds = sorted(g.key[0] for g in eager_graphs)
    assert kinds == ["fast", "fit", "l_inv", "test", "variance"]
    assert [g.replays for g in eager_graphs if g.key[0] == "fit"] == [2]


# -- (b) graphed against the JAX package's jits -----------------------------

def _close(got, ref, dtype):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = 1e-12 if dtype == np.float64 else F32_TOL
    atol = tol * max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _jax_steps(case, gp):
    """JAX's fit and query jits on the model's train set, queries and basis
    constants (numpy): (state, [per query batch: (ktest, outputs of the
    first and of the repeated-query variance)])."""
    ts, dt = gp.get_train_set(), case.dtype.type
    consts = () if not case.rr else tuple(
        np.asarray(a) for a in (gp._basis._freq, gp._basis._sqrt_s,
                                gp._basis._origin, gp._basis._half,
                                gp._basis._inv_sqrt_vol))
    scale = dt(gp._scale)
    queries = [np.ascontiguousarray(q.T.astype(case.dtype))
               for q in case.queries]
    if not case.nigp:
        if case.rr:
            st = jv.rr_fit(ts.xp, ts.yp, ts.vp, ts.mask, *consts)
        else:
            st = jv.vanilla_fit(ts.xp, ts.yp, ts.vp, ts.mask, scale,
                                kernel=gp._kernel)
        out = []
        for xq in queries:
            if case.rr:
                kt = jax_rr_features(
                    jnp.asarray(xq), jnp.ones(xq.shape[0], bool),
                    *consts).T
            else:
                kt = jv.vanilla_ktest(st, xq, scale, kernel=gp._kernel)
            mean = jv.vanilla_mean(st, kt)[:, 0]
            var = jv.vanilla_variance(st, kt, reduced_rank=case.rr)
            fast = jv.vanilla_variance_fast(jv.vanilla_l_inv(st), kt,
                                            reduced_rank=case.rr)
            out.append((kt, {"var": var, "mean": mean}, {"var": fast}))
        return st, out
    smask = ts.sample_mask
    if case.grad:
        args = (ts.xp, ts.yp, ts.gradp, ts.vx, ts.vy, ts.vg, smask, ts.gmask)
        st = (jn.nigp_rr_fit(*args, *consts) if case.rr else
              jn.nigp_fit(*args, scale, kernel=gp._kernel))
    else:
        args = (ts.xp, ts.yp, ts.vx, ts.vy, smask)
        st = (jn.nigp_rr_fit_nograd(*args, *consts) if case.rr else
              jn.nigp_fit_nograd(*args, scale, kernel=gp._kernel))
    out = []
    d, m = 2, 64
    for xq in queries:
        if case.rr:
            kt = jax_rr_ktest_joint(jnp.asarray(xq), *consts,
                                    with_test_grad=True)
        else:
            kt = jn.nigp_ktest(st, xq, scale, kernel=gp._kernel,
                               with_test_grad=True,
                               with_train_grad=case.grad)
        varcov = jn.nigp_variance_cov(st, kt, scale, d=d,
                                      reduced_rank=case.rr)
        fast = jn.nigp_variance_cov_fast(jn.nigp_l_inv(st), kt, scale, d=d,
                                         reduced_rank=case.rr)
        names = ("mean_var", "grad_var", "cov")
        first = dict(zip(names, (varcov[0], varcov[1].T, varcov[2].T)))
        first["mean"] = jn.nigp_mean(st, kt, m)[:, 0]
        first["grad"] = jn.nigp_gradient(st, kt, m, d)[:, :, 0].T
        again = dict(zip(names, (fast[0], fast[1].T, fast[2].T)))
        if not case.grad:
            # the joint layout without train gradients still predicts the
            # test gradient; the model is asked for the mean variance only
            first = {k: first[k] for k in ("mean_var", "mean")}
            again = {"mean_var": again["mean_var"]}
        out.append((kt, first, again))
    return st, out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", VARIANTS)
def test_graphed_steps_match_the_jax_jits(eager_graphs, variant, dtype):
    """The graphed fit (L's lower triangle, alpha), test (ktest, mean,
    gradient) and both variance paths (the whitening, then L^-1) against
    the JAX package's jits on the same inputs."""
    case = Case(variant, dtype)
    gp = case.new(graphed=True)
    assert case.train(gp)
    st, per_query = _jax_steps(case, gp)
    tri = np.tril(np.ones(gp.state.L.shape, bool))
    _close(np.where(tri, _np(gp.state.L), 0),
           np.where(tri, np.asarray(st.L), 0), case.dtype)
    _close(gp.state.alpha, st.alpha, case.dtype)
    for q, (kt, first, again) in enumerate(per_query):
        res = case.test(gp, q)
        _close(res.k_test, kt, case.dtype)
        got = case.outputs(res)
        ref = first if q == 0 else {**first, **again}
        assert got.keys() == ref.keys()
        for key in ref:
            _close(got[key], ref[key], case.dtype)
    assert gp._L_inv is not None


# -- (c) the hazards --------------------------------------------------------

@pytest.mark.parametrize("variant", ["vanilla", "nigp"])
def test_jitter_retry_replays_with_the_raised_noise(eager_graphs, caplog,
                                                    variant):
    """Coincident samples at zero noise leave the gram singular: the fit
    graph's alpha is NaN, and the host retry replays the same graph with
    the noise raised to 1e-10 (one capture, two replays), ending equal to
    the eager retry bit for bit, with its warning."""
    case = Case(variant, np.float64)
    x = np.array([[0.0, 0.0, 1.0], [0.5, 0.5, -0.5]])
    y = np.array([1.0, 1.0, -1.0])
    states = []
    for graphed in (False, True):
        gp = case.new(graphed)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert (gp.train(x, y, np.zeros((2, 3)), 0.0, 0.0, 0.0)
                    if case.nigp else gp.train(x, y, 0.0))
        assert "jitter 1e-10" in caplog.text
        states.append(gp.state)
        assert np.isfinite(_np(gp.state.alpha)).all()
    _same_state(*states)
    fits = [g for g in eager_graphs if g.key[0] == "fit"]
    assert len(fits) == 1 and fits[0].replays == 2


@pytest.mark.parametrize("variant", ["vanilla", "nigp"])
def test_live_results_keep_their_inputs(eager_graphs, variant):
    """Two results of one query shape, read interleaved: the second test
    copies the first result's ktest out of the graph's buffer, its variance
    copies it back; both equal the eager model's bit for bit."""
    case = Case(variant, np.float64)
    ref, got = case.new(), case.new(graphed=True)
    for m in (ref, got):
        assert case.train(m)
    a1, a2 = case.test(ref, 0), case.test(ref, 1)
    b1 = case.test(got, 0)
    buffer = b1._held.ktest
    b2 = case.test(got, 1)
    assert b2._held.ktest is buffer and b1._held.ktest is not buffer
    o1 = case.outputs(b1)
    assert b1._held.ktest is buffer and b2._held.ktest is not buffer
    o2 = case.outputs(b2)
    assert b2._held.ktest is buffer and b1._held.ktest is not buffer
    for got_o, ref_o in ((o1, case.outputs(a1)), (o2, case.outputs(a2))):
        for key in ref_o:
            _bits(got_o[key], ref_o[key])
    assert len(next(iter(got._graphs._states.values())).queries) == 1


@pytest.mark.parametrize("variant", ["vanilla", "nigp"])
def test_a_result_from_before_a_retrain_reads_the_new_state(eager_graphs,
                                                            variant):
    """A result made before a retrain (of the same shape: the same buffers,
    overwritten) gives what the eager model's gives, which reads the state
    at query time: one whose mean was read before the retrain (the vanilla
    GP keeps it), one read only after it; then a new test."""
    case = Case(variant, np.float64)
    ref, got = case.new(), case.new(graphed=True)
    pairs = []
    for m in (ref, got):
        assert case.train(m, 0)
        early, late = case.test(m, 0), case.test(m, 1)
        early.get_mean(0)
        assert case.train(m, 1)
        pairs.append((case.outputs(early), case.outputs(late),
                      case.outputs(case.test(m, 0))))
    for a, b in zip(*pairs):
        for key in a:
            _bits(a[key], b[key])


@pytest.mark.parametrize("variant", ["vanilla_rr", "nigp"])
def test_state_dict_copies_and_a_load(eager_graphs, tmp_path, variant):
    """``state_dict`` returns copies (a retrain leaves them as they were); a
    load drops the graphs and its state is the loaded tensors (float32
    Dinv rebuilt); its tests and the next train equal the eager model's
    bit for bit."""
    case = Case(variant, np.float32)
    ref, got = case.new(), case.new(graphed=True)
    for m in (ref, got):
        assert case.train(m, 0)
    d = got.state_dict()
    kept = {k: v.copy() for k, v in d["state"].items()}
    assert case.train(got, 1)
    for k, v in kept.items():
        np.testing.assert_array_equal(d["state"][k], v)
    assert not np.array_equal(_np(got.state.alpha), kept["alpha"])
    path = str(tmp_path / "gp.npz")
    ref.save(path)
    for m in (ref, got):
        m.load(path)
    assert all(g.graph is None for g in eager_graphs)
    _same_state(ref.state, got.state)
    assert got.state.dinv is not None
    a, b = case.outputs(case.test(ref)), case.outputs(case.test(got))
    for key in a:
        _bits(a[key], b[key])
    got.reset(case.budget, 2, 1)
    ref.reset(case.budget, 2, 1)
    for m in (ref, got):
        assert m.train()
    _same_state(ref.state, got.state)
    assert sum(g.key[0] == "fit" for g in eager_graphs) == 2


def test_a_mean_only_test_replays_no_variance_graph(eager_graphs):
    """The reference's lazy result defers the whitening: a test whose
    variance is never asked replays the test graph only."""
    case = Case("nigp", np.float64)
    gp = case.new(graphed=True)
    assert case.train(gp)
    res = case.test(gp)
    res.get_mean(0), res.get_gradient(0)
    assert sorted(g.key[0] for g in eager_graphs) == ["fit", "test"]
    res.get_mean_variance()
    assert sorted(g.key[0] for g in eager_graphs) == \
        ["fit", "test", "variance"]


def test_the_least_recently_used_are_dropped(eager_graphs):
    """A state keeps MAX_QUERIES query groups and a model MAX_STATES
    states; the least recently used are released (the graphs of a state
    with it). A result of a dropped group still gives the eager model's
    variance; every capture stays on record."""
    from erl_gaussian_process_tpu_torch.models import exact_graph

    case = Case("vanilla", np.float64)
    ref, got = case.new(), case.new(graphed=True)
    for m in (ref, got):
        assert case.train(m)
    rng = np.random.default_rng(3)
    qs = [rng.uniform(-0.8, 0.8, (2, 10 + k))
          for k in range(exact_graph.MAX_QUERIES + 1)]
    first = got.test(qs[0])
    for q in qs[1:]:
        got.test(q)
    sg = next(iter(got._graphs._states.values()))
    assert len(sg.queries) == exact_graph.MAX_QUERIES
    assert not first._held.group.kept and first._held.group.test.graph is None
    _bits(first.get_variance(), ref.test(qs[0]).get_variance())
    for k in range(1, exact_graph.MAX_STATES + 1):
        got.setting.max_num_samples = case.budget + k
        assert case.train(got)
    assert len(got._graphs._states) == exact_graph.MAX_STATES
    assert sg.state is None and sg.fit.graph is None
    assert len([g for g in eager_graphs if g.key[0] == "fit"]) == \
        exact_graph.MAX_STATES + 1


def test_the_scale_is_in_every_key(eager_graphs):
    """The gram-fused Cholesky and the gram take the scale as a host
    constant, so a graph bakes it: a model whose kernel scale changed
    captures new graphs, and its fit and test equal an eager model at the
    new scale bit for bit."""
    case = Case("vanilla", np.float64)
    got = case.new(graphed=True)
    assert case.train(got)
    case.outputs(case.test(got))
    ref = case.new()
    for m in (ref, got):
        m.setting.kernel.scale = 0.3
        m._setup_kernel()
        assert case.train(m)
    _same_state(ref.state, got.state)
    a, b = case.outputs(case.test(ref)), case.outputs(case.test(got))
    for key in a:
        _bits(a[key], b[key])
    fits = [g.key for g in eager_graphs if g.key[0] == "fit"]
    assert len(fits) == 2 and fits[0][3] == 0.5 and fits[1][3] == 0.3


def test_a_failed_capture_raises(monkeypatch):
    """A capture error raises with its cause: nothing falls back to the
    eager chain."""
    def capture(*args, **kw):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(pg, "capture", capture)
    gp = Case("nigp", np.float32).new(graphed=True)
    with pytest.raises(RuntimeError, match="capture failed"):
        Case("nigp", np.float32).train(gp)
    assert gp.state is None


def test_cpu_models_build_no_graph(monkeypatch):
    """A CPU model never captures: every step runs eagerly."""
    def capture(*args, **kw):
        raise AssertionError("a CPU model captured a graph")

    monkeypatch.setattr(pg, "capture", capture)
    for variant in ("vanilla", "nigp_rr"):
        case = Case(variant, np.float32)
        gp = case.new()
        assert case.train(gp)
        case.outputs(case.test(gp))
        assert gp._graphs is None


def test_replays_count_the_launches_they_captured(monkeypatch):
    """The fit graph holds the fit's kernels and each replay counts them: a
    stand-in capture records the plain versions its body calls as the
    wrappers' launches (one gram-fused Cholesky, two substitutions), and
    three graphed trains (one capture) add three times that to the counts;
    a test then holds no factorization."""
    calls = {}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(chol_ops, "chol_blocked_gram_plain", counting(
        chol_blocked_gram, chol_ops.chol_blocked_gram_plain))
    monkeypatch.setattr(trsv_ops, "substitute_plain", counting(
        substitute_cuda, trsv_ops.substitute_plain))

    def capture(key, device, warm, run, inputs, generators=()):
        warm()
        calls.clear()
        graph = StaticGraph(key, run, inputs)
        graph.replay()                 # the capture: records the outputs
        return pg.CapturedGraph(key=key, graph=graph, inputs=inputs,
                                outputs=graph.outputs, launches=dict(calls),
                                warmup_ms=0.0, capture_ms=0.0, pool_bytes=0)

    monkeypatch.setattr(pg, "capture", capture)
    case = Case("vanilla", np.float64)
    gp = case.new(graphed=True)
    before = launch_counts()
    for k in (0, 1, 0):
        assert case.train(gp, k)
    case.outputs(case.test(gp))
    after = launch_counts()
    fit = gp._graphs.captures[0]
    assert fit.launches == {chol_blocked_gram: 1, substitute_cuda: 2}
    assert fit.replays == 3
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"chol_gram": 3, "trsv": 6}
