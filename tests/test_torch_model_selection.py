"""Marginal-likelihood scale selection of the PyTorch port
(``erl_gaussian_process_tpu_torch/utils/model_selection.py``) against the
JAX package's ``utils/model_selection.py`` on the same numpy-seeded inputs:
every sweep's NLML at float64 to 1e-10 relative (masked rows included),
the same picks, the degenerate-input errors, the gradient of the fit
against a central finite difference and against ``jax.grad`` of the JAX
criterion, the fit's Adam trace against the JAX ``optax`` trace, and the
gram op's autograd backward against autograd through the plain gram. The
cases follow tests/test_model_selection.py one to one where they apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erl_gaussian_process_tpu.utils import model_selection as jms
from erl_gaussian_process_tpu_torch.ops.gram import (
    GramScale,
    apply_family,
    cross_gram_plain,
    pairwise_sqdist,
)
from erl_gaussian_process_tpu_torch.utils import model_selection as tms

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10        # float64 NLML, port against JAX
CPU = "cpu"


def _t(a, dtype=torch.float64):
    a = np.asarray(a)
    return torch.as_tensor(a) if a.dtype == bool else torch.as_tensor(
        a, dtype=dtype)


def _masked_problem(seed=0, n=120):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    y = np.stack([np.sin(2 * x[:, 0]), np.cos(x[:, 1])], axis=1)
    y += rng.normal(0, 1e-2, y.shape)
    var = np.full(n, 1e-3)
    mask = rng.random(n) < 0.85
    return x, y, var, mask


@pytest.mark.parametrize("kernel", ["rbf", "matern32", "ou"])
def test_nlml_matches_jax_with_mask(kernel):
    x, y, var, mask = _masked_problem()
    scales = np.array([0.2, 0.5, 1.0])
    got = tms.nlml_sweep(_t(x), _t(y), _t(var), _t(mask), _t(scales),
                         kernel=kernel).numpy()
    ref = np.asarray(jms.nlml_sweep(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(var), jnp.asarray(mask),
        jnp.asarray(scales), kernel=kernel))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_select_scale_recovers_generative_scale():
    """The port picks the same scale as JAX on data from a known-scale GP,
    within a grid step of the truth, and ranks clearly wrong scales
    worse."""
    rng = np.random.default_rng(1)
    n, true_scale = 300, 0.4
    x = rng.uniform(-2, 2, (n, 1))
    r2 = (x[:, None, 0] - x[None, :, 0]) ** 2
    K = np.exp(-0.5 * r2 / true_scale**2) + 1e-6 * np.eye(n)
    f = np.linalg.cholesky(K) @ rng.standard_normal(n)
    y = (f + rng.normal(0, 0.1, n))[:, None]
    var = np.full(n, 1e-2)
    best, scales, vals = tms.select_scale(x, y, var, kernel="rbf", refine=1,
                                          device=CPU)
    jbest, jscales, jvals = jms.select_scale(x, y, var, kernel="rbf",
                                             refine=1)
    assert best == jbest
    np.testing.assert_array_equal(scales, jscales)
    np.testing.assert_allclose(vals, jvals, rtol=RTOL)
    assert 0.25 < best < 0.65, best
    wrong = tms.nlml_sweep(_t(x), _t(y), _t(var), torch.ones(n, dtype=bool),
                           _t([0.02, 4.0]), kernel="rbf").numpy()
    assert (vals.min() < wrong).all()


def test_select_scale_improves_fit_quality():
    """A vanilla GP of the port trained at the selected scale beats the
    same model at a 5x-off scale on held-out MAE."""
    from erl_gaussian_process_tpu_torch.kernels import KernelSetting
    from erl_gaussian_process_tpu_torch.models import (
        VanillaGaussianProcess,
        VanillaGPSetting,
    )

    rng = np.random.default_rng(2)
    n = 200
    x = np.sort(rng.uniform(-1, 1, n))[None, :]
    y = (np.sin(4 * x[0]) + rng.normal(0, 1e-2, n))[:, None]
    var = np.full(n, 1e-4)
    best, _, _ = tms.select_scale(x.T, y, var, kernel="rbf", refine=1,
                                  device=CPU)
    assert best == jms.select_scale(x.T, y, var, kernel="rbf", refine=1)[0]
    xq = np.linspace(-0.9, 0.9, 257)[None, :]
    truth = np.sin(4 * xq[0])

    def mae_at(s):
        gp = VanillaGaussianProcess(VanillaGPSetting(
            kernel_type="rbf", kernel=KernelSetting(x_dim=1, scale=s),
            max_num_samples=n), device=CPU)
        gp.train(x, y, var)
        return float(np.abs(np.asarray(gp.test(xq).get_mean()) - truth)
                     .mean())

    assert mae_at(best) < mae_at(best * 5.0)
    assert mae_at(best) < 5e-3


def _nigp_problem(seed=3, n=60, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(2 * x[:, :1]) * np.cos(x[:, 1:2])
    grad = np.stack([2 * np.cos(2 * x[:, :1]) * np.cos(x[:, 1:2]),
                     -np.sin(2 * x[:, :1]) * np.sin(x[:, 1:2])], axis=1)
    var_x = np.full(n, 1e-4)
    var_y = np.full(n, 1e-3)
    var_grad = np.full(n, 1e-2)
    sample_mask = rng.random(n) < 0.9
    grad_mask = sample_mask & (rng.random(n) < 0.6)
    return x, y, grad, var_x, var_y, var_grad, sample_mask, grad_mask


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_nlml_nigp_matches_jax(kernel):
    args = _nigp_problem()
    scales = np.array([0.4, 0.8])
    got = tms.nlml_sweep_nigp(*[_t(a) for a in args], _t(scales),
                              kernel=kernel).numpy()
    ref = np.asarray(jms.nlml_sweep_nigp(
        *[jnp.asarray(a) for a in args], jnp.asarray(scales), kernel=kernel))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_select_scale_nigp_drives_the_reference_sweep():
    """The 1D NIGP sweep of the reference's grid: scale 0.1 ranks last in
    both packages, the NLML values agree, and the automated selection picks
    JAX's interior optimum."""
    n = 100
    x = np.linspace(0, 2 * np.pi, n)[:, None]
    y = np.sin(2 * x)
    grad = 2 * np.cos(2 * x)
    var = np.full(n, 1e-4)
    ref_grid = np.array([0.1, 0.2, 0.3, 0.4, 0.5])
    ones = np.ones(n, bool)
    vals = tms.nlml_sweep_nigp(
        _t(x), _t(y), _t(grad[:, :, None]), _t(var), _t(var), _t(var),
        _t(ones), _t(ones), _t(ref_grid), kernel="rbf").numpy()
    jvals = np.asarray(jms.nlml_sweep_nigp(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(grad[:, :, None]),
        jnp.asarray(var), jnp.asarray(var), jnp.asarray(var),
        jnp.asarray(ones), jnp.asarray(ones), jnp.asarray(ref_grid),
        kernel="rbf"))
    assert np.isfinite(vals).all() and vals.argmax() == 0
    np.testing.assert_allclose(vals, jvals, rtol=1e-8)
    best, _, nlml = tms.select_scale_nigp(x, y, grad, var, var, var,
                                          kernel="rbf", refine=1, device=CPU)
    jbest, _, _ = jms.select_scale_nigp(x, y, grad, var, var, var,
                                        kernel="rbf", refine=1)
    assert np.isfinite(best) and 0.5 < best < 2.0, best
    np.testing.assert_allclose(best, jbest, rtol=1e-12)


def test_select_scale_nigp_2d_rejects_catastrophic_scale():
    """The reference's 2D sweep grid: scale 0.05 ranks last and the pick
    is JAX's interior one."""
    m = 16
    xs = np.linspace(-2, 2, m)
    ys = np.linspace(-1, 1, m)
    xv, yv = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([xv.ravel(), yv.ravel()], axis=-1)
    z = 2 * np.sin(10 * pts[:, 0]) * np.cos(5 * pts[:, 1])
    gx = 20 * np.cos(10 * pts[:, 0]) * np.cos(5 * pts[:, 1])
    gy = -10 * np.sin(10 * pts[:, 0]) * np.sin(5 * pts[:, 1])
    grad = np.stack([gx, gy], axis=1)[:, :, None]
    var = np.full(m * m, 1e-4)
    ref_grid = np.array([0.05, 0.1, 0.15, 0.2])
    best, _, vals = tms.select_scale_nigp(
        pts, z[:, None], grad, var, var, var, kernel="rbf", scales=ref_grid,
        refine=0, device=CPU)
    jbest, _, _ = jms.select_scale_nigp(
        pts, z[:, None], grad, var, var, var, kernel="rbf", scales=ref_grid,
        refine=0)
    ranked = np.where(np.isfinite(vals), vals, np.inf)
    assert ranked.argmax() == 0, vals.tolist()
    assert best == jbest and best in (0.1, 0.15, 0.2), best


def test_select_scale_rejects_degenerate_inputs():
    with pytest.raises(ValueError, match=">= 2 valid"):
        tms.select_scale(np.zeros((1, 1)), np.zeros((1, 1)),
                         np.full(1, 1e-4), kernel="rbf", device=CPU)
    with pytest.raises(ValueError, match="distinct"):
        tms.select_scale(np.ones((8, 1)), np.zeros((8, 1)),
                         np.full(8, 1e-4), kernel="rbf", device=CPU)
    x = np.repeat(np.linspace(0, 1, 4), 4)[:, None]
    best, scales, _ = tms.select_scale(x, np.sin(x), np.full(16, 1e-2),
                                       kernel="rbf", refine=0, device=CPU)
    assert np.isfinite(scales).all() and np.isfinite(best)
    np.testing.assert_array_equal(
        scales, jms.select_scale(x, np.sin(x), np.full(16, 1e-2),
                                 kernel="rbf", refine=0)[1])


def _spgp_problem(seed=5, m_side=6, n=160):
    rng = np.random.default_rng(seed)
    c = np.linspace(-1, 1, m_side)
    pv, qv = np.meshgrid(c, c, indexing="ij")
    pseudo = np.stack([pv.ravel(), qv.ravel()], axis=-1)
    x = rng.uniform(-1, 1, (n, 2))
    y = np.stack([np.sin(2 * x[:, 0]) * np.cos(x[:, 1]),
                  x[:, 0] * x[:, 1]], axis=-1)
    var = np.full(n, 1e-2)
    mask = rng.uniform(size=n) < 0.85
    return pseudo, x, y, var, mask


@pytest.mark.parametrize("kernel", ["matern32", "rbf"])
def test_nlml_spgp_matches_jax_with_mask(kernel):
    args = _spgp_problem()
    scales = np.asarray([0.2, 0.4, 0.8])
    got = tms.nlml_sweep_spgp(*[_t(a) for a in args], _t(scales),
                              kernel=kernel).numpy()
    ref = np.asarray(jms.nlml_sweep_spgp(
        *[jnp.asarray(a) for a in args], jnp.asarray(scales), kernel=kernel))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_select_scale_spgp_recovers_sensible_scale():
    """The FITC pick (fixed pseudo grid) lands near the exact-GP pick on
    data from a known-scale GP, as in JAX. Here K_M of 48 pseudo points
    0.085 apart is singular at float64 from scale ~0.3 on (NaN NLML in
    both packages), so the optimum sits at the edge of where the Cholesky
    succeeds and which refined candidates near that edge factor depends
    on rounding: the values agree to 1e-6 where both are finite and the
    picks to within one refined grid step. On a well-conditioned problem
    (the masked 2D case) the pick is JAX's to the last bit."""
    rng = np.random.default_rng(11)
    n = 400
    x = np.sort(rng.uniform(-2, 2, n))[:, None]
    d2 = (x - x.T) ** 2
    K = np.exp(-0.5 * d2 / 0.45**2) + 1e-8 * np.eye(n)
    y = np.linalg.cholesky(K) @ rng.standard_normal((n, 1))
    var = np.full(n, 1e-4)
    pseudo = np.linspace(-2, 2, 48)[:, None]
    best_fitc, _, _ = tms.select_scale_spgp(pseudo, x, y, var,
                                            kernel="rbf", refine=2,
                                            device=CPU)
    jbest, _, _ = jms.select_scale_spgp(pseudo, x, y, var, kernel="rbf",
                                        refine=2)
    assert abs(best_fitc - jbest) / jbest < 0.15, (best_fitc, jbest)
    _, _, vals = tms.select_scale_spgp(pseudo, x, y, var, kernel="rbf",
                                       refine=0, device=CPU)
    _, _, jvals = jms.select_scale_spgp(pseudo, x, y, var, kernel="rbf",
                                        refine=0)
    np.testing.assert_array_equal(np.isfinite(vals), np.isfinite(jvals))
    np.testing.assert_allclose(vals, jvals, rtol=1e-6)
    best_exact, _, _ = tms.select_scale(x, y, var, kernel="rbf", refine=2,
                                        device=CPU)
    assert 0.5 * best_exact < best_fitc < 2.0 * best_exact
    assert 0.25 < best_fitc < 0.9, best_fitc

    pseudo, x, y, var, mask = _spgp_problem()
    best, scales, vals = tms.select_scale_spgp(pseudo, x, y, var, mask,
                                               kernel="matern32", refine=1,
                                               device=CPU)
    jbest, jscales, jvals = jms.select_scale_spgp(pseudo, x, y, var, mask,
                                                  kernel="matern32",
                                                  refine=1)
    assert best == jbest
    np.testing.assert_array_equal(scales, jscales)
    np.testing.assert_allclose(vals, jvals, rtol=RTOL)


def _trace_problem():
    rng = np.random.default_rng(0)
    n = 120
    x = np.sort(rng.uniform(0, 2 * np.pi, n))[:, None]
    y = np.sin(x[:, 0]) + rng.normal(0, 0.01, n)
    return x, y, np.full(n, 1e-4)


def test_fit_scale_gradient_matches_sweep_optimum():
    """Descent on the exact NLML lands at the sweep's optimum, and the
    port's Adam trace follows JAX's optax trace for the same init, steps
    and lr at float64 (scales to 1e-7, NLML to 1e-7 relative)."""
    x, y, var = _trace_problem()
    best_sweep, _, _ = tms.select_scale(x, y, var, kernel="rbf", refine=2,
                                        device=CPU)
    best, scales, vals = tms.fit_scale(x, y, var, kernel="rbf", steps=120,
                                       lr=0.08, device=CPU)
    assert abs(best - best_sweep) / best_sweep < 0.1, (best, best_sweep)
    fin = vals[np.isfinite(vals)]
    assert fin[-1] <= fin[0]
    jbest, jscales, jvals = jms.fit_scale(x, y, var, kernel="rbf", steps=120,
                                          lr=0.08)
    np.testing.assert_allclose(scales, jscales, rtol=1e-7)
    np.testing.assert_allclose(vals, jvals, rtol=1e-7)
    np.testing.assert_allclose(best, jbest, rtol=1e-7)


def _grad_problem():
    rng = np.random.default_rng(1)
    n = 40
    x = rng.uniform(-1, 1, (n, 2))
    y = rng.uniform(-1, 1, (n, 1))
    var = np.full(n, 1e-3)
    mask = rng.uniform(size=n) < 0.85
    return x, y, var, mask


def test_fit_scale_gradient_is_correct():
    """The autograd gradient of the port's NLML agrees with a central
    finite difference to 1e-5 and with ``jax.grad`` of the JAX criterion."""
    x, y, var, mask = _grad_problem()
    tx, ty, tv, tm = _t(x), _t(y), _t(var), _t(mask)

    def f(ls):
        return tms.nlml_sweep(tx, ty, tv, tm, torch.exp(ls)[None],
                              kernel="matern32")[0]

    ls0 = torch.tensor(np.log(0.47), dtype=torch.float64, requires_grad=True)
    f(ls0).backward()
    g = float(ls0.grad)
    h = 1e-6
    with torch.no_grad():
        fd = float((f(ls0 + h) - f(ls0 - h)) / (2 * h))
    assert abs(g - fd) / max(1.0, abs(fd)) < 1e-5, (g, fd)

    def jf(ls):
        return jms.nlml_sweep(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(var), jnp.asarray(mask),
                              jnp.exp(ls)[None], kernel="matern32")[0]

    jg = float(jax.grad(jf)(jnp.asarray(np.log(0.47))))
    np.testing.assert_allclose(g, jg, rtol=1e-9)


@pytest.mark.parametrize("kernel", ["matern32", "rbf"])
def test_fit_scale_spgp_gradient_through_the_gram_op(kernel):
    """The SPGP criterion's gradient, which runs through ``GramScale`` (the
    gram op forward, its plain backward), against a central finite
    difference to 1e-5 and ``jax.grad`` of the JAX criterion; the fit's
    trace against JAX's."""
    pseudo, x, y, var, mask = _spgp_problem(seed=7, m_side=5, n=90)
    args = [_t(a) for a in (pseudo, x, y, var, mask)]

    def f(ls):
        return tms.nlml_sweep_spgp(*args, torch.exp(ls)[None],
                                   kernel=kernel)[0]

    ls0 = torch.tensor(np.log(0.5), dtype=torch.float64, requires_grad=True)
    f(ls0).backward()
    g = float(ls0.grad)
    h = 1e-6
    with torch.no_grad():
        fd = float((f(ls0 + h) - f(ls0 - h)) / (2 * h))
    assert abs(g - fd) / max(1.0, abs(fd)) < 1e-5, (g, fd)
    jargs = [jnp.asarray(a) for a in (pseudo, x, y, var, mask)]
    jg = float(jax.grad(lambda ls: jms.nlml_sweep_spgp(
        *jargs, jnp.exp(ls)[None], kernel=kernel)[0])(
            jnp.asarray(np.log(0.5))))
    np.testing.assert_allclose(g, jg, rtol=1e-8)

    best, scales, vals = tms.fit_scale_spgp(pseudo, x, y, var, mask,
                                            kernel=kernel, init=0.5,
                                            steps=30, device=CPU)
    jbest, jscales, jvals = jms.fit_scale_spgp(pseudo, x, y, var, mask,
                                               kernel=kernel, init=0.5,
                                               steps=30)
    np.testing.assert_allclose(scales, jscales, rtol=1e-7)
    np.testing.assert_allclose(vals, jvals, rtol=1e-7)


def test_fit_scale_nigp_recovers_golden_config_scale():
    """The NIGP fit lands in the sweep's basin, follows JAX's trace, and
    the fitted scale meets the golden-class MAE in the port's NIGP."""
    from erl_gaussian_process_tpu_torch.kernels import KernelSetting
    from erl_gaussian_process_tpu_torch.models import (
        NoisyInputGaussianProcess,
        NoisyInputGPSetting,
    )

    rng = np.random.default_rng(0)
    n = 100
    x = np.sort(rng.uniform(0, 2 * np.pi, n))[:, None]
    y = np.sin(x[:, 0]) + rng.normal(0, 1e-3, n)
    grad = np.cos(x)
    v = np.full(n, 1e-6)
    best_sweep, _, _ = tms.select_scale_nigp(x, y, grad, v, v, v,
                                             kernel="rbf", refine=2,
                                             device=CPU)
    best, _, vals = tms.fit_scale_nigp(x, y, grad, v, v, v, kernel="rbf",
                                       steps=60, lr=0.08, device=CPU)
    jbest, _, jvals = jms.fit_scale_nigp(x, y, grad, v, v, v, kernel="rbf",
                                         steps=60, lr=0.08)
    np.testing.assert_allclose(vals, jvals, rtol=1e-6)
    assert abs(best - best_sweep) / best_sweep < 0.15, (best, best_sweep)
    gp = NoisyInputGaussianProcess(NoisyInputGPSetting(
        kernel_type="rbf", kernel=KernelSetting(x_dim=1, scale=float(best)),
        max_num_samples=n), device=CPU)
    gp.train(x.T, y[:, None], grad.T, v, v, v)
    xq = np.linspace(0.3, 2 * np.pi - 0.3, 200)[None, :]
    mae = np.abs(np.asarray(gp.test(xq).get_mean(0)) - np.sin(xq[0])).mean()
    assert mae < 1e-4, mae


@pytest.mark.parametrize("kernel", ["rbf", "ou", "matern32", "mixture"])
def test_gram_op_backward_matches_autograd_through_plain(kernel):
    """``GramScale``'s backward (dK/ds in closed form, masked rows 0)
    against autograd through the plain gram with a tensor scale."""
    if kernel == "mixture":
        from erl_gaussian_process_tpu_torch.kernels import (
            register_scale_mixture,
        )
        kernel = register_scale_mixture("matern32", 1.5, (1.0, 2.0, 0.5))
    rng = np.random.default_rng(9)
    x1 = _t(rng.uniform(-1, 1, (17, 3)))
    x2 = _t(rng.uniform(-1, 1, (23, 3)))
    mask = _t(rng.random(17) < 0.7)
    w = _t(rng.standard_normal((17, 23)))
    s = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    k = GramScale.apply(kernel, x1, x2, s, mask)
    torch.testing.assert_close(
        k, cross_gram_plain(kernel, x1, x2, 0.6, mask), rtol=0, atol=0)
    (g,) = torch.autograd.grad(torch.sum(w * k), s)
    s2 = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    kp = apply_family(kernel, pairwise_sqdist(x1, x2), s2)
    kp = torch.where(mask[:, None], kp, torch.zeros_like(kp))
    (g2,) = torch.autograd.grad(torch.sum(w * kp), s2)
    torch.testing.assert_close(g, g2, rtol=1e-12, atol=0)
