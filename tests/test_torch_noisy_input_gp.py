"""The port's noisy-input GP and joint value/gradient grams
(``erl_gaussian_process_tpu_torch/models/noisy_input_gp.py``,
``kernels/gradient.py``) against the JAX package's: the gradient blocks and
joint grams at float64 to 1e-12, the reference goldens of
``tests/test_noisy_input_gp.py`` at their tolerances (the two 7500^2 cases
behind ``ERL_GP_HEAVY=1``, as there), parity with JAX's class at float64
(1e-10) and float32 (the f32 posterior class), ``grad_flag`` masking
against a packed dense reference, the float32 sample-budget padding and
conversion of a JAX checkpoint. Everything runs on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erl_gaussian_process_tpu.kernels import KernelSetting as JaxKernelSetting
from erl_gaussian_process_tpu.kernels import gradient as jgrad
from erl_gaussian_process_tpu.kernels.stationary import (
    register_scale_mixture as jax_register_scale_mixture,
)
from erl_gaussian_process_tpu.models import (
    NoisyInputGaussianProcess as JaxNIGP,
)
from erl_gaussian_process_tpu_torch.kernels import (
    KernelSetting,
    register_scale_mixture,
)
from erl_gaussian_process_tpu_torch.kernels import gradient as tgrad
from erl_gaussian_process_tpu_torch.models import (
    NoisyInputGaussianProcess,
    NoisyInputGPSetting,
)
from erl_gaussian_process_tpu_torch.utils.convert import (
    noisy_input_gp_from_numpy,
)
from erl_gaussian_process_tpu_torch.workloads import (
    NIGP_GOLDEN_BOUNDS,
    NIGP_GOLDEN_RECORDED,
    nigp_golden_workload,
)

NOISE_VAR = 1e-4
MIX = ("rbf", 0.5, (0.7, 0.3))
# float32 parity: the JAX suite's f32 posterior class (2e-3 mean MAE)
F32_TOL = 2e-3
HEAVY = pytest.mark.skipif(os.environ.get("ERL_GP_HEAVY") != "1",
                           reason="7500^2 joint system, ~50 s on CPU f64 — "
                                  "run with ERL_GP_HEAVY=1")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _family(name):
    if name == "mix":
        name = register_scale_mixture(*MIX)
        assert jax_register_scale_mixture(*MIX) == name
    return name


def _pair(setting_kw, kernel_kw, dtype=np.float64):
    gp = NoisyInputGaussianProcess(NoisyInputGPSetting(
        kernel=KernelSetting(**kernel_kw), **setting_kw), dtype=dtype,
        device="cpu")
    jgp = JaxNIGP(JaxNIGP.Setting(kernel=JaxKernelSetting(**kernel_kw),
                                  **setting_kw), dtype=dtype)
    return gp, jgp


def _values_1d(x):
    return np.sin(2 * x), 2 * np.cos(2 * x)


def _grid_pts(n, xmin, xmax, ymin, ymax):
    xs = np.linspace(xmin, xmax, n)
    ys = np.linspace(ymin, ymax, n)
    return np.array([[x, y] for x in xs for y in ys]).T


# -- kernels/gradient.py ----------------------------------------------------

@pytest.mark.parametrize("fam", ["rbf", "matern32", "mix"])
def test_gradient_blocks_and_grams_match_jax(fam):
    """k, dk/dx2, d2k/dx1dx2; the joint train gram with masks and noise; the
    cross gram in all four (train grad, test grad) combinations: 1e-12."""
    fam = _family(fam)
    rng = np.random.default_rng(1)
    x1, x2 = rng.uniform(-1, 1, (7, 2)), rng.uniform(-1, 1, (5, 2))
    for a, b in zip(tgrad._blocks(fam, *map(torch.as_tensor, (x1, x2)), 0.37),
                    jgrad._blocks(fam, jnp.asarray(x1), jnp.asarray(x2),
                                  0.37)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-12)
    vx, vy, vg = (rng.uniform(1e-3, 1e-2, 7) for _ in range(3))
    sm, gm = rng.random(7) < 0.8, rng.random(7) < 0.6
    K = tgrad.train_gram_with_gradient(
        fam, *map(torch.as_tensor, (x1, vx, vy, vg, sm, gm)), 0.37)
    jK = jgrad.train_gram_with_gradient(
        fam, *map(jnp.asarray, (x1, vx, vy, vg, sm, gm)), 0.37)
    np.testing.assert_allclose(_np(K), _np(jK), rtol=0, atol=1e-12)
    for tg in (True, False):
        for trg in (True, False):
            kt = tgrad.cross_gram_with_gradient(
                fam, torch.as_tensor(x1), torch.as_tensor(x2), 0.37,
                torch.as_tensor(sm), torch.as_tensor(gm), tg, trg)
            jkt = jgrad.cross_gram_with_gradient(
                fam, jnp.asarray(x1), jnp.asarray(x2), 0.37,
                jnp.asarray(sm), jnp.asarray(gm), tg, trg)
            np.testing.assert_allclose(_np(kt), _np(jkt), rtol=0, atol=1e-12)
    assert tgrad.gradient_prior_variance(0.37) == \
        jgrad.gradient_prior_variance(0.37)


def test_ou_has_no_gradient_gram():
    x = torch.zeros((3, 2), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="OU"):
        tgrad._blocks("ou", x, x, 1.0)
    with pytest.raises(NotImplementedError, match="OU"):
        tgrad._blocks(register_scale_mixture("ou", 0.5, (1.0, 1.0)), x, x,
                      1.0)


# -- the reference goldens (float64) ----------------------------------------

def test_1d_with_gradient_golden(tmp_path):
    """test_noisy_input_gp.cpp:13-186: MAEs 4.1624e-6 / 7.1391e-5 to
    1e-13 / 1e-12; variance surfaces; checkpoint round trip."""
    n = 100
    gp, _ = _pair(dict(kernel_type="rbf", max_num_samples=n),
                  dict(x_dim=1, scale=0.2))
    x = np.linspace(0, 2 * np.pi, n)
    y, g = _values_1d(x)
    assert gp.train(x[None], y, g[None], var_x=NOISE_VAR, var_y=NOISE_VAR,
                    var_grad=NOISE_VAR)
    xt = np.linspace(0, 2 * np.pi, 200)
    yt, gt = _values_1d(xt)
    res = gp.test(xt[None], predict_gradient=True)
    mae = np.abs(res.get_mean(0) - yt).mean()
    mae_g = np.abs(res.get_gradient(0)[0] - gt).mean()
    assert abs(mae - 4.1624286843223515e-06) < 1e-13, mae
    assert abs(mae_g - 7.139121709502966e-05) < 1e-12, mae_g
    mv, gv, cov = (res.get_mean_variance(), res.get_gradient_variance(),
                   res.get_covariance())
    assert mv.shape == (200,) and np.all(mv > 0)
    assert gv.shape == (1, 200) and np.all(gv > 0) and cov.shape == (1, 200)
    path = str(tmp_path / "nigp.npz")
    gp.save(path)
    gp2 = NoisyInputGaussianProcess(device="cpu")
    gp2.load(path)
    assert gp == gp2


def test_1d_without_gradient_golden():
    """test_noisy_input_gp.cpp:188-352: MAEs 7.3775e-5 / 2.4348e-3 to
    1e-12 / 1e-11."""
    n = 100
    gp, _ = _pair(dict(kernel_type="rbf", max_num_samples=n,
                       no_gradient_observation=True),
                  dict(x_dim=1, scale=0.2))
    x = np.linspace(0, 2 * np.pi, n)
    y, _ = _values_1d(x)
    assert gp.train(x[None], y, var_x=NOISE_VAR, var_y=NOISE_VAR)
    xt = np.linspace(0, 2 * np.pi, 200)
    yt, gt = _values_1d(xt)
    res = gp.test(xt[None], predict_gradient=True)
    assert abs(np.abs(res.get_mean(0) - yt).mean()
               - 7.377464439757659e-05) < 1e-12
    assert abs(np.abs(res.get_gradient(0)[0] - gt).mean()
               - 0.0024347632450979033) < 1e-11


def test_2d_without_gradient_full_reference_size():
    """test_noisy_input_gp.cpp:561-760 (50x50 grid, scale 0.15): MAEs to
    1e-13 / 1e-12."""
    pts = _grid_pts(50, -2, 2, -1, 1)
    z = 2 * np.sin(10 * pts[0]) * np.cos(5 * pts[1])
    gp, _ = _pair(dict(kernel_type="rbf", max_num_samples=2500,
                       no_gradient_observation=True),
                  dict(x_dim=2, scale=0.15))
    assert gp.train(pts, z, var_x=NOISE_VAR, var_y=NOISE_VAR)
    qt = _grid_pts(100, -2, 2, -1, 1)
    res = gp.test(qt, predict_gradient=True)
    mae = np.abs(res.get_mean(0)
                 - 2 * np.sin(10 * qt[0]) * np.cos(5 * qt[1])).mean()
    g = res.get_gradient(0)
    mx = np.abs(g[0] - 20 * np.cos(10 * qt[0]) * np.cos(5 * qt[1])).mean()
    my = np.abs(g[1] + 10 * np.sin(10 * qt[0]) * np.sin(5 * qt[1])).mean()
    assert abs(mae - 0.0003368450993049195) < 1e-13, mae
    assert abs(mx - 0.009407525172327099) < 1e-12, mx
    assert abs(my - 0.014184702590183184) < 1e-12, my


def test_2d_two_output_without_gradient_full_reference_size():
    """test_noisy_input_gp.cpp:1004-end (50x50 on [-1,1]^2, scale 0.1):
    output-0 MAEs to 1e-13 / 1e-12."""
    pts = _grid_pts(50, -1, 1, -1, 1)
    z1 = 2 * np.sin(10 * pts[0]) * np.cos(10 * pts[1])
    z2 = 3 * (np.sin(10 * pts[0]) + np.cos(10 * pts[1]))
    gp, _ = _pair(dict(kernel_type="rbf", max_num_samples=2500,
                       no_gradient_observation=True),
                  dict(x_dim=2, scale=0.1))
    assert gp.train(pts, np.stack([z1, z2], axis=-1), var_x=NOISE_VAR,
                    var_y=NOISE_VAR)
    qt = _grid_pts(100, -1, 1, -1, 1)
    res = gp.test(qt, predict_gradient=True)
    z1t = 2 * np.sin(10 * qt[0]) * np.cos(10 * qt[1])
    g0 = res.get_gradient(0)
    assert abs(np.abs(res.get_mean(0) - z1t).mean()
               - 0.000250581062775504) < 1e-13
    assert abs(np.abs(g0[0] - 20 * np.cos(10 * qt[0]) * np.cos(10 * qt[1])
                      ).mean() - 0.014144193031284197) < 1e-12
    assert abs(np.abs(g0[1] + 20 * np.sin(10 * qt[0]) * np.sin(10 * qt[1])
                      ).mean() - 0.010989238198062933) < 1e-12


@HEAVY
def test_2d_with_gradient_full_reference_size():
    """test_noisy_input_gp.cpp:354-560: the 7500^2 joint system; under the
    reference's bounds and equal to its recorded values to 1e-12 / 1e-11."""
    setting, pts, z, grad, noise, qt, zt, gt = nigp_golden_workload()
    gp = NoisyInputGaussianProcess(setting, device="cpu")
    assert gp.train(pts, z, grad, var_x=noise, var_y=noise, var_grad=noise)
    res = gp.test(qt, predict_gradient=True)
    g = res.get_gradient(0)
    got = (np.abs(res.get_mean(0) - zt).mean(), np.abs(g[0] - gt[0]).mean(),
           np.abs(g[1] - gt[1]).mean())
    assert all(a < b for a, b in zip(got, NIGP_GOLDEN_BOUNDS)), got
    for a, r, tol in zip(got, NIGP_GOLDEN_RECORDED, (1e-12, 1e-11, 1e-11)):
        assert abs(a - r) < tol, (a, r)


@HEAVY
def test_2d_two_output_with_gradient_full_reference_size():
    """test_noisy_input_gp.cpp:763-1002: both outputs with gradients, all
    six recorded MAEs to 1e-12 / 1e-11."""
    pts = _grid_pts(50, -1, 1, -1, 1)

    def values(q):
        z1 = 2 * np.sin(10 * q[0]) * np.cos(10 * q[1])
        z2 = 3 * (np.sin(10 * q[0]) + np.cos(10 * q[1]))
        g = [(20 * np.cos(10 * q[0]) * np.cos(10 * q[1]),
              -20 * np.sin(10 * q[0]) * np.sin(10 * q[1])),
             (30 * np.cos(10 * q[0]), -30 * np.sin(10 * q[1]))]
        return z1, z2, g
    z1, z2, g = values(pts)
    gp, _ = _pair(dict(kernel_type="rbf", max_num_samples=2500),
                  dict(x_dim=2, scale=0.15))
    assert gp.train(pts, np.stack([z1, z2], axis=-1),
                    np.stack([g[0][0], g[0][1], g[1][0], g[1][1]]),
                    var_x=NOISE_VAR, var_y=NOISE_VAR, var_grad=NOISE_VAR)
    qt = _grid_pts(100, -1, 1, -1, 1)
    z1t, z2t, gt = values(qt)
    res = gp.test(qt, predict_gradient=True)
    recorded = [(6.205702021195462e-06, 0.00016324462241659358,
                 0.0002209177886253753),
                (1.1967913545722718e-05, 0.000292787449896784,
                 0.00034572267944076794)]
    for d, ztt in enumerate([z1t, z2t]):
        gg = res.get_gradient(d)
        got = (np.abs(res.get_mean(d) - ztt).mean(),
               np.abs(gg[0] - gt[d][0]).mean(),
               np.abs(gg[1] - gt[d][1]).mean())
        for a, r, tol in zip(got, recorded[d], (1e-12, 1e-11, 1e-11)):
            assert abs(a - r) < tol, (d, a, r)


# -- parity with the JAX package's class ------------------------------------

def _nigp_data(rng, n=40):
    x = np.sort(rng.uniform(-1, 1, (2, n)), axis=1)
    y = np.sin(3 * x[0]) * np.cos(2 * x[1])
    grad = np.stack([3 * np.cos(3 * x[0]) * np.cos(2 * x[1]),
                     -2 * np.sin(3 * x[0]) * np.sin(2 * x[1])])
    return x, y, grad, rng.uniform(-1, 1, (2, 25))


def _outputs(res):
    return (res.get_mean(0), res.get_gradient(0), res.get_mean_variance(),
            res.get_gradient_variance(), res.get_covariance())


@pytest.mark.parametrize("kernel", ["rbf", "matern32", "mix"])
@pytest.mark.parametrize("no_grad", [False, True])
def test_parity_with_jax_f64(kernel, no_grad):
    """Mean, gradient, variances and covariances against the JAX package at
    float64 (1e-10), then the repeated-query fast path (second query)."""
    kernel = _family(kernel)
    rng = np.random.default_rng(4)
    x, y, grad, xt = _nigp_data(rng)
    kw = dict(kernel_type="rbf", max_num_samples=40,
              no_gradient_observation=no_grad)
    kkw = dict(x_dim=2, scale=0.5)
    if kernel not in ("rbf",):
        kw["kernel_type"] = "matern32" if kernel == "matern32" else "rbf"
        if kernel != "matern32":
            kkw.update(scale_mix=0.5, weights=[0.7, 0.3])
    gp, jgp = _pair(kw, kkw)
    assert gp._kernel == kernel
    for m in (gp, jgp):
        assert m.train(x, y, grad, var_x=1e-4, var_y=1e-3, var_grad=1e-3)
    for _ in range(2):       # the second query takes the L^{-1} product
        for a, b in zip(_outputs(gp.test(xt, True)),
                        _outputs(jgp.test(xt, True))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    assert gp._L_inv is not None


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_parity_with_jax_f32(kernel):
    """float32 against the JAX package at float32 (the joint gram-fused
    Cholesky's plain version, the Dinv whitening): both within the f32
    posterior class of the float64 fit."""
    rng = np.random.default_rng(5)
    x, y, grad, xt = _nigp_data(rng, 60)
    kw = dict(kernel_type=kernel, max_num_samples=60)
    outs = {}
    for dtype in (np.float32, np.float64):
        gp, jgp = _pair(kw, dict(x_dim=2, scale=0.5), dtype)
        for m in (gp, jgp):
            assert m.train(x, y, grad, var_x=1e-4, var_y=1e-2, var_grad=1e-2)
        outs[dtype] = (_outputs(gp.test(xt, True)),
                       _outputs(jgp.test(xt, True)))
    ref = outs[np.float64][0]
    for got in outs[np.float32]:
        for a, r in zip(got, ref):
            assert np.abs(a - r).max() / max(1.0, np.abs(r).max()) < F32_TOL


def test_grad_flag_masking_matches_packed():
    """Samples with grad_flag 0 behave as if their gradient rows were never
    in the system (the reference packs them out; here identity rows)."""
    rng = np.random.default_rng(2)
    n = 24
    x = np.sort(rng.uniform(0, 2 * np.pi, n))
    y, g = _values_1d(x)
    flag = rng.uniform(size=n) < 0.5
    gp, _ = _pair(dict(kernel_type="rbf", max_num_samples=n),
                  dict(x_dim=1, scale=0.4))
    gp.train(x[None], y, g[None], var_x=1e-4, var_y=1e-4, var_grad=1e-4,
             grad_flag=flag)
    xt = np.linspace(0, 2 * np.pi, 50)
    s = 0.4

    def k(a, b):
        return np.exp(-(a[:, None] - b[None, :]) ** 2 / (2 * s * s))

    def dk(a, b):
        return (a[:, None] - b[None, :]) / (s * s) * k(a, b)

    def d2k(a, b):
        return (1 / (s * s) - (a[:, None] - b[None, :]) ** 2 / s ** 4) \
            * k(a, b)
    xf = x[flag]
    K = np.block([
        [k(x, x) + np.diag(np.full(n, 2e-4)), dk(x, xf)],
        [-dk(xf, x), d2k(xf, xf) + np.diag(np.full(flag.sum(), 1e-4))]])
    alpha = np.linalg.solve(K, np.concatenate([y, g[flag]]))
    ktm = np.vstack([k(x, xt), -dk(xf, xt)])
    np.testing.assert_allclose(gp.test(xt[None], True).get_mean(0),
                               ktm.T @ alpha, atol=1e-10)


def test_f32_sample_budget_padding_keeps_the_jax_shapes():
    """At float32 a budget >= 256 pads to a multiple of 128, as in the JAX
    package (its states and checkpoints keep those shapes); the padded rows
    are identity rows, so the posterior matches the unpadded float64 fit."""
    rng = np.random.default_rng(6)
    x, y, grad, xt = _nigp_data(rng, 50)
    kw = dict(kernel_type="rbf", max_num_samples=300)
    gp, jgp = _pair(kw, dict(x_dim=2, scale=0.5), np.float32)
    for m in (gp, jgp):
        m.train(x, y, grad, var_x=1e-4, var_y=1e-2, var_grad=1e-2)
    assert gp.setting.max_num_samples == jgp.setting.max_num_samples == 384
    assert gp.state.L.shape == tuple(np.asarray(jgp.state.L).shape) \
        == (3 * 384, 3 * 384)
    ref, _ = _pair(dict(kernel_type="rbf", max_num_samples=50),
                   dict(x_dim=2, scale=0.5))
    ref.train(x, y, grad, var_x=1e-4, var_y=1e-2, var_grad=1e-2)
    np.testing.assert_allclose(gp.test(xt, True).get_mean(0),
                               ref.test(xt, True).get_mean(0), atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_conversion_from_a_jax_checkpoint(dtype):
    """A JAX ``state_dict`` becomes the port's model at its dtype, with the
    same predictions; it retrains from the carried train set."""
    rng = np.random.default_rng(7)
    x, y, grad, xt = _nigp_data(rng)
    _, jgp = _pair(dict(kernel_type="matern32", max_num_samples=40),
                   dict(x_dim=2, scale=0.5), dtype)
    jgp.train(x, y, grad, var_x=1e-4, var_y=1e-2, var_grad=1e-2)
    gp = noisy_input_gp_from_numpy(jgp.state_dict(), device="cpu")
    assert gp.dtype == np.dtype(dtype) and gp.is_trained
    tol = 1e-10 if dtype == np.float64 else 1e-4
    for a, b in zip(_outputs(gp.test(xt, True)),
                    _outputs(jgp.test(xt, True))):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    gp.reset(40, 2, 1)
    assert gp.update_ktrain() and gp.k_train.shape == (120, 120)
    assert gp.get_train_set().num_samples_with_grad == 40
    # a plain kernel has no coord origin, in both packages
    for m in (gp, jgp):
        with pytest.raises(AssertionError, match="not a reduced-rank"):
            m.kernel_origin
    # a reduced-rank checkpoint: its basis rebuilt from the setting, the
    # (m, m) state carried, the same predictions
    from erl_gaussian_process_tpu.kernels import ReducedRankSetting
    jrr = JaxNIGP(JaxNIGP.Setting(
        kernel_type="rr_matern32", max_num_samples=40,
        kernel=ReducedRankSetting(x_dim=2, scale=0.5, num_basis=[9, 8],
                                  boundary=[2.0, 2.0],
                                  coord_origin=[0.0, 0.1])), dtype=dtype)
    jrr.train(x, y, grad, var_x=1e-4, var_y=1e-2, var_grad=1e-2)
    rr = noisy_input_gp_from_numpy(jrr.state_dict(), device="cpu")
    assert rr.using_reduced_rank_kernel() and rr.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(rr.kernel_origin, jrr.kernel_origin)
    assert rr.cholesky_k_train.shape == (72, 72)
    for a, b in zip(_outputs(rr.test(xt, True)),
                    _outputs(jrr.test(xt, True))):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(np.abs(b).max(), 1.0))
