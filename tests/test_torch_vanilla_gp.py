"""The port's exact GP (``erl_gaussian_process_tpu_torch/models/vanilla_gp.py``)
against the JAX package's: the reference goldens of ``tests/test_vanilla_gp.py``
at float64 (to 1e-12 of the recorded MAEs), parity with JAX's
``VanillaGaussianProcess`` on the same numpy inputs at float64 (1e-12) and
float32 (the JAX suite's f32 posterior class), the repeated-query fast path,
padding, checkpoints, conversion of a JAX checkpoint and the host jitter
retry. Everything runs on the CPU (``device="cpu"``): the plain versions of
the Cholesky and solve kernels."""

import logging

import numpy as np
import pytest

from erl_gaussian_process_tpu.kernels import KernelSetting as JaxKernelSetting
from erl_gaussian_process_tpu.models import (
    VanillaGaussianProcess as JaxVanillaGP,
)
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import (
    VanillaGaussianProcess,
    VanillaGPSetting,
)
from erl_gaussian_process_tpu_torch.utils.convert import vanilla_gp_from_numpy

NOISE_VAR = 0.001
# float32 parity: the JAX suite's f32 posterior class (tests/test_ops.py
# pins 2e-3 mean MAE for its f32 factorizations against float64)
F32_TOL = 2e-3


def _grid2d(n):
    a = np.linspace(-1.0, 1.0, n)
    xv, yv = np.meshgrid(a, a, indexing="ij")
    return np.stack([xv.ravel(), yv.ravel()], axis=0)


def _pair(kernel="rbf", scale=0.5, x_dim=1, max_num_samples=256,
          dtype=np.float64):
    """The same setting in both packages."""
    gp = VanillaGaussianProcess(VanillaGPSetting(
        kernel_type=kernel, kernel=KernelSetting(x_dim=x_dim, scale=scale),
        max_num_samples=max_num_samples), dtype=dtype, device="cpu")
    jgp = JaxVanillaGP(JaxVanillaGP.Setting(
        kernel_type=kernel, kernel=JaxKernelSetting(x_dim=x_dim, scale=scale),
        max_num_samples=max_num_samples), dtype=dtype)
    return gp, jgp


def test_single_input_single_output_golden(tmp_path):
    """test_vanilla_gp.cpp:13-110: MAE 2.4246430481069056e-4 to 1e-12;
    checkpoint round trip."""
    n = 100
    gp, _ = _pair(max_num_samples=n)
    x = np.linspace(0, 2 * np.pi, n)
    assert gp.train(x[None, :], np.sin(x), np.full(n, NOISE_VAR))
    xt = np.linspace(0, 2 * np.pi, 200)
    res = gp.test(xt[None, :])
    mae = np.abs(res.get_mean(0) - np.sin(xt)).mean()
    assert abs(mae - 2.4246430481069056e-4) < 1e-12, mae
    var = res.get_variance()
    assert var.shape == (200,) and np.all(var > 0) and \
        np.all(var < NOISE_VAR * 10)
    path = str(tmp_path / "vanilla_gp.npz")
    gp.save(path)
    gp2 = VanillaGaussianProcess(device="cpu")
    gp2.load(path)
    assert gp == gp2
    np.testing.assert_array_equal(res.get_mean(0),
                                  gp2.test(xt[None, :]).get_mean(0))


def test_multi_input_single_output_golden():
    """test_vanilla_gp.cpp:112-221: MAE 5.035569336460338e-4 to 1e-10 (the
    JAX suite's bound)."""
    n = 50
    pts = _grid2d(n)
    z = 2 * np.sin(10.0 * pts[0]) * np.cos(10.0 * pts[1])
    gp, _ = _pair(scale=0.1, x_dim=2, max_num_samples=n * n)
    assert gp.train(pts, z, np.full(n * n, NOISE_VAR))
    pt = _grid2d(100)
    mae = np.abs(gp.test(pt).get_mean(0)
                 - 2 * np.sin(10.0 * pt[0]) * np.cos(10.0 * pt[1])).mean()
    assert abs(mae - 5.035569336460338e-4) < 1e-10, mae


def test_multi_input_multi_output_golden():
    """test_vanilla_gp.cpp:223-373: both outputs under the reference's
    bounds, and equal to the JAX package's to 1e-12."""
    n = 50
    pts = _grid2d(n)
    z1 = 2 * np.sin(10.0 * pts[0]) * np.cos(10.0 * pts[1])
    z2 = 3 * (np.sin(10.0 * pts[0]) + np.cos(10.0 * pts[1]))
    gp, jgp = _pair(scale=0.1, x_dim=2, max_num_samples=n * n)
    y = np.stack([z1, z2], axis=1)
    assert gp.train(pts, y, np.full(n * n, NOISE_VAR))
    assert jgp.train(pts, y, np.full(n * n, NOISE_VAR))
    pt = _grid2d(100)
    res, jres = gp.test(pt), jgp.test(pt)
    mae1 = np.abs(res.get_mean(0)
                  - 2 * np.sin(10.0 * pt[0]) * np.cos(10.0 * pt[1])).mean()
    mae2 = np.abs(res.get_mean(1)
                  - 3 * (np.sin(10.0 * pt[0]) + np.cos(10.0 * pt[1]))).mean()
    assert mae1 < 5.1e-4 and mae2 < 1.2e-3, (mae1, mae2)
    for j in range(2):
        np.testing.assert_allclose(res.get_mean(j), jres.get_mean(j),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel", ["rbf", "matern32", "ou"])
def test_parity_with_jax_f64(kernel):
    """Mean and variance against the JAX package at float64, 1e-12."""
    rng = np.random.default_rng(0)
    n = 150
    x = rng.uniform(0, 2 * np.pi, n)
    gp, jgp = _pair(kernel=kernel)
    for m in (gp, jgp):
        assert m.train(x[None], np.sin(x), np.full(n, 1e-3))
    xt = np.linspace(0, 2 * np.pi, 70)[None]
    res, jres = gp.test(xt), jgp.test(xt)
    np.testing.assert_allclose(res.get_mean(0), jres.get_mean(0), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(res.get_variance(), jres.get_variance(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel", ["rbf", "matern32"])
def test_parity_with_jax_f32(kernel):
    """float32 (the blocked Cholesky's plain version, the Dinv-based
    whitening) against the JAX package at float32, both to the f32
    posterior class of the float64 fit."""
    rng = np.random.default_rng(1)
    n = 300
    x = rng.uniform(-1, 1, (2, n))
    y = np.sin(3 * x[0]) * np.cos(2 * x[1])
    xt = rng.uniform(-1, 1, (2, 120))
    means, variances = [], []
    for dtype in (np.float32, np.float64):
        gp, jgp = _pair(kernel=kernel, x_dim=2, dtype=dtype)
        for m in (gp, jgp):
            assert m.train(x, y, np.full(n, 1e-2))
        res, jres = gp.test(xt), jgp.test(xt)
        means.append((res.get_mean(0), jres.get_mean(0)))
        variances.append((res.get_variance(), jres.get_variance()))
    (m32, jm32), (m64, _) = means
    (v32, jv32), (v64, _) = variances
    for got in (m32, jm32):
        assert np.abs(got - m64).mean() < F32_TOL
    for got in (v32, jv32):
        assert np.abs(got - v64).max() < F32_TOL
    assert m32.dtype == np.float32


def test_repeated_variance_queries_use_consistent_fast_path():
    """From the second variance query on, whitening switches to the
    amortized L^{-1} product; the results match the solve path, the cache
    is reused and a retrain drops it (as the JAX package's)."""
    rng = np.random.default_rng(0)
    gp, jgp = _pair(scale=0.3)
    x = np.sort(rng.uniform(-1, 1, 120))[None, :]
    xq = np.linspace(-0.8, 0.8, 75)[None, :]
    for m in (gp, jgp):
        m.train(x, np.sin(3 * x[0])[:, None], np.full(120, 1e-4))
    v1 = gp.test(xq).get_variance()
    assert gp._L_inv is None
    v2 = gp.test(xq).get_variance()
    assert gp._L_inv is not None
    v3 = gp.test(xq + 0.01).get_variance()
    np.testing.assert_allclose(v2, v1, rtol=1e-9, atol=1e-12)
    jgp.test(xq).get_variance()
    np.testing.assert_allclose(v3, jgp.test(xq + 0.01).get_variance(),
                               rtol=0, atol=1e-12)
    gp.train(x, np.cos(2 * x[0])[:, None], np.full(120, 1e-4))
    assert gp._L_inv is None and gp._var_queries == 0


def test_padded_equals_exact():
    """Identity padding does not change results against an exact-size fit."""
    rng = np.random.default_rng(0)
    n = 37
    x = rng.uniform(0, 2 * np.pi, n)
    g1, _ = _pair(max_num_samples=n)
    g2, _ = _pair(max_num_samples=64)
    g1.train(x[None], np.sin(x), 1e-3)
    g2.train(x[None], np.sin(x), 1e-3)
    xt = np.linspace(0, 2 * np.pi, 50)[None]
    np.testing.assert_allclose(g1.test(xt).get_mean(0),
                               g2.test(xt).get_mean(0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(g1.test(xt).get_variance(),
                               g2.test(xt).get_variance(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_conversion_from_a_jax_checkpoint(dtype):
    """A JAX ``state_dict`` becomes the port's model at the checkpoint's
    dtype, with the same state and predictions; the train set carries over,
    so the converted model retrains."""
    rng = np.random.default_rng(2)
    _, jgp = _pair(x_dim=2, dtype=dtype)
    x = rng.uniform(-1, 1, (2, 60))
    jgp.train(x, np.sin(x[0]), np.full(60, 1e-2))
    gp = vanilla_gp_from_numpy(jgp.state_dict(), device="cpu")
    assert gp.dtype == np.dtype(dtype) and gp.is_trained
    xt = rng.uniform(-1, 1, (2, 30))
    tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(gp.test(xt).get_mean(0),
                               jgp.test(xt).get_mean(0), rtol=0, atol=tol)
    np.testing.assert_allclose(gp.test(xt).get_variance(),
                               jgp.test(xt).get_variance(), rtol=0,
                               atol=tol * 10)
    gp.reset(256, 2, 1)
    assert gp.train()


def test_host_jitter_retry_escalates_on_a_failed_fit(caplog):
    """Two coincident samples at zero noise leave the gram singular: the
    fit's NaN makes the host retry escalate to jitter 1e-10 with a warning,
    as the JAX package does, and both packages agree."""
    x = np.array([[0.0, 0.0, 1.0]])
    y = np.array([1.0, 1.0, -1.0])
    gp, jgp = _pair(max_num_samples=3)
    with caplog.at_level(logging.WARNING):
        assert gp.train(x, y, 0.0)
    assert "jitter 1e-10" in caplog.text
    jgp.train(x, y, 0.0)
    xt = np.array([[0.0, 0.5, 1.0]])
    np.testing.assert_allclose(gp.test(xt).get_mean(0),
                               jgp.test(xt).get_mean(0), rtol=1e-6,
                               atol=1e-9)
    assert np.isfinite(gp.state.alpha.numpy()).all()


def test_train_guards_and_reduced_rank_kernels():
    """train() without data or twice warns and returns False; a
    reduced-rank kernel type named by its C++-style name builds its basis
    and predicts as JAX's does (float64, 1e-12)."""
    gp, _ = _pair()
    assert gp.test(np.zeros((1, 3))) is None
    assert not gp.train()
    x = np.linspace(0, 1, 10)
    assert gp.train(x[None], x, 1e-2)
    assert not gp.train()
    gp.reset(10, 1, 1)
    assert gp.train() and gp.get_memory_usage() > 0
    rr = VanillaGaussianProcess(VanillaGPSetting(
        kernel_type="ReducedRankRbf"), device="cpu")
    jrr = JaxVanillaGP(JaxVanillaGP.Setting(kernel_type="ReducedRankRbf"))
    assert rr.reduced_rank_kernel and rr._kernel == "rbf"
    xr = np.linspace(-0.8, 0.8, 40)
    for m in (rr, jrr):
        assert m.train(xr[None], np.sin(3 * xr), 1e-2)
    assert tuple(rr.state.L.shape) == (32, 32)
    xq = np.linspace(-0.7, 0.7, 21)[None]
    a, b = rr.test(xq), jrr.test(xq)
    ref = b.get_mean(0)
    np.testing.assert_allclose(a.get_mean(0), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    ref = b.get_variance()
    np.testing.assert_allclose(a.get_variance(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    assert (a.get_variance() > 0).all()
