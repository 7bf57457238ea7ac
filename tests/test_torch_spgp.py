"""The PyTorch port's SPGP (erl_gaussian_process_tpu_torch/models/
sparse_pseudo_input_gp.py) against the JAX package on the same inputs,
made from a numpy seed: the functional core and the class at float64
(1e-12 of each result's magnitude), the class at float32, the Kahan
accumulation, the tiered prepare, and state carried over from JAX."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.models.sparse_pseudo_input_gp as jsp
from erl_gaussian_process_tpu.kernels import KernelSetting as JaxKernelSetting
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import gp_core
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SparsePseudoInputGaussianProcess,
    SpGpSetting,
    fitc_variance,
    spgp_init,
    spgp_predict,
    spgp_prepare,
    spgp_prepare_exact_host,
    spgp_update,
    tri_inv,
)
from erl_gaussian_process_tpu_torch.utils.convert import spgp_state_from_numpy

SCALE = 0.7


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _batches(rng, k, n, d=3, q=1, dtype=np.float64, var=1e-2):
    out = []
    for _ in range(k):
        x = rng.uniform(-2, 2, (n, d)).astype(dtype)
        y = rng.uniform(-1, 1, (n, q)).astype(dtype)
        mask = rng.uniform(size=n) < 0.85
        out.append((x, y, np.full(n, var, dtype), mask))
    return out


def _settings(**kw):
    base = dict(kernel_type="matern32", max_num_samples=128)
    base.update(kw)
    return (jsp.SpGpSetting(kernel=JaxKernelSetting(x_dim=3, scale=SCALE),
                            **base),
            SpGpSetting(kernel=KernelSetting(x_dim=3, scale=SCALE), **base))


def test_functional_core_matches_jax_f64():
    """init -> 3 updates -> prepare -> predict (mean and FITC variance)."""
    rng = np.random.default_rng(0)
    pseudo = rng.uniform(-2, 2, (60, 3))
    jst = jsp.spgp_init(jnp.asarray(pseudo), np.float64(SCALE),
                        kernel="matern32")
    tst = spgp_init(torch.tensor(pseudo), SCALE, kernel="matern32")
    for name in ("L_km", "L_inv", "qm"):
        _close(getattr(tst, name), getattr(jst, name), 1e-12)
    for x, y, var, mask in _batches(rng, 3, 100, q=2):
        jst = jsp.spgp_update(jst, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(var), jnp.asarray(mask),
                              np.float64(SCALE), kernel="matern32")
        tst = spgp_update(tst, *[torch.tensor(a) for a in (x, y, var, mask)],
                          SCALE, kernel="matern32")
    # (the Kahan compensation buffers hold rounding residues, which differ
    # with the summation order; the compensated sums agree)
    for name in ("qm", "alpha"):
        _close(getattr(tst, name), getattr(jst, name), 1e-12)
        _close(getattr(tst, name) - getattr(tst, name + "_c"),
               np.asarray(getattr(jst, name)) - np.asarray(
                   getattr(jst, name + "_c")), 1e-12)
    jL, ja = jsp.spgp_prepare(jst)
    tL, ta = spgp_prepare(tst)
    _close(tL, jL, 1e-12)
    _close(ta, ja, 1e-12)
    xq = rng.uniform(-2, 2, (50, 3))
    jm, _, jv = jsp.spgp_predict(jst, jL, ja, jnp.asarray(xq),
                                 np.float64(SCALE), kernel="matern32")
    tm, tg, tv = spgp_predict(tst, tL, ta, torch.tensor(xq), SCALE,
                              kernel="matern32")
    assert tg is None and tm.shape == (50, 2) and tv.shape == (50,)
    _close(tm, jm, 1e-12)
    _close(tv, jv, 1e-12)
    # the amortized-inverse variance path agrees with the exact solve
    _close(fitc_variance(tst.L_inv, tL, torch.tensor(np.asarray(
        jsp.cross_gram("matern32", jst.pseudo, jnp.asarray(xq),
                       np.float64(SCALE)))), li_qm=tri_inv(tL)), jv, 1e-12)


@pytest.mark.parametrize("config", ["dense", "diagonal_qm", "use_sparse"])
def test_class_matches_jax_f64(config):
    kw = {"dense": {}, "diagonal_qm": {"diagonal_qm": True},
          "use_sparse": {"use_sparse": True,
                         "sparse_zero_threshold": 1e-3}}[config]
    js, ts = _settings(**kw)
    rng = np.random.default_rng(1)
    pseudo = rng.uniform(-2, 2, (3, 50))          # (d, M) reference layout
    jgp = jsp.SparsePseudoInputGaussianProcess(js, pseudo, dtype=np.float64)
    tgp = SparsePseudoInputGaussianProcess(ts, pseudo, dtype=np.float64)
    assert tgp._zero_threshold == jgp._zero_threshold
    for x, y, var, _ in _batches(rng, 3, 90):
        jgp.update(x.T, y, var)
        tgp.update(x.T, y, var)
    _close(tgp.mat_qm, jgp.mat_qm, 1e-12)
    _close(tgp.mat_alpha, jgp.mat_alpha, 1e-12)
    _close(tgp.mat_l_qm, jgp.mat_l_qm, 1e-12)
    xq = rng.uniform(-2, 2, (3, 40))
    jr, tr = jgp.test(xq), tgp.test(xq)
    _close(tr.get_mean(0), jr.get_mean(0), 1e-12)
    _close(tr.get_variance(), jr.get_variance(), 1e-12)


def test_class_matches_jax_f32():
    """float32 states are far-point padded to 128 rows in both packages;
    the two run exact-float32 products in different summation orders."""
    js, ts = _settings()
    rng = np.random.default_rng(2)
    pseudo = rng.uniform(-2, 2, (3, 50))
    jgp = jsp.SparsePseudoInputGaussianProcess(js, pseudo, dtype=np.float32)
    tgp = SparsePseudoInputGaussianProcess(ts, pseudo, dtype=np.float32)
    assert tgp.state.qm.shape == (128, 128) == jgp.state.qm.shape
    for x, y, var, _ in _batches(rng, 3, 90, dtype=np.float32):
        jgp.update(x.T, y, var)
        tgp.update(x.T, y, var)
    _close(tgp.mat_qm, jgp.mat_qm, 1e-5)
    xq = rng.uniform(-2, 2, (3, 40)).astype(np.float32)
    _close(tgp.test(xq).get_mean(0), jgp.test(xq).get_mean(0), 1e-4)
    _close(tgp.test(xq).get_variance(), jgp.test(xq).get_variance(), 1e-4)


def test_state_tensors_are_contiguous():
    """The CUDA kernels read the state in place and refuse strided
    tensors, so init, update and load must keep every tensor row-major."""
    _, ts = _settings()
    rng = np.random.default_rng(3)
    gp = SparsePseudoInputGaussianProcess(ts, rng.uniform(-2, 2, (3, 40)),
                                          dtype=np.float32)
    assert all(t.is_contiguous() for t in gp.state)
    x, y, var, _ = _batches(rng, 1, 30, dtype=np.float32)[0]
    gp.update(x.T, y, var)
    assert all(t.is_contiguous() for t in gp.state)
    gp.load_state_dict(gp.state_dict())
    assert all(t.is_contiguous() for t in gp.state)


def test_kahan_accumulation_survives_eager_torch():
    """Mirror of test_kahan_accumulation_survives_xla: 4096 below-ulp
    increments onto 1e8 in float32 — plain addition loses every one, the
    compensated pair recovers the exact sum."""
    s = torch.full((8, 128), 1e8, dtype=torch.float32)
    c = torch.zeros_like(s)
    plain = s.clone()
    d = torch.ones_like(s)
    for _ in range(4096):
        s, c = gp_core.kahan_add(s, c, d)
        plain = plain + d
    assert float(plain[0, 0]) == 1e8
    got = s.double() - c.double()
    assert torch.equal(got, torch.full((8, 128), 1e8 + 4096,
                                       dtype=torch.float64))


def test_long_horizon_compensated_accumulation_exact_sum():
    """Identical updates give bitwise-identical increments, so the exact
    sum is K_M + T dq; the compensated pair tracks it with no growth in T."""
    rng = np.random.default_rng(0)
    pseudo = torch.tensor(rng.uniform(-1, 1, (32, 2)).astype(np.float32))
    x, y = (torch.tensor(rng.uniform(-1, 1, (64, k)).astype(np.float32))
            for k in (2, 1))
    var = torch.full((64,), 1e-3, dtype=torch.float32)
    mask = torch.ones(64, dtype=torch.bool)
    st = spgp_init(pseudo, 0.4, kernel="matern32")
    km = st.qm.double()
    st = spgp_update(st, x, y, var, mask, 0.4, kernel="matern32")
    dq = st.qm.double() - st.qm_c.double() - km
    T = 600
    for _ in range(T - 1):
        st = spgp_update(st, x, y, var, mask, 0.4, kernel="matern32")
    exact = km + T * dq
    scale = float(exact.abs().max())
    comp_err = float((st.qm.double() - st.qm_c.double() - exact).abs().max())
    raw_err = float((st.qm.double() - exact).abs().max())
    assert comp_err / scale < 1e-6, (comp_err / scale, raw_err / scale)
    assert float(st.qm_c.abs().max()) > 0
    assert comp_err <= raw_err


def _ill_conditioned_gp():
    """The same 24 samples re-observed 400 times at tiny noise: Q_M's
    conditioning walks past 1/eps_f32 (the JAX suite's
    test_prepare_exact_host_refactorization_no_jitter setup)."""
    rng = np.random.default_rng(3)
    pseudo = rng.uniform(-1, 1, (2, 48))
    gp = SparsePseudoInputGaussianProcess(
        SpGpSetting(kernel_type="matern32",
                    kernel=KernelSetting(x_dim=2, scale=0.6),
                    max_num_samples=32), pseudo, dtype=np.float32)
    x = rng.uniform(-1, 1, (24, 2)).astype(np.float32)
    y = rng.uniform(-1, 1, (24, 1)).astype(np.float32)
    for _ in range(400):
        gp.update(x.T, y, np.float32(1e-6))
    return gp, rng


def test_prepare_escalates_to_exact_host_refactorization(caplog):
    gp, rng = _ill_conditioned_gp()
    assert np.linalg.cond(gp.state.qm.double().numpy()) > 3e7
    with caplog.at_level(logging.INFO, "erl_gaussian_process_tpu_torch"):
        mean = gp.test(rng.uniform(-1, 1, (16, 2)).astype(np.float32).T
                       ).get_mean(0)
    assert torch.isfinite(mean).all()
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    assert any("exact float64 host" in r.getMessage() for r in caplog.records)
    # the exact tier is numpy/scipy float64 in both packages: same state in,
    # same factor out
    tL, ta = spgp_prepare_exact_host(gp.state)
    jL, ja = jsp.spgp_prepare_exact_host(jsp.SpGpState(
        **{k: jnp.asarray(v) for k, v in gp.state_dict()["state"].items()}))
    _close(tL, jL, 1e-6)
    _close(ta, ja, 1e-6)


def test_escalation_boundary(monkeypatch, caplog):
    """ERL_GP_COND_ESCALATE, read in one helper, decides the tier: just
    above the state's squared pivot ratio keeps the device factor, just
    below escalates."""
    assert gp_core.cond_escalate_threshold(np.float32) == 1e7
    assert gp_core.cond_escalate_threshold(np.float64) == 1e15
    _, ts = _settings(max_num_samples=64)
    rng = np.random.default_rng(4)
    gp = SparsePseudoInputGaussianProcess(ts, rng.uniform(-2, 2, (3, 40)),
                                          dtype=np.float32)
    x, y, var, _ = _batches(rng, 1, 60, dtype=np.float32, var=1e-3)[0]
    gp.update(x.T, y, var)
    L, _ = spgp_prepare(gp.state)
    dl = torch.diagonal(L).abs().double()
    ratio = float((dl.max() / dl.min()) ** 2)
    for factor, escalates in ((1.01, False), (0.99, True)):
        monkeypatch.setenv("ERL_GP_COND_ESCALATE", repr(ratio * factor))
        gp.invalidate()
        caplog.clear()
        with caplog.at_level(logging.INFO, "erl_gaussian_process_tpu_torch"):
            Lp, _ = gp._prepared()
        logged = any("exact float64 host" in r.getMessage()
                     for r in caplog.records)
        assert logged == escalates
        assert torch.equal(Lp, L) != escalates


def test_convert_round_trip_predicts_the_same():
    """A JAX state after K updates, carried into the port, predicts the
    same means and variances at 1e-12."""
    js, ts = _settings()
    rng = np.random.default_rng(5)
    pseudo = rng.uniform(-2, 2, (3, 45))
    jgp = jsp.SparsePseudoInputGaussianProcess(js, pseudo, dtype=np.float64)
    for x, y, var, _ in _batches(rng, 4, 80):
        jgp.update(x.T, y, var)
    d = jgp.state_dict()
    st = spgp_state_from_numpy({k: np.asarray(v) for k, v in
                                d["state"].items()})
    assert st.qm.dtype == torch.float64
    _close(st.qm, d["state"]["qm"], 0)
    tgp = SparsePseudoInputGaussianProcess(ts, pseudo, dtype=np.float64)
    tgp.load_state_dict(d)
    assert tgp.is_trained and tgp.num_pseudo_points == 45
    xq = rng.uniform(-2, 2, (3, 30))
    _close(tgp.test(xq).get_mean(0), jgp.test(xq).get_mean(0), 1e-12)
    _close(tgp.test(xq).get_variance(), jgp.test(xq).get_variance(), 1e-12)


def test_save_load_round_trip(tmp_path):
    _, ts = _settings()
    rng = np.random.default_rng(6)
    pseudo = rng.uniform(-2, 2, (3, 30))
    gp = SparsePseudoInputGaussianProcess(ts, pseudo, dtype=np.float32)
    x, y, var, _ = _batches(rng, 1, 50, dtype=np.float32)[0]
    gp.update(x.T, y, var)
    path = str(tmp_path / "spgp.npz")
    gp.save(path)
    gp2 = SparsePseudoInputGaussianProcess(ts, pseudo, dtype=np.float32)
    assert not gp2 == gp
    gp2.load(path)
    assert gp2 == gp
    xq = rng.uniform(-2, 2, (3, 20)).astype(np.float32)
    assert torch.equal(gp.test(xq).get_mean(0), gp2.test(xq).get_mean(0))


def test_gradient_predict_is_not_ported_yet():
    _, ts = _settings()
    gp = SparsePseudoInputGaussianProcess(ts, np.zeros((3, 4)))
    with pytest.raises(NotImplementedError, match="Gradient predict"):
        gp.test(np.zeros((3, 2)), predict_gradient=True)
    with pytest.raises(NotImplementedError, match="Gradient predict"):
        spgp_predict(gp.state, None, None, torch.zeros(2, 3), SCALE,
                     kernel="matern32", with_grad=True)


def test_robust_cholesky_escalates_jitter_like_jax():
    """A singular gram (two coincident points) fails the plain
    factorization; both packages retry with the same jitter ladder and
    land on the same factor."""
    from erl_gaussian_process_tpu.models.gp_core import (
        robust_cholesky as jax_robust_cholesky,
    )

    x = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 0.5]])
    km = np.asarray(jsp.kernel_fn("rbf")(jnp.asarray(x), jnp.asarray(x),
                                         np.float64(1.0)))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.tensor(km))
    L = gp_core.robust_cholesky(torch.tensor(km))
    assert torch.isfinite(L).all()
    _close(L, jax_robust_cholesky(jnp.asarray(km)), 1e-12)


def test_exact_host_repairs_an_indefinite_q_m_like_jax():
    """Tier 2's eigenvalue repair: a Q_M indefinite even at float64 is
    clamped to its noise floor; numpy/scipy in both packages, so the same
    state gives the same factor."""
    rng = np.random.default_rng(9)
    a = rng.normal(size=(6, 6))
    qm = a @ a.T - 0.05 * np.eye(6) * np.abs(np.linalg.eigvalsh(a @ a.T)).min()
    qm -= 1e-3 * np.eye(6)                     # lambda_min < 0
    assert np.linalg.eigvalsh(qm)[0] < 0
    d = {"pseudo": np.zeros((6, 2)), "L_km": np.eye(6), "L_inv": np.eye(6),
         "qm": qm, "alpha": rng.normal(size=(6, 1)),
         "qm_c": np.zeros((6, 6)), "alpha_c": np.zeros((6, 1))}
    tL, ta = spgp_prepare_exact_host(spgp_state_from_numpy(d))
    jL, ja = jsp.spgp_prepare_exact_host(jsp.SpGpState(
        **{k: jnp.asarray(v) for k, v in d.items()}))
    assert torch.isfinite(tL).all() and torch.isfinite(ta).all()
    _close(tL, jL, 1e-12)
    _close(ta, ja, 1e-12)


def test_host_jitter_retry_warns_when_it_changes_the_noise(caplog):
    calls = []

    def fit_once(j):
        calls.append(j)
        return (torch.tensor([float("nan")]) if j < 1e-8
                else torch.tensor([1.0]),)

    with caplog.at_level(logging.WARNING, "erl_gaussian_process_tpu_torch"):
        out = gp_core.host_jitter_retry(fit_once, lambda r: r)
    assert calls == [0.0, 1e-10, 1e-8] and float(out[0][0]) == 1.0
    assert any("jitter 1e-08" in r.getMessage() for r in caplog.records)
