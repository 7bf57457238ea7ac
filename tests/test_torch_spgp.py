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
    tgp = SparsePseudoInputGaussianProcess(
        ts, pseudo, dtype=np.float64, device="cpu")
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
    tgp = SparsePseudoInputGaussianProcess(
        ts, pseudo, dtype=np.float32, device="cpu")
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
                                          dtype=np.float32, device="cpu")
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
                    max_num_samples=32), pseudo, dtype=np.float32,
        device="cpu")
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
                                          dtype=np.float32, device="cpu")
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
                                d["state"].items()}, device="cpu")
    assert st.qm.dtype == torch.float64
    _close(st.qm, d["state"]["qm"], 0)
    tgp = SparsePseudoInputGaussianProcess(
        ts, pseudo, dtype=np.float64, device="cpu")
    tgp.load_state_dict(d)
    assert tgp.is_trained and tgp.num_pseudo_points == 45
    xq = rng.uniform(-2, 2, (3, 30))
    _close(tgp.test(xq).get_mean(0), jgp.test(xq).get_mean(0), 1e-12)
    _close(tgp.test(xq).get_variance(), jgp.test(xq).get_variance(), 1e-12)


def test_loaded_l_inv_is_exactly_lower_triangular():
    """A state whose L_inv carries 1e-9 noise above the diagonal (a
    checkpoint or a converted JAX state) loads with exact zeros there, and
    its FITC plain update equals the clean state's bit for bit."""
    from erl_gaussian_process_tpu_torch.ops import fitc_update_plain

    rng = np.random.default_rng(13)
    st = spgp_init(torch.tensor(rng.uniform(-2, 2, (40, 3))), SCALE,
                   kernel="matern32")
    clean = {k: v.numpy() for k, v in st._asdict().items()}
    noisy = dict(clean)
    noisy["L_inv"] = clean["L_inv"] + np.triu(
        1e-9 * rng.standard_normal(clean["L_inv"].shape), 1)
    assert np.triu(noisy["L_inv"], 1).any()
    loaded = spgp_state_from_numpy(noisy, device="cpu")
    assert not torch.triu(loaded.L_inv, 1).any()
    assert torch.equal(loaded.L_inv, st.L_inv)
    gp = SparsePseudoInputGaussianProcess(
        _settings()[1], clean["pseudo"].T, dtype=np.float64, device="cpu")
    gp.load_state_dict({**gp.state_dict(), "state": noisy})
    assert torch.equal(gp.state.L_inv, st.L_inv)
    x, y, var, mask = (torch.tensor(a) for a in _batches(rng, 1, 70)[0])
    for a, b in zip(fitc_update_plain("matern32", loaded.pseudo, loaded.L_inv,
                                      x, y, var, mask, SCALE),
                    fitc_update_plain("matern32", st.pseudo, st.L_inv, x, y,
                                      var, mask, SCALE)):
        assert torch.equal(a, b)


def test_save_load_round_trip(tmp_path):
    _, ts = _settings()
    rng = np.random.default_rng(6)
    pseudo = rng.uniform(-2, 2, (3, 30))
    gp = SparsePseudoInputGaussianProcess(
        ts, pseudo, dtype=np.float32, device="cpu")
    x, y, var, _ = _batches(rng, 1, 50, dtype=np.float32)[0]
    gp.update(x.T, y, var)
    path = str(tmp_path / "spgp.npz")
    gp.save(path)
    gp2 = SparsePseudoInputGaussianProcess(
        ts, pseudo, dtype=np.float32, device="cpu")
    assert not gp2 == gp
    gp2.load(path)
    assert gp2 == gp
    xq = rng.uniform(-2, 2, (3, 20)).astype(np.float32)
    assert torch.equal(gp.test(xq).get_mean(0), gp2.test(xq).get_mean(0))


def test_gradient_predict_is_not_ported_yet():
    """Gradient predict is ported; what still raises is what raises in the
    JAX package too: a family without a gradient gram (OU). A result
    tested without gradients has none to give."""
    js, ts = _settings(kernel_type="ou")
    pseudo = np.random.default_rng(8).uniform(-2, 2, (3, 4))
    gp = SparsePseudoInputGaussianProcess(ts, pseudo, device="cpu")
    jgp = jsp.SparsePseudoInputGaussianProcess(js, pseudo, dtype=np.float64)
    for model in (gp, jgp):
        with pytest.raises(NotImplementedError, match="no gradient gram"):
            model.test(np.zeros((3, 2)), predict_gradient=True)
    with pytest.raises(NotImplementedError, match="no gradient gram"):
        spgp_predict(gp.state, *gp._prepared(), torch.zeros(2, 3), SCALE,
                     kernel="ou", with_grad=True)
    with pytest.raises(ValueError, match="predict_gradient"):
        gp.test(np.zeros((3, 2))).get_gradient()


@pytest.mark.parametrize("zero_threshold", [0.0, 1e-3])
def test_gradient_predict_matches_jax_f64(zero_threshold):
    """spgp_predict(with_grad=True) after 3 updates: mean, gradient (m, d,
    q) and variance against JAX at float64 to 1e-12, with and without the
    sparse threshold; the class's get_gradient (d, m) too."""
    rng = np.random.default_rng(12)
    pseudo = rng.uniform(-2, 2, (60, 3))
    jst = jsp.spgp_init(jnp.asarray(pseudo), np.float64(SCALE),
                        kernel="matern32")
    tst = spgp_init(torch.tensor(pseudo), SCALE, kernel="matern32")
    for x, y, var, mask in _batches(rng, 3, 100, q=2):
        jst = jsp.spgp_update(jst, *map(jnp.asarray, (x, y, var, mask)),
                              np.float64(SCALE), kernel="matern32",
                              zero_threshold=zero_threshold)
        tst = spgp_update(tst, *[torch.tensor(a) for a in (x, y, var, mask)],
                          SCALE, kernel="matern32",
                          zero_threshold=zero_threshold)
    jL, ja = jsp.spgp_prepare(jst)
    tL, ta = spgp_prepare(tst)
    xq = rng.uniform(-2, 2, (50, 3))
    kw = dict(kernel="matern32", with_grad=True,
              zero_threshold=zero_threshold)
    jm, jg, jv = jsp.spgp_predict(jst, jL, ja, jnp.asarray(xq),
                                  np.float64(SCALE), **kw)
    tm, tg, tv = spgp_predict(tst, tL, ta, torch.tensor(xq), SCALE, **kw)
    assert tg.shape == (50, 3, 2)
    _close(tm, jm, 1e-12)
    _close(tg, jg, 1e-12)
    _close(tv, jv, 1e-12)
    js, ts = _settings(**({"use_sparse": True,
                           "sparse_zero_threshold": zero_threshold}
                          if zero_threshold else {}))
    jgp = jsp.SparsePseudoInputGaussianProcess(js, pseudo.T, dtype=np.float64)
    tgp = SparsePseudoInputGaussianProcess(ts, pseudo.T, dtype=np.float64,
                                           device="cpu")
    for x, y, var, _ in _batches(rng, 2, 90):
        jgp.update(x.T, y, var)
        tgp.update(x.T, y, var)
    jr = jgp.test(xq.T, predict_gradient=True)
    tr = tgp.test(xq.T, predict_gradient=True)
    assert tr.get_gradient(0).shape == (3, 50)
    _close(tr.get_gradient(0), jr.get_gradient(0), 1e-12)
    _close(tr.get_mean(0), jr.get_mean(0), 1e-12)
    _close(tr.get_variance(), jr.get_variance(), 1e-12)


def test_amortized_inverse_variance_matches_trsm():
    """Port of the JAX suite's test of the same name (with_grad=True,
    float32, at its tolerances): the variance whitened against the cached
    chol(Q_M)^{-1} agrees with the triangular solve, and each of the
    port's results agrees with the JAX package's predict on the same
    state and prepared factor (the two packages' float32 updates round
    differently, and this Q_M amplifies that in the mean)."""
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        pad_pseudo_points,
    )

    rng = np.random.default_rng(7)
    ps = pad_pseudo_points(rng.uniform(-1, 1, (100, 2)).astype(np.float32))
    x = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    y = rng.uniform(-1, 1, (300, 1)).astype(np.float32)
    var = np.full((300,), 1e-3, np.float32)
    mask = np.ones((300,), bool)
    xq = rng.uniform(-1, 1, (50, 2)).astype(np.float32)
    tst = spgp_init(torch.tensor(ps), 0.4, kernel="matern32")
    tst = spgp_update(tst, *[torch.tensor(a) for a in (x, y, var, mask)],
                      0.4, kernel="matern32")
    L, a = spgp_prepare(tst)
    kw = dict(kernel="matern32", with_grad=True, with_var=True)
    jst = jsp.SpGpState(**{k: jnp.asarray(v.numpy())
                           for k, v in tst._asdict().items()})
    jref = jsp.spgp_predict(jst, jnp.asarray(L.numpy()),
                            jnp.asarray(a.numpy()), jnp.asarray(xq),
                            np.float32(0.4), **kw)
    m1, g1, v1 = spgp_predict(tst, L, a, torch.tensor(xq), 0.4, **kw)
    m2, g2, v2 = spgp_predict(tst, L, a, torch.tensor(xq), 0.4,
                              li_qm=tri_inv(L), **kw)
    assert g1.shape == (50, 2, 1)
    for (p, q, r), atol in zip(((m1, m2, jref[0]), (g1, g2, jref[1]),
                                (v1, v2, jref[2])), (2e-5, 2e-4, 5e-5)):
        np.testing.assert_allclose(p.numpy(), q.numpy(), atol=atol)
        np.testing.assert_allclose(q.numpy(), np.asarray(r), atol=atol)


def test_li_qm_variance_on_an_ill_conditioned_state():
    """The float32 variance through the cached chol(Q_M)^{-1} (``li_qm``)
    on a state whose Q_M is past 1/eps_f32 (the exact host tier's factor):
    the port's against JAX's on the same state to the JAX f32 suite's 5e-5,
    and the port's error against the float64 exact solve of the same state
    no worse than 2x JAX's plus 1e-6."""
    from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
        _tri_inv,
    )

    gp, rng = _ill_conditioned_gp()
    xq = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    var = gp.test(xq.T).get_variance().numpy()          # li_qm at float32
    assert gp._li is not None
    arrays = {k: np.asarray(v) for k, v in gp.state_dict()["state"].items()}
    jst = jsp.SpGpState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jL, ja = jsp.spgp_prepare_exact_host(jst)
    _, _, jvar = jsp.spgp_predict(jst, jL, ja, jnp.asarray(xq),
                                  np.float32(0.6), kernel="matern32",
                                  li_qm=_tri_inv(jL))
    jvar = np.asarray(jvar)
    np.testing.assert_allclose(var, jvar, atol=5e-5)
    st64 = spgp_state_from_numpy(
        {k: v.astype(np.float64) for k, v in arrays.items()}, device="cpu")
    L64, a64 = spgp_prepare_exact_host(st64)
    _, _, truth = spgp_predict(st64, L64, a64,
                               torch.tensor(xq.astype(np.float64)), 0.6,
                               kernel="matern32")
    truth = truth.numpy()
    err, jerr = np.abs(var - truth).max(), np.abs(jvar - truth).max()
    assert err <= 2 * jerr + 1e-6, (err, jerr)


def test_robust_cholesky_escalates_jitter_like_jax():
    """A singular gram (two coincident points) fails the plain
    factorization; both packages retry with the same jitter ladder, take
    the same rung, and land on a factor of the same jittered gram.

    L[2, 1] is not compared: with rows 0 and 1 equal it is an exact
    cancellation (K[2,1] - L[2,0] L[1,0]) divided by sqrt of the jitter
    (~1.4e-7), i.e. rounding noise that LAPACK and XLA round differently
    (3.755e-8 vs 3.791e-8 on one host). Neither package determines it; the
    reconstruction L L^T below holds it to its own 1e-12 in both."""
    from erl_gaussian_process_tpu.models.gp_core import (
        robust_cholesky as jax_robust_cholesky,
    )

    x = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 0.5]])
    km = np.asarray(jsp.kernel_fn("rbf")(jnp.asarray(x), jnp.asarray(x),
                                         np.float64(1.0)))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.tensor(km))
    L = gp_core.robust_cholesky(torch.tensor(km)).numpy()
    J = np.asarray(jax_robust_cholesky(jnp.asarray(km)))
    assert np.isfinite(L).all()
    ladder = [1e-14 * 100.0 ** k for k in range(8)]
    scale = np.mean(np.diag(km))

    def rung(F):
        errs = [np.abs(F @ F.T - (km + j * scale * np.eye(3))).max()
                for j in ladder]
        return int(np.argmin(errs)), min(errs)

    (r_port, e_port), (r_jax, e_jax) = rung(L), rung(J)
    assert r_port == r_jax
    assert e_port <= 1e-12 and e_jax <= 1e-12
    np.testing.assert_allclose(L[1, 1], J[1, 1], rtol=1e-12)
    well_determined = np.tril(np.ones((3, 3), bool))
    well_determined[2, 1] = False
    _close(L[well_determined], J[well_determined], 1e-12)


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
    tL, ta = spgp_prepare_exact_host(spgp_state_from_numpy(d, device="cpu"))
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
