"""The PyTorch port's reduced-rank (Hilbert-space) kernels
(erl_gaussian_process_tpu_torch/kernels/reduced_rank.py) and the models
that take them, against the JAX package on the same numpy-seeded inputs:
every test of tests/test_reduced_rank.py held against JAX (name parsing,
features and their gradients, spectral densities, the vanilla and
noisy-input GPs with gradients, checkpoints), the reduced-rank bank, the 3D
sensor GP and the 2D lidar GP.

Tolerances, relative to each result's magnitude: float64 1e-12 for the
features, the vanilla GP and the banks; 1e-10 for the noisy-input GP's
joint systems (the tolerance of tests/test_torch_noisy_input_gp.py: their
information matrices at var 1e-4 carry gradient rows of weight 1e4, and
the products that build them sum in another order than XLA's); float32
1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.kernels as jk
import erl_gaussian_process_tpu.kernels.reduced_rank as jrr
import erl_gaussian_process_tpu.models.batch_gp as jbg
from erl_gaussian_process_tpu.models import lidar_gp_2d as jlidar
from erl_gaussian_process_tpu.models.noisy_input_gp import (
    NoisyInputGaussianProcess as JaxNIGP,
    NoisyInputGPSetting as JaxNIGPSetting,
)
from erl_gaussian_process_tpu.models.vanilla_gp import (
    VanillaGaussianProcess as JaxVanillaGP,
    VanillaGPSetting as JaxVanillaGPSetting,
)
from erl_gaussian_process_tpu_torch.kernels import (
    KernelSetting,
    ReducedRankBasis,
    ReducedRankSetting,
    parse_reduced_rank_name,
    spectral_density,
)
from erl_gaussian_process_tpu_torch.kernels import reduced_rank as trr
from erl_gaussian_process_tpu_torch.models import (
    LidarGaussianProcess2D,
    LidarGP2DSetting,
    NoisyInputGaussianProcess,
    NoisyInputGPSetting,
    VanillaGaussianProcess,
    VanillaGPSetting,
    bank_fit_rr,
    bank_predict_assigned,
)
from erl_gaussian_process_tpu_torch.models.batch_gp import bank_fit_rr_core
from erl_gaussian_process_tpu_torch.utils.convert import (
    lidar_gp_2d_from_numpy,
    vanilla_gp_from_numpy,
)

TOL = {np.float64: 1e-12, np.float32: 1e-4}
NIGP_TOL = {np.float64: 1e-10, np.float32: 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """One float32 exp over every thread before the parity tests: this CPU
    build of torch got its first multi-threaded float32 exp of a process
    wrong in one thread's chunk now and then (tests/test_torch_gram.py)."""
    torch.exp(torch.zeros(1 << 20, dtype=torch.float32))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, ref, tol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _sine_data(n=100, noise=1e-2, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-0.8, 0.8, n))
    y = np.sin(3.0 * x) + rng.normal(0, np.sqrt(noise), n)
    return x[None, :], y[:, None], np.full(n, noise)


def _rr_kw(num_basis, scale=0.3, boundary=2.0, origin=0.0):
    return dict(x_dim=1, scale=scale, num_basis=[num_basis],
                boundary=[boundary], coord_origin=[origin])


def _vanilla_pair(kernel_type, kernel_kw, dtype=np.float64, plain=False):
    """The same setting in both packages (``plain``: a KernelSetting)."""
    ks, jks = ((KernelSetting, jk.KernelSetting) if plain else
               (ReducedRankSetting, jk.ReducedRankSetting))
    gp = VanillaGaussianProcess(VanillaGPSetting(
        kernel_type=kernel_type, kernel=ks(**kernel_kw)), dtype=dtype,
        device="cpu")
    jgp = JaxVanillaGP(JaxVanillaGPSetting(
        kernel_type=kernel_type, kernel=jks(**kernel_kw)), dtype=dtype)
    return gp, jgp


def _test_close(res, jres, tol):
    _close(res.get_mean(), jres.get_mean(), tol)
    _close(res.get_variance(), jres.get_variance(), tol)


def test_name_parsing_matches_jax():
    names = ["reduced_rank_rbf", "rr_matern32", "reduced_rank",
             "erl::covariance::ReducedRankMatern32<double, 2>",
             "erl::covariance::ReducedRankOrnsteinUhlenbeck1d",
             "ReducedRankRadialBiasFunction2d", "rr_matern", "rr_ou",
             "rbf", "matern32", "erl::covariance::Matern32<float, 2>"]
    for n in names:
        assert parse_reduced_rank_name(n) == jrr.parse_reduced_rank_name(n)
    assert parse_reduced_rank_name("reduced_rank_rbf") == "rbf"
    assert parse_reduced_rank_name(
        "erl::covariance::ReducedRankMatern32<double, 2>") == "matern32"
    assert parse_reduced_rank_name("rbf") is None


@pytest.mark.parametrize("name", ["rbf", "matern32", "ou"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_spectral_density_and_basis_match_jax(name, d):
    omega2 = np.linspace(0.0, 400.0, 97)
    _close(spectral_density(name, omega2, 0.37, d),
           jrr.spectral_density(name, jnp.asarray(omega2), 0.37, d), 1e-14)
    kw = dict(x_dim=d, scale=0.37, base_kernel=name,
              num_basis=[5, 4, 3][:d], boundary=[1.5, 2.0, 0.8][:d],
              coord_origin=[0.1, -0.2, 0.3][:d])
    for dtype in (np.float64, np.float32):
        b = ReducedRankBasis(ReducedRankSetting(**kw), dtype=dtype)
        jb = jrr.ReducedRankBasis(jk.ReducedRankSetting(**kw), dtype=dtype)
        assert b.num_basis_total == jb.num_basis_total
        for ours, ref in zip(b.consts("cpu"), (jb._freq, jb._sqrt_s,
                                               jb._origin, jb._half,
                                               jb._inv_sqrt_vol)):
            assert ours.dtype == torch.from_numpy(
                np.array(ref)).dtype
            _close(ours, ref, 1e-15 if dtype == np.float64 else 1e-6)
    with pytest.raises(ValueError, match="share length"):
        ReducedRankBasis(ReducedRankSetting(num_basis=[4, 4],
                                            boundary=[1.0]))
    # an unset boundary falls back to 1.0 a dim, as in JAX
    b = ReducedRankBasis(ReducedRankSetting(num_basis=[4, 4],
                                            coord_origin=[0.0, 0.0]))
    assert b.setting.boundary == [1.0, 1.0]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_features_and_gradients_match_jax(dtype):
    rng = np.random.default_rng(5)
    kw = dict(x_dim=2, scale=0.5, num_basis=[6, 5], boundary=[1.0, 1.5],
              coord_origin=[0.2, -0.1])
    b = ReducedRankBasis(ReducedRankSetting(**kw), dtype=dtype)
    jb = jrr.ReducedRankBasis(jk.ReducedRankSetting(**kw), dtype=dtype)
    x = rng.uniform(-2.5, 2.5, (64, 2)).astype(dtype)
    mask = rng.uniform(size=64) < 0.8
    jc = (jb._freq, jb._sqrt_s, jb._origin, jb._half, jb._inv_sqrt_vol)
    _close(b.features(torch.tensor(x), torch.tensor(mask)),
           jrr.rr_features(jnp.asarray(x), jnp.asarray(mask), *jc),
           TOL[dtype])
    phi, dphi = trr.rr_features_with_grad(torch.tensor(x), *b.consts("cpu"))
    jphi, jdphi = jrr.rr_features_with_grad(jnp.asarray(x), *jc)
    _close(phi, jphi, TOL[dtype])
    _close(dphi, jdphi, TOL[dtype])
    _close(trr.rr_ktest_joint(torch.tensor(x), *b.consts("cpu"), True),
           jrr.rr_ktest_joint(jnp.asarray(x), *jc, True), TOL[dtype])
    # the batched features (a bank's) are the per-member features
    xb = torch.tensor(x).reshape(4, 16, 2)
    mb = torch.tensor(mask).reshape(4, 16)
    _close(b.features(xb, mb).reshape(64, -1),
           b.features(torch.tensor(x), torch.tensor(mask)), 0.0)


def test_grad_features_consistent_with_clamp():
    """dphi is the derivative of the implemented (clamped) feature: zero
    outside the box and equal to the autograd Jacobian of rr_features
    inside (tests/test_reduced_rank.py's jacfwd check, by torch)."""
    basis = ReducedRankBasis(ReducedRankSetting(
        x_dim=2, scale=0.5, num_basis=[6, 5], boundary=[1.0, 1.5],
        coord_origin=[0.2, -0.1]))
    c = basis.consts("cpu")
    x = torch.tensor([[0.0, 0.0], [0.9, 1.2], [1.4, 0.0], [0.0, -1.8],
                      [2.0, 3.0]], dtype=torch.float64)
    _, dphi = trr.rr_features_with_grad(x, *c)
    ones = torch.ones(1, dtype=torch.bool)
    jac = torch.stack([torch.autograd.functional.jacobian(
        lambda xi: trr.rr_features(xi[None], ones, *c)[0], xi) for xi in x])
    _close(dphi, jac.permute(0, 2, 1), 1e-12)
    assert (dphi[2, 0] == 0).all() and (dphi[3, 1] == 0).all()
    assert (dphi[4] == 0).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("base,num_basis,tol_mean,tol_var", [
    ("rbf", 64, 2e-4, 2e-3), ("matern32", 512, 2e-3, 2e-2)])
def test_rr_converges_to_exact_and_matches_jax(base, num_basis, tol_mean,
                                               tol_var, dtype):
    x, y, var = _sine_data()
    exact, _ = _vanilla_pair(base, dict(x_dim=1, scale=0.3), dtype,
                             plain=True)
    rr, jrr_gp = _vanilla_pair(f"reduced_rank_{base}", _rr_kw(num_basis),
                               dtype)
    for m in (exact, rr, jrr_gp):
        assert m.train(x, y, var)
    assert rr.reduced_rank_kernel and not exact.reduced_rank_kernel
    assert rr._kernel == base
    xq = np.linspace(-0.7, 0.7, 201)[None, :]
    re, rq, jq = exact.test(xq), rr.test(xq), jrr_gp.test(xq)
    _test_close(rq, jq, TOL[dtype])
    assert rq.k_test.shape == (num_basis, 201)
    _close(rq.k_test, jq.k_test, TOL[dtype])
    if dtype == np.float64:
        assert np.max(np.abs(re.get_mean() - rq.get_mean())) < tol_mean
        assert np.max(np.abs(re.get_variance() - rq.get_variance())) \
            < tol_var
    assert np.all(rq.get_variance() > 0)
    # the repeated-query path (L^{-1} product) keeps the + sign
    _test_close(rr.test(xq), jrr_gp.test(xq), TOL[dtype])


def test_rr_accuracy_against_truth():
    x, y, var = _sine_data()
    exact, _ = _vanilla_pair("rbf", dict(x_dim=1, scale=0.3), plain=True)
    rr, jrr_gp = _vanilla_pair("reduced_rank_rbf", _rr_kw(64))
    for m in (exact, rr, jrr_gp):
        m.train(x, y, var)
    xq = np.linspace(-0.7, 0.7, 401)
    truth = np.sin(3 * xq)
    mae_rr = np.mean(np.abs(rr.test(xq[None]).get_mean() - truth))
    mae_ex = np.mean(np.abs(exact.test(xq[None]).get_mean() - truth))
    mae_j = np.mean(np.abs(jrr_gp.test(xq[None]).get_mean() - truth))
    assert mae_rr < mae_ex + 2e-4
    assert abs(mae_rr - mae_j) < 1e-12


def test_rr_coord_origin_shift_equivalence():
    x, y, var = _sine_data()
    shift = 5.0
    a, ja = _vanilla_pair("rr_rbf", _rr_kw(48))
    b, jb = _vanilla_pair("rr_rbf", _rr_kw(48, origin=shift))
    np.testing.assert_array_equal(b.get_coord_origin(), jb.get_coord_origin())
    for m in (a, ja):
        m.train(x, y, var)
    for m in (b, jb):
        m.train(x + shift, y, var)
    xq = np.linspace(-0.7, 0.7, 101)[None, :]
    ra, rb = a.test(xq), b.test(xq + shift)
    np.testing.assert_allclose(ra.get_mean(), rb.get_mean(), atol=1e-10)
    np.testing.assert_allclose(ra.get_variance(), rb.get_variance(),
                               atol=1e-10)
    _test_close(rb, jb.test(xq + shift), 1e-12)
    c, _ = _vanilla_pair("rr_rbf", _rr_kw(48))
    c.set_coord_origin([shift])
    c.train(x + shift, y, var)
    np.testing.assert_allclose(ra.get_mean(), c.test(xq + shift).get_mean(),
                               atol=1e-10)


def test_rr_serialization_and_jax_checkpoint(tmp_path):
    x, y, var = _sine_data()
    rr, jrr_gp = _vanilla_pair("reduced_rank_matern32", _rr_kw(512))
    for m in (rr, jrr_gp):
        m.train(x, y, var)
    p = str(tmp_path / "rr.npz")
    rr.save(p)
    rr2 = VanillaGaussianProcess(device="cpu")
    rr2.load(p)
    assert rr2.reduced_rank_kernel and rr == rr2
    xq = np.linspace(-0.5, 0.5, 32)[None, :]
    np.testing.assert_array_equal(rr.test(xq).get_mean(),
                                  rr2.test(xq).get_mean())
    np.testing.assert_array_equal(rr.test(xq).get_variance(),
                                  rr2.test(xq).get_variance())
    carried = vanilla_gp_from_numpy(jrr_gp.state_dict(), device="cpu")
    assert carried.reduced_rank_kernel
    assert carried.setting.kernel.to_dict() == \
        jrr_gp.setting.kernel.to_dict()
    _test_close(carried.test(xq), jrr_gp.test(xq), 1e-12)


def test_rr_2d_matern_matches_jax():
    """tests/test_reduced_rank.py:240-259's 2D Matérn (400 points, 16x16
    basis, noise 1e-4): MAE < 2e-2, and JAX's predictions."""
    rng = np.random.default_rng(1)
    n = 400
    x = rng.uniform(-0.8, 0.8, (2, n))
    y = (np.sin(2 * x[0]) * np.cos(2 * x[1]) + rng.normal(0, 1e-2, n))
    kw = dict(x_dim=2, scale=0.6, num_basis=[16, 16], boundary=[2.0, 2.0],
              coord_origin=[0.0, 0.0])
    gp, jgp = _vanilla_pair("rr_matern32", kw)
    for m in (gp, jgp):
        m.train(x, y[:, None], np.full(n, 1e-4))
    g = np.linspace(-0.6, 0.6, 21)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    xq = np.stack([gx.ravel(), gy.ravel()])
    res = gp.test(xq)
    mae = np.mean(np.abs(res.get_mean()
                         - np.sin(2 * gx.ravel()) * np.cos(2 * gy.ravel())))
    assert mae < 2e-2, mae
    _test_close(res, jgp.test(xq), 1e-12)


def _nigp_pair(with_grad, base="matern32", num_basis=512, scale=0.3, n=80,
               noise=1e-4, dtype=np.float64):
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(-0.8, 0.8, n))
    y = np.sin(3.0 * x)
    g = 3.0 * np.cos(3.0 * x)[None, :]
    kw = dict(var_x=noise, var_y=noise, var_grad=noise)
    models = []
    for cls, scls, kcls in (
            (NoisyInputGaussianProcess, NoisyInputGPSetting,
             ReducedRankSetting),
            (JaxNIGP, JaxNIGPSetting, jk.ReducedRankSetting)):
        extra = {"device": "cpu"} if cls is NoisyInputGaussianProcess else {}
        m = cls(scls(kernel_type=f"reduced_rank_{base}",
                     kernel=kcls(**_rr_kw(num_basis, scale)),
                     no_gradient_observation=not with_grad), dtype=dtype,
                **extra)
        assert m.using_reduced_rank_kernel()
        assert m.train(x[None, :], y, g if with_grad else None, **kw)
        models.append(m)
    exact = NoisyInputGaussianProcess(NoisyInputGPSetting(
        kernel_type=base, kernel=KernelSetting(x_dim=1, scale=scale),
        no_gradient_observation=not with_grad), dtype=dtype, device="cpu")
    assert exact.train(x[None, :], y, g if with_grad else None, **kw)
    return exact, models[0], models[1]


def _nigp_outputs(res):
    return (res.get_mean(), res.get_gradient(), res.get_mean_variance(),
            res.get_gradient_variance(), res.get_covariance())


@pytest.mark.parametrize("with_grad", [True, False])
def test_nigp_rr_converges_to_exact_and_matches_jax(with_grad):
    exact, rr, jrr_gp = _nigp_pair(with_grad)
    xq = np.linspace(-0.7, 0.7, 101)[None, :]
    re = exact.test(xq, predict_gradient=True)
    rq = rr.test(xq, predict_gradient=True)
    for a, b in zip(_nigp_outputs(rq),
                    _nigp_outputs(jrr_gp.test(xq, predict_gradient=True))):
        _close(a, b, NIGP_TOL[np.float64])
    assert np.max(np.abs(re.get_mean() - rq.get_mean())) < 2e-3
    assert np.max(np.abs(re.get_gradient() - rq.get_gradient())) < 0.05
    ve, vq = re.get_mean_variance(), rq.get_mean_variance()
    assert np.all(vq > 0) and np.max(np.abs(ve - vq)) < 5e-3
    ge, gq = re.get_gradient_variance(), rq.get_gradient_variance()
    assert np.all(gq > 0)
    assert np.all(ge - gq > -0.05)
    assert np.max(ge - gq) < 0.1 * 3.0 / 0.09
    assert np.max(np.abs(re.get_covariance() - rq.get_covariance())) < 0.1
    assert rq.k_test.shape == (512, 101 * 2)
    # the repeated-query path
    for a, b in zip(_nigp_outputs(rr.test(xq, True)),
                    _nigp_outputs(jrr_gp.test(xq, True))):
        _close(a, b, NIGP_TOL[np.float64])


def test_nigp_rr_rbf_gradient_variance_quirk():
    exact, rr, jrr_gp = _nigp_pair(True, base="rbf", num_basis=64)
    xq = np.linspace(-0.6, 0.6, 51)[None, :]
    ge = exact.test(xq, True).get_gradient_variance()
    gq = rr.test(xq, True).get_gradient_variance()
    np.testing.assert_allclose(ge - gq, 2.0 / (0.3 * 0.3), atol=1e-2)
    _close(gq, jrr_gp.test(xq, True).get_gradient_variance(),
           NIGP_TOL[np.float64])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nigp_rr_gradient_accuracy_against_truth(dtype):
    """The truth gates at both dtypes. At float64 every output against
    JAX's; at float32 each output's error against JAX's float64 result no
    more than 2x JAX's own float32 error (the variances at var 1e-4 lose
    ~4 digits in either package's float32 factor, so the two float32
    results are not closer to each other than to the truth)."""
    _, rr, jrr_gp = _nigp_pair(True, base="rbf", num_basis=64, dtype=dtype)
    xq = np.linspace(-0.6, 0.6, 201)
    res = rr.test(xq[None, :], predict_gradient=True)
    ours = _nigp_outputs(res)
    jax_out = _nigp_outputs(jrr_gp.test(xq[None, :], True))
    if dtype == np.float64:
        for a, b in zip(ours, jax_out):
            _close(a, b, NIGP_TOL[dtype])
    else:
        _, _, j64 = _nigp_pair(True, base="rbf", num_basis=64)
        for a, b, c in zip(ours, jax_out,
                           _nigp_outputs(j64.test(xq[None, :], True))):
            err, jerr = np.abs(a - c).max(), np.abs(b - c).max()
            assert err <= 2.0 * jerr + 1e-7 * np.abs(c).max(), (err, jerr)
    assert np.mean(np.abs(res.get_mean() - np.sin(3 * xq))) < 1e-3
    assert np.mean(np.abs(res.get_gradient()[0] - 3 * np.cos(3 * xq))) \
        < 1e-2


def test_nigp_rr_serialization_round_trip(tmp_path):
    _, rr, _ = _nigp_pair(True, base="rbf", num_basis=64)
    p = str(tmp_path / "nigp_rr.npz")
    rr.save(p)
    rr2 = NoisyInputGaussianProcess(device="cpu")
    rr2.load(p)
    assert rr2.using_reduced_rank_kernel() and rr == rr2
    xq = np.linspace(-0.5, 0.5, 32)[None, :]
    np.testing.assert_array_equal(rr.test(xq, True).get_mean(),
                                  rr2.test(xq, True).get_mean())
    np.testing.assert_array_equal(rr.test(xq, True).get_gradient_variance(),
                                  rr2.test(xq, True).get_gradient_variance())
    rr2.kernel_origin = [0.25]
    np.testing.assert_array_equal(rr2.get_kernel_coord_origin(), [0.25])


def test_bank_fit_rr_matches_single_rr_gps_and_jax():
    """tests/test_mapping_and_batch.py:161-206: each member of a
    reduced-rank bank equals a standalone reduced-rank GP on its data, and
    the bank equals JAX's."""
    rng = np.random.default_rng(11)
    B, nmax = 3, 40
    xs = np.zeros((B, nmax, 1))
    ys = np.zeros((B, nmax, 1))
    vs = np.zeros((B, nmax))
    ms = np.zeros((B, nmax), bool)
    counts = [40, 18, 29]
    for b, n in enumerate(counts):
        xs[b, :n, 0] = np.sort(rng.uniform(-0.8, 0.8, n))
        ys[b, :n, 0] = np.sin(3 * xs[b, :n, 0]) * (b + 1)
        vs[b, :n] = 1e-3
        ms[b, :n] = True
    kw = _rr_kw(48, boundary=1.5)
    basis = ReducedRankBasis(ReducedRankSetting(**kw))
    jbasis = jrr.ReducedRankBasis(jk.ReducedRankSetting(**kw))
    bank = bank_fit_rr(*map(torch.tensor, (xs, ys, vs, ms)), basis)
    jbank = jbg.bank_fit_rr(*map(jnp.asarray, (xs, ys, vs, ms)), jbasis)
    assert tuple(bank.L.shape) == (B, 48, 48)
    _close(bank.L, jbank.L, 1e-12)
    _close(bank.alpha, jbank.alpha, 1e-12)
    q = np.linspace(-0.7, 0.7, 33)
    idx = np.tile(np.arange(B), 11).astype(np.int32)
    mean, var, valid = bank_predict_assigned(
        bank, q[:, None], idx, 0.3, kernel="rbf", reduced_rank=True,
        basis=basis)
    assert valid.all() and (var > 0).all()
    for b in range(B):
        gp = VanillaGaussianProcess(VanillaGPSetting(
            kernel_type="rr_rbf", kernel=ReducedRankSetting(**kw)),
            device="cpu")
        n = counts[b]
        gp.train(xs[b, :n, 0][None], ys[b, :n, 0], 1e-3)
        res = gp.test(q[None, :])
        sel = np.flatnonzero(idx == b)
        np.testing.assert_allclose(mean[sel, 0], res.get_mean()[sel],
                                   atol=1e-10)
        np.testing.assert_allclose(var[sel], res.get_variance()[sel],
                                   atol=1e-10)
    # the banks' robust Cholesky jitters each failing member alone, as the
    # JAX package's vmapped loop does: a singular (all-ones) member beside
    # a well-posed one
    from erl_gaussian_process_tpu.models import gp_core as jgp
    from erl_gaussian_process_tpu_torch.models import gp_core
    K = torch.stack([torch.eye(48, dtype=torch.float64) * 2.0,
                     torch.ones((48, 48), dtype=torch.float64)])
    assert bool(torch.isnan(gp_core.cholesky_nan(K)[1]).all())
    L = gp_core.robust_cholesky(K)
    jL = jax.vmap(jgp.robust_cholesky)(jnp.asarray(K.numpy()))
    assert bool(torch.isfinite(L).all())
    # the singular member's factor is ill-conditioned entry by entry: hold
    # the matrices the two factor, K + the first jitter that succeeds
    jL = torch.tensor(np.asarray(jL))
    _close(L @ L.mT, jL @ jL.mT, 1e-12)
    _close(L @ L.mT, K, 1e-12)
    assert torch.equal(L[0], gp_core.cholesky_nan(K[:1])[0])


# -- the 2D lidar GP with a reduced-rank kernel ------------------------------

GROUP, OVERLAP, MARGIN = 20, 6, 1


def _rr_lidar_setting_dict(angles, num_basis=96, boundary=(3.0,),
                           discontinuity=False, group=GROUP + OVERLAP):
    kernel = dict(x_dim=1, scale=0.25, num_basis=[num_basis])
    if boundary is not None:
        kernel.update(boundary=list(boundary), coord_origin=[0.0])
    return dict(group_size=group, overlap_size=OVERLAP, margin=MARGIN,
                sensor_range_var=1e-4, max_valid_range_var=0.5,
                sensor_frame=dict(valid_range_min=0.1, valid_range_max=30.0,
                                  angle_min=float(angles[0]),
                                  angle_max=float(angles[-1]),
                                  num_rays=int(angles.shape[0]),
                                  discontinuity_detection=discontinuity),
                gp=dict(kernel_type="reduced_rank_rbf", kernel=kernel),
                mapping=dict(type="identity"))


def _lidar_pair(d, dtype=np.float64):
    return (LidarGaussianProcess2D(LidarGP2DSetting.from_dict(d),
                                   dtype=dtype, device="cpu"),
            jlidar.LidarGaussianProcess2D(
                jlidar.LidarGP2DSetting.from_dict(d), dtype=dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lidar_rr_through_the_bank_matches_jax(dtype, tmp_path):
    """tests/test_lidar_gp_2d.py:155-210: a smooth 270-ray scan, rows =
    #basis, MAE < 0.02, +||.||^2 variances, the exact twin's accuracy
    class, a checkpoint, and the JAX model's bank and predictions."""
    n = 270
    angles = np.linspace(-2.2, 2.2, n)
    ranges = 3.0 + 0.8 * np.sin(2.0 * angles)
    gp, jgp = _lidar_pair(_rr_lidar_setting_dict(angles), dtype)
    assert gp.using_reduced_rank_kernel()
    for m in (gp, jgp):
        assert m.train(np.eye(2), np.zeros(2), ranges)
    assert tuple(gp.bank.L.shape)[1:] == (96, 96)
    tol = TOL[dtype] if dtype == np.float32 else 1e-11
    _close(gp.bank.L, jgp.bank.L, tol)
    res, jres = gp.test(angles, True, True), jgp.test(angles, True, True)
    pred, valid = res.get_mean()
    jpred, jvalid = jres.get_mean()
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum() > 0.9 * n
    _close(pred[valid], jpred[valid], TOL[dtype])
    var, vvalid = res.get_variance()
    _close(var[vvalid], jres.get_variance()[0][vvalid], TOL[dtype])
    assert np.all(var[vvalid] > 0)
    mae = np.abs(pred[valid] - ranges[valid]).mean()
    assert mae < 0.02, mae
    d = _rr_lidar_setting_dict(angles)
    d["gp"] = {"kernel_type": "rbf", "kernel": {"x_dim": 1, "scale": 0.25}}
    twin = LidarGaussianProcess2D(LidarGP2DSetting.from_dict(d), dtype=dtype,
                                  device="cpu")
    twin.train(np.eye(2), np.zeros(2), ranges)
    p2, v2 = twin.test(angles, True, True).get_mean()
    assert mae < np.abs(p2[v2] - ranges[v2]).mean() + 0.01
    p = str(tmp_path / "lidar_rr.npz")
    gp.save(p)
    gp3 = LidarGaussianProcess2D(LidarGP2DSetting(), device="cpu")
    gp3.load(p)
    assert gp3.using_reduced_rank_kernel() and gp == gp3
    np.testing.assert_array_equal(gp3.test(angles, True, True).get_mean()[0],
                                  pred)
    carried = lidar_gp_2d_from_numpy(jgp.state_dict(), device="cpu")
    assert carried.using_reduced_rank_kernel()
    cp, cv = carried.test(angles, True, True).get_mean()
    np.testing.assert_array_equal(cv, jvalid)
    _close(cp[cv], jpred[jvalid], TOL[dtype])
    with pytest.raises(NotImplementedError, match="plain kernel"):
        gp.train_scan_batch(ranges[None])


def test_lidar_rr_boundary_defaults_from_the_frame():
    """A setting that gives only num_basis gets the frame's half-span plus
    3 length scales, as JAX's; rays past +-1 rad predict right."""
    n = 270
    angles = np.linspace(-2.2, 2.2, n)
    ranges = 3.0 + 0.8 * np.sin(2.0 * angles)
    gp, jgp = _lidar_pair(_rr_lidar_setting_dict(angles, boundary=None))
    assert gp.setting.gp.kernel.boundary == jgp.setting.gp.kernel.boundary
    assert gp.setting.gp.kernel.boundary[0] >= 2.2 + 3 * 0.25 - 1e-9
    for m in (gp, jgp):
        assert m.train(np.eye(2), np.zeros(2), ranges)
    pred, valid = gp.test(angles, True, True).get_mean()
    jpred, _ = jgp.test(angles, True, True).get_mean()
    outer = valid & (np.abs(angles) > 1.2)
    assert outer.sum() > 0
    assert np.abs(pred[outer] - ranges[outer]).mean() < 0.02
    _close(pred[valid], jpred[valid], 1e-12)


def test_lidar_rr_explicit_unit_boundary_survives():
    angles = np.linspace(-0.7, 0.7, 90)
    gp, jgp = _lidar_pair(_rr_lidar_setting_dict(angles, num_basis=64,
                                                 boundary=(1.0,)))
    assert list(gp.setting.gp.kernel.boundary) == [1.0] == \
        list(jgp.setting.gp.kernel.boundary)


def test_lidar_rr_scan_train_matches_host_assembled_path_and_jax():
    """The device gather (holes, discontinuity detection on) feeding the
    reduced-rank bank equals the host-assembled arrays through
    bank_fit_rr, and JAX's fused reduced-rank train."""
    n = 270
    angles = np.linspace(-2.2, 2.2, n)
    ranges = 3.0 + 0.8 * np.sin(2.0 * angles)
    ranges[40:60] = np.inf
    gp, jgp = _lidar_pair(_rr_lidar_setting_dict(
        angles, num_basis=48, boundary=None, discontinuity=True, group=32))
    for m in (gp, jgp):
        assert m.train(np.eye(2), np.zeros(2), ranges)
    xs, ys, vs, ms = gp._assemble_bank_arrays()
    ref = bank_fit_rr_core(*map(torch.tensor, (xs, ys, vs, ms)),
                           *gp._basis.consts("cpu"))
    np.testing.assert_array_equal(gp.bank.mask.numpy(), ms)
    np.testing.assert_array_equal(gp.bank.x.numpy(), xs)
    assert torch.equal(gp.bank.L, ref.L)
    assert torch.equal(gp.bank.alpha, ref.alpha)
    np.testing.assert_array_equal(gp.bank.x.numpy(), np.asarray(jgp.bank.x))
    _close(gp.bank.L, jgp.bank.L, 1e-12)
    _close(gp.bank.alpha, jgp.bank.alpha, 1e-10)


def test_range_sensor_gp_3d_rr_carried_from_jax():
    """A JAX 3D sensor GP with a reduced-rank kernel (24 x 12 basis on a
    64 x 33 lidar scan of a wavy room), its state carried into the port:
    the same routed predictions, and the next scan trained the same."""
    from erl_gaussian_process_tpu.models.range_sensor_gp_3d import (
        RangeSensorGaussianProcess3D as JaxGP3D,
        RangeSensorGP3DSetting as JaxSetting3D,
    )
    from erl_gaussian_process_tpu_torch.utils.convert import (
        range_sensor_gp_3d_from_numpy,
    )

    d = dict(row_group_size=12, row_overlap_size=4, col_group_size=12,
             col_overlap_size=4, sensor_range_var=1e-4,
             sensor_frame=dict(valid_range_min=0.1, valid_range_max=40.0,
                               azimuth_min=-np.pi, azimuth_max=np.pi,
                               elevation_min=-0.6, elevation_max=0.6,
                               num_azimuth_lines=64, num_elevation_lines=33),
             gp=dict(kernel_type="reduced_rank_rbf",
                     kernel=dict(x_dim=2, scale=0.5, num_basis=[24, 12],
                                 boundary=[4.8, 2.1],
                                 coord_origin=[0.0, 0.0])),
             mapping=dict(type="identity"))
    jgp = JaxGP3D(JaxSetting3D.from_dict(d))
    dirs = jgp.sensor_frame.ray_directions_in_frame()
    az = np.arctan2(dirs[..., 1], dirs[..., 0])
    el = np.arctan2(dirs[..., 2], np.hypot(dirs[..., 0], dirs[..., 1]))
    ranges = 5.0 + 0.5 * np.sin(3 * az) * np.cos(2 * el)
    assert jgp.train(np.eye(3), np.zeros(3), ranges)
    gp = range_sensor_gp_3d_from_numpy(jgp.state_dict(), device="cpu")
    assert gp.using_reduced_rank_kernel()
    assert tuple(gp.bank.L.shape)[1:] == (288, 288)
    q = dirs.reshape(-1, 3)[::5]
    a, b = gp.test(q, True, True), jgp.test(q, True, True)
    np.testing.assert_array_equal(a.get_mean()[1], b.get_mean()[1])
    v = a.get_mean()[1]
    assert v.mean() > 0.9
    assert np.mean((a.get_mean()[0][v] - ranges.reshape(-1)[::5][v]) ** 2) \
        < 1e-5
    _close(a.get_mean()[0][v], b.get_mean()[0][v], 1e-12)
    _close(a.get_variance()[0][v], b.get_variance()[0][v], 1e-12)
    for m in (gp, jgp):
        assert m.train(np.eye(3), np.zeros(3), ranges * 1.01)
    _close(gp.bank.L, jgp.bank.L, 1e-11)


def test_rr_fit_indefinite_system_retries_like_jax(caplog):
    """A negative noise variance makes the information matrix indefinite:
    the blocked Cholesky's plain version gives NaN, and the host retry
    escalates the jitter to the level at which the JAX package's fit
    succeeds, with the same posterior."""
    import logging

    x, y, _ = _sine_data(n=60)
    rr, jrr_gp = _vanilla_pair("rr_rbf", _rr_kw(32))
    with caplog.at_level(logging.WARNING):
        for m in (rr, jrr_gp):
            assert m.train(x, y, -5e-3)
    assert any("jitter 0.01" in r.getMessage() for r in caplog.records
               if r.name == "erl_gaussian_process_tpu_torch")
    assert bool(torch.isfinite(rr.state.L).all())
    xq = np.linspace(-0.7, 0.7, 41)[None]
    _test_close(rr.test(xq), jrr_gp.test(xq), 1e-12)
