"""The PyTorch port's cross-gram (erl_gaussian_process_tpu_torch/ops/gram.py)
against the JAX package: the plain version vs ``kernel_fn`` at float64 and
vs the Pallas gram kernel in interpret mode at float32, with and without
the row mask, on the same inputs made from a numpy seed; the host's family
constants against the JAX ``_apply_family`` formulas; the masked callers
(``kernels.stationary.cross_gram``, ``batch_gp.bank_predict``) against
theirs. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import erl_gaussian_process_tpu.models.batch_gp as jax_batch_gp
from erl_gaussian_process_tpu.kernels import cross_gram as jax_cross_gram
from erl_gaussian_process_tpu.kernels import kernel_fn as jax_kernel_fn
from erl_gaussian_process_tpu.kernels import train_gram as jax_train_gram
from erl_gaussian_process_tpu.kernels import (
    register_scale_mixture as jax_register_mixture,
)
from erl_gaussian_process_tpu.ops.pallas_gram import (
    _apply_family as jax_apply_family,
)
from erl_gaussian_process_tpu.ops.pallas_gram import pallas_cross_gram
from erl_gaussian_process_tpu_torch.kernels import (
    cross_gram,
    register_scale_mixture,
    resolve_kernel_name,
    train_gram,
)
from erl_gaussian_process_tpu_torch.kernels.base import mixture_params
from erl_gaussian_process_tpu_torch.models.batch_gp import (
    bank_fit,
    bank_predict,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    pad_pseudo_points,
)
from erl_gaussian_process_tpu_torch.ops import (
    cross_gram_cuda,
    cross_gram_plain,
    launch_counts,
)
from erl_gaussian_process_tpu_torch.ops.gram import (
    apply_family,
    family_components,
    packed_family,
)
from tests.conftest import interpret_test

MIXTURE = ("matern32", 1.5, (1.0, 2.0, 0.5))
FAMILIES = ["rbf", "ou", "matern32", "mixture"]


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """Run torch's CPU exp once over a float32 tensor large enough to be
    split over every thread before the parity tests. In a fresh process,
    the first such call of this CPU build of torch was off by up to 1.5e-4
    (relative) in one thread's chunk in about 3% of processes, with or
    without JAX loaded, and never with one thread; every later call in the
    process was exact to float32 rounding. Without this call, whichever f32
    parity test came first in a worker process failed at that rate."""
    torch.exp(torch.zeros(1 << 20, dtype=torch.float32))


def _names(fam):
    """(jax name, port name) of a family; the mixture registers in both."""
    if fam == "mixture":
        return jax_register_mixture(*MIXTURE), register_scale_mixture(*MIXTURE)
    return fam, fam


@pytest.mark.parametrize("fam", FAMILIES)
def test_plain_gram_matches_jax_f64(fam):
    jname, tname = _names(fam)
    assert jname == tname
    rng = np.random.default_rng(0)
    x1 = rng.uniform(-2, 2, (37, 3))
    x2 = rng.uniform(-2, 2, (53, 3))
    ref = np.asarray(jax_kernel_fn(jname)(jnp.asarray(x1), jnp.asarray(x2),
                                          np.float64(0.7)))
    got = cross_gram(tname, torch.as_tensor(x1), torch.as_tensor(x2), 0.7)
    assert got.dtype == torch.float64 and got.shape == (37, 53)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fam", FAMILIES)
@interpret_test
def test_plain_gram_matches_pallas_interpret_f32(fam):
    """Same tolerance as tests/test_ops.py's Pallas gram parity test."""
    jname, tname = _names(fam)
    rng = np.random.default_rng(1)
    x1 = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    x2 = rng.uniform(-2, 2, (513, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_cross_gram(jname, jnp.asarray(x1),
                                           jnp.asarray(x2), 0.3))
    got = cross_gram_cuda(tname, torch.as_tensor(x1), torch.as_tensor(x2), 0.3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fam", FAMILIES)
def test_far_point_rows_exactly_zero(fam, dtype):
    """Far-point padding rows (coordinates up to ~1e17) give exactly +0.0
    against data and against each other, so K_M = block-diag(K, I)."""
    _, tname = _names(fam)
    rng = np.random.default_rng(2)
    p = pad_pseudo_points(rng.uniform(-3, 3, (100, 3)).astype(dtype))
    assert p.shape == (128, 3)
    x = torch.as_tensor(rng.uniform(-5, 5, (64, 3)).astype(dtype))
    P = torch.as_tensor(p)
    k = cross_gram(tname, P, x, 0.5)
    assert torch.isfinite(k).all()
    assert (k[100:] == 0).all() and not torch.signbit(k[100:]).any()
    kp = cross_gram(tname, P[100:], P[100:], 0.5).numpy()
    off = ~np.eye(28, dtype=bool)
    assert (kp[off] == 0).all()
    # a mixture's normalized weights sum to 1 up to rounding
    np.testing.assert_allclose(np.diag(kp), 1.0, rtol=1e-6)


def test_train_gram_matches_jax_f64():
    """k(x, x) + diag(var), identity rows/cols outside the mask."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, (40, 3))
    var = rng.uniform(1e-3, 1e-1, 40)
    mask = rng.uniform(size=40) < 0.7
    ref = np.asarray(jax_train_gram("matern32", jnp.asarray(x),
                                    jnp.asarray(var), np.float64(0.5),
                                    jnp.asarray(mask)))
    got = train_gram("matern32", torch.tensor(x), torch.tensor(var), 0.5,
                     torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_registry_resolves_reference_names():
    assert resolve_kernel_name("erl::covariance::Matern32<float, 3>") == \
        "matern32"
    assert resolve_kernel_name("RadialBiasFunction1d") == "rbf"
    assert resolve_kernel_name("erl::covariance::OrnsteinUhlenbeck<double, 2>"
                               ) == "ou"


def _packed(name, scale):
    fam, ncomp, coefs, weights = packed_family(name, scale)
    assert len(coefs) == len(weights) == ncomp
    return fam, tuple(coefs), tuple(weights)


def test_family_args_for_the_kernel():
    """The kernels' family arguments: the family id, one float64
    coefficient and one weight a component."""
    assert _packed("matern32", 0.5) == (2, (math.sqrt(3.0) / 0.5,), (1.0,))
    name = register_scale_mixture(*MIXTURE)
    fam, coefs, weights = _packed(name, 0.4)
    assert fam == 2
    assert coefs == tuple(math.sqrt(3.0) / (0.4 * r)
                          for r in (1.0, 1.5, 2.25))
    np.testing.assert_allclose(weights, np.array([1.0, 2.0, 0.5]) / 3.5)
    with pytest.raises(ValueError, match="at most 8"):
        packed_family(register_scale_mixture("rbf", 1.1, (1.0,) * 9), 1.0)
    with pytest.raises(KeyError):
        packed_family("nope", 1.0)


_FORMULAS = {
    "rbf": (lambda s: -0.5 / (s * s), lambda r2, c: np.exp(r2 * c)),
    "ou": (lambda s: 1.0 / s, lambda r2, c: np.exp(-np.sqrt(r2) * c)),
    "matern32": (lambda s: math.sqrt(3.0) / s,
                 lambda r2, c: (1.0 + c * np.sqrt(r2))
                 * np.exp(-c * np.sqrt(r2))),
}


@pytest.mark.parametrize("fam", FAMILIES)
def test_host_constants_are_the_apply_family_formulas(fam):
    """The constants every kernel takes from the host (csrc/family.cuh) are
    the JAX ``_apply_family`` formulas at s_i = scale * ratio_i, in
    float64: rbf -0.5 / s^2, ou 1 / s, matern32 sqrt(3) / s; the kernel
    value rebuilt from them, and the port's plain ``apply_family``, equal
    ``_apply_family`` at float64."""
    jname, tname = _names(fam)
    scale = 0.37
    base, coefs, weights = family_components(tname, scale)
    mix = mixture_params(tname)
    ratios, wref = (mix[1], mix[2]) if mix else ((1.0,), (1.0,))
    coef_of, value_of = _FORMULAS[base]
    assert coefs == tuple(coef_of(scale * r) for r in ratios)
    assert weights == tuple(wref)
    assert _packed(tname, scale)[1:] == (coefs, weights)
    r2 = np.linspace(0.0, 9.0, 181)
    ref = np.asarray(jax_apply_family(jname, jnp.asarray(r2), scale))
    rebuilt = sum(w * value_of(r2, c) for c, w in zip(coefs, weights))
    np.testing.assert_allclose(rebuilt, ref, rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(apply_family(tname, torch.as_tensor(r2),
                                            scale).numpy(), ref,
                               rtol=1e-14, atol=1e-15)


def _masked_inputs(m, n, dtype, seed):
    """x1 (m, 3) and x2 (n, 3) in [-2, 2], a row mask with about a third of
    the rows off (not a prefix), NaN in the coordinates of two masked
    rows."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-2, 2, (m, 3)).astype(dtype)
    x2 = rng.uniform(-2, 2, (n, 3)).astype(dtype)
    mask = rng.uniform(size=m) < 0.65
    mask[:2] = False
    x1[0, 1] = np.nan
    x1[1] = np.nan
    return x1, x2, mask


@pytest.mark.parametrize("fam", FAMILIES)
def test_masked_plain_gram_matches_jax_f64(fam):
    """cross_gram_plain(mask1=) against the JAX cross_gram(mask1=): masked
    rows exactly 0, NaN coordinates in them included."""
    jname, tname = _names(fam)
    x1, x2, mask = _masked_inputs(37, 53, np.float64, 6)
    ref = np.asarray(jax_cross_gram(jname, jnp.asarray(x1), jnp.asarray(x2),
                                    np.float64(0.7), mask1=jnp.asarray(mask)))
    got = cross_gram_plain(tname, torch.as_tensor(x1), torch.as_tensor(x2),
                           0.7, mask1=torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    assert (got[~mask] == 0).all() and not np.signbit(got[~mask]).any()


@pytest.mark.parametrize("fam", FAMILIES)
@interpret_test
def test_masked_plain_gram_matches_pallas_interpret_f32(fam):
    """The float32 masked gram against the Pallas gram in interpret mode
    masked by JAX's own where, at the unmasked test's tolerance."""
    jname, tname = _names(fam)
    x1, x2, mask = _masked_inputs(300, 513, np.float32, 7)
    with pltpu.force_tpu_interpret_mode():
        k = pallas_cross_gram(jname, jnp.asarray(x1), jnp.asarray(x2), 0.3)
        ref = np.asarray(jnp.where(jnp.asarray(mask)[:, None], k, 0.0))
    got = cross_gram_cuda(tname, torch.as_tensor(x1), torch.as_tensor(x2),
                          0.3, mask1=torch.as_tensor(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert (got.numpy()[~mask] == 0).all()


def _bank_with_masked_rows(dtype):
    rng = np.random.default_rng(9)
    xs = rng.uniform(-1, 1, (5, 24, 2)).astype(dtype)
    ys = (np.sin(3 * xs[:, :, :1]) + np.arange(5)[:, None, None]).astype(
        dtype)
    vs = np.full((5, 24), 1e-2, dtype)
    ms = rng.uniform(size=(5, 24)) < 0.7
    ms[1] = False                                    # an untrained member
    ms[3, :5] = False
    xq = rng.uniform(-1, 1, (5, 11, 2)).astype(dtype)
    return xs, ys, vs, ms, xq


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-4)])
@pytest.mark.parametrize("caller", ["cross_gram", "bank_predict"])
def test_masked_callers_match_jax(caller, dtype, tol):
    """The two callers that mask the gram's rows, against JAX on the CPU:
    ``kernels.stationary.cross_gram(mask1=)`` (the exact GP's test) and
    ``batch_gp.bank_predict`` on a bank with masked rows and an untrained
    member (the sensor GPs' routed predict); float32 to the bank parity
    tolerance, relative to the largest value."""
    if caller == "cross_gram":
        x1, x2, mask = _masked_inputs(70, 45, dtype, 8)
        ref = [np.asarray(jax_cross_gram(
            "rbf", jnp.asarray(x1), jnp.asarray(x2), dtype(0.5),
            mask1=jnp.asarray(mask)))]
        got = [cross_gram("rbf", torch.as_tensor(x1), torch.as_tensor(x2),
                          0.5, mask1=torch.as_tensor(mask))]
    else:
        xs, ys, vs, ms, xq = _bank_with_masked_rows(dtype)
        jstate = jax_batch_gp.bank_fit(*map(jnp.asarray, (xs, ys, vs, ms)),
                                       0.4, kernel="ou")
        ref = jax_batch_gp.bank_predict(jstate, jnp.asarray(xq), 0.4,
                                        kernel="ou")
        state = bank_fit(*map(torch.as_tensor, (xs, ys, vs, ms)), 0.4,
                         kernel="ou")
        got = bank_predict(state, torch.as_tensor(xq), 0.4, kernel="ou")
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == dtype and g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=tol * max(np.abs(r).max(), 1.0))


def test_cpu_takes_plain_version_without_launching():
    before = launch_counts()["gram"]
    x = torch.ones((4, 3), dtype=torch.float64)
    k = cross_gram_cuda("rbf", x, x, 1.0)
    torch.testing.assert_close(k, cross_gram_plain("rbf", x, x, 1.0),
                               rtol=0, atol=0)
    assert launch_counts()["gram"] == before


def test_non_cpu_non_cuda_operands_raise():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches the kernel or raises."""
    x = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cross_gram_cuda("rbf", x, x, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        cross_gram_cuda("rbf", torch.ones(4, 3), x, 1.0)
