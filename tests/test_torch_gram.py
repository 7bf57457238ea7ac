"""The PyTorch port's cross-gram (erl_gaussian_process_tpu_torch/ops/gram.py)
against the JAX package: the plain version vs ``kernel_fn`` at float64 and
vs the Pallas gram kernel in interpret mode at float32, on the same inputs
made from a numpy seed. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from erl_gaussian_process_tpu.kernels import kernel_fn as jax_kernel_fn
from erl_gaussian_process_tpu.kernels import train_gram as jax_train_gram
from erl_gaussian_process_tpu.kernels import (
    register_scale_mixture as jax_register_mixture,
)
from erl_gaussian_process_tpu.ops.pallas_gram import pallas_cross_gram
from erl_gaussian_process_tpu_torch.kernels import (
    cross_gram,
    register_scale_mixture,
    resolve_kernel_name,
    train_gram,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    pad_pseudo_points,
)
from erl_gaussian_process_tpu_torch.ops import (
    cross_gram_cuda,
    cross_gram_plain,
    launch_counts,
)
from erl_gaussian_process_tpu_torch.ops.gram import family_args
from tests.conftest import interpret_test

MIXTURE = ("matern32", 1.5, (1.0, 2.0, 0.5))
FAMILIES = ["rbf", "ou", "matern32", "mixture"]


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


def test_family_args_for_the_kernel():
    assert family_args("matern32") == (2, (1.0,), (1.0,))
    name = register_scale_mixture(*MIXTURE)
    fam, ratios, weights = family_args(name)
    assert fam == 2 and ratios == (1.0, 1.5, 2.25)
    np.testing.assert_allclose(weights, np.array([1.0, 2.0, 0.5]) / 3.5)
    with pytest.raises(ValueError, match="at most 8"):
        family_args(register_scale_mixture("rbf", 1.1, (1.0,) * 9))
    with pytest.raises(KeyError):
        family_args("nope")


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
