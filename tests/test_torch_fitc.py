"""The PyTorch port's FITC update (erl_gaussian_process_tpu_torch/ops/fitc.py)
against the JAX package: the plain version vs ``fitc_delta`` at float64 and
vs the Pallas FITC kernel in interpret mode at float32, on the same inputs
made from a numpy seed. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
    fitc_delta as jax_fitc_delta,
)
from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
    spgp_init as jax_spgp_init,
)
from erl_gaussian_process_tpu.ops.pallas_fitc import pallas_fitc_update
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    pad_pseudo_points,
    spgp_init,
)
from erl_gaussian_process_tpu_torch.ops import (
    fitc_update_cuda,
    fitc_update_plain,
    launch_counts,
)
from tests.conftest import interpret_test


def _problem(rng, m, n, d, q, dtype, half=2.0):
    pseudo = rng.uniform(-half, half, (m, d)).astype(dtype)
    x = rng.uniform(-2, 2, (n, d)).astype(dtype)
    y = rng.uniform(-1, 1, (n, q)).astype(dtype)
    mask = rng.uniform(size=n) < 0.8
    return pseudo, x, y, mask


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("beta_via", ["L_inv", "trsm"])
def test_plain_fitc_matches_jax_fitc_delta_f64(beta_via):
    """Against both of fitc_delta's formulations (the L_inv product, as the
    kernel computes it, and the triangular solve of the JAX float64 path)
    at 1e-12 of max|dQ|."""
    rng = np.random.default_rng(0)
    pseudo, x, y, mask = _problem(rng, 60, 200, 3, 2, np.float64)
    var = np.full(200, 1e-2)
    st = jax_spgp_init(jnp.asarray(pseudo), np.float64(0.7), kernel="matern32")
    dq_ref, da_ref = jax_fitc_delta(
        st.pseudo, st.L_km, jnp.asarray(x), jnp.asarray(y), jnp.asarray(var),
        jnp.asarray(mask), np.float64(0.7), kernel="matern32",
        L_inv=st.L_inv if beta_via == "L_inv" else None)
    dq_ref, da_ref = np.asarray(dq_ref), np.asarray(da_ref)
    dq, da = fitc_update_cuda("matern32", *_t(st.pseudo, st.L_inv, x, y, var,
                                               mask), 0.7)
    assert dq.dtype == torch.float64 and dq.shape == (60, 60)
    assert da.shape == (60, 2)
    np.testing.assert_allclose(dq.numpy(), dq_ref, rtol=0,
                               atol=1e-12 * np.abs(dq_ref).max())
    np.testing.assert_allclose(da.numpy(), da_ref, rtol=0,
                               atol=1e-12 * np.abs(da_ref).max())


@interpret_test
@pytest.mark.parametrize("m", [128, 384])
def test_plain_fitc_matches_pallas_interpret_f32(m):
    """Same inputs and tolerance as tests/test_ops.py's Pallas FITC parity
    test (var = 0.1: the 1/(lam + var) amplification of the Pallas kernel's
    bf16x3 products stays <= 10)."""
    rng = np.random.default_rng(1)
    n, d = 200, 2
    half = 2.0 * np.sqrt(m / 128.0)
    pseudo, x, y, mask = _problem(rng, m, n, d, 1, np.float32, half)
    st = jax_spgp_init(jnp.asarray(pseudo), np.float32(0.5), kernel="matern32")
    var = np.full(n, 0.1, np.float32)
    with pltpu.force_tpu_interpret_mode():
        dq_ref, da_ref = pallas_fitc_update(
            "matern32", st.pseudo, st.L_inv, jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(var), jnp.asarray(mask), np.float32(0.5))
    dq, da = fitc_update_cuda("matern32", *_t(st.pseudo, st.L_inv, x, y, var,
                                               mask), 0.5)
    assert dq.dtype == torch.float32
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(da.numpy(), np.asarray(da_ref), rtol=2e-3,
                               atol=2e-3)


def test_masked_samples_contribute_nothing():
    """Masked columns drop out exactly, whatever their coordinates, labels
    and variances hold (here a zero variance, which an unmasked sample
    could not have)."""
    rng = np.random.default_rng(2)
    pseudo, x, y, mask = _problem(rng, 40, 90, 3, 1, np.float64)
    st = spgp_init(torch.as_tensor(pseudo), 0.6, kernel="rbf")
    var = np.where(mask, 1e-3, 0.0)
    dq, da = fitc_update_cuda("rbf", st.pseudo, st.L_inv,
                              *_t(x, y, var, mask), 0.6)
    keep = np.flatnonzero(mask)
    dq2, da2 = fitc_update_plain(
        "rbf", st.pseudo, st.L_inv,
        *_t(x[keep], y[keep], var[keep], np.ones(len(keep), bool)), 0.6)
    torch.testing.assert_close(dq, dq2, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(da, da2, rtol=1e-12, atol=1e-12)


def test_far_point_padding_rows_stay_zero():
    rng = np.random.default_rng(3)
    pseudo = pad_pseudo_points(rng.uniform(-2, 2, (100, 3)))
    st = spgp_init(torch.as_tensor(pseudo), 0.5, kernel="matern32")
    _, x, y, mask = _problem(rng, 1, 64, 3, 1, np.float64)
    dq, da = fitc_update_cuda("matern32", st.pseudo, st.L_inv,
                              *_t(x, y, np.full(64, 1e-4), mask), 0.5)
    assert (dq[100:] == 0).all() and (dq[:, 100:] == 0).all()
    assert (da[100:] == 0).all()


def test_cpu_takes_plain_version_without_launching():
    rng = np.random.default_rng(4)
    pseudo, x, y, mask = _problem(rng, 20, 30, 3, 1, np.float32)
    st = spgp_init(torch.as_tensor(pseudo), 0.5, kernel="ou")
    args = ("ou", st.pseudo, st.L_inv, *_t(x, y, np.full(30, 0.1, np.float32),
                                           mask), 0.5)
    before = launch_counts()["fitc"]
    dq, da = fitc_update_cuda(*args)
    dq2, da2 = fitc_update_plain(*args)
    assert torch.equal(dq, dq2) and torch.equal(da, da2)
    assert launch_counts()["fitc"] == before


def test_non_cpu_operands_raise():
    meta = [torch.empty(s, device="meta") for s in
            ((8, 3), (8, 8), (5, 3), (5, 1), (5,))]
    mask = torch.ones(5, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fitc_update_cuda("rbf", *meta, mask, 1.0)
