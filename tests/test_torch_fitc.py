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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_update_sums_pose_by_pose(dtype):
    """``block`` = one pose's samples: a fused update of c poses is the sum
    of the c per-pose products in pose order (the same operations, bit for
    bit); a single pose (``block`` 0, or >= n) keeps the one-product bits
    of the update before the block sum existed, which the chain below
    writes out."""
    rng = np.random.default_rng(3)
    pseudo, x, y, mask = _problem(rng, 70, 4 * 96, 2, 1, dtype)
    var = np.full(4 * 96, 1e-2, dtype)
    st = spgp_init(torch.tensor(pseudo), 0.6, kernel="matern32")
    args = _t(st.pseudo, st.L_inv, x, y, var, mask)
    single = fitc_update_plain("matern32", *(a[:96] if a.dim() and
                                             a.shape[0] == 4 * 96 else a
                                             for a in args), 0.6)
    for block in (0, 96, 500):
        one = fitc_update_plain("matern32", *(a[:96] if a.dim() and
                                              a.shape[0] == 4 * 96 else a
                                              for a in args), 0.6, block)
        assert all(torch.equal(p, q) for p, q in zip(one, single))
    from erl_gaussian_process_tpu_torch.kernels.stationary import cross_gram

    kmn = cross_gram("matern32", args[0], args[2][:96], 0.6)
    beta = args[1] @ kmn
    lam = torch.clamp(1.0 - torch.sum(beta * beta, dim=0), min=0.0)
    inv = torch.where(args[5][:96], 1.0 / (lam + args[4][:96]),
                      torch.zeros_like(lam))
    ksc = kmn * inv[None, :]
    yv = torch.where(args[5][:96, None], args[3][:96],
                     torch.zeros_like(args[3][:96]))
    assert torch.equal(single[0], ksc @ kmn.T)
    assert torch.equal(single[1], ksc @ yv)
    fused = fitc_update_plain("matern32", *args, 0.6, 96)
    whole = fitc_update_plain("matern32", *args, 0.6)
    k_all = cross_gram("matern32", args[0], args[2], 0.6)
    b_all = args[1] @ k_all
    lam = torch.clamp(1.0 - torch.sum(b_all * b_all, dim=0), min=0.0)
    w = torch.where(args[5], 1.0 / (lam + args[4]), torch.zeros_like(lam))
    ks = k_all * w[None, :]
    yv = torch.where(args[5][:, None], args[3], torch.zeros_like(args[3]))
    dq, da = ks[:, :96] @ k_all[:, :96].T, ks[:, :96] @ yv[:96]
    for lo in (96, 192, 288):
        dq = dq + ks[:, lo:lo + 96] @ k_all[:, lo:lo + 96].T
        da = da + ks[:, lo:lo + 96] @ yv[lo:lo + 96]
    assert torch.equal(fused[0], dq) and torch.equal(fused[1], da)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for a, b in zip(fused, whole):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_spgp_update_sums_a_fused_update_pose_by_pose_on_the_cpu():
    """``spgp_update(block=)`` on CPU tensors: a fused update of 4 poses
    adds the plain version's pose-by-pose sum; a single pose (``block`` =
    n) goes through the op, whose plain version is the one product; the
    op itself takes no ``block``."""
    from erl_gaussian_process_tpu_torch.models.gp_core import kahan_add
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        spgp_update,
    )

    rng = np.random.default_rng(5)
    pseudo, x, y, mask = _problem(rng, 40, 4 * 64, 2, 1, np.float32)
    var = np.full(4 * 64, 1e-2, np.float32)
    st = spgp_init(torch.tensor(pseudo), 0.6, kernel="matern32")
    args = _t(x, y, var, mask)
    for block, n in ((64, 4 * 64), (64, 64)):
        a = [t[:n] for t in args]
        got = spgp_update(st, *a, 0.6, kernel="matern32", block=block)
        dq, da = fitc_update_plain("matern32", st.pseudo, st.L_inv, *a, 0.6,
                                   block)
        assert torch.equal(got.qm, kahan_add(st.qm, st.qm_c, dq)[0])
        assert torch.equal(got.alpha, kahan_add(st.alpha, st.alpha_c, da)[0])
    assert "block" not in str(torch.ops.egp.fitc_update.default._schema)
