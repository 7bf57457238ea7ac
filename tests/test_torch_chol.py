"""The port's blocked Cholesky (``erl_gaussian_process_tpu_torch/ops/chol.py``)
against the JAX package's: its plain versions (what the CPU runs) beside
the JAX Pallas kernels in interpret mode at a shrunk tile, with the
tolerances of ``tests/test_ops.py`` (float32 against float64 numpy), and
against the JAX package's XLA route at float64 to 1e-12; plus the
semantics the CUDA kernels share with them (exactly lower triangular,
masked and pad rows identity, Dinv the inverses of L's diagonal tiles, NaN
on a non-SPD input). The CUDA kernels themselves are held against these
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from erl_gaussian_process_tpu.kernels import (
    train_gram as jax_train_gram,
    train_gram_with_gradient as jax_train_gram_with_gradient,
)
from erl_gaussian_process_tpu.kernels.stationary import (
    register_scale_mixture as jax_register_scale_mixture,
)
from erl_gaussian_process_tpu.ops import pallas_chol as pc
from erl_gaussian_process_tpu_torch.kernels import register_scale_mixture
from erl_gaussian_process_tpu_torch.models import gp_core
from erl_gaussian_process_tpu_torch.ops import (
    chol_blocked,
    chol_blocked_gram,
    chol_blocked_gram_joint,
    TILE,
    launch_counts,
)
from tests.conftest import interpret_test

MIX = ("rbf", 0.5, (0.7, 0.3))


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _spd(rng, n, dtype=np.float32):
    X = rng.standard_normal((n, n)).astype(dtype)
    return (X @ X.T / n + np.eye(n, dtype=dtype) * 2.0).astype(dtype)


def _gram_inputs(rng, n0, dtype=np.float32):
    """tests/test_ops.py's gram case: masked tail rows, a ragged size."""
    x = rng.uniform(-3, 3, (n0, 2)).astype(dtype)
    var = (0.05 + 0.01 * rng.random(n0)).astype(dtype)
    mask = np.ones(n0, bool)
    mask[-4:] = False
    return x, var, mask


def _np_gram(fam, x, var, mask, scale, mix):
    """The dense numpy gram of tests/test_ops.py, float64."""
    x = x.astype(np.float64)
    r = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    if fam == "rbf":
        K = np.exp(-0.5 * (r / scale) ** 2)
    elif fam == "ou":
        K = np.exp(-r / scale)
    elif fam == mix:
        K = (0.7 * np.exp(-0.5 * (r / scale) ** 2)
             + 0.3 * np.exp(-0.5 * (r / (0.5 * scale)) ** 2))
    else:
        c = np.sqrt(3) / scale
        K = (1 + c * r) * np.exp(-c * r)
    K = K + np.diag(var.astype(np.float64))
    K[~mask, :] = 0.0
    K[:, ~mask] = 0.0
    K[np.ix_(~mask, ~mask)] = np.eye(int((~mask).sum()))
    return K


def _joint_inputs(rng, n0, d, dtype=np.float32):
    x = rng.uniform(-2, 2, (n0, d)).astype(dtype)
    var_x = (0.02 + 0.01 * rng.random(n0)).astype(dtype)
    var_y = (0.03 + 0.01 * rng.random(n0)).astype(dtype)
    var_g = (0.05 + 0.01 * rng.random(n0)).astype(dtype)
    sample_mask = rng.random(n0) < 0.9
    grad_mask = rng.random(n0) < 0.7
    return x, var_x, var_y, var_g, sample_mask, grad_mask


def _jax_joint_gram(fam, x, var_x, var_y, var_g, sm, gm, scale):
    j = jnp.asarray
    return np.asarray(jax_train_gram_with_gradient(
        fam, j(x), jnp.where(j(sm), j(var_x), 0.0),
        jnp.where(j(sm), j(var_y), 0.0), jnp.where(j(gm), j(var_g), 0.0),
        j(sm), j(gm), scale), np.float64)


# -- against the JAX kernels in interpret mode (float32) ---------------------

@interpret_test
def test_chol_blocked_plain_matches_jax_interpret(monkeypatch):
    """The plain-A entry at the JAX interpret test's first case (nb = 5 at
    tile 16): the JAX kernel and the port both within 5e-5 of numpy's
    float64 factor, the port exactly lower triangular."""
    monkeypatch.setattr(pc, "_SB", 8)
    tile = 16
    A = _spd(np.random.default_rng(0), 5 * tile)
    with pltpu.force_tpu_interpret_mode():
        jL = np.asarray(pc.chol_blocked(jnp.asarray(A), tile=tile))
    L = chol_blocked(torch.as_tensor(A)).numpy()
    ref = np.linalg.cholesky(A.astype(np.float64))
    assert np.abs(jL - ref).max() < 5e-5
    assert np.abs(L - ref).max() < 5e-5
    assert np.abs(L - jL).max() < 5e-5
    assert np.abs(np.triu(L, 1)).max() == 0.0


@pytest.mark.parametrize("nb", [5, 6, 9])
def test_chol_blocked_plain_matches_numpy(nb):
    """The JAX interpret test's sizes (tile 16) through the port's plain
    entry: within 5e-5 of numpy float64."""
    A = _spd(np.random.default_rng(nb), nb * 16)
    L = chol_blocked(torch.as_tensor(A)).numpy()
    ref = np.linalg.cholesky(A.astype(np.float64))
    assert np.abs(L - ref).max() < 5e-5
    assert np.abs(np.triu(L, 1)).max() == 0.0


@interpret_test
def test_chol_blocked_gram_plain_matches_jax_interpret(monkeypatch):
    """The gram-fused entry at the JAX interpret test's scale-mixture case
    (nb = 5, n0 = 77, 4 masked rows): JAX kernel and port within 3e-4 of
    the dense numpy factor."""
    monkeypatch.setattr(pc, "_SB", 8)
    tile = 16
    mix = register_scale_mixture(*MIX)
    assert jax_register_scale_mixture(*MIX) == mix
    x, var, mask = _gram_inputs(np.random.default_rng(1), 5 * tile - 3)
    scale = np.float32(1.7)
    with pltpu.force_tpu_interpret_mode():
        jL = np.asarray(pc.chol_blocked_gram(
            mix, jnp.asarray(x), jnp.asarray(var), jnp.asarray(mask), scale,
            tile=tile))
    L = chol_blocked_gram(mix, *_t(x, var, mask), float(scale)).numpy()
    ref = np.linalg.cholesky(_np_gram(mix, x, var, mask, scale, mix))
    assert np.abs(jL - ref).max() < 3e-4
    assert np.abs(L - ref).max() < 3e-4
    assert np.abs(np.triu(L, 1)).max() == 0.0


@pytest.mark.parametrize("nb,fam", [(5, "rbf"), (6, "matern32"), (9, "ou"),
                                    (5, "mix")])
def test_chol_blocked_gram_plain_matches_numpy(nb, fam):
    """tests/test_ops.py's four gram cases through the port's plain entry:
    within 3e-4 of the dense numpy factor, masked rows identity."""
    mix = register_scale_mixture(*MIX)
    fam = mix if fam == "mix" else fam
    x, var, mask = _gram_inputs(np.random.default_rng(nb), nb * 16 - 3)
    L = chol_blocked_gram(fam, *_t(x, var, mask), 1.7).numpy()
    ref = np.linalg.cholesky(_np_gram(fam, x, var, mask, 1.7, mix))
    assert np.abs(L - ref).max() < 3e-4
    assert np.abs(np.triu(L, 1)).max() == 0.0
    off = ~mask
    assert np.array_equal(L[np.ix_(off, off)], np.eye(int(off.sum())))
    assert not L[np.ix_(off, mask)].any() and not L[np.ix_(mask, off)].any()


@interpret_test
def test_chol_blocked_gram_joint_plain_matches_jax_interpret(monkeypatch):
    """The joint entry at the JAX interpret test's first case (rbf, d = 2,
    n0 = 33: value/gradient block boundaries mid-tile, pad rows): JAX
    kernel and port within 5e-4 of the factor of the jnp joint gram."""
    monkeypatch.setattr(pc, "_SB", 8)
    x, vx, vy, vg, sm, gm = _joint_inputs(np.random.default_rng(3), 33, 2)
    scale = np.float32(0.9)
    with pltpu.force_tpu_interpret_mode():
        jL = np.asarray(pc.chol_blocked_gram_joint(
            "rbf", jnp.asarray(x), jnp.asarray(vx + vy), jnp.asarray(vg),
            jnp.asarray(sm), jnp.asarray(gm), scale, tile=16))
    L = chol_blocked_gram_joint("rbf", *_t(x, vx + vy, vg, sm, gm),
                                float(scale)).numpy()
    ref = np.linalg.cholesky(
        _jax_joint_gram("rbf", x, vx, vy, vg, sm, gm, scale))
    assert np.abs(jL - ref).max() < 5e-4
    assert np.abs(L - ref).max() < 5e-4
    assert np.abs(np.triu(L, 1)).max() == 0.0


@pytest.mark.parametrize("fam,d,n0", [("rbf", 2, 33), ("matern32", 2, 33),
                                      ("matern32", 1, 45), ("rbf", 3, 23)])
def test_chol_blocked_gram_joint_plain_matches_jax_gram(fam, d, n0):
    """tests/test_ops.py's four joint cases through the port's plain entry:
    within 5e-4 of the factor of the JAX package's joint gram; masked rows
    identity."""
    x, vx, vy, vg, sm, gm = _joint_inputs(np.random.default_rng(n0 + d), n0,
                                          d)
    L = chol_blocked_gram_joint(fam, *_t(x, vx + vy, vg, sm, gm),
                                0.9).numpy()
    ref = np.linalg.cholesky(_jax_joint_gram(fam, x, vx, vy, vg, sm, gm,
                                             np.float32(0.9)))
    assert np.abs(L - ref).max() < 5e-4
    assert np.abs(np.triu(L, 1)).max() == 0.0
    off = ~np.concatenate([sm] + [gm] * d)
    assert np.array_equal(L[np.ix_(off, off)], np.eye(int(off.sum())))


# -- float64 against the JAX package's XLA route ----------------------------

@pytest.mark.parametrize("fam", ["rbf", "ou", "matern32", "mix"])
def test_chol_blocked_gram_f64_matches_jax_xla(fam):
    """float64: the port's gram-fused entry against JAX's ``train_gram`` +
    ``jnp.linalg.cholesky`` (what the JAX package runs off the TPU) to
    1e-12, with Dinv."""
    mix = register_scale_mixture(*MIX)
    jax_register_scale_mixture(*MIX)
    fam = mix if fam == "mix" else fam
    x, var, mask = _gram_inputs(np.random.default_rng(5), 150, np.float64)
    L, dinv = chol_blocked_gram(fam, *_t(x, var, mask), 1.7,
                                return_dinv=True)
    K = jax_train_gram(fam, jnp.asarray(x),
                       jnp.where(jnp.asarray(mask), jnp.asarray(var), 0.0),
                       1.7, mask=jnp.asarray(mask))
    jL = np.asarray(jnp.linalg.cholesky(K))
    assert np.abs(L.numpy() - jL).max() < 1e-12
    assert dinv.shape == (3 * 64, 64)


@pytest.mark.parametrize("fam", ["rbf", "matern32"])
def test_chol_blocked_gram_joint_f64_matches_jax_xla(fam):
    """float64: the joint entry against JAX's ``train_gram_with_gradient`` +
    ``jnp.linalg.cholesky`` to 1e-12."""
    x, vx, vy, vg, sm, gm = _joint_inputs(np.random.default_rng(6), 40, 2,
                                          np.float64)
    L = chol_blocked_gram_joint(fam, *_t(x, vx + vy, vg, sm, gm), 0.9)
    jL = np.linalg.cholesky(_jax_joint_gram(fam, x, vx, vy, vg, sm, gm, 0.9))
    assert np.abs(L.numpy() - jL).max() < 1e-12


def test_chol_blocked_f64_matches_jax_xla():
    """float64 plain-A entry at a ragged n against ``jnp.linalg.cholesky``
    to 1e-12."""
    A = _spd(np.random.default_rng(7), 203, np.float64)
    L = chol_blocked(torch.as_tensor(A)).numpy()
    assert np.abs(L - np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
                  ).max() < 1e-12


# -- semantics shared with the kernels --------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 17, 129, 300])
def test_dinv_holds_the_diagonal_tile_inverses(n, dtype):
    """Dinv is (nb T, T), block j the inverse of L's diagonal tile j (the
    last one padded with identity), T = TILE at both dtypes."""
    A = torch.as_tensor(_spd(np.random.default_rng(n), n, np.float64),
                        dtype=dtype)
    L, dinv = chol_blocked(A, return_dinv=True)
    T = TILE
    nb = -(-n // T)
    assert dinv.shape == (nb * T, T)
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    for j in range(nb):
        blk = torch.eye(T, dtype=torch.float64)
        lo, hi = j * T, min(n, (j + 1) * T)
        blk[:hi - lo, :hi - lo] = L[lo:hi, lo:hi].double()
        prod = dinv[j * T:(j + 1) * T].double() @ blk
        assert float((prod - torch.eye(T, dtype=torch.float64)).abs().max()
                     ) < tol


def test_non_spd_gives_nan_and_the_fit_escalates():
    """A non-positive pivot gives NaN (never a clamp), which reaches alpha
    through cholesky_fit(robust=False): the signal host_jitter_retry
    escalates on."""
    A = 2.0 * torch.eye(40, dtype=torch.float64)
    A[20, 20] = -1.0
    assert torch.isnan(chol_blocked(A)).all()
    L, alpha = gp_core.cholesky_fit(A, torch.ones((40, 1), dtype=A.dtype),
                                    robust=False)
    assert torch.isnan(alpha).all()
    fits = []

    def fit(j):
        fits.append(j)
        return gp_core.cholesky_fit(A + (2.0 if j else 0.0) * torch.eye(40),
                                    torch.ones((40, 1), dtype=A.dtype),
                                    robust=False)
    L, alpha = gp_core.host_jitter_retry(fit, lambda r: (r[1],))
    assert fits == [0.0, 1e-10] and torch.isfinite(alpha).all()


def test_cpu_tensors_launch_nothing_and_other_devices_raise():
    """CPU tensors take the plain versions (no launch counted); a tensor on
    any other device (``meta`` here) goes to the kernel's checks and
    raises, never to the plain version."""
    before = launch_counts()
    A = torch.as_tensor(_spd(np.random.default_rng(9), 20))
    chol_blocked(A)
    chol_blocked_gram("rbf", A[:, :2].contiguous(), torch.ones(20),
                      torch.ones(20, dtype=torch.bool), 1.0)
    assert launch_counts() == before
    meta = torch.empty((20, 20), device="meta")
    with pytest.raises(ValueError):
        chol_blocked(meta)
    x = torch.empty((20, 2), device="meta")
    v = torch.empty((20,), device="meta")
    m = torch.ones(20, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        chol_blocked_gram("rbf", x, v, m, 1.0)
    with pytest.raises(ValueError):
        chol_blocked_gram_joint("rbf", x, v, v, m, m, 1.0)
    with pytest.raises(ValueError, match="family"):
        chol_blocked_gram_joint("ou", x, v, v, m, m, 1.0)


@pytest.mark.parametrize("n", [1, 64, 129, 1300, 7500, 7680, 8192])
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_chol_plan_fits_the_kernels(n, sms):
    """The split plan the kernels are given (``ops.chol.chol_plan``): every
    column has the tile of A as buffer 0; the first two have no panel for
    the update (column j's covers panels 0 .. j - 2, the look-ahead leaving
    panel j - 1 to the diag and apply); every later column's panels are
    covered exactly by at most MAX_SPLITS - 1 splits of at least one panel,
    at most UPDATE_SM_SHARE of the SMs in product blocks as the float32
    update's grid counts them (UPDATE_ROWS = two row tiles a block) where a
    column has fewer blocks than that, and every column's buffers fit one
    parity's half of the workspace."""
    from erl_gaussian_process_tpu_torch.ops.chol import (
        MAX_SPLITS,
        UPDATE_ROWS,
        UPDATE_SM_SHARE,
        chol_plan,
        update_block_cap,
        update_blocks,
    )

    pps, half = chol_plan(n, sms)
    nb = -(-n // TILE)
    assert len(pps) == nb and pps[:2] == (1, 1)[:nb]
    buffers = [1, 1][:nb]
    for j in range(2, nb):
        npan, nt = j - 1, nb - j
        ns = -(-npan // pps[j])
        assert 1 <= pps[j] <= npan and 1 <= ns <= MAX_SPLITS - 1
        assert (ns - 1) * pps[j] < npan <= ns * pps[j]
        blocks = update_blocks(nt, ns)
        assert blocks == -(-nt // (UPDATE_ROWS // TILE)) * ns
        if ns > 1:
            assert blocks <= update_block_cap(sms) <= UPDATE_SM_SHARE * sms
        buffers.append(1 + ns)
    assert half == max(nbuf * (nb - j) * TILE * TILE
                       for j, nbuf in enumerate(buffers))


def test_chol_plan_splits_long_columns_on_a_wide_card():
    """At the exact-GP size on the H100's 132 SMs the late columns (few
    tiles, a long prefix) take the most splits and the early ones one; the
    workspace stays within what the plan's blocks allow (each a block of
    UPDATE_ROWS rows, so up to that many tiles' buffers a block); a quarter
    of the SMs stay free of the update's blocks."""
    from erl_gaussian_process_tpu_torch.ops.chol import (
        MAX_SPLITS,
        UPDATE_ROWS,
        chol_plan,
        update_block_cap,
    )

    pps, half = chol_plan(8192, 132)
    assert update_block_cap(132) == 99
    assert pps[2] == 1 and MAX_SPLITS // 2 <= -(-126 // pps[127]) < MAX_SPLITS
    assert 128 * TILE * TILE <= half <= (
        128 + UPDATE_ROWS // TILE * update_block_cap(132)) * TILE * TILE
