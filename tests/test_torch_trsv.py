"""The port's triangular solves (``erl_gaussian_process_tpu_torch/ops/trsv.py``)
against the JAX package's (``ops/pallas_trsv.py``): the plain versions
beside the JAX Pallas kernel in interpret mode (its bf16x3 dots keep it to
the 5e-5 relative class of ``tests/test_ops.py``), the diagonal-block
inverses sliced from the blocked Cholesky's Dinv at the port's layout and
at the JAX package's, and the Dinv-based whitening of ``gp_core.whiten``.
The CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch
from jax.experimental.pallas import tpu as pltpu

from erl_gaussian_process_tpu.ops import pallas_trsv as jtrsv
from erl_gaussian_process_tpu_torch.models import gp_core
from erl_gaussian_process_tpu_torch.ops import (
    TILE,
    cho_solve_vec,
    chol_blocked,
    inverses_from_chol_dinv,
    solve_lower,
    solve_lower_t,
)
from erl_gaussian_process_tpu_torch.ops.trsv import _diag_block_inverses
from tests.conftest import interpret_test


def _factor(rng, n, dtype=np.float32):
    X = rng.standard_normal((n, n)).astype(dtype) / np.sqrt(n)
    A = (X @ X.T + np.eye(n, dtype=dtype)).astype(dtype)
    return A, np.linalg.cholesky(A).astype(dtype)


@interpret_test
def test_solves_match_jax_kernel_interpret():
    """n = 256, q = 2: the JAX kernel (interpret mode) and the port's plain
    solves both within 5e-5 relative of scipy's float64 solves."""
    rng = np.random.default_rng(0)
    _, L = _factor(rng, 256)
    b = rng.standard_normal((256, 2)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jx = np.asarray(jtrsv.solve_lower(jnp.asarray(L), jnp.asarray(b)))
        jxt = np.asarray(jtrsv.solve_lower_t(jnp.asarray(L), jnp.asarray(b)))
        jcs = np.asarray(jtrsv.cho_solve_vec(jnp.asarray(L), jnp.asarray(b)))
    L64 = L.astype(np.float64)
    refs = (sla.solve_triangular(L64, b, lower=True),
            sla.solve_triangular(L64.T, b, lower=False),
            sla.cho_solve((L64, True), b))
    Lt, bt = torch.as_tensor(L), torch.as_tensor(b)
    ours = (solve_lower(Lt, bt), solve_lower_t(Lt, bt),
            cho_solve_vec(Lt, bt))
    for j, o, r in zip((jx, jxt, jcs), ours, refs):
        scale = np.abs(r).max()
        assert np.abs(j - r).max() / scale < 5e-5
        assert np.abs(o.numpy() - r).max() / scale < 5e-5


@pytest.mark.parametrize("n,q", [(1, 1), (200, 3), (257, 129)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cho_solve_vec_with_and_without_dinv(n, q, dtype):
    """K^{-1} b through the blocked Cholesky's Dinv and without it, at
    ragged n and q > 128, against scipy (float64 to 1e-12 relative, float32
    to the 5e-5 class)."""
    rng = np.random.default_rng(n + q)
    A, _ = _factor(rng, n, dtype)
    b = rng.standard_normal((n, q)).astype(dtype)
    L, dinv = chol_blocked(torch.as_tensor(A), return_dinv=True)
    ref = sla.cho_solve((np.linalg.cholesky(A.astype(np.float64)), True), b)
    tol = 5e-5 if dtype == np.float32 else 1e-12
    for got in (cho_solve_vec(L, torch.as_tensor(b), chol_dinv=dinv),
                cho_solve_vec(L, torch.as_tensor(b))):
        assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < tol


def test_inverses_from_chol_dinv_matches_jax_layout():
    """The JAX package's layout (T = 512 tiles, b = 128 blocks, n = 640: a
    partly padded last tile): the port's slicing equals JAX's and the
    batched block inversion."""
    rng = np.random.default_rng(7)
    n, npad = 640, 1024
    _, L = _factor(rng, n)
    Lp = np.eye(npad, dtype=np.float32)
    Lp[:n, :n] = L
    dinv = np.concatenate([
        sla.solve_triangular(Lp[j * 512:(j + 1) * 512,
                                j * 512:(j + 1) * 512],
                             np.eye(512, dtype=np.float32), lower=True)
        for j in range(npad // 512)]).astype(np.float32)
    ours = inverses_from_chol_dinv(torch.as_tensor(dinv), n, tile=512, b=128)
    theirs = np.asarray(jtrsv.inverses_from_chol_dinv(jnp.asarray(dinv), n))
    assert ours.shape == theirs.shape == (n, 128)
    assert np.array_equal(ours.numpy(), theirs)
    ref = _diag_block_inverses(torch.as_tensor(L), 128)
    assert float((ours - ref).abs().max()) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inverses_from_chol_dinv_at_the_ports_layout(dtype):
    """The port's own layout (T = b = TILE = 64 at both dtypes) at a ragged
    n, and a finer b inside the same tiles: the slices equal the inverses of
    L's diagonal blocks (the last identity-padded)."""
    n = 300
    A, _ = _factor(np.random.default_rng(3), n, np.float64)
    L, dinv = chol_blocked(torch.as_tensor(A, dtype=dtype), return_dinv=True)
    B = TILE
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for b in (B, B // 2):
        got = inverses_from_chol_dinv(dinv, n, b=b)
        assert got.shape == (-(-n // b) * b, b)
        assert float((got - _diag_block_inverses(L, b)).abs().max()) < tol


@pytest.mark.parametrize("n", [100, 300])
def test_whiten_with_dinv_matches_the_triangular_solve(n):
    """gp_core.whiten's block substitution with the Cholesky's Dinv (float32)
    equals the triangular solve to float32 rounding; float64 keeps the
    solve exactly."""
    rng = np.random.default_rng(n)
    A, _ = _factor(rng, n)
    kt = torch.as_tensor(rng.standard_normal((n, 37)).astype(np.float32))
    L, dinv = chol_blocked(torch.as_tensor(A), return_dinv=True)
    ref = torch.linalg.solve_triangular(L.double(), kt.double(), upper=False)
    got = gp_core.whiten(L, kt, dinv)
    assert float((got.double() - ref).abs().max() / ref.abs().max()) < 5e-6
    L64, d64 = chol_blocked(torch.as_tensor(A, dtype=torch.float64),
                            return_dinv=True)
    assert torch.equal(gp_core.whiten(L64, kt.double(), d64),
                       torch.linalg.solve_triangular(L64, kt.double(),
                                                     upper=False))


@pytest.mark.parametrize("n,coresident,grid,want", [
    (8192, 264, None, 128), (8192, 100, None, 100), (1, 264, None, 1),
    (1300, 264, 3, 3), (1300, 264, 7, 7), (100, 264, 7, 2),
    (1300, 264, 264, 21)])
def test_trsv_grid(n, coresident, grid, want):
    """The persistent solve's thread blocks: one per 64-row block up to the
    co-resident count, or the grid asked for, never more than the row
    blocks."""
    from erl_gaussian_process_tpu_torch.ops.trsv import trsv_grid

    assert trsv_grid(n, coresident, grid) == want


@pytest.mark.parametrize("grid", [0, -1, 265])
def test_trsv_grid_refuses_what_cannot_be_resident(grid):
    """A grid of no blocks or of more than the card keeps resident raises
    (the kernel would never finish), before any launch."""
    from erl_gaussian_process_tpu_torch.ops.trsv import trsv_grid

    with pytest.raises(ValueError, match="resident"):
        trsv_grid(8192, 264, grid)


@pytest.mark.parametrize("n,q,dtype,want", [
    (8192, 1, torch.float32, 8192), (1300, 33, torch.float32, 42900),
    (1, 129, torch.float64, 258), (64, 32, torch.float64, 4096)])
def test_trsv_word_count(n, q, dtype, want):
    """x is published through one 64-bit word per 32-bit part of each
    value: one per float32 value, two per float64 value."""
    from erl_gaussian_process_tpu_torch.ops.trsv import trsv_word_count

    assert trsv_word_count(n, q, dtype) == want
