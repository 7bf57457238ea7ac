"""The PyTorch port's GP bank (erl_gaussian_process_tpu_torch/ops/bank.py,
models/batch_gp.py, models/mapping.py, the bank pieces of models/gp_core.py)
against the JAX package on the same inputs, made from a numpy seed: float64
to 1e-12 of each result's magnitude, float32 to 1e-4 (the JAX package's own
bank parity tolerances), and the plain bank fit against the JAX Pallas
kernel run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.models.batch_gp as jbg
from erl_gaussian_process_tpu.kernels import cross_gram as jax_cross_gram
from erl_gaussian_process_tpu.models import gp_core as jgp
from erl_gaussian_process_tpu.models.mapping import (
    Mapping as JaxMapping,
    MappingSetting as JaxMappingSetting,
    MappingType as JaxMappingType,
)
from erl_gaussian_process_tpu_torch.models import gp_core
from erl_gaussian_process_tpu_torch.models.batch_gp import (
    BatchGPBank,
    bank_fit,
    bank_fit_rr,
    bank_predict,
    bank_predict_assigned,
    bank_state_from_numpy,
)
from erl_gaussian_process_tpu_torch.models.mapping import (
    Mapping,
    MappingSetting,
    MappingType,
)
from erl_gaussian_process_tpu_torch.ops import (
    bank_cholesky_solve_cuda,
    bank_cholesky_solve_plain,
    bank_fit_cuda,
    bank_fit_plain,
    cross_gram_batched_cuda,
    solve_alpha,
)

TOL = {np.float64: 1e-12, np.float32: 1e-4}
FAMILIES = ["rbf", "ou", "matern32"]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, ref, tol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _bank_inputs(dtype, B=37, n=100, d=2, q=2, seed=0):
    """The JAX package's bank parity shape: off any grid, masked rows."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, n, d)).astype(dtype),
            rng.normal(size=(B, n, q)).astype(dtype),
            (0.01 + 0.1 * rng.random((B, n))).astype(dtype),
            rng.random((B, n)) < 0.9)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# -- mapping ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mtype,scale,domain", [
    ("IDENTITY", 1.0, (0.1, 10.0)),
    ("INVERSE", 1.0, (0.1, 10.0)),
    ("INVERSE_SQRT", 1.0, (0.1, 10.0)),
    ("EXP", 0.7, (0.1, 10.0)),
    ("LOG", 0.7, (0.1, 10.0)),
    ("TANH", 0.3, (0.1, 3.0)),
    ("SIGMOID", 0.5, (0.1, 10.0)),
])
def test_mapping_matches_jax(mtype, scale, domain, dtype):
    """map and inv on tensors and on numpy arrays, both dtypes, against the
    JAX mapping to 256 ulps (the packages' elementwise math libraries
    differ: torch's float64 atanh is ~50 ulps from XLA's); inv_masked
    sends invalid lanes to +inf."""
    x = np.linspace(*domain, 57).astype(dtype)
    m = Mapping(MappingSetting(type=MappingType[mtype], scale=scale))
    jm = JaxMapping(JaxMappingSetting(type=JaxMappingType[mtype],
                                      scale=scale))
    rtol = 256 * np.finfo(dtype).eps
    mapped = m.map(torch.as_tensor(x))
    assert mapped.dtype == torch.as_tensor(x).dtype
    np.testing.assert_allclose(mapped.numpy(), np.asarray(jm.map(x)),
                               rtol=rtol)
    y = np.asarray(jm.map(x))
    np.testing.assert_allclose(m.inv(y), np.asarray(jm.inv(y)), rtol=rtol)
    assert isinstance(m.map(x), np.ndarray)
    valid = np.arange(x.size) % 3 != 0
    out = m.inv_masked(y, valid)
    np.testing.assert_allclose(out[valid], np.asarray(jm.inv(y))[valid],
                               rtol=rtol)
    assert np.isinf(out[~valid]).all()
    assert MappingSetting.from_dict(m.setting.to_dict()) == m.setting
    assert m.setting.to_dict() == jm.setting.to_dict()


# -- gp_core ---------------------------------------------------------------

def test_cholesky_fit_and_whiten_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(30, 30))
    K = a @ a.T + 30 * np.eye(30)
    y = rng.normal(size=(30, 2))
    kt = rng.normal(size=(30, 7))
    L, alpha = gp_core.cholesky_fit(*_t(K, y))
    jL, ja = jgp.cholesky_fit(jnp.asarray(K), jnp.asarray(y))
    _close(L, jL, 1e-12)
    _close(alpha, ja, 1e-12)
    _close(gp_core.whiten(L, torch.as_tensor(kt)),
           jgp.whiten(jL, jnp.asarray(kt)), 1e-12)
    # the single-system route: the blocked Cholesky and substitution (their
    # plain versions on the CPU) against the JAX package's robust=False
    L, alpha = gp_core.cholesky_fit(*_t(K, y), robust=False)
    jL, ja = jgp.cholesky_fit(jnp.asarray(K), jnp.asarray(y), robust=False)
    _close(L, jL, 1e-12)
    _close(alpha, ja, 1e-12)


# -- bank fit --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fam", FAMILIES)
def test_bank_fit_plain_matches_jax(fam, dtype):
    """The plain bank fit against the JAX package's XLA bank fit: L, alpha,
    and L_inv really the inverse of L (identity on masked rows)."""
    x, y, var, mask = _bank_inputs(dtype)
    L, L_inv, alpha = bank_fit_plain(fam, *_t(x, y, var, mask), 0.7)
    st = jbg._bank_fit_xla(*map(jnp.asarray, (x, y, var, mask)),
                           dtype(0.7), kernel=fam)
    tol = TOL[dtype]
    _close(L, st.L, tol)
    _close(alpha, st.alpha, tol)
    eye_err = np.abs(_np(L_inv) @ np.asarray(st.L) - np.eye(100)).max()
    assert eye_err < tol
    # the CPU wrapper is the plain version
    for a, b in zip(bank_fit_cuda(fam, *_t(x, y, var, mask), 0.7),
                    (L, L_inv, alpha)):
        assert torch.equal(a, b)


def test_bank_fit_plain_marks_a_failed_member_nan():
    x, y, var, mask = _bank_inputs(np.float64, B=5, n=20)
    var[2, np.flatnonzero(mask[2])[0]] = -50.0
    L, L_inv, alpha = bank_fit_plain("ou", *_t(x, y, var, mask), 0.7)
    for t in (L, L_inv, alpha):
        assert torch.isnan(t[2]).all()
        assert torch.isfinite(t[[0, 1, 3, 4]]).all()


@pytest.mark.parametrize("fam", FAMILIES)
def test_bank_fit_plain_matches_the_pallas_kernel_in_interpret_mode(fam):
    """The TPU kernel itself (interpret mode, B = 2, n0 = 12, float32)
    against the plain version that the CUDA kernel is held to."""
    from jax.experimental.pallas import tpu as pltpu

    from erl_gaussian_process_tpu.ops.pallas_bank import bank_fit_fused

    x, y, var, mask = _bank_inputs(np.float32, B=2, n=12, q=1, seed=3)
    with pltpu.force_tpu_interpret_mode():
        jL, jLi, ja = bank_fit_fused(
            fam, *map(jnp.asarray, (x, y, var, mask)), np.float32(0.7))
    L, L_inv, alpha = bank_fit_plain(fam, *_t(x, y, var, mask), 0.7)
    tri = np.tril(np.ones((12, 12), bool))
    # the TPU kernel leaves rounding residue above L's diagonal
    _close(np.where(tri, _np(L), 0), np.where(tri, np.asarray(jL), 0), 1e-4)
    _close(L_inv, jLi, 1e-4)
    _close(alpha, ja, 1e-4)


def test_bank_cholesky_solve_matches_jax_and_the_pallas_kernel():
    from jax.experimental.pallas import tpu as pltpu

    from erl_gaussian_process_tpu.ops.pallas_bank import (
        bank_cholesky_solve_fused,
    )

    rng = np.random.default_rng(1)
    X = rng.normal(size=(21, 12, 8))
    K = np.einsum("bnd,bmd->bnm", X, X) / 8 + 2 * np.eye(12)
    y = rng.normal(size=(21, 12, 1))
    L, L_inv, alpha = bank_cholesky_solve_plain(*_t(K, y))
    jL, ja = jbg._batched_cholesky_solve(jnp.asarray(K), jnp.asarray(y))
    _close(L, jL, 1e-12)
    _close(alpha, ja, 1e-12)
    for a, b in zip(bank_cholesky_solve_cuda(*_t(K, y)), (L, L_inv, alpha)):
        assert torch.equal(a, b)
    K32, y32 = K[:2].astype(np.float32), y[:2].astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        pL, pLi, pa = bank_cholesky_solve_fused(jnp.asarray(K32),
                                                jnp.asarray(y32))
    L, L_inv, alpha = bank_cholesky_solve_plain(*_t(K32, y32))
    tri = np.tril(np.ones((12, 12), bool))
    _close(np.where(tri, _np(L), 0), np.where(tri, np.asarray(pL), 0), 1e-4)
    _close(L_inv, pLi, 1e-4)
    _close(alpha, pa, 1e-3)


def test_alpha_chunks_do_not_change_the_result():
    """alpha solved slice by slice, as the sensor GPs' replay solves it
    scan by scan, agrees with the whole bank's."""
    x, y, var, mask = _t(*_bank_inputs(np.float64, B=9, n=16))
    _, L_inv, alpha = bank_fit_plain("rbf", x, y, var, mask, 0.7)
    y = torch.where(mask[..., None], y, 0.0)
    _close(torch.cat([solve_alpha(L_inv[i:i + 4], y[i:i + 4])
                      for i in range(0, 9, 4)]), alpha, 1e-14)


@pytest.mark.parametrize("wrapper", ["bank_fit", "bank_chol", "gram"])
def test_wrappers_take_the_plain_version_only_for_cpu_tensors(wrapper):
    """Tensors on another device than the CPU go to the kernel, which
    checks its operands and raises here (they are not on a CUDA device)."""
    x, y, var, mask = (torch.as_tensor(a, device="meta")
                       for a in _bank_inputs(np.float32, B=2, n=8))
    with pytest.raises(ValueError, match="CUDA device"):
        if wrapper == "bank_fit":
            bank_fit_cuda("rbf", x, y, var, mask, 0.7)
        elif wrapper == "bank_chol":
            bank_cholesky_solve_cuda(torch.empty((2, 8, 8), device="meta"),
                                     y)
        else:
            cross_gram_batched_cuda("rbf", x, x, 0.7)


def test_batched_gram_plain_matches_jax_vmap():
    rng = np.random.default_rng(5)
    x1, x2 = rng.uniform(-1, 1, (6, 20, 2)), rng.uniform(-1, 1, (6, 9, 2))
    import jax
    ref = jax.vmap(lambda a, b: jax_cross_gram("matern32", a, b, 0.4))(
        jnp.asarray(x1), jnp.asarray(x2))
    _close(cross_gram_batched_cuda("matern32", *_t(x1, x2), 0.4), ref, 1e-12)


# -- BatchGPBank ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_gp_bank_matches_jax(dtype):
    """Load padded (K, y) problems, one batched solve, read back (L,
    alpha); members smaller than n are identity-padded exactly."""
    rng = np.random.default_rng(2)
    bank = BatchGPBank(batch_size=3, max_num_samples=24, y_dim=1,
                       dtype=dtype, device="cpu")
    jbank = jbg.BatchGPBank(batch_size=3, max_num_samples=24, y_dim=1,
                            dtype=dtype)
    sizes = [24, 10, 17]
    for i, n in enumerate(sizes):
        x = np.sort(rng.uniform(0, 1, n))
        K = np.exp(-(x[:, None] - x[None, :]) ** 2 / (2 * 0.2 ** 2))
        K += np.diag(np.full(n, 1e-2))
        y = np.sin(5 * x)[:, None]
        bank.load_gp_data(i, n, K, y)
        jbank.load_gp_data(i, n, K, y)
    bank.solve()
    jbank.solve()
    for i, n in enumerate(sizes):
        L, a = bank.get_gp_result(i)
        jL, ja = jbank.get_gp_result(i)
        assert L.dtype == dtype and a.shape == (24, 1)
        _close(L, jL, TOL[dtype])
        _close(a, ja, TOL[dtype] * (1e2 if dtype == np.float32 else 1))
        np.testing.assert_array_equal(L[n:, n:], np.eye(24 - n))
        np.testing.assert_array_equal(a[n:], 0.0)


# -- predict -------------------------------------------------------------

def _routed_bank(seed=7, B=6, nmax=24):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (B, nmax, 2))
    ys = np.sin(xs[:, :, :1] * 3) + np.arange(B)[:, None, None]
    vs = np.full((B, nmax), 1e-3)
    ms = np.ones((B, nmax), bool)
    ms[4, 11:] = False
    ms[2] = False                                      # untrained member
    return xs, ys, vs, ms


def test_bank_predict_matches_jax():
    xs, ys, vs, ms = _routed_bank()
    rng = np.random.default_rng(8)
    xq = rng.uniform(-1, 1, (6, 13, 2))
    state = bank_fit(*_t(xs, ys, vs, ms), 0.4, kernel="matern32")
    jstate = jbg.bank_fit(*map(jnp.asarray, (xs, ys, vs, ms)), 0.4,
                          kernel="matern32")
    mean, var = bank_predict(state, torch.as_tensor(xq), 0.4,
                             kernel="matern32")
    jm, jv = jbg.bank_predict(jstate, jnp.asarray(xq), 0.4,
                              kernel="matern32")
    _close(mean, jm, 1e-12)
    _close(var, jv, 1e-12)
    # a state without L_inv (a loaded checkpoint) whitens by a solve
    loaded = state._replace(L_inv=None)
    m2, v2 = bank_predict(loaded, torch.as_tensor(xq), 0.4, kernel="matern32")
    _close(m2, jm, 1e-12)
    _close(v2, jv, 1e-12)
    # reduced_rank: the same gram, the +||.||^2 variance
    mr, vr = bank_predict(state, torch.as_tensor(xq), 0.4, kernel="matern32",
                          reduced_rank=True)
    jmr, jvr = jbg.bank_predict(jstate, jnp.asarray(xq), 0.4,
                                kernel="matern32", reduced_rank=True)
    _close(mr, jmr, 1e-12)
    _close(vr, jvr, 1e-12)


@pytest.mark.parametrize("from_jax_state", [False, True])
def test_bank_predict_assigned_matches_jax(from_jax_state):
    """Routed predict with -1 indices and an untrained member, from the
    port's own fit and from the JAX state carried over."""
    xs, ys, vs, ms = _routed_bank()
    rng = np.random.default_rng(9)
    q = rng.uniform(-1, 1, (237, 2))
    idx = rng.integers(-1, 6, 237).astype(np.int32)
    jstate = jbg.bank_fit(*map(jnp.asarray, (xs, ys, vs, ms)), 0.4,
                          kernel="matern32")
    state = bank_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()
         if v is not None}, device="cpu") if from_jax_state else \
        bank_fit(*_t(xs, ys, vs, ms), 0.4, kernel="matern32")
    prof = {}
    mean, var, valid = bank_predict_assigned(state, q, idx, 0.4,
                                             kernel="matern32", profile=prof)
    jm, jv, jvalid = jbg.bank_predict_assigned(jstate, q, idx, 0.4,
                                               kernel="matern32")
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    assert list(valid) == list((idx >= 0) & (idx != 2))
    _close(mean, jm, 1e-12)
    _close(var, jv, 1e-12)
    assert mean.dtype == np.float64 and var.shape == (237,)
    for k in ("host_group", "h2d", "device", "d2h_scatter"):
        assert prof[k] >= 0.0
    assert prof["bucket"][0] % 8 == 0
    none_m, none_v, none_ok = bank_predict_assigned(
        state, q[:3], np.array([-1, 2, -1]), 0.4, kernel="matern32")
    assert not none_ok.any() and (none_v == 1.0).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reduced_rank_banks_match_jax(dtype):
    """bank_fit_rr over a shared 2D basis and the routed reduced-rank
    predict (-1 indices, an untrained member) against JAX: the (m, m)
    factors, alpha, means and +||.||^2 variances."""
    from erl_gaussian_process_tpu.kernels import (
        ReducedRankBasis as JaxBasis,
        ReducedRankSetting as JaxRRSetting,
    )
    from erl_gaussian_process_tpu_torch.kernels import (
        ReducedRankBasis,
        ReducedRankSetting,
    )

    xs, ys, vs, ms = (a.astype(dtype) if a.dtype != bool else a
                      for a in _routed_bank())
    kw = dict(x_dim=2, scale=0.4, num_basis=[7, 6], boundary=[1.6, 1.7],
              coord_origin=[0.1, 0.0])
    basis = ReducedRankBasis(ReducedRankSetting(**kw), dtype=dtype)
    jbasis = JaxBasis(JaxRRSetting(**kw), dtype=dtype)
    state = bank_fit_rr(*_t(xs, ys, vs, ms), basis)
    jstate = jbg.bank_fit_rr(*map(jnp.asarray, (xs, ys, vs, ms)), jbasis)
    assert tuple(state.L.shape) == (6, 42, 42) and state.L_inv is None
    np.testing.assert_array_equal(_np(state.trained),
                                  np.asarray(jstate.trained))
    _close(state.L, jstate.L, TOL[dtype])
    _close(state.alpha, jstate.alpha, TOL[dtype])
    rng = np.random.default_rng(10)
    q = rng.uniform(-1, 1, (150, 2)).astype(dtype)
    idx = rng.integers(-1, 6, 150).astype(np.int32)
    mean, var, valid = bank_predict_assigned(state, q, idx, 0.4,
                                             kernel="rbf", reduced_rank=True,
                                             basis=basis)
    jm, jv, jvalid = jbg.bank_predict_assigned(
        jstate, q, idx, 0.4, kernel="rbf", reduced_rank=True, basis=jbasis)
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    assert valid.any() and (var[valid] > 0).all()
    _close(mean, jm, TOL[dtype])
    _close(var, jv, TOL[dtype])


# -- the bank Cholesky's plan (csrc/bank.cu's two paths) ---------------------

H100_SMEM_OPTIN = 232448  # bytes of shared memory a block may opt into
BIG_BANK = 10 ** 6  # a bank with more than 8 members an SM


@pytest.mark.parametrize("n", [1, 12, 16, 17, 24, 100, 104, 112, 300, 320])
def test_bank_chol_plan_takes_the_blocked_path_where_members_fit(n):
    """float32 members up to n = 320 take the blocked kernel on an H100,
    in a large bank as many a block as fit (at most 8), each a slab of its
    lower 16 x 16 tiles, one warp each; n = 104 fits 8 members a block, so
    B = 1000 is one wave of 125 blocks."""
    from erl_gaussian_process_tpu_torch.ops.bank import (
        MAX_MEMBERS_PER_BLOCK,
        PANEL,
        bank_chol_plan,
        member_tiles,
    )

    plan = bank_chol_plan(n, torch.float32, H100_SMEM_OPTIN, BIG_BANK, 132)
    p = -(-n // PANEL)
    member = member_tiles(n) * PANEL * PANEL * 4
    assert member_tiles(n) == p * (p + 1) // 2 + (p == 1)
    assert plan.path == "blocked"
    assert 1 <= plan.members_per_block <= MAX_MEMBERS_PER_BLOCK
    assert plan.members_per_block * member <= H100_SMEM_OPTIN
    more = plan.members_per_block + 1
    assert more > MAX_MEMBERS_PER_BLOCK or more * member > H100_SMEM_OPTIN
    if n == 104:
        assert plan.members_per_block == 8 and -(-1000 // 8) <= 132


@pytest.mark.parametrize("n,dtype", [(104, torch.float64), (12, torch.float64),
                                     (336, torch.float32),
                                     (512, torch.float32)])
def test_bank_chol_plan_keeps_the_elimination_elsewhere(n, dtype):
    """float64, and float32 members whose tiles do not fit a block, take the
    augmented elimination (members_per_block 0 in the C entry)."""
    from erl_gaussian_process_tpu_torch.ops.bank import bank_chol_plan

    plan = bank_chol_plan(n, dtype, H100_SMEM_OPTIN, BIG_BANK, 132)
    assert (plan.path, plan.members_per_block) == ("eliminate", 0)


@pytest.mark.parametrize("n,batch,sms,expect", [
    (100, 736, 132, 6),      # the lidar protocol: 123 blocks, not 92
    (144, 408, 132, 4),      # the default-grouped scan: 102 blocks, not 82
    (100, 47104, 132, 8),    # a 64-scan replay: as many as fit
    (104, 1000, 132, 8),     # BatchGPBank's (1000, 104): one wave
    (100, 1, 132, 1),
    (100, 736, 16, 8),       # few SMs: as many as fit
    (320, 736, 132, 1),      # one member fills a block
])
def test_bank_plan_spreads_the_bank_over_the_sms(n, batch, sms, expect):
    """The plan as a pure function of (n, dtype, shared memory, B, SMs):
    members a block = min(8, as many as fit, ceil(B / SMs)), so a bank of
    fewer than 8 members an SM still reaches every SM; a member's results
    do not depend on the count (one warp a member, no block barrier)."""
    from erl_gaussian_process_tpu_torch.ops.bank import (
        MAX_MEMBERS_PER_BLOCK,
        bank_chol_plan,
        member_tiles,
    )

    plan = bank_chol_plan(n, torch.float32, H100_SMEM_OPTIN, batch, sms)
    assert (plan.path, plan.members_per_block) == ("blocked", expect)
    fit = H100_SMEM_OPTIN // (member_tiles(n) * 1024)
    assert expect == min(MAX_MEMBERS_PER_BLOCK, fit, -(-batch // sms))
    if expect < min(MAX_MEMBERS_PER_BLOCK, fit):
        # fewer members a block than fit: one wave of blocks, and one member
        # fewer a block would need more blocks than SMs
        assert -(-batch // expect) <= sms
        assert expect == 1 or -(-batch // (expect - 1)) > sms
    assert bank_chol_plan(n, torch.float64, H100_SMEM_OPTIN, batch,
                          sms).path == "eliminate"


def test_bank_chol_plan_follows_the_cards_shared_memory():
    """A card with less shared memory packs fewer members a block, and
    moves the largest sizes to the elimination."""
    from erl_gaussian_process_tpu_torch.ops.bank import bank_chol_plan

    small = 101376
    assert bank_chol_plan(104, torch.float32, small, BIG_BANK,
                          132).members_per_block == 3
    assert bank_chol_plan(240, torch.float32, small, BIG_BANK,
                          132).path == "eliminate"


@pytest.mark.parametrize("n", [5, 17, 100, 104])
def test_identity_padding_leaves_the_leading_factor_exact(n):
    """The blocked kernel factors the member padded to a multiple of 16 with
    identity rows: the padded factor is [[L, 0], [0, I]] and its inverse
    [[L^-1, 0], [0, I]] (float64, against the unpadded factor)."""
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 8))
    K = torch.as_tensor(X @ X.T / 8 + 2 * np.eye(n))
    p = -(-n // 16) * 16
    Kp = torch.eye(p, dtype=K.dtype)
    Kp[:n, :n] = K
    L, L_inv, _ = bank_cholesky_solve_plain(K[None], torch.ones(1, n, 1,
                                                                 dtype=K.dtype))
    Lp, Lp_inv, _ = bank_cholesky_solve_plain(
        Kp[None], torch.ones(1, p, 1, dtype=K.dtype))
    _close(Lp[0, :n, :n], L[0], 1e-14)
    _close(Lp_inv[0, :n, :n], L_inv[0], 1e-14)
    eye = torch.eye(p - n, dtype=K.dtype)
    assert torch.equal(Lp[0, n:, n:], eye) and torch.equal(Lp_inv[0, n:, n:],
                                                            eye)
    assert not Lp[0, n:, :n].any() and not Lp_inv[0, n:, :n].any()
