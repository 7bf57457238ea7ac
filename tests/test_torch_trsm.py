"""The whitening of many right-hand sides (``ops/trsm.py``) on the CPU: the
wrapper's checks, ``gp_core.whiten``'s routing (3D, float64 and factors
without tile inverses keep the triangular solve; the CPU takes the plain
64-row loop, bit for bit the loop ``whiten`` ran before the kernel), and
the kernel's counters, which a CPU call leaves alone. The CUDA kernel is
held against the float64 solve on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from erl_gaussian_process_tpu_torch.models import gp_core
from erl_gaussian_process_tpu_torch.ops import (
    TILE,
    chol_blocked,
    solve_lower_many,
    solve_lower_many_plain,
)
from erl_gaussian_process_tpu_torch.utils import timing


def _factor(n, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n)) / np.sqrt(n)
    A = torch.as_tensor(X @ X.T + np.eye(n), dtype=dtype)
    return chol_blocked(A, return_dinv=True)


def _rhs(n, m, seed=1, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((n, m)), dtype=dtype)


def _loop(L, ktest, dinv):
    """The 64-row block substitution as ``gp_core.whiten`` wrote it before
    the kernel."""
    n = L.shape[0]
    tile = dinv.shape[1]
    out = torch.empty_like(ktest)
    for lo in range(0, n, tile):
        hi = min(n, lo + tile)
        rhs = ktest[lo:hi]
        if lo:
            rhs = torch.addmm(rhs, L[lo:hi, :lo], out[:lo], alpha=-1.0)
        torch.matmul(dinv[lo:hi, :hi - lo], rhs, out=out[lo:hi])
    return out


@pytest.mark.parametrize("n", [64, 520, 1024])
@pytest.mark.parametrize("m", [1, 300])
def test_whiten_on_the_cpu_is_the_loop(n, m):
    """A float32 factor with its tile inverses whitens on the CPU through
    the plain version: bit for bit the loop, and within float32 rounding
    of the float64 solve."""
    L, dinv = _factor(n, seed=n)
    kt = _rhs(n, m, seed=m)
    got = gp_core.whiten(L, kt, dinv)
    assert torch.equal(got, _loop(L, kt, dinv))
    assert torch.equal(got, solve_lower_many_plain(L, dinv, kt))
    ref = torch.linalg.solve_triangular(L.double(), kt.double(), upper=False)
    assert float((got.double() - ref).abs().max() / ref.abs().max()) < 5e-6


def _solve(L, kt):
    return torch.linalg.solve_triangular(L, kt, upper=False)


@pytest.mark.parametrize("case", ["float64", "no_dinv", "batched"])
def test_whiten_keeps_the_triangular_solve(case):
    """Float64, a factor given without tile inverses and a batch of factors
    take ``torch.linalg.solve_triangular`` as before, never the wrapper."""
    L, dinv = _factor(130, seed=3)
    kt = _rhs(130, 9)
    if case == "float64":
        L, dinv = _factor(130, seed=3, dtype=torch.float64)
        kt = kt.double()
        assert torch.equal(gp_core.whiten(L, kt, dinv), _solve(L, kt))
    elif case == "no_dinv":
        assert torch.equal(gp_core.whiten(L, kt), _solve(L, kt))
    else:
        Lb, ktb = torch.stack([L, L]), torch.stack([kt, 2 * kt])
        assert torch.equal(gp_core.whiten(Lb, ktb, dinv), _solve(Lb, ktb))


def test_the_cpu_counts_no_kernel():
    """A CPU whitening counts neither ``whiten.kernel`` nor a launch."""
    L, dinv = _factor(200, seed=5)
    kt = _rhs(200, 17)
    before = timing.counters().get("whiten.kernel", 0)
    launches = (solve_lower_many.launches, solve_lower_many.captured)
    gp_core.whiten(L, kt, dinv)
    solve_lower_many(L, dinv, kt)
    assert timing.counters().get("whiten.kernel", 0) == before
    assert (solve_lower_many.launches, solve_lower_many.captured) == launches


@pytest.mark.parametrize("case,error", [
    ("no_dinv", ValueError), ("float64", TypeError),
    ("float64_rhs", TypeError), ("rank", ValueError),
    ("rows", ValueError), ("dinv_shape", ValueError),
    ("device", ValueError)])
def test_solve_lower_many_refuses(case, error):
    """The wrapper raises on what it does not take, on the CPU as on the
    card: no tile inverses, another dtype, a batch, a right-hand side of
    other rows, inverses of another tile, operands on another device."""
    L, dinv = _factor(130, seed=7)
    kt = _rhs(130, 5)
    args = {
        "no_dinv": (L, None, kt),
        "float64": (L.double(), dinv.double(), kt.double()),
        "float64_rhs": (L, dinv, kt.double()),
        "rank": (L, dinv, kt[None]),
        "rows": (L, dinv, kt[1:]),
        "dinv_shape": (L, dinv[:TILE], kt),
        "device": (L, dinv, kt.to("meta")),
    }[case]
    with pytest.raises(error):
        solve_lower_many(*args)
