"""The yardstick's arithmetic for the exact GP (``exact_gp8192``): the
kernels of its fit that the per-layer readers time, and the operations
and bytes its fit and its test need, from their shapes. The card's peaks,
the least time and the conventions are ``portbench/work.py``'s: operations
count what the inputs need, bytes each input read once and each output
written once, in float32.
"""

from __future__ import annotations

from portbench.work import F32, distance_flops

TILE = 64   # the blocked Cholesky's tile edge (csrc/chol.cu kTile)

# the kernels of one counted launch of the gram-fused Cholesky
# (``ops/chol.py::chol_blocked_gram``): per column of tiles an update and a
# diagonal factor, and an apply below the diagonal but in the last column
CHOL_KERNELS = ("chol_update", "chol_diag_kernel", "chol_apply_kernel")


def chol_kernels(n: int) -> int:
    """Kernels one factorization of size n launches."""
    nb = -(-n // TILE)
    return 3 * nb - 1


def rbf_entry_flops(d: int) -> int:
    """One rbf gram entry: a distance and the evaluation (a scale and an
    exponential, 2 operations)."""
    return distance_flops(d) + 2


def chol_gram_flops(n: int, d: int) -> float:
    """The gram-fused Cholesky: the gram's lower triangle and the noise on
    its diagonal, then n^3 / 3 for the factorization."""
    return float(n * (n + 1) // 2 * rbf_entry_flops(d) + n + n ** 3 / 3)


def chol_gram_bytes(n: int, d: int) -> float:
    """Samples, noise and a mask byte read; L's lower triangle and the
    inverses of its diagonal tiles written."""
    nb = -(-n // TILE)
    read = F32 * n * (d + 1) + n
    return float(read + F32 * (n * (n + 1) // 2 + nb * TILE * TILE))


def exact_fit_flops(n: int, d: int) -> float:
    """A fit: the gram-fused Cholesky and the two substitutions for alpha
    (n^2 each)."""
    return chol_gram_flops(n, d) + 2.0 * n * n


def exact_query_flops(n: int, m: int, d: int) -> float:
    """A test of m queries and its variance: the cross gram (n m entries),
    the mean k*^T alpha (2 n m), the whitening L^-1 k* (n^2 m) and the
    variance 1 - ||.||^2 (2 n m + m)."""
    return float(n * m * rbf_entry_flops(d) + 2 * n * m + n * n * m
                 + 2 * n * m + m)
