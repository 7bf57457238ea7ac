"""The yardstick's arithmetic for the noisy-input GP with gradient
observations (``nigp7680``): the operations and bytes of its fit's joint-
gram Cholesky, of a fit and of a test with gradients, from their shapes.
The kernels timed, the rbf entry and the factorization's kernel count are
``portbench/exact_work.py``'s; the card's peaks, the least time and the
conventions are ``portbench/work.py``'s: operations count what the inputs
need (the samples the set holds, not the padded rows), bytes each input
read once and each output written once, in float32.

A sample pair's block of the joint gram holds (1 + d)^2 entries: the value
entry (an rbf entry), d value/gradient and d gradient/value entries (2
operations each: a difference times the scaled value) and d^2
gradient/gradient entries (3 each: a product of two differences and its
scale, the diagonal's term subtracted where it has one).
"""

from __future__ import annotations

from portbench.exact_work import TILE, rbf_entry_flops
from portbench.work import F32

FIRST = 2    # operations of a first-derivative entry
SECOND = 3   # operations of a second-derivative entry


def joint_rows(n: int, d: int) -> int:
    """The joint system's rows: the values and d gradient blocks."""
    return (1 + d) * n


def chol_joint_flops(n: int, d: int) -> float:
    """The joint-gram Cholesky of n samples: the joint gram's lower
    triangle (the value block's lower triangle, the d gradient/value
    blocks whole, the gradient/gradient blocks on and below the diagonal
    of blocks), the noise on its diagonal, then N^3 / 3, N = (1 + d) n."""
    tri, full = n * (n + 1) // 2, n * n
    values = tri * rbf_entry_flops(d)
    cross = d * full * FIRST
    grads = (d * (d - 1) // 2 * full + d * tri) * SECOND
    big = joint_rows(n, d)
    return float(values + cross + grads + big + big ** 3 / 3)


def chol_joint_bytes(n: int, d: int) -> float:
    """Samples, the value and gradient noises and two mask bytes read; L's
    lower triangle and the inverses of its diagonal tiles written."""
    big = joint_rows(n, d)
    nb = -(-big // TILE)
    read = F32 * n * (d + 2) + 2 * n
    return float(read + F32 * (big * (big + 1) // 2 + nb * TILE * TILE))


def nigp_fit_flops(n: int, d: int) -> float:
    """A fit: the joint-gram Cholesky and the two substitutions for alpha
    (N^2 each)."""
    big = joint_rows(n, d)
    return chol_joint_flops(n, d) + 2.0 * big * big


def cross_entry_flops(d: int) -> int:
    """One (sample, query) pair's block of the cross gram with gradient
    columns: (1 + d)^2 entries."""
    return rbf_entry_flops(d) + 2 * d * FIRST + d * d * SECOND


def nigp_query_flops(n: int, m: int, d: int) -> float:
    """A test of m queries with gradients and its variances: the cross
    gram (n m pair blocks), the mean and the gradient against alpha (2 N
    (1 + d) m), the whitening L^-1 k* (N^2 (1 + d) m), the squared norms
    of the (1 + d) m whitened columns and their prior less them (2 N + 1
    each), and the d (d + 1) / 2 covariances a query (2 N each)."""
    big = joint_rows(n, d)
    cols = (1 + d) * m
    return float(n * m * cross_entry_flops(d) + 2 * big * cols
                 + big * big * cols + (2 * big + 1) * cols
                 + d * (d + 1) // 2 * m * 2 * big)
