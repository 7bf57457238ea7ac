"""The yardstick's arithmetic: the card's published peaks, the kernels the
per-layer readers time (by name pattern, with the kernels one counted
launch of the program's wrapper makes), and the operations and bytes each
timed computation needs, from its shapes.

Operations count what the inputs need (samples a pose used, hits a member
holds), not the padded work a kernel does; bytes count each input read
once and each output written once, in float32 (4 bytes).
"""

from __future__ import annotations

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at the 700 W limit
PEAK_FLOPS = 495e12   # TF32 tensor cores: the fastest unit taking float32
PEAK_BYTES = 3.35e12  # HBM3
F32 = 4

# wrapper -> (kernel name patterns, kernels one counted launch makes)
KERNELS = {
    "fitc": (("kmn_kernel", "beta_tc_kernel", "beta_f64_kernel",
              "syrk_tc_kernel", "syrk_f64_kernel"), 3),
    "bank_fit": (("bank_fit",), 1),
    "gram": (("gram_kernel",), 1),
}


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the memory's."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def distance_flops(d: int) -> int:
    """One Euclidean distance in d dimensions: d differences, d squares,
    d - 1 sums and a square root."""
    return 3 * d


def fitc_flops(m: int, n: int, d: int) -> float:
    """One rank-n FITC increment over m pseudo points: K_MN (a distance and
    the Matern-3/2 evaluation, 4 operations, an entry), beta = L^-1 K_MN
    with L^-1 triangular, lambda and the weights, the symmetric product
    K_MN W K_MN^T (its lower half) and K_MN W y."""
    kmn = m * n * (distance_flops(d) + 4)
    beta = m * (m + 1) * n
    weights = 2 * m * n + 3 * n + m * n
    syrk = m * (m + 1) * n
    dalpha = 2 * m * n
    return float(kmn + beta + weights + syrk + dalpha)


def fitc_bytes(m: int, n: int, d: int) -> float:
    """Pseudo points, the lower triangle of L^-1, the samples (points,
    targets, variances, a mask byte) read; dQ_M (m x m) and dalpha
    written."""
    read = F32 * (m * d + m * (m + 1) // 2 + n * (d + 2)) + n
    return float(read + F32 * (m * m + m))


def bank_fit_flops(counts, d: int) -> float:
    """Each member of n hits: its gram (a distance and the OU evaluation,
    2 operations, an entry), Cholesky (n^3 / 3), L^-1 (n^3 / 3) and alpha
    = L^-T L^-1 y (two triangular products, 2 n^2)."""
    return float(sum((distance_flops(d) + 2) * n * n + 2 * n ** 3 / 3
                     + 2 * n * n for n in counts))


def bank_fit_bytes(members: int, width: int, d: int) -> float:
    """Every member's padded inputs (points, variances, targets, a mask
    byte) read; its padded L, L^-1 and alpha, the bank's layout, written."""
    read = members * width * (F32 * (d + 2) + 1)
    return float(read + F32 * members * (2 * width * width + width))


def routed_gram_flops(per_query, d: int) -> float:
    """The routed test's gram: each valid query against the n hits of the
    member that answers it."""
    return float(sum(per_query) * (distance_flops(d) + 2))


def routed_gram_bytes(per_query, per_member, d: int) -> float:
    """Each query's coordinates and each answering member's points read
    once; one gram entry written per (query, hit)."""
    return float(F32 * (len(per_query) * d + sum(per_member) * d
                        + sum(per_query)))


def routed_test_flops(per_query, d: int) -> float:
    """A routed query's device work: its gram column, the mean k*^T alpha
    and the whitening ||L^-1 k*||^2 with L^-1 triangular."""
    return float(sum((distance_flops(d) + 2) * n + 2 * n + n * (n + 1)
                     + 2 * n for n in per_query))
