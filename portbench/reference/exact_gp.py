"""Plain reference of the exact GP (``exact_gp8192``): upstream's
``VanillaGaussianProcess`` (src/vanilla_gp.cpp) in its 2D single-output
test (test/gtest/test_vanilla_gp.cpp:112-221), in plain ``torch``.

Training: K = k(x, x) + noise I with the rbf kernel k(a, b) =
exp(-r^2 / (2 s^2)), r = |a - b| (the port's definition,
``ops/gram.py``); L = chol(K) by ``torch.linalg.cholesky``; alpha =
L^-T L^-1 y by two triangular solves. A query point q: the mean k*^T alpha
and the variance 1 - ||L^-1 k*||^2, clamped at 0 (rounding near a training
point can push it below), k* = k(x, q).

Departures from upstream, none of which changes what is computed:

- the training set is 8192 scattered samples with noisy targets (the
  configuration's ``assumed``), not upstream's noiseless 50 x 50 grid;
- the factor comes from LAPACK or cuSOLVER, not Eigen's LLT;
- a triangular solve is a block substitution (:func:`solve_lower`): each
  block of rows less the product of the rows solved before it, then the
  diagonal block's ``torch.linalg.solve_triangular``;
- queries and the gram's rows go in blocks, so that the reference fits on
  the card beside the program.

``dtype`` is float64 for the reference, with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False). ``tf32=True`` with float32 is
the control: the same computation with TF32 matrix products (both flags
True). Each product's operands are rounded to TF32 (a 10-bit mantissa, to
nearest) as the tensor cores round them, so the control is the same on
every device and whatever route the BLAS takes (a matrix-vector product
runs on no tensor core). Nothing here imports the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

BLOCK = 2048   # rows of the gram, and queries, a block
SOLVE_BLOCK = 256   # rows a step of a block substitution


def surface(x: np.ndarray) -> np.ndarray:
    """Upstream's test surface z = 2 sin(10 x) cos(10 y); x (n, 2)."""
    return 2.0 * np.sin(10.0 * x[:, 0]) * np.cos(10.0 * x[:, 1])


def grid(side: int, lo: float, hi: float) -> np.ndarray:
    """Upstream's test grid, (side^2, 2): x outer, y inner
    (test_vanilla_gp.cpp:118)."""
    c = np.linspace(lo, hi, side)
    gx, gy = np.meshgrid(c, c, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1)


@contextlib.contextmanager
def tf32_products(on: bool):
    """TF32 matrix products allowed inside the block when ``on``, else
    not; the settings restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10-bit mantissa, to nearest."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, tf32: bool):
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def rbf(a, b, scale: float):
    """k(a, b) (len(a), len(b)) for a (n, d) and b (m, d) of one dtype."""
    r2 = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype,
                     device=a.device)
    for j in range(a.shape[1]):
        r2 += (a[:, j, None] - b[None, :, j]) ** 2
    return torch.exp(r2 * (-0.5 / (scale * scale)))


def train_gram(x, noise: float, scale: float):
    """K = k(x, x) + noise I, built in row blocks."""
    n = x.shape[0]
    K = torch.empty((n, n), dtype=x.dtype, device=x.device)
    for lo in range(0, n, BLOCK):
        K[lo:lo + BLOCK] = rbf(x[lo:lo + BLOCK], x, scale)
    K.diagonal().add_(noise)
    return K


def solve_lower(L, B, tf32: bool = False, transpose: bool = False):
    """L^-1 B, or with ``transpose`` L^-T B, for L (n, n) lower triangular
    and B (n, k), by block substitution."""
    n = L.shape[0]
    X = torch.empty_like(B)
    blocks = list(range(0, n, SOLVE_BLOCK))
    for lo in (reversed(blocks) if transpose else blocks):
        hi = min(n, lo + SOLVE_BLOCK)
        rhs = B[lo:hi]
        if transpose and hi < n:
            rhs = rhs - _mm(L[hi:, lo:hi].T, X[hi:], tf32)
        elif not transpose and lo:
            rhs = rhs - _mm(L[lo:hi, :lo], X[:lo], tf32)
        D = L[lo:hi, lo:hi]
        X[lo:hi] = torch.linalg.solve_triangular(
            D.T if transpose else D, rhs, upper=transpose)
    return X


class FitReference:
    """One training set fit in ``dtype`` on ``device``: x32 (n, 2) and y32
    (n,) the float32 samples the program was given."""

    def __init__(self, x32: np.ndarray, y32: np.ndarray, noise: float,
                 scale: float, *, dtype=torch.float64, device="cpu",
                 tf32: bool = False):
        self.scale, self.tf32 = scale, tf32
        self.device = torch.device(device)
        self.x = torch.as_tensor(x32, device=self.device).to(dtype)
        y = torch.as_tensor(y32, device=self.device).to(dtype)[:, None]
        with tf32_products(tf32):
            self.L = torch.linalg.cholesky(train_gram(self.x, noise, scale))
            self.alpha = solve_lower(self.L, solve_lower(self.L, y, tf32),
                                     tf32, transpose=True)

    def predict(self, xq: np.ndarray):
        """(mean (m,), variance (m,)) at xq (m, 2), float64 numpy."""
        m = len(xq)
        mean, var = np.empty(m), np.empty(m)
        q = torch.as_tensor(xq, device=self.device).to(self.x.dtype)
        for lo in range(0, m, BLOCK):
            with tf32_products(self.tf32):
                ks = rbf(self.x, q[lo:lo + BLOCK], self.scale)
                mean[lo:lo + BLOCK] = _mm(ks.T, self.alpha, self.tf32)[:, 0] \
                    .double().cpu().numpy()
                v = solve_lower(self.L, ks, self.tf32)
                var[lo:lo + BLOCK] = torch.clamp(
                    1.0 - (v * v).sum(0), min=0.0).double().cpu().numpy()
        return mean, var


def mean_from_alpha(x32: np.ndarray, alpha: np.ndarray, xq: np.ndarray,
                    scale: float, device="cpu") -> np.ndarray:
    """k(x, xq)^T alpha in float64 (m,): the mean a fit's alpha gives."""
    x = torch.as_tensor(x32, device=device).double()
    a = torch.as_tensor(alpha, device=device).double().reshape(-1, 1)
    q = torch.as_tensor(xq, device=device).double()
    out = np.empty(len(xq))
    with tf32_products(False):
        for lo in range(0, len(xq), BLOCK):
            ks = rbf(x, q[lo:lo + BLOCK], scale)
            out[lo:lo + BLOCK] = (ks.T @ a)[:, 0].cpu().numpy()
    return out


def backward_rel(L, x32: np.ndarray, noise: float, scale: float,
                 device="cpu") -> float:
    """||L L^T - K||_max / ||K||_max of a factor L (n, n), K built in
    float64 from the float32 samples x32: the factorization's backward
    error."""
    x = torch.as_tensor(x32, device=device).double()
    L = torch.as_tensor(L, device=device).double()
    with tf32_products(False):
        K = train_gram(x, noise, scale)
        worst = 0.0
        for lo in range(0, len(K), BLOCK):
            d = (L[lo:lo + BLOCK] @ L.T - K[lo:lo + BLOCK]).abs().max()
            worst = max(worst, float(d))
        return worst / float(K.abs().max())
