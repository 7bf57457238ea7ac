"""Plain reference of the noisy-input GP with gradient observations
(``nigp7680``): upstream's ``NoisyInputGaussianProcess``
(src/noisy_input_gp.cpp) in its 2D case with every sample's gradient
flagged (test/gtest/test_noisy_input_gp.cpp), in plain ``torch``.

Training: the joint gram of upstream's ``ComputeKtrainWithGradient``
layout, rows and columns ``[values(n); grad-dim0(n); grad-dim1(n)]``, for
the rbf kernel k(a, b) = exp(-|a - b|^2 / (2 s^2)) with D = a - b:

- value/value k; value/gradient (column b's dimension l) D_l k / s^2;
  gradient/value (row a's dimension l) -D_l k / s^2;
- gradient/gradient (l, m) (delta_lm / s^2 - D_l D_m / s^4) k;
- ``var_x + var_y`` on the value diagonal, ``var_grad`` on the gradient
  diagonal.

L = chol(K) by ``torch.linalg.cholesky``; alpha = L^-T L^-1 [y; g0; g1]
by block substitution. A query point q has the columns ``[mean(q);
grad-dim0(q); grad-dim1(q)]`` of the same layout (:func:`joint_cross`);
its mean and gradient are those columns against alpha; with V = L^-1 of
the columns, the mean variance 1 - ||V_f||^2 and the gradient variance
3 / s^2 - ||V_gl||^2 (each clamped at 0, as rounding near a training point
can push them below), and the covariances, in upstream's lower-triangle
order, -V_g0 . V_f, -V_g1 . V_f, -V_g1 . V_g0.

Departures from upstream, none of which changes what is computed:

- the gradient variance's prior is upstream's 3 / s^2
  (noisy_input_gp.cpp:270-280), which is the Matern-3/2 kernel's and not
  the rbf's 1 / s^2; it is kept, as the program keeps it;
- the training set is 2500 scattered samples with noisy targets and
  gradients (the configuration's ``assumed``), not upstream's noiseless
  50 x 50 grid;
- the factor comes from LAPACK or cuSOLVER, not Eigen's LLT; a triangular
  solve is ``reference/exact_gp.py``'s block substitution;
- gram rows and queries go in blocks, so that the reference fits on the
  card beside the program.

``dtype`` is float64 for the reference, with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False). ``tf32=True`` with float32 is
the control: the same computation with TF32 matrix products, as
``reference/exact_gp.py`` has it. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.exact_gp import _mm, solve_lower, tf32_products

ROWS = 512     # samples a block of the gram's rows
QUERIES = 1024   # queries a block


def surface(x: np.ndarray) -> np.ndarray:
    """Upstream's surface z = 2 sin(10 x) cos(5 y); x (n, 2)."""
    return 2.0 * np.sin(10.0 * x[:, 0]) * np.cos(5.0 * x[:, 1])


def surface_grad(x: np.ndarray) -> np.ndarray:
    """The surface's gradient (n, 2): (20 cos(10 x) cos(5 y), -10 sin(10 x)
    sin(5 y))."""
    return np.stack([20.0 * np.cos(10.0 * x[:, 0]) * np.cos(5.0 * x[:, 1]),
                     -10.0 * np.sin(10.0 * x[:, 0]) * np.sin(5.0 * x[:, 1])],
                    -1)


def grid(side: int, domain) -> np.ndarray:
    """Upstream's test grid over ``domain`` ((lo, hi) a dimension), (side^2,
    2): x outer, y inner (test_noisy_input_gp.cpp's grid)."""
    (x0, x1), (y0, y1) = domain
    gx, gy = np.meshgrid(np.linspace(x0, x1, side), np.linspace(y0, y1, side),
                         indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1)


def host(t) -> np.ndarray:
    """A tensor as float64 numpy on the host."""
    return t.double().cpu().numpy()


def joint_cross(a, b, scale: float):
    """The joint gram of points a (n, d) against b (m, d) of one dtype:
    rows ``[values(n); grad-dim0(n); ...]`` of a, columns the same of b,
    ((1 + d) n, (1 + d) m)."""
    n, d = a.shape
    m = b.shape[0]
    inv = 1.0 / (scale * scale)
    diff = [a[:, j, None] - b[None, :, j] for j in range(d)]
    k = torch.exp(sum(t * t for t in diff) * (-0.5 * inv))
    out = torch.empty(((1 + d) * n, (1 + d) * m), dtype=a.dtype,
                      device=a.device)
    out[:n, :m] = k
    for lo in range(d):
        rows = slice((1 + lo) * n, (2 + lo) * n)
        cols = slice((1 + lo) * m, (2 + lo) * m)
        first = diff[lo] * (inv * k)
        out[:n, cols] = first
        out[rows, :m] = -first
        for hi in range(d):
            second = -(diff[lo] * diff[hi]) * (inv * inv * k)
            if hi == lo:
                second += inv * k
            out[rows, (1 + hi) * m:(2 + hi) * m] = second
    return out


def train_gram(x, var_v: float, var_g: float, scale: float):
    """The joint train gram K (N, N), N = (1 + d) n, built in row blocks,
    with ``var_v`` on the value diagonal and ``var_g`` on the gradient
    diagonal."""
    n, d = x.shape
    K = torch.empty(((1 + d) * n, (1 + d) * n), dtype=x.dtype,
                    device=x.device)
    for lo in range(0, n, ROWS):
        hi = min(n, lo + ROWS)
        part = joint_cross(x[lo:hi], x, scale)
        for r in range(1 + d):
            K[r * n + lo:r * n + hi] = part[r * (hi - lo):(r + 1) * (hi - lo)]
    K.diagonal()[:n] += var_v
    K.diagonal()[n:] += var_g
    return K


def joint_targets(y: np.ndarray, grad: np.ndarray) -> np.ndarray:
    """[y (n); grad-dim0 (n); ...] for y (n,) and grad (n, d)."""
    return np.concatenate([y, *grad.T])


class FitReference:
    """One training set fit in ``dtype`` on ``device``: x32 (n, 2), y32 (n,)
    and g32 (n, 2) the float32 samples the program was given."""

    def __init__(self, x32, y32, g32, var_v: float, var_g: float,
                 scale: float, *, dtype=torch.float64, device="cpu",
                 tf32: bool = False):
        self.scale, self.tf32 = scale, tf32
        self.device = torch.device(device)
        self.x = torch.as_tensor(x32, device=self.device).to(dtype)
        t = torch.as_tensor(joint_targets(y32, g32),
                            device=self.device).to(dtype)[:, None]
        with tf32_products(tf32):
            self.L = torch.linalg.cholesky(
                train_gram(self.x, var_v, var_g, scale))
            self.alpha = solve_lower(self.L, solve_lower(self.L, t, tf32),
                                     tf32, transpose=True)

    def predict(self, xq: np.ndarray) -> tuple:
        """(mean (m,), gradient (d, m), mean variance (m,), gradient
        variance (d, m), covariance (d (d + 1) / 2, m)) at xq (m, d),
        float64 numpy, in the layouts of the program's getters."""
        m, d = xq.shape
        mean, grad = np.empty(m), np.empty((d, m))
        var, gvar = np.empty(m), np.empty((d, m))
        cov = np.empty((d * (d + 1) // 2, m))
        q = torch.as_tensor(xq, device=self.device).to(self.x.dtype)
        prior = 3.0 / (self.scale * self.scale)
        for lo in range(0, m, QUERIES):
            hi = min(m, lo + QUERIES)
            b = hi - lo
            with tf32_products(self.tf32):
                ks = joint_cross(self.x, q[lo:hi], self.scale)
                out = _mm(ks.T, self.alpha, self.tf32)[:, 0]
                v = solve_lower(self.L, ks, self.tf32)
            cols = [v[:, j * b:(j + 1) * b] for j in range(1 + d)]
            sq = [(c * c).sum(0) for c in cols]
            mean[lo:hi] = host(out[:b])
            var[lo:hi] = host(torch.clamp(1.0 - sq[0], min=0.0))
            row = 0
            for j in range(d):
                grad[j, lo:hi] = host(out[(1 + j) * b:(2 + j) * b])
                gvar[j, lo:hi] = host(torch.clamp(prior - sq[1 + j], min=0.0))
                for c in range(1 + j):   # the value, then gradients < j
                    cov[row, lo:hi] = host(-(cols[1 + j] * cols[c]).sum(0))
                    row += 1
        return mean, grad, var, gvar, cov


def mean_from_alpha(x32, alpha: np.ndarray, xq: np.ndarray, scale: float,
                    device="cpu") -> tuple:
    """(mean (m,), gradient (d, m)) in float64 that a joint alpha ((1 + d)
    n,) gives at xq (m, d)."""
    x = torch.as_tensor(x32, device=device).double()
    a = torch.as_tensor(alpha, device=device).double().reshape(-1, 1)
    q = torch.as_tensor(xq, device=device).double()
    m, d = xq.shape
    mean, grad = np.empty(m), np.empty((d, m))
    with tf32_products(False):
        for lo in range(0, m, QUERIES):
            hi = min(m, lo + QUERIES)
            out = (joint_cross(x, q[lo:hi], scale).T @ a)[:, 0].cpu().numpy()
            b = hi - lo
            mean[lo:hi] = out[:b]
            grad[:, lo:hi] = out[b:].reshape(d, b)
    return mean, grad


def backward_rel(L, x32, var_v: float, var_g: float, scale: float,
                 device="cpu") -> float:
    """||L L^T - K||_max / ||K||_max of a joint factor L (N, N), K built in
    float64 from the float32 samples x32: the factorization's backward
    error."""
    x = torch.as_tensor(x32, device=device).double()
    L = torch.as_tensor(L, device=device).double()
    with tf32_products(False):
        K = train_gram(x, var_v, var_g, scale)
        worst = 0.0
        for lo in range(0, len(K), 2048):
            d = (L[lo:lo + 2048] @ L.T - K[lo:lo + 2048]).abs().max()
            worst = max(worst, float(d))
        return worst / float(K.abs().max())
