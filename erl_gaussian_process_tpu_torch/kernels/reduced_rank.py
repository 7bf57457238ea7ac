"""Reduced-rank (Hilbert-space) covariance (counterpart of
``erl_gaussian_process_tpu/kernels/reduced_rank.py``).

Method (Solin & Särkkä, "Hilbert space methods for reduced-rank Gaussian
process regression", Stat. Comput. 2020): on the box
``[origin - Lb, origin + Lb]^d`` the negative Laplacian has eigenpairs

    phi_j(x)  = prod_k sqrt(1/Lb_k) * sin(pi j_k (x_k - o_k + Lb_k) / (2 Lb_k))
    lam_j     = sum_k (pi j_k / (2 Lb_k))^2

and a stationary kernel is approximated by k(x, x') ~= sum_j S(sqrt(lam_j))
phi_j(x) phi_j(x') with S the kernel's spectral density. The features are
whitened, ``phit_j = sqrt(S_j) * phi_j``, so the prior on the weights is
N(0, I):

    train:    A = I + Phit^T diag(1/var) Phit        (m, m)
              b = Phit^T (y / var)                   (m, q)
              L = chol(A);  alpha = A^{-1} b
    predict:  mean = phit(x*)^T alpha
              var  = ||L^{-1} phit(x*)||^2           <- note **+**, no 1-...

"Ktrain" is the (m, m) information matrix (rows = #basis, not n), and the
posterior variance is ``+||.||^2``. The features and the information
systems are plain torch (the JAX package leaves them to XLA); the exact
GPs factor A with the blocked Cholesky (``gp_core.cholesky_fit(robust=
False)``), the banks with batched library factorizations.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.kernels.base import KernelSetting

# names accepted for a reduced-rank kernel: "reduced_rank_rbf", "rr_matern32",
# or the reference's C++ type string "erl::covariance::ReducedRankMatern32<...>"
_RR_NAME_RE = re.compile(
    r"^(?:erl::covariance::)?(?:ReducedRank|reduced_rank_?|rr_)(\w*?)"
    r"\s*(?:<.*>)?$", re.IGNORECASE)

_BASE_ALIASES = {
    "radialbiasfunction": "rbf", "radial_bias_function": "rbf",
    "squaredexponential": "rbf", "rbf": "rbf",
    "ornsteinuhlenbeck": "ou", "ornstein_uhlenbeck": "ou", "ou": "ou",
    "matern32": "matern32", "": "",
}


def parse_reduced_rank_name(name: str) -> Optional[str]:
    """If ``name`` denotes a reduced-rank kernel, return the base kernel
    family name ("" when the name is generic, e.g. just "reduced_rank" —
    the setting's ``base_kernel`` then decides); else None."""
    m = _RR_NAME_RE.match(name.strip())
    if not m:
        return None
    base = re.sub(r"\d+[df]?$", "", m.group(1)).lower()
    if base in ("matern", "matern3"):
        base = "matern32"
    return _BASE_ALIASES.get(base, base)


def spectral_density(name: str, omega2, scale: float, d: int):
    """S(omega) as a function of omega^2 (a numpy array) for the three
    kernel families (unit variance, isotropic, d input dims).

    rbf      : S = (2 pi)^{d/2} s^d exp(-omega^2 s^2 / 2)
    matern32 : nu = 3/2, S = c_d * (2 nu / s^2 + omega^2)^{-(nu + d/2)}
    ou       : nu = 1/2 (exponential kernel), same Matern form.
    """
    s = scale
    if name == "rbf":
        return (2.0 * math.pi) ** (d / 2.0) * s**d * np.exp(-0.5 * s * s * omega2)
    if name in ("matern32", "ou"):
        nu = 1.5 if name == "matern32" else 0.5
        c = (2.0 ** d * math.pi ** (d / 2.0) * math.gamma(nu + d / 2.0)
             * (2.0 * nu) ** nu) / (math.gamma(nu) * s ** (2.0 * nu))
        return c * (2.0 * nu / (s * s) + omega2) ** (-(nu + d / 2.0))
    raise KeyError(f"no spectral density for kernel {name!r}")


@dataclasses.dataclass
class ReducedRankSetting(KernelSetting):
    """The base covariance setting plus the basis grid. ``boundary`` is the
    box half-extent per dim (relative to ``coord_origin``); ``num_basis``
    is basis functions per dim (total m = prod(num_basis)). ``boundary``
    None means "not set": the sensor GPs derive a box from their frame,
    and :class:`ReducedRankBasis` falls back to 1.0 per dim; an explicit
    value, even [1.0], is kept."""

    base_kernel: str = "rbf"
    num_basis: List[int] = dataclasses.field(default_factory=lambda: [32])
    boundary: Optional[List[float]] = None
    coord_origin: List[float] = dataclasses.field(default_factory=lambda: [0.0])

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in known})


class ReducedRankBasis:
    """The basis grid's state: per-basis frequencies and whitening weights
    sqrt(S(sqrt(lam_j))), built on the host in the model's dtype (the
    reference's ``BuildSpectralDensities`` after creation or load).
    :meth:`consts` gives them as tensors on a device, cached."""

    def __init__(self, setting: ReducedRankSetting, dtype=np.float64):
        self.setting = setting
        self.dtype = np.dtype(dtype)
        d = len(setting.num_basis)
        if setting.boundary is None:
            setting.boundary = [1.0] * d
        if len(setting.boundary) != d or len(setting.coord_origin) != d:
            raise ValueError(
                "num_basis, boundary, coord_origin must share length "
                f"({setting.num_basis}, {setting.boundary}, "
                f"{setting.coord_origin})")
        self.build_spectral_densities()

    @property
    def num_basis_total(self) -> int:
        return int(np.prod(self.setting.num_basis))

    @property
    def x_dim(self) -> int:
        return len(self.setting.num_basis)

    def build_spectral_densities(self):
        """(Re)build the frequency grid and the whitening weights."""
        s = self.setting
        d = self.x_dim
        axes = [np.arange(1, n + 1, dtype=self.dtype) for n in s.num_basis]
        grids = np.meshgrid(*axes, indexing="ij")
        j = np.stack([g.ravel() for g in grids], axis=-1)      # (m, d)
        Lb = np.asarray(s.boundary, self.dtype)                 # (d,)
        freq = j * (math.pi / 2.0) / Lb                         # (m, d)
        lam = np.sum(freq * freq, axis=-1)                      # (m,)
        Sj = spectral_density(s.base_kernel, lam, s.scale, d)
        self._freq = freq
        self._sqrt_s = np.sqrt(Sj, dtype=self.dtype)
        self._half = Lb
        self._inv_sqrt_vol = self.dtype.type(
            float(np.prod(1.0 / np.sqrt(Lb))))
        self._set_origin(s.coord_origin)

    def _set_origin(self, origin):
        self._origin = np.asarray(origin, self.dtype)
        self._consts = {}

    @property
    def coord_origin(self) -> np.ndarray:
        return self._origin.copy()

    def set_coord_origin(self, origin: Sequence[float]):
        self.setting.coord_origin = [float(v) for v in origin]
        self._set_origin(self.setting.coord_origin)

    def consts(self, device) -> tuple:
        """(freq (m, d), sqrt_s (m,), origin (d,), half (d,), inv_sqrt_vol
        ()) as tensors of the basis dtype on ``device``: the arguments of
        :func:`rr_features` and :func:`rr_features_with_grad`."""
        device = torch.device(device)
        c = self._consts.get(device)
        if c is None:
            c = tuple(torch.tensor(np.asarray(a), device=device) for a in (
                self._freq, self._sqrt_s, self._origin, self._half,
                self._inv_sqrt_vol))
            self._consts[device] = c
        return c

    def features(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """Whitened features Phit (..., n, m) of x (..., n, d); rows with
        mask False are zero. Coordinates outside the box clamp to its edge
        (the sine basis vanishes there)."""
        if mask is None:
            mask = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        return rr_features(x, mask, *self.consts(x.device))

    def state_dict(self):
        return {"setting": self.setting.to_dict(), "dtype": self.dtype.str}

    @classmethod
    def from_state_dict(cls, d):
        return cls(ReducedRankSetting.from_dict(d["setting"]),
                   dtype=np.dtype(d["dtype"]))

    def __eq__(self, other):
        if not isinstance(other, ReducedRankBasis):
            return NotImplemented
        return self.setting == other.setting and self.dtype == other.dtype


def rr_features(x, mask, freq, sqrt_s, origin, half, inv_sqrt_vol):
    """Whitened Hilbert-basis features (..., n, m) of x (..., n, d); see
    :meth:`ReducedRankBasis.features`."""
    z = x - origin + half                               # in [0, 2L]
    z = torch.minimum(torch.clamp(z, min=0.0), 2.0 * half)
    angles = z[..., None, :] * freq                     # (..., n, m, d)
    phi = torch.prod(torch.sin(angles), dim=-1)         # (..., n, m)
    phi = phi * (inv_sqrt_vol * sqrt_s)
    return torch.where(mask[..., None], phi, torch.zeros_like(phi))


def rr_features_with_grad(x, freq, sqrt_s, origin, half, inv_sqrt_vol):
    """Whitened features and their input gradients: (phi (n, m), dphi (n,
    d, m)) with dphi[i, k, j] = d phit_j / d x_k (x_i), the derivative of
    the implemented (clamped) feature: 0 in a clamped coordinate.
    Unmasked: callers apply the sample and gradient masks."""
    d = x.shape[1]
    z = x - origin + half
    zc = torch.minimum(torch.clamp(z, min=0.0), 2.0 * half)
    inside = (z > 0.0) & (z < 2.0 * half)               # (n, d)
    angles = zc[:, None, :] * freq                      # (n, m, d)
    sin = torch.sin(angles)
    cos = torch.cos(angles)
    w = inv_sqrt_vol * sqrt_s                           # (m,)
    phi = torch.prod(sin, dim=-1) * w
    dims = torch.arange(d, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    dphis = []
    for k in range(d):
        others = torch.prod(torch.where(dims == k, one, sin), dim=-1)
        dphis.append(others * cos[:, :, k] * freq[:, k]
                     * inside[:, k:k + 1])
    dphi = torch.stack(dphis, dim=1) * w                # (n, d, m)
    return phi, dphi


def rr_train_system(basis_phi, y, var, mask):
    """A = I + Phit^T diag(mask/var) Phit; b = Phit^T (mask * y / var), over
    optional leading batch dims: basis_phi (..., n, m), y (..., n, q),
    var and mask (..., n). Returns (A (..., m, m), b (..., m, q))."""
    w = torch.where(mask, 1.0 / var, torch.zeros_like(var))
    phw = basis_phi * w[..., None]
    m = basis_phi.shape[-1]
    A = torch.eye(m, dtype=basis_phi.dtype, device=basis_phi.device) \
        + basis_phi.mT @ phw
    b = phw.mT @ torch.where(mask[..., None], y, torch.zeros_like(y))
    return A, b


def rr_joint_train_system(phi, dphi, y, grad, var_val, var_grad,
                          sample_mask, grad_mask):
    """The joint value/gradient information system

        A = I + Phit^T Wv Phit + sum_k dPhit_k^T Wg dPhit_k
        b = Phit^T Wv y + sum_k dPhit_k^T Wg grad_k

    with Wv = diag(sample_mask / var_val), Wg = diag(grad_mask / var_grad);
    ``var_val`` is the NIGP's value noise var_x + var_y. phi (n, m); dphi
    (n, d, m); y (n, q); grad (n, d, q). Returns (A (m, m), b (m, q))."""
    wv = torch.where(sample_mask, 1.0 / var_val, torch.zeros_like(var_val))
    wg = torch.where(grad_mask, 1.0 / var_grad, torch.zeros_like(var_grad))
    m = phi.shape[1]
    A = torch.eye(m, dtype=phi.dtype, device=phi.device) \
        + phi.mT @ (phi * wv[:, None])
    A = A + torch.einsum("ndm,n,ndp->mp", dphi, wg, dphi)
    b = phi.mT @ (torch.where(sample_mask[:, None], y, torch.zeros_like(y))
                  * wv[:, None])
    b = b + torch.einsum("ndm,n,ndq->mq", dphi, wg,
                         torch.where(grad_mask[:, None, None], grad,
                                     torch.zeros_like(grad)))
    return A, b


def rr_ktest_joint(xq, freq, sqrt_s, origin, half, inv_sqrt_vol,
                   with_test_grad: bool):
    """The reduced-rank "Ktest" in the NIGP's joint layout: rows = #basis,
    columns = [means(mq) | grad-dim0(mq) | grad-dim1(mq) | ...]. Shape
    (m, mq*(1+d)), or (m, mq) without test gradients."""
    phi, dphi = rr_features_with_grad(xq, freq, sqrt_s, origin, half,
                                      inv_sqrt_vol)
    if not with_test_grad:
        return phi.mT
    d = xq.shape[1]
    return torch.cat([phi.mT] + [dphi[:, k, :].mT for k in range(d)], dim=1)
