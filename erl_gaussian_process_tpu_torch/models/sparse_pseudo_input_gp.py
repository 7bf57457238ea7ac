"""Incremental sparse pseudo-input GP (SPGP/FITC) over fixed pseudo-points
(counterpart of ``erl_gaussian_process_tpu/models/sparse_pseudo_input_gp.py``).

    init:    K_M = k(P, P);  L_KM = chol(K_M);  Q_M = K_M;  alpha = 0
    update:  Q_M   += K_MN (Lambda + diag(var))^{-1} K_MN^T
             alpha += K_MN (Lambda + diag(var))^{-1} y
             lambda_i = 1 - ||L_KM^{-1} k_i||^2
    predict: mean  = k*^T Q_M^{-1} alpha
             var   = 1 - ||L_KM^{-1} k*||^2 + ||L_QM^{-1} k*||^2

The update of the main configuration (dense Q_M, no sparsity threshold)
runs ``ops/fitc.fitc_update_cuda``: the hand-written FITC kernel for a CUDA
state, its plain version for a CPU state. The diagonal-Q_M and thresholded
configurations run :func:`fitc_delta`, whose gram still goes through the
gram kernel on CUDA. Everything is eager PyTorch; the state is a
``NamedTuple`` of tensors on one device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.kernels import (
    KernelSetting,
    cross_gram,
    cross_gram_with_gradient,
    kernel_fn,
    resolve_kernel_setting,
)
from erl_gaussian_process_tpu_torch.models.gp_core import (
    DEFAULT_DEVICE,
    cholesky_nan,
    cond_escalate_threshold,
    host_jitter_retry,
    kahan_add,
    resolve_device,
    robust_cholesky,
    use_full_fp32_matmul,
)
from erl_gaussian_process_tpu_torch.ops.fitc import fitc_update_cuda
from erl_gaussian_process_tpu_torch.utils.serialization import (
    eq_state,
    load_pytree,
    save_pytree,
)

_LOG = logging.getLogger("erl_gaussian_process_tpu_torch")


def torch_dtype(dtype) -> torch.dtype:
    """torch.float32/float64 from a numpy or torch dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
    if out not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype!r} (float32 or float64)")
    return out


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(np.float32 if dtype == torch.float32 else np.float64)


class SpGpState(NamedTuple):
    """pseudo (M, d); L_km (M, M); L_inv (M, M) = L_km^{-1}; qm (M, M) [or
    (M, 1) when diagonal]; alpha (M, q); qm_c/alpha_c the Kahan
    compensation of qm/alpha (``qm - qm_c`` is the accumulated Q_M to
    ~double-float32 precision). M may include far-point padding rows
    (:func:`pad_pseudo_points`)."""

    pseudo: torch.Tensor
    L_km: torch.Tensor
    L_inv: torch.Tensor
    qm: torch.Tensor
    alpha: torch.Tensor
    qm_c: torch.Tensor
    alpha_c: torch.Tensor


def state_from_numpy(d, device) -> SpGpState:
    """An SpGpState on ``device`` from a dict of arrays (a ``state`` entry
    of a checkpoint). Missing compensation buffers start at zero. L_inv,
    the inverse of the lower-triangular L_km, is lower triangular by
    definition; it is stored as its lower triangle, since the FITC kernel
    reads its diagonal tiles whole (``ops/fitc.py``)."""
    st = {k: torch.tensor(np.ascontiguousarray(v), device=device)
          for k, v in d.items()}
    st["L_inv"] = torch.tril(st["L_inv"])
    st.setdefault("qm_c", torch.zeros_like(st["qm"]))
    st.setdefault("alpha_c", torch.zeros_like(st["alpha"]))
    return SpGpState(**{k: st[k] for k in SpGpState._fields})


def pad_pseudo_points(p: np.ndarray, multiple: int = 128) -> np.ndarray:
    """Pad (M, d) pseudo points to a multiple of ``multiple`` rows with the
    far-point trick: padding row i sits at 1e15 * (i + 2) in every
    coordinate, so k(pad, .) == +0.0 exactly for every family in float32
    and float64 and K_M becomes block-diag(K, I)."""
    m, d = p.shape
    m_pad = -(-m // multiple) * multiple
    if m_pad == m:
        return p
    pad = (np.arange(m_pad - m, dtype=p.dtype) + 2.0)[:, None] * p.dtype.type(
        1e15) * np.ones((1, d), p.dtype)
    return np.concatenate([p, pad], axis=0)


def spgp_init(pseudo: torch.Tensor, scale, *, kernel: str,
              diagonal_qm: bool = False, y_dim: int = 1) -> SpGpState:
    """K_M, chol, L_inv, Q_M <- K_M (or ones when diagonal), alpha <- 0."""
    m = pseudo.shape[0]
    km = kernel_fn(kernel)(pseudo, pseudo, scale)
    # the factorizations may return column-major results; the state (and
    # the FITC kernel, which reads L_inv) keeps row-major tensors
    L_km = robust_cholesky(km).contiguous()
    eye = torch.eye(m, dtype=km.dtype, device=km.device)
    L_inv = torch.linalg.solve_triangular(L_km, eye, upper=False).contiguous()
    qm = torch.ones((m, 1), dtype=km.dtype, device=km.device) \
        if diagonal_qm else km
    alpha = torch.zeros((m, y_dim), dtype=km.dtype, device=km.device)
    return SpGpState(pseudo=pseudo, L_km=L_km, L_inv=L_inv, qm=qm,
                     alpha=alpha, qm_c=torch.zeros_like(qm),
                     alpha_c=torch.zeros_like(alpha))


def spgp_update(state: SpGpState, x, y, var, mask, scale, *, kernel: str,
                diagonal_qm: bool = False, zero_threshold: float = 0.0,
                reduce=None, out: Optional[SpGpState] = None) -> SpGpState:
    """Rank-N FITC update with fixed-shape masking: masked-out columns
    contribute nothing. x (n, d); y (n, q); var/mask (n,).

    Dense Q_M without a threshold runs the FITC kernel wrapper (kernel on
    CUDA, plain version on the CPU); ``diagonal_qm`` or ``zero_threshold``
    > 0 (the reference's UpdateSparse math as a masked dense chain) run
    :func:`fitc_delta`. ``reduce``, when given, maps each increment before
    the Kahan add (the mesh's sum over ranks, ``parallel/mesh.py``).
    ``out``, when given (it may be ``state``), receives the new ``qm``,
    ``alpha``, ``qm_c`` and ``alpha_c`` in its tensors, bit for bit the
    values of a new state (``gp_core.kahan_add``), and is returned."""
    if not diagonal_qm and zero_threshold == 0.0:
        dq, da = fitc_update_cuda(kernel, state.pseudo, state.L_inv, x, y,
                                  var, mask, scale)
    else:
        l_inv = state.L_inv if state.pseudo.dtype == torch.float32 else None
        dq, da = fitc_delta(state.pseudo, state.L_km, x, y, var, mask, scale,
                            kernel=kernel, diagonal_qm=diagonal_qm,
                            zero_threshold=zero_threshold, L_inv=l_inv)
    if reduce is not None:
        dq, da = reduce(dq), reduce(da)
    qm, qm_c = kahan_add(state.qm, state.qm_c, dq,
                         out=None if out is None else (out.qm, out.qm_c))
    alpha, alpha_c = kahan_add(
        state.alpha, state.alpha_c, da,
        out=None if out is None else (out.alpha, out.alpha_c))
    if out is not None:
        return out
    return state._replace(qm=qm, alpha=alpha, qm_c=qm_c, alpha_c=alpha_c)


def fitc_delta(pseudo, L_km, x, y, var, mask, scale, *, kernel: str,
               diagonal_qm: bool = False, zero_threshold: float = 0.0,
               L_inv=None):
    """The per-column FITC increment (dQ_M (M, M|1), dalpha (M, q)).

    ``zero_threshold`` > 0: sub-threshold K_MN entries are zeroed before
    the solve. ``L_inv``: when given, beta is the product ``L_inv @ kmn``
    (the float32 path); None keeps the triangular solve against ``L_km``."""
    kmn = cross_gram(kernel, pseudo, x, scale)                 # (M, n)
    if zero_threshold:
        kmn = torch.where(torch.abs(kmn) >= zero_threshold, kmn,
                          torch.zeros_like(kmn))
    if L_inv is not None:
        beta = L_inv @ kmn                                     # (M, n)
    else:
        beta = torch.linalg.solve_triangular(L_km, kmn, upper=False)
    # lambda >= 0 mathematically; roundoff can push ||beta||^2 past 1 near
    # pseudo points, and an unclamped lambda can cancel var -> inf weights
    lam = torch.clamp(1.0 - torch.sum(beta * beta, dim=0), min=0.0)
    inv = torch.where(mask, 1.0 / (lam + var), torch.zeros_like(lam))
    ksc = kmn * inv[None, :]
    if diagonal_qm:
        dqm = torch.sum(ksc * kmn, dim=1, keepdim=True)
    else:
        dqm = ksc @ kmn.T
    yv = torch.where(mask[:, None], y, torch.zeros_like(y))
    return dqm, ksc @ yv


def spgp_prepare(state: SpGpState, jitter: float = 0.0, *,
                 diagonal_qm: bool = False):
    """(L_qm, alpha_solved = Q_M^{-1} alpha). A failed factorization comes
    back as NaN (see gp_core.cholesky_nan); the class ``_prepared`` tiers
    act on that."""
    if diagonal_qm:
        L_qm = torch.sqrt(state.qm[:, 0])
        return torch.diag(L_qm), state.alpha / state.qm
    m = state.qm.shape[0]
    eye = torch.eye(m, dtype=state.qm.dtype, device=state.qm.device)
    qm = state.qm + (jitter * torch.mean(torch.diagonal(state.qm))) * eye
    L_qm = cholesky_nan(qm)
    a = torch.linalg.solve_triangular(L_qm, state.alpha, upper=False)
    a = torch.linalg.solve_triangular(L_qm.T, a, upper=True)
    return L_qm, a


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit lower-triangular inverse (one solve with M right-hand
    sides); feeds :func:`fitc_variance`'s ``li_qm``."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def spgp_prepare_exact_host(state: SpGpState, *, diagonal_qm: bool = False):
    """Exact float64 HOST refactorization of Q_M from the compensated
    accumulators (qm - qm_c, alpha - alpha_c), for states whose device
    Cholesky is indefinite or ill-conditioned at the state dtype. If Q_M is
    indefinite even in float64, eigenvalues below the measured breach
    |lambda_min| are clamped up to ~2x that noise floor.

    Returns (L_qm, alpha_solved) in the state dtype and device, or None if
    the system is non-finite or degenerate."""
    import scipy.linalg

    dt, dev = state.qm.dtype, state.qm.device

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def back(a):
        return torch.as_tensor(a).to(device=dev, dtype=dt)

    qm = host(state.qm) - host(state.qm_c)
    al = host(state.alpha) - host(state.alpha_c)
    if not (np.isfinite(qm).all() and np.isfinite(al).all()):
        return None
    if diagonal_qm:
        if not (qm > 0).all():
            return None
        return back(np.diag(np.sqrt(qm[:, 0]))), back(al / qm)
    try:
        L = np.linalg.cholesky(qm)
    except np.linalg.LinAlgError:
        w, v = np.linalg.eigh(qm)
        if w[-1] <= 0:
            return None  # degenerate beyond repair
        floor = 2.0 * max(-w[0], 0.0) + 1e-12 * w[-1]
        _LOG.info(
            "Q_M indefinite at float64 (lambda_min %.3e vs lambda_max %.3e): "
            "clamping %d noise-dominated eigenvalues up to %.3e (see "
            "spgp_prepare_exact_host)", w[0], w[-1], int((w < floor).sum()),
            floor)
        qm = (v * np.maximum(w, floor)) @ v.T
        L = np.linalg.cholesky(qm)
    a = scipy.linalg.solve_triangular(L, al, lower=True)
    a = scipy.linalg.solve_triangular(L.T, a, lower=False)
    return back(L), back(a)


def spgp_predict(state: SpGpState, L_qm, alpha_solved, xq, scale, *,
                 kernel: str, with_grad: bool = False, with_var: bool = True,
                 zero_threshold: float = 0.0, li_qm=None):
    """mean (m_q, q), grad (m_q, d, q) | None, var (m_q,) | None.

    ``with_grad``: the cross gram takes the queries' gradient columns too
    (``kernels/gradient.py``; a family without a gradient gram, OU, raises
    there). ``li_qm``: optional chol(Q_M)^{-1}, which turns the variance
    whitening into a product (see :func:`fitc_variance`)."""
    mq, d = xq.shape
    if with_grad:
        m = state.pseudo.shape[0]
        kt = cross_gram_with_gradient(
            kernel, state.pseudo, xq, scale,
            torch.ones(m, dtype=torch.bool, device=xq.device),
            torch.zeros(m, dtype=torch.bool, device=xq.device),
            with_test_grad=True, with_train_grad=False)
    else:
        kt = cross_gram(kernel, state.pseudo, xq, scale)
    if zero_threshold:
        kt = torch.where(torch.abs(kt) >= zero_threshold, kt,
                         torch.zeros_like(kt))
    mean = kt[:, :mq].T @ alpha_solved
    grad = None
    if with_grad:
        g = kt[:, mq:].T @ alpha_solved                       # (d mq, q)
        grad = g.reshape(d, mq, -1).permute(1, 0, 2)          # (mq, d, q)
    var = fitc_variance(state.L_inv, L_qm, kt[:, :mq], li_qm=li_qm) \
        if with_var else None
    return mean, grad, var


def fitc_variance(L_inv, L_qm, kmean, li_qm=None):
    """FITC predictive variance 1 - ||L_km^{-1}k*||^2 + ||L_qm^{-1}k*||^2,
    clamped at 0. gamma is the product ``li_qm @ kmean`` when the cached
    inverse is given, else the exact triangular solve."""
    beta = L_inv @ kmean
    if li_qm is not None:
        gamma = li_qm @ kmean
    else:
        gamma = torch.linalg.solve_triangular(L_qm, kmean, upper=False)
    return torch.clamp(1.0 - torch.sum(beta * beta, dim=0)
                       + torch.sum(gamma * gamma, dim=0), min=0.0)


@dataclasses.dataclass
class SpGpSetting:
    """Mirror of SparsePseudoInputGaussianProcess::Setting. ``use_sparse``
    runs the thresholded math as a masked dense computation."""

    kernel_type: str = "rbf"
    kernel: KernelSetting = dataclasses.field(default_factory=KernelSetting)
    max_num_samples: int = 256
    sparse_zero_threshold: float = 1e-6
    use_sparse: bool = False
    diagonal_qm: bool = False

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        d.pop("kernel_setting_type", None)
        if "kernel" in d:
            d["kernel"] = KernelSetting.from_dict(d["kernel"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class SpGpTestResult:
    """Predictions at a batch of test points (tensors on the model's
    device)."""

    def __init__(self, gp: "SparsePseudoInputGaussianProcess", xq,
                 will_predict_gradient: bool):
        L_qm, a = gp._prepared()
        # float32 serving whitens the variance against the cached
        # chol(Q_M)^{-1}; float64 keeps the exact solve
        li = gp._prepared_inv() if gp.dtype == torch.float32 else None
        self._mean, self._grad, self._var = spgp_predict(
            gp.state, L_qm, a, xq, gp._scale, kernel=gp._kernel,
            with_grad=will_predict_gradient, with_var=True,
            zero_threshold=gp._zero_threshold, li_qm=li)
        self.num_test = xq.shape[0]

    def get_mean(self, y_index: int = 0) -> torch.Tensor:
        return self._mean[:, y_index]

    def get_gradient(self, y_index: int = 0) -> torch.Tensor:
        """The mean's gradient at each query, (d, m); needs
        ``predict_gradient=True`` at ``test``."""
        if self._grad is None:
            raise ValueError("get_gradient: test(..., predict_gradient=True) "
                             "computes the gradient")
        return self._grad[:, :, y_index].T

    def get_variance(self) -> torch.Tensor:
        return self._var


class SparsePseudoInputGaussianProcess:
    """Stateful wrapper mirroring the reference API. ``pseudo_points`` is
    (d, M) column-major as in the reference constructor; every tensor of
    the model lives on ``device``."""

    Setting = SpGpSetting
    TestResult = SpGpTestResult

    def __init__(self, setting: Optional[SpGpSetting], pseudo_points,
                 dtype=torch.float64, y_dim: int = 1,
                 device=DEFAULT_DEVICE):
        use_full_fp32_matmul()
        self.setting = setting or SpGpSetting()
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self._set_setting(self.setting)
        np_dt = numpy_dtype(self.dtype)
        p = np.asarray(pseudo_points, np_dt)
        if p.ndim == 1:
            p = p[None, :]
        self._y_dim = y_dim
        pr = np.ascontiguousarray(p.T)                # (M, d)
        self._m_valid = pr.shape[0]
        if self.dtype == torch.float32:
            # far-point padding is exact (see pad_pseudo_points); it keeps
            # the float32 shapes of the JAX package's states
            pr = pad_pseudo_points(pr)
        self.state = spgp_init(
            torch.tensor(pr, device=self.device), self._scale,
            kernel=self._kernel, diagonal_qm=self.setting.diagonal_qm,
            y_dim=y_dim)
        self._trained = False
        self._cache = None
        self._li = None

    def _set_setting(self, setting: SpGpSetting) -> None:
        self.setting = setting
        self._zero_threshold = (float(setting.sparse_zero_threshold)
                                if setting.use_sparse else 0.0)
        self._kernel = resolve_kernel_setting(
            setting.kernel_type, setting.kernel,
            "SparsePseudoInputGaussianProcess")
        self._scale = float(setting.kernel.scale)

    # -- accessors mirroring the reference ---------------------------------
    @property
    def is_trained(self):
        return self._trained

    @property
    def num_pseudo_points(self):
        return self._m_valid

    @property
    def pseudo_points(self):
        return self.state.pseudo[: self._m_valid].T

    @property
    def mat_l_km(self):
        m = self._m_valid
        return self.state.L_km[:m, :m]

    @property
    def mat_qm(self):
        m = self._m_valid
        q = self.state.qm
        return q[:m] if self.setting.diagonal_qm else q[:m, :m]

    @property
    def mat_alpha(self):
        return self.state.alpha[: self._m_valid]

    @property
    def mat_l_qm(self):
        m = self._m_valid
        return self._prepared()[0][:m, :m]

    def invalidate(self) -> None:
        """Drop the prepared factor after the state changed."""
        self._cache = None
        self._li = None

    def _prepared(self):
        """Lazily-cached (chol(Q_M), Q_M^{-1} alpha), three tiers:

        1. the Cholesky on the device at the state dtype, kept if finite
           and its squared pivot ratio (max diag(L) / min diag(L))^2 is
           within :func:`gp_core.cond_escalate_threshold`;
        2. else the exact float64 host refactorization from the
           compensated accumulators (posterior unchanged, INFO log);
        3. only if that fails too: the escalating jitter ladder, which
           changes the effective noise and warns."""
        if self._cache is not None:
            return self._cache
        diag = self.setting.diagonal_qm
        r = spgp_prepare(self.state, 0.0, diagonal_qm=diag)
        ok = bool(torch.isfinite(r[1]).all())
        if ok and not diag:
            dl = torch.abs(torch.diagonal(r[0])).double().cpu().numpy()
            dmin = dl.min()
            ok = dmin > 0 and (dl.max() / dmin) ** 2 <= \
                cond_escalate_threshold(numpy_dtype(self.dtype))
        if ok:
            self._cache = r
            return r
        exact = spgp_prepare_exact_host(self.state, diagonal_qm=diag)
        if exact is not None and bool(torch.isfinite(exact[1]).all()):
            _LOG.info(
                "chol(Q_M) numerically indefinite or ill-conditioned at %s — "
                "exact float64 host refactorization from the compensated "
                "accumulators (posterior unchanged; see "
                "spgp_prepare_exact_host)", self.dtype)
            self._cache = exact
        else:
            self._cache = host_jitter_retry(
                lambda j: spgp_prepare(self.state, j, diagonal_qm=diag),
                lambda r: (r[1],), jitters=(1e-10, 1e-8, 1e-6, 1e-4, 1e-2))
        return self._cache

    def _prepared_inv(self):
        """chol(Q_M)^{-1}, cached per prepared factor (keyed on its
        identity, so whatever refreshes ``_prepared`` refreshes this)."""
        L_qm, _ = self._prepared()
        if self._li is None or self._li[0] is not L_qm:
            self._li = (L_qm, tri_inv(L_qm))
        return self._li[1]

    def update(self, x, y, var) -> bool:
        """Accumulate one batch. x (d, n); y (n, q) or (n,); var (n,) or
        scalar (reference: Update -> UpdateDense)."""
        np_dt = numpy_dtype(self.dtype)
        x = np.asarray(x, np_dt)
        if x.ndim == 1:
            x = x[None, :]
        n = x.shape[1]
        if n == 0:
            return False
        y = np.asarray(y, np_dt)
        if y.ndim == 1:
            y = y[:, None]
        var = np.broadcast_to(np.asarray(var, np_dt), (n,))
        nmax = max(self.setting.max_num_samples, n)
        xp = np.zeros((nmax, x.shape[0]), np_dt)
        xp[:n] = x.T
        yp = np.zeros((nmax, y.shape[1]), np_dt)
        yp[:n] = y
        vp = np.zeros((nmax,), np_dt)
        vp[:n] = var
        mask = np.zeros((nmax,), bool)
        mask[:n] = True
        dev = self.device
        self.state = spgp_update(
            self.state, torch.as_tensor(xp, device=dev),
            torch.as_tensor(yp, device=dev), torch.as_tensor(vp, device=dev),
            torch.as_tensor(mask, device=dev), self._scale,
            kernel=self._kernel, diagonal_qm=self.setting.diagonal_qm,
            zero_threshold=self._zero_threshold)
        self._trained = True
        self.invalidate()
        return True

    def test(self, mat_x_test, predict_gradient: bool = False
             ) -> SpGpTestResult:
        xq = np.asarray(mat_x_test, numpy_dtype(self.dtype))
        if xq.ndim == 1:
            xq = xq[None, :]
        return SpGpTestResult(
            self, torch.as_tensor(np.ascontiguousarray(xq.T),
                                  device=self.device), predict_gradient)

    def get_memory_usage(self) -> int:
        """Bytes held by the state's tensors."""
        from erl_gaussian_process_tpu_torch.utils.timing import memory_usage

        return memory_usage(self.state)

    # -- checkpoint ---------------------------------------------------------
    def state_dict(self):
        """Checkpoint dict; the state arrays are host numpy copies."""
        return {
            "setting": self.setting.to_dict(),
            "trained": self._trained,
            "y_dim": self._y_dim,
            "m_valid": self._m_valid,
            "state": {k: v.detach().cpu().numpy()
                      for k, v in self.state._asdict().items()},
        }

    def load_state_dict(self, d):
        self._set_setting(SpGpSetting.from_dict(d["setting"]))
        self._trained = bool(d["trained"])
        self._y_dim = int(d["y_dim"])
        self._m_valid = int(d.get("m_valid", len(d["state"]["pseudo"])))
        self.state = state_from_numpy(d["state"], self.device)
        self.dtype = self.state.qm.dtype
        self.invalidate()

    def save(self, path):
        save_pytree(path, self.state_dict())

    def load(self, path):
        self.load_state_dict(load_pytree(path))

    def __eq__(self, other):
        if not isinstance(other, SparsePseudoInputGaussianProcess):
            return NotImplemented
        return eq_state(self.state_dict(), other.state_dict())
