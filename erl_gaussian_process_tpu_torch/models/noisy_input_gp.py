"""GP with noisy inputs and optional per-sample gradient observations
(counterpart of ``erl_gaussian_process_tpu/models/noisy_input_gp.py``;
reference: NoisyInputGaussianProcess, src/noisy_input_gp.cpp).

The joint value/gradient layout and noise placement are those of
``kernels/gradient.py``. Per-sample ``grad_flag`` is a boolean mask over
fixed gradient slots (one per sample per dim): unflagged slots are identity
rows with zero alpha, which reproduces the reference's packed system.

Fits: with gradients, the joint gram is built per tile inside the blocked
Cholesky (``ops/chol.chol_blocked_gram_joint``) for rbf and matern32; other
kernels (scale mixtures) build it with ``train_gram_with_gradient`` and
factor it by ``gp_core.cholesky_fit(robust=False)``'s route (the blocked
Cholesky of a given matrix), as the JAX package splits them. Without gradients the
value gram is fused (``chol_blocked_gram``). The solve is the blocked
substitution in every case.

Predictive quantities (reference formulas):
- mean:          k*^T alpha
- gradient:      grad-column dot alpha
- mean var:      1 - ||L^{-1} k*||^2
- grad var:      3/s^2 - ||L^{-1} k*_grad||^2  (the 3/s^2 quirk)
- mean/grad cov: lower triangle of -(L^{-1}k*_j)^T (L^{-1}k*_k)

A reduced-rank kernel type fits the joint value/gradient information
system of its Hilbert basis (:func:`nigp_rr_fit`; gradient observations
are linear observations of the basis weights) by
``gp_core.cholesky_fit(robust=False)``'s route, and every variance and
covariance above takes the opposite sign (``+||.||^2``).

On a CUDA device each fit, each test (ktest, the mean and the gradient,
:func:`nigp_test_step`) and each variance query is one replay of a CUDA
graph (``models/exact_graph.py``), as each is one jit in the JAX package;
the model's state is then the fit graph's buffers.

Spans (``utils.timing.span``): ``egp.nigp.train`` (a fit, either form,
with ``egp.nigp.inputs``, the reset and the padded host arrays, and the
jitter retry's ``egp.fit.check``), ``egp.nigp.test`` (a test's feed and
replay), ``egp.nigp.mean``, ``egp.nigp.gradient`` and
``egp.nigp.variance`` (the first variance, gradient variance or
covariance read, which whitens; each with ``egp.nigp.readback``, its
copy to the host). Counters: ``nigp.var_solve`` and ``nigp.var_product``,
the whitening that served a first variance read (the factor's
substitution or the product with L^-1).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.kernels import (
    KernelSetting,
    resolve_kernel_setting,
)
from erl_gaussian_process_tpu_torch.kernels.gradient import (
    cross_gram_with_gradient,
    gradient_prior_variance,
    train_gram_with_gradient,
)
from erl_gaussian_process_tpu_torch.kernels.reduced_rank import (
    rr_features,
    rr_features_with_grad,
    rr_joint_train_system,
    rr_ktest_joint,
    rr_train_system,
)
from erl_gaussian_process_tpu_torch.models.exact_graph import ExactGraphs
from erl_gaussian_process_tpu_torch.models.gp_core import (
    DEFAULT_DEVICE,
    host_jitter_retry,
    resolve_device,
    solve_with_L,
    use_full_fp32_matmul,
    whiten,
    with_tile_inverses,
)
from erl_gaussian_process_tpu_torch.ops.chol import (
    JOINT_FAMILIES,
    chol_blocked,
    chol_blocked_gram,
    chol_blocked_gram_joint,
)
from erl_gaussian_process_tpu_torch.models.vanilla_gp import (
    kernel_setting_from_dict,
    setup_reduced_rank,
)
from erl_gaussian_process_tpu_torch.utils.serialization import (
    eq_state,
    load_pytree,
    save_pytree,
)
from erl_gaussian_process_tpu_torch.utils.timing import count, span

_LOG = logging.getLogger("erl_gaussian_process_tpu_torch")


class NoisyInputGPState(NamedTuple):
    """x (n, d); masks (n,); L/alpha over the joint system (N = n if
    trained without gradient observations, else n(1+d)). ``dinv``: the
    blocked Cholesky's diagonal-tile inverses, which
    :func:`gp_core.whiten` uses at float32; not part of a checkpoint
    (rebuilt from L on load)."""

    x: torch.Tensor
    sample_mask: torch.Tensor
    grad_mask: torch.Tensor
    L: torch.Tensor
    alpha: torch.Tensor
    dinv: Optional[torch.Tensor] = None


def _masked(v, mask):
    return torch.where(mask, v, torch.zeros_like(v))


def pack_alpha(y, grad, sample_mask, grad_mask):
    """alpha rows = [y(n); dim-major gradient blocks], masked to zero.
    y (n, q); grad (n, d, q)."""
    n, d, q = grad.shape
    yv = _masked(y, sample_mask[:, None])
    gv = _masked(grad, grad_mask[:, None, None])
    return torch.cat([yv, gv.permute(1, 0, 2).reshape(d * n, q)], dim=0)


def nigp_fit(x, y, grad, var_x, var_y, var_grad, sample_mask, grad_mask,
             scale, *, kernel: str) -> NoisyInputGPState:
    """Train with gradient observations: joint gram, Cholesky, solve."""
    alpha = pack_alpha(y, grad, sample_mask, grad_mask)
    if kernel in JOINT_FAMILIES:
        L, dinv = chol_blocked_gram_joint(
            kernel, x, var_x + var_y, var_grad, sample_mask, grad_mask,
            scale, return_dinv=True)
        return NoisyInputGPState(x, sample_mask, grad_mask, L,
                                 solve_with_L(L, alpha, chol_dinv=dinv), dinv)
    K = train_gram_with_gradient(
        kernel, x, _masked(var_x, sample_mask), _masked(var_y, sample_mask),
        _masked(var_grad, grad_mask), sample_mask, grad_mask, scale)
    # gp_core.cholesky_fit(robust=False)'s route, keeping Dinv for whiten
    L, dinv = chol_blocked(K, return_dinv=True)
    return NoisyInputGPState(x, sample_mask, grad_mask, L,
                             solve_with_L(L, alpha, chol_dinv=dinv), dinv)


def nigp_fit_nograd(x, y, var_x, var_y, sample_mask, scale, *, kernel: str
                    ) -> NoisyInputGPState:
    """Train without gradient observations: the value gram with var = var_x
    + var_y."""
    var = _masked(var_x + var_y, sample_mask)
    yv = _masked(y, sample_mask[:, None])
    L, dinv = chol_blocked_gram(kernel, x, var, sample_mask, scale,
                                return_dinv=True)
    return NoisyInputGPState(x, sample_mask, torch.zeros_like(sample_mask), L,
                             solve_with_L(L, yv, chol_dinv=dinv), dinv)


def _rr_solve(x, A, b, sample_mask, grad_mask) -> NoisyInputGPState:
    L, dinv = chol_blocked(A, return_dinv=True)
    return NoisyInputGPState(x, sample_mask, grad_mask, L,
                             solve_with_L(L, b, chol_dinv=dinv), dinv)


def nigp_rr_fit(x, y, grad, var_x, var_y, var_grad, sample_mask, grad_mask,
                freq, sqrt_s, origin, half, inv_sqrt_vol
                ) -> NoisyInputGPState:
    """Reduced-rank train with gradient observations: the joint
    value/gradient information system
    (``kernels.reduced_rank.rr_joint_train_system``), L (m, m) with m =
    #basis."""
    phi, dphi = rr_features_with_grad(x, freq, sqrt_s, origin, half,
                                      inv_sqrt_vol)
    A, b = rr_joint_train_system(phi, dphi, y, grad, var_x + var_y,
                                 var_grad, sample_mask, grad_mask)
    return _rr_solve(x, A, b, sample_mask, grad_mask)


def nigp_rr_fit_nograd(x, y, var_x, var_y, sample_mask, freq, sqrt_s,
                       origin, half, inv_sqrt_vol) -> NoisyInputGPState:
    """Reduced-rank train without gradient observations: the plain
    information system with the value noise var_x + var_y."""
    phi = rr_features(x, sample_mask, freq, sqrt_s, origin, half,
                      inv_sqrt_vol)
    A, b = rr_train_system(phi, y, var_x + var_y, sample_mask)
    return _rr_solve(x, A, b, sample_mask, torch.zeros_like(sample_mask))


def nigp_ktest(state: NoisyInputGPState, xq, scale, *, kernel: str,
               with_test_grad: bool, with_train_grad: bool):
    return cross_gram_with_gradient(
        kernel, state.x, xq, scale, state.sample_mask, state.grad_mask,
        with_test_grad=with_test_grad, with_train_grad=with_train_grad)


def nigp_mean(state: NoisyInputGPState, ktest, num_test: int):
    """Means from the first num_test columns. Returns (m, q)."""
    return ktest[:, :num_test].mT @ state.alpha


def nigp_gradient(state: NoisyInputGPState, ktest, num_test: int, d: int):
    """Gradients from the dim-major columns m..m(1+d). Returns (m, d, q)."""
    g = ktest[:, num_test:num_test * (1 + d)].mT @ state.alpha   # (d*m, q)
    return g.reshape(d, num_test, -1).permute(1, 0, 2)


def nigp_test_step(state: NoisyInputGPState, xq, scale, *, kernel: str,
                   with_test_grad: bool, with_train_grad: bool, d: int):
    """``test``'s chain (:func:`nigp_ktest`, :func:`nigp_mean` and, with
    test gradients, :func:`nigp_gradient`): (ktest, the mean[, the
    gradient])."""
    ktest = nigp_ktest(state, xq, scale, kernel=kernel,
                       with_test_grad=with_test_grad,
                       with_train_grad=with_train_grad)
    return _test_outputs(state, ktest, xq.shape[0], with_test_grad, d)


def nigp_rr_test_step(state: NoisyInputGPState, xq, freq, sqrt_s, origin,
                      half, inv_sqrt_vol, *, with_test_grad: bool, d: int):
    """A reduced-rank model's ``test`` chain: ktest in the joint layout
    (``kernels.reduced_rank.rr_ktest_joint``, rows = #basis), the mean[,
    the gradient]."""
    ktest = rr_ktest_joint(xq, freq, sqrt_s, origin, half, inv_sqrt_vol,
                           with_test_grad=with_test_grad)
    return _test_outputs(state, ktest, xq.shape[0], with_test_grad, d)


def _test_outputs(state, ktest, num_test: int, with_test_grad: bool, d: int):
    mean = nigp_mean(state, ktest, num_test)
    if not with_test_grad:
        return ktest, mean
    return ktest, mean, nigp_gradient(state, ktest, num_test, d)


def _varcov_from_whitened(at, ktest, scale, d: int, reduced_rank: bool):
    m = ktest.shape[1] // (1 + d)
    cols = at.mT.reshape(1 + d, m, -1)             # (1+d, m, N)
    sq = torch.sum(cols * cols, dim=-1)            # (1+d, m)
    # clamped at 0 like gp_core.variance_from_whitened
    mean_var = sq[0] if reduced_rank else torch.clamp(1.0 - sq[0], min=0.0)
    gvar_prior = gradient_prior_variance(scale)
    grad_var = (sq[1:].mT if reduced_rank
                else torch.clamp(gvar_prior - sq[1:].mT, min=0.0))
    sign = 1.0 if reduced_rank else -1.0
    covs = []
    for j in range(d):
        covs.append(sign * torch.sum(cols[1 + j] * cols[0], dim=-1))
        for k in range(j):
            covs.append(sign * torch.sum(cols[1 + j] * cols[1 + k], dim=-1))
    cov = torch.stack(covs, dim=1) if covs else \
        torch.zeros((m, 0), dtype=at.dtype, device=at.device)
    return mean_var, grad_var, cov


def nigp_variance_cov(state: NoisyInputGPState, ktest, scale, *, d: int,
                      reduced_rank: bool = False):
    """(mean_var (m,), grad_var (m, d), cov (m, d(d+1)/2)) from the whitened
    L^{-1} ktest; cov rows in the reference's lower-triangle order
    [cov(g0,f), cov(g1,f), cov(g1,g0), cov(g2,f), ...]."""
    return _varcov_from_whitened(whiten(state.L, ktest, state.dinv), ktest,
                                 scale, d, reduced_rank)


def nigp_l_inv(state: NoisyInputGPState):
    """Explicit L^{-1} over the joint system for the repeated-query path."""
    n = state.L.shape[0]
    return whiten(state.L, torch.eye(n, dtype=state.L.dtype,
                                     device=state.L.device), state.dinv)


def nigp_variance_cov_fast(L_inv, ktest, scale, *, d: int,
                           reduced_rank: bool = False):
    return _varcov_from_whitened(L_inv @ ktest, ktest, scale, d,
                                 reduced_rank)


class NigpTrainSet:
    """Mirror of NoisyInputGaussianProcess::TrainSet: x (d, n), y (n, q),
    grad (d*q, n) output-major row blocks, var_x/var_y/var_grad (n,),
    grad_flag (n,), held padded on the host."""

    def __init__(self, xp, yp, gradp, vx, vy, vg, gmask, num_samples):
        self.xp, self.yp, self.gradp = xp, yp, gradp
        self.vx, self.vy, self.vg = vx, vy, vg
        self.gmask = gmask
        self.num_samples = int(num_samples)

    @property
    def x(self):
        return self.xp[:self.num_samples].T

    @property
    def y(self):
        return self.yp[:self.num_samples]

    @property
    def grad(self):
        n = self.num_samples
        _, d, q = self.gradp.shape
        return self.gradp[:n].transpose(0, 2, 1).reshape(n, q * d).T

    @property
    def var_x(self):
        return self.vx[:self.num_samples]

    @property
    def var_y(self):
        return self.vy[:self.num_samples]

    @property
    def var_grad(self):
        return self.vg[:self.num_samples]

    @property
    def grad_flag(self):
        return self.gmask[:self.num_samples]

    @property
    def x_dim(self):
        return self.xp.shape[1]

    @property
    def y_dim(self):
        return self.yp.shape[1]

    @property
    def sample_mask(self):
        m = np.zeros((self.xp.shape[0],), bool)
        m[:self.num_samples] = True
        return m

    @property
    def num_samples_with_grad(self):
        return int(np.asarray(self.gmask).sum())


@dataclasses.dataclass
class NoisyInputGPSetting:
    """Mirror of NoisyInputGaussianProcess::Setting."""

    kernel_type: str = "rbf"
    kernel: KernelSetting = dataclasses.field(default_factory=KernelSetting)
    max_num_samples: int = 256
    no_gradient_observation: bool = False

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        d.pop("kernel_setting_type", None)
        if "kernel" in d:
            d["kernel"] = kernel_setting_from_dict(d.get("kernel_type", ""),
                                                   d["kernel"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class NigpTestResult:
    """Lazy test result: ktest at construction, the whitening deferred to
    the first variance query. ``xq`` (m, d), a host array.

    On a model with graphs the construction replays the test graph (ktest,
    the mean and the gradient) and the first variance query a variance
    graph; ktest, the mean and the gradient are the graphs' buffers until
    another test of the same shape copies them out (``exact_graph.Held``).
    """

    def __init__(self, gp: "NoisyInputGaussianProcess", xq,
                 will_predict_gradient: bool):
        self._gp = gp
        self._xq = xq
        self._with_grad = will_predict_gradient
        self._varcov = None
        self._held = None
        with span("egp.nigp.test"):
            if gp._graphs is not None:
                self._held = gp._graphs.test(
                    gp.state, *gp._test_step(will_predict_gradient), xq,
                    gp._rr_consts())
            elif gp._basis is not None:
                # rows = #basis, columns in the same joint layout
                self._ktest_eager = rr_ktest_joint(
                    gp._tensor(xq), *gp._rr_consts(),
                    with_test_grad=will_predict_gradient)
            else:
                self._ktest_eager = nigp_ktest(
                    gp.state, gp._tensor(xq), gp._scale, kernel=gp._kernel,
                    with_test_grad=will_predict_gradient,
                    with_train_grad=not gp.setting.no_gradient_observation)

    @property
    def _ktest(self) -> torch.Tensor:
        return self._ktest_eager if self._held is None else self._held.ktest

    @property
    def num_test(self):
        return self._xq.shape[0]

    @property
    def k_test(self):
        return self._ktest.cpu().numpy()

    def get_mean(self, y_index: int = 0, parallel: bool = True):
        del parallel
        with span("egp.nigp.mean"):
            if ExactGraphs.serves(self._held, self._gp.state):
                mean = self._held.outputs[1]
            else:
                mean = nigp_mean(self._gp.state, self._ktest, self.num_test)
            with span("egp.nigp.readback"):
                return mean[:, y_index].cpu().numpy()

    def get_gradient(self, y_index: int = 0, parallel: bool = True):
        del parallel
        assert self._with_grad, "TestResult built without gradient support"
        with span("egp.nigp.gradient"):
            if ExactGraphs.serves(self._held, self._gp.state):
                g = self._held.outputs[2]
            else:
                g = nigp_gradient(self._gp.state, self._ktest, self.num_test,
                                  self._gp._x_dim)
            with span("egp.nigp.readback"):
                # (d, m) as the reference
                return g[:, :, y_index].mT.cpu().numpy()

    def _prepare(self):
        """(mean_var, grad_var, cov) on the host, whitened at the first
        read (counted by the whitening that served it)."""
        if self._varcov is None:
            with span("egp.nigp.variance"):
                out = self._variance_cov()
                with span("egp.nigp.readback"):
                    self._varcov = tuple(t.cpu() for t in out)
        return self._varcov

    def _variance_cov(self):
        gp = self._gp
        d = gp._x_dim if self._with_grad else 0
        rr = gp.reduced_rank_kernel
        gp._var_queries += 1
        # the product whitening only beats the solve while the query batch
        # is thin
        fast = gp._var_queries >= 2 and self._ktest.shape[1] <= 512
        count("nigp.var_product" if fast else "nigp.var_solve")
        if fast and gp._L_inv is None:
            gp._L_inv = gp._l_inv()
        if ExactGraphs.serves(self._held, gp.state):
            body = nigp_variance_cov_fast if fast else nigp_variance_cov
            return gp._graphs.variance(
                self._held, "fast" if fast else "variance",
                functools.partial(body, scale=gp._scale, d=d,
                                  reduced_rank=rr),
                gp._L_inv if fast else None)
        if fast:
            return nigp_variance_cov_fast(gp._L_inv, self._ktest, gp._scale,
                                          d=d, reduced_rank=rr)
        return nigp_variance_cov(gp.state, self._ktest, gp._scale, d=d,
                                 reduced_rank=rr)

    def get_mean_variance(self, parallel: bool = True):
        del parallel
        return self._prepare()[0].numpy()

    def get_gradient_variance(self, parallel: bool = True):
        del parallel
        assert self._with_grad
        return self._prepare()[1].mT.numpy()   # (d, m)

    def get_covariance(self, parallel: bool = True):
        """Lower-triangle covariances, (d(d+1)/2, m)."""
        del parallel
        assert self._with_grad
        return self._prepare()[2].mT.numpy()


class NoisyInputGaussianProcess:
    """Stateful wrapper mirroring the reference binding API. Reference
    layout: x (d, n), y (n, q), grad (d*q, n), var_* (n,), grad_flag (n,).
    The state lives on ``device``; on a CUDA device it is the fit graph's
    buffers (``models/exact_graph.py``), which the next fit overwrites:
    copy what you keep (``state_dict`` returns copies)."""

    Setting = NoisyInputGPSetting
    TestResult = NigpTestResult
    TrainSet = NigpTrainSet

    def __init__(self, setting: Optional[NoisyInputGPSetting] = None,
                 dtype=np.float64, device=DEFAULT_DEVICE):
        use_full_fp32_matmul()
        self.setting = setting or NoisyInputGPSetting()
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self.state: Optional[NoisyInputGPState] = None
        self._setup_kernel()
        self._trained = False
        self._x_dim = 0
        self._y_dim = 0
        self._L_inv = None
        self._var_queries = 0
        self._train_set: Optional[NigpTrainSet] = None
        self._graphs = ExactGraphs(self.device) \
            if self.device.type == "cuda" else None

    def _setup_kernel(self):
        """Resolve the kernel family; a reduced-rank kernel type builds its
        basis."""
        self._scale = float(self.setting.kernel.scale)
        self.setting.kernel, self._basis = setup_reduced_rank(
            self.setting.kernel_type, self.setting.kernel, self.dtype,
            "NoisyInputGaussianProcess")
        if self._basis is not None:
            self._kernel = self.setting.kernel.base_kernel
        else:
            self._kernel = resolve_kernel_setting(
                self.setting.kernel_type, self.setting.kernel,
                "NoisyInputGaussianProcess")
        self.reduced_rank_kernel = self._basis is not None

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), device=self.device)

    def using_reduced_rank_kernel(self) -> bool:
        return self.reduced_rank_kernel

    def get_kernel_coord_origin(self):
        assert self._basis is not None, "not a reduced-rank kernel"
        return self._basis.coord_origin

    def set_kernel_coord_origin(self, origin):
        assert self._basis is not None, "not a reduced-rank kernel"
        self._basis.set_coord_origin(origin)

    @property
    def is_trained(self):
        return self._trained

    def get_train_set(self) -> Optional[NigpTrainSet]:
        return self._train_set

    @property
    def train_set(self) -> Optional[NigpTrainSet]:
        return self._train_set

    @property
    def kernel(self):
        """The kernel's setting (hyperparameters)."""
        return self.setting.kernel

    @property
    def kernel_origin(self):
        return self.get_kernel_coord_origin()

    @kernel_origin.setter
    def kernel_origin(self, origin):
        self.set_kernel_coord_origin(origin)

    @property
    def alpha(self):
        """Solved weights over the joint system."""
        return None if self.state is None else \
            self.state.alpha.cpu().numpy()

    @property
    def cholesky_k_train(self):
        """Lower Cholesky factor of the joint train gram."""
        return None if self.state is None else self.state.L.cpu().numpy()

    @property
    def k_train(self):
        """The joint train gram that was factored, as L L^T of the stored
        factor (so it includes any host jitter escalation)."""
        if self.state is None:
            return None
        L = self.state.L
        return (L @ L.mT).cpu().numpy()

    @property
    def memory_usage(self) -> int:
        return self.get_memory_usage()

    def update_ktrain(self) -> bool:
        """Recompute the joint gram, factor and solve from the stored train
        set."""
        return self._fit_train_set()

    def reset(self, max_num_samples: int, x_dim: int, y_dim: int):
        """Size the padded buffers and drop the trained state (the stored
        train set survives)."""
        self.setting.max_num_samples = int(max_num_samples)
        del x_dim, y_dim  # shapes are taken from the data at train()
        self._trained = False
        self.state = None
        self._L_inv = None
        self._var_queries = 0

    def _fit_train_set(self) -> bool:
        """The C++ Train() body, empty-data guarded, with the host jitter
        retry."""
        ts = self._train_set
        if ts is None or ts.num_samples <= 0:
            _LOG.warning("num_samples = %d, it should be > 0.",
                         0 if ts is None else ts.num_samples)
            return False
        self._x_dim, self._y_dim = ts.x_dim, ts.y_dim
        jit = self.dtype.type
        rr = self._basis is not None
        kw = {} if rr else dict(scale=self._scale, kernel=self._kernel)
        if self.setting.no_gradient_observation:
            body = nigp_rr_fit_nograd if rr else nigp_fit_nograd

            def feeds(j):
                return ts.xp, ts.yp, ts.vx, ts.vy + jit(j), ts.sample_mask
        else:
            body = nigp_rr_fit if rr else nigp_fit

            def feeds(j):
                return (ts.xp, ts.yp, ts.gradp, ts.vx, ts.vy + jit(j),
                        ts.vg + jit(j), ts.sample_mask, ts.gmask)
        static = (body.__name__, *kw.values())
        body = functools.partial(body, **kw)
        consts = self._rr_consts()
        self.state = host_jitter_retry(
            lambda j: self._fit(static, body, feeds(j), consts),
            lambda st: (st.alpha,))
        self._trained = True
        self._L_inv = None
        self._var_queries = 0
        return True

    def train(self, mat_x=None, mat_y=None, mat_grad=None, var_x=None,
              var_y=None, var_grad=None, grad_flag=None) -> bool:
        """``train()`` with no arguments is the C++ ``Train()`` (already
        trained: warn and return False; empty train set: warn and return
        False); ``train(x, y, ...)`` is the binding's (reset + store +
        Train). x (d, n); y (n, q) or (n,); grad (d*q, n), output-major row
        blocks of size d."""
        with span("egp.nigp.train"):
            if mat_x is None:
                if self._trained:
                    _LOG.warning("The model has been trained. Please reset "
                                 "the model before training.")
                    return False
                return self._fit_train_set()
            with span("egp.nigp.inputs"):
                self._store_train_set(mat_x, mat_y, mat_grad, var_x, var_y,
                                      var_grad, grad_flag)
            return self._fit_train_set()

    def _store_train_set(self, mat_x, mat_y, mat_grad, var_x, var_y,
                         var_grad, grad_flag) -> None:
        """``train(x, y, ...)``'s reset and padded host arrays."""
        x = np.asarray(mat_x, self.dtype)
        if x.ndim == 1:
            x = x[None, :]
        d, n = x.shape
        y = np.asarray(mat_y, self.dtype)
        if y.ndim == 1:
            y = y[:, None]
        q = y.shape[1]
        nmax = max(self.setting.max_num_samples, max(n, 1))
        if self.dtype == np.float32 and nmax >= 256:
            # the sample budget padded to a multiple of 128, as in the JAX
            # package (its states and checkpoints keep those shapes);
            # padded rows are masked identity rows, so posteriors are
            # unchanged
            nmax = -(-nmax // 128) * 128
        self.reset(nmax, d, q)
        self._x_dim, self._y_dim = d, q

        def padv(v):
            out = np.zeros((nmax,), self.dtype)
            if v is not None:
                out[:n] = np.broadcast_to(np.asarray(v, self.dtype), (n,))
            return out

        xp = np.zeros((nmax, d), self.dtype)
        xp[:n] = x.T
        yp = np.zeros((nmax, q), self.dtype)
        yp[:n] = y
        gmask = np.zeros((nmax,), bool)
        gradp = np.zeros((nmax, d, q), self.dtype)
        if not self.setting.no_gradient_observation:
            gmask[:n] = True if grad_flag is None else \
                np.asarray(grad_flag).astype(bool)[:n]
            if mat_grad is not None:
                g = np.asarray(mat_grad, self.dtype)
                if g.ndim == 1:
                    g = g[None, :]
                gradp[:n] = g.T.reshape(n, q, d).transpose(0, 2, 1)
        self._train_set = NigpTrainSet(xp, yp, gradp, padv(var_x),
                                       padv(var_y), padv(var_grad), gmask, n)

    def _rr_consts(self) -> tuple:
        """A reduced-rank basis's constants on the device, else ()."""
        return () if self._basis is None else self._basis.consts(self.device)

    def _fit(self, static: tuple, body, feeds: tuple, consts: tuple):
        """``body(*feeds, *consts)``: one replay of its graph on a model with
        graphs, else on new tensors of the host arrays ``feeds``."""
        if self._graphs is not None:
            return self._graphs.fit(static, body, feeds, consts)
        return body(*map(self._tensor, feeds), *consts)

    def _test_step(self, with_test_grad: bool) -> tuple:
        """(the key of a test graph, less the queries' shape, and its body
        (:func:`nigp_test_step` or :func:`nigp_rr_test_step`))."""
        rr = self._basis is not None
        with_train_grad = not self.setting.no_gradient_observation
        if rr:
            body = functools.partial(nigp_rr_test_step,
                                     with_test_grad=with_test_grad,
                                     d=self._x_dim)
        else:
            body = functools.partial(
                nigp_test_step, scale=self._scale, kernel=self._kernel,
                with_test_grad=with_test_grad,
                with_train_grad=with_train_grad, d=self._x_dim)
        return ("nigp", self._kernel, self._scale, with_test_grad,
                with_train_grad, rr), body

    def _l_inv(self) -> torch.Tensor:
        """L^-1 of the joint system (:func:`nigp_l_inv`), through its graph
        on a model with graphs."""
        if self._graphs is not None:
            return self._graphs.l_inv(self.state, nigp_l_inv)
        return nigp_l_inv(self.state)

    def test(self, mat_x_test, predict_gradient: bool = False
             ) -> Optional[NigpTestResult]:
        if not self._trained:
            return None
        xq = np.asarray(mat_x_test, self.dtype)
        if xq.ndim == 1:
            xq = xq[None, :]
        return NigpTestResult(self, np.ascontiguousarray(xq.T),
                              predict_gradient)

    def get_memory_usage(self) -> int:
        """Bytes held by the state's tensors."""
        return 0 if self.state is None else sum(
            t.nbytes for t in self.state if t is not None)

    # -- checkpoint --------------------------------------------------------
    def state_dict(self):
        ts = self._train_set
        return {
            "setting": self.setting.to_dict(),
            "trained": self._trained,
            "x_dim": self._x_dim,
            "y_dim": self._y_dim,
            "state": None if self.state is None else {
                k: v.detach().to("cpu", copy=True).numpy()
                for k, v in self.state._asdict().items() if k != "dinv"},
            "train_set": None if ts is None else {
                "x": ts.xp, "y": ts.yp, "grad": ts.gradp,
                "var_x": ts.vx, "var_y": ts.vy, "var_grad": ts.vg,
                "grad_flag": ts.gmask, "num_samples": ts.num_samples},
        }

    def load_state_dict(self, dd):
        """Load a ``state_dict``; a model with graphs drops them (its state
        is then the loaded tensors)."""
        if self._graphs is not None:
            self._graphs.clear()
        self.setting = NoisyInputGPSetting.from_dict(dd["setting"])
        self._setup_kernel()
        self._trained = bool(dd["trained"])
        self._x_dim = int(dd["x_dim"])
        self._y_dim = int(dd["y_dim"])
        s = dd["state"]
        self.state = None if s is None else with_tile_inverses(
            NoisyInputGPState(**{k: self._tensor(s[k])
                                 for k in NoisyInputGPState._fields
                                 if k != "dinv"}))
        ts = dd.get("train_set")
        self._train_set = None if ts is None else NigpTrainSet(
            np.asarray(ts["x"]), np.asarray(ts["y"]), np.asarray(ts["grad"]),
            np.asarray(ts["var_x"]), np.asarray(ts["var_y"]),
            np.asarray(ts["var_grad"]), np.asarray(ts["grad_flag"]),
            int(ts["num_samples"]))
        self._L_inv = None
        self._var_queries = 0

    def save(self, path):
        save_pytree(path, self.state_dict())

    def load(self, path):
        self.load_state_dict(load_pytree(path))

    def __eq__(self, other):
        if not isinstance(other, NoisyInputGaussianProcess):
            return NotImplemented
        return eq_state(self.state_dict(), other.state_dict())
