"""Exact multi-output GP regression (counterpart of
``erl_gaussian_process_tpu/models/vanilla_gp.py``; reference:
VanillaGaussianProcess, src/vanilla_gp.cpp).

Functional core: :func:`vanilla_fit` (the gram-fused blocked Cholesky and
the blocked substitution, ``ops/chol.py`` + ``ops/trsv.py``),
:func:`vanilla_ktest` (the gram kernel), mean and variance. The
:class:`VanillaGaussianProcess` class mirrors the reference's Python API
(train/test/TestResult) over padded fixed-shape buffers on ``device``.
A reduced-rank kernel type (``reduced_rank_*``) fits the (m, m)
information system of its Hilbert basis instead (:func:`rr_fit`: the
blocked Cholesky and the blocked substitution, as the exact fit), and its
variance is ``+||.||^2``.

On a CUDA device each fit, each test (ktest and the mean,
:func:`vanilla_test_step`) and each variance query is one replay of a
CUDA graph (``models/exact_graph.py``), as each is one jit in the JAX
package; the model's state is then the fit graph's buffers.

Spans (``utils.timing.span``): ``egp.exact.train`` (a fit, with
``egp.exact.inputs``, the reset and the padded host arrays, and the
jitter retry's ``egp.fit.check``), ``egp.exact.test`` (a test's feed and
replay), ``egp.exact.mean`` and ``egp.exact.variance`` (each with
``egp.exact.readback``, its copy to the host). Counters: ``exact.var_solve``
and ``exact.var_product``, the whitening that served a variance query
(the factor's substitution or the product with L^-1).
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
    cross_gram,
    resolve_kernel_setting,
    validate_kernel_setting,
)
from erl_gaussian_process_tpu_torch.kernels.reduced_rank import (
    ReducedRankBasis,
    ReducedRankSetting,
    parse_reduced_rank_name,
    rr_features,
    rr_train_system,
)
from erl_gaussian_process_tpu_torch.models.exact_graph import ExactGraphs
from erl_gaussian_process_tpu_torch.models.gp_core import (
    DEFAULT_DEVICE,
    host_jitter_retry,
    mean_from_ktest,
    resolve_device,
    solve_with_L,
    use_full_fp32_matmul,
    variance_from_whitened,
    whiten,
    with_tile_inverses,
)
from erl_gaussian_process_tpu_torch.ops.chol import (
    chol_blocked,
    chol_blocked_gram,
)
from erl_gaussian_process_tpu_torch.utils.serialization import (
    eq_state,
    load_pytree,
    save_pytree,
)
from erl_gaussian_process_tpu_torch.utils.timing import count, span

_LOG = logging.getLogger("erl_gaussian_process_tpu_torch")


class VanillaGPState(NamedTuple):
    """Trained GP; shapes static (padded to max_num_samples): x (n, d), mask
    (n,) bool, L (n, n), alpha (n, y_dim). ``dinv``: the blocked
    Cholesky's diagonal-tile inverses, which :func:`gp_core.whiten` uses at
    float32; not part of a checkpoint (rebuilt from L on load)."""

    x: torch.Tensor
    mask: torch.Tensor
    L: torch.Tensor
    alpha: torch.Tensor
    dinv: Optional[torch.Tensor] = None


def vanilla_fit(x, y, var, mask, scale, *, kernel: str) -> VanillaGPState:
    """Train: gram + noise diagonal (identity-padded) -> Cholesky -> alpha.
    x (n, d); y (n, y_dim); var (n,); mask (n,) bool. The gram is built per
    tile inside the factorization (``chol_blocked_gram``), whose
    diagonal-tile inverses feed the substitution."""
    y = torch.where(mask[:, None], y, torch.zeros_like(y))
    L, dinv = chol_blocked_gram(kernel, x, var, mask, scale, return_dinv=True)
    return VanillaGPState(x=x, mask=mask, L=L,
                          alpha=solve_with_L(L, y, chol_dinv=dinv), dinv=dinv)


def vanilla_ktest(state: VanillaGPState, xq, scale, *, kernel: str):
    """Cross gram (n, m); masked train rows zeroed."""
    return cross_gram(kernel, state.x, xq, scale, mask1=state.mask)


def vanilla_mean(state: VanillaGPState, ktest):
    return mean_from_ktest(ktest, state.alpha)


def vanilla_test_step(state: VanillaGPState, xq, scale, *, kernel: str):
    """``test``'s chain (:func:`vanilla_ktest`, :func:`vanilla_mean`): (ktest,
    the mean)."""
    ktest = vanilla_ktest(state, xq, scale, kernel=kernel)
    return ktest, vanilla_mean(state, ktest)


def rr_test_step(state: VanillaGPState, xq, freq, sqrt_s, origin, half,
                 inv_sqrt_vol):
    """A reduced-rank model's ``test`` chain: (the whitened features of the
    queries as ktest, rows = #basis, the mean)."""
    mask = torch.ones(xq.shape[:-1], dtype=torch.bool, device=xq.device)
    ktest = rr_features(xq, mask, freq, sqrt_s, origin, half,
                        inv_sqrt_vol).mT
    return ktest, vanilla_mean(state, ktest)


def vanilla_variance(state: VanillaGPState, ktest, *, reduced_rank=False):
    return variance_from_whitened(whiten(state.L, ktest, state.dinv),
                                  reduced_rank)


def vanilla_l_inv(state: VanillaGPState):
    """Explicit L^{-1} for the repeated-query path: computed once (from the
    second variance query on); every later query batch whitens with a
    product instead of a triangular solve."""
    n = state.L.shape[0]
    return whiten(state.L, torch.eye(n, dtype=state.L.dtype,
                                     device=state.L.device), state.dinv)


def vanilla_variance_fast(L_inv, ktest, *, reduced_rank=False):
    return variance_from_whitened(L_inv @ ktest, reduced_rank)


def vanilla_predict(state: VanillaGPState, xq, scale, *, kernel: str,
                    reduced_rank: bool = False):
    """Mean and variance of one query batch."""
    ktest = vanilla_ktest(state, xq, scale, kernel=kernel)
    return (mean_from_ktest(ktest, state.alpha),
            variance_from_whitened(whiten(state.L, ktest, state.dinv),
                                   reduced_rank))


def rr_fit(x, y, var, mask, freq, sqrt_s, origin, half, inv_sqrt_vol
           ) -> VanillaGPState:
    """Reduced-rank train: features -> (m, m) information matrix ->
    Cholesky, by ``gp_core.cholesky_fit(robust=False)``'s route (the
    blocked Cholesky and the blocked substitution), keeping the factor's
    Dinv for :func:`gp_core.whiten`. L is (m, m) and alpha (m, y_dim),
    m = #basis."""
    phi = rr_features(x, mask, freq, sqrt_s, origin, half, inv_sqrt_vol)
    A, b = rr_train_system(phi, y, var, mask)
    L, dinv = chol_blocked(A, return_dinv=True)
    return VanillaGPState(x=x, mask=mask, L=L,
                          alpha=solve_with_L(L, b, chol_dinv=dinv), dinv=dinv)


class VanillaTrainSet:
    """Mirror of VanillaGaussianProcess::TrainSet: ``x`` (x_dim, n)
    column-major, ``y`` (n, y_dim), ``var`` (n,), held as padded host
    arrays so a checkpointed model can be retrained."""

    def __init__(self, xp: np.ndarray, yp: np.ndarray, vp: np.ndarray,
                 num_samples: int):
        self.xp, self.yp, self.vp = xp, yp, vp
        self.num_samples = int(num_samples)

    @property
    def x(self):
        return self.xp[:self.num_samples].T

    @property
    def y(self):
        return self.yp[:self.num_samples]

    @property
    def var(self):
        return self.vp[:self.num_samples]

    @property
    def x_dim(self):
        return self.xp.shape[1]

    @property
    def y_dim(self):
        return self.yp.shape[1]

    @property
    def mask(self):
        m = np.zeros((self.xp.shape[0],), bool)
        m[:self.num_samples] = True
        return m


@dataclasses.dataclass
class VanillaGPSetting:
    """Mirror of VanillaGaussianProcess::Setting."""

    kernel_type: str = "rbf"
    kernel: KernelSetting = dataclasses.field(default_factory=KernelSetting)
    max_num_samples: int = 256

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        d.pop("kernel_setting_type", None)  # reference YAML field, implied
        if "kernel" in d:
            d["kernel"] = kernel_setting_from_dict(d.get("kernel_type", ""),
                                                   d["kernel"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def kernel_setting_from_dict(kernel_type, d) -> KernelSetting:
    """A model setting's ``kernel`` entry: a ``ReducedRankSetting`` for a
    reduced-rank kernel type (whose family, when it names one, wins over
    ``base_kernel``), else a ``KernelSetting``."""
    rr = parse_reduced_rank_name(str(kernel_type))
    ks = (ReducedRankSetting if rr is not None else KernelSetting).from_dict(
        d or {})
    if rr:
        ks.base_kernel = rr
    return ks


def setup_reduced_rank(kernel_type, ks, dtype, context: str, defaults=None):
    """(setting, basis) of a model's kernel: for a reduced-rank kernel type
    the setting ``ks`` as a ``ReducedRankSetting`` (converted from a plain
    one), its ``base_kernel`` set from the type's family, ``defaults(ks)``
    applied (a sensor GP fills the fields left unset from its frame), and
    its basis; else (ks, None)."""
    rr_base = parse_reduced_rank_name(kernel_type)
    if rr_base is None:
        return ks, None
    validate_kernel_setting(ks, context)
    if not isinstance(ks, ReducedRankSetting):
        ks = ReducedRankSetting.from_dict(ks.to_dict())
    if rr_base:
        ks.base_kernel = rr_base
    if defaults is not None:
        defaults(ks)
    return ks, ReducedRankBasis(ks, dtype=dtype)


class VanillaTestResult:
    """Lazy test result (the reference's TestResult): ktest at
    construction, the whitening deferred to the first variance query. A
    reduced-rank model's ktest is the whitened feature matrix, rows =
    #basis. ``xq`` (m, x_dim), a host array.

    On a model with graphs the construction replays the test graph (ktest
    and the mean) and the first variance query a variance graph; ktest and
    the mean are the graphs' buffers until another test of the same shape
    copies them out (``exact_graph.Held``)."""

    def __init__(self, gp: "VanillaGaussianProcess", xq):
        self._gp = gp
        self._xq = xq
        self._mean = None
        self._var = None
        self._held = None
        with span("egp.exact.test"):
            if gp._graphs is not None:
                self._held = gp._graphs.test(gp.state, *gp._test_step(), xq,
                                             gp._rr_consts())
            elif gp._basis is not None:
                self._ktest_eager = gp._basis.features(gp._tensor(xq)).mT
            else:
                self._ktest_eager = vanilla_ktest(
                    gp.state, gp._tensor(xq), gp._scale, kernel=gp._kernel)

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
        with span("egp.exact.mean"):
            if self._mean is None:
                if ExactGraphs.serves(self._held, self._gp.state):
                    mean = self._held.outputs[1]
                else:
                    mean = vanilla_mean(self._gp.state, self._ktest)
                with span("egp.exact.readback"):
                    self._mean = mean.cpu()
            return self._mean[:, y_index].numpy()

    def get_variance(self, parallel: bool = True):
        del parallel
        with span("egp.exact.variance"):
            if self._var is None:
                self._var = self._variance()
            return self._var.numpy()

    def _variance(self) -> torch.Tensor:
        """The variance on the host, through the whitening that serves
        this query (counted by which)."""
        gp = self._gp
        rr = gp.reduced_rank_kernel
        gp._var_queries += 1
        # the product whitening only beats the solve while the query
        # batch is thin
        fast = gp._var_queries >= 2 and self._ktest.shape[1] <= 512
        count("exact.var_product" if fast else "exact.var_solve")
        if fast and gp._L_inv is None:
            gp._L_inv = gp._l_inv()
        if ExactGraphs.serves(self._held, gp.state):
            body = vanilla_variance_fast if fast else vanilla_variance
            var = gp._graphs.variance(
                self._held, "fast" if fast else "variance",
                functools.partial(body, reduced_rank=rr),
                gp._L_inv if fast else None)
        elif fast:
            var = vanilla_variance_fast(gp._L_inv, self._ktest,
                                        reduced_rank=rr)
        else:
            var = vanilla_variance(gp.state, self._ktest, reduced_rank=rr)
        with span("egp.exact.readback"):
            return var.cpu()


class VanillaGaussianProcess:
    """Stateful wrapper mirroring the reference class API. Inputs follow the
    reference layout: ``x`` (x_dim, n) column-major, ``y`` (n, y_dim),
    ``var`` (n,). The state lives on ``device``; on a CUDA device it is the
    fit graph's buffers (``models/exact_graph.py``), which the next fit
    overwrites: copy what you keep (``state_dict`` returns copies)."""

    Setting = VanillaGPSetting
    TestResult = VanillaTestResult
    TrainSet = VanillaTrainSet

    def __init__(self, setting: Optional[VanillaGPSetting] = None,
                 dtype=np.float64, device=DEFAULT_DEVICE):
        use_full_fp32_matmul()
        self.setting = setting or VanillaGPSetting()
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self.state: Optional[VanillaGPState] = None
        self._setup_kernel()
        self._trained = False
        self._n = 0
        self._x_dim = 0
        self._y_dim = 0
        self._L_inv = None
        self._var_queries = 0
        self._train_set: Optional[VanillaTrainSet] = None
        self._graphs = ExactGraphs(self.device) \
            if self.device.type == "cuda" else None

    def _setup_kernel(self):
        """Resolve the kernel family; a reduced-rank kernel type builds its
        basis (the reference's BuildSpectralDensities after create/load)."""
        self._scale = float(self.setting.kernel.scale)
        self.setting.kernel, self._basis = setup_reduced_rank(
            self.setting.kernel_type, self.setting.kernel, self.dtype,
            "VanillaGaussianProcess")
        if self._basis is not None:
            self._kernel = self.setting.kernel.base_kernel
        else:
            self._kernel = resolve_kernel_setting(
                self.setting.kernel_type, self.setting.kernel,
                "VanillaGaussianProcess")
        self.reduced_rank_kernel = self._basis is not None

    def get_coord_origin(self):
        assert self._basis is not None, "not a reduced-rank kernel"
        return self._basis.coord_origin

    def set_coord_origin(self, origin):
        assert self._basis is not None, "not a reduced-rank kernel"
        self._basis.set_coord_origin(origin)

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), device=self.device)

    @property
    def is_trained(self) -> bool:
        return self._trained

    def get_train_set(self) -> Optional[VanillaTrainSet]:
        return self._train_set

    def reset(self, max_num_samples: int, x_dim: int, y_dim: int):
        """Size the buffers and clear the trained flag; the stored train set
        survives."""
        self.setting.max_num_samples = int(max_num_samples)
        self._x_dim, self._y_dim = int(x_dim), int(y_dim)
        self._n = 0
        self._trained = False
        self.state = None
        self._L_inv = None
        self._var_queries = 0

    def _fit_train_set(self) -> bool:
        """The C++ Train() body: fit from the stored train set, with the
        empty-data guard and the host jitter retry."""
        ts = self._train_set
        if ts is None or ts.num_samples <= 0:
            _LOG.warning("num_samples = %d, it should be > 0.",
                         0 if ts is None else ts.num_samples)
            return False
        if self._basis is not None:
            static, body = ("rr",), rr_fit
        else:
            static = ("exact", self._kernel, self._scale)
            body = functools.partial(vanilla_fit, scale=self._scale,
                                     kernel=self._kernel)
        consts = self._rr_consts()
        self.state = host_jitter_retry(
            lambda j: self._fit(static, body, (
                ts.xp, ts.yp, ts.vp + self.dtype.type(j), ts.mask), consts),
            lambda st: (st.alpha,))
        self._n = ts.num_samples
        self._trained = True
        self._L_inv = None
        self._var_queries = 0
        return True

    def train(self, mat_x_train=None, mat_y_train=None, vec_var_y=None
              ) -> bool:
        """``train()`` with no arguments is the C++ ``Train()``: refuses when
        already trained (call ``reset`` first) or when the stored train set
        is empty, else fits it. ``train(x, y, var)`` is the binding's: reset,
        store the data, fit. x (x_dim, n); y (n, y_dim) or (n,); var (n,) or
        a scalar."""
        with span("egp.exact.train"):
            if mat_x_train is None:
                if self._trained:
                    _LOG.warning("The model has been trained. Please reset "
                                 "the model before training.")
                    return False
                return self._fit_train_set()
            with span("egp.exact.inputs"):
                self._store_train_set(mat_x_train, mat_y_train, vec_var_y)
            return self._fit_train_set()

    def _store_train_set(self, mat_x_train, mat_y_train, vec_var_y) -> None:
        """``train(x, y, var)``'s reset and padded host arrays."""
        x = np.asarray(mat_x_train, dtype=self.dtype)
        if x.ndim == 1:
            x = x[None, :]
        y = np.asarray(mat_y_train, dtype=self.dtype)
        if y.ndim == 1:
            y = y[:, None]
        n = x.shape[1]
        var = np.broadcast_to(np.asarray(vec_var_y, dtype=self.dtype), (n,))
        self.reset(max(self.setting.max_num_samples, max(n, 1)),
                   x.shape[0], y.shape[1])
        nmax = self.setting.max_num_samples
        xp = np.zeros((nmax, x.shape[0]), self.dtype)
        xp[:n] = x.T
        yp = np.zeros((nmax, y.shape[1]), self.dtype)
        yp[:n] = y
        vp = np.zeros((nmax,), self.dtype)
        vp[:n] = var
        self._train_set = VanillaTrainSet(xp, yp, vp, n)

    def _rr_consts(self) -> tuple:
        """A reduced-rank basis's constants on the device, else ()."""
        return () if self._basis is None else self._basis.consts(self.device)

    def _fit(self, static: tuple, body, feeds: tuple, consts: tuple):
        """``body(*feeds, *consts)``: one replay of its graph on a model with
        graphs, else on new tensors of the host arrays ``feeds``."""
        if self._graphs is not None:
            return self._graphs.fit(static, body, feeds, consts)
        return body(*map(self._tensor, feeds), *consts)

    def _test_step(self) -> tuple:
        """(the key of a test graph, less the queries' shape, and its body
        (:func:`vanilla_test_step` or :func:`rr_test_step`))."""
        rr = self._basis is not None
        body = rr_test_step if rr else functools.partial(
            vanilla_test_step, scale=self._scale, kernel=self._kernel)
        return ("vanilla", self._kernel, self._scale, rr), body

    def _l_inv(self) -> torch.Tensor:
        """L^-1 of the state (:func:`vanilla_l_inv`), through its graph on a
        model with graphs."""
        if self._graphs is not None:
            return self._graphs.l_inv(self.state, vanilla_l_inv)
        return vanilla_l_inv(self.state)

    def test(self, mat_x_test) -> Optional[VanillaTestResult]:
        """x (x_dim, m) column-major (or (m,) for 1-D inputs)."""
        if not self._trained:
            return None
        xq = np.asarray(mat_x_test, dtype=self.dtype)
        if xq.ndim == 1:
            xq = xq[None, :]
        return VanillaTestResult(self, np.ascontiguousarray(xq.T))

    def get_memory_usage(self) -> int:
        """Bytes held by the state's tensors."""
        return 0 if self.state is None else sum(
            t.nbytes for t in self.state if t is not None)

    # -- checkpoint (the full train set round-trips, as in the reference) --
    def state_dict(self) -> dict:
        ts = self._train_set
        return {
            "setting": self.setting.to_dict(),
            "trained": self._trained,
            "n": self._n,
            "x_dim": self._x_dim,
            "y_dim": self._y_dim,
            "state": None if self.state is None else {
                k: v.detach().to("cpu", copy=True).numpy()
                for k, v in self.state._asdict().items() if k != "dinv"},
            "train_set": None if ts is None else {
                "x": ts.xp, "y": ts.yp, "var": ts.vp,
                "num_samples": ts.num_samples},
        }

    def load_state_dict(self, d: dict):
        """Load a ``state_dict``; a model with graphs drops them (its state
        is then the loaded tensors)."""
        if self._graphs is not None:
            self._graphs.clear()
        self.setting = VanillaGPSetting.from_dict(d["setting"])
        self._setup_kernel()
        self._L_inv = None
        self._var_queries = 0
        self._trained = bool(d["trained"])
        self._n = int(d["n"])
        self._x_dim = int(d["x_dim"])
        self._y_dim = int(d["y_dim"])
        s = d["state"]
        self.state = None if s is None else with_tile_inverses(VanillaGPState(
            **{k: self._tensor(s[k]) for k in ("x", "mask", "L", "alpha")}))
        ts = d.get("train_set")
        self._train_set = None if ts is None else VanillaTrainSet(
            np.asarray(ts["x"]), np.asarray(ts["y"]), np.asarray(ts["var"]),
            int(ts["num_samples"]))

    def save(self, path: str):
        save_pytree(path, self.state_dict())

    def load(self, path: str):
        self.load_state_dict(load_pytree(path))

    def __eq__(self, other):
        if not isinstance(other, VanillaGaussianProcess):
            return NotImplemented
        return eq_state(self.state_dict(), other.state_dict())
