"""The noisy-input GP with gradient observations under the benchmark:
inputs, the program's model built through its public API, the calls the
loop makes, and the comparison with the plain reference
(``portbench/reference/noisy_input_gp.py``).

One ``NoisyInputGaussianProcess`` serves the run (built in set-up). An
update is ``train(x, y, grad, var_x, var_y, var_grad, grad_flag)`` of the
next training set of a pool made once per checkout, in an order drawn
from the run's seed, every sample's gradient flagged; each fit replaces
the model's state, as the model does. A query is ``test`` of the
traffic's grid with gradients, then ``get_mean(0)``, ``get_gradient(0)``,
``get_mean_variance()``, ``get_gradient_variance()`` and
``get_covariance()``, all read back on the host.

What is checked once the window has closed: the fits that needed a jitter
on the noise (the program's ``fit.jitter``, counted from the warm-up on);
without queries, the joint factor and alpha the last fit left (the
factor's backward error against the float64 joint gram of its set, and
the mean and gradient alpha gives on the configuration's grid against the
float64 fit's); with queries, the five answers of the last query and of 4
earlier ones drawn from the seed, against the float64 reference's of
their sets.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.adapters.exact_gp import CHECKED_QUERIES, _gap
from portbench.metrics.counters import counted, snapshot
from portbench.reference import noisy_input_gp as ref

ANSWERS = ("mean_gap", "grad_gap", "var_gap", "grad_var_gap", "cov_gap")


def make_inputs(cfg: dict) -> dict:
    """The pool: x (pool, n, 2) ~ U(domain), y (pool, n) and grad (pool, n,
    2), the surface and its gradient each plus N(0, var_y) and N(0,
    var_grad) noise, float32."""
    rng = np.random.default_rng(cfg["pool_seed"])
    shape = (cfg["pool"], cfg["samples"])
    (x0, x1), (y0, y1) = cfg["domain"]
    x = np.stack([rng.uniform(x0, x1, shape), rng.uniform(y0, y1, shape)], -1)
    flat = x.reshape(-1, cfg["x_dim"])
    y = ref.surface(flat).reshape(shape) \
        + rng.normal(0.0, np.sqrt(cfg["var_y"]), shape)
    g = ref.surface_grad(flat).reshape(shape + (cfg["x_dim"],)) \
        + rng.normal(0.0, np.sqrt(cfg["var_grad"]), shape + (cfg["x_dim"],))
    return {"x": x.astype(np.float32), "y": y.astype(np.float32),
            "grad": g.astype(np.float32)}


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 root: str, cache_dir: str):
        from erl_gaussian_process_tpu_torch.kernels import KernelSetting
        from erl_gaussian_process_tpu_torch.models import (
            NoisyInputGaussianProcess,
            NoisyInputGPSetting,
        )

        del root
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed) % 2**64
        self.device = torch.device(device)
        self.pool = inputs.cached(cache_dir, "nigp_sets", cfg,
                                  lambda: make_inputs(cfg), __file__,
                                  ref.__file__)
        self.n = len(self.pool["x"])
        self.order = np.random.default_rng([self.seed, 1]).permutation(self.n)
        self.grid = ref.grid(cfg["test_grid"], cfg["domain"]) \
            .astype(np.float32)
        q = traffic.get("query")
        self.queries = None if not q else \
            ref.grid(q["grid"], cfg["domain"]).astype(np.float32)
        self.flags = np.ones(cfg["samples"], bool)
        self.gp = NoisyInputGaussianProcess(
            NoisyInputGPSetting(kernel_type=cfg["kernel_type"],
                                kernel=KernelSetting(
                                    x_dim=cfg["x_dim"],
                                    scale=cfg["kernel_scale"]),
                                max_num_samples=cfg["samples"]),
            dtype=np.dtype(cfg["dtype"]), device=self.device)
        self.joint_rows = None      # the joint system's padded rows
        self.last = None            # the set the model holds
        self.answers = {}           # the latest answers by set
        self._want = None           # the reference's outputs, once checked
        self._before = None         # the counters when the warm-up began
        self._warmed = None         # (counters, captures) after the warm-up
        self.recording = None       # sets fit in the traced slice
        self.query_log = None       # sets answered in the traced slice

    # -- the calls the loop makes ---------------------------------------------
    def warm(self) -> None:
        """Every set of the pool once, with its query when the traffic has
        them: the fit graph, and the test and variance graphs of the
        traffic's grid, are captured before the window."""
        self._before = snapshot()
        for k in range(self.n):
            self.update(k)
            if self.queries is not None:
                self.query(k)
        self.sync()
        self.joint_rows = int(self.gp.state.L.shape[0])
        self.answers = {}
        graphs = self.gp._graphs
        self._warmed = (snapshot(),
                        None if graphs is None else len(graphs.captures))

    def start_session(self, s: int) -> None:
        del s   # one model serves the run; each fit replaces its state

    def update(self, k: int) -> None:
        i = int(self.order[k % self.n])
        cfg, p = self.cfg, self.pool
        if not self.gp.train(p["x"][i].T, p["y"][i], p["grad"][i].T,
                             cfg["var_x"], cfg["var_y"], cfg["var_grad"],
                             self.flags):
            raise RuntimeError(f"the noisy-input GP refused training set {i}")
        self.last = i
        if self.recording is not None:
            self.recording.append(i)

    def query(self, k: int) -> None:
        del k
        res = self.gp.test(self.queries.T, predict_gradient=True)
        self.answers[self.last] = (
            res.get_mean(0), res.get_gradient(0), res.get_mean_variance(),
            res.get_gradient_variance(), res.get_covariance())
        if self.query_log is not None:
            self.query_log.append(self.last)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- what the metrics read --------------------------------------------------
    def nigp_fit_shapes(self) -> list:
        """(samples, d, the joint system's padded rows) of each traced
        fit."""
        return [(self.cfg["samples"], self.cfg["x_dim"], self.joint_rows)] \
            * len(self.recording)

    def nigp_query_shapes(self) -> list:
        """(samples, queries, d) of each traced query."""
        return [(self.cfg["samples"], len(self.queries), self.cfg["x_dim"])] \
            * len(self.query_log)

    # -- the check ---------------------------------------------------------------
    def _active(self, rows: int) -> np.ndarray:
        """The joint system's rows that hold samples, in the reference's
        order ``[values; grad-dim0; grad-dim1]``, of a padded system of
        ``rows`` rows."""
        n, d = self.cfg["samples"], self.cfg["x_dim"]
        pad = rows // (1 + d)
        return np.concatenate([b * pad + np.arange(n) for b in range(1 + d)])

    def collect(self) -> dict:
        """Copy what is checked off the model, then drop the model."""
        st = self.gp.state
        graphs = self.gp._graphs
        out = {"set": self.last,
               "jitter_fits": counted(self._before, "fit.jitter") or 0,
               "capture_ms": counted(self._warmed[0], "graph.capture_ms"),
               "captures": None if graphs is None
               else len(graphs.captures) - self._warmed[1],
               "answers": {}}
        if self.queries is None:
            idx = torch.as_tensor(self._active(st.L.shape[0]),
                                  device=st.L.device)
            out["L"] = st.L[idx][:, idx].clone()
            out["alpha"] = st.alpha[idx, 0].double().cpu().numpy()
        else:
            rng = np.random.default_rng([self.seed, 2])
            earlier = sorted(set(self.answers) - {self.last})
            pick = set(rng.choice(earlier, min(CHECKED_QUERIES, len(earlier)),
                                  replace=False).tolist()) | {self.last}
            out["answers"] = {i: self.answers[i] for i in sorted(pick)
                              if i in self.answers}
        self.gp = None
        return out

    def _fit(self, i: int, dtype, tf32: bool) -> ref.FitReference:
        cfg, p = self.cfg, self.pool
        return ref.FitReference(p["x"][i], p["y"][i], p["grad"][i],
                                cfg["var_x"] + cfg["var_y"], cfg["var_grad"],
                                cfg["kernel_scale"], dtype=dtype,
                                device=self.device, tf32=tf32)

    def replay(self, got: dict, *, dtype=torch.float64,
               tf32: bool = False) -> dict:
        """The reference's (or, with float32 and ``tf32``, the control's)
        outputs for what :meth:`collect` returned: for the last set, its
        joint factor and alpha (with queries, none), and the answers of
        each answered set."""
        out = {"set": got["set"], "jitter_fits": 0, "answers": {}}
        if "L" in got:
            fit = self._fit(got["set"], dtype, tf32)
            out["L"] = fit.L
            out["alpha"] = fit.alpha[:, 0].double().cpu().numpy()
        for i in got["answers"]:
            out["answers"][i] = self._fit(i, dtype, tf32).predict(
                self.queries)
        return out

    def check(self, got: dict, control: bool = False) -> dict:
        """The numbers compared: the program's, or with ``control`` those
        of the control put in its place."""
        if self._want is None:
            self._want = self.replay(got)
        out = self.replay(got, dtype=torch.float32, tf32=True) \
            if control else got
        return self.compare(out, self._want)

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers the check holds to their limits: the fits that took
        a jitter; without queries, the last joint factor's backward error
        and the widest gaps of the mean and the gradient its alpha gives on
        the grid; with queries, the widest gaps of the five answers over
        the checked queries."""
        cfg, p = self.cfg, self.pool
        nums = {"jitter_fits": int(got["jitter_fits"])}
        if "L" in got:
            x = p["x"][got["set"]]
            scale = cfg["kernel_scale"]
            nums["backward_rel"] = ref.backward_rel(
                got["L"], x, cfg["var_x"] + cfg["var_y"], cfg["var_grad"],
                scale, self.device)
            mean, grad = ref.mean_from_alpha(x, got["alpha"], self.grid,
                                             scale, self.device)
            m_ref, g_ref = ref.mean_from_alpha(x, want["alpha"], self.grid,
                                               scale, self.device)
            nums["mean_gap"] = _gap(mean, m_ref)
            nums["grad_gap"] = _gap(grad, g_ref)
        if want["answers"]:
            gaps = dict.fromkeys(ANSWERS, 0.0)
            for i, wanted in want["answers"].items():
                for name, a, b in zip(ANSWERS, got["answers"][i], wanted):
                    gaps[name] = max(gaps[name], _gap(a, b))
            nums.update(gaps)
        return nums

    def diagnose(self, got: dict) -> dict:
        """Graphs captured after the warm-up (none is the rule) and the
        program's ``graph.capture_ms`` over the same span."""
        return {"captures_after_warmup": got["captures"],
                "capture_ms_after_warmup": got["capture_ms"]}

