"""The exact GP under the benchmark: inputs, the program's model built
through its public API, the calls the loop makes, and the comparison with
the plain reference (``portbench/reference/exact_gp.py``).

One ``VanillaGaussianProcess`` serves the run (built in set-up). An update
is ``train(x, y, var)`` of the next training set of a pool made once per
checkout, in an order drawn from the run's seed; each fit replaces the
model's state, as the model does. A query is ``test`` of the traffic's
grid, then ``get_mean(0)`` and ``get_variance()``, both read back on the
host.

What is checked once the window has closed: the fits that needed a jitter
on the noise (the program's ``fit.jitter``, counted from the warm-up on);
without queries, the factor and alpha the last fit left (the factor's
backward error against the float64 gram of its set, and the mean alpha
gives on the configuration's grid against the float64 fit's); with
queries, the answers of the last query and of 4 earlier ones drawn from
the seed, against the float64 reference's mean and variance of their
sets.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.metrics.counters import counted, snapshot
from portbench.reference import exact_gp as ref

CHECKED_QUERIES = 4   # seeded sample of the sets answered, + the last


def make_inputs(cfg: dict) -> dict:
    """The pool: x (pool, n, 2) ~ U(lo, hi)^2 and y (pool, n), the surface
    plus N(0, noise_var) noise, float32."""
    rng = np.random.default_rng(cfg["pool_seed"])
    lo, hi = cfg["domain"]
    shape = (cfg["pool"], cfg["samples"])
    x = rng.uniform(lo, hi, shape + (cfg["x_dim"],))
    y = ref.surface(x.reshape(-1, cfg["x_dim"])).reshape(shape) \
        + rng.normal(0.0, np.sqrt(cfg["noise_var"]), shape)
    return {"x": x.astype(np.float32), "y": y.astype(np.float32)}


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 root: str, cache_dir: str):
        from erl_gaussian_process_tpu_torch.kernels import KernelSetting
        from erl_gaussian_process_tpu_torch.models import (
            VanillaGaussianProcess,
            VanillaGPSetting,
        )

        del root
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed) % 2**64
        self.device = torch.device(device)
        self.pool = inputs.cached(cache_dir, "exact_sets", cfg,
                                  lambda: make_inputs(cfg), __file__,
                                  ref.__file__)
        self.n = len(self.pool["x"])
        self.order = np.random.default_rng([self.seed, 1]).permutation(self.n)
        lo, hi = cfg["domain"]
        self.grid = ref.grid(cfg["test_grid"], lo, hi).astype(np.float32)
        q = traffic.get("query")
        self.queries = None if not q else \
            ref.grid(q["grid"], lo, hi).astype(np.float32)
        self.gp = VanillaGaussianProcess(
            VanillaGPSetting(kernel_type=cfg["kernel_type"],
                             kernel=KernelSetting(x_dim=cfg["x_dim"],
                                                  scale=cfg["kernel_scale"]),
                             max_num_samples=cfg["samples"]),
            dtype=np.dtype(cfg["dtype"]), device=self.device)
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
        self.answers = {}
        graphs = self.gp._graphs
        self._warmed = (snapshot(),
                        None if graphs is None else len(graphs.captures))

    def start_session(self, s: int) -> None:
        del s   # one model serves the run; each fit replaces its state

    def update(self, k: int) -> None:
        i = int(self.order[k % self.n])
        if not self.gp.train(self.pool["x"][i].T, self.pool["y"][i],
                             self.cfg["noise_var"]):
            raise RuntimeError(f"the exact GP refused training set {i}")
        self.last = i
        if self.recording is not None:
            self.recording.append(i)

    def query(self, k: int) -> None:
        del k
        res = self.gp.test(self.queries.T)
        self.answers[self.last] = (res.get_mean(0), res.get_variance())
        if self.query_log is not None:
            self.query_log.append(self.last)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- what the metrics read --------------------------------------------------
    def exact_fit_shapes(self) -> list:
        """(samples, d) of each traced fit."""
        return [(self.cfg["samples"], self.cfg["x_dim"])] \
            * len(self.recording)

    def exact_query_shapes(self) -> list:
        """(samples, queries, d) of each traced query."""
        return [(self.cfg["samples"], len(self.queries), self.cfg["x_dim"])] \
            * len(self.query_log)

    def routed_query_shapes(self) -> list:
        """(hits per query, points per answering member, d) of each traced
        query, as ``gram_roofline.query`` reads them: every query of the
        grid against the one training set of the model."""
        n, m = self.cfg["samples"], len(self.queries)
        return [([n] * m, [n], self.cfg["x_dim"])] * len(self.query_log)

    # -- the check ---------------------------------------------------------------
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
            out["L"] = st.L.clone()
            out["alpha"] = st.alpha[:, 0].double().cpu().numpy()
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
        cfg = self.cfg
        return ref.FitReference(self.pool["x"][i], self.pool["y"][i],
                                cfg["noise_var"], cfg["kernel_scale"],
                                dtype=dtype, device=self.device, tf32=tf32)

    def replay(self, got: dict, *, dtype=torch.float64,
               tf32: bool = False) -> dict:
        """The reference's (or, with float32 and ``tf32``, the control's)
        outputs for what :meth:`collect` returned: for the last set, its
        factor and alpha (with queries, none), and the answers of each
        answered set."""
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
        a jitter; without queries, the last factor's backward error and the
        widest gap of the mean its alpha gives on the grid; with queries,
        the widest mean and variance gaps over the checked answers."""
        cfg, p = self.cfg, self.pool
        nums = {"jitter_fits": int(got["jitter_fits"])}
        if "L" in got:
            x = p["x"][got["set"]]
            nums["backward_rel"] = ref.backward_rel(
                got["L"], x, cfg["noise_var"], cfg["kernel_scale"],
                self.device)
            mean = ref.mean_from_alpha(x, got["alpha"], self.grid,
                                       cfg["kernel_scale"], self.device)
            nums["mean_gap"] = _gap(mean, ref.mean_from_alpha(
                x, want["alpha"], self.grid, cfg["kernel_scale"],
                self.device))
        if want["answers"]:
            mg = vg = 0.0
            for i, (m_ref, v_ref) in want["answers"].items():
                m, v = got["answers"][i]
                mg = max(mg, _gap(m, m_ref))
                vg = max(vg, _gap(v, v_ref))
            nums.update(mean_gap=mg, var_gap=vg)
        return nums

    def diagnose(self, got: dict) -> dict:
        """Graphs captured after the warm-up (none is the rule) and the
        program's ``graph.capture_ms`` over the same span."""
        return {"captures_after_warmup": got["captures"],
                "capture_ms_after_warmup": got["capture_ms"]}


def _gap(a, b) -> float:
    """The widest absolute gap of two arrays, inf where one is not
    finite."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.max(d)) if np.all(np.isfinite(d)) else np.inf
