"""The 3D SPGP occupancy map under the benchmark: inputs, the program's
model built through its public API, the calls the loop makes, and the
comparison with the plain reference (``portbench/reference/spgp_map3d.py``).

A session is one ``SpGpOccupancyMap`` fed the trajectory's poses in order:
``update(sensor, points, mask)`` with host arrays, as a mapper integrates
scans; ``query`` is ``predict(points, compute_gradient=True)`` read back to
the host, as a planner waits for it. Session s of a run has the map seed
``worlds.session_seed(seed, s)``; the query points of pose k come from the
run's seed.

What is checked once the window has closed, in two stages:

- the updates: the last session that ran to its end (or, when none did,
  the current one): the samples each of its poses used, against the
  reference's sampler, and its final Q_M and alpha (the map's compensated
  sums) against the float64 replay of the same poses;
- the queries, when the traffic has them: the answers at a few positions
  drawn from the seed (and the last answer of the run), each against the
  float64 prepare and predict of the map's own state at that moment, which
  the loop copies on the card right after the answer. Q_M is so badly
  conditioned that two float32 accumulations of the same poses, a rounding
  apart, give posteriors that differ by O(1) of their largest value, so
  the predict is judged from the state the program holds, and that state
  by the first stage.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import inputs
from portbench.reference import spgp_map3d as ref
from portbench.reference import worlds

SNAPSHOTS = 4         # query positions drawn from the seed whose state is kept
SNAPSHOT_RANGE = 48   # ... among a session's first positions


def load_trajectory(cfg: dict, root: str) -> np.ndarray:
    poses = np.loadtxt(os.path.join(root, cfg["trajectory"])).reshape(-1, 4, 4)
    return poses[:cfg["poses"]]


def make_inputs(cfg: dict, root: str) -> dict:
    poses = load_trajectory(cfg, root)
    scene = worlds.hotel0_scene(poses, cfg)
    return worlds.hotel0_scans(poses, scene, cfg)


class Cell:
    """One run's map sessions (see the module docstring)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 root: str, cache_dir: str):
        from erl_gaussian_process_tpu_torch.geometry import Aabb
        from erl_gaussian_process_tpu_torch.kernels import KernelSetting
        from erl_gaussian_process_tpu_torch.models import (
            SpGpOccupancyMap,
            SpGpOccupancyMapSetting,
            SpGpSetting,
        )

        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed) % 2**64
        self.device = torch.device(device)
        poses = load_trajectory(cfg, root)
        self.scene = worlds.hotel0_scene(poses, cfg)
        self.scans = inputs.cached(
            cache_dir, "hotel0_scans", cfg, lambda: make_inputs(cfg, root),
            __file__, os.path.join(root, cfg["trajectory"]))
        self.n = len(self.scans["sensors"])
        q = traffic.get("query")
        self.queries, self.snap_at = None, set()
        if q:
            rng = np.random.default_rng([self.seed, 1])
            self.queries = worlds.box_queries(
                self.scene["lo"], self.scene["hi"], q["inset"],
                self.n * q["points"], rng).reshape(self.n, q["points"], 3)
            self.snap_at = set(rng.choice(min(self.n, SNAPSHOT_RANGE),
                                          SNAPSHOTS, replace=False).tolist())
        self.setting = SpGpOccupancyMapSetting(
            sp_gp=SpGpSetting(
                kernel_type=cfg["kernel_type"],
                kernel=KernelSetting(x_dim=3, scale=self.scene["scale"]),
                max_num_samples=cfg["max_num_samples"]),
            min_distance=cfg["min_distance"], max_distance=cfg["max_distance"],
            free_points_per_meter=cfg["free_points_per_meter"],
            free_sampling_margin=cfg["free_sampling_margin"],
            logodd_free=cfg["logodd_free"],
            logodd_occupied=cfg["logodd_occupied"],
            logodd_variance=cfg["logodd_variance"])
        box = Aabb.from_min_max(self.scene["lo"], self.scene["hi"])
        pseudo = np.ascontiguousarray(self.scene["pseudo"].T)
        dtype = getattr(torch, cfg["dtype"])

        def new_map(map_seed):
            return SpGpOccupancyMap(
                self.setting, pseudo, box, seed=map_seed, dtype=dtype,
                free_slots_per_ray=cfg["free_slots_per_ray"],
                device=self.device)

        self.new_map = new_map
        self.sessions = []          # the current session and the one before
        self.snaps = {}             # position -> (state copies, answer)
        self.last = None            # (position, state, answer) of the last query
        self._want = None           # the reference's outputs, once checked
        self.gradient = bool(q and q.get("gradient"))
        self.recording = None       # samples used by the traced updates

    # -- the calls the loop makes ---------------------------------------------
    def warm(self) -> None:
        """A throwaway session over the first poses, with a query when the
        traffic has them: the library loads, the graphs' first captures
        and the allocator's pools happen here."""
        m = self.new_map(worlds.session_seed(self.seed, -1))
        for k in range(min(4, self.n)):
            m.update(self.scans["sensors"][k], self.scans["points"][k],
                     self.scans["masks"][k])
            if self.queries is not None:
                mean, grad = m.predict(self.queries[k], self.gradient)
                mean.cpu()
        self.sync()

    def start_session(self, s: int) -> None:
        seed = worlds.session_seed(self.seed, s)
        self.sessions = self.sessions[-1:] + [
            {"seed": seed, "map": self.new_map(seed), "used": []}]

    def update(self, k: int) -> None:
        s, i = self.sessions[-1], k % self.n
        used = s["map"].update(self.scans["sensors"][i],
                               self.scans["points"][i], self.scans["masks"][i])
        s["used"].append(used)
        if self.recording is not None:
            self.recording.append(used)

    def query(self, k: int) -> None:
        m, i = self.sessions[-1]["map"], k % self.n
        mean, grad = m.predict(self.queries[i], self.gradient)
        answer = (mean.cpu().numpy(),
                  None if grad is None else grad.cpu().numpy())
        self.last = (i, m.state, answer)
        if i in self.snap_at:
            st = m.state
            self.snaps[i] = ((st.qm.clone(), st.qm_c.clone(),
                              st.alpha.clone(), st.alpha_c.clone()), answer)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- what the metrics read --------------------------------------------------
    def fitc_shapes(self) -> list:
        """(M, N, d) of each traced update's FITC increment: M the padded
        pseudo points, N the samples the pose used (the map's own count)."""
        m = -(-len(self.scene["pseudo"]) // self.cfg["pad_multiple"]) \
            * self.cfg["pad_multiple"]
        return [(m, int(u), 3) for u in torch.stack(self.recording).cpu()]

    # -- the check ---------------------------------------------------------------
    def collect(self) -> dict:
        """Copy what is checked to the host, then drop every map."""
        done = [s for s in self.sessions if len(s["used"]) == self.n]
        s = done[-1] if done else self.sessions[-1]
        qm, alpha = _compensated(s["map"].state)
        out = {"seed": s["seed"], "poses": list(range(len(s["used"]))),
               "used": torch.stack(s["used"]).cpu().numpy(),
               "qm": qm, "alpha": alpha, "answers": {}}
        if self.last is not None:
            snaps = dict(self.snaps)
            i, st, answer = self.last
            snaps[i] = ((st.qm, st.qm_c, st.alpha, st.alpha_c), answer)
            out["answers"] = {i: (*answer, *_pairs(t))
                              for i, (t, answer) in snaps.items()}
        self.sessions, self.snaps, self.last = [], {}, None
        return out

    def replay(self, got: dict, *, dtype=torch.float64,
               tf32: bool = False) -> dict:
        """The reference's (or, with float32 and ``tf32``, the control's)
        replay of the checked session, with its answers and states at the
        checked positions it reaches."""
        keep = {i: self.queries[i] for i in got["answers"]
                if i < len(got["poses"])}
        out = ref.replay_session(self.scene, self.scans, self.cfg,
                                 got["seed"], got["poses"], keep,
                                 dtype=dtype, device=self.device, tf32=tf32)
        out["answers"] = out.pop("preds")
        return out

    def own_state(self, answers: dict) -> dict:
        """The float64 predictions of each answer's own state."""
        p = ref.pad_pseudo(self.scene["pseudo"], self.cfg["pad_multiple"])
        P = torch.as_tensor(p, device=self.device).double()
        return {i: ref.predict_state(P, self.scene["scale"], qm, alpha,
                                     self.queries[i])
                for i, (_, _, qm, alpha) in answers.items()}

    def check(self, got: dict, control: bool = False) -> dict:
        """The numbers compared: the program's, or with ``control`` those
        of the control put in its place."""
        if self._want is None:
            self._want = self.replay(got)
        out = self.replay(got, dtype=torch.float32, tf32=True) \
            if control else got
        return compare(out, self._want, self.own_state(out["answers"]))


    def diagnose(self, got: dict) -> dict:
        """For the readings only: the answers against the float64 replay's
        own predictions (two accumulations a rounding apart), and the
        condition number of the replay's final Q_M."""
        want = self._want
        both = {i: want["answers"][i][:2] for i in got["answers"]
                if i in want["answers"]}
        out = compare(got, want, both)
        return {"mean_gap_replay": out.get("mean_gap"),
                "grad_gap_replay": out.get("grad_gap"),
                "cond_qm": float(np.linalg.cond(want["qm"]))}


def _pairs(t) -> tuple:
    """(Q_M, alpha) as float64 numpy from (qm, qm_c, alpha, alpha_c)."""
    qm, qm_c, alpha, alpha_c = (x.double().cpu().numpy() for x in t)
    return qm - qm_c, alpha - alpha_c


def _compensated(st) -> tuple:
    return _pairs((st.qm, st.qm_c, st.alpha, st.alpha_c))


def compare(got: dict, want: dict, own: dict) -> dict:
    """The numbers the check holds to their limits: poses whose sample
    count differs, Q_M's and alpha's relative Frobenius errors against the
    replay, and the widest gaps of the checked answers' log-odds and
    gradients against the float64 predictions of their own states, each
    relative to the largest value those give at that position."""
    nums = {
        "samples_off": int(np.sum(got["used"] != want["used"])),
        "qm_rel": _rel(got["qm"], want["qm"]),
        "alpha_rel": _rel(got["alpha"], want["alpha"]),
    }
    if own:
        mean_gap = grad_gap = 0.0
        for i, (m_ref, g_ref) in own.items():
            m, g = got["answers"][i][:2]
            mean_gap = max(mean_gap, _gap(np.abs(m - m_ref), np.abs(m_ref)))
            if g is not None:
                grad_gap = max(grad_gap, _gap(
                    np.linalg.norm(g - g_ref, axis=-1),
                    np.linalg.norm(g_ref, axis=-1)))
        nums["mean_gap"] = mean_gap
        nums["grad_gap"] = grad_gap
    return nums


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    if not np.all(np.isfinite(a)):
        return float("inf")
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _gap(err, size) -> float:
    if not np.all(np.isfinite(err)):
        return float("inf")
    return float(err.max() / max(size.max(), 1e-300))
