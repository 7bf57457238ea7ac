"""The 3D range-sensor GP under the benchmark: inputs, the program's model
built through its public API, the calls the loop makes, and the comparison
with the plain reference (``portbench/reference/range_gp3d.py``).

One ``RangeSensorGaussianProcess3D`` serves the run (built in set-up). An
update is ``train(R, t, ranges)`` of the next scan of a pool made once per
checkout, in an order drawn from the run's seed; each train replaces the
bank, as the model does. A query is ``test(directions, False, True)`` of
the run's query directions (drawn from its seed), with its means and
variances read back on the host.

What is checked once the window has closed: the bank the last train left
(each member's sample count and alpha, against the float64 fit of the same
scan) and, when the traffic queries, the answers of a seeded sample of the
scans answered in the window (always the last): ranges, variances and the
valid mask, against the reference's routed predictions.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.reference import range_gp3d as ref
from portbench.reference import worlds

CHECKED_QUERIES = 4   # seeded sample of the scans answered, + the last


def make_inputs(cfg: dict) -> dict:
    pool = worlds.lidar_scan_pool(cfg)
    pool["ranges"] = pool["ranges"].astype(np.float32)
    return pool


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 root: str, cache_dir: str):
        from erl_gaussian_process_tpu_torch.geometry import LidarFrame3DSetting
        from erl_gaussian_process_tpu_torch.kernels import KernelSetting
        from erl_gaussian_process_tpu_torch.models import (
            RangeSensorGaussianProcess3D,
            RangeSensorGP3DSetting,
            VanillaGPSetting,
        )
        from erl_gaussian_process_tpu_torch.models.mapping import (
            MappingSetting,
            MappingType,
        )

        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed) % 2**64
        self.device = torch.device(device)
        self.pool = inputs.cached(cache_dir, "lidar_scans", cfg,
                                  lambda: make_inputs(cfg), __file__)
        self.n = len(self.pool["ranges"])
        rng = np.random.default_rng([self.seed, 1])
        self.order = rng.permutation(self.n)
        q = traffic.get("query")
        self.queries = None if not q else \
            worlds.sphere_queries(q["points"], rng).astype(np.float32)
        lo, hi = ref.valid_range(cfg["frame"])
        frame = LidarFrame3DSetting(**{**cfg["frame"], "valid_range_min": lo,
                                       "valid_range_max": hi})
        keys = ("row_group_size", "row_overlap_size", "row_margin",
                "col_group_size", "col_overlap_size", "col_margin",
                "min_num_samples_per_group", "sensor_range_var",
                "max_valid_range_var")
        self.setting = RangeSensorGP3DSetting(
            **{k: cfg[k] for k in keys}, sensor_frame_type="lidar",
            sensor_frame=frame,
            gp=VanillaGPSetting(kernel_type=cfg["kernel_type"],
                                kernel=KernelSetting(
                                    x_dim=2, scale=cfg["kernel_scale"])),
            mapping=MappingSetting(type=MappingType.parse(cfg["mapping"])))
        self.gp = RangeSensorGaussianProcess3D(
            self.setting, dtype=np.dtype(cfg["dtype"]), device=self.device)
        self.layout = ref.Layout(cfg)
        self.last = None            # the scan the bank holds
        self.answers = {}           # the latest answers by scan
        self._want = None           # the reference's outputs, once checked
        self.recording = None       # scans trained in the traced slice
        self.query_log = None       # scans answered in the traced slice
        self._counted = {}          # each pool scan's hits a member

    # -- the calls the loop makes ---------------------------------------------
    def warm(self) -> None:
        """Every scan of the pool once, with its query when the traffic has
        them: the train's graph is captured and each routed bucket shape
        of the run has been through the library once."""
        for k in range(self.n):
            self.update(k)
            if self.queries is not None:
                self._test()
        self.sync()
        self.answers = {}

    def start_session(self, s: int) -> None:
        del s   # one model serves the run; each train replaces its bank

    def update(self, k: int) -> None:
        i = int(self.order[k % self.n])
        p = self.pool
        self.gp.train(p["rotations"][i], p["positions"][i], p["ranges"][i])
        self.last = i
        if self.recording is not None:
            self.recording.append(i)

    def _test(self):
        res = self.gp.test(self.queries, False, True)
        rng, valid = res.get_mean()
        var, _ = res.get_variance()
        return rng, var, valid

    def query(self, k: int) -> None:
        del k
        self.answers[self.last] = self._test()
        if self.query_log is not None:
            self.query_log.append(self.last)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- what the metrics read --------------------------------------------------
    def _counts(self, i: int) -> np.ndarray:
        if i not in self._counted:
            self._counted[i] = self.layout.gather(
                self.pool["ranges"][i])[2].sum(1)
        return self._counted[i]

    def bank_fit_shapes(self) -> list:
        """(padded n, each member's sample count, d) of each traced
        train."""
        return [(self.layout.width, self._counts(i), 2)
                for i in self.recording]

    def routed_query_shapes(self) -> list:
        """For each traced query: the hit count of the member that answers
        each valid query direction, the hit counts of the members that
        answer any, and d."""
        out, routed = [], {}
        for i in self.query_log:
            if i in routed:
                out.append(routed[i])
                continue
            counts = self._counts(i)
            _, idx = self.layout.route(
                self.queries, self.pool["rotations"][i].astype(np.float32))
            idx = idx[idx >= 0]
            idx = idx[counts[idx] > 0]
            routed[i] = (counts[idx], counts[np.unique(idx)], 2)
            out.append(routed[i])
        return out

    # -- the check ---------------------------------------------------------------
    def collect(self) -> dict:
        """Copy what is checked to the host, then drop the model."""
        b = self.gp.bank
        out = {"bank_scan": self.last,
               "count": b.mask.sum(1).cpu().numpy(),
               "alpha": b.alpha[..., 0].double().cpu().numpy(),
               "answers": {}}
        if self.answers:
            rng = np.random.default_rng([self.seed, 2])
            have = sorted(self.answers)
            pick = set(rng.choice(have, min(CHECKED_QUERIES, len(have)),
                                  replace=False).tolist()) | {self.last}
            out["answers"] = {i: self.answers[i] for i in sorted(pick)
                              if i in self.answers}
        self.gp = None
        return out

    def replay(self, got: dict, *, dtype=torch.float64,
               tf32: bool = False) -> dict:
        """The reference's (or, with float32 and ``tf32``, the control's)
        outputs for what :meth:`collect` returned."""
        p = self.pool
        bank = ref.ScanReference(self.layout, p["ranges"][got["bank_scan"]],
                                 dtype=dtype, device=self.device, tf32=tf32)
        out = {"bank_scan": got["bank_scan"], "count": bank.count,
               "alpha": bank.alpha.double().cpu().numpy(), "answers": {}}
        for i in got["answers"]:
            scan = bank if i == got["bank_scan"] else ref.ScanReference(
                self.layout, p["ranges"][i], dtype=dtype, device=self.device,
                tf32=tf32)
            out["answers"][i] = scan.test(
                self.queries, p["rotations"][i].astype(np.float32))
        return out

    def check(self, got: dict, control: bool = False) -> dict:
        """The numbers compared: the program's, or with ``control`` those
        of the control put in its place."""
        if self._want is None:
            self._want = self.replay(got)
        out = self.replay(got, dtype=torch.float32, tf32=True) \
            if control else got
        return compare(out, self._want)


def compare(got: dict, want: dict) -> dict:
    """The numbers the check holds to their limits: members whose sample
    count differs; the largest relative error of a trained member's alpha;
    and over the checked answers, the queries whose validity differs, the
    widest relative range gap and the widest variance gap of the valid
    ones."""
    cnt = want["count"]
    nums = {"members_off": int(np.sum(got["count"] != cnt))}
    a, b = got["alpha"], want["alpha"]
    worst = 0.0
    for j in np.flatnonzero(cnt > 0):
        n = cnt[j]
        d = np.linalg.norm(a[j, :n] - b[j, :n])
        worst = max(worst, d / max(np.linalg.norm(b[j, :n]), 1e-300)
                    if np.isfinite(d) else np.inf)
    nums["alpha_rel"] = float(worst)
    if want["answers"]:
        off, rgap, vgap = 0, 0.0, 0.0
        for i, (r_ref, v_ref, ok_ref) in want["answers"].items():
            r, v, ok = got["answers"][i]
            off += int(np.sum(ok != ok_ref))
            both = ok & ok_ref
            if both.any():
                e = np.abs(r[both] - r_ref[both]) / r_ref[both]
                rgap = max(rgap, float(np.max(e)) if np.all(np.isfinite(e))
                           else np.inf)
                e = np.abs(v[both] - v_ref[both])
                vgap = max(vgap, float(np.max(e)) if np.all(np.isfinite(e))
                           else np.inf)
        nums.update(valid_off=off, range_gap=rgap, var_gap=vgap)
    return nums
