"""Plain reference of the 3D range-sensor GP (``lidar3d_rsgp``).

A scan is a range image over (azimuth, elevation). Rows and columns are cut
into overlapping groups (the reference constructor's partition math,
:func:`grid_partitions`); each (row group, column group) cell is a member:
an exact GP on the frame coordinates (az, el) of its hits (finite ranges in
[valid_range_min, valid_range_max], row-major within the cell), with
targets 1 / sqrt(range), noise ``sensor_range_var`` and the
Ornstein-Uhlenbeck kernel exp(-r / scale). A member with at most
``min_num_samples_per_group`` hits is not trained.

A query direction is turned into the sensor frame (d @ R), then into frame
coordinates, and answered by the first member whose row interval [left,
right) and column interval [left, right] hold it, when that member is
trained: mean k*^T K^-1 y, mapped back as 1 / mean^2, and variance
1 - ||L^-1 k*||^2 (at least 0). The routing runs in float32, in the order
the model defines it, so that a query lands on the member a float32 model
routes it to; the fits and predictions run in ``dtype`` (float64 for the
reference). ``tf32=True`` with float32 is the control: the same
computation with TF32 matrix products (K^-1 y and the predictions are
products with L^-1). Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.spgp_map3d import _Tf32
from portbench.reference.worlds import lidar_angles


def valid_range(frame: dict) -> tuple:
    """The frame's valid range interval; a bound given as null is open."""
    lo, hi = frame["valid_range_min"], frame["valid_range_max"]
    return (-np.inf if lo is None else lo), (np.inf if hi is None else hi)


def grid_partitions(coords: np.ndarray, group: int, overlap: int,
                    margin: int) -> list:
    """(first index, end index, left coordinate, right coordinate) of each
    group along one axis."""
    n = coords.shape[0]
    step = group - overlap
    half = overlap // 2
    groups = max(1, n // step) + 1
    gs2 = (n - (groups - 2) * step) // 2
    parts = [(0, gs2 + half, coords[margin], coords[gs2])]
    for i in range(groups - 2):
        il = i * step + gs2 - half
        ir = il + group
        parts.append((il, ir, coords[il + half], coords[ir - half]))
    parts.append((n - gs2 - half, n, coords[n - 1 - gs2],
                  coords[n - 1 - margin]))
    return parts


class Layout:
    """The partition grid of a lidar frame (``cfg`` the configuration)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.az, self.el = lidar_angles(cfg["frame"], np.float32)
        self.rows = grid_partitions(self.az, cfg["row_group_size"],
                                    cfg["row_overlap_size"], cfg["row_margin"])
        self.cols = grid_partitions(self.el, cfg["col_group_size"],
                                    cfg["col_overlap_size"], cfg["col_margin"])
        self.width = (max(b - a for a, b, _, _ in self.rows)
                      * max(b - a for a, b, _, _ in self.cols))
        self.row_bounds = np.asarray([[l, r] for *_, l, r in self.rows],
                                     np.float32)
        self.col_bounds = np.asarray([[l, r] for *_, l, r in self.cols],
                                     np.float32)

    @property
    def members(self) -> int:
        return len(self.rows) * len(self.cols)

    def gather(self, ranges32: np.ndarray):
        """One scan's members: x (B, width, 2) f32 frame coordinates,
        ranges (B, width) f32, mask (B, width) bool (hits of trained
        members, packed to the front in row-major order)."""
        lo, hi = valid_range(self.cfg["frame"])
        hit = np.isfinite(ranges32) & (ranges32 >= np.float32(lo)) \
            & (ranges32 <= np.float32(hi))
        B, w = self.members, self.width
        x = np.zeros((B, w, 2), np.float32)
        r = np.ones((B, w), np.float32)
        m = np.zeros((B, w), bool)
        C = len(self.cols)
        for i, (r0, r1, _, _) in enumerate(self.rows):
            for j, (c0, c1, _, _) in enumerate(self.cols):
                h = hit[r0:r1, c0:c1]
                cnt = int(h.sum())
                if cnt <= self.cfg["min_num_samples_per_group"]:
                    continue
                b = i * C + j
                aa, ee = np.meshgrid(self.az[r0:r1], self.el[c0:c1],
                                     indexing="ij")
                x[b, :cnt] = np.stack([aa[h], ee[h]], -1)
                r[b, :cnt] = ranges32[r0:r1, c0:c1][h]
                m[b, :cnt] = True
        return x, r, m

    def route(self, dirs_world32: np.ndarray, rotation32: np.ndarray):
        """Frame coordinates (q, 2) f32 and the member index of each query,
        -1 where it falls outside the frame."""
        d = dirs_world32 @ rotation32
        az = np.arctan2(d[..., 1], d[..., 0])
        el = np.arctan2(d[..., 2], np.hypot(d[..., 0], d[..., 1]))
        f = self.cfg["frame"]
        ok = np.isfinite(az) & np.isfinite(el) \
            & (az >= f["azimuth_min"]) & (az <= f["azimuth_max"]) \
            & (el >= f["elevation_min"]) & (el <= f["elevation_max"])
        rok = (az[:, None] >= self.row_bounds[None, :, 0]) \
            & (az[:, None] < self.row_bounds[None, :, 1])
        cok = (el[:, None] >= self.col_bounds[None, :, 0]) \
            & (el[:, None] <= self.col_bounds[None, :, 1])
        idx = np.argmax(rok, 1) * len(self.cols) + np.argmax(cok, 1)
        ok &= rok.any(1) & cok.any(1)
        return np.stack([az, el], -1), np.where(ok, idx, -1)


def ou(x1, x2, scale):
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    return torch.exp(-torch.sqrt(torch.sum(diff * diff, -1)) / scale)


class ScanReference:
    """One scan's bank of members fit in ``dtype`` on ``device``."""

    def __init__(self, layout: Layout, ranges32: np.ndarray, *,
                 dtype=torch.float64, device="cpu", tf32: bool = False):
        self.layout, self.dtype, self.tf32 = layout, dtype, tf32
        self.device = torch.device(device)
        cfg = layout.cfg
        x, r, m = layout.gather(ranges32)
        self.count = m.sum(1)
        self.trained = self.count > 0
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.x, self.m = t(x).to(dtype), t(m)
        y = torch.where(self.m, 1.0 / torch.sqrt(t(r).to(dtype)), 0.0)
        eye = torch.eye(layout.width, dtype=dtype, device=self.device)
        with _Tf32(tf32):
            K = ou(self.x, self.x, cfg["kernel_scale"])
            both = self.m[:, :, None] & self.m[:, None, :]
            K = torch.where(both, K, 0.0) + eye * torch.where(
                self.m, cfg["sensor_range_var"], 1.0)[:, :, None]
            L = torch.linalg.cholesky(K)
            self.Linv = torch.linalg.solve_triangular(L, eye.expand_as(L),
                                                      upper=False)
            self.alpha = torch.bmm(self.Linv.mT,
                                   torch.bmm(self.Linv, y[:, :, None]))[..., 0]

    def test(self, dirs_world32: np.ndarray, rotation32: np.ndarray,
             block: int = 2048):
        """(range (q,), variance (q,), valid (q,)) as float64 numpy; an
        invalid query's range is +inf and its variance 0."""
        coords, idx = self.layout.route(dirs_world32, rotation32)
        valid = idx >= 0
        valid[valid] = self.trained[idx[valid]]
        q = len(idx)
        rng, var = np.full(q, np.inf), np.zeros(q)
        sel = np.flatnonzero(valid)
        scale = self.layout.cfg["kernel_scale"]
        for s in range(0, len(sel), block):
            j = sel[s:s + block]
            b = torch.as_tensor(idx[j], device=self.device)
            xq = torch.as_tensor(coords[j], device=self.device).to(self.dtype)
            with _Tf32(self.tf32):
                kt = ou(self.x[b], xq[:, None, :], scale)[..., 0]   # (c, n)
                kt = torch.where(self.m[b], kt, 0.0)
                mean = torch.bmm(kt[:, None, :],
                                 self.alpha[b][:, :, None])[:, 0, 0]
                v = torch.bmm(self.Linv[b], kt[:, :, None])[..., 0]
                vr = torch.clamp(1.0 - torch.sum(v * v, -1), min=0.0)
            m = mean.double().cpu().numpy()
            rng[j] = 1.0 / (m * m)
            var[j] = vr.double().cpu().numpy()
        return rng, var, valid
