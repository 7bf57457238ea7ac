"""Plain reference of the 3D SPGP occupancy map (``hotel0_spgp3d``).

The map's equations (FITC over fixed pseudo points):

    init:    K_M = k(P, P);  L = chol(K_M);  Q_M = K_M;  alpha = 0
    update:  lambda_i = max(1 - ||L^-1 k_i||^2, 0),  w_i = 1 / (lambda_i + var)
             Q_M += K_MN diag(w) K_MN^T;  alpha += K_MN diag(w) y
    predict: mean(x*) = k(P, x*)^T Q_M^-1 alpha, and its gradient in x*
             (Q_M^-1 alpha by an LU solve, which a control's Q_M that
             rounding left indefinite still takes)

with k the Matern-3/2 kernel (1 + c r) exp(-c r), c = sqrt(3) / scale.

One pose's dataset: each ray's end point when it lies in the box and within
[min_distance, max_distance] of the sensor (label occupied), then
``free_slots`` candidates per ray at fractions u of the ray (label free),
slot j active when j < free_points_per_meter * (ray length capped at
max_distance) and the point lies in the box; the first ``max_samples``
active slots in slot order (hits first, then ray-major free slots) are
kept. The sampler runs in float32 with the operations in the order the
map's definition gives them, so that a slot is active here exactly when it
is active in a float32 map; u comes from ``torch.rand`` on a generator
seeded with the pose's ``worlds.step_seed``, on the map's device.

Everything after the sampler runs in ``dtype`` (float64 for the
reference). ``tf32=True`` with float32 is the control: the same
computation with TF32 matrix products. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.worlds import step_seed


def pad_pseudo(p: np.ndarray, multiple: int) -> np.ndarray:
    """Pad (M, d) pseudo points to a multiple of ``multiple`` rows with
    points far enough away that the kernel between them and anything else
    is exactly 0: row i of the padding at 1e15 * (i + 2) in every
    coordinate."""
    m, d = p.shape
    m_pad = -(-m // multiple) * multiple
    pad = (np.arange(m_pad - m, dtype=p.dtype) + 2.0)[:, None] \
        * p.dtype.type(1e15) * np.ones((1, d), p.dtype)
    return np.concatenate([p, pad])


def free_fractions(seed: int, steps, rays: int, slots: int, margin: float,
                   device) -> np.ndarray:
    """(len(steps), rays, slots) float32 fractions in [margin, 1 - margin):
    pose ``step``'s draw from a generator seeded with step_seed(seed,
    step)."""
    g = torch.Generator(device=device)
    span, lo = (1.0 - margin) - margin, margin
    out = []
    for s in steps:
        g.manual_seed(step_seed(seed, s))
        out.append(torch.rand((rays, slots), generator=g, device=device,
                              dtype=torch.float32) * span + lo)
    return torch.stack(out).cpu().numpy()


def sample_pose(sensor, points, mask, amin, amax, u, cfg):
    """One pose's dataset in float32: (points (n, 3) f32, labels (n,) in
    {+1, -1} for occupied and free) of the active slots kept, in slot
    order. sensor (3,), points (rays, 3), mask (rays,), amin/amax (3,),
    all float32; u (rays, slots) float32."""
    f32 = np.float32
    p = np.where(mask[:, None], points, f32(0))
    delta = [p[:, k] - sensor[k] for k in range(3)]
    dist = np.sqrt((delta[0] * delta[0] + delta[1] * delta[1])
                   + delta[2] * delta[2])
    pos = dist > 0
    inv = np.where(pos, f32(1) / np.where(pos, dist, f32(1)), f32(0))
    finite = mask & np.isfinite(dist) & pos
    in_box = finite.copy()
    for k in range(3):
        in_box &= (p[:, k] >= amin[k]) & (p[:, k] <= amax[k])
    dmin, dmax = f32(cfg["min_distance"]), f32(cfg["max_distance"])
    hit_ok = in_box & (dist >= dmin) & (dist <= dmax)
    free_len = np.minimum(dist, dmax)
    free_ray = finite & (dist >= dmin)
    t = u * (free_len * inv)[:, None]
    free = [sensor[k] + t * delta[k][:, None] for k in range(3)]
    slot = np.arange(u.shape[1], dtype=f32)[None, :]
    n_free = f32(cfg["free_points_per_meter"]) * free_len
    free_ok = free_ray[:, None] & (slot < n_free[:, None])
    for k in range(3):
        free_ok &= (free[k] >= amin[k]) & (free[k] <= amax[k])
    pts = np.concatenate([p, np.stack([f.ravel() for f in free], -1)])
    lbl = np.concatenate([np.ones(len(p), f32), -np.ones(free_ok.size, f32)])
    act = np.flatnonzero(np.concatenate([hit_ok, free_ok.ravel()]))
    act = act[:cfg["max_num_samples"]]
    return pts[act], lbl[act]


def box_f32(lo, hi):
    """The map box's corners as the float32 map holds them (center and
    half sizes in float64, then rounded)."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    c, h = (lo + hi) / 2, (hi - lo) / 2
    return (c - h).astype(np.float32), (c + h).astype(np.float32)


def matern32(x1, x2, scale):
    c = math.sqrt(3.0) / scale
    diff = x1[:, None, :] - x2[None, :, :]
    r = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return (1.0 + c * r) * torch.exp(-c * r)


class MapReference:
    """The map's state in ``dtype`` on ``device``, updated pose by pose
    with datasets from :func:`sample_pose`."""

    def __init__(self, pseudo32: np.ndarray, scale: float, cfg: dict, *,
                 dtype=torch.float64, device="cpu", tf32: bool = False):
        self.cfg, self.scale, self.dtype = cfg, float(scale), dtype
        self.device = torch.device(device)
        self.tf32 = tf32
        p = pad_pseudo(pseudo32, cfg["pad_multiple"])
        self.P = torch.as_tensor(p, device=self.device).to(dtype)
        with self._precision():
            K = matern32(self.P, self.P, self.scale)
            L = torch.linalg.cholesky(K)
            eye = torch.eye(len(p), dtype=dtype, device=self.device)
            self.Linv = torch.linalg.solve_triangular(L, eye, upper=False)
            self.Q = K.clone()
        self.alpha = torch.zeros((len(p), 1), dtype=dtype, device=self.device)

    def _precision(self):
        return _Tf32(self.tf32)

    def update(self, x32: np.ndarray, y32: np.ndarray) -> None:
        """One pose's FITC update; y32 > 0 marks the occupied samples."""
        if len(x32) == 0:
            return
        x = torch.as_tensor(x32, device=self.device).to(self.dtype)
        occ = torch.as_tensor(y32 > 0, device=self.device)[:, None]
        y = torch.where(occ, self.cfg["logodd_occupied"],
                        self.cfg["logodd_free"]).to(self.dtype)
        with self._precision():
            kmn = matern32(self.P, x, self.scale)
            beta = self.Linv @ kmn
            lam = torch.clamp(1.0 - torch.sum(beta * beta, dim=0), min=0.0)
            ks = kmn / (lam + self.cfg["logodd_variance"])
            self.Q += ks @ kmn.T
            self.alpha += ks @ y

    def predict(self, xq32: np.ndarray):
        """(mean (q,), gradient (q, 3)) of the current state, as float64
        numpy."""
        return predict_state(self.P, self.scale, self.Q, self.alpha, xq32,
                             tf32=self.tf32)


def predict_state(P, scale: float, Q, alpha, xq32: np.ndarray, *,
                  tf32: bool = False):
    """The posterior mean (q,) and its gradient (q, 3) at ``xq32`` of the
    state (Q_M, alpha) over the padded pseudo points ``P``, computed in
    P's dtype on P's device; float64 numpy out."""
    P = torch.as_tensor(P)
    Q = torch.as_tensor(Q, device=P.device).to(P.dtype)
    alpha = torch.as_tensor(alpha, device=P.device).to(P.dtype)
    xq = torch.as_tensor(xq32, device=P.device).to(P.dtype)
    c = math.sqrt(3.0) / scale
    with _Tf32(tf32):
        a = torch.linalg.solve(Q, alpha)
        diff = P[:, None, :] - xq[None, :, :]                    # (M, q, 3)
        r = torch.sqrt(torch.sum(diff * diff, dim=-1))
        e = torch.exp(-c * r)
        mean = ((1.0 + c * r) * e).T @ a                         # (q, 1)
        wgt = (c * c) * e * a                                    # (M, q)
        grad = wgt.T @ P - torch.sum(wgt, 0)[:, None] * xq
    return mean[:, 0].double().cpu().numpy(), grad.double().cpu().numpy()


class _Tf32:
    """Allow TF32 matrix products inside the block when ``on``; restore
    the setting after it."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


def replay_session(scene: dict, scans: dict, cfg: dict, map_seed: int,
                   poses, keep_at=None, *, dtype=torch.float64, device="cpu",
                   tf32: bool = False) -> dict:
    """Replay a session's ``poses`` (indices into the scans, in order; pose
    k of the session is step k + 1 of the map seed) into a fresh
    :class:`MapReference`. ``keep_at`` maps session positions to query
    points (q, 3) predicted right after that position's update. Returns the
    samples used per pose, the final (Q_M, alpha), and at each kept
    position the prediction and the state, all as float64 numpy."""
    amin, amax = box_f32(scene["lo"], scene["hi"])
    rays = scans["masks"].shape[1]
    u = free_fractions(map_seed, range(1, len(poses) + 1), rays,
                       cfg["free_slots_per_ray"], cfg["free_sampling_margin"],
                       device)
    ref = MapReference(scene["pseudo"], scene["scale"], cfg, dtype=dtype,
                       device=device, tf32=tf32)
    used, preds = [], {}
    keep = dict(keep_at or {})
    for k, i in enumerate(poses):
        x, y = sample_pose(scans["sensors"][i], scans["points"][i],
                           scans["masks"][i], amin, amax, u[k], cfg)
        used.append(len(x))
        ref.update(x, y)
        if k in keep:
            preds[k] = (*ref.predict(keep[k]), ref.Q.double().cpu().numpy(),
                        ref.alpha.double().cpu().numpy())
    return {"used": np.asarray(used), "preds": preds,
            "qm": ref.Q.double().cpu().numpy(),
            "alpha": ref.alpha.double().cpu().numpy()}
