"""Frozen input generators of the benchmark: the procedural worlds, a numpy
raycaster, the hotel-0 trajectory set-up, the lidar scan pool and the
per-pose seed schedule.

These are the benchmark's own copies, so that a change to the program
cannot change what the benchmark feeds it. They follow the worlds the
program's tests use (a hotel-room shell with a bed, a desk and a wardrobe
around the Replica hotel-0 trajectory; the reference's 6 x 5 x 3 m office
room for the range-sensor GP) value for value. Plain numpy; nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np


# -- worlds ----------------------------------------------------------------

def box_triangles(vmin, vmax) -> np.ndarray:
    """The 12 triangles (12, 3, 3) of an axis-aligned box."""
    x0, y0, z0 = vmin
    x1, y1, z1 = vmax
    v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]],
                 float)
    quads = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4), (1, 2, 6, 5),
             (2, 3, 7, 6), (3, 0, 4, 7)]
    faces = [f for a, b, c, d in quads for f in ((a, b, c), (a, c, d))]
    return v[np.asarray(faces)]


def hotel_triangles(lo, hi) -> np.ndarray:
    """A hotel-room shell between ``lo`` and ``hi`` with a bed, a desk and
    a wardrobe placed at fixed fractions of its extent."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    ext = hi - lo
    boxes = [(lo, hi)] + [(lo + np.asarray(f0) * ext, lo + np.asarray(f1) * ext)
                          for f0, f1 in (([0.05, 0.07, 0.0], [0.35, 0.37, 0.22]),
                                         ([0.82, 0.43, 0.0], [0.97, 0.70, 0.25]),
                                         ([0.03, 0.84, 0.0], [0.21, 0.97, 0.78]))]
    return np.concatenate([box_triangles(a, b) for a, b in boxes])


def office_triangles() -> np.ndarray:
    """The 6 x 5 x 3 m office room of the range-sensor GP protocol: shell,
    wardrobe, shelf and a low table."""
    boxes = (([-3.0, -2.5, -1.5], [3.0, 2.5, 1.5]),
             ([0.5, 2.1, -1.5], [2.0, 2.5, 0.6]),
             ([-3.0, -1.0, -0.5], [-2.7, 1.0, 0.5]),
             ([0.9, -2.5, -1.5], [2.1, -2.0, -1.1]))
    return np.concatenate([box_triangles(a, b) for a, b in boxes])


def triangles_center(tris: np.ndarray) -> np.ndarray:
    v = tris.reshape(-1, 3)
    return 0.5 * (v.min(0) + v.max(0))


def cast_rays(tris: np.ndarray, origins, directions,
              chunk: int = 16384) -> np.ndarray:
    """Nearest-hit distances of rays against a triangle soup
    (Moller-Trumbore, double-sided); misses are +inf. origins (n, 3) or
    (3,); directions (n, 3), unit."""
    d_all = np.asarray(directions, float).reshape(-1, 3)
    o_all = np.broadcast_to(np.asarray(origins, float).reshape(-1, 3),
                            d_all.shape)
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    out = np.empty(len(d_all))
    for s in range(0, len(d_all), chunk):
        d = d_all[s:s + chunk]
        o = o_all[s:s + chunk]
        p = np.cross(d[:, None, :], e2[None])
        det = np.einsum("tj,ctj->ct", e1, p)
        sv = o[:, None, :] - v0[None]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / det
            u = np.einsum("ctj,ctj->ct", sv, p) * inv
            q = np.cross(sv, e1[None])
            w = np.einsum("ctj,cj->ct", q, d) * inv
            t = np.einsum("tj,ctj->ct", e2, q) * inv
            ok = (np.abs(det) > 1e-14) & (u >= 0) & (u <= 1) & (w >= 0) \
                & (u + w <= 1) & (t > 1e-9)
        out[s:s + chunk] = np.where(ok, t, np.inf).min(axis=1)
    return out


# -- hotel-0 ---------------------------------------------------------------

def hotel0_scene(poses: np.ndarray, cfg: dict) -> dict:
    """The box, the kernel scale, the pseudo points (f32, (M, 3), before
    any padding) and the sensor-frame ray directions of the hotel-0 map
    for a pose set (n, 4, 4)."""
    pos = poses[:, :3, 3]
    lo = pos.min(axis=0) - cfg["box_margin"]
    hi = pos.max(axis=0) + cfg["box_margin"]
    gx, gy, gz = cfg["pseudo_grid"]
    res = (hi - lo) / np.asarray([gx, gy, gz], float)
    axes = [lo[i] + (np.arange(n) + 0.5) * res[i]
            for i, n in enumerate((gx, gy, gz))]
    pseudo = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    nu, nv = cfg["ray_grid"]
    u = np.linspace(-cfg["ray_half_width"][0], cfg["ray_half_width"][0], nu)
    v = np.linspace(-cfg["ray_half_width"][1], cfg["ray_half_width"][1], nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    d_local = np.stack([uu.ravel(), vv.ravel(), np.ones(uu.size)], -1)
    d_local /= np.linalg.norm(d_local, axis=-1, keepdims=True)
    return {"lo": lo, "hi": hi,
            "scale": float((hi - lo).max()) / cfg["scale_divisor"],
            "pseudo": pseudo.astype(np.float32), "d_local": d_local}


def hotel0_scans(poses: np.ndarray, scene: dict, cfg: dict) -> dict:
    """Every pose's depth scan of the hotel shell inset ``mesh_inset`` from
    the box: float32 sensor positions (n, 3), end points (n, rays, 3) with
    misses at the sensor, and hit masks (n, rays)."""
    inset = cfg["mesh_inset"]
    tris = hotel_triangles(scene["lo"] + inset, scene["hi"] - inset)
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    dirs = np.einsum("sij,nj->sni", R, scene["d_local"])       # (S, n, 3)
    rng = cast_rays(tris, np.repeat(t, dirs.shape[1], 0),
                    dirs.reshape(-1, 3)).reshape(dirs.shape[:2])
    hit = np.isfinite(rng) & (rng <= cfg["max_distance"])
    pts = t[:, None] + dirs * np.where(hit, rng, 0.0)[..., None]
    return {"sensors": t.astype(np.float32), "points": pts.astype(np.float32),
            "masks": hit}


def step_seed(seed: int, step: int) -> int:
    """The generator seed of pose ``step`` (counted from 1 in a session) of a
    map seeded with ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, int(step)])
    return int(ss.generate_state(1, np.uint64)[0])


def session_seed(seed: int, session: int) -> int:
    """The map seed of the ``session``-th session of a run."""
    ss = np.random.SeedSequence([int(seed) % 2**64, 1 + int(session)])
    return int(ss.generate_state(1, np.uint32)[0])


def box_queries(lo, hi, inset: float, n: int, rng) -> np.ndarray:
    """``n`` points uniform in the box inset ``inset`` from each face,
    float32 (n, 3)."""
    a = np.asarray(lo, float) + inset
    b = np.asarray(hi, float) - inset
    return rng.uniform(a, b, (n, 3)).astype(np.float32)


# -- the range-sensor GP protocol --------------------------------------------

def euler_rotation(roll, pitch, yaw) -> np.ndarray:
    """R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr, cp, sp, cy, sy = (np.cos(roll), np.sin(roll), np.cos(pitch),
                              np.sin(pitch), np.cos(yaw), np.sin(yaw))
    return (np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
            @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]]))


def lidar_angles(frame: dict, dtype=np.float32):
    """The frame's azimuths and elevations, as the model holds them."""
    az = np.linspace(frame["azimuth_min"], frame["azimuth_max"],
                     frame["num_azimuth_lines"]).astype(dtype)
    el = np.linspace(frame["elevation_min"], frame["elevation_max"],
                     frame["num_elevation_lines"]).astype(dtype)
    return az, el


def lidar_scan_pool(cfg: dict) -> dict:
    """``cfg["scans"]`` lidar scans of the office room from seeded poses
    (roll and pitch within pi/4, any yaw; position within ``position_jitter``
    of the room's center): rotations (S, 3, 3), positions (S, 3) and ranges
    (S, n_az, n_el), float64."""
    tris = office_triangles()
    az, el = lidar_angles(cfg["frame"], np.float64)
    ca, sa = np.cos(az)[:, None], np.sin(az)[:, None]
    ce, se = np.cos(el)[None, :], np.sin(el)[None, :]
    dirs_f = np.stack([ca * ce, sa * ce, np.broadcast_to(se, (az.size, el.size))],
                      -1).reshape(-1, 3)
    rng = np.random.default_rng(cfg["scan_pool_seed"])
    center = triangles_center(tris)
    Rs, ts = [], []
    for _ in range(cfg["scans"]):
        rpy = rng.uniform(-1, 1, 3) * np.array([np.pi / 4, np.pi / 4, np.pi])
        Rs.append(euler_rotation(*rpy))
        ts.append(center + rng.uniform(-1, 1, 3) * cfg["position_jitter"])
    Rs, ts = np.stack(Rs), np.stack(ts)
    dirs = np.einsum("sij,nj->sni", Rs, dirs_f)
    ranges = cast_rays(tris, np.repeat(ts, dirs_f.shape[0], 0),
                       dirs.reshape(-1, 3))
    return {"rotations": Rs, "positions": ts,
            "ranges": ranges.reshape(cfg["scans"], az.size, el.size)}


def sphere_queries(n: int, rng) -> np.ndarray:
    """``n`` world directions, azimuth uniform in [-pi, pi) and elevation
    uniform in [-pi/2, pi/2), as the reference's protocol draws them."""
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(-np.pi / 2, np.pi / 2, n)
    return np.stack([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el),
                     np.sin(el)], -1)
