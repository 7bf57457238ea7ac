"""Procedural 3D world for the hotel-0 replay (counterpart of
``erl_gaussian_process_tpu/geometry/simulators.py:111-219``): a triangle
soup with a numpy Möller–Trumbore raycaster. Host-side only; it
synthesizes data. The JAX package's native OpenMP raycaster is not ported
yet (ROADMAP.md, Queue 1 item 5), so ``cast_rays`` is the vectorized numpy
version of ``erl_gaussian_process_tpu/utils/native.py:286-339``."""

from __future__ import annotations

import numpy as np


def raycast_mesh(triangles: np.ndarray, origins: np.ndarray,
                 directions: np.ndarray,
                 max_range: float = np.inf) -> np.ndarray:
    """Nearest-hit distances for rays vs a triangle soup; misses are +inf.

    triangles: (t, 3, 3) or (t, 9) [v0 v1 v2]; origins: (n, 3) or (3,);
    directions: (n, 3) unit. Chunked over rays to bound the (chunk, t)
    temporaries."""
    tris = np.ascontiguousarray(
        np.asarray(triangles, np.float64).reshape(-1, 9))
    dirs = np.ascontiguousarray(np.asarray(directions, np.float64)
                                .reshape(-1, 3))
    orig = np.ascontiguousarray(np.broadcast_to(
        np.asarray(origins, np.float64).reshape(-1, 3), (len(dirs), 3)))
    mr = float(min(max_range, 1e300))
    if len(tris) == 0:
        return np.full(len(dirs), np.inf)
    v0 = tris[:, 0:3]
    e1 = tris[:, 3:6] - v0
    e2 = tris[:, 6:9] - v0
    out = np.empty(len(dirs), np.float64)
    chunk = max(1, int(4e6 // len(tris)))
    for s in range(0, len(dirs), chunk):
        d = dirs[s:s + chunk]                         # (c, 3)
        o = orig[s:s + chunk]
        p = np.cross(d[:, None, :], e2[None, :, :])   # (c, T, 3)
        det = np.einsum("tj,ctj->ct", e1, p)
        sv = o[:, None, :] - v0[None, :, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / det
            u = np.einsum("ctj,ctj->ct", sv, p) * inv
            q = np.cross(sv, e1[None, :, :])
            w = np.einsum("ctj,ctj->ct", q * inv[..., None], d[:, None, :])
            t = np.einsum("tj,ctj->ct", e2, q) * inv
        ok = (np.abs(det) > 1e-14) & (u >= 0) & (u <= 1) & (w >= 0) \
            & (u + w <= 1) & (t > 1e-9) & (t < mr)
        t = np.where(ok, t, np.inf)
        out[s:s + chunk] = t.min(axis=1)
    return out


class TriangleMesh:
    """3D triangle-soup world with a host raycaster."""

    def __init__(self, vertices, faces):
        """vertices (V, 3); faces (F, 3) int indices."""
        self.vertices = np.asarray(vertices, float)
        self.faces = np.asarray(faces, int)
        self.triangles = self.vertices[self.faces]     # (F, 3, 3)

    @property
    def num_triangles(self) -> int:
        return self.faces.shape[0]

    def cast_rays(self, origin, directions, max_range=np.inf) -> np.ndarray:
        """origin (3,) or (n, 3); directions (n, 3) unit. Misses -> +inf."""
        return raycast_mesh(self.triangles, origin, directions, max_range)

    @staticmethod
    def _quad(a, b, c, d):
        """Two triangles for the quad a-b-c-d."""
        return [[a, b, c], [a, c, d]]

    @classmethod
    def box(cls, vmin, vmax) -> "TriangleMesh":
        """Axis-aligned box (the raycaster is double-sided)."""
        x0, y0, z0 = vmin
        x1, y1, z1 = vmax
        v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                      [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]])
        f = []
        f += cls._quad(0, 1, 2, 3)    # floor
        f += cls._quad(4, 5, 6, 7)    # ceiling
        f += cls._quad(0, 1, 5, 4)
        f += cls._quad(1, 2, 6, 5)
        f += cls._quad(2, 3, 7, 6)
        f += cls._quad(3, 0, 4, 7)
        return cls(v, np.asarray(f))

    @staticmethod
    def merge(meshes) -> "TriangleMesh":
        vs, fs, off = [], [], 0
        for m in meshes:
            vs.append(m.vertices)
            fs.append(m.faces + off)
            off += m.vertices.shape[0]
        return TriangleMesh(np.concatenate(vs), np.concatenate(fs))


def replica_hotel_like_mesh(lo=None, hi=None) -> TriangleMesh:
    """Procedural hotel-room-scale mesh for the 983-pose replica-hotel-0
    trajectory replay (the trajectory ships in ``data/``; the mesh does
    not). ``lo``/``hi`` size the shell (default a 6.6x7.4x3.2 room);
    furniture (bed, desk, wardrobe) is placed proportionally inside."""
    lo = np.asarray([-3.2, -4.4, -1.6] if lo is None else lo, float)
    hi = np.asarray([3.4, 3.0, 1.6] if hi is None else hi, float)
    ext = hi - lo

    def frac_box(f0, f1):
        return TriangleMesh.box(lo + np.asarray(f0) * ext,
                                lo + np.asarray(f1) * ext)

    shell = TriangleMesh.box(lo, hi)
    bed = frac_box([0.05, 0.07, 0.0], [0.35, 0.37, 0.22])
    desk = frac_box([0.82, 0.43, 0.0], [0.97, 0.70, 0.25])
    wardrobe = frac_box([0.03, 0.84, 0.0], [0.21, 0.97, 0.78])
    return TriangleMesh.merge([shell, bed, desk, wardrobe])
