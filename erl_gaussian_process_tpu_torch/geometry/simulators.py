"""Procedural worlds and simulated sensors (counterpart of
``erl_gaussian_process_tpu/geometry/simulators.py``): the 2D polygon world,
lidar and reference trajectory of the 2D occupancy map, and the 3D triangle
soups of the hotel-0 replay and the 3D range-sensor GP protocols. Host-side;
they synthesize data. Both ray casters run the native OpenMP raycasters of
``utils/native.py`` when that library is available, as the JAX module does,
and numpy otherwise."""

from __future__ import annotations

import dataclasses

import numpy as np


class Space2D:
    """A set of closed polylines (obstacle boundaries + an enclosing box)."""

    def __init__(self, polygons):
        """polygons: list of (k_i, 2) vertex arrays, each a closed loop."""
        self.polygons = [np.asarray(p, float) for p in polygons]
        self.seg_a = np.concatenate(self.polygons, axis=0)        # (S, 2)
        self.seg_b = np.concatenate(
            [np.roll(p, -1, axis=0) for p in self.polygons], axis=0)

    @property
    def surface_vertices(self):
        return np.concatenate(self.polygons, axis=0)

    def surface_points(self, spacing: float):
        """Uniformly resampled points along every boundary."""
        pts = []
        for poly in self.polygons:
            a, b = poly, np.roll(poly, -1, axis=0)
            for pa, pb in zip(a, b):
                L = np.linalg.norm(pb - pa)
                k = max(1, int(L / spacing))
                t = np.arange(k) / k
                pts.append(pa + t[:, None] * (pb - pa))
        return np.concatenate(pts, axis=0)

    def cast_rays(self, origin, directions, max_range=np.inf):
        """origin (2,), directions (R, 2) unit; returns ranges (R,), inf
        where no segment is hit within max_range. The native raycaster
        when it is available, numpy otherwise."""
        from erl_gaussian_process_tpu_torch.utils.native import (
            native_available,
            raycast_2d,
        )

        o = np.asarray(origin, float)
        d = np.asarray(directions, float)          # (R, 2)
        if native_available():
            segs = np.concatenate([self.seg_a, self.seg_b], axis=1)
            ang = np.arctan2(d[:, 1], d[:, 0])
            mr = float(min(max_range, 1e30))
            r = raycast_2d(segs, np.broadcast_to(o, (len(d), 2)), ang, mr)
            return np.where(r >= 1e30, np.inf, r)
        a = self.seg_a[None, :, :]                 # (1, S, 2)
        ab = (self.seg_b - self.seg_a)[None, :, :]
        ao = o[None, None, :] - a
        dd = d[:, None, :]                         # (R, 1, 2)
        denom = dd[..., 0] * (-ab[..., 1]) + dd[..., 1] * ab[..., 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (ao[..., 0] * (-ab[..., 1]) + ao[..., 1] * ab[..., 0]) / -denom
            s = (dd[..., 0] * ao[..., 1] - dd[..., 1] * ao[..., 0]) / -denom
        hit = (np.abs(denom) > 1e-14) & (t > 1e-9) & (s >= 0.0) & (s <= 1.0)
        t = np.where(hit, t, np.inf)
        r = t.min(axis=1)
        return np.where(r <= max_range, r, np.inf)


@dataclasses.dataclass
class Lidar2DSetting:
    min_angle: float = -np.pi
    max_angle: float = np.pi
    num_lines: int = 360
    max_range: float = np.inf


class Lidar2D:
    """A 2D lidar in a :class:`Space2D`."""

    Setting = Lidar2DSetting

    def __init__(self, setting: Lidar2DSetting, space: Space2D):
        self.setting = setting
        self.space = space
        self.angles = np.linspace(
            setting.min_angle, setting.max_angle, setting.num_lines)

    def ray_directions_in_frame(self):
        return np.stack([np.cos(self.angles), np.sin(self.angles)], axis=-1)

    def scan(self, pose_angle: float, position) -> np.ndarray:
        c, s = np.cos(pose_angle), np.sin(pose_angle)
        rot = np.array([[c, -s], [s, c]])
        dirs = self.ray_directions_in_frame() @ rot.T
        return self.space.cast_rays(position, dirs, self.setting.max_range)


def reference_space_2d() -> Space2D:
    """The reference's 2D map world: two circles inside a 4x4 box."""
    def circle(r, cx, cy, n):
        a = np.arange(n) * (2 * np.pi / n)
        return np.stack([r * np.cos(a) + cx, r * np.sin(a) + cy], axis=-1)

    n = 40
    half = 2.0
    v = -half + 2 * half * np.arange(n) / n
    box = np.concatenate([
        np.stack([np.full(n, -half), v], axis=-1),
        np.stack([v, np.full(n, half)], axis=-1),
        np.stack([np.full(n, half), -v], axis=-1),
        np.stack([-v, np.full(n, -half)], axis=-1),
    ], axis=0)
    return Space2D([circle(0.3, -1.0, 0.2, 50), circle(0.8, 0.3, 0.0, 100),
                    box])


def reference_trajectory_2d(n: int = 50, repeats: int = 1) -> np.ndarray:
    """The elliptical n-pose trajectory (x, y, heading) of the 2D map."""
    a, b = 1.6, 1.2
    ang = 2 * np.pi * np.arange(n) / n
    xy = np.stack([a * np.cos(ang), b * np.sin(ang)], axis=-1)
    heading = np.zeros(n)
    heading[1:] = np.arctan2(np.diff(xy[:, 1]), np.diff(xy[:, 0]))
    traj = np.concatenate([xy, heading[:, None]], axis=-1)
    return np.tile(traj, (repeats, 1))


def lidar_scan_points_2d(lidar: Lidar2D, pose):
    """One scan of ``lidar`` from pose (x, y, heading): the ranges (R,),
    the world end points (R, 2), with misses at the sensor, and the hit
    mask (R,) — the 2D map's inputs per pose."""
    r = lidar.scan(pose[2], pose[:2])
    c, s = np.cos(pose[2]), np.sin(pose[2])
    dirs = lidar.ray_directions_in_frame() @ np.array([[c, -s], [s, c]]).T
    hit = np.isfinite(r)
    return r, pose[:2] + dirs * np.where(hit, r, 0.0)[:, None], hit


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

    def center(self) -> np.ndarray:
        return 0.5 * (self.vertices.min(0) + self.vertices.max(0))

    def cast_rays(self, origin, directions, max_range=np.inf) -> np.ndarray:
        """origin (3,) or (n, 3); directions (n, 3) unit. Misses -> +inf."""
        from erl_gaussian_process_tpu_torch.utils.native import raycast_mesh

        return raycast_mesh(self.triangles, origin, directions, max_range)

    def surface_points(self, per_triangle: int, rng=None) -> np.ndarray:
        """``per_triangle`` * F points drawn uniformly on the surface
        (triangles picked by area), for map-quality gates; ``rng`` seeds
        ``np.random.default_rng``, whose draws (pick, then barycentric
        pairs) are those of the JAX package's sampler."""
        rng = np.random.default_rng(rng)
        t = self.triangles
        area = 0.5 * np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1)
        n = per_triangle * self.num_triangles
        pick = rng.choice(self.num_triangles, n, p=area / area.sum())
        u = rng.uniform(0, 1, (n, 2))
        flip = u.sum(1) > 1          # fold the unit square onto the triangle
        u[flip] = 1.0 - u[flip]
        tp = t[pick]
        return (tp[:, 0] + u[:, :1] * (tp[:, 1] - tp[:, 0])
                + u[:, 1:] * (tp[:, 2] - tp[:, 0]))

    @staticmethod
    def _quad(a, b, c, d):
        """Two triangles for the quad a-b-c-d."""
        return [[a, b, c], [a, c, d]]

    @classmethod
    def box(cls, vmin, vmax, inward: bool = False) -> "TriangleMesh":
        """Axis-aligned box. ``inward`` (a room shell) changes nothing: the
        raycaster is double-sided."""
        del inward
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


def reference_room_mesh_3d() -> TriangleMesh:
    """Procedural stand-in for the Replica office-1 mesh of the reference's
    3D sensor-GP protocols (the .ply is not distributed): a 6x5x3 room
    shell with wall-flush, shallow furniture (wardrobe, shelf, low table),
    whose silhouette depth steps stay ~0.3-0.4 m, like a scanned office
    seen from its center."""
    room = TriangleMesh.box([-3.0, -2.5, -1.5], [3.0, 2.5, 1.5])
    wardrobe = TriangleMesh.box([0.5, 2.1, -1.5], [2.0, 2.5, 0.6])
    shelf = TriangleMesh.box([-3.0, -1.0, -0.5], [-2.7, 1.0, 0.5])
    table = TriangleMesh.box([0.9, -2.5, -1.5], [2.1, -2.0, -1.1])
    return TriangleMesh.merge([room, wardrobe, shelf, table])


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
