"""Native host runtime (ctypes over ``csrc/host/erl_gp_native.cpp``),
counterpart of ``erl_gaussian_process_tpu/utils/native.py``.

The lidar-log parser, the token checkpoint writer and reader (the ``.egpt``
format of ``utils/serialization.py``) and the OpenMP 2D and 3D raycasters,
with numpy signatures. The C++ source is this package's own copy; it is
compiled at first use with the host's ``c++ -O3 -std=c++17 -shared -fPIC
-fopenmp`` into ``erl_gaussian_process_tpu_torch/_build/host/<source
hash>/`` and loaded with ctypes. Every entry point has a Python path,
taken when no C++ compiler is there or ``ERL_GP_NO_NATIVE`` is set;
:func:`native_available` tells which one runs. Both paths read and write
the same token bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG_DIR, "csrc", "host", "erl_gp_native.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build", "host")

_lib: Optional[ctypes.CDLL] = None
_tried = False

_DTYPE_CODES: List[Tuple[np.dtype, int]] = [
    (np.dtype(np.float64), 0), (np.dtype(np.float32), 1),
    (np.dtype(np.int64), 2), (np.dtype(np.int32), 3),
    (np.dtype(np.uint8), 4), (np.dtype(np.bool_), 5),
    (np.dtype(np.uint32), 6), (np.dtype(np.uint64), 7),
    (np.dtype(np.int16), 8), (np.dtype(np.uint16), 9),
    (np.dtype(np.int8), 10), (np.dtype(np.float16), 11),
]
_TO_CODE = {dt: c for dt, c in _DTYPE_CODES}
_FROM_CODE = {c: dt for dt, c in _DTYPE_CODES}


def _build_path(src: str) -> str:
    """The library's path under ``_build/host/``, keyed by the source's
    hash so an edited source rebuilds."""
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, h, "erl_gp_native.so")


def _compile(src: str, out: str) -> bool:
    """Compile ``src`` into ``out`` with the first C++ compiler that works,
    with OpenMP if it takes it; False if none does. The library is written
    to a temporary file and moved into place, so processes that build at
    once never load a half-written one."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    for cc in ("c++", "g++", "clang++"):
        for extra in (["-fopenmp"], []):
            try:
                with tempfile.TemporaryDirectory(
                        dir=os.path.dirname(out)) as td:
                    tmp = os.path.join(td, "lib.so")
                    subprocess.run(
                        [cc, "-O3", "-std=c++17", "-shared", "-fPIC",
                         *extra, src, "-o", tmp],
                        check=True, capture_output=True, timeout=180)
                    os.replace(tmp, out)
                return True
            except (OSError, subprocess.SubprocessError):
                continue
    return False


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.egp_version.restype = c.c_int
    lib.egp_log_open.restype = c.c_void_p
    lib.egp_log_open.argtypes = [c.c_char_p, c.c_int]
    lib.egp_log_num_frames.restype = c.c_int64
    lib.egp_log_num_frames.argtypes = [c.c_void_p]
    lib.egp_log_frame_numel.restype = c.c_int64
    lib.egp_log_frame_numel.argtypes = [c.c_void_p, c.c_int64]
    lib.egp_log_frame_pose_size.restype = c.c_int64
    lib.egp_log_frame_pose_size.argtypes = [c.c_void_p, c.c_int64]
    lib.egp_log_frame.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                  c.c_void_p, c.c_void_p]
    lib.egp_log_close.argtypes = [c.c_void_p]
    lib.egp_ckpt_write.restype = c.c_int
    lib.egp_ckpt_write.argtypes = [
        c.c_char_p, c.c_int64, c.POINTER(c.c_char_p), c.POINTER(c.c_uint32),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint64),
        c.POINTER(c.c_void_p), c.POINTER(c.c_uint64)]
    lib.egp_ckpt_open.restype = c.c_void_p
    lib.egp_ckpt_open.argtypes = [c.c_char_p]
    lib.egp_ckpt_num.restype = c.c_int64
    lib.egp_ckpt_num.argtypes = [c.c_void_p]
    lib.egp_ckpt_name.restype = c.c_char_p
    lib.egp_ckpt_name.argtypes = [c.c_void_p, c.c_int64]
    lib.egp_ckpt_dtype.restype = c.c_uint32
    lib.egp_ckpt_dtype.argtypes = [c.c_void_p, c.c_int64]
    lib.egp_ckpt_ndim.restype = c.c_uint32
    lib.egp_ckpt_ndim.argtypes = [c.c_void_p, c.c_int64]
    lib.egp_ckpt_shape.argtypes = [c.c_void_p, c.c_int64,
                                   c.POINTER(c.c_uint64)]
    lib.egp_ckpt_nbytes.restype = c.c_uint64
    lib.egp_ckpt_nbytes.argtypes = [c.c_void_p, c.c_int64]
    lib.egp_ckpt_data.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
    lib.egp_ckpt_close.argtypes = [c.c_void_p]
    lib.egp_raycast_2d.argtypes = [
        c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p, c.c_int64,
        c.c_double, c.c_void_p]
    lib.egp_raycast_mesh.argtypes = [
        c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p, c.c_int64,
        c.c_double, c.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if it cannot be
    built here or ``ERL_GP_NO_NATIVE`` is set."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("ERL_GP_NO_NATIVE"):
        return None
    so = _build_path(SRC)
    if not os.path.exists(so) and not _compile(SRC, so):
        return None
    try:
        _lib = _declare(ctypes.CDLL(so))
    except OSError:
        return None
    return _lib


def native_available() -> bool:
    """True when the native library is built and loaded; False when the
    Python paths below run instead."""
    return get_lib() is not None


# ------------------------------------------------------------- lidar log

def load_lidar_log_native(path: str, dtype=np.float64):
    """Native parse of the log ``utils/loaders.load_lidar_log`` reads:
    the frames as (angles, ranges, pose_flat) float64 tuples, or None if
    the library is not available."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.egp_log_open(path.encode(), 0 if np.dtype(dtype) == np.float64
                         else 1)
    if not h:
        raise IOError(f"native lidar-log parse failed: {path}")
    try:
        out = []
        for i in range(lib.egp_log_num_frames(h)):
            n = lib.egp_log_frame_numel(h, i)
            ps = lib.egp_log_frame_pose_size(h, i)
            angles = np.empty(n, np.float64)
            ranges = np.empty(n, np.float64)
            pose = np.empty(ps, np.float64)
            lib.egp_log_frame(h, i, angles.ctypes.data, ranges.ctypes.data,
                              pose.ctypes.data)
            out.append((angles, ranges, pose))
        return out
    finally:
        lib.egp_log_close(h)


# --------------------------------------------------------- token checkpoint

def save_tokens(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write a token-tagged binary checkpoint (EGPT format). Uses the native
    writer when available, else the struct-compatible Python writer."""
    items = [(k, np.ascontiguousarray(v)) for k, v in arrays.items()]
    for k, v in items:
        if v.dtype not in _TO_CODE:
            raise TypeError(f"unsupported dtype {v.dtype} for {k!r}")
    lib = get_lib()
    if lib is not None:
        n = len(items)
        names = (ctypes.c_char_p * n)(*[k.encode() for k, _ in items])
        dtypes = (ctypes.c_uint32 * n)(*[_TO_CODE[v.dtype] for _, v in items])
        ndims = (ctypes.c_uint32 * n)(*[v.ndim for _, v in items])
        shape_flat = [d for _, v in items for d in v.shape]
        shapes = (ctypes.c_uint64 * max(len(shape_flat), 1))(*shape_flat)
        datas = (ctypes.c_void_p * n)(*[v.ctypes.data for _, v in items])
        nbytes = (ctypes.c_uint64 * n)(*[v.nbytes for _, v in items])
        rc = lib.egp_ckpt_write(path.encode(), n, names, dtypes, ndims,
                                shapes, datas, nbytes)
        if rc != 0:
            raise IOError(f"native checkpoint write failed ({rc}): {path}")
        return
    import struct
    with open(path, "wb") as f:
        f.write(b"EGPT")
        f.write(struct.pack("<IQ", 1, len(items)))
        for k, v in items:
            nb = k.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<II", _TO_CODE[v.dtype], v.ndim))
            f.write(struct.pack(f"<{v.ndim}Q", *v.shape))
            f.write(struct.pack("<Q", v.nbytes))
            f.write(v.tobytes())


def load_tokens(path: str) -> Dict[str, np.ndarray]:
    lib = get_lib()
    if lib is not None:
        h = lib.egp_ckpt_open(path.encode())
        if not h:
            raise IOError(f"native checkpoint parse failed: {path}")
        try:
            out = {}
            for i in range(lib.egp_ckpt_num(h)):
                name = lib.egp_ckpt_name(h, i).decode()
                dt = _FROM_CODE[lib.egp_ckpt_dtype(h, i)]
                nd = lib.egp_ckpt_ndim(h, i)
                shape = (ctypes.c_uint64 * max(nd, 1))()
                if nd:
                    lib.egp_ckpt_shape(h, i, shape)
                arr = np.empty(tuple(shape[:nd]), dt)
                assert arr.nbytes == lib.egp_ckpt_nbytes(h, i), name
                lib.egp_ckpt_data(h, i, arr.ctypes.data)
                out[name] = arr
            return out
        finally:
            lib.egp_ckpt_close(h)
    import struct
    out = {}
    with open(path, "rb") as f:
        assert f.read(4) == b"EGPT", path
        _, n = struct.unpack("<IQ", f.read(12))
        for _ in range(n):
            (name_len,) = struct.unpack("<I", f.read(4))
            name = f.read(name_len).decode()
            code, nd = struct.unpack("<II", f.read(8))
            shape = struct.unpack(f"<{nd}Q", f.read(8 * nd)) if nd else ()
            (nbytes,) = struct.unpack("<Q", f.read(8))
            arr = np.frombuffer(f.read(nbytes),
                                _FROM_CODE[code]).reshape(shape).copy()
            out[name] = arr
    return out


# --------------------------------------------------------------- raycaster

def raycast_2d(segments: np.ndarray, origins: np.ndarray,
               angles: np.ndarray, max_range: float) -> np.ndarray:
    """Nearest-hit distances for rays vs a 2D segment soup; misses are +inf.

    segments: (s, 4) [x1 y1 x2 y2]; origins: (n, 2); angles: (n,).
    Native (OpenMP) when available, else vectorized numpy.
    """
    segs = np.ascontiguousarray(segments, np.float64)
    orig = np.ascontiguousarray(np.broadcast_to(
        np.asarray(origins, np.float64).reshape(-1, 2),
        (len(angles), 2)))
    ang = np.ascontiguousarray(angles, np.float64)
    lib = get_lib()
    if lib is not None:
        out = np.empty(len(ang), np.float64)
        lib.egp_raycast_2d(segs.ctypes.data, len(segs), orig.ctypes.data,
                           ang.ctypes.data, len(ang), float(max_range),
                           out.ctypes.data)
        return out
    # numpy fallback: (n_rays, n_segs) broadcast
    d = np.stack([np.cos(ang), np.sin(ang)], -1)            # (n, 2)
    e = segs[:, 2:4] - segs[:, 0:2]                          # (s, 2)
    q = segs[None, :, 0:2] - orig[:, None, :]                # (n, s, 2)
    denom = d[:, None, 0] * e[None, :, 1] - d[:, None, 1] * e[None, :, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (q[..., 0] * e[None, :, 1] - q[..., 1] * e[None, :, 0]) / denom
        u = (q[..., 0] * d[:, None, 1] - q[..., 1] * d[:, None, 0]) / denom
    ok = (np.abs(denom) > 1e-15) & (t >= 0) & (u >= 0) & (u <= 1) & \
         (t < max_range)
    t = np.where(ok, t, np.inf)
    return t.min(axis=1)


def raycast_mesh(triangles: np.ndarray, origins: np.ndarray,
                 directions: np.ndarray,
                 max_range: float = np.inf) -> np.ndarray:
    """Nearest-hit distances for rays vs a 3D triangle soup (Moller-
    Trumbore); misses are +inf.

    triangles: (t, 3, 3) or (t, 9) [v0 v1 v2]; origins: (n, 3) or (3,);
    directions: (n, 3) unit. Native (OpenMP) when available, else
    chunked-vectorized numpy.
    """
    tris = np.ascontiguousarray(
        np.asarray(triangles, np.float64).reshape(-1, 9))
    dirs = np.ascontiguousarray(np.asarray(directions, np.float64)
                                .reshape(-1, 3))
    orig = np.ascontiguousarray(np.broadcast_to(
        np.asarray(origins, np.float64).reshape(-1, 3),
        (len(dirs), 3)))
    mr = float(min(max_range, 1e300))
    lib = get_lib()
    if lib is not None:
        out = np.empty(len(dirs), np.float64)
        lib.egp_raycast_mesh(tris.ctypes.data, len(tris), orig.ctypes.data,
                             dirs.ctypes.data, len(dirs), mr,
                             out.ctypes.data)
        return out
    # numpy fallback, chunked over rays to bound the (chunk, T) temporaries
    if len(tris) == 0:
        # all-miss, matching the native path (the reduction below would
        # raise on a zero-size axis)
        return np.full(len(dirs), np.inf)
    v0 = tris[:, 0:3]
    e1 = tris[:, 3:6] - v0
    e2 = tris[:, 6:9] - v0
    out = np.empty(len(dirs), np.float64)
    chunk = max(1, int(4e6 // max(len(tris), 1)))
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
