"""Build and load the hand-written CUDA kernels.

``csrc/gram.cu`` and ``csrc/fitc.cu`` (with the shared ``csrc/family.cuh``)
compile with ``nvcc`` into ONE shared library with a plain C interface,
loaded with ``ctypes``. Nothing is built when this module is imported: the
first call of :func:`load_library` builds, into
``erl_gaussian_process_tpu_torch/_build/<hash>/``, where the hash covers the
sources and the compiler flags, so a changed source rebuilds and an
unchanged one loads the existing library. A failed build raises with the
compiler's output; there is no fallback.

The sources include no PyTorch headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
_SOURCES = ("family.cuh", "gram.cu", "fitc.cu")
_COMPILED = ("gram.cu", "fitc.cu")
# sm_90a: the Hopper target. No --use_fast_math: the kernels need the
# full-precision exp/sqrt/division (see csrc/family.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libegp_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_PD = ctypes.POINTER(ctypes.c_double)


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded library plus how it came to be: ``seconds`` is the
    build time in this process (0.0 when an existing build was loaded) and
    ``log`` the compiler's output (register and shared-memory use per
    kernel, from ``-Xptxas -v``)."""

    lib: ctypes.CDLL
    path: str
    seconds: float
    log: str

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry returned a CUDA error."""
        if code != 0:
            msg = self.lib.egp_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of erl_gaussian_process_tpu_torch are built from "
        "csrc/ at first use and need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    lib.egp_error_string.argtypes = [_I]
    lib.egp_error_string.restype = ctypes.c_char_p
    for name in ("egp_gram_f32", "egp_gram_f64"):
        fn = getattr(lib, name)
        # x1, x2, out, m, n, d, family, ncomp, ratios, weights, scale,
        # device, stream
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _PD, _PD, _D, _I, _P]
        fn.restype = _I
    for name in ("egp_fitc_f32", "egp_fitc_f64"):
        fn = getattr(lib, name)
        # pseudo, linv, x, y, var, mask, kmn, partial, w, dq, da,
        # m, n, d, q, family, ncomp, ratios, weights, scale, device, stream
        fn.argtypes = [_P] * 11 + [_I] * 6 + [_PD, _PD, _D, _I, _P]
        fn.restype = _I


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; one per process."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    path = os.path.join(out_dir, _LIB_NAME)
    log_path = os.path.join(out_dir, "nvcc.log")
    seconds = 0.0
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[os.path.join(CSRC_DIR, s) for s in _COMPILED]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        with open(log_path, "w") as f:
            f.write(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                f"{log}")
        os.replace(tmp, path)
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    lib = ctypes.CDLL(path)
    _declare(lib)
    return KernelLibrary(lib=lib, path=path, seconds=seconds, log=log)


def double_array(values) -> ctypes.Array:
    """A ctypes double[] holding ``values`` (host memory for a C entry)."""
    vals = [float(v) for v in values]
    return (ctypes.c_double * len(vals))(*vals)
