"""Build and load the hand-written CUDA kernels.

``csrc/gram.cu`` and ``csrc/gram_f64.cu`` (the gram kernel of
``csrc/gram.cuh`` at each dtype), ``csrc/fitc.cu``, ``csrc/bank.cu``,
``csrc/chol.cu``, ``csrc/trsv.cu`` and ``csrc/trsm.cu`` (with the shared
``csrc/family.cuh``, ``csrc/async_copy.cuh``, ``csrc/mma_tf32.cuh``,
``csrc/wgmma_tf32.cuh`` and ``csrc/sub_block.cuh``) compile with ``nvcc``
into ONE shared library with a plain C interface, loaded with ``ctypes``. Nothing is built when this module is imported: the
first call of :func:`load_library` builds, into
``erl_gaussian_process_tpu_torch/_build/<hash>/``, where the hash covers the
sources and the compiler flags, so a changed source rebuilds and an
unchanged one loads the existing library. A failed build raises with the
compiler's output; there is no fallback.

Each source compiles in its own ``nvcc`` process, all started together,
and one more links the objects. The sources include no PyTorch headers, so
a build takes seconds.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
_COMPILED = ("gram.cu", "gram_f64.cu", "fitc.cu", "bank.cu", "chol.cu",
             "trsv.cu", "trsm.cu")
_SOURCES = ("family.cuh", "gram.cuh", "async_copy.cuh", "mma_tf32.cuh",
            "wgmma_tf32.cuh", "sub_block.cuh") + _COMPILED
# sm_90a: the Hopper target. No --use_fast_math: the kernels need the
# full-precision exp/sqrt/division (see csrc/family.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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
        # x1, x2, mask1, out, batch, m, n, d, family, ncomp, coefs,
        # weights, device, stream
        fn.argtypes = [_P] * 4 + [_I] * 6 + [_PD, _PD, _I, _P]
        fn.restype = _I
    for name in ("egp_fitc_f32", "egp_fitc_f64"):
        fn = getattr(lib, name)
        # pseudo, linv, x, y, var, mask, kmn, partial, w, dq, da, ws,
        # counters, m, n, d, q, the SYRK's grid (blocks, span, copy engine
        # at float32; splits, chunk, 0 at float64), family, ncomp, coefs,
        # weights, device, stream
        fn.argtypes = [_P] * 13 + [_I] * 9 + [_PD, _PD, _I, _P]
        fn.restype = _I
    # kmn, w, y, mask, dq, da, ws, counters, m, n, q, blocks, span, copy
    # engine, device, stream
    lib.egp_fitc_syrk_f32.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.egp_fitc_syrk_f32.restype = _I
    for name in ("egp_bank_fit_f32", "egp_bank_fit_f64"):
        fn = getattr(lib, name)
        # x, var, mask, y, L, L_inv, alpha, batch, n, d, q, family, ncomp,
        # coefs, weights, members_per_block, device, stream
        fn.argtypes = [_P] * 7 + [_I] * 6 + [_PD, _PD, _I, _I, _P]
        fn.restype = _I
    for name in ("egp_bank_chol_f32", "egp_bank_chol_f64"):
        fn = getattr(lib, name)
        # K, y, L, L_inv, alpha, batch, n, q, members_per_block, device,
        # stream
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_P]
        fn.restype = _I
    # device -> opt-in shared memory per block in bytes (or -error)
    lib.egp_smem_optin.argtypes = [_I]
    lib.egp_smem_optin.restype = _I
    # the split plan of every Cholesky entry: ws_half, panels per split
    plan = [ctypes.c_longlong, ctypes.POINTER(_I)]
    for name in ("egp_chol_f32", "egp_chol_f64"):
        fn = getattr(lib, name)
        # A, L, Dinv, ws, ws_half, pps, n, device, stream
        fn.argtypes = [_P] * 4 + plan + [_I, _I, _P]
        fn.restype = _I
    for name in ("egp_chol_gram_f32", "egp_chol_gram_f64"):
        fn = getattr(lib, name)
        # x, var, mask, L, Dinv, ws, ws_half, pps, n, d, family, ncomp,
        # coefs, weights, device, stream
        fn.argtypes = [_P] * 6 + plan + [_I] * 4 + [_PD, _PD, _I, _P]
        fn.restype = _I
    for name in ("egp_chol_joint_f32", "egp_chol_joint_f64"):
        fn = getattr(lib, name)
        # x, var_v, var_g, smask, gmask, L, Dinv, ws, ws_half, pps, n0, d,
        # family, scale, device, stream
        fn.argtypes = [_P] * 8 + plan + [_I] * 3 + [_D, _I, _P]
        fn.restype = _I
    # f64, device -> co-resident blocks of the solve (or -error)
    lib.egp_trsv_max_grid.argtypes = [_I, _I]
    lib.egp_trsv_max_grid.restype = _I
    for name in ("egp_trsv_f32", "egp_trsv_f64"):
        fn = getattr(lib, name)
        # L, inv, b, x, words, n, q, trans, grid, device, stream
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_P]
        fn.restype = _I
    # n -> floats of the solve's scratch
    lib.egp_trsm_scratch_floats.argtypes = [_I]
    lib.egp_trsm_scratch_floats.restype = ctypes.c_longlong
    # L, dinv, b, x, scratch, n, m, device, stream
    lib.egp_trsm_f32.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.egp_trsm_f32.restype = _I


def _run(cmd: list) -> tuple:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return " ".join(cmd) + "\n" + proc.stdout, proc.returncode


def _compile(out_dir: str, path: str) -> None:
    """One ``nvcc -c`` per source, all started together, then one link into
    ``path``; the compiler's output goes to ``nvcc.log``. Raises on a
    failure."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(_COMPILED)) as pool:
        objs = [os.path.join(tmp, f"{s}.o") for s in _COMPILED]
        runs = list(pool.map(_run, [
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, s), "-o", o]
            for s, o in zip(_COMPILED, objs)]))
        lib = os.path.join(tmp, _LIB_NAME)
        if not any(code for _, code in runs):
            runs.append(_run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", lib,
                              *objs]))
        log = "".join(out for out, _ in runs)
        with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
            f.write(log)
        failed = [code for _, code in runs if code]
        if failed:
            raise RuntimeError(f"nvcc failed (exit {failed[0]}):\n{log}")
        os.replace(lib, path)


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; one per process."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    path = os.path.join(out_dir, _LIB_NAME)
    log_path = os.path.join(out_dir, "nvcc.log")
    seconds = 0.0
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        _compile(out_dir, path)
        seconds = time.perf_counter() - t0
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
