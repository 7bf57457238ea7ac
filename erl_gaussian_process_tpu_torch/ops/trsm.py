"""Forward substitution with many right-hand sides: X = L^{-1} B for one
float32 factor L, given the inverses of its diagonal tiles, by the
hand-written CUDA kernels of ``csrc/trsm.cu``, and its plain PyTorch
version.

This is the exact GPs' float32 whitening (``models/gp_core.whiten``): B is
the cross gram of the queries, thousands of columns wide. The kernels
replace no Pallas kernel: the JAX package left
``erl_gaussian_process_tpu/ops/blocked_solve.py::blocked_solve_lower`` to
XLA. The port adds them because the whitening was ~95% of a test of 10 000
queries against 8192 samples, as 128 thin FP32 cuBLAS products. They solve
in blocks of 512 rows on the tensor cores (wgmma, 3xTF32): a product for
the rows solved before a block, then the block's eight 64-row
substitutions with the factor's own tile inverses (``dinv``, the blocked
Cholesky's second output, ``ops/chol.py``), whose products round as the
factorization's did. The least time at n = 8192 and m = 10 000 is 4.07 ms
at the 3xTF32 rate; the FP32 SIMT rate, which no blocking of the plain
version passes, gives 10.0 ms.
"""

from __future__ import annotations

import torch

from erl_gaussian_process_tpu_torch.ops._build import load_library
from erl_gaussian_process_tpu_torch.ops._library import note_launch
from erl_gaussian_process_tpu_torch.ops.chol import TILE
from erl_gaussian_process_tpu_torch.ops.gram import check_cuda_operands


def solve_lower_many_plain(L, dinv, B):
    """The plain version: the block forward substitution X_k = Dinv_k (B_k -
    L[k, :k] X[:k]) over the factor's tiles, one ``addmm`` and one product
    by the tile's inverse a tile."""
    n = L.shape[0]
    tile = dinv.shape[1]
    out = torch.empty_like(B)
    for lo in range(0, n, tile):
        hi = min(n, lo + tile)
        rhs = B[lo:hi]
        if lo:
            rhs = torch.addmm(rhs, L[lo:hi, :lo], out[:lo], alpha=-1.0)
        torch.matmul(dinv[lo:hi, :hi - lo], rhs, out=out[lo:hi])
    return out


def _check(L, dinv, B) -> None:
    what = "solve_lower_many"
    if dinv is None:
        raise ValueError(f"{what}: the factor's tile inverses (dinv) are "
                         "required")
    for t in (L, dinv, B):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: dtype {t.dtype} (the solve takes "
                            "float32; other dtypes take a triangular solve)")
    if L.dim() != 2 or B.dim() != 2 or L.shape[1] != L.shape[0] \
            or B.shape[0] != L.shape[0]:
        raise ValueError(f"{what}: shapes L {tuple(L.shape)} B "
                         f"{tuple(B.shape)} (L (n, n), B (n, m))")
    n = L.shape[0]
    if tuple(dinv.shape) != (-(-n // TILE) * TILE, TILE):
        raise ValueError(f"{what}: dinv {tuple(dinv.shape)}, want "
                         f"({-(-n // TILE) * TILE}, {TILE})")
    devices = {L.device, dinv.device, B.device}
    if len(devices) != 1 or L.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: operands must share the CPU or one CUDA "
                         f"device, got {[str(d) for d in devices]}")


def solve_lower_many(L, dinv, B):
    """X = L^{-1} B; L (n, n) lower triangular float32, ``dinv`` its
    (ceil(n / 64) * 64, 64) diagonal-tile inverses, B (n, m). CPU tensors
    take :func:`solve_lower_many_plain`; CUDA tensors launch the kernel
    (``csrc/trsm.cu``; a solve counted in ``solve_lower_many.launches``) or
    raise. Raises on another dtype, shape or device."""
    _check(L, dinv, B)
    if L.device.type == "cpu":
        return solve_lower_many_plain(L, dinv, B)
    check_cuda_operands("solve_lower_many", torch.float32, L, dinv, B)
    X = torch.empty_like(B)
    if X.numel() == 0:
        return X
    kl = load_library()
    n = L.shape[0]
    # L split into TF32 hi and lo tiles in the order the products read it
    scratch = torch.empty(kl.lib.egp_trsm_scratch_floats(n),
                          dtype=torch.float32, device=L.device)
    code = kl.lib.egp_trsm_f32(L.data_ptr(), dinv.data_ptr(), B.data_ptr(),
                               X.data_ptr(), scratch.data_ptr(), n,
                               B.shape[1], L.device.index,
                               torch.cuda.current_stream(L.device).cuda_stream)
    kl.check(code, "trsm kernel launch")
    note_launch(solve_lower_many)
    return X


solve_lower_many.launches = 0
solve_lower_many.captured = 0
