"""Triangular solves with few right-hand sides: the hand-written CUDA kernel
(``csrc/trsv.cu``) and its plain PyTorch version.

Counterpart of ``erl_gaussian_process_tpu/ops/pallas_trsv.py``:
:func:`solve_lower` solves L x = b, :func:`solve_lower_t` solves L^T x = b
and :func:`cho_solve_vec` chains both (K^{-1} b for K = L L^T). L is (n, n)
lower triangular, b (n, q). The substitution runs over blocks of
``ops/chol.TILE`` (64) rows with the diagonal blocks pre-inverted: either by one
batched triangular solve outside the kernel (:func:`_diag_block_inverses`,
which the JAX package also leaves outside its kernel) or sliced for free
from the blocked Cholesky's Dinv (:func:`inverses_from_chol_dinv`). The JAX
package took its kernel on a TPU at float32 for 128-aligned n and q <= 128
only; here every CUDA call launches the kernel, at any n and q, float32 and
float64.
"""

from __future__ import annotations

import functools

import torch

from erl_gaussian_process_tpu_torch.ops._build import load_library
from erl_gaussian_process_tpu_torch.ops._library import note_launch
from erl_gaussian_process_tpu_torch.ops.chol import TILE, diag_tile_inverses
from erl_gaussian_process_tpu_torch.ops.gram import check_cuda_operands


def _diag_block_inverses(L: torch.Tensor, b: int = TILE) -> torch.Tensor:
    """(nb * b, b) stack of inv(L[kb:(k+1)b, kb:(k+1)b]), the last block
    padded with identity: one batched triangular solve, shared by both
    directions. The substitution's block is the Cholesky's tile, so a
    blocked Cholesky's own Dinv serves in its place."""
    return diag_tile_inverses(L, b)


def inverses_from_chol_dinv(dinv: torch.Tensor, n: int, *, tile: int = TILE,
                            b: int = TILE) -> torch.Tensor:
    """The (nb * b, b) substitution-block inverses, sliced from the blocked
    Cholesky's Dinv (block row j = inv(L[jT:(j+1)T, jT:(j+1)T]), T =
    ``tile``, the last block identity-padded). The inverse of a lower
    triangular matrix is lower triangular with its diagonal b-blocks the
    inverses of the original's diagonal b-blocks, so each stored T-block
    inverse already holds the (T/b) b-block inverses the substitution
    needs."""
    assert tile % b == 0
    r = tile // b
    nb = -(-n // b)                 # b-blocks needed
    nt = -(-nb // r)                # covering T-blocks
    assert dinv.shape[0] >= nt * tile and dinv.shape[1] == tile
    d4 = dinv[:nt * tile].reshape(nt, r, b, r, b)
    diag = torch.diagonal(d4, dim1=1, dim2=3)          # (nt, b, b, r)
    return diag.permute(0, 3, 1, 2).reshape(nt * tile, b)[:nb * b]


def substitute_plain(L, b, trans: bool):
    """The plain version of the kernel: ``torch.linalg.solve_triangular``
    with L (``trans``: L^T)."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, b, upper=True)
    return torch.linalg.solve_triangular(L, b, upper=False)


def trsv_grid(n: int, coresident: int, grid=None) -> int:
    """Thread blocks of one persistent solve: one per 64-row block up to the
    ``coresident`` count (the kernel needs every block resident at once),
    or the ``grid`` asked for (at most ``coresident``; results are bitwise
    the same for every grid)."""
    nb = -(-n // TILE)
    if grid is None:
        return max(1, min(nb, coresident))
    if not 1 <= grid <= coresident:
        raise ValueError(f"trsv grid {grid}: the card keeps 1 .. "
                         f"{coresident} blocks of the solve resident")
    return min(grid, nb)


def trsv_word_count(n: int, q: int, dtype) -> int:
    """The 64-bit words through which one solve's thread blocks publish x:
    one per 32-bit part of each value (zeroed for every solve)."""
    return n * q * (torch.finfo(dtype).bits // 32)


@functools.lru_cache(maxsize=None)
def _coresident(f64: bool, device_index: int) -> int:
    kl = load_library()
    most = kl.lib.egp_trsv_max_grid(int(f64), device_index)
    if most < 0:
        kl.check(-most, "trsv occupancy query")
    return most


def substitute_cuda(L, inv, b, trans: bool, *, grid=None):
    """One direction of the blocked substitution on the card: L x = b, or
    L^T x = b with ``trans``; ``inv`` the (nb * B, B) diagonal-block
    inverses. One persistent launch per 32 columns of b
    (``csrc/trsv.cu``; one solve counted in ``substitute_cuda.launches``)
    or raises. ``grid`` forces the number of thread blocks
    (:func:`trsv_grid`)."""
    check_cuda_operands("substitute_cuda", L.dtype, L, inv, b)
    n = L.shape[0]
    bs = TILE
    if L.dim() != 2 or L.shape[1] != n or b.dim() != 2 \
            or b.shape[0] != n or b.shape[1] == 0 or n == 0:
        raise ValueError(f"substitute_cuda: shapes L {tuple(L.shape)} b "
                         f"{tuple(b.shape)}")
    if tuple(inv.shape) != (-(-n // bs) * bs, bs):
        raise ValueError(f"substitute_cuda: inv {tuple(inv.shape)}, want "
                         f"({-(-n // bs) * bs}, {bs})")
    q = b.shape[1]
    f64 = L.dtype == torch.float64
    blocks = trsv_grid(n, _coresident(f64, L.device.index), grid)
    x = torch.empty_like(b)
    words = torch.zeros(trsv_word_count(n, q, L.dtype), dtype=torch.int64,
                        device=L.device)
    kl = load_library()
    fn = kl.lib.egp_trsv_f64 if f64 else kl.lib.egp_trsv_f32
    code = fn(L.data_ptr(), inv.data_ptr(), b.data_ptr(), x.data_ptr(),
              words.data_ptr(), n, q, int(trans), blocks, L.device.index,
              torch.cuda.current_stream(L.device).cuda_stream)
    kl.check(code, "trsv kernel launch")
    note_launch(substitute_cuda)
    return x


substitute_cuda.launches = 0
substitute_cuda.captured = 0


def _solve(L, b, inv, trans: bool):
    if L.device.type == "cpu" and b.device.type == "cpu":
        return substitute_plain(L, b, trans)
    if inv is None:
        inv = _diag_block_inverses(L)
    return substitute_cuda(L, inv, b.contiguous(), trans)


def solve_lower(L, b, inv=None):
    """x with L x = b; L (n, n) lower triangular, b (n, q). CPU tensors
    take :func:`substitute_plain`; CUDA tensors launch the kernel."""
    return _solve(L, b, inv, trans=False)


def solve_lower_t(L, b, inv=None):
    """x with L^T x = b (the second half of a Cholesky solve)."""
    return _solve(L, b, inv, trans=True)


def cho_solve_vec(L, b, chol_dinv=None):
    """K^{-1} b = L^{-T} L^{-1} b by the two blocked solves, sharing one set
    of diagonal-block inverses: sliced from the blocked Cholesky's
    ``chol_dinv`` when given, else one batched triangular solve."""
    if L.device.type == "cpu" and b.device.type == "cpu":
        return substitute_plain(L, substitute_plain(L, b, False), True)
    if chol_dinv is not None:
        inv = inverses_from_chol_dinv(chol_dinv, L.shape[0])
    else:
        inv = _diag_block_inverses(L)
    inv = inv.contiguous()
    return solve_lower_t(L, solve_lower(L, b, inv), inv)
