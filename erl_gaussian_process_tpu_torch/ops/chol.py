"""Blocked Cholesky of one large SPD matrix: the hand-written CUDA kernels
(``csrc/chol.cu``) and their plain PyTorch versions.

Counterpart of ``erl_gaussian_process_tpu/ops/pallas_chol.py``. Three
entries, one factorization, differing in where a tile of the matrix comes
from:

- :func:`chol_blocked`: ``A`` read from memory (its lower triangle);
- :func:`chol_blocked_gram`: ``k(x, x) + diag(var)``, masked rows exact
  identity rows, built per tile from the coordinates;
- :func:`chol_blocked_gram_joint`: the NIGP's joint value/gradient gram
  (``kernels/gradient.train_gram_with_gradient``'s layout), built per tile.

Each returns L (exactly lower triangular) and, with ``return_dinv=True``,
the inverses of its diagonal tiles: ``Dinv`` of shape (nb * T, T) whose
block row j is ``inv(L[jT:(j+1)T, jT:(j+1)T])``, the last block taken of L
padded with identity. T is :data:`TILE` (64, at float32 and float64):
this card's tile, not the TPU's 512. A failed factorization gives
NaN: the plain version's L is all NaN, the kernel's from the failing tile
on; either way the solve that follows is NaN, so ``host_jitter_retry``
escalates. The JAX package took its kernels on a TPU at float32 above a
size gate only; here every CUDA call launches the kernel, at any n and at
float32 and float64.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from erl_gaussian_process_tpu_torch.ops._build import load_library
from erl_gaussian_process_tpu_torch.ops._library import LaunchCount, note_launch
from erl_gaussian_process_tpu_torch.ops.gram import (
    FAMILY_IDS,
    check_cuda_operands,
    packed_family,
)

JOINT_FAMILIES = ("rbf", "matern32")
TILE = 64  # csrc/chol.cu kTile: the tile edge of the factorization and Dinv


def diag_tile_inverses(L: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """(nb * tile, tile): the inverses of L's diagonal tiles, the last one
    padded with identity, by one batched triangular solve (Dinv of a given
    factor, e.g. one loaded from a checkpoint)."""
    n = L.shape[0]
    nb = -(-n // tile)
    blocks = torch.eye(tile, dtype=L.dtype, device=L.device).repeat(nb, 1, 1)
    for j in range(nb):
        lo, hi = j * tile, min(n, (j + 1) * tile)
        blocks[j, :hi - lo, :hi - lo] = L[lo:hi, lo:hi]
    eye = torch.eye(tile, dtype=L.dtype, device=L.device)
    inv = torch.linalg.solve_triangular(blocks, eye.expand_as(blocks),
                                        upper=False)
    return inv.reshape(nb * tile, tile).contiguous()


def _factor_plain(K: torch.Tensor, return_dinv: bool):
    L, info = torch.linalg.cholesky_ex(K)
    L = L.masked_fill(info != 0, float("nan")).contiguous()
    if return_dinv:
        return L, diag_tile_inverses(L)
    return L


def chol_blocked_plain(A, *, return_dinv: bool = False):
    """The plain version of :func:`chol_blocked`, on any device:
    ``cholesky_ex`` (all NaN on failure), Dinv by a batched triangular
    solve of the diagonal tiles."""
    return _factor_plain(A, return_dinv)


def chol_blocked_gram_plain(name: str, x, var, mask, scale, *,
                            return_dinv: bool = False):
    """The plain version of :func:`chol_blocked_gram`: ``train_gram`` then
    :func:`chol_blocked_plain`."""
    from erl_gaussian_process_tpu_torch.kernels.stationary import train_gram

    K = train_gram(name, x, torch.where(mask, var, torch.zeros_like(var)),
                   scale, mask=mask)
    return _factor_plain(K, return_dinv)


def chol_blocked_gram_joint_plain(name: str, x, var_v, var_g, sample_mask,
                                  grad_mask, scale, *,
                                  return_dinv: bool = False):
    """The plain version of :func:`chol_blocked_gram_joint`:
    ``train_gram_with_gradient`` then :func:`chol_blocked_plain`."""
    from erl_gaussian_process_tpu_torch.kernels.gradient import (
        train_gram_with_gradient,
    )

    zero = torch.zeros_like(var_v)
    K = train_gram_with_gradient(
        name, x, torch.where(sample_mask, var_v, zero), zero,
        torch.where(grad_mask, var_g, zero), sample_mask, grad_mask, scale)
    return _factor_plain(K, return_dinv)


UPDATE_ROWS = 128        # csrc/chol.cu kUpRows: rows of a float32 update block
UPDATE_SM_SHARE = 0.75   # of the card's SMs, the most a column's update takes
MAX_SPLITS = 16          # csrc/chol.cu kMaxSplits: buffers a consumer sums


def update_blocks(nt: int, splits: int) -> int:
    """Product blocks of a float32 column update over ``nt`` row tiles in
    ``splits`` splits: :data:`UPDATE_ROWS` rows a block."""
    return -(-nt * TILE // UPDATE_ROWS) * splits


def update_block_cap(sms: int) -> int:
    """The most product blocks a column's update is split into on a card of
    ``sms`` SMs: :data:`UPDATE_SM_SHARE` of them, one block an SM. The rest
    stay free for the diagonal factor and apply launches of the chain,
    which the update's blocks would otherwise hold off their SMs."""
    return max(1, int(UPDATE_SM_SHARE * sms))


@functools.lru_cache(maxsize=None)
def chol_plan(n: int, sms: int) -> tuple:
    """The kernels' split plan at size n on a card with ``sms`` SMs:
    ``(pps, ws_half)``. Column j's update writes the column's tiles of A
    (buffer 0) and the products of the panels 0 .. j - 2 (the look-ahead
    leaves panel j - 1 to the diag and apply launches) in splits of
    ``pps[j]`` panels each: as many as keep the product blocks
    (:func:`update_blocks` of the column's nb - j row tiles) within
    :func:`update_block_cap`, each at least one panel, at most
    :data:`MAX_SPLITS` - 1 of them (the first two columns have no such
    panel; their ``pps`` is 1, unused). ``ws_half`` is the elements of one
    column's buffers (the largest (1 + splits) x tiles x T^2); the workspace
    holds two, one per column parity. The float64 update takes one tile a
    block under the same plan."""
    nb = -(-n // TILE)
    pps = [1] * nb
    half = nb * TILE * TILE
    for j in range(2, nb):
        npan, nt = j - 1, nb - j
        ns = max(1, min(MAX_SPLITS - 1, npan,
                        update_block_cap(sms) // update_blocks(nt, 1)))
        per = -(-npan // ns)
        pps[j] = per
        half = max(half, (1 + -(-npan // per)) * nt * TILE * TILE)
    return tuple(pps), half


def _outputs(n: int, dtype, device):
    """L (n, n), Dinv (nb T, T), the kernels' split workspace and the split
    plan (``ws_half`` and the host array of panels per split)."""
    kl = load_library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    pps, half = chol_plan(n, sms)
    L = torch.empty((n, n), dtype=dtype, device=device)
    dinv = torch.empty((-(-n // TILE) * TILE, TILE), dtype=dtype,
                       device=device)
    ws = torch.empty((2 * half,), dtype=dtype, device=device)
    return kl, L, dinv, ws, (half, (ctypes.c_int * len(pps))(*pps))


def _check_mask(what, mask, like):
    if mask.device != like.device or mask.dtype != torch.bool \
            or not mask.is_contiguous() or mask.shape != like.shape[:1]:
        raise ValueError(f"{what}: masks must be contiguous bool tensors of "
                         f"shape ({like.shape[0]},) on the operands' device")


def _result(L, dinv, return_dinv):
    return (L, dinv) if return_dinv else L


# float32 factorizations (any entry) whose column updates ran on the wgmma
# kernel (csrc/chol.cu chol_update_wgmma_kernel)
chol_update_wgmma = LaunchCount("chol_update_wgmma")


def _note(wrapper, dtype) -> None:
    note_launch(wrapper)
    if dtype == torch.float32:
        note_launch(chol_update_wgmma)


def chol_blocked(A, *, return_dinv: bool = False):
    """L = chol(A) for one SPD (n, n) A, read from its lower triangle.

    CPU tensors take :func:`chol_blocked_plain`; CUDA tensors launch
    ``csrc/chol.cu`` (one factorization counted in
    ``chol_blocked.launches``, and at float32 in
    ``chol_update_wgmma.launches`` too) or raise."""
    if A.device.type == "cpu":
        return chol_blocked_plain(A, return_dinv=return_dinv)
    check_cuda_operands("chol_blocked", A.dtype, A)
    if A.dim() != 2 or A.shape[0] != A.shape[1] or A.shape[0] == 0:
        raise ValueError(f"chol_blocked: A must be square and non-empty, "
                         f"got {tuple(A.shape)}")
    n = A.shape[0]
    kl, L, dinv, ws, plan = _outputs(n, A.dtype, A.device)
    fn = kl.lib.egp_chol_f32 if A.dtype == torch.float32 else \
        kl.lib.egp_chol_f64
    code = fn(A.data_ptr(), L.data_ptr(), dinv.data_ptr(), ws.data_ptr(),
              *plan, n, A.device.index,
              torch.cuda.current_stream(A.device).cuda_stream)
    kl.check(code, "chol kernel launch")
    _note(chol_blocked, A.dtype)
    return _result(L, dinv, return_dinv)


chol_blocked.launches = 0
chol_blocked.captured = 0


def chol_blocked_gram(name: str, x, var, mask, scale, *,
                      return_dinv: bool = False):
    """L = chol(k(x, x) + diag(var)), masked rows exact identity rows; the
    gram is built per tile inside the factorization. x (n, d); var (n,);
    mask (n,) bool.

    CPU tensors take :func:`chol_blocked_gram_plain`; CUDA tensors launch
    ``csrc/chol.cu`` (counted in ``chol_blocked_gram.launches``) or
    raise."""
    if all(t.device.type == "cpu" for t in (x, var, mask)):
        return chol_blocked_gram_plain(name, x, var, mask, scale,
                                       return_dinv=return_dinv)
    check_cuda_operands("chol_blocked_gram", x.dtype, x, var)
    if x.dim() != 2 or var.shape != x.shape[:1] or 0 in x.shape:
        raise ValueError(f"chol_blocked_gram: shapes x {tuple(x.shape)} var "
                         f"{tuple(var.shape)}")
    _check_mask("chol_blocked_gram", mask, x)
    n, d = x.shape
    fam, ncomp, coefs, weights = packed_family(name, float(scale))
    kl, L, dinv, ws, plan = _outputs(n, x.dtype, x.device)
    fn = kl.lib.egp_chol_gram_f32 if x.dtype == torch.float32 else \
        kl.lib.egp_chol_gram_f64
    code = fn(x.data_ptr(), var.data_ptr(), mask.data_ptr(), L.data_ptr(),
              dinv.data_ptr(), ws.data_ptr(), *plan, n, d, fam, ncomp, coefs,
              weights, x.device.index,
              torch.cuda.current_stream(x.device).cuda_stream)
    kl.check(code, "chol gram kernel launch")
    _note(chol_blocked_gram, x.dtype)
    return _result(L, dinv, return_dinv)


chol_blocked_gram.launches = 0
chol_blocked_gram.captured = 0


def chol_blocked_gram_joint(name: str, x, var_v, var_g, sample_mask,
                            grad_mask, scale, *, return_dinv: bool = False):
    """L = chol(joint value/gradient train gram), the (N, N) gram (N =
    (1+d) n) built per tile inside the factorization, rows ``[values(n);
    grad-dim0(n); ...]``, masked rows exact identity rows. x (n, d); var_v
    = var_x + var_y per sample; var_g per gradient row; masks (n,) bool.
    Families: rbf and matern32 (the JAX package's joint families).

    CPU tensors take :func:`chol_blocked_gram_joint_plain`; CUDA tensors
    launch ``csrc/chol.cu`` (counted in ``chol_blocked_gram_joint.launches``)
    or raise."""
    tensors = (x, var_v, var_g, sample_mask, grad_mask)
    if all(t.device.type == "cpu" for t in tensors):
        return chol_blocked_gram_joint_plain(
            name, x, var_v, var_g, sample_mask, grad_mask, scale,
            return_dinv=return_dinv)
    if name not in JOINT_FAMILIES:
        raise ValueError(f"chol_blocked_gram_joint: family {name!r} (the "
                         f"kernel takes {JOINT_FAMILIES})")
    check_cuda_operands("chol_blocked_gram_joint", x.dtype, x, var_v, var_g)
    if x.dim() != 2 or var_v.shape != x.shape[:1] \
            or var_g.shape != x.shape[:1] or 0 in x.shape:
        raise ValueError(f"chol_blocked_gram_joint: shapes x "
                         f"{tuple(x.shape)} var_v {tuple(var_v.shape)} var_g "
                         f"{tuple(var_g.shape)}")
    _check_mask("chol_blocked_gram_joint", sample_mask, x)
    _check_mask("chol_blocked_gram_joint", grad_mask, x)
    n0, d = x.shape
    kl, L, dinv, ws, plan = _outputs((1 + d) * n0, x.dtype, x.device)
    fn = kl.lib.egp_chol_joint_f32 if x.dtype == torch.float32 else \
        kl.lib.egp_chol_joint_f64
    code = fn(x.data_ptr(), var_v.data_ptr(), var_g.data_ptr(),
              sample_mask.data_ptr(), grad_mask.data_ptr(), L.data_ptr(),
              dinv.data_ptr(), ws.data_ptr(), *plan, n0, d, FAMILY_IDS[name],
              float(scale), x.device.index,
              torch.cuda.current_stream(x.device).cuda_stream)
    kl.check(code, "chol joint kernel launch")
    _note(chol_blocked_gram_joint, x.dtype)
    return _result(L, dinv, return_dinv)


chol_blocked_gram_joint.launches = 0
chol_blocked_gram_joint.captured = 0
