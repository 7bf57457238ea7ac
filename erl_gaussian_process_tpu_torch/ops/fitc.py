"""Rank-N FITC update (dQ_M, dalpha): the hand-written CUDA kernel
(``csrc/fitc.cu``) and its plain PyTorch version.

Counterpart of ``erl_gaussian_process_tpu/ops/pallas_fitc.py``. The L_inv
product, the weighted SYRK and the ``y`` product all run inside the kernel's
three launches; the Kahan accumulation of the result stays with the caller
(``models/sparse_pseudo_input_gp.spgp_update``). :func:`fitc_plan` is the
host side of the kernel's grid: its tiles and the N-split of the SYRK.
The wrapper calls the registered op ``egp::fitc_update``
(``ops/_library.py``): its CPU implementation is the plain version, its
CUDA implementation the kernel's launch.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from erl_gaussian_process_tpu_torch.ops._build import load_library
from erl_gaussian_process_tpu_torch.ops._library import define, note_launch
from erl_gaussian_process_tpu_torch.ops.gram import (
    _plain_spec,
    check_cuda_operands,
    check_devices,
    family_spec,
    packed_spec,
)
from erl_gaussian_process_tpu_torch.utils.timing import count

TILE = 64  # csrc/fitc.cu kTile: the tile edge of beta and the float64 SYRK
SYRK_EDGE = 128  # csrc/fitc.cu kSyEdge: the float32 SYRK's super-tile edge
# the float32 SYRK's blocks an SM holds (two warpgroups and 194.5 KB of
# shared memory each): its grid is one wave of SYRK_BLOCKS_PER_SM x SMs
SYRK_BLOCKS_PER_SM = 1
F64_BLOCKS_PER_SM = 3  # the float64 SYRK's blocks per SM its split aims at
SYRK_MAX_SPAN = 64  # csrc/fitc.cu kSyMaxSpan: super-tiles a block may meet
SYRK_DA_Q = 2  # csrc/fitc.cu kDaQ: dalpha columns the float32 SYRK streams
LAUNCHES = 3  # kmn, beta (+ weights), SYRK (+ dalpha)


def lower_tile(b: int) -> tuple:
    """(tr, tc), tc <= tr: the lower tile that SYRK tile index b stands for,
    row by row (``csrc/fitc.cu`` ``lower_tile``)."""
    tr = int((math.sqrt(8.0 * b + 1.0) - 1.0) * 0.5)
    while tr * (tr + 1) // 2 > b:
        tr -= 1
    while (tr + 1) * (tr + 2) // 2 <= b:
        tr += 1
    return tr, b - tr * (tr + 1) // 2


@dataclasses.dataclass(frozen=True)
class FitcPlan:
    """The kernel's grid at (m, n): ``row_blocks`` x ``col_blocks`` tiles of
    beta (64 x 64; ``col_blocks`` is also the count of 64-sample panels),
    and the SYRK's.

    Float32: ``super_tiles`` lower 128 x 128 super-tiles of dQ; the units
    of work are (super-tile, panel) pairs in that order, and block b of
    ``blocks`` takes the units [b U / blocks, (b + 1) U / blocks), U =
    super-tiles x panels, one segment of panels for each super-tile it
    meets, at most ``span`` of them (``csrc/fitc.cu`` ``StreamGrid``);
    ``copy_engine``: its strips may come through the copy engine (TMA),
    which wants kmn's rows to start on 16 bytes (n % 4 == 0); else, and
    where y does not start on 16 bytes (:func:`_copy_engine`), through
    4-byte ``cp.async`` copies (at the hotel-0 shape 112 against 59 us,
    PERF.md). Float64: ``tiles`` lower 64 x 64 tiles, each summed over
    ``splits`` chunks of ``chunk`` samples (a multiple of :data:`TILE`;
    the last one may be short). ``launches`` kernel launches either way."""

    row_blocks: int
    col_blocks: int
    super_tiles: int
    blocks: int
    span: int
    copy_engine: bool
    tiles: int
    splits: int
    chunk: int
    launches: int = LAUNCHES

    def split_range(self, s: int, n: int) -> range:
        """The samples float64 split s sums."""
        return range(s * self.chunk, min(n, (s + 1) * self.chunk))


def _lower_tiles(m: int, edge: int) -> int:
    rows = -(-m // edge)
    return rows * (rows + 1) // 2


@functools.lru_cache(maxsize=None)
def fitc_plan(m: int, n: int, sms: int) -> FitcPlan:
    """The FITC kernel's plan for M = m pseudo points and n samples on a
    card with ``sms`` SMs.

    The float32 SYRK computes dQ's lower 128 x 128 super-tiles (two
    warpgroups a block, each 64 rows against the super-tile's 128 columns;
    a diagonal super-tile's quadrant above the diagonal is computed and not
    stored). Its grid is one wave: a block an SM, each with an equal share
    (to one unit) of the super-tiles x 64-sample panels, so that no SM
    waits for a wave the tiles fill in part (45 super-tiles x 32 panels
    over 132 blocks at the hotel-0 shape, 10 or 11 panels a block); a
    super-tile's segments are its split partials, summed in panel order.
    The float64 SYRK keeps its split of the 64 x 64 tiles: as many N-splits
    as keep its tiles x splits blocks within :data:`F64_BLOCKS_PER_SM` per
    SM, each split at least one panel and none empty."""
    row_blocks = -(-m // TILE)
    panels = -(-n // TILE)
    super_tiles = _lower_tiles(m, SYRK_EDGE)
    units = super_tiles * panels
    blocks = min(units, max(SYRK_BLOCKS_PER_SM * sms,
                            -(-units // ((SYRK_MAX_SPAN - 1) * panels))))
    per = -(-units // blocks)
    tiles = _lower_tiles(m, TILE)
    splits = max(1, min(panels, F64_BLOCKS_PER_SM * sms // tiles))
    chunk = -(-panels // splits) * TILE
    return FitcPlan(row_blocks=row_blocks, col_blocks=panels,
                    super_tiles=super_tiles, blocks=blocks,
                    span=(per + panels - 2) // panels + 1,
                    copy_engine=n % 4 == 0, tiles=tiles,
                    splits=-(-n // chunk), chunk=chunk)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _syrk_workspace(plan: FitcPlan, q: int, dtype, device) -> torch.Tensor:
    """The SYRK's split partials: ``span`` super-tiles a float32 block
    (then, for q <= :data:`SYRK_DA_Q`, ``span`` partials of 128 dalpha
    rows), a 64 x 64 tile a float64 block."""
    if dtype != torch.float32:
        return torch.empty((plan.tiles * plan.splits * TILE * TILE,),
                           dtype=dtype, device=device)
    tile = SYRK_EDGE * SYRK_EDGE + (SYRK_EDGE * q if q <= SYRK_DA_Q else 0)
    return torch.empty((plan.blocks * plan.span * tile,), dtype=dtype,
                       device=device)


def _copy_engine(plan: FitcPlan, y) -> bool:
    """Whether the copy engine feeds the float32 SYRK: the plan's choice
    by shape, and y starting on 16 bytes where the SYRK's stream reads it
    (q <= :data:`SYRK_DA_Q`); kmn and w are the wrappers' scratch."""
    return plan.copy_engine and (y.shape[1] > SYRK_DA_Q
                                 or y.data_ptr() % 16 == 0)


def _syrk_grid(plan: FitcPlan, dtype, y) -> tuple:
    """The three ints of the SYRK's grid the C entries take: blocks, span
    and the copy engine (:func:`_copy_engine`) at float32, splits, chunk
    and 0 at float64."""
    return ((plan.blocks, plan.span, int(_copy_engine(plan, y)))
            if dtype == torch.float32 else (plan.splits, plan.chunk, 0))


def fitc_update_plain(name: str, pseudo, linv, x, y, var, mask, scale,
                      block: int = 0):
    """The plain PyTorch version of the FITC kernel, on any device: the
    beta-via-L_inv formulation of ``fitc_delta`` (the one the Pallas kernel
    also computes). ``block`` > 0: the samples are a fused update of poses
    of ``block`` samples each, and dQ_M and dalpha are summed pose by pose,
    in pose order, as the per-pose updates' sum rounds (the kernel sums its
    own :func:`fitc_plan` chunks and takes no ``block``)."""
    return _fitc_plain(pseudo, linv, x, y, var, mask, *family_spec(name),
                       float(scale), int(block))


def _fitc_plain(pseudo, linv, x, y, var, mask, base, ratios, weights, scale,
                block=0):
    kmn = _plain_spec(pseudo, x, None, base, ratios, weights, scale)
    beta = linv @ kmn                                         # (M, n)
    lam = torch.clamp(1.0 - torch.sum(beta * beta, dim=0), min=0.0)
    inv = torch.where(mask, 1.0 / (lam + var), torch.zeros_like(lam))
    ksc = kmn * inv[None, :]
    yv = torch.where(mask[:, None], y, torch.zeros_like(y))
    n = kmn.shape[1]
    if block <= 0 or block >= n:
        return ksc @ kmn.T, ksc @ yv
    # a fused update of several poses: each pose's products on their own,
    # added in pose order, so that the sum rounds as the per-pose updates'
    # sum does (one product over all N samples lets the BLAS block its
    # sample sum across pose boundaries)
    dq, da = ksc[:, :block] @ kmn[:, :block].T, ksc[:, :block] @ yv[:block]
    for lo in range(block, n, block):
        hi = lo + block
        dq = dq + ksc[:, lo:hi] @ kmn[:, lo:hi].T
        da = da + ksc[:, lo:hi] @ yv[lo:hi]
    return dq, da


def fitc_update_cuda(name: str, pseudo, linv, x, y, var, mask, scale):
    """(dQ_M (M, M), dalpha (M, q)) for one rank-N FITC update.

    pseudo: (M, d); linv: (M, M) = chol(K_M)^{-1}, lower triangular with
    exact zeros above the diagonal, as ``solve_triangular`` writes them (the
    kernel reads only the 64 x 64 tiles on and below the diagonal, the
    plain version all of it); x: (n, d); y: (n, q); var: (n,);
    mask: (n,) bool. Any M and n. The op ``egp::fitc_update``: CPU tensors
    take :func:`fitc_update_plain`; CUDA tensors launch ``csrc/fitc.cu``,
    the :data:`LAUNCHES` kernels of :func:`fitc_plan`'s grid (one call
    counted in ``fitc_update_cuda.launches``, or in ``.captured`` under
    CUDA-graph capture: ``ops/_library.note_launch``), or raise."""
    check_devices("fitc_update_cuda", pseudo, linv, x, y, var)
    return torch.ops.egp.fitc_update(pseudo, linv, x, y, var, mask,
                                     *family_spec(name), float(scale))


fitc_update_cuda.launches = 0
fitc_update_cuda.captured = 0


def _fitc_cuda(pseudo, linv, x, y, var, mask, base, ratios, weights, scale):
    dt = pseudo.dtype
    check_cuda_operands("fitc_update_cuda", dt, pseudo, linv, x, y, var)
    if mask.device != pseudo.device or mask.dtype != torch.bool \
            or not mask.is_contiguous():
        raise ValueError("fitc_update_cuda: mask must be a contiguous bool "
                         "tensor on the operands' device")
    if pseudo.dim() != 2 or x.dim() != 2 or y.dim() != 2:
        raise ValueError("fitc_update_cuda: pseudo, x and y must be 2-D")
    m, d = pseudo.shape
    n, q = y.shape
    if (linv.shape != (m, m) or x.shape != (n, d) or var.shape != (n,)
            or mask.shape != (n,)):
        raise ValueError(
            f"fitc_update_cuda: shapes pseudo {tuple(pseudo.shape)} linv "
            f"{tuple(linv.shape)} x {tuple(x.shape)} y {tuple(y.shape)} var "
            f"{tuple(var.shape)} mask {tuple(mask.shape)}")
    if m == 0 or n == 0 or d == 0 or q == 0:
        raise ValueError(f"fitc_update_cuda: empty operand, m={m} n={n} "
                         f"d={d} q={q}")
    fam, ncomp, coefs, weights = packed_spec(base, tuple(ratios),
                                             tuple(weights), float(scale))
    dev = pseudo.device
    plan = fitc_plan(m, n, _sms(dev.index))
    dq = torch.empty((m, m), dtype=dt, device=dev)
    da = torch.empty((m, q), dtype=dt, device=dev)
    # scratch: kmn, the beta partials (float64 at both dtypes), the
    # weights, the SYRK's partial tiles and the int32 arrival counters
    # (zeroed by the first launch)
    kmn = torch.empty((m, n), dtype=dt, device=dev)
    partial = torch.empty((plan.row_blocks, n), dtype=torch.float64,
                          device=dev)
    w = torch.empty((n,), dtype=dt, device=dev)
    ws = _syrk_workspace(plan, q, dt, dev)
    counters = torch.empty((plan.col_blocks + plan.tiles,), dtype=torch.int32,
                           device=dev)
    kl = load_library()
    fn = kl.lib.egp_fitc_f32 if dt == torch.float32 else kl.lib.egp_fitc_f64
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(pseudo.data_ptr(), linv.data_ptr(), x.data_ptr(), y.data_ptr(),
              var.data_ptr(), mask.data_ptr(), kmn.data_ptr(),
              partial.data_ptr(), w.data_ptr(), dq.data_ptr(),
              da.data_ptr(), ws.data_ptr(), counters.data_ptr(), m, n, d, q,
              *_syrk_grid(plan, dt, y), fam, ncomp, coefs, weights, dev.index,
              stream)
    kl.check(code, "FITC kernel launch")
    note_launch(fitc_update_cuda)
    if dt == torch.float32:
        count("fitc.syrk_tma" if _copy_engine(plan, y)
              else "fitc.syrk_cp_async")
    return dq, da


def fitc_syrk_alone(kmn, w, y, mask):
    """The float32 SYRK and dalpha, the last of the FITC kernel's launches,
    by itself on a kmn (M, n) and weights w (n,) computed beforehand
    (``mask ? 1 / (lam + var) : 0``), on :func:`fitc_plan`'s grid: returns
    ``(launch, dq, da)``, ``launch()`` writing dQ (M, M) and dalpha (M, q)
    into ``dq`` and ``da`` with one launch on the current stream, so that
    ``chip_smoke.py`` times the SYRK alone by CUDA events (kmn and w must
    start on 16 bytes where the copy engine reads them). The map never
    calls it, and its launches are not counted."""
    check_cuda_operands("fitc_syrk_alone", torch.float32, kmn, w, y)
    m, n = kmn.shape
    q = y.shape[1]
    if w.shape != (n,) or y.shape != (n, q) or mask.shape != (n,) \
            or mask.dtype != torch.bool or mask.device != kmn.device:
        raise ValueError("fitc_syrk_alone: shapes, or a mask that is not "
                         "bool on the operands' device")
    dev = kmn.device
    plan = fitc_plan(m, n, _sms(dev.index))
    dq = torch.empty((m, m), dtype=kmn.dtype, device=dev)
    da = torch.empty((m, q), dtype=kmn.dtype, device=dev)
    ws = _syrk_workspace(plan, q, kmn.dtype, dev)
    # the kernel sets each super-tile's counter back to 0 when it is done
    counters = torch.zeros((plan.super_tiles,), dtype=torch.int32, device=dev)
    kl = load_library()

    def launch():
        code = kl.lib.egp_fitc_syrk_f32(
            kmn.data_ptr(), w.data_ptr(), y.data_ptr(), mask.data_ptr(),
            dq.data_ptr(), da.data_ptr(), ws.data_ptr(), counters.data_ptr(),
            m, n, q, *_syrk_grid(plan, kmn.dtype, y), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        kl.check(code, "FITC SYRK launch")

    return launch, dq, da


define("fitc_update(Tensor pseudo, Tensor linv, Tensor x, Tensor y, "
       "Tensor var, Tensor mask, str family, float[] ratios, "
       "float[] weights, float scale) -> (Tensor, Tensor)",
       _fitc_plain, _fitc_cuda,
       lambda pseudo, linv, x, y, *_: (
           pseudo.new_empty((pseudo.shape[0], pseudo.shape[0])),
           pseudo.new_empty((pseudo.shape[0], y.shape[1]))))
