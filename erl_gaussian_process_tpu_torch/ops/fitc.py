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

TILE = 64  # csrc/fitc.cu kTile: the tile edge of beta and of dQ
SYRK_BLOCKS_PER_SM = 3  # the SYRK's blocks per SM a split plan aims at
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
    beta, ``tiles`` lower tiles of dQ, each summed over ``splits`` chunks of
    ``chunk`` samples (a multiple of :data:`TILE`; the last one may be
    short), in ``launches`` kernel launches."""

    row_blocks: int
    col_blocks: int
    tiles: int
    splits: int
    chunk: int
    launches: int = LAUNCHES

    def split_range(self, s: int, n: int) -> range:
        """The samples split s sums."""
        return range(s * self.chunk, min(n, (s + 1) * self.chunk))


@functools.lru_cache(maxsize=None)
def fitc_plan(m: int, n: int, sms: int) -> FitcPlan:
    """The FITC kernel's plan for M = m pseudo points and n samples on a
    card with ``sms`` SMs: as many N-splits as keep the SYRK's tiles x
    splits blocks within :data:`SYRK_BLOCKS_PER_SM` per SM (4 fit one SM's
    shared memory), each split at least one 64-sample panel and every split
    non-empty: 171 tiles x 2 splits of 1024 at the hotel-0 shape on an
    H100, the fastest of 1 to 8 splits there (PERF.md)."""
    row_blocks = -(-m // TILE)
    tiles = row_blocks * (row_blocks + 1) // 2
    panels = -(-n // TILE)
    splits = max(1, min(panels, SYRK_BLOCKS_PER_SM * sms // tiles))
    chunk = -(-panels // splits) * TILE
    return FitcPlan(row_blocks=row_blocks, col_blocks=panels, tiles=tiles,
                    splits=-(-n // chunk), chunk=chunk)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def fitc_update_plain(name: str, pseudo, linv, x, y, var, mask, scale):
    """The plain PyTorch version of the FITC kernel, on any device: the
    beta-via-L_inv formulation of ``fitc_delta`` (the one the Pallas kernel
    also computes)."""
    return _fitc_plain(pseudo, linv, x, y, var, mask, *family_spec(name),
                       float(scale))


def _fitc_plain(pseudo, linv, x, y, var, mask, base, ratios, weights, scale):
    kmn = _plain_spec(pseudo, x, None, base, ratios, weights, scale)
    beta = linv @ kmn                                         # (M, n)
    lam = torch.clamp(1.0 - torch.sum(beta * beta, dim=0), min=0.0)
    inv = torch.where(mask, 1.0 / (lam + var), torch.zeros_like(lam))
    ksc = kmn * inv[None, :]
    yv = torch.where(mask[:, None], y, torch.zeros_like(y))
    return ksc @ kmn.T, ksc @ yv


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
    ws = torch.empty((plan.tiles * plan.splits, TILE, TILE), dtype=dt,
                     device=dev)
    counters = torch.empty((plan.col_blocks + plan.tiles,), dtype=torch.int32,
                           device=dev)
    kl = load_library()
    fn = kl.lib.egp_fitc_f32 if dt == torch.float32 else kl.lib.egp_fitc_f64
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(pseudo.data_ptr(), linv.data_ptr(), x.data_ptr(), y.data_ptr(),
              var.data_ptr(), mask.data_ptr(), kmn.data_ptr(),
              partial.data_ptr(), w.data_ptr(), dq.data_ptr(),
              da.data_ptr(), ws.data_ptr(), counters.data_ptr(), m, n, d, q,
              plan.splits, plan.chunk, fam, ncomp, coefs, weights, dev.index,
              stream)
    kl.check(code, "FITC kernel launch")
    note_launch(fitc_update_cuda)
    return dq, da


define("fitc_update(Tensor pseudo, Tensor linv, Tensor x, Tensor y, "
       "Tensor var, Tensor mask, str family, float[] ratios, "
       "float[] weights, float scale) -> (Tensor, Tensor)",
       _fitc_plain, _fitc_cuda,
       lambda pseudo, linv, x, y, *_: (
           pseudo.new_empty((pseudo.shape[0], pseudo.shape[0])),
           pseudo.new_empty((pseudo.shape[0], y.shape[1]))))
