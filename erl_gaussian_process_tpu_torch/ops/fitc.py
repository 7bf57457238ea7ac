"""Rank-N FITC update (dQ_M, dalpha): the hand-written CUDA kernel
(``csrc/fitc.cu``) and its plain PyTorch version.

Counterpart of ``erl_gaussian_process_tpu/ops/pallas_fitc.py``. The L_inv
product, the weighted SYRK and the ``y`` product all run inside the kernel;
the Kahan accumulation of the result stays with the caller
(``models/sparse_pseudo_input_gp.spgp_update``).
"""

from __future__ import annotations

import torch

from erl_gaussian_process_tpu_torch.ops._build import double_array, load_library
from erl_gaussian_process_tpu_torch.ops.gram import (
    check_cuda_operands,
    cross_gram_plain,
    family_args,
)

_TILE = 64  # csrc/fitc.cu kTile: rows of beta per partial sum


def fitc_update_plain(name: str, pseudo, linv, x, y, var, mask, scale):
    """The plain PyTorch version of the FITC kernel, on any device: the
    beta-via-L_inv formulation of ``fitc_delta`` (the one the Pallas kernel
    also computes)."""
    kmn = cross_gram_plain(name, pseudo, x, scale)            # (M, n)
    beta = linv @ kmn                                         # (M, n)
    lam = torch.clamp(1.0 - torch.sum(beta * beta, dim=0), min=0.0)
    inv = torch.where(mask, 1.0 / (lam + var), torch.zeros_like(lam))
    ksc = kmn * inv[None, :]
    yv = torch.where(mask[:, None], y, torch.zeros_like(y))
    return ksc @ kmn.T, ksc @ yv


def fitc_update_cuda(name: str, pseudo, linv, x, y, var, mask, scale):
    """(dQ_M (M, M), dalpha (M, q)) for one rank-N FITC update.

    pseudo: (M, d); linv: (M, M) = chol(K_M)^{-1}; x: (n, d); y: (n, q);
    var: (n,); mask: (n,) bool. Any M and n. CPU tensors take
    :func:`fitc_update_plain`; CUDA tensors launch ``csrc/fitc.cu``
    (counted in ``fitc_update_cuda.launches``) or raise."""
    tensors = (pseudo, linv, x, y, var, mask)
    if all(t.device.type == "cpu" for t in tensors):
        return fitc_update_plain(name, pseudo, linv, x, y, var, mask, scale)
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
    fam, ratios, weights = family_args(name)
    dev = pseudo.device
    kmn = torch.empty((m, n), dtype=dt, device=dev)
    partial = torch.empty((-(-m // _TILE), n), dtype=dt, device=dev)
    w = torch.empty((n,), dtype=dt, device=dev)
    dq = torch.empty((m, m), dtype=dt, device=dev)
    da = torch.empty((m, q), dtype=dt, device=dev)
    kl = load_library()
    fn = kl.lib.egp_fitc_f32 if dt == torch.float32 else kl.lib.egp_fitc_f64
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(pseudo.data_ptr(), linv.data_ptr(), x.data_ptr(), y.data_ptr(),
              var.data_ptr(), mask.data_ptr(), kmn.data_ptr(),
              partial.data_ptr(), w.data_ptr(), dq.data_ptr(), da.data_ptr(),
              m, n, d, q, fam, len(ratios), double_array(ratios),
              double_array(weights), float(scale), dev.index, stream)
    kl.check(code, "FITC kernel launch")
    fitc_update_cuda.launches += 1
    return dq, da


fitc_update_cuda.launches = 0
