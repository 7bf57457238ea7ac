"""Numerical drift check for long-horizon FITC replays (counterpart of
``erl_gaussian_process_tpu/utils/drift.py``).

The reference for a float32 replay is an exact float64 replay of the
IDENTICAL per-pose datasets (``update_batch(collect_datasets=True)``),
written on the port's plain float64 torch functions only — no kernel of
this package and no JAX — so it shares nothing with the code it checks
but the kernel-family formulas.
"""

from __future__ import annotations

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.kernels.stationary import kernel_fn
from erl_gaussian_process_tpu_torch.ops.gram import cross_gram_plain


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=torch.float64)


def replay_f64(pseudo, scale, kernel, dx, dy, dm, var, grid,
               poses_per_chunk: int = 16, device="cpu") -> np.ndarray:
    """Float64 replay of the collected datasets; returns the posterior
    log-odds on ``grid`` as a numpy array.

    pseudo (M, d) UNPADDED pseudo points (far-point padding rows are inert);
    dx (B, n, d) / dy (B, n, 1) / dm (B, n) the collected datasets (numpy
    or tensors); var the scalar log-odds variance; grid (q, d) query points.
    ``poses_per_chunk`` poses go into one increment (the FITC increment is
    an order-free sum over sample columns, so this is exact up to float64
    reassociation). Runs on ``device``."""
    dev = torch.device(device)
    p64 = _f64(pseudo, dev)
    m = p64.shape[0]
    km = kernel_fn(kernel)(p64, p64, float(scale))
    L_km = torch.linalg.cholesky(km)
    L_inv = torch.linalg.solve_triangular(
        L_km, torch.eye(m, dtype=torch.float64, device=dev), upper=False)
    qm = km.clone()
    dy64 = _f64(dy, dev)
    alpha = torch.zeros((m, dy64.shape[-1]), dtype=torch.float64, device=dev)
    dx64 = _f64(dx, dev)
    dmb = torch.as_tensor(dm).to(device=dev, dtype=torch.bool)
    B, _, d = dx64.shape
    c = int(poses_per_chunk)
    for i0 in range(0, B, c):
        xs = dx64[i0:i0 + c].reshape(-1, d)
        ys = dy64[i0:i0 + c].reshape(-1, dy64.shape[-1])
        ms = dmb[i0:i0 + c].reshape(-1)
        kmn = cross_gram_plain(kernel, p64, xs, scale)          # (M, nc)
        beta = L_inv @ kmn
        lam = torch.clamp(1.0 - torch.sum(beta * beta, dim=0), min=0.0)
        w = torch.where(ms, 1.0 / (lam + float(var)), torch.zeros_like(lam))
        ksc = kmn * w[None, :]
        qm += ksc @ kmn.T
        alpha += ksc @ torch.where(ms[:, None], ys, torch.zeros_like(ys))
    L_qm = torch.linalg.cholesky(qm)
    a = torch.linalg.solve_triangular(L_qm, alpha, upper=False)
    a = torch.linalg.solve_triangular(L_qm.T, a, upper=True)
    kq = cross_gram_plain(kernel, p64, _f64(grid, dev), scale)   # (M, q)
    return (kq.T @ a)[:, 0].cpu().numpy()


def drift_metric(lo_test, lo_ref) -> float:
    """max |lo_test - lo_ref| / max |lo_ref| — the relative log-odds
    drift of a replayed posterior against its float64 reference."""
    lo_test = np.asarray(lo_test, np.float64)
    lo_ref = np.asarray(lo_ref, np.float64)
    return float(np.abs(lo_test - lo_ref).max() / np.abs(lo_ref).max())


def sign_agreement(lo_test, lo_ref, confident: float = 1.0) -> float:
    """Fraction of confidently classified cells (|lo_ref| >= confident)
    whose log-odds sign agrees; 1.0 when there is no such cell."""
    lo_test = np.asarray(lo_test, np.float64)
    lo_ref = np.asarray(lo_ref, np.float64)
    conf = np.abs(lo_ref) >= confident
    if not conf.any():
        return 1.0
    return float(np.mean(np.sign(lo_test[conf]) == np.sign(lo_ref[conf])))
