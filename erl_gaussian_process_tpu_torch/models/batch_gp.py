"""Batched bank of small exact GPs (counterpart of
``erl_gaussian_process_tpu/models/batch_gp.py``): the sensor GPs' partition
grids become one bank of B members, fit by one launch of the bank kernel
(``ops/bank.py``) and queried by one routed predict.

Each member is a padded fixed-size GP. Padding uses the identity-diagonal
trick (gram diag 1 / alpha 0 outside the mask), so one batched
factorization over (B, n, n) trains the whole bank. The bank fit always
returns ``L^{-1}`` as well, so predicts whiten with a product; a state
without it (a loaded checkpoint) whitens with a triangular solve.

A reduced-rank bank (:func:`bank_fit_rr`) solves each member's (m, m)
information system over one shared Hilbert basis instead; its L and alpha
have m = #basis rows, and its predicts take ``+||.||^2`` for the variance.
Those are batched library products and factorizations, as the JAX package
leaves them to XLA. The sharded bank fit over several ranks is
``parallel/mesh.sharded_bank_fit``.

A routed predict groups its queries by member in one of two ways, which
share the batched predict (:func:`_predict_rows`) and nothing else:
:func:`group_queries` on the host, into a bucket whose shape follows the
queries (:func:`bank_predict_assigned`, the public entry, and the CPU
model's path), and :func:`group_chunks` on the device, into rows of
``ROUTE_CHUNK`` slots whose number depends only on the query count and
the bank's size (:func:`bank_predict_chunked`, the body of both sensor
GPs' graphed test, ``models/sensor_graph.SensorGraphs.routed_test``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.kernels.reduced_rank import (
    rr_features,
    rr_train_system,
)
from erl_gaussian_process_tpu_torch.models.gp_core import (
    DEFAULT_DEVICE,
    cholesky_flagged,
    cholesky_solve_pair,
    jitter_ladder,
    resolve_device,
    whiten,
)
from erl_gaussian_process_tpu_torch.ops.bank import (
    bank_cholesky_solve_cuda,
    bank_fit_cuda,
)
from erl_gaussian_process_tpu_torch.ops.gram import cross_gram_batched_cuda
from erl_gaussian_process_tpu_torch.utils.timing import count, span

# The device-routed test (:func:`bank_predict_chunked`): queries padded to a
# multiple of ROUTE_PAD, grouped into rows of ROUTE_CHUNK slots (chosen on
# an H100 among 16, 32 and 64, which were within noise of each other;
# PERF.md §6).
ROUTE_PAD = 1024
ROUTE_CHUNK = 32


class BankState(NamedTuple):
    """x (B, n, d); mask (B, n) bool; L (B, n, n); alpha (B, n, q);
    trained (B,) bool (the member has >= 1 sample); L_inv (B, n, n), None
    for a state loaded from a checkpoint."""

    x: torch.Tensor
    mask: torch.Tensor
    L: torch.Tensor
    alpha: torch.Tensor
    trained: torch.Tensor
    L_inv: Optional[torch.Tensor] = None


def bank_state_from_numpy(d, device=DEFAULT_DEVICE) -> BankState:
    """A BankState on ``device`` from a dict of host arrays: a checkpoint's
    ``bank`` entry, or a JAX ``BankState._asdict()``. ``L_inv`` carries
    over when present."""
    device = resolve_device(device)
    return BankState(**{
        k: torch.tensor(np.asarray(v), device=device)
        for k, v in d.items() if k in BankState._fields and v is not None})


def bank_fit_core(x, y, var, mask, scale, *, kernel: str) -> BankState:
    """Train B GPs at once: x (B, n, d); y (B, n, q); var/mask (B, n). The
    one implementation of the bank fit, shared by :func:`bank_fit` and the
    sensor GPs' scan trains: the bank kernel for CUDA tensors, its plain
    version for CPU tensors."""
    L, L_inv, alpha = bank_fit_cuda(kernel, x, y, var, mask, scale)
    return BankState(x=x, mask=mask, L=L, alpha=alpha,
                     trained=torch.any(mask, dim=1), L_inv=L_inv)


bank_fit = bank_fit_core


class RRFitParts(NamedTuple):
    """The reduced-rank bank fit before its jitter ladder: ``bank`` with L
    the plain Cholesky of each information system A (NaN where it failed)
    and alpha solved with it; A and b; ``bad`` (B,) the failed members;
    ``any_bad`` () their any. Tensor code with no host sync, so a CUDA
    graph captures it (``models/sensor_graph.py``)."""

    bank: BankState
    A: torch.Tensor
    b: torch.Tensor
    bad: torch.Tensor
    any_bad: torch.Tensor


def bank_fit_rr_parts(x, y, var, mask, freq, sqrt_s, origin, half,
                      inv_sqrt_vol) -> RRFitParts:
    """Each member's features, information system, Cholesky and solves,
    batched, on the basis constants (``ReducedRankBasis.consts``)."""
    phi = rr_features(x, mask, freq, sqrt_s, origin, half, inv_sqrt_vol)
    A, b = rr_train_system(phi, y, var, mask)
    L, bad = cholesky_flagged(A)
    bank = BankState(x=x, mask=mask, L=L, alpha=cholesky_solve_pair(L, b),
                     trained=torch.any(mask, dim=1))
    return RRFitParts(bank, A, b, bad, torch.any(bad))


def bank_fit_rr_finish(parts: RRFitParts) -> tuple:
    """(bank, whether the ladder ran): one host read of ``any_bad``; when a
    member failed, ``gp_core.jitter_ladder`` retries the failed members and
    alpha is solved again from the new L, as ``gp_core.cholesky_fit`` does.
    Members that did not fail keep their bits either way."""
    if not bool(parts.any_bad):
        return parts.bank, False
    L = jitter_ladder(parts.A, parts.bank.L, parts.bad)
    return parts.bank._replace(L=L, alpha=cholesky_solve_pair(L, parts.b)), \
        True


def bank_fit_rr_core(x, y, var, mask, freq, sqrt_s, origin, half,
                     inv_sqrt_vol) -> BankState:
    """Reduced-rank bank fit on the basis constants
    (``ReducedRankBasis.consts``): each member's features, information
    system and robust Cholesky, batched (:func:`bank_fit_rr_parts`, then
    :func:`bank_fit_rr_finish`). The one implementation shared by
    :func:`bank_fit_rr` and the sensor GPs' scan trains."""
    return bank_fit_rr_finish(bank_fit_rr_parts(
        x, y, var, mask, freq, sqrt_s, origin, half, inv_sqrt_vol))[0]


def bank_fit_rr(x, y, var, mask, basis) -> BankState:
    """Reduced-rank bank fit: every member solves its own (m, m)
    information system over the shared ``basis`` (a
    ``kernels.reduced_rank.ReducedRankBasis``). x (B, n, d); y (B, n, q);
    var/mask (B, n). L and alpha have m = #basis rows; x and mask are kept
    for routing and checkpoints."""
    return bank_fit_rr_core(x, y, var, mask, *basis.consts(x.device))


def _members_predict(xs, ms, W, alphas, qs, scale, *, kernel: str,
                     fused: bool, reduced_rank: bool = False):
    """Member b answers its queries qs[b] (C, d): one batched cross gram
    and one whitening per member. W is L^{-1} when ``fused``, else L.
    Returns mean (B, C, q), var (B, C)."""
    kt = cross_gram_batched_cuda(kernel, xs, qs.contiguous(), scale,
                                 ms.contiguous())               # (B, n, C)
    mean = torch.bmm(kt.mT, alphas)
    at = torch.bmm(W, kt) if fused else whiten(W, kt)
    s = torch.sum(at * at, dim=1)
    if reduced_rank:
        return mean, s
    # clamp: whitening can overshoot ||at||^2 past 1 by rounding near
    # training points; a negative variance NaNs downstream sqrts
    return mean, torch.clamp(1.0 - s, min=0.0)


def bank_predict(state: BankState, xq, scale, *, kernel: str,
                 reduced_rank: bool = False):
    """Each bank member predicts its own queries. xq (B, m, d).
    Returns mean (B, m, q), var (B, m); ``reduced_rank`` takes
    ``+||.||^2`` for the variance."""
    fused = state.L_inv is not None
    return _members_predict(state.x, state.mask,
                            state.L_inv if fused else state.L, state.alpha,
                            xq, scale, kernel=kernel, fused=fused,
                            reduced_rank=reduced_rank)


def _predict_segmented(state: BankState, mids, qs, scale, *, kernel: str,
                       fused: bool, reduced_rank: bool = False):
    """One active bank member per row of ``mids``: member mids[b'] answers
    its C grouped queries qs[b'], so each member's (n, n) factor is read
    once however many queries routed to it."""
    W = state.L_inv if fused else state.L
    return _members_predict(state.x[mids], state.mask[mids], W[mids],
                            state.alpha[mids], qs, scale, kernel=kernel,
                            fused=fused, reduced_rank=reduced_rank)


def _predict_segmented_rr(state: BankState, mids, qs, basis):
    """The reduced-rank routed predict: the query features do not depend
    on the member (rows = #basis), and each active member whitens them
    against its own information factor; variance ``+||.||^2``."""
    ones = torch.ones(qs.shape[:-1], dtype=torch.bool, device=qs.device)
    kt = basis.features(qs, ones).mT                  # (Bp, m_basis, C)
    mean = torch.bmm(kt.mT, state.alpha[mids])
    at = whiten(state.L[mids], kt)
    return mean, torch.sum(at * at, dim=1)


def _predict_rows(state: BankState, mids, qs, scale, *, kernel: str,
                  reduced_rank: bool = False, basis=None):
    """The routed predict of grouped queries, either grouping's: member
    mids[r] answers qs[r] (rows, C, d). ``basis``: the reduced-rank
    predict (:func:`_predict_segmented_rr`); else :func:`_predict_segmented`,
    fused when the state holds L^-1."""
    if basis is not None:
        return _predict_segmented_rr(state, mids, qs, basis)
    return _predict_segmented(state, mids, qs, scale, kernel=kernel,
                              fused=state.L_inv is not None,
                              reduced_rank=reduced_rank)


def _next_pow2(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def _next_mult8(v: int) -> int:
    return max(8, -(-int(v) // 8) * 8)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def group_queries(idx: np.ndarray, trained: np.ndarray):
    """The routed predict's host grouping: idx (m,) names each query's
    member (-1 unresolved), trained (B,) is the bank's host mask.

    Returns (ok, slots, svalid, member_ids): ok (m,) the queries a trained
    member answers; row r of the (Bp, C) bucket holds member member_ids[r]'s
    queries slots[r] where svalid[r]. Queries keep their order within a
    member (stable sort); C is a power of two, Bp a multiple of 8 (padded
    rows name member 0). The last three are None when no query is ok."""
    B = trained.shape[0]
    ok = (idx >= 0) & (idx < B)
    ok[ok] = trained[idx[ok]]
    if not ok.any():
        return ok, None, None, None
    okj = np.flatnonzero(ok)
    order = okj[np.argsort(idx[okj], kind="stable")]
    sorted_members = idx[order]
    active = np.unique(sorted_members)
    counts = np.bincount(sorted_members, minlength=B)[active]
    C = _next_pow2(int(counts.max()))
    # padded member rows run full discarded predicts against member 0;
    # buckets of 8 cap that waste at 7 rows
    Bp = _next_mult8(int(active.size))
    starts = np.searchsorted(sorted_members, active)
    row = np.searchsorted(active, sorted_members)
    pos = np.arange(order.size) - starts[row]
    slots = np.zeros((Bp, C), np.int64)
    svalid = np.zeros((Bp, C), bool)
    member_ids = np.zeros((Bp,), np.int64)
    slots[row, pos] = order
    svalid[row, pos] = True
    member_ids[: active.size] = active
    return ok, slots, svalid, member_ids


def bank_predict_assigned(state: BankState, q, idx, scale, *, kernel: str,
                          reduced_rank: bool = False, basis=None,
                          profile: dict | None = None):
    """Per-query routed prediction: query j is answered by bank member
    idx[j]. q (m, d) and idx (m,) host arrays; idx may be -1 (unresolved,
    flagged invalid) or name an untrained member (invalid too).

    Returns numpy (mean (m, q_dim), var (m,), valid (m,) bool).

    Queries are grouped by member on the host (:func:`group_queries`), and
    the active members answer their groups in one batched predict on the
    state's device (:func:`_predict_segmented`).

    ``basis`` (a ``ReducedRankBasis``): the reduced-rank predict, queries
    answered with the basis features and the ``+||.||^2`` variance.
    ``reduced_rank`` alone takes ``+||.||^2`` with the kernel's gram.

    ``profile``: pass a dict to record per-phase wall-clock seconds (keys
    ``host_group``, ``h2d``, ``device``, ``d2h_scatter``, plus the bucket
    shape ``bucket``). Profiling synchronizes between phases. The phases
    are also spans (``utils.timing.span``), which open and close at the
    same statements and synchronize nothing, so under a profiler they
    show where the host spends a call while the card runs on:
    ``egp.bank.group``, ``egp.bank.h2d``, ``egp.bank.predict``, then
    ``d2h_scatter`` as ``egp.bank.readback`` and ``egp.bank.scatter``.
    Each call that answers a query counts ``bank.routed_eager`` (a sensor
    GP with graphs routes through ``SensorGraphs.routed_test`` instead,
    which counts ``bank.routed_graphed``)."""
    prof = profile is not None
    if prof:
        t0 = time.perf_counter()
    with span("egp.bank.group"):
        q = np.asarray(q)
        idx = np.asarray(idx)
        m = q.shape[0]
        dev = state.x.device
        dtype = np.dtype(np.float32 if state.alpha.dtype == torch.float32
                         else np.float64)
        q_dim = state.alpha.shape[2]
        mean_out = np.zeros((m, q_dim), dtype)
        var_out = np.full((m,), 1.0, dtype)
        ok, slots, svalid, member_ids = group_queries(
            idx, state.trained.cpu().numpy())
    if slots is None:
        return mean_out, var_out, ok
    if prof:
        t1 = time.perf_counter()
        profile["host_group"] = t1 - t0
        profile["bucket"] = tuple(int(v) for v in slots.shape)

    with span("egp.bank.h2d"):
        qs = torch.as_tensor(q[slots].astype(dtype, copy=False), device=dev)
        mids = torch.as_tensor(member_ids, device=dev)
        if prof:
            _sync(dev)
    count("bank.routed_eager")
    if prof:
        t2 = time.perf_counter()
        profile["h2d"] = t2 - t1
    with span("egp.bank.predict"):
        mean_seg, var_seg = _predict_rows(state, mids, qs, scale,
                                          kernel=kernel,
                                          reduced_rank=reduced_rank,
                                          basis=basis)
        if prof:
            _sync(dev)
    if prof:
        t3 = time.perf_counter()
        profile["device"] = t3 - t2
    with span("egp.bank.readback"):
        mean_seg = mean_seg.cpu().numpy()
        var_seg = var_seg.cpu().numpy()
    with span("egp.bank.scatter"):
        mean_out[slots[svalid]] = mean_seg[svalid]
        var_out[slots[svalid]] = var_seg[svalid]
    if prof:
        profile["d2h_scatter"] = time.perf_counter() - t3
    return mean_out, var_out, ok


def chunk_rows(m: int, members: int, chunk: int) -> int:
    """The rows of ``chunk`` slots that always hold m queries grouped by
    member over ``members`` members: sum_b ceil(c_b / chunk) <= m / chunk
    + members."""
    return -(-m // chunk) + members


def group_chunks(key, members: int, chunk: int):
    """The device-routed test's grouping, fixed-shape tensor code with no
    host sync (a CUDA graph captures it): key (m,) int64 names each query's
    member, ``members`` (B) for a query no member answers.

    Member b's c_b queries fill ceil(c_b / chunk) consecutive rows of
    ``chunk`` slots, in their order (a stable sort, as
    :func:`group_queries`); R = :func:`chunk_rows` rows. Returns (src (R,
    chunk): the query in each slot, m for an empty slot; mids (R,): each
    row's member, 0 for an unused row; slot (m,): each query's flat slot
    in (R * chunk), R * chunk for a query no member answers)."""
    m = key.shape[0]
    dev = key.device
    R = chunk_rows(m, members, chunk)
    counts = torch.zeros(members + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, key, torch.ones_like(key))[:members]
    rows = torch.div(counts + (chunk - 1), chunk, rounding_mode="floor")
    first_row = torch.cumsum(rows, 0) - rows
    first_rank = torch.cumsum(counts, 0) - counts
    order = torch.argsort(key, stable=True)
    member = key[order]
    answered = member < members
    member = torch.clamp(member, max=members - 1)
    rank = torch.arange(m, device=dev) - first_rank[member]
    row = first_row[member] + torch.div(rank, chunk, rounding_mode="floor")
    flat = torch.where(answered, row * chunk + rank % chunk, R * chunk)
    # one dump slot and one dump row past the end take what no slot holds
    src = torch.full((R * chunk + 1,), m, dtype=torch.int64, device=dev)
    src[flat] = order
    mids = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    mids[torch.where(answered, row, R)] = member
    slot = torch.empty_like(flat)
    slot[order] = flat
    return src[:-1].view(R, chunk), mids[:-1], slot


def bank_predict_chunked(state: BankState, q, idx, scale, *, kernel: str,
                         reduced_rank: bool = False, basis=None):
    """The routed predict on the device, every shape fixed by the query
    count and the bank's size: q (m, d) and idx (m,) int64 tensors on the
    bank's device, idx -1 (unresolved) or a member, which answers when it
    is trained.

    Returns one tensor (q_dim + 2, m): the mean's rows, the variance and
    the valid flag (1 or 0); a query no member answers reads mean 0,
    variance 1, valid 0, as :func:`bank_predict_assigned` gives it. The
    queries are grouped by :func:`group_chunks` in rows of ``ROUTE_CHUNK``
    slots, answered row by row by :func:`_predict_rows` and gathered back
    by their slots."""
    B = state.trained.shape[0]
    ok = (idx >= 0) & (idx < B)
    ok = ok & state.trained[torch.where(ok, idx, 0)]
    src, mids, slot = group_chunks(torch.where(ok, idx, B), B, ROUTE_CHUNK)
    qs = torch.cat([q, torch.zeros_like(q[:1])])[src]
    mean, var = _predict_rows(state, mids, qs, scale, kernel=kernel,
                              reduced_rank=reduced_rank, basis=basis)
    mean = mean.reshape(-1, mean.shape[-1])
    mean = torch.cat([mean, torch.zeros_like(mean[:1])])[slot]
    var = var.reshape(-1)
    var = torch.cat([var, torch.ones_like(var[:1])])[slot]
    return torch.cat([mean.mT, var[None], ok.to(var.dtype)[None]])


class BatchGPBank:
    """API-parity replacement for the reference's
    BatchGaussianProcessUpdateTorch: collect B (gram, y) problems on the
    host, solve them in one launch of the bank Cholesky kernel on
    ``device`` (its plain version on the CPU), and read back per-GP (L,
    alpha)."""

    def __init__(self, batch_size: int, max_num_samples: int, y_dim: int = 1,
                 dtype=np.float32, device=DEFAULT_DEVICE):
        self.B = batch_size
        self.n = max_num_samples
        self.q = y_dim
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self.prepare_memory()

    def prepare_memory(self):
        eye = np.eye(self.n, dtype=self.dtype)
        self._K = np.tile(eye, (self.B, 1, 1))
        self._alpha = np.zeros((self.B, self.n, self.q), self.dtype)
        self._L = None

    def load_gp_data(self, i: int, size: int, ktrain, alpha):
        """Pad GP i's (size, size) gram into slot i (identity beyond
        size)."""
        self._K[i] = np.eye(self.n, dtype=self.dtype)
        self._K[i, :size, :size] = np.asarray(ktrain, self.dtype)[:size, :size]
        self._alpha[i] = 0.0
        a = np.asarray(alpha, self.dtype)
        if a.ndim == 1:
            a = a[:, None]
        self._alpha[i, :size, :a.shape[1]] = a[:size]

    def solve(self):
        L, _, alpha = bank_cholesky_solve_cuda(
            torch.as_tensor(self._K, device=self.device),
            torch.as_tensor(self._alpha, device=self.device))
        self._L = L.cpu().numpy()
        self._alpha = alpha.cpu().numpy()

    def get_gp_result(self, i: int):
        """Returns (L_i, alpha_i)."""
        return self._L[i], self._alpha[i]
