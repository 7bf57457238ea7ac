"""Bank fit and bank Cholesky solve: the hand-written CUDA kernels
(``csrc/bank.cu``) and their plain PyTorch versions.

Counterpart of ``erl_gaussian_process_tpu/ops/pallas_bank.py``. Each call
factors a bank of B small exact GPs of n samples:

- :func:`bank_fit_cuda`: the gram ``k(x, x) + diag(var)`` with masked rows
  as identity rows, then ``L`` and ``L^{-1}`` (``_fit_kernel``);
- :func:`bank_cholesky_solve_cuda`: ``L`` and ``L^{-1}`` of a given gram
  batch (``_chol_kernel``).

Both return ``(L, L_inv, alpha)`` with ``alpha = K^{-1} y``. The kernels
form alpha themselves from each member's ``L^{-1}`` (one launch, no other
kernel), so a member's three results are bit for bit the same whatever
bank it is computed in; the plain versions, like the JAX package, take two
batched products against ``L^{-1}`` (:func:`solve_alpha`). The JAX package
took its kernel on a TPU in float32 above n = 96 only; here every CUDA call
launches the kernel, at any n and both dtypes. A member whose factorization
fails comes out all NaN in both versions.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from erl_gaussian_process_tpu_torch.ops._build import load_library
from erl_gaussian_process_tpu_torch.ops._library import note_launch
from erl_gaussian_process_tpu_torch.ops.gram import (
    check_cuda_operands,
    packed_family,
)


def solve_alpha(L_inv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """alpha = L^{-T} L^{-1} y: two batched products. L_inv (B, n, n), y
    (B, n, q)."""
    return torch.bmm(L_inv.mT, torch.bmm(L_inv, y))


def _masked_y(y, mask):
    return torch.where(mask[:, :, None], y, torch.zeros_like(y))


def _factor_plain(K: torch.Tensor):
    L, info = torch.linalg.cholesky_ex(K)
    L = L.masked_fill((info != 0)[:, None, None], float("nan")).contiguous()
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    L_inv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return L, L_inv.contiguous()


def bank_fit_plain(name: str, x, y, var, mask, scale):
    """The plain PyTorch version of the bank fit kernel, on any device:
    batched ``train_gram`` -> ``cholesky_ex`` (a failed member all NaN, no
    jitter) -> ``L^{-1}`` by a triangular solve -> :func:`solve_alpha`."""
    # kernels.stationary imports this package's gram module: import late
    from erl_gaussian_process_tpu_torch.kernels.stationary import train_gram

    K = train_gram(name, x, torch.where(mask, var, torch.zeros_like(var)),
                   scale, mask=mask)
    L, L_inv = _factor_plain(K)
    return L, L_inv, solve_alpha(L_inv, _masked_y(y, mask))


def bank_cholesky_solve_plain(K, y):
    """The plain PyTorch version of the bank Cholesky kernel, on any
    device."""
    L, L_inv = _factor_plain(K)
    return L, L_inv, solve_alpha(L_inv, y)


def bank_fit_cuda(name: str, x, y, var, mask, scale,
                  members_per_block: int | None = None):
    """(L, L_inv, alpha) of B GPs. x (B, n, d); y (B, n, q); var (B, n);
    mask (B, n) bool, False rows padding (identity rows of the gram, zero
    rows of alpha; any rows, not only a suffix). On the card a member's L,
    L_inv and alpha do not depend on the bank it is fit in.

    CPU tensors take :func:`bank_fit_plain`; CUDA tensors launch
    ``csrc/bank.cu`` once, on the path :func:`bank_chol_plan` picks
    (counted in ``bank_fit_cuda.launches``), or raise.
    ``members_per_block`` overrides the plan's (a float32 member count to
    measure, or 0 for the elimination); the C entry refuses counts whose
    slabs do not fit a block."""
    tensors = (x, y, var, mask)
    if all(t.device.type == "cpu" for t in tensors):
        return bank_fit_plain(name, x, y, var, mask, scale)
    dt = x.dtype
    check_cuda_operands("bank_fit_cuda", dt, x, y, var)
    if mask.device != x.device or mask.dtype != torch.bool \
            or not mask.is_contiguous():
        raise ValueError("bank_fit_cuda: mask must be a contiguous bool "
                         "tensor on the operands' device")
    if x.dim() != 3 or y.dim() != 3:
        raise ValueError("bank_fit_cuda: x and y must be 3-D")
    b, n, d = x.shape
    if (y.shape[:2] != (b, n) or var.shape != (b, n)
            or mask.shape != (b, n)):
        raise ValueError(
            f"bank_fit_cuda: shapes x {tuple(x.shape)} y {tuple(y.shape)} "
            f"var {tuple(var.shape)} mask {tuple(mask.shape)}")
    if b == 0 or n == 0 or d == 0 or y.shape[2] == 0:
        raise ValueError(f"bank_fit_cuda: empty operand, B={b} n={n} d={d} "
                         f"q={y.shape[2]}")
    fam, ncomp, coefs, weights = packed_family(name, float(scale))
    q = y.shape[2]
    L, L_inv = torch.empty((2, b, n, n), dtype=dt, device=x.device)
    alpha = torch.empty((b, n, q), dtype=dt, device=x.device)
    kl = load_library()
    fn = kl.lib.egp_bank_fit_f32 if dt == torch.float32 else \
        kl.lib.egp_bank_fit_f64
    if members_per_block is None:
        members_per_block = _plan(n, dt, b, x.device.index).members_per_block
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), var.data_ptr(), mask.data_ptr(), y.data_ptr(),
              L.data_ptr(), L_inv.data_ptr(), alpha.data_ptr(), b, n, d, q,
              fam, ncomp, coefs, weights, members_per_block, x.device.index,
              stream)
    kl.check(code, "bank fit kernel launch")
    note_launch(bank_fit_cuda)
    return L, L_inv, alpha


bank_fit_cuda.launches = 0
bank_fit_cuda.captured = 0


PANEL = 16  # csrc/bank.cu kPt: the blocked kernel's panel and tile edge
MAX_MEMBERS_PER_BLOCK = 8  # csrc/bank.cu kMaxMembers


@dataclasses.dataclass(frozen=True)
class BankCholPlan:
    """How ``csrc/bank.cu`` factors a bank of B members of size n (the bank
    fit's and the bank Cholesky's one plan): ``path`` is ``"blocked"``
    (float32: one warp per member, ``members_per_block`` of them a block,
    each holding its :func:`member_tiles` in shared memory) or
    ``"eliminate"`` (the augmented elimination, one block per member;
    ``members_per_block`` 0, the code the C entry takes for it)."""

    path: str
    members_per_block: int


def member_tiles(n: int) -> int:
    """Shared-memory tiles of one member on the blocked path: the P (P + 1)
    / 2 lower tiles of the member padded to P = ceil(n / 16) a side, plus a
    scratch tile when P = 1 (csrc/bank.cu ``member_tiles``)."""
    p = -(-n // PANEL)
    return p * (p + 1) // 2 + (1 if p == 1 else 0)


@functools.lru_cache(maxsize=1024)
def bank_chol_plan(n: int, dtype: torch.dtype, smem_limit: int, batch: int,
                   sms: int) -> BankCholPlan:
    """The path of a bank of ``batch`` members of size n on a card with
    ``sms`` SMs and ``smem_limit`` bytes of opt-in shared memory per block:
    float32 members whose tiles fit take the blocked tensor-core kernel
    with min(:data:`MAX_MEMBERS_PER_BLOCK`, as many as fit, ceil(batch /
    sms)) members a block, so that a bank smaller than 8 members an SM
    still spreads over every SM (B = 736 at n = 100: 6 a block, 123 blocks
    on an H100's 132 SMs, where 8 a block left 40 SMs idle). float64, and
    float32 members too large for a block (n > 320 on an H100), take the
    augmented elimination."""
    member = member_tiles(n) * PANEL * PANEL * 4
    if dtype != torch.float32 or member > smem_limit:
        return BankCholPlan("eliminate", 0)
    return BankCholPlan("blocked", min(MAX_MEMBERS_PER_BLOCK,
                                       smem_limit // member,
                                       max(1, -(-batch // sms))))


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """The card's opt-in shared memory per block, in bytes."""
    kl = load_library()
    limit = kl.lib.egp_smem_optin(device_index)
    kl.check(max(0, -limit), "shared-memory query")
    return limit


def _plan(n: int, dtype: torch.dtype, batch: int,
          device_index: int) -> BankCholPlan:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return bank_chol_plan(n, dtype, smem_optin(device_index), batch, sms)


def bank_cholesky_solve_cuda(K, y):
    """(L, L_inv, alpha = K^{-1} y) for a gram batch K (B, n, n), read from
    its lower triangle; y (B, n, q).

    CPU tensors take :func:`bank_cholesky_solve_plain`; CUDA tensors launch
    ``csrc/bank.cu`` once, on the path :func:`bank_chol_plan` picks (counted
    in ``bank_cholesky_solve_cuda.launches``), or raise."""
    if K.device.type == "cpu" and y.device.type == "cpu":
        return bank_cholesky_solve_plain(K, y)
    check_cuda_operands("bank_cholesky_solve_cuda", K.dtype, K, y)
    if K.dim() != 3 or y.dim() != 3 or K.shape[1] != K.shape[2] \
            or y.shape[:2] != K.shape[:2]:
        raise ValueError(f"bank_cholesky_solve_cuda: shapes K "
                         f"{tuple(K.shape)} y {tuple(y.shape)}")
    b, n, _ = K.shape
    q = y.shape[2]
    if b == 0 or n == 0 or q == 0:
        raise ValueError(f"bank_cholesky_solve_cuda: empty operand, B={b} "
                         f"n={n} q={q}")
    L, L_inv = torch.empty((2, b, n, n), dtype=K.dtype, device=K.device)
    alpha = torch.empty((b, n, q), dtype=K.dtype, device=K.device)
    kl = load_library()
    fn = kl.lib.egp_bank_chol_f32 if K.dtype == torch.float32 else \
        kl.lib.egp_bank_chol_f64
    plan = _plan(n, K.dtype, b, K.device.index)
    stream = torch.cuda.current_stream(K.device).cuda_stream
    code = fn(K.data_ptr(), y.data_ptr(), L.data_ptr(), L_inv.data_ptr(),
              alpha.data_ptr(), b, n, q, plan.members_per_block,
              K.device.index, stream)
    kl.check(code, "bank Cholesky kernel launch")
    note_launch(bank_cholesky_solve_cuda)
    return L, L_inv, alpha


bank_cholesky_solve_cuda.launches = 0
bank_cholesky_solve_cuda.captured = 0
