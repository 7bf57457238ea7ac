"""Sharded variants of the hot steps over ``torch.distributed``
(counterpart of ``erl_gaussian_process_tpu/parallel/mesh.py``).

The JAX package drives a ``jax.sharding.Mesh`` from one controller through
``shard_map``. Here every rank of a process group runs the same program
(SPMD): each rank calls the same function with the same inputs, works only
on its shard, and gets the result back replicated.

- **Bank fit** (:func:`sharded_bank_fit`): the member axis is sharded; each
  rank fits its members with ``bank_fit_core`` (the bank-fit kernel on
  CUDA), then the factors are gathered.
- **SPGP update** (:func:`sharded_spgp_update`, :func:`sharded_update_step`,
  :func:`sharded_update_many`): the sample axis is sharded; each rank
  computes its local (dQ_M, dalpha) (the FITC kernel on CUDA), the
  accumulation is one ``all_reduce`` pair (JAX's ``psum``), and the
  Kahan-compensated add runs replicated after it.
- **Predict** (:func:`sharded_spgp_predict`): the query axis is sharded;
  each rank's queries go through the gram kernel, then the results are
  gathered.

One deviation from JAX: the bank fit's and the predict's outputs stay
sharded there (one global array); ``torch.distributed`` has no global-array
view, so here they are gathered and every rank gets whole tensors.

The mesh is :class:`Mesh`, a record of (rank, size, device) that
:func:`make_mesh` builds over the default process group, which the caller
has initialised (``torch.distributed.init_process_group`` with its address,
world size and rank; give it a ``timeout`` so that a dead rank ends the
others' collectives with an error). It is one type for every backend:
``DeviceMesh`` would also describe a mesh, but several ranks sharing one
card (gloo ranks on ``cuda:0``) is a layout this module must take. **Host
staging**: gloo moves tensors through host memory; on a CUDA mesh over gloo
(``Mesh.host_staging``) each collective copies its tensors to the host
explicitly, runs there, and copies the result back. NCCL runs on the card.

**CUDA graphs.** A mesh whose collectives run on the card (NCCL;
:func:`runs_graphs`) can be captured: the models built on it replay each
step as one CUDA graph a rank, its collectives inside
(``models/pose_graph.py``, ``models/sensor_graph.py``), as the JAX package
jits each of these functions over its mesh. Every rank then captures and
replays the same graphs in the same order. A host-staged mesh and a CPU
mesh run eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from erl_gaussian_process_tpu_torch.models.batch_gp import (
    BankState,
    bank_fit_core,
)
from erl_gaussian_process_tpu_torch.models.gp_core import resolve_device
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SpGpState,
    spgp_predict,
    spgp_update,
)

BANK_AXIS = "b"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of the ``size`` ranks of the default process group.
    ``device`` is this rank's; ``host_staging`` is set when the backend is
    gloo and the device is a card."""

    rank: int
    size: int
    device: torch.device
    axis_name: str = BANK_AXIS
    host_staging: bool = False


def make_mesh(n_devices: Optional[int] = None, axis_name: str = BANK_AXIS,
              *, device: str = "cuda") -> Mesh:
    """The mesh of every rank of the default process group, which the
    caller has initialised. Each rank's device is
    ``cuda:{rank % device_count}`` (made the current device), or the CPU
    when ``device="cpu"``. ``n_devices``, when given, must equal the
    group's size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: torch.distributed is not initialised; call "
            "init_process_group (address, world size, rank, timeout) first")
    size = dist.get_world_size()
    rank = dist.get_rank()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the process "
                         f"group has {size} ranks")
    kind = torch.device(device).type
    backend = dist.get_backend()
    if kind == "cuda":
        resolve_device("cuda")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        if backend != "gloo":
            raise ValueError(f"make_mesh: a CPU mesh needs the gloo backend, "
                             f"not {backend}")
        dev = torch.device("cpu")
    else:
        raise ValueError(f"make_mesh: device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    return Mesh(rank=rank, size=size, device=dev,
                axis_name=axis_name,
                host_staging=kind == "cuda" and backend == "gloo")


def model_device(mesh: Optional[Mesh], device) -> torch.device:
    """The device of a model built with ``mesh``: ``resolve_device(device)``
    without a mesh, else the mesh's device (a ``device`` naming another
    raises). A ``mesh`` that is not a :class:`Mesh` raises TypeError."""
    dev = resolve_device(device)
    if mesh is None:
        return dev
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    if dev.type != mesh.device.type or (
            dev.index is not None and dev.index != mesh.device.index):
        raise ValueError(f"device {dev} differs from the mesh's device "
                         f"{mesh.device}")
    return mesh.device


def runs_graphs(device: torch.device, mesh: Optional[Mesh]) -> bool:
    """Whether a model on ``device`` (``model_device(mesh, ...)``) replays
    its steps as CUDA graphs: on a card, without a mesh or on one whose
    collectives run on the card (NCCL; not ``host_staging``).

    On a mesh of several ranks a replay holds its collectives, and a rank
    whose peer never replays the same graph waits inside its replay for
    ever: the process group's timeout does not reach captured work. The
    caller bounds the world (a join with a time limit that kills the
    ranks, as ``parallel/spawn.py`` does). A capture that holds a
    collective of more than one rank has not yet been run."""
    return device.type == "cuda" and not (mesh is not None
                                          and mesh.host_staging)


def all_reduce(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the mesh (JAX's ``psum``), on every rank."""
    if mesh.host_staging:
        h = t.cpu()
        dist.all_reduce(h)
        return h.to(mesh.device)
    dist.all_reduce(t)
    return t


# all_gather_into_tensor is all_gather_single from torch 2.13 on
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along axis
    0 in rank order, on every rank: one collective into one output of
    static shape (what a capture holds)."""
    src = (t.cpu() if mesh.host_staging else t).contiguous()
    out = src.new_empty((mesh.size * src.shape[0], *src.shape[1:]))
    _gather_into(out, src)
    return out.to(mesh.device)


def _pad_axis(arrs, axis: int, mult: int):
    """Zero/False-pad every tensor's ``axis`` up to a multiple of ``mult``.
    Returns (tensors, the original length)."""
    n = arrs[0].shape[axis]
    npad = -(-n // mult) * mult
    if npad == n:
        return list(arrs), n
    out = []
    for a in arrs:
        shape = list(a.shape)
        shape[axis] = npad - n
        out.append(torch.cat([a, a.new_zeros(shape)], dim=axis))
    return out, n


def _shard(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of axis 0 (its length a multiple of the size); a
    block of a contiguous tensor is contiguous."""
    n = t.shape[0] // mesh.size
    return t.narrow(0, mesh.rank * n, n)


def sharded_bank_fit(mesh: Mesh, x, y, var, mask, scale, *,
                     kernel: str) -> BankState:
    """``bank_fit_core`` with the bank axis sharded over the mesh: the bank
    is padded with empty members up to a multiple of the mesh size, each
    rank fits its block (the bank-fit kernel on CUDA), and L, L^{-1} and
    alpha are gathered and trimmed back to B. A member's factors do not
    depend on the bank it is fit in, so the result equals the one-card
    fit. x (B, n, d); y (B, n, q); var/mask (B, n)."""
    padded, b0 = _pad_axis([x, y, var, mask], 0, mesh.size)
    local = bank_fit_core(*(_shard(mesh, t) for t in padded), scale,
                          kernel=kernel)
    L, L_inv, alpha = (all_gather(mesh, t)[:b0]
                       for t in (local.L, local.L_inv, local.alpha))
    return BankState(x=x, mask=mask, L=L, alpha=alpha,
                     trained=torch.any(mask, dim=1), L_inv=L_inv)


def sharded_spgp_update(mesh: Mesh, state: SpGpState, x, y, var, mask,
                        scale, *, kernel: str, diagonal_qm: bool = False,
                        zero_threshold: float = 0.0, block: int = 0,
                        out: Optional[SpGpState] = None) -> SpGpState:
    """FITC rank-N update with the N sample axis sharded over the mesh.

    Each rank runs ``spgp_update``'s increment on its block of samples
    (the FITC kernel on CUDA for dense Q_M without a threshold; the
    ``fitc_delta`` chain for ``diagonal_qm`` or ``zero_threshold`` > 0,
    with the same semantics as one card), the increments are summed by one
    ``all_reduce`` pair, and the Kahan add runs replicated. Padding samples
    are masked: their weight is exactly 0. The pseudo-point state is
    replicated. x (n, d); y (n, q); var/mask (n,). ``block``: the samples of
    one pose of a fused update (``spgp_update``); each rank's plain version
    sums its shard in blocks of that many samples. ``out``: as
    ``spgp_update``'s (the static state of a captured chunk)."""
    (x, y, var, mask), _ = _pad_axis([x, y, var, mask], 0, mesh.size)
    return spgp_update(state, _shard(mesh, x), _shard(mesh, y),
                       _shard(mesh, var), _shard(mesh, mask), scale,
                       kernel=kernel, diagonal_qm=diagonal_qm,
                       zero_threshold=zero_threshold,
                       reduce=lambda t: all_reduce(mesh, t), out=out,
                       block=block)


def sharded_update_step(mesh: Mesh, state: SpGpState, seed: int, step: int,
                        sensor_position, points, *args, generator=None,
                        u=None, **step_kw):
    """JAX's ``sharded_update_step``: the map's ``update_step`` (sampler ->
    label -> FITC) with the FITC update sharded over the mesh. Every rank
    seeds ``generator`` (one on the points' device when None) with
    ``step_seed(seed, step)``, so it draws the same bits as the one-card
    map's pose ``step``; ``u`` (the sampler's fractions) replaces the
    draw. ``args`` (point_mask, aabb_min, aabb_max, scale) and ``step_kw``
    are ``update_step``'s. Returns (state, n_used as a 0-dim tensor)."""
    # the map's module imports this one, so its functions are imported here
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        step_seed,
        update_step,
    )

    if u is None:
        if generator is None:
            generator = torch.Generator(device=points.device)
        generator.manual_seed(step_seed(seed, step))
    state, n_used, _ = update_step(state, sensor_position, points, *args,
                                   generator=generator, u=u, mesh=mesh,
                                   **step_kw)
    return state, n_used


def sharded_update_many(mesh: Mesh, state: SpGpState, seed: int, step0: int,
                        sensor_positions, *args, **kw):
    """JAX's ``sharded_update_many``: c = len(sensor_positions) poses fused
    into ONE sharded rank-N FITC update, the map's ``update_batch_steps``
    with ``poses_per_step`` = c on the mesh. Returns (state, n_used (c,))."""
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        update_batch_steps,
    )

    return update_batch_steps(state, seed, step0, sensor_positions, *args,
                              poses_per_step=sensor_positions.shape[0],
                              mesh=mesh, **kw)


def sharded_spgp_predict(mesh: Mesh, state: SpGpState, L_qm, alpha_solved,
                         xq, scale, *, kernel: str, with_var: bool = True,
                         zero_threshold: float = 0.0):
    """Query-sharded SPGP predict: the queries are padded to a multiple of
    the mesh size, each rank answers its block (``spgp_predict``: the gram
    kernel on CUDA, the reference's sparse ``zero_threshold`` semantics),
    and the answers are gathered. No collective beyond the gather.
    Returns (mean (m_q, q), var (m_q,) | None)."""
    (xq,), m0 = _pad_axis([xq], 0, mesh.size)
    mean, _, var = spgp_predict(state, L_qm, alpha_solved, _shard(mesh, xq),
                                scale, kernel=kernel, with_var=with_var,
                                zero_threshold=zero_threshold)
    mean = all_gather(mesh, mean)[:m0]
    return mean, all_gather(mesh, var)[:m0] if with_var else None
