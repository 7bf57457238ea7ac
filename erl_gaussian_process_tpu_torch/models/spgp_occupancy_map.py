"""Online occupancy mapping on one global incremental SPGP (counterpart of
``erl_gaussian_process_tpu/models/spgp_occupancy_map.py``).

One pose's update samples a fixed-shape dataset along the rays, labels it
with log-odds, caps it at ``max_num_samples``, compacts the actives into a
256-aligned prefix and runs the rank-N FITC update (the FITC kernel on
CUDA). ``sample_pose``/``update_step`` are the functional core; the class
wraps them with the reference's API.

On a CUDA device (without ``mesh=``, or on a mesh whose collectives run
on the card: NCCL, ``parallel.mesh.runs_graphs``) the class runs the JAX package's
design, one dispatch a pose: each chunk of ``poses_per_step`` poses and
each prepared predict is one replay of a CUDA graph captured over static
state buffers (``models/pose_graph.py``), and ``sp_gp.state`` is those
buffers, updated in place. The functional steps below stay eager: they are
the reference the graphs are held to. The tiered prepare stays eager too
(its tiers are host decisions), and so do the CPU map and a mesh that
stages its collectives through the host (gloo).

Randomness: the JAX package draws each pose's free-sample positions from
``fold_in(key, step)``. PyTorch cannot reproduce those bits, so here each
pose draws from a ``torch.Generator`` on the map's device, seeded from
(seed, step) alone (:func:`step_seed`): a pose's draw depends on nothing
but the map seed and the pose index, so ``update_batch`` equals a sequence
of ``update`` calls, and a checkpoint carries the seed in place of the key.

With ``mesh=`` (``parallel/mesh.py``) every rank of the mesh runs the same
calls: updates shard the FITC update's sample axis over the ranks (the
sampler runs replicated from the same seeds, so every rank and the one-card
map consume the same datasets), and predictions without a gradient shard
the query axis. On an NCCL mesh each rank replays one graph a chunk
and one a predict, the collectives inside them (JAX's
``sharded_update_many`` and ``sharded_spgp_predict``, each one jit).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.geometry.aabb import Aabb
from erl_gaussian_process_tpu_torch.geometry.occupancy_dataset import (
    compact_slots,
    generate_dataset_fixed,
    generate_dataset_np,
)
from erl_gaussian_process_tpu_torch.models.gp_core import DEFAULT_DEVICE
from erl_gaussian_process_tpu_torch.models.pose_graph import PoseGraphs
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SparsePseudoInputGaussianProcess,
    SpGpSetting,
    SpGpState,
    numpy_dtype,
    spgp_predict,
    spgp_prepare,
    spgp_update,
)
from erl_gaussian_process_tpu_torch.parallel.mesh import (
    model_device,
    runs_graphs,
    sharded_spgp_predict,
    sharded_spgp_update,
)
from erl_gaussian_process_tpu_torch.utils.serialization import (
    eq_state,
    load_pytree,
    save_pytree,
)
from erl_gaussian_process_tpu_torch.utils.timing import span


@dataclasses.dataclass
class SpGpOccupancyMapSetting:
    """Mirror of SpGpOccupancyMap::Setting; loads the reference's YAML
    (``config/spgp_occupancy_map_2d.yaml``) unchanged."""

    sp_gp: SpGpSetting = dataclasses.field(default_factory=SpGpSetting)
    min_distance: float = 0.5
    max_distance: float = 30.0
    free_points_per_meter: float = 2.0
    free_sampling_margin: float = 0.05
    parallel: bool = True
    logodd_free: float = -5.0
    logodd_occupied: float = 5.0
    logodd_variance: float = 1e-4

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        if "sp_gp" in d:
            d["sp_gp"] = SpGpSetting.from_dict(d["sp_gp"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml_file(cls, path: str):
        from erl_gaussian_process_tpu_torch.utils.config import from_yaml_file
        return from_yaml_file(cls, path)

    def as_yaml_file(self, path: str):
        from erl_gaussian_process_tpu_torch.utils.config import as_yaml_file
        as_yaml_file(self, path)


def step_seed(seed: int, step: int) -> int:
    """The generator seed of pose ``step`` of a map seeded with ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, int(step)])
    return int(ss.generate_state(1, np.uint64)[0])


def sample_pose(sensor_position, points, point_mask, aabb_min, aabb_max, *,
                free_slots, max_samples, min_distance, max_distance,
                free_sampling_margin, free_points_per_meter, logodd_occupied,
                logodd_free, logodd_variance, generator=None, u=None):
    """Sample -> label -> cap -> compact for ONE pose. Returns
    (pts (budget, d), y (budget, 1), var (budget,), mask (budget,)) with
    budget = max_samples rounded up to 256 (or the full slot grid if
    smaller). Excess actives beyond ``max_samples`` are dropped in slot
    order (hits first, then free samples)."""
    pts, lbl, mask = generate_dataset_fixed(
        sensor_position, points, point_mask, aabb_min, aabb_max,
        min_distance, max_distance, free_sampling_margin,
        free_points_per_meter, free_slots_per_ray=free_slots,
        generator=generator, u=u)
    order_rank = torch.cumsum(mask.to(torch.int32), dim=0) - 1
    mask = mask & (order_rank < max_samples)
    budget = min(pts.shape[0], -(-max_samples // 256) * 256)
    if budget < pts.shape[0]:
        pts, lbl, mask = compact_slots(pts, lbl, mask, budget)
    y = torch.full_like(lbl, logodd_free).masked_fill_(lbl > 0,
                                                       logodd_occupied)
    var = torch.full_like(lbl, logodd_variance)
    return pts, y[:, None], var, mask


def _fitc_update(mesh):
    """``spgp_update``, or with a mesh its twin that shards the samples
    over the ranks (``parallel/mesh.sharded_spgp_update``)."""
    return spgp_update if mesh is None else functools.partial(
        sharded_spgp_update, mesh)


def update_step(state: SpGpState, sensor_position, points, point_mask,
                aabb_min, aabb_max, scale, *, kernel, diagonal_qm,
                free_slots, max_samples, min_distance, max_distance,
                free_sampling_margin, free_points_per_meter, logodd_occupied,
                logodd_free, logodd_variance, zero_threshold: float = 0.0,
                generator=None, u=None, mesh=None):
    """One map update: sample dataset -> label -> FITC update. Returns
    (new state, number of samples used as a 0-dim device tensor,
    the dataset (pts, y, mask) the update consumed). With ``mesh`` every
    rank samples the same dataset and the FITC update is sharded."""
    pts, y, var, mask = sample_pose(
        sensor_position, points, point_mask, aabb_min, aabb_max,
        free_slots=free_slots, max_samples=max_samples,
        min_distance=min_distance, max_distance=max_distance,
        free_sampling_margin=free_sampling_margin,
        free_points_per_meter=free_points_per_meter,
        logodd_occupied=logodd_occupied, logodd_free=logodd_free,
        logodd_variance=logodd_variance, generator=generator, u=u)
    new_state = _fitc_update(mesh)(state, pts, y, var, mask, scale,
                                   kernel=kernel, diagonal_qm=diagonal_qm,
                                   zero_threshold=zero_threshold)
    return new_state, torch.sum(mask), (pts, y, mask)


def update_batch_steps(state: SpGpState, seed: int, step0: int,
                       sensor_positions, points, point_masks, aabb_min,
                       aabb_max, scale, *, generator: torch.Generator, kernel,
                       diagonal_qm, zero_threshold: float = 0.0,
                       poses_per_step: int = 1,
                       collect_datasets: bool = False, mesh=None,
                       **sample_kw):
    """B map updates in order, pose i drawing from ``generator`` seeded
    with ``step_seed(seed, step0 + i)``. Returns (state, n_used (B,)),
    plus the stacked datasets (pts (B, budget, d), y (B, budget, 1),
    mask (B, budget)) exactly as the FITC updates consumed them when
    ``collect_datasets``.

    Every ``poses_per_step`` c consecutive poses are sampled (each from its
    own seed, so the datasets are those of c == 1) and their datasets
    concatenated into ONE rank-N FITC update of N = c * budget samples; at
    c == 1 this is B ``update_step`` calls. The FITC increment is a sum of
    independent per-column terms, so (Q_M, alpha) equal the sequential
    result up to the sums' rounding order. B must be a multiple of c (the
    class wrapper pads with all-masked poses, exact no-ops);
    ``collect_datasets`` needs c == 1. With ``mesh`` every rank samples
    the same datasets and each FITC update shards its N samples over the
    ranks.

    sensor_positions (B, d); points (B, n, d); point_masks (B, n)."""
    c = int(poses_per_step)
    b = sensor_positions.shape[0]
    if c < 1:
        raise ValueError(f"poses_per_step must be >= 1, got {c}")
    if collect_datasets and c != 1:
        raise ValueError("collect_datasets requires poses_per_step == 1")
    if b % c:
        raise ValueError(f"B={b} not a multiple of poses_per_step={c}")
    used, data = [], []
    update = _fitc_update(mesh)
    for lo in range(0, b, c):
        chunk = []
        for i in range(lo, lo + c):
            generator.manual_seed(step_seed(seed, step0 + i))
            chunk.append(sample_pose(
                sensor_positions[i], points[i], point_masks[i], aabb_min,
                aabb_max, generator=generator, **sample_kw))
        pts, y, var, mask = (chunk[0] if c == 1 else
                             tuple(torch.cat(t) for t in zip(*chunk)))
        state = update(state, pts, y, var, mask, scale, kernel=kernel,
                       diagonal_qm=diagonal_qm, zero_threshold=zero_threshold,
                       block=chunk[0][0].shape[0])
        used.extend(torch.sum(m) for *_, m in chunk)
        if collect_datasets:
            data.append((pts, y, mask))
    n_used = torch.stack(used) if used else torch.zeros(
        0, dtype=torch.int64, device=sensor_positions.device)
    if collect_datasets:
        return state, n_used, tuple(torch.stack(t) for t in zip(*data))
    return state, n_used


def predict_step(state: SpGpState, xq, scale, *, kernel, diagonal_qm,
                 with_grad, zero_threshold: float = 0.0):
    """Prepare fused with predict for one-shot queries: (mean (m, q),
    grad (m, d, q) | None) of a state whose prepare is not cached. Repeated
    queries on an unchanged map go through the class's cached prepare
    (:func:`predict_prepared_step`) instead."""
    L_qm, a = spgp_prepare(state, diagonal_qm=diagonal_qm)
    return predict_prepared_step(state, L_qm, a, xq, scale, kernel=kernel,
                                 with_grad=with_grad,
                                 zero_threshold=zero_threshold)


def predict_prepared_step(state: SpGpState, L_qm, alpha_solved, xq, scale, *,
                          kernel, with_grad, zero_threshold: float = 0.0):
    """Queries against a prepared posterior (``(L_qm, alpha_solved)`` of
    the class's cached prepare): (mean (m, q), grad (m, d, q) | None), the
    serving step ``utils/deploy.export_map_predict_step`` exports."""
    mean, grad, _ = spgp_predict(state, L_qm, alpha_solved, xq, scale,
                                 kernel=kernel, with_grad=with_grad,
                                 with_var=False,
                                 zero_threshold=zero_threshold)
    return mean, grad


class SpGpOccupancyMap:
    Setting = SpGpOccupancyMapSetting

    def __init__(self, setting: Optional[SpGpOccupancyMapSetting],
                 pseudo_points, map_boundary: Aabb, seed: int = 0,
                 dtype=torch.float64, free_slots_per_ray: Optional[int] = None,
                 mesh=None, device=DEFAULT_DEVICE):
        """pseudo_points: (d, M) column-major (reference constructor
        layout). Every tensor of the map lives on ``device``.

        ``mesh``: an optional ``parallel.mesh.Mesh``; the map then lives on
        the mesh's device, every rank makes the same calls, ``update`` and
        ``update_batch`` shard the FITC update's samples over the ranks and
        ``predict`` without a gradient shards the queries
        (``parallel/mesh.py``).

        On a CUDA device, without a mesh or on an NCCL one
        (``parallel.mesh.runs_graphs``), updates and predicts replay CUDA graphs
        (``models/pose_graph.py``): ``state`` is the graphs' static
        buffers, overwritten in place by every update, so a state held from
        before an update is not a snapshot (copy it, or use
        ``state_dict``)."""
        with span("egp.map.init"):
            self.setting = setting or SpGpOccupancyMapSetting()
            self.device = model_device(mesh, device)
            self.mesh = mesh
            self.sp_gp = SparsePseudoInputGaussianProcess(
                self.setting.sp_gp, pseudo_points, dtype=dtype,
                device=self.device)
            self.dtype = self.sp_gp.dtype
            self.seed = int(seed)
            self.step = 0
            s = self.setting
            if free_slots_per_ray is None:
                free_slots_per_ray = max(
                    1, int(np.ceil(s.free_points_per_meter * s.max_distance)))
            self.free_slots = int(free_slots_per_ray)
            self._generator = torch.Generator(device=self.device)
            self._graphs = PoseGraphs(self.device, mesh) \
                if runs_graphs(self.device, mesh) else None
            self._set_boundary(map_boundary)
            self._online_buf: list = []

    def _set_boundary(self, map_boundary: Aabb) -> None:
        self.map_boundary = map_boundary
        self._aabb_min = self._tensor(map_boundary.min())
        self._aabb_max = self._tensor(map_boundary.max())

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a, numpy_dtype(self.dtype)),
                            device=self.device)

    @property
    def state(self) -> SpGpState:
        return self.sp_gp.state

    def _points(self, points) -> np.ndarray:
        p = np.asarray(points, numpy_dtype(self.dtype))
        d = self.map_boundary.dim
        if p.ndim == 2 and p.shape[0] == d and p.shape[1] != d:
            p = p.T
        return p

    def _step_kw(self) -> dict:
        s = self.setting
        return dict(
            kernel=self.sp_gp._kernel, diagonal_qm=s.sp_gp.diagonal_qm,
            free_slots=self.free_slots,
            max_samples=int(s.sp_gp.max_num_samples),
            min_distance=s.min_distance, max_distance=s.max_distance,
            free_sampling_margin=s.free_sampling_margin,
            free_points_per_meter=s.free_points_per_meter,
            logodd_occupied=s.logodd_occupied, logodd_free=s.logodd_free,
            logodd_variance=s.logodd_variance,
            zero_threshold=self.sp_gp._zero_threshold)

    def _bind(self) -> None:
        """Point the state and the box at the graphs' static buffers,
        copying whatever was put in their place (``load_state_dict``)."""
        self.sp_gp.state, self._aabb_min, self._aabb_max = self._graphs.bind(
            self.sp_gp.state, self._aabb_min, self._aabb_max)

    def _update_graphed(self, sp, p, masks, c: int, collect: bool):
        """``update_batch_steps`` as one graph replay a chunk of c poses
        (B a multiple of c). Returns (n_used (B,), the stacked datasets or
        None)."""
        if collect and c != 1:
            raise ValueError("collect_datasets requires poses_per_step == 1")
        self._bind()
        b = sp.shape[0]
        kw = self._step_kw()
        n_used = torch.empty(b, dtype=torch.int64, device=self.device)
        data = None
        for lo in range(0, b, c):
            used, ds = self._graphs.update_chunk(
                sp[lo:lo + c], p[lo:lo + c], masks[lo:lo + c],
                [step_seed(self.seed, self.step + 1 + i)
                 for i in range(lo, lo + c)],
                self.sp_gp._scale, collect_datasets=collect, **kw)
            n_used[lo:lo + c].copy_(used)
            if collect:
                if data is None:
                    data = tuple(t.new_empty((b, *t.shape)) for t in ds)
                for out, t in zip(data, ds):
                    out[lo].copy_(t)
        return n_used, data

    def _commit(self, state: SpGpState, poses: int) -> None:
        self.sp_gp.state = state
        self.step += poses
        self.sp_gp._trained = True
        self.sp_gp.invalidate()

    def update(self, sensor_position, points, point_mask=None):
        """One scan update. points: (n, d) world end points ((d, n)
        accepted too). Returns the number of samples used as a 0-dim
        device tensor; nothing waits for the device."""
        p = self._points(points)
        if point_mask is None:
            point_mask = np.isfinite(p).all(axis=-1)
        return self.update_batch(np.asarray(sensor_position)[None], p[None],
                                 np.asarray(point_mask, bool)[None])[0]

    def update_online(self, sensor_position, points, point_mask=None,
                      chunk: int = 8):
        """Buffered ingestion: scans are held on the host and applied as
        one ``update_batch`` once ``chunk`` of them are waiting. Every read
        (``predict``, ``update``, ``update_batch``, ``save``) flushes the
        buffer first, so it sees every scan ingested before it, in order.
        Ragged scans are refused here, when they arrive."""
        p = self._points(points)
        if point_mask is None:
            point_mask = np.isfinite(p).all(axis=-1)
        if self._online_buf and p.shape != self._online_buf[0][1].shape:
            raise ValueError(
                f"update_online: scan of shape {p.shape} after scans of "
                f"shape {self._online_buf[0][1].shape}; buffered scans must "
                "share one shape")
        self._online_buf.append(
            (np.asarray(sensor_position, numpy_dtype(self.dtype)), p,
             np.asarray(point_mask, bool)))
        if len(self._online_buf) >= int(chunk):
            self.flush_online()

    def flush_online(self):
        """Apply any buffered ``update_online`` scans now."""
        if not self._online_buf:
            return
        buf, self._online_buf = self._online_buf, []
        self.update_batch(np.stack([b[0] for b in buf]),
                          np.stack([b[1] for b in buf]),
                          np.stack([b[2] for b in buf]))

    def update_batch(self, sensor_positions, points, point_masks=None,
                     poses_per_step: int = 1, collect_datasets: bool = False):
        """B scans in order (``update_batch_steps``), with results identical
        to B ``update`` calls. The batch moves to the device in one copy per
        array. ``poses_per_step`` c > 1 fuses every c poses into one FITC
        update (equal to the sequential result up to rounding order); the
        pose axis is padded with all-masked poses, exact no-ops, up to a
        multiple of c. ``collect_datasets`` (c == 1) also returns the
        per-pose datasets the FITC updates consumed — the drift check's
        replay input.

        With a mesh, every rank samples the same datasets as the one-card
        map and each FITC update is sharded; ``collect_datasets`` is
        refused there (as in the JAX package): collect them from a one-card
        replay.

        sensor_positions (B, d); points (B, n, d); point_masks (B, n)."""
        if self.mesh is not None and collect_datasets:
            raise ValueError(
                "collect_datasets with mesh=: replay on one card (the "
                "datasets are the same, each pose drawn from its own seed)")
        self.flush_online()
        with span("egp.map.update"):
            with span("egp.map.inputs"):
                sp = np.asarray(sensor_positions, numpy_dtype(self.dtype))
                p = np.asarray(points, numpy_dtype(self.dtype))
                if point_masks is None:
                    point_masks = np.isfinite(p).all(axis=-1)
                point_masks = np.asarray(point_masks, bool)
                b = sp.shape[0]
                pad = -b % int(poses_per_step)
                if pad:
                    sp = np.concatenate(
                        [sp, np.zeros((pad,) + sp.shape[1:], sp.dtype)])
                    p = np.concatenate(
                        [p, np.zeros((pad,) + p.shape[1:], p.dtype)])
                    point_masks = np.concatenate(
                        [point_masks,
                         np.zeros((pad,) + point_masks.shape[1:], bool)])
                p = np.where(point_masks[..., None], p, p.dtype.type(0))
            if self._graphs is not None:
                n_used, data = self._update_graphed(
                    sp, p, point_masks, int(poses_per_step), collect_datasets)
                out = (self.sp_gp.state, n_used, data)
            else:
                out = update_batch_steps(
                    self.sp_gp.state, self.seed, self.step + 1,
                    self._tensor(sp), self._tensor(p),
                    torch.as_tensor(point_masks, device=self.device),
                    self._aabb_min, self._aabb_max, self.sp_gp._scale,
                    generator=self._generator, poses_per_step=poses_per_step,
                    collect_datasets=collect_datasets, mesh=self.mesh,
                    **self._step_kw())
            self._commit(out[0], b)
        return (out[1], out[2]) if collect_datasets else out[1][:b]

    def predict(self, points, compute_gradient: bool = False,
                parallel: bool = True):
        """logodd (n,) and its gradient (n, d) | None, as device tensors
        (reference Predict). With a mesh, a predict without a gradient
        shards the queries over the ranks. ``parallel`` is the reference's
        OpenMP switch, accepted and ignored."""
        del parallel
        self.flush_online()
        if self._graphs is not None:
            self._bind()
            mean, grad = self._graphs.predict(
                self.sp_gp._prepared(), self._points(points),
                self.sp_gp._scale, kernel=self.sp_gp._kernel,
                with_grad=compute_gradient,
                zero_threshold=self.sp_gp._zero_threshold)
            return mean[:, 0], None if grad is None else grad[:, :, 0]
        L_qm, a = self.sp_gp._prepared()
        xq = self._tensor(self._points(points))
        if self.mesh is not None and not compute_gradient:
            mean, _ = sharded_spgp_predict(
                self.mesh, self.sp_gp.state, L_qm, a, xq, self.sp_gp._scale,
                kernel=self.sp_gp._kernel, with_var=False,
                zero_threshold=self.sp_gp._zero_threshold)
            return mean[:, 0], None
        mean, grad, _ = spgp_predict(
            self.sp_gp.state, L_qm, a, xq,
            self.sp_gp._scale, kernel=self.sp_gp._kernel,
            with_grad=compute_gradient, with_var=False,
            zero_threshold=self.sp_gp._zero_threshold)
        return mean[:, 0], None if grad is None else grad[:, :, 0]

    def predict_gradient(self, points, parallel: bool = True):
        del parallel
        return self.predict(points, compute_gradient=True)[1]

    def generate_dataset(self, sensor_position, points, seed=None):
        """Host numpy dataset sampler with the reference's
        ``OccupancyMap::GenerateDataset`` call shape: returns
        (dataset_points (m, d), labels (m,) in {0, 1}, hit_indices)."""
        s = self.setting
        return generate_dataset_np(
            np.random.default_rng(seed),
            np.asarray(sensor_position, numpy_dtype(self.dtype)),
            self._points(points), self.map_boundary.min(),
            self.map_boundary.max(), s.min_distance, s.max_distance,
            s.free_sampling_margin, s.free_points_per_meter,
            int(s.sp_gp.max_num_samples))

    # -- checkpoint ---------------------------------------------------------
    def state_dict(self):
        self.flush_online()
        return {
            "setting": self.setting.to_dict(),
            "sp_gp": self.sp_gp.state_dict(),
            "map_boundary": {"center": self.map_boundary.center,
                             "half_sizes": self.map_boundary.half_sizes},
            "seed": self.seed,
            "step": self.step,
        }

    def load_state_dict(self, d):
        self.setting = SpGpOccupancyMapSetting.from_dict(d["setting"])
        self.sp_gp.load_state_dict(d["sp_gp"])
        self.dtype = self.sp_gp.dtype
        self._set_boundary(Aabb(
            center=np.asarray(d["map_boundary"]["center"]),
            half_sizes=np.asarray(d["map_boundary"]["half_sizes"])))
        self.seed = int(d["seed"])
        self.step = int(d.get("step", 0))
        self._online_buf = []
        if self._graphs is not None:
            self._bind()

    def save(self, path):
        save_pytree(path, self.state_dict())

    def load(self, path):
        self.load_state_dict(load_pytree(path))

    def __eq__(self, other):
        if not isinstance(other, SpGpOccupancyMap):
            return NotImplemented
        return eq_state(self.state_dict(), other.state_dict())
