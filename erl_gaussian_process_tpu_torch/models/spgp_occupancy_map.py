"""Online occupancy mapping on one global incremental SPGP (counterpart of
``erl_gaussian_process_tpu/models/spgp_occupancy_map.py``).

One pose's update samples a fixed-shape dataset along the rays, labels it
with log-odds, caps it at ``max_num_samples``, compacts the actives into a
256-aligned prefix and runs the rank-N FITC update (the FITC kernel on
CUDA). ``sample_pose``/``update_step`` are the functional core; the class
wraps them with the reference's API.

Randomness: the JAX package draws each pose's free-sample positions from
``fold_in(key, step)``. PyTorch cannot reproduce those bits, so here each
pose draws from a ``torch.Generator`` on the map's device, seeded from
(seed, step) alone (:func:`step_seed`): a pose's draw depends on nothing
but the map seed and the pose index, so ``update_batch`` equals a sequence
of ``update`` calls, and a checkpoint carries the seed in place of the key.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.geometry.aabb import Aabb
from erl_gaussian_process_tpu_torch.geometry.occupancy_dataset import (
    compact_slots,
    generate_dataset_fixed,
    generate_dataset_np,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    GRADIENT_TODO,
    SparsePseudoInputGaussianProcess,
    SpGpSetting,
    SpGpState,
    numpy_dtype,
    spgp_predict,
    spgp_update,
)
from erl_gaussian_process_tpu_torch.utils.serialization import (
    eq_state,
    load_pytree,
    save_pytree,
)

MESH_TODO = ("mesh= (the sharded map over several cards) is not ported yet "
             "(ROADMAP.md, Queue 1: 'Multi-card map, mesh=')")
POSES_PER_STEP_TODO = ("poses_per_step > 1 (several poses fused into one "
                       "FITC call) is not ported yet (ROADMAP.md, Queue 1: "
                       "'poses_per_step > 1')")


@dataclasses.dataclass
class SpGpOccupancyMapSetting:
    """Mirror of SpGpOccupancyMap::Setting. Built in code; this package
    reads no YAML."""

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


def update_step(state: SpGpState, sensor_position, points, point_mask,
                aabb_min, aabb_max, scale, *, kernel, diagonal_qm,
                free_slots, max_samples, min_distance, max_distance,
                free_sampling_margin, free_points_per_meter, logodd_occupied,
                logodd_free, logodd_variance, zero_threshold: float = 0.0,
                generator=None, u=None):
    """One map update: sample dataset -> label -> FITC update. Returns
    (new state, number of samples used as a 0-dim device tensor,
    the dataset (pts, y, mask) the update consumed)."""
    pts, y, var, mask = sample_pose(
        sensor_position, points, point_mask, aabb_min, aabb_max,
        free_slots=free_slots, max_samples=max_samples,
        min_distance=min_distance, max_distance=max_distance,
        free_sampling_margin=free_sampling_margin,
        free_points_per_meter=free_points_per_meter,
        logodd_occupied=logodd_occupied, logodd_free=logodd_free,
        logodd_variance=logodd_variance, generator=generator, u=u)
    new_state = spgp_update(state, pts, y, var, mask, scale, kernel=kernel,
                            diagonal_qm=diagonal_qm,
                            zero_threshold=zero_threshold)
    return new_state, torch.sum(mask), (pts, y, mask)


def update_batch_steps(state: SpGpState, seed: int, step0: int,
                       sensor_positions, points, point_masks, aabb_min,
                       aabb_max, scale, *, generator: torch.Generator,
                       poses_per_step: int = 1,
                       collect_datasets: bool = False, **step_kw):
    """B map updates in order, pose i drawing from ``generator`` seeded
    with ``step_seed(seed, step0 + i)``: identical to B ``update_step``
    calls. Returns (state, n_used (B,)), plus the stacked datasets
    (pts (B, budget, d), y (B, budget, 1), mask (B, budget)) exactly as the
    FITC updates consumed them when ``collect_datasets``.

    sensor_positions (B, d); points (B, n, d); point_masks (B, n)."""
    if int(poses_per_step) != 1:
        raise NotImplementedError(POSES_PER_STEP_TODO)
    used, data = [], []
    for i in range(sensor_positions.shape[0]):
        generator.manual_seed(step_seed(seed, step0 + i))
        state, n_used, d = update_step(
            state, sensor_positions[i], points[i], point_masks[i], aabb_min,
            aabb_max, scale, generator=generator, **step_kw)
        used.append(n_used)
        if collect_datasets:
            data.append(d)
    n_used = torch.stack(used) if used else torch.zeros(
        0, dtype=torch.int64, device=sensor_positions.device)
    if collect_datasets:
        return state, n_used, tuple(torch.stack(t) for t in zip(*data))
    return state, n_used


class SpGpOccupancyMap:
    Setting = SpGpOccupancyMapSetting

    def __init__(self, setting: Optional[SpGpOccupancyMapSetting],
                 pseudo_points, map_boundary: Aabb, seed: int = 0,
                 dtype=torch.float64, free_slots_per_ray: Optional[int] = None,
                 mesh=None, device="cpu"):
        """pseudo_points: (d, M) column-major (reference constructor
        layout). Every tensor of the map lives on ``device``."""
        if mesh is not None:
            raise NotImplementedError(MESH_TODO)
        self.setting = setting or SpGpOccupancyMapSetting()
        self.device = torch.device(device)
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
        array. ``collect_datasets`` also returns the per-pose datasets the
        FITC updates consumed — the drift check's replay input.

        sensor_positions (B, d); points (B, n, d); point_masks (B, n)."""
        self.flush_online()
        sp = np.asarray(sensor_positions, numpy_dtype(self.dtype))
        p = np.asarray(points, numpy_dtype(self.dtype))
        if point_masks is None:
            point_masks = np.isfinite(p).all(axis=-1)
        point_masks = np.asarray(point_masks, bool)
        out = update_batch_steps(
            self.sp_gp.state, self.seed, self.step + 1, self._tensor(sp),
            self._tensor(np.where(point_masks[..., None], p, 0.0)),
            torch.as_tensor(point_masks, device=self.device), self._aabb_min,
            self._aabb_max, self.sp_gp._scale, generator=self._generator,
            poses_per_step=poses_per_step, collect_datasets=collect_datasets,
            **self._step_kw())
        self._commit(out[0], sp.shape[0])
        return out[1:] if collect_datasets else out[1]

    def predict(self, points, compute_gradient: bool = False):
        """logodd (n,) as a device tensor, and None in place of the
        gradient (reference Predict)."""
        if compute_gradient:
            raise NotImplementedError(GRADIENT_TODO)
        self.flush_online()
        L_qm, a = self.sp_gp._prepared()
        mean, _, _ = spgp_predict(
            self.sp_gp.state, L_qm, a, self._tensor(self._points(points)),
            self.sp_gp._scale, kernel=self.sp_gp._kernel, with_var=False,
            zero_threshold=self.sp_gp._zero_threshold)
        return mean[:, 0], None

    def predict_gradient(self, points):
        raise NotImplementedError(GRADIENT_TODO)

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

    def save(self, path):
        save_pytree(path, self.state_dict())

    def load(self, path):
        self.load_state_dict(load_pytree(path))

    def __eq__(self, other):
        if not isinstance(other, SpGpOccupancyMap):
            return NotImplemented
        return eq_state(self.state_dict(), other.state_dict())
