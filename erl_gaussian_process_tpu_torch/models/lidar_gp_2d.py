"""One 2D lidar scan -> a bank of small 1-D local GPs over overlapping angle
partitions (counterpart of ``erl_gaussian_process_tpu/models/lidar_gp_2d.py``;
reference: LidarGaussianProcess2D, src/lidar_gp_2d.cpp).

A scan train is the hit and continuity masks, the distance mapping and the
partition gather on the model's device (:func:`_gather_scan`), then ONE
launch of the bank fit kernel (``ops/bank.py``); a test routes each query
angle to its partition and answers every partition in one batched
predict. The frame and the partition tables are host numpy, as in the JAX
package, and so is the routing of the CPU model
(``models/batch_gp.bank_predict_assigned``); on a model with graphs only
the sensor-frame angles are, and the rest of the routing runs on the
device (:meth:`~LidarGaussianProcess2D._route_tensor`,
``models/batch_gp.bank_predict_chunked``).

A reduced-rank ``gp.kernel_type`` threads through the whole class: the
bank fit solves each partition's information system over one shared
Hilbert basis (``models/batch_gp.bank_fit_rr_core``) and the routed
predict takes ``+||.||^2`` for the variance.

On a CUDA device each scan train (:meth:`~LidarGaussianProcess2D.train`)
and each routed test or ``compute_occ``, from the sensor-frame angles on,
is one replay of a CUDA graph (``models/sensor_graph.py``), as each is one
jit in the JAX package; the offline replay
(:meth:`~LidarGaussianProcess2D.train_scan_batch`) runs eagerly.

With ``mesh=``, a train shards the bank's members over the ranks
(``parallel/mesh.sharded_bank_fit``): on a mesh whose collectives run on
the card (NCCL, ``parallel.mesh.runs_graphs``) each rank replays it as one graph,
the rank's bank fit and the gathers inside, and the routed test, which
reads the replicated bank, takes the one-card graphs; on a mesh that
stages its collectives through the host (gloo) both run eagerly. A
reduced-rank fit stays on each rank whole, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.geometry.lidar_frame_2d import (
    LidarFrame2D,
    LidarFrame2DSetting,
)
from erl_gaussian_process_tpu_torch.kernels import resolve_kernel_setting
from erl_gaussian_process_tpu_torch.models.batch_gp import (
    BankState,
    bank_fit_core,
    bank_fit_rr_finish,
    bank_fit_rr_parts,
    bank_predict_assigned,
    bank_predict_chunked,
    bank_state_from_numpy,
)
from erl_gaussian_process_tpu_torch.models.gp_core import DEFAULT_DEVICE
from erl_gaussian_process_tpu_torch.models.mapping import (
    Mapping,
    MappingSetting,
    MappingType,
)
from erl_gaussian_process_tpu_torch.models.sensor_graph import SensorGraphs
from erl_gaussian_process_tpu_torch.models.vanilla_gp import (
    VanillaGaussianProcess,
    VanillaGPSetting,
    VanillaGPState,
    VanillaTrainSet,
    setup_reduced_rank,
)
from erl_gaussian_process_tpu_torch.parallel.mesh import (
    model_device,
    runs_graphs,
    sharded_bank_fit,
)
from erl_gaussian_process_tpu_torch.utils.serialization import (
    eq_state,
    load_pytree,
    save_pytree,
)

_LOG = logging.getLogger("erl_gaussian_process_tpu_torch")


def partition_on_angles(n: int, group_size: int, overlap_size: int,
                        margin: int, symmetric: bool, coords: np.ndarray):
    """Angle-partition index/coord tables (the reference's
    PartitionOnAngles). Returns a list of (index_left, index_right,
    coord_left, coord_right)."""
    gs = group_size
    step = group_size - overlap_size
    num_groups = max(1, n // step) + 1
    gs2 = (n - (num_groups - 2) * step) // 2
    half = overlap_size // 2
    parts = []
    if symmetric:
        parts.append((0, gs2 + half, coords[margin], coords[gs2]))
        for i in range(num_groups - 2):
            il = i * step + gs2 - half
            ir = il + gs
            parts.append((il, ir, coords[il + half], coords[ir - half]))
        parts.append((n - gs2 - half, n, coords[n - 1 - gs2],
                      coords[n - 1 - margin]))
        return parts
    for i in range(num_groups - 2):
        il = i * step
        ir = il + gs
        parts.append((il, ir, coords[il], coords[ir - half]))
    il = (num_groups - 2) * step
    ir = il + (n - il + overlap_size) // 2
    parts.append((il, ir, coords[il], coords[ir - half]))
    il = il + (n - il - overlap_size) // 2
    ir = n
    parts.append((il, ir, coords[il], coords[ir - 1]))
    return parts


def partition_on_hit_rays(hit_ray_indices: np.ndarray, n_hit: int,
                          group_size: int, overlap_size: int,
                          coords: np.ndarray):
    """Partitions over the hit rays only (the reference's
    PartitionOnHitRays)."""
    step = group_size - overlap_size
    num_groups = max(1, n_hit // step) + 1
    h = hit_ray_indices
    parts = []
    for i in range(num_groups - 2):
        il, ir = i * step, i * step + group_size
        il, ir = int(h[il]), int(h[ir])
        parts.append((il, ir, coords[il], coords[ir]))
    il = (num_groups - 2) * step
    ir = il + (n_hit - il + overlap_size) // 2
    il2, ir2 = int(h[il]), int(h[ir])
    parts.append((il2, ir2, coords[il2], coords[ir2]))
    il = il + (n_hit - il - overlap_size) // 2
    il3 = int(h[il])
    ir3 = int(h[n_hit - 1]) + 1
    # the reference reads angles[index_right] with index_right possibly ==
    # num_rays when the last ray is a hit (an unchecked index); the right
    # coord is clamped to the last angle, the exclusive index bound kept
    cr3 = coords[min(ir3, coords.shape[0] - 1)]
    parts.append((il3, ir3, coords[il3], cr3))
    return parts


def _gather_scan(ranges, angles, idx, inb, vmin, vmax, thr, srv, dv, *,
                 discon_on: bool, mapping: Mapping):
    """The device gather of a scan train, for S scans at once.

    ranges (S, n); angles (n,); idx (B, width) each partition's ray indices
    [il, ir), inb (B, width) its valid slots; vmin, vmax, thr, srv and dv
    0-dim tensors of the ranges' dtype (a graph's static input). A stable
    sort on ~hit compacts
    each member's hit rays to the front in ray order, the host's
    ``np.arange(il, ir)[hit[il:ir]]``. A ray is discontinuous when the
    range jump to either neighbour exceeds ``thr`` (the frame's continuity
    mask); with ``discon_on`` it takes the variance ``dv``, else ``srv``.
    Returns xs (S, B, width, 1), ys (S, B, width, 1), vs and ms (S, B,
    width)."""
    S, n = ranges.shape
    finite = torch.isfinite(ranges)
    hit = finite & (ranges >= vmin) & (ranges <= vmax)
    cont = torch.ones_like(hit)
    if n > 1:
        zero = torch.zeros_like(ranges)
        big = torch.abs(torch.diff(torch.where(finite, ranges, zero),
                                   dim=1)) > thr
        cont[:, :-1] &= ~big
        cont[:, 1:] &= ~big
    mapped = mapping.map(ranges)
    h = hit[:, idx] & inb                                    # (S, B, width)
    order = torch.argsort((~h).to(torch.uint8), dim=2, stable=True)
    sel = torch.take_along_dim(idx[None], order, dim=2)
    ms = torch.take_along_dim(h, order, dim=2)
    rows = torch.arange(S, device=ranges.device)[:, None, None]
    zero = torch.zeros((), dtype=ranges.dtype, device=ranges.device)
    xs = torch.where(ms, angles[sel], zero)[..., None]
    ys = torch.where(ms, mapped[rows, sel], zero)[..., None]
    v = torch.where(cont[rows, sel], srv, dv) if discon_on else srv
    vs = torch.where(ms, v, zero)
    return xs, ys, vs, ms


@dataclasses.dataclass
class LidarGP2DSetting:
    """Mirror of LidarGaussianProcess2D::Setting."""

    partition_on_hit_rays: bool = False
    symmetric_partitions: bool = False
    group_size: int = 26
    overlap_size: int = 6
    margin: int = 1
    init_variance: float = 1e6
    sensor_range_var: float = 0.01
    discontinuity_var: float = 10.0
    max_valid_range_var: float = 0.1
    occ_test_temperature: float = 30.0
    sensor_frame: LidarFrame2DSetting = dataclasses.field(
        default_factory=LidarFrame2DSetting)
    gp: VanillaGPSetting = dataclasses.field(
        default_factory=lambda: VanillaGPSetting(kernel_type="ou"))
    mapping: MappingSetting = dataclasses.field(
        default_factory=lambda: MappingSetting(type=MappingType.INVERSE_SQRT))

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["mapping"] = self.mapping.to_dict()
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        if "sensor_frame" in d:
            d["sensor_frame"] = LidarFrame2DSetting.from_dict(d["sensor_frame"])
        if "gp" in d:
            d["gp"] = VanillaGPSetting.from_dict(d["gp"])
        if "mapping" in d:
            d["mapping"] = MappingSetting.from_dict(d["mapping"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class LidarGP2DTestResult:
    """Routed query result: mean and variance per query angle, with a
    validity flag for queries no trained partition answers."""

    def __init__(self, gp: "LidarGaussianProcess2D", angles: np.ndarray,
                 angles_are_local: bool, un_map: bool):
        self._gp = gp
        a = np.asarray(angles, gp.dtype).reshape(-1)
        if not angles_are_local:
            a = gp.sensor_frame.angles_world_to_frame(a)
        mean, var, valid = gp._route(a)
        self._mean = mean[:, 0]
        self._var = var
        self._valid = valid
        self._un_map = un_map

    @property
    def num_test(self):
        return self._mean.shape[0]

    def get_mean(self, parallel: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (mean, valid); mapped back through inv() when un_map."""
        del parallel
        f = self._mean
        if self._un_map:
            f = Mapping(self._gp.setting.mapping).inv_masked(f, self._valid)
        return f, self._valid.copy()

    def get_variance(self, parallel: bool = True):
        del parallel
        var = np.where(self._valid, self._var,
                       self._gp.setting.init_variance)
        return var, self._valid.copy()


class LidarGaussianProcess2D:
    """The bank lives on ``device`` (the mesh's device with a ``mesh``); the
    frame and the partition tables stay on the host, and so does the query
    routing of a model without graphs."""

    Setting = LidarGP2DSetting
    TestResult = LidarGP2DTestResult

    def __init__(self, setting: Optional[LidarGP2DSetting] = None,
                 dtype=np.float64, mesh=None, device=DEFAULT_DEVICE):
        self.device = model_device(mesh, device)
        self.mesh = mesh
        self.setting = setting or LidarGP2DSetting()
        self.dtype = np.dtype(dtype)
        self.sensor_frame = LidarFrame2D(self.setting.sensor_frame,
                                         dtype=dtype)
        self.mapping = Mapping(self.setting.mapping)
        self._setup_kernel()
        self._trained = False
        self.bank: Optional[BankState] = None
        self.mapped_distances = None
        self._scan_fit_cache = None
        self._angles = None     # the frame's angles on the device
        self._graphs = SensorGraphs(self.device) \
            if runs_graphs(self.device, mesh) else None
        angles = self.sensor_frame.angles_in_frame
        n = angles.shape[0]
        self.partitions = []
        if n > self.setting.overlap_size and \
                not self.setting.partition_on_hit_rays:
            self.partitions = partition_on_angles(
                n, self.setting.group_size, self.setting.overlap_size,
                self.setting.margin, self.setting.symmetric_partitions, angles)
        self._part_bounds = self._bounds_array()

    def _setup_kernel(self):
        """Resolve the partition GPs' kernel. A reduced-rank kernel type
        gets a 1-D basis; a boundary left unset (None, or of the wrong
        length) becomes the frame's angular half-span plus 3 length scales,
        an explicit one (even [1.0]) is kept."""
        gp = self.setting.gp
        self._scale = float(gp.kernel.scale)

        def frame_defaults(ks):
            if ks.boundary is None or len(ks.boundary) != 1:
                sf = self.setting.sensor_frame
                halfspan = max(abs(sf.angle_min), abs(sf.angle_max))
                ks.boundary = [float(halfspan + 3.0 * ks.scale)]

        gp.kernel, self._basis = setup_reduced_rank(
            gp.kernel_type, gp.kernel, self.dtype,
            "LidarGaussianProcess2D.gp", defaults=frame_defaults)
        if self._basis is not None:
            self._kernel = gp.kernel.base_kernel
        else:
            self._kernel = resolve_kernel_setting(
                gp.kernel_type, gp.kernel, "LidarGaussianProcess2D.gp")
        self.reduced_rank_kernel = self._basis is not None

    def using_reduced_rank_kernel(self) -> bool:
        return self.reduced_rank_kernel

    def _bounds_array(self):
        if not self.partitions:
            return np.zeros((0, 2), self.dtype)
        return np.asarray([[cl, cr] for (_, _, cl, cr) in self.partitions],
                          self.dtype)

    @property
    def is_trained(self):
        return self._trained

    @property
    def angle_partitions(self):
        return list(self.partitions)

    def _assemble_bank_arrays(self):
        """Per-partition padded training arrays of the stored scan, on the
        host (the reference's gather loop)."""
        angles = self.sensor_frame.angles_in_frame
        hit = self.sensor_frame.hit_mask
        cont = self.sensor_frame.continuity_mask
        discon_on = self.setting.sensor_frame.discontinuity_detection
        B = len(self.partitions)
        width = max(ir - il for (il, ir, _, _) in self.partitions)
        xs = np.zeros((B, width, 1), self.dtype)
        ys = np.zeros((B, width, 1), self.dtype)
        vs = np.zeros((B, width), self.dtype)
        ms = np.zeros((B, width), bool)
        for b, (il, ir, _, _) in enumerate(self.partitions):
            sel = np.arange(il, ir)[hit[il:ir]]
            cnt = sel.shape[0]
            xs[b, :cnt, 0] = angles[sel]
            ys[b, :cnt, 0] = self.mapped_distances[sel]
            if discon_on:
                vs[b, :cnt] = np.where(cont[sel],
                                       self.setting.sensor_range_var,
                                       self.setting.discontinuity_var)
            else:
                vs[b, :cnt] = self.setting.sensor_range_var
            ms[b, :cnt] = True
        return xs, ys, vs, ms

    @property
    def gps(self):
        """Per-partition ``VanillaGaussianProcess`` views of the bank (the
        reference's ``gps``): each view's state is its member's slice of
        the bank, on the bank's device, and its train set the stored
        scan's partition. ``[]`` when untrained. The routed predict of
        :meth:`test` does not use them. On a model with graphs the views
        hold a copy of the bank, which the next train does not overwrite.
        The views have no graphs of their own (``models/exact_graph.py``):
        a view runs its steps eagerly."""
        if not self._trained or self.bank is None:
            return []
        xs, ys, vs, ms = self._assemble_bank_arrays()
        bank = self.bank
        if self._graphs is not None:
            bank = BankState(*(None if t is None else t.clone()
                               for t in bank))
        trained = bank.trained.cpu().numpy()
        out = []
        for b in range(len(self.partitions)):
            g = VanillaGaussianProcess(self.setting.gp, dtype=self.dtype,
                                       device=self.device)
            g._graphs = None
            n_b = int(ms[b].sum())
            g._train_set = VanillaTrainSet(xs[b], ys[b], vs[b], n_b)
            g.state = VanillaGPState(x=bank.x[b], mask=bank.mask[b],
                                     L=bank.L[b], alpha=bank.alpha[b])
            g._trained = bool(trained[b])
            g._n = n_b
            g._x_dim, g._y_dim = 1, 1
            out.append(g)
        return out

    def reset(self):
        """Drop the trained state; the frame and the settings survive."""
        self._trained = False
        self.bank = None
        self.mapped_distances = None
        self._scan_fit_cache = None

    def partition_on_angles(self):
        """(Re)build the angle-partition table from the frame geometry."""
        angles = self.sensor_frame.angles_in_frame
        self.partitions = partition_on_angles(
            angles.shape[0], self.setting.group_size,
            self.setting.overlap_size, self.setting.margin,
            self.setting.symmetric_partitions, angles)
        self._part_bounds = self._bounds_array()
        self._scan_fit_cache = None

    def partition_on_hit_rays(self):
        """(Re)build the hit-ray partition table from the stored scan."""
        self.partitions = partition_on_hit_rays(
            self.sensor_frame.hit_ray_indices,
            self.sensor_frame.num_hit_rays,
            self.setting.group_size, self.setting.overlap_size,
            self.sensor_frame.angles_in_frame)
        self._part_bounds = self._bounds_array()
        self._scan_fit_cache = None

    def _build_scan_fit_cache(self) -> dict:
        """The partition index table of the scan train (``idx``, ``inb``:
        host arrays), rebuilt whenever the partition table changes. Setting
        scalars are read live at every train (:meth:`_scan_scalars`)."""
        c = self._scan_fit_cache
        if c is None:
            B = len(self.partitions)
            width = max(ir - il for (il, ir, _, _) in self.partitions)
            idx = np.zeros((B, width), np.int64)
            inb = np.zeros((B, width), bool)
            for b, (il, ir, _, _) in enumerate(self.partitions):
                idx[b, :ir - il] = np.arange(il, ir)
                inb[b, :ir - il] = True
            c = {"idx": idx, "inb": inb}
            self._scan_fit_cache = c
        return c

    def _table_tensors(self) -> tuple:
        """The partition index table on the device, for the eager chain
        (kept with the table until it is rebuilt)."""
        c = self._build_scan_fit_cache()
        if "idx_t" not in c:
            c["idx_t"] = torch.as_tensor(c["idx"], device=self.device)
            c["inb_t"] = torch.as_tensor(c["inb"], device=self.device)
        return c["idx_t"], c["inb_t"]

    def _scan_scalars(self) -> np.ndarray:
        """The float settings a scan train reads, at every train: (valid
        range min, max, discontinuity threshold, sensor range variance,
        discontinuity variance) in the model's dtype."""
        sf, s = self.setting.sensor_frame, self.setting
        return np.array([sf.valid_range_min, sf.valid_range_max,
                         sf.discontinuity_threshold, s.sensor_range_var,
                         s.discontinuity_var], self.dtype)

    def _gather_scans(self, ranges_batch: np.ndarray):
        """S scans -> the bank fit's inputs (x, y, var, mask) of S*B
        members, scan-major, gathered on the model's device."""
        return self._gather_tensors(
            torch.as_tensor(np.asarray(ranges_batch, self.dtype),
                            device=self.device),
            torch.as_tensor(self._scan_scalars(), device=self.device),
            *self._table_tensors())

    def _gather_tensors(self, ranges, scalars, idx, inb):
        """:meth:`_gather_scans` of S scans (S, n), :meth:`_scan_scalars`
        and the partition table, as tensors on the model's device."""
        if self._angles is None:
            self._angles = torch.as_tensor(
                self.sensor_frame.angles_in_frame, device=self.device)
        sf = self.setting.sensor_frame
        xs, ys, vs, ms = _gather_scan(
            ranges, self._angles, idx, inb, *scalars.unbind(),
            discon_on=sf.discontinuity_detection, mapping=self.mapping)
        S, B, w = ms.shape
        return (xs.reshape(S * B, w, 1), ys.reshape(S * B, w, 1),
                vs.reshape(S * B, w), ms.reshape(S * B, w))

    def _scan_step(self, ranges, scalars, idx, inb):
        """The body of a scan train, the function its CUDA graph captures:
        the gather and ONE bank fit, a BankState of S*B members (a
        reduced-rank model's ``batch_gp.bank_fit_rr_parts``, before its
        jitter ladder). Plain tensor code."""
        x, y, var, mask = self._gather_tensors(ranges, scalars, idx, inb)
        if self._basis is not None:
            return bank_fit_rr_parts(x, y, var, mask,
                                     *self._basis.consts(self.device))
        if self.mesh is not None:
            return sharded_bank_fit(self.mesh, x, y, var, mask, self._scale,
                                    kernel=self._kernel)
        return bank_fit_core(x, y, var, mask, self._scale,
                             kernel=self._kernel)

    def _step_key(self, shape, table_shape) -> tuple:
        """What a scan train's graph bakes: the shapes, and the settings
        that are not :meth:`_scan_scalars`."""
        m = self.mapping.setting
        return ("fit", tuple(shape), tuple(table_shape), self.dtype.str,
                self._kernel, self._scale, str(m.type), float(m.scale),
                bool(self.setting.sensor_frame.discontinuity_detection),
                self._basis is not None)

    def _fit_scans(self, ranges_batch: np.ndarray,
                   graphed: bool = False) -> BankState:
        """S scans -> one BankState of S*B members, scan-major: the device
        gather and ONE bank fit, or the reduced-rank bank fit
        (:meth:`_scan_step`), one CUDA-graph replay when ``graphed`` on a
        model with graphs. A member's L, L_inv and alpha do not depend on
        the bank it is fit in (``ops/bank.py``), so each scan's slice of a
        replay equals its own train bit for bit. A mesh shards the members
        over its ranks."""
        rb = np.asarray(ranges_batch, self.dtype)
        sc = self._scan_scalars()
        if graphed and self._graphs is not None:
            c = self._build_scan_fit_cache()
            return self._graphs.fit(self._step_key(rb.shape, c["idx"].shape),
                                    self._scan_step, (rb, sc),
                                    (c["idx"], c["inb"]))
        out = self._scan_step(torch.as_tensor(rb, device=self.device),
                              torch.as_tensor(sc, device=self.device),
                              *self._table_tensors())
        return bank_fit_rr_finish(out)[0] if self._basis is not None else out

    def train_scan_batch(self, ranges_batch) -> BankState:
        """Offline trajectory replay: S scans' partition banks in ONE bank
        fit. ranges_batch (S, num_rays). Returns a BankState with S*B
        members, scan-major (member s*B + b is scan s's partition b); use
        :meth:`use_scan_bank` to route queries at one scan's slice. Needs
        the static angle-partition table and a plain kernel; does not
        change this instance's trained state. One card only. Runs eagerly
        on every device (``models/sensor_graph.py`` says why): the result
        is new tensors, the caller's own."""
        if self.setting.partition_on_hit_rays or self._basis is not None:
            raise NotImplementedError(
                "train_scan_batch needs the static angle-partition table "
                "with a plain kernel on a single chip")
        if self.mesh is not None:
            raise ValueError("train_scan_batch runs on one card: build the "
                             "model without mesh=")
        rb = np.asarray(ranges_batch, self.dtype)
        if rb.ndim != 2 or rb.shape[1] != self.setting.sensor_frame.num_rays:
            raise ValueError(
                f"ranges_batch must be (S, {self.setting.sensor_frame.num_rays}),"
                f" got {rb.shape}")
        return self._fit_scans(rb)

    def use_scan_bank(self, stacked: BankState, scan_index: int) -> None:
        """Point this instance's routed predict (test, compute_occ) at one
        scan's slice of a :meth:`train_scan_batch` result."""
        B = len(self.partitions)
        sl = slice(scan_index * B, (scan_index + 1) * B)
        self.bank = BankState(
            x=stacked.x[sl], mask=stacked.mask[sl], L=stacked.L[sl],
            alpha=stacked.alpha[sl], trained=stacked.trained[sl],
            L_inv=None if stacked.L_inv is None else stacked.L_inv[sl])
        self._trained = True

    def train(self, rotation, translation, ranges) -> bool:
        """Store the scan, map its distances, and fit its partition bank in
        one launch (reference Train). On a CUDA model with graphs (without
        a mesh, or on an NCCL one), ``self.bank`` is then the outputs
        of the train's graph, which the next train of that shape overwrites
        in place: clone a bank to keep it."""
        self._trained = False
        self.sensor_frame.update_ranges(rotation, translation, ranges)
        if not self.sensor_frame.is_valid():
            return False
        self.mapped_distances = np.asarray(
            self.mapping.map(self.sensor_frame.ranges), self.dtype)
        if self.setting.partition_on_hit_rays:
            if self.sensor_frame.num_hit_rays == 0:
                return False
            # through the method: it also drops the gather's index table,
            # so a later switch back to angle partitions rebuilds it
            self.partition_on_hit_rays()
        if not self.partitions:
            _LOG.warning("LidarGaussianProcess2D.train: no partitions for "
                         "this scan — nothing to train")
            return False
        self.bank = self._fit_scans(self.sensor_frame.ranges[None],
                                    graphed=True)
        self._trained = True
        return True

    # -- frame transforms ----------------------------------------------------
    def global_to_local_so2(self, dir_global):
        """World direction(s) (n, 2) -> sensor frame (R^T d)."""
        return self.sensor_frame.dir_world_to_frame(dir_global)

    def local_to_global_so2(self, dir_local):
        return np.asarray(dir_local, self.dtype) @ self.sensor_frame.rotation.T

    def global_to_local_se2(self, xy_global):
        p = np.asarray(xy_global, self.dtype) - self.sensor_frame.translation
        return p @ self.sensor_frame.rotation

    def local_to_global_se2(self, xy_local):
        return (np.asarray(xy_local, self.dtype)
                @ self.sensor_frame.rotation.T
                + self.sensor_frame.translation)

    def search_partition(self, angles_local: np.ndarray) -> np.ndarray:
        """First partition whose [coord_left, coord_right] contains each
        angle; -1 when none."""
        a = np.asarray(angles_local)[:, None]               # (m, 1)
        lo = self._part_bounds[None, :, 0]
        hi = self._part_bounds[None, :, 1]
        ok = (a >= lo) & (a <= hi) & np.isfinite(a)
        idx = np.argmax(ok, axis=1).astype(np.int32)
        idx[~ok.any(axis=1)] = -1
        return idx

    def _route_tensor(self, angles: torch.Tensor,
                      bounds: torch.Tensor) -> torch.Tensor:
        """:meth:`search_partition` as tensor code on the device with no
        host sync (the routed test's graph runs it): angles (m,), NaN for
        no angle; bounds (P, 2) the partition table's [coord_left,
        coord_right] -> the partition of each (m,) int64, -1 when none (a
        NaN is in no partition). Compared in the angles' dtype, the first
        match kept, as the host's comparisons and ``argmax`` do."""
        a = angles[:, None]
        ok = (a >= bounds[:, 0]) & (a <= bounds[:, 1])
        return torch.where(ok.any(1), torch.argmax(ok.to(torch.uint8), 1),
                           -1)

    def _route(self, angles_local: np.ndarray):
        """(mean (m, 1), var (m,), valid (m,)) of sensor-frame angles, each
        answered by its partition's member: without graphs, routed on the
        host (:meth:`search_partition`) and answered by
        ``bank_predict_assigned``; with graphs, one replay of
        ``SensorGraphs.routed_test``, the partition bounds its input."""
        if self._graphs is None:
            return bank_predict_assigned(
                self.bank, angles_local[:, None],
                self.search_partition(angles_local), self._scale,
                kernel=self._kernel, reduced_rank=self.reduced_rank_kernel,
                basis=self._basis)

        def body(bank, q, bounds):
            return bank_predict_chunked(
                bank, q, self._route_tensor(q[:, 0], bounds), self._scale,
                kernel=self._kernel, reduced_rank=self.reduced_rank_kernel,
                basis=self._basis)

        return self._graphs.routed_test(
            self.bank, angles_local[:, None], body,
            (self._kernel, self._scale, self.reduced_rank_kernel,
             self._basis is not None), tables=(self._part_bounds,))

    def test(self, angles, angles_are_local: bool, un_map: bool
             ) -> Optional[LidarGP2DTestResult]:
        if not self._trained:
            return None
        return LidarGP2DTestResult(self, angles, angles_are_local, un_map)

    def compute_occ(self, pos_local: np.ndarray):
        """Vectorized ComputeOcc: occ = 2 / (1 + exp(dist T (r_hat -
        map(dist)))) - 1, gated on the variance. A single point (2,)
        returns the reference binding's dict {success, dist_pos,
        range_pred, occ} of scalars; a batch (n, 2) returns (valid (n,),
        dist (n,), range_pred (n,), occ (n,))."""
        single = np.asarray(pos_local).ndim == 1
        p = np.atleast_2d(np.asarray(pos_local, self.dtype))
        dist = np.linalg.norm(p, axis=-1)
        mean, var, valid = self._route(np.arctan2(p[:, 1], p[:, 0]))
        mean = mean[:, 0]
        valid = valid & (var <= self.setting.max_valid_range_var)
        a = dist * self.setting.occ_test_temperature
        mapped = self.mapping.map(dist)
        # 2/(1+e^z)-1 == -tanh(z/2): saturates instead of overflowing exp
        occ = -np.tanh(0.5 * a * (mean - mapped))
        range_pred = self.mapping.inv_masked(mean, valid)
        if single:
            return {"success": bool(valid[0]), "dist_pos": float(dist[0]),
                    "range_pred": float(range_pred[0]),
                    "occ": float(occ[0])}
        return valid, dist, range_pred, occ

    def get_memory_usage(self) -> int:
        """Bytes held by the bank's tensors."""
        if self.bank is None:
            return 0
        return sum(t.nbytes for t in self.bank if t is not None)

    # -- checkpoint ----------------------------------------------------------
    def state_dict(self):
        """Checkpoint dict; the bank arrays are host numpy copies (L_inv is
        left out: a loaded bank whitens with a triangular solve)."""
        return {
            "setting": self.setting.to_dict(),
            "trained": self._trained,
            "partitions": np.asarray(
                [[il, ir, cl, cr] for (il, ir, cl, cr) in self.partitions]),
            "sensor_frame": self.sensor_frame.state_dict(),
            "mapped_distances": self.mapped_distances,
            "bank": None if self.bank is None else {
                k: v.detach().cpu().numpy()
                for k, v in self.bank._asdict().items() if k != "L_inv"},
        }

    def load_state_dict(self, d):
        """Load a checkpoint at its own dtype (its sensor frame's) onto this
        model's device; its partition table and frame replace this
        instance's (and the gather's cached index table with them)."""
        self.__init__(LidarGP2DSetting.from_dict(d["setting"]),
                      dtype=np.asarray(d["sensor_frame"]["rotation"]).dtype,
                      device=self.device)
        self._trained = bool(d["trained"])
        self.partitions = [
            (int(il), int(ir), float(cl), float(cr))
            for il, ir, cl, cr in np.asarray(d["partitions"])]
        self._part_bounds = self._bounds_array()
        self.sensor_frame.load_state_dict(d["sensor_frame"])
        md = d["mapped_distances"]
        self.mapped_distances = None if md is None else np.asarray(md)
        b = d["bank"]
        self.bank = None if b is None else bank_state_from_numpy(
            {k: v for k, v in b.items() if k != "L_inv"}, self.device)

    def save(self, path):
        save_pytree(path, self.state_dict())

    def load(self, path):
        self.load_state_dict(load_pytree(path))

    def __eq__(self, other):
        if not isinstance(other, LidarGaussianProcess2D):
            return NotImplemented
        return eq_state(self.state_dict(), other.state_dict())
