"""3D range-sensor GP: a 2D grid of local 2-input GPs over (azimuth-row x
elevation-col) partitions of a 3D sensor frame (counterpart of
``erl_gaussian_process_tpu/models/range_sensor_gp_3d.py``).

The reference's OpenMP grid loop becomes one flattened bank of all
row x col partitions: a scan train is the hit mask, distance mapping and
partition gather on the model's device followed by ONE launch of the bank
fit kernel (``ops/bank.py``); a test routes each query to its partition
and answers all partitions in one batched predict. Frames and partition
search are host numpy, as in the JAX package, on the CPU model
(``models/batch_gp.bank_predict_assigned``); on a model with graphs only
the frame coordinates are, and the rest of the routing runs on the device
(:meth:`~RangeSensorGaussianProcess3D._route_tensor`,
``models/batch_gp.bank_predict_chunked``). A reduced-rank ``gp.kernel_type``
fits each partition's basis information system instead
(``models/batch_gp.bank_fit_rr_core``) and predicts with ``+||.||^2``.
On a CUDA device each scan train
(:meth:`~RangeSensorGaussianProcess3D.train`) and each routed test or
``compute_occ``, from the frame coordinates on, is one replay of a CUDA
graph (``models/sensor_graph.py``),
as each is one jit in the JAX package; the offline replay
(:meth:`~RangeSensorGaussianProcess3D.train_scan_batch`) runs eagerly.
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
from typing import Optional, Tuple

import numpy as np
import torch

from erl_gaussian_process_tpu_torch.geometry.frames_3d import (
    LidarFrame3DSetting,
    create_range_sensor_frame_3d,
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
from erl_gaussian_process_tpu_torch.utils.timing import span


def _grid_partitions(coords: np.ndarray, group_size: int, overlap: int,
                     margin: int):
    """Symmetric 1-axis partitioning used for both row and col axes
    (port of the reference ctor math)."""
    n = coords.shape[0]
    step = group_size - overlap
    half = overlap // 2
    num_groups = max(1, n // step) + 1
    gs2 = (n - (num_groups - 2) * step) // 2
    parts = [(0, gs2 + half, coords[margin], coords[gs2])]
    for i in range(num_groups - 2):
        il = i * step + gs2 - half
        ir = il + group_size
        parts.append((il, ir, coords[il + half], coords[ir - half]))
    parts.append((n - gs2 - half, n, coords[n - 1 - gs2],
                  coords[n - 1 - margin]))
    return parts


def _gather_scan_3d(ranges, fc_flat, idx, inb, vmin, vmax, srv, min_count,
                    *, mapping: Mapping):
    """The device gather of a scan train, for S range images at once.

    ranges (S, H, W); fc_flat (H*W, 2) frame coords; idx (B, width) the
    flat grid indices of each partition's sub-block in row-major order,
    inb (B, width) its valid slots; vmin, vmax and srv 0-dim tensors of
    the ranges' dtype (a graph's static input). A stable sort on ~hit
    compacts each member's hits to the front in that order, exactly
    numpy's boolean-mask flattening; groups with at most ``min_count`` hits
    are masked out whole. Returns xs (S, B, width, 2), ys (S, B, width, 1),
    vs and ms (S, B, width)."""
    r = ranges.reshape(ranges.shape[0], -1)
    hit = torch.isfinite(r) & (r >= vmin) & (r <= vmax)
    mapped = mapping.map(r)
    h = hit[:, idx] & inb                                    # (S, B, width)
    order = torch.argsort((~h).to(torch.uint8), dim=2, stable=True)
    sel = torch.take_along_dim(idx[None], order, dim=2)
    ms = torch.take_along_dim(h, order, dim=2)
    ms = ms & (torch.sum(h, dim=2) > min_count)[..., None]
    xs = torch.where(ms[..., None], fc_flat[sel], 0.0)
    rows = torch.arange(r.shape[0], device=r.device)[:, None, None]
    ys = torch.where(ms, mapped[rows, sel], 0.0)
    vs = srv.expand(ms.shape).contiguous()
    return xs, ys[..., None], vs, ms


@dataclasses.dataclass
class RangeSensorGP3DSetting:
    """Mirror of RangeSensorGaussianProcess3D::Setting."""

    row_group_size: int = 12
    row_overlap_size: int = 4
    row_margin: int = 0
    col_group_size: int = 12
    col_overlap_size: int = 4
    col_margin: int = 0
    min_num_samples_per_group: int = 10
    init_variance: float = 1e6
    sensor_range_var: float = 0.01
    max_valid_range_var: float = 0.1
    occ_test_temperature: float = 30.0
    sensor_frame_type: str = "lidar"
    sensor_frame: dict | object = dataclasses.field(
        default_factory=LidarFrame3DSetting)
    gp: VanillaGPSetting = dataclasses.field(
        default_factory=lambda: VanillaGPSetting(kernel_type="ou"))
    mapping: MappingSetting = dataclasses.field(
        default_factory=lambda: MappingSetting(type=MappingType.INVERSE_SQRT))

    def to_dict(self):
        d = dataclasses.asdict(self)
        if hasattr(self.sensor_frame, "to_dict"):
            d["sensor_frame"] = self.sensor_frame.to_dict()
        d["mapping"] = self.mapping.to_dict()
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        if "gp" in d:
            d["gp"] = VanillaGPSetting.from_dict(d["gp"])
        if "mapping" in d:
            d["mapping"] = MappingSetting.from_dict(d["mapping"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class RangeSensorGP3DTestResult:
    def __init__(self, gp: "RangeSensorGaussianProcess3D",
                 directions: np.ndarray, directions_are_local: bool,
                 un_map: bool):
        with span("egp.rsgp.test"):
            d = np.asarray(directions, gp.dtype)
            if d.ndim == 1:
                d = d[None, :]
            if d.shape[0] == 3 and d.shape[1] != 3:
                d = d.T  # accept the reference's (3, m) layout
            mean, var, valid = gp._routed_predict(d, directions_are_local)
        self._gp = gp
        self._mean = mean[:, 0]
        self._var = var
        self._valid = valid
        self._un_map = un_map

    @property
    def num_test(self):
        return self._mean.shape[0]

    def get_mean(self, parallel: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        del parallel
        f = self._mean
        if self._un_map:
            f = Mapping(self._gp.setting.mapping).inv_masked(f, self._valid)
        return f, self._valid.copy()

    def get_variance(self, parallel: bool = True):
        del parallel
        var = np.where(self._valid, self._var, self._gp.setting.init_variance)
        return var, self._valid.copy()


class RangeSensorGaussianProcess3D:
    """The bank lives on ``device`` (the mesh's device with a ``mesh``);
    frames and partition tables stay on the host, and so does the query
    routing of a model without graphs."""

    Setting = RangeSensorGP3DSetting
    TestResult = RangeSensorGP3DTestResult

    def __init__(self, setting: Optional[RangeSensorGP3DSetting] = None,
                 dtype=np.float64, mesh=None, device=DEFAULT_DEVICE):
        self.device = model_device(mesh, device)
        self.mesh = mesh
        self.setting = setting or RangeSensorGP3DSetting()
        if self.setting.row_overlap_size % 2 or \
                self.setting.col_overlap_size % 2:
            raise ValueError("row_overlap_size and col_overlap_size must be "
                             "even")
        self.dtype = np.dtype(dtype)
        self.sensor_frame = create_range_sensor_frame_3d(
            self.setting.sensor_frame_type, self.setting.sensor_frame,
            dtype=dtype)
        self.mapping = Mapping(self.setting.mapping)
        self._setup_kernel()
        fc = self.sensor_frame.frame_coords()
        self.row_partitions = _grid_partitions(
            fc[:, 0, 0], self.setting.row_group_size,
            self.setting.row_overlap_size, self.setting.row_margin)
        self.col_partitions = _grid_partitions(
            fc[0, :, 1], self.setting.col_group_size,
            self.setting.col_overlap_size, self.setting.col_margin)
        self._row_bounds = np.asarray(
            [[cl, cr] for (_, _, cl, cr) in self.row_partitions], self.dtype)
        self._col_bounds = np.asarray(
            [[cl, cr] for (_, _, cl, cr) in self.col_partitions], self.dtype)
        self._trained = False
        self.bank: Optional[BankState] = None
        self.mapped_distances = None
        self._scan_fit_cache = None
        self._route_bounds = None
        self._graphs = SensorGraphs(self.device) \
            if runs_graphs(self.device, mesh) else None

    def _setup_kernel(self):
        """Resolve the partition GPs' kernel. A reduced-rank kernel type
        gets a 2D basis over the frame coords; only the fields the user
        left unset (num_basis of length 1, boundary None or of the wrong
        length, coord_origin [0.0]) take the frame-derived defaults: the
        box is the (az, el) domain plus 3 length scales a side."""
        gp = self.setting.gp
        self._scale = float(gp.kernel.scale)

        def frame_defaults(ks):
            if len(ks.num_basis) != 2:
                nb = ks.num_basis[0] if ks.num_basis else 16
                ks.num_basis = [nb, nb]
            if ks.boundary is None or len(ks.boundary) != 2:
                fc = self.sensor_frame.frame_coords()
                ks.boundary = [float(np.abs(fc[..., k]).max()
                                     + 3.0 * ks.scale) for k in range(2)]
            if len(ks.coord_origin) != 2 or list(ks.coord_origin) == [0.0]:
                ks.coord_origin = [0.0, 0.0]

        gp.kernel, self._basis = setup_reduced_rank(
            gp.kernel_type, gp.kernel, self.dtype,
            "RangeSensorGaussianProcess3D.gp", defaults=frame_defaults)
        if self._basis is not None:
            self._kernel = gp.kernel.base_kernel
        else:
            self._kernel = resolve_kernel_setting(
                gp.kernel_type, gp.kernel, "RangeSensorGaussianProcess3D.gp")
        self.reduced_rank_kernel = self._basis is not None

    def using_reduced_rank_kernel(self) -> bool:
        return self.reduced_rank_kernel

    @property
    def is_trained(self):
        return self._trained

    @property
    def num_partitions(self):
        return len(self.row_partitions), len(self.col_partitions)

    @property
    def range_sensor_frame(self):
        return self.sensor_frame

    @property
    def gps(self):
        """Row-major R x C grid of per-partition ``VanillaGaussianProcess``
        views of the bank (the reference's ``gps``): each view's state is
        its member's slice of the bank, on the bank's device, and its train
        set the stored scan's partition. ``[]`` when untrained. The routed
        predict of :meth:`test` does not use them. On a model with graphs
        the views hold a copy of the bank, which the next train does not
        overwrite. The views have no graphs of their own
        (``models/exact_graph.py``): a view runs its steps eagerly."""
        if not self._trained or self.bank is None:
            return []
        xs, ys, vs, ms = self._assemble_bank_arrays()
        bank = self.bank
        if self._graphs is not None:
            bank = BankState(*(None if t is None else t.clone()
                               for t in bank))
        trained = bank.trained.cpu().numpy()
        R, C = self.num_partitions
        grid = []
        for i in range(R):
            row = []
            for j in range(C):
                b = i * C + j
                g = VanillaGaussianProcess(self.setting.gp, dtype=self.dtype,
                                           device=self.device)
                g._graphs = None
                n_b = int(ms[b].sum())
                g._train_set = VanillaTrainSet(xs[b], ys[b], vs[b], n_b)
                g.state = VanillaGPState(x=bank.x[b], mask=bank.mask[b],
                                         L=bank.L[b], alpha=bank.alpha[b])
                g._trained = bool(trained[b])
                g._n = n_b
                g._x_dim, g._y_dim = 2, 1
                row.append(g)
            grid.append(row)
        return grid

    def reset(self):
        """Drop the trained state; frame, settings and partition tables
        survive."""
        self._trained = False
        self.bank = None
        self.mapped_distances = None

    # -- frame transforms ----------------------------------------------------
    def global_to_local_so3(self, dir_global):
        """World direction(s) (n, 3) -> sensor frame (R^T d per row)."""
        return self.sensor_frame.dir_world_to_frame(dir_global)

    def local_to_global_so3(self, dir_local):
        return (np.asarray(dir_local, self.dtype)
                @ self.sensor_frame.rotation.T)

    def global_to_local_se3(self, xyz_global):
        p = (np.asarray(xyz_global, self.dtype)
             - self.sensor_frame.translation)
        return p @ self.sensor_frame.rotation

    def local_to_global_se3(self, xyz_local):
        return (np.asarray(xyz_local, self.dtype)
                @ self.sensor_frame.rotation.T
                + self.sensor_frame.translation)

    def compute_frame_coords(self, dirs_local):
        coords, _ = self.sensor_frame.compute_frame_coords(dirs_local)
        return coords

    def store_data(self, rotation, translation, ranges) -> bool:
        """Store a scan (pose, ranges and mapped distances) without
        training (reference StoreData; Train = StoreData + fit)."""
        with span("egp.rsgp.frame"):
            self.sensor_frame.update_ranges(rotation, translation, ranges)
            if not self.sensor_frame.is_valid():
                return False
            self.mapped_distances = np.asarray(
                self.mapping.map(self.sensor_frame.ranges), self.dtype)
        return True

    def _assemble_bank_arrays(self):
        """Per-(row, col)-partition padded training arrays of the stored
        scan, on the host (the reference's gather loop)."""
        fc = self.sensor_frame.frame_coords()
        hit = self.sensor_frame.hit_mask
        R, C = self.num_partitions
        width = (max(ir - il for (il, ir, _, _) in self.row_partitions)
                 * max(ir - il for (il, ir, _, _) in self.col_partitions))
        B = R * C
        xs = np.zeros((B, width, 2), self.dtype)
        ys = np.zeros((B, width, 1), self.dtype)
        vs = np.full((B, width), self.setting.sensor_range_var, self.dtype)
        ms = np.zeros((B, width), bool)
        for i, (ril, rir, _, _) in enumerate(self.row_partitions):
            for j, (cil, cir, _, _) in enumerate(self.col_partitions):
                b = i * C + j
                sub_hit = hit[ril:rir, cil:cir]
                cnt = int(sub_hit.sum())
                if cnt <= self.setting.min_num_samples_per_group:
                    continue
                xs[b, :cnt] = fc[ril:rir, cil:cir][sub_hit]
                ys[b, :cnt, 0] = self.mapped_distances[ril:rir, cil:cir][sub_hit]
                ms[b, :cnt] = True
        return xs, ys, vs, ms

    def _build_scan_fit_cache(self) -> dict:
        """Geometry-only device constants of the scan train: the flat-index
        partition table and the frame coords (the partition grid never
        changes after the constructor). Setting scalars are read live at
        every train."""
        c = self._scan_fit_cache
        if c is None:
            fc = self.sensor_frame.frame_coords()
            W = fc.shape[1]
            R, C = self.num_partitions
            rw = max(ir - il for (il, ir, _, _) in self.row_partitions)
            cw = max(ir - il for (il, ir, _, _) in self.col_partitions)
            idx = np.zeros((R * C, rw * cw), np.int64)
            inb = np.zeros((R * C, rw * cw), bool)
            for i, (ril, rir, _, _) in enumerate(self.row_partitions):
                for j, (cil, cir, _, _) in enumerate(self.col_partitions):
                    b = i * C + j
                    rr, cc = np.meshgrid(np.arange(ril, rir),
                                         np.arange(cil, cir), indexing="ij")
                    flat = (rr * W + cc).ravel()  # row-major, as numpy's
                    idx[b, :flat.size] = flat     # boolean-mask flattening
                    inb[b, :flat.size] = True
            dev = self.device
            c = {"fc_flat": torch.as_tensor(fc.reshape(-1, 2), device=dev),
                 "idx": torch.as_tensor(idx, device=dev),
                 "inb": torch.as_tensor(inb, device=dev)}
            self._scan_fit_cache = c
        return c

    def _scan_scalars(self) -> np.ndarray:
        """The float settings a scan train reads, at every train: (valid
        range min, max, sensor range variance) in the model's dtype."""
        sf, s = self.sensor_frame.setting, self.setting
        return np.array([sf.valid_range_min, sf.valid_range_max,
                         s.sensor_range_var], self.dtype)

    def _gather_scans(self, ranges_batch: np.ndarray):
        """S range images -> the bank fit's inputs (x, y, var, mask) of S*B
        members, scan-major, gathered on the model's device."""
        return self._gather_tensors(
            torch.as_tensor(np.asarray(ranges_batch, self.dtype),
                            device=self.device),
            torch.as_tensor(self._scan_scalars(), device=self.device))

    def _gather_tensors(self, ranges, scalars):
        """:meth:`_gather_scans` of S range images (S, H, W) and
        :meth:`_scan_scalars` as tensors on the model's device."""
        c = self._build_scan_fit_cache()
        xs, ys, vs, ms = _gather_scan_3d(
            ranges, c["fc_flat"], c["idx"], c["inb"], scalars[0], scalars[1],
            scalars[2], int(self.setting.min_num_samples_per_group),
            mapping=self.mapping)
        S, B, w = ms.shape
        return (xs.reshape(S * B, w, 2), ys.reshape(S * B, w, 1),
                vs.reshape(S * B, w), ms.reshape(S * B, w))

    def _scan_step(self, ranges, scalars):
        """The body of a scan train, the function its CUDA graph captures:
        the gather and ONE bank fit, a BankState of S*B members (a
        reduced-rank model's ``batch_gp.bank_fit_rr_parts``, before its
        jitter ladder). Plain tensor code."""
        x, y, var, mask = self._gather_tensors(ranges, scalars)
        if self._basis is not None:
            return bank_fit_rr_parts(x, y, var, mask,
                                     *self._basis.consts(self.device))
        if self.mesh is not None:
            return sharded_bank_fit(self.mesh, x, y, var, mask, self._scale,
                                    kernel=self._kernel)
        return bank_fit_core(x, y, var, mask, self._scale,
                             kernel=self._kernel)

    def _step_key(self, shape) -> tuple:
        """What a scan train's graph bakes: the shape, and the settings
        that are not :meth:`_scan_scalars`."""
        m = self.mapping.setting
        return ("fit", tuple(shape), self.dtype.str, self._kernel,
                self._scale, str(m.type), float(m.scale),
                int(self.setting.min_num_samples_per_group),
                self._basis is not None)

    def _fit_scans(self, ranges_batch: np.ndarray,
                   graphed: bool = False) -> BankState:
        """S range images -> one BankState of S*B members: the gather and
        ONE bank fit (:meth:`_scan_step`), one CUDA-graph replay when
        ``graphed`` on a model with graphs. A member's L, L_inv and alpha
        do not depend on the bank it is fit in (``ops/bank.py``), so each
        scan's slice of a replay equals its own train bit for bit. A
        reduced-rank model fits the members' basis information systems
        instead; a mesh shards the members over its ranks."""
        rb = np.asarray(ranges_batch, self.dtype)
        sc = self._scan_scalars()
        if graphed and self._graphs is not None:
            return self._graphs.fit(self._step_key(rb.shape),
                                    self._scan_step, (rb, sc))
        out = self._scan_step(torch.as_tensor(rb, device=self.device),
                              torch.as_tensor(sc, device=self.device))
        return bank_fit_rr_finish(out)[0] if self._basis is not None else out

    def train_scan_batch(self, ranges_batch) -> BankState:
        """Offline trajectory replay: S range images' partition banks in ONE
        bank fit. ranges_batch (S, n_az, n_el), or (S, H, W) for a depth
        frame. Returns a BankState with S*B members, scan-major; use
        :meth:`use_scan_bank` to route queries at one scan's slice. Does
        not change this instance's trained state. Plain kernels on one card
        only. Runs eagerly on every device (``models/sensor_graph.py`` says
        why): the result is new tensors, the caller's own."""
        if self._basis is not None:
            raise NotImplementedError(
                "train_scan_batch needs plain kernels on a single chip")
        if self.mesh is not None:
            raise ValueError("train_scan_batch runs on one card: build the "
                             "model without mesh=")
        rb = np.asarray(ranges_batch, self.dtype)
        fc = self.sensor_frame.frame_coords()
        if rb.ndim != 3 or rb.shape[1:] != fc.shape[:2]:
            raise ValueError(
                f"ranges_batch must be (S, {fc.shape[0]}, {fc.shape[1]}), "
                f"got {rb.shape}")
        return self._fit_scans(rb)

    def use_scan_bank(self, stacked: BankState, scan_index: int) -> None:
        """Point this instance's routed predict at one scan's slice of a
        :meth:`train_scan_batch` result."""
        R, C = self.num_partitions
        B = R * C
        sl = slice(scan_index * B, (scan_index + 1) * B)
        self.bank = BankState(
            x=stacked.x[sl], mask=stacked.mask[sl], L=stacked.L[sl],
            alpha=stacked.alpha[sl], trained=stacked.trained[sl],
            L_inv=None if stacked.L_inv is None else stacked.L_inv[sl])
        self._trained = True

    def train(self, rotation, translation, ranges) -> bool:
        """One scan -> one flattened padded bank fit (reference Train). On
        a CUDA model with graphs (without a mesh, or on an NCCL one),
        ``self.bank`` is then the outputs of the train's graph, which the
        next train overwrites in place: clone a bank to keep it."""
        with span("egp.rsgp.train"):
            self._trained = False
            if not self.store_data(rotation, translation, ranges):
                return False
            self.bank = self._fit_scans(self.sensor_frame.ranges[None],
                                        graphed=True)
            self._trained = True
        return True

    def search_partition(self, coords: np.ndarray) -> np.ndarray:
        """coords (m, 2) -> flat bank index i*C + j; -1 when unresolved.
        Row interval is [left, right), col interval is [left, right]."""
        rc = coords[:, 0][:, None]
        cc = coords[:, 1][:, None]
        rok = (rc >= self._row_bounds[None, :, 0]) & (rc < self._row_bounds[None, :, 1])
        cok = (cc >= self._col_bounds[None, :, 0]) & (cc <= self._col_bounds[None, :, 1])
        ri = np.argmax(rok, axis=1)
        ci = np.argmax(cok, axis=1)
        ok = rok.any(axis=1) & cok.any(axis=1)
        idx = (ri * len(self.col_partitions) + ci).astype(np.int32)
        idx[~ok] = -1
        return idx

    def route_directions(self, dirs_local: np.ndarray):
        """Sensor-frame directions (m, 3) -> their frame coords (m, 2) and
        the bank member that answers each, -1 outside the frame: the
        routing of :meth:`test` and :meth:`compute_occ`."""
        coords, ok = self.sensor_frame.compute_frame_coords(dirs_local)
        ok = ok & self.sensor_frame.coords_in_frame(coords)
        return coords, np.where(ok, self.search_partition(coords),
                                -1).astype(np.int32)

    def _route_tensor(self, coords: torch.Tensor) -> torch.Tensor:
        """:meth:`route_directions` after the frame coordinates, as tensor
        code on the device with no host sync (the routed test's graph
        runs it): coords (m, 2), NaN where the frame maps no direction ->
        the member of each (m,) int64, -1 outside the frame. The frame's
        bounds are compared in the coordinates' dtype and the partition
        search keeps the first match (row [left, right), col [left,
        right]), as the host's comparisons and ``argmax`` do."""
        if self._route_bounds is None:
            self._route_bounds = tuple(
                torch.as_tensor(b, device=self.device)
                for b in (self._row_bounds, self._col_bounds))
        rb, cb = self._route_bounds
        rc, cc = coords[:, :1], coords[:, 1:]
        rok = (rc >= rb[:, 0]) & (rc < rb[:, 1])
        cok = (cc >= cb[:, 0]) & (cc <= cb[:, 1])
        ok = self.sensor_frame.coords_in_frame(coords) & rok.any(1) \
            & cok.any(1)
        idx = torch.argmax(rok.to(torch.uint8), 1) * len(self.col_partitions) \
            + torch.argmax(cok.to(torch.uint8), 1)
        return torch.where(ok, idx, -1)

    def _routed_predict(self, dirs: np.ndarray, directions_are_local: bool):
        """(mean (m, 1), var (m,), valid (m,)) numpy of the directions (m,
        3), in the sensor frame when ``directions_are_local``, else the
        world's: :meth:`test`'s and :meth:`compute_occ`'s routed predict.
        Without graphs, routed on the host (:meth:`route_directions`) and
        answered by ``bank_predict_assigned``; with graphs, the frame
        coordinates on the host and the rest one replay of
        ``SensorGraphs.routed_test``."""
        frame = self.sensor_frame
        with span("egp.rsgp.route"):
            if not directions_are_local:
                dirs = frame.dir_world_to_frame(dirs)
            if self._graphs is None:
                coords, idx = self.route_directions(dirs)
            else:
                coords, ok = frame.compute_frame_coords(dirs)
                coords = np.where(ok[:, None], coords,
                                  coords.dtype.type(np.nan))
        if self._graphs is None:
            return bank_predict_assigned(
                self.bank, coords, idx, self._scale, kernel=self._kernel,
                reduced_rank=self.reduced_rank_kernel, basis=self._basis)

        def body(bank, q):
            return bank_predict_chunked(
                bank, q, self._route_tensor(q), self._scale,
                kernel=self._kernel, reduced_rank=self.reduced_rank_kernel,
                basis=self._basis)

        return self._graphs.routed_test(
            self.bank, coords, body,
            (self._kernel, self._scale, self.reduced_rank_kernel,
             self._basis is not None, tuple(vars(frame.setting).values())))

    def test(self, directions, directions_are_local: bool, un_map: bool
             ) -> Optional[RangeSensorGP3DTestResult]:
        if not self._trained:
            return None
        return RangeSensorGP3DTestResult(self, directions,
                                         directions_are_local, un_map)

    def compute_occ(self, pos_local: np.ndarray):
        """Vectorized ComputeOcc. pos_local (n, 3) returns (valid, dist,
        range_pred, occ); a single point (3,) returns the reference
        binding's dict {success, dist_pos, range_pred, occ} of scalars."""
        single = np.asarray(pos_local).ndim == 1
        p = np.atleast_2d(np.asarray(pos_local, self.dtype))
        dist = np.linalg.norm(p, axis=-1)
        dirs = p / np.where(dist > 0, dist, 1.0)[:, None]
        mean, var, valid = self._routed_predict(dirs, True)
        mean = mean[:, 0]
        valid = valid & (var <= self.setting.max_valid_range_var)
        a = dist * self.setting.occ_test_temperature
        mapped = self.mapping.map(dist)
        # 2/(1+e^z)-1 == -tanh(z/2): saturates instead of overflowing exp
        occ = -np.tanh(0.5 * a * (mean - mapped))
        range_pred = self.mapping.inv(mean)
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
            "sensor_frame": self.sensor_frame.state_dict(),
            "mapped_distances": self.mapped_distances,
            "bank": None if self.bank is None else {
                k: v.detach().cpu().numpy()
                for k, v in self.bank._asdict().items() if k != "L_inv"},
        }

    def load_state_dict(self, d):
        """Load a checkpoint at its own dtype (its sensor frame's) onto this
        model's device."""
        self.__init__(RangeSensorGP3DSetting.from_dict(d["setting"]),
                      dtype=np.asarray(d["sensor_frame"]["rotation"]).dtype,
                      device=self.device)
        self._trained = bool(d["trained"])
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
        if not isinstance(other, RangeSensorGaussianProcess3D):
            return NotImplemented
        return eq_state(self.state_dict(), other.state_dict())
