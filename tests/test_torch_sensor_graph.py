"""The sensor GPs' CUDA-graph steps (erl_gaussian_process_tpu_torch/models/
sensor_graph.py) on the CPU: the bodies the graphs capture (the scan
train's gather and bank fit, plain and reduced-rank, and the routed
predict), run eagerly, against ``train`` / ``train_scan_batch`` / ``test``
bit for bit and against the JAX package's one-dispatch jits on the same
inputs (float64 to 1e-12 of each result's magnitude, float32 to 1e-4, the
tolerances of tests/test_torch_range_sensor_gp_3d.py and
tests/test_torch_lidar_gp_2d.py); the graphs' routing, driven on the CPU
with an eager stand-in for the capture whose outputs are static buffers
overwritten by each replay, as a graph's are; and the launch accounting of
a replay. The graphs themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 8-10, 16, 17 and 20)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.models.batch_gp as jbatch
import erl_gaussian_process_tpu.models.lidar_gp_2d as jlidar
import erl_gaussian_process_tpu.models.range_sensor_gp_3d as j3d
import erl_gaussian_process_tpu_torch.models.pose_graph as pg
from erl_gaussian_process_tpu_torch.models import (
    LidarGaussianProcess2D,
    LidarGP2DSetting,
    RangeSensorGaussianProcess3D,
    RangeSensorGP3DSetting,
)
from erl_gaussian_process_tpu_torch.models.batch_gp import (
    _predict_segmented,
    _predict_segmented_rr,
    group_queries,
)
from erl_gaussian_process_tpu_torch.models.sensor_graph import SensorGraphs
from erl_gaussian_process_tpu_torch.ops import (
    bank_fit_cuda,
    launch_counts,
    substitute_cuda,
)
from erl_gaussian_process_tpu_torch.ops._library import note_launch
from erl_gaussian_process_tpu_torch.utils.loaders import load_lidar_log
from torch_graph_standin import eager_graphs  # noqa: F401 (fixture)

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data", "double",
                    "train.dat")
TOL = {np.float64: 1e-12, np.float32: 1e-4}
# the reduced-rank banks' float64 L and alpha, as
# tests/test_torch_reduced_rank.py holds them to JAX's (the information
# systems at var 1e-4 are ill-conditioned enough to show 1e-12 roundings)
RR_TOL64 = {"L": 1e-11, "alpha": 1e-10}
KINDS = ["3d", "3d_rr", "2d", "2d_rr"]


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """The first multi-threaded float32 ``torch.exp`` of a fresh CPU
    process can be off in one thread's chunk (tests/test_torch_gram.py's
    fixture of the same name); the bitwise comparisons below would see it."""
    torch.exp(torch.zeros(1 << 20, dtype=torch.float32))


@pytest.fixture(scope="module")
def frames():
    return load_lidar_log(DATA)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, ref, tol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _same_bank(a, b):
    """Bit for bit, NaN members included."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None and y is None) or (
            x.dtype == y.dtype and x.shape == y.shape
            and _np(x).tobytes() == _np(y).tobytes())


def _setting_3d(rr: bool) -> dict:
    """tests/test_torch_range_sensor_gp_3d.py's analytic lidar scan at 40 x
    20 rays (a reduced-rank 24 x 12 basis for ``rr``, at noise 1e-2: at
    1e-4 its float32 information systems leave L's last pivots to
    rounding)."""
    gp = (dict(kernel_type="reduced_rank_rbf",
               kernel=dict(x_dim=2, scale=0.5, num_basis=[24, 12],
                           boundary=[4.8, 2.1], coord_origin=[0.0, 0.0]))
          if rr else dict(kernel_type="ou", kernel=dict(x_dim=2, scale=0.5)))
    return dict(row_group_size=12, row_overlap_size=4, col_group_size=12,
                col_overlap_size=4, min_num_samples_per_group=10,
                sensor_range_var=1e-2 if rr else 1e-4,
                sensor_frame=dict(valid_range_min=0.1, valid_range_max=40.0,
                                  azimuth_min=-np.pi, azimuth_max=np.pi,
                                  elevation_min=-0.6, elevation_max=0.6,
                                  num_azimuth_lines=40,
                                  num_elevation_lines=20),
                gp=gp, mapping=dict(type="inverse_sqrt"))


def _setting_2d(angles, rr: bool, **kw) -> dict:
    """tests/test_torch_lidar_gp_2d.py's setting with discontinuity
    detection (a 48-function reduced-rank basis for ``rr``)."""
    gp = (dict(kernel_type="reduced_rank_rbf",
               kernel=dict(x_dim=1, scale=0.25, num_basis=[48]))
          if rr else dict(kernel_type="ou", kernel=dict(x_dim=1, scale=0.05)))
    d = dict(group_size=26, overlap_size=6, margin=1, sensor_range_var=0.01,
             discontinuity_var=100.0,
             sensor_frame=dict(valid_range_min=0.1, valid_range_max=30.0,
                               angle_min=float(angles[0]),
                               angle_max=float(angles[-1]),
                               num_rays=int(angles.shape[0]),
                               discontinuity_detection=True),
             gp=gp, mapping=dict(type="identity"))
    d.update(kw)
    return d


def _scans_3d(gp, n=3):
    """n holed scans of the wavy room, each a little scaled."""
    dirs = gp.sensor_frame.ray_directions_in_frame()
    az = np.arctan2(dirs[..., 1], dirs[..., 0])
    el = np.arctan2(dirs[..., 2], np.hypot(dirs[..., 0], dirs[..., 1]))
    r = 5.0 + 0.5 * np.sin(3 * az) * np.cos(2 * el)
    rng = np.random.default_rng(1)
    return np.stack([np.where(rng.uniform(size=r.shape) < 0.2, np.inf,
                              r * (1 + 0.01 * k)) for k in range(n)])


class Case:
    """One sensor GP kind: a model factory, its scans, the queries of its
    ``test`` and the train pose."""

    def __init__(self, kind, dtype, frames, **kw):
        self.kind, self.dtype = kind, dtype
        rr = kind.endswith("_rr")
        if kind.startswith("3d"):
            self.setting = _setting_3d(rr)
            self.cls, self.scls = RangeSensorGaussianProcess3D, \
                RangeSensorGP3DSetting
            self.jcls, self.jscls = j3d.RangeSensorGaussianProcess3D, \
                j3d.RangeSensorGP3DSetting
            self.pose = (np.eye(3), np.zeros(3))
            self.scans = _scans_3d(self.new())
            dirs = self.new().sensor_frame.ray_directions_in_frame()
            self.queries = dirs.reshape(-1, 3)[::5]
        else:
            angles = frames[0].angles
            self.setting = _setting_2d(angles, rr, **kw)
            self.cls, self.scls = LidarGaussianProcess2D, LidarGP2DSetting
            self.jcls, self.jscls = jlidar.LidarGaussianProcess2D, \
                jlidar.LidarGP2DSetting
            self.pose = (np.eye(2), np.zeros(2))
            self.scans = np.stack([f.ranges for f in frames[:3]])
            self.queries = angles

    def new(self, graphed=False, **kw):
        """A CPU model; ``graphed``: with graphs on the CPU (``kw`` for
        ``SensorGraphs``), run through the ``eager_graphs`` stand-in."""
        gp = self.cls(self.scls.from_dict(self.setting), dtype=self.dtype,
                      device="cpu")
        assert gp._graphs is None
        if graphed:
            gp._graphs = SensorGraphs("cpu", **kw)
        return gp

    def jax_model(self):
        return self.jcls(self.jscls.from_dict(self.setting),
                         dtype=self.dtype)

    def result(self, gp):
        r = gp.test(self.queries, True, False)
        return r._mean, r._var, r._valid


def _owned(gp) -> bool:
    """Whether the model's bank is a train graph's static outputs."""
    outs = [getattr(g.outputs, "bank", g.outputs)
            for g in gp._graphs._fits.values()]
    return any(all(a is b for a, b in zip(gp.bank, o)) for o in outs)


def _same_result(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _routed_result(case, a, b, occ=False):
    """A routed test's or ``compute_occ``'s (``occ``) outputs of the
    graphed model (b) against the eager model's (a): bit for bit, but
    where the graph's rows (``batch_gp.group_chunks``, 32 slots) have
    another shape than the host's bucket and their products round
    otherwise: a float32 3D model's outputs, and a 2D model's
    ``compute_occ`` of a few points (a bucket a few slots wide): valid
    flags and distances exact, the rest within TOL of their dtype
    (tests/test_torch_routed_chunks.py)."""
    if not ((case.kind.startswith("3d") and case.dtype == np.float32)
            or (occ and case.kind.startswith("2d"))):
        _same_result(a, b)
        return
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == bool:
            np.testing.assert_array_equal(x, y)
        else:
            fin = np.isfinite(x)
            np.testing.assert_array_equal(fin, np.isfinite(y))
            _close(y[fin], x[fin], TOL[case.dtype])


# -- (a) the captured bodies against train / train_scan_batch / test --------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_graphed_steps_equal_the_eager_model(frames, eager_graphs, kind,
                                             dtype):
    """The graphed routing (static inputs, the bodies run as captured,
    static outputs) against the eager CPU model, bit for bit: the bank of
    each ``train``, ``test``'s mean, variance and valid mask, the
    ``compute_occ`` result (a float32 3D model's, and a 2D model's
    ``compute_occ``, within TOL: ``_routed_result``), and (plain kernels)
    ``train_scan_batch`` (eager, no graph) and each scan's slice against
    its own ``train``; the body called directly gives the same bank."""
    case = Case(kind, dtype, frames)
    ref, got = case.new(), case.new(graphed=True)
    for s in range(2):
        assert ref.train(*case.pose, case.scans[s])
        assert got.train(*case.pose, case.scans[s])
        _same_bank(ref.bank, got.bank)
        assert _owned(got)
        _routed_result(case, case.result(ref), case.result(got))
        assert len(got._graphs._routed)
    body = ref._scan_step(torch.as_tensor(case.scans[1:2].astype(dtype)),
                          torch.as_tensor(ref._scan_scalars()),
                          *([] if kind.startswith("3d") else
                            ref._table_tensors()))
    _same_bank(ref.bank, body.bank if kind.endswith("_rr") else body)
    occ = (case.queries[::7] * 2.0 if kind.startswith("3d") else
           np.stack([np.cos(case.queries[::7]),
                     np.sin(case.queries[::7])], -1) * 2.0)
    _routed_result(case, ref.compute_occ(occ), got.compute_occ(occ), True)
    if kind.endswith("_rr"):
        assert len(got._graphs._fits) == 1
        return
    stacked_ref = ref.train_scan_batch(case.scans)
    stacked = got.train_scan_batch(case.scans)
    _same_bank(stacked_ref, stacked)
    assert len(got._graphs._fits) == 1
    B = stacked.x.shape[0] // len(case.scans)
    for s in (0, 2):
        assert got.train(*case.pose, case.scans[s])
        _same_bank([t[s * B:(s + 1) * B] for t in stacked], got.bank)


# -- (b) the captured bodies against the JAX package's jits -----------------

def _jax_fit(case, jgp, ranges, batch: bool):
    """JAX's one-dispatch scan train of ``ranges`` (one scan, or S with
    ``batch``) from the JAX model's own cache and settings."""
    c = jgp._build_scan_fit_cache()
    s = jgp.setting
    dt = jgp.dtype.type
    r = jnp.asarray(ranges)
    if case.kind.startswith("3d"):
        sf = jgp.sensor_frame.setting
        args = (r, c["fc_flat"], c["idx"], c["inb"], dt(sf.valid_range_min),
                dt(sf.valid_range_max), dt(s.sensor_range_var),
                jnp.int32(s.min_num_samples_per_group))
        kw = dict(map_type=s.mapping.type, map_scale=s.mapping.scale)
        mod = j3d
    else:
        sf = s.sensor_frame
        args = (r, c["angles"], c["idx"], c["inb"], dt(sf.valid_range_min),
                dt(sf.valid_range_max), dt(sf.discontinuity_threshold),
                dt(s.sensor_range_var), dt(s.discontinuity_var))
        kw = dict(discon_on=sf.discontinuity_detection,
                  map_type=s.mapping.type, map_scale=s.mapping.scale)
        mod = jlidar
    if jgp._basis is not None:
        b = jgp._basis
        return mod._scan_train_fused_rr(*args, b._freq, b._sqrt_s, b._origin,
                                        b._half, b._inv_sqrt_vol, **kw)
    fn = mod._scan_train_batch_fused if batch else mod._scan_train_fused
    return fn(*args, dt(jgp._scale), kernel=jgp._kernel,
              use_pallas=c["use_pallas"], **kw)


def _bank_close(bank, jbank, tol, rr=False):
    np.testing.assert_array_equal(_np(bank.mask), np.asarray(jbank.mask))
    np.testing.assert_array_equal(_np(bank.x), np.asarray(jbank.x))
    tri = np.tril(np.ones(bank.L.shape[1:], bool))
    f64 = bank.L.dtype == torch.float64
    _close(np.where(tri, _np(bank.L), 0),
           np.where(tri, np.asarray(jbank.L), 0),
           RR_TOL64["L"] if rr and f64 else tol)
    if rr and not f64:
        # a float32 information system leaves alpha to rounding: held, as
        # tests/test_torch_reduced_rank.py holds it, through the predict
        return
    _close(bank.alpha, jbank.alpha, RR_TOL64["alpha"] if rr else tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_captured_bodies_match_the_jax_jits(frames, kind, dtype):
    """The train body against ``_scan_train_fused`` (``_rr``), the scan
    replay's against ``_scan_train_batch_fused``, and the routed predict's
    (``_predict_segmented``, ``_predict_segmented_rr``) against the JAX
    package's on the same bank, member ids and bucketed queries."""
    case = Case(kind, dtype, frames)
    tol = TOL[dtype]
    gp, jgp = case.new(), case.jax_model()
    assert gp.train(*case.pose, case.scans[0])
    assert jgp.train(*case.pose, case.scans[0])
    ranges = np.asarray(jgp.sensor_frame.ranges, dtype)
    body = gp._scan_step(torch.as_tensor(ranges[None]),
                         torch.as_tensor(gp._scan_scalars()),
                         *([] if kind.startswith("3d") else
                           gp._table_tensors()))
    rr = kind.endswith("_rr")
    _bank_close(body.bank if rr else body,
                _jax_fit(case, jgp, ranges, False), tol, rr)
    if not rr:
        stacked = gp._scan_step(torch.as_tensor(case.scans.astype(dtype)),
                                torch.as_tensor(gp._scan_scalars()),
                                *([] if kind.startswith("3d") else
                                  gp._table_tensors()))
        _bank_close(stacked, _jax_fit(case, jgp, case.scans.astype(dtype),
                                      True), tol)
    # the routed predict's body on the port's bank, in both packages
    bank = gp.bank
    if kind.startswith("3d"):
        coords, idx = gp.route_directions(case.queries.astype(dtype))
    else:
        a = case.queries.astype(dtype)
        coords, idx = a[:, None], gp.search_partition(a)
    _, slots, _, mids = group_queries(idx, _np(bank.trained))
    qs = torch.as_tensor(coords[slots])
    jstate = jbatch.BankState(*(None if t is None else jnp.asarray(_np(t))
                                for t in bank))
    if rr:
        got = _predict_segmented_rr(bank, torch.as_tensor(mids), qs,
                                    gp._basis)
        b = jgp._basis
        ref = jbatch._predict_segmented_rr(
            jstate, jnp.asarray(mids), jnp.asarray(_np(qs)), b._freq,
            b._sqrt_s, b._origin, b._half, b._inv_sqrt_vol)
    else:
        got = _predict_segmented(bank, torch.as_tensor(mids), qs, gp._scale,
                                 kernel=gp._kernel, fused=True)
        ref = jbatch._predict_segmented(
            jstate, jnp.asarray(mids), jnp.asarray(_np(qs)),
            dtype(gp._scale), kernel=gp._kernel, reduced_rank=False,
            fused=True)
    for a, b in zip(got, ref):
        _close(a, b, tol)


# -- (c) the graphs' routing ------------------------------------------------

@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_changed_setting_scalars_reach_the_next_train(frames, eager_graphs,
                                                      kind):
    """The float settings are a static input of the train's graph, filled
    at every train: changed between two trains of one graphed model, the
    bank changes as the eager model's does (one graph, no recapture); a
    setting the graph bakes (the sample floor) gets a graph of its own."""
    case = Case(kind, np.float64, frames)
    ref, got = case.new(), case.new(graphed=True)
    for m in (ref, got):
        assert m.train(*case.pose, case.scans[0])
    before = got.bank.L.clone()
    for m in (ref, got):
        m.setting.sensor_range_var = 0.05
        if kind == "2d":
            m.setting.sensor_frame.discontinuity_threshold = 0.05
        else:
            m.sensor_frame.setting.valid_range_max = 5.2
        assert m.train(*case.pose, case.scans[0])
    _same_bank(ref.bank, got.bank)
    assert not torch.equal(before, got.bank.L)
    assert len(got._graphs._fits) == 1
    _same_result(case.result(ref), case.result(got))
    if kind == "3d":
        for m in (ref, got):
            m.setting.min_num_samples_per_group = 40
            assert m.train(*case.pose, case.scans[0])
        _same_bank(ref.bank, got.bank)
        assert len(got._graphs._fits) == 2


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_a_new_bank_is_what_the_routed_graph_reads(frames, eager_graphs,
                                                   kind):
    """``use_scan_bank`` and ``load_state_dict`` give the model another
    bank: the routed predict reads it (copied into the graph's static
    bank), not the train graph's buffers, and a train makes those the
    bank again; a loaded model starts with graphs of its own."""
    case = Case(kind, np.float64, frames)
    ref, got = case.new(), case.new(graphed=True)
    stacked = [m.train_scan_batch(case.scans) for m in (ref, got)]
    for m in (ref, got):
        assert m.train(*case.pose, case.scans[0])
    _same_result(case.result(ref), case.result(got))
    for k in (2, 1):
        for m, st in zip((ref, got), stacked):
            m.use_scan_bank(st, k)
        assert not _owned(got)
        _same_result(case.result(ref), case.result(got))
    for m in (ref, got):
        assert m.train(*case.pose, case.scans[0])
    _same_result(case.result(ref), case.result(got))
    state = ref.state_dict()
    graphs = got._graphs
    for m in (ref, got):
        m.train(*case.pose, case.scans[2])
        m.load_state_dict(state)
    assert got._graphs is not graphs
    got._graphs = SensorGraphs("cpu")
    _same_result(case.result(ref), case.result(got))


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_scan_batch_result_survives_the_next_call(frames, eager_graphs,
                                                  kind):
    """``train_scan_batch`` runs eagerly and captures nothing: a bank held
    from one call is not overwritten by the next, while ``train``'s bank is
    the train graph's buffers, which the next train overwrites."""
    case = Case(kind, np.float64, frames)
    got = case.new(graphed=True)
    first = got.train_scan_batch(case.scans)
    kept = [t.clone() for t in first]
    second = got.train_scan_batch(case.scans[::-1].copy())
    assert not torch.equal(first.L, second.L)
    _same_bank(first, kept)
    assert not eager_graphs and not len(got._graphs._fits)
    assert got.train(*case.pose, case.scans[0])
    held = got.bank
    assert _owned(got) and got.bank is held
    L0 = held.L.clone()
    assert got.train(*case.pose, case.scans[1])
    assert got.bank.L is held.L and not torch.equal(held.L, L0)


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_scan_batch_leaves_the_trained_bank(frames, eager_graphs, kind):
    """``train`` of scan A, then ``train_scan_batch`` of scan B alone (S =
    1, the train's own shape): the model's bank, and so its ``test`` and
    ``compute_occ``, stay scan A's, the eager model's (bit for bit, but a
    2D ``compute_occ``: ``_routed_result``)."""
    case = Case(kind, np.float64, frames)
    ref, got = case.new(), case.new(graphed=True)
    for m in (ref, got):
        assert m.train(*case.pose, case.scans[0])
    want = case.result(ref)
    _same_result(want, case.result(got))
    bank = [t.clone() for t in got.bank]
    for m in (ref, got):
        m.train_scan_batch(case.scans[1:2])
    _same_bank(bank, got.bank)
    _same_result(want, case.result(got))
    _same_result(want, case.result(ref))
    occ = (case.queries[::7] * 2.0 if kind == "3d" else
           np.stack([np.cos(case.queries[::7]),
                     np.sin(case.queries[::7])], -1) * 2.0)
    _routed_result(case, ref.compute_occ(occ), got.compute_occ(occ), True)


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_gps_views_survive_the_next_train(frames, eager_graphs, kind):
    """``gps`` on a graphed model: the views hold a copy of the bank, so a
    later train leaves their factors those of the scan their train sets
    hold, bit for bit the eager model's views."""
    case = Case(kind, np.float64, frames)
    ref, got = case.new(), case.new(graphed=True)
    for m in (ref, got):
        assert m.train(*case.pose, case.scans[0])

    def views(m):
        g = m.gps
        return [v for row in g for v in row] if kind == "3d" else g

    held, want = views(got), views(ref)
    assert got.train(*case.pose, case.scans[1])
    assert not torch.equal(got.bank.L, ref.bank.L)
    assert len(held) == len(want) > 1
    for a, b in zip(held, want):
        _same_bank(tuple(a.state), tuple(b.state))
        assert a._train_set.x.tobytes() == b._train_set.x.tobytes()


def test_a_large_routed_test_is_one_replay(frames, eager_graphs):
    """A 2D test of 6000 query angles, whose host bucket (Bp * C) holds
    more than 4096 query slots, and the device rows too: one replay of one
    routed graph, captured at the first test and replayed by the second,
    whose answers (mean, variance, valid flags) are the eager model's bit
    for bit; the query count keys the graph, the data does not."""
    case = Case("2d", np.float64, frames)
    ref, got = case.new(), case.new(graphed=True)
    for m in (ref, got):
        assert m.train(*case.pose, case.scans[0])
    many = np.linspace(-2.5, 2.5, 6000)
    idx = ref.search_partition(many)
    slots = group_queries(idx, _np(ref.bank.trained))[1]
    assert slots.size > 4096 and (idx < 0).any()
    g = got._graphs
    for k in range(2):
        a, b = ref.test(many, True, False), got.test(many, True, False)
        _same_result((a._mean, a._var, a._valid),
                     (b._mean, b._var, b._valid))
        assert b._valid.any()
        (routed,) = [r for r in eager_graphs if r.key[1] == "chunked"]
        assert routed.replays == k + 1 and len(g._routed) == 1
    a, b = ref.test(many[::-1].copy(), True, False), \
        got.test(many[::-1].copy(), True, False)
    _same_result((a._mean, a._var, a._valid), (b._mean, b._var, b._valid))
    assert len(g._routed) == 1 and routed.replays == 3


def test_the_least_recently_used_shape_is_dropped(frames, eager_graphs):
    """A table keeps ``size`` graphs of each kind; the least recently used
    is released (with the routed predicts that read its outputs), the
    record of every capture stays. The shapes: hit-ray partition tables of
    scans with 0, 18, 36 and 54 rays lost."""
    case = Case("2d", np.float64, frames, partition_on_hit_rays=True)
    got = case.new(graphed=True)
    got._graphs = g = SensorGraphs("cpu", size=2)

    def train(holes):
        r = frames[0].ranges.copy()
        r[:holes] = np.inf
        assert got.train(*case.pose, r)
        return got._scan_fit_cache["idx"].shape

    shapes = [train(h) for h in (0, 18, 0, 36)]
    assert len(set(shapes)) == 3
    assert [k[2] for k in g._fits] == [shapes[0], shapes[3]]
    assert len(g.captures) == 3
    assert g.captures[1].graph is None and g.captures[1].key[2] == shapes[1]
    fit_key = list(g._fits)[-1]
    got.test(case.queries, True, False)
    assert [k[0] for k in g._routed] == [("fit", fit_key)]
    assert train(18) == shapes[1]
    assert len(g._routed) == 1
    assert train(54) not in shapes
    assert not len(g._routed)


def test_cpu_models_build_no_graph(frames, monkeypatch):
    """A CPU model (and a model with a mesh) never captures: every step
    runs eagerly."""
    def capture(*args, **kw):
        raise AssertionError("a CPU model captured a graph")

    monkeypatch.setattr(pg, "capture", capture)
    for kind in ("3d", "2d_rr"):
        case = Case(kind, np.float32, frames)
        gp = case.new()
        assert gp.train(*case.pose, case.scans[0])
        case.result(gp)
        if kind == "3d":
            gp.train_scan_batch(case.scans)
        assert gp._graphs is None


def test_hit_ray_partitions_capture_a_graph_per_shape(frames, eager_graphs):
    """With ``partition_on_hit_rays`` the partition table, and so the
    train's shape, changes from scan to scan: a graph per shape, the new
    table copied in whenever it changed; every scan of the log equal to
    the eager model bit for bit."""
    case = Case("2d", np.float64, frames, partition_on_hit_rays=True)
    ref, got = case.new(), case.new(graphed=True)
    got._graphs = SensorGraphs("cpu", size=64)
    shapes = set()
    for k, f in enumerate(frames[:10]):
        r = f.ranges.copy()
        r[:9 * (k % 4)] = np.inf      # the log's scans hit every ray
        for m in (ref, got):
            assert m.train(*case.pose, r)
        shapes.add(tuple(ref._scan_fit_cache["idx"].shape))
        _same_bank(ref.bank, got.bank)
        _same_result(case.result(ref), case.result(got))
    assert len(got._graphs._fits) == len(shapes) > 1


def test_hit_ray_tables_of_one_length_route_by_their_own_bounds(
        frames, eager_graphs):
    """Two hit-ray partition tables of the same length and shape but other
    bounds (a scan missing its first 9 rays, one missing its last 9): one
    train graph and one routed graph serve both, and each test routes by
    its own table, the bounds copied into the graph's input when the model
    holds the other table: the answers bit for bit the eager model's, the
    valid flags of the two tables apart."""
    case = Case("2d", np.float64, frames, partition_on_hit_rays=True)
    ref, got = case.new(), case.new(graphed=True)
    head, tail = frames[0].ranges.copy(), frames[0].ranges.copy()
    head[:9] = np.inf
    tail[-9:] = np.inf
    valid, bounds = [], []
    for r in (head, tail, head):
        for m in (ref, got):
            assert m.train(*case.pose, r)
        want, res = case.result(ref), case.result(got)
        _same_result(want, res)
        valid.append(res[2])
        bounds.append(ref._part_bounds)
    assert bounds[0].shape == bounds[1].shape
    assert not np.array_equal(bounds[0], bounds[1])
    assert not np.array_equal(valid[0], valid[1])
    np.testing.assert_array_equal(valid[0], valid[2])
    assert len(got._graphs._fits) == 1 and len(got._graphs._routed) == 1
    (routed,) = got._graphs._routed.values()
    assert routed.replays == 3
    np.testing.assert_array_equal(_np(routed.inputs[3]), bounds[2])


def test_a_table_rebuilt_after_the_train_keys_its_own_graph(
        frames, eager_graphs):
    """A partition table rebuilt after the train (``partition_on_angles``
    at another group size) holds another count than the bank's members:
    the test routes by it through a routed graph of its own, keyed by the
    table's shape, the bank's graph unchanged, and answers bit for bit as
    the eager model does."""
    case = Case("2d", np.float64, frames)
    ref, got = case.new(), case.new(graphed=True)
    for m in (ref, got):
        assert m.train(*case.pose, case.scans[0])
    _same_result(case.result(ref), case.result(got))
    members = got.bank.trained.shape[0]
    for m in (ref, got):
        m.setting.group_size = 20
        m.partition_on_angles()
    assert len(got.partitions) != members
    _same_result(case.result(ref), case.result(got))
    assert len(got._graphs._fits) == 1 and len(got._graphs._routed) == 2
    shapes = sorted(tuple(r.inputs[3].shape)
                    for r in got._graphs._routed.values())
    assert shapes == sorted([(members, 2), (len(got.partitions), 2)])


def test_rr_jitter_ladder_runs_after_the_replay(frames, eager_graphs):
    """A reduced-rank bank whose information matrices are indefinite (a
    negative noise variance): the graph runs the well-posed chain, the
    host reads its flag after the replay and runs the jitter ladder (which
    repairs some members, the rest stay NaN), and the bank equals the eager
    model's bit for bit."""
    case = Case("2d_rr", np.float64, frames, sensor_range_var=-10.0)
    ref, got = case.new(), case.new(graphed=True)
    for m in (ref, got):
        assert m.train(*case.pose, case.scans[0])
    assert got._graphs.ladder_runs == 1
    _same_bank(ref.bank, got.bank)
    failed = got._graphs._fits.values().__iter__().__next__().outputs.bad
    fixed = failed & torch.isfinite(got.bank.L).flatten(1).all(1)
    assert bool(failed.all()) and 0 < int(fixed.sum()) < len(failed)
    _same_result(case.result(ref), case.result(got))


# -- launch accounting ------------------------------------------------------

class _NoGraph:
    def replay(self):
        pass


def test_replays_count_the_launches_they_captured(monkeypatch):
    """Under capture a wrapper's launch counts in ``captured``; each replay
    of a graph adds the launches it captured: after N replays the counts
    grew by N times them."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    before = (bank_fit_cuda.launches, bank_fit_cuda.captured)
    note_launch(bank_fit_cuda)
    assert (bank_fit_cuda.launches, bank_fit_cuda.captured) == \
        (before[0], before[1] + 1)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    note_launch(bank_fit_cuda)
    assert bank_fit_cuda.launches == before[0] + 1
    g = pg.CapturedGraph(key="k", graph=_NoGraph(), inputs=(), outputs=None,
                         launches={bank_fit_cuda: 1, substitute_cuda: 2},
                         warmup_ms=0.0, capture_ms=0.0, pool_bytes=0)
    start = launch_counts()
    for _ in range(5):
        g.replay()
    end = launch_counts()
    assert {k: end[k] - start[k] for k in end if end[k] != start[k]} == \
        {"bank_fit": 5, "trsv": 10}
    assert g.replays == 5
    assert all(hasattr(w, "captured") for w in pg._counted_wrappers()) and \
        len(pg._counted_wrappers()) == len(launch_counts())
