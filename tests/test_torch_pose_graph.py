"""The map's CUDA-graph step (erl_gaussian_process_tpu_torch/models/
pose_graph.py) on the CPU: its captured body, run eagerly, against the
functional ``update_batch_steps`` of the port (bit for bit) and of the JAX
package (with JAX's draws injected); the port's ``predict_step`` against
JAX's; checkpoints; and the map's graphed routing, driven on the CPU with
an eager stand-in for the capture (a "graph" whose replay runs the
captured function again), held bit for bit to the eager map. The graphs
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 24)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.models.spgp_occupancy_map as jmap
import erl_gaussian_process_tpu_torch.models.pose_graph as pg
from erl_gaussian_process_tpu.geometry import Aabb as JaxAabb
from erl_gaussian_process_tpu_torch.geometry import Aabb
from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
from erl_gaussian_process_tpu_torch.models.gp_core import kahan_add
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SpGpState,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    predict_step,
    step_seed,
    update_batch_steps,
)
from erl_gaussian_process_tpu_torch.utils.convert import (
    spgp_state_from_numpy,
)
from erl_gaussian_process_tpu_torch.workloads import (
    FREE_SLOTS_PER_RAY,
    hotel0_workload,
)

POSES = 8
SEED = 3
# tests/test_spgp_occupancy_map.py's float32 map tolerances (as
# tests/test_torch_occupancy_map.py); float64 to 1e-12 of each result's
# magnitude
TOL = {np.float32: dict(rtol=1e-3, atol=1e-4)}
F64_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_exp():
    """The first multi-threaded float32 ``torch.exp`` of a fresh CPU
    process can be off in one thread's chunk (tests/test_torch_gram.py's
    fixture of the same name); the bitwise comparisons below would see it."""
    torch.exp(torch.zeros(1 << 20, dtype=torch.float32))


@pytest.fixture(scope="module")
def hotel0():
    """Hotel-0's first POSES poses at full width (1089 pseudo points, 384
    rays, a 2048-sample budget)."""
    sensors, pts, masks, _, traj, setting, pseudo, lo, hi = hotel0_workload(
        n_poses=POSES)
    pts = np.where(masks[..., None], pts, 0.0).astype(np.float32)
    return dict(sensors=sensors, pts=pts, masks=masks, traj=traj,
                setting=setting, pseudo=pseudo, lo=lo, hi=hi)


@pytest.fixture(scope="module")
def small(hotel0):
    """The same scans on a coarse map (a 5 x 5 x 4 pseudo grid padded to
    128, a 512-sample budget), for the class-level tests: every path of the
    routing at a few seconds."""
    s = hotel0["setting"]
    axes = [np.linspace(a, b, k) for a, b, k in
            zip(hotel0["lo"], hotel0["hi"], (5, 5, 4))]
    grid = np.stack([a.ravel() for a in np.meshgrid(*axes, indexing="ij")])
    return dict(hotel0, pseudo=grid, setting=dataclasses.replace(
        s, sp_gp=dataclasses.replace(s.sp_gp, max_num_samples=512)))


def _map(w, dtype=np.float32, seed=SEED):
    return SpGpOccupancyMap(w["setting"], w["pseudo"],
                            Aabb.from_min_max(w["lo"], w["hi"]), seed=seed,
                            dtype=dtype,
                            free_slots_per_ray=FREE_SLOTS_PER_RAY,
                            device="cpu")


def _copy(state):
    return SpGpState(*(t.clone() for t in state))


def _inputs(m, w, dtype):
    return (m._tensor(w["sensors"].astype(dtype)),
            m._tensor(w["pts"].astype(dtype)), torch.as_tensor(w["masks"]))


def test_kahan_add_into_given_tensors_is_bitwise_the_new_tensors():
    rng = np.random.default_rng(0)
    s, c, d = (torch.tensor(rng.normal(size=(64, 64)), dtype=torch.float32)
               for _ in range(3))
    ref = kahan_add(s, c, d)
    s2, c2 = s.clone(), c.clone()
    out = kahan_add(s2, c2, d, out=(s2, c2))
    assert out[0] is s2 and out[1] is c2
    assert torch.equal(s2, ref[0]) and torch.equal(c2, ref[1])


@pytest.mark.parametrize("c", [1, 4])
def test_pose_chunk_body_equals_update_batch_steps_bitwise(hotel0, c):
    """(a) The captured body, run eagerly on CPU tensors chunk by chunk
    with each pose's generator seeded as the map seeds it, writes into its
    state buffers exactly what the functional ``update_batch_steps``
    returns: Q_M, alpha, both Kahan terms, the samples used and (c = 1)
    the collected datasets."""
    m = _map(hotel0)
    kw = m._step_kw()
    sp, p, mk = _inputs(m, hotel0, np.float32)
    ref_state, ref_used, *ref_data = update_batch_steps(
        _copy(m.state), SEED, 1, sp, p, mk, m._aabb_min, m._aabb_max,
        m.sp_gp._scale, generator=torch.Generator(), poses_per_step=c,
        collect_datasets=c == 1, **kw)
    state = _copy(m.state)
    buffers = tuple(state)
    gens = [torch.Generator() for _ in range(c)]
    used, data = [], []
    for lo in range(0, POSES, c):
        for i, g in enumerate(gens):
            g.manual_seed(step_seed(SEED, 1 + lo + i))
        n, ds = pg.pose_chunk_body(
            state, sp[lo:lo + c], p[lo:lo + c], mk[lo:lo + c], m._aabb_min,
            m._aabb_max, m.sp_gp._scale, generators=gens,
            collect_datasets=c == 1, **kw)
        used.append(n)
        data.append(ds)
    assert all(a is b for a, b in zip(state, buffers))
    for name in ("qm", "alpha", "qm_c", "alpha_c"):
        assert torch.equal(getattr(state, name), getattr(ref_state, name)), \
            name
    assert torch.equal(torch.cat(used), ref_used)
    if c == 1:
        for got, ref in zip(zip(*data), ref_data[0]):
            assert torch.equal(torch.stack(got), ref)


def _jax_u(key, step, n, free_slots, margin, dtype):
    """The free-sample draws JAX's sampler makes for pose ``step``."""
    return np.asarray(jax.random.uniform(
        jax.random.fold_in(key, step), (n, free_slots), minval=margin,
        maxval=1.0 - margin, dtype=dtype))


@pytest.mark.parametrize("dtype,c", [(np.float64, 1), (np.float64, 4),
                                     (np.float32, 1), (np.float32, 4)])
def test_pose_chunk_body_matches_jax_update_batch_steps(hotel0, dtype, c):
    """(b) The body with the draws JAX's sampler makes injected as ``u``,
    against JAX's ``update_batch_steps`` at ``poses_per_step`` c on the
    same poses, from JAX's initial state: samples used equal; Q_M and
    alpha to 1e-12 of their magnitude at float64, at the float32 map
    tolerances (rtol 1e-3, atol 1e-4) at float32."""
    s = hotel0["setting"]
    jm = jmap.SpGpOccupancyMap(s, hotel0["pseudo"],
                               JaxAabb.from_min_max(hotel0["lo"],
                                                    hotel0["hi"]),
                               seed=SEED, dtype=dtype,
                               free_slots_per_ray=FREE_SLOTS_PER_RAY)
    tm = _map(hotel0, dtype)
    kw = tm._step_kw()
    jst = jm.state
    state = spgp_state_from_numpy({k: np.array(v) for k, v in
                                   jst._asdict().items()}, device="cpu")
    sensors, pts = (hotel0[k].astype(dtype) for k in ("sensors", "pts"))
    jst, jused = jmap.update_batch_steps(
        jst, jm.key, 1, jnp.asarray(sensors), jnp.asarray(pts),
        jnp.asarray(hotel0["masks"]), jm._aabb_min, jm._aabb_max,
        dtype(s.sp_gp.kernel.scale), poses_per_step=c, **kw)
    n_rays = pts.shape[1]
    u = torch.tensor(np.stack([
        _jax_u(jm.key, k + 1, n_rays, FREE_SLOTS_PER_RAY,
               s.free_sampling_margin, dtype) for k in range(POSES)]))
    sp, p, mk = _inputs(tm, hotel0, dtype)
    used = torch.cat([pg.pose_chunk_body(
        state, sp[lo:lo + c], p[lo:lo + c], mk[lo:lo + c], tm._aabb_min,
        tm._aabb_max, tm.sp_gp._scale, u=u[lo:lo + c], **kw)[0]
        for lo in range(0, POSES, c)])
    assert used.tolist() == np.asarray(jused).tolist()
    for name in ("qm", "alpha"):
        ref = np.asarray(getattr(jst, name))
        got = getattr(state, name).numpy()
        if dtype == np.float64:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=F64_TOL * np.abs(ref).max())
        else:
            np.testing.assert_allclose(got, ref, **TOL[np.float32])


@pytest.mark.parametrize("with_grad", [False, True])
def test_predict_step_matches_jax(hotel0, with_grad):
    """(c) Prepare fused with predict, at float64 on a state JAX's map
    updated over the first poses, against JAX's ``predict_step``: mean and
    gradient to 1e-12 of their magnitude."""
    s = hotel0["setting"]
    jm = jmap.SpGpOccupancyMap(s, hotel0["pseudo"],
                               JaxAabb.from_min_max(hotel0["lo"],
                                                    hotel0["hi"]),
                               seed=SEED, dtype=np.float64,
                               free_slots_per_ray=FREE_SLOTS_PER_RAY)
    jm.update_batch(hotel0["sensors"][:3].astype(np.float64),
                    hotel0["pts"][:3].astype(np.float64),
                    hotel0["masks"][:3])
    state = spgp_state_from_numpy({k: np.array(v) for k, v in
                                   jm.state._asdict().items()}, device="cpu")
    tm = _map(hotel0, np.float64)
    xq = hotel0["traj"].astype(np.float64)
    scale = float(s.sp_gp.kernel.scale)
    jmean, jgrad = jmap.predict_step(
        jm.state, jnp.asarray(xq), scale, kernel=tm.sp_gp._kernel,
        diagonal_qm=False, with_grad=with_grad)
    mean, grad = predict_step(state, torch.tensor(xq), scale,
                              kernel=tm.sp_gp._kernel, diagonal_qm=False,
                              with_grad=with_grad)
    pairs = [(mean, jmean)] + ([(grad, jgrad)] if with_grad else [])
    assert (grad is None) == (not with_grad)
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=F64_TOL * np.abs(ref).max())


def test_checkpoint_then_update_equals_uninterrupted(small):
    """(d) state_dict -> load_state_dict into another map -> the remaining
    updates equal the uninterrupted map's, bit for bit."""
    sp, p, mk = small["sensors"], small["pts"], small["masks"]
    a = _map(small)
    a.update_batch(sp, p, mk)
    b = _map(small)
    b.update_batch(sp[:3], p[:3], mk[:3])
    c = _map(small, seed=SEED + 1)
    c.load_state_dict(b.state_dict())
    c.update_batch(sp[3:], p[3:], mk[3:])
    assert c.step == a.step == POSES
    for x, y in zip(a.state, c.state):
        assert torch.equal(x, y)


def test_cpu_map_never_builds_a_graph(small, monkeypatch):
    """(e) A CPU map runs eagerly: no PoseGraphs, and neither a CUDA graph
    nor a capture is ever made, through every entry point."""
    def refuse(*a, **k):
        raise AssertionError("a graph was built for a CPU map")

    monkeypatch.setattr(pg, "capture", refuse)
    monkeypatch.setattr(pg, "PoseGraphs", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    sp, p, mk = small["sensors"], small["pts"], small["masks"]
    m = _map(small)
    assert m._graphs is None
    m.update(sp[0], p[0], mk[0])
    m.update_batch(sp[1:3], p[1:3], mk[1:3], poses_per_step=2)
    m.update_online(sp[3], p[3], mk[3], chunk=2)
    m.predict(small["traj"])
    m.predict(small["traj"], compute_gradient=True)
    assert m._graphs is None and m.step == 4


class _EagerGraph:
    """Stand-in for a captured graph on the CPU: replay runs the captured
    function again (on the same static buffers), so the map's routing,
    buffers, seeding and cache run as they do on the card."""

    def __init__(self, key, run, inputs):
        self.key, self.graph, self.inputs = key, run, inputs
        self.outputs, self.replays = None, 0

    def replay(self):
        self.outputs = self.graph()
        self.replays += 1

    def release(self):
        self.graph, self.inputs, self.outputs = None, (), ()


@pytest.fixture
def eager_graphs(monkeypatch):
    """Maps built in the test get a PoseGraphs on the CPU whose captures
    are :class:`_EagerGraph` (after the warm-up run, as on the card)."""
    def capture(key, device, warm, run, inputs, generators=()):
        warm()
        return _EagerGraph(key, run, inputs)

    monkeypatch.setattr(pg, "capture", capture)

    def graphed(w, **kw):
        m = _map(w, **kw)
        m._graphs = pg.PoseGraphs("cpu")
        return m

    return graphed


@pytest.mark.parametrize("c", [1, 3])
def test_graphed_routing_equals_the_eager_map(small, eager_graphs, c):
    """(f) The graphed routing (static buffers, per-pose generators seeded
    before each replay, the chunk loop with its padding) against the eager
    map, bit for bit: ``update`` pose by pose, ``update_batch`` at c (8
    poses pad to 9 at c = 3), ``collect_datasets``, and ``predict`` with and
    without the gradient; the state is the graphs' buffers."""
    sp, p, mk = small["sensors"], small["pts"], small["masks"]
    ref, got = _map(small), eager_graphs(small)
    for i in range(2):
        assert int(ref.update(sp[i], p[i], mk[i])) == \
            int(got.update(sp[i], p[i], mk[i]))
    assert torch.equal(ref.update_batch(sp[2:], p[2:], mk[2:],
                                        poses_per_step=c),
                       got.update_batch(sp[2:], p[2:], mk[2:],
                                        poses_per_step=c))
    assert got.state.qm is got._graphs.state.qm
    for x, y in zip(ref.state, got.state):
        assert torch.equal(x, y)
    for grad in (False, True):
        for x, y in zip(ref.predict(small["traj"], grad),
                        got.predict(small["traj"], grad)):
            assert (x is None and y is None) or torch.equal(x, y)
    a, b = _map(small), eager_graphs(small)
    ra = a.update_batch(sp, p, mk, collect_datasets=True)
    rb = b.update_batch(sp, p, mk, collect_datasets=True)
    assert torch.equal(ra[0], rb[0])
    for x, y in zip(ra[1], rb[1]):
        assert torch.equal(x, y)


def test_graphed_online_checkpoint_and_cache(small, eager_graphs):
    """(f) ``update_online`` through the graphs equals the eager map; a
    checkpoint loaded into a graphed map is copied into its buffers (the
    state stays the buffers) and continues bit for bit; the graph cache
    keeps MAX_GRAPHS of each kind, the least recently used released; a
    state of another shape gets new buffers and releases every graph."""
    sp, p, mk = small["sensors"], small["pts"], small["masks"]
    ref, got = _map(small), eager_graphs(small)
    for i in range(5):
        ref.update_online(sp[i], p[i], mk[i], chunk=2)
        got.update_online(sp[i], p[i], mk[i], chunk=2)
    q = small["traj"]
    assert torch.equal(ref.predict(q)[0], got.predict(q)[0])
    back = eager_graphs(small, seed=SEED + 1)
    back.update(sp[0], p[0], mk[0])
    buffers = tuple(back._graphs.state)
    back.load_state_dict(got.state_dict())
    assert all(a is b for a, b in zip(back.state, buffers))
    for m in (ref, back):
        m.update_batch(sp[5:], p[5:], mk[5:])
    for x, y in zip(ref.state, back.state):
        assert torch.equal(x, y)
    g = back._graphs
    assert pg.MAX_GRAPHS == 4
    for n in (2, 3, 4, 5, 6, 5):
        back.predict(q[:n])
    assert [k[1] for k in g._predicts] == [3, 4, 6, 5]
    assert len(g.captures) == 1 + 5     # one update shape, five queries
    assert g.captures[1].graph is None and g.captures[1].key[1] == 2
    for c in (4, 2, 3, 5):
        back.update_batch(sp[:4], p[:4], mk[:4], poses_per_step=c)
    assert [k[2] for k in g._updates] == [4, 2, 3, 5]
    kept = list(g._updates.values()) + list(g._predicts.values())
    back.sp_gp.state = SpGpState(*(t[:64, :64] if t.shape[1] > 3 else
                                   t[:64] for t in back.state))
    back._bind()
    assert back.state.qm.shape == (64, 64)
    assert not g._updates and not g._predicts
    assert all(r.graph is None for r in kept)
