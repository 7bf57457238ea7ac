"""The names and keywords of the JAX package that the port took over last,
against the JAX package on the same numpy inputs made from a seed: the
``parallel`` keyword of the SPGP and the occupancy map (the reference's
OpenMP switch, accepted and ignored), ``TriangleMesh.box(inward=)``,
``fitc_delta(reduce=)``, ``kernels.pairwise_dist``,
``is_mixture_setting``, ``kernel_names``, ``Aabb.contains``,
``TriangleMesh.surface_points`` and the ``models`` re-exports of the
functional cores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.kernels as jkernels
import erl_gaussian_process_tpu.models.sparse_pseudo_input_gp as jsp
import erl_gaussian_process_tpu.models.spgp_occupancy_map as jmap
import erl_gaussian_process_tpu_torch.kernels as tkernels
import erl_gaussian_process_tpu_torch.models as tmodels
import erl_gaussian_process_tpu_torch.models.pose_graph as pg
from erl_gaussian_process_tpu.geometry import Aabb as JaxAabb
from erl_gaussian_process_tpu.geometry import simulators as jsim
from erl_gaussian_process_tpu.kernels import KernelSetting as JaxKernelSetting
from erl_gaussian_process_tpu_torch.geometry import Aabb
from erl_gaussian_process_tpu_torch.geometry import simulators as tsim
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import (
    noisy_input_gp,
    sparse_pseudo_input_gp,
    vanilla_gp,
)
from erl_gaussian_process_tpu_torch.utils.convert import spgp_state_from_numpy
from tests.torch_graph_standin import eager_graphs  # noqa: F401

SCALE = 0.7


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _same(a, b) -> bool:
    """Bit for bit: dtype, shape and bytes."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# -- F1: ``parallel`` on the SPGP and its test result -----------------------

def _spgp_pair(rng):
    """JAX's SPGP and two of the port's at float64, 50 pseudo points in 3D
    (tests/test_torch_spgp.py's class setting)."""
    base = dict(kernel_type="matern32", max_num_samples=128)
    js = jsp.SpGpSetting(kernel=JaxKernelSetting(x_dim=3, scale=SCALE),
                         **base)
    ts = sparse_pseudo_input_gp.SpGpSetting(
        kernel=KernelSetting(x_dim=3, scale=SCALE), **base)
    pseudo = rng.uniform(-2, 2, (3, 50))          # (d, M) reference layout
    return (jsp.SparsePseudoInputGaussianProcess(js, pseudo,
                                                 dtype=np.float64),
            *(sparse_pseudo_input_gp.SparsePseudoInputGaussianProcess(
                ts, pseudo, dtype=np.float64, device="cpu")
              for _ in range(2)))


def test_spgp_update_takes_parallel():
    """``update(..., parallel=True)`` accumulates what JAX's does (1e-12
    of each result's magnitude) and what the call without the keyword
    does, bit for bit."""
    rng = np.random.default_rng(0)
    jgp, tgp, plain = _spgp_pair(rng)
    for _ in range(3):
        x = rng.uniform(-2, 2, (3, 90))
        y = rng.uniform(-1, 1, 90)
        var = np.full(90, 1e-2)
        assert jgp.update(x, y, var, parallel=True)
        assert tgp.update(x, y, var, parallel=True)
        assert plain.update(x, y, var)
    for name in ("qm", "alpha", "qm_c", "alpha_c"):
        assert _same(getattr(tgp.state, name), getattr(plain.state, name))
    _close(tgp.mat_qm, jgp.mat_qm, 1e-12)
    _close(tgp.mat_alpha, jgp.mat_alpha, 1e-12)


@pytest.mark.parametrize("getter", ["get_mean", "get_gradient",
                                    "get_variance"])
def test_spgp_test_result_takes_parallel(getter):
    """Each of the test result's getters with ``parallel=True`` returns
    JAX's value (1e-12 of its magnitude) and the port's call without the
    keyword, bit for bit."""
    rng = np.random.default_rng(1)
    jgp, tgp, _ = _spgp_pair(rng)
    x = rng.uniform(-2, 2, (3, 90))
    y = np.sin(x[0]) * np.cos(x[1])
    jgp.update(x, y, 1e-2)
    tgp.update(x, y, 1e-2)
    xq = rng.uniform(-2, 2, (3, 40))
    jr, tr = jgp.test(xq, True), tgp.test(xq, True)
    args = () if getter == "get_variance" else (0,)
    got = getattr(tr, getter)(*args, parallel=True)
    assert _same(got, getattr(tr, getter)(*args))
    _close(got, getattr(jr, getter)(*args, parallel=True), 1e-12)


# -- F1: ``parallel`` on the occupancy map -----------------------------------

def _map_setting(mod):
    ks = (JaxKernelSetting if mod is jmap else KernelSetting)(x_dim=2,
                                                              scale=0.4)
    sp = (jsp.SpGpSetting if mod is jmap else
          sparse_pseudo_input_gp.SpGpSetting)(
        kernel_type="matern32", kernel=ks, max_num_samples=256)
    return mod.SpGpOccupancyMapSetting(
        sp_gp=sp, min_distance=0.0, max_distance=5.0,
        free_points_per_meter=2.0, free_sampling_margin=0.02,
        logodd_free=-1.0, logodd_occupied=1.0, logodd_variance=1e-4)


def _maps(graphed: bool):
    """JAX's 2D map (8 x 8 pseudo points, float64) after 8 poses, and two
    port maps holding its state (``graphed``: the second one routes through
    ``PoseGraphs`` on the CPU)."""
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        SpGpOccupancyMap,
    )

    c = np.linspace(-2, 2, 8)
    grid = np.stack([a.ravel() for a in np.meshgrid(c, c, indexing="ij")])
    jm = jmap.SpGpOccupancyMap(_map_setting(jmap), grid,
                               JaxAabb.from_min_max([-2, -2], [2, 2]),
                               seed=0, dtype=np.float64, free_slots_per_ray=4)
    rng = np.random.default_rng(2)
    ang = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    ring = 1.5 * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    for _ in range(8):
        jm.update(rng.uniform(-0.3, 0.3, 2), ring)
    st = {k: np.array(v) for k, v in jm.state._asdict().items()}
    maps = []
    for _ in range(2):
        m = SpGpOccupancyMap(_map_setting(tmodels.spgp_occupancy_map), grid,
                             Aabb.from_min_max([-2, -2], [2, 2]), seed=0,
                             dtype=np.float64, free_slots_per_ray=4,
                             device="cpu")
        m.sp_gp.state = spgp_state_from_numpy(st, device="cpu")
        m.sp_gp.invalidate()
        maps.append(m)
    if graphed:
        maps[1]._graphs = pg.PoseGraphs("cpu")
    return jm, *maps


@pytest.mark.parametrize("graphed", [False, True])
def test_map_predict_takes_parallel(eager_graphs, graphed):  # noqa: F811
    """``predict`` (positional after ``compute_gradient``, as in JAX) and
    ``predict_gradient`` with ``parallel=True``: JAX's values (1e-10 of
    their magnitude), and the port's call without the keyword bit for bit,
    eager and through the map's graphs."""
    jm, ref, m = _maps(graphed)
    q = np.random.default_rng(3).uniform(-1.8, 1.8, (50, 2))
    for grad in (False, True):
        jlo, jg = jm.predict(q, grad, True)
        lo, g = m.predict(q, grad, True)
        rlo, rg = ref.predict(q, grad)
        assert _same(lo, rlo)
        _close(lo, jlo, 1e-10)
        assert (g is None) == (jg is None) == (not grad)
        if grad:
            assert _same(g, rg)
            _close(g, jg, 1e-10)
    g = m.predict_gradient(q, parallel=True)
    assert _same(g, ref.predict_gradient(q))
    _close(g, jm.predict_gradient(q, parallel=True), 1e-10)
    if graphed:
        assert len(m._graphs._predicts) == 2 and len(eager_graphs) == 2


# -- F2: ``TriangleMesh.box(inward=)`` ----------------------------------------

@pytest.mark.parametrize("inward", [False, True])
def test_box_takes_inward(inward):
    lo, hi = [-3.0, -2.5, -1.5], [3.0, 2.5, 1.5]
    got = tsim.TriangleMesh.box(lo, hi, inward=inward)
    ref = jsim.TriangleMesh.box(lo, hi, inward=inward)
    for name in ("vertices", "faces", "triangles"):
        assert _same(getattr(got, name), getattr(ref, name))
    assert _same(got.vertices, tsim.TriangleMesh.box(lo, hi).vertices)


# -- ``fitc_delta(reduce=)`` ---------------------------------------------------

@pytest.mark.parametrize("diagonal_qm", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fitc_delta_reduce(dtype, diagonal_qm):
    """``reduce`` wraps both accumulated products, as JAX's does: against
    JAX at float64 to 1e-12 of the magnitude, at float32 to the Pallas
    FITC parity test's 2e-3 (var 0.1, tests/test_torch_fitc.py); and the
    port's call with ``lambda t: 3 * t`` is 3 x the call without,
    exactly."""
    rng = np.random.default_rng(4)
    pseudo = rng.uniform(-2, 2, (60, 3)).astype(dtype)
    x = rng.uniform(-2, 2, (150, 3)).astype(dtype)
    y = rng.uniform(-1, 1, (150, 2)).astype(dtype)
    var = np.full(150, 0.1 if dtype == np.float32 else 1e-2, dtype)
    mask = rng.uniform(size=150) < 0.8
    st = jsp.spgp_init(jnp.asarray(pseudo), dtype(SCALE), kernel="matern32")
    l_inv = st.L_inv if dtype == np.float32 else None
    kw = dict(kernel="matern32", diagonal_qm=diagonal_qm)
    jref = jsp.fitc_delta(st.pseudo, st.L_km, *map(jnp.asarray, (
        x, y, var, mask)), dtype(SCALE), reduce=lambda t: 3 * t,
        L_inv=l_inv, **kw)
    args = [torch.tensor(np.asarray(a)) for a in (st.pseudo, st.L_km, x, y,
                                                   var, mask)]
    t_inv = None if l_inv is None else torch.tensor(np.asarray(l_inv))
    got = sparse_pseudo_input_gp.fitc_delta(
        *args, SCALE, reduce=lambda t: 3 * t, L_inv=t_inv, **kw)
    once = sparse_pseudo_input_gp.fitc_delta(*args, SCALE, L_inv=t_inv,
                                             **kw)
    for g, o, r in zip(got, once, jref):
        assert g.dtype == torch.from_numpy(np.empty(0, dtype)).dtype
        assert torch.equal(g, 3 * o)
        if dtype == np.float64:
            _close(g, r, 1e-12)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3,
                                       atol=2e-3)


# -- ``kernels`` ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [((7, 1), (5, 1)), ((40, 3), (33, 3))])
def test_pairwise_dist(shape):
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(-2, 2, s) for s in shape)
    got = tkernels.pairwise_dist(torch.tensor(a), torch.tensor(b))
    ref = np.asarray(jkernels.pairwise_dist(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    assert float(tkernels.pairwise_dist(torch.tensor(a),
                                        torch.tensor(a)).diagonal().abs()
                 .max()) == 0.0


@pytest.mark.parametrize("weights,scale_mix", [([], 1.0), ([1.0, 0.5], 2.0),
                                               ((0.3,), 1.0)])
def test_is_mixture_setting(weights, scale_mix):
    got = tkernels.is_mixture_setting(KernelSetting(
        x_dim=2, scale=0.5, scale_mix=scale_mix, weights=list(weights)))
    ref = jkernels.is_mixture_setting(JaxKernelSetting(
        x_dim=2, scale=0.5, scale_mix=scale_mix, weights=list(weights)))
    assert got is ref is (len(weights) > 0)


def test_kernel_names():
    """The same sorted list, the families and then a mixture registered in
    both packages."""
    assert tkernels.kernel_names() == jkernels.kernel_names()
    assert {"rbf", "ou", "matern32"} <= set(tkernels.kernel_names())
    name = tkernels.register_scale_mixture("rbf", 1.7, (1.0, 0.25))
    assert name == jkernels.register_scale_mixture("rbf", 1.7, (1.0, 0.25))
    assert name in tkernels.kernel_names()
    assert tkernels.kernel_names() == jkernels.kernel_names()


# -- ``geometry`` ----------------------------------------------------------------

def test_aabb_contains():
    """Points inside, outside and exactly on each face and corner."""
    lo, hi = [-1.0, -2.0, 0.5], [2.0, 1.0, 3.0]
    rng = np.random.default_rng(6)
    pts = [rng.uniform(-3, 4, (200, 3))]
    for axis in range(3):
        for bound, outward in ((lo, -np.inf), (hi, np.inf)):
            on = rng.uniform(lo, hi, (5, 3))
            on[:, axis] = bound[axis]
            off = on.copy()
            off[:, axis] = np.nextafter(bound[axis], outward)
            pts += [on, off]
    pts += [np.array([lo, hi, [lo[0], hi[1], lo[2]]])]
    pts = np.concatenate(pts)
    got = Aabb.from_min_max(lo, hi).contains(pts)
    ref = JaxAabb.from_min_max(lo, hi).contains(pts)
    assert got.dtype == bool and got.shape == (len(pts),)
    assert _same(got, ref)
    assert got.any() and not got.all()
    assert Aabb.from_min_max(lo, hi).contains(np.array([lo, hi])).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_surface_points(seed):
    """The same draws from the same ``rng``: bit for bit, on the room the
    3D protocols use and on a hotel-sized mesh."""
    for mesh in ("reference_room_mesh_3d", "replica_hotel_like_mesh"):
        got = getattr(tsim, mesh)().surface_points(4, rng=seed)
        ref = getattr(jsim, mesh)().surface_points(4, rng=seed)
        assert got.shape == (4 * getattr(tsim, mesh)().num_triangles, 3)
        assert _same(got, ref)


# -- ``models`` re-exports ----------------------------------------------------

@pytest.mark.parametrize("name,module", [
    ("vanilla_fit", vanilla_gp), ("nigp_fit", noisy_input_gp),
    ("spgp_init", sparse_pseudo_input_gp),
    ("spgp_update", sparse_pseudo_input_gp)])
def test_models_reexport_the_functional_cores(name, module):
    assert getattr(tmodels, name) is getattr(module, name)
    assert name in tmodels.__all__
