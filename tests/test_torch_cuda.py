"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without an NVIDIA
GPU. This file imports neither JAX nor the JAX package, so it runs on a
machine that has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from erl_gaussian_process_tpu_torch.geometry import Aabb
from erl_gaussian_process_tpu_torch.kernels import (
    KernelSetting,
    register_scale_mixture,
)
from erl_gaussian_process_tpu_torch.models import (
    SpGpOccupancyMap,
    SpGpOccupancyMapSetting,
    SpGpSetting,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    pad_pseudo_points,
    spgp_init,
)
from erl_gaussian_process_tpu_torch.ops import (
    bank_cholesky_solve_cuda,
    bank_cholesky_solve_plain,
    bank_fit_cuda,
    bank_fit_plain,
    cross_gram_batched_cuda,
    cross_gram_cuda,
    cross_gram_plain,
    fitc_update_cuda,
    fitc_update_plain,
    launch_counts,
)
from erl_gaussian_process_tpu_torch.utils.backend import (
    probe_backend,
    probe_backend_subprocess,
    require_backend,
)

pytestmark = pytest.mark.cuda
FAMILIES = ["rbf", "ou", "matern32", "mixture"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with python -m "
                    "pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda")


def _name(fam):
    return register_scale_mixture("matern32", 1.5, (1.0, 2.0, 0.5)) \
        if fam == "mixture" else fam


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("fam", FAMILIES)
def test_gram_kernel_matches_plain(cuda, fam, dtype, tol):
    """Ragged (1152, 1000) with far-point padded rows, which stay 0."""
    rng = np.random.default_rng(3)
    x1 = torch.as_tensor(pad_pseudo_points(rng.uniform(-3, 3, (1089, 3))),
                         dtype=dtype, device=cuda)
    x2 = torch.as_tensor(rng.uniform(-3, 3, (1000, 3)), dtype=dtype,
                         device=cuda)
    before = launch_counts()["gram"]
    k = cross_gram_cuda(_name(fam), x1, x2, 0.6)
    torch.cuda.synchronize()
    assert launch_counts()["gram"] == before + 1
    ref = cross_gram_plain(_name(fam), x1, x2, 0.6)
    assert float((k - ref).abs().max()) <= tol
    assert (k[1089:] == 0).all()


GRAM_TOL = [(torch.float32, 1e-6), (torch.float64, 1e-12)]


def _gram_operands(cuda, dtype, m, n, d, seed=11, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    x1 = torch.as_tensor(rng.uniform(-1.5, 1.5, lead + (m, d)), dtype=dtype,
                         device=cuda)
    x2 = torch.as_tensor(rng.uniform(-1.5, 1.5, lead + (n, d)), dtype=dtype,
                         device=cuda)
    mask = torch.as_tensor(rng.uniform(size=lead + (m,)) < 0.7, device=cuda)
    return x1, x2, mask


def _gram_err(k, ref):
    return float((k - ref).abs().max())


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8, 9])
@pytest.mark.parametrize("dtype,tol", GRAM_TOL)
@pytest.mark.parametrize("fam", FAMILIES)
def test_gram_kernel_every_dimension(cuda, fam, dtype, tol, d):
    """d <= 8 runs the kernel's unrolled instantiation, d = 9 its runtime-d
    one; a masked and an unmasked call, each against the plain version."""
    x1, x2, mask = _gram_operands(cuda, dtype, 193, 301, d)
    for m1 in (None, mask):
        k = cross_gram_cuda(_name(fam), x1, x2, 0.7, m1)
        torch.cuda.synchronize()
        assert _gram_err(k, cross_gram_plain(_name(fam), x1, x2, 0.7, m1)) \
            <= tol


@pytest.mark.parametrize("n", [1, 62, 63, 64, 65, 129])
@pytest.mark.parametrize("m", [1, 63, 65, 129])
@pytest.mark.parametrize("dtype,tol", GRAM_TOL)
def test_gram_kernel_ragged_and_misaligned_rows(cuda, dtype, tol, m, n):
    """Ragged edges in both directions and every n % 4: rows whose start
    misses 16-byte alignment take the kernel's shifted store windows. In a
    batch of 3 members each member's base is misaligned too when m n is
    odd. Every element is written: a NaN-filled block of the output's size
    is freed just before the call, for the allocator to hand it out
    again."""
    for batch in (None, 3):
        x1, x2, mask = _gram_operands(cuda, dtype, m, n, 2, batch=batch)
        fn = cross_gram_cuda if batch is None else cross_gram_batched_cuda
        for m1 in (None, mask):
            stale = torch.full((batch or 1, m, n), float("nan"), dtype=dtype,
                               device=cuda)
            del stale
            k = fn("matern32", x1, x2, 0.5, m1)
            torch.cuda.synchronize()
            ref = cross_gram_plain("matern32", x1, x2, 0.5, m1)
            assert bool(torch.isfinite(k).all())
            assert _gram_err(k, ref) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("masks", ["none", "all_false", "random"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_gram_kernel_row_mask(cuda, fam, masks, dtype):
    """Masked rows are exactly +0.0, NaN coordinates in them included (the
    semantics of torch.where(mask1[:, None], k, 0)); the other rows match
    the plain version."""
    tol = dict(GRAM_TOL)[dtype]
    x1, x2, mask = _gram_operands(cuda, dtype, 130, 257, 3)
    if masks == "none":
        mask = None
    else:
        if masks == "all_false":
            mask = torch.zeros_like(mask)
        mask[5] = False
        x1[5, 1] = float("nan")
    k = cross_gram_cuda(_name(fam), x1, x2, 0.5, mask)
    torch.cuda.synchronize()
    if mask is None:
        ref = cross_gram_plain(_name(fam), x1, x2, 0.5)
        assert _gram_err(k, ref) <= tol
        return
    off = ~mask
    assert bool((k[off] == 0).all()) and not bool(torch.signbit(k[off]).any())
    ref = cross_gram_plain(_name(fam), x1, x2, 0.5, mask)
    if bool(mask.any()):
        assert _gram_err(k[mask], ref[mask]) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fam", FAMILIES)
def test_gram_kernel_far_point_rows_are_zero(cuda, fam, dtype):
    """Far-point padded pseudo points (~1e17) give exactly +0.0 against data
    and against each other."""
    rng = np.random.default_rng(12)
    P = torch.as_tensor(pad_pseudo_points(rng.uniform(-3, 3, (100, 3))),
                        dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.uniform(-5, 5, (67, 3)), dtype=dtype,
                        device=cuda)
    k = cross_gram_cuda(_name(fam), P, x, 0.5)
    kp = cross_gram_cuda(_name(fam), P[100:].contiguous(),
                         P[100:].contiguous(), 0.5)
    torch.cuda.synchronize()
    off = ~torch.eye(28, dtype=torch.bool, device=cuda)
    assert bool((k[100:] == 0).all()) and not bool(
        torch.signbit(k[100:]).any())
    assert bool((kp[off] == 0).all())


def test_gram_kernel_batch_over_65535_members(cuda):
    """More members than a grid's y or z axis takes, in one launch."""
    x1, x2, mask = _gram_operands(cuda, torch.float32, 3, 5, 2,
                                  batch=70_001)
    before = launch_counts()["gram_batched"]
    k = cross_gram_batched_cuda("ou", x1, x2, 0.4, mask)
    torch.cuda.synchronize()
    assert launch_counts()["gram_batched"] == before + 1
    assert _gram_err(k, cross_gram_plain("ou", x1, x2, 0.4, mask)) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_kernel_is_deterministic(cuda, dtype):
    """Two calls agree bit for bit."""
    x1, x2, mask = _gram_operands(cuda, dtype, 1000, 999, 3)
    a = cross_gram_cuda(_name("mixture"), x1, x2, 0.6, mask)
    b = cross_gram_cuda(_name("mixture"), x1, x2, 0.6, mask)
    assert torch.equal(a, b)


def _fitc_args(cuda, dtype, m, n, var, seed=5):
    rng = np.random.default_rng(seed)
    half = 2.0 * (m / 128.0) ** (1 / 3)
    st = spgp_init(torch.as_tensor(rng.uniform(-half, half, (m, 3)),
                                   dtype=dtype, device=cuda), 0.6,
                   kernel="matern32")

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    return ("matern32", st.pseudo, st.L_inv,
            t(rng.uniform(-2, 2, (n, 3))), t(rng.uniform(-1, 1, (n, 2))),
            t(np.full(n, var)),
            torch.as_tensor(rng.uniform(size=n) < 0.8, device=cuda), 0.6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(1152, 2048), (1089, 1500), (70, 33),
                                 (1152, 2000)])
def test_fitc_kernel_matches_plain(cuda, dtype, m, n):
    """Ragged shapes included (the kernel masks its own edges; n = 1500 and
    2000 are not multiples of the SYRK's split chunk); dQ exactly
    symmetric; one launch counted; float32 at var = 0.1 to 1e-4 and
    float64 at var = 1e-4 to 1e-10 of the result's magnitude."""
    var, tol = (0.1, 1e-4) if dtype == torch.float32 else (1e-4, 1e-10)
    args = _fitc_args(cuda, dtype, m, n, var)
    before = launch_counts()["fitc"]
    dq, da = fitc_update_cuda(*args)
    torch.cuda.synchronize()
    assert launch_counts()["fitc"] == before + 1
    dq_ref, da_ref = fitc_update_plain(*args)
    assert float((dq - dq_ref).abs().max() / dq_ref.abs().max()) <= tol
    assert float((da - da_ref).abs().max() / da_ref.abs().max()) <= tol
    assert torch.equal(dq, dq.T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fitc_kernel_is_deterministic(cuda, dtype):
    """No float atomics (an integer counter picks which block sums a
    tile's split partials, never their order): two launches on the same
    inputs agree bit for bit, and dQ is exactly symmetric."""
    args = _fitc_args(cuda, dtype, 1152, 2048, 1e-4)
    a = fitc_update_cuda(*args)
    b = fitc_update_cuda(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], a[0].T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fitc_kernel_all_masked_is_zero(cuda, dtype):
    """A pose whose samples are all masked adds exactly nothing."""
    args = list(_fitc_args(cuda, dtype, 1089, 1500, 1e-4))
    args[6] = torch.zeros_like(args[6])
    dq, da = fitc_update_cuda(*args)
    assert not dq.any() and not da.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fitc_kernel_far_point_rows_are_zero(cuda, dtype):
    """The map's far-point padded pseudo points (1089 padded to 1152) give
    rows and columns of dQ and rows of dalpha that are exactly 0."""
    rng = np.random.default_rng(6)
    pseudo = torch.as_tensor(pad_pseudo_points(rng.uniform(-2, 2, (1089, 3))),
                             dtype=dtype, device=cuda)
    st = spgp_init(pseudo, 0.6, kernel="matern32")
    args = list(_fitc_args(cuda, dtype, 1152, 2048, 0.1))
    args[1:3] = [st.pseudo, st.L_inv]
    dq, da = fitc_update_cuda(*args)
    dq_ref, da_ref = fitc_update_plain(*args)
    assert (dq[1089:] == 0).all() and (dq[:, 1089:] == 0).all()
    assert (da[1089:] == 0).all()
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((dq - dq_ref).abs().max() / dq_ref.abs().max()) <= tol


def test_fitc_kernel_f32_at_the_map_variance_against_f64(cuda):
    """At the main path's variance (1e-4), where 1/(lambda + var) amplifies
    float32 rounding: the float32 kernel's relative errors in dQ and
    dalpha against the float64 update of the same inputs are no worse than
    2x the float32 plain version's."""
    args = _fitc_args(cuda, torch.float32, 1152, 2048, 1e-4)
    st64 = spgp_init(args[1].double(), 0.6, kernel="matern32")
    truth = fitc_update_plain("matern32", st64.pseudo, st64.L_inv,
                              *(t.double() for t in args[3:6]), args[6], 0.6)

    def rel(got):
        return [float((g.double() - t).abs().max() / t.abs().max())
                for g, t in zip(got, truth)]

    kernel, plain = rel(fitc_update_cuda(*args)), rel(fitc_update_plain(*args))
    assert all(k <= 2 * p for k, p in zip(kernel, plain)), (kernel, plain)


def _device_kernels(fn):
    """{kernel name: launches} of ``fn()`` on the card, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(1152, 2048), (70, 33)])
def test_fitc_kernel_launches_as_planned(cuda, dtype, m, n):
    """One call is the plan's launches on the card and nothing else (no
    memset of the workspace or the counters)."""
    from erl_gaussian_process_tpu_torch.ops.fitc import fitc_plan

    args = _fitc_args(cuda, dtype, m, n, 0.1)
    fitc_update_cuda(*args)                      # build and warm up
    kernels = _device_kernels(lambda: fitc_update_cuda(*args))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sum(kernels.values()) == fitc_plan(m, n, sms).launches == 3, \
        kernels


def test_wrappers_raise_on_operands_the_kernels_do_not_take(cuda):
    args = list(_fitc_args(cuda, torch.float32, 128, 64, 0.1))
    bad_linv = args[2].T                                   # strided
    with pytest.raises(ValueError, match="contiguous"):
        fitc_update_cuda(*args[:2], bad_linv, *args[3:])
    with pytest.raises(ValueError, match="bool"):
        fitc_update_cuda(*args[:6], args[6].to(torch.uint8), args[7])
    with pytest.raises(TypeError, match="mixed dtypes"):
        fitc_update_cuda(*args[:3], args[3].double(), *args[4:])
    with pytest.raises(ValueError, match="shapes"):
        fitc_update_cuda(*args[:5], args[5][:10], *args[6:])
    x = torch.ones((4, 3), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 and float64"):
        cross_gram_cuda("rbf", x, x, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        cross_gram_cuda("rbf", x.float(), x.float().cpu(), 1.0)


def test_map_on_the_card_batch_equals_sequential(cuda):
    """A small float32 map on the card: every update runs the FITC kernel
    once (a graph replay; the wrappers' count adds one eager warm-up run
    a captured graph, models/pose_graph.py), the batch replay equals the
    pose-by-pose updates bit for bit, and predict launches the gram
    kernel."""
    setting = SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=3, scale=0.5),
                          max_num_samples=512),
        min_distance=0.05, max_distance=10.0, free_points_per_meter=2.0,
        free_sampling_margin=0.02, logodd_free=-1.0, logodd_occupied=1.0,
        logodd_variance=1e-4)
    c = np.linspace(-2, 2, 6)
    pseudo = np.stack([a.ravel() for a in np.meshgrid(c, c, c,
                                                      indexing="ij")])
    rng = np.random.default_rng(0)
    b, rays = 4, 200
    sensors = rng.uniform(-0.3, 0.3, (b, 3))
    d = rng.normal(size=(b, rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = sensors[:, None, :] + 1.5 * d

    def make():
        return SpGpOccupancyMap(setting, pseudo, Aabb.from_min_max(
            [-2] * 3, [2] * 3), seed=3, dtype=np.float32,
            free_slots_per_ray=4, device=cuda)

    seq, bat = make(), make()
    before = launch_counts()
    for i in range(b):
        seq.update(sensors[i], pts[i])
    bat.update_batch(sensors, pts)
    lo, _ = bat.predict(np.zeros((5, 3)))
    after = launch_counts()
    graphs = [g for m in (seq, bat) for g in m._graphs.captures
              if g.key[0] == "update"]
    assert sum(g.replays * g.launches[fitc_update_cuda] for g in graphs) \
        == 2 * b
    assert after["fitc"] - before["fitc"] == 2 * b + len(graphs)
    assert after["gram"] > before["gram"]
    for x, y in zip(seq.state, bat.state):
        assert torch.equal(x, y)
    assert lo.is_cuda and bool((lo < 0).all())


def _graph_map_case(cuda, dtype, b=6, rays=150):
    setting = SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=3, scale=0.5),
                          max_num_samples=512),
        min_distance=0.05, max_distance=10.0, free_points_per_meter=2.0,
        free_sampling_margin=0.02, logodd_free=-1.0, logodd_occupied=1.0,
        logodd_variance=1e-4)
    c = np.linspace(-2, 2, 6)
    pseudo = np.stack([a.ravel() for a in np.meshgrid(c, c, c,
                                                      indexing="ij")])
    rng = np.random.default_rng(1)
    sensors = rng.uniform(-0.3, 0.3, (b, 3))
    d = rng.normal(size=(b, rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = sensors[:, None, :] + rng.uniform(1.2, 1.8, (b, rays, 1)) * d
    masks = rng.uniform(size=(b, rays)) < 0.9

    def make(seed=3):
        return SpGpOccupancyMap(setting, pseudo, Aabb.from_min_max(
            [-2] * 3, [2] * 3), seed=seed, dtype=dtype,
            free_slots_per_ray=4, device=cuda)

    return make, sensors.astype(dtype), pts.astype(dtype), masks


def _eager_chain(m, sensors, pts, masks, c=1):
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        update_batch_steps,
    )

    b = len(sensors)
    pad = -b % c
    p = np.where(masks[..., None], pts, 0)
    sp, mk = sensors, masks
    if pad:
        sp = np.concatenate([sp, np.zeros((pad, 3), sp.dtype)])
        p = np.concatenate([p, np.zeros((pad,) + p.shape[1:], p.dtype)])
        mk = np.concatenate([mk, np.zeros((pad, mk.shape[1]), bool)])
    st, used = update_batch_steps(
        m.state, m.seed, 1, m._tensor(sp), m._tensor(p),
        torch.as_tensor(mk, device=m.device), m._aabb_min, m._aabb_max,
        m.sp_gp._scale, generator=torch.Generator(device=m.device),
        poses_per_step=c, **m._step_kw())
    return st, used[:b]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("c", [1, 4])
def test_map_graphs_equal_the_eager_chain(cuda, dtype, c):
    """The map's CUDA graphs against the eager functional chain
    (update_batch_steps, the same kernels launched one by one), bit for
    bit: pose by pose through update, the batch through update_batch at
    poses_per_step c (6 poses pad to 8 at c = 4), the samples used; the
    graphed predict, with and without the gradient, against the eager
    predict of the same prepare; the state is the graphs' buffers."""
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        predict_prepared_step,
    )

    make, sensors, pts, masks = _graph_map_case(cuda, dtype)
    ref, ref_used = _eager_chain(make(), sensors, pts, masks, c)
    bat = make()
    used = bat.update_batch(sensors, pts, masks, poses_per_step=c)
    assert bat.state.qm is bat._graphs.state.qm
    assert torch.equal(used, ref_used)
    for name in ("qm", "alpha", "qm_c", "alpha_c"):
        assert torch.equal(getattr(bat.state, name), getattr(ref, name))
    if c == 1:
        seq = make()
        seq_used = torch.stack([seq.update(sensors[i], pts[i], masks[i])
                                for i in range(len(sensors))])
        assert torch.equal(seq_used, ref_used)
        for x, y in zip(seq.state, bat.state):
            assert torch.equal(x, y)
    q = np.random.default_rng(2).uniform(-1.5, 1.5, (77, 3)).astype(dtype)
    for grad in (False, True):
        got = bat.predict(q, grad)
        mean, g = predict_prepared_step(
            bat.state, *bat.sp_gp._prepared(), bat._tensor(q),
            bat.sp_gp._scale, kernel=bat.sp_gp._kernel, with_grad=grad)
        assert torch.equal(got[0], mean[:, 0])
        assert (got[1] is None) == (not grad)
        if grad:
            assert torch.equal(got[1], g[:, :, 0])


def test_graphed_predict_ignores_the_parallel_keyword(cuda):
    """``predict``/``predict_gradient`` with ``parallel`` (the reference's
    OpenMP switch, ignored) replay the graph the call without it replays,
    bit for bit."""
    make, sensors, pts, masks = _graph_map_case(cuda, np.float32)
    m = make()
    m.update_batch(sensors, pts, masks)
    q = np.random.default_rng(5).uniform(-1.5, 1.5, (77, 3)).astype(
        np.float32)
    for grad in (False, True):
        ref = m.predict(q, grad)
        for parallel in (True, False):
            got = m.predict(q, grad, parallel)
            assert torch.equal(got[0], ref[0])
            assert (got[1] is None) == (not grad)
            if grad:
                assert torch.equal(got[1], ref[1])
    assert torch.equal(m.predict_gradient(q, parallel=True),
                       m.predict_gradient(q))
    assert len(m._graphs._predicts) == 2


def test_require_backend_on_the_card(cuda):
    """The deadline-bounded probe initializes CUDA and adds on cuda:0, in
    this process and in a child interpreter."""
    assert require_backend() == "gpu"
    assert probe_backend(30.0) == (True, "gpu")
    assert probe_backend_subprocess(120.0) == (True, "gpu")


def test_graphed_pose_makes_no_synchronising_call(cuda):
    """Once its graph is captured, an update is host work, input copies
    and one replay: nothing waits for the card."""
    make, sensors, pts, masks = _graph_map_case(cuda, np.float32)
    m = make()
    m.update(sensors[0], pts[0], masks[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(1, 3):
            m.update(sensors[i], pts[i], masks[i])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert m.step == 3


def test_graph_replays_run_the_fitc_kernels(cuda):
    """A graphed pose runs FITC's 3 kernels (torch.profiler) and adds the
    graph's captured launches to the count: one FITC call a replay."""
    make, sensors, pts, masks = _graph_map_case(cuda, np.float32)
    m = make()
    m.update(sensors[0], pts[0], masks[0])
    before = launch_counts()["fitc"]
    kernels = _device_kernels(lambda: [m.update(sensors[i], pts[i],
                                                masks[i])
                                       for i in range(1, 4)])
    fitc = sum(n for k, n in kernels.items()
               if any(f in k for f in ("kmn_kernel", "beta_tc_kernel",
                                       "syrk_tc_kernel")))
    assert fitc == 3 * 3, kernels
    assert launch_counts()["fitc"] - before == 3


def test_graphed_map_checkpoint_continues_bitwise(cuda):
    """A checkpoint loaded into a graphed map is copied into its buffers
    and the map continues bit for bit like the one it came from; the
    graphs it had captured stay (same shapes)."""
    make, sensors, pts, masks = _graph_map_case(cuda, np.float32)
    a = make()
    a.update_batch(sensors[:3], pts[:3], masks[:3])
    b = make(seed=9)
    b.update(sensors[0], pts[0], masks[0])
    captured = len(b._graphs.captures)
    buffers = tuple(b._graphs.state)
    b.load_state_dict(a.state_dict())
    assert all(x is y for x, y in zip(b.state, buffers))
    for m in (a, b):
        m.update_batch(sensors[3:], pts[3:], masks[3:])
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert len(b._graphs.captures) == captured


def _bank_args(cuda, dtype, b, n, seed=0, q=2):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    return (t(rng.normal(size=(b, n, 2))), t(rng.normal(size=(b, n, q))),
            t(0.01 + 0.1 * rng.random((b, n))),
            torch.as_tensor(rng.random((b, n)) < 0.9, device=cuda))


def _bank_errors(got, ref):
    L, L_inv, alpha = got
    L_ref, _, a_ref = ref
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return (float((L - L_ref).abs().max()),
            float((alpha - a_ref).abs().max() / a_ref.abs().max()),
            float((L_inv @ L_ref - eye).abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("n", [1, 12, 15, 16, 17, 100, 144, 320, 321, 512])
@pytest.mark.parametrize("fam", FAMILIES)
def test_bank_fit_kernel_matches_plain(cuda, fam, n, dtype, tol):
    """float32 up to n = 320 on the blocked tensor-core kernel (sizes on
    and off its 16-grid), the elimination beyond and at float64 (both slab
    placements); masks that are not prefixes, B off any grid; one launch
    counted; L, alpha and L^{-1} L against the plain version; L exactly
    lower triangular."""
    b = 37 if n < 320 else 5
    args = _bank_args(cuda, dtype, b, n)
    before = launch_counts()["bank_fit"]
    got = bank_fit_cuda(_name(fam), *args, 0.7)
    torch.cuda.synchronize()
    assert launch_counts()["bank_fit"] == before + 1
    assert max(_bank_errors(got, bank_fit_plain(_name(fam), *args,
                                                0.7))) <= tol
    assert (torch.triu(got[0], 1) == 0).all()


@pytest.mark.parametrize("n", [100, 144, 321])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bank_fit_non_spd_member_is_nan(cuda, dtype, n):
    """A negative variance makes one member indefinite: it comes out all
    NaN in L, L^{-1} and alpha (never clamped), its neighbours bit for bit
    unchanged."""
    x, y, v, m = _bank_args(cuda, dtype, 7, n)
    ok = bank_fit_cuda("ou", x, y, v, m, 0.7)
    v[3, m[3].nonzero()[0]] = -50.0
    bad = bank_fit_cuda("ou", x, y, v, m, 0.7)
    rest = [0, 1, 2, 4, 5, 6]
    for a, b in zip(bad, ok):
        assert torch.isnan(a[3]).all()
        assert torch.equal(a[rest], b[rest])


def test_bank_fit_kernel_is_deterministic_and_batch_independent(cuda):
    """Two launches agree bit for bit; a member fit alone, or in a bank of
    736 (6 members a block instead of 8), equals the same member inside a
    bank of 2208: L, L^{-1} and alpha, which the kernel forms itself with
    no solve outside it; float32 (blocked) and float64 (elimination)."""
    for dtype in (torch.float32, torch.float64):
        x, y, v, m = _bank_args(cuda, dtype, 3 * 736, 100)
        a = bank_fit_cuda("ou", x, y, v, m, 0.3)
        b = bank_fit_cuda("ou", x, y, v, m, 0.3)
        alone = bank_fit_cuda("ou", *(t[736:1472].contiguous()
                                      for t in (x, y, v, m)), 0.3)
        single = bank_fit_cuda("ou", *(t[800:801].contiguous()
                                       for t in (x, y, v, m)), 0.3)
        for p, q, r, s in zip(a, b, alone, single):
            assert torch.equal(p, q)
            assert torch.equal(r, p[736:1472])
            assert torch.equal(s[0], p[800])


@pytest.mark.parametrize("n", [17, 100, 144, 321])
def test_bank_fit_all_masked_member_is_identity(cuda, n):
    """A member with every row masked comes out L = I, L^{-1} = I and
    alpha = 0 exactly, beside members masked elsewhere than a suffix."""
    x, y, v, m = _bank_args(cuda, torch.float32, 9, n)
    m[4] = False
    m[5, ::3] = False
    L, Li, a = bank_fit_cuda("matern32", x, y, v, m, 0.7)
    eye = torch.eye(n, device=cuda)
    assert torch.equal(L[4], eye) and torch.equal(Li[4], eye)
    assert not a[4].any()
    assert not a[5, ::3].any()
    ref = bank_fit_plain("matern32", x, y, v, m, 0.7)
    assert max(_bank_errors((L, Li, a), ref)) <= 1e-4


def test_bank_fit_plan_on_the_card(cuda):
    """The plan at the sensor GP's shapes spreads the bank over the SMs (6
    members of n = 100 a block for 736, 4 of n = 144 for 408, 8 for a
    64-scan replay), and the C entry's shared-memory arithmetic matches
    member_tiles: the plan's largest count that fits launches, one more is
    refused."""
    from erl_gaussian_process_tpu_torch.ops.bank import (
        MAX_MEMBERS_PER_BLOCK,
        bank_chol_plan,
        member_tiles,
        smem_optin,
    )

    dev = cuda.index or 0
    smem = smem_optin(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, b, expect in ((100, 736, 6), (144, 408, 4), (100, 47104, 8)):
        plan = bank_chol_plan(n, torch.float32, smem, b, sms)
        assert (plan.path, plan.members_per_block) == ("blocked", expect)
    for n in (100, 144, 320):
        fit = smem // (member_tiles(n) * 1024)
        args = _bank_args(cuda, torch.float32, 3, n)
        if fit <= MAX_MEMBERS_PER_BLOCK:
            bank_fit_cuda("rbf", *args, 0.7, members_per_block=fit)
        if fit + 1 <= MAX_MEMBERS_PER_BLOCK:
            with pytest.raises(RuntimeError, match="CUDA error"):
                bank_fit_cuda("rbf", *args, 0.7, members_per_block=fit + 1)


def _chol_bank(cuda, b, n, dtype, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, n, 8))
    K = torch.as_tensor(np.einsum("bnd,bmd->bnm", X, X) / 8 + 2 * np.eye(n),
                        dtype=dtype, device=cuda)
    y = torch.as_tensor(rng.normal(size=(b, n, 1)), dtype=dtype, device=cuda)
    return K, y


@pytest.mark.parametrize("dtype,tol,atol", [(torch.float32, 1e-4, 1e-3),
                                            (torch.float64, 1e-10, 1e-10)])
@pytest.mark.parametrize("n", [12, 100, 104, 112, 300])
def test_bank_chol_kernel_matches_plain(cuda, dtype, tol, atol, n):
    """Sizes on and off the blocked kernel's 16-grid (float32: the blocked
    path, 8 members a block up to n = 112, one at n = 300; float64: the
    elimination); L exactly lower triangular."""
    K, y = _chol_bank(cuda, 21, n, dtype)
    before = launch_counts()["bank_chol"]
    got = bank_cholesky_solve_cuda(K, y)
    torch.cuda.synchronize()
    assert launch_counts()["bank_chol"] == before + 1
    eL, ea, eI = _bank_errors(got, bank_cholesky_solve_plain(K, y))
    assert eL <= tol and ea <= atol and eI <= tol
    assert (torch.triu(got[0], 1) == 0).all()
    assert (torch.triu(got[1], 1) == 0).all()


def test_bank_chol_plan_on_the_card(cuda):
    """The card's shared memory gives the blocked path at the bank's size:
    8 members of n = 104 a block, one warp each, so (1000, 104) is one
    wave."""
    from erl_gaussian_process_tpu_torch.ops.bank import (
        bank_chol_plan,
        smem_optin,
    )

    plan = bank_chol_plan(104, torch.float32, smem_optin(cuda.index or 0),
                          1000, torch.cuda.get_device_properties(
                              cuda).multi_processor_count)
    assert (plan.path, plan.members_per_block) == ("blocked", 8)


@pytest.mark.parametrize("n", [5, 100, 104])
def test_bank_chol_identity_padding_is_exact(cuda, n):
    """The blocked kernel pads a member to a multiple of 16 with identity
    rows: its factor equals, bit for bit, the leading block of the factor
    of the member padded with identity by hand, whose padding comes out as
    exact identity and zeros."""
    K, y = _chol_bank(cuda, 9, n, torch.float32, seed=2)
    p = -(-n // 16) * 16
    Kp = torch.eye(p, device=cuda).repeat(9, 1, 1)
    Kp[:, :n, :n] = K
    yp = torch.zeros((9, p, 1), device=cuda)
    yp[:, :n] = y
    L, Li, _ = bank_cholesky_solve_cuda(K, y)
    Lp, Lpi, _ = bank_cholesky_solve_cuda(Kp, yp)
    assert torch.equal(Lp[:, :n, :n], L) and torch.equal(Lpi[:, :n, :n], Li)
    eye = torch.eye(p - n, device=cuda).expand(9, -1, -1)
    assert torch.equal(Lp[:, n:, n:], eye) and torch.equal(Lpi[:, n:, n:], eye)
    assert not Lp[:, n:, :n].any() and not Lpi[:, n:, :n].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [24, 104])
def test_bank_chol_non_spd_member_is_nan(cuda, dtype, n):
    """An indefinite member comes out all NaN (never clamped), its
    neighbours in the same block bit for bit unchanged."""
    K, y = _chol_bank(cuda, 11, n, dtype)
    ok = bank_cholesky_solve_cuda(K, y)
    K[5, n // 2, n // 2] = -4.0
    bad = bank_cholesky_solve_cuda(K, y)
    rest = [i for i in range(11) if i != 5]
    for a, b in zip(bad[:2], ok[:2]):
        assert torch.isnan(a[5]).all()
        assert torch.equal(a[rest], b[rest])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bank_chol_member_alone_equals_it_in_the_bank(cuda, dtype):
    """A member factored alone equals, bit for bit, the same member inside
    a 1000-member bank (L, L^{-1} and alpha, which the kernel forms itself;
    whichever warp or block it lands on), and two launches agree."""
    K, y = _chol_bank(cuda, 1000, 104, dtype, seed=3)
    a = bank_cholesky_solve_cuda(K, y)
    b = bank_cholesky_solve_cuda(K, y)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for i in (0, 7, 8, 517, 999):
        alone = bank_cholesky_solve_cuda(K[i:i + 1].contiguous(),
                                         y[i:i + 1].contiguous())
        for got, bank in zip(alone, a):
            assert torch.equal(got[0], bank[i])


@pytest.mark.parametrize("c", [1, 3, 19, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("fam", FAMILIES)
def test_batched_gram_kernel_matches_plain(cuda, fam, dtype, tol, c):
    """c queries per member: below, across and at whole warps, as the
    routed predict's buckets give them."""
    rng = np.random.default_rng(4)
    x1 = torch.as_tensor(rng.uniform(-1, 1, (37, 100, 2)), dtype=dtype,
                         device=cuda)
    x2 = torch.as_tensor(rng.uniform(-1, 1, (37, c, 2)), dtype=dtype,
                         device=cuda)
    before = launch_counts()["gram_batched"]
    k = cross_gram_batched_cuda(_name(fam), x1, x2, 0.4)
    torch.cuda.synchronize()
    assert launch_counts()["gram_batched"] == before + 1
    assert float((k - cross_gram_plain(_name(fam), x1, x2, 0.4)).abs().max()
                 ) <= tol


def test_cuda_sensor_gp_never_calls_the_plain_versions(cuda, monkeypatch):
    """A CUDA train and test of the 3D sensor GP run the kernels only: the
    plain versions are patched to raise. The first train and test capture
    their graphs; the next train is one replay, one bank-fit launch, and
    the next test (routed and grouped on the device) one replay, one gram
    launch."""
    import erl_gaussian_process_tpu_torch.ops.bank as bank_ops
    import erl_gaussian_process_tpu_torch.ops.gram as gram_ops
    from erl_gaussian_process_tpu_torch.models import (
        BatchGPBank,
        RangeSensorGaussianProcess3D,
    )
    from erl_gaussian_process_tpu_torch.workloads import (
        lidar3d_reference_workload,
    )

    def boom(*args, **kwargs):
        raise AssertionError("plain version called on the CUDA path")

    for mod, name in ((bank_ops, "bank_fit_plain"),
                      (bank_ops, "bank_cholesky_solve_plain"),
                      (gram_ops, "cross_gram_plain")):
        monkeypatch.setattr(mod, name, boom)
    setting, R, t, ranges, q, gt, _ = lidar3d_reference_workload()
    gp = RangeSensorGaussianProcess3D(setting, dtype=np.float32, device=cuda)
    assert gp.train(R, t, ranges)
    gp.test(q, False, True)
    before = launch_counts()
    assert gp.train(R, t, ranges)
    pred, valid = gp.test(q, False, True).get_mean()
    bank = BatchGPBank(3, 24, dtype=np.float32, device=cuda)
    bank.solve()
    after = launch_counts()
    assert after["bank_fit"] == before["bank_fit"] + 1
    assert after["gram_batched"] == before["gram_batched"] + 1
    assert after["bank_chol"] == before["bank_chol"] + 1
    assert np.mean((pred[valid] - gt[valid]) ** 2) <= 4.2e-4


# -- the exact GPs: blocked Cholesky and triangular solves -------------------

def _spd(cuda, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n + 8))
    return torch.as_tensor(X @ X.T / n + 2 * np.eye(n), dtype=dtype,
                           device=cuda)


def _berr(L, K):
    """||L L^T - K||_max / ||K||_max in float64."""
    L64, K64 = L.double(), K.double()
    return float((L64 @ L64.T - K64).abs().max() / K64.abs().max())


def _chol_sizes(dtype):
    """Sizes around the kernels' tile (ops.chol.TILE at both dtypes) and two
    of many columns, where the update splits, the look-ahead and every
    sub-block of the diagonal tiles run."""
    from erl_gaussian_process_tpu_torch.ops import TILE

    return [1, 17, TILE, TILE + 1, 3 * TILE - 5, 1300, 2600]


def _berr_ok(be, bp, dtype):
    """float32: no worse than 4x the plain version's; float64: 1e-12."""
    return be <= 4 * bp + 1e-7 if dtype == torch.float32 else be <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("i", range(7))
def test_chol_kernel_matches_plain(cuda, dtype, i):
    """n in {1, 17, T, T + 1, 3T - 5, 1300, 2600}: backward error, an exactly zero
    strict upper part, Dinv against the plain version's, one launch (at
    float32 its updates on the wgmma kernel, counted once), and two
    launches bitwise equal."""
    from erl_gaussian_process_tpu_torch.ops import (
        chol_blocked,
        chol_blocked_plain,
    )

    n = _chol_sizes(dtype)[i]
    A = _spd(cuda, n, dtype, seed=n)
    before = launch_counts()
    L, D = chol_blocked(A, return_dinv=True)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["chol"] == before["chol"] + 1
    assert after["chol_update_wgmma"] - before["chol_update_wgmma"] == \
        (dtype == torch.float32)
    Lp, Dp = chol_blocked_plain(A, return_dinv=True)
    assert _berr_ok(_berr(L, A), _berr(Lp, A), dtype)
    assert bool((torch.triu(L, 1) == 0).all())
    assert float((D - Dp).abs().max()) <= (1e-4 if dtype == torch.float32
                                           else 1e-12)
    assert torch.equal(chol_blocked(A), L)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("i", [1, 4])
def test_chol_gram_kernel_matches_plain(cuda, fam, dtype, i):
    """The gram-fused entry with masked rows: backward error against the
    train gram, masked rows exact identity rows."""
    from erl_gaussian_process_tpu_torch.kernels import train_gram
    from erl_gaussian_process_tpu_torch.ops import (
        chol_blocked_gram,
        chol_blocked_gram_plain,
    )

    n = _chol_sizes(dtype)[i]
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.uniform(-2, 2, (n, 2)), dtype=dtype, device=cuda)
    var = torch.as_tensor(0.05 + 0.01 * rng.random(n), dtype=dtype,
                          device=cuda)
    mask = torch.as_tensor(rng.random(n) < 0.9, device=cuda)
    mask[0] = True
    name = _name(fam)
    L = chol_blocked_gram(name, x, var, mask, 0.7)
    torch.cuda.synchronize()
    K = train_gram(name, x, torch.where(mask, var, 0.0), 0.7, mask=mask)
    Lp = chol_blocked_gram_plain(name, x, var, mask, 0.7)
    assert _berr_ok(_berr(L, K), _berr(Lp, K), dtype)
    off = ~mask
    assert torch.equal(L[off][:, off], torch.eye(int(off.sum()), dtype=dtype,
                                                 device=cuda))
    assert bool((L[off][:, mask] == 0).all() and (L[mask][:, off] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fam,d,n0", [("rbf", 2, 33), ("matern32", 1, 45),
                                      ("rbf", 3, 100), ("matern32", 2, 150)])
def test_chol_joint_kernel_matches_plain(cuda, fam, d, n0, dtype):
    """The joint value/gradient entry: backward error against the plain
    joint gram, masked rows identity, one launch."""
    from erl_gaussian_process_tpu_torch.kernels import (
        train_gram_with_gradient,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        chol_blocked_gram_joint,
        chol_blocked_gram_joint_plain,
    )

    rng = np.random.default_rng(n0)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    x = t(rng.uniform(-2, 2, (n0, d)))
    vv, vg = t(0.05 + 0.01 * rng.random(n0)), t(0.05 + 0.01 * rng.random(n0))
    sm = torch.as_tensor(rng.random(n0) < 0.9, device=cuda)
    gm = torch.as_tensor(rng.random(n0) < 0.7, device=cuda)
    before = launch_counts()["chol_gram_joint"]
    L = chol_blocked_gram_joint(fam, x, vv, vg, sm, gm, 0.9)
    torch.cuda.synchronize()
    assert launch_counts()["chol_gram_joint"] == before + 1
    K = train_gram_with_gradient(fam, x, torch.where(sm, vv, 0.0),
                                 torch.zeros_like(vv),
                                 torch.where(gm, vg, 0.0), sm, gm, 0.9)
    Lp = chol_blocked_gram_joint_plain(fam, x, vv, vg, sm, gm, 0.9)
    assert _berr_ok(_berr(L, K), _berr(Lp, K), dtype)
    off = ~torch.cat([sm] + [gm] * d)
    assert torch.equal(L[off][:, off], torch.eye(int(off.sum()), dtype=dtype,
                                                 device=cuda))


# The float32 factorization's backward error against float64 with the
# mma.sync update that the wgmma one replaced, at the inputs of
# _update_case (NVIDIA H100 80GB HBM3, 700 W): the new update may be at
# most 2x these, and never past the exact-GP cell's backward_rel limit.
MMA_SYNC_BERR = {"cell8192": 1.214627e-06, "joint7680": 1.493217e-06,
                 "ragged8000": 1.237591e-06}
BACKWARD_REL_LIMIT = 3e-5


def _update_case(cuda, case):
    """(factorize, K in float64) at the paths' sizes: the exact-GP cell's
    gram (8192 samples ~ U(-1, 1)^2, rbf 0.1, noise 1e-3), the NIGP's joint
    gram at 7680 (``workloads.nigp_workload``, every slot kept) and the
    cell's gram at a ragged 8000 (an odd count of row tiles)."""
    from erl_gaussian_process_tpu_torch.kernels import (
        train_gram,
        train_gram_with_gradient,
    )
    from erl_gaussian_process_tpu_torch.ops import (
        chol_blocked_gram,
        chol_blocked_gram_joint,
    )
    from erl_gaussian_process_tpu_torch.workloads import nigp_workload

    if case == "joint7680":
        x, _, _, vx, vy, vg, _, scale, kern = nigp_workload()
        X, Vv, Vg = (torch.as_tensor(a, device=cuda) for a in (x, vx + vy, vg))
        m = torch.ones(x.shape[0], dtype=torch.bool, device=cuda)
        return (lambda: chol_blocked_gram_joint(kern, X, Vv, Vg, m, m, scale,
                                                return_dinv=True),
                lambda: train_gram_with_gradient(
                    kern, X.double(), Vv.double(),
                    torch.zeros_like(Vv).double(), Vg.double(), m, m, scale))
    n = int(case[-4:])
    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                        device=cuda)
    V = torch.full((n,), 1e-3, dtype=torch.float32, device=cuda)
    m = torch.ones(n, dtype=torch.bool, device=cuda)
    return (lambda: chol_blocked_gram("rbf", X, V, m, 0.1, return_dinv=True),
            lambda: train_gram("rbf", X.double(), V.double(), 0.1, mask=m))


@pytest.mark.parametrize("case", sorted(MMA_SYNC_BERR))
def test_chol_update_wgmma_against_float64(cuda, case):
    """At the paths' sizes the float32 factorization, its updates on the
    wgmma kernel, keeps a backward error against float64 within 2x the
    mma.sync update's and the cell's limit; two calls are bitwise equal
    (L and Dinv), and each counts one wgmma update."""
    factor, gram = _update_case(cuda, case)
    before = launch_counts()["chol_update_wgmma"]
    L, D = factor()
    L2, D2 = factor()
    torch.cuda.synchronize()
    assert launch_counts()["chol_update_wgmma"] == before + 2
    assert torch.equal(L, L2) and torch.equal(D, D2)
    be = _berr(L, gram())
    assert be <= min(2 * MMA_SYNC_BERR[case], BACKWARD_REL_LIMIT), be


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_kernel_non_spd_is_nan(cuda, dtype):
    """A negative pivot makes the factor NaN from its tile on (never a
    clamp), and the solve's alpha NaN."""
    from erl_gaussian_process_tpu_torch.models.gp_core import cholesky_fit
    from erl_gaussian_process_tpu_torch.ops import chol_blocked

    n = _chol_sizes(dtype)[4]
    A = _spd(cuda, n, dtype)
    A[n - 20, n - 20] = -1.0
    L = chol_blocked(A)
    torch.cuda.synchronize()
    assert bool(torch.isnan(L[n - 20:, n - 20]).all())
    _, alpha = cholesky_fit(A, torch.ones((n, 1), dtype=dtype, device=cuda),
                            robust=False)
    assert bool(torch.isnan(alpha).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [3, 37])
def test_chol_kernel_sub_block_pivot_is_nan(cuda, dtype, offset):
    """A negative pivot in the first (offset 3) or a middle (37) 16-column
    sub-block of a diagonal tile: that tile's lower part, its Dinv and every
    later column NaN, the columns before it finite."""
    from erl_gaussian_process_tpu_torch.ops import TILE, chol_blocked

    n = 1300
    at = 10 * TILE + offset
    A = _spd(cuda, n, dtype)
    A[at, at] = -1.0
    L, D = chol_blocked(A, return_dinv=True)
    torch.cuda.synchronize()
    tile = slice(10 * TILE, 11 * TILE)
    r, c = torch.tril_indices(TILE, TILE, device=cuda)
    assert bool(torch.isfinite(L[:, :10 * TILE]).all())
    assert bool(torch.isnan(L[tile, tile][r, c]).all())
    assert bool((torch.triu(L[tile, tile], 1) == 0).all())
    assert bool(torch.isnan(D[tile]).all())
    assert bool(torch.isnan(L[11 * TILE:, tile]).all())
    assert bool(torch.isnan(L[-1, 11 * TILE:]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("q", [1, 3, 33, 129])
@pytest.mark.parametrize("grid", [1, 3, 7])
def test_trsv_forced_grid_is_bitwise_equal(cuda, dtype, q, grid):
    """The persistent solve at a forced small grid (fewer thread blocks
    than the 21 row blocks, each block taking several) equals the default
    grid bit for bit, in both directions."""
    from erl_gaussian_process_tpu_torch.ops import chol_blocked
    from erl_gaussian_process_tpu_torch.ops.trsv import (
        inverses_from_chol_dinv,
        substitute_cuda,
    )

    n = 1300
    L, D = chol_blocked(_spd(cuda, n, dtype, seed=q), return_dinv=True)
    inv = inverses_from_chol_dinv(D, n).contiguous()
    b = torch.as_tensor(np.random.default_rng(q).standard_normal((n, q)),
                        dtype=dtype, device=cuda)
    for trans in (False, True):
        ref = substitute_cuda(L, inv, b, trans)
        got = substitute_cuda(L, inv, b, trans, grid=grid)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("q", [1, 3, 129])
@pytest.mark.parametrize("with_dinv", [False, True])
def test_trsv_kernel_matches_plain(cuda, dtype, q, with_dinv):
    """Both directions and the Cholesky solve at a ragged n, with the
    Cholesky's Dinv and without it: residuals no worse than 4x the plain
    solve's (float32) or 1e-12 relative (float64); two launches per
    cho_solve_vec, bitwise repeatable."""
    from erl_gaussian_process_tpu_torch.ops import (
        cho_solve_vec,
        chol_blocked,
        inverses_from_chol_dinv,
        solve_lower,
        solve_lower_t,
        substitute_plain,
    )

    n = _chol_sizes(dtype)[4]
    A = _spd(cuda, n, dtype, seed=q)
    L, D = chol_blocked(A, return_dinv=True)
    b = torch.as_tensor(np.random.default_rng(q).standard_normal((n, q)),
                        dtype=dtype, device=cuda)
    inv = inverses_from_chol_dinv(D, n).contiguous() if with_dinv else None
    before = launch_counts()["trsv"]
    x = cho_solve_vec(L, b, chol_dinv=D if with_dinv else None)
    torch.cuda.synchronize()
    assert launch_counts()["trsv"] == before + 2
    cases = [(solve_lower(L, b, inv), substitute_plain(L, b, False), L),
             (solve_lower_t(L, b, inv), substitute_plain(L, b, True), L.T),
             (x, torch.cholesky_solve(b, L), A)]
    for got, ref, M in cases:
        r_k = float((M.double() @ got.double() - b.double()).abs().max())
        r_p = float((M.double() @ ref.double() - b.double()).abs().max())
        if dtype == torch.float32:
            assert r_k <= 4 * r_p + 1e-6
        else:
            assert float((got - ref).abs().max() / ref.abs().max()) < 1e-12
    assert torch.equal(cho_solve_vec(L, b, chol_dinv=D if with_dinv
                                     else None), x)


# -- the whitening of many right-hand sides (ops/trsm.py) --------------------

def _rbf64(a, b, scale):
    d2 = torch.cdist(a.double(), b.double()) ** 2
    return torch.exp(-0.5 * d2 / scale ** 2)


def _whiten_case(cuda, case):
    """(L, dinv, B) float32 on the card for one of the whitening's shapes:
    the exact-GP cell's rbf fit (8192 samples of U(-1, 1)^2, scale 0.1,
    noise 1e-3) against its 100 x 100 grid or 4096 queries of it; the
    NIGP's joint value/gradient factor (7680) against 1024 queries with
    gradients; a ragged exact fit (520) against 7 queries; the
    reduced-rank models' (256, 256) factor against 300 columns."""
    from erl_gaussian_process_tpu_torch.ops import (
        chol_blocked,
        chol_blocked_gram,
        chol_blocked_gram_joint,
    )

    rng = np.random.default_rng(22)
    if case in ("exact_grid", "exact_4096", "ragged"):
        n = 520 if case == "ragged" else 8192
        x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)), device=cuda)
        L, dinv = chol_blocked_gram(
            "rbf", x.float(), torch.full((n,), 1e-3, device=cuda),
            torch.ones(n, dtype=torch.bool, device=cuda), 0.1,
            return_dinv=True)
        g = torch.linspace(-1, 1, 100, dtype=torch.float64, device=cuda)
        xq = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1)
        xq = xq.reshape(-1, 2)
        if case != "exact_grid":
            xq = xq[torch.as_tensor(rng.choice(
                len(xq), 4096 if case == "exact_4096" else 7,
                replace=False), device=cuda)]
        return L, dinv, _rbf64(x, xq, 0.1).float()
    if case == "nigp_joint":
        from erl_gaussian_process_tpu_torch.kernels.gradient import (
            cross_gram_with_gradient,
        )
        from erl_gaussian_process_tpu_torch.workloads import nigp_workload

        x, _, _, vx, vy, vg, xq, scale, kern = nigp_workload()
        x, xq = (torch.as_tensor(a, device=cuda) for a in (x, xq))
        sm = torch.ones(len(x), dtype=torch.bool, device=cuda)
        L, dinv = chol_blocked_gram_joint(
            kern, x, torch.as_tensor(vx + vy, device=cuda),
            torch.as_tensor(vg, device=cuda), sm, sm, scale,
            return_dinv=True)
        return L, dinv, cross_gram_with_gradient(kern, x, xq, scale, sm, sm,
                                                 True).contiguous()
    L, dinv = chol_blocked(_spd(cuda, 256, torch.float32, seed=5),
                           return_dinv=True)
    return L, dinv, torch.as_tensor(rng.standard_normal((256, 300)),
                                    dtype=torch.float32, device=cuda)


@pytest.mark.parametrize("case", ["exact_grid", "exact_4096", "nigp_joint",
                                  "ragged", "reduced_rank"])
def test_trsm_kernel_against_float64(cuda, case):
    """The whitening kernel at each shape that runs it, against the float64
    triangular solve of the same factor: its max error relative to the
    solution's largest entry no worse than 2x that of the 64-row loop it
    replaced (the plain version, on the card); finite, one launch a solve,
    bitwise repeatable."""
    from erl_gaussian_process_tpu_torch.ops import (
        solve_lower_many,
        solve_lower_many_plain,
    )

    L, dinv, B = _whiten_case(cuda, case)
    before = launch_counts()["trsm"]
    X = solve_lower_many(L, dinv, B)
    torch.cuda.synchronize()
    assert launch_counts()["trsm"] == before + 1
    P = solve_lower_many_plain(L, dinv, B)
    ref = torch.linalg.solve_triangular(L.double(), B.double(), upper=False)
    scale = float(ref.abs().max())
    err_k = float((X.double() - ref).abs().max()) / scale
    err_p = float((P.double() - ref).abs().max()) / scale
    assert bool(torch.isfinite(X).all())
    assert err_k <= 2 * err_p, (err_k, err_p)
    assert torch.equal(solve_lower_many(L, dinv, B), X)


def test_exact_gp_variance_through_the_kernel(cuda):
    """The exact GP at the benchmark cell's shape (8192 samples, the 100 x
    100 grid, float32): its variance, a replay of the variance graph, is
    within 2e-4 of the float64 posterior variance and equals the eager
    whitening bit for bit; ``whiten.kernel`` and the kernel's launches
    count it, and the 3D sensor GP's routed test (whose bank whitens a
    batch) counts in neither."""
    from erl_gaussian_process_tpu_torch.models import (
        RangeSensorGaussianProcess3D,
        VanillaGaussianProcess,
        VanillaGPSetting,
    )
    from erl_gaussian_process_tpu_torch.models.vanilla_gp import (
        vanilla_variance,
    )
    from erl_gaussian_process_tpu_torch.utils import timing
    from erl_gaussian_process_tpu_torch.workloads import (
        lidar3d_reference_workload,
    )

    rng = np.random.default_rng(23)
    n = 8192
    x = rng.uniform(-1, 1, (2, n))
    y = 2 * np.sin(10 * x[0]) * np.cos(10 * x[1]) + \
        rng.normal(0, np.sqrt(1e-3), n)
    g = np.linspace(-1, 1, 100)
    xq = np.stack([a.ravel() for a in np.meshgrid(g, g, indexing="ij")])
    gp = VanillaGaussianProcess(VanillaGPSetting(
        kernel=KernelSetting(x_dim=2, scale=0.1), max_num_samples=n),
        dtype=np.float32, device=cuda)
    assert gp._graphs is not None
    assert gp.train(x, y, 1e-3)
    before = (timing.counters().get("whiten.kernel", 0),
              launch_counts()["trsm"])
    var = gp.test(xq).get_variance()      # the variance graph's capture
    res = gp.test(xq)                     # a replay of the test graph...
    got = res.get_variance()              # ... and of the variance graph
    torch.cuda.synchronize()
    # the capture's warm-up and capture route once each; the replays add
    # the launch the graph captured
    assert timing.counters()["whiten.kernel"] - before[0] == 2
    assert launch_counts()["trsm"] - before[1] == 3
    eager = vanilla_variance(gp.state, res._ktest).cpu().numpy()
    assert eager.tobytes() == got.tobytes() and var.tobytes() == \
        got.tobytes()
    xt = torch.as_tensor(x.T, device=cuda)
    K = _rbf64(xt, xt, 0.1) + 1e-3 * torch.eye(n, dtype=torch.float64,
                                               device=cuda)
    ks = _rbf64(xt, torch.as_tensor(xq.T, device=cuda), 0.1)
    w = torch.linalg.solve_triangular(torch.linalg.cholesky(K), ks,
                                      upper=False)
    ref = torch.clamp(1 - (w * w).sum(0), min=0).cpu().numpy()
    assert np.abs(got.ravel() - ref).max() <= 2e-4
    setting, R, t, ranges, q, _, _ = lidar3d_reference_workload()
    sgp = RangeSensorGaussianProcess3D(setting, dtype=np.float32,
                                       device=cuda)
    assert sgp.train(R, t, ranges)
    before = (timing.counters().get("whiten.kernel", 0),
              launch_counts()["trsm"])
    for _ in range(2):
        sgp.test(q, False, True).get_mean()
    torch.cuda.synchronize()
    assert (timing.counters().get("whiten.kernel", 0),
            launch_counts()["trsm"]) == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_exact_gps_on_the_card_match_the_cpu(cuda, dtype, monkeypatch):
    """A small exact GP and noisy-input GP trained and tested on the card
    run the kernels only (the plain Cholesky versions are patched to raise)
    and agree with the same models on the CPU."""
    import erl_gaussian_process_tpu_torch.ops.chol as chol_ops
    from erl_gaussian_process_tpu_torch.models import (
        NoisyInputGaussianProcess,
        NoisyInputGPSetting,
        VanillaGaussianProcess,
        VanillaGPSetting,
    )

    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 300))
    y = np.sin(3 * x[0]) * np.cos(2 * x[1])
    g = np.stack([3 * np.cos(3 * x[0]) * np.cos(2 * x[1]),
                  -2 * np.sin(3 * x[0]) * np.sin(2 * x[1])])
    xt = rng.uniform(-1, 1, (2, 50))
    ks = KernelSetting(x_dim=2, scale=0.5)
    outs = {}
    for dev in ("cpu", cuda):
        if dev != "cpu":
            def boom(*args, **kwargs):
                raise AssertionError("plain version on the CUDA path")
            for name in ("chol_blocked_plain", "chol_blocked_gram_plain",
                         "chol_blocked_gram_joint_plain"):
                monkeypatch.setattr(chol_ops, name, boom)
        vgp = VanillaGaussianProcess(VanillaGPSetting(
            kernel=ks, max_num_samples=300), dtype=dtype, device=dev)
        assert vgp.train(x, y, 1e-2)
        vr = vgp.test(xt)
        ngp = NoisyInputGaussianProcess(NoisyInputGPSetting(
            kernel=ks, max_num_samples=300), dtype=dtype, device=dev)
        assert ngp.train(x, y, g, 1e-4, 1e-2, 1e-2)
        nr = ngp.test(xt, True)
        outs[str(dev)] = (vr.get_mean(), vr.get_variance(), nr.get_mean(),
                          nr.get_gradient(), nr.get_mean_variance())
    tol = 1e-3 if dtype == np.float32 else 1e-9
    for a, b in zip(*outs.values()):
        assert np.abs(a - b).max() < tol


# -- the 2D path and reduced rank --------------------------------------------

def _fitc_args_2d(cuda, dtype, m, n, d, var, seed=8):
    """FITC operands at the 2D map's shapes: m - 63 pseudo points on a grid
    of the map's spacing (0.2) in d dims, far-point padded to m, samples
    inside it, matern32 at the production scale 0.18."""
    rng = np.random.default_rng(seed)
    k = round((m - 63) ** (1 / d))
    half = 0.1 * (k - 1)
    c = np.linspace(-half, half, k)
    grid = np.stack([a.ravel() for a in np.meshgrid(*[c] * d,
                                                    indexing="ij")], -1)
    pseudo = pad_pseudo_points(grid)
    assert pseudo.shape == (m, d)
    st = spgp_init(torch.as_tensor(pseudo, dtype=dtype, device=cuda), 0.18,
                   kernel="matern32")

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    return ("matern32", st.pseudo, st.L_inv,
            t(rng.uniform(-half, half, (n, d))),
            t(rng.choice([-1.0, 1.0], (n, 1))), t(np.full(n, var)),
            torch.as_tensor(rng.uniform(size=n) < 0.9, device=cuda), 0.18)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("m", [1024, 1152])
def test_fitc_kernel_at_the_2d_map_shapes(cuda, m, d, dtype):
    """FITC at M in {1024, 1152} (the 2D map's 961 pseudo points pad to
    1024), N = 2048, d in {1, 2}: against the plain version (float32 at var
    0.1 to 1e-4, float64 at var 1e-4 to 1e-10), dQ exactly symmetric, the
    plan's launches; and at float32 at the map's variance 1e-4, the
    kernel's errors against the float64 update no worse than 2x the plain
    version's."""
    var, tol = (0.1, 1e-4) if dtype == torch.float32 else (1e-4, 1e-10)
    args = _fitc_args_2d(cuda, dtype, m, 2048, d, var)
    assert args[1].shape == (m, d)
    before = launch_counts()["fitc"]
    dq, da = fitc_update_cuda(*args)
    torch.cuda.synchronize()
    assert launch_counts()["fitc"] == before + 1
    dq_ref, da_ref = fitc_update_plain(*args)
    assert float((dq - dq_ref).abs().max() / dq_ref.abs().max()) <= tol
    assert float((da - da_ref).abs().max() / da_ref.abs().max()) <= tol
    assert torch.equal(dq, dq.T)
    if dtype == torch.float64:
        return
    args = _fitc_args_2d(cuda, dtype, m, 2048, d, 1e-4)
    st64 = spgp_init(args[1].double(), 0.18, kernel="matern32")
    truth = fitc_update_plain("matern32", st64.pseudo, st64.L_inv,
                              *(t.double() for t in args[3:6]), args[6],
                              0.18)

    def rel(got):
        return [float((g.double() - t).abs().max() / t.abs().max())
                for g, t in zip(got, truth)]

    kernel, plain = rel(fitc_update_cuda(*args)), rel(fitc_update_plain(*args))
    assert all(k <= 2 * p for k, p in zip(kernel, plain)), (kernel, plain)


def _lidar_log_gp(cuda, dtype):
    """The lidar GP of tests/test_lidar_gp_2d.py:25-50 on the card, and the
    28 logged scans."""
    import os

    from erl_gaussian_process_tpu_torch.models import (
        LidarGaussianProcess2D,
        LidarGP2DSetting,
    )
    from erl_gaussian_process_tpu_torch.utils.loaders import load_lidar_log

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frames = load_lidar_log(os.path.join(root, "data", "double",
                                         "train.dat"))
    f = frames[0]
    s = LidarGP2DSetting.from_dict(dict(
        group_size=26, overlap_size=6, margin=1, sensor_range_var=0.01,
        discontinuity_var=100.0,
        sensor_frame=dict(valid_range_min=0.1, valid_range_max=30.0,
                          angle_min=float(f.angles[0]),
                          angle_max=float(f.angles[-1]), num_rays=270,
                          discontinuity_detection=True),
        gp=dict(kernel_type="ou", kernel=dict(x_dim=1, scale=0.05)),
        mapping=dict(type="identity")))
    return (LidarGaussianProcess2D(s, dtype=dtype, device=cuda),
            LidarGaussianProcess2D(s, dtype=dtype, device="cpu"),
            np.stack([fr.ranges for fr in frames]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lidar_gp_2d_replay_on_the_card_is_bitwise_per_scan_train(cuda,
                                                                 dtype):
    """The 28 logged scans (392 members of 26) in one bank-fit launch: each
    scan's slice equals its own train bit for bit; the routed test (a
    replay of its routed graph) is one batched gram launch and agrees
    with the CPU model."""
    gp, cpu, rb = _lidar_log_gp(cuda, dtype)
    before = launch_counts()
    stacked = gp.train_scan_batch(rb)
    torch.cuda.synchronize()
    assert launch_counts()["bank_fit"] == before["bank_fit"] + 1
    assert tuple(stacked.L.shape) == (392, 26, 26)
    for s in (0, 13, 27):
        assert gp.train(np.eye(2), np.zeros(2), rb[s])
        for a, b in zip(stacked, gp.bank):
            assert torch.equal(a[s * 14:(s + 1) * 14], b)
    angles = gp.sensor_frame.angles_in_frame
    gp.test(angles, True, True)
    before = launch_counts()
    pred, valid = gp.test(angles, True, True).get_mean()
    assert launch_counts()["gram_batched"] == before["gram_batched"] + 1
    assert cpu.train(np.eye(2), np.zeros(2), rb[27])
    cpred, cvalid = cpu.test(angles, True, True).get_mean()
    np.testing.assert_array_equal(valid, cvalid)
    tol = 1e-4 if dtype == np.float32 else 1e-10
    assert np.abs(pred[valid] - cpred[valid]).max() <= \
        tol * np.abs(cpred[valid]).max()


@pytest.mark.parametrize("m", [1, 17, 48, 64, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_kernel_at_the_rr_fit_sizes(cuda, dtype, m):
    """The reduced-rank fit's (m, m) information systems are small: the
    blocked Cholesky at m in {1, ..., 256} against its plain version, and
    an indefinite one NaN, so the host retry escalates."""
    from erl_gaussian_process_tpu_torch.ops import (
        chol_blocked,
        chol_blocked_plain,
    )

    A = _spd(cuda, m, dtype, seed=m)
    L = chol_blocked(A)
    assert _berr_ok(_berr(L, A), _berr(chol_blocked_plain(A), A), dtype)
    A[m - 1, m - 1] = -1.0
    assert bool(torch.isnan(chol_blocked(A)[m - 1, m - 1]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rr_fits_on_the_card_run_the_chol_and_trsv_kernels(cuda, dtype,
                                                           monkeypatch):
    """The vanilla and noisy-input reduced-rank GPs on the card: their
    (m, m) fits launch the blocked Cholesky and the substitution (the plain
    Cholesky patched to raise) and predict as on the CPU."""
    import erl_gaussian_process_tpu_torch.ops.chol as chol_ops
    from erl_gaussian_process_tpu_torch.kernels import ReducedRankSetting
    from erl_gaussian_process_tpu_torch.models import (
        NoisyInputGaussianProcess,
        NoisyInputGPSetting,
        VanillaGaussianProcess,
        VanillaGPSetting,
    )

    rng = np.random.default_rng(1)
    x = rng.uniform(-0.8, 0.8, (2, 400))
    y = np.sin(2 * x[0]) * np.cos(2 * x[1])
    g = np.stack([2 * np.cos(2 * x[0]) * np.cos(2 * x[1]),
                  -2 * np.sin(2 * x[0]) * np.sin(2 * x[1])])
    xt = rng.uniform(-0.6, 0.6, (2, 64))
    ks = dict(x_dim=2, scale=0.6, num_basis=[16, 16], boundary=[2.0, 2.0],
              coord_origin=[0.0, 0.0])
    outs = {}
    for dev in ("cpu", cuda):
        if dev != "cpu":
            def boom(*args, **kwargs):
                raise AssertionError("plain version on the CUDA path")
            monkeypatch.setattr(chol_ops, "chol_blocked_plain", boom)
            before = launch_counts()
        vgp = VanillaGaussianProcess(VanillaGPSetting(
            kernel_type="rr_matern32", kernel=ReducedRankSetting(**ks)),
            dtype=dtype, device=dev)
        assert vgp.train(x, y, 1e-4)
        vr = vgp.test(xt)
        ngp = NoisyInputGaussianProcess(NoisyInputGPSetting(
            kernel_type="rr_rbf", kernel=ReducedRankSetting(**ks)),
            dtype=dtype, device=dev)
        assert ngp.train(x, y, g, 1e-4, 1e-4, 1e-4)
        nr = ngp.test(xt, True)
        outs[str(dev)] = (vr.get_mean(), vr.get_variance(), nr.get_mean(),
                          nr.get_gradient(), nr.get_mean_variance())
    after = launch_counts()
    # each model's first fit is a graph: its capture runs the fit once
    # eagerly (counted), then the replay counts the launches it captured
    assert after["chol"] == before["chol"] + 4
    assert after["trsv"] >= before["trsv"] + 8
    tol = 1e-3 if dtype == np.float32 else 1e-9
    for a, b in zip(*outs.values()):
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("dtype,tol", GRAM_TOL)
@pytest.mark.parametrize("fam", FAMILIES)
def test_registered_ops_match_plain(cuda, fam, dtype, tol):
    """The ``egp`` ops called directly: CUDA tensors launch the kernels
    (one count each), CPU tensors give the plain versions bit for bit;
    the gram plain, masked and batched, and FITC."""
    from erl_gaussian_process_tpu_torch.ops.gram import family_spec

    spec = family_spec(_name(fam))
    rng = np.random.default_rng(21)

    def both(*shape):
        a = rng.uniform(-2, 2, shape)
        return (torch.as_tensor(a, dtype=dtype, device=cuda),
                torch.as_tensor(a, dtype=dtype))

    (x1, c1), (x2, c2) = both(300, 3), both(517, 3)
    mask_c = torch.as_tensor(rng.uniform(size=300) < 0.7)
    mask = mask_c.to(cuda)
    counts = launch_counts()
    k = torch.ops.egp.cross_gram(x1, x2, mask, *spec, 0.6)
    kb = torch.ops.egp.cross_gram_batched(x1[None].repeat(2, 1, 1),
                                          x2[None].repeat(2, 1, 1),
                                          mask[None].repeat(2, 1), *spec, 0.6)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["gram"] == counts["gram"] + 1
    assert after["gram_batched"] == counts["gram_batched"] + 1
    ref = torch.ops.egp.cross_gram(c1, c2, mask_c, *spec, 0.6)
    assert torch.equal(ref, cross_gram_plain(_name(fam), c1, c2, 0.6,
                                             mask_c))
    assert float((k.cpu() - ref).abs().max()) <= tol
    assert torch.equal(kb[0], k) and torch.equal(kb[1], k)
    if fam == "ou":
        return
    st = spgp_init(x1, 0.6, kernel=_name(fam))
    y = torch.as_tensor(rng.choice([-1.0, 1.0], (517, 1)), dtype=dtype,
                        device=cuda)
    var = torch.full((517,), 0.1, dtype=dtype, device=cuda)
    m2 = torch.as_tensor(rng.uniform(size=517) < 0.9, device=cuda)
    args = (st.pseudo, st.L_inv, x2, y, var, m2)
    dq, da = torch.ops.egp.fitc_update(*args, *spec, 0.6)
    torch.cuda.synchronize()
    assert launch_counts()["fitc"] == after["fitc"] + 1
    rq, ra = torch.ops.egp.fitc_update(*(a.cpu() for a in args), *spec, 0.6)
    ftol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((dq.cpu() - rq).abs().max() / rq.abs().max()) <= ftol
    assert float((da.cpu() - ra).abs().max() / ra.abs().max()) <= ftol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fam", FAMILIES)
def test_autograd_gram_backward_on_the_card(cuda, fam, dtype):
    """``GramScale`` on CUDA tensors: the forward is the gram kernel (one
    launch), the scale's gradient equals autograd through the plain gram
    with a tensor scale on the same card."""
    from erl_gaussian_process_tpu_torch.ops import GramScale
    from erl_gaussian_process_tpu_torch.ops.gram import (
        apply_family,
        pairwise_sqdist,
    )

    rng = np.random.default_rng(5)
    x1 = torch.as_tensor(rng.uniform(-1, 1, (257, 2)), dtype=dtype,
                         device=cuda)
    x2 = torch.as_tensor(rng.uniform(-1, 1, (1031, 2)), dtype=dtype,
                         device=cuda)
    w = torch.as_tensor(rng.standard_normal((257, 1031)), dtype=dtype,
                        device=cuda)
    s = torch.tensor(0.4, dtype=dtype, device=cuda, requires_grad=True)
    before = launch_counts()["gram"]
    k = GramScale.apply(_name(fam), x1, x2, s)
    (g,) = torch.autograd.grad(torch.sum(w * k), s)
    torch.cuda.synchronize()
    assert launch_counts()["gram"] == before + 1
    s2 = torch.tensor(0.4, dtype=dtype, device=cuda, requires_grad=True)
    kp = apply_family(_name(fam), pairwise_sqdist(x1, x2), s2)
    (g2,) = torch.autograd.grad(torch.sum(w * kp), s2)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    ktol = 1e-6 if dtype == torch.float32 else 1e-12
    assert float((k - kp).detach().abs().max()) <= ktol
    assert abs(float(g - g2)) <= tol * max(1.0, abs(float(g2)))


def _fitc_args_3d(cuda, dtype, n, var, seed=9):
    """FITC operands at hotel-0's pseudo shape: an 11 x 11 x 9 grid (1089
    points, spacing 0.3) far-point padded to 1152, n samples inside it,
    matern32 at 0.6, d = 3."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1.5, 1.5, 11)] * 2 + [np.linspace(-1.2, 1.2, 9)]
    grid = np.stack([a.ravel() for a in np.meshgrid(*axes, indexing="ij")],
                    -1)
    st = spgp_init(torch.as_tensor(pad_pseudo_points(grid), dtype=dtype,
                                   device=cuda), 0.6, kernel="matern32")

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    return ("matern32", st.pseudo, st.L_inv,
            t(rng.uniform(-1.5, 1.5, (n, 3))),
            t(rng.choice([-1.0, 1.0], (n, 1))), t(np.full(n, var)),
            torch.as_tensor(rng.uniform(size=n) < 0.9, device=cuda), 0.6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fitc_kernel_at_four_poses(cuda, dtype):
    """FITC at (1152, 8192, d = 3), the hotel-0 update at poses_per_step =
    4 (2 splits of 4096 samples): against the plain version (float32 at
    var 0.1 to 1e-4, float64 at var 1e-4 to 1e-10), dQ exactly symmetric,
    one launch counted; at float32 at var 1e-4 the kernel's errors
    against the float64 update no worse than 2x the plain version's."""
    from erl_gaussian_process_tpu_torch.ops.fitc import fitc_plan

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fitc_plan(1152, 8192, sms).splits >= 2
    var, tol = (0.1, 1e-4) if dtype == torch.float32 else (1e-4, 1e-10)
    args = _fitc_args_3d(cuda, dtype, 8192, var)
    before = launch_counts()["fitc"]
    dq, da = fitc_update_cuda(*args)
    torch.cuda.synchronize()
    assert launch_counts()["fitc"] == before + 1
    dq_ref, da_ref = fitc_update_plain(*args)
    assert float((dq - dq_ref).abs().max() / dq_ref.abs().max()) <= tol
    assert float((da - da_ref).abs().max() / da_ref.abs().max()) <= tol
    assert torch.equal(dq, dq.T)
    if dtype == torch.float64:
        return
    args = _fitc_args_3d(cuda, dtype, 8192, 1e-4)
    st64 = spgp_init(args[1].double(), 0.6, kernel="matern32")
    truth = fitc_update_plain("matern32", st64.pseudo, st64.L_inv,
                              *(t.double() for t in args[3:6]), args[6], 0.6)

    def rel(got):
        return [float((g.double() - t).abs().max() / t.abs().max())
                for g, t in zip(got, truth)]

    kernel, plain = rel(fitc_update_cuda(*args)), rel(fitc_update_plain(*args))
    assert all(k <= 2 * p for k, p in zip(kernel, plain)), (kernel, plain)


def _fitc_args_at(cuda, m, n, d, var):
    if d == 2:
        return _fitc_args_2d(cuda, torch.float32, m, n, d, var)
    if m == 1152:
        return _fitc_args_3d(cuda, torch.float32, n, var)
    return _fitc_args(cuda, torch.float32, m, n, var)


@pytest.mark.parametrize("m,n,d", [(1024, 2048, 2), (1152, 8192, 3),
                                   (1152, 4096, 3), (1089, 1500, 3),
                                   (1089, 1501, 3)])
def test_fitc_syrk_at_the_path_shapes(cuda, m, n, d):
    """The float32 SYRK's grid (fitc_plan: 128 x 128 super-tiles, a block
    an SM) at the 2D map's shape, four poses, a gloo rank's two and a ragged
    M and N (1501 samples: the plan's cp.async path): against the plain version at var 0.1 (to 1e-4 of the result's
    magnitude), dQ exactly symmetric, two calls bit for bit (the kernel
    sets its super-tiles' counters back), one launch counted."""
    args = _fitc_args_at(cuda, m, n, d, 0.1)
    assert args[1].shape == (m, d) and args[3].shape == (n, d)
    before = launch_counts()["fitc"]
    dq, da = fitc_update_cuda(*args)
    torch.cuda.synchronize()
    assert launch_counts()["fitc"] == before + 1
    dq_ref, da_ref = fitc_update_plain(*args)
    assert float((dq - dq_ref).abs().max() / dq_ref.abs().max()) <= 1e-4
    assert float((da - da_ref).abs().max() / da_ref.abs().max()) <= 1e-4
    assert torch.equal(dq, dq.T)
    again = fitc_update_cuda(*args)
    assert torch.equal(dq, again[0]) and torch.equal(da, again[1])


def test_fitc_copy_paths_agree_bitwise(cuda):
    """The plan's two copy paths of the float32 SYRK (fitc_plan's
    copy_engine): 1501 samples come through cp.async, the same samples
    with three masked ones appended (1504, the same 24 panels) through the
    copy engine, and the two updates agree bit for bit; the counters
    fitc.syrk_cp_async and fitc.syrk_tma say which path served each
    call."""
    from erl_gaussian_process_tpu_torch.utils.timing import counters

    args = list(_fitc_args(cuda, torch.float32, 1089, 1501, 0.1))
    before = counters()
    dq, da = fitc_update_cuda(*args)
    padded = list(args)
    padded[3] = torch.cat([args[3], torch.full_like(args[3][:3], 0.5)])
    padded[4] = torch.cat([args[4], torch.ones_like(args[4][:3])])
    padded[5] = torch.cat([args[5], torch.full_like(args[5][:3], 0.1)])
    padded[6] = torch.cat([args[6], torch.zeros_like(args[6][:3])])
    got = fitc_update_cuda(*padded)
    after = counters()
    assert torch.equal(dq, got[0]) and torch.equal(da, got[1])
    for name in ("fitc.syrk_cp_async", "fitc.syrk_tma"):
        assert after.get(name, 0) - before.get(name, 0) == 1, name


@pytest.mark.parametrize("n", [1501, 2048])
def test_fitc_unaligned_targets_are_bitwise_neutral(cuda, n):
    """A y that starts 4 bytes into its buffer (which the copy engine does
    not read: such a call takes the cp.async path, ops/fitc.py
    _copy_engine) gives the update of the same y aligned, bit for bit."""
    args = list(_fitc_args(cuda, torch.float32, 1089, n, 0.1))
    dq, da = fitc_update_cuda(*args)
    buf = torch.empty(args[4].numel() + 1, dtype=torch.float32, device=cuda)
    shifted = buf[1:].view(args[4].shape)
    shifted.copy_(args[4])
    assert shifted.data_ptr() % 16 != 0
    args[4] = shifted
    got = fitc_update_cuda(*args)
    assert torch.equal(dq, got[0]) and torch.equal(da, got[1])


def test_fitc_kernel_with_three_target_columns(cuda):
    """dalpha with q = 3 columns, more than the SYRK's stream carries
    (csrc/fitc.cu kDaQ): one warp a (row, column) pair before the stream,
    against the plain version at var 0.1 (to 1e-4), dQ exactly symmetric,
    two calls bit for bit."""
    args = list(_fitc_args(cuda, torch.float32, 1152, 2048, 0.1))
    args[4] = torch.cat([args[4], args[4][:, :1] * -0.5], dim=1)
    assert args[4].shape == (2048, 3)
    dq, da = fitc_update_cuda(*args)
    dq_ref, da_ref = fitc_update_plain(*args)
    assert float((dq - dq_ref).abs().max() / dq_ref.abs().max()) <= 1e-4
    assert float((da - da_ref).abs().max() / da_ref.abs().max()) <= 1e-4
    assert torch.equal(dq, dq.T)
    again = fitc_update_cuda(*args)
    assert torch.equal(dq, again[0]) and torch.equal(da, again[1])


def test_fitc_syrk_alone_repeats_bitwise(cuda):
    """The SYRK launched alone (the timing entry of chip_smoke.py) on kmn
    and weights computed by the plain version: kmn w kmn^T to 1e-4, dQ
    exactly symmetric, and a second launch on the same buffers bit for bit
    (its arrival counters are zeroed once, then set back by the kernel)."""
    from erl_gaussian_process_tpu_torch.ops.fitc import fitc_syrk_alone
    from erl_gaussian_process_tpu_torch.ops.gram import cross_gram_plain

    name, P, linv, x, y, var, mask, scale = _fitc_args_3d(
        cuda, torch.float32, 2048, 1e-4)
    kmn = cross_gram_plain(name, P, x, scale).contiguous()
    lam = torch.clamp(1.0 - torch.sum((linv @ kmn) ** 2, dim=0), min=0.0)
    w = torch.where(mask, 1.0 / (lam + var), torch.zeros_like(lam))
    launch, dq, da = fitc_syrk_alone(kmn, w, y, mask)
    launch()
    first = (dq.clone(), da.clone())
    launch()
    assert torch.equal(dq, first[0]) and torch.equal(da, first[1])
    ref = (kmn * w[None, :]) @ kmn.T
    assert float((dq - ref).abs().max() / ref.abs().max()) <= 1e-4
    assert torch.equal(dq, dq.T)
    yv = torch.where(mask[:, None], y, torch.zeros_like(y))
    ref_a = (kmn * w[None, :]) @ yv
    assert float((da - ref_a).abs().max() / ref_a.abs().max()) <= 1e-4


def test_artifact_round_trip_on_the_card(cuda):
    """The map's update and predict artifacts exported on the card,
    through bytes, equal the eager step bit for bit (a call after the one
    that captured its graph) and launch the FITC and
    gram kernels (the launch counts)."""
    from erl_gaussian_process_tpu_torch.geometry import free_sample_fractions
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        spgp_prepare,
    )
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        predict_prepared_step,
        step_seed,
        update_step,
    )
    from erl_gaussian_process_tpu_torch.utils.deploy import (
        export_map_predict_step,
        export_map_update_step,
        load_fn,
    )

    s = SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=2, scale=0.3),
                          max_num_samples=256),
        min_distance=0.0, max_distance=30.0, free_points_per_meter=2.0,
        free_sampling_margin=0.02, logodd_free=-1.0, logodd_occupied=1.0,
        logodd_variance=1e-4)
    c = np.linspace(-1, 1, 8)
    pseudo = np.stack([a.ravel() for a in np.meshgrid(c, c, indexing="ij")],
                      -1)
    st = spgp_init(torch.as_tensor(pseudo, dtype=torch.float32, device=cuda),
                   0.3, kernel="matern32")
    step = load_fn(export_map_update_step(s, n_pseudo=64, n_rays=32,
                                          free_slots=4, device=cuda))
    predict = load_fn(export_map_predict_step(n_pseudo=64, scale=0.3,
                                              device=cuda))
    ang = np.linspace(-2.0, 2.0, 32)
    pts = torch.as_tensor(np.stack([2 * np.cos(ang), 2 * np.sin(ang)], -1),
                          dtype=torch.float32, device=cuda)
    lo = torch.full((2,), -3.0, device=cuda)
    hi = torch.full((2,), 3.0, device=cuda)
    scan = (torch.zeros(2, device=cuda), pts,
            torch.ones(32, dtype=torch.bool, device=cuda), lo, hi)
    g = torch.Generator(device=cuda)
    g.manual_seed(step_seed(0, 1))
    u = free_sample_fractions(32, 4, 0.02, g, torch.float32, cuda)
    step(st, u, *scan)                   # the capture
    before = launch_counts()
    got, n_used = step(st, u, *scan)
    torch.cuda.synchronize()
    assert launch_counts()["fitc"] == before["fitc"] + 1
    ref, ref_n, _ = update_step(
        st, *scan, 0.3, kernel="matern32", diagonal_qm=False, free_slots=4,
        max_samples=256, min_distance=0.0, max_distance=30.0,
        free_sampling_margin=0.02, free_points_per_meter=2.0,
        logodd_occupied=1.0, logodd_free=-1.0, logodd_variance=1e-4, u=u)
    assert int(n_used) == int(ref_n) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    L_qm, a = spgp_prepare(got)
    q = torch.rand(100, 2, device=cuda) * 2 - 1
    predict(got, L_qm, a, q)             # the capture
    before = launch_counts()["gram"]
    mean, _ = predict(got, L_qm, a, q)
    torch.cuda.synchronize()
    assert launch_counts()["gram"] == before + 1
    ref_mean, _ = predict_prepared_step(got, L_qm, a, q, 0.3,
                                        kernel="matern32", with_grad=False)
    assert torch.equal(mean, ref_mean)


# -- the sensor GPs' and the loaded artifacts' CUDA graphs -------------------

def _sensor_case(cuda, kind, dtype, mesh=None, **kw):
    """(graphed model on the card, the same model's eager chain as a
    function of a callable, scans, train pose, test queries) for the 3D
    range-sensor GP (a 40 x 20 analytic scan) or the 2D lidar GP (the
    logged scans), plain or reduced rank (``kind`` ending in "_rr"), on
    ``mesh`` when given."""
    import os

    from erl_gaussian_process_tpu_torch.models import (
        LidarGaussianProcess2D,
        LidarGP2DSetting,
        RangeSensorGaussianProcess3D,
        RangeSensorGP3DSetting,
    )
    from erl_gaussian_process_tpu_torch.utils.loaders import load_lidar_log

    rr = kind.endswith("_rr")
    if kind.startswith("3d"):
        gp_kw = (dict(kernel_type="reduced_rank_rbf",
                      kernel=dict(x_dim=2, scale=0.5, num_basis=[24, 12],
                                  boundary=[4.8, 2.1],
                                  coord_origin=[0.0, 0.0]))
                 if rr else dict(kernel_type="ou",
                                 kernel=dict(x_dim=2, scale=0.5)))
        d = dict(row_group_size=12, row_overlap_size=4, col_group_size=12,
                 col_overlap_size=4, sensor_range_var=1e-2 if rr else 1e-4,
                 sensor_frame=dict(valid_range_min=0.1, valid_range_max=40.0,
                                   azimuth_min=-np.pi, azimuth_max=np.pi,
                                   elevation_min=-0.6, elevation_max=0.6,
                                   num_azimuth_lines=40,
                                   num_elevation_lines=20),
                 gp=gp_kw, mapping=dict(type="inverse_sqrt"))
        d.update(kw)
        gp = RangeSensorGaussianProcess3D(RangeSensorGP3DSetting.from_dict(d),
                                          dtype=dtype, mesh=mesh, device=cuda)
        dirs = gp.sensor_frame.ray_directions_in_frame()
        az = np.arctan2(dirs[..., 1], dirs[..., 0])
        el = np.arctan2(dirs[..., 2], np.hypot(dirs[..., 0], dirs[..., 1]))
        r = 5.0 + 0.5 * np.sin(3 * az) * np.cos(2 * el)
        rng = np.random.default_rng(1)
        scans = np.stack([np.where(rng.uniform(size=r.shape) < 0.2, np.inf,
                                   r * (1 + 0.01 * k)) for k in range(3)])
        return gp, scans, (np.eye(3), np.zeros(3)), dirs.reshape(-1, 3)[::5]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frames = load_lidar_log(os.path.join(root, "data", "double",
                                         "train.dat"))
    f = frames[0]
    d = dict(group_size=26, overlap_size=6, margin=1, sensor_range_var=0.01,
             discontinuity_var=100.0,
             sensor_frame=dict(valid_range_min=0.1, valid_range_max=30.0,
                               angle_min=float(f.angles[0]),
                               angle_max=float(f.angles[-1]), num_rays=270,
                               discontinuity_detection=True),
             gp=(dict(kernel_type="reduced_rank_rbf",
                      kernel=dict(x_dim=1, scale=0.25, num_basis=[48]))
                 if rr else dict(kernel_type="ou",
                                 kernel=dict(x_dim=1, scale=0.05))),
             mapping=dict(type="identity"))
    d.update(kw)
    gp = LidarGaussianProcess2D(LidarGP2DSetting.from_dict(d), dtype=dtype,
                                mesh=mesh, device=cuda)
    return (gp, np.stack([fr.ranges for fr in frames]), (np.eye(2),
                                                          np.zeros(2)),
            f.angles)


def _eager(gp, fn):
    """``fn()`` with ``gp``'s graphs set aside: the eager chain."""
    graphs, gp._graphs = gp._graphs, None
    try:
        return fn()
    finally:
        gp._graphs = graphs


def _bits(a, b) -> bool:
    """Bit for bit, NaN included: tensors, arrays or tuples of them."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_bits(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _result(gp, q):
    r = gp.test(q, True, False)
    return r._mean, r._var, r._valid


def _same_test(kind, got, want) -> bool:
    """A graphed test against the eager chain's. Both GPs' graphed tests
    group their queries on the device into rows of 32 slots, the host into
    a bucket: for the 2D GPs' tests here (270 angles, a 16 x 32 bucket)
    the products still round as the eager chain's, bit for bit; the 3D
    GP's rows have another shape than its bucket, so its products may
    round otherwise: valid flags exact, means and variances within 1e-4
    (float32) or 1e-12 (float64) of their magnitude
    (tests/test_torch_routed_chunks.py)."""
    if not kind.startswith("3d"):
        return _bits(got, want)
    tol = 1e-4 if got[0].dtype == np.float32 else 1e-12
    return np.array_equal(got[2], want[2]) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)
        for a, b in zip(got[:2], want[:2]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["3d", "3d_rr", "2d", "2d_rr"])
def test_sensor_graphs_equal_the_eager_chain(cuda, kind, dtype):
    """The graphed ``train`` and ``test`` (twice: the capture, then a
    replay) against the same model's eager chain on the card, bit for bit:
    banks, and the 2D GPs' means, variances and valid masks (the 3D GP's
    device-routed test: ``_same_test``); a replay is one bank-fit launch
    (plain) and one batched gram launch. ``train_scan_batch`` (eager)
    too."""
    gp, scans, pose, q = _sensor_case(cuda, kind, dtype)
    for s in range(2):
        before = launch_counts()
        assert gp.train(*pose, scans[s])
        bank = tuple(t.clone() if t is not None else None for t in gp.bank)
        got = _result(gp, q)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert _eager(gp, lambda: gp.train(*pose, scans[s]))
        assert _bits(bank, tuple(gp.bank))
        assert _same_test(kind, got, _eager(gp, lambda: _result(gp, q)))
        if s == 1 and not kind.endswith("_rr"):
            assert counts["bank_fit"] - before["bank_fit"] == 1
            assert counts["gram_batched"] - before["gram_batched"] == 1
    assert gp._graphs.ladder_runs == 0
    if kind.endswith("_rr"):
        return
    stacked = gp.train_scan_batch(scans)
    assert _bits(tuple(stacked),
                 tuple(_eager(gp, lambda: gp.train_scan_batch(scans))))


@pytest.mark.parametrize("name,gate", [("lidar", 4.2e-4), ("depth", 2.2e-4)])
def test_device_routed_test_matches_the_host_path(cuda, name, gate):
    """The reference protocols' tests (10 000 lidar directions, the depth
    image's) on the card: each graphed test is one replay of one graph,
    captured once, holding one gram launch and counting one
    ``bank.routed_graphed``; valid flags equal to the host path's (the
    same model's graphs set aside), ranges and variances within 1e-4 of
    their magnitude, both under the protocol's MSE gate."""
    from erl_gaussian_process_tpu_torch.models import (
        RangeSensorGaussianProcess3D,
    )
    from erl_gaussian_process_tpu_torch.ops import cross_gram_batched_cuda
    from erl_gaussian_process_tpu_torch.utils import timing
    from erl_gaussian_process_tpu_torch.workloads import (
        depth3d_reference_workload,
        lidar3d_reference_workload,
    )

    make = {"lidar": lidar3d_reference_workload,
            "depth": depth3d_reference_workload}[name]
    setting, R, t, ranges, q, gt, _ = make()
    gp = RangeSensorGaussianProcess3D(setting, dtype=np.float32, device=cuda)

    def answers():
        r = gp.test(q, False, True)
        return (*r.get_mean(), r.get_variance()[0])

    assert gp.train(R, t, ranges)
    answers()
    before = timing.counters().get("bank.routed_graphed", 0)
    pred, valid, var = answers()
    assert timing.counters().get("bank.routed_graphed", 0) == before + 1
    (g,) = [g for g in gp._graphs.captures if g.key[1] == "chunked"]
    assert g.replays == 2 and g.launches == {cross_gram_batched_cuda: 1}
    hpred, hvalid, hvar = _eager(gp, answers)
    np.testing.assert_array_equal(valid, hvalid)
    assert valid.any()
    for a, b in ((pred, hpred), (var, hvar)):
        assert np.abs(a[valid] - b[valid]).max() <= \
            1e-4 * np.abs(b[valid]).max()
    for p, v in ((pred, valid), (hpred, hvalid)):
        assert np.mean((p[v] - gt[v]) ** 2) <= gate


def test_sensor_graph_replays_launch_the_bank_fit_once(cuda):
    """After the capture, N graphed trains launch the bank fit N times (the
    replays add the launch each captured), and the graph records one."""
    from erl_gaussian_process_tpu_torch.ops import bank_fit_cuda

    gp, scans, pose, _ = _sensor_case(cuda, "3d", np.float32)
    assert gp.train(*pose, scans[0])
    g = list(gp._graphs._fits.values())[0]
    assert g.launches == {bank_fit_cuda: 1}
    before = launch_counts()["bank_fit"]
    for k in range(5):
        assert gp.train(*pose, scans[k % 3])
    torch.cuda.synchronize()
    assert launch_counts()["bank_fit"] - before == 5 and g.replays == 6


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_sensor_graph_sees_a_changed_scalar(cuda, kind):
    """A setting changed between two trains reaches the graphed train as it
    reaches the eager one (one graph: the scalars are a static input), and
    a bank held from ``train_scan_batch`` is not overwritten by the next
    call."""
    gp, scans, pose, q = _sensor_case(cuda, kind, np.float32)
    assert gp.train(*pose, scans[0])
    before = gp.bank.L.clone()
    gp.setting.sensor_range_var = 0.05
    assert gp.train(*pose, scans[0])
    bank = tuple(t.clone() for t in gp.bank)
    assert _eager(gp, lambda: gp.train(*pose, scans[0]))
    assert _bits(bank, tuple(gp.bank)) and not torch.equal(before, bank[2])
    assert len(gp._graphs._fits) == 1
    first = gp.train_scan_batch(scans)
    kept = tuple(t.clone() for t in first)
    gp.train_scan_batch(scans[::-1].copy())
    assert _bits(kept, tuple(first))


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_sensor_graph_scan_batch_leaves_the_trained_bank(cuda, kind):
    """``train`` of scan A, then ``train_scan_batch`` of scan B alone (S =
    1, the train's own shape): the bank and ``test`` stay scan A's, the
    eager chain's ``test`` of A (``_same_test``)."""
    gp, scans, pose, q = _sensor_case(cuda, kind, np.float32)
    assert gp.train(*pose, scans[0])
    _result(gp, q)
    bank = tuple(t.clone() for t in gp.bank)
    gp.train_scan_batch(scans[1:2])
    got = _result(gp, q)
    assert _bits(bank, tuple(gp.bank))
    assert _same_test(kind, got, _eager(gp, lambda: _result(gp, q)))
    assert gp._graphs._routed.get(next(iter(gp._graphs._routed))) \
        .replays == 2


def test_loaded_artifacts_replay_graphs_bit_for_bit(cuda):
    """A loaded update and predict artifact on CUDA inputs: each call after
    the capture is one graph replay (one FITC launch, one gram launch)
    whose results equal the module's own call bit for bit, across 5 chained
    updates and two query counts of the dynamic predict."""
    from erl_gaussian_process_tpu_torch.geometry import free_sample_fractions
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        spgp_prepare,
    )
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        step_seed,
    )
    from erl_gaussian_process_tpu_torch.utils.deploy import (
        export_map_predict_step,
        export_map_update_step,
        load_fn,
    )

    s = SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=2, scale=0.3),
                          max_num_samples=256),
        min_distance=0.0, max_distance=30.0, free_points_per_meter=2.0,
        free_sampling_margin=0.02, logodd_free=-1.0, logodd_occupied=1.0,
        logodd_variance=1e-4)
    c = np.linspace(-1, 1, 8)
    pseudo = np.stack([a.ravel() for a in np.meshgrid(c, c, indexing="ij")],
                      -1)
    st = spgp_init(torch.as_tensor(pseudo, dtype=torch.float32, device=cuda),
                   0.3, kernel="matern32")
    step = load_fn(export_map_update_step(s, n_pseudo=64, n_rays=32,
                                          free_slots=4, device=cuda))
    predict = load_fn(export_map_predict_step(n_pseudo=64, scale=0.3,
                                              device=cuda))
    lo = torch.full((2,), -3.0, device=cuda)
    hi = torch.full((2,), 3.0, device=cuda)
    g = torch.Generator(device=cuda)
    st_g = st_e = st
    for k in range(5):
        ang = np.linspace(-2.0, 2.0, 32) + 0.1 * k
        pts = torch.as_tensor(np.stack([2 * np.cos(ang), 2 * np.sin(ang)],
                                       -1), dtype=torch.float32, device=cuda)
        scan = (torch.full((2,), 0.05 * k, device=cuda), pts,
                torch.ones(32, dtype=torch.bool, device=cuda), lo, hi)
        g.manual_seed(step_seed(0, k + 1))
        u = free_sample_fractions(32, 4, 0.02, g, torch.float32, cuda)
        before = launch_counts()["fitc"]
        st_g, n_g = step(st_g, u, *scan)
        torch.cuda.synchronize()
        assert launch_counts()["fitc"] - before == (2 if k == 0 else 1)
        st_e, n_e = step.eager(st_e, u, *scan)
        assert _bits(tuple(st_g), tuple(st_e)) and int(n_g) == int(n_e)
    assert len(step.captures) == 1 and step.captures[0].replays == 5
    L_qm, a = spgp_prepare(st_g)
    for n in (100, 37, 100):
        q = torch.rand(n, 2, device=cuda) * 2 - 1
        mean, _ = predict(st_g, L_qm, a, q)
        ref, _ = predict.eager(st_g, L_qm, a, q)
        assert _bits(mean, ref)
    assert len(predict.captures) == 2


# -- the exact GPs' CUDA graphs ----------------------------------------------

EXACT_VARIANTS = ["vanilla", "vanilla_rr", "nigp", "nigp_mix", "nigp_nograd",
                  "nigp_rr", "nigp_rr_nograd"]


def _exact_case(cuda, variant, dtype):
    """(a model with graphs on the card, its two train calls of one shape,
    its two query batches of 64, and what a result gives) for one variant
    of ``VanillaGaussianProcess`` / ``NoisyInputGaussianProcess``: exact or
    reduced-rank (a 16 x 16 basis), with or without gradient observations,
    a scale mixture (the plain-A Cholesky)."""
    from erl_gaussian_process_tpu_torch.kernels import ReducedRankSetting
    from erl_gaussian_process_tpu_torch.models import (
        NoisyInputGaussianProcess,
        NoisyInputGPSetting,
        VanillaGaussianProcess,
        VanillaGPSetting,
    )

    nigp, rr = variant.startswith("nigp"), "_rr" in variant
    grad = nigp and not variant.endswith("nograd")
    rng = np.random.default_rng(5)
    n = 300 if nigp else 600
    x = rng.uniform(-0.9, 0.9, (2, n))
    ys = [np.sin(3 * x[0]) * np.cos(2 * x[1]), np.cos(2 * x[0]) * x[1]]
    gs = [np.stack([3 * np.cos(3 * x[0]) * np.cos(2 * x[1]),
                    -2 * np.sin(3 * x[0]) * np.sin(2 * x[1])]),
          np.stack([-2 * np.sin(2 * x[0]) * x[1], np.cos(2 * x[0])])]
    queries = [rng.uniform(-0.8, 0.8, (2, 64)) for _ in range(2)]
    if rr:
        kt, ks = ("rr_rbf" if nigp else "rr_matern32"), ReducedRankSetting(
            x_dim=2, scale=0.6, num_basis=[16, 16], boundary=[2.0, 2.0],
            coord_origin=[0.0, 0.0])
    elif variant == "nigp_mix":
        register_scale_mixture("rbf", 0.5, (0.7, 0.3))
        kt, ks = "rbf", KernelSetting(x_dim=2, scale=0.5, scale_mix=0.5,
                                      weights=[0.7, 0.3])
    else:
        kt, ks = "rbf", KernelSetting(x_dim=2, scale=0.5)
    if nigp:
        gp = NoisyInputGaussianProcess(NoisyInputGPSetting(
            kernel_type=kt, kernel=ks, max_num_samples=n + 20,
            no_gradient_observation=not grad), dtype=dtype, device=cuda)
        trains = [lambda k=k: gp.train(x, ys[k], gs[k], 1e-4, 1e-2, 1e-2)
                  for k in range(2)]
        tests = [lambda q=q: gp.test(q, True) for q in queries]

        def outputs(r):
            out = (r.get_mean_variance(), r.get_mean(0))
            return out + ((r.get_gradient_variance(), r.get_covariance(),
                           r.get_gradient(0)) if grad else ())
    else:
        gp = VanillaGaussianProcess(VanillaGPSetting(
            kernel_type=kt, kernel=ks, max_num_samples=n + 20), dtype=dtype,
            device=cuda)
        trains = [lambda k=k: gp.train(x, ys[k], 1e-2) for k in range(2)]
        tests = [lambda q=q: gp.test(q) for q in queries]

        def outputs(r):
            return r.get_variance(), r.get_mean(0)
    assert gp._graphs is not None
    return gp, trains, tests, outputs


def _state_copy(gp):
    return tuple(None if t is None else t.clone() for t in gp.state)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant", EXACT_VARIANTS)
def test_exact_graphs_equal_the_eager_chain(cuda, variant, dtype):
    """The graphed fit and test of each exact-GP variant (twice: the
    capture, then a replay on other data of the same shape; the second
    variance query takes the L^-1 path) against the same model's eager
    chain (its graphs set aside), bit for bit: L, alpha, Dinv, ktest,
    means, gradients, variances and covariances."""
    gp, trains, tests, outputs = _exact_case(cuda, variant, dtype)
    for train in trains:
        got = []
        for graphed in (True, False):
            run = (lambda f: f()) if graphed else (lambda f: _eager(gp, f))
            assert run(train)
            state = _state_copy(gp)
            res = [run(t) for t in tests]
            got.append((state, [r.k_test for r in res],
                        [run(lambda r=r: outputs(r)) for r in res]))
        assert _bits(got[0][0], got[1][0])
        for a, b in zip(got[0][1], got[1][1]):
            assert _bits(a, b)
        for a, b in zip(got[0][2], got[1][2]):
            assert _bits(tuple(a), tuple(b))
    kinds = sorted(g.key[0] for g in gp._graphs.captures)
    assert kinds == ["fast", "fit", "l_inv", "test", "variance"], kinds


def test_exact_graph_replays_launch_the_fit_once(cuda):
    """After the capture, N graphed exact-GP trains launch the gram-fused
    Cholesky N times (its updates on the wgmma kernel, counted N times too)
    and the substitution 2N times (the replays add what the graph
    captured), and N graphed tests the gram N times."""
    gp, trains, tests, outputs = _exact_case(cuda, "vanilla", np.float32)
    assert trains[0]()
    tests[0]().get_mean()
    fit = gp._graphs.captures[0]
    assert fit.key[0] == "fit" and \
        {w.__name__: k for w, k in fit.launches.items()} == \
        {"chol_blocked_gram": 1, "chol_update_wgmma": 1, "substitute_cuda": 2}
    before = launch_counts()
    for k in range(4):
        assert trains[k % 2]()
        tests[k % 2]().get_mean()
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["chol_gram"] - before["chol_gram"] == 4
    assert after["chol_update_wgmma"] - before["chol_update_wgmma"] == 4
    assert after["trsv"] - before["trsv"] == 8
    assert after["gram"] - before["gram"] == 4
    assert fit.replays == 5


def test_graphed_exact_test_makes_no_synchronising_call(cuda):
    """Once its graphs are captured, a test (ktest and the mean) and its
    variance are input copies and replays: nothing waits for the card
    until the host reads a result."""
    gp, trains, tests, outputs = _exact_case(cuda, "nigp", np.float32)
    assert trains[0]()
    outputs(tests[0]())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = tests[0]()
        # the variance graph is captured: the body is not called again
        gp._graphs.variance(res._held, "variance", None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# -- the mesh's CUDA graphs: an NCCL world of one rank on the card ----------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-rank NCCL process group in this process and its mesh on
    cuda:0 (NCCL takes one rank a card). Its collectives are captured into
    the models' graphs (``runs_graphs``)."""
    import datetime

    import torch.distributed as dist

    from erl_gaussian_process_tpu_torch.parallel import make_mesh
    from erl_gaussian_process_tpu_torch.parallel.mesh import runs_graphs

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with python -m "
                    "pytest --noconftest -m cuda tests/test_torch_cuda.py")
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(1)
        assert not mesh.host_staging and runs_graphs(mesh.device, mesh)
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def hotel0_16():
    """hotel-0's first 16 poses (float32), its drift grid and its map."""
    from erl_gaussian_process_tpu_torch.workloads import (
        FREE_SLOTS_PER_RAY,
        hotel0_query_grid,
        hotel0_workload,
    )

    sensors, pts, masks, _, _, setting, pseudo, lo, hi = hotel0_workload(
        n_poses=16)

    def make(mesh=None, device="cuda"):
        return SpGpOccupancyMap(setting, pseudo, Aabb.from_min_max(lo, hi),
                                seed=0, dtype=np.float32,
                                free_slots_per_ray=FREE_SLOTS_PER_RAY,
                                mesh=mesh, device=device)

    return make, sensors, pts, masks, hotel0_query_grid(lo, hi)


def _run_map(m, sensors, pts, masks, c):
    if c == 1:
        used = torch.stack([m.update(sensors[i], pts[i], masks[i])
                            for i in range(len(sensors))])
    else:
        used = m.update_batch(sensors, pts, masks, poses_per_step=c)
    torch.cuda.synchronize()
    return used


@pytest.mark.parametrize("c", [1, 4])
def test_mesh_map_graphs_equal_eager_mesh_and_one_card(nccl_mesh, hotel0_16,
                                                       c):
    """hotel-0's first 16 poses through the map on the NCCL mesh, graphed
    (one replay a chunk, the all_reduce pair inside it) against the same
    mesh map run eagerly and the one-card graphed map, bit for bit: Q_M,
    alpha, their compensations and the samples used. A replay launches
    FITC once."""
    make, sensors, pts, masks, _ = hotel0_16
    graphed, eager, one = make(nccl_mesh), make(nccl_mesh), make()
    eager._graphs = None
    assert graphed._graphs is not None and graphed._graphs.mesh is nccl_mesh
    before = launch_counts()["fitc"]
    used = _run_map(graphed, sensors, pts, masks, c)
    ups = [g for g in graphed._graphs.captures if g.key[0] == "update"]
    assert len(ups) == 1 and ups[0].launches == {fitc_update_cuda: 1}
    assert ups[0].replays == len(sensors) // c
    assert launch_counts()["fitc"] - before == len(sensors) // c + 1
    for other in (eager, one):
        assert _bits(used, _run_map(other, sensors, pts, masks, c))
        for k in ("qm", "alpha", "qm_c", "alpha_c"):
            assert _bits(getattr(graphed.state, k), getattr(other.state, k))


def test_mesh_graphed_sharded_predict(nccl_mesh, hotel0_16):
    """The graphed sharded predict (the rank's queries through the gram and
    the gather, one replay) of hotel-0's drift grid against the eager
    sharded predict and the one-card graphed predict on the same state,
    bit for bit; a predict with the gradient replays the one-card graph
    (no collective), bit for bit the one-card map's."""
    make, sensors, pts, masks, grid = hotel0_16
    m, one = make(nccl_mesh), make()
    for x in (m, one):
        x.update_batch(sensors, pts, masks, poses_per_step=4)
    before = launch_counts()["gram"]
    lo = m.predict(grid)[0]
    lo_again = m.predict(grid)[0]
    keys = [g.key for g in m._graphs.captures if g.key[0] == "predict"]
    assert keys == [("predict", len(grid), False, m.sp_gp._kernel,
                     float(m.sp_gp._scale), 0.0)]
    assert launch_counts()["gram"] - before == 3
    graphs, m._graphs = m._graphs, None
    ref = m.predict(grid)[0]
    m._graphs = graphs
    assert _bits(lo, ref) and _bits(lo_again, ref)
    assert _bits(lo, one.predict(grid)[0])
    q = grid[::37]
    assert _bits(m.predict(q, True), one.predict(q, True))


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_mesh_sensor_graphs_equal_eager_mesh_train(nccl_mesh, kind):
    """The 3D lidar and 2D lidar GPs on the NCCL mesh: each train one
    replay (the rank's bank fit and the three gathers inside), bit for
    bit the same model's eager mesh train and the one-card graphed
    train; the routed test on the gathered bank too (against the eager
    mesh chain: ``_same_test``)."""
    gp, scans, pose, q = _sensor_case(torch.device("cuda"), kind, np.float32,
                                      mesh=nccl_mesh)
    one = _sensor_case(torch.device("cuda"), kind, np.float32)[0]
    assert gp._graphs is not None
    for s in range(2):
        before = launch_counts()["bank_fit"]
        assert gp.train(*pose, scans[s]) and one.train(*pose, scans[s])
        bank = tuple(t.clone() if t is not None else None for t in gp.bank)
        got = _result(gp, q)
        torch.cuda.synchronize()
        if s == 1:
            assert launch_counts()["bank_fit"] - before == 2
        assert _bits(bank, tuple(one.bank))
        assert _bits(got, _result(one, q))
        assert _eager(gp, lambda: gp.train(*pose, scans[s]))
        assert _bits(bank, tuple(gp.bank))
        assert _same_test(kind, got, _eager(gp, lambda: _result(gp, q)))
    fits = [g for g in gp._graphs.captures if g.key[0] == "fit"]
    assert len(fits) == 1 and fits[0].replays == 2
