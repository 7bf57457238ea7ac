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
    plain versions are patched to raise."""
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
    strict upper part, Dinv against the plain version's, one launch, and
    two launches bitwise equal."""
    from erl_gaussian_process_tpu_torch.ops import (
        chol_blocked,
        chol_blocked_plain,
    )

    n = _chol_sizes(dtype)[i]
    A = _spd(cuda, n, dtype, seed=n)
    before = launch_counts()["chol"]
    L, D = chol_blocked(A, return_dinv=True)
    torch.cuda.synchronize()
    assert launch_counts()["chol"] == before + 1
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
    scan's slice equals its own train bit for bit; the routed test is one
    batched gram launch and agrees with the CPU model."""
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
    assert after["chol"] == before["chol"] + 2
    assert after["trsv"] >= before["trsv"] + 4
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


def test_artifact_round_trip_on_the_card(cuda):
    """The map's update and predict artifacts exported on the card,
    through bytes, equal the eager step bit for bit and launch the FITC and
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
    before = launch_counts()["gram"]
    mean, _ = predict(got, L_qm, a, q)
    torch.cuda.synchronize()
    assert launch_counts()["gram"] == before + 1
    ref_mean, _ = predict_prepared_step(got, L_qm, a, q, 0.3,
                                        kernel="matern32", with_grad=False)
    assert torch.equal(mean, ref_mean)
