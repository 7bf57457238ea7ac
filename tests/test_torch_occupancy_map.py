"""The PyTorch port's occupancy map (erl_gaussian_process_tpu_torch/models/
spgp_occupancy_map.py and geometry/occupancy_dataset.py) against the JAX
package. PyTorch cannot reproduce ``jax.random``, so the parity tests
compute JAX's free-sample draws ``u`` with ``jax.random`` here and inject
them into the port's sampler; everything else is the same inputs made from
a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.models.spgp_occupancy_map as jmap
from erl_gaussian_process_tpu.geometry import Aabb as JaxAabb
from erl_gaussian_process_tpu.geometry.occupancy_dataset import (
    generate_dataset_fixed as jax_generate_dataset_fixed,
)
from erl_gaussian_process_tpu.kernels import KernelSetting as JaxKernelSetting
from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
    SpGpSetting as JaxSpGpSetting,
)
from erl_gaussian_process_tpu_torch.geometry import (
    Aabb,
    compact_slots,
    generate_dataset_fixed,
)
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMap
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SpGpSetting,
    spgp_update,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMapSetting,
    sample_pose,
    update_step,
)
from erl_gaussian_process_tpu_torch.utils.convert import (
    occupancy_map_from_numpy,
    seed_from_key,
    spgp_state_from_numpy,
)

RADIUS = 1.5
FREE_SLOTS = 4
SETTING = dict(min_distance=0.05, max_distance=10.0,
               free_points_per_meter=2.0, free_sampling_margin=0.02,
               logodd_free=-1.0, logodd_occupied=1.0, logodd_variance=1e-4)


def _settings(max_samples=256):
    sp = dict(kernel_type="matern32", max_num_samples=max_samples)
    return (jmap.SpGpOccupancyMapSetting(
                sp_gp=JaxSpGpSetting(
                    kernel=JaxKernelSetting(x_dim=3, scale=0.6), **sp),
                **SETTING),
            SpGpOccupancyMapSetting(
                sp_gp=SpGpSetting(kernel=KernelSetting(x_dim=3, scale=0.6),
                                  **sp),
                **SETTING))


def _pseudo(k=5):
    c = np.linspace(-2, 2, k)
    g = np.meshgrid(c, c, c, indexing="ij")
    return np.stack([a.ravel() for a in g], axis=0)            # (3, k^3)


def _sphere_scans(rng, poses, rays):
    """Scans of a sphere shell seen from inside: (B, 3), (B, rays, 3),
    (B, rays) with ~10% of the rays dropped."""
    sensors, pts, masks = [], [], []
    for _ in range(poses):
        o = rng.uniform(-0.4, 0.4, 3)
        d = rng.normal(size=(rays, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        b = d @ o
        t = -b + np.sqrt(b * b + (RADIUS ** 2 - o @ o))
        sensors.append(o)
        pts.append(o + t[:, None] * d)
        masks.append(rng.uniform(size=rays) < 0.9)
    return np.stack(sensors), np.stack(pts), np.stack(masks)


def _jax_u(key, step, n, free_slots=FREE_SLOTS, dtype=np.float64):
    """The draws JAX's sampler makes for pose ``step``."""
    m = SETTING["free_sampling_margin"]
    return np.asarray(jax.random.uniform(
        jax.random.fold_in(key, step), (n, free_slots), minval=m,
        maxval=1.0 - m, dtype=dtype))


def _kw(omap):
    s = omap.setting
    return dict(kernel=omap.sp_gp._kernel, diagonal_qm=False,
                free_slots=omap.free_slots,
                max_samples=int(s.sp_gp.max_num_samples),
                min_distance=s.min_distance, max_distance=s.max_distance,
                free_sampling_margin=s.free_sampling_margin,
                free_points_per_meter=s.free_points_per_meter,
                logodd_occupied=s.logodd_occupied,
                logodd_free=s.logodd_free,
                logodd_variance=s.logodd_variance)


def _maps(dtype=np.float64, seed=7, max_samples=256):
    js, ts = _settings(max_samples)
    box = ([-2.0] * 3, [2.0] * 3)
    jm = jmap.SpGpOccupancyMap(js, _pseudo(), JaxAabb.from_min_max(*box),
                               seed=seed, dtype=dtype,
                               free_slots_per_ray=FREE_SLOTS)
    tm = SpGpOccupancyMap(ts, _pseudo(), Aabb.from_min_max(*box), seed=seed,
                          dtype=dtype, free_slots_per_ray=FREE_SLOTS)
    return jm, tm


def assert_coords_match(got, ref):
    """Free-sample coordinates ``sensor + t * delta`` at float64 agree to
    a few roundings, not bit for bit, for two measured reasons: XLA's CPU
    backend contracts that multiply-add into a fused multiply-add (one
    rounding where PyTorch rounds the product and the sum), and PyTorch's
    vectorized CPU ``sqrt`` is not always correctly rounded (the ray length
    can differ by one ulp). So the bound is a few ulp of the operands'
    magnitude (absolute), not of the possibly tiny result."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=0,
        atol=4 * np.finfo(np.float64).eps * np.abs(ref).max())


def test_sampler_matches_jax_f64_with_injected_u():
    """Every slot over rays that are dropped, too short, too long or end
    outside the box: masks, labels and hit points bit for bit, free-sample
    coordinates to the rounding of one product (see
    assert_coords_match)."""
    rng = np.random.default_rng(0)
    n, F = 96, 6
    sensor = np.array([0.1, -0.2, 0.05])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rng_len = rng.uniform(0.0, 3.5, n)
    pts = sensor + rng_len[:, None] * d
    mask = rng.uniform(size=n) < 0.9
    lo, hi = np.array([-2.0, -2.0, -1.5]), np.array([2.0, 2.0, 1.5])
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    args = (0.2, 2.5, 0.02, 2.0)
    jp, jl, jmk = jax_generate_dataset_fixed(
        key, jnp.asarray(sensor), jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(lo), jnp.asarray(hi), *args, free_slots_per_ray=F)
    u = np.asarray(jax.random.uniform(key, (n, F), minval=0.02,
                                      maxval=1.0 - 0.02, dtype=np.float64))
    tp, tl, tmk = generate_dataset_fixed(
        *[torch.tensor(a) for a in (sensor, pts, mask, lo, hi)], *args,
        free_slots_per_ray=F, u=torch.tensor(u))
    assert tp.shape == (n * (1 + F), 3)
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))
    np.testing.assert_array_equal(tp[:n].numpy(), np.asarray(jp)[:n])
    assert_coords_match(tp[n:], np.asarray(jp)[n:])
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert 0 < int(tmk.sum()) < len(tmk)


def test_sample_pose_active_prefix_matches_jax():
    """Cap and compaction: the active prefix matches JAX — slots, labels
    and variances bit for bit, coordinates as in assert_coords_match (the
    inactive tail is whatever top-k picked among ties, masked out)."""
    jm, tm = _maps()
    rng = np.random.default_rng(1)
    sensors, pts, masks = _sphere_scans(rng, 1, 160)
    n_slots = 160 * (1 + FREE_SLOTS)
    assert n_slots > 256                      # compaction triggers
    kw = _kw(tm)
    kw.pop("kernel"), kw.pop("diagonal_qm")
    jx, jy, jv, jmk = jmap.sample_pose(
        jm.key, 4, jnp.asarray(sensors[0]),
        jnp.asarray(np.where(masks[0][:, None], pts[0], 0.0)),
        jnp.asarray(masks[0]), jm._aabb_min, jm._aabb_max, **kw)
    tx, ty, tv, tmk = sample_pose(
        torch.tensor(sensors[0]),
        torch.tensor(np.where(masks[0][:, None], pts[0], 0.0)),
        torch.tensor(masks[0]), tm._aabb_min, tm._aabb_max,
        u=torch.tensor(_jax_u(jm.key, 4, 160)), **kw)
    k = int(np.asarray(jmk).sum())
    assert k == int(tmk.sum()) == 256        # capped at max_num_samples
    assert tmk[:k].all() and not tmk[k:].any()
    assert_coords_match(tx[:k], np.asarray(jx)[:k])
    np.testing.assert_array_equal(ty[:k].numpy(), np.asarray(jy)[:k])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_compact_slots_preserves_actives():
    rng = np.random.default_rng(7)
    n, budget = 400, 256
    pts = torch.tensor(rng.normal(size=(n, 2)).astype(np.float32))
    lbl = torch.tensor((rng.uniform(size=n) < 0.3).astype(np.int32))
    mask = rng.uniform(size=n) < 0.5
    cp, cl, cm = compact_slots(pts, lbl, torch.tensor(mask), budget)
    act = np.flatnonzero(mask)
    k = len(act)
    assert cp.shape == (budget, 2) and int(cm.sum()) == k
    assert cm[:k].all()
    np.testing.assert_array_equal(cp[:k].numpy(), pts.numpy()[act])
    np.testing.assert_array_equal(cl[:k].numpy(), lbl.numpy()[act])


def test_update_slice_matches_jax_f64():
    """The whole update slice — sampler, cap, compaction, FITC, Kahan —
    for 5 poses of a small 3D map (5x5x5 pseudo grid, 160 rays) with
    JAX's draws injected, then the prepared posterior: port vs JAX at
    1e-10 of each result's magnitude."""
    jm, tm = _maps()
    rng = np.random.default_rng(2)
    sensors, pts, masks = _sphere_scans(rng, 5, 160)
    kw = _kw(tm)
    jst = jm.state
    tst = spgp_state_from_numpy({k: np.array(v) for k, v in
                                 jst._asdict().items()})
    for i in range(5):
        step = i + 1
        p = np.where(masks[i][:, None], pts[i], 0.0)
        jst, jn = jmap.update_step(
            jst, jm.key, step, jnp.asarray(sensors[i]), jnp.asarray(p),
            jnp.asarray(masks[i]), jm._aabb_min, jm._aabb_max,
            np.float64(0.6), **kw)
        tst, tn, _ = update_step(
            tst, torch.tensor(sensors[i]), torch.tensor(p),
            torch.tensor(masks[i]), tm._aabb_min, tm._aabb_max, 0.6,
            u=torch.tensor(_jax_u(jm.key, step, 160)), **kw)
        assert int(tn) == int(jn)
    for name in ("qm", "alpha"):
        ref = np.asarray(getattr(jst, name))
        np.testing.assert_allclose(getattr(tst, name).numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())
    jm.sp_gp.state, jm.sp_gp._cache = jst, None
    tm.sp_gp.state = tst
    tm.sp_gp.invalidate()
    q = rng.uniform(-1.8, 1.8, (64, 3))
    ref = jm.predict(q)[0]
    np.testing.assert_allclose(tm.predict(q)[0].numpy(), ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_update_batch_equals_sequential(dtype):
    """Each pose draws from a generator seeded by (seed, step) alone, so the
    batch replays exactly the sequential updates: bitwise equal."""
    _, ts = _settings()
    rng = np.random.default_rng(3)
    sensors, pts, masks = _sphere_scans(rng, 4, 120)

    def make():
        return SpGpOccupancyMap(ts, _pseudo(), Aabb.from_min_max(
            [-2] * 3, [2] * 3), seed=11, dtype=dtype,
            free_slots_per_ray=FREE_SLOTS)

    seq = make()
    used = [int(seq.update(sensors[i], pts[i], masks[i])) for i in range(4)]
    bat = make()
    n_used = bat.update_batch(sensors, pts, masks)
    assert n_used.tolist() == used and seq.step == bat.step == 4
    for a, b in zip(seq.state, bat.state):
        assert torch.equal(a, b)


def test_collect_datasets_replay_parity():
    """The collected datasets are exactly what the updates consumed
    (replaying them reproduces the state bit for bit), and their active
    prefixes match the datasets JAX's map collects for the same scans
    when JAX's draws are injected."""
    jm, tm = _maps()
    rng = np.random.default_rng(4)
    sensors, pts, masks = _sphere_scans(rng, 3, 160)
    st0 = tm.state
    n_used, (dx, dy, dm) = tm.update_batch(sensors, pts, masks,
                                           collect_datasets=True)
    assert dx.shape == (3, 256, 3) and dy.shape == (3, 256, 1)
    assert n_used.tolist() == dm.sum(dim=1).tolist()
    st = st0
    var = torch.full((256,), tm.setting.logodd_variance, dtype=torch.float64)
    for i in range(3):
        st = spgp_update(st, dx[i], dy[i], var, dm[i], 0.6,
                         kernel=tm.sp_gp._kernel)
    assert torch.equal(st.qm, tm.state.qm)
    assert torch.equal(st.alpha, tm.state.alpha)

    _, (jx, jy, jmk) = jm.update_batch(sensors, pts, masks,
                                       collect_datasets=True)
    kw = _kw(tm)
    kw.pop("kernel"), kw.pop("diagonal_qm")
    for i in range(3):
        p = np.where(masks[i][:, None], pts[i], 0.0)
        x, y, _, mk = sample_pose(
            torch.tensor(sensors[i]), torch.tensor(p), torch.tensor(masks[i]),
            tm._aabb_min, tm._aabb_max,
            u=torch.tensor(_jax_u(jm.key, i + 1, 160)), **kw)
        k = int(np.asarray(jmk[i]).sum())
        assert int(mk.sum()) == k and mk[:k].all()
        assert_coords_match(x[:k], np.asarray(jx[i])[:k])
        np.testing.assert_array_equal(y[:k, 0].numpy(),
                                      np.asarray(jy[i])[:k, 0])


def test_checkpoint_round_trip_continues_identically(tmp_path):
    """Save, load into a map built with another seed, and keep updating:
    the seed and step in the checkpoint stand in for the PRNG key, so the
    loaded map continues exactly like the original."""
    _, ts = _settings()
    rng = np.random.default_rng(5)
    sensors, pts, masks = _sphere_scans(rng, 4, 100)
    box = Aabb.from_min_max([-2] * 3, [2] * 3)
    a = SpGpOccupancyMap(ts, _pseudo(), box, seed=1, dtype=np.float32,
                         free_slots_per_ray=FREE_SLOTS)
    a.update_batch(sensors[:2], pts[:2], masks[:2])
    path = str(tmp_path / "map.npz")
    a.save(path)
    b = SpGpOccupancyMap(ts, _pseudo(), box, seed=2, dtype=np.float32,
                         free_slots_per_ray=FREE_SLOTS)
    b.load(path)
    assert a == b and b.seed == 1 and b.step == 2
    q = rng.uniform(-1.5, 1.5, (20, 3)).astype(np.float32)
    assert torch.equal(a.predict(q)[0], b.predict(q)[0])
    for m in (a, b):
        m.update_batch(sensors[2:], pts[2:], masks[2:])
    assert a == b


def test_occupancy_map_from_jax_state_predicts_the_same():
    jm, _ = _maps()
    rng = np.random.default_rng(6)
    sensors, pts, masks = _sphere_scans(rng, 3, 120)
    for i in range(3):
        jm.update(sensors[i], pts[i], masks[i])
    d = jm.state_dict()
    tm = occupancy_map_from_numpy(d, "cpu", free_slots_per_ray=FREE_SLOTS)
    assert tm.step == 3 and tm.seed == seed_from_key(d["key"])
    assert tm.free_slots == FREE_SLOTS and tm.dtype == torch.float64
    q = rng.uniform(-1.8, 1.8, (50, 3))
    ref = jm.predict(q)[0]
    np.testing.assert_allclose(tm.predict(q)[0].numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_update_online_buffers_and_flushes():
    _, ts = _settings()
    rng = np.random.default_rng(7)
    sensors, pts, masks = _sphere_scans(rng, 5, 100)
    box = Aabb.from_min_max([-2] * 3, [2] * 3)
    seq = SpGpOccupancyMap(ts, _pseudo(), box, seed=4, dtype=np.float32,
                           free_slots_per_ray=FREE_SLOTS)
    onl = SpGpOccupancyMap(ts, _pseudo(), box, seed=4, dtype=np.float32,
                           free_slots_per_ray=FREE_SLOTS)
    for i in range(5):
        seq.update(sensors[i], pts[i], masks[i])
        onl.update_online(sensors[i], pts[i], masks[i], chunk=2)
    assert len(onl._online_buf) == 1
    q = rng.uniform(-1.5, 1.5, (10, 3)).astype(np.float32)
    assert torch.equal(onl.predict(q)[0], seq.predict(q)[0])
    assert not onl._online_buf and onl.step == 5
    onl.update_online(sensors[0], pts[0], masks[0])
    with pytest.raises(ValueError, match="share one shape"):
        onl.update_online(sensors[1], pts[1][:50], masks[1][:50])


def test_online_mapping_3d_quality():
    """The JAX suite's 3D quality gate on a sphere (9x9x9 pseudo grid,
    8 poses of 400 rays, float32): surface occupied, interior free."""
    _, ts = _settings(max_samples=2000)
    ts.sp_gp.kernel.scale = 0.35
    rng = np.random.default_rng(0)
    m = SpGpOccupancyMap(ts, _pseudo(9), Aabb.from_min_max([-2] * 3, [2] * 3),
                         seed=0, dtype=np.float32, free_slots_per_ray=8)
    sensors, pts, _ = _sphere_scans(rng, 8, 400)
    for i in range(8):
        m.update(sensors[i].astype(np.float32), pts[i].astype(np.float32))
    d = rng.normal(size=(500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo_surf, _ = m.predict((RADIUS * d).astype(np.float32))
    lo_free, _ = m.predict(rng.uniform(-0.5, 0.5, (200, 3)).astype(
        np.float32))
    assert float((lo_surf > 0).float().mean()) > 0.9
    assert float((lo_free < 0).float().mean()) > 0.95
    hits, labels, idx = m.generate_dataset(sensors[0], pts[0], seed=0)
    assert hits.shape[1] == 3 and set(np.unique(labels)) <= {0.0, 1.0}


def test_paths_not_ported_yet_raise():
    _, ts = _settings()
    box = Aabb.from_min_max([-2] * 3, [2] * 3)
    with pytest.raises(NotImplementedError, match="mesh="):
        SpGpOccupancyMap(ts, _pseudo(), box, mesh=object())
    m = SpGpOccupancyMap(ts, _pseudo(), box, free_slots_per_ray=FREE_SLOTS)
    sensors, pts, masks = _sphere_scans(np.random.default_rng(8), 2, 50)
    with pytest.raises(NotImplementedError, match="poses_per_step"):
        m.update_batch(sensors, pts, masks, poses_per_step=2)
    with pytest.raises(NotImplementedError, match="Gradient predict"):
        m.predict(pts[0], compute_gradient=True)
