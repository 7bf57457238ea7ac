"""Deployment artifacts of the PyTorch port (``erl_gaussian_process_tpu_torch/
utils/deploy.py``, ``torch.export``), following tests/test_deploy.py: the
map's update and predict artifacts round-trip through bytes and equal the
live step bit for bit; the update artifact equals JAX's ``update_step``
given JAX's draws; wrong shapes are rejected; the graph carries the
``egp::`` kernel ops (the counterpart of JAX's multi-platform artifact
check); a generic export of the vanilla predict; one dynamic-batch predict
artifact serves three batch sizes; a mixture kernel is baked into the
update artifact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erl_gaussian_process_tpu.models.spgp_occupancy_map as jmap
from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
    spgp_init as jax_spgp_init,
)
from erl_gaussian_process_tpu_torch.geometry import free_sample_fractions
from erl_gaussian_process_tpu_torch.kernels import (
    KernelSetting,
    resolve_kernel_setting,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SpGpSetting,
    SpGpState,
    spgp_init,
    spgp_prepare,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMapSetting,
    predict_prepared_step,
    step_seed,
    update_step,
)
from erl_gaussian_process_tpu_torch.utils.convert import spgp_state_from_numpy
from erl_gaussian_process_tpu_torch.utils.deploy import (
    export_fn,
    export_map_predict_step,
    export_map_update_step,
    load_fn,
    load_program,
)

N_SIDE = 8      # 64 pseudo points
N_RAYS = 32
SLOTS = 4
SCALE = 0.3
MARGIN = 0.02
CPU = "cpu"
STEP_KW = dict(diagonal_qm=False, free_slots=SLOTS, max_samples=256,
               min_distance=0.0, max_distance=30.0,
               free_sampling_margin=MARGIN, free_points_per_meter=2.0,
               logodd_occupied=1.0, logodd_free=-1.0, logodd_variance=1e-4)


def _setting(**kernel):
    return SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=2, scale=SCALE,
                                               **kernel),
                          max_num_samples=256),
        min_distance=0.0, max_distance=30.0, free_points_per_meter=2.0,
        free_sampling_margin=MARGIN, logodd_free=-1.0, logodd_occupied=1.0,
        logodd_variance=1e-4)


def _pseudo(dtype=np.float32):
    c = np.linspace(-1, 1, N_SIDE, dtype=dtype)
    pv, qv = np.meshgrid(c, c, indexing="ij")
    return np.stack([pv.ravel(), qv.ravel()], axis=-1)


def _state(kernel="matern32", dtype=np.float32):
    return spgp_init(torch.as_tensor(_pseudo(dtype)), SCALE, kernel=kernel)


def _scan(dtype=torch.float32):
    ang = np.linspace(-2.0, 2.0, N_RAYS)
    pts = np.stack([2 * np.cos(ang), 2 * np.sin(ang)], axis=-1)
    return (torch.zeros(2, dtype=dtype), torch.as_tensor(pts, dtype=dtype),
            torch.ones(N_RAYS, dtype=torch.bool),
            torch.full((2,), -3.0, dtype=dtype),
            torch.full((2,), 3.0, dtype=dtype))


def _draws(step=1, dtype=torch.float32):
    g = torch.Generator()
    g.manual_seed(step_seed(0, step))
    return free_sample_fractions(N_RAYS, SLOTS, MARGIN, g, dtype, CPU)


@pytest.fixture(scope="module")
def update_blob():
    return export_map_update_step(_setting(), n_pseudo=N_SIDE**2,
                                  n_rays=N_RAYS, free_slots=SLOTS,
                                  device=CPU)


@pytest.fixture(scope="module")
def predict_blob():
    return export_map_predict_step(n_pseudo=N_SIDE**2, scale=SCALE,
                                   n_queries=16, device=CPU)


def test_map_update_artifact_round_trip(update_blob):
    assert isinstance(update_blob, bytes) and len(update_blob) > 1000
    step = load_fn(update_blob)
    st, u = _state(), _draws()
    new_state, n_used = step(st, u, *_scan())
    assert isinstance(new_state, SpGpState) and int(n_used) > 0
    assert bool(torch.isfinite(new_state.qm).all())
    ref_state, ref_n, _ = update_step(st, *_scan(), SCALE, kernel="matern32",
                                      u=u, **STEP_KW)
    assert int(ref_n) == int(n_used)
    for a, b in zip(new_state, ref_state):
        assert torch.equal(a, b)
    # u drawn as the map draws pose 1: the live step with the generator
    g = torch.Generator()
    g.manual_seed(step_seed(0, 1))
    gen_state, _, _ = update_step(st, *_scan(), SCALE, kernel="matern32",
                                  generator=g, **STEP_KW)
    assert torch.equal(gen_state.qm, new_state.qm)


def test_map_update_artifact_matches_jax_update_step():
    """At float64 the artifact, given JAX's draws for (key, step), lands on
    JAX's ``update_step`` state to 1e-10 of each result's magnitude (the
    tolerance of tests/test_torch_occupancy_map.py's slice parity)."""
    blob = export_map_update_step(_setting(), n_pseudo=N_SIDE**2,
                                  n_rays=N_RAYS, free_slots=SLOTS,
                                  dtype=torch.float64, device=CPU)
    jst = jax_spgp_init(jnp.asarray(_pseudo(np.float64)), np.float64(SCALE),
                        kernel="matern32")
    tst = spgp_state_from_numpy({k: np.array(v) for k, v in
                                 jst._asdict().items()}, device=CPU)
    key = jax.random.PRNGKey(0)
    u = np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 1), (N_RAYS, SLOTS), minval=MARGIN,
        maxval=1.0 - MARGIN, dtype=np.float64))
    scan = _scan(torch.float64)
    got, n_used = load_fn(blob)(tst, torch.tensor(u), *scan)
    ref, jn = jmap.update_step(
        jst, key, 1, *[jnp.asarray(t.numpy()) for t in scan],
        np.float64(SCALE), kernel="matern32", **STEP_KW)
    assert int(n_used) == int(jn)
    for name in ("qm", "alpha"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=0,
                                   atol=1e-10 * np.abs(r).max())


def _posterior():
    st, _, _ = update_step(_state(), *_scan(), SCALE, kernel="matern32",
                           u=_draws(), **STEP_KW)
    L_qm, a = spgp_prepare(st)
    return st, L_qm, a


def test_map_predict_artifact_round_trip(predict_blob):
    st, L_qm, a = _posterior()
    q = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 1, (16, 2)).astype(np.float32))
    mean, grad = load_fn(predict_blob)(st, L_qm, a, q)
    assert grad is None
    ref, _ = predict_prepared_step(st, L_qm, a, q, SCALE, kernel="matern32",
                                   with_grad=False)
    assert torch.equal(mean, ref)


def test_artifact_rejects_wrong_shapes(predict_blob, update_blob):
    st, L_qm, a = _posterior()
    with pytest.raises(Exception):
        load_fn(predict_blob)(st, L_qm, a, torch.zeros(7, 2))
    with pytest.raises(Exception):
        load_fn(update_blob)(st, _draws()[:-1], *_scan())


def test_artifact_graph_carries_the_kernel_ops(update_blob, predict_blob):
    """The counterpart of JAX's multi-platform artifact check: the
    artifacts' graphs call the registered ``egp::`` ops (launched as the
    CUDA kernels on CUDA tensors), not their plain versions inlined."""
    def targets(blob):
        return {str(n.target) for n in load_program(blob).graph.nodes
                if n.op == "call_function"}

    assert "egp.fitc_update.default" in targets(update_blob)
    assert "egp.cross_gram.default" in targets(predict_blob)
    assert not any("exp" in t for t in targets(update_blob))


def test_generic_export_fn_vanilla_predict():
    """``export_fn`` exports an arbitrary model function: the exact GP's
    predict, which reaches the gram op and torch ops only."""
    from erl_gaussian_process_tpu_torch.models.vanilla_gp import (
        vanilla_fit,
        vanilla_predict,
    )

    n, m, d = 64, 32, 1
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, d)).astype(np.float32))
    y = torch.sin(3 * x)
    st = vanilla_fit(x, y, torch.full((n,), 1e-3), torch.ones(n, dtype=bool),
                     0.4, kernel="rbf")
    xq = torch.as_tensor(rng.uniform(-1, 1, (m, d)).astype(np.float32))
    blob = export_fn(lambda s, q: vanilla_predict(s, q, 0.4, kernel="rbf"),
                     st, xq)
    ops = {str(nd.target) for nd in load_program(blob).graph.nodes
           if str(nd.target).startswith("egp.")}
    assert ops == {"egp.cross_gram.default"}
    mean, var = load_fn(blob)(st, xq)
    ref_mean, ref_var = vanilla_predict(st, xq, 0.4, kernel="rbf")
    assert torch.equal(mean, ref_mean) and torch.equal(var, ref_var)


def test_polymorphic_predict_artifact_serves_any_batch():
    st, L_qm, a = _posterior()
    blob = export_map_predict_step(n_pseudo=N_SIDE**2, scale=SCALE,
                                   n_queries=None, device=CPU)
    predict = load_fn(blob)
    rng = np.random.default_rng(2)
    for nq in (3, 33, 200):
        q = torch.as_tensor(rng.uniform(-1, 1, (nq, 2)).astype(np.float32))
        mean, _ = predict(st, L_qm, a, q)
        assert mean.shape == (nq, 1)
        ref, _ = predict_prepared_step(st, L_qm, a, q, SCALE,
                                       kernel="matern32", with_grad=False)
        assert torch.equal(mean, ref)


def test_map_update_artifact_bakes_mixture_kernel():
    """A scale-mixture map exports an artifact that runs the same mixture
    as the live step, and the mixture is live (it differs from the plain
    matern32 update)."""
    s = _setting(scale_mix=0.5, weights=[0.7, 0.3])
    blob = export_map_update_step(s, n_pseudo=N_SIDE**2, n_rays=N_RAYS,
                                  free_slots=SLOTS, device=CPU)
    kernel = resolve_kernel_setting(s.sp_gp.kernel_type, s.sp_gp.kernel)
    st = _state(kernel)
    u = _draws(3)
    got, n_used = load_fn(blob)(st, u, *_scan())
    ref, _, _ = update_step(st, *_scan(), SCALE, kernel=kernel, u=u,
                            **STEP_KW)
    assert int(n_used) > 0
    assert torch.equal(got.qm, ref.qm)
    plain, _, _ = update_step(_state(), *_scan(), SCALE, kernel="matern32",
                              u=u, **STEP_KW)
    assert (got.qm - plain.qm).abs().max() > 1e-6
