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
@pytest.mark.parametrize("m,n", [(1152, 2048), (1089, 1500), (70, 33)])
def test_fitc_kernel_matches_plain(cuda, dtype, m, n):
    """Ragged shapes included (the kernel masks its own edges); dQ exactly
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


def test_fitc_kernel_is_deterministic(cuda):
    """No float atomics: two launches on the same inputs agree bit for bit."""
    args = _fitc_args(cuda, torch.float32, 1152, 2048, 1e-4)
    a = fitc_update_cuda(*args)
    b = fitc_update_cuda(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


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
    """A small float32 map on the card: every update launches the FITC
    kernel once, the batch replay equals the pose-by-pose updates bit for
    bit, and predict launches the gram kernel."""
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
    assert after["fitc"] - before["fitc"] == 2 * b
    assert after["gram"] > before["gram"]
    for x, y in zip(seq.state, bat.state):
        assert torch.equal(x, y)
    assert lo.is_cuda and bool((lo < 0).all())
