"""The PyTorch port's native host runtime
(``erl_gaussian_process_tpu_torch/utils/native.py`` over its own copy of the
C++ source, ``csrc/host/erl_gp_native.cpp``) against the JAX package's
``utils/native.py``, following tests/test_native.py case for case: the
library builds; the lidar log parses the same on the native and Python
paths and as JAX's loader parses it; token files round-trip and are byte
for byte JAX's; ``.egpt`` model checkpoints work for every model and a
JAX-written one loads into the port with equal state; both raycasters
match numpy and JAX's native raycast bit for bit."""

import os

import numpy as np
import pytest

from erl_gaussian_process_tpu.utils import native as jnat
from erl_gaussian_process_tpu.utils.loaders import (
    load_lidar_log as jax_load_lidar_log,
)
from erl_gaussian_process_tpu_torch.utils import native as nat
from erl_gaussian_process_tpu_torch.utils.loaders import load_lidar_log

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _python_path:
    """The Python path of the port's native module for the block (as
    ``ERL_GP_NO_NATIVE`` selects it), the native one after."""

    def __enter__(self):
        os.environ["ERL_GP_NO_NATIVE"] = "1"
        nat._lib, nat._tried = None, False

    def __exit__(self, *exc):
        del os.environ["ERL_GP_NO_NATIVE"]
        nat._lib, nat._tried = None, False
        return False


def _write_synthetic_log(path, frames, dtype=np.float64):
    with open(path, "wb") as f:
        for angles, ranges, pose in frames:
            f.write(np.int32(len(angles)).tobytes())
            f.write(np.asarray(angles, dtype).tobytes())
            f.write(np.asarray(ranges, dtype).tobytes())
            f.write(np.uint64(len(pose)).tobytes())
            f.write(np.asarray(pose, dtype).tobytes())


def test_native_builds():
    assert nat.native_available(), "the host runtime should build (g++)"
    assert nat.get_lib().egp_version() == 1
    assert nat.SRC.startswith(os.path.join(
        REPO, "erl_gaussian_process_tpu_torch", "csrc", "host"))
    with _python_path():
        assert not nat.native_available()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lidar_log_native_matches_python_and_jax(tmp_path, dtype):
    rng = np.random.default_rng(0)
    frames = []
    for n in (5, 9, 3):
        frames.append((np.sort(rng.uniform(-np.pi, np.pi, n)),
                       rng.uniform(0.1, 10.0, n), rng.uniform(-1, 1, 6)))
    p = str(tmp_path / "log.dat")
    _write_synthetic_log(p, frames, dtype)
    got = load_lidar_log(p, dtype)
    with _python_path():
        ref = load_lidar_log(p, dtype)
    jax_frames = jax_load_lidar_log(p, dtype)
    assert len(got) == len(ref) == len(jax_frames) == 3
    for a, b, c in zip(got, ref, jax_frames):
        for f in ("angles", "ranges", "position", "rotation"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(getattr(a, f), getattr(c, f))
            assert getattr(a, f).dtype == getattr(c, f).dtype


def _arrays():
    rng = np.random.default_rng(1)
    return {
        "a/b": rng.standard_normal((7, 3)),
        "a/c": rng.standard_normal((4,)).astype(np.float32),
        "flags": np.array([True, False, True]),
        "idx": np.arange(5, dtype=np.int64),
        "scalar": np.asarray(3, np.int32).reshape(()),
        "m": np.array([1, 0, 1], np.uint8),
    }


def test_token_checkpoint_round_trip(tmp_path):
    arrays = _arrays()
    p = str(tmp_path / "ck.egpt")
    nat.save_tokens(p, arrays)
    back = nat.load_tokens(p)
    assert set(back) == set(arrays)
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(back[k], arrays[k])


def test_token_bytes_equal_jax_on_both_paths(tmp_path):
    """The port's native and Python writers produce JAX's ``save_tokens``
    bytes, and each reader reads the other side's file."""
    arrays = _arrays()
    p_jax = str(tmp_path / "jax.egpt")
    p_nat = str(tmp_path / "nat.egpt")
    p_py = str(tmp_path / "py.egpt")
    jnat.save_tokens(p_jax, arrays)
    nat.save_tokens(p_nat, arrays)
    with _python_path():
        nat.save_tokens(p_py, arrays)
        back_py = nat.load_tokens(p_jax)
    with open(p_jax, "rb") as f:
        ref = f.read()
    for p in (p_nat, p_py):
        with open(p, "rb") as f:
            assert f.read() == ref
    back_jax = jnat.load_tokens(p_nat)
    back_nat = nat.load_tokens(p_jax)
    for k in arrays:
        for back in (back_py, back_jax, back_nat):
            np.testing.assert_array_equal(back[k], arrays[k])


def _port_models():
    """One trained instance of every model of the port, small."""
    from erl_gaussian_process_tpu_torch.geometry import (
        Aabb,
        LidarFrame3DSetting,
    )
    from erl_gaussian_process_tpu_torch.kernels import KernelSetting
    from erl_gaussian_process_tpu_torch.models import (
        LidarGaussianProcess2D,
        LidarGP2DSetting,
        NoisyInputGaussianProcess,
        NoisyInputGPSetting,
        RangeSensorGaussianProcess3D,
        RangeSensorGP3DSetting,
        SparsePseudoInputGaussianProcess,
        SpGpOccupancyMap,
        SpGpOccupancyMapSetting,
        SpGpSetting,
        VanillaGaussianProcess,
        VanillaGPSetting,
    )

    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (1, 50))
    y = np.sin(3 * x[0])
    out = []
    vgp = VanillaGaussianProcess(VanillaGPSetting(
        kernel=KernelSetting(x_dim=1, scale=0.5), max_num_samples=50),
        device=CPU)
    vgp.train(x, y, np.full(50, 1e-4))
    out.append((vgp, lambda: VanillaGaussianProcess(device=CPU)))
    ngp = NoisyInputGaussianProcess(NoisyInputGPSetting(
        kernel=KernelSetting(x_dim=1, scale=0.5), max_num_samples=50),
        device=CPU)
    ngp.train(x, y, 3 * np.cos(3 * x), 1e-4, 1e-4, 1e-4)
    out.append((ngp, lambda: NoisyInputGaussianProcess(device=CPU)))
    pseudo = np.linspace(-1, 1, 9)[None]
    sgp = SparsePseudoInputGaussianProcess(SpGpSetting(
        kernel=KernelSetting(x_dim=1, scale=0.5)), pseudo, device=CPU)
    sgp.update(x, y, 1e-2)
    out.append((sgp, lambda: SparsePseudoInputGaussianProcess(
        None, pseudo, device=CPU)))
    c = np.linspace(-2, 2, 5)
    g = np.stack([a.ravel() for a in np.meshgrid(c, c, indexing="ij")])
    ms = SpGpOccupancyMapSetting(
        sp_gp=SpGpSetting(kernel_type="matern32",
                          kernel=KernelSetting(x_dim=2, scale=0.5),
                          max_num_samples=64), max_distance=5.0)
    box = Aabb.from_min_max([-2, -2], [2, 2])
    omap = SpGpOccupancyMap(ms, g, box, free_slots_per_ray=2, device=CPU)
    ang = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    omap.update(np.zeros(2), 1.5 * np.stack([np.cos(ang), np.sin(ang)], -1))
    out.append((omap, lambda: SpGpOccupancyMap(ms, g, box, device=CPU)))
    rgp = RangeSensorGaussianProcess3D(RangeSensorGP3DSetting(
        sensor_frame=LidarFrame3DSetting(
            azimuth_min=-1.5, azimuth_max=1.5, elevation_min=-0.5,
            elevation_max=0.5, num_azimuth_lines=20, num_elevation_lines=8),
        gp=VanillaGPSetting(kernel_type="ou",
                            kernel=KernelSetting(x_dim=2, scale=0.5))),
        dtype=np.float32, device=CPU)
    rgp.train(np.eye(3), np.zeros(3), 3.0 + 0.2 * rng.uniform(size=(20, 8)))
    out.append((rgp, lambda: RangeSensorGaussianProcess3D(device=CPU)))
    lgp = LidarGaussianProcess2D(LidarGP2DSetting.from_dict(dict(
        sensor_frame=dict(angle_min=-2.0, angle_max=2.0, num_rays=60))),
        device=CPU)
    lgp.train(np.eye(2), np.zeros(2), 2.0 + 0.1 * rng.uniform(size=60))
    out.append((lgp, lambda: LidarGaussianProcess2D(device=CPU)))
    return out


def test_model_checkpoint_egpt_all_models(tmp_path):
    """Every model of the port saves to and loads from an ``.egpt`` token
    checkpoint with its state equal (``__eq__``), on both paths; the two
    paths write the same bytes."""
    for i, (model, fresh) in enumerate(_port_models()):
        p = str(tmp_path / f"m{i}.egpt")
        model.save(p)
        back = fresh()
        back.load(p)
        assert back == model, type(model).__name__
        with _python_path():
            p2 = str(tmp_path / f"m{i}_py.egpt")
            model.save(p2)
            back2 = fresh()
            back2.load(p)
        assert back2 == model, type(model).__name__
        with open(p, "rb") as f1, open(p2, "rb") as f2:
            assert f1.read() == f2.read()


def test_jax_egpt_checkpoint_loads_into_the_port(tmp_path):
    """A vanilla GP and an SPGP saved to ``.egpt`` by the JAX package load
    through the port's ``load_pytree`` to the same state, and the port's
    models built from them hold JAX's arrays exactly."""
    from erl_gaussian_process_tpu.kernels import KernelSetting as JKS
    from erl_gaussian_process_tpu.models.sparse_pseudo_input_gp import (
        SparsePseudoInputGaussianProcess as JSpGp,
        SpGpSetting as JSpGpSetting,
    )
    from erl_gaussian_process_tpu.models.vanilla_gp import (
        VanillaGaussianProcess as JVanilla,
    )
    from erl_gaussian_process_tpu.utils.serialization import (
        load_pytree as jax_load_pytree,
    )
    from erl_gaussian_process_tpu_torch.utils.convert import (
        vanilla_gp_from_numpy,
    )
    from erl_gaussian_process_tpu_torch.utils.serialization import (
        eq_state,
        load_pytree,
    )

    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (1, 50))
    jgp = JVanilla()
    jgp.train(x, np.sin(3 * x[0])[:, None], np.full(50, 1e-4))
    p = str(tmp_path / "gp.egpt")
    jgp.save(p)
    d = load_pytree(p)
    assert eq_state(d, jax_load_pytree(p))
    gp = vanilla_gp_from_numpy(d, device=CPU)
    js = jgp.state_dict()["state"]
    for k in ("x", "L", "alpha"):
        np.testing.assert_array_equal(
            getattr(gp.state, k).numpy(), np.asarray(js[k]))

    pseudo = np.linspace(-1, 1, 9)[None]
    jsp = JSpGp(JSpGpSetting(kernel=JKS(x_dim=1, scale=0.5)), pseudo)
    jsp.update(x, np.sin(3 * x[0]), 1e-2)
    p3 = str(tmp_path / "spgp.egpt")
    jsp.save(p3)
    from erl_gaussian_process_tpu_torch.models import (
        SparsePseudoInputGaussianProcess,
    )
    sgp = SparsePseudoInputGaussianProcess(None, pseudo, device=CPU)
    sgp.load(p3)
    for k, v in jsp.state._asdict().items():
        np.testing.assert_array_equal(getattr(sgp.state, k).numpy(),
                                      np.tril(v) if k == "L_inv"
                                      else np.asarray(v))


def test_raycast_2d_native_matches_numpy_and_jax():
    from erl_gaussian_process_tpu.geometry.simulators import (
        reference_space_2d as jax_space_2d,
    )
    from erl_gaussian_process_tpu_torch.geometry import reference_space_2d

    space = reference_space_2d()
    rng = np.random.default_rng(3)
    ang = rng.uniform(-np.pi, np.pi, 257)
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1)
    origin = np.array([0.9, -0.4])
    r_native = space.cast_rays(origin, dirs)
    with _python_path():
        r_np = space.cast_rays(origin, dirs)
    finite = np.isfinite(r_np)
    assert (finite == np.isfinite(r_native)).all()
    np.testing.assert_allclose(r_native[finite], r_np[finite], rtol=1e-12)
    np.testing.assert_array_equal(r_native,
                                  jax_space_2d().cast_rays(origin, dirs))


def test_raycast_mesh_native_matches_numpy_and_jax():
    from erl_gaussian_process_tpu.utils.native import (
        raycast_mesh as jax_raycast_mesh,
    )
    from erl_gaussian_process_tpu_torch.geometry.simulators import (
        TriangleMesh,
        reference_room_mesh_3d,
    )

    mesh = reference_room_mesh_3d()
    rng = np.random.default_rng(5)
    d = rng.normal(size=(409, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    origin = mesh.center() + np.array([0.2, -0.1, 0.05])
    r_native = mesh.cast_rays(origin, d)
    with _python_path():
        r_np = mesh.cast_rays(origin, d)
    assert np.isfinite(r_native).all()
    np.testing.assert_allclose(r_native, r_np, rtol=1e-12)
    np.testing.assert_array_equal(
        r_native, jax_raycast_mesh(mesh.triangles, origin, d))
    box = TriangleMesh.box([-1, -1, -1], [1, 1, 1])
    r = box.cast_rays(np.zeros(3), np.array([[1.0, 0, 0], [0, -1.0, 0]]))
    np.testing.assert_allclose(r, [1.0, 1.0], atol=1e-12)


def test_reference_float_and_double_logs_agree():
    fd = load_lidar_log(os.path.join(REPO, "data", "double", "train.dat"),
                        dtype=np.float64)
    ff = load_lidar_log(os.path.join(REPO, "data", "float", "train.dat"),
                        dtype=np.float32)
    assert len(fd) == len(ff) > 0
    for a, b in zip(fd, ff):
        np.testing.assert_allclose(a.angles, b.angles, rtol=2e-7, atol=1e-6)
        finite = np.isfinite(a.ranges) & np.isfinite(b.ranges)
        np.testing.assert_allclose(a.ranges[finite], b.ranges[finite],
                                   rtol=2e-7, atol=1e-5)
        np.testing.assert_allclose(a.position, b.position, atol=1e-6)
