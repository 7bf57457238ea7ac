"""The PyTorch port runs where neither JAX nor PyYAML is installed: in a
fresh interpreter, importing it and driving a tiny occupancy map (a few CPU
updates and a predict), a small 3D range-sensor GP (train, replay, test,
compute_occ, save/load), a BatchGPBank, an exact GP and a noisy-input GP
with gradients, the 2D lidar GP on a logged scan (with the setting
registry), the 2D simulators, a reduced-rank GP, the native host runtime
(an ``.egpt`` checkpoint, the raycasters), the timers, scale selection and
fitting, a ``torch.export`` artifact, the D/F API, ``poses_per_step`` and
the sharded paths (``parallel/``, one gloo rank: a map and a 3D sensor GP
with ``mesh=``), the CUDA-graph module and the example scripts (imported)
must not import ``jax``, ``yaml`` or the JAX package; and the host
runtime's C++ source is the port's own copy."""

import ast
import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import sys
import numpy as np
import erl_gaussian_process_tpu_torch as port
from erl_gaussian_process_tpu_torch.geometry import Aabb
from erl_gaussian_process_tpu_torch.kernels import KernelSetting
from erl_gaussian_process_tpu_torch.models import (
    SpGpOccupancyMap, SpGpOccupancyMapSetting, SpGpSetting)

setting = SpGpOccupancyMapSetting(
    sp_gp=SpGpSetting(kernel_type="matern32",
                      kernel=KernelSetting(x_dim=2, scale=0.4),
                      max_num_samples=128),
    min_distance=0.0, max_distance=5.0, free_points_per_meter=2.0,
    free_sampling_margin=0.02, logodd_free=-1.0, logodd_occupied=1.0,
    logodd_variance=1e-4)
c = np.linspace(-2, 2, 7)
g = np.stack([a.ravel() for a in np.meshgrid(c, c, indexing="ij")])
m = SpGpOccupancyMap(setting, g, Aabb.from_min_max([-2, -2], [2, 2]),
                     dtype=np.float32, free_slots_per_ray=4, device="cpu")
rng = np.random.default_rng(0)
ang = np.linspace(0, 2 * np.pi, 60, endpoint=False)
ring = 1.5 * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
for _ in range(3):
    m.update(rng.uniform(-0.2, 0.2, 2), ring)
lo, _ = m.predict(np.array([[0.0, 0.0], [1.5, 0.0]]))
assert lo.shape == (2,) and bool((lo[:1] < 0).all()), lo

import os, tempfile
from erl_gaussian_process_tpu_torch.geometry import LidarFrame3DSetting
from erl_gaussian_process_tpu_torch.models import (
    BatchGPBank, RangeSensorGaussianProcess3D, RangeSensorGP3DSetting,
    VanillaGPSetting)
from erl_gaussian_process_tpu_torch.utils.convert import (
    range_sensor_gp_3d_from_numpy)
gp = RangeSensorGaussianProcess3D(RangeSensorGP3DSetting(
    sensor_frame=LidarFrame3DSetting(
        azimuth_min=-1.5, azimuth_max=1.5, elevation_min=-0.5,
        elevation_max=0.5, num_azimuth_lines=40, num_elevation_lines=16),
    gp=VanillaGPSetting(kernel_type="ou",
                        kernel=KernelSetting(x_dim=2, scale=0.5))),
    dtype=np.float32, device="cpu")
ranges = 3.0 + 0.2 * rng.uniform(size=(40, 16))
assert gp.train(np.eye(3), np.zeros(3), ranges)
stacked = gp.train_scan_batch(np.stack([ranges, ranges + 0.1]))
gp.use_scan_bank(stacked, 0)
dirs = gp.sensor_frame.ray_directions_in_frame().reshape(-1, 3)
pred, valid = gp.test(dirs, True, True).get_mean()
assert valid.mean() > 0.5
valid_occ = gp.compute_occ(dirs * 1.5)[0]
path = os.path.join(tempfile.mkdtemp(), "gp3d.npz")
gp.save(path)
gp2 = RangeSensorGaussianProcess3D(device="cpu")
gp2.load(path)
assert gp2 == gp
assert range_sensor_gp_3d_from_numpy(gp.state_dict(), device="cpu") == gp
bank = BatchGPBank(2, 8, device="cpu")
bank.load_gp_data(0, 3, 2 * np.eye(3), np.ones(3))
bank.solve()
assert np.allclose(bank.get_gp_result(0)[1][:3, 0], 0.5)
from erl_gaussian_process_tpu_torch.models import (
    NoisyInputGaussianProcess, NoisyInputGPSetting, VanillaGaussianProcess)
x = np.linspace(0, 2 * np.pi, 40)
vgp = VanillaGaussianProcess(VanillaGPSetting(
    kernel_type="rbf", kernel=KernelSetting(x_dim=1, scale=0.5),
    max_num_samples=40), dtype=np.float32, device="cpu")
assert vgp.train(x[None], np.sin(x), 1e-3)
vres = vgp.test(x[None] + 0.05)
assert np.abs(vres.get_mean() - np.sin(x + 0.05)).max() < 1e-2
assert (vres.get_variance() >= 0).all()
ngp = NoisyInputGaussianProcess(NoisyInputGPSetting(
    kernel_type="matern32", kernel=KernelSetting(x_dim=1, scale=0.5),
    max_num_samples=40), device="cpu")
assert ngp.train(x[None], np.sin(x), np.cos(x)[None], 1e-4, 1e-4, 1e-4)
q = x[:-1] + 0.05
nres = ngp.test(q[None], predict_gradient=True)
assert np.abs(nres.get_gradient()[0] - np.cos(q)).max() < 0.1
assert nres.get_covariance().shape == (1, 39)
from erl_gaussian_process_tpu_torch.geometry import (
    Lidar2D, reference_space_2d, reference_trajectory_2d)
from erl_gaussian_process_tpu_torch.models import (
    LidarGaussianProcess2D, LidarGP2DSetting)
from erl_gaussian_process_tpu_torch.kernels import ReducedRankSetting
from erl_gaussian_process_tpu_torch.utils import create_setting
from erl_gaussian_process_tpu_torch.utils.loaders import load_lidar_log
f = load_lidar_log(os.path.join("data", "double", "train.dat"))[0]
ls = create_setting("erl::gaussian_process::LidarGaussianProcess2D<double>"
                    "::Setting", {"sensor_frame": {
                        "angle_min": float(f.angles[0]),
                        "angle_max": float(f.angles[-1]), "num_rays": 270}})
assert isinstance(ls, LidarGP2DSetting)
lgp = LidarGaussianProcess2D(ls, device="cpu")
assert lgp.train(np.eye(2), np.zeros(2), f.ranges)
assert lgp.test(f.angles, True, True).get_mean()[1].any()
scan = Lidar2D(Lidar2D.Setting(num_lines=16), reference_space_2d()).scan(
    0.0, reference_trajectory_2d(4)[1, :2])
assert np.isfinite(scan).all()
rr = VanillaGaussianProcess(VanillaGPSetting(
    kernel_type="rr_rbf", kernel=ReducedRankSetting(
        x_dim=1, scale=0.5, num_basis=[32], boundary=[8.0])), device="cpu")
assert rr.train(x[None], np.sin(x), 1e-3)
assert (rr.test(x[None]).get_variance() > 0).all()
import torch
from erl_gaussian_process_tpu_torch import api
from erl_gaussian_process_tpu_torch.utils import (
    BlockTimer, memory_usage, native, report_time, select_scale_spgp, trace)
from erl_gaussian_process_tpu_torch.utils.deploy import (
    export_map_predict_step, load_fn)
from erl_gaussian_process_tpu_torch.utils.model_selection import fit_scale
assert native.native_available()
assert os.sep.join(["erl_gaussian_process_tpu_torch", "csrc", "host"]) \
    in native.SRC
ck = os.path.join(tempfile.mkdtemp(), "map.egpt")
m.save(ck)
m2 = SpGpOccupancyMap(setting, g, Aabb.from_min_max([-2, -2], [2, 2]),
                      dtype=np.float32, free_slots_per_ray=4, device="cpu")
m2.load(ck)
assert m2 == m
m.update_batch(np.zeros((3, 2)), np.stack([ring] * 3), poses_per_step=2)
with BlockTimer("t", log=False), trace(None):
    report_time("r", 1, lambda: m.predict(ring[:2]), warmup=0)
assert memory_usage(m.state) > 0
best, _, _ = select_scale_spgp(g.T, ring, np.sign(ring[:, 0]),
                               np.full(60, 1e-2), kernel="matern32",
                               scales=[0.3, 0.6], refine=0, device="cpu")
fit_scale(x[:, None], np.sin(x), np.full(40, 1e-3), kernel="rbf", steps=2,
          device="cpu")
blob = export_map_predict_step(n_pseudo=m.state.pseudo.shape[0], scale=0.4,
                               kernel="matern32", device="cpu")
L, a = m.sp_gp._prepared()
mean, _ = load_fn(blob)(m.state, L, a, torch.zeros(5, 2))
assert mean.shape == (5, 1)
assert api.VanillaGaussianProcessF(device="cpu").dtype == np.float32
from erl_gaussian_process_tpu_torch.models import pose_graph
from erl_gaussian_process_tpu_torch.examples import (
    deploy_serving, gp_regression, occupancy_mapping_2d, replica_hotel_3d)
assert pose_graph.MAX_GRAPHS > 0 and occupancy_mapping_2d.production_setting()
import datetime
import torch.distributed as dist
from erl_gaussian_process_tpu_torch.parallel import make_mesh
from erl_gaussian_process_tpu_torch.parallel.spawn import spawn_world
dist.init_process_group(
    "gloo", init_method="file://" + os.path.join(tempfile.mkdtemp(), "s"),
    rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
mesh = make_mesh(1, device="cpu")
ms = SpGpOccupancyMap(setting, g, Aabb.from_min_max([-2, -2], [2, 2]),
                      dtype=np.float32, free_slots_per_ray=4, mesh=mesh,
                      device="cpu")
ms.update(np.zeros(2), ring)
ms.update_batch(np.zeros((2, 2)), np.stack([ring] * 2), poses_per_step=2)
assert ms.predict(np.array([[0.0, 0.0]]))[0].shape == (1,)
gps = RangeSensorGaussianProcess3D(gp.setting, dtype=np.float32, mesh=mesh,
                                   device="cpu")
assert gps.train(np.eye(3), np.zeros(3), ranges)
dist.destroy_process_group()
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "yaml",
                                    "erl_gaussian_process_tpu"))
print("BAD", bad)
"""


def test_port_runs_without_jax_or_yaml():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("script", [
    "chip_smoke.py", "main_path_ab.py",
    "erl_gaussian_process_tpu_torch/models/pose_graph.py",
    *(f"erl_gaussian_process_tpu_torch/examples/{name}.py" for name in (
        "gp_regression", "occupancy_mapping_2d", "replica_hotel_3d",
        "deploy_serving"))])
def test_card_scripts_import_no_jax(script):
    """The scripts and modules run on the card's machine (no JAX, no
    PyYAML) name neither, nor the JAX package, in any import statement:
    the two scripts, the CUDA-graph module and the example scripts."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, script)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "erl_gaussian_process_tpu_torch" in names, names
    assert not names & {"jax", "jaxlib", "yaml", "erl_gaussian_process_tpu"}, \
        names
