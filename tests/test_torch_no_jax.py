"""The PyTorch port runs where neither JAX nor PyYAML is installed: in a
fresh interpreter, importing it and driving a tiny occupancy map (a few CPU
updates and a predict) must not import ``jax``, ``yaml`` or the JAX
package."""

import os
import subprocess
import sys

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
