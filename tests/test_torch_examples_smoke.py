"""The PyTorch port's example scripts (erl_gaussian_process_tpu_torch/
examples/, counterparts of examples/*.py): each runs in a fresh subprocess
with ``--device cpu`` at the sizes tests/test_examples_smoke.py gives the
JAX scripts, exits 0, and never imports JAX, the JAX package or (without
``--config-file``) PyYAML. The 2D example's in-code production setting is
held to config/spgp_occupancy_map_2d.yaml."""

import os
import subprocess
import sys

import pytest

from erl_gaussian_process_tpu_torch.examples.occupancy_mapping_2d import (
    production_setting,
)
from erl_gaussian_process_tpu_torch.kernels import resolve_kernel_setting
from erl_gaussian_process_tpu_torch.models import SpGpOccupancyMapSetting

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
TIMEOUT_S = 120   # each takes 7-16 s on this CPU

_RUN = """
import runpy, sys
sys.argv = {argv!r}
runpy.run_module({module!r}, run_name="__main__")
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "yaml",
                                    "erl_gaussian_process_tpu"))
print("BAD", bad)
"""


@pytest.mark.parametrize("name,argv", [
    ("gp_regression", []),
    ("occupancy_mapping_2d", ["--hinged-grid-size", "15",
                              "--test-grid-size", "32", "--n-poses", "6"]),
    ("replica_hotel_3d", ["8"]),
    ("deploy_serving", []),
])
def test_port_example_runs_on_the_cpu_without_jax(name, argv):
    module = f"erl_gaussian_process_tpu_torch.examples.{name}"
    code = _RUN.format(argv=[name] + argv + ["--device", "cpu"],
                       module=module)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, (
        f"{module} failed\n--- stdout ---\n{r.stdout[-3000:]}\n"
        f"--- stderr ---\n{r.stderr[-3000:]}")
    assert "BAD []" in r.stdout, r.stdout


def test_2d_example_setting_is_the_production_yaml():
    """Every field of ``production_setting()`` equals the YAML's as the
    port loads it (the kernel by its resolved family; numbers as floats,
    since the YAML spells some as strings or ints)."""
    ref = SpGpOccupancyMapSetting.from_yaml_file(
        os.path.join(ROOT, "config", "spgp_occupancy_map_2d.yaml"))
    got = production_setting()

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, v

    ref_d, got_d = dict(flat(ref.to_dict())), dict(flat(got.to_dict()))
    assert ref_d.keys() == got_d.keys()
    for k, v in ref_d.items():
        if k == "sp_gp.kernel_type":
            assert resolve_kernel_setting(v, ref.sp_gp.kernel, "yaml") == \
                resolve_kernel_setting(got_d[k], got.sp_gp.kernel, "code")
        elif isinstance(v, (list, bool)):
            assert got_d[k] == v, k
        else:
            assert float(got_d[k]) == float(v), k
