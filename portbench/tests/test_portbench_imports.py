"""Nothing the benchmark loads is JAX or the JAX package, and the plain
references load nothing of the program: checked in fresh processes, by
the top-level name of every loaded module (the part before the first dot)
compared whole, since the program's name begins with the JAX package's."""

import json
import os
import subprocess
import sys

from portbench import harness

JAX = ["jax", "jaxlib", "flax", "erl_gaussian_process_tpu"]
PROGRAM = "erl_gaussian_process_tpu_torch"

LOAD_CELLS = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import env
env.setup()
from portbench import harness
for w in json.load(open({bench!r}))["workloads"]:
    spec = harness.cell_spec(w["name"])
    import importlib
    importlib.import_module("portbench.adapters." + spec["config"]["adapter"])
    for m in spec["per_layer"]:
        harness.load_file_module(
            harness.HERE + "/metrics/" + m["name"] + ".py", m["name"])
import portbench.run, portbench.readings
from erl_gaussian_process_tpu_torch.ops import launch_counts
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCES = """
import json, os, sys, importlib
sys.path.insert(0, {root!r})
for f in sorted(os.listdir({ref!r})):
    if f.endswith(".py"):
        importlib.import_module("portbench.reference." + f[:-3])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    names = _top_level_names(LOAD_CELLS.format(
        root=harness.ROOT, bench=os.path.join(harness.ROOT, "BENCHMARK.json")))
    assert PROGRAM in names and "torch" in names
    assert not names & set(JAX), names & set(JAX)


def test_the_references_load_nothing_of_the_program():
    names = _top_level_names(LOAD_REFERENCES.format(
        root=harness.ROOT, ref=os.path.join(harness.HERE, "reference")))
    assert "torch" in names
    assert not names & set(JAX + [PROGRAM]), names & set(JAX + [PROGRAM])


def test_the_check_compares_whole_names():
    sys.modules["erl_gaussian_process_tpu_torch_probe"] = sys
    try:
        assert "erl_gaussian_process_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["erl_gaussian_process_tpu_torch_probe"]
