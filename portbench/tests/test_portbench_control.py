"""The control on the card: the plain reference put in the program's place
and computed in the precision below the configurations' float32 with TF32
off (float32 with TF32 matrix products) fails each cell's check, while
the program passes it, at a size a test run holds (hotel-0's full
983-pose session, since the control's error grows along it: at 96 poses
it stays under the limit; a pool of 8 lidar scans). Card only:

    python -m pytest -m cuda portbench/tests/test_portbench_control.py
"""

import time

import pytest

from portbench import harness

pytestmark = pytest.mark.cuda

SIZES = {"hotel0.stream": {}, "lidar3d.train": {"scans": 8},
         "lidar3d.query": {"scans": 8}}


def _limit_failed(nums: dict, limits: dict) -> list:
    return [k for k, v in nums.items() if not v <= limits[k]]


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_and_program_passes(cuda, tmp_path, workload):
    spec = harness.cell_spec(workload)
    spec["config"] = dict(spec["config"], **SIZES[workload])
    for seed in (5_000_000_001, 5_000_000_002, 5_000_000_003):
        out = harness.run_cell(spec, seed, 1.5, False, cuda,
                               time.perf_counter(),
                               cache_dir=str(tmp_path), control=True)
        assert out["correct"], out["checks"]
        assert _limit_failed(out["control_numbers"], spec["limits"]), \
            out["control_numbers"]
