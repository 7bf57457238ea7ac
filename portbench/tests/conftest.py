"""Shared set-up of the benchmark's own tests (run from the repository's
root: ``python -m pytest portbench/tests``). Registers the ``cuda`` marker
of the card-only tests, which skip without a card, and gives the CPU tests
each cell at a size a test run holds."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")


def tiny_spec(workload: str, traffic: str = None) -> dict:
    """The cell's entries at a CPU test's size: the first poses of the
    trajectory with a coarse pseudo grid and ray grid, or a coarse lidar
    frame with a pool of four scans; fewer query points. ``traffic`` names
    another traffic file for the cell's configuration."""
    import json

    from portbench import harness

    spec = harness.cell_spec(workload)
    if traffic:
        with open(os.path.join(harness.HERE, "traffic",
                               traffic + ".json")) as f:
            spec["traffic"] = json.load(f)
    cfg = dict(spec["config"])
    if cfg["adapter"] == "spgp_map3d":
        cfg.update(poses=5, pseudo_grid=[4, 4, 3], ray_grid=[8, 6],
                   max_num_samples=256)
    else:
        cfg["frame"] = dict(cfg["frame"], num_azimuth_lines=41,
                            num_elevation_lines=21)
        cfg.update(scans=4)
    spec["config"] = cfg
    traffic = dict(spec["traffic"])
    if "query" in traffic:
        traffic["query"] = dict(traffic["query"], points=300)
    spec["traffic"] = traffic
    return spec


@pytest.fixture
def tiny(tmp_path):
    """(spec of a cell at a test's size, a cache directory of its own)."""
    return lambda workload, traffic=None: (tiny_spec(workload, traffic),
                                           str(tmp_path / "cache"))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest -m cuda "
                    "portbench/tests on the card")
    return torch.device("cuda")
