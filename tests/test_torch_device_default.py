"""The port's entry points run on the card unless the caller asks for the
CPU: built without ``device=`` where no CUDA device is available, every
model, state loader and converter raises instead of running on the CPU.
(CUDA is reported absent through a monkeypatch, so the test means the same
on a machine with a card.)"""

import numpy as np
import pytest
import torch

from erl_gaussian_process_tpu_torch.geometry import Aabb
from erl_gaussian_process_tpu_torch.models import (
    BatchGPBank,
    NoisyInputGaussianProcess,
    RangeSensorGaussianProcess3D,
    SparsePseudoInputGaussianProcess,
    SpGpOccupancyMap,
    VanillaGaussianProcess,
)
from erl_gaussian_process_tpu_torch.models.batch_gp import (
    bank_state_from_numpy,
)
from erl_gaussian_process_tpu_torch.utils import convert
from erl_gaussian_process_tpu_torch.utils.drift import replay_f64


def _vanilla_checkpoint():
    gp = VanillaGaussianProcess(device="cpu")
    gp.train(np.linspace(0, 1, 5)[None], np.zeros(5), 1e-2)
    return gp.state_dict()


def _nigp_checkpoint():
    gp = NoisyInputGaussianProcess(device="cpu")
    gp.train(np.linspace(0, 1, 5)[None], np.zeros(5), np.zeros((1, 5)),
             1e-2, 1e-2, 1e-2)
    return gp.state_dict()


def _spgp_state():
    gp = SparsePseudoInputGaussianProcess(None, np.zeros((2, 4)),
                                          device="cpu")
    return {k: v.numpy() for k, v in gp.state._asdict().items()}


ENTRY_POINTS = {
    "VanillaGaussianProcess": lambda: VanillaGaussianProcess(),
    "NoisyInputGaussianProcess": lambda: NoisyInputGaussianProcess(),
    "BatchGPBank": lambda: BatchGPBank(2, 8),
    "RangeSensorGaussianProcess3D": lambda: RangeSensorGaussianProcess3D(),
    "SparsePseudoInputGaussianProcess":
        lambda: SparsePseudoInputGaussianProcess(None, np.zeros((2, 4))),
    "SpGpOccupancyMap": lambda: SpGpOccupancyMap(
        None, np.zeros((2, 4)), Aabb.from_min_max([-1, -1], [1, 1])),
    "bank_state_from_numpy": lambda: bank_state_from_numpy(
        {"x": np.zeros((1, 2, 1))}),
    "spgp_state_from_numpy": lambda: convert.spgp_state_from_numpy(
        _spgp_state()),
    "vanilla_gp_from_numpy": lambda: convert.vanilla_gp_from_numpy(
        _vanilla_checkpoint()),
    "noisy_input_gp_from_numpy": lambda: convert.noisy_input_gp_from_numpy(
        _nigp_checkpoint()),
    "range_sensor_gp_3d_from_numpy": lambda:
        convert.range_sensor_gp_3d_from_numpy(
            RangeSensorGaussianProcess3D(device="cpu").state_dict()),
    "replay_f64": lambda: replay_f64(
        np.zeros((4, 2)), 1.0, "rbf", np.zeros((1, 3, 2)),
        np.zeros((1, 3, 1)), np.ones((1, 3), bool), 1e-2, np.zeros((2, 2))),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_is_the_card_and_never_the_cpu(entry, monkeypatch):
    make = ENTRY_POINTS[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        make()
