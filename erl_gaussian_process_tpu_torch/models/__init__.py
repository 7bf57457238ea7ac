"""Models: the incremental SPGP and the occupancy map built on it, the
batched GP bank and the 3D range-sensor GP built on that, the exact
(vanilla) GP and the noisy-input GP (counterpart of
``erl_gaussian_process_tpu/models``)."""

from erl_gaussian_process_tpu_torch.models.batch_gp import (
    BankState,
    BatchGPBank,
    bank_fit,
    bank_predict,
    bank_predict_assigned,
)
from erl_gaussian_process_tpu_torch.models.mapping import (
    Mapping,
    MappingSetting,
    MappingType,
)
from erl_gaussian_process_tpu_torch.models.noisy_input_gp import (
    NoisyInputGaussianProcess,
    NoisyInputGPSetting,
    NoisyInputGPState,
)
from erl_gaussian_process_tpu_torch.models.range_sensor_gp_3d import (
    RangeSensorGaussianProcess3D,
    RangeSensorGP3DSetting,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SparsePseudoInputGaussianProcess,
    SpGpSetting,
    SpGpState,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMap,
    SpGpOccupancyMapSetting,
)
from erl_gaussian_process_tpu_torch.models.vanilla_gp import (
    VanillaGaussianProcess,
    VanillaGPSetting,
    VanillaGPState,
)

__all__ = [
    "BankState",
    "BatchGPBank",
    "Mapping",
    "MappingSetting",
    "MappingType",
    "NoisyInputGPSetting",
    "NoisyInputGPState",
    "NoisyInputGaussianProcess",
    "RangeSensorGP3DSetting",
    "RangeSensorGaussianProcess3D",
    "SparsePseudoInputGaussianProcess",
    "SpGpOccupancyMap",
    "SpGpOccupancyMapSetting",
    "SpGpSetting",
    "SpGpState",
    "VanillaGPSetting",
    "VanillaGPState",
    "VanillaGaussianProcess",
    "bank_fit",
    "bank_predict",
    "bank_predict_assigned",
]
