"""Models: the incremental SPGP and the occupancy map built on it, the
batched GP bank and the 2D lidar and 3D range-sensor GPs built on that, the
exact (vanilla) GP and the noisy-input GP (counterpart of
``erl_gaussian_process_tpu/models``)."""

from erl_gaussian_process_tpu_torch.models.batch_gp import (
    BankState,
    BatchGPBank,
    bank_fit,
    bank_fit_rr,
    bank_predict,
    bank_predict_assigned,
)
from erl_gaussian_process_tpu_torch.models.lidar_gp_2d import (
    LidarGaussianProcess2D,
    LidarGP2DSetting,
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
    nigp_fit,
)
from erl_gaussian_process_tpu_torch.models.range_sensor_gp_3d import (
    RangeSensorGaussianProcess3D,
    RangeSensorGP3DSetting,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SparsePseudoInputGaussianProcess,
    SpGpSetting,
    SpGpState,
    spgp_init,
    spgp_update,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMap,
    SpGpOccupancyMapSetting,
)
from erl_gaussian_process_tpu_torch.models.vanilla_gp import (
    VanillaGaussianProcess,
    VanillaGPSetting,
    VanillaGPState,
    vanilla_fit,
)

__all__ = [
    "BankState",
    "BatchGPBank",
    "LidarGP2DSetting",
    "LidarGaussianProcess2D",
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
    "bank_fit_rr",
    "bank_predict",
    "bank_predict_assigned",
    "nigp_fit",
    "spgp_init",
    "spgp_update",
    "vanilla_fit",
]
