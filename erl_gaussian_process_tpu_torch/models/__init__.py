"""Models on the main path: the incremental SPGP and the occupancy map
built on it (counterpart of ``erl_gaussian_process_tpu/models``)."""

from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SparsePseudoInputGaussianProcess,
    SpGpSetting,
    SpGpState,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMap,
    SpGpOccupancyMapSetting,
)

__all__ = [
    "SparsePseudoInputGaussianProcess",
    "SpGpOccupancyMap",
    "SpGpOccupancyMapSetting",
    "SpGpSetting",
    "SpGpState",
]
