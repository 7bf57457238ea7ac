"""Type registration at import time (counterpart of
``erl_gaussian_process_tpu/init.py``; the reference's ``Init()``): every
model setting is registered with :mod:`utils.config` under its short
names and the reference's C++ type strings, so a YAML file that names its
type loads unchanged. The package ``__init__`` calls :func:`init` once.
"""

_initialized = False


def init() -> None:
    global _initialized
    if _initialized:
        return
    _initialized = True

    from erl_gaussian_process_tpu_torch.geometry.frames_3d import (
        DepthFrame3DSetting,
        LidarFrame3DSetting,
    )
    from erl_gaussian_process_tpu_torch.geometry.lidar_frame_2d import (
        LidarFrame2DSetting,
    )
    from erl_gaussian_process_tpu_torch.kernels.base import KernelSetting
    from erl_gaussian_process_tpu_torch.models.lidar_gp_2d import (
        LidarGP2DSetting,
    )
    from erl_gaussian_process_tpu_torch.models.mapping import MappingSetting
    from erl_gaussian_process_tpu_torch.models.noisy_input_gp import (
        NoisyInputGPSetting,
    )
    from erl_gaussian_process_tpu_torch.models.range_sensor_gp_3d import (
        RangeSensorGP3DSetting,
    )
    from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
        SpGpSetting,
    )
    from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
        SpGpOccupancyMapSetting,
    )
    from erl_gaussian_process_tpu_torch.models.vanilla_gp import (
        VanillaGPSetting,
    )
    from erl_gaussian_process_tpu_torch.utils.config import register_setting

    register_setting(KernelSetting,
                     "erl::covariance::Covariance<double>::Setting",
                     "erl::covariance::Covariance<float>::Setting",
                     "covariance")
    register_setting(VanillaGPSetting, "VanillaGaussianProcess",
                     "vanilla_gaussian_process")
    register_setting(NoisyInputGPSetting, "NoisyInputGaussianProcess",
                     "noisy_input_gaussian_process")
    register_setting(SpGpSetting, "SparsePseudoInputGaussianProcess",
                     "sparse_pseudo_input_gaussian_process", "sp_gp")
    register_setting(MappingSetting, "Mapping")
    register_setting(LidarGP2DSetting, "LidarGaussianProcess2D",
                     "lidar_gaussian_process_2d")
    register_setting(RangeSensorGP3DSetting, "RangeSensorGaussianProcess3D",
                     "range_sensor_gaussian_process_3d")
    register_setting(SpGpOccupancyMapSetting, "SpGpOccupancyMap")
    register_setting(LidarFrame2DSetting, "LidarFrame2D")
    register_setting(LidarFrame3DSetting, "LidarFrame3D")
    register_setting(DepthFrame3DSetting, "DepthFrame3D")
