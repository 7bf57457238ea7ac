"""Checkpoints, settings by name and in YAML, the lidar-log loader, the
float64 drift check and state conversion from the JAX package (counterpart
of ``erl_gaussian_process_tpu/utils``, without the native runtime, timing,
model selection and deployment)."""

from erl_gaussian_process_tpu_torch.utils.config import (
    as_yaml_file,
    as_yaml_str,
    create_setting,
    from_yaml_file,
    from_yaml_str,
    register_setting,
    setting_names,
)
from erl_gaussian_process_tpu_torch.utils.serialization import (
    eq_state,
    load_pytree,
    save_pytree,
)

__all__ = ["as_yaml_file", "as_yaml_str", "create_setting", "eq_state",
           "from_yaml_file", "from_yaml_str", "load_pytree",
           "register_setting", "save_pytree", "setting_names"]
