"""Runtime utilities (counterpart of ``erl_gaussian_process_tpu/utils``):
checkpoints (``.npz`` and the ``.egpt`` token stream), the native host
runtime, timing, settings by name and in YAML, the lidar-log loader, the
float64 drift check, state conversion from the JAX package, kernel-scale
selection and deployment artifacts (``utils/deploy.py``)."""

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
from erl_gaussian_process_tpu_torch.utils.native import (
    load_tokens,
    native_available,
    raycast_2d,
    save_tokens,
)
from erl_gaussian_process_tpu_torch.utils.timing import (
    BlockTimer,
    memory_usage,
    report_time,
    trace,
)
from erl_gaussian_process_tpu_torch.utils.model_selection import (
    nlml_sweep,
    nlml_sweep_nigp,
    nlml_sweep_spgp,
    select_scale,
    select_scale_nigp,
    select_scale_spgp,
)

__all__ = [
    "eq_state", "load_pytree", "save_pytree", "BlockTimer", "report_time",
    "memory_usage", "trace",
    "native_available", "save_tokens", "load_tokens", "raycast_2d",
    "as_yaml_file", "as_yaml_str", "create_setting", "from_yaml_file",
    "from_yaml_str", "register_setting", "setting_names",
    "nlml_sweep", "nlml_sweep_nigp", "nlml_sweep_spgp",
    "select_scale", "select_scale_nigp", "select_scale_spgp",
]
