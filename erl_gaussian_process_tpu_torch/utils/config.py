"""Settings by name, and YAML files (counterpart of
``erl_gaussian_process_tpu/utils/config.py``).

Every model ``Setting`` is a dataclass with ``to_dict``/``from_dict``. This
module keeps a name -> setting-class registry (``register_setting`` /
``create_setting``), keyed by short names (``"spgp_occupancy_map"``) and by
the reference's C++ type strings
(``"erl::gaussian_process::SpGpOccupancyMap<float, 2>::Setting"``), and
reads and writes settings as YAML (``from_yaml_*`` / ``as_yaml_*``). The
registrations are in :mod:`erl_gaussian_process_tpu_torch.init`.

PyYAML is imported inside the four YAML functions only: the package and
everything else here work without it.
"""

from __future__ import annotations

import io
import re
from typing import Dict, Type

_SETTING_REGISTRY: Dict[str, Type] = {}

# erl::gaussian_process::VanillaGaussianProcess<double>::Setting -> vanilla...
_CPP_SETTING_RE = re.compile(
    r"^erl::\w+::(\w+)\s*(?:<[^>]*>)?\s*(?:::Setting)?$")
# split camelCase but keep acronym runs together: VanillaGPSetting ->
# vanilla_gp_setting, SpGpOccupancyMap -> sp_gp_occupancy_map
_CAMEL_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")


def _normalize(name: str) -> str:
    raw = name.strip()
    m = _CPP_SETTING_RE.match(raw)
    if m:
        raw = m.group(1)
    snake = _CAMEL_RE.sub("_", raw).lower().strip("_")
    return re.sub(r"_+", "_", snake)


def register_setting(cls: Type, *names: str) -> Type:
    """Register a setting dataclass under its snake-case class name plus any
    extra aliases (including reference C++ type strings)."""
    keys = {_normalize(cls.__name__)}
    keys.update(_normalize(n) for n in names)
    for k in keys:
        _SETTING_REGISTRY[k] = cls
    return cls


def create_setting(type_string: str, data: dict | None = None):
    """A registered setting by name, populated from ``data`` if given."""
    key = _normalize(type_string)
    if key not in _SETTING_REGISTRY:
        raise KeyError(
            f"unknown setting type {type_string!r} (normalized {key!r}); "
            f"known: {sorted(_SETTING_REGISTRY)}")
    cls = _SETTING_REGISTRY[key]
    return cls.from_dict(data) if data is not None else cls()


def setting_names():
    return sorted(_SETTING_REGISTRY)


def from_yaml_str(cls: Type, text: str):
    import yaml
    return cls.from_dict(yaml.safe_load(text))


def from_yaml_file(cls: Type, path: str):
    import yaml
    with open(path) as f:
        return cls.from_dict(yaml.safe_load(f))


def as_yaml_str(setting) -> str:
    import yaml
    buf = io.StringIO()
    yaml.safe_dump(setting.to_dict(), buf, sort_keys=False)
    return buf.getvalue()


def as_yaml_file(setting, path: str) -> None:
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(setting.to_dict(), f, sort_keys=False)
