"""The vanilla GP's setting (counterpart of
``erl_gaussian_process_tpu/models/vanilla_gp.py:192-215``). The sensor GPs
configure their partition GPs with it; the model itself is not ported yet
(ROADMAP.md, Queue 1 item 9)."""

from __future__ import annotations

import dataclasses

from erl_gaussian_process_tpu_torch.kernels import KernelSetting


@dataclasses.dataclass
class VanillaGPSetting:
    """Mirror of VanillaGaussianProcess::Setting."""

    kernel_type: str = "rbf"
    kernel: KernelSetting = dataclasses.field(default_factory=KernelSetting)
    max_num_samples: int = 256

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        d.pop("kernel_setting_type", None)  # reference YAML field, implied
        if "kernel" in d:
            d["kernel"] = KernelSetting.from_dict(d["kernel"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
