"""Carry a JAX-package state over to the port.

The JAX package's checkpoints (``state_dict()`` of
``SparsePseudoInputGaussianProcess``, ``SpGpOccupancyMap``,
``LidarGaussianProcess2D``, ``RangeSensorGaussianProcess3D``,
``VanillaGaussianProcess`` and ``NoisyInputGaussianProcess``, as numpy
arrays) load here and compute the same thing from the same state; a
reduced-rank model's setting rebuilds its basis, and its (m, m) state
carries over as it is. The one
piece that cannot carry over is the JAX PRNG key: the map gets a fresh
``torch.Generator`` seed derived from it (:func:`seed_from_key`), so its
future free-space samples differ from the JAX map's.
"""

from __future__ import annotations

import numpy as np

from erl_gaussian_process_tpu_torch.geometry.aabb import Aabb
from erl_gaussian_process_tpu_torch.models.batch_gp import (  # noqa: F401
    bank_state_from_numpy,
)
from erl_gaussian_process_tpu_torch.models.lidar_gp_2d import (
    LidarGaussianProcess2D,
)
from erl_gaussian_process_tpu_torch.models.gp_core import (
    DEFAULT_DEVICE,
    resolve_device,
)
from erl_gaussian_process_tpu_torch.models.noisy_input_gp import (
    NoisyInputGaussianProcess,
)
from erl_gaussian_process_tpu_torch.models.range_sensor_gp_3d import (
    RangeSensorGaussianProcess3D,
)
from erl_gaussian_process_tpu_torch.models.sparse_pseudo_input_gp import (
    SpGpState,
    state_from_numpy,
)
from erl_gaussian_process_tpu_torch.models.spgp_occupancy_map import (
    SpGpOccupancyMap,
    SpGpOccupancyMapSetting,
)
from erl_gaussian_process_tpu_torch.models.vanilla_gp import (
    VanillaGaussianProcess,
)


def spgp_state_from_numpy(d, device=DEFAULT_DEVICE) -> SpGpState:
    """SpGpState on ``device`` from the ``state`` dict of a JAX
    ``SparsePseudoInputGaussianProcess.state_dict()`` (pseudo, L_km, L_inv,
    qm, alpha, qm_c, alpha_c)."""
    return state_from_numpy(d, resolve_device(device))


def seed_from_key(key) -> int:
    """A 64-bit generator seed from a JAX PRNG key (uint32 words)."""
    words = np.asarray(key, np.uint32).ravel()
    seed = 0
    for w in words:
        seed = ((seed << 32) | int(w)) % 2**64
    return seed


def occupancy_map_from_numpy(d, device=DEFAULT_DEVICE,
                             free_slots_per_ray=None) -> SpGpOccupancyMap:
    """A port ``SpGpOccupancyMap`` on ``device`` from a JAX
    ``SpGpOccupancyMap.state_dict()``. Setting, boundary, step and the SPGP
    state carry over; the PRNG key becomes a generator seed. The JAX
    checkpoint does not record ``free_slots_per_ray``: pass the value the
    JAX map was built with (None derives it from the setting, as both
    constructors do)."""
    sp = d["sp_gp"]
    st = sp["state"]
    pseudo = np.asarray(st["pseudo"])
    m_valid = int(sp.get("m_valid", len(pseudo)))
    boundary = Aabb(center=np.asarray(d["map_boundary"]["center"]),
                    half_sizes=np.asarray(d["map_boundary"]["half_sizes"]))
    seed = seed_from_key(d["key"])
    omap = SpGpOccupancyMap(
        SpGpOccupancyMapSetting.from_dict(d["setting"]), pseudo[:m_valid].T,
        boundary, seed=seed, dtype=pseudo.dtype,
        free_slots_per_ray=free_slots_per_ray, device=device)
    omap.load_state_dict({
        "setting": d["setting"], "sp_gp": sp,
        "map_boundary": d["map_boundary"], "seed": seed,
        "step": int(d.get("step", 0))})
    return omap


def range_sensor_gp_3d_from_numpy(d, device=DEFAULT_DEVICE
                                  ) -> RangeSensorGaussianProcess3D:
    """A port ``RangeSensorGaussianProcess3D`` on ``device`` from a JAX
    ``RangeSensorGaussianProcess3D.state_dict()``, at the checkpoint's
    dtype."""
    gp = RangeSensorGaussianProcess3D(device=device)
    gp.load_state_dict(d)
    return gp


def lidar_gp_2d_from_numpy(d, device=DEFAULT_DEVICE
                           ) -> LidarGaussianProcess2D:
    """A port ``LidarGaussianProcess2D`` on ``device`` from a JAX
    ``LidarGaussianProcess2D.state_dict()``, at the checkpoint's dtype."""
    gp = LidarGaussianProcess2D(device=device)
    gp.load_state_dict(d)
    return gp


def _checkpoint_dtype(d) -> np.dtype:
    """The dtype of an exact GP's checkpoint: its train set's."""
    ts = d.get("train_set")
    src = ts["x"] if ts is not None else (d.get("state") or {}).get("L")
    return np.asarray(src).dtype if src is not None else np.dtype(np.float64)


def vanilla_gp_from_numpy(d, device=DEFAULT_DEVICE) -> VanillaGaussianProcess:
    """A port ``VanillaGaussianProcess`` on ``device`` from a JAX
    ``VanillaGaussianProcess.state_dict()``, at the checkpoint's dtype."""
    gp = VanillaGaussianProcess(dtype=_checkpoint_dtype(d), device=device)
    gp.load_state_dict(d)
    return gp


def noisy_input_gp_from_numpy(d, device=DEFAULT_DEVICE
                              ) -> NoisyInputGaussianProcess:
    """A port ``NoisyInputGaussianProcess`` on ``device`` from a JAX
    ``NoisyInputGaussianProcess.state_dict()``, at the checkpoint's
    dtype."""
    gp = NoisyInputGaussianProcess(dtype=_checkpoint_dtype(d), device=device)
    gp.load_state_dict(d)
    return gp
