"""Occupancy training-set generation: hit points plus free-space samples
along rays (counterpart of
``erl_gaussian_process_tpu/geometry/occupancy_dataset.py``).

- ``generate_dataset_np``: host numpy, variable-size output;
- ``generate_dataset_fixed``: torch on the tensors' device, fixed shapes
  plus a validity mask. It draws its free-sample positions from a
  ``torch.Generator``, or takes them injected as ``u`` so that a test can
  hand it the JAX package's ``jax.random`` draws and compare slot for slot.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def generate_dataset_np(
    rng: np.random.Generator,
    sensor_position: np.ndarray,      # (d,)
    points: np.ndarray,               # (n, d) world hit points
    aabb_min: np.ndarray,
    aabb_max: np.ndarray,
    min_distance: float,
    max_distance: float,
    free_sampling_margin: float,
    free_points_per_meter: float,
    max_dataset_size: int,
):
    """Returns (dataset_points (m, d), labels (m,) in {0, 1}, hit_indices).

    Labels: 1 = occupied (the hit point), 0 = free (sampled along the ray).
    Rays shorter than min_distance or invalid are skipped; rays longer than
    max_distance contribute free samples up to max_distance but no hit.
    """
    p = np.asarray(points, float)
    sp = np.asarray(sensor_position, float)
    delta = p - sp
    dist = np.linalg.norm(delta, axis=-1)
    finite = np.isfinite(dist) & (dist > 0)
    in_box = np.all((p >= aabb_min) & (p <= aabb_max), axis=-1)

    occupied = finite & in_box & (dist >= min_distance) & (dist <= max_distance)
    hit_indices = np.flatnonzero(occupied)

    out_pts = [p[occupied]]
    out_lbl = [np.ones(occupied.sum())]

    free_ray = finite & (dist >= min_distance)
    free_len = np.minimum(dist, max_distance)
    for i in np.flatnonzero(free_ray):
        d_i = free_len[i]
        n_free = int(free_points_per_meter * d_i)
        if n_free <= 0:
            continue
        u = rng.uniform(free_sampling_margin, 1.0 - free_sampling_margin,
                        size=n_free)
        pts = sp + u[:, None] * (delta[i] / dist[i]) * d_i
        keep = np.all((pts >= aabb_min) & (pts <= aabb_max), axis=-1)
        out_pts.append(pts[keep])
        out_lbl.append(np.zeros(keep.sum()))

    pts = np.concatenate(out_pts, axis=0)
    lbl = np.concatenate(out_lbl, axis=0)
    if max_dataset_size > 0 and pts.shape[0] > max_dataset_size:
        sel = rng.choice(pts.shape[0], size=max_dataset_size, replace=False)
        pts, lbl = pts[sel], lbl[sel]
    return pts, lbl, hit_indices


def generate_dataset_fixed(
    sensor_position: torch.Tensor,    # (d,)
    points: torch.Tensor,             # (n, d) world end points
    point_mask: torch.Tensor,         # (n,) bool valid-measurement mask
    aabb_min: torch.Tensor,           # (d,)
    aabb_max: torch.Tensor,           # (d,)
    min_distance: float,
    max_distance: float,
    free_sampling_margin: float,
    free_points_per_meter: float,
    *,
    free_slots_per_ray: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
):
    """Fixed-shape sampler: returns (dataset_points (n*(1+F), d),
    labels (n*(1+F),), mask (n*(1+F),) bool) with F = free_slots_per_ray.

    Slot layout: first n hit slots, then n*F free slots. Free slot j of ray i
    is active iff j < free_points_per_meter * effective_ray_length_i.

    The free samples sit at fractions ``u`` (n, F) of each ray, uniform in
    [margin, 1 - margin): drawn from ``generator`` unless ``u`` is given.
    The operation order follows the JAX sampler line by line, so with the
    same ``u`` the two agree bit for bit in float64."""
    p = points
    sp = sensor_position
    n, d = p.shape
    F = int(free_slots_per_ray)
    delta = [p[:, k] - sp[k] for k in range(d)]
    dist = torch.sqrt(sum(dk * dk for dk in delta))
    pos = dist > 0
    inv_safe = torch.where(pos, 1.0 / torch.where(pos, dist,
                                                  torch.ones_like(dist)),
                           torch.zeros_like(dist))
    finite = point_mask & torch.isfinite(dist) & pos
    in_box = finite
    for k in range(d):
        in_box = in_box & (p[:, k] >= aabb_min[k]) & (p[:, k] <= aabb_max[k])

    hit_ok = in_box & (dist >= min_distance) & (dist <= max_distance)
    free_len = torch.clamp(dist, max=max_distance)
    free_ray = finite & (dist >= min_distance)

    if u is None:
        u = free_sample_fractions(n, F, free_sampling_margin, generator,
                                  p.dtype, p.device)
    elif u.shape != (n, F):
        raise ValueError(f"u must have shape {(n, F)}, got {tuple(u.shape)}")
    t = u * (free_len * inv_safe)[:, None]                 # (n, F) ray params
    free_k = [sp[k] + t * delta[k][:, None] for k in range(d)]
    slot_idx = torch.arange(F, device=p.device, dtype=p.dtype)[None, :]
    n_free = free_points_per_meter * free_len
    free_ok = free_ray[:, None] & (slot_idx < n_free[:, None])
    for k in range(d):
        free_ok = free_ok & (free_k[k] >= aabb_min[k]) \
            & (free_k[k] <= aabb_max[k])

    free_pts = torch.stack([fk.reshape(n * F) for fk in free_k], dim=-1)
    pts = torch.cat([p, free_pts], dim=0)
    lbl = torch.cat([torch.ones(n, device=p.device, dtype=p.dtype),
                     torch.zeros(n * F, device=p.device, dtype=p.dtype)])
    mask = torch.cat([hit_ok, free_ok.reshape(n * F)])
    pts = torch.where(mask[:, None], pts, torch.zeros_like(pts))
    return pts, lbl, mask


def free_sample_fractions(n: int, free_slots: int, margin: float,
                          generator: Optional[torch.Generator], dtype,
                          device) -> torch.Tensor:
    """The (n, free_slots) fractions of each ray at which
    :func:`generate_dataset_fixed` places its free samples, uniform in
    [margin, 1 - margin), drawn from ``generator``: what the sampler draws
    when it is given no ``u``."""
    lo, hi = margin, 1.0 - margin
    return torch.rand((n, free_slots), generator=generator, device=device,
                      dtype=dtype) * (hi - lo) + lo


def compact_slots(pts, lbl, mask, budget: int):
    """Gather the active slots into a fixed ``budget``-size prefix,
    preserving slot order (hits first, then free samples). Callers must have
    capped ``mask`` to <= budget actives.

    Active slots get descending positive scores in slot order and inactive
    ones 0, so ``topk`` yields the actives' indices in ascending slot order.
    Which inactive slots fill the tail is unspecified (ties at score 0);
    they stay masked out downstream."""
    n = pts.shape[0]
    score = torch.where(
        mask, n - torch.arange(n, device=mask.device, dtype=torch.int32),
        torch.zeros((), device=mask.device, dtype=torch.int32))
    _, idx = torch.topk(score, budget, sorted=True)
    return pts[idx], lbl[idx], mask[idx]
