"""Ray / axis-aligned-cube slab intersection.

Frozen copy of ``virus_nerf_tpu_torch/ops/intersection.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Counterpart of ``virus_nerf_tpu/ops/intersection.py`` (reference:
modules/intersection.py:8-55).
"""

from __future__ import annotations

import torch

from benchmark.reference.common import NEAR_DISTANCE


def ray_aabb_intersect(rays_o, rays_d, scale: float):
    """Intersect rays with the cube ``[-scale, scale]^3``.

    Args:
        rays_o: (N, 3) origins.
        rays_d: (N, 3) directions (need not be normalized).
    Returns:
        (N, 2) entry/exit distances ``(max(t1, NEAR_DISTANCE), t2)``, or
        ``(-1, -1)`` for rays that miss.
    """
    inv_d = 1.0 / rays_d
    t_min = (-scale - rays_o) * inv_d
    t_max = (scale - rays_o) * inv_d
    t1 = torch.minimum(t_min, t_max).amax(dim=-1)
    t2 = torch.maximum(t_min, t_max).amin(dim=-1)
    hit = t2 > 0.0
    near = torch.clamp(t1, min=NEAR_DISTANCE)
    miss = torch.full_like(t1, -1.0)
    return torch.stack(
        [torch.where(hit, near, miss), torch.where(hit, t2, miss)], dim=-1
    )
