"""Running per-image USS minimum-depth statistics.

Counterpart of ``virus_nerf_tpu/data/uss_stats.py`` (reference:
datasets/sensor_uss.py:113-217): during training, track for every image
the pixel inside the USS field of view whose rendered depth is currently
the smallest.  The ``closest`` pixel strategy draws that pixel, so the USS
cone-minimum hinge supervises the pixel most likely to have made the echo.

Ties: where several samples of a batch share an image's minimum depth, the
JAX package keeps an arbitrary one of them (a scatter with duplicate
indices, uss_stats.py:66-72).  The port keeps the one at the LAST batch
position, on every device — the order XLA's CPU scatter writes in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class USSStats(NamedTuple):
    min_depth: torch.Tensor  # (N_imgs,) float32 current minimum depth
    min_pix: torch.Tensor  # (N_imgs,) int64 pixel index of that minimum
    counts: torch.Tensor  # (N_imgs,) int64 number of updates


def uss_stats_init(n_imgs: int, center_pix: int = 0, device="cuda") -> USSStats:
    return USSStats(
        min_depth=torch.full((n_imgs,), float("inf"), device=device),
        min_pix=torch.full((n_imgs,), int(center_pix), dtype=torch.long,
                           device=device),
        counts=torch.zeros((n_imgs,), dtype=torch.long, device=device),
    )


def uss_stats_update(stats: USSStats, img_idxs, pix_idxs, depths,
                     uss_mask) -> USSStats:
    """Fold a batch of rendered depths into the per-image minima
    (reference: datasets/sensor_uss.py:142-217).

    If the batch minimum of an image lands on the tracked pixel, the stored
    depth is refreshed (it may grow: the scene estimate changed); otherwise
    it only shrinks.  The tracked pixel moves whenever the batch minimum is
    at most the stored one.

    Args:
        img_idxs, pix_idxs: (B,) integer sample coordinates.
        depths: (B,) rendered depths.
        uss_mask: (H*W,) bool field-of-view mask of the USS sensor.
    """
    n_imgs = stats.min_depth.shape[0]
    img_idxs, pix_idxs = img_idxs.long(), pix_idxs.long()
    in_fov = uss_mask[pix_idxs]
    d = torch.where(in_fov, depths, float("inf"))
    batch_min = torch.full_like(stats.min_depth, float("inf")).scatter_reduce(
        0, img_idxs, d, "amin", include_self=True)
    has_batch = torch.isfinite(batch_min)
    is_min = in_fov & (d <= batch_min[img_idxs])
    # the last batch position holding an image's minimum (see module doc)
    pos = torch.arange(img_idxs.shape[0], device=img_idxs.device)
    last = torch.full((n_imgs + 1,), -1, dtype=torch.long,
                      device=img_idxs.device).scatter_reduce(
        0, torch.where(is_min, img_idxs, n_imgs), pos, "amax",
        include_self=True)[:n_imgs]
    batch_pix = torch.where(last >= 0, pix_idxs[last.clamp(min=0)], 0)

    same_pix = has_batch & (batch_pix == stats.min_pix)
    new_depth = torch.where(
        same_pix, batch_min,
        torch.minimum(torch.where(has_batch, batch_min, float("inf")),
                      stats.min_depth),
    )
    improved = has_batch & (batch_min <= stats.min_depth)
    return USSStats(
        min_depth=new_depth,
        min_pix=torch.where(improved, batch_pix, stats.min_pix),
        counts=stats.counts + has_batch.long(),
    )
