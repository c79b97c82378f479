"""Device-resident dataset + batch sampling.

Frozen copy of ``virus_nerf_tpu_torch/data/dataset.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Counterpart of ``virus_nerf_tpu/data/dataset.py`` (reference:
datasets/dataset_base.py:23-98, training/sampler.py:9-262).  Draws come
from an explicit ``torch.Generator`` on the dataset's device.

Strategies: images "all" | "same", optionally only among the images taken
by ``elapse_time`` (real-time simulation); pixels "random" | "valid_uss" |
"valid_tof" | "closest" (the pixel the USS statistics track, see
``data/uss_stats.py``), mixable as {strategy: share} with the remainder
"random", or "entire_img" (every pixel once, in order).

The image filter draws uniformly over the images with ``times <=
elapse_time``, or over all images while none qualifies
(``ops.common.draw_masked``; a ``jax.random.categorical`` over a mask in
the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from benchmark.reference.common import draw_masked


class DeviceDataset(NamedTuple):
    """All tensors of one split on one device; NaN marks invalid depths."""

    poses: torch.Tensor  # (N_imgs, 3, 4) camera-to-world
    directions: torch.Tensor  # (n_cams, H*W, 3) unit directions, camera frame
    cam_idx: torch.Tensor  # (N_imgs,) int64 index into directions
    rgbs: torch.Tensor  # (N_imgs, H*W, 3) in [0, 1]
    depths: Dict[str, torch.Tensor]  # sensor -> (N_imgs, H*W), cube units
    times: torch.Tensor  # (N_imgs,) seconds since start
    uss_mask_idx: torch.Tensor  # (K_uss,) pixel indices inside the USS FoV
    tof_mask_idx: torch.Tensor  # (K_tof,) pixel indices on the ToF lattice
    sensor_ids: torch.Tensor  # (N_imgs,) stack/camera identity

    @property
    def n_images(self) -> int:
        return self.poses.shape[0]

    @property
    def n_pixels(self) -> int:
        return self.rgbs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.poses.device


def dataset_to(dataset: DeviceDataset, device) -> DeviceDataset:
    """The dataset with every tensor on ``device`` (``jax.device_put``)."""
    return DeviceDataset(*(
        {k: v.to(device) for k, v in x.items()} if isinstance(x, dict)
        else x.to(device) for x in dataset
    ))


class Batch(NamedTuple):
    img_idxs: torch.Tensor  # (B,)
    pix_idxs: torch.Tensor  # (B,)
    rays_o: torch.Tensor  # (B, 3)
    rays_d: torch.Tensor  # (B, 3) unit norm
    rgb: torch.Tensor  # (B, 3)
    depths: Dict[str, torch.Tensor]  # sensor -> (B,)
    times: torch.Tensor  # (B,)


def strategy_slots(pix_strategy, batch_size: int):
    """Pixel-strategy spec -> per-strategy slot counts
    (reference: training/sampler.py:139-171)."""
    if isinstance(pix_strategy, str):
        pix_strategy = {pix_strategy: 1.0}
    slots, used = [], 0
    for name, share in pix_strategy.items():
        b = int(share * batch_size)
        slots.append((name, b))
        used += b
    if batch_size - used > 0:
        slots.append(("random", batch_size - used))
    return slots


def _randint(high: int, n: int, generator, device):
    return torch.randint(0, high, (n,), generator=generator, device=device)


def sample_img_idxs(dataset: DeviceDataset, generator, batch_size: int,
                    img_strategy: str = "all", elapse_time=None):
    """Image indices (reference: training/sampler.py:94-123); with
    ``elapse_time`` (a float or a 0-dim tensor) only among the images with
    ``times <= elapse_time`` (training/sampler.py:70-92)."""
    n, dev = dataset.n_images, dataset.device
    if img_strategy not in ("all", "same"):
        raise ValueError(f"unknown image strategy {img_strategy}")
    draws = batch_size if img_strategy == "all" else 1
    if elapse_time is None:
        idx = _randint(n, draws, generator, dev)
    else:
        idx = draw_masked(dataset.times <= elapse_time, draws, generator)
    return idx.expand(batch_size)


def sample_pix_idxs(dataset: DeviceDataset, generator, batch_size: int,
                    pix_strategy, uss_stats_pix=None, img_idxs=None):
    """Pixel indices (reference: training/sampler.py:125-262).  "closest"
    reads ``uss_stats_pix`` (the tracked pixel of every image) at the
    batch's images ``img_idxs``."""
    dev = dataset.device
    if pix_strategy == "entire_img":
        return torch.arange(dataset.n_pixels, device=dev)
    parts = []
    offset = 0
    for name, b in strategy_slots(pix_strategy, batch_size):
        if b == 0:
            continue
        if name == "random":
            parts.append(_randint(dataset.n_pixels, b, generator, dev))
        elif name in ("valid_uss", "valid_tof"):
            table = (
                dataset.uss_mask_idx if name == "valid_uss"
                else dataset.tof_mask_idx
            )
            parts.append(table[_randint(table.shape[0], b, generator, dev)])
        elif name == "closest":
            if uss_stats_pix is None or img_idxs is None:
                raise ValueError("'closest' needs USS stats and img_idxs")
            parts.append(uss_stats_pix[img_idxs[offset:offset + b]].long())
        else:
            raise ValueError(f"unknown pixel strategy {name}")
        offset += b
    return torch.cat(parts)


def gather_batch(dataset: DeviceDataset, img_idxs, pix_idxs) -> Batch:
    """Rays + targets for sampled (image, pixel) pairs
    (reference: datasets/dataset_base.py:50-76,194-243)."""
    img_idxs, pix_idxs = img_idxs.long(), pix_idxs.long()
    cam = dataset.cam_idx[img_idxs]
    dirs_cam = dataset.directions[cam, pix_idxs]  # (B, 3)
    poses = dataset.poses[img_idxs]  # (B, 3, 4)
    return Batch(
        img_idxs=img_idxs,
        pix_idxs=pix_idxs,
        rays_o=poses[:, :3, 3],
        rays_d=torch.einsum("bij,bj->bi", poses[:, :3, :3], dirs_cam),
        rgb=dataset.rgbs[img_idxs, pix_idxs],
        depths={s: d[img_idxs, pix_idxs] for s, d in dataset.depths.items()},
        times=dataset.times[img_idxs],
    )


def sample_batch(dataset: DeviceDataset, generator, batch_size: int,
                 sampling_strategy: Dict[str, Any], elapse_time=None,
                 uss_stats_pix: Optional[torch.Tensor] = None) -> Batch:
    """Full batch draw (reference: datasets/dataset_base.py:23-76); see
    :func:`sample_img_idxs` for ``elapse_time`` and
    :func:`sample_pix_idxs` for ``uss_stats_pix``."""
    img_idxs = sample_img_idxs(
        dataset, generator, batch_size, sampling_strategy.get("imgs", "all"),
        elapse_time,
    )
    pix_idxs = sample_pix_idxs(
        dataset, generator, batch_size, sampling_strategy.get("pixs", "random"),
        uss_stats_pix=uss_stats_pix, img_idxs=img_idxs,
    )
    return gather_batch(dataset, img_idxs, pix_idxs)
