"""E1, the evaluator's ground-truth slice scan (``csrc/slice_scan.cu``),
and its plain version.

``Scene.get_slice_scan`` (``data/scene.py``) casts planar rays over the
slice raster of the ground-truth points within a height band and keeps
each ray's first occupied sample.  What decides a ray's depth is one
integer, the raster cell of that sample (or none), so the card can give it
bit for bit.  :func:`slice_scan` finds those cells: on the card with E1,
on the CPU with :func:`slice_scan_plain`.  The scene's own
``Scene.scan_depths`` makes the inputs (the band, the rays) and turns the
cells into depths.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.ops import _build
from virus_nerf_tpu_torch.ops.common import CUBE_MAX, CUBE_MIN
from virus_nerf_tpu_torch.ops.launch_counts import register

SPAN = CUBE_MAX - CUBE_MIN


def slice_scan_plain(cells, band: Tuple[int, int], res: int, rays, radii):
    """Plain version of :func:`slice_scan`: the raster, every sample of
    every ray and its cell in numpy, as ``get_slice_scan`` computes them,
    and the first occupied sample by ``argmax``."""
    lo, hi = band
    occupied = np.zeros(res * res, bool)
    occupied[cells.numpy()[lo:hi]] = True
    rays, radii = rays.numpy(), radii.numpy()

    def cell(p):
        idx = (res - 1) * (p - CUBE_MIN) / SPAN
        return np.clip(np.round(idx).astype(np.int64), 0, res - 1)

    lin = (cell(rays[:, None, 0] + radii[None, :] * rays[:, None, 2]) * res
           + cell(rays[:, None, 1] + radii[None, :] * rays[:, None, 3]))
    hit = occupied[lin]
    rows = np.arange(lin.shape[0])
    first = np.argmax(hit, axis=1)
    return torch.from_numpy(
        np.where(hit[rows, first], lin[rows, first], -1).astype(np.int32))


def slice_scan(cells, band: Tuple[int, int], res: int, rays, radii):
    """The raster cell ``ix * res + iy`` of each ray's first occupied
    sample, or -1 where none is.

    The raster holds the cells ``cells[lo:hi]`` (``band = (lo, hi)``); ray
    i's sample k lies at ``rays[i, :2] + radii[k] * rays[i, 2:]`` and falls
    in the cell ``Scene.c2idx`` gives it.  CUDA tensors launch E1 (or
    raise); CPU tensors take :func:`slice_scan_plain`.  ``.launches``
    counts the calls that launched E1 (a zero fill and two kernels each).

    Args:
        cells: (P,) int32 cells in ``[0, res^2)``.
        rays: (N, 4) float64 origin x, y and direction x, y.
        radii: (M,) float64 sample distances.
    Returns:
        (N,) int32 on the device of ``cells``.
    """
    lo, hi = int(band[0]), int(band[1])
    if cells.dtype != torch.int32 or cells.dim() != 1:
        raise TypeError(f"slice_scan: want (P,) int32 cells, got "
                        f"{tuple(cells.shape)} {cells.dtype}")
    if rays.dtype != torch.float64 or rays.dim() != 2 or rays.shape[1] != 4:
        raise TypeError(f"slice_scan: want (N, 4) float64 rays, got "
                        f"{tuple(rays.shape)} {rays.dtype}")
    if radii.dtype != torch.float64 or radii.dim() != 1:
        raise TypeError(f"slice_scan: want (M,) float64 radii, got "
                        f"{tuple(radii.shape)} {radii.dtype}")
    if not 0 <= lo <= hi <= cells.shape[0]:
        raise ValueError(f"slice_scan: band {band} outside [0, {cells.shape[0]}]")
    if not 1 <= res <= 46340:  # res^2 cells fit int32
        raise ValueError(f"slice_scan: res {res} outside [1, 46340]")
    if not cells.device == rays.device == radii.device:
        raise ValueError(f"slice_scan: cells on {cells.device}, rays on "
                         f"{rays.device}, radii on {radii.device}")
    if cells.device.type == "cpu":
        return slice_scan_plain(cells, (lo, hi), res, rays, radii)
    if not cells.is_cuda:
        raise ValueError(f"slice_scan: unsupported device {cells.device}")
    if not (cells.is_contiguous() and rays.is_contiguous()
            and radii.is_contiguous()):
        raise ValueError("slice_scan: cells, rays and radii must be contiguous")
    n = rays.shape[0]
    words = (res * res + 31) // 32
    bits = torch.empty(words, dtype=torch.int32, device=cells.device)
    hit = torch.empty(n, dtype=torch.int32, device=cells.device)
    err = _build.library().vn_slice_scan(
        cells[lo:hi].data_ptr(), hi - lo, bits.data_ptr(), words,
        rays.data_ptr(), radii.data_ptr(), radii.shape[0], res,
        float(CUBE_MIN), float(SPAN), hit.data_ptr(), n,
        torch.cuda.current_stream(cells.device).cuda_stream,
    )
    _build.check(err, "vn_slice_scan")
    slice_scan.launches += 1
    return hit


slice_scan.launches = 0
register(slice_scan)
