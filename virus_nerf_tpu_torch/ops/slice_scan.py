"""E1, the evaluator's ground-truth slice scan (``csrc/slice_scan.cu``), its
plain version and its host side.

``Scene.get_slice_scan`` (``data/scene.py``) casts planar rays over the
slice raster of the ground-truth points within a height band and keeps
each ray's first occupied sample.  What decides a ray's depth is one
integer, the raster cell of that sample (or none), so the card can give it
bit for bit.  :class:`SliceScan` does the host's part as
``get_slice_scan`` does it (the band, the angles, the depths from the hit
cells) and :func:`slice_scan` finds the hits: on the card with E1, on the
CPU with :func:`slice_scan_plain`.  :func:`scene_slice_scan` keeps one
:class:`SliceScan` a scene, raster size and device, so the evaluators of
one scene (a population's, one a particle) share its set-up.
``Scene.get_slice_scan`` stays the plain scan of the plots and the tests.
"""

from __future__ import annotations

import weakref
from typing import Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.data.scene import CUBE_MAX, CUBE_MIN, Scene
from virus_nerf_tpu_torch.ops import _build
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


class SliceScan:
    """``Scene.get_slice_scan``'s scan depths for one scene and raster size
    ``res``, the hits found by :func:`slice_scan` on ``device``.

    Set-up, once: every cloud point's cell (``scene.w2idx`` of its x, y,
    which no height band changes), the points sorted by height, and the
    sample distances, on ``device``.  A call's band is then one range of
    the sorted points.  The scan holds its scene weakly (the cache of
    :func:`scene_slice_scan` is keyed by the scene) and its cloud.
    """

    def __init__(self, scene: Scene, res: int, device):
        if scene.point_cloud is None:
            raise ValueError("scene has no point cloud")
        self.cloud = scene.point_cloud
        pts = self.cloud[:, :3]
        order = np.argsort(pts[:, 2], kind="stable")
        self._scene = weakref.ref(scene)
        self.res = int(res)
        self.device = torch.device(device)
        # the heights in the cloud's own dtype: the band compares them as
        # get_slice_map does
        self.z = pts[order, 2]
        ij = scene.w2idx(pts[order, :2], self.res)
        self.cells = torch.from_numpy(
            (ij[:, 0] * self.res + ij[:, 1]).astype(np.int32)).to(self.device)
        m = int(np.ceil(np.sqrt(2.0 * self.res**2)))
        self.radii = torch.from_numpy(
            np.linspace(0.0, CUBE_MAX - CUBE_MIN, m)).to(self.device)

    @property
    def scene(self) -> Scene:
        return self._scene()

    def inputs(self, rays_o: np.ndarray, rays_d: np.ndarray,
               height_tolerance: float):
        """A call's host inputs, as ``get_slice_scan`` computes them: the
        band ``(lo, hi)`` and the (N, 4) float64 rays (origin x, y, then
        the cosine and sine of each direction's angle).  ``rays_o`` is
        float64 in cube coordinates."""
        angles = np.arctan2(rays_d[:, 1], rays_d[:, 0])
        height_mean = float(np.mean(rays_o[:, 2]))
        height = self.scene.c2w(np.array([[0.0, 0.0, height_mean]]))[0, 2]
        inside = ((self.z >= height - height_tolerance)
                  & (self.z <= height + height_tolerance))
        lo = int(np.argmax(inside))  # sorted heights: the band is one range
        rays = np.empty((rays_o.shape[0], 4))
        rays[:, :2] = rays_o[:, :2]
        rays[:, 2] = np.cos(angles)
        rays[:, 3] = np.sin(angles)
        return (lo, lo + int(np.count_nonzero(inside))), rays

    def depths(self, rays_o: np.ndarray, rays_d: np.ndarray,
               height_tolerance: float) -> np.ndarray:
        """``get_slice_scan(res, rays_o, rays_d, height_tolerance,
        rays_o_in_world_coord=False)[1]``: each ray's depth to its first
        hit in cube units, NaN where it hits nothing."""
        rays_o = np.array(rays_o, dtype=np.float64)
        band, rays = self.inputs(rays_o, rays_d, height_tolerance)
        hit = slice_scan(self.cells, band, self.res,
                         torch.from_numpy(rays).to(self.device),
                         self.radii).cpu().numpy()
        hit_rays = np.flatnonzero(hit >= 0)
        closest_idx = np.stack([hit[hit_rays] // self.res,
                                hit[hit_rays] % self.res], axis=1)
        depths = np.full(rays_o.shape[0], np.nan)
        depths[hit_rays] = np.linalg.norm(
            self.scene.idx2c(closest_idx, self.res) - rays_o[hit_rays, :2],
            axis=1)
        return depths


# scene -> {(res, device): SliceScan}; an entry goes with its scene
_SCANS: "weakref.WeakKeyDictionary[Scene, dict]" = weakref.WeakKeyDictionary()


def scene_slice_scan(scene: Scene, res: int, device) -> SliceScan:
    """The :class:`SliceScan` of ``scene`` at ``res`` on ``device``, made at
    the first call and kept while the scene lives (made anew if its cloud
    was replaced)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    scans = _SCANS.setdefault(scene, {})
    scan = scans.get((int(res), device))
    if scan is None or scan.cloud is not scene.point_cloud:
        scan = scans[int(res), device] = SliceScan(scene, res, device)
    return scan
