"""Scene container: ground-truth point cloud + world<->cube transforms +
2-D slice maps / simulated LiDAR scans.

Host-side numpy counterpart of the reference scene classes
(reference: datasets/scene_base.py:7-423, datasets/scene_ethz.py:54-72,
datasets/scene_rh.py:42-60).  Used for evaluation (the mapping metrics run on
2-D projections of the GT map) and for converting metric sensor parameters
into cube units.

A copy of ``virus_nerf_tpu/data/scene.py`` (importing that module runs
``virus_nerf_tpu/data/__init__.py``, which imports jax), but for the GT
slice scan: :meth:`Scene.scan_depths` walks the rays with
``ops/slice_scan.py`` (the kernel E1 on a card, its plain version on the
CPU) from a set-up the scene keeps a raster size and device, and
:meth:`Scene.get_slice_scan` is that walk on the CPU, bit for bit the JAX
package's dense-raster march.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.ops.common import CUBE_MAX, CUBE_MIN
from virus_nerf_tpu_torch.ops.slice_scan import slice_scan

SCALE_MARGIN = 1.05


class SliceScanSetup(NamedTuple):
    """A scene's GT slice scan set-up at one raster size on one device."""

    cloud: np.ndarray  # the point cloud it was made from
    z: np.ndarray  # the heights, sorted (stable), in the cloud's dtype
    cells: torch.Tensor  # (P,) int32 slice cell ix * res + iy of each, sorted
    radii: torch.Tensor  # (M,) float64 sample distances along a ray


class Scene:
    """GT point cloud + world<->cube coordinate transforms."""

    def __init__(
        self,
        point_cloud: Optional[np.ndarray] = None,
        xyz_min: Optional[np.ndarray] = None,
        xyz_max: Optional[np.ndarray] = None,
    ):
        """Either explicit bounds (ETHZ-style, scene_ethz.py:22-32) or bounds
        from the cloud itself (RH-style, scene_rh.py:42-60)."""
        self.point_cloud = point_cloud
        if xyz_min is None or xyz_max is None:
            if point_cloud is None:
                raise ValueError("need a point cloud or explicit bounds")
            xyz_min = point_cloud[:, :3].min(axis=0)
            xyz_max = point_cloud[:, :3].max(axis=0)
        self.xyz_min = np.asarray(xyz_min, np.float64)
        self.xyz_max = np.asarray(xyz_max, np.float64)
        # shift + isotropic scale into the margin-enlarged unit cube
        # (reference: scene_ethz.py:60-72)
        self.shift = (self.xyz_max + self.xyz_min) / 2.0
        self.scale = (
            (self.xyz_max - self.xyz_min).max() * SCALE_MARGIN / (CUBE_MAX - CUBE_MIN)
        )
        self._slice_scans: Dict[tuple, SliceScanSetup] = {}

    # ------------------------------------------------------------ transforms
    def w2c(self, pos, only_scale: bool = False):
        """World (meters) -> cube coords (reference: scene_base.py:150-174).
        Accepts scalars or (N, 2/3) arrays."""
        pos = np.array(pos, dtype=np.float64)
        if not only_scale and pos.ndim >= 1 and pos.shape[-1] in (2, 3):
            pos = pos - self.shift[: pos.shape[-1]]
        return pos / self.scale

    def c2w(self, pos, only_scale: bool = False):
        """Cube -> world (reference: scene_base.py:176-200)."""
        pos = np.array(pos, dtype=np.float64) * self.scale
        if not only_scale and pos.ndim >= 1 and pos.shape[-1] in (2, 3):
            pos = pos + self.shift[: pos.shape[-1]]
        return pos

    def c2idx(self, pos, res: int):
        """Cube coords -> slice-map indices (reference: scene_base.py:202-217)."""
        idx = (res - 1) * (np.asarray(pos) - CUBE_MIN) / (CUBE_MAX - CUBE_MIN)
        return np.clip(np.round(idx).astype(int), 0, res - 1)

    def idx2c(self, map_idxs, res: int):
        """Slice-map indices -> cube coords (reference: scene_base.py:219-234)."""
        return np.asarray(map_idxs) * (CUBE_MAX - CUBE_MIN) / (res - 1) + CUBE_MIN

    def w2idx(self, pos, res: int):
        return self.c2idx(self.w2c(pos), res)

    def idx2w(self, map_idxs, res: int):
        return self.c2w(self.idx2c(map_idxs, res))

    # ------------------------------------------------------------ slice maps
    def get_slice_map(
        self,
        height: float,
        res: int,
        height_tolerance: float,
        height_in_world_coord: bool = True,
    ) -> np.ndarray:
        """Binary occupancy raster of GT points within a height band
        (reference: scene_base.py:49-84)."""
        if self.point_cloud is None:
            raise ValueError("scene has no point cloud")
        pts = self.point_cloud[:, :3]
        if not height_in_world_coord:
            height = self.c2w(np.array([[0.0, 0.0, height]]))[0, 2]
        sel = (pts[:, 2] >= height - height_tolerance) & (
            pts[:, 2] <= height + height_tolerance
        )
        idx = self.w2idx(pts[sel, :2], res)
        m = np.zeros((res, res))
        m[idx[:, 0], idx[:, 1]] = 1
        return m

    def slice_scan_setup(self, res: int, device="cpu") -> SliceScanSetup:
        """The GT slice scan's set-up at raster size ``res`` on ``device``:
        each cloud point's slice cell (``w2idx`` of its x, y, which no
        height band changes), the points sorted by height, and the sample
        distances.  Made at the first call and again once ``point_cloud``
        was replaced; the scene keeps it, so the evaluators of one scene
        share it."""
        if self.point_cloud is None:
            raise ValueError("scene has no point cloud")
        res, device = int(res), torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        setup = self._slice_scans.get((res, device))
        if setup is None or setup.cloud is not self.point_cloud:
            pts = self.point_cloud[:, :3]
            order = np.argsort(pts[:, 2], kind="stable")
            ij = self.w2idx(pts[order, :2], res)
            cells = (ij[:, 0] * res + ij[:, 1]).astype(np.int32)
            m = int(np.ceil(np.sqrt(2.0 * res**2)))
            radii = np.linspace(0.0, CUBE_MAX - CUBE_MIN, m)
            setup = self._slice_scans[res, device] = SliceScanSetup(
                self.point_cloud, pts[order, 2],
                torch.from_numpy(cells).to(device),
                torch.from_numpy(radii).to(device))
        return setup

    def scan_depths(
        self,
        res: int,
        rays_o: np.ndarray,
        rays_d: Optional[np.ndarray] = None,
        height_tolerance: float = 0.1,
        angular_range: Tuple[float, float] = (-np.pi, np.pi),
        device="cpu",
    ):
        """The simulated 2-D LiDAR of :meth:`get_slice_scan` with ``rays_o``
        in cube coordinates, the rays walked on ``device`` (E1 on a card).

        On the host: the height band (one range of the set-up's sorted
        heights, the points ``get_slice_map`` selects), the angles, the
        (N, 4) rays (origin x, y, then the cosine and sine of the angle)
        and the depths from the hit cells; ``slice_scan`` finds each ray's
        first occupied cell.

        Returns (depths (N,) cube units, NaN where a ray hits nothing;
        hits (N,) int32 cells ix * res + iy, -1 where none; angles (N,)).
        """
        res = int(res)
        rays_o = np.array(rays_o, dtype=np.float64)
        setup = self.slice_scan_setup(res, device)
        n = rays_o.shape[0]
        if rays_d is None:
            angles = np.linspace(
                angular_range[0], angular_range[1], n, endpoint=False
            )
        else:
            angles = np.arctan2(rays_d[:, 1], rays_d[:, 0])

        height_mean = float(np.mean(rays_o[:, 2]))
        height = self.c2w(np.array([[0.0, 0.0, height_mean]]))[0, 2]
        inside = (setup.z >= height - height_tolerance) & (
            setup.z <= height + height_tolerance
        )
        lo = int(np.argmax(inside))
        band = (lo, lo + int(np.count_nonzero(inside)))
        rays = np.empty((n, 4))
        rays[:, :2] = rays_o[:, :2]
        rays[:, 2] = np.cos(angles)
        rays[:, 3] = np.sin(angles)
        hits = slice_scan(setup.cells, band, res,
                          torch.from_numpy(rays).to(setup.cells.device),
                          setup.radii).cpu().numpy()

        hit_rays = np.flatnonzero(hits >= 0)
        closest_idx = np.stack(
            [hits[hit_rays] // res, hits[hit_rays] % res], axis=1
        )
        depths = np.full(n, np.nan)
        depths[hit_rays] = np.linalg.norm(
            self.idx2c(closest_idx, res) - rays_o[hit_rays, :2], axis=1
        )
        return depths, hits, angles

    def get_slice_scan(
        self,
        res: int,
        rays_o: np.ndarray,
        rays_d: Optional[np.ndarray] = None,
        height_tolerance: float = 0.1,
        angular_range: Tuple[float, float] = (-np.pi, np.pi),
        rays_o_in_world_coord: bool = True,
    ):
        """Simulated horizontal 2-D LiDAR on the GT slice raster: march each
        planar ray over the raster, first occupied cell wins
        (reference: scene_base.py:86-148); :meth:`scan_depths` on the CPU.

        Returns (scan_map (res,res), scan_depth (N,) cube units, angles (N,)).
        """
        rays_o = np.array(rays_o, dtype=np.float64)
        if rays_o_in_world_coord:
            rays_o = self.w2c(rays_o)
        scan_depth, hits, angles = self.scan_depths(
            res, rays_o, rays_d, height_tolerance, angular_range
        )
        hits = hits[hits >= 0]
        scan_map = np.zeros((res, res))
        scan_map[hits // res, hits % res] = 1
        return scan_map, scan_depth, angles

    # -------------------------------------------------------- 3D -> 2D rays
    def depth2pos(self, rays_o, rays_d, depths):
        """Project depth readings along 3-D rays onto the 2-D plane
        (reference: scene_base.py:291-363).  NaN-safe.

        Returns (pos (N,2), pos_o (N,2), dists (N,)).
        """
        rays_o = np.asarray(rays_o, np.float64)
        rays_d = np.asarray(rays_d, np.float64)
        depths = np.asarray(depths, np.float64)
        mask = (
            ~np.isnan(depths)
            & np.all(~np.isnan(rays_o), axis=1)
            & np.all(~np.isnan(rays_d), axis=1)
        )
        pos = np.full((mask.shape[0], 2), np.nan)
        pos_o = np.full((mask.shape[0], 2), np.nan)
        dists = np.full(mask.shape[0], np.nan)

        o2 = rays_o[mask, :2]
        d2 = rays_d[mask, :2]
        dist = depths[mask] * np.linalg.norm(d2, axis=1)
        ang = np.arctan2(d2[:, 1], d2[:, 0])
        pos[mask] = o2 + np.stack([dist * np.cos(ang), dist * np.sin(ang)], 1)
        pos_o[mask] = o2
        dists[mask] = dist
        return pos, pos_o, dists

    def pos2map(self, pos: np.ndarray, num_points: int, res: int):
        """Rasterize 2-D world positions into per-origin maps
        (reference: scene_base.py:268-289)."""
        idx = self.w2idx(pos, res).reshape(num_points, -1, 2)
        maps = np.zeros((num_points, res, res))
        maps[np.arange(num_points)[:, None], idx[:, :, 0], idx[:, :, 1]] = 1
        return maps
