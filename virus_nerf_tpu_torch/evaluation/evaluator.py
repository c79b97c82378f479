"""End-to-end evaluation: colour PSNR/SSIM and the 2-D mapping NND metrics.

Counterpart of ``virus_nerf_tpu/evaluation/evaluator.py`` (reference:
training/trainer.py:167-224, 374-866): render 360-degree horizontal depth
scans from the NeRF, build the matching ground-truth scan by ray-casting the
GT slice map, project both to the 2-D plane, and compare them with
nearest-neighbour distances in three directions per sensor:

- ``nn``           prediction -> FoV-limited GT   (accuracy),
- ``nn_inv``       FoV-limited GT -> prediction   (coverage inside FoV),
- ``nn_inv_360``   full 360-degree GT -> prediction (total coverage).

The NeRF renders run on the card in fixed-size chunks (the last one padded)
with zero march noise under ``torch.no_grad()``.  The GT scan is
``Scene.scan_depths``, bit for bit ``Scene.get_slice_scan``, its rays
walked on the evaluator's device: on the card by the kernel E1, on the CPU
by its plain version.  The nearest-neighbour
search of the NND metrics is ``ops/nn_search.py``'s, bit for bit the JAX
package's numpy search: on the card the kernel E2, all of one
``nn_metrics`` call's images in one launch, on the CPU the numpy search.
The rest (the FoV masks, the projections, the NND statistics) is the JAX
package's numpy code, on the host.  Where the JAX methods
take the parameters (``params``), these take the model that holds them.
``evaluate(save_dir=...)`` writes ``metrics.csv`` and the colour renders
(``renders/{rgb,rgb_gt,depth}_###.png``, with the port's PNG writer and
turbo table); with ``plot=True`` also the per-image scan maps
(``maps/map{i}.png``) and the NND summary (``metrics.png``) through
``evaluation/plots.py``, which needs matplotlib (ImportError naming it
where it is missing).  ``density_slice`` probes the model's density on a
horizontal slice, ``pack_lidar_scans`` packs LiDAR clouds for
``evaluate_depth(extra_sensor_data=...)`` and ``export_nerf_pointcloud``
writes the NeRF's scans at several heights as a PCD.

With the tracer on (``utils/tracing.py``) ``evaluate_depth`` is the span
``evaluator.call``, with the spans ``evaluator.gt_scan``,
``evaluator.render`` and ``evaluator.nnd`` (each ``nn_metrics`` call)
inside.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data.dataset import DeviceDataset
from virus_nerf_tpu_torch.data.pcl import save_pcd
from virus_nerf_tpu_torch.data.png import write_png
from virus_nerf_tpu_torch.data.scene import Scene
from virus_nerf_tpu_torch.evaluation import metrics as M
from virus_nerf_tpu_torch.evaluation.geometry import (
    create_scan_pos,
    create_scan_rays,
    limit_fov,
)
from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.models.renderer import render_rays
from virus_nerf_tpu_torch.utils import tracing
from virus_nerf_tpu_torch.utils.deployment import density_in_chunks
from virus_nerf_tpu_torch.utils.helpers import require_matplotlib, turbo


def _sync_idxs(times: np.ndarray, sids: np.ndarray, img_idxs,
               tolerance: float = 0.1) -> np.ndarray:
    """Time-synchronous images across sensor stacks
    (virus_nerf_tpu/data/dataset.py:173-199): for each query image, its own
    index plus the closest-in-time image of every OTHER stack within
    ``tolerance`` seconds (its own index when none is close enough).
    Returns (N, n_stacks) int indices."""
    img_idxs = np.atleast_1d(np.asarray(img_idxs, int))
    stacks = np.unique(sids)
    out = np.zeros((img_idxs.shape[0], stacks.shape[0]), int)
    for i, q in enumerate(img_idxs):
        for j, s in enumerate(stacks):
            if sids[q] == s:
                out[i, j] = q
                continue
            cand = np.where(sids == s)[0]
            if cand.size == 0:
                out[i, j] = q
                continue
            k = cand[np.argmin(np.abs(times[cand] - times[q]))]
            out[i, j] = k if abs(times[k] - times[q]) < tolerance else q
    return out


class Evaluator:
    """Host-side evaluation around chunked renders on ``device``."""

    def __init__(
        self,
        cfg: Config,
        dataset: DeviceDataset,
        scene: Scene,
        img_wh: Optional[Tuple[int, int]] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.scene = scene
        self.img_wh = img_wh
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # the evaluation reads the split on the host, once
        self.ds = {
            name: getattr(dataset, name).cpu().numpy()
            for name in ("poses", "directions", "cam_idx", "rgbs", "times",
                         "uss_mask_idx", "tof_mask_idx", "sensor_ids")
        }
        self.depths = {k: v.cpu().numpy() for k, v in dataset.depths.items()}
        self.n_images = dataset.n_images
        self.n_pixels = dataset.n_pixels

    # ------------------------------------------------------------- rendering
    @tracing.spanned("evaluator.render")
    def render_batched(
        self, model: NGPModel, occ_bool, rays_o: np.ndarray, rays_d: np.ndarray
    ) -> Dict[str, np.ndarray]:
        """Render arbitrarily many rays in chunks of
        ``evaluation.batch_size`` (reference: training/trainer_base.py:
        183-224), with no march jitter."""
        param_dev = next(model.parameters()).device
        if param_dev != self.device:
            raise ValueError(f"model on {param_dev}, evaluator on {self.device}")
        cfg, ev = self.cfg, self.cfg.evaluation
        budget = ev.sample_budget
        if budget is not None and budget <= 0:
            budget = None
        B = ev.batch_size
        occ = occ_bool.to(self.device)
        noise = torch.zeros(B, device=self.device)
        n = rays_o.shape[0]
        outs = {"rgb": [], "depth": [], "opacity": []}
        with torch.no_grad():
            for i in range(0, n, B):
                o = np.array(rays_o[i:i + B], np.float32)  # writable copies
                d = np.array(rays_d[i:i + B], np.float32)
                pad = B - o.shape[0]
                if pad:
                    o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
                    d = np.concatenate(
                        [d, np.tile(np.array([[0, 0, 1]], np.float32), (pad, 1))]
                    )
                res = render_rays(
                    model, occ, torch.from_numpy(o).to(self.device),
                    torch.from_numpy(d).to(self.device), noise,
                    exp_step_factor=cfg.exp_step_factor,
                    max_samples=ev.max_samples_per_ray,
                    n_candidates=cfg.training.march_candidates,
                    march_resolution=cfg.training.march_resolution,
                    sample_budget=budget,
                )
                for k in outs:
                    outs[k].append(res[k][:B - pad])
        return {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}

    # ----------------------------------------------------------- color eval
    def evaluate_color(self, model: NGPModel, occ_bool, img_idxs: np.ndarray,
                       save_dir: Optional[str] = None) -> Dict[str, float]:
        """Full-image renders -> PSNR/SSIM; with ``save_dir`` also the
        per-image ``rgb_###.png`` / ``rgb_gt_###.png`` / ``depth_###.png``
        (reference: training/trainer.py:304-372, export :358-370)."""
        if self.img_wh is None:
            raise ValueError("Evaluator needs img_wh for color evaluation")
        W, H = self.img_wh
        ds = self.ds
        rgbs, gts, depths = [], [], []
        for i in np.asarray(img_idxs, int):
            dirs_cam = ds["directions"][int(ds["cam_idx"][i])]  # (H*W, 3)
            pose = ds["poses"][i]  # (3, 4)
            rays_d = dirs_cam @ pose[:3, :3].T
            rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
            out = self.render_batched(model, occ_bool, rays_o, rays_d)
            rgbs.append(out["rgb"].reshape(H, W, 3))
            gts.append(ds["rgbs"][i].reshape(H, W, 3))
            depths.append(out["depth"].reshape(H, W))
        rgbs, gts, depths = np.stack(rgbs), np.stack(gts), np.stack(depths)
        if save_dir:
            self.save_render_images(save_dir, np.asarray(img_idxs, int),
                                    rgbs, gts, depths)
        return {"psnr": M.psnr(rgbs, gts), "ssim": M.ssim(rgbs, gts)}

    @staticmethod
    def save_render_images(save_dir, img_idxs, rgbs, gts, depths):
        """Rendered and GT colour and the turbo-coloured depth (scaled by
        the largest depth) of each image as PNGs, the pixels of the JAX
        package's ``save_render_images`` (evaluator.py:160-183)."""
        os.makedirs(save_dir, exist_ok=True)
        d_max = float(np.nanmax(depths)) if np.isfinite(depths).any() else 1.0
        d_max = d_max if d_max > 0 else 1.0
        for j, i in enumerate(img_idxs):
            for name, img in (("rgb", rgbs[j]), ("rgb_gt", gts[j])):
                write_png(os.path.join(save_dir, f"{name}_{i:03d}.png"),
                          (np.clip(img, 0, 1) * 255).astype(np.uint8))
            dn = np.clip(depths[j] / d_max, 0.0, 1.0)
            write_png(os.path.join(save_dir, f"depth_{i:03d}.png"),
                      (turbo(dn) * 255).astype(np.uint8))

    # --------------------------------------------------------- density slice
    def density_slice(
        self,
        model: NGPModel,
        res_map: int,
        height_w: float,
        num_avg_heights: int = 1,
        tolerance_w: float = 0.0,
        threshold: float = 10.0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Horizontal density-map slice and its thresholded binarization
        (reference: training/trainer_base.py:92-140 ``interfereDensityMap``).

        Probes ``model.density`` on an L x L x A cube-coordinate grid
        around the world height ``height_w`` (+- ``tolerance_w``), in
        chunks of ``evaluation.batch_size`` on the model's device, takes
        the nanmax over the A heights, and thresholds.

        Returns:
            (density_map (L, L), density_map_thr (L, L)) numpy arrays.
        """
        height_c = float(
            self.scene.w2c(np.array([[0.0, 0.0, height_w]]))[0, 2]
        )
        tol_c = float(self.scene.w2c(tolerance_w, only_scale=True))
        pos = create_scan_pos(
            res_map=res_map,
            height_c=height_c,
            num_avg_heights=num_avg_heights,
            tolerance_c=tol_c,
        )  # (L*L*A, 3)
        density = density_in_chunks(model, pos, self.cfg.evaluation.batch_size)
        density = density.reshape(res_map, res_map, num_avg_heights)
        density_map = np.nanmax(density, axis=2)
        return density_map, (density_map >= threshold).astype(np.float32)

    # -------------------------------------------------------- robot pose/FoV
    def get_robot_pose_2d(
        self, img_idxs: np.ndarray
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Per-camera-stack 2-D robot pose in world coordinates
        (reference: datasets/dataset_ethz.py:195-259 ``getRobotPose2D``):
        the camera origin and the world XY angle of the central pixel's ray
        of each stack's time-synchronous image.

        Returns:
            pos: {camera_name: (N, 2) world XY}, orientation: {name: (N,)}.
        """
        if self.img_wh is None:
            raise ValueError("get_robot_pose_2d needs img_wh")
        W, H = self.img_wh
        center = (H // 2) * W + W // 2  # reference: 0.5*W*(H+1)
        ds = self.ds
        img_idxs = np.asarray(img_idxs, int)
        sync = _sync_idxs(ds["times"], ds["sensor_ids"], img_idxs)
        stacks = np.unique(ds["sensor_ids"])
        cam_idx = ds["cam_idx"].astype(int)
        pos: Dict[str, np.ndarray] = {}
        orientation: Dict[str, np.ndarray] = {}
        for j, s in enumerate(stacks):
            ii = sync[:, j]
            p = ds["poses"][ii]  # (N, 3, 4)
            d_cam = ds["directions"][cam_idx[ii], center]  # (N, 3)
            d_w = np.einsum("nij,nj->ni", p[:, :3, :3], d_cam)
            o_w = self.scene.c2w(p[:, :3, 3])
            name = f"CAM{int(s)}"
            pos[name] = o_w[:, :2]
            orientation[name] = np.arctan2(d_w[:, 1], d_w[:, 0])
        return pos, orientation

    def get_field_of_view(self, img_idxs: np.ndarray):
        """Per-image angular FoV ranges of every sensor
        (reference: datasets/dataset_ethz.py:261-307): camera orientation
        ± half the sensor's horizontal angle of view; NeRF scans are 360°.

        Returns:
            fov: {sensor: {camera: (N, 2) [min, max] angles}},
            pos: {camera: (N, 2)}, orientation: {camera: (N,)}.
        """
        pos, orientation = self.get_robot_pose_2d(img_idxs)
        n = np.asarray(img_idxs).shape[0]
        half = {
            "USS": 0.5 * np.deg2rad(self.cfg.uss.angle_of_view[0]),
            "ToF": 0.5 * np.deg2rad(self.cfg.tof.angle_of_view[0]),
            "RGBD": 0.5 * np.deg2rad(self.cfg.rgbd.angle_of_view[0]),
        }
        fov = {
            sensor: {
                name: orientation[name][:, None] + np.array([-h, h])
                for name in orientation
            }
            for sensor, h in half.items()
        }
        first = next(iter(orientation))
        fov["NeRF"] = {first: np.tile([-np.pi, np.pi], (n, 1))}
        # normalize angles to [-pi, pi] (reference quirk: single wrap)
        for sensor in fov:
            for cam in fov[sensor]:
                a = fov[sensor][cam]
                a[a > np.pi] -= 2 * np.pi
                a[a < -np.pi] += 2 * np.pi
        return fov, pos, orientation

    # ----------------------------------------------------------- depth data
    def _scan_origins(self, img_idxs: np.ndarray) -> np.ndarray:
        """Per-image scan origin = camera position (cube coords)."""
        return self.ds["poses"][img_idxs, :3, 3]

    @tracing.spanned("evaluator.gt_scan")
    def _get_gt_data(self, img_idxs: np.ndarray):
        """GT 360-degree scan by ray-casting the GT slice raster
        (reference: training/trainer.py:534-571), the rays walked on the
        evaluator's device (``Scene.scan_depths``)."""
        ev = self.cfg.evaluation
        rays_o, rays_d = create_scan_rays(self._scan_origins(img_idxs),
                                          ev.res_angular)
        depths_c = self.scene.scan_depths(
            ev.res_map, rays_o, rays_d, ev.height_tolerance,
            device=self.device)[0]
        return (self.scene.c2w(rays_o), rays_d,
                self.scene.c2w(depths_c, only_scale=True))

    def _get_nerf_data(self, model: NGPModel, occ_bool, img_idxs: np.ndarray):
        """NeRF 360-degree depth scan (reference: training/trainer.py:573-629)."""
        ev = self.cfg.evaluation
        rays_o, rays_d = create_scan_rays(self._scan_origins(img_idxs),
                                          ev.res_angular)
        out = self.render_batched(model, occ_bool, rays_o, rays_d)
        return (self.scene.c2w(rays_o), rays_d,
                self.scene.c2w(out["depth"], only_scale=True))

    def _get_sensor_data(self, img_idxs: np.ndarray, sensor: str):
        """Measured USS/ToF/RGBD depths within the height band, NaN-packed to
        a common per-image width (reference: training/trainer.py:681-762)."""
        ds = self.ds
        ev = self.cfg.evaluation
        if sensor == "USS":
            pix = ds["uss_mask_idx"].astype(int)
        elif sensor == "ToF":
            pix = ds["tof_mask_idx"].astype(int)
        else:
            pix = np.arange(self.n_pixels)
        N = img_idxs.shape[0]
        k = pix.shape[0]

        poses = ds["poses"][img_idxs]  # (N, 3, 4)
        cams = ds["cam_idx"][img_idxs]
        rays_d = np.einsum(
            "nij,nkj->nki", poses[:, :3, :3], ds["directions"][cams][:, pix]
        )  # (N, k, 3)
        rays_o = np.broadcast_to(poses[:, None, :3, 3], rays_d.shape).copy()
        depths_c = self.depths[sensor][img_idxs][:, pix]  # (N, k)

        rays_o_w = self.scene.c2w(rays_o.reshape(-1, 3)).reshape(N, k, 3)
        depths_w = self.scene.c2w(depths_c, only_scale=True)

        # height-band filter (training/trainer.py:731-735)
        dz = depths_w * rays_d[:, :, 2]
        mask = (
            (dz >= -ev.height_tolerance)
            & (dz <= ev.height_tolerance)
            & ~np.isnan(depths_w)
        )  # (N, k)

        K = int(max(mask.sum(axis=1).max(), 1))
        rays_o_p = np.full((N, K, 3), np.nan)
        rays_d_p = np.full((N, K, 3), np.nan)
        depths_p = np.full((N, K), np.nan)
        for i in range(N):
            m = mask[i]
            c = int(m.sum())
            rays_o_p[i, :c] = rays_o_w[i, m]
            rays_d_p[i, :c] = rays_d[i, m]
            depths_p[i, :c] = depths_w[i, m]
        return (
            rays_o_p.reshape(-1, 3),
            rays_d_p.reshape(-1, 3),
            depths_p.reshape(-1),
        )

    @staticmethod
    def pack_lidar_scans(
        xyzs,
        poses_w: np.ndarray,
        scan_heights: np.ndarray,
        height_tolerance: float,
    ):
        """Per-image LiDAR clouds -> NaN-packed (rays_o, rays_d, depths)
        within the scan height band (reference: training/trainer.py:631-679).

        Args:
            xyzs: list of N (M_i, 3) world clouds (e.g. from
                ``data.ethz.load_lidar_maps``).
            poses_w: (N, 3, 4) LiDAR poses in world coordinates.
            scan_heights: (N,) world z of the camera scan plane.
        """
        N = len(xyzs)
        sliced = []
        K = 1
        for i, xyz in enumerate(xyzs):
            lo = scan_heights[i] - height_tolerance
            hi = scan_heights[i] + height_tolerance
            sel = xyz[(xyz[:, 2] >= lo) & (xyz[:, 2] <= hi)]
            sliced.append(sel)
            K = max(K, sel.shape[0])
        rays_o = np.full((N, K, 3), np.nan)
        rays_d = np.full((N, K, 3), np.nan)
        depths = np.full((N, K), np.nan)
        for i, sel in enumerate(sliced):
            k = sel.shape[0]
            if k == 0:
                continue
            origin = poses_w[i, :3, 3]
            scan_o = np.array([origin[0], origin[1], scan_heights[i]])
            diff = sel - origin
            dist = np.linalg.norm(diff, axis=1)
            rays_o[i, :k] = scan_o
            rays_d[i, :k] = diff / dist[:, None]
            depths[i, :k] = dist
        return (
            rays_o.reshape(-1, 3),
            rays_d.reshape(-1, 3),
            depths.reshape(-1),
        )

    # ----------------------------------------------------------- depth eval
    @tracing.spanned("evaluator.call")
    def evaluate_depth(
        self,
        model: NGPModel,
        occ_bool,
        img_idxs: np.ndarray,
        sensors: Iterable[str] = ("GT", "NeRF"),
        fov: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
        robot_pos: Optional[Dict[str, np.ndarray]] = None,
        extra_sensor_data: Optional[Dict[str, tuple]] = None,
    ):
        """Depth evaluation over sensors (reference: training/trainer.py:374-490).

        Args:
            img_idxs: (N,) test image indices.
            sensors: subset of {GT, NeRF, USS, ToF, RGBD} and the keys of
                ``extra_sensor_data``; GT is mandatory and evaluated first.
            fov: sensor -> {camera: (N, 2) angular ranges}.  By default,
                with ``img_wh``, the per-image robot FoV
                (``get_field_of_view``), so the ``nn``/``nn_inv``
                directions compare against FoV-limited GT as in the
                reference (training/trainer.py:401-434); ``fov={}``
                disables it.
            robot_pos: camera -> (N, 2) positions for ``fov`` (default:
                ``get_field_of_view``'s).
            extra_sensor_data: sensor -> precomputed world (rays_o, rays_d,
                depths), e.g. LiDAR scans from ``pack_lidar_scans``.
        Returns:
            (metrics_dict, data_dict) keyed by sensor.
        """
        img_idxs = np.asarray(img_idxs, int)
        N = img_idxs.shape[0]
        ev = self.cfg.evaluation
        zones = {k: tuple(v) for k, v in ev.zones.items()}

        if fov is None and self.img_wh is not None:
            fov, fov_robot_pos, _ = self.get_field_of_view(img_idxs)
            if robot_pos is None:
                robot_pos = fov_robot_pos

        metrics_dict: Dict[str, dict] = {}
        data_dict: Dict[str, dict] = {}
        sensors = ["GT"] + [s for s in sensors if s != "GT"]

        for sensor in sensors:
            if sensor == "GT":
                rays_o, rays_d, depths = self._get_gt_data(img_idxs)
            elif sensor == "NeRF":
                rays_o, rays_d, depths = self._get_nerf_data(
                    model, occ_bool, img_idxs
                )
            elif extra_sensor_data is not None and sensor in extra_sensor_data:
                rays_o, rays_d, depths = extra_sensor_data[sensor]
            else:
                rays_o, rays_d, depths = self._get_sensor_data(img_idxs, sensor)

            pos, pos_o, dists = self.scene.depth2pos(rays_o, rays_d, depths)

            if sensor == "GT":
                data_dict["GT"] = {
                    "pos": pos, "pos_o": pos_o, "depths": dists,
                    "rays_o": rays_o,
                }
                continue

            if fov is not None and sensor in fov and robot_pos is not None:
                pos_gt, pos_o_gt = limit_fov(
                    data_dict["GT"]["pos"], data_dict["GT"]["pos_o"],
                    fov[sensor], N, robot_pos,
                )
            else:
                pos_gt = data_dict["GT"]["pos"]
                pos_o_gt = data_dict["GT"]["pos_o"]

            res = {}
            for suffix, (p, p_ref, ref_is_gt) in {
                "": (pos, pos_gt, True),
                "_inv": (pos_gt, pos, False),
                "_inv_360": (data_dict["GT"]["pos"], pos, False),
            }.items():
                with tracing.span("evaluator.nnd"):
                    nn_dists, mean, median, inlier, too_close = M.nn_metrics(
                        p, p_ref, dists, data_dict["GT"]["depths"], N,
                        ref_pos_is_gt=ref_is_gt, zones=zones,
                        inlier_threshold=ev.inlier_threshold,
                        device=self.device,
                    )
                res[f"nn_dists{suffix}"] = nn_dists
                res[f"nn_mean{suffix}"] = mean
                res[f"nn_median{suffix}"] = median
                res[f"nn_inlier{suffix}"] = inlier
                res[f"nn_outlier_too_close{suffix}"] = too_close

            data_dict[sensor] = {
                "pos": pos, "pos_o": pos_o, "depths": dists,
                "pos_gt": pos_gt, "pos_o_gt": pos_o_gt,
            }
            metrics_dict[sensor] = res

        return metrics_dict, data_dict

    # -------------------------------------------------------------- summary
    def evaluate(
        self,
        model: NGPModel,
        occ_bool,
        color_img_idxs: Optional[np.ndarray] = None,
        depth_img_idxs: Optional[np.ndarray] = None,
        sensors: Optional[Iterable[str]] = None,
        save_dir: Optional[str] = None,
        plot: bool = False,
    ) -> Dict[str, dict]:
        """Colour and depth evaluation (reference: training/trainer.py:
        167-224, 868-906); every sensor's metrics carry the colour
        PSNR/SSIM.  With ``save_dir``: ``metrics.csv`` and ``renders/``,
        and with ``plot`` the per-image scan maps and NND histograms
        (``maps/map{i}.png``) and the 9-panel NND summary
        (``metrics.png``, trainer_plot.py:156-394).  ``plot`` with a
        ``save_dir`` needs matplotlib: without it, ImportError before any
        render."""
        if plot and save_dir:
            require_matplotlib()
        ev = self.cfg.evaluation
        n = self.n_images
        if color_img_idxs is None:
            k = ev.num_color_pts if isinstance(ev.num_color_pts, int) else n
            color_img_idxs = np.linspace(0, n - 1, min(k, n)).astype(int)
        if depth_img_idxs is None:
            k = ev.num_depth_pts if isinstance(ev.num_depth_pts, int) else n
            depth_img_idxs = np.linspace(0, n - 1, min(k, n)).astype(int)
        if sensors is None:
            sensors = [
                s for s in ev.sensors
                if s in ("GT", "NeRF") or s in self.depths
            ]

        if len(np.atleast_1d(color_img_idxs)) == 0:
            # num_color_pts=0 skips colour, as the reference's PSO protocol
            # does (reference: run_optimization.py:32)
            color = {"psnr": float("nan"), "ssim": float("nan")}
        else:
            color = self.evaluate_color(
                model, occ_bool, color_img_idxs,
                save_dir=os.path.join(save_dir, "renders") if save_dir else None,
            )
        metrics_dict, data_dict = self.evaluate_depth(
            model, occ_bool, depth_img_idxs, sensors
        )
        for key in metrics_dict:
            metrics_dict[key]["psnr"] = color["psnr"]
            metrics_dict[key]["ssim"] = color["ssim"]
        if save_dir:
            self.save_metrics_csv(metrics_dict,
                                  os.path.join(save_dir, "metrics.csv"))
            if plot:
                self._plot_depth(save_dir, data_dict, metrics_dict,
                                 depth_img_idxs)
        return metrics_dict

    def _plot_depth(self, save_dir, data_dict, metrics_dict, depth_img_idxs):
        """``maps/map{i}.png`` and ``metrics.png`` (the JAX ``evaluate``'s
        plot block, evaluator.py:586-611)."""
        from virus_nerf_tpu_torch.evaluation.plots import (
            plot_maps_per_image,
            plot_nnd_summary,
        )

        ev = self.cfg.evaluation
        robot = None
        if self.img_wh is not None:
            pos, orientation = self.get_robot_pose_2d(depth_img_idxs)
            robot = {"pos": pos, "orientation": orientation}
        plot_maps_per_image(
            self.scene, data_dict, metrics_dict,
            sensors=list(metrics_dict.keys()),
            num_points=len(np.asarray(depth_img_idxs)),
            res_map=ev.res_map,
            height_tolerance=ev.height_tolerance,
            save_dir=os.path.join(save_dir, "maps"),
            num_plot_pts=int(ev.num_plot_pts),
            robot=robot,
        )
        plot_nnd_summary(
            metrics_dict,
            zones=tuple(ev.zones.keys()),
            path=os.path.join(save_dir, "metrics.png"),
            zone_ranges=ev.zones,
        )

    def export_nerf_pointcloud(
        self,
        model: NGPModel,
        occ_bool,
        rays_o_w: np.ndarray,
        save_path: str,
        num_heights: int = 2,
        height_range: float = 0.3,
        min_opacity: float = 0.5,
    ) -> np.ndarray:
        """Render 360-degree scans at several heights and export the hit
        points as a PCD point cloud (reference: training/trainer.py:908-1003).

        Args:
            rays_o_w: (N, 3) world scan origins; z is replaced by
                ``num_heights`` values spanning +-height_range.
        Returns:
            the (M, 3) world point cloud that was written.
        """
        ev = self.cfg.evaluation
        o = np.tile(
            np.asarray(rays_o_w, np.float64)[:, None, :], (1, num_heights, 1)
        )
        o[:, :, 2] = np.linspace(-height_range, height_range, num_heights)
        o = self.scene.w2c(o.reshape(-1, 3))
        rays_o, rays_d = create_scan_rays(o, ev.res_angular)
        out = self.render_batched(model, occ_bool, rays_o, rays_d)
        depths_w = self.scene.c2w(out["depth"], only_scale=True)
        rays_o_world = self.scene.c2w(rays_o)
        pts = rays_o_world + rays_d * depths_w[:, None]
        pts = pts[out["opacity"] > min_opacity]
        save_pcd(save_path, pts.astype(np.float32))
        return pts

    @staticmethod
    def save_metrics_csv(metrics_dict: Dict[str, dict], path: str) -> None:
        """One row a sensor, one column a metric but the per-point
        ``nn_dists*`` (reference: training/trainer.py:888-905; the JAX
        package's ``save_metrics_csv``)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        sensors = list(metrics_dict)
        cols = [k for k in (metrics_dict[sensors[0]] if sensors else [])
                if not k.startswith("nn_dists")]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([""] + cols)
            for s in sensors:
                w.writerow([s] + [metrics_dict[s].get(c, "") for c in cols])
