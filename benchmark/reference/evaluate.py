"""The reference's depth evaluation: the NeRF's 360-degree scans and their
NND metrics against the ground-truth slice.

Frozen copy of the depth path of ``virus_nerf_tpu_torch/evaluation/
evaluator.py`` (``evaluate_depth`` with its GT scans, fields of view and
robot poses, all numpy on the host), with the render written plainly: the
scan rays in blocks through ``renderer.render_rays`` (the dense march at
``evaluation.max_samples_per_ray``, no jitter, the plain model), where the
program renders fixed chunks of ``evaluation.batch_size`` rays, the last
one padded.  A ray's depth does not depend on the rays rendered beside it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from benchmark.reference import metrics as M
from benchmark.reference.geometry import create_scan_rays, limit_fov
from benchmark.reference.renderer import render_rays

RENDER_BLOCK = 2048  # rays a block of the reference's render


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



class DepthEvaluator:
    """The depth evaluation of one split, on the host around block renders
    on ``device``."""

    def __init__(
        self,
        cfg,
        dataset,
        scene,
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

    def render_batched(self, model, occ_bool, rays_o: np.ndarray,
                       rays_d: np.ndarray) -> Dict[str, np.ndarray]:
        """Depth, opacity and colour of every ray, ``RENDER_BLOCK`` rays at a
        time, with no march jitter."""
        cfg, ev = self.cfg, self.cfg.evaluation
        occ = occ_bool.to(self.device)
        outs = {"rgb": [], "depth": [], "opacity": []}
        with torch.no_grad():
            for i in range(0, rays_o.shape[0], RENDER_BLOCK):
                o = torch.from_numpy(np.array(rays_o[i:i + RENDER_BLOCK], np.float32)).to(self.device)
                d = torch.from_numpy(np.array(rays_d[i:i + RENDER_BLOCK], np.float32)).to(self.device)
                res = render_rays(
                    model, occ, o, d, torch.zeros(o.shape[0], device=self.device),
                    exp_step_factor=cfg.exp_step_factor,
                    max_samples=ev.max_samples_per_ray,
                    n_candidates=cfg.training.march_candidates,
                    march_resolution=cfg.training.march_resolution,
                    sample_budget=None,
                )
                for k in outs:
                    outs[k].append(res[k])
        return {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}

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

    def _scan_origins(self, img_idxs: np.ndarray) -> np.ndarray:
        """Per-image scan origin = camera position (cube coords)."""
        return self.ds["poses"][img_idxs, :3, 3]

    def _get_gt_data(self, img_idxs: np.ndarray):
        """GT 360-degree scan by ray-casting the GT slice raster
        (reference: training/trainer.py:534-571)."""
        ev = self.cfg.evaluation
        rays_o, rays_d = create_scan_rays(self._scan_origins(img_idxs),
                                          ev.res_angular)
        _, depths_c, _ = self.scene.get_slice_scan(
            res=ev.res_map, rays_o=rays_o, rays_d=rays_d,
            height_tolerance=ev.height_tolerance, rays_o_in_world_coord=False,
        )
        return (self.scene.c2w(rays_o), rays_d,
                self.scene.c2w(depths_c, only_scale=True))

    def _get_nerf_data(self, model, occ_bool, img_idxs: np.ndarray):
        """NeRF 360-degree depth scan (reference: training/trainer.py:573-629)."""
        ev = self.cfg.evaluation
        rays_o, rays_d = create_scan_rays(self._scan_origins(img_idxs),
                                          ev.res_angular)
        out = self.render_batched(model, occ_bool, rays_o, rays_d)
        return (self.scene.c2w(rays_o), rays_d,
                self.scene.c2w(out["depth"], only_scale=True))

    def evaluate_depth(
        self,
        model,
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
                raise ValueError(f"the reference evaluates GT and NeRF, not {sensor}")

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
                nn_dists, mean, median, inlier, too_close = M.nn_metrics(
                    p, p_ref, dists, data_dict["GT"]["depths"], N,
                    ref_pos_is_gt=ref_is_gt, zones=zones,
                    inlier_threshold=ev.inlier_threshold,
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
