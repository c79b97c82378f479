"""Synthetic box-world dataset for tests and benchmarks.

Counterpart of ``virus_nerf_tpu/data/synthetic.py``: the scene, cameras,
analytic depth/colour and simulated USS/ToF readings are the same numpy
computation (imported here from the port's numpy copies); only the
returned ``DeviceDataset`` holds torch tensors on a chosen device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.data.dataset import DeviceDataset
from virus_nerf_tpu_torch.data.rays import get_ray_directions
from virus_nerf_tpu_torch.data.scene import Scene
from virus_nerf_tpu_torch.data.sensors import RGBDModel, ToFModel, USSModel

# default room: 6m x 6m x 3m centered at origin
_ROOM_MIN = np.array([-3.0, -3.0, -1.5])
_ROOM_MAX = np.array([3.0, 3.0, 1.5])

_WALL_COLORS = np.array(
    [
        [0.9, 0.3, 0.3],  # +x wall
        [0.3, 0.9, 0.3],  # -x wall
        [0.3, 0.3, 0.9],  # +y wall
        [0.9, 0.9, 0.3],  # -y wall
        [0.8, 0.8, 0.8],  # ceiling
        [0.4, 0.4, 0.4],  # floor
    ]
)


def _default_boxes() -> Tuple[np.ndarray, np.ndarray]:
    """A few box obstacles (min, max) + colors."""
    mins = np.array([[1.2, -0.6, -1.5], [-2.2, 1.0, -1.5], [-0.5, -2.4, -1.5]])
    maxs = np.array([[2.0, 0.4, 0.2], [-1.4, 2.0, 0.0], [0.5, -1.6, -0.3]])
    colors = np.array([[0.9, 0.5, 0.1], [0.1, 0.8, 0.8], [0.8, 0.1, 0.8]])
    return np.stack([mins, maxs], axis=1), colors


def _raycast(rays_o, rays_d, boxes, box_colors, room_min=None, room_max=None):
    """Exact depth (N,) + color (N, 3) of rays from inside the room
    (default: the synthetic room): min(room-wall exit, nearest obstacle
    entry).  The JAX package's arithmetic, element for element, laid out
    axis-major (3, N) so that the reductions over the axes run on rows."""
    room_min = _ROOM_MIN if room_min is None else np.asarray(room_min)
    room_max = _ROOM_MAX if room_max is None else np.asarray(room_max)
    n = rays_o.shape[0]
    inv = 1.0 / np.where(np.abs(rays_d) < 1e-12, 1e-12, rays_d)
    inv, o = np.ascontiguousarray(inv.T), np.ascontiguousarray(np.asarray(rays_o).T)
    t_exit_per_axis = np.maximum(
        (room_min[:, None] - o) * inv, (room_max[:, None] - o) * inv
    )  # (3, N)
    axis = np.argmin(t_exit_per_axis, axis=0)
    depth = t_exit_per_axis[axis, np.arange(n)]
    sign_pos = rays_d[np.arange(n), axis] > 0
    color = axis * 2 + (~sign_pos).astype(int)  # row of the palette
    for b in range(boxes.shape[0]):
        bt_lo = (boxes[b, 0][:, None] - o) * inv
        bt_hi = (boxes[b, 1][:, None] - o) * inv
        t1 = np.maximum.reduce(np.minimum(bt_lo, bt_hi))
        t2 = np.minimum.reduce(np.maximum(bt_lo, bt_hi))
        hit = (t2 > t1) & (t1 > 1e-6) & (t1 < depth)
        depth = np.where(hit, t1, depth)
        color = np.where(hit, len(_WALL_COLORS) + b, color)
    return depth, np.concatenate([_WALL_COLORS, box_colors])[color]


def _sample_surfaces(rng, boxes: np.ndarray, n_points: int,
                     room_min=None, room_max=None) -> np.ndarray:
    """Points uniform by area on the room walls + box faces (the GT map;
    default room: the synthetic one)."""
    room_min = _ROOM_MIN if room_min is None else np.asarray(room_min)
    room_max = _ROOM_MAX if room_max is None else np.asarray(room_max)
    aabbs = np.concatenate(
        [np.stack([room_min, room_max])[None], boxes], axis=0
    )
    faces = []
    for b in range(aabbs.shape[0]):
        ext = aabbs[b, 1] - aabbs[b, 0]
        for axis in range(3):
            area = ext[(axis + 1) % 3] * ext[(axis + 2) % 3]
            for side in range(2):
                faces.append((axis, side, b, area))
    areas = np.array([f[3] for f in faces])
    counts = rng.multinomial(n_points, areas / areas.sum())
    pts = []
    for (axis, side, b, _), c in zip(faces, counts):
        if c == 0:
            continue
        p = rng.uniform(aabbs[b, 0], aabbs[b, 1], size=(c, 3))
        p[:, axis] = aabbs[b, side, axis]
        pts.append(p)
    return np.concatenate(pts, axis=0)


def make_synthetic_dataset(
    n_images: int = 16,
    img_wh: Tuple[int, int] = (64, 40),
    seed: int = 21,
    sensors: Tuple[str, ...] = ("RGBD", "USS", "ToF"),
    camera_aov_deg: Tuple[float, float] = (90.0, 65.0),
    tof_matrix: Tuple[int, int] = (8, 8),
    n_gt_points: int = 400_000,
    device="cuda",
) -> Tuple[DeviceDataset, Scene, Dict]:
    """Build the synthetic dataset on ``device``.

    Returns (dataset, scene, info); info carries the sensor models, the
    intrinsics and the image size.
    """
    rng = np.random.default_rng(seed)
    W, H = img_wh
    boxes, box_colors = _default_boxes()

    fx = W / 2.0 / np.tan(np.deg2rad(camera_aov_deg[0]) / 2.0)
    fy = H / 2.0 / np.tan(np.deg2rad(camera_aov_deg[1]) / 2.0)
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1.0]])
    dirs_cam = get_ray_directions(H, W, K)  # (H*W, 3) unit

    # camera poses: orbit the center at radius 1m, looking outward
    poses = np.zeros((n_images, 3, 4), np.float64)
    for i in range(n_images):
        a = 2 * np.pi * i / n_images
        front = np.array([np.cos(a), np.sin(a), 0.0])
        right = np.array([-np.sin(a), np.cos(a), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        poses[i, :, :3] = np.stack([right, down, front], axis=1)
        poses[i, :, 3] = np.array([np.cos(a), np.sin(a), 0.0])

    rgbs = np.zeros((n_images, H * W, 3), np.float32)
    depths_w = np.zeros((n_images, H * W), np.float64)
    for i in range(n_images):
        rays_d = dirs_cam @ poses[i, :, :3].T
        rays_o = np.broadcast_to(poses[i, :, 3], rays_d.shape)
        depths_w[i], rgbs[i] = _raycast(rays_o, rays_d, boxes, box_colors)

    pts = _sample_surfaces(rng, boxes, n_gt_points)
    scene = Scene(point_cloud=pts, xyz_min=_ROOM_MIN, xyz_max=_ROOM_MAX)

    uss = USSModel(img_wh, camera_aov_deg)
    tof = ToFModel(img_wh, camera_aov_deg, matrix=tof_matrix)
    rgbd = RGBDModel(img_wh, camera_aov_deg)
    models = {"RGBD": rgbd, "USS": uss, "ToF": tof}
    scale = scene.w2c(1.0, only_scale=True)  # world -> cube depth scaling
    depths = {
        name: (models[name].convert_depth(depths_w) * scale).astype(np.float32)
        for name in ("RGBD", "USS", "ToF") if name in sensors
    }

    poses_c = poses.copy()
    poses_c[:, :, 3] = scene.w2c(poses[:, :, 3])

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    dataset = DeviceDataset(
        poses=t(poses_c, torch.float32),
        directions=t(dirs_cam[None], torch.float32),
        cam_idx=torch.zeros(n_images, dtype=torch.long, device=device),
        rgbs=t(rgbs, torch.float32),
        depths={k: t(v, torch.float32) for k, v in depths.items()},
        times=t(np.linspace(0, 10, n_images), torch.float32),
        uss_mask_idx=t(np.where(uss.mask)[0], torch.long),
        tof_mask_idx=t(np.where(tof.mask)[0], torch.long),
        sensor_ids=torch.zeros(n_images, dtype=torch.long, device=device),
    )
    info = {
        "img_wh": img_wh,
        "K": K,
        "sensor_models": models,
        "boxes": boxes,
        "box_colors": box_colors,
        "depths_world": depths_w,
    }
    return dataset, scene, info
