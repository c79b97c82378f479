"""Synthesize a realistic-scale ETHZ room ON DISK in the reference layout.

Frozen copy of ``virus_nerf_tpu_torch/data/ethz_fixture.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

The port's copy of ``tools/make_ethz_fixture.py``: the same arguments,
defaults and random stream, built on the port's raycaster, PCD writer,
sensor models and PNG writer, so that it writes the same files as the tool
(the same CSV bytes, ``.npy`` arrays, PNG pixels and PCD points) without
OpenCV and without the JAX package.

The reference's entire claim is mapping real ETHZ rooms from camera + USS +
ToF (reference: README.md:19-22, loaders datasets/dataset_ethz.py:24-980).
The real recordings are not redistributable, so this tool raycasts an
analytic room fitted inside the reference's published `commonroom` world
bounds (datasets/scene_ethz.py:22-32) and writes the exact directory layout
the ETHZ loader consumes — hundreds of images from a robot trajectory, two
camera stacks, per-stack USS/ToF CSVs generated through the reference's
measurement conventions *in reverse* (counts = m*5000, pcl_creator.py:149-163;
ToF mm frames pre-un-oriented so tof_meas2depth's flip/transpose chain
reproduces the zone grid, pcl_creator.py:182-202), plus realistic sensor
noise (USS multiplicative + dropout-to-50000, ToF additive mm noise + range
clipping, RGBD mm quantization + range clipping, BALM-grade pose jitter).

Dropping in the REAL dataset afterwards needs no code changes: point
`ethz.dataset_dir` at the real `ETHZDataset` root — the layout, units, and
conventions here are the reference's own.

Usage:
    python -m virus_nerf_tpu_torch.data.ethz_fixture --out DIR \
        [--n-images 300] [--img-wh 320 240] [--seed 21] [--no-noise]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from benchmark.reference.ethz import ETHZ_ROOM_BOUNDS
from benchmark.reference.pcl import matrix_to_quat, save_pcd
from benchmark.reference.png import write_png
from benchmark.reference.rays import get_ray_directions
from benchmark.reference.sensors import ToFModel, USSModel
from benchmark.rooms.raycast import _raycast, _sample_surfaces

# furniture boxes (min, max) inside the commonroom bounds, placed off the
# robot's elliptical trajectory
_BOXES = np.array(
    [
        [[11.5, -2.0, -0.4], [13.5, 0.0, 0.5]],
        [[-1.5, 5.5, -0.4], [0.5, 7.5, 0.3]],
        [[5.0, 7.0, -0.4], [7.5, 8.5, 0.6]],
        [[1.0, -2.5, -0.4], [3.0, -1.0, 0.2]],
        [[12.5, 6.0, -0.4], [14.5, 8.5, 0.8]],
    ]
)
_BOX_COLORS = np.array(
    [
        [0.85, 0.45, 0.10],
        [0.10, 0.75, 0.75],
        [0.75, 0.10, 0.75],
        [0.25, 0.55, 0.20],
        [0.60, 0.60, 0.15],
    ]
)

# mimic the sensor's physical limits for realistic invalid-measurement rates
_TOF_MAX_RANGE_M = 4.0  # VL53L5CX spec
_RGBD_MAX_RANGE_M = 6.0
_USS_NO_ECHO = 50000.0  # reference: pcl_creator.py:149-163


def _stack_pose(center, radii, phase, yaw_offset):
    """Robot-trajectory pose: position on an ellipse, camera yawed
    tangentially + ``yaw_offset`` (CAM1 faces the heading, CAM3 +90deg
    right), OpenCV camera axes (x right, y down, z forward) as world
    columns."""
    pos = np.array(
        [
            center[0] + radii[0] * np.cos(phase),
            center[1] + radii[1] * np.sin(phase),
            0.35,
        ]
    )
    tangent = np.array(
        [-radii[0] * np.sin(phase), radii[1] * np.cos(phase), 0.0]
    )
    yaw = np.arctan2(tangent[1], tangent[0]) + yaw_offset
    front = np.array([np.cos(yaw), np.sin(yaw), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    right = np.cross(down, front)
    R = np.stack([right, down, front], axis=1)
    return R, pos


def _invert_tof_orientation(depth_m: np.ndarray) -> np.ndarray:
    """Inverse of tof_meas2depth's orientation chain so that
    ``tof_meas2depth(frames)`` returns ``depth_m`` exactly
    (reference chain: pcl_creator.py:182-202)."""
    # forward: f(M) = (M[:, ::-1].T)[::-1, ::-1]
    ref2 = depth_m[::-1, ::-1]
    return ref2.T[:, ::-1]


def generate_ethz_fixture(
    out_dir: str,
    room: str = "commonroom",
    n_images: int = 300,
    img_wh=(320, 240),
    seed: int = 21,
    noise: bool = True,
    n_gt_points: int = 800_000,
    cam_aov_deg=(90.0, 65.0),
    uss_aov_deg=(55.0, 35.0),
    tof_aov_deg=(45.0, 45.0),
) -> str:
    """Write the fixture; returns the dataset_dir to point the config at."""
    rng = np.random.default_rng(seed)
    W, H = img_wh
    lo, hi = (np.array(b, float) for b in ETHZ_ROOM_BOUNDS[room])
    room_min, room_max = lo.copy(), hi.copy()

    root = os.path.join(out_dir)
    rdir = os.path.join(root, room)
    meas_dir = os.path.join(rdir, "measurements")
    os.makedirs(os.path.join(rdir, "poses"), exist_ok=True)
    os.makedirs(os.path.join(rdir, "maps"), exist_ok=True)

    # ---- intrinsics -------------------------------------------------
    fx = W / 2.0 / np.tan(np.deg2rad(cam_aov_deg[0]) / 2.0)
    fy = H / 2.0 / np.tan(np.deg2rad(cam_aov_deg[1]) / 2.0)
    with open(os.path.join(root, "camera_intrinsics.CSV"), "w") as f:
        f.write("cam_id,fx,fy,cx,cy\n")
        for cam in ("CAM1", "CAM3"):
            f.write(f"{cam},{fx},{fy},{W / 2},{H / 2}\n")
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1.0]])
    dirs = get_ray_directions(H, W, K, normalize=True)  # (H*W, 3) unit

    # ---- sensor pixel lattices (same models the loader builds) ------
    uss_model = USSModel(img_wh, cam_aov_deg, aov_sensor_deg=uss_aov_deg)
    tof_model = ToFModel(img_wh, cam_aov_deg, aov_sensor_deg=tof_aov_deg)
    uss_mask = uss_model.mask  # (H*W,) bool
    # zone k of convert_depth(format="sensor") lands on flat-mask-order
    # pixel k — row-major over the 8x8 lattice
    tof_pix = np.where(tof_model.mask)[0]  # (64,) flat pixel indices
    assert tof_pix.shape[0] == 64

    # ---- trajectory: ellipse inside the room ------------------------
    center = (lo[:2] + hi[:2]) / 2.0
    radii = (hi[:2] - lo[:2]) / 2.0 - 2.2  # keep >2m off the walls
    radii = np.maximum(radii, 0.5)
    phases = np.linspace(0.0, 2.0 * np.pi, n_images, endpoint=False)

    cams = {"CAM1": 0.0, "CAM3": np.pi / 2.0}  # yaw offsets (stack layout)
    for cam, yaw_off in cams.items():
        sid = int(cam[-1])
        cdir = os.path.join(meas_dir, f"{cam}_color_image_raw")
        ddir = os.path.join(meas_dir, f"{cam}_aligned_depth_to_color_image_raw")
        os.makedirs(cdir, exist_ok=True)
        os.makedirs(ddir, exist_ok=True)

        pose_rows, lidar_rows, uss_rows, tof_rows = [], [], [], []
        for i, ph in enumerate(phases):
            R, pos = _stack_pose(center, radii, ph, yaw_off)
            t = 100.0 + 0.5 * i
            # BALM-grade pose jitter on the WRITTEN pose (the scene stays
            # exact): ~5 mm translation, ~0.2deg rotation
            R_w, pos_w = R, pos
            if noise:
                ang = np.deg2rad(0.2) * rng.normal(size=3)
                cx_, cy_, cz_ = np.cos(ang)
                sx_, sy_, sz_ = np.sin(ang)
                Rx = np.array([[1, 0, 0], [0, cx_, -sx_], [0, sx_, cx_]])
                Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
                Rz = np.array([[cz_, -sz_, 0], [sz_, cz_, 0], [0, 0, 1]])
                R_w = Rz @ Ry @ Rx @ R
                pos_w = pos + 0.005 * rng.normal(size=3)
            q = matrix_to_quat(R_w)
            pose_rows.append((t, *pos_w, *q))
            lidar_rows.append((t, pos_w[0], pos_w[1], pos_w[2] + 0.2, *q))

            # ---- raycast the EXACT pose the loader will reconstruct ----
            rays_d = dirs @ R_w.T
            rays_o = np.broadcast_to(pos_w, rays_d.shape)
            depth, rgb = _raycast(
                rays_o, rays_d, _BOXES, _BOX_COLORS,
                room_min=room_min, room_max=room_max,
            )

            # color png (mild distance shading + pixel noise)
            shade = 1.0 - 0.25 * np.clip(depth / 12.0, 0.0, 1.0)
            img = rgb * shade[:, None]
            if noise:
                img = img + rng.normal(0.0, 2.0 / 255.0, img.shape)
            img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(cdir, f"img{i}.png"), img8.reshape(H, W, 3),
                      level=1)

            # RGBD npy: z-depth in mm (loader divides by unit-dir z,
            # data/ethz.py RGBD block)
            zmm = depth * dirs[:, 2] * 1000.0
            if noise:
                zmm = zmm + rng.normal(0.0, 2.0, zmm.shape)
            zmm = np.where(depth > _RGBD_MAX_RANGE_M, 0.0, np.round(zmm))
            np.save(os.path.join(ddir, f"img{i}.npy"), zmm.reshape(H, W))

            # USS: cone minimum -> counts (reference: pcl_creator.py:149-163
            # inverse; RH simulation analogue: datasets/dataset_rh.py:450-504)
            m = float(np.nanmin(depth[uss_mask]))
            if noise:
                m *= 1.0 + 0.03 * rng.normal()
            counts = m * 5000.0
            if noise and rng.random() < 0.02:
                counts = _USS_NO_ECHO  # no echo
            uss_rows.append((t, min(counts, _USS_NO_ECHO)))

            # ToF: zone depths at the 8x8 lattice -> mm frame, un-oriented
            d64 = depth[tof_pix].reshape(8, 8)
            if noise:
                d64 = d64 + rng.normal(0.0, 0.02, d64.shape)
            d64 = np.where(d64 > _TOF_MAX_RANGE_M, 0.0, d64)
            frame_mm = _invert_tof_orientation(d64) * 1000.0
            tof_rows.append((t, frame_mm.reshape(64)))

        # ---- CSVs ----------------------------------------------------
        for name, rows in (
            (f"poses_cam_balm_sync{sid}.csv", pose_rows),
            (f"poses_lidar_balm_sync{sid}.csv", lidar_rows),
            (f"poses_cam_sync{sid}.csv", pose_rows),
            (f"poses_lidar_sync{sid}.csv", lidar_rows),
        ):
            with open(os.path.join(rdir, "poses", name), "w") as f:
                f.write("time,x,y,z,qx,qy,qz,qw\n")
                for r in rows:
                    f.write(",".join(f"{v:.9f}" for v in r) + "\n")
        with open(os.path.join(meas_dir, f"USS{sid}.csv"), "w") as f:
            f.write("time,meas\n")
            for t, c in uss_rows:
                f.write(f"{t:.6f},{c:.1f}\n")
        with open(os.path.join(meas_dir, f"TOF{sid}.csv"), "w") as f:
            cols = (
                ["time"]
                + [f"meas_{i}" for i in range(64)]
                + [f"stds_{i}" for i in range(64)]
            )
            f.write(",".join(cols) + "\n")
            for t, frame in tof_rows:
                f.write(
                    ",".join(
                        [f"{t:.6f}"]
                        + [f"{v:.1f}" for v in frame]
                        + ["15.0"] * 64
                    )
                    + "\n"
                )

    # ---- GT map ------------------------------------------------------
    pts = _sample_surfaces(
        rng, _BOXES, n_gt_points, room_min=room_min, room_max=room_max
    )
    save_pcd(
        os.path.join(rdir, "maps", "map_balm.pcd"),
        pts.astype(np.float32),
        binary=True,
    )
    return root


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--room", default="commonroom")
    p.add_argument("--n-images", type=int, default=300)
    p.add_argument("--img-wh", type=int, nargs=2, default=(320, 240))
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--no-noise", action="store_true")
    p.add_argument("--n-gt-points", type=int, default=800_000)
    args = p.parse_args()
    root = generate_ethz_fixture(
        args.out,
        room=args.room,
        n_images=args.n_images,
        img_wh=tuple(args.img_wh),
        seed=args.seed,
        noise=not args.no_noise,
        n_gt_points=args.n_gt_points,
    )
    print(root)


# the name the benchmark finds a room writer by
write_room = generate_ethz_fixture


if __name__ == "__main__":
    main()
