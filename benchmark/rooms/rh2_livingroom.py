"""Synthesize a realistic-scale Robot@Home2 room ON DISK.

Frozen copy of ``virus_nerf_tpu_torch/data/rh_fixture.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

The port's copy of ``tools/make_rh_fixture.py``: the same arguments,
defaults and random stream, built on the port's raycaster, pose assembly
and PNG writer, so that it writes the same ``observations.csv`` bytes, PNG
pixels and ``scene_points.npy`` as the tool, without OpenCV and without
the JAX package.

The reference's second dataset path loads RH2 rooms through the external
``robotathome`` package: labelled RGBD observations of one room from a
4-camera rig, USS/ToF *simulated from the dense RGBD depth*
(reference: datasets/dataset_rh.py:229-267,398-504).  The real 2 GB
database is not redistributable, so this module raycasts an analytic
livingroom and writes

- per-observation RGB + depth pngs in RH2's conventions (depth value =
  z-depth * 128/5 in 8-bit, 0 = invalid — datasets/dataset_rh.py:417),
- an ``observations.csv`` with the lblrgbd schema the loader consumes
  (sensor pose as x/y/z + yaw/pitch/roll Euler angles, 4 sensor ids,
  timestamps),
- the room's GT surface point cloud,
- ``robotathome.py`` — a reader module exposing the RobotAtHome calls the
  loaders make (get_sensor_observations, name2id, get_RGBD_files,
  get_scene_points) through the port's reader, no pandas; its
  observation table is a {column: numpy array} dict.

The scene is a whole-room scan whose world extent drives
``model.scale = 1.0`` (cascades = 2, exp_step_factor = 1/256 — reference
args/args.py:84).

Usage:
    python -m virus_nerf_tpu_torch.data.rh_fixture --out DIR \
        [--n-times 75] [--img-wh 244 320] [--seed 21] [--no-noise]
    python -m virus_nerf_tpu_torch.run --override dataset.name=RH2 \
        --override rh2.dataset_dir=DIR --override model.scale=1.0 ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from benchmark.reference.png import write_png
from benchmark.reference.rays import get_ray_directions
from benchmark.reference.rh import (
    OBSERVATION_COLUMNS,
    RH_DEPTH_SCALE,
    euler_to_pose,
    rh_intrinsics,
)
from benchmark.rooms.raycast import _raycast, _sample_surfaces

# analytic livingroom (meters; RH2 world frame, z up)
ROOM_MIN = np.array([0.0, 0.0, 0.0])
ROOM_MAX = np.array([7.2, 5.4, 2.6])
_BOXES = np.array(
    [
        [[0.2, 0.2, 0.0], [1.4, 2.4, 0.75]],   # sofa
        [[2.6, 1.9, 0.0], [4.2, 3.1, 0.45]],   # table
        [[6.2, 0.3, 0.0], [7.0, 1.9, 1.9]],    # shelf
        [[0.4, 4.4, 0.0], [2.2, 5.2, 0.9]],    # sideboard
        [[5.4, 4.2, 0.0], [6.8, 5.2, 0.5]],    # bench
    ]
)
_BOX_COLORS = np.array(
    [
        [0.70, 0.30, 0.20],
        [0.55, 0.40, 0.15],
        [0.20, 0.35, 0.60],
        [0.45, 0.45, 0.45],
        [0.25, 0.55, 0.25],
    ]
)

_RGBD_MAX_RANGE_M = 6.0  # typical structured-light limit
_SENSOR_YAWS = np.deg2rad([0.0, 90.0, 180.0, 270.0])  # 4-camera rig
N_SCENE_POINTS = 400_000


def make_fixture(out: str, n_times: int = 75, img_wh=(244, 320),
                 seed: int = 21, noise: bool = True) -> dict:
    """Write the fixture; returns summary info. Total observations =
    4 * n_times (one per rig camera per trajectory point)."""
    rng = np.random.default_rng(seed)
    W, H = img_wh
    K = rh_intrinsics()
    dirs_cam = get_ray_directions(H, W, K)  # (H*W, 3) unit, camera frame
    dz = dirs_cam[:, 2]

    img_dir = os.path.join(out, "imgs")
    os.makedirs(img_dir, exist_ok=True)

    # robot trajectory: ellipse through the room center, z at rig height
    center = (ROOM_MIN + ROOM_MAX) / 2.0
    radii = (ROOM_MAX - ROOM_MIN)[:2] * 0.22
    phases = np.linspace(0, 2 * np.pi, n_times, endpoint=False)

    rows = []
    obs_id = 0
    t0 = 1000.0
    for ti, ph in enumerate(phases):
        pos = np.array(
            [
                center[0] + radii[0] * np.cos(ph),
                center[1] + radii[1] * np.sin(ph),
                0.92,
            ]
        )
        heading = np.arctan2(radii[1] * np.cos(ph), -radii[0] * np.sin(ph))
        for sid in range(4):
            # camera yaw: rig heading + mount offset (+pi/2 so that the
            # loader's -90 deg convention lands the optical axis on the
            # mount direction); roll -pi/2 lays the sideways-mounted
            # camera's z horizontal and its y onto world -z (down)
            jitter = rng.normal(0, 0.01, 3) if noise else np.zeros(3)
            yaw = heading + _SENSOR_YAWS[sid] + np.pi / 2 + jitter[0]
            pitch = jitter[1]
            roll = -np.pi / 2 + jitter[2]
            pose = euler_to_pose(
                pos[None], np.array([yaw]), np.array([pitch]),
                np.array([roll]),
            )[0]
            Rwc, t = pose[:, :3], pose[:, 3]
            d_world = dirs_cam @ Rwc.T
            depth, rgb = _raycast(
                np.broadcast_to(t, d_world.shape), d_world,
                _BOXES, _BOX_COLORS, ROOM_MIN, ROOM_MAX,
            )
            if noise:
                rgb = np.clip(
                    rgb + rng.normal(0, 0.015, rgb.shape), 0, 1
                )
            # depth png stores CAMERA-Z depth at value = z * 128/5
            # (loader: d = png * 5/128 / dz, datasets/dataset_rh.py:417)
            z = depth * dz
            invalid = depth > _RGBD_MAX_RANGE_M
            if noise:
                invalid |= rng.random(z.shape) < 0.01
            dval = np.round(z / RH_DEPTH_SCALE).astype(np.int32)
            dval = np.clip(dval, 1, 255)
            dval[invalid] = 0
            write_png(
                os.path.join(img_dir, f"{obs_id:06d}_rgb.png"),
                (rgb.reshape(H, W, 3) * 255).astype(np.uint8),
            )
            write_png(os.path.join(img_dir, f"{obs_id:06d}_d.png"),
                      dval.reshape(H, W).astype(np.uint8))
            rows.append(
                (obs_id, 1, 7, sid, t0 + 0.35 * ti + 0.01 * sid,
                 pos[0] + (rng.normal(0, 0.01) if noise else 0.0),
                 pos[1] + (rng.normal(0, 0.01) if noise else 0.0),
                 pos[2], yaw, pitch, roll)
            )
            obs_id += 1

    with open(os.path.join(out, "observations.csv"), "w") as f:
        f.write(",".join(OBSERVATION_COLUMNS) + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")

    pts = _sample_surfaces(rng, _BOXES, N_SCENE_POINTS, ROOM_MIN, ROOM_MAX)
    np.save(os.path.join(out, "scene_points.npy"), pts)

    with open(os.path.join(out, "robotathome.py"), "w") as f:
        f.write(_STUB_SRC)

    info = {
        "n_obs": obs_id,
        "img_wh": (W, H),
        "room_extent_m": (ROOM_MAX - ROOM_MIN).tolist(),
    }
    with open(os.path.join(out, "README.txt"), "w") as f:
        f.write(
            "Synthetic Robot@Home2 room fixture (see "
            "virus_nerf_tpu_torch/data/rh_fixture.py).\n"
            f"{obs_id} lblrgbd observations, 4-camera rig, "
            f"{W}x{H} px.\nThe RH2 loaders read observations.csv, imgs/ and "
            "scene_points.npy; robotathome.py is a reader over them for "
            "code that imports 'robotathome'.\n"
        )
    return info


# the reader module written into the fixture dir: the RobotAtHome calls the
# loaders make (reference: datasets/dataset_rh.py:229-267
# get_sensor_observations/name2id/get_RGBD_files, scene_rh.py:42-60
# get_scene_points), through the port's reader of this layout
_STUB_SRC = '''"""Reader over the on-disk RH2 fixture, exposing the
RobotAtHome calls the RH2 loaders make, without pandas: the observation
table is a {column: numpy array} dict.  Generated by
virus_nerf_tpu_torch/data/rh_fixture.py."""

import os

from virus_nerf_tpu_torch.data.rh import RHFixtureReader


class RobotAtHome(RHFixtureReader):
    def __init__(self, rh_path=None, wspc_path=None, db_filename="rh.db"):
        super().__init__(rh_path or os.path.dirname(os.path.abspath(__file__)))
'''


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--n-times", type=int, default=75,
                   help="trajectory points (observations = 4x this)")
    p.add_argument("--img-wh", type=int, nargs=2, default=(244, 320))
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--no-noise", action="store_true")
    args = p.parse_args()
    info = make_fixture(
        args.out, n_times=args.n_times, img_wh=tuple(args.img_wh),
        seed=args.seed, noise=not args.no_noise,
    )
    print(info)


# the name the benchmark finds a room writer by
write_room = make_fixture


if __name__ == "__main__":
    main()
