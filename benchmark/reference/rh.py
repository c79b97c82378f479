"""Robot@Home2 (RH2) dataset loader.

Frozen copy of ``virus_nerf_tpu_torch/data/rh.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Counterpart of ``virus_nerf_tpu/data/rh.py`` (reference: DatasetRH /
SceneRH, datasets/dataset_rh.py:21-576, datasets/scene_rh.py:7-60):
labelled RGBD observations of one room, with USS/ToF measurements
*simulated from the dense RGBD depth* through the sensor models
(reference: datasets/dataset_rh.py:450-504).  The same numpy computation,
float64 until the last cast, so both loaders give the same numbers; the
``DeviceDataset`` holds torch tensors on a chosen device (indices as
int64).

The JAX loader reads the observation table through the external
``robotathome`` package (a pandas frame), the RGB through matplotlib and
the depth through OpenCV.  This loader needs none of them for the on-disk
layout that ``data/rh_fixture.py`` (and ``tools/make_rh_fixture.py``)
write:

    <dataset_dir>/observations.csv            id,home_id,room_id,sensor_id,
                                              timestamp,sensor_pose_{x,y,z,
                                              yaw,pitch,roll}
    <dataset_dir>/imgs/{id:06d}_rgb.png       8-bit RGB
    <dataset_dir>/imgs/{id:06d}_d.png         8-bit depth, z * 128/5 m
    <dataset_dir>/scene_points.npy            (M, 3) GT point cloud

What the pandas and OpenCV calls do is copied where it decides a number:
the observations are ordered by numpy's (unstable) quicksort of the
timestamps, as ``DataFrame.sort_values`` orders them; an 8-bit RGB PNG
becomes ``u8 / 255`` in float32, as ``matplotlib.image.imread`` gives it;
and a depth PNG with 3 or 4 channels gives its *blue* channel, which is
channel 0 of OpenCV's BGR(A) array.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.config import Config
from benchmark.reference.dataset import DeviceDataset
from benchmark.reference.png import read_pngs
from benchmark.reference.rays import get_ray_directions
from benchmark.reference.scene import Scene
from benchmark.reference.sensors import RGBDModel, ToFModel, USSModel

# Calibration constants of the RH2 RGBD camera (the dataset ships no
# intrinsics file; these are the values the reference derived for it,
# datasets/dataset_rh.py:107-114).  Note the camera is mounted sideways:
# the intrinsics matrix swaps the fx/fy and cx/cy roles accordingly.
RH_CX = 157.3245865
RH_CY = 120.0802295
RH_FX = 286.441384
RH_FY = 271.36999

# depth png value -> meters (RH2 stores depth as value*5/128 m,
# reference: datasets/dataset_rh.py:417)
RH_DEPTH_SCALE = 5.0 / 128.0

# the columns of the lblrgbd observation table the loader reads
OBSERVATION_COLUMNS = (
    "id", "home_id", "room_id", "sensor_id", "timestamp", "sensor_pose_x",
    "sensor_pose_y", "sensor_pose_z", "sensor_pose_yaw", "sensor_pose_pitch",
    "sensor_pose_roll",
)


def rh_intrinsics() -> np.ndarray:
    """3x3 K of the (sideways-mounted) RH2 RGBD camera."""
    return np.array(
        [
            [RH_FY, 0.0, RH_CY],
            [0.0, RH_FX, RH_CX],
            [0.0, 0.0, 1.0],
        ]
    )


def euler_to_pose(
    xyz: np.ndarray, yaw: np.ndarray, pitch: np.ndarray, roll: np.ndarray
) -> np.ndarray:
    """Assemble (N, 3, 4) camera-to-world poses from RH2 sensor poses.

    RH2 gives the sensor pose as position + yaw/pitch/roll Euler angles;
    the camera convention requires a -90 deg yaw offset
    (reference: datasets/dataset_rh.py:281-305).  R = Rz(yaw) Ry(pitch)
    Rx(roll).
    """
    yaw = np.asarray(yaw, np.float64) - np.pi / 2.0
    pitch = np.asarray(pitch, np.float64)
    roll = np.asarray(roll, np.float64)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    n = yaw.shape[0]
    rz = np.zeros((n, 3, 3))
    rz[:, 0, 0], rz[:, 0, 1] = cy, -sy
    rz[:, 1, 0], rz[:, 1, 1] = sy, cy
    rz[:, 2, 2] = 1.0
    ry = np.zeros((n, 3, 3))
    ry[:, 0, 0], ry[:, 0, 2] = cp, sp
    ry[:, 1, 1] = 1.0
    ry[:, 2, 0], ry[:, 2, 2] = -sp, cp
    rx = np.zeros((n, 3, 3))
    rx[:, 0, 0] = 1.0
    rx[:, 1, 1], rx[:, 1, 2] = cr, -sr
    rx[:, 2, 1], rx[:, 2, 2] = sr, cr
    R = rz @ ry @ rx
    return np.concatenate([R, np.asarray(xyz)[:, :, None]], axis=2)


def rh_depth_to_scan(depths_raw: np.ndarray, directions: np.ndarray) -> np.ndarray:
    """Decode RH2 depth pngs to per-ray scan depths in meters.

    png value -> meters (``* 5/128``), then z-depth -> distance along the
    ray (divide by the ray's z component ``sqrt(1 - dx^2 - dy^2)``); zeros
    mark invalid and become NaN (reference: datasets/dataset_rh.py:398-433).

    Args:
        depths_raw: (N, H*W) raw png values.
        directions: (H*W, 3) unit ray directions in the camera frame.
    Returns:
        (N, H*W) float64 depths in meters, NaN where invalid.
    """
    d = RH_DEPTH_SCALE * np.asarray(depths_raw, np.float64)
    dz = np.sqrt(
        np.clip(1.0 - directions[:, 0] ** 2 - directions[:, 1] ** 2, 1e-12, None)
    )
    d = d / dz[None, :]
    d[d == 0.0] = np.nan
    return d


def interleaved_split(
    sensor_ids: np.ndarray,
    split_ratio: Dict[str, float],
    split_dir: Optional[str] = None,
    split_name: str = "split.csv",
) -> np.ndarray:
    """Deterministic interleaved train/val/test split, persisted as CSV.

    Per sensor id, observation k (in time order) goes to the partition at
    position ``k mod 10`` of the pattern
    ``[train]*10r_t + [val]*10r_v + [test]*10r_s`` — the reference's
    modulo-10 scheme (datasets/dataset_rh.py:546-556).  Ratios must be
    multiples of 0.1 summing to 1.  If ``split_dir`` is given the labels
    are saved to (or reloaded from) ``split_dir/split_name``, reused iff
    the ratios recorded in ``split_description.csv`` match and the row
    count matches (reference: datasets/dataset_rh.py:525-540).  The files
    are the JAX loader's, byte for byte, so the two loaders share one
    dataset directory.

    Returns:
        (N,) array of labels 'train' | 'val' | 'test'.
    """
    r = {k: round(float(split_ratio[k]) * 10) for k in ("train", "val", "test")}
    if sum(r.values()) != 10:
        raise ValueError("split ratios must be multiples of 0.1 summing to 1")
    desc_now = f"{r['train'] / 10},{r['val'] / 10},{r['test'] / 10}"

    if split_dir is not None:
        desc_path = os.path.join(split_dir, "split_description.csv")
        path = os.path.join(split_dir, split_name)
        if os.path.exists(desc_path) and os.path.exists(path):
            with open(desc_path) as f:
                f.readline()
                if f.readline().strip() == desc_now:
                    arr = np.loadtxt(path, dtype=str, delimiter=",", skiprows=1)
                    if arr.ndim == 1:
                        arr = arr[None]
                    if arr.shape[0] == sensor_ids.shape[0]:
                        return arr[:, 1]

    pattern = (
        ["train"] * r["train"] + ["val"] * r["val"] + ["test"] * r["test"]
    )
    labels = np.empty(sensor_ids.shape[0], dtype=object)
    for sid in np.unique(sensor_ids):
        idxs = np.where(sensor_ids == sid)[0]
        for offset, part in enumerate(pattern):
            labels[idxs[offset::10]] = part

    if split_dir is not None:
        os.makedirs(split_dir, exist_ok=True)
        with open(os.path.join(split_dir, split_name), "w") as f:
            f.write("idx,split\n")
            for i, s in enumerate(labels):
                f.write(f"{i},{s}\n")
        with open(os.path.join(split_dir, "split_description.csv"), "w") as f:
            f.write("train,val,test\n")
            f.write(desc_now + "\n")
    return labels.astype(str)


def build_rh_device_dataset(
    cfg: Config,
    scene: Scene,
    poses: np.ndarray,
    rgbs: np.ndarray,
    depths_raw: np.ndarray,
    sensor_ids: np.ndarray,
    times: np.ndarray,
    img_wh: Tuple[int, int],
    device="cuda",
) -> Tuple[DeviceDataset, Dict]:
    """Assemble a DeviceDataset on ``device`` from decoded RH2 arrays.

    Converts depths to cube units and simulates USS/ToF from the dense RGBD
    depth through the sensor models with ``format='img'`` — USS = min over
    its elliptic FoV, ToF = the 8x8 pixel lattice sample (reference:
    datasets/dataset_rh.py:450-504).
    """
    W, H = img_wh
    K = rh_intrinsics()
    directions = get_ray_directions(H, W, K)  # (H*W, 3)

    d_m = rh_depth_to_scan(depths_raw, directions)  # meters, NaN invalid
    w2c_scale = scene.w2c(1.0, only_scale=True)
    d_cube = d_m * w2c_scale

    cam_aov = (
        2 * np.rad2deg(np.arctan(W / (2 * K[0, 0]))),
        2 * np.rad2deg(np.arctan(H / (2 * K[1, 1]))),
    )
    uss_model = USSModel(
        img_wh, cam_aov, aov_sensor_deg=tuple(cfg.uss.angle_of_view)
    )
    tof_model = ToFModel(
        img_wh, cam_aov,
        matrix=tuple(cfg.tof.matrix),
        aov_sensor_deg=tuple(cfg.tof.angle_of_view),
        tof_pix_size=cfg.tof.tof_pix_size,
        sensor_calibration_error=cfg.tof.sensor_calibration_error,
        sensor_random_error=cfg.tof.sensor_random_error,
    )
    rgbd_model = RGBDModel(img_wh, cam_aov)

    models = {"RGBD": rgbd_model, "USS": uss_model, "ToF": tof_model}
    depths_dict = {
        name: models[name].convert_depth(d_cube, format="img").astype(np.float32)
        for name in ("RGBD", "USS", "ToF") if name in cfg.dataset.sensors
    }

    poses_c = np.asarray(poses, np.float64).copy()
    poses_c[:, :, 3] = scene.w2c(poses[:, :, 3])

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    dataset = DeviceDataset(
        poses=t(poses_c, torch.float32),
        directions=t(directions[None], torch.float32),
        cam_idx=t(np.zeros(poses.shape[0]), torch.long),
        rgbs=t(rgbs, torch.float32),
        depths={k: t(v, torch.float32) for k, v in depths_dict.items()},
        times=t(times, torch.float32),
        uss_mask_idx=t(np.where(uss_model.mask)[0], torch.long),
        tof_mask_idx=t(np.where(tof_model.mask)[0], torch.long),
        sensor_ids=t(sensor_ids, torch.long),
    )
    info = {
        "img_wh": img_wh,
        "K": K,
        "sensor_models": models,
        "camera_aov_deg": cam_aov,
    }
    return dataset, info


def make_rh_scene(points: np.ndarray) -> Scene:
    """Scene from the RH2 room's labelled point cloud: cube bounds from the
    cloud min/max (reference: datasets/scene_rh.py:42-60)."""
    pts = np.asarray(points, np.float64)
    return Scene(
        point_cloud=pts, xyz_min=pts.min(axis=0), xyz_max=pts.max(axis=0)
    )


# ------------------------------------------------------------------- readers
def read_columns(path: str) -> Dict[str, np.ndarray]:
    """A CSV file's columns as numpy arrays, typed as pandas' ``read_csv``
    types them: int64 where every value is an integer, else float64.  The
    dtype matters: the timestamps are argsorted by it."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    cols = {}
    for j, name in enumerate(rows[0]):
        vals = [r[j] for r in rows[1:]]
        try:
            cols[name] = np.array([int(v) for v in vals], np.int64)
        except ValueError:
            cols[name] = np.array([float(v) for v in vals], np.float64)
    return cols


class RHFixtureReader:
    """The four RobotAtHome calls the loader makes, over the on-disk layout
    of the module doc (one home, id 1; one room, id 7; sensors ``cam_0`` to
    ``cam_3``, ids 0-3)."""

    def __init__(self, root: str):
        self.root = root

    def get_sensor_observations(self, kind: str) -> Dict[str, np.ndarray]:
        if kind != "lblrgbd":
            raise ValueError(f"RH2 reader: only 'lblrgbd' observations, got {kind}")
        return read_columns(os.path.join(self.root, "observations.csv"))

    def name2id(self, name: str, kind: str) -> int:
        if kind == "h":
            return 1
        if kind == "r":
            return 7
        if kind == "s":
            return {"cam_0": 0, "cam_1": 1, "cam_2": 2, "cam_3": 3}[name]
        raise KeyError((name, kind))

    def get_RGBD_files(self, obs_id) -> Tuple[str, str]:
        i = int(obs_id)
        return (
            os.path.join(self.root, "imgs", f"{i:06d}_rgb.png"),
            os.path.join(self.root, "imgs", f"{i:06d}_d.png"),
        )

    def get_scene_points(self, home_id, room_id) -> np.ndarray:
        return np.load(os.path.join(self.root, "scene_points.npy"))


def depth_channel(img: np.ndarray) -> np.ndarray:
    """The raw depth plane of a decoded depth PNG, as the JAX loader's
    ``cv2.imread(IMREAD_UNCHANGED)[:, :, 0]`` takes it: the plane of a
    grayscale file; the gray of a gray+alpha file (OpenCV expands it to
    BGRA); the blue channel (RGB(A) channel 2) of a colour file."""
    if img.ndim == 2:
        return img
    return img[:, :, 0] if img.shape[2] == 2 else img[:, :, 2]


def load_rh_dataset(
    cfg: Config,
    split: str = "train",
    scene: Optional[Scene] = None,
    device="cuda",
) -> Tuple[DeviceDataset, Scene, Dict]:
    """Load one split of an RH2 room into a DeviceDataset on ``device``
    (reference: datasets/dataset_rh.py:229-267).

    Selects the labelled-RGBD observations of ``cfg.rh2.home/room`` in
    time order, applies the persistent interleaved split, then
    ``dataset.keep_sensor`` and ``dataset.keep_N_observations``, decodes
    images and poses, and hands off to :func:`build_rh_device_dataset`.
    """
    torch.empty(0, device=device)  # no such device: raise before reading
    rh2 = cfg.rh2
    rh = RHFixtureReader(rh2.dataset_dir)
    obs = rh.get_sensor_observations("lblrgbd")
    home_id = rh.name2id(rh2.home, "h")
    room_id = rh.name2id(rh2.home + "_" + rh2.room, "r")
    rows = np.flatnonzero((obs["home_id"] == home_id)
                          & (obs["room_id"] == room_id))
    # DataFrame.sort_values: numpy's quicksort of the column, not stable
    rows = rows[np.argsort(obs["timestamp"][rows], kind="quicksort")]

    labels = interleaved_split(
        obs["sensor_id"][rows],
        cfg.dataset.split_ratio,
        split_dir=os.path.join(
            rh2.dataset_dir, "files", "rgbd", rh2.session, rh2.home, rh2.room
        ),
        split_name=f"split_{rh2.subsession}.csv",
    )
    rows = rows[labels == split]
    if cfg.dataset.keep_sensor != "all":
        # observations of one named sensor only
        # (reference: datasets/dataset_rh.py:207-261 getIdxFromSensorName)
        sid = rh.name2id(cfg.dataset.keep_sensor, "s")
        rows = rows[obs["sensor_id"][rows] == sid]
    if cfg.dataset.keep_N_observations != "all":
        rows = rows[: int(cfg.dataset.keep_N_observations)]

    col = {k: v[rows] for k, v in obs.items()}
    poses = euler_to_pose(
        np.stack([col[f"sensor_pose_{a}"] for a in "xyz"], axis=1),
        col["sensor_pose_yaw"], col["sensor_pose_pitch"],
        col["sensor_pose_roll"],
    )

    files = [rh.get_RGBD_files(i) for i in col["id"]]
    rgbs = np.stack(read_pngs([f[0] for f in files]))
    # matplotlib's imread of an 8-bit PNG: u8 / 255 in float32, so the
    # JAX loader's "max > 1 -> / 255" never applies
    rgbs = np.divide(rgbs, 255, dtype=np.float32)
    depths_raw = [depth_channel(d) for d in read_pngs([f[1] for f in files])]
    n, H, W = rgbs.shape[:3]
    rgbs = rgbs.reshape(n, H * W, 3)
    depths_raw = np.stack(depths_raw).astype(np.float32).reshape(n, H * W)

    if scene is None:
        scene = make_rh_scene(rh.get_scene_points(home_id, room_id))

    times = col["timestamp"].astype(np.float64)
    times = times - times.min()

    dataset, info = build_rh_device_dataset(
        cfg, scene, poses, rgbs, depths_raw,
        col["sensor_id"].astype(np.int64) % 4,
        times, (W, H), device=device,
    )
    return dataset, scene, info
