"""ETHZ dataset loader: real camera + USS + ToF recordings.

Frozen copy of ``virus_nerf_tpu_torch/data/ethz.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Counterpart of ``virus_nerf_tpu/data/ethz.py`` (reference: DatasetETHZ /
SceneETHZ / SplitterETHZ, datasets/dataset_ethz.py:24-980,
datasets/scene_ethz.py:7-72, datasets/splitter_ethz.py:10-258).  The same
numpy computation, float64 until the last cast, so both loaders give the
same numbers; the ``DeviceDataset`` holds torch tensors on a chosen device
(indices as int64).  Images are read with the port's own PNG reader
(``data/png.py``), which returns RGB.

Directory layout consumed (produced by the reference's ROS pipeline,
README.md:70-84):

    <dataset_dir>/camera_intrinsics.CSV          cam_id,fx,fy,cx,cy
    <dataset_dir>/<room>/
        measurements/CAM<i>_color_image_raw/img<j>.png
        measurements/CAM<i>_aligned_depth_to_color_image_raw/img<j>.npy  (mm)
        measurements/USS<i>.csv                  time,meas        (counts)
        measurements/TOF<i>.csv                  time,meas_0..63,stds_0..63 (mm)
        poses/poses_cam[_balm]_sync<i>.csv       time,x,y,z,qx,qy,qz,qw
        poses/poses_lidar[_balm]_sync<i>.csv
        maps/map_balm.pcd                        GT map
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.config import Config
from benchmark.reference.dataset import DeviceDataset
from benchmark.reference.pcl import (
    SE3,
    PCLLoader,
    load_pcd,
    quat_to_matrix,
    tof_meas2depth,
    uss_meas2depth,
)
from benchmark.reference.png import read_pngs
from benchmark.reference.rays import get_ray_directions
from benchmark.reference.scene import Scene
from benchmark.reference.sensors import RGBDModel, ToFModel, USSModel

# fixed per-room world bounds (reference: datasets/scene_ethz.py:22-32)
ETHZ_ROOM_BOUNDS = {
    "office": ([-2.0, -1.0, -0.4], [6.0, 8.0, 1.2]),
    "commonroom": ([-3.0, -3.0, -0.4], [15.0, 9.0, 1.2]),
    "corridor": ([0.0, -3.0, -0.4], [40.0, 3.0, 1.2]),
}


def cam_stack_id(cam_id: str) -> int:
    """'CAM1' -> 1 (reference: helpers/data_fcts.py:215-265)."""
    return int(cam_id[-1])


def make_ethz_scene(dataset_dir: str, room: str) -> Scene:
    """GT scene: map_balm.pcd cloud + fixed room bounds
    (reference: datasets/scene_ethz.py:39-72)."""
    if room not in ETHZ_ROOM_BOUNDS:
        raise ValueError(f"unknown ETHZ room {room}")
    lo, hi = ETHZ_ROOM_BOUNDS[room]
    cloud = load_pcd(os.path.join(dataset_dir, room, "maps", "map_balm.pcd"))
    return Scene(
        point_cloud=cloud, xyz_min=np.array(lo), xyz_max=np.array(hi)
    )


# ------------------------------------------------------------------ splitter
def load_or_create_split(
    data_dir: str,
    cam_ids: List[str],
    n_per_cam: Dict[str, int],
    split_ratio: Dict[str, float],
    keep_N: "str | int" = "all",
    seed: int = 21,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Persistent randomized train/val/test split
    (reference: datasets/splitter_ethz.py:74-192): the split is stored as
    CSV next to the data and reused iff ratios + keep_N match; otherwise a
    new split is drawn and saved.

    Returns {cam_id: {split: bool mask (n_per_cam,)}}.
    """
    if abs(sum(split_ratio.values()) - 1.0) > 1e-9:
        raise ValueError("split ratios must sum to 1")
    split_dir = os.path.join(data_dir, "split")
    desc_path = os.path.join(split_dir, "split_description.csv")
    os.makedirs(split_dir, exist_ok=True)

    desc_now = (
        f"{split_ratio['train']},{split_ratio['val']},"
        f"{split_ratio['test']},{keep_N}"
    )
    masks: Dict[str, Dict[str, np.ndarray]] = {}
    reuse = False
    if os.path.exists(desc_path):
        with open(desc_path) as f:
            f.readline()
            reuse = f.readline().strip() == desc_now

    rng = np.random.default_rng(seed)
    for cam in cam_ids:
        n = n_per_cam[cam]
        path = os.path.join(split_dir, f"split_{cam}.csv")
        if reuse and os.path.exists(path):
            arr = np.loadtxt(path, dtype=str, delimiter=",", skiprows=1)
            if arr.ndim == 1:
                arr = arr[None]
            if arr.shape[0] == n:
                masks[cam] = {
                    s: arr[:, 1] == s for s in ("train", "val", "test")
                }
                continue
        # draw a fresh split (reference: splitter_base.py:164-192)
        keep = n if keep_N == "all" else min(int(keep_N), n)
        chosen = np.sort(rng.permutation(n)[:keep])
        labels = np.array(["skip"] * n, dtype=object)
        n_train = int(split_ratio["train"] * keep)
        n_val = int(split_ratio["val"] * keep)
        perm = rng.permutation(keep)
        labels[chosen[perm[:n_train]]] = "train"
        labels[chosen[perm[n_train : n_train + n_val]]] = "val"
        labels[chosen[perm[n_train + n_val :]]] = "test"
        with open(path, "w") as f:
            f.write("idx,split\n")
            for i, s in enumerate(labels):
                f.write(f"{i},{s}\n")
        masks[cam] = {s: labels == s for s in ("train", "val", "test")}

    with open(desc_path, "w") as f:
        f.write("train,val,test,keep_N_observations\n")
        f.write(desc_now + "\n")
    return masks


# ------------------------------------------------------------------- loaders
def _read_intrinsics(
    dataset_dir: str, data_dir: str, cam_ids: List[str]
) -> Tuple[Tuple[int, int], Dict[str, np.ndarray], np.ndarray]:
    """Image size + per-camera K + normalized direction tables
    (reference: datasets/dataset_ethz.py:309-360)."""
    probe = os.path.join(
        data_dir, "measurements", f"{cam_ids[0]}_color_image_raw", "img0.png"
    )
    if not os.path.exists(probe):
        raise FileNotFoundError(probe)
    h, w = read_pngs([probe])[0].shape[:2]

    rows = {}
    with open(os.path.join(dataset_dir, "camera_intrinsics.CSV")) as f:
        header = f.readline().strip().split(",")
        for line in f:
            vals = line.strip().split(",")
            if not vals or vals == [""]:
                continue
            d = dict(zip(header, vals))
            rows[d["cam_id"]] = d

    K_dict, dirs = {}, []
    for cam in cam_ids:
        r = rows[cam]
        K = np.array(
            [
                [float(r["fx"]), 0.0, float(r["cx"])],
                [0.0, float(r["fy"]), float(r["cy"])],
                [0.0, 0.0, 1.0],
            ]
        )
        K_dict[cam] = K
        dirs.append(get_ray_directions(h, w, K, normalize=True))
    return (w, h), K_dict, np.stack(dirs)  # (n_cams, H*W, 3)


def _read_csv_columns(path: str) -> Dict[str, np.ndarray]:
    data = np.genfromtxt(path, delimiter=",", names=True)
    return {name: np.atleast_1d(data[name]) for name in data.dtype.names}


def _read_poses(
    data_dir: str,
    cam_ids: List[str],
    masks: Dict[str, np.ndarray],
    use_optimized: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Quaternion pose CSVs -> (N, 3, 4) camera + lidar poses, stack ids,
    times (reference: datasets/dataset_ethz.py:483-571)."""
    poses, poses_lidar, ids, times = [], [], [], []
    suffix = "_balm_sync" if use_optimized else "_sync"
    for cam in cam_ids:
        sid = cam_stack_id(cam)
        cam_csv = _read_csv_columns(
            os.path.join(data_dir, "poses", f"poses_cam{suffix}{sid}.csv")
        )
        lid_csv = _read_csv_columns(
            os.path.join(data_dir, "poses", f"poses_lidar{suffix}{sid}.csv")
        )
        m = masks[cam]
        for src, dst in ((cam_csv, poses), (lid_csv, poses_lidar)):
            P = np.zeros((int(m.sum()), 3, 4))
            sel = np.where(m)[0]
            for k, i in enumerate(sel):
                q = np.array(
                    [src["qx"][i], src["qy"][i], src["qz"][i], src["qw"][i]]
                )
                P[k, :3, :3] = quat_to_matrix(q)
                P[k, :3, 3] = [src["x"][i], src["y"][i], src["z"][i]]
            dst.append(P)
        times.append(cam_csv["time"][m])
        ids.append(np.full(int(m.sum()), sid))
    return (
        np.concatenate(poses),
        np.concatenate(poses_lidar),
        np.concatenate(ids),
        np.concatenate(times),
    )


def _read_imgs(
    data_dir: str, cam_ids: List[str], masks: Dict[str, np.ndarray]
) -> np.ndarray:
    """Color pngs -> (N, H*W, 3) in [0, 1]
    (reference: datasets/dataset_ethz.py:573-614,779-792).  Gray is
    repeated to three channels and alpha dropped, as OpenCV's colour read
    does."""
    paths = []
    for cam in cam_ids:
        d = os.path.join(data_dir, "measurements", f"{cam}_color_image_raw")
        paths += [os.path.join(d, f"img{i}.png") for i in np.where(masks[cam])[0]]
    out = []
    for img in read_pngs(paths):
        img = img.reshape(img.shape[:2] + (-1,))
        img = img[:, :, :3] if img.shape[2] >= 3 else img[:, :, :1]
        img = np.broadcast_to(img, img.shape[:2] + (3,))
        out.append(img.reshape(-1, 3).astype(np.float32) / 255.0)
    return np.stack(out)


def _read_depths(
    data_dir: str, cam_ids: List[str], masks: Dict[str, np.ndarray]
) -> np.ndarray:
    out = []
    for cam in cam_ids:
        d = os.path.join(
            data_dir, "measurements", f"{cam}_aligned_depth_to_color_image_raw"
        )
        for i in np.where(masks[cam])[0]:
            out.append(np.load(os.path.join(d, f"img{i}.npy")).reshape(-1))
    return np.stack(out).astype(np.float64)


def load_ethz_dataset(
    cfg: Config,
    split: str = "train",
    scene: Optional[Scene] = None,
    device="cuda",
) -> Tuple[DeviceDataset, Scene, Dict]:
    """Load one split of an ETHZ room into a DeviceDataset on ``device``
    (reference: datasets/dataset_ethz.py:24-132)."""
    torch.empty(0, device=device)  # no such device: raise before reading
    e = cfg.ethz
    dataset_dir = e.dataset_dir
    data_dir = os.path.join(dataset_dir, e.room)
    cam_ids = list(e.cam_ids)

    if scene is None:
        scene = make_ethz_scene(dataset_dir, e.room)
    w2c_scale = scene.w2c(1.0, only_scale=True)

    img_wh, K_dict, directions = _read_intrinsics(
        dataset_dir, data_dir, cam_ids
    )
    W, H = img_wh

    # per-camera sample counts from the pose files
    suffix = "_balm_sync" if e.use_optimized_poses else "_sync"
    n_per_cam = {
        cam: _read_csv_columns(
            os.path.join(
                data_dir, "poses",
                f"poses_cam{suffix}{cam_stack_id(cam)}.csv",
            )
        )["time"].shape[0]
        for cam in cam_ids
    }
    split_masks = load_or_create_split(
        data_dir, cam_ids, n_per_cam, cfg.dataset.split_ratio,
        keep_N=cfg.dataset.keep_N_observations, seed=cfg.seed,
    )
    masks = {cam: split_masks[cam][split] for cam in cam_ids}

    poses, poses_lidar, sensor_ids, times = _read_poses(
        data_dir, cam_ids, masks, e.use_optimized_poses
    )
    times = times - times.min() if times.size else times
    rgbs = _read_imgs(data_dir, cam_ids, masks)

    # sensor models (camera AoV from intrinsics: 2*atan(W/(2 fx)))
    K0 = K_dict[cam_ids[0]]
    cam_aov = (
        2 * np.rad2deg(np.arctan(W / (2 * K0[0, 0]))),
        2 * np.rad2deg(np.arctan(H / (2 * K0[1, 1]))),
    )
    uss_model = USSModel(img_wh, cam_aov, aov_sensor_deg=tuple(cfg.uss.angle_of_view))
    tof_model = ToFModel(
        img_wh, cam_aov,
        matrix=tuple(cfg.tof.matrix),
        aov_sensor_deg=tuple(cfg.tof.angle_of_view),
        tof_pix_size=cfg.tof.tof_pix_size,
        sensor_calibration_error=cfg.tof.sensor_calibration_error,
        sensor_random_error=cfg.tof.sensor_random_error,
    )
    rgbd_model = RGBDModel(img_wh, cam_aov)

    depths_dict = {}
    sensors = cfg.dataset.sensors
    if "RGBD" in sensors:
        # depth npy (mm) -> m -> scan depth along the ray -> cube units
        # (reference: datasets/dataset_ethz.py:794-845)
        d = 0.001 * _read_depths(data_dir, cam_ids, masks)
        cam_of_img = np.concatenate(
            [
                np.full(int(masks[c].sum()), ci)
                for ci, c in enumerate(cam_ids)
            ]
        )
        dir_z = directions[cam_of_img, :, 2]  # (N, H*W)
        d = d / dir_z
        d[d == 0.0] = np.nan
        depths_dict["RGBD"] = (d * w2c_scale).astype(np.float32)

    if "USS" in sensors:
        # raw counts -> m -> cube -> broadcast over FoV mask
        # (reference: datasets/dataset_ethz.py:847-897)
        meas = []
        for cam in cam_ids:
            cols = _read_csv_columns(
                os.path.join(
                    data_dir, "measurements",
                    f"USS{cam_stack_id(cam)}.csv",
                )
            )
            meas.append(cols["meas"][masks[cam]])
        d = uss_meas2depth(np.concatenate(meas)) * w2c_scale  # (N,)
        d[d == 0.0] = np.nan
        depths_dict["USS"] = uss_model.convert_depth(
            d, format="sensor"
        ).astype(np.float32)

    if "ToF" in sensors:
        # raw 64-zone frames (mm) -> oriented (8,8) m -> cube -> pixel grid
        # (reference: datasets/dataset_ethz.py:899-963)
        meas, stds = [], []
        for cam in cam_ids:
            cols = _read_csv_columns(
                os.path.join(
                    data_dir, "measurements",
                    f"TOF{cam_stack_id(cam)}.csv",
                )
            )
            frame = np.stack(
                [cols[f"meas_{i}"] for i in range(64)], axis=1
            )[masks[cam]]
            std = np.stack(
                [cols[f"stds_{i}"] for i in range(64)], axis=1
            )[masks[cam]]
            meas.append(frame)
            stds.append(std)
        d = tof_meas2depth(np.concatenate(meas))  # (N, 8, 8) meters
        d = d.reshape(d.shape[0], 64) * w2c_scale
        depths_dict["ToF"] = tof_model.convert_depth(
            d, format="sensor"
        ).astype(np.float32)

    poses_c = poses.copy()
    poses_c[:, :, 3] = scene.w2c(poses[:, :, 3])
    poses_lidar_c = poses_lidar.copy()
    poses_lidar_c[:, :, 3] = scene.w2c(poses_lidar[:, :, 3])

    cam_idx = np.concatenate(
        [np.full(int(masks[c].sum()), ci) for ci, c in enumerate(cam_ids)]
    )

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    dataset = DeviceDataset(
        poses=t(poses_c, torch.float32),
        directions=t(directions, torch.float32),
        cam_idx=t(cam_idx, torch.long),
        rgbs=t(rgbs, torch.float32),
        depths={k: t(v, torch.float32) for k, v in depths_dict.items()},
        times=t(times, torch.float32),
        uss_mask_idx=t(np.where(uss_model.mask)[0], torch.long),
        tof_mask_idx=t(np.where(tof_model.mask)[0], torch.long),
        sensor_ids=t(sensor_ids, torch.long),
    )
    info = {
        "img_wh": img_wh,
        "K": K_dict,
        "poses_lidar": poses_lidar_c,
        "sensor_models": {
            "RGBD": rgbd_model, "USS": uss_model, "ToF": tof_model,
        },
        "camera_aov_deg": cam_aov,
    }
    return dataset, scene, info


def load_lidar_maps(
    cfg: Config,
    img_times: np.ndarray,
    poses_lidar_c,
    scene: Scene,
    time_tolerance: float = 0.05,
):
    """Per-image LiDAR point clouds in world coordinates for evaluation
    (reference: datasets/dataset_ethz.py:134-193).

    Matches each image time to the closest 'lidars/filtered/<time>.pcd'
    within ``time_tolerance`` seconds and transforms the cloud with the
    image's (world-coordinate) LiDAR pose.

    Args:
        img_times: (N,) normalized sample times.
        poses_lidar_c: (N, 3, 4) LiDAR poses with cube-coordinate positions
            (the 'poses_lidar' entry of load_ethz_dataset's info dict).
    Returns:
        (xyzs, poses_w): list of (M_i, 3) world clouds and (N, 3, 4) poses.
    """
    poses_w = np.array(poses_lidar_c, np.float64)
    poses_w[:, :, 3] = scene.c2w(poses_w[:, :, 3])

    loader = PCLLoader(os.path.join(cfg.ethz.dataset_dir, cfg.ethz.room))
    lidar_times, lidar_files = loader.get_times("lidars/filtered")
    order = np.argsort(lidar_times)
    lidar_times = lidar_times[order] - lidar_times.min()
    lidar_files = [lidar_files[i] for i in order]

    xyzs = []
    for i, t in enumerate(np.asarray(img_times, float)):
        j = int(np.argmin(np.abs(lidar_times - t)))
        if abs(lidar_times[j] - t) > time_tolerance:
            xyzs.append(np.zeros((0, 3)))
            continue
        xyz = loader.load_pcl(os.path.join("lidars/filtered", lidar_files[j]))
        trans = SE3(t=poses_w[i, :3, 3], R=poses_w[i, :3, :3])
        xyzs.append(trans.apply(xyz))
    return xyzs, poses_w
