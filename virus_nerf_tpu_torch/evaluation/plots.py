"""Result plots: occupancy-grid slices, scan maps, NND summaries, curves.

Counterpart of ``virus_nerf_tpu/evaluation/plots.py`` (reference:
training/trainer_plot.py:17-473) on matplotlib's Agg backend (files only;
nothing blocks on a GUI).  matplotlib is imported when a plot is drawn,
not with the module, so the module imports where matplotlib is missing;
a plot then raises ImportError naming it (``require_matplotlib``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from virus_nerf_tpu_torch.utils.helpers import (
    combine_imgs,
    require_matplotlib,
)


def check_bitfield_roundtrip(occ_bool, bitfield, grid_size: int) -> bool:
    """debug_mode consistency check of the packed Morton bitfield against
    the cartesian boolean grid: unpack -> morton->cartesian must recover
    occ_bool exactly (reference: training/trainer_plot.py:74-86)."""
    from virus_nerf_tpu_torch.grids.base import grid_from_bitfield

    bits = torch.as_tensor(np.asarray(bitfield, np.uint8).reshape(-1))
    cart = grid_from_bitfield(bits, 1, grid_size).numpy()
    return bool(
        np.array_equal(cart.reshape(-1), np.asarray(occ_bool).reshape(-1))
    )


def plot_occ_grid_slice(
    occ_grid_cart: np.ndarray,
    grid_size: int,
    height_idx: Optional[int] = None,
    gt_slice: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    threshold: float = 0.5,
    extent: Optional[Sequence[float]] = None,
    bitfield: Optional[np.ndarray] = None,
    occ_bool: Optional[np.ndarray] = None,
    logger=None,
):
    """Horizontal slice of the occupancy grid: GT slice map, probability
    slice, binary slice — the reference's per-update occgrid_{step}.png
    (reference: training/trainer_plot.py:44-153), including its debug-mode
    bitfield round-trip check when ``bitfield``/``occ_bool`` are given."""
    plt = require_matplotlib()
    grid = np.asarray(occ_grid_cart).reshape(-1)[: grid_size**3]
    grid = grid.reshape(grid_size, grid_size, grid_size)
    h = grid_size // 2 if height_idx is None else height_idx
    sl = grid[:, :, h]
    occ_bin = sl > threshold

    if bitfield is not None and occ_bool is not None:
        if not check_bitfield_roundtrip(occ_bool, bitfield, grid_size):
            msg = "bitfield/cartesian grid round-trip mismatch"
            if logger is not None:
                logger.error(msg)
            else:
                raise AssertionError(msg)

    ncols = 3 if gt_slice is not None else 2
    fig, axes = plt.subplots(1, ncols, figsize=(3.2 * ncols, 3.2),
                             squeeze=False)
    col = 0
    if gt_slice is not None:
        gt = np.asarray(gt_slice) > 0.5
        axes[0, 0].imshow(
            gt.T, origin="lower", cmap="jet", vmin=0, vmax=1,
            extent=extent, interpolation="none",
        )
        axes[0, 0].set_title("GT")
        axes[0, 0].set_ylabel("y [m]")
        col = 1
    im = axes[0, col].imshow(
        sl.T, origin="lower", cmap="jet", vmin=0, vmax=1, extent=extent,
        interpolation="none",
    )
    axes[0, col].set_title("OccGrid density")
    axes[0, col + 1].imshow(
        occ_bin.T, origin="lower", cmap="jet", extent=extent,
        interpolation="none",
    )
    axes[0, col + 1].set_title("OccGrid binary")
    for ax in axes[0]:
        ax.set_xlabel("x [m]")
    fig.subplots_adjust(right=0.88)
    cax = fig.add_axes([0.90, 0.12, 0.025, 0.76])
    fig.colorbar(im, cax=cax)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=120)
    plt.close(fig)
    return sl


def plot_scan_maps(
    data_dict: Dict[str, dict],
    sensors: Sequence[str],
    path: Optional[str] = None,
    extent: Optional[Sequence[float]] = None,
):
    """Per-sensor 2-D scan point overlays vs the GT scan
    (reference: training/trainer_plot.py:155-298)."""
    plt = require_matplotlib()
    n = len(sensors)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 5), squeeze=False)
    gt_pos = data_dict["GT"]["pos"]
    for i, sensor in enumerate(sensors):
        ax = axes[0, i]
        pos = data_dict[sensor]["pos"]
        ax.scatter(gt_pos[:, 0], gt_pos[:, 1], s=1, c="grey", label="GT")
        ax.scatter(pos[:, 0], pos[:, 1], s=1, c="red", label=sensor)
        ax.set_title(sensor)
        ax.set_aspect("equal")
        ax.legend(markerscale=8)
        if extent is not None:
            ax.set_xlim(extent[0], extent[1])
            ax.set_ylim(extent[2], extent[3])
    fig.tight_layout()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=120)
    plt.close(fig)


def _dilate3x3(img: np.ndarray) -> np.ndarray:
    """3x3 binary dilation (the reference uses cv.dilate,
    trainer_plot.py:232-233) — numpy rolls, no OpenCV dependency."""
    out = img.astype(bool)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx or dy:
                out = out | np.roll(img.astype(bool), (dx, dy), axis=(0, 1))
    return out


def plot_maps_per_image(
    scene,
    data_dict: Dict[str, dict],
    metrics_dict: Dict[str, dict],
    sensors: Sequence[str],
    num_points: int,
    res_map: int,
    height_tolerance: float,
    save_dir: str,
    num_plot_pts: int = 4,
    robot: Optional[dict] = None,
    num_ray_steps: int = 512,
    max_error_m: float = 4.0,
    bin_size: float = 0.2,
):
    """Per-image scan maps + NND histograms — maps/map{i}.png
    (reference: training/trainer_plot.py:156-298).

    For each of ``num_plot_pts`` evaluation images and each sensor: the GT
    slice map with the (dilated) GT scan and sensor scan rasters overlaid
    plus measurement rays and robot poses; histograms of the sensor->GT and
    GT->sensor NND with their means.

    Args:
        data_dict/metrics_dict: outputs of ``Evaluator.evaluate_depth``.
        robot: optional {'pos': {cam: (N,2)}, 'orientation': {cam: (N,)}}.
    """
    plt = require_matplotlib()
    os.makedirs(save_dir, exist_ok=True)
    colors = {"GT": "grey", "NeRF": "tab:red", "USS": "tab:blue",
              "ToF": "tab:green", "RGBD": "tab:orange", "LiDAR": "tab:purple"}
    sensors = [s for s in sensors if s != "GT" and s in data_dict]
    N = num_points
    hist_bins = np.linspace(0, max_error_m, int(max_error_m / bin_size + 1))
    gt_o = data_dict["GT"]["rays_o"].reshape(N, -1, 3)

    for i in np.linspace(0, N - 1, min(num_plot_pts, N), dtype=int):
        fig, axes = plt.subplots(
            ncols=3, nrows=len(sensors), figsize=(9, 3.3 * len(sensors)),
            squeeze=False,
        )
        map_gt = scene.get_slice_map(
            float(gt_o[i, 0, 2]), res_map, height_tolerance,
            height_in_world_coord=True,
        )
        extent = scene.c2w(np.array([[-0.5, -0.5], [0.5, 0.5]]))
        extent = extent.T.flatten()

        for s, sensor in enumerate(sensors):
            pos = data_dict[sensor]["pos"].reshape(N, -1, 2)[i]
            pos_o = data_dict[sensor]["pos_o"].reshape(N, -1, 2)[i]
            pos_gt = data_dict[sensor]["pos_gt"].reshape(N, -1, 2)[i]

            def raster(p):
                p = p[~np.isnan(p).any(axis=1)]
                if p.shape[0] == 0:
                    return np.zeros((res_map, res_map), bool)
                m = scene.pos2map(p, 1, res_map)[0]
                return _dilate3x3(m > 0)

            img = combine_imgs(
                [map_gt > 0, raster(pos_gt), raster(pos)],
                ["grey", "black", colors.get(sensor, "red")],
            )
            ax = axes[s, 0]
            ax.imshow(np.transpose(img, (1, 0, 2)), origin="lower",
                      extent=extent, interpolation="none")
            ok = ~(np.isnan(pos).any(1) | np.isnan(pos_o).any(1))
            okj = np.where(ok)[0]
            for j in okj[:: max(1, okj.size // num_ray_steps)]:
                ax.plot([pos_o[j, 0], pos[j, 0]], [pos_o[j, 1], pos[j, 1]],
                        c=colors.get(sensor, "red"), linewidth=0.1, alpha=0.2)
            if robot is not None:
                for cam, rp in robot["pos"].items():
                    ax.add_patch(plt.Circle(
                        (rp[i, 0], rp[i, 1]), radius=0.06, color="black"))
                    a = robot["orientation"][cam][i]
                    ax.arrow(rp[i, 0], rp[i, 1],
                             0.4 * np.cos(a), 0.4 * np.sin(a),
                             color="black", width=0.001)
            ax.set_xlabel("x [m]")
            ax.set_ylabel(sensor, fontsize=13, weight="bold")

            for col, key in ((1, "nn_dists"), (2, "nn_dists_inv")):
                ax = axes[s, col]
                d = metrics_dict[sensor][key].reshape(N, -1)[i]
                d = d[~np.isnan(d)]
                if d.size:
                    counts, _, _ = ax.hist(
                        d, bins=hist_bins, color=colors.get(sensor, "red"))
                    ax.vlines(d.mean(), 0, counts.max() + 1, colors="r",
                              linestyles="dashed",
                              label=f"Mean: {d.mean():.2f}m")
                    ax.legend()
                    ax.set_xlim([0, 1.2 * max(d.max(), 0.2)])
                ax.set_xlabel("NND [m]")
                ax.set_ylabel("# elements")
                ax.set_box_aspect(1)

        axes[0, 0].set_title("Scan", weight="bold")
        axes[0, 1].set_title("NND Sensor->GT", weight="bold")
        axes[0, 2].set_title("NND GT->Sensor", weight="bold")
        fig.tight_layout()
        fig.savefig(os.path.join(save_dir, f"map{i}.png"), dpi=120)
        plt.close(fig)


def plot_nnd_summary(
    metrics_dict: Dict[str, dict],
    zones: Sequence[str] = ("zone1", "zone2", "zone3"),
    path: Optional[str] = None,
    zone_ranges: Optional[Dict[str, Sequence[float]]] = None,
):
    """9-panel NND summary — rows mean/median/inlier-fraction, columns the
    three comparison directions, grouped bars per sensor over the distance
    zones; the inlier row stacks the too-close / too-far outlier fractions
    (reference: training/trainer_plot.py:300-394 ``metrics.png``)."""
    plt = require_matplotlib()
    colors = {"NeRF": "tab:red", "USS": "tab:blue", "ToF": "tab:green",
              "RGBD": "tab:orange", "LiDAR": "tab:purple"}
    sensors = [s for s in metrics_dict if "nn_mean" in metrics_dict[s]]
    if not sensors:
        return
    rows = [("nn_mean", "Mean [m]"), ("nn_median", "Median [m]"),
            ("nn_inlier", "Inliers [%]")]
    cols = [("", "Accuracy: Sensor->GT(FoV)"),
            ("_inv", "Coverage: GT(FoV)->Sensor"),
            ("_inv_360", "Coverage: GT(360°)->Sensor")]
    x = np.arange(len(zones))
    width = 0.6
    fig, axs = plt.subplots(3, 3, figsize=(13, 8))
    for r, (base, ylabel) in enumerate(rows):
        for c, (suffix, title) in enumerate(cols):
            ax = axs[r, c]
            for j, sensor in enumerate(sensors):
                xj = x - width / 2 + (j + 0.5) * width / len(sensors)
                vals = np.array([
                    metrics_dict[sensor].get(base + suffix, {}).get(z, np.nan)
                    for z in zones
                ])
                color = colors.get(sensor, None)
                ax.bar(xj, vals, width / len(sensors),
                       label=sensor if (r == 0 and c == 0) else None,
                       color=color)
                if base == "nn_inlier":
                    too_close = np.array([
                        metrics_dict[sensor]
                        .get("nn_outlier_too_close" + suffix, {})
                        .get(z, np.nan)
                        for z in zones
                    ])
                    too_far = 1.0 - vals - too_close
                    ax.bar(xj, too_close, width / len(sensors), bottom=vals,
                           color=color, alpha=0.4)
                    ax.bar(xj, too_far, width / len(sensors),
                           bottom=1.0 - too_far, color=color, alpha=0.1)
            if r == 0:
                ax.set_title(title, weight="bold")
            if c == 0:
                ax.set_ylabel(ylabel)
            if base == "nn_inlier":
                ax.set_ylim([0, 1.05])
            if zone_ranges is not None:
                ax.set_xticks(
                    x,
                    [f"{zone_ranges[z][0]}-{zone_ranges[z][1]}m"
                     for z in zones],
                )
            else:
                ax.set_xticks(x, list(zones))
    axs[0, 0].legend()
    fig.suptitle("Nearest Neighbour Distance", fontsize=16, weight="bold")
    fig.tight_layout()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_training_curves(
    logs: Dict[str, list], path: Optional[str] = None
):
    """Loss / PSNR / mnn training curves
    (reference: training/trainer_plot.py:396-472)."""
    plt = require_matplotlib()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    steps = logs.get("step", range(len(logs.get("loss", []))))
    for ax, key, label in zip(
        axes, ("loss", "psnr", "mnn"), ("loss", "PSNR [dB]", "mean NND [m]")
    ):
        vals = np.asarray(logs.get(key, []), float)
        ax.plot(list(steps)[: len(vals)], vals)
        ax.set_xlabel("step")
        ax.set_ylabel(label)
        if key == "loss" and np.all(np.asarray(vals)[np.isfinite(vals)] > 0):
            ax.set_yscale("log")
    fig.tight_layout()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_pointclouds(
    pointcloud_dir: str,
    pcl_dir: str = "nerf_pcl",
    path: Optional[str] = None,
) -> np.ndarray:
    """Top-down scatter of every PCD in ``pointcloud_dir/pcl_dir``,
    colored by acquisition order
    (reference: plotting/training/plot_pointclouds.py:10-34, rebuilt on
    the repo's own PCD loader and Agg file output instead of plt.show).

    Returns the stacked (N, 3) points (also useful headless)."""
    plt = require_matplotlib()
    from virus_nerf_tpu_torch.data.pcl import PCLLoader

    loader = PCLLoader(pointcloud_dir)
    xyzs = [
        loader.load_pcl(os.path.join(pcl_dir, f))
        for f in loader.get_files(pcl_dir)
    ]
    xyz = (
        np.concatenate([x.reshape(-1, 3) for x in xyzs])
        if xyzs else np.zeros((0, 3), np.float32)
    )
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(
        xyz[:, 0], xyz[:, 1], s=0.1, c=np.arange(xyz.shape[0]), cmap="jet"
    )
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.tight_layout()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=120)
    plt.close(fig)
    return xyz


def plot_ablation_bars(
    x_values: Sequence[float],
    mnn: Sequence[float],
    convergence: Dict[str, Sequence[float]],
    x_label: str = "Angular error [degree]",
    path: Optional[str] = None,
):
    """Two-panel ablation summary: mean NND bars per ablated value +
    grouped convergence-time bars (the generic form of the reference's
    ToF-calibration-error figure, plotting/datasets/plot_calibration_error.py:5-31,
    which hard-codes one experiment's numbers).

    Args:
        x_values: ablated parameter values (bar group labels).
        mnn: mean NND per value.
        convergence: {legend_label: times} per convergence threshold.
        path: output png (omit to skip saving; the figure is returned).
    """
    plt = require_matplotlib()
    fig, axes = plt.subplots(ncols=2, nrows=1, figsize=(12, 6))
    x = np.arange(len(x_values))

    ax = axes[0]
    ax.bar(x, mnn, color="tab:blue", width=0.4)
    ax.set_xlabel(x_label)
    ax.set_ylabel("Mean NND [m]")
    ax.set_xticks(x, [str(v) for v in x_values])

    ax = axes[1]
    n = max(len(convergence), 1)
    w = 0.8 / n
    for j, (label, times) in enumerate(convergence.items()):
        ax.bar(x + (j - (n - 1) / 2) * w, times, width=w, label=label)
    ax.set_xlabel(x_label)
    ax.set_ylabel("Convergence time [s]")
    ax.set_xticks(x, [str(v) for v in x_values])
    ax.legend()

    fig.tight_layout()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
