"""Mapping and image-quality metrics.

Counterpart of the reference Metrics/MetricsRH classes
(reference: training/metrics.py:13-484, training/metrics_rh.py:8-68) without
the torchmetrics dependency: PSNR and SSIM are implemented directly (same
definitions and defaults torchmetrics uses — data_range=1, SSIM with an
11x11 Gaussian window, sigma 1.5, k1=0.01, k2=0.03).

All depth metrics are zone-resolved: a zone is a [min, max] ground-truth
depth interval in meters (reference: training/metrics.py:186-213).

The port's copy of ``virus_nerf_tpu/evaluation/metrics.py`` (importing
that module runs ``virus_nerf_tpu/__init__.py``, which imports jax), with
one change: ``nn_metrics`` finds the nearest neighbours of all its images
at once by ``ops/nn_search.py``, on the device it is given (the evaluator's:
the kernel E2 on the card, the JAX package's numpy search on the CPU), with
the same results bit for bit.  The statistics stay in float64 numpy on the
host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.ops.nn_search import nn_search

Zones = Dict[str, Tuple[float, float]]


def nn_metrics(
    pos: np.ndarray,
    pos_ref: np.ndarray,
    depths: np.ndarray,
    depths_gt: np.ndarray,
    num_points: int,
    ref_pos_is_gt: bool,
    zones: Zones,
    inlier_threshold: float,
    device="cpu",
):
    """Per-image nearest-neighbour distances between two 2-D scan point sets,
    with zone-resolved statistics (reference: training/metrics.py:113-213).

    Args:
        pos: (N*K, 2) query positions.
        pos_ref: (N*M, 2) reference positions.
        depths: (N*K,) predicted depths if ``ref_pos_is_gt`` else (N*M,).
        depths_gt: GT depths, complementary shape.
        num_points: N images.
        ref_pos_is_gt: direction of the match — True measures *accuracy*
            (prediction -> GT), False measures *coverage* (GT -> prediction).
        device: where the search runs (``ops/nn_search.py``): a CUDA
            device launches E2, the CPU searches in numpy.
    Returns:
        nn_dists (N*K,), and dicts zone -> mean / median / inlier ratio /
        outlier-too-close ratio.
    """
    N = num_points
    K = pos.shape[0] // N
    if ref_pos_is_gt:
        nn_depths = np.asarray(depths, np.float64).reshape(N, K)
        depths_gt_r = np.asarray(depths_gt, np.float64).reshape(N, -1)
        nn_depths_gt = np.full((N, K), np.nan)
    else:
        depths_r = np.asarray(depths, np.float64).reshape(N, -1)
        nn_depths_gt = np.asarray(depths_gt, np.float64).reshape(N, K)
        nn_depths = np.full((N, K), np.nan)

    # float32 on the host, as find_nearest_neighbour casts
    idxs, dists = nn_search(
        torch.from_numpy(np.array(pos, np.float32).reshape(-1, 2)).to(device),
        torch.from_numpy(np.array(pos_ref, np.float32).reshape(-1, 2)).to(device),
        N,
    )
    idxs = idxs.cpu().numpy()
    nn_dists = dists.cpu().numpy().astype(np.float64)
    valid = idxs >= 0
    rows = np.nonzero(valid)[0]
    if ref_pos_is_gt:
        nn_depths_gt[valid] = depths_gt_r[rows, idxs[valid]]
    else:
        nn_depths[valid] = depths_r[rows, idxs[valid]]

    nn_dists = nn_dists.reshape(-1)
    nn_depths = nn_depths.reshape(-1)
    nn_depths_gt = nn_depths_gt.reshape(-1)

    nn_mean, nn_median, nn_inlier, nn_outlier_too_close = {}, {}, {}, {}
    with np.errstate(invalid="ignore"):
        for zone, (lo, hi) in zones.items():
            valid = (
                ~np.isnan(nn_dists)
                & (nn_depths_gt >= lo)
                & (nn_depths_gt <= hi)
            )
            inlier = nn_dists < inlier_threshold
            too_close = nn_depths < nn_depths_gt
            n_valid = valid.sum()
            nn_mean[zone] = (
                float(np.nanmean(nn_dists[valid])) if n_valid else np.nan
            )
            nn_median[zone] = (
                float(np.nanmedian(nn_dists[valid])) if n_valid else np.nan
            )
            nn_inlier[zone] = (
                float((valid & inlier).sum() / n_valid) if n_valid else np.nan
            )
            nn_outlier_too_close[zone] = (
                float((valid & ~inlier & too_close).sum() / n_valid)
                if n_valid
                else np.nan
            )
    return nn_dists, nn_mean, nn_median, nn_inlier, nn_outlier_too_close


def _zone_reduce(depth, depth_gt, zones: Zones, fn):
    out = {}
    with np.errstate(invalid="ignore"):
        for zone, (lo, hi) in zones.items():
            mask = (depth_gt >= lo) & (depth_gt <= hi)
            out[zone] = float(fn(depth[mask], depth_gt[mask]))
    return out


def rmse(depth, depth_gt, zones: Zones):
    """Zone-resolved mean squared error (reference: training/metrics.py:254-274
    — note the reference's 'rmse' does not take the square root either)."""
    return _zone_reduce(
        depth, depth_gt, zones, lambda d, g: np.nanmean((d - g) ** 2)
    )


def mae(depth, depth_gt, zones: Zones):
    """Zone-resolved mean absolute error (training/metrics.py:276-296)."""
    return _zone_reduce(
        depth, depth_gt, zones, lambda d, g: np.nanmean(np.abs(d - g))
    )


def mare(depth, depth_gt, zones: Zones):
    """Zone-resolved mean absolute relative error
    (training/metrics.py:298-318)."""
    return _zone_reduce(
        depth, depth_gt, zones, lambda d, g: np.nanmean(np.abs((d - g) / g))
    )


# ------------------------------------------------------------------- images
def psnr(rgb: np.ndarray, rgb_gt: np.ndarray, data_range: float = 1.0):
    """Mean per-image PSNR over a stack of images
    (reference: training/metrics.py:358-389).

    Args:
        rgb, rgb_gt: (n_imgs, ...) in [0, data_range].
    """
    rgb = np.asarray(rgb, np.float64)
    rgb_gt = np.asarray(rgb_gt, np.float64)
    vals = []
    for i in range(rgb.shape[0]):
        mse = np.mean((rgb[i] - rgb_gt[i]) ** 2)
        vals.append(
            10.0 * np.log10(data_range**2 / mse) if mse > 0 else np.inf
        )
    return float(np.mean(vals)) if vals else 0.0


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    return g / g.sum()


def _filter2d_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' 2-D convolution of (H, W, C) with 1-D kernel k."""
    size = k.shape[0]
    H, W = img.shape[:2]
    # along H
    out = np.zeros((H - size + 1, W) + img.shape[2:])
    for i in range(size):
        out += k[i] * img[i : i + H - size + 1]
    # along W
    out2 = np.zeros((H - size + 1, W - size + 1) + img.shape[2:])
    for i in range(size):
        out2 += k[i] * out[:, i : i + W - size + 1]
    return out2


def ssim(
    rgb: np.ndarray,
    rgb_gt: np.ndarray,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
):
    """Mean per-image SSIM over (n_imgs, H, W, C) stacks — same formula and
    defaults as torchmetrics' StructuralSimilarityIndexMeasure used by the
    reference (training/metrics.py:30-33,391-421)."""
    rgb = np.asarray(rgb, np.float64)
    rgb_gt = np.asarray(rgb_gt, np.float64)
    if rgb.ndim == 3:
        rgb, rgb_gt = rgb[None], rgb_gt[None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    k = _gaussian_kernel(kernel_size, sigma)
    vals = []
    for i in range(rgb.shape[0]):
        x, y = rgb[i], rgb_gt[i]
        mu_x = _filter2d_sep(x, k)
        mu_y = _filter2d_sep(y, k)
        mu_xx = _filter2d_sep(x * x, k)
        mu_yy = _filter2d_sep(y * y, k)
        mu_xy = _filter2d_sep(x * y, k)
        var_x = mu_xx - mu_x**2
        var_y = mu_yy - mu_y**2
        cov = mu_xy - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2)
        )
        vals.append(float(np.mean(s)))
    return float(np.mean(vals)) if vals else 0.0
