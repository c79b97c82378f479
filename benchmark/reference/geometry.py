"""Geometric evaluation helpers: nearest neighbours, scan rays, FoV masks.

Frozen copy of ``virus_nerf_tpu_torch/evaluation/geometry.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Counterparts of the reference's evaluation geometry
(reference: helpers/geometric_fcts.py:8-153, training/trainer.py:815-866).
The per-point Python loops of the reference become batched numpy; the
brute-force NN keeps the reference's exact semantics (NaN rows ignored on
both sides, -1 index / NaN distance for invalid queries).

Copied unchanged from ``virus_nerf_tpu/evaluation/geometry.py``: the module
is numpy only, but importing it from the JAX package runs
``virus_nerf_tpu/__init__.py``, which imports jax.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def find_nearest_neighbour(
    array1: np.ndarray,
    array2: np.ndarray,
    batch_size: Optional[int] = None,
    ignore_nan: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """For each point in array1, index+distance of the closest point in array2.

    Brute-force NN with the reference's contract
    (reference: helpers/geometric_fcts.py:8-80): with ``ignore_nan`` rows of
    either array containing NaN are dropped; queries that were NaN (or when
    array2 is empty) get index -1 and distance NaN.

    Args:
        array1: (N, 2/3) query points.
        array2: (M, 2/3) reference points.
        batch_size: chunk size over array1 to bound the (chunk, M) distance
            matrix; None = one chunk.
    Returns:
        nn_idxs: (N,) int32 indices into the original array2 (-1 invalid).
        nn_dists: (N,) float32 distances (NaN invalid).
    """
    array1 = np.asarray(array1, np.float32)
    array2 = np.asarray(array2, np.float32)
    n = array1.shape[0]

    if ignore_nan:
        mask1 = ~np.isnan(array1).any(axis=1)
        mask2 = ~np.isnan(array2).any(axis=1)
        sub1 = array1[mask1]
        sub2 = array2[mask2]
        idx2 = np.where(mask2)[0]
        if sub1.shape[0] == 0 or sub2.shape[0] == 0:
            return (
                -np.ones(n, dtype=np.int32),
                np.full(n, np.nan, dtype=np.float32),
            )
    else:
        mask1 = np.ones(n, dtype=bool)
        sub1, sub2 = array1, array2
        idx2 = np.arange(array2.shape[0])

    if batch_size is None:
        batch_size = max(sub1.shape[0], 1)
    sub_idxs = np.empty(sub1.shape[0], dtype=np.int64)
    for i in range(0, sub1.shape[0], batch_size):
        chunk = sub1[i : i + batch_size]  # (B, D)
        d2 = ((sub2[None, :, :] - chunk[:, None, :]) ** 2).sum(axis=2)  # (B, M)
        sub_idxs[i : i + batch_size] = np.argmin(d2, axis=1)
    sub_dists = np.linalg.norm(sub2[sub_idxs] - sub1, axis=1)

    nn_idxs = -np.ones(n, dtype=np.int32)
    nn_dists = np.full(n, np.nan, dtype=np.float32)
    nn_idxs[mask1] = idx2[sub_idxs].astype(np.int32)
    nn_dists[mask1] = sub_dists.astype(np.float32)
    return nn_idxs, nn_dists


def create_scan_rays(
    rays_o: np.ndarray,
    angle_res: int,
    angle_min_max: Tuple[float, float] = (-np.pi, np.pi),
) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal 360-degree scan rays from each origin
    (reference: helpers/geometric_fcts.py:82-117).

    Args:
        rays_o: (N, 3) origins.
        angle_res: M angular samples (endpoint excluded).
    Returns:
        rays_o: (N*M, 3) repeated origins, rays_d: (N*M, 3) planar directions.
    """
    rays_o = np.asarray(rays_o, np.float32)
    angles = np.linspace(
        angle_min_max[0], angle_min_max[1], angle_res, endpoint=False
    )
    rays_d = np.zeros((angle_res, 3), dtype=np.float32)
    rays_d[:, 0] = np.cos(angles)
    rays_d[:, 1] = np.sin(angles)
    rays_d = np.tile(rays_d, (rays_o.shape[0], 1))
    rays_o = np.repeat(rays_o, angle_res, axis=0)
    return rays_o, rays_d


def create_scan_pos(
    res_map: int,
    height_c: float,
    num_avg_heights: int,
    tolerance_c: float,
    cube_min: float = -0.5,
    cube_max: float = 0.5,
) -> np.ndarray:
    """L x L x A grid of density-probe positions around a slice height
    (reference: helpers/geometric_fcts.py:119-153).

    Returns (L*L*A, 3) cube-coordinate positions; heights span
    ``height_c +- tolerance_c`` with A = num_avg_heights samples.
    """
    ax = np.linspace(cube_min, cube_max, res_map)
    if num_avg_heights > 1:
        heights = height_c + np.linspace(
            -tolerance_c, tolerance_c, num_avg_heights
        )
    else:
        heights = np.array([height_c])
    X, Y, H = np.meshgrid(ax, ax, heights, indexing="ij")
    return np.stack([X, Y, H], axis=-1).reshape(-1, 3).astype(np.float32)


def limit_fov(
    pos: np.ndarray,
    pos_o: np.ndarray,
    fov_sensor: Dict[str, np.ndarray],
    num_points: int,
    robot_pos: Dict[str, np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Mask scan points outside every camera's sensor field of view
    (reference: training/trainer.py:815-866).

    Args:
        pos: (N*M, 2) scan hit positions (world).
        pos_o: (N*M, 2) scan origins (world).
        fov_sensor: camera name -> (N, 2) [min, max] angular range per image;
            a (-pi, pi) range means 360 degrees (everything kept).
        num_points: N images.
        robot_pos: camera name -> (N, 2) robot position per image.
    Returns:
        (pos, pos_o) with out-of-FoV rows set to NaN.
    """
    pos = pos.copy()
    pos_o = pos_o.copy()
    N = num_points
    M = pos.shape[0] // N

    mask = np.zeros((N, M), dtype=bool)
    for name, fov in fov_sensor.items():
        fov = np.asarray(fov, np.float64)
        if np.allclose(fov[:, 0], -np.pi) and np.allclose(fov[:, 1], np.pi):
            mask = np.ones((N, M), dtype=bool)
            break
        o = np.repeat(np.asarray(robot_pos[name], np.float64), M, axis=0)
        angles = np.arctan2((pos - o)[:, 1], (pos - o)[:, 0]).reshape(N, M)
        rel = angles - fov[:, 0][:, None]
        upper = fov[:, 1] - fov[:, 0]
        rel[rel < 0] += 2 * np.pi
        upper[upper < 0] += 2 * np.pi
        mask |= rel <= upper[:, None]

    flat = mask.reshape(-1)
    pos[~flat] = np.nan
    pos_o[~flat] = np.nan
    return pos, pos_o
