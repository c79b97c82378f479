"""Camera ray synthesis (reference: datasets/ray_utils.py:8-80).

Frozen copy of ``virus_nerf_tpu_torch/data/rays.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Copied unchanged from ``virus_nerf_tpu/data/rays.py``: the module is
numpy only, but importing it from the JAX package runs
``virus_nerf_tpu/data/__init__.py``, which imports jax.
"""

from __future__ import annotations

import numpy as np


def get_ray_directions(H: int, W: int, K: np.ndarray, normalize: bool = True):
    """Per-pixel ray directions in camera frame [right down front], through
    pixel centers (reference: datasets/ray_utils.py:8-48 + normalization at
    datasets/dataset_ethz.py:344-348).

    Returns (H*W, 3) float32.
    """
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    dirs = np.stack(
        [(u - cx + 0.5) / fx, (v - cy + 0.5) / fy, np.ones_like(u, np.float64)],
        axis=-1,
    ).reshape(-1, 3)
    if normalize:
        dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    return dirs.astype(np.float32)


def get_rays(directions, c2w):
    """Rotate camera-frame directions into world frame and take the camera
    origin (reference: datasets/ray_utils.py:51-80).

    Args:
        directions: (N, 3).
        c2w: (N, 3, 4) per-ray camera-to-world.
    Returns:
        rays_o (N, 3), rays_d (N, 3).
    """
    rays_d = np.einsum("nij,nj->ni", c2w[:, :3, :3], directions)
    rays_o = c2w[:, :3, 3]
    return rays_o, rays_d
