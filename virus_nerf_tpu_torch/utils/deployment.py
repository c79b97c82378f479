"""Deployment export and density-map inference.

Counterpart of ``virus_nerf_tpu/utils/deployment.py`` (reference:
modules/utils.py:230-253, training/trainer_base.py:92-140).  The density
probes run on the model's device in chunks; on the card the position
encoder's kernels run in them (the widened-slab forward, B5, on the
``slabs`` route).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from virus_nerf_tpu_torch.evaluation.geometry import create_scan_pos
from virus_nerf_tpu_torch.grids.base import bitfield_from_grid
from virus_nerf_tpu_torch.models.ngp import NGPModel


def _np(t) -> np.ndarray:
    """A tensor (on any device, bf16 as float32) or array as numpy."""
    if torch.is_tensor(t):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def save_deployment_model(model: NGPModel, occ_grid_cart, poses, save_dir: str,
                          threshold: float = 0.5) -> str:
    """Poses, the Morton density bitfield and the flattened MLP and hash
    parameters in ``<save_dir>/deployment.npy`` (reference:
    modules/utils.py:230-253), the JAX function's keys and layout: each
    weight flattened in PyTorch's (out, in) order, the rgb output layer
    zero-padded from 3 to 16 rows as the reference does
    (modules/utils.py:231-233).  Where the JAX function takes the
    parameters (``params``), this takes the model that holds them.  A
    bf16 table (the ``bfloat16`` mode) is written in float32, which holds
    each of its values."""
    rgb_ws = [_np(lin.weight) for lin in model.rgb_net]
    rgb_out = rgb_ws[-1]  # (3, width)
    padding = np.zeros((13, rgb_out.shape[1]), rgb_out.dtype)
    rgb_out = np.concatenate([rgb_out, padding], axis=0)
    xyz_flat = np.concatenate([_np(lin.weight).reshape(-1)
                               for lin in model.xyz_net])
    rgb_flat = np.concatenate([w.reshape(-1) for w in rgb_ws[:-1]]
                              + [rgb_out.reshape(-1)])
    grid = torch.from_numpy(np.asarray(_np(occ_grid_cart), np.float32))
    bitfield = bitfield_from_grid(grid, threshold, model.grid_size)
    payload = {
        "poses": _np(poses),
        "model.density_bitfield": bitfield.cpu().numpy(),
        "model.hash_encoder.params": _np(model.pos_table).reshape(-1),
        "model.per_level_scale": model.hash_spec.log_b,
        "model.xyz_encoder.params": xyz_flat,
        "model.rgb_net.params": rgb_flat,
    }
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "deployment.npy")
    np.save(path, payload)  # a dict, loaded with allow_pickle=True
    return path


def infer_density_map(model: NGPModel, res_map: int, height_c: float,
                      num_avg_heights: int = 1, tolerance_c: float = 0.0,
                      height_in_cube: bool = True, batch_size: int = 65536,
                      threshold: Optional[float] = None) -> np.ndarray:
    """Densities on an L x L horizontal probe grid around a slice height,
    averaged over ``num_avg_heights`` sub-slices (reference:
    training/trainer_base.py:92-140, helpers/geometric_fcts.py:119-153;
    the mean, where ``Evaluator.density_slice`` takes the nanmax, as in
    the JAX package).  The probes run on the model's device in chunks of
    ``batch_size``, the last one zero-padded.

    Returns the (res_map, res_map) density map, thresholded to {0, 1}
    when ``threshold`` is given.
    """
    pos = create_scan_pos(res_map, height_c, num_avg_heights, tolerance_c,
                          cube_min=-model.scale, cube_max=model.scale)
    density = density_in_chunks(model, pos, batch_size)
    density = density.reshape(res_map, res_map, num_avg_heights).mean(axis=2)
    if threshold is not None:
        density = (density > threshold).astype(np.float32)
    return density


def density_in_chunks(model: NGPModel, pos: np.ndarray,
                      batch_size: int) -> np.ndarray:
    """``model.density`` at (n, 3) float32 positions, in chunks of
    ``batch_size`` on the model's device (the last chunk zero-padded, as
    the JAX package's fixed-shape probes are), as float32 numpy."""
    dev = next(model.parameters()).device
    out = []
    with torch.no_grad():
        for i in range(0, pos.shape[0], batch_size):
            chunk = pos[i:i + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, 3), np.float32)])
            d = model.density(torch.from_numpy(chunk).to(dev))
            out.append(d[:batch_size - pad].cpu().numpy())
    return np.concatenate(out)
