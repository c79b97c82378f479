"""Convert the JAX package's state into the port's tensors.

The functions take the JAX pytrees with their leaves already as numpy
arrays (``jax.tree.map(np.asarray, tree)``) and read them by field name, so
this module imports no jax.  Tests use them to make both implementations
compute on the same numbers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.data.uss_stats import USSStats
from virus_nerf_tpu_torch.grids.ngp_grid import NGPGridState
from virus_nerf_tpu_torch.grids.occupancy_grid import OccGridState


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _leaf(x, device):
    """A float32 leaf as float32; a bf16 leaf (an ``ml_dtypes.bfloat16``
    array, which torch cannot read) as bf16, through float32, which holds
    every bf16 value exactly."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return _t(x.astype(np.float32), device).to(torch.bfloat16)
    return _t(x, device)


def params_from_jax(params, device="cuda") -> Dict[str, torch.Tensor]:
    """``NGPParams`` -> ``NGPModel`` state dict.  MLP weights go from
    JAX's (in, out) to ``nn.Linear``'s (out, in); the table keeps its dtype
    (bf16 in the ``bfloat16`` compute mode)."""
    out = {"pos_table": _leaf(params.pos_table, device)}
    for net, ws in (("xyz_net", params.xyz_w), ("rgb_net", params.rgb_w)):
        for i, w in enumerate(ws):
            out[f"{net}.{i}.weight"] = _leaf(np.asarray(w).T, device).contiguous()
    return out


def adam_state_from_jax(
    opt_state, device="cuda"
) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``FusedAdamState`` -> (count, mu, nu) keyed like the model's
    parameters (see ``FusedAdam.load_moments``)."""
    return (
        int(np.asarray(opt_state.count)),
        params_from_jax(opt_state.mu, device),
        params_from_jax(opt_state.nu, device),
    )


def grid_from_jax(grid, device="cuda") -> OccGridState:
    """``OccGridState`` -> the port's (occ_3d_grid, occ_bool, update_step);
    the Morton bitfield is dropped."""
    return OccGridState(
        occ_3d_grid=_t(grid.occ_3d_grid, device),
        occ_bool=_t(grid.occ_bool, device, torch.bool),
        update_step=int(np.asarray(grid.update_step)),
    )


def ngp_grid_from_jax(grid, device="cuda") -> NGPGridState:
    """``NGPGridState`` -> the port's."""
    return NGPGridState(
        density_grid=_t(grid.density_grid, device),
        occ_bool=_t(grid.occ_bool, device, torch.bool),
        bitfield=_t(grid.bitfield, device, torch.uint8),
        threshold=_t(grid.threshold, device),
    )


def uss_stats_from_jax(stats, device="cuda") -> USSStats:
    """``USSStats`` -> the port's (int64 pixel indices and counts)."""
    return USSStats(
        min_depth=_t(stats.min_depth, device),
        min_pix=_t(stats.min_pix, device, torch.long),
        counts=_t(stats.counts, device, torch.long),
    )
