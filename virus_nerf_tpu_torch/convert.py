"""Convert the JAX package's state into the port's tensors.

The functions take the JAX pytrees with their leaves already as numpy
arrays (``jax.tree.map(np.asarray, tree)``) and read them by field name, so
this module imports no jax.  Tests use them to make both implementations
compute on the same numbers.  Every tensor is a copy: a numpy view of a
JAX array is JAX's own buffer, which the port's steps would otherwise
write in place (the grid, the moments) while JAX still reads it.
``state_from_jax_checkpoint`` reads the JAX trainer's ``model.npz`` from
disk.
"""

from __future__ import annotations

import re
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.data.uss_stats import USSStats
from virus_nerf_tpu_torch.grids.ngp_grid import NGPGridState
from virus_nerf_tpu_torch.grids.occupancy_grid import OccGridState


def _t(x, device, dtype=torch.float32):
    """A tensor of its own: ``x``'s values copied (``np.array`` copies)."""
    return torch.from_numpy(np.array(x)).to(dtype=dtype, device=device)


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
    JAX's (in, out) to ``nn.Linear``'s (out, in); the position table (the
    hash table, or the tri-plane encoder's flat planes) keeps its shape and
    dtype (bf16 in the ``bfloat16`` compute mode)."""
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


def _jax_fields(leaves: Dict[str, np.ndarray], prefix: str) -> SimpleNamespace:
    """The fields under ``prefix`` of a JAX checkpoint's leaves (keyed by
    tree path: ``.params.pos_table``, ``.params.xyz_w[0]``), tuples of
    arrays as lists."""
    fields: Dict[str, object] = {}
    for key, a in leaves.items():
        if not key.startswith(prefix + "."):
            continue
        m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", key[len(prefix) + 1:])
        if m is None:
            continue
        if m[2] is None:
            fields[m[1]] = a
        else:
            fields.setdefault(m[1], {})[int(m[2])] = a
    return SimpleNamespace(**{
        k: [v[i] for i in sorted(v)] if isinstance(v, dict) else v
        for k, v in fields.items()
    })


def state_from_jax_checkpoint(path: str, trainer):
    """A JAX trainer's checkpoint (``model.npz``: leaves keyed
    ``leaf{i}:{tree path}``, virus_nerf_tpu/training/trainer.py:818-824)
    as a ``TrainState`` of the port's ``trainer``, which must be built from
    the same config: parameters, Adam step and moments, grid, step and USS
    statistics.  The random stream stays the port's, seeded from the
    config (a JAX key has no torch counterpart)."""
    with np.load(path, allow_pickle=False) as f:
        leaves = {k.split(":", 1)[1]: f[k] for k in f.files
                  if k.startswith("leaf")}
    state = trainer.init_state()
    dev = trainer.device
    state.model.load_state_dict(
        params_from_jax(_jax_fields(leaves, ".params"), dev))
    opt = SimpleNamespace(count=leaves[".opt_state.count"],
                          mu=_jax_fields(leaves, ".opt_state.mu"),
                          nu=_jax_fields(leaves, ".opt_state.nu"))
    count, mu, nu = adam_state_from_jax(opt, dev)
    state.optimizer.load_moments(state.model.named_parameters(), count, mu, nu)
    grid = _jax_fields(leaves, ".grid")
    state.grid = (ngp_grid_from_jax(grid, dev) if hasattr(grid, "density_grid")
                  else grid_from_jax(grid, dev))
    if ".uss_stats.min_pix" in leaves:
        state.uss_stats = uss_stats_from_jax(_jax_fields(leaves, ".uss_stats"), dev)
    state.step = int(leaves[".step"])
    return state
