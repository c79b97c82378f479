"""Instant-NGP density grid.

Counterpart of ``virus_nerf_tpu/grids/ngp_grid.py`` (reference:
modules/ngp_grid.py:15-152): an exponential moving maximum of the NeRF's
density per cell, kept in cartesian order, thresholded adaptively into the
march's boolean grid; the Morton bitfield is for export.

The random draws of an update are an argument of :func:`ngp_grid_update_on`
(one ``(cells, jitter)`` pair per cascade), so tests can hand both
implementations the JAX key's draws; :func:`ngp_cell_draws` makes them
from a ``torch.Generator``.  Deliberate differences in how the draws are
made, not in what they are:

- "gs^3/4 cells drawn over the occupied mask" is ``ops.common.draw_masked``:
  an inverse-CDF draw with no host sync, uniform over all cells while none
  is occupied, as ``jax.random.categorical`` is over logits that are all
  -1e9 (``torch.multinomial`` would raise).
- Duplicate cells in one update take the maximum of their densities:
  ``scatter_reduce_(..., "amax", include_self=True)`` is JAX's
  ``.at[c, idx].max``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import torch

from virus_nerf_tpu_torch.grids.base import bitfield_from_grid, occ_bool_from_grid
from virus_nerf_tpu_torch.ops.common import NEAR_DISTANCE, draw_masked

# cells of one density call: the warm-up evaluates every cell, 2,097,152 a
# cascade at 128^3, in chunks of this many so that the hash forward's
# intermediates stay a few GiB (the density is pointwise)
DENSITY_CHUNK = 1 << 19

DECAY = 0.95  # the density EMA's decay per update (ngp_grid.py:68)


class NGPGridState(NamedTuple):
    density_grid: torch.Tensor  # (cascades, gs^3) float32; -1: invisible
    occ_bool: torch.Tensor  # (cascades, gs^3) bool for the ray march
    bitfield: torch.Tensor  # (cascades * gs^3 / 8,) uint8, Morton order
    threshold: torch.Tensor  # () float32 binarization threshold


def ngp_grid_init(cascades: int, grid_size: int, device="cuda") -> NGPGridState:
    n = grid_size**3
    return NGPGridState(
        density_grid=torch.zeros((cascades, n), device=device),
        occ_bool=torch.zeros((cascades, n), dtype=torch.bool, device=device),
        bitfield=torch.zeros((cascades * n // 8,), dtype=torch.uint8,
                             device=device),
        threshold=torch.tensor(0.5, device=device),
    )


def _cell_coords(idx, grid_size: int):
    """Linear cartesian index -> integer (x, y, z)."""
    x = torch.div(idx, grid_size * grid_size, rounding_mode="floor")
    y = torch.div(idx, grid_size, rounding_mode="floor") % grid_size
    return torch.stack([x, y, idx % grid_size], dim=-1)


def _cells_to_world(coords, cascade: int, grid_size: int, scale: float):
    """Cell coords -> world positions at a cascade, and the half cell
    (reference: modules/ngp_grid.py:127-131)."""
    s = min(2.0 ** (cascade - 1), scale)
    half = s / grid_size
    unit = coords.float() / (grid_size - 1) * 2.0 - 1.0
    return unit * (s - half), half


def ngp_cell_draws(state: NGPGridState, generator, *, warmup: bool,
                   density_threshold: float, grid_size: int
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The draws of one update, per cascade: (cells (P,) int64, jitter
    (P, 3) in [-1, 1)).  Warm-up: every cell; else gs^3/4 uniform cells and
    gs^3/4 cells drawn over the cells whose density exceeds
    ``density_threshold`` (ngp_grid.py:86-104)."""
    n = grid_size**3
    dev = state.density_grid.device
    draws = []
    for c in range(state.density_grid.shape[0]):
        if warmup:
            idx = torch.arange(n, device=dev)
        else:
            m = n // 4
            idx_uni = torch.randint(0, n, (m,), generator=generator, device=dev)
            idx_occ = draw_masked(state.density_grid[c] > density_threshold,
                                  m, generator)
            idx = torch.cat([idx_uni, idx_occ])
        jitter = torch.rand((idx.shape[0], 3), generator=generator,
                            device=dev) * 2.0 - 1.0
        draws.append((idx, jitter))
    return draws


def _density(density_fn: Callable, xyz):
    if xyz.shape[0] <= DENSITY_CHUNK:
        return density_fn(xyz)
    return torch.cat([density_fn(x) for x in xyz.split(DENSITY_CHUNK)])


def ngp_grid_update_on(state: NGPGridState, density_fn: Callable, draws, *,
                       density_threshold: float, grid_size: int,
                       scale: float) -> NGPGridState:
    """One grid update (reference: modules/ngp_grid.py:110-152) at the
    given draws (see :func:`ngp_cell_draws`).  The Morton bitfield is left
    stale, as the JAX trainer runs the update (trainer.py:419); call
    :func:`ngp_grid_refresh_bitfield` before reading it."""
    grid = state.density_grid
    new_grid = grid * DECAY
    for c, (idx, jitter) in enumerate(draws):
        xyz, half = _cells_to_world(_cell_coords(idx, grid_size), c, grid_size,
                                    scale)
        # xyz + jitter * half rounded once, as XLA fuses it under jit
        sigma = _density(density_fn,
                         torch.addcmul(xyz, jitter, xyz.new_full((), half)))
        old = grid[c, idx]
        # EMA floor at the fresh density; invisible (-1) cells stay pinned
        # (reference: modules/ngp_grid.py:138-141)
        new_grid[c].scatter_reduce_(0, idx, torch.where(old < 0.0, old, sigma),
                                    "amax", include_self=True)
    new_grid = torch.where(grid < 0.0, grid, new_grid)
    pos = new_grid > 0.0
    mean_density = torch.where(pos, new_grid, 0.0).sum() / torch.clamp(
        pos.sum(), min=1)
    threshold = torch.clamp(mean_density, max=density_threshold)
    return state._replace(
        density_grid=new_grid,
        occ_bool=occ_bool_from_grid(new_grid, threshold),
        threshold=threshold,
    )


def ngp_grid_refresh_bitfield(state: NGPGridState,
                              grid_size: int) -> NGPGridState:
    """The Morton bitfield rebuilt from the density grid at the current
    threshold."""
    return state._replace(bitfield=bitfield_from_grid(
        state.density_grid, state.threshold, grid_size))


def mark_invisible_cells(state: NGPGridState, K, poses, img_wh, *,
                         cascades: int, grid_size: int,
                         scale: float) -> NGPGridState:
    """Pin cells no camera sees at density -1, the others at 0
    (reference: modules/ngp_grid.py:66-108; a utility the reference
    trainer never calls either).

    Args:
        K: (3, 3) intrinsics; poses: (N_cams, 3, 4) camera-to-world;
        img_wh: (W, H).
    """
    n = grid_size**3
    dev = state.density_grid.device
    coords = _cell_coords(torch.arange(n, device=dev), grid_size)
    w2c_R = poses[:, :3, :3].transpose(1, 2)  # (N_cams, 3, 3)
    w2c_T = -w2c_R @ poses[:, :3, 3:]  # (N_cams, 3, 1)
    grid = state.density_grid.clone()
    for c in range(cascades):
        xyz, _ = _cells_to_world(coords, c, grid_size, scale)
        uvd = K @ (w2c_R @ xyz.T[None] + w2c_T)  # (N_cams, 3, n)
        uv = uvd[:, :2] / uvd[:, 2:]
        in_image = ((uvd[:, 2] >= 0) & (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
                    & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1]))
        covered = (uvd[:, 2] >= NEAR_DISTANCE) & in_image
        too_near = ((uvd[:, 2] < NEAR_DISTANCE) & in_image).any(dim=0)
        visible = (covered.sum(dim=0) > 0) & ~too_near
        grid[c] = torch.where(visible, 0.0, -1.0)
    return state._replace(density_grid=grid)
