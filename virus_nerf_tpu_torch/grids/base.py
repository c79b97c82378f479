"""Shared occupancy-grid machinery: Morton views and bitfields.

Counterpart of ``virus_nerf_tpu/grids/base.py`` (reference:
modules/grid.py:16-270).  The march reads a ``(cascades, grid_size^3)``
boolean grid in cartesian order ``lin = (x*gs + y)*gs + z``; the
Morton-ordered uint8 bitfield (the reference's layout, for export) comes
from it through a permutation computed once per grid size on the host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from virus_nerf_tpu_torch.ops.morton import packbits, unpackbits


def _expand_bits_np(v: np.ndarray) -> np.ndarray:
    """numpy mirror of ``ops.morton._expand_bits`` in uint32."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


@lru_cache(maxsize=8)
def _morton_of_linear(grid_size: int) -> np.ndarray:
    """morton_code[linear_cell] for all cells, row-major [x, y, z]
    (read-only: the cache hands the same array to every caller)."""
    idx = np.arange(grid_size**3, dtype=np.int64)
    x = idx // (grid_size * grid_size)
    y = (idx // grid_size) % grid_size
    z = idx % grid_size
    code = (
        _expand_bits_np(x)
        | (_expand_bits_np(y) << np.uint32(1))
        | (_expand_bits_np(z) << np.uint32(2))
    ).astype(np.int64)
    code.flags.writeable = False
    return code


@lru_cache(maxsize=8)
def _linear_of_morton(grid_size: int) -> np.ndarray:
    """linear_cell[morton_code] — the inverse permutation (read-only)."""
    m = _morton_of_linear(grid_size)
    inv = np.empty_like(m)
    inv[m] = np.arange(grid_size**3, dtype=m.dtype)
    inv.flags.writeable = False
    return inv


def _perm(table: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(table.copy()).to(device)


def cartesian_to_morton(grid_cart, grid_size: int):
    """Reorder a (..., gs^3) cartesian grid into Morton order
    (reference: modules/grid.py:154-170)."""
    return grid_cart[..., _perm(_linear_of_morton(grid_size), grid_cart.device)]


def morton_to_cartesian(grid_morton, grid_size: int):
    """Inverse of :func:`cartesian_to_morton`
    (reference: modules/grid.py:172-189)."""
    return grid_morton[..., _perm(_morton_of_linear(grid_size), grid_morton.device)]


def bitfield_from_grid(grid_cart, threshold, grid_size: int):
    """Cartesian (C, gs^3) float grid -> Morton uint8 bitfield
    (C * gs^3 / 8,) (reference: modules/grid.py:128-151,192-211)."""
    return packbits(cartesian_to_morton(grid_cart, grid_size).reshape(-1),
                    threshold)


def grid_from_bitfield(bitfield, cascades: int, grid_size: int):
    """Morton bitfield -> cartesian (C, gs^3) bool grid (the round trip,
    reference: modules/grid.py:213-233, training/trainer_plot.py:74-86)."""
    bits = unpackbits(bitfield).reshape(cascades, grid_size**3)
    return morton_to_cartesian(bits, grid_size)


def occ_bool_from_grid(grid_cart, threshold):
    """Threshold a (C, gs^3) cartesian grid into the march's boolean layout."""
    return grid_cart > threshold


def cell_centers(grid_size: int, scale: float, cascade: int, device="cuda"):
    """World positions (gs^3, 3) of all cell centers of one cascade
    (reference: modules/ngp_grid.py:127-131 coordinate convention)."""
    idx = np.arange(grid_size, dtype=np.float32)
    g = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"), axis=-1).reshape(-1, 3)
    s = min(2.0 ** (cascade - 1), scale)
    half = s / grid_size
    return torch.from_numpy((g / (grid_size - 1) * 2 - 1) * (s - half)).to(device)
