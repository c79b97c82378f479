"""Morton (Z-order) codes and occupancy bitfield packing.

Counterpart of ``virus_nerf_tpu/ops/morton.py`` (reference:
modules/utils.py:95-169), plain integer tensor arithmetic.  The bit
interleaving runs in int64: each product is below 2^49 and each mask below
2^32, so ``(v * m) & mask`` equals the JAX package's uint32 arithmetic,
which wraps modulo 2^32 before the same mask.
"""

from __future__ import annotations

import torch


def _expand_bits(v):
    """Spread the low 10 bits of v so they occupy every 3rd bit
    (reference: modules/utils.py:96-101)."""
    v = v.long()
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords):
    """(..., 3) non-negative integer coords (each < 1024) -> (...,) int32
    Morton codes (reference: modules/utils.py:104-107)."""
    e = _expand_bits(coords)
    return (e[..., 0] | (e[..., 1] << 1) | (e[..., 2] << 2)).to(torch.int32)


def _compact_bits(x):
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(codes):
    """Morton codes -> (..., 3) int32 xyz coords
    (reference: modules/utils.py:110-127)."""
    c = codes.long() & 0xFFFFFFFF  # the code's uint32 bits
    return torch.stack(
        [_compact_bits(c), _compact_bits(c >> 1), _compact_bits(c >> 2)], dim=-1
    ).to(torch.int32)


def packbits(grid, threshold):
    """Pack a (N*8,) grid into a (N,) uint8 bitfield: bit i of byte n is set
    iff ``grid[8n+i] > threshold`` (reference: modules/utils.py:157-169)."""
    occ = (grid.reshape(-1, 8) > threshold).long()
    weights = 1 << torch.arange(8, device=grid.device)
    return (occ * weights).sum(dim=1).to(torch.uint8)


def unpackbits(bitfield):
    """Inverse of :func:`packbits`: (N,) uint8 -> (N*8,) bool
    (reference: modules/grid.py:213-233)."""
    shifts = torch.arange(8, device=bitfield.device)
    return ((bitfield.long()[:, None] >> shifts) & 1).reshape(-1).bool()
