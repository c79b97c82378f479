"""Widened slabs of the additive hash table.

Counterpart of ``build_wide_slabs`` (virus_nerf_tpu/ops/hash_encoder.py
:330-406): row r of a level's slab holds the features of the 8 trilinear
corners of base row r,

    W[r, c] = T[offset + (r + o_c) mod size],

so the ``slabs`` forward of ``hash_encode`` gathers one (8, F) row per
(sample, level) instead of 8 corner rows.  The slab is bf16 where the JAX
package builds it in bf16: for a level whose size passes ``packable_size``
(>= 2^17 rows) and for every level of a bf16 table (the ``mixed`` and
``bfloat16`` compute modes); else float32.

A group of same-size levels shares its corner offsets, so a group's slabs
are built in one call: ``widen_slabs_group``, whose CUDA kernel
``csrc/widen_slabs.cu`` replaces the TPU kernel ``_wp_kernel``
(virus_nerf_tpu/ops/widen_pack_pallas.py:90), builds every bf16 group on
the card; ``widen_slabs_group_plain`` is its plain version, the 3-step roll
doubling tree of the JAX function.  The few small float32 levels are
gathered together through one cached index (``_SpecTensors.f32_slabs``).  The slabs are in natural row order,
(G, s, 8, F): the TPU kernel's int32 bit-pair, band-permuted layout
(``packed_ci_rows``) exists only for the TPU's tiles and is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from virus_nerf_tpu_torch.ops import _build
from virus_nerf_tpu_torch.ops.launch_counts import register
from virus_nerf_tpu_torch.ops.hash_encoder import (
    HashGridSpec,
    _SpecTensors,
    packable_size,
)

# F values the kernel is instantiated for (csrc/widen_slabs.cu)
WIDEN_KERNEL_FEATS = (1, 2, 4, 8)
# constants of csrc/widen_slabs.cu (a card test compares them with the
# library's): bytes of a CTA's (TR, 8, F) bf16 output tile, and bf16 of one
# corner plane of its shared-memory tile (TR * F plus the phases of the
# window's two runs)
WIDEN_TILE_BYTES = 32768
WIDEN_PLANE = WIDEN_TILE_BYTES // 16 + 24


def widen_tile_rows(F: int) -> int:
    """Base rows of one CTA's tile at F features (TR)."""
    return WIDEN_TILE_BYTES // (16 * F)


def widen_slabs_group_plain(table, row0: int, size: int, G: int,
                            corner_offsets):
    """Plain PyTorch version: the group's rows cast to bf16, then three
    widen-by-roll steps along the corner bits, x fastest (the doubling tree
    of hash_encoder.py:395-405: corner c's offset is the sum of
    ``corner_offsets[1]``, ``[2]``, ``[4]`` over its set bits).

    Args:
        table: (total_rows, F) float32 or bf16 table.
        row0: the group's first row; its G levels of ``size`` rows follow.
        corner_offsets: the levels' 8 corner row offsets, in [0, size).
    Returns:
        (G, size, 8, F) bf16 slabs.
    """
    rows = table[row0:row0 + G * size].reshape(G, size, 1, table.shape[1])
    wide = rows.to(torch.bfloat16)
    for bit in (1, 2, 4):
        wide = torch.cat(
            [wide, torch.roll(wide, -int(corner_offsets[bit]), dims=1)], dim=2
        )
    return wide


def _check_args(table, row0: int, size: int, G: int, corner_offsets):
    name = "widen_slabs_group"
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: want a float32 or bf16 table, got {table.dtype}")
    if (table.dim() != 2 or not 0 <= row0 <= row0 + G * size <= table.shape[0]
            or 8 * size >= 2**31):
        raise ValueError(
            f"{name}: rows [{row0}, {row0 + G * size}) are not in a 2-D "
            f"table of shape {tuple(table.shape)}"
        )
    offs = [int(o) for o in corner_offsets]
    # corner c steps by offs[1], offs[2], offs[4] along its set bits (the
    # plain version's roll tree reads only those three)
    ok = (len(offs) == 8 and size > 0 and all(0 <= o < size for o in offs)
          and all(offs[c] == (offs[1] * (c & 1) + offs[2] * (c >> 1 & 1)
                              + offs[4] * (c >> 2 & 1)) % size
                  for c in range(8)))
    if not ok:
        raise ValueError(
            f"{name}: want the 8 corner offsets of a level of {size} rows "
            f"(in [0, size), corner c the sum of offsets 1, 2, 4 over its "
            f"bits), got {offs}"
        )


def _widen_slabs_group_cuda(table, row0: int, size: int, G: int,
                            corner_offsets):
    F = table.shape[1]
    if F not in WIDEN_KERNEL_FEATS:
        raise ValueError(
            f"widen_slabs_group: F={F} has no kernel (have {WIDEN_KERNEL_FEATS})"
        )
    if not table.is_contiguous():
        raise ValueError("widen_slabs_group: the table must be contiguous")
    if table.data_ptr() % (F * table.element_size()):
        # the kernel keeps a row's F values together in its tile, which
        # needs a table pointer at a multiple of F elements
        table, row0 = table[row0:row0 + G * size].clone(), 0
    out = torch.empty((G, size, 8, F), dtype=torch.bfloat16,
                      device=table.device)
    offs = (ctypes.c_int * 8)(*(int(o) for o in corner_offsets))
    err = _build.library().vn_widen_slabs(
        table.data_ptr(), int(table.dtype == torch.bfloat16), out.data_ptr(),
        row0, size, G, F, ctypes.addressof(offs),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check(err, "vn_widen_slabs")
    widen_slabs_group.launches += 1
    return out


def widen_slabs_group(table, row0: int, size: int, G: int, corner_offsets):
    """The bf16 widened slabs of G same-size levels,
    ``W[g, r, c] = bf16(T[row0 + g*size + (r + o_c) mod size])``.

    A CUDA tensor launches ``csrc/widen_slabs.cu`` (or raises); a CPU
    tensor takes :func:`widen_slabs_group_plain`.  ``.launches`` counts
    kernel launches.  Arguments and result as the plain version.
    """
    _check_args(table, row0, size, G, corner_offsets)
    if table.is_cuda:
        return _widen_slabs_group_cuda(table, row0, size, G, corner_offsets)
    if table.device.type == "cpu":
        return widen_slabs_group_plain(table, row0, size, G, corner_offsets)
    raise ValueError(f"widen_slabs_group: unsupported device {table.device}")


widen_slabs_group.launches = 0
register(widen_slabs_group)


def wide_slabs(table, consts: _SpecTensors):
    """The slabs the ``slabs`` forward gathers from, as
    ``(float32 part, bf16 groups)``:

    - float32 part: None, or ``(levels (Lf,), slabs (R, 8, F), first
      (Lf, 1))``: the slabs of every group the JAX forward keeps in float32
      (a float32 table, ``packable_size`` false), one level after another,
      built by one gather through the cached index ``consts.f32_slabs()``,
      and each level's first row in them;
    - bf16 groups: ``[(levels, (G, s, 8, F) slabs)]``, each built by
      :func:`widen_slabs_group`.
    """
    f32 = consts.f32_slabs() if table.dtype == torch.float32 else None
    part = None
    if f32:
        lv, rows, first = f32
        part = (lv, table[rows], first)
    groups = [
        (lvls, widen_slabs_group(table, row0, size, len(lvls), offs))
        for lvls, row0, size, offs in consts.slab_groups
        if not (f32 and not packable_size(size, consts.feat_dim))
    ]
    return part, groups


def build_wide_slabs(table, spec: HashGridSpec, consts: _SpecTensors = None):
    """One (size_l, 8, F) slab per level (hash_encoder.py:330-406, with the
    JAX (size_l, 8F) row split into its 8 corners), as :func:`wide_slabs`
    builds them."""
    consts = consts if consts is not None else _SpecTensors(spec, table.device)
    part, groups = wide_slabs(table, consts)
    slabs = [None] * spec.levels
    if part:
        lv, wide, first = part
        for lvl, f0 in zip(lv.tolist(), first[:, 0].tolist()):
            slabs[lvl] = wide[f0:f0 + spec.sizes[lvl]]
    for lvls, group in groups:
        for j, lvl in enumerate(lvls):
            slabs[lvl] = group[j]
    return slabs
