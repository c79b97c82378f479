"""Multiresolution hash-grid encoder on a 2-D table: the additive hash and
the reference's XOR hash.

Counterpart of ``hash_encode`` (virus_nerf_tpu/ops/hash_encoder.py:538).
The table layout (``HashGridSpec``) and the additive hash

    idx = (x + y*P2 + z*P3) mod size

are the JAX package's, so all eight trilinear corners of a sample sit at
fixed per-level row offsets ``corner_offsets`` from its base corner.  Each
direction of the additive encode has two routes, chosen by the arguments
``forward`` and ``backward`` (``NGPModel`` passes them on):

- forward ``"corners"``: base rows (``hash_base_rows``), a plain gather of
  the 8 corner rows ``offset + (base + corner_offsets[l, c]) mod size``,
  the trilinear combine;
- forward ``"slabs"``, the JAX package's own layout (hash_encoder.py
  :518-557): per same-size level group, a widened slab whose row r holds
  the 8 corner rows of base row r (``ops/widen.py``; bf16 groups built by
  the CUDA kernel ``csrc/widen_slabs.cu`` on the card), then one (8, F)
  row gathered per (sample, level) and combined in float32;
- backward ``"product"`` (table gradient only, as hash_encoder.py:683-889):
  one sort of the (L, N) base-row keys, the (N, 8F) corner-weight x
  gradient values permuted into the transposed (G, 8F, K) stream, a
  segment sum (``segment_sum_sorted``, ``csrc/segment_sum.cu``) once over
  the merged run of single-level groups and once per same-size group, then
  the 3-step roll fold of the widened gradient back onto the table;
- backward ``"factors"``, the JAX fused path (hash_encoder.py:703-711,
  762-775): the same sort, but the streams carry the sorted factors
  ``[w (8 rows); g (F rows)]`` in bf16 and the segment sum
  (``group_segment_sum_tsf_sorted``, ``csrc/segment_sum_factors.cu``) forms
  the products itself; its F-major output is folded by
  ``_fold_wide_t_fmajor``.

The two directions are independent: both forwards save (base, weights).
The table may be float32 or bf16 (the ``mixed``/``bfloat16`` compute modes);
the gradient comes back in the table's dtype, as in JAX.  What the TPU
needed beyond that is not ported: the packed-bf16 gather rows, the
band-permuted slab order, the 16-row padding of the factor stream.

Reference behaviour kept on purpose: the JAX forward gathers bf16-rounded
corner features for every level whose size passes ``packable_size``
(>= 2^17 rows; hash_encoder.py:388-394, 482-496, 529-530), on every backend.
Both forwards round at the same point so the numbers match.

The XOR variant (``hash_encode_xor``, hash_encoder.py:895-1014) indexes
each corner as the reference does: ``x + y*res + z*res^2`` on dense levels,
``(x ^ y*P2 ^ z*P3) mod size`` in uint32 on hashed ones.  Its corners have
no fixed offsets, so it has one route: the forward gathers the 8 corner
rows of the table as it is given (float32, or bf16 in the ``mixed`` and
``bfloat16`` modes) and casts them to float32, and the backward
segment-sums the float32 (8N, F) corner stream of each level in row-major
form (``group_segment_sum_t_sorted``, the CUDA kernel
``csrc/segment_sum_rows.cu`` on the card): one call for the merged run of
single-size dense levels, one per group of same-size levels, so two calls
per backward at the reference's 16 x 2 layout, each writing its block of
the table gradient in place, cast to the table's dtype at the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.ops.segment_sum import (
    group_segment_sum_t_sorted,
    group_segment_sum_tsf_sorted,
    segment_sum_sorted,
)

# the reference's hashing primes (modules/hash_encoder.py:43-51)
_PRIME_Y = 2654435761
_PRIME_Z = 805459861
_PACK_MIN_ROWS = 1 << 17  # hash_encoder.py:409
_MASK32 = 0xFFFFFFFF  # uint32 wrap-around of the XOR hash, in int64
FORWARD_ROUTES = ("corners", "slabs")
BACKWARD_ROUTES = ("product", "factors")


def _align_to(x: int, y: int) -> int:
    return int((x + y - 1) // y) * y


@dataclass(frozen=True)
class HashGridSpec:
    """Static layout of the multiresolution hash table.

    Copied from ``virus_nerf_tpu/ops/hash_encoder.py:80-161`` (numpy only;
    importing the JAX module would import jax)."""

    levels: int
    feat_dim: int
    base_res: float
    log_b: float
    offsets: Tuple[int, ...]  # per-level row offset into the table
    sizes: Tuple[int, ...]  # per-level number of rows
    scales: Tuple[float, ...]  # per-level grid scale (res - 1 before ceil)
    resolutions: Tuple[int, ...]
    begin_fast_hash_level: int
    total_rows: int
    stride_y: Tuple[int, ...]  # per-level row stride of a +1 step in y
    stride_z: Tuple[int, ...]  # per-level row stride of a +1 step in z

    @property
    def out_dim(self) -> int:
        return self.levels * self.feat_dim

    @property
    def total_params(self) -> int:
        return self.total_rows * self.feat_dim

    @property
    def corner_offsets(self) -> np.ndarray:
        """(L, 8) row offsets of the 8 trilerp corners from the base corner
        (corner bit d selects the +1 step along dim d)."""
        out = np.zeros((self.levels, 8), np.int64)
        for lvl in range(self.levels):
            s = self.sizes[lvl]
            cy, cz = self.stride_y[lvl], self.stride_z[lvl]
            for c in range(8):
                o = (c & 1) * 1 + ((c >> 1) & 1) * cy + ((c >> 2) & 1) * cz
                out[lvl, c] = o % s
        return out

    @staticmethod
    def create(
        levels: int = 16,
        feat_dim: int = 2,
        base_res: float = 16.0,
        max_res: float = 2048.0,
        max_params: int = 2**19,
    ) -> "HashGridSpec":
        # reference: modules/utils.py:31-39, modules/hash_encoder.py:183-207
        log_b = float(np.log(float(max_res) / float(base_res)) / float(levels - 1))
        offsets, sizes, scales, resolutions = [], [], [], []
        stride_y, stride_z = [], []
        offset = 0
        begin_fast = levels
        for i in range(levels):
            scale = float(base_res) * float(np.exp(i * log_b)) - 1.0
            res = int(np.ceil(scale)) + 1
            full_size = res**3
            full_aligned = _align_to(full_size, 8)
            size_i = min(int(max_params), full_aligned)
            offsets.append(offset)
            sizes.append(size_i)
            scales.append(scale)
            resolutions.append(res)
            if full_size > size_i and begin_fast == levels:
                begin_fast = i
            dense = full_size <= size_i
            stride_y.append(res if dense else _PRIME_Y % size_i)
            stride_z.append(res * res if dense else _PRIME_Z % size_i)
            offset += size_i
        return HashGridSpec(
            levels=levels,
            feat_dim=feat_dim,
            base_res=float(base_res),
            log_b=log_b,
            offsets=tuple(offsets),
            sizes=tuple(sizes),
            scales=tuple(scales),
            resolutions=tuple(resolutions),
            begin_fast_hash_level=begin_fast,
            total_rows=offset,
            stride_y=tuple(stride_y),
            stride_z=tuple(stride_z),
        )

    def init_table(self, generator=None, device=None):
        """Uniform [0, 1) init (reference: modules/hash_encoder.py:220-227),
        shaped (total_rows, feat_dim)."""
        return torch.rand(
            (self.total_rows, self.feat_dim), generator=generator,
            device=device, dtype=torch.float32,
        )


def same_size_level_groups(spec: HashGridSpec):
    """Contiguous runs of levels sharing (size, stride_y, stride_z) — the
    hashed levels all share them (hash_encoder.py:223-235)."""
    groups = []
    for lvl in range(spec.levels):
        key = (spec.sizes[lvl], spec.stride_y[lvl], spec.stride_z[lvl])
        if groups and groups[-1][0] == key:
            groups[-1][1].append(lvl)
        else:
            groups.append((key, [lvl]))
    return [(k[0], k[1], k[2], ls) for k, ls in groups]


def packable_size(size: int, feat_dim: int) -> bool:
    """Whether the JAX forward gathers a level of this size from a bf16
    slab (``_packable_size``, hash_encoder.py:482-489)."""
    wdt = 8 * feat_dim
    return (wdt <= 64 and 128 % wdt == 0 and size % (128 // wdt) == 0
            and size >= _PACK_MIN_ROWS)


def bf16_rounded_levels(spec: HashGridSpec):
    """Levels whose corner features the JAX forward rounds to bf16."""
    return [lvl for lvl, size in enumerate(spec.sizes)
            if packable_size(size, spec.feat_dim)]


class _SpecTensors:
    """Per-level constants of a spec as tensors on one device, made once:
    a step builds no tensor from host values, so a CUDA graph can hold it
    (``Trainer.make_train_chunk``)."""

    def __init__(self, spec: HashGridSpec, device):
        def t(x, dtype):
            return torch.tensor(x, dtype=dtype, device=device)

        self.scales = t(spec.scales, torch.float32)[:, None, None]  # (L,1,1)
        self.half = t(0.5, torch.float32)  # () the lattice's half-cell shift
        self.sizes = t(spec.sizes, torch.long)[:, None]  # (L,1)
        self.offsets = t(spec.offsets, torch.long)[:, None]
        self.stride_y = t(spec.stride_y, torch.long)[:, None]
        self.stride_z = t(spec.stride_z, torch.long)[:, None]
        self.corner_offsets = t(spec.corner_offsets, torch.long)  # (L, 8)
        corner = torch.arange(8, device=device)
        self.corner_bits = torch.stack(
            [(corner >> d) & 1 for d in range(3)], dim=0
        ).bool()  # (3, 8)
        rounded = torch.zeros(spec.levels, dtype=torch.bool, device=device)
        rounded[bf16_rounded_levels(spec)] = True
        self.bf16_levels = rounded
        self.resolutions = t(spec.resolutions, torch.long)[:, None]
        self.dense = t(
            [lvl < spec.begin_fast_hash_level for lvl in range(spec.levels)],
            torch.bool,
        )[:, None]
        # the slabs forward: each same-size group as (levels, first row,
        # size, corner offsets), and (built at first use) one index that
        # gathers the slabs of every group the JAX forward keeps in float32
        co = spec.corner_offsets
        self.slab_groups = [
            (lvls, spec.offsets[lvls[0]], size, tuple(int(o) for o in co[lvls[0]]))
            for size, _, _, lvls in same_size_level_groups(spec)
        ]
        self.feat_dim, self.device = spec.feat_dim, torch.device(device)
        self._f32_slabs = None

    def f32_slabs(self):
        """(levels (Lf,), slab rows (R, 8), each level's first slab row
        (Lf, 1)), all int64, over the groups whose slabs stay float32 for a
        float32 table (``packable_size`` false); None if there are none."""
        if self._f32_slabs is None:
            lvls, rows, first, n = [], [], [], 0
            for lv, row0, size, offs in self.slab_groups:
                if packable_size(size, self.feat_dim):
                    continue
                rows.append(slab_corner_rows(row0, size, len(lv), offs,
                                             self.device).reshape(-1, 8))
                lvls += lv
                first += [n + j * size for j in range(len(lv))]
                n += len(lv) * size
            self._f32_slabs = (
                torch.tensor(lvls, dtype=torch.long, device=self.device),
                torch.cat(rows),
                torch.tensor(first, dtype=torch.long, device=self.device)[:, None],
            ) if lvls else ()
        return self._f32_slabs or None


def slab_corner_rows(row0: int, size: int, G: int, corner_offsets, device):
    """(G, size, 8) int64 table rows of a same-size group's widened slabs,
    ``row0 + g*size + (r + o_c) mod size``."""
    r = torch.arange(size, device=device)[:, None]
    o = torch.tensor([int(x) for x in corner_offsets], device=device)
    g = size * torch.arange(G, device=device)[:, None, None]
    return row0 + g + (r + o) % size


def _grid_positions(c: _SpecTensors, xyz):
    """Per-level lattice cell (L, 3, N) int64 and fraction (L, 3, N)."""
    xyzT = xyz.t().float()  # (3, N)
    # pos = xyz * scale + 0.5 in float32, rounded once as a fused
    # multiply-add: the rounding XLA's CPU compiler gives the JAX function
    # under jit
    pos = torch.addcmul(c.half, xyzT[None], c.scales)  # (L, 3, N)
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    # float -> uint32 saturates at 0 in XLA; a negative position (noisy
    # grid-update samples just outside the cube) floors to corner 0
    return pos_grid.clamp(min=0.0).long(), frac


def hash_base_rows(spec: HashGridSpec, xyz, consts: _SpecTensors = None):
    """Base-corner rows and trilinear weights for every (sample, level)
    (hash_encoder.py:178-220).

    Args:
        xyz: (N, 3) positions normalized to [0, 1].
    Returns:
        base: (L, N) int64 base row WITHIN each level, in [0, size).
        weights: (L, 8, N) float32 (corner bit d = +1 along dim d).
    """
    c = consts if consts is not None else _SpecTensors(spec, xyz.device)
    pg, frac = _grid_positions(c, xyz)
    # additive hash; the strides are reduced mod size and hashed sizes are
    # powers of two, so int64 reproduces the uint32 wrap-around exactly
    base = (pg[:, 0] + pg[:, 1] * c.stride_y + pg[:, 2] * c.stride_z) % c.sizes
    w = torch.where(
        c.corner_bits[None, :, :, None],  # (1, 3, 8, 1)
        frac[:, :, None, :],  # (L, 3, 1, N)
        1.0 - frac[:, :, None, :],
    ).prod(dim=1)  # (L, 8, N)
    return base, w


def _fold_wide_t(dt, sy: int, sz: int, s: int):
    """Fold a transposed widened gradient (..., 8F, s) -> (..., F, s):
    ``dT[r] += dW[(r - o_c) mod s, c]`` by the three halve-by-roll steps
    that invert the corner doubling tree (hash_encoder.py:651-661)."""
    for stride in (sz, sy, 1):
        half = dt.shape[-2] // 2
        dt = dt[..., :half, :] + torch.roll(dt[..., half:, :], stride % s, -1)
    return dt


def _fold_wide_t_fmajor(dt, sy: int, sz: int, s: int, F: int):
    """:func:`_fold_wide_t` for the factor segment sum's F-major rows (row
    f*8 + c): each f-block of 8 rows is folded by the same three steps
    (hash_encoder.py:664-680).  (..., 8F, s) -> (..., F, s)."""
    lead = dt.shape[:-2]
    folded = _fold_wide_t(dt.reshape(*lead, F, 8, s), sy, sz, s)
    return folded.reshape(*lead, F, s)


def _grouped_streams(spec: HashGridSpec, sk_all, level_stream):
    """The segment-sum calls of the additive backward, in table-row order:
    the merged run of consecutive single-level groups, then each group of
    same-size levels (hash_encoder.py:790-884).

    Yields ``(vals, keys, n_rows, parts)``: the (G, C, K) stream of one
    call (``level_stream(lvl)`` gives a level's sorted (C, N) stream), its
    (G, K) sorted int32 keys, and per table block of its output
    ``(row0, size, stride_y, stride_z)`` — ``out[:, :, row0:row0 + size]``
    folds onto that block.
    """
    def merged(buf):
        # consecutive single-level groups: each level's keys are sorted and
        # the per-level bases ascend, so the concatenated stream is sorted
        # over the concatenated output rows — one segment sum for the run
        bases = np.cumsum([0] + [b[0] for b in buf])
        keys = torch.cat(
            [sk_all[lvl] + int(bases[i]) for i, (_, _, _, lvl) in enumerate(buf)]
        )
        vals = torch.cat([level_stream(b[3]) for b in buf], dim=1)
        parts = [(int(bases[i]), size, sy, sz)
                 for i, (size, sy, sz, _) in enumerate(buf)]
        return vals[None].contiguous(), keys[None].contiguous(), int(bases[-1]), parts

    merge_buf = []
    for size, sy, sz, lvls in same_size_level_groups(spec):
        if len(lvls) == 1:
            merge_buf.append((size, sy, sz, lvls[0]))
            continue
        if merge_buf:
            yield merged(merge_buf)
            merge_buf = []
        vals = torch.stack([level_stream(lvl) for lvl in lvls])
        keys = sk_all[lvls[0]:lvls[-1] + 1]
        yield vals.contiguous(), keys.contiguous(), size, [(0, size, sy, sz)]
    if merge_buf:
        yield merged(merge_buf)


def _sorted_keys(base):
    """One sort of all (L, N) keys; a stable sort keeps equal keys in
    sample order, so the segment sums are deterministic."""
    sk_all, sp_all = torch.sort(base, dim=1, stable=True)
    return sk_all.to(torch.int32), sp_all


def table_grad_streams(spec: HashGridSpec, base, w, g):
    """The segment sums of the ``product`` backward (the transposed-stream
    kernel path of hash_encoder.py:683-889).

    Yields ``(vals, keys, n_rows, parts)`` as :func:`_grouped_streams`
    says, with (G, 8F, K) float32 values.
    """
    F = spec.feat_dim
    n = base.shape[-1]
    g = g.reshape(n, spec.levels, F).float()
    sk_all, sp_all = _sorted_keys(base)

    def sorted_stream(lvl):
        # (8F, K) stream: d out / d W[base, c*F + f] = w[c] * g[f], permuted
        # into key order and transposed (samples last)
        gv = (w[lvl].t()[:, :, None] * g[:, lvl, None, :]).reshape(n, 8 * F)
        return gv[sp_all[lvl]].t()

    return _grouped_streams(spec, sk_all, sorted_stream)


def table_grad_factor_streams(spec: HashGridSpec, base, w, g,
                              factor_dtype=torch.bfloat16):
    """The segment sums of the ``factors`` backward (hash_encoder.py
    :762-775): the same calls in the same order as
    :func:`table_grad_streams`, but each stream is the sorted (8 + F, K)
    factor stream ``[w (8 rows); g (F rows)]`` in ``factor_dtype``.

    Yields ``(wgt, keys, n_rows, parts)`` as :func:`_grouped_streams` says.
    """
    F = spec.feat_dim
    n = base.shape[-1]
    sk_all, sp_all = _sorted_keys(base)
    # (L, 8 + F, N): each level's corner weights over its gradient features,
    # cast before the permutation (the JAX fused path casts both factors,
    # hash_encoder.py:729-732), then permuted into key order
    fac = torch.cat(
        [w, g.reshape(n, spec.levels, F).permute(1, 2, 0).float()], dim=1
    ).to(factor_dtype)
    fac = fac.gather(2, sp_all[:, None, :].expand(-1, 8 + F, -1))
    return _grouped_streams(spec, sk_all, lambda lvl: fac[lvl])


def _table_grad(spec: HashGridSpec, base, w, g, backward: str = "product",
                factor_dtype=torch.bfloat16):
    """Table gradient of the encode by the ``backward`` route: each
    stream's segment sum, folded back onto its table blocks."""
    F = spec.feat_dim
    if backward == "factors":
        streams = table_grad_factor_streams(spec, base, w, g, factor_dtype)

        def reduce(vals, keys, n_rows):
            return group_segment_sum_tsf_sorted(vals, keys, n_rows, F)

        def fold(dt, sy, sz, size):
            return _fold_wide_t_fmajor(dt, sy, sz, size, F)
    else:
        streams = table_grad_streams(spec, base, w, g)
        reduce, fold = segment_sum_sorted, _fold_wide_t
    blocks = []
    for vals, keys, n_rows, parts in streams:
        out = reduce(vals, keys, n_rows)
        for row0, size, sy, sz in parts:
            ft = fold(out[:, :, row0:row0 + size], sy, sz, size)
            blocks.append(ft.transpose(1, 2).reshape(-1, F))
    return torch.cat(blocks, dim=0)  # (total_rows, F)


def _corner_gather_combine(table, base, w, spec: HashGridSpec,
                           consts: _SpecTensors):
    """The ``corners`` forward: gather the 8 corner rows of every (sample,
    level) and combine them.  Returns (N, L * F) float32."""
    idx = consts.offsets[:, None, :] + (
        base[:, None, :] + consts.corner_offsets[:, :, None]
    ) % consts.sizes[:, None, :]  # (L, 8, N)
    feats = table[idx].float()  # (L, 8, N, F)
    feats = torch.where(
        consts.bf16_levels[:, None, None, None],
        feats.to(torch.bfloat16).float(), feats,
    )
    out = torch.einsum("lcnf,lcn->nlf", feats, w)
    return out.reshape(base.shape[1], spec.out_dim)


def _slab_gather_combine(table, base, w, spec: HashGridSpec,
                         consts: _SpecTensors):
    """The ``slabs`` forward (hash_encoder.py:518-535): build the widened
    slabs (``ops/widen.py:wide_slabs``: bf16 groups by B5, the small
    float32 levels by one gather), gather one (8, F) row per (sample,
    level) and combine in float32.  Returns (N, L * F) float32."""
    # imported here: ops/widen.py imports this module for the spec helpers
    from virus_nerf_tpu_torch.ops.widen import wide_slabs

    n, F = base.shape[1], spec.feat_dim
    out = w.new_empty((n, spec.levels, F))
    f32_part, groups = wide_slabs(table, consts)
    if f32_part:
        lv, slab, first = f32_part
        feats = slab[base[lv] + first]  # (Lf, N, 8, F)
        out[:, lv] = torch.einsum("lncf,lcn->nlf", feats, w[lv])
    for lvls, slab in groups:
        G, size = slab.shape[:2]
        lv = slice(lvls[0], lvls[-1] + 1)
        rows = base[lv] + size * torch.arange(G, device=base.device)[:, None]
        feats = slab.reshape(G * size, 8, F)[rows].float()  # (G, N, 8, F)
        out[:, lv] = torch.einsum("gncf,gcn->ngf", feats, w[lv])
    return out.reshape(n, spec.out_dim)


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, xyz, spec, consts, forward, backward):
        base, w = hash_base_rows(spec, xyz, consts)
        if forward == "slabs":
            out = _slab_gather_combine(table, base, w, spec, consts)
        else:
            out = _corner_gather_combine(table, base, w, spec, consts)
        ctx.spec, ctx.backward, ctx.table_dtype = spec, backward, table.dtype
        ctx.save_for_backward(base, w)
        return out

    @staticmethod
    def backward(ctx, g):
        base, w = ctx.saved_tensors
        grad = _table_grad(ctx.spec, base, w, g, ctx.backward)
        return grad.to(ctx.table_dtype), None, None, None, None, None


def hash_encode(table, xyz, spec: HashGridSpec, consts: _SpecTensors = None,
                forward: str = "corners", backward: str = "product"):
    """Encode positions through the multiresolution hash grid.

    The gradient flows only into the table (sample positions come from the
    non-differentiable ray march).

    Args:
        table: (total_rows, feat_dim) float32 or bf16 parameter table.
        xyz: (N, 3) positions in [0, 1].
        consts: the spec's per-level tensors on xyz's device (built here if
            not given; ``NGPModel`` caches them).
        forward: ``"corners"`` (8 corner rows per sample and level) or
            ``"slabs"`` (one widened row; see the module doc).
        backward: ``"product"`` (the (8F, K) value stream) or ``"factors"``
            (the bf16 (8 + F, K) factor stream).
    Returns:
        (N, levels * feat_dim) float32 embedding.
    """
    if table.dim() != 2 or tuple(table.shape) != (spec.total_rows, spec.feat_dim):
        raise ValueError(
            f"hash_encode: want a ({spec.total_rows}, {spec.feat_dim}) table, "
            f"got {tuple(table.shape)}"
        )
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hash_encode: want a float32 or bf16 table, got "
                        f"{table.dtype}")
    if forward not in FORWARD_ROUTES or backward not in BACKWARD_ROUTES:
        raise ValueError(
            f"hash_encode: unknown route forward={forward!r} backward="
            f"{backward!r} (have {FORWARD_ROUTES} and {BACKWARD_ROUTES})"
        )
    if consts is None:
        consts = _SpecTensors(spec, xyz.device)
    return _HashEncode.apply(table, xyz, spec, consts, forward, backward)


# --------------------------------------------------------------- XOR hash
def xor_corner_rows(spec: HashGridSpec, xyz, consts: _SpecTensors = None):
    """Per-corner absolute rows and trilinear weights under the reference
    hash (hash_encoder.py:907-951).

    Args:
        xyz: (N, 3) positions normalized to [0, 1].
    Returns:
        rows: (L, 8, N) int32 absolute rows into the table.
        weights: (L, 8, N) float32 (corner bit d selects the +1 step
            along d).
    """
    c = consts if consts is not None else _SpecTensors(spec, xyz.device)
    pg, frac = _grid_positions(c, xyz)
    rows, weights = [], []
    for corner in range(8):
        sel = [(corner >> d) & 1 for d in range(3)]
        cx, cy, cz = (pg[:, d] + sel[d] for d in range(3))  # (L, N)
        # uint32 products and sums of the JAX function, in int64 masked to
        # 32 bits
        under = (cx + cy * c.resolutions
                 + cz * c.resolutions * c.resolutions) & _MASK32
        fast = (cx ^ ((cy * _PRIME_Y) & _MASK32)
                ^ ((cz * _PRIME_Z) & _MASK32))
        idx = torch.where(c.dense, under, fast) % c.sizes
        rows.append((c.offsets + idx).to(torch.int32))
        w = torch.ones_like(frac[:, 0])
        for d in range(3):
            w = w * (frac[:, d] if sel[d] else 1.0 - frac[:, d])
        weights.append(w)
    return torch.stack(rows, dim=1), torch.stack(weights, dim=1)


def _xor_gather_combine(table, rows, w, spec: HashGridSpec):
    """Per level: gather the 8 corner rows, cast them to float32 and
    combine them (hash_encoder.py:962-971).  Returns (N, L * F)."""
    n = rows.shape[-1]
    outs = []
    for lvl in range(spec.levels):
        feats = table[rows[lvl].reshape(-1).long()].reshape(
            8, n, spec.feat_dim).float()
        outs.append(torch.einsum("cnf,cn->nf", feats, w[lvl]))
    return torch.cat(outs, dim=1)


def xor_table_grad_streams(spec: HashGridSpec, rows, w, g,
                           consts: _SpecTensors = None):
    """The segment sums of the XOR table gradient, in table-row order
    (hash_encoder.py:984-1011); ``consts``: the spec's tensors on rows'
    device (built here if None).

    Yields ``(sv, sk, n_rows)``: the (G, K, F) values and (G, K) int32
    sorted keys of one ``group_segment_sum_t_sorted`` call.  Its (G,
    n_rows, F) storage is the gradient of the next G * n_rows table rows.
    """
    F = spec.feat_dim
    L, _, n = rows.shape
    # d out / d T[rows[l, c, n], f] = w[l, c, n] * g[n, l, f], (L, 8N, F)
    gv = (
        w[:, :, :, None] * g.reshape(n, L, F).float().transpose(0, 1)[:, None]
    ).reshape(L, 8 * n, F)
    c = consts if consts is not None else _SpecTensors(spec, rows.device)
    local = (rows.long() - c.offsets[:, :, None]).reshape(L, 8 * n)
    # one sort of every level's keys; a stable sort keeps equal keys in
    # stream order, so the sums are deterministic
    sk_all, perm = torch.sort(local, dim=1, stable=True)
    sv_all = torch.take_along_dim(gv, perm[:, :, None], dim=1)
    sk_all = sk_all.to(torch.int32)

    merge = []  # consecutive single-size levels, summed in one call

    def merged():
        # each level's keys are sorted and its table block follows the
        # previous one's, so keys shifted by the block offsets are sorted
        # over the concatenated blocks
        base = spec.offsets[merge[0]]
        keys = torch.cat([sk_all[lvl] + (spec.offsets[lvl] - base)
                          for lvl in merge])
        vals = torch.cat([sv_all[lvl] for lvl in merge])
        n_rows = sum(spec.sizes[lvl] for lvl in merge)
        return vals[None].contiguous(), keys[None].contiguous(), n_rows

    for size, _, _, lvls in same_size_level_groups(spec):
        if len(lvls) == 1:
            merge.append(lvls[0])
            continue
        if merge:
            yield merged()
            merge = []
        sl = slice(lvls[0], lvls[-1] + 1)
        yield sv_all[sl].contiguous(), sk_all[sl].contiguous(), size
    if merge:
        yield merged()


def _xor_table_grad(spec: HashGridSpec, rows, w, g, consts: _SpecTensors):
    """The (total_rows, F) table gradient: each segment sum writes its
    block of table rows in place (every row of the block)."""
    F = spec.feat_dim
    grad = torch.empty((spec.total_rows, F), dtype=torch.float32,
                       device=rows.device)
    r0 = 0
    for sv, sk, n_rows in xor_table_grad_streams(spec, rows, w, g, consts):
        G = sk.shape[0]
        block = grad[r0:r0 + G * n_rows].view(G, n_rows, F)
        group_segment_sum_t_sorted(sv, sk, n_rows, out=block)
        r0 += G * n_rows
    assert r0 == spec.total_rows, "the streams cover every table row"
    return grad


class _HashEncodeXor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, xyz, spec, consts):
        rows, w = xor_corner_rows(spec, xyz, consts)
        ctx.spec, ctx.consts, ctx.table_dtype = spec, consts, table.dtype
        ctx.save_for_backward(rows, w)
        return _xor_gather_combine(table, rows, w, spec)

    @staticmethod
    def backward(ctx, g):
        # summed in float32, cast to the table's dtype at the end
        # (hash_encoder.py:1011)
        rows, w = ctx.saved_tensors
        grad = _xor_table_grad(ctx.spec, rows, w, g, ctx.consts)
        return grad.to(ctx.table_dtype), None, None, None


def hash_encode_xor(table, xyz, spec: HashGridSpec,
                    consts: _SpecTensors = None):
    """Encode positions through the hash grid under the reference's XOR
    hash (hash_encoder.py:954-959); arguments and result as
    :func:`hash_encode` (a float32 or bf16 table, one route)."""
    if table.dim() != 2 or tuple(table.shape) != (spec.total_rows, spec.feat_dim):
        raise ValueError(
            f"hash_encode_xor: want a ({spec.total_rows}, {spec.feat_dim}) "
            f"table, got {tuple(table.shape)}"
        )
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hash_encode_xor: want a float32 or bf16 table, got "
                        f"{table.dtype}")
    if consts is None:
        consts = _SpecTensors(spec, xyz.device)
    return _HashEncodeXor.apply(table, xyz, spec, consts)
