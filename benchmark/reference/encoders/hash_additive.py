"""The additive hash encoder: ``encoder_type "hash"`` with ``hash_variant
"additive"``, the JAX package's hash, in plain PyTorch.

It follows the port's ``ops/hash_encoder.py`` with its ``corners`` forward,
written again without kernels or custom autograd functions:

- the additive hash ``idx = (x + y*P2 + z*P3) mod size`` with each level's
  strides reduced mod its size (``HashGridSpec``, copied from the port);
- trilinear weights from ``pos = xyz * scale + 0.5`` rounded once;
- the corner features of every level of at least 2^17 rows rounded to
  bfloat16 in the forward pass, as the model definition of the JAX package
  and the port has it; the gradient passes that rounding straight through
  (``f + (round(f) - f).detach()``, exact in float32);
- the table gradient from autograd (the gather's backward), where the port
  sorts the keys and runs its segment-sum kernel.

Its one leaf, the program's ``pos_table``, is drawn uniform in [0, 1) from
the generator before the MLPs' layers, as the port draws it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

_PRIME_Y = 2654435761
_PRIME_Z = 805459861
_PACK_MIN_ROWS = 1 << 17


def _align_to(x: int, y: int) -> int:
    return int((x + y - 1) // y) * y


@dataclass(frozen=True)
class HashGridSpec:
    """Static layout of the multiresolution hash table (frozen copy of
    the port's ``HashGridSpec``)."""

    levels: int
    feat_dim: int
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    scales: Tuple[float, ...]
    resolutions: Tuple[int, ...]
    total_rows: int
    stride_y: Tuple[int, ...]
    stride_z: Tuple[int, ...]

    @property
    def out_dim(self) -> int:
        return self.levels * self.feat_dim

    @staticmethod
    def create(levels: int, feat_dim: int, base_res: float, max_res: float,
               max_params: int) -> "HashGridSpec":
        log_b = float(np.log(float(max_res) / float(base_res)) / float(levels - 1))
        offsets, sizes, scales, resolutions, sy, sz = [], [], [], [], [], []
        offset = 0
        for i in range(levels):
            scale = float(base_res) * float(np.exp(i * log_b)) - 1.0
            res = int(np.ceil(scale)) + 1
            full = res**3
            size = min(int(max_params), _align_to(full, 8))
            offsets.append(offset)
            sizes.append(size)
            scales.append(scale)
            resolutions.append(res)
            dense = full <= size
            sy.append(res if dense else _PRIME_Y % size)
            sz.append(res * res if dense else _PRIME_Z % size)
            offset += size
        return HashGridSpec(levels, feat_dim, tuple(offsets), tuple(sizes),
                            tuple(scales), tuple(resolutions), offset,
                            tuple(sy), tuple(sz))

    def corner_offsets(self) -> np.ndarray:
        """(L, 8) row offsets of the 8 corners from the base corner."""
        out = np.zeros((self.levels, 8), np.int64)
        for lvl in range(self.levels):
            for c in range(8):
                o = ((c & 1) + ((c >> 1) & 1) * self.stride_y[lvl]
                     + ((c >> 2) & 1) * self.stride_z[lvl])
                out[lvl, c] = o % self.sizes[lvl]
        return out

    def rounded_levels(self):
        """Levels whose corner features the forward rounds to bfloat16."""
        wdt = 8 * self.feat_dim
        return [lvl for lvl, s in enumerate(self.sizes)
                if wdt <= 64 and 128 % wdt == 0 and s % (128 // wdt) == 0
                and s >= _PACK_MIN_ROWS]


def hash_encode(table, xyz, spec: HashGridSpec):
    """(N, L*F) float32 embedding of positions ``xyz`` (N, 3) in [0, 1]."""
    dev = xyz.device
    scales = torch.tensor(spec.scales, dtype=torch.float32, device=dev)[:, None, None]
    half = torch.tensor(0.5, dtype=torch.float32, device=dev)
    pos = torch.addcmul(half, xyz.t().float()[None], scales)  # (L, 3, N)
    pg = torch.floor(pos)
    frac = pos - pg
    pg = pg.clamp(min=0.0).long()
    sizes = torch.tensor(spec.sizes, dtype=torch.long, device=dev)[:, None]
    sy = torch.tensor(spec.stride_y, dtype=torch.long, device=dev)[:, None]
    sz = torch.tensor(spec.stride_z, dtype=torch.long, device=dev)[:, None]
    base = (pg[:, 0] + pg[:, 1] * sy + pg[:, 2] * sz) % sizes  # (L, N)
    bits = torch.stack([(torch.arange(8, device=dev) >> d) & 1
                        for d in range(3)]).bool()  # (3, 8)
    w = torch.where(bits[None, :, :, None], frac[:, :, None, :],
                    1.0 - frac[:, :, None, :]).prod(dim=1)  # (L, 8, N)
    co = torch.tensor(spec.corner_offsets(), dtype=torch.long, device=dev)
    offs = torch.tensor(spec.offsets, dtype=torch.long, device=dev)
    idx = offs[:, None, None] + (base[:, None, :] + co[:, :, None]) % sizes[:, None, :]
    feats = table[idx].float()  # (L, 8, N, F)
    rounded = torch.zeros(spec.levels, dtype=torch.bool, device=dev)
    rounded[spec.rounded_levels()] = True
    r = feats.to(torch.bfloat16).float()
    feats = torch.where(rounded[:, None, None, None],
                        feats + (r - feats).detach(), feats)
    out = torch.einsum("lcnf,lcn->nlf", feats, w)
    return out.reshape(xyz.shape[0], spec.out_dim)


def _spec(model) -> HashGridSpec:
    return HashGridSpec.create(model.hash_levels, model.hash_features_per_level,
                               model.hash_base_res, model.hash_max_res,
                               2**model.hash_log2_T)


def shapes(model):
    """``(out_dim, leaf shapes)`` of the model's encoder, from its sizes
    alone (no table is drawn): the roofline's count of the MLP's input
    width and of the parameters."""
    spec = _spec(model)
    return spec.out_dim, [(spec.total_rows, spec.feat_dim)]


class Encoder:
    """The encoder as ``PlainNGP`` takes it (``reference/parts.py``): its
    leaves and their program names, ``out_dim`` and ``encode``."""

    def __init__(self, model, generator: torch.Generator, device):
        self.spec = _spec(model)
        self.out_dim = self.spec.out_dim
        self.names = ["pos_table"]
        self.leaves = [torch.rand((self.spec.total_rows, self.spec.feat_dim),
                                  generator=generator, device=device,
                                  dtype=torch.float32)]

    def encode(self, leaves, x_unit):
        """(N, out_dim) features of ``x_unit`` (N, 3) in [0, 1]."""
        return hash_encode(leaves[0], x_unit, self.spec)
