"""The plain NGP model of the reference: the additive hash grid, the two
bias-free MLPs and the degree-4 SH directions, in plain PyTorch.

It follows the model definition of the port (``models/ngp.py`` with
``ops/hash_encoder.py``'s ``corners`` forward), written again without
kernels or custom autograd functions:

- the additive hash ``idx = (x + y*P2 + z*P3) mod size`` with each level's
  strides reduced mod its size (``HashGridSpec``, copied from the port);
- trilinear weights from ``pos = xyz * scale + 0.5`` rounded once;
- the corner features of every level of at least 2^17 rows rounded to
  bfloat16 in the forward pass, as the model definition of the JAX package
  and the port has it; the gradient passes that rounding straight through
  (``f + (round(f) - f).detach()``, exact in float32);
- the table gradient from autograd (the gather's backward), where the port
  sorts the keys and runs its segment-sum kernel;
- float32 MLPs, ``trunc_exp`` density, sigmoid colour.

The weights come from a ``torch.Generator`` in the port's order of draws
(the table uniform in [0, 1), then each MLP layer Xavier-uniform, the xyz
layers first), so one seed gives both sides the same initial weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from benchmark.reference.common import trunc_exp
from benchmark.reference.sh import sh_encode

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


class PlainNGP:
    """The model's parameters as plain tensors (``params``: the table,
    then the xyz and rgb layers) and its forward pass."""

    def __init__(self, cfg, generator: torch.Generator, device):
        m = cfg.model
        self.scale = float(m.scale)
        self.grid_size = int(m.grid_size)
        self.cascades = max(1 + int(np.ceil(np.log2(2.0 * self.scale))), 1)
        self.out_dim = m.xyz_net_out_dim
        self.spec = HashGridSpec.create(m.hash_levels, m.hash_features_per_level,
                                        m.hash_base_res, m.hash_max_res,
                                        2**m.hash_log2_T)
        table = torch.rand((self.spec.total_rows, self.spec.feat_dim),
                           generator=generator, device=device,
                           dtype=torch.float32)
        xyz_dims = ([self.spec.out_dim] + [m.xyz_net_width] * m.xyz_net_depth
                    + [m.xyz_net_out_dim])
        rgb_dims = [16 + m.xyz_net_out_dim] + [m.rgb_net_width] * m.rgb_net_depth + [3]

        def layers(dims):
            out = []
            for din, dout in zip(dims[:-1], dims[1:]):
                a = float(np.sqrt(6.0 / (din + dout)))
                out.append(torch.empty((dout, din), device=device).uniform_(
                    -a, a, generator=generator))
            return out

        self.xyz = layers(xyz_dims)
        self.rgb = layers(rgb_dims)
        self.names = (["pos_table"] + [f"xyz_net.{i}.weight" for i in range(len(self.xyz))]
                      + [f"rgb_net.{i}.weight" for i in range(len(self.rgb))])
        self.params = [table] + self.xyz + self.rgb
        for p in self.params:
            p.requires_grad_(True)

    def load(self, params_by_name) -> None:
        """Set every leaf from ``{name: tensor}`` (the program's names,
        ``pos_table``, ``xyz_net.<i>.weight``, ``rgb_net.<i>.weight``)."""
        with torch.no_grad():
            for name, p in zip(self.names, self.params):
                p.copy_(params_by_name[name].to(p.dtype))

    @staticmethod
    def _mlp(weights, h):
        for i, wt in enumerate(weights):
            h = torch.nn.functional.linear(h, wt)
            if i < len(weights) - 1:
                h = torch.relu(h)
        return h

    def density(self, x, return_feat: bool = False):
        shape = x.shape[:-1]
        x_unit = (x.reshape(-1, 3) + self.scale) / (2.0 * self.scale)
        h = self._mlp(self.xyz, hash_encode(self.params[0], x_unit, self.spec))
        sigma = trunc_exp(h[:, 0]).reshape(shape)
        if return_feat:
            return sigma, h.reshape(*shape, self.out_dim)
        return sigma

    def __call__(self, x, d):
        shape = x.shape[:-1]
        sigma, feat = self.density(x, return_feat=True)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        sh = sh_encode((d.reshape(-1, 3) + 1.0) / 2.0)
        rgb = torch.sigmoid(self._mlp(self.rgb, torch.cat(
            [sh, feat.reshape(-1, self.out_dim)], -1)))
        return sigma, rgb.reshape(*shape, 3)
