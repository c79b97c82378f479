"""Instant-NGP model: hash encoder + tiny MLPs + SH directions.

Counterpart of ``NGPModel`` (virus_nerf_tpu/models/ngp.py; reference:
modules/networks.py:32-191) as an ``nn.Module``, float32 compute only:

- xyz net: ``xyz_net_depth`` hidden layers x ``xyz_net_width``, no bias,
  ``xyz_net_out_dim`` outputs; sigma = trunc_exp(out[0]);
- rgb net: ``rgb_net_depth`` hidden layers x ``rgb_net_width``, no bias,
  sigmoid output, input SH(dir) ++ xyz features;
- degree-4 SH on (d+1)/2 with d normalized.

The hash encoder in both variants (``hash_variant``: "additive", the JAX
package's production hash, or "xor", the reference's own,
models/ngp.py:154-155); the triplane encoder and the ``mixed``/``bfloat16``
compute modes are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from virus_nerf_tpu_torch.ops.common import trunc_exp
from virus_nerf_tpu_torch.ops.hash_encoder import (
    HashGridSpec,
    _SpecTensors,
    hash_encode,
    hash_encode_xor,
)

_ENCODERS = {"additive": hash_encode, "xor": hash_encode_xor}
from virus_nerf_tpu_torch.ops.sh import sh_encode


def _mlp(dims, generator, device):
    layers = nn.ModuleList()
    for din, dout in zip(dims[:-1], dims[1:]):
        lin = nn.Linear(din, dout, bias=False, device=device)
        nn.init.xavier_uniform_(lin.weight, generator=generator)
        layers.append(lin)
    return layers


class NGPModel(nn.Module):
    def __init__(
        self,
        scale: float = 0.5,
        levels: int = 16,
        feature_per_level: int = 2,
        log2_T: int = 19,
        base_res: int = 16,
        max_res: int = 2048,
        xyz_net_width: int = 64,
        xyz_net_depth: int = 1,
        xyz_net_out_dim: int = 16,
        rgb_net_width: int = 64,
        rgb_net_depth: int = 2,
        grid_size: int = 128,
        hash_variant: str = "additive",
        generator: torch.Generator = None,
        device=None,
    ):
        """``generator`` draws the initial weights and lives on ``device``
        (the default generator when None)."""
        super().__init__()
        if hash_variant not in _ENCODERS:
            raise ValueError(f"unknown hash_variant {hash_variant!r} (have "
                             f"{sorted(_ENCODERS)})")
        self.hash_variant = hash_variant
        self._encode = _ENCODERS[hash_variant]
        self.scale = float(scale)
        self.grid_size = int(grid_size)
        self.xyz_net_out_dim = xyz_net_out_dim
        self.hash_spec = HashGridSpec.create(
            levels=levels, feat_dim=feature_per_level, base_res=base_res,
            max_res=max_res, max_params=2**log2_T,
        )
        self.pos_table = nn.Parameter(
            self.hash_spec.init_table(generator=generator, device=device)
        )
        xyz_dims = (
            [self.hash_spec.out_dim] + [xyz_net_width] * xyz_net_depth
            + [xyz_net_out_dim]
        )
        rgb_dims = [16 + xyz_net_out_dim] + [rgb_net_width] * rgb_net_depth + [3]
        self.xyz_net = _mlp(xyz_dims, generator, device)
        self.rgb_net = _mlp(rgb_dims, generator, device)
        self._consts = None

    @property
    def cascades(self) -> int:
        # reference: modules/networks.py:65
        return max(1 + int(np.ceil(np.log2(2.0 * self.scale))), 1)

    def _spec_consts(self, device):
        if self._consts is None or self._consts.scales.device != device:
            self._consts = _SpecTensors(self.hash_spec, device)
        return self._consts

    @staticmethod
    def _run(layers, h):
        for i, lin in enumerate(layers):
            h = lin(h)
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h

    def density(self, x, return_feat: bool = False):
        """Density at positions x (..., 3) in [-scale, scale]^3."""
        shape = x.shape[:-1]
        x_unit = (x.reshape(-1, 3) + self.scale) / (2.0 * self.scale)
        emb = self._encode(
            self.pos_table, x_unit, self.hash_spec,
            self._spec_consts(x.device),
        )
        h = self._run(self.xyz_net, emb)
        sigma = trunc_exp(h[:, 0]).reshape(shape)
        if return_feat:
            return sigma, h.reshape(*shape, self.xyz_net_out_dim)
        return sigma

    def forward(self, x, d):
        """(sigma (...), rgb (..., 3)) at positions x and view dirs d."""
        shape = x.shape[:-1]
        sigma, feat = self.density(x, return_feat=True)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        sh = sh_encode((d.reshape(-1, 3) + 1.0) / 2.0)
        rgb_in = torch.cat([sh, feat.reshape(-1, self.xyz_net_out_dim)], -1)
        rgb = torch.sigmoid(self._run(self.rgb_net, rgb_in))
        return sigma, rgb.reshape(*shape, 3)
