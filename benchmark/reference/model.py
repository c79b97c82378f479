"""The plain NGP model of the reference: an encoder, the two bias-free
MLPs and the degree-4 SH directions, in plain PyTorch.

It follows the model definition of the port (``models/ngp.py``), written
again without kernels or custom autograd functions:

- the encoder found by the configuration's name (``parts.encoder``:
  ``encoders/hash_additive.py`` for the additive hash);
- float32 MLPs, ``trunc_exp`` density, sigmoid colour.

The weights come from a ``torch.Generator`` in the port's order of draws
(the encoder's leaves, then each MLP layer Xavier-uniform, the xyz layers
first), so one seed gives both sides the same initial weights.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import parts
from benchmark.reference.common import trunc_exp
from benchmark.reference.sh import sh_encode


class PlainNGP:
    """The model's parameters as plain tensors (``params``: the encoder's
    leaves, then the xyz and rgb layers) and its forward pass."""

    def __init__(self, cfg, generator: torch.Generator, device):
        m = cfg.model
        self.scale = float(m.scale)
        self.grid_size = int(m.grid_size)
        self.cascades = max(1 + int(np.ceil(np.log2(2.0 * self.scale))), 1)
        self.out_dim = m.xyz_net_out_dim
        self.encoder = parts.encoder(m).Encoder(m, generator, device)
        self.n_enc = len(self.encoder.leaves)
        xyz_dims = ([self.encoder.out_dim] + [m.xyz_net_width] * m.xyz_net_depth
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
        self.names = (list(self.encoder.names)
                      + [f"xyz_net.{i}.weight" for i in range(len(self.xyz))]
                      + [f"rgb_net.{i}.weight" for i in range(len(self.rgb))])
        self.params = list(self.encoder.leaves) + self.xyz + self.rgb
        for p in self.params:
            p.requires_grad_(True)

    def load(self, params_by_name) -> None:
        """Set every leaf from ``{name: tensor}`` (the program's names: the
        encoder's, ``xyz_net.<i>.weight``, ``rgb_net.<i>.weight``)."""
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
        h = self._mlp(self.xyz, self.encoder.encode(self.params[:self.n_enc], x_unit))
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
