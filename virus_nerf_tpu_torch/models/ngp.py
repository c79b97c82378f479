"""Instant-NGP model: hash/triplane encoder + tiny MLPs + SH directions.

Counterpart of ``NGPModel`` (virus_nerf_tpu/models/ngp.py; reference:
modules/networks.py:32-191) as an ``nn.Module``:

- xyz net: ``xyz_net_depth`` hidden layers x ``xyz_net_width``, no bias,
  ``xyz_net_out_dim`` outputs; sigma = trunc_exp(out[0]);
- rgb net: ``rgb_net_depth`` hidden layers x ``rgb_net_width``, no bias,
  sigmoid output, input SH(dir) ++ xyz features;
- degree-4 SH on (d+1)/2 with d normalized.

The position encoder (``pos_encoder_type``): the hash grid in both
variants (``hash_variant``: "additive", the JAX package's production hash,
or "xor", the reference's own, models/ngp.py:154-155; the additive one
takes the routes ``hash_forward`` and ``hash_backward`` of
``hash_encode``), or the tri-plane grid ("triplane", models/ngp.py:95-105:
8 levels x 4 features on planes of ``max_res^2`` cells, the planes a flat
parameter in ``pos_table``).  The compute modes (``compute_dtype``,
models/ngp.py:73-78, 107-168):

- ``float32``: everything float32;
- ``mixed``: float32 parameters; the table is cast to bf16 inside the
  graph before the encode (its gradient comes back through the cast,
  bf16-rounded), and every MLP product takes bf16 inputs, accumulates in
  float32 and gives bf16 activations;
- ``bfloat16``: as ``mixed``, but the table parameter itself is bf16 (the
  reference's half-precision table); the MLP weights stay float32 and are
  cast at use, as in JAX.

Every encoder runs in every mode; the XOR hash takes one route,
corners/product: its rows are gathered and cast to float32 before the
weighted sum, and its table gradient is summed in float32 (B3) and cast
to the table's dtype at the end (hash_encoder.py:962-971, 1011).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from virus_nerf_tpu_torch.ops.common import trunc_exp
from virus_nerf_tpu_torch.ops.hash_encoder import (
    BACKWARD_ROUTES,
    FORWARD_ROUTES,
    HashGridSpec,
    _SpecTensors,
    hash_encode,
    hash_encode_xor,
)
from virus_nerf_tpu_torch.ops.sh import sh_encode
from virus_nerf_tpu_torch.ops.triplane import (
    TriPlaneSpec,
    TriPlaneTensors,
    triplane_encode,
)

ENCODER_TYPES = ("hash", "triplane")
HASH_VARIANTS = ("additive", "xor")
COMPUTE_DTYPES = ("float32", "mixed", "bfloat16")


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
        pos_encoder_type: str = "hash",
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
        hash_forward: str = "corners",
        hash_backward: str = "product",
        compute_dtype: str = "float32",
        generator: torch.Generator = None,
        device=None,
    ):
        """``generator`` draws the initial weights and lives on ``device``
        (the default generator when None)."""
        super().__init__()
        if pos_encoder_type not in ENCODER_TYPES:
            raise ValueError(f"unknown pos_encoder_type {pos_encoder_type!r} "
                             f"(have {ENCODER_TYPES})")
        if hash_variant not in HASH_VARIANTS:
            raise ValueError(f"unknown hash_variant {hash_variant!r} (have "
                             f"{HASH_VARIANTS})")
        if hash_forward not in FORWARD_ROUTES or hash_backward not in BACKWARD_ROUTES:
            raise ValueError(
                f"unknown hash route {hash_forward!r}/{hash_backward!r} (have "
                f"{FORWARD_ROUTES} and {BACKWARD_ROUTES})"
            )
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r} (have "
                             f"{COMPUTE_DTYPES})")
        if hash_variant == "xor" and (hash_forward, hash_backward) != (
                "corners", "product"):
            raise NotImplementedError(
                "the XOR hash has one route, corners/product"
            )
        self.pos_encoder_type = pos_encoder_type
        self.hash_variant = hash_variant
        self.hash_forward, self.hash_backward = hash_forward, hash_backward
        self.compute_dtype = compute_dtype
        self._dtype = torch.float32 if compute_dtype == "float32" else torch.bfloat16
        self.scale = float(scale)
        self.grid_size = int(grid_size)
        self.xyz_net_out_dim = xyz_net_out_dim
        self.hash_spec = HashGridSpec.create(
            levels=levels, feat_dim=feature_per_level, base_res=base_res,
            max_res=max_res, max_params=2**log2_T,
        )
        # reference: 8 levels x 4 features for the tri-plane
        # (modules/networks.py:81-87)
        self.triplane_spec = TriPlaneSpec.create(max_res=max_res, feat_dim=4)
        if pos_encoder_type == "hash":
            table = self.hash_spec.init_table(generator=generator, device=device)
        else:
            table = self.triplane_spec.init_planes(generator=generator,
                                                   device=device)
        if compute_dtype == "bfloat16":
            table = table.to(torch.bfloat16)
        self.pos_table = nn.Parameter(table)
        xyz_dims = (
            [self.pos_out_dim] + [xyz_net_width] * xyz_net_depth
            + [xyz_net_out_dim]
        )
        rgb_dims = [16 + xyz_net_out_dim] + [rgb_net_width] * rgb_net_depth + [3]
        self.xyz_net = _mlp(xyz_dims, generator, device)
        self.rgb_net = _mlp(rgb_dims, generator, device)
        self._consts = None

    @property
    def pos_out_dim(self) -> int:
        spec = self.hash_spec if self.pos_encoder_type == "hash" else self.triplane_spec
        return spec.out_dim

    @property
    def cascades(self) -> int:
        # reference: modules/networks.py:65
        return max(1 + int(np.ceil(np.log2(2.0 * self.scale))), 1)

    def _spec_consts(self, device):
        """The encoder's constants on ``device``, made at first use and
        kept (every step reads the same tensors)."""
        if self._consts is None or self._consts.device != device:
            self._consts = (
                TriPlaneTensors(self.triplane_spec, device)
                if self.pos_encoder_type == "triplane"
                else _SpecTensors(self.hash_spec, device))
        return self._consts

    def _run(self, layers, h):
        """The MLP in the compute dtype (JAX ``_mlp``, models/ngp.py
        :159-168): inputs and weights cast to it, each product accumulated
        in float32 and rounded to it (bf16 rounding commutes with the
        ReLU), the result back in float32."""
        h = h.to(self._dtype)
        for i, lin in enumerate(layers):
            h = nn.functional.linear(h, lin.weight.to(self._dtype))
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h.float()

    def _encode_pos(self, x_unit):
        # "mixed": the float32 table is cast inside the graph, so its
        # gradient comes back through the cast, bf16-rounded
        table = self.pos_table.to(self._dtype)
        consts = self._spec_consts(x_unit.device)
        if self.pos_encoder_type == "triplane":
            return triplane_encode(table, x_unit, self.triplane_spec, consts)
        if self.hash_variant == "xor":
            return hash_encode_xor(table, x_unit, self.hash_spec, consts)
        return hash_encode(
            table, x_unit, self.hash_spec, consts,
            forward=self.hash_forward, backward=self.hash_backward,
        )

    def density(self, x, return_feat: bool = False):
        """Density at positions x (..., 3) in [-scale, scale]^3."""
        shape = x.shape[:-1]
        x_unit = (x.reshape(-1, 3) + self.scale) / (2.0 * self.scale)
        emb = self._encode_pos(x_unit)
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
