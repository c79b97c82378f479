"""Tri-plane positional encoder.

Counterpart of ``virus_nerf_tpu/ops/triplane.py`` (reference:
modules/triplane.py:35-205), the alternative to the hash grid.  Three
axis-aligned feature planes of ``max_res^2`` cells each; a query at level L
bilinearly interpolates its (x,y), (y,z) and (z,x) projections on the
level-L lattice, with the corners' coordinates mapped up onto the shared
max-res plane; each (feature, level) output is the product of the three
plane features.

The JAX package computes this as a plain XLA gather whose autodiff
backward is a scatter-add, with no Pallas kernel, and so does the port: an
index gather of the planes whose autograd backward is PyTorch's
accumulating ``index_put_``, with XLA's treatment of a cell outside the
planes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class TriPlaneSpec:
    levels: int
    feat_dim: int
    base_res: int
    max_res: int
    log_b: float
    resolutions: Tuple[int, ...]

    @property
    def out_dim(self) -> int:
        return self.levels * self.feat_dim

    @property
    def total_params(self) -> int:
        return 3 * self.max_res**2 * self.feat_dim

    @staticmethod
    def create(base_res: int = 16, max_res: int = 2048, levels: int = 8,
               feat_dim: int = 4) -> "TriPlaneSpec":
        """The per-level lattice resolutions (triplane.py:42-58)."""
        log_b = float(np.log(max_res / base_res) / (levels - 1))
        res = tuple(
            int(np.ceil(base_res * np.exp(i * log_b) - 1.0)) + 1
            for i in range(levels)
        )
        return TriPlaneSpec(levels=levels, feat_dim=feat_dim,
                            base_res=base_res, max_res=max_res, log_b=log_b,
                            resolutions=res)

    def init_planes(self, generator=None, device=None,
                    dtype=torch.float32) -> torch.Tensor:
        """Uniform[0, 1) planes, flat (reference:
        modules/triplane.py:129-136), drawn in float32 and cast to
        ``dtype``."""
        u = torch.rand((self.total_params,), generator=generator,
                       device=device)
        return u.to(dtype)


class TriPlaneTensors:
    """A spec's constants as tensors on one device, made once: a step builds
    no tensor from host values, so a CUDA graph can hold it
    (``Trainer.make_train_chunk``)."""

    def __init__(self, spec: TriPlaneSpec, device):
        self.device = torch.device(device)
        self.res = torch.tensor(spec.resolutions, dtype=torch.float32,
                                device=device)  # (L,)
        self.half = torch.tensor(0.5, dtype=torch.float32, device=device)
        # the plane projections (x,y), (y,z), (z,x) as column indices
        self.proj = torch.tensor([[0, 1], [1, 2], [2, 0]], device=device)


def triplane_cells(xyz, spec: TriPlaneSpec, consts: TriPlaneTensors = None):
    """Each query's bilinear corners on the three planes.

    Args:
        xyz: (N, 3) positions in [0, 1].
        consts: the spec's tensors on xyz's device (built here if None).
    Returns:
        cell: (N, L, 3, 4) int64 cells of the max-res planes, bit for bit
            the JAX function's (triplane.py:84-100).
        w: (N, L, 3, 4) float32 bilinear weights.
    """
    c = consts if consts is not None else TriPlaneTensors(spec, xyz.device)
    mr = spec.max_res
    x = xyz.float()
    # plane projections (x,y), (y,z), (z,x) -> (N, 3, 2)
    proj = x[:, c.proj]
    res = c.res
    # pos = proj * (res - 1) + 0.5, rounded once as a fused multiply-add:
    # the rounding XLA's CPU compiler gives the JAX function under jit
    pos = torch.addcmul(c.half, proj[:, None], (res - 1.0)[None, :, None, None])
    pg = torch.floor(pos)
    frac = pos - pg  # (N, L, 3, 2)
    corner = torch.arange(4, device=x.device)
    co = torch.stack([(corner >> d) & 1 for d in range(2)], -1).float()  # (4, 2)
    local = pg[:, :, :, None, :] + co  # (N, L, 3, 4, 2)
    fr = frac[:, :, :, None, :]
    w = torch.where(co == 1.0, fr, 1.0 - fr)
    w = w[..., 0] * w[..., 1]  # (N, L, 3, 4)
    # level-local corner -> the shared max-res plane: a float divide, then
    # a truncation (reference: modules/triplane.py:72-76)
    ori = (local / res[None, :, None, None, None] * float(mr - 1)).to(torch.int32)
    cell = ori[..., 0].long() + ori[..., 1].long() * mr
    return cell, w


def triplane_encode(planes, xyz, spec: TriPlaneSpec,
                    consts: TriPlaneTensors = None):
    """Encode positions through the tri-plane grid.

    Args:
        planes: flat (3 * max_res^2 * feat_dim,) parameter, float32 or
            bf16, laid out [plane][cell][feat] (reference:
            modules/triplane.py:84-92).
        xyz: (N, 3) positions in [0, 1].
        consts: the spec's tensors on xyz's device (built here if None).
    Returns:
        (N, levels * feat_dim) float32 embedding, ordered [feat][level]
        (reference: modules/triplane.py:43-44).
    """
    if planes.dim() != 1 or planes.shape[0] != spec.total_params:
        raise ValueError(
            f"triplane_encode: want a flat ({spec.total_params},) parameter, "
            f"got {tuple(planes.shape)}"
        )
    n = xyz.shape[0]
    mr, F = spec.max_res, spec.feat_dim
    planes3 = planes.reshape(3, mr * mr, F)
    c = consts if consts is not None else TriPlaneTensors(spec, xyz.device)
    cell, w = triplane_cells(xyz, spec, c)
    # a query outside [0, 1] (the grid update's jittered cells) reads out
    # of the planes: as XLA's gather, a negative cell counts from the end,
    # the cell is then clamped, and the gradient drops it
    size = mr * mr
    cell = torch.where(cell < 0, cell + size, cell)
    inside = (cell >= 0) & (cell < size)
    plane_idx = torch.arange(3, device=xyz.device)[None, None, :, None]
    feats = planes3[plane_idx, cell.clamp(0, size - 1)].float()  # (N, L, 3, 4, F)
    if feats.requires_grad:
        feats = torch.where(inside[..., None], feats, feats.detach())
    plane_feat = (feats * w[..., None]).sum(dim=3)  # (N, L, 3, F)
    out = plane_feat[:, :, 0] * plane_feat[:, :, 1] * plane_feat[:, :, 2]
    # [feat][level] order: output column j * levels + level
    return out.transpose(1, 2).reshape(n, spec.out_dim)
