"""Shared constants and small vectorized ops of the render path.

Counterpart of ``virus_nerf_tpu/ops/common.py``.  There is no kernel gate
here: the device of the tensor a kernel wrapper is given decides between
the kernel (CUDA) and its plain PyTorch version (CPU).
"""

from __future__ import annotations

import torch

# reference: modules/utils.py:12-16
MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.01
SQRT3 = 1.7320508075688772
SQRT3_2 = SQRT3 * 2
# the cube the scene is scaled into, in cube coordinates (data/scene.py)
CUBE_MIN, CUBE_MAX = -0.5, 0.5


class TruncExp(torch.autograd.Function):
    """exp with an input-clamped gradient (reference:
    modules/networks.py:17-29)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


trunc_exp = TruncExp.apply


def calc_dt(t, exp_step_factor: float, grid_size: int, scale: float,
            resolution: int = MAX_SAMPLES):
    """Marching step size (reference: modules/utils.py:54-57); the constant
    ``SQRT3/resolution`` when ``exp_step_factor == 0``."""
    return torch.clamp(
        t * exp_step_factor, SQRT3 / resolution, SQRT3_2 * scale / grid_size
    )


def _ceil_log2(x):
    """ceil(log2(x)) for x > 0, 0 for x == 0 (reference ``frexp_bit``,
    modules/utils.py:60-75)."""
    mantissa, exponent = torch.frexp(x.float())
    e = torch.where(mantissa == 0.5, exponent - 1, exponent)
    return torch.where(x != 0.0, e, torch.zeros_like(e))


def mip_from_absmax(mx, cascades: int):
    """Cascade index from max(|x|,|y|,|z|) (reference:
    modules/utils.py:78-84)."""
    return torch.clamp(_ceil_log2(mx) + 1, 0, cascades - 1)


def mip_from_dt(dt, grid_size: int, cascades: int):
    """Cascade index from step size (reference: modules/utils.py:87-92)."""
    return torch.clamp(_ceil_log2(dt * grid_size), 0, cascades - 1)


def draw_masked(mask, n: int, generator):
    """n indices drawn uniformly over the True entries of a (M,) bool mask,
    or over all M entries while none is True — what
    ``jax.random.categorical`` gives over logits of 0 (True) and -1e9
    (False).  An inverse-CDF draw over the integer cumulative count: no
    host sync, where ``torch.multinomial`` would need one to refuse an
    all-zero mask."""
    mask = mask | ~mask.any()
    cdf = torch.cumsum(mask.long(), dim=0)
    u = torch.rand((n,), generator=generator, device=mask.device)
    j = torch.minimum((u * cdf[-1]).long(), cdf[-1] - 1)
    return torch.searchsorted(cdf, j, right=True)
