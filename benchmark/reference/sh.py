"""Degree-4 real spherical-harmonics direction encoding.

Frozen copy of ``virus_nerf_tpu_torch/ops/sh.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Counterpart of ``virus_nerf_tpu/ops/sh.py`` (reference:
modules/spherical_harmonics.py:7-59); autograd gives the backward.
"""

from __future__ import annotations

import torch


def sh_encode(dirs):
    """Encode (..., 3) directions, pre-mapped to ``(d+1)/2`` as in the
    reference caller (modules/networks.py:161), into (..., 16)
    coefficients."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack(
        [
            torch.full_like(x, 0.28209479177387814),
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ],
        dim=-1,
    )
