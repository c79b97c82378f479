"""Sensor-fusion training loss.

Counterpart of ``virus_nerf_tpu/training/loss.py`` (reference:
training/loss.py:7-198):

    total = color_loss_w * MSE(rgb)
          + rgbd_loss_w * MSE(depth | valid RGBD)
          + tof_loss_w  * MSE(depth | valid ToF)
          + uss_loss_w  * hinge(depth | valid USS)

The USS hinge penalizes only rendered depth closer than the cone-minimum
measurement by more than a 3 cm (world) tolerance.  Masked means are
sum(mask * err) / max(count, 1).  With ``distortion > 0`` the Mip-NeRF 360
distortion regularizer ``mean_r sum_ij w_i w_j |t_i - t_j|`` over the
renderer's dense weights 'ws' is added (loss.py:83-93); autograd carries
its gradient.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class LossWeights(NamedTuple):
    color: float = 1.0
    rgbd: float = 100.0
    tof: float = 50.0
    uss: float = 50.0
    uss_depth_tol: float = 0.03 / 2.1  # 3 cm world -> cube units (trainer)
    distortion: float = 0.0


def _masked_mse(pred, target, mask):
    err = torch.where(mask, (pred - target) ** 2, torch.zeros_like(pred))
    return err.sum() / torch.clamp(mask.sum(), min=1)


def compute_loss(
    results: Dict[str, torch.Tensor],
    batch,
    weights: LossWeights,
    sensors: Tuple[str, ...] = ("USS", "ToF"),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss + per-term dict (reference: training/loss.py:34-77)."""
    color = torch.mean((results["rgb"] - batch.rgb) ** 2) * weights.color
    loss_dict = {"color": color}
    total = color
    depth = results["depth"]
    for sensor in sensors:
        meas = batch.depths[sensor]
        valid = ~torch.isnan(meas)
        meas_safe = torch.where(valid, meas, torch.zeros_like(meas))
        if sensor == "RGBD":
            term = weights.rgbd * _masked_mse(depth, meas_safe, valid)
            loss_dict["rgbd"] = term
        elif sensor == "ToF":
            term = weights.tof * _masked_mse(depth, meas_safe, valid)
            loss_dict["ToF"] = term
        elif sensor == "USS":
            close = depth < meas_safe - weights.uss_depth_tol
            term = weights.uss * _masked_mse(depth, meas_safe, valid & close)
            loss_dict["USS"] = term
        else:
            raise ValueError(f"unknown training sensor {sensor}")
        total = total + term
    if weights.distortion > 0.0 and "ws" in results:
        w, t = results["ws"], results["ts"]
        intra = (w[:, :, None] * w[:, None, :]
                 * (t[:, :, None] - t[:, None, :]).abs()).sum(dim=(1, 2))
        term = weights.distortion * intra.mean()
        loss_dict["distortion"] = term
        total = total + term
    loss_dict["depth"] = total - color
    loss_dict["total"] = total
    return total, loss_dict
