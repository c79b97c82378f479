"""Sensor-fusion training loss.

Frozen copy of ``virus_nerf_tpu_torch/training/loss.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

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

The four weights of ``DEVICE_WEIGHTS`` may be 0-dim float32 tensors (the
trainer's ``device_loss_weights``, read from device memory, so a CUDA graph
of a step takes the weights written before its replay) or floats; a
float32 tensor gives the losses of the float bit for bit, since a float
multiplies a float32 tensor as its float32 rounding.  ``distortion`` stays
a float: it gates a branch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


# the weights a step may read from device memory, in this order
DEVICE_WEIGHTS = ("color", "rgbd", "tof", "uss")


class LossWeights(NamedTuple):
    color: float = 1.0
    rgbd: float = 100.0
    tof: float = 50.0
    uss: float = 50.0
    uss_depth_tol: float = 0.03 / 2.1  # 3 cm world -> cube units (trainer)
    distortion: float = 0.0


def weights_tensor(weights: LossWeights, device) -> torch.Tensor:
    """The ``DEVICE_WEIGHTS`` of ``weights`` as a (4,) float32 tensor."""
    return torch.tensor([float(getattr(weights, f)) for f in DEVICE_WEIGHTS],
                        dtype=torch.float32).to(device)


def with_device_weights(weights: LossWeights, values: torch.Tensor) -> LossWeights:
    """``weights`` with its ``DEVICE_WEIGHTS`` read from ``values`` (4,)."""
    return weights._replace(**dict(zip(DEVICE_WEIGHTS, values.unbind())))


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
