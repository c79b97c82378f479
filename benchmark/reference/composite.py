"""Front-to-back alpha compositing, log-space transmittance.

Frozen copy of ``virus_nerf_tpu_torch/ops/composite.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Counterpart of ``virus_nerf_tpu/ops/composite.py`` (reference:
modules/volume_train.py:6-48,160-175):

    alpha_i = 1 - exp(-sigma_i * delta_i)
    T_i     = exp(-sum_{j<i} sigma_j delta_j)
    w_i     = alpha_i * T_i        (0 once T_i <= T_threshold)

Autograd differentiates it.  The exclusive optical depth is always a
cumulative sum WITHIN one ray: a global cumsum minus its value at the
segment start cancels catastrophically once the stream total dwarfs a ray's
optical depth (it made training NaN in the JAX package, composite.py:39-43).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeResults(NamedTuple):
    opacity: torch.Tensor  # (N,)
    depth: torch.Tensor  # (N,)
    rgb: torch.Tensor  # (N, 3)
    ws: torch.Tensor  # (N, S) per-sample weights
    vr_samples: torch.Tensor  # (N,) contributing samples per ray


def _weights(sd, valid, T_threshold: float):
    """Per-sample weights and liveness from the (N, S) optical depths."""
    tau = torch.cumsum(sd, dim=1) - sd  # exclusive, per ray
    T = torch.exp(-tau)
    alpha = 1.0 - torch.exp(-sd)
    live = valid & (T > T_threshold)
    return torch.where(live, alpha * T, torch.zeros_like(sd)), live


def composite_rays(sigmas, rgbs, deltas, ts, valid,
                   T_threshold: float = 1e-4) -> CompositeResults:
    """Composite the (N, S) sample layout into per-ray opacity/depth/rgb.

    Args:
        sigmas, deltas, ts: (N, S); rgbs: (N, S, 3); valid: (N, S) bool.
    """
    sd = torch.where(valid, sigmas * deltas, torch.zeros_like(sigmas))
    w, live = _weights(sd, valid, T_threshold)
    return CompositeResults(
        opacity=w.sum(dim=1),
        depth=(w * ts).sum(dim=1),
        rgb=(w[..., None] * rgbs).sum(dim=1),
        ws=w,
        vr_samples=live.sum(dim=1, dtype=torch.int32),
    )


def composite_stream(sigmas, rgbs, deltas, ts, valid, ray_id, starts, counts,
                     T_threshold: float = 1e-4, *, max_count: int):
    """Compositing on a ray-major compacted sample stream.

    Ray r owns stream slots ``[starts[r], starts[r] + counts[r])`` in
    ascending-t order.  Each valid slot is placed at (ray, slot - start) of
    a dense (N, max_count) layout, :func:`composite_rays` composites there
    (per-row cumsum), and the weights come back to the stream by the same
    index — the per-ray form of the JAX package's segmented scan.

    Args:
        sigmas, deltas, ts: (B,) stream values; rgbs: (B, 3).
        valid: (B,) bool slot validity.
        ray_id: (B,) int owning ray per slot.
        starts, counts: (N,) int stream offset and sample count per ray.
        max_count: an upper bound of ``counts`` (the per-ray budget S).
    Returns:
        (opacity (N,), depth (N,), rgb (N, 3), vr_total (), w (B,)).
    """
    B = sigmas.shape[0]
    n_rays = starts.shape[0]
    n_dense = n_rays * max_count
    ray_id = ray_id.long()
    pos = torch.arange(B, device=sigmas.device) - starts.long()[ray_id]
    inside = (
        valid & (pos >= 0) & (pos < counts.long()[ray_id]) & (pos < max_count)
    )
    # slots outside every ray land on one dump row past the dense layout
    flat = torch.where(inside, ray_id * max_count + pos,
                       torch.full_like(pos, n_dense))

    def dense(x):
        buf = x.new_zeros((n_dense + 1,) + x.shape[1:])
        return buf.index_put((flat,), x)[:-1].view(
            n_rays, max_count, *x.shape[1:]
        )

    comp = composite_rays(
        dense(sigmas), dense(rgbs), dense(deltas), dense(ts), dense(inside),
        T_threshold,
    )
    w = comp.ws.reshape(-1)[flat.clamp(max=n_dense - 1)]
    w = torch.where(inside, w, torch.zeros_like(w))
    return comp.opacity, comp.depth, comp.rgb, comp.vr_samples.sum(), w
