"""Ray rendering: AABB intersect -> occupancy-guided march -> model ->
composite.

Counterpart of ``render_rays`` (virus_nerf_tpu/models/renderer.py:27;
reference: modules/rendering.py:12-228).  The march noise is an argument
(the caller draws it), so tests can hand both implementations the same
numbers.  Asked by the training step (``stamp_phases``), with the tracer
on (``utils/tracing.py``), it stamps the ends of the ``march`` phase (the
march and, on the budget path, the compaction up to the selected points)
and of the ``forward`` phase (the encoder, the MLPs and the compositing).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.ops.composite import composite_rays, composite_stream
from virus_nerf_tpu_torch.ops.intersection import ray_aabb_intersect
from virus_nerf_tpu_torch.ops.ray_march import march_rays_train
from virus_nerf_tpu_torch.utils import tracing


def render_rays(
    model: NGPModel,
    occ_bool,
    rays_o,
    rays_d,
    noise,
    *,
    exp_step_factor: float = 0.0,
    T_threshold: float = 1e-4,
    max_samples: int = 256,
    n_candidates: int = 1024,
    march_resolution: int = 1024,
    sample_budget: Optional[int] = None,
    need_ws: bool = False,
    stamp_phases: bool = False,
) -> Dict[str, torch.Tensor]:
    """Render a batch of rays.

    Args:
        occ_bool: (cascades, grid_size^3) bool occupancy.
        rays_o, rays_d: (N, 3).
        noise: (N,) march jitter in [0, 1) (zeros for no jitter).
        sample_budget: run the model on at most this many compacted samples
            (None: on the dense (N, max_samples) layout).
        need_ws: with ``sample_budget``, also scatter the stream's weights
            back to the dense (N, max_samples) 'ws' (the distortion loss
            reads them); the dense layout always returns 'ws'.
        stamp_phases: stamp the training step's ``march`` and ``forward``
            phases (the trainer's step; the evaluator's renders stamp
            nothing).
    Returns:
        'opacity', 'depth', 'rgb', 'deltas', 'ts', 'valid', 'ws' (see
        ``need_ws``) and the counters 'rm_samples', 'vr_samples',
        'overflow'.  Background is white when
        ``exp_step_factor == 0``, else black (modules/rendering.py:219-226).
    """
    hits_t = ray_aabb_intersect(rays_o, rays_d, model.scale)
    march = march_rays_train(
        rays_o, rays_d, hits_t, occ_bool, noise,
        cascades=model.cascades, grid_size=model.grid_size, scale=model.scale,
        exp_step_factor=exp_step_factor, max_samples=max_samples,
        n_candidates=n_candidates, march_resolution=march_resolution,
    )
    if sample_budget is None and stamp_phases:
        tracing.stamp("march", rays_o.device)
    out: Dict[str, torch.Tensor] = {
        "deltas": march.deltas,
        "ts": march.ts,
        "valid": march.valid,
        "rm_samples": march.total_samples,
    }
    if sample_budget is None:
        sigmas, rgbs = model(march.xyzs, march.dirs)
        sigmas = torch.where(march.valid, sigmas, torch.zeros_like(sigmas))
        comp = composite_rays(
            sigmas, rgbs, march.deltas, march.ts, march.valid, T_threshold
        )
        opacity, depth, rgb_fg = comp.opacity, comp.depth, comp.rgb
        out["ws"] = comp.ws
        out["vr_samples"] = comp.vr_samples.sum()
        out["overflow"] = torch.zeros((), dtype=torch.int32, device=rays_o.device)
    else:
        # Global compaction (renderer.py:95-193): when the batch's valid
        # samples exceed the budget every ray is proportionally stride-
        # subsampled (per-ray target k_i = slots_i * B / total, deltas
        # scaled by the represented count) instead of truncating the tail
        # rays of the batch.
        S = max_samples
        slots0 = torch.clamp(march.n_samples.long(), max=S)  # (N,)
        total0 = slots0.sum()
        need = total0 > sample_budget
        k = torch.where(
            need,
            torch.maximum(
                torch.div(slots0 * sample_budget, torch.clamp(total0, min=1),
                          rounding_mode="floor"),
                torch.clamp(slots0, max=1),  # nonempty rays keep >= 1
            ),
            slots0,
        )
        s_idx = torch.arange(S, device=rays_o.device)[None, :]
        c = slots0[:, None]
        kk = k[:, None]
        cg = torch.clamp(c, min=1)
        kg = torch.clamp(kk, min=1)
        f0 = torch.div(s_idx * kk + cg - 1, cg, rounding_mode="floor")
        f1 = torch.div((s_idx + 1) * kk + cg - 1, cg, rounding_mode="floor")
        kept = (f1 > f0) & (f0 < kk)  # exactly k slots of the first c
        nxt = torch.minimum(torch.div((f0 + 1) * cg, kg, rounding_mode="floor"), c)
        rep = torch.clamp(nxt - s_idx, min=1).to(march.deltas.dtype)
        sub = need & (c > kk)  # rays actually subsampled
        valid_b = march.valid & torch.where(sub, kept, march.valid)
        deltas_b = march.deltas * torch.where(sub, rep, torch.ones_like(rep))

        # stable valid-first order of the flat (N*S) layout
        flat_valid = valid_b.reshape(-1)
        order = torch.sort((~flat_valid).to(torch.int32), stable=True).indices
        sel = order[:sample_budget]
        dt_c = deltas_b.reshape(-1)[sel]
        sel_valid = (
            torch.arange(sample_budget, device=rays_o.device) < flat_valid.sum()
        )
        pts = march.xyzs.reshape(-1, 3)[sel]
        if stamp_phases:
            tracing.stamp("march", rays_o.device)
        ray_id = torch.div(sel, S, rounding_mode="floor")
        drs = rays_d[ray_id]
        sig_c, rgb_c = model(pts, drs)
        sig_c = torch.where(sel_valid, sig_c, torch.zeros_like(sig_c))
        # t rebuilt from the gathered position (exact to f32 rounding)
        ts_c = ((pts - rays_o[ray_id]) * drs).sum(dim=1)

        starts = torch.cumsum(k, dim=0) - k
        cnt = (
            torch.clamp(starts + k, max=sample_budget)
            - torch.clamp(starts, max=sample_budget)
        )
        starts = torch.clamp(starts, max=sample_budget - 1)
        opacity, depth, rgb_fg, vr_total, w_stream = composite_stream(
            sig_c, rgb_c, dt_c, ts_c, sel_valid, ray_id, starts, cnt,
            T_threshold, max_count=S,
        )
        out["vr_samples"] = vr_total
        out["overflow"] = torch.clamp(total0 - sample_budget, min=0)
        if need_ws:
            # the stream's slots are distinct cells of the (N, S) layout
            # (renderer.py:186-190)
            out["ws"] = w_stream.new_zeros(valid_b.numel()).index_put(
                (sel,), w_stream).reshape(valid_b.shape)

    rgb_bg = 1.0 if exp_step_factor == 0.0 else 0.0
    out["opacity"] = opacity
    out["depth"] = depth
    out["rgb"] = rgb_fg + rgb_bg * (1.0 - opacity)[:, None]
    if stamp_phases:
        tracing.stamp("forward", rays_o.device)
    return out
