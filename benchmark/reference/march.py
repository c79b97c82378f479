"""Occupancy-grid-guided ray marching into a static sample layout.

Frozen copy of ``virus_nerf_tpu_torch/ops/ray_march.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick. The kernel wrappers are left out:
the reference runs the plain versions only.

Counterpart of ``march_rays_train`` (virus_nerf_tpu/ops/ray_march.py:306).
The semantics are ported, not the TPU probe tricks: the candidate lattice
(``_candidate_lattice``, :88-116) — closed form ``t_k = t1 + (noise + k) *
dt`` at constant dt (``exp_step_factor == 0``), the exponential-step scan
otherwise — one exact cascade-aware occupancy probe per candidate
(``occupancy_lookup``, :118-158), ``in_range``, and the rank-compact slot
selection with stride subsampling of overflowing rays and per-candidate
step sizes (``_rank_select`` / ``_select_from_valid`` / ``_exact``,
:368-451).  The JAX package's payload, multi-cascade payload, hierarchical
and super-coarse probes are bit-exact stand-ins for this exact probe
(:28-36), so none of them is ported.

On the card the whole chain from the cube hits to the (N, S) layout is
one kernel, ``csrc/march.cu`` (:func:`march_select`): the lattice stays in
registers and shared memory.  Its plain version
(:func:`march_select_plain`) builds the (N, K) lattice
(:func:`march_lattice_plain` for the exponential step), probes it and
selects.  The selection is computed, not sorted: a kept candidate of rank
j lands in slot j (rays within budget) or slot ceil(j*S/c) (overflowing
rays) — the position the JAX package's rank sort gives it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

import numpy as np

from benchmark.reference.common import (
    SQRT3,
    SQRT3_2,
    calc_dt,
    mip_from_absmax,
    mip_from_dt,
)


class MarchResults(NamedTuple):
    xyzs: torch.Tensor  # (N, S, 3) sample positions
    dirs: torch.Tensor  # (N, S, 3) ray directions (broadcast)
    deltas: torch.Tensor  # (N, S) marching deltas
    ts: torch.Tensor  # (N, S) sample distances
    valid: torch.Tensor  # (N, S) bool sample validity
    n_samples: torch.Tensor  # (N,) int32 samples kept per ray (<= S)
    total_samples: torch.Tensor  # () sum of n_samples ("rm_samples")


def occupancy_lookup(occ_grid, x, y, z, dt, cascades: int, grid_size: int,
                     scale: float, active=None):
    """Cascade-aware occupancy at positions (x, y, z), each (...).

    Args:
        occ_grid: (cascades, grid_size^3) bool, cartesian order
            ``lin = (x*gs + y)*gs + z``.
        dt: (...) step sizes.
        active: optional (...) bool; where False the index is masked to 0
            (callers AND the result with their own mask).

    The flat index is clamped to the grid's last cell, as XLA clamps the
    JAX package's gather.  That matters only where the grid has fewer
    rows than ``cascades``: the VIRUS grid is one cascade over
    ``[-scale, scale]``, yet the renderer marches it with the model's
    cascades (2 at scale 1.0), so a mip-1 probe indexes past its end and
    reads the last cell — a reference behaviour the port keeps bit for bit
    (ROADMAP, "Reference behaviours the port matches").
    """
    mx = torch.maximum(x.abs(), torch.maximum(y.abs(), z.abs()))
    mip = torch.maximum(
        mip_from_absmax(mx, cascades), mip_from_dt(dt, grid_size, cascades)
    )
    mip_bound = torch.clamp(torch.exp2(mip.float() - 1.0), max=scale)

    def cell(c):
        n = torch.clamp(
            0.5 * (c / mip_bound + 1.0) * grid_size, 0.0, grid_size - 1.0
        )
        return n.long()  # floor (n >= 0)

    lin = (cell(x) * grid_size + cell(y)) * grid_size + cell(z)
    idx = mip.long() * grid_size**3 + lin
    if active is not None:
        idx = torch.where(active, idx, torch.zeros_like(idx))
    flat = occ_grid.reshape(-1)
    return flat[idx.clamp_(max=flat.numel() - 1)]


def march_lattice_plain(t1, noise, exp_step_factor: float, grid_size: int,
                        scale: float, n_candidates: int, resolution: int = 1024):
    """Plain version of :func:`march_lattice`: the scan as a loop of K
    steps over (N,) tensors."""
    # t1 + noise * dt(t1) rounded once (a fused multiply-add), as XLA's CPU
    # compiler gives the jitted JAX lattice; each later step is a multiply,
    # a clamp and an add, each rounded
    t = torch.addcmul(
        t1, noise, calc_dt(t1, exp_step_factor, grid_size, scale, resolution)
    )
    ts = t1.new_empty((t1.shape[0], n_candidates))
    dts = torch.empty_like(ts)
    for k in range(n_candidates):
        dt = calc_dt(t, exp_step_factor, grid_size, scale, resolution)
        ts[:, k] = t
        dts[:, k] = dt
        t = t + dt
    return ts, dts


def _select_from_valid(valid, ts_cand, dts, S: int):
    """Rank-compact S slots per ray out of the (N, K) candidate lattice.

    ``dts`` is the (N, K) candidates' step sizes, or one float for a
    constant step.  Rays with more valid candidates c than S keep the
    candidates of rank j with ``ceil((j+1)S/c) > ceil(jS/c)`` and scale
    their delta by the number of candidates each represents
    (ray_march.py:368-422).
    """
    n_rays, K = valid.shape
    c = valid.sum(dim=1, dtype=torch.long)[:, None]  # (N, 1)
    v = valid.long()
    rank = torch.cumsum(v, dim=1) - v
    dt = (torch.full_like(ts_cand, dts) if isinstance(dts, float) else dts)
    if S >= K:
        kept, slot = valid, rank
    else:
        overflow = c > S
        cg = torch.clamp(c, min=1)
        jS = rank * S
        f0 = torch.div(jS + c - 1, cg, rounding_mode="floor")  # ceil(jS/c)
        f1 = torch.div(jS + S + c - 1, cg, rounding_mode="floor")
        kept = valid & torch.where(overflow, (f1 > f0) & (f0 < S), rank < S)
        nxt = torch.minimum(torch.div((f0 + 1) * c, S, rounding_mode="floor"), c)
        rep = torch.clamp(nxt - rank, min=1).float()
        dt = dt * torch.where(overflow, rep, torch.ones_like(rep))
        slot = torch.where(overflow, f0, rank)
    # scatter the kept candidates into their slots; the rest land in one
    # dump column past the layout
    width = max(S, K)
    slot = torch.where(kept, slot, torch.full_like(slot, width))
    ts_sel = ts_cand.new_zeros(n_rays, width + 1).scatter_(1, slot, ts_cand)
    dt_sel = dt.new_zeros(n_rays, width + 1).scatter_(1, slot, dt)
    n_kept = torch.clamp(c[:, 0], max=S).to(torch.int32)
    slot_valid = torch.arange(S, device=valid.device)[None, :] < n_kept[:, None]
    zero = ts_sel.new_zeros(())
    return (
        torch.where(slot_valid, ts_sel[:, :S], zero),
        torch.where(slot_valid, dt_sel[:, :S], zero),
        slot_valid,
        n_kept,
    )


def _constant_dt(grid_size: int, scale: float, resolution: int) -> float:
    """The constant step as a float32 value (the ``clamp(0, ...)`` of
    ``calc_dt`` at ``exp_step_factor == 0``)."""
    return float(np.float32(
        min(max(0.0, SQRT3 / resolution), SQRT3_2 * scale / grid_size)
    ))


def march_select_plain(rays_o, rays_d, t1, t2, noise, occ_grid, *,
                       cascades: int, grid_size: int, scale: float,
                       exp_step_factor: float, max_samples: int,
                       n_candidates: int, march_resolution: int = 1024):
    """Plain version of :func:`march_select`: the (N, K) candidate lattice,
    ``in_range``, the probe of every candidate and the selection, each a
    PyTorch op over the whole lattice."""
    if exp_step_factor == 0.0:
        dt0 = _constant_dt(grid_size, scale, march_resolution)
        dt0_t = torch.tensor(dt0, dtype=torch.float32, device=t1.device)
        k = torch.arange(n_candidates, dtype=torch.float32, device=t1.device)
        # t1 + (noise + k) * dt and the positions o + t * d below are each
        # rounded once, as fused multiply-adds: the rounding XLA's CPU
        # compiler gives the JAX march under jit, so the probed cells agree
        # bit for bit
        ts_cand = torch.addcmul(t1[:, None], noise[:, None] + k[None, :], dt0_t)
        dts_cand, dts_sel = dt0_t.expand_as(ts_cand), dt0
    else:
        ts_cand, dts_cand = march_lattice_plain(
            t1, noise, exp_step_factor, grid_size, scale, n_candidates,
            march_resolution,
        )
        dts_sel = dts_cand
    in_range = (ts_cand >= 0.0) & (ts_cand < t2[:, None]) & (t1[:, None] >= 0.0)
    cx, cy, cz = (torch.addcmul(rays_o[:, d:d + 1], ts_cand, rays_d[:, d:d + 1])
                  for d in range(3))
    occ = occupancy_lookup(
        occ_grid, cx, cy, cz, dts_cand, cascades, grid_size, scale,
        active=in_range,
    )
    return _select_from_valid(occ & in_range, ts_cand, dts_sel, max_samples)


def march_rays_train(
    rays_o,
    rays_d,
    hits_t,
    occ_grid,
    noise,
    *,
    cascades: int,
    grid_size: int,
    scale: float,
    exp_step_factor: float,
    max_samples: int,
    n_candidates: int = 1024,
    march_resolution: int = 1024,
) -> MarchResults:
    """March rays through the occupancy grid into a static (N, S) layout
    (:func:`march_select`, then the positions).

    Args:
        rays_o, rays_d: (N, 3) origins and unit directions.
        hits_t: (N, 2) cube entry/exit from ``ray_aabb_intersect``.
        occ_grid: (rows, grid_size^3) bool occupancy (cartesian order),
            one row a cascade; the one-row VIRUS grid too, whatever
            ``cascades`` (see ``occupancy_lookup``).
        noise: (N,) per-ray jitter in [0, 1) of the first sample.
        max_samples: per-ray budget S of the layout.
        n_candidates: lattice length K.
        march_resolution: min step SQRT3/resolution (1024 = reference).
        exp_step_factor: 0 for the constant step's closed form, else the
            exponential-step lattice.
    """
    n_rays = rays_o.shape[0]
    S = max_samples
    t1, t2 = hits_t.t().contiguous()  # one copy; each row contiguous
    ts, deltas, valid, n_kept = march_select_plain(
        rays_o.contiguous(), rays_d.contiguous(), t1, t2, noise.contiguous(),
        occ_grid.contiguous(), cascades=cascades, grid_size=grid_size,
        scale=scale, exp_step_factor=exp_step_factor, max_samples=S,
        n_candidates=n_candidates, march_resolution=march_resolution,
    )
    xyzs = torch.addcmul(rays_o[:, None, :], ts[..., None], rays_d[:, None, :])
    dirs = rays_d[:, None, :].expand(n_rays, S, 3)
    return MarchResults(
        xyzs=xyzs, dirs=dirs, deltas=deltas, ts=ts, valid=valid,
        n_samples=n_kept, total_samples=n_kept.sum(),
    )
