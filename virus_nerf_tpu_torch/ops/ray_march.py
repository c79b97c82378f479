"""Occupancy-grid-guided ray marching into a static sample layout.

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

from virus_nerf_tpu_torch.ops import _build
from virus_nerf_tpu_torch.ops.launch_counts import register
from virus_nerf_tpu_torch.ops.common import (
    SQRT3,
    SQRT3_2,
    calc_dt,
    mip_from_absmax,
    mip_from_dt,
)


# csrc/march.cu's constants (a card test compares them with the library's):
# candidates a chunk (one lane each), and the largest K and S it takes
MARCH_CHUNK = 32
MARCH_MAX_CANDIDATES = 1024
MARCH_MAX_SAMPLES = 1024


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


def _dt_bounds(grid_size: int, scale: float, resolution: int):
    """``calc_dt``'s clamp bounds as float32 values."""
    return (float(np.float32(SQRT3 / resolution)),
            float(np.float32(SQRT3_2 * scale / grid_size)))


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


def _march_lattice_cuda(t1, noise, exp_step_factor: float, grid_size: int,
                        scale: float, n_candidates: int, resolution: int):
    if not (t1.is_contiguous() and noise.is_contiguous()):
        raise ValueError("march_lattice: t1 and noise must be contiguous")
    n = t1.shape[0]
    ts = torch.empty((n, n_candidates), dtype=torch.float32, device=t1.device)
    dts = torch.empty_like(ts)
    lo, hi = _dt_bounds(grid_size, scale, resolution)
    err = _build.library().vn_march_lattice(
        t1.data_ptr(), noise.data_ptr(), ts.data_ptr(), dts.data_ptr(), n,
        n_candidates, float(np.float32(exp_step_factor)), lo, hi,
        torch.cuda.current_stream(t1.device).cuda_stream,
    )
    _build.check(err, "vn_march_lattice")
    march_lattice.launches += 1
    return ts, dts


def march_lattice(t1, noise, exp_step_factor: float, grid_size: int,
                  scale: float, n_candidates: int, resolution: int = 1024):
    """The exponential-step candidate lattice: ``t_0 = t1 + noise *
    dt(t1)``, ``t_{k+1} = t_k + dt(t_k)`` with ``dt`` of ``calc_dt``
    (``_candidate_lattice``, virus_nerf_tpu/ops/ray_march.py:106-116).

    A CUDA tensor launches the standalone lattice kernel of
    ``csrc/march.cu`` (or raises); a CPU tensor takes
    :func:`march_lattice_plain`.  ``.launches`` counts the calls that
    launched the kernel (one launch each).  The march itself does not call
    it: :func:`march_select` computes the lattice in its own kernel.

    Args:
        t1, noise: (N,) float32 cube entry distances and jitter in [0, 1).
    Returns:
        ts, dts: (N, n_candidates) float32 distances and step sizes.
    """
    if t1.dtype != torch.float32 or noise.dtype != torch.float32:
        raise TypeError(
            f"march_lattice: want float32 t1 and noise, got {t1.dtype} and "
            f"{noise.dtype}"
        )
    if t1.dim() != 1 or tuple(noise.shape) != tuple(t1.shape):
        raise ValueError(
            f"march_lattice: want t1 and noise (N,), got {tuple(t1.shape)} "
            f"and {tuple(noise.shape)}"
        )
    if noise.device != t1.device:
        raise ValueError(
            f"march_lattice: t1 on {t1.device}, noise on {noise.device}"
        )
    args = (t1, noise, exp_step_factor, grid_size, scale, n_candidates,
            resolution)
    if t1.is_cuda:
        return _march_lattice_cuda(*args)
    if t1.device.type == "cpu":
        return march_lattice_plain(*args)
    raise ValueError(f"march_lattice: unsupported device {t1.device}")


march_lattice.launches = 0
register(march_lattice)


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


def _march_select_cuda(rays_o, rays_d, t1, t2, noise, occ_grid, *,
                       cascades: int, grid_size: int, scale: float,
                       exp_step_factor: float, max_samples: int,
                       n_candidates: int, march_resolution: int = 1024):
    n, S = t1.shape[0], max_samples
    dev = t1.device
    ts = torch.empty((n, S), dtype=torch.float32, device=dev)
    deltas = torch.empty_like(ts)
    valid = torch.empty((n, S), dtype=torch.bool, device=dev)
    n_kept = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return ts, deltas, valid, n_kept
    lo, hi = _dt_bounds(grid_size, scale, march_resolution)
    err = _build.library().vn_march_select(
        rays_o.data_ptr(), rays_d.data_ptr(), t1.data_ptr(), t2.data_ptr(),
        noise.data_ptr(), occ_grid.data_ptr(), occ_grid.numel(), grid_size,
        cascades, float(np.float32(scale)), float(np.float32(exp_step_factor)),
        lo, hi, _constant_dt(grid_size, scale, march_resolution),
        ts.data_ptr(), deltas.data_ptr(), valid.data_ptr(), n_kept.data_ptr(),
        n, S, n_candidates, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "vn_march_select")
    march_select.launches += 1
    return ts, deltas, valid, n_kept


def _check_select_args(rays_o, rays_d, t1, t2, noise, occ_grid, cascades,
                       grid_size, max_samples, n_candidates):
    floats = dict(rays_o=rays_o, rays_d=rays_d, t1=t1, t2=t2, noise=noise)
    for name, x in floats.items():
        if x.dtype != torch.float32:
            raise TypeError(f"march_select: want float32 {name}, got {x.dtype}")
    if occ_grid.dtype != torch.bool:
        raise TypeError(f"march_select: want a bool occ_grid, got {occ_grid.dtype}")
    if t1.dim() != 1:
        raise ValueError(f"march_select: want t1 of shape (N,), got {tuple(t1.shape)}")
    n = t1.shape[0]
    shapes = dict(rays_o=(n, 3), rays_d=(n, 3), t2=(n,), noise=(n,))
    for name, want in shapes.items():
        if tuple(floats[name].shape) != want:
            raise ValueError(
                f"march_select: want {name} of shape {want} (N = t1's), got "
                f"{tuple(floats[name].shape)}")
    if (occ_grid.dim() != 2 or occ_grid.shape[0] < 1
            or occ_grid.shape[1] != grid_size**3):
        raise ValueError(
            f"march_select: want occ_grid (rows, {grid_size}^3), got "
            f"{tuple(occ_grid.shape)}")
    # the kernel's cell index is int32
    if cascades < 1 or max(cascades, occ_grid.shape[0]) * grid_size**3 >= 2**31:
        raise ValueError(f"march_select: want 1 <= cascades and fewer than 2^31 "
                         f"cells, got {cascades} cascades of {grid_size}^3, "
                         f"{occ_grid.shape[0]} grid rows")
    # the kernel keeps 32 ballots a ray in shared memory, and the integer
    # selection (rank * S, (f0 + 1) * c) stays in int32 at these limits
    if not (1 <= n_candidates <= MARCH_MAX_CANDIDATES
            and 1 <= max_samples <= MARCH_MAX_SAMPLES):
        raise ValueError(
            f"march_select: want 1 <= K <= {MARCH_MAX_CANDIDATES} and 1 <= S "
            f"<= {MARCH_MAX_SAMPLES}, got K = {n_candidates}, S = {max_samples}")
    for name, x in dict(floats, occ_grid=occ_grid).items():
        if x.device != t1.device:
            raise ValueError(f"march_select: {name} on {x.device}, t1 on {t1.device}")
        if not x.is_contiguous():
            raise ValueError(f"march_select: {name} must be contiguous")


def march_select(rays_o, rays_d, t1, t2, noise, occ_grid, *, cascades: int,
                 grid_size: int, scale: float, exp_step_factor: float,
                 max_samples: int, n_candidates: int,
                 march_resolution: int = 1024):
    """The march from the cube hits to the (N, S) sample layout: the
    candidate lattice, ``in_range``, the occupancy probe and the slot
    selection (virus_nerf_tpu/ops/ray_march.py:88-158, :368-451).

    A CUDA tensor launches ``csrc/march.cu`` (or raises); a CPU tensor
    takes :func:`march_select_plain`.  ``.launches`` counts the calls that
    launched the kernel (one launch each).

    Args:
        rays_o, rays_d: (N, 3) float32 origins and unit directions.
        t1, t2: (N,) float32 cube entry and exit (``ray_aabb_intersect``).
        noise: (N,) float32 jitter in [0, 1) of the first candidate.
        occ_grid: (rows, grid_size^3) bool, rows 1 (VIRUS) or the cascades.
        All contiguous, on one device.  K = ``n_candidates`` and S =
        ``max_samples`` are at most 1024.
    Returns:
        ts, deltas: (N, S) float32, zero past ``n_kept``; valid: (N, S)
        bool; n_kept: (N,) int32 samples kept per ray.
    """
    _check_select_args(rays_o, rays_d, t1, t2, noise, occ_grid, cascades,
                       grid_size, max_samples, n_candidates)
    kw = dict(cascades=cascades, grid_size=grid_size, scale=scale,
              exp_step_factor=exp_step_factor, max_samples=max_samples,
              n_candidates=n_candidates, march_resolution=march_resolution)
    args = (rays_o, rays_d, t1, t2, noise, occ_grid)
    if t1.is_cuda:
        return _march_select_cuda(*args, **kw)
    if t1.device.type == "cpu":
        return march_select_plain(*args, **kw)
    raise ValueError(f"march_select: unsupported device {t1.device}")


march_select.launches = 0
register(march_select)


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
    ts, deltas, valid, n_kept = march_select(
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
