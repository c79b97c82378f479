"""The VIRUS occupancy grid: Bayesian sensor-fused probability grid.

Frozen copy of ``virus_nerf_tpu_torch/grids/occupancy_grid.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick. The collectives are the
identity (one process) and the bitfield export is left out.

Counterpart of ``virus_nerf_tpu/grids/occupancy_grid.py`` (reference:
modules/occupancy_grid.py:12-496).  Per-cell occupancy probabilities are
updated from

- the depth sensors, through an explicit sensor model (constant false
  detection density + distance-proportional Gaussian around the reading,
  with the not-detected-earlier survival integral, floored at prob_min),
- the NeRF's density, through a log-space sigmoid around an adaptive
  threshold,

as log-odds evidence ``log(Po/Pe)`` summed per cell (``index_add_``), then
a Bayes update in log-odds, the warmup decay toward 0.5 and the boolean
grid the march reads.  Under data parallelism (``group``) each rank
computes the evidence of its shard of the update batches, with the NeRF
threshold's mean density averaged over the ranks, and the evidence is
summed over them before one replicated application.  The state holds no Morton bitfield: training never
reads it, and ``occ_grid_refresh_bitfield`` builds it for export.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch



def all_reduce_mean_(x, group=None):
    """One process: the value itself."""
    return x


def all_reduce_sum_(x, group=None):
    """One process: the value itself."""
    return x


class OccGridHParams(NamedTuple):
    """Static hyper-parameters, all distances in cube units (copied from
    virus_nerf_tpu/grids/occupancy_grid.py:36-68)."""

    grid_size: int
    scale: float
    M: int = 32  # cells sampled along each ray
    I: int = 32  # integration points of the survival term
    prob_min: float = 0.03
    false_detection_prob_every_m: float = 0.3
    std_every_m: float = 0.2
    nerf_pos_noise_every_m: float = 0.2
    nerf_threshold_max: float = 5.91
    nerf_threshold_slope: float = 0.01
    decay_warmup_steps: int = 80
    update_interval: int = 8
    threshold: float = 0.5
    occ_init_max: float = 0.51

    @property
    def grid_decay(self) -> float:
        """Warmup decay per update, floored to 3 decimals
        (reference: modules/occupancy_grid.py:50-52)."""
        if self.decay_warmup_steps <= 0:
            return 1.0
        decay_num_steps = self.decay_warmup_steps / self.update_interval
        d = (self.threshold / self.occ_init_max) ** (1.0 / decay_num_steps)
        return float(np.floor(d * 1000.0) / 1000.0)


class OccGridState(NamedTuple):
    occ_3d_grid: torch.Tensor  # (gs, gs, gs) float32 probabilities
    occ_bool: torch.Tensor  # (1, gs^3) bool for the ray march
    update_step: int  # updates applied so far


def occ_grid_init(hp: OccGridHParams, generator=None, device=None) -> OccGridState:
    """Probabilities uniform in (threshold, occ_init_max] so every cell
    starts marchable (reference: modules/occupancy_grid.py:38-42)."""
    gs = hp.grid_size
    u = torch.rand((gs, gs, gs), generator=generator, device=device)
    grid = hp.threshold + (hp.occ_init_max - hp.threshold) * u
    return OccGridState(grid, grid.reshape(1, -1) > hp.threshold, 0)


def _linspace01(n: int, device):
    """0..1 in n steps, as float32 ``i * (1/(n-1))`` with an exact 1 at the
    end — the values XLA gives ``jnp.linspace(0, 1, n)``."""
    out = torch.arange(n, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(n - 1)
    )
    out[-1].fill_(1.0)  # a fill: no host value copied to the device
    return out


def dist_to_cube_border(rays_o, rays_d, cube_min: float, cube_max: float):
    """Distance along each unit ray to the cube boundary
    (reference: helpers/geometric_fcts.py:151-171)."""
    pos_d = (cube_max - rays_o) / rays_d
    neg_d = (cube_min - rays_o) / rays_d
    inf = torch.full_like(pos_d, float("inf"))
    dists = torch.where(rays_d > 0, pos_d, torch.where(rays_d < 0, neg_d, inf))
    return dists.amin(dim=-1)


def _c2idx(pos, hp: OccGridHParams):
    """Cube coords -> grid indices, round to nearest
    (reference: modules/occupancy_grid.py:467-480)."""
    idx = (hp.grid_size - 1) * (pos + hp.scale) / (2.0 * hp.scale)
    return torch.clamp(torch.round(idx).long(), 0, hp.grid_size - 1)


def _cell_positions(rays_o, rays_d, hp: OccGridHParams, noise=None):
    """M cells equidistant from each origin to the cube border
    (reference: modules/occupancy_grid.py:292-335).

    Returns cell_dists (N, M), cell_pos (N, M, 3), cell_idxs (N, M, 3).
    """
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    border = dist_to_cube_border(rays_o, rays_d, -hp.scale, hp.scale)
    cell_dists = _linspace01(hp.M, rays_o.device)[None, :] * border[:, None]
    # o + d * dist as one fused multiply-add, the rounding XLA gives it
    cell_pos = torch.addcmul(
        rays_o[:, None, :], rays_d[:, None, :], cell_dists[..., None]
    )
    if noise is not None:
        cell_pos = torch.addcmul(
            cell_pos, hp.nerf_pos_noise_every_m * cell_dists[..., None], noise
        )
    return cell_dists, cell_pos, _c2idx(cell_pos, hp)


def _sensor_occupied_pdf(meas, dists, hp: OccGridHParams):
    """P[meas = dist | cell occupied] (reference:
    modules/occupancy_grid.py:448-465)."""
    stds = hp.std_every_m * dists + 1e-5
    return torch.exp(-0.5 * (meas - dists) ** 2 / stds**2)


def ray_measurement_probs(meas, dists, hp: OccGridHParams):
    """Sensor model P[meas@dist | occ], P[meas@dist | emp], each (N, M)
    (reference: modules/occupancy_grid.py:337-389)."""
    probs_equal_emp = torch.full_like(dists, hp.false_detection_prob_every_m)
    probs_equal_occ = probs_equal_emp + _sensor_occupied_pdf(
        meas[:, None], dists, hp
    )
    probs_notless_emp = torch.clamp(1.0 - probs_equal_emp * dists, min=hp.prob_min)
    # survival integral over y in [0, meas] with I points
    y = _linspace01(hp.I, meas.device)[None, :] * meas[:, None]  # (N, I)
    integrand = _sensor_occupied_pdf(y[:, None, :], dists[:, :, None], hp)
    integral = integrand.sum(dim=2) * (meas / hp.I)[:, None]  # (N, M)
    probs_notless_occ = torch.clamp(probs_notless_emp - integral, min=hp.prob_min)
    return (
        probs_equal_occ * probs_notless_occ,
        probs_equal_emp * probs_notless_emp,
    )


def nerf_density_probs(density, hp: OccGridHParams, mean_density=None):
    """Density -> occupancy probability by a log-space sigmoid around an
    adaptive threshold (reference: modules/occupancy_grid.py:391-408)."""
    if mean_density is None:
        mean_density = density.mean()
    threshold_nerf = torch.clamp(mean_density, max=hp.nerf_threshold_max)
    h_thr = -torch.log(threshold_nerf)
    probs_occ = torch.sigmoid(
        hp.nerf_threshold_slope * (torch.log(density) - h_thr)
    )
    return probs_occ, 1.0 - probs_occ


def _evidence_add_(delta, gs: int, cell_idxs, probs_occ, probs_emp, weight):
    """delta[cell] += log(Po/Pe) * weight, duplicates summed
    (occupancy_grid.py:242-247)."""
    d = torch.log(torch.clamp(probs_occ, min=1e-30)) - torch.log(
        torch.clamp(probs_emp, min=1e-30)
    )
    lin = (cell_idxs[:, 0] * gs + cell_idxs[:, 1]) * gs + cell_idxs[:, 2]
    return delta.index_add_(0, lin, d * weight)


def occ_grid_delta(hp: OccGridHParams, density_fn: Callable,
                   ray_batch: Optional[dict] = None,
                   nerf_batch: Optional[dict] = None, nerf_noise=None,
                   group=None):
    """Log-odds evidence of one update, a dense (gs^3,) vector.

    Batches are dicts with 'rays_o' (B, 3), 'rays_d' (B, 3) and 'meas' (B,)
    (NaN = no reading, masked to a no-op).  ``nerf_noise`` (B, M, 3) in
    [-1, 1) jitters the NeRF batch's cell positions.  Under ``group`` the
    NeRF threshold's mean density is the mean over the ranks
    (occupancy_grid.py:229-231).
    """
    gs = hp.grid_size
    some = ray_batch if ray_batch is not None else nerf_batch
    delta = torch.zeros(gs**3, dtype=torch.float32, device=some["rays_o"].device)
    if ray_batch is not None:
        valid = ~torch.isnan(ray_batch["meas"])
        meas = torch.where(valid, ray_batch["meas"], torch.ones_like(ray_batch["meas"]))
        dists, _, idxs = _cell_positions(ray_batch["rays_o"], ray_batch["rays_d"], hp)
        p_occ, p_emp = ray_measurement_probs(meas, dists, hp)
        weight = valid[:, None].float().expand_as(dists).reshape(-1)
        _evidence_add_(delta, gs, idxs.reshape(-1, 3), p_occ.reshape(-1),
                       p_emp.reshape(-1), weight)
    if nerf_batch is not None:
        valid = ~torch.isnan(nerf_batch["meas"])
        _, pos, idxs = _cell_positions(
            nerf_batch["rays_o"], nerf_batch["rays_d"], hp, noise=nerf_noise
        )
        density = density_fn(pos.reshape(-1, 3))
        mean_density = all_reduce_mean_(density.mean(), group)
        p_occ, p_emp = nerf_density_probs(density, hp, mean_density)
        weight = valid[:, None].float().expand(-1, hp.M).reshape(-1)
        _evidence_add_(delta, gs, idxs.reshape(-1, 3), p_occ, p_emp, weight)
    return delta


def occ_grid_apply_delta(state: OccGridState, hp: OccGridHParams,
                         delta) -> OccGridState:
    """Bayes update in log-odds, warmup decay, boolean grid
    (reference: modules/occupancy_grid.py:94-106)."""
    gs = hp.grid_size
    p = torch.clamp(state.occ_3d_grid, 1e-6, 1.0 - 1e-6)
    logits = (torch.log(p) - torch.log1p(-p)).reshape(-1) + delta
    grid = torch.sigmoid(logits).reshape(gs, gs, gs)
    update_step = state.update_step + 1
    if update_step <= hp.decay_warmup_steps:
        grid = grid * hp.grid_decay
    return OccGridState(grid, grid.reshape(1, -1) > hp.threshold, update_step)


def occ_grid_update(state: OccGridState, hp: OccGridHParams,
                    density_fn: Callable, ray_batch: Optional[dict] = None,
                    nerf_batch: Optional[dict] = None,
                    nerf_noise=None, group=None) -> OccGridState:
    """One full VIRUS grid update (reference:
    modules/occupancy_grid.py:64-106): evidence, then its application.  The
    caller draws the NeRF position noise (see ``occ_grid_delta``).  Under
    ``group`` the batches are this rank's shard and the evidence is summed
    over the ranks (occupancy_grid.py:313-316)."""
    delta = occ_grid_delta(hp, density_fn, ray_batch, nerf_batch, nerf_noise,
                           group)
    return occ_grid_apply_delta(state, hp, all_reduce_sum_(delta, group))
