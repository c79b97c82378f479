"""The VIRUS grid (``model.grid_type "occ"``) as the trainer keeps it: the
frozen ``occupancy_grid.py`` updated every ``occ_grid.update_interval``
steps from a batch of depth-sensor rays and a batch of NeRF rays.

Its draws, from the run's one generator: the initial probabilities (after
the model's leaves), then at each update the ray batch, the NeRF batch and
the NeRF cells' position noise, in that order; under data parallelism
(``update_shards``) each rank draws its shard of them from its own
generator.  The metric-to-cube
conversions, the batch sizes and the sensors of an update are worked out
from the configuration and the scene, as the trainer does.
"""

from __future__ import annotations

import torch

from benchmark.reference.dataset import sample_batch
from benchmark.reference.occupancy_grid import (
    OccGridHParams,
    _cell_positions,
    _evidence_add_,
    nerf_density_probs,
    occ_grid_apply_delta,
    occ_grid_delta,
    occ_grid_init,
    occ_grid_update,
)


def _grid_sensors(sensors):
    if "RGBD" in sensors:
        return ("random", "RGBD"), ("random", "RGBD")
    if "ToF" in sensors and "USS" in sensors:
        return ("valid_tof", "ToF"), ("valid_uss", "USS")
    if "ToF" in sensors:
        return ("valid_tof", "ToF"), ("valid_tof", "ToF")
    if "USS" in sensors:
        return ("valid_uss", "USS"), ("valid_uss", "USS")
    raise ValueError("the grid update needs a depth sensor")


class Grid:
    """The grid's state (``state``, an ``OccGridState``) and its updates."""

    def __init__(self, cfg, dataset, scene, generator: torch.Generator):
        og, m = cfg.occ_grid, cfg.model
        w2c = float(scene.w2c(1.0, only_scale=True))
        self.hp = OccGridHParams(
            grid_size=m.grid_size, scale=m.scale,
            false_detection_prob_every_m=float(og.false_detection_prob_every_m / w2c),
            std_every_m=float(og.std_every_m * w2c),
            nerf_pos_noise_every_m=float(og.nerf_pos_noise_every_m * w2c),
            nerf_threshold_max=og.nerf_threshold_max,
            nerf_threshold_slope=og.nerf_threshold_slope,
            decay_warmup_steps=og.decay_warmup_steps,
            update_interval=og.update_interval,
        )
        self.b_ray = max(1, int(og.batch_size * og.batch_ratio_ray_update))
        self.b_nerf = max(1, og.batch_size - int(og.batch_size * og.batch_ratio_ray_update))
        self.b_all = (int(og.batch_size * og.batch_ratio_ray_update),
                      og.batch_size - int(og.batch_size * og.batch_ratio_ray_update))
        self.ray_sel, self.nerf_sel = _grid_sensors(cfg.training.sensors)
        self.dataset, self.generator = dataset, generator
        self.state = occ_grid_init(self.hp, generator=generator, device=dataset.device)

    def due(self, step: int) -> bool:
        return step % self.hp.update_interval == 0

    def _draw(self, g, b_ray: int, b_nerf: int):
        ds = self.dataset
        ray_b = sample_batch(ds, g, b_ray, {"imgs": "all", "pixs": self.ray_sel[0]})
        nerf_b = sample_batch(ds, g, b_nerf, {"imgs": "all", "pixs": self.nerf_sel[0]})
        noise = torch.rand((b_nerf, self.hp.M, 3), generator=g, device=ds.device) * 2.0 - 1.0
        return ray_b, nerf_b, noise

    def update(self, density, step: int) -> None:
        """One update: its two batches and its noise drawn, the evidence of
        ``density`` (the model's, without gradient) applied."""
        hp = self.hp
        ray_b, nerf_b, noise = self._draw(self.generator, self.b_ray, self.b_nerf)
        with torch.no_grad():
            self.state = occ_grid_update(
                self.state, hp, density,
                ray_batch={"rays_o": ray_b.rays_o, "rays_d": ray_b.rays_d,
                           "meas": ray_b.depths[self.ray_sel[1]]},
                nerf_batch={"rays_o": nerf_b.rays_o, "rays_d": nerf_b.rays_d,
                            "meas": nerf_b.depths[self.nerf_sel[1]]},
                nerf_noise=noise)

    def update_shards(self, density, step: int, generators) -> None:
        """One data-parallel update over ``len(generators)`` virtual ranks:
        each draws its shard of the two batches and its noise from its own
        generator, the NeRF threshold's mean density is the mean of the
        ranks' means, each rank's evidence is summed in rank order, and the
        sum is applied once."""
        hp, world = self.hp, len(generators)
        b_ray, b_nerf = (max(1, b // world) for b in self.b_all)
        shards = [self._draw(g, b_ray, b_nerf) for g in generators]
        with torch.no_grad():
            nerf = []
            for _, nerf_b, noise in shards:
                _, pos, idxs = _cell_positions(nerf_b.rays_o, nerf_b.rays_d, hp,
                                               noise=noise)
                nerf.append((idxs, density(pos.reshape(-1, 3))))
            mean_density = sum(d.mean() for _, d in nerf) / world
            total = None
            for (ray_b, nerf_b, _), (idxs, dens) in zip(shards, nerf):
                delta = occ_grid_delta(hp, density, ray_batch={
                    "rays_o": ray_b.rays_o, "rays_d": ray_b.rays_d,
                    "meas": ray_b.depths[self.ray_sel[1]]})
                valid = ~torch.isnan(nerf_b.depths[self.nerf_sel[1]])
                p_occ, p_emp = nerf_density_probs(dens, hp, mean_density)
                weight = valid[:, None].float().expand(-1, hp.M).reshape(-1)
                _evidence_add_(delta, hp.grid_size, idxs.reshape(-1, 3), p_occ,
                               p_emp, weight)
                total = delta if total is None else total + delta
            self.state = occ_grid_apply_delta(self.state, hp, total)

    @property
    def occ_bool(self) -> torch.Tensor:
        """The boolean grid the march reads, (1, gs^3)."""
        return self.state.occ_bool

    def values(self) -> torch.Tensor:
        """The cells' occupancy probabilities, (gs, gs, gs)."""
        return self.state.occ_3d_grid


def program_values(state) -> torch.Tensor:
    """The probabilities of the port's VIRUS grid state (its ``OccGridState``)."""
    return state.occ_3d_grid
