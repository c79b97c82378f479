"""Trainer: the training step and loop on one device.

Counterpart of ``virus_nerf_tpu/training/trainer.py`` (reference:
training/trainer.py:29-165).  One step samples a batch, renders it through
the occupancy-guided march, takes the sensor-fusion loss, back-propagates
(the hash-table gradient through the segment-sum kernel) and applies Adam
(the table through the fused-Adam kernel).  The VIRUS grid update runs
BEFORE the step whenever ``step % update_interval == 0``, step 0 included —
the order of the JAX package's chunk body (trainer.py:484-510).

Per-step metrics stay on the device and are fetched once per chunk of
``evaluation.eval_every_n_steps`` steps, not once per step.

Ported: the occupancy ("occ") grid, the additive hash encoder (with its
routes ``hash_forward``/``hash_backward``, arguments of the trainer) and the
XOR one, the ``float32``, ``mixed`` and ``bfloat16`` compute modes
(``model.dtype``; XOR in float32 only), constant-dt marching, the "all"/"same" image and
"random"/"valid_uss"/"valid_tof" pixel strategies.  Not yet: checkpoints,
debug_mode, intermediate evaluation, the NGP grid, real-time simulation,
the distortion loss and data parallelism.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data.dataset import Batch, DeviceDataset, sample_batch
from virus_nerf_tpu_torch.data.scene import Scene
from virus_nerf_tpu_torch.grids.occupancy_grid import (
    OccGridHParams,
    OccGridState,
    occ_grid_init,
    occ_grid_update,
)
from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.models.renderer import render_rays
from virus_nerf_tpu_torch.ops.fused_adam import FusedAdam
from virus_nerf_tpu_torch.training.loss import LossWeights, compute_loss

logger = logging.getLogger("virus_nerf_tpu_torch")

METRIC_KEYS = (
    "loss", "loss_color", "loss_USS", "loss_ToF", "loss_rgbd", "loss_depth",
    "psnr", "rm_samples", "vr_samples", "overflow",
)


@dataclass
class TrainState:
    """Everything a step changes: parameters (in ``model``), Adam moments
    and step count (in ``optimizer``), the grid, the random stream and the
    step."""

    model: NGPModel
    optimizer: FusedAdam
    grid: OccGridState
    generator: torch.Generator
    step: int = 0


def _full_device(device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so two spellings of one card compare
    equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_supported(cfg: Config) -> None:
    unsupported = {
        "model.grid_type": (cfg.model.grid_type, "occ"),
        "model.encoder_type": (cfg.model.encoder_type, "hash"),
        "model.hash_variant": (cfg.model.hash_variant, ("additive", "xor")),
        "model.dtype": (cfg.model.dtype, ("float32", "mixed", "bfloat16")),
        "exp_step_factor": (cfg.exp_step_factor, 0.0),
        "training.distortion_loss_w": (cfg.training.distortion_loss_w, 0.0),
        "training.debug_mode": (cfg.training.debug_mode, False),
        "training.real_time_simulation": (
            cfg.training.real_time_simulation, False
        ),
    }
    for name, (have, want) in unsupported.items():
        if have not in (want if isinstance(want, tuple) else (want,)):
            raise NotImplementedError(
                f"virus_nerf_tpu_torch Trainer: {name}={have!r} is not "
                f"ported (only {want!r})"
            )


class Trainer:
    """Training loop around the model, the optimizer and the grid."""

    def __init__(self, cfg: Config, train_dataset: DeviceDataset,
                 scene: Optional[Scene] = None, device=None,
                 hash_forward: str = "corners", hash_backward: str = "product"):
        """``hash_forward`` / ``hash_backward``: the additive hash's routes
        (``hash_encode``); the compute mode is ``cfg.model.dtype``."""
        _check_supported(cfg)
        self.cfg = cfg
        self.device = _full_device(
            train_dataset.device if device is None else device
        )
        if _full_device(train_dataset.device) != self.device:
            raise ValueError(
                f"dataset on {train_dataset.device}, trainer on {self.device}"
            )
        self.train_dataset = train_dataset
        # full float32 matrix products and convolutions on the card, and
        # float32 accumulation of bf16 products (the mixed/bfloat16 modes)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

        m = cfg.model
        self.model_kwargs = dict(
            scale=m.scale, levels=m.hash_levels,
            feature_per_level=m.hash_features_per_level, log2_T=m.hash_log2_T,
            base_res=m.hash_base_res, max_res=m.hash_max_res,
            xyz_net_width=m.xyz_net_width, xyz_net_depth=m.xyz_net_depth,
            xyz_net_out_dim=m.xyz_net_out_dim, rgb_net_width=m.rgb_net_width,
            rgb_net_depth=m.rgb_net_depth, grid_size=m.grid_size,
            hash_variant=m.hash_variant, hash_forward=hash_forward,
            hash_backward=hash_backward, compute_dtype=m.dtype,
        )
        # metric -> cube conversions (reference: training/loss.py:29,
        # modules/occupancy_grid.py:55-58)
        w2c = scene.w2c(1.0, only_scale=True) if scene is not None else 1.0
        t = cfg.training
        self.loss_weights = LossWeights(
            color=t.color_loss_w, rgbd=t.rgbd_loss_w, tof=t.tof_loss_w,
            uss=t.uss_loss_w, uss_depth_tol=float(0.03 * w2c),
        )
        og = cfg.occ_grid
        self.occ_hp = OccGridHParams(
            grid_size=m.grid_size, scale=m.scale,
            false_detection_prob_every_m=float(
                og.false_detection_prob_every_m / w2c
            ),
            std_every_m=float(og.std_every_m * w2c),
            nerf_pos_noise_every_m=float(og.nerf_pos_noise_every_m * w2c),
            nerf_threshold_max=og.nerf_threshold_max,
            nerf_threshold_slope=og.nerf_threshold_slope,
            decay_warmup_steps=og.decay_warmup_steps,
            update_interval=og.update_interval,
        )
        self.grid_update_interval = og.update_interval
        self.sample_budget = self._sample_budget()
        # occupancy update batches and the sensor cascade RGBD -> ToF/USS
        # (reference: modules/occupancy_grid.py:107-180)
        self.b_ray = max(1, int(og.batch_size * og.batch_ratio_ray_update))
        self.b_nerf = max(1, og.batch_size - int(
            og.batch_size * og.batch_ratio_ray_update
        ))
        sensors = t.sensors
        if "RGBD" in sensors:
            self.ray_sel, self.nerf_sel = ("random", "RGBD"), ("random", "RGBD")
        elif "ToF" in sensors and "USS" in sensors:
            self.ray_sel, self.nerf_sel = ("valid_tof", "ToF"), ("valid_uss", "USS")
        elif "ToF" in sensors:
            self.ray_sel, self.nerf_sel = ("valid_tof", "ToF"), ("valid_tof", "ToF")
        elif "USS" in sensors:
            self.ray_sel, self.nerf_sel = ("valid_uss", "USS"), ("valid_uss", "USS")
        else:
            raise ValueError("occupancy grid needs at least one depth sensor")
        self.logs: Dict[str, list] = {"time": [], "step": []}

    def _sample_budget(self) -> Optional[int]:
        """The compacted-sample budget, or None for the dense layout.  As
        the JAX trainer (trainer.py:222-243): "auto" (None) compacts
        constant-dt configs (``exp_step_factor == 0``) to 32 samples per
        ray and leaves exponential-stepping ones dense; 0 opts out."""
        t = self.cfg.training
        budget = t.sample_budget
        if budget is None:
            dense = self.cfg.exp_step_factor != 0.0
            budget = 0 if dense else t.batch_size * min(32, t.max_samples_per_ray)
        return budget if budget > 0 else None

    # ------------------------------------------------------------------ init
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Model, optimizer, grid and random stream from one seed."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.cfg.seed if seed is None else int(seed))
        model = NGPModel(**self.model_kwargs, generator=g, device=self.device)
        optimizer = FusedAdam(model.parameters(), lr=self.cfg.training.lr,
                              eps=1e-15)
        grid = occ_grid_init(self.occ_hp, generator=g, device=self.device)
        return TrainState(model=model, optimizer=optimizer, grid=grid,
                          generator=g)

    # ------------------------------------------------------------ train step
    def train_step(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """Draw a batch and the march jitter, then one step."""
        t = self.cfg.training
        batch = sample_batch(self.train_dataset, state.generator,
                             t.batch_size, t.sampling_strategy)
        noise = torch.rand((t.batch_size,), generator=state.generator,
                           device=self.device)
        return self.train_step_on(state, batch, noise)

    def train_step_on(self, state: TrainState, batch: Batch,
                      noise) -> Dict[str, torch.Tensor]:
        """One step on a given batch and march jitter; returns the step's
        metrics as 0-dim device tensors."""
        t = self.cfg.training
        results = render_rays(
            state.model, state.grid.occ_bool, batch.rays_o, batch.rays_d,
            noise, exp_step_factor=self.cfg.exp_step_factor,
            max_samples=t.max_samples_per_ray,
            n_candidates=t.march_candidates,
            march_resolution=t.march_resolution,
            sample_budget=self.sample_budget,
        )
        loss, loss_dict = compute_loss(
            results, batch, self.loss_weights, tuple(t.sensors)
        )
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            metrics = {
                "loss": loss.detach(),
                **{f"loss_{k}": v.detach() for k, v in loss_dict.items()},
                "psnr": -10.0 * torch.log10(
                    torch.mean((results["rgb"].detach() - batch.rgb) ** 2)
                ),
                "rm_samples": results["rm_samples"],
                "vr_samples": results["vr_samples"],
                "overflow": results["overflow"],
            }
        return metrics

    # ------------------------------------------------------------ grid update
    def grid_update(self, state: TrainState) -> None:
        """Draw the two update batches and the position noise, then one
        VIRUS grid update."""
        ds, g = self.train_dataset, state.generator
        ray_b = sample_batch(ds, g, self.b_ray,
                             {"imgs": "all", "pixs": self.ray_sel[0]})
        nerf_b = sample_batch(ds, g, self.b_nerf,
                              {"imgs": "all", "pixs": self.nerf_sel[0]})
        noise = torch.rand((self.b_nerf, self.occ_hp.M, 3), generator=g,
                           device=self.device) * 2.0 - 1.0
        self.grid_update_on(state, ray_b, nerf_b, noise)

    def grid_update_on(self, state: TrainState, ray_b: Batch, nerf_b: Batch,
                       nerf_noise) -> None:
        """One grid update on given batches and NeRF position noise."""
        with torch.no_grad():
            state.grid = occ_grid_update(
                state.grid, self.occ_hp, state.model.density,
                ray_batch={"rays_o": ray_b.rays_o, "rays_d": ray_b.rays_d,
                           "meas": ray_b.depths[self.ray_sel[1]]},
                nerf_batch={"rays_o": nerf_b.rays_o, "rays_d": nerf_b.rays_d,
                            "meas": nerf_b.depths[self.nerf_sel[1]]},
                nerf_noise=nerf_noise,
            )

    # ------------------------------------------------------------------ train
    def train(self, state: Optional[TrainState] = None) -> TrainState:
        """Run until ``training.max_steps`` or ``training.max_time``
        (checked once per chunk); grid update every interval, before the
        step."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        chunk = max(1, cfg.evaluation.eval_every_n_steps)
        tic = time.time()
        pending = []
        while state.step < cfg.training.max_steps:
            if state.step % self.grid_update_interval == 0:
                self.grid_update(state)
            pending.append((state.step, self.train_step(state)))
            if len(pending) == chunk or state.step == cfg.training.max_steps:
                self._log_chunk(pending, tic)
                pending = []
                if time.time() - tic > cfg.training.max_time:
                    logger.info("max_time reached at step %d", state.step)
                    break
        return state

    def _log_chunk(self, pending, tic: float) -> None:
        """One device -> host transfer for all metrics of the chunk."""
        keys = [k for k in METRIC_KEYS if k in pending[0][1]]
        vals = torch.stack([
            torch.stack([m[k].float() for k in keys]) for _, m in pending
        ]).cpu().numpy()
        now = time.time() - tic
        for (step, _), row in zip(pending, vals):
            self.logs["time"].append(now)
            self.logs["step"].append(step)
            for k, v in zip(keys, row):
                self.logs.setdefault(k, []).append(float(v))
        last = dict(zip(keys, vals[-1]))
        logger.info(
            "step %5d | loss %.4f | psnr %.2f | rm %d | vr %d",
            pending[-1][0], last["loss"], last["psnr"],
            int(last["rm_samples"]), int(last["vr_samples"]),
        )
