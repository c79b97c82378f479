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

A chunk runs through :meth:`Trainer.make_train_chunk`, the counterpart of
the JAX ``_make_train_chunk`` (trainer.py:428-519), which fuses a chunk
into one device program.  On the card a chunk is replays of at most three
CUDA graphs a state: the group (the grid update, then ``update_interval``
steps, as the JAX aligned scan), one step and one grid update (an
unaligned entry or a tail, as the JAX ``lax.cond`` path).  Each kind runs
eagerly the first time (the warm-up), is captured the second time and is
replayed from then on; on the CPU (and over a gloo group) the same bodies
run eagerly.  The bodies write the state's own tensors in place, so a
replay reads what the last one wrote.  The trainer keeps the graphs of
one state: another state, or one whose tensors or generators were rebound
(``run_steps``, a loaded checkpoint), gets new ones, so particles that
take turns on one trainer share one state, set in place for each
(:meth:`Trainer.reset_state`).
The loss reads its color, rgbd, ToF and USS weights from device memory
(``device_loss_weights``), so a graph takes the weights written before its
replay.  Under a NCCL ``group`` the collectives of the step and the grid
update are captured with the rest: the counterpart of the JAX
data-parallel chunk (virus_nerf_tpu/parallel/data_parallel.py:128-149).

Every training option of the JAX trainer is ported: the VIRUS ("occ") and
the NGP ("ngp") grid, the position encoders (the additive hash with its
routes ``hash_forward``/``hash_backward``, arguments of the trainer, the
XOR hash and the tri-plane grid), the ``float32``, ``mixed`` and
``bfloat16`` compute modes (``model.dtype``), constant-dt and
exponential-step marching (every scale), the distortion loss, every image
and pixel strategy ("closest" with its USS statistics in the state),
real-time simulation (the images of a batch are those taken by the host
clock's time since the loop started) and ``debug_mode``.

Data parallelism: the step and the grid update take a ``torch.distributed``
process ``group`` (``parallel/data_parallel.py`` builds it), the
counterpart of the JAX bodies' ``axis_name`` (trainer.py:199-334,
343-401): each rank draws its share of the batch from its own generator
(``TrainState.shard_generator``), gradients and metrics are all-reduced,
the USS statistics fold the batch gathered in rank order, and the VIRUS
grid's evidence is summed over the ranks.

With a ``test_dataset`` the loop scores the map at the end of every chunk
(the ``mnn`` column of ``logs``: the NeRF scans' mean NND in zone 3 on
``evaluation.num_depth_pts_per_step`` test images drawn with replacement
from ``numpy.random.default_rng(cfg.seed)``, trainer.py:756-779).  A chunk
is ``evaluation.eval_every_n_steps`` steps rounded down to a whole number
of grid-update intervals, as the JAX loop's (trainer.py:564-573).  The NGP
grid's warm-up runs step by step, as the JAX loop's ``_train_stepwise``
(trainer.py:704-743): up to the first multiple of the update interval at
or after ``ngp_grid.warmup_steps``, one row a step, scored after the steps
whose index is a multiple of ``eval_every_n_steps``, ``max_time`` checked
after every step.
It logs through ``utils.logging.make_logger`` as the JAX trainer does (a
coloured stream, and ``<save_dir>/log.txt`` when ``cfg.save_dir`` is set).
``save_logs`` writes the JAX package's ``logs.csv``; ``save_checkpoint`` /
``load_checkpoint`` keep the whole ``TrainState`` in one ``.npz``.

The NGP grid update runs every ``ngp_grid.update_interval`` steps, over
every cell while ``step < ngp_grid.warmup_steps`` (trainer.py:536-545,
704-745: the JAX trainer's step-wise warm-up and fused steady state run
the same updates at the same steps).
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data.dataset import Batch, DeviceDataset, sample_batch
from virus_nerf_tpu_torch.data.scene import Scene
from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
from virus_nerf_tpu_torch.data.uss_stats import (
    USSStats,
    uss_stats_init,
    uss_stats_update,
)
from virus_nerf_tpu_torch.grids.ngp_grid import (
    NGPGridState,
    ngp_cell_draws,
    ngp_grid_init,
    ngp_grid_update_on,
)
from virus_nerf_tpu_torch.grids.occupancy_grid import (
    OccGridHParams,
    OccGridState,
    occ_grid_init,
    occ_grid_update,
)
from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.models.renderer import render_rays
from virus_nerf_tpu_torch.ops.common import MAX_SAMPLES
from virus_nerf_tpu_torch.ops.fused_adam import FusedAdam
from virus_nerf_tpu_torch.ops.launch_counts import GraphLaunches
from virus_nerf_tpu_torch.training.loss import (
    LossWeights,
    compute_loss,
    weights_tensor,
    with_device_weights,
)
from virus_nerf_tpu_torch.utils.distributed import (
    all_gather_cat,
    all_reduce_grads_mean_,
    reduce_metrics,
    world_size,
)
from virus_nerf_tpu_torch.utils import tracing
from virus_nerf_tpu_torch.utils.logging import make_logger

METRIC_KEYS = (
    "loss", "loss_color", "loss_USS", "loss_ToF", "loss_rgbd",
    "loss_distortion", "loss_depth", "psnr", "rm_samples", "vr_samples",
    "overflow",
)

# the NGP grid's density threshold (reference: training/trainer.py:110)
NGP_DENSITY_THRESHOLD = 0.01 * MAX_SAMPLES / 3**0.5

# logs.csv: its column -> the ``logs`` key it is read from (the JAX
# trainer's columns, trainer.py:137-140)
LOG_COLUMNS = {"time": "time", "step": "step", "loss": "loss",
               "color_loss": "loss_color", "depth_loss": "loss_depth",
               "psnr": "psnr", "mnn": "mnn"}


@dataclass
class TrainState:
    """Everything a step changes: parameters (in ``model``), Adam moments
    and step count (in ``optimizer``), the grid, the random stream, the
    step and, for the "closest" pixel strategy, the USS statistics.  Under
    data parallelism over several ranks, ``shard_generator`` draws this
    rank's share of the batches (``generator`` then draws only what every
    rank draws alike: the NGP grid's cells); a checkpoint does not keep
    it."""

    model: NGPModel
    optimizer: FusedAdam
    grid: Union[OccGridState, NGPGridState]
    generator: torch.Generator
    step: int = 0
    uss_stats: Optional[USSStats] = None
    shard_generator: Optional[torch.Generator] = None


def _full_device(device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so two spellings of one card compare
    equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a step reads and writes: parameters, Adam moments and
    count, grid, USS statistics."""
    out = [state.optimizer.count]
    for p in state.model.parameters():
        out += [p, *state.optimizer._moments(p)]
    out += [x for x in state.grid if torch.is_tensor(x)]
    if state.uss_stats is not None:
        out += list(state.uss_stats)
    return out


def _write_into(old, new):
    """``new``'s tensors written into ``old``'s (a NamedTuple of the same
    shapes): ``old``'s tensors with ``new``'s values and ``new``'s other
    fields."""
    fields = []
    for o, n in zip(old, new):
        if torch.is_tensor(o):
            if n is not o:
                o.copy_(n)
            fields.append(o)
        else:
            fields.append(n)
    return type(old)(*fields)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    launches: GraphLaunches
    ets: Optional[torch.Tensor]  # the static elapse times it reads
    metrics: Optional[torch.Tensor]  # its static (steps, metrics) output


class _StateGraphs:
    """The CUDA graphs of one training state: keyed by the piece (kind,
    steps, process group, the host flags its body reads), made over the
    state's tensors at ``addresses`` and its generators, all in one memory
    pool (each replay's output is copied out before the next replay, and
    no graph reads memory another wrote)."""

    def __init__(self, state: TrainState):
        self.state = weakref.ref(state)
        self.addresses = [t.data_ptr() for t in _state_tensors(state)]
        self.generators = (state.generator, state.shard_generator)
        self.pool = None  # made at the first capture
        self.warm: set = set()  # pieces run eagerly once (the warm-up)
        self.graphs: Dict[tuple, _Graph] = {}

    def holds(self, state: TrainState) -> bool:
        return (self.state() is state
                and self.generators[0] is state.generator
                and self.generators[1] is state.shard_generator
                and self.addresses == [t.data_ptr()
                                       for t in _state_tensors(state)])


def _check_supported(cfg: Config) -> None:
    """Every option of the JAX trainer is ported: a value outside these
    is unknown (ValueError)."""
    known = {
        "model.grid_type": (cfg.model.grid_type, ("occ", "ngp")),
        "model.encoder_type": (cfg.model.encoder_type, ("hash", "triplane")),
        "model.hash_variant": (cfg.model.hash_variant, ("additive", "xor")),
        "model.dtype": (cfg.model.dtype, ("float32", "mixed", "bfloat16")),
    }
    for name, (have, want) in known.items():
        if have not in want:
            raise ValueError(f"Trainer: unknown {name}={have!r} (have {want!r})")


class Trainer:
    """Training loop around the model, the optimizer and the grid."""

    def __init__(self, cfg: Config, train_dataset: DeviceDataset,
                 scene: Optional[Scene] = None, device=None,
                 hash_forward: str = "corners", hash_backward: str = "product",
                 test_dataset: Optional[DeviceDataset] = None,
                 img_wh: Optional[tuple] = None):
        """``hash_forward`` / ``hash_backward``: the additive hash's routes
        (``hash_encode``); the compute mode is ``cfg.model.dtype``.  With
        ``training.debug_mode`` the camera directions must be unit vectors
        (AssertionError otherwise).  ``test_dataset`` (with ``scene``)
        turns on the intermediate evaluation; ``img_wh`` is the images'
        size, which the evaluator's field-of-view limits need."""
        _check_supported(cfg)
        self.cfg = cfg
        self.logger = make_logger(cfg)
        self.device = _full_device(
            train_dataset.device if device is None else device
        )
        if _full_device(train_dataset.device) != self.device:
            raise ValueError(
                f"dataset on {train_dataset.device}, trainer on {self.device}"
            )
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.scene = scene
        self.img_wh = img_wh
        self._evaluator = None
        self._eval_rng = np.random.default_rng(cfg.seed)
        # full float32 matrix products and convolutions on the card, and
        # float32 accumulation of bf16 products (the mixed/bfloat16 modes)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

        m = cfg.model
        self.model_kwargs = dict(
            scale=m.scale, pos_encoder_type=m.encoder_type, levels=m.hash_levels,
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
        # the weights the loss reads from device memory (``loss_weights``
        # writes them)
        self.device_loss_weights = torch.zeros(4, dtype=torch.float32,
                                               device=self.device)
        self.loss_weights = LossWeights(
            color=t.color_loss_w, rgbd=t.rgbd_loss_w, tof=t.tof_loss_w,
            uss=t.uss_loss_w, uss_depth_tol=float(0.03 * w2c),
            distortion=t.distortion_loss_w,
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
        # reference: training/trainer_base.py:84-90
        self.grid_update_interval = (
            og.update_interval if m.grid_type == "occ"
            else cfg.ngp_grid.update_interval
        )
        self.sample_budget = self._sample_budget()
        pixs = t.sampling_strategy.get("pixs", "random")
        self.uses_closest = (pixs == "closest" if isinstance(pixs, str)
                             else "closest" in pixs)
        # the USS field of view as a dense pixel mask ("closest")
        self.uss_mask = torch.zeros(
            train_dataset.n_pixels, dtype=torch.bool, device=self.device
        ).index_fill_(0, train_dataset.uss_mask_idx.long(), True)
        # occupancy update batches and the sensor cascade RGBD -> ToF/USS
        # (reference: modules/occupancy_grid.py:107-180)
        self._b_ray_all = int(og.batch_size * og.batch_ratio_ray_update)
        self._b_nerf_all = og.batch_size - self._b_ray_all
        self.b_ray, self.b_nerf = self.occ_batch_sizes(1)
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
        self.logs: Dict[str, list] = {"time": [], "step": [], "mnn": []}
        self._metric_keys: Optional[List[str]] = None
        self._metric_dtypes: Optional[List[torch.dtype]] = None
        self._graphs: Optional[_StateGraphs] = None
        self._graph_stream = None
        if t.debug_mode:
            self._debug_validate_dataset()

    @property
    def loss_weights(self) -> LossWeights:
        """The loss weights; setting them writes ``device_loss_weights``
        too (a copy from the host, so never inside a capture)."""
        return self._loss_weights

    @loss_weights.setter
    def loss_weights(self, weights: LossWeights) -> None:
        self._loss_weights = weights
        self.device_loss_weights.copy_(weights_tensor(weights, self.device))

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

    def occ_batch_sizes(self, world: int):
        """The VIRUS grid update's two batch sizes on each of ``world``
        ranks (trainer.py:352-356)."""
        return (max(1, self._b_ray_all // world),
                max(1, self._b_nerf_all // world))

    def _shard_budget(self, world: int) -> Optional[int]:
        """Each rank's share of the sample budget (trainer.py:240-243)."""
        if self.sample_budget is None or world == 1:
            return self.sample_budget
        return max(1, self.sample_budget // world)

    def _shard_batch(self, world: int) -> int:
        """Each rank's share of the batch (trainer.py:216-217)."""
        b = self.cfg.training.batch_size
        if b % world:
            raise ValueError(f"training.batch_size {b} is not a multiple of "
                             f"the {world} ranks")
        return b // world

    @staticmethod
    def _draws(state: TrainState, group) -> torch.Generator:
        """The generator of this rank's draws: the state's own on one rank,
        its ``shard_generator`` over several."""
        if world_size(group) == 1:
            return state.generator
        if state.shard_generator is None:
            raise ValueError("a data-parallel step needs the state's "
                             "shard_generator (parallel.shard_state)")
        return state.shard_generator

    # ------------------------------------------------------------------ init
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Model, optimizer, grid, random stream and (for "closest") the
        USS statistics from one seed."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.cfg.seed if seed is None else int(seed))
        model = NGPModel(**self.model_kwargs, generator=g, device=self.device)
        optimizer = FusedAdam(model.parameters(), lr=self.cfg.training.lr,
                              eps=1e-15)
        if self.cfg.model.grid_type == "occ":
            grid = occ_grid_init(self.occ_hp, generator=g, device=self.device)
        else:
            grid = ngp_grid_init(model.cascades, model.grid_size, self.device)
        uss_stats = None
        if self.uses_closest:
            # every image starts on the field of view's middle pixel
            # (trainer.py:158-168)
            idx = self.train_dataset.uss_mask_idx
            uss_stats = uss_stats_init(
                self.train_dataset.n_images, int(idx[idx.shape[0] // 2]),
                self.device,
            )
        return TrainState(model=model, optimizer=optimizer, grid=grid,
                          generator=g, uss_stats=uss_stats)

    def reset_state(self, state: TrainState, seed: Optional[int] = None
                    ) -> TrainState:
        """``state`` set in place to the values of ``init_state(seed)``:
        its tensors and generators keep their addresses, so the CUDA graphs
        made over it replay on (a swarm runs its particles in turns on one
        state).  A rank's shard generator is seeded anew by
        ``parallel.shard_state(state, mesh, reseed=True)``."""
        fresh = self.init_state(seed)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), fresh.model.parameters()):
                p.copy_(q)
                for m, n in zip(state.optimizer._moments(p),
                                fresh.optimizer._moments(q)):
                    m.copy_(n)
            state.optimizer.count.copy_(fresh.optimizer.count)
            state.grid = _write_into(state.grid, fresh.grid)
            if state.uss_stats is not None:
                state.uss_stats = _write_into(state.uss_stats, fresh.uss_stats)
        state.generator.set_state(fresh.generator.get_state())
        state.step = fresh.step
        return state

    def _elapse(self, elapse_time):
        """The image filter's time: ``elapse_time`` under
        ``real_time_simulation``, else None (every image)."""
        return elapse_time if self.cfg.training.real_time_simulation else None

    # ------------------------------------------------------------ train step
    def train_step(self, state: TrainState, elapse_time: Optional[float] = None,
                   group=None) -> Dict[str, torch.Tensor]:
        """Draw a batch and the march jitter, then one step.  Under
        ``real_time_simulation`` the batch comes from the images with
        ``times <= elapse_time`` (seconds since training started).  Under
        ``group`` this rank draws its share of the batch."""
        t = self.cfg.training
        g = self._draws(state, group)
        b = self._shard_batch(world_size(group))
        batch = sample_batch(
            self.train_dataset, g, b,
            t.sampling_strategy, elapse_time=self._elapse(elapse_time),
            uss_stats_pix=(state.uss_stats.min_pix if self.uses_closest
                           else None),
        )
        noise = torch.rand((b,), generator=g, device=self.device)
        tracing.stamp("sample", self.device)
        return self.train_step_on(state, batch, noise, group)

    def train_step_on(self, state: TrainState, batch: Batch, noise,
                      group=None) -> Dict[str, torch.Tensor]:
        """One step on a given batch and march jitter; returns the step's
        metrics as 0-dim device tensors.  With "closest" sampling it folds
        the batch's rendered depths into the USS statistics.  Under
        ``group`` the batch is this rank's share: the gradients are
        averaged over the ranks before Adam, the metrics summed (sample
        counts) or averaged, and the statistics fold the batch gathered in
        rank order (trainer.py:277-322)."""
        t = self.cfg.training
        results = render_rays(
            state.model, state.grid.occ_bool, batch.rays_o, batch.rays_d,
            noise, exp_step_factor=self.cfg.exp_step_factor,
            max_samples=t.max_samples_per_ray,
            n_candidates=t.march_candidates,
            march_resolution=t.march_resolution,
            sample_budget=self._shard_budget(world_size(group)),
            need_ws=self.loss_weights.distortion > 0.0, stamp_phases=True,
        )
        loss, loss_dict = compute_loss(
            results, batch,
            with_device_weights(self.loss_weights, self.device_loss_weights),
            tuple(t.sensors),
        )
        tracing.stamp("loss", self.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads_mean_(state.model.parameters(), group)
        tracing.stamp("backward", self.device)
        state.optimizer.step()
        tracing.stamp("adam", self.device)
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
            metrics = reduce_metrics(metrics, group)
            if self.uses_closest:
                state.uss_stats = uss_stats_update(
                    state.uss_stats, all_gather_cat(batch.img_idxs, group),
                    all_gather_cat(batch.pix_idxs, group),
                    all_gather_cat(results["depth"].detach(), group),
                    self.uss_mask,
                )
        tracing.stamp("stats", self.device)
        return metrics

    # ------------------------------------------------------------ grid update
    def grid_update(self, state: TrainState, elapse_time: Optional[float] = None,
                    group=None) -> None:
        """Draw, then one grid update.  VIRUS grid: the two update batches
        (under ``real_time_simulation`` from the images taken by
        ``elapse_time``) and the position noise, under ``group`` this
        rank's share of them; NGP grid: the cells and their jitter, every
        cell while ``step < ngp_grid.warmup_steps``, drawn alike on every
        rank from the state's own generator."""
        ds = self.train_dataset
        if self.cfg.model.grid_type == "ngp":
            draws = ngp_cell_draws(
                state.grid, state.generator,
                warmup=state.step < self.cfg.ngp_grid.warmup_steps,
                density_threshold=NGP_DENSITY_THRESHOLD,
                grid_size=state.model.grid_size,
            )
            self.ngp_update_on(state, draws)
            return
        et = self._elapse(elapse_time)
        g = self._draws(state, group)
        b_ray, b_nerf = self.occ_batch_sizes(world_size(group))
        ray_b = sample_batch(ds, g, b_ray,
                             {"imgs": "all", "pixs": self.ray_sel[0]}, et)
        nerf_b = sample_batch(ds, g, b_nerf,
                              {"imgs": "all", "pixs": self.nerf_sel[0]}, et)
        noise = torch.rand((b_nerf, self.occ_hp.M, 3), generator=g,
                           device=self.device) * 2.0 - 1.0
        self.grid_update_on(state, ray_b, nerf_b, noise, group)

    def ngp_update_on(self, state: TrainState, draws) -> None:
        """One NGP grid update at given draws (``ngp_cell_draws``)
        (trainer.py:403-426)."""
        with torch.no_grad():
            state.grid = ngp_grid_update_on(
                state.grid, state.model.density, draws,
                density_threshold=NGP_DENSITY_THRESHOLD,
                grid_size=state.model.grid_size, scale=state.model.scale,
            )

    def grid_update_on(self, state: TrainState, ray_b: Batch, nerf_b: Batch,
                       nerf_noise, group=None) -> None:
        """One grid update on given batches and NeRF position noise (under
        ``group``: this rank's shard of them, the evidence summed over the
        ranks)."""
        with torch.no_grad():
            state.grid = occ_grid_update(
                state.grid, self.occ_hp, state.model.density,
                ray_batch={"rays_o": ray_b.rays_o, "rays_d": ray_b.rays_d,
                           "meas": ray_b.depths[self.ray_sel[1]]},
                nerf_batch={"rays_o": nerf_b.rays_o, "rays_d": nerf_b.rays_d,
                            "meas": nerf_b.depths[self.nerf_sel[1]]},
                nerf_noise=nerf_noise, group=group,
            )

    def run_steps(self, state: TrainState, n_steps: int, elapse_time=None,
                  group=None):
        """``n_steps`` steps, the grid update before every step whose index
        is a multiple of the update interval (the JAX chunk body,
        trainer.py:475-511).  ``elapse_time``: None, seconds, or a
        function that reads them before each update and step.  Returns
        ``[(step, metrics), ...]``, the metrics on the device."""
        clock = elapse_time if callable(elapse_time) else (lambda: elapse_time)
        out = []
        for _ in range(n_steps):
            if state.step % self.grid_update_interval == 0:
                self.grid_update(state, clock(), group)
            out.append((state.step, self.train_step(state, clock(), group)))
        return out

    # ------------------------------------------------------------ the chunk
    def make_train_chunk(self, chunk_steps: int, group=None):
        """``chunk(state, elapse_times=None) -> (first step, metric names,
        (chunk_steps, metrics) device tensor)``: ``chunk_steps`` steps with
        the grid update before every step whose index is a multiple of the
        update interval, the semantics of :meth:`run_steps` (the JAX
        ``_make_train_chunk``, trainer.py:428-519).  ``elapse_times``: None
        or the seconds each step (and a grid update at it) filters images
        by under ``real_time_simulation`` (the JAX ``ets``).  ``group``:
        the process group of a data-parallel chunk (this rank's share of
        each batch, the collectives of :meth:`train_step_on` and
        :meth:`grid_update_on`).

        The chunk runs as pieces: a group (the grid update, then
        ``update_interval`` steps) at each interval-aligned step with a
        whole interval left, else single steps, each after a lone grid
        update where one falls.  On the card each piece kind is a CUDA
        graph (see the module doc; one stream of work, no fallback: a
        capture that fails raises), under a NCCL group with its
        collectives inside; on the CPU and over gloo the pieces run
        eagerly.  Metrics are stacked over the chunk as the JAX scan
        stacks them, in float32, which holds the sample counts exactly
        below 2^24 (a step's rays times ``max_samples_per_ray``; a larger
        configuration raises ValueError)."""
        if chunk_steps < 1:
            raise ValueError(f"make_train_chunk: want chunk_steps >= 1, got "
                             f"{chunk_steps}")
        t = self.cfg.training
        rays = t.batch_size
        if t.sampling_strategy.get("pixs") == "entire_img":
            rays = max(rays, self.train_dataset.n_pixels)
        if rays * t.max_samples_per_ray >= 2**24:
            raise ValueError(
                f"make_train_chunk: {rays} rays x {t.max_samples_per_ray} "
                f"samples a step: the float32 metrics hold counts below 2^24")

        def chunk(state: TrainState, elapse_times=None):
            first = state.step
            ets = (None if elapse_times is None
                   else np.asarray(elapse_times, np.float32).reshape(-1))
            if ets is not None and ets.shape[0] != chunk_steps:
                raise ValueError(f"chunk: want {chunk_steps} elapse times, got "
                                 f"{ets.shape[0]}")
            outs, i = [], 0
            with tracing.span("trainer.chunk"):
                for kind, n in self._pieces(state.step, chunk_steps):
                    outs.append(self._run_piece(
                        state, kind, n,
                        None if ets is None else ets[i:i + max(n, 1)], group))
                    i += n
                return first, self._metric_keys, torch.cat(
                    [m for m in outs if m is not None])

        return chunk

    def _pieces(self, step: int, n: int) -> List[Tuple[str, int]]:
        """The chunk's pieces from ``step``: ("group", interval), ("grid",
        0) or ("step", 1)."""
        interval, out = self.grid_update_interval, []
        while n > 0:
            if step % interval == 0 and n >= interval:
                out.append(("group", interval))
                step, n = step + interval, n - interval
                continue
            if step % interval == 0:
                out.append(("grid", 0))
            out.append(("step", 1))
            step, n = step + 1, n - 1
        return out

    def _piece_body(self, state: TrainState, kind: str, n: int, ets,
                    group=None):
        """A piece on the state's own tensors: the grid update (group and
        grid), then n steps; returns the (n, metrics) stacked metrics, or
        None for a lone grid update.  ``ets``: None or an (n,) tensor of
        elapse times (the grid update reads the first).  With the tracer on
        it stamps the ``between`` phase first and ``grid_update`` after the
        grid update."""
        tracing.stamp("between", self.device)
        if kind != "step":
            grid = state.grid
            self.grid_update(state, None if ets is None else ets[0], group)
            state.grid = _write_into(grid, state.grid)
            tracing.stamp("grid_update", self.device)
        rows = []
        for i in range(n):
            uss = state.uss_stats
            m = self.train_step(state, None if ets is None else ets[i], group)
            if uss is not None:
                state.uss_stats = _write_into(uss, state.uss_stats)
            keys = [k for k in METRIC_KEYS if k in m]
            self._metric_keys = keys
            self._metric_dtypes = [m[k].dtype for k in keys]
            rows.append(torch.stack([m[k].float() for k in keys]))
        return torch.stack(rows) if rows else None

    def _piece_flags(self, state: TrainState, kind: str) -> tuple:
        """The host values a piece's body branches on: the VIRUS update's
        warm-up decay, the NGP update's warm-up pass."""
        if kind == "step":
            return ()
        if isinstance(state.grid, OccGridState):
            return (state.grid.update_step + 1 <= self.occ_hp.decay_warmup_steps,)
        return (state.step < self.cfg.ngp_grid.warmup_steps,)

    def _advance(self, state: TrainState, kind: str, n: int) -> None:
        """The host counters a replayed piece moves: the step, and the
        VIRUS grid's update count."""
        state.step += n
        if kind != "step" and isinstance(state.grid, OccGridState):
            state.grid = state.grid._replace(
                update_step=state.grid.update_step + 1)

    def _graphed(self, group) -> bool:
        """Pieces run as CUDA graphs: on the card, alone or over NCCL (a
        gloo group's collectives go through the host)."""
        return self.device.type == "cuda" and (
            group is None or dist.get_backend(group) == "nccl")

    def state_graphs(self, state: TrainState) -> _StateGraphs:
        """``state``'s graph set: the trainer's, made anew (the old one
        dropped) for another state or one whose tensors or generators were
        rebound."""
        if self._graphs is None or not self._graphs.holds(state):
            self._graphs = _StateGraphs(state)
        return self._graphs

    @tracing.spanned("trainer.piece")
    def _run_piece(self, state: TrainState, kind: str, n: int, ets,
                   group=None):
        """One piece: eagerly off the card; on it the piece's warm-up, its
        capture or a replay of its graph, keyed by the piece, the host
        flags its body reads and whether the tracer is on (a stamped graph
        never stands in for an unstamped one)."""
        dev = self.device
        if not self._graphed(group):
            et = None if ets is None else torch.from_numpy(ets).to(dev)
            return self._piece_body(state, kind, n, et, group)
        graphs = self.state_graphs(state)
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(dev)
        stream, here = self._graph_stream, torch.cuda.current_stream(dev)
        key = ((kind, n, group) + self._piece_flags(state, kind)
               + (tracing.enabled(),))
        g = graphs.graphs.get(key)
        if g is None and key not in graphs.warm:
            # the warm-up: the piece eagerly, on the capture's stream (a
            # group's communicator and collectives run once before capture)
            with tracing.span("trainer.warm"):
                stream.wait_stream(here)
                with torch.cuda.stream(stream):
                    et = None if ets is None else torch.from_numpy(ets).to(dev)
                    out = self._piece_body(state, kind, n, et, group)
                here.wait_stream(stream)
            graphs.warm.add(key)
            return out
        if g is None:
            with tracing.span("trainer.capture"):
                g = graphs.graphs[key] = self._capture(state, graphs, kind, n,
                                                       ets, group)
        if ets is not None:
            g.ets.copy_(torch.from_numpy(ets).pin_memory(), non_blocking=True)
        g.graph.replay()
        g.launches.replays += 1
        self._advance(state, kind, n)
        return None if g.metrics is None else g.metrics.clone()

    def _capture(self, state: TrainState, graphs: _StateGraphs, kind: str,
                 n: int, ets, group=None) -> _Graph:
        """Capture a piece (PyTorch's whole-network recipe: gradients set
        to None first, so backward allocates them from the graph's pool);
        capture runs nothing on the card, so the host counters the body
        moved are set back.  Under a group the capture is thread-local:
        the communicator's watchdog thread keeps querying its events."""
        dev = self.device
        et = None if ets is None else torch.empty(
            ets.shape, dtype=torch.float32, device=dev)
        state.optimizer.zero_grad(set_to_none=True)
        step, grid = state.step, state.grid
        graph = torch.cuda.CUDAGraph()
        for gen in (state.generator, state.shard_generator):
            if gen is not None:
                graph.register_generator_state(gen)
        if graphs.pool is None:
            graphs.pool = torch.cuda.graph_pool_handle()
        launches = GraphLaunches()
        mode = "global" if group is None else "thread_local"
        with launches.capture(), torch.cuda.graph(
                graph, pool=graphs.pool, stream=self._graph_stream,
                capture_error_mode=mode):
            metrics = self._piece_body(state, kind, n, et, group)
        state.step, state.grid = step, grid
        return _Graph(graph, launches, et, metrics)

    # ------------------------------------------------------------------ train
    def train(self, state: Optional[TrainState] = None) -> TrainState:
        """Run until ``training.max_steps`` or ``training.max_time``; grid
        update every interval, before the step.  The NGP grid's warm-up
        runs step by step (see the module doc), the rest in chunks of
        :meth:`make_train_chunk` (CUDA graphs on the card), with
        ``max_time`` checked after each.  ``real_time_simulation`` reads
        the host clock before each warm-up step and, in a chunk, takes
        the clock at its start plus the measured seconds a step;
        ``debug_mode`` checks the state after each logged step or chunk
        (and may sync the host only there)."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        self.logger.info("----- START TRAINING -----")
        tic = time.time()
        self._train_loop(state, tic)
        self.logger.info(
            f"----- FINISHED TRAINING ----- {time.time() - tic:.2f}s, "
            f"iter: {state.step}"
        )
        return state

    def _train_loop(self, state: TrainState, tic: float) -> None:
        cfg = self.cfg
        if cfg.model.grid_type == "ngp":
            # trainer.py:536-547: step by step up to the first interval
            # multiple at or after the warm-up's end
            interval = self.grid_update_interval
            w = cfg.ngp_grid.warmup_steps
            switch = min(cfg.training.max_steps, -(-w // interval) * interval)
            if not self._train_stepwise(state, tic, switch):
                return
        self._train_chunks(state, tic)

    def _over_time(self, tic: float, step: int) -> bool:
        if time.time() - tic > self.cfg.training.max_time:
            self.logger.info(f"max_time reached at step {step}")
            return True
        return False

    def _train_stepwise(self, state: TrainState, tic: float, until: int) -> bool:
        """One logged row a step up to step ``until`` (trainer.py:704-743):
        the map scored after each step whose index is a multiple of
        ``eval_every_n_steps``, ``max_time`` checked after every step.
        Returns False when ``max_time`` ended the run."""
        cfg = self.cfg
        clock = lambda: time.time() - tic  # noqa: E731
        while state.step < until:
            (step, m), = self.run_steps(state, 1, clock)
            keys = [k for k in METRIC_KEYS if k in m]
            vals = torch.stack([m[k].float() for k in keys])[None].cpu().numpy()
            scored = step % cfg.evaluation.eval_every_n_steps == 0
            mnn = (self._intermediate_eval(state, clock()) if scored
                   else float("nan"))
            last = self._log_chunk(step, keys, vals, tic, mnn, quiet=not scored)
            if cfg.training.debug_mode:
                self._debug_check_state(state, last, state.step)
            if self._over_time(tic, state.step):
                return False
        return True

    def _train_chunks(self, state: TrainState, tic: float) -> None:
        """Chunks of ``eval_every_n_steps`` steps rounded down to whole
        grid-update intervals when the entry step is a multiple of one
        (trainer.py:556-656), each through :meth:`make_train_chunk`, the
        map scored after each.  Under ``real_time_simulation`` a chunk's
        steps take the host clock at its start plus the measured seconds a
        step (the last chunk's, the first chunk's excepted: its pieces run
        eagerly and are captured), as the JAX loop's ``ets``
        (trainer.py:574-601).  With ``training.profile_dir`` the tracer is
        on for the first two chunks (the first warms the stamped graphs
        up), and the second and the evaluation after it run
        under one ``torch.profiler`` session, as the JAX loop profiles its
        second chunk (trainer.py:619-627): see :meth:`_profiled`.  The
        tracer is put back as it was once the files are written."""
        cfg = self.cfg
        profile_dir = cfg.training.profile_dir
        was = tracing.enabled()
        tracing.enable(was or bool(profile_dir))
        max_steps = cfg.training.max_steps
        chunk = max(1, min(cfg.evaluation.eval_every_n_steps,
                           max_steps - state.step))
        interval = self.grid_update_interval
        if state.step % interval == 0 and chunk >= interval:
            chunk -= chunk % interval
        clock = lambda: time.time() - tic  # noqa: E731
        chunks, start, dt_est = {}, state.step, 0.0
        try:
            while state.step < max_steps:
                n = min(chunk, max_steps - state.step)
                if n not in chunks:
                    chunks[n] = self.make_train_chunk(n)
                t0 = clock()
                ets = (t0 + dt_est * np.arange(n)
                       if cfg.training.real_time_simulation else None)
                profiled = bool(profile_dir) and state.step > start
                with (self._profiled(profile_dir, state.step) if profiled
                      else contextlib.nullcontext()):
                    first, keys, metrics = chunks[n](state, ets)
                    vals = metrics.cpu().numpy()  # one transfer; waits
                    if first > start:
                        dt_est = (clock() - t0) / n
                    mnn = self._intermediate_eval(state, clock())
                if profiled:
                    profile_dir = None
                    tracing.enable(was)
                last = self._log_chunk(first, keys, vals, tic, mnn)
                if cfg.training.debug_mode:
                    self._debug_check_state(state, last, state.step)
                if self._over_time(tic, state.step):
                    break
        finally:
            tracing.enable(was)

    @contextlib.contextmanager
    def _profiled(self, profile_dir: str, step: int):
        """The body under ``torch.profiler`` (the card's activity too on a
        CUDA trainer), the tracer reset once the profiler has started;
        then writes the Chrome trace ``chunk_<step>.trace.json`` (the
        tracer's spans are ranges in it) and the tracer's readings,
        ``chunk_<step>.tracer.json`` (the chunk's phases and the
        evaluation's spans), to ``profile_dir``."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            tracing.reset()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        name = os.path.join(profile_dir, f"chunk_{step}")
        prof.export_chrome_trace(name + ".trace.json")
        with open(name + ".tracer.json", "w") as f:
            json.dump(tracing.snapshot(), f, indent=1)
        self.logger.info("profiled the chunk at step %d and its evaluation "
                         "into %s", step, profile_dir)

    # ------------------------------------------------------------ debug mode
    def _debug_check_state(self, state: TrainState, m: Dict[str, float],
                           step: int) -> None:
        """debug_mode's invariants (trainer.py:645-691): a finite loss and
        hash table, VIRUS probabilities in [0, 1] and the boolean grid
        their thresholding.  Raises FloatingPointError or AssertionError."""
        if not math.isfinite(m["loss"]):
            raise FloatingPointError(f"debug_mode: non-finite loss at {step}")
        if not bool(torch.isfinite(state.model.pos_table).all()):
            raise FloatingPointError(
                f"debug_mode: non-finite hash table at {step}"
            )
        if isinstance(state.grid, OccGridState):
            g = state.grid.occ_3d_grid
            lo, hi = float(g.min()), float(g.max())
            if not (0.0 <= lo and hi <= 1.0):
                raise FloatingPointError(
                    f"debug_mode: occupancy probs out of [0,1] at {step}: "
                    f"[{lo}, {hi}]"
                )
            mismatch = int((state.grid.occ_bool.reshape(-1)
                            != (g.reshape(-1) > self.occ_hp.threshold)).sum())
            if mismatch:
                raise AssertionError(
                    f"debug_mode: occ_bool/prob mismatch at {step}: "
                    f"{mismatch} cells"
                )

    def _debug_validate_dataset(self) -> None:
        """The camera directions are unit vectors (trainer.py:693-702;
        reference ray-norm check, datasets/dataset_base.py:236-241)."""
        norms = torch.linalg.norm(self.train_dataset.directions,
                                  dim=-1).cpu().numpy()
        if not np.allclose(norms, 1.0, atol=1e-4):
            raise AssertionError(
                "debug_mode: camera direction table not unit-norm "
                f"(range [{norms.min()}, {norms.max()}])"
            )

    # ------------------------------------------------ intermediate evaluation
    def _get_evaluator(self) -> Evaluator:
        if self._evaluator is None:
            self._evaluator = Evaluator(self.cfg, self.test_dataset, self.scene,
                                        img_wh=self.img_wh, device=self.device)
        return self._evaluator

    def _intermediate_eval(self, state: TrainState, elapse: float) -> float:
        """The NeRF scans' mean NND in zone 3 on
        ``num_depth_pts_per_step`` test images drawn with replacement,
        under ``real_time_simulation`` among those taken by ``elapse``
        (reference: training/trainer.py:274-302); NaN without a test set."""
        if self.test_dataset is None or self.scene is None:
            return float("nan")
        n_pts = int(self.cfg.evaluation.num_depth_pts_per_step)
        if n_pts <= 0:
            return float("nan")
        idxs = np.arange(self.test_dataset.n_images)
        if self.cfg.training.real_time_simulation:
            seen = idxs[self.test_dataset.times.cpu().numpy() <= elapse]
            if seen.size:
                idxs = seen
        sel = self._eval_rng.choice(idxs, size=min(n_pts, idxs.size),
                                    replace=True)
        metrics, _ = self._get_evaluator().evaluate_depth(
            state.model, state.grid.occ_bool, sel, sensors=("NeRF",))
        return float(metrics["NeRF"]["nn_mean"]["zone3"])

    def _log_chunk(self, first: int, keys, vals: np.ndarray, tic: float,
                   mnn: float = float("nan"), quiet: bool = False
                   ) -> Dict[str, float]:
        """The chunk's metrics ``vals`` (steps, ``keys``), on the host: one
        row a step from ``first``, ``mnn`` on the chunk's last row
        (trainer.py:781-809); returns the last step's metrics (logged
        unless ``quiet``)."""
        now = time.time() - tic
        for j, row in enumerate(vals):
            self.logs["time"].append(now)
            self.logs["step"].append(first + j)
            self.logs["mnn"].append(mnn if j == len(vals) - 1 else math.nan)
            for k, v in zip(keys, row):
                self.logs.setdefault(k, []).append(float(v))
        last = dict(zip(keys, vals[-1]))
        if not quiet:
            self.logger.info(
                "step %5d | loss %.4f | psnr %.2f | mnn %.3f | rm %d | vr %d",
                first + len(vals) - 1, last["loss"], last["psnr"], mnn,
                int(last["rm_samples"]), int(last["vr_samples"]),
            )
        return {k: float(v) for k, v in last.items()}

    def save_logs(self, path: str) -> None:
        """``logs.csv``: the JAX trainer's columns (time, step, loss,
        color_loss, depth_loss, psnr, mnn), one row a step (reference:
        training/trainer_base.py:170-181)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n = len(self.logs["step"])
        cols = [self.logs.get(key, [math.nan] * n) for key in LOG_COLUMNS.values()]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(list(LOG_COLUMNS))
            w.writerows(zip(*cols))

    # ------------------------------------------------------------ checkpoints
    def state_arrays(self, state: TrainState) -> Dict[str, np.ndarray]:
        """The state as numpy arrays keyed by the port's names: the
        parameters (``params.<name>``), the Adam step and moments
        (``adam.count``, ``adam.mu.<name>``, ``adam.nu.<name>``), the grid
        (``grid.<field>``), the USS statistics (``uss_stats.<field>``), the
        ``step`` and the random stream (``generator``).  bf16 tensors are
        stored as float32, which holds them exactly."""
        def host(x):
            if torch.is_tensor(x):
                x = x.detach()
                return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
            return np.asarray(x, np.int64)

        out = {"step": state.step, "adam.count": int(state.optimizer.count),
               "generator": state.generator.get_state()}
        for name, p in state.model.named_parameters():
            mu, nu = state.optimizer._moments(p)
            out.update({f"params.{name}": p, f"adam.mu.{name}": mu,
                        f"adam.nu.{name}": nu})
        for field, x in zip(state.grid._fields, state.grid):
            out[f"grid.{field}"] = x
        if state.uss_stats is not None:
            for field, x in zip(state.uss_stats._fields, state.uss_stats):
                out[f"uss_stats.{field}"] = x
        return {k: host(v) for k, v in out.items()}

    def save_checkpoint(self, state: TrainState, path: str) -> None:
        """The whole state (``state_arrays``) as one ``.npz``, the config
        beside it as ``<path>.json`` (trainer.py:811-825; the reference
        saves the weights only, training/trainer_base.py:155-168)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            np.savez(f, **self.state_arrays(state))
        with open(path + ".json", "w") as f:
            json.dump(self.cfg.to_dict(), f, indent=2)

    def load_checkpoint(self, path: str) -> TrainState:
        """A checkpoint loaded into a fresh ``init_state()``, built from the
        current config.  Every key, shape and dtype is checked against it
        first: a config that drifted since the save raises ValueError
        (trainer.py:827-857)."""
        state = self.init_state()
        want = self.state_arrays(state)
        with np.load(path, allow_pickle=False) as f:
            data = {k: f[k] for k in f.files}
        missing, extra = sorted(set(want) - set(data)), sorted(set(data) - set(want))
        if missing or extra:
            raise ValueError(f"checkpoint {path}: keys missing {missing}, "
                             f"unexpected {extra} (config drift?)")
        for k, w in want.items():
            a = data[k]
            if a.shape != w.shape or a.dtype != w.dtype:
                raise ValueError(
                    f"checkpoint {path}: {k} is {a.dtype}{list(a.shape)}, "
                    f"expected {w.dtype}{list(w.shape)} (config drift?)")

        def put(old, a):
            if torch.is_tensor(old):
                return torch.from_numpy(a).to(device=old.device, dtype=old.dtype)
            return int(a)

        with torch.no_grad():
            for name, p in state.model.named_parameters():
                p.copy_(put(p, data[f"params.{name}"]))
                for m, key in zip(state.optimizer._moments(p), ("mu", "nu")):
                    m.copy_(put(m, data[f"adam.{key}.{name}"]))
        state.optimizer.count.fill_(int(data["adam.count"]))
        state.grid = type(state.grid)(*(
            put(x, data[f"grid.{field}"])
            for field, x in zip(state.grid._fields, state.grid)))
        if state.uss_stats is not None:
            state.uss_stats = type(state.uss_stats)(*(
                put(x, data[f"uss_stats.{field}"])
                for field, x in zip(state.uss_stats._fields, state.uss_stats)))
        state.step = int(data["step"])
        state.generator.set_state(torch.from_numpy(data["generator"]))
        return state
