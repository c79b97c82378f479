"""Population parallelism: evaluate a whole PSO swarm at once.

Counterpart of ``virus_nerf_tpu/parallel/population.py:1-156``.  The
reference evaluates one particle at a time, a full train and evaluation a
PSO step (run_optimization.py:105-127).  Every particle's training run is
independent, so all N particles of a batch-synchronous PSO iteration
(``ParticleSwarmOptimization.ask_all``/``tell_all``) run together, one
card each, ``devices[i % len(devices)]``.

Each particle gets its own ``Trainer`` (the hyper-parameters change the
run's shapes: sampling slot counts, update intervals), its dataset on its
device, and a seed ``base.seed + 1000 * call + i``.  The launch phase runs
chunk k of every particle before chunk k+1 of any, each through its
trainer's ``make_train_chunk`` (on the card, replays of the particle's own
CUDA graphs, one memory pool a particle: the JAX package's jitted chunk a
particle, dispatched asynchronously, population.py:103-135); CUDA launches
are asynchronous, so each card works through its queue while the host
launches the others' chunks.  The harvest phase then scores each
particle: a non-finite last loss gives ``inf``, else the NeRF depth
evaluation on every test image through ``score_from_metrics``.

A chunk is ``min(max_steps, eval_every_n_steps)`` steps with the grid
update before every step whose index is a multiple of the interval, so a
particle makes the draws of ``Trainer.train`` on its config and scores as
that serial run does.  (The JAX chunk runs the NGP grid's update without
its warm-up; the port keeps the warm-up, as its own ``train`` does.)
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data.dataset import DeviceDataset, dataset_to

logger = logging.getLogger("virus_nerf_tpu_torch")


def population_devices(n: Optional[int] = None) -> List[torch.device]:
    """The cards, ``n`` of them (all when None); raises without enough."""
    have = torch.cuda.device_count()
    if n is not None and have < n:
        raise ValueError(f"need {n} cards, have {have}")
    if have == 0:
        raise ValueError("no CUDA device: pass devices=[torch.device('cpu')]")
    return [torch.device("cuda", i) for i in range(have if n is None else n)]


def particle_configs(base_cfg: Config, space, positions: np.ndarray,
                     call: int) -> List[Config]:
    """The configs of a swarm's particles at the ``call``-th evaluation
    (from 1): ``apply_hparams`` of each position, seeded ``base.seed +
    1000 * call + i`` (population.py:93-97)."""
    from virus_nerf_tpu_torch.optimization.runner import apply_hparams

    cfgs = []
    for i, pos in enumerate(positions):
        cfg = apply_hparams(base_cfg, space.to_group_dict(pos))
        cfg.seed = base_cfg.seed + 1000 * call + i
        cfgs.append(cfg)
    return cfgs


def make_population_eval(
    base_cfg: Config,
    space,
    datasets: Tuple,
    devices: Optional[Sequence] = None,
    score_fn: Optional[Callable] = None,
) -> Callable[[np.ndarray], np.ndarray]:
    """Build the ``batch_eval`` hook of ``run_optimization``.

    Args:
        base_cfg: experiment config; each particle patches it through
            ``apply_hparams`` (the serial path's rules).
        space: ``HParamSpace`` mapping swarm positions to hparam groups.
        datasets: ((train_ds, scene, info), (test_ds, scene, info)),
            shared by the particles (reference: run_optimization.py:44-52).
        devices: one per concurrent particle (cycled when the swarm is
            bigger); default ``population_devices()``, every card.
        score_fn: metrics -> float; default ``score_from_metrics`` (mean
            NeRF NND, zone 3, run_optimization.py:123-125).
    Returns:
        batch_eval: (N, M) positions -> (N,) scores.
    """
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.optimization.runner import score_from_metrics
    from virus_nerf_tpu_torch.training.trainer import Trainer

    if score_fn is None:
        score_fn = score_from_metrics
    (train_ds, scene, _), (test_ds, _, test_info) = datasets
    devices = [torch.device(d) for d in
               (population_devices() if devices is None else devices)]
    on_device = {}

    def train_on(dev) -> DeviceDataset:
        if dev not in on_device:
            on_device[dev] = dataset_to(train_ds, dev)
        return on_device[dev]

    calls = [0]

    def batch_eval(positions: np.ndarray) -> np.ndarray:
        n = positions.shape[0]
        calls[0] += 1
        # setup: a Trainer and an initial state a particle, on its device
        parts = []
        for i, cfg in enumerate(particle_configs(base_cfg, space, positions,
                                                 calls[0])):
            dev = devices[i % len(devices)]
            trainer = Trainer(cfg, train_on(dev), scene=scene, device=dev)
            chunk = max(1, min(cfg.training.max_steps,
                               cfg.evaluation.eval_every_n_steps))
            parts.append(dict(dev=dev, trainer=trainer,
                              state=trainer.init_state(), chunk=chunk,
                              last=None))

        # launch phase: chunk k of every particle before chunk k+1 of any
        while any(p["state"].step < p["trainer"].cfg.training.max_steps
                  for p in parts):
            for p in parts:
                tr = p["trainer"]
                k = min(p["chunk"], tr.cfg.training.max_steps - p["state"].step)
                if k > 0:
                    ets = (np.zeros(k, np.float32)
                           if tr.cfg.training.real_time_simulation else None)
                    _, keys, m = tr.make_train_chunk(k)(p["state"], ets)
                    p["last"] = m[-1, keys.index("loss")]

        # harvest phase: wait for each particle's result, then score it
        scores = np.full(n, np.inf)
        for i, p in enumerate(parts):
            loss = float(p["last"])
            if not np.isfinite(loss):
                logger.warning("particle %d: non-finite loss, score=inf", i)
                continue
            ev = Evaluator(p["trainer"].cfg, test_ds, scene,
                           img_wh=test_info.get("img_wh"), device=p["dev"])
            metrics, _ = ev.evaluate_depth(
                p["state"].model, p["state"].grid.occ_bool,
                np.arange(test_ds.n_images), sensors=("NeRF",))
            scores[i] = score_fn(metrics)
        return scores

    return batch_eval
