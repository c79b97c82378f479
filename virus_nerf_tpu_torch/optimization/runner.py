"""Hyper-parameter optimization runner: PSO over whole training runs.

The port's copy of ``virus_nerf_tpu/optimization/runner.py`` on the
port's ``Config``.  Counterpart of the reference's
run_optimization.py:15-139: per PSO iteration, patch the experiment config
with the particle's hyper-parameters, run a full train + evaluate, and
feed back the mapping score (mean NND of the NeRF scan vs GT, zone3).
Datasets are built once and shared across particles
(run_optimization.py:44-52).

- config patching is functional (``apply_hparams`` returns a new Config),
- crash/resume state is a single atomic JSON (see optimization/pso.py),
- ``run_optimization(..., batch_eval=f)`` uses the batch-synchronous swarm
  (ask_all/tell_all) with a caller-provided evaluation of all positions,
- ``run_worker`` is one worker of a leased pool sharing the state.

Runs are seeded as in the JAX package: ``seed + t + 1`` for the t-th
evaluation of the sequential swarm, ``seed + particle + 1`` for a worker's.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np

from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.optimization.pso import MultiWorkerPSO, PSOWrapper

logger = logging.getLogger("virus_nerf_tpu_torch")


def apply_hparams(cfg: Config, group_dict: Dict[str, Dict[str, float]]) -> Config:
    """Return a new Config with the particle's hyper-parameters applied,
    replicating the reference's patching rules
    (reference: run_optimization.py:80-104):

    - ``pixs_valid_uss``/``pixs_valid_tof`` become the pixel sampling
      strategy, renormalized when their sum exceeds 1,
    - ``occ_grid.update_interval``/``decay_warmup_steps`` and
      ``ToF.tof_pix_size`` are rounded to ints,
    - everything else is set verbatim on its group.
    """
    cfg = copy.deepcopy(cfg)
    gd = {g: dict(p) for g, p in group_dict.items()}

    tr = gd.get("training", {})
    if "pixs_valid_uss" in tr or "pixs_valid_tof" in tr:
        uss = float(tr.pop("pixs_valid_uss", 0.0))
        tof = float(tr.pop("pixs_valid_tof", 0.0))
        total = uss + tof
        if total > 1.0:
            total = np.ceil(100 * total) / 100
            uss, tof = uss / total, tof / total
        cfg.training.sampling_strategy = {
            "imgs": "all",
            "pixs": {"valid_uss": uss, "valid_tof": tof},
        }
    for key, value in tr.items():
        setattr(cfg.training, key, value)

    for key, value in gd.get("occ_grid", {}).items():
        if key in ("update_interval", "decay_warmup_steps"):
            value = int(np.round(value))
        setattr(cfg.occ_grid, key, value)

    for key, value in gd.get("ToF", {}).items():
        if key == "tof_pix_size":
            value = int(np.round(value))
        setattr(cfg.tof, key, value)

    for group, params in gd.items():
        if group in ("training", "occ_grid", "ToF"):
            continue
        target = getattr(cfg, group.lower(), None)
        if target is None:
            raise ValueError(f"unknown hparam group {group}")
        for key, value in params.items():
            setattr(target, key, value)
    return cfg


def score_from_metrics(metrics_dict: dict) -> float:
    """PSO objective: mean NND of the NeRF scan over all depths
    (reference: run_optimization.py:123-125)."""
    try:
        score = float(metrics_dict["NeRF"]["nn_mean"]["zone3"])
    except (KeyError, TypeError):
        return float("inf")
    return score if np.isfinite(score) else float("inf")


def run_optimization(
    base_cfg: Config,
    hparams_lims,
    save_dir: str,
    train_and_eval: Callable[[Config, int], dict],
    T: float = 36000.0,
    termination_by_time: bool = True,
    rng: Optional[np.random.Generator] = None,
    max_iters: Optional[int] = None,
    batch_eval: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> PSOWrapper:
    """Drive PSO to convergence (or termination).

    Args:
        base_cfg: experiment config to patch per particle.
        hparams_lims: {group: {param: [min, max]}} dict or JSON path.
        save_dir: state directory (resumable across process restarts).
        train_and_eval: (cfg, iteration) -> metrics_dict; typically builds a
            Trainer on shared datasets, trains, and evaluates.
        T: budget — seconds (termination_by_time) or iterations.
        max_iters: hard cap on iterations this process runs (for tests).
        batch_eval: optional (N, M)-positions -> (N,) scores parallel
            evaluator; switches to the batch-synchronous swarm.
    Returns:
        the PSOWrapper (with .best_hparams / .best_score).
    """
    pso = PSOWrapper(
        hparams_lims, save_dir, T,
        termination_by_time=termination_by_time, rng=rng,
    )

    if batch_eval is not None:
        it = 0
        while not pso.terminated() and (max_iters is None or it < max_iters):
            positions = pso.pso.ask_all()
            scores = np.asarray(batch_eval(positions), np.float64)
            pso.pso.tell_all(scores)
            pso.pso.state.elapsed = (
                time.time() - pso.time_start
            ) + pso._loaded_elapsed()
            pso._save()
            it += 1
        return pso

    it = 0
    terminate = False
    while not terminate and (max_iters is None or it < max_iters):
        it += 1
        group_dict = pso.get_next_hparams(group_dict_layout=True)
        cfg = apply_hparams(base_cfg, group_dict)
        cfg.seed = base_cfg.seed + pso.pso.state.t + 1  # fresh seed per run
        logger.info(
            f"PSO iter {pso.pso.state.t + 1} particle {pso.pso.state.n} "
            f"best={pso.best_score:.4f}"
        )
        metrics = train_and_eval(cfg, it)
        terminate = pso.update(score_from_metrics(metrics))
    return pso


def run_worker(
    base_cfg: Config,
    hparams_lims,
    save_dir: str,
    train_and_eval: Callable[[Config, int], dict],
    worker: str,
    T: float = 36000.0,
    termination_by_time: bool = True,
    lease_ttl: float = 3600.0,
    max_iters: Optional[int] = None,
    idle_wait: float = 1.0,
    seed: int = 21,
):
    """One PSO worker process: claim → train+evaluate → complete, until the
    shared budget is exhausted.

    Particles run as independent training processes coordinated only
    through the leased swarm state (:class:`MultiWorkerPSO`).  Launch N
    copies with distinct ``worker`` ids and the same ``save_dir``; any of
    them may be killed and relaunched (the lease TTL re-queues its
    particle), which replaces the reference's watch_optimization.py
    relaunch loop.

    Returns the :class:`MultiWorkerPSO` handle (with .best_hparams/.best_score).
    """
    pool = MultiWorkerPSO(
        hparams_lims, save_dir, worker=worker, T=T,
        termination_by_time=termination_by_time, lease_ttl=lease_ttl,
        seed=seed,
    )
    it = 0
    while max_iters is None or it < max_iters:
        work = pool.claim()
        if work is None:
            if pool.terminated():
                break
            time.sleep(idle_wait)  # all particles leased: wait for a slot
            continue
        it += 1
        cfg = apply_hparams(base_cfg, work["hparams"])
        cfg.seed = base_cfg.seed + work["particle"] + 1
        logger.info(
            f"PSO worker {worker}: particle {work['particle']} "
            f"(exploring={work['exploring']})"
        )
        metrics = train_and_eval(cfg, it)
        pool.complete(work["particle"], score_from_metrics(metrics))
    return pool
