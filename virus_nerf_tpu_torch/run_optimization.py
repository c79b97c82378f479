"""PSO hyper-parameter search: ``python -m virus_nerf_tpu_torch.run_optimization``.

Counterpart of ``virus_nerf_tpu/run_optimization.py`` (reference:
run_optimization.py:15-139 + watch_optimization.py:13-27) with the same
flags plus ``--device``: per iteration a particle's hyper-parameters are
applied to the config, a full train + evaluate runs on datasets built
once, and the mapping score (NeRF mean NND, zone3) updates the swarm.
Swarm state is a single atomic JSON in ``--save-dir``, so re-running this
command after any crash resumes mid-swarm.  With ``--worker-id`` the
process is one worker of a leased pool sharing ``--save-dir``.

Runs on ``cuda`` unless ``--device cpu`` is passed; without a card it
raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from virus_nerf_tpu_torch.configs.config import (
    Config,
    apply_cli_overrides,
    load_config,
)
from virus_nerf_tpu_torch.data import make_dataset
from virus_nerf_tpu_torch.optimization import run_optimization, run_worker
from virus_nerf_tpu_torch.run import train_and_evaluate
from virus_nerf_tpu_torch.utils import check_device_memory

# default search space (reference: optimization/hparams_lims.json)
DEFAULT_LIMS = {
    "training": {
        "pixs_valid_uss": [0.0, 0.9],
        "pixs_valid_tof": [0.0, 0.9],
        "tof_loss_w": [0.1, 400.0],
        "uss_loss_w": [0.1, 400.0],
        "color_loss_w": [0.1, 10.0],
    },
    "occ_grid": {
        "update_interval": [2.0, 32.0],
        "decay_warmup_steps": [32.0, 96.0],
        "batch_ratio_ray_update": [0.1, 0.9],
        "false_detection_prob_every_m": [0.1, 0.3],
        "std_every_m": [0.05, 0.5],
        "nerf_pos_noise_every_m": [0.05, 0.5],
        "nerf_threshold_max": [0.1, 9.0],
        "nerf_threshold_slope": [0.08, 0.32],
    },
    "ToF": {"tof_pix_size": [1.0, 16.0]},
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None)
    p.add_argument("--hparams-lims", default=None, help="search-space JSON")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--T", type=float, default=36000.0,
                   help="wall-time budget in seconds (reference: T=36000)")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--worker-id", default=None,
                   help="run as ONE worker of a pool sharing --save-dir "
                        "(launch several with distinct ids)")
    p.add_argument("--lease-ttl", type=float, default=3600.0,
                   help="seconds before a worker's claimed particle is "
                        "re-queued (worker mode)")
    p.add_argument(
        "--override", action="append", default=[], metavar="GROUP.KEY=VALUE",
        help="config override, e.g. training.max_steps=500 (repeatable)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    cfg = load_config(args.config) if args.config else Config()
    apply_cli_overrides(cfg, args.override)
    lims = args.hparams_lims or DEFAULT_LIMS

    # datasets built ONCE, reused across particles
    # (reference: run_optimization.py:44-52)
    train = make_dataset(cfg, "train", device=args.device)
    test = make_dataset(cfg, "test", scene=train[1], device=args.device)

    def objective(run_cfg, iteration):
        metrics = train_and_evaluate(run_cfg, datasets=(train, test),
                                     device=args.device)
        if check_device_memory(device=args.device):
            raise RuntimeError("device memory low — resumable state saved")
        return metrics

    if args.worker_id is not None:
        pso = run_worker(
            cfg, lims, args.save_dir, objective,
            worker=args.worker_id, T=args.T, termination_by_time=True,
            lease_ttl=args.lease_ttl, max_iters=args.max_iters,
            seed=cfg.seed,
        )
    else:
        pso = run_optimization(
            cfg, lims, args.save_dir, objective,
            T=args.T, termination_by_time=True,
            rng=np.random.default_rng(cfg.seed),
            max_iters=args.max_iters,
        )
    print(f"best score: {pso.best_score:.4f}")
    print(f"best hparams: {pso.best_hparams}")
    return pso


if __name__ == "__main__":
    main()
