"""Data-parallel training of the port over 1 and N cards (NCCL), timed.

    python tools/torch_dp_scaling.py [--world N] [--config bench|scale1]

For one rank and for ``--world`` ranks (default: every card), spawns one
process a card (``virus_nerf_tpu_torch.parallel.spawn_ranks``), trains
``chip_smoke.bench_config()`` (or its scale-1.0 variant) through
``make_dp_train_chunk`` on a NCCL group: 8 warm-up steps (the step-0 grid
update and the first launches), then 16 timed steps (host clock after a
device sync and a barrier; grid updates at steps 8 and 16), then checks
that every rank's parameters, Adam moments and grid are bit-identical.
The global batch stays 4096 rays, so each of N ranks draws 4096 / N.
Prints one JSON line a world size and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank(rank, world, init_method, config):
    import torch.distributed as dist

    from chip_smoke import bench_config, scale1_config
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.parallel import (
        make_dp_train_chunk,
        make_mesh,
        replica_mismatches,
    )
    from virus_nerf_tpu_torch.training.trainer import Trainer

    dev = torch.device("cuda", rank)
    mesh = make_mesh(world, rank=rank, device=dev, backend="nccl",
                     init_method=init_method)
    cfg = bench_config() if config == "bench" else scale1_config()
    dataset, scene, _ = make_synthetic_dataset(n_images=16, img_wh=(160, 120),
                                               device=dev)
    trainer = Trainer(cfg, dataset, scene=scene, device=dev)
    state = trainer.init_state()
    chunk = make_dp_train_chunk(trainer, mesh, 8)
    chunk(state)  # warm-up
    torch.cuda.synchronize(dev)
    dist.barrier()
    tic = time.perf_counter()
    losses = []
    for _ in range(2):
        losses += chunk(state)["loss"].tolist()
    torch.cuda.synchronize(dev)
    dist.barrier()
    seconds = time.perf_counter() - tic
    return {"ms_per_step": seconds / 16 * 1e3, "losses": losses,
            "mismatches": replica_mismatches(state, mesh),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def main(argv=None) -> None:
    from virus_nerf_tpu_torch.parallel import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=torch.cuda.device_count())
    ap.add_argument("--config", choices=["bench", "scale1"], default="bench")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or args.world < 1:
        sys.exit("needs CUDA cards")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    for world in sorted({1, args.world}):
        results = spawn_ranks(_rank, world, args=(args.config,), timeout=900)
        ms = [r["ms_per_step"] for r in results]
        replicas = all(not r["mismatches"] for r in results) and all(
            r["losses"] == results[0]["losses"] for r in results)
        print(json.dumps({
            "world": world, "config": args.config, "rays_per_step": 4096,
            "ms_per_step": max(ms), "rays_per_s": 4096 / (max(ms) / 1e3),
            "ms_per_step_by_rank": ms, "replicas_bit_identical": replicas,
            "mismatches": [r["mismatches"] for r in results],
            "peak_gib_by_rank": [r["peak_gib"] for r in results],
            "loss_last": results[0]["losses"][-1],
        }), flush=True)
        if not replicas:
            sys.exit(f"world {world}: replicas diverged")
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
