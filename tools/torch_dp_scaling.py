"""Data-parallel training of the port over 1 and N cards (NCCL), timed.

    python tools/torch_dp_scaling.py [--world N] [--config bench|scale1]

For one rank and for ``--world`` ranks (default: every card), spawns one
process a card (``virus_nerf_tpu_torch.parallel.spawn_ranks``), trains
``chip_smoke.bench_config()`` (or its scale-1.0 variant) on a NCCL group
two ways from one seed: through ``make_dp_train_chunk`` (CUDA graphs
with the collectives inside) and eagerly (``Trainer.run_steps`` over the
group).  Each takes 16 warm-up steps (the graphs' warm-up and capture),
then 16 timed steps four times in turns graphed, eager, eager, graphed
(host clock after a device sync and a barrier).  Then every rank's
parameters, Adam moments and grid are checked bit-identical, and in
PyTorch's deterministic mode 16 graphed steps are held bit for bit
against 16 eager ones (``chip_smoke.dp_graph_against_eager``).  The
global batch stays 4096 rays, so each of N ranks draws 4096 / N.  Prints
one JSON line a world size and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank(rank, world, init_method, config):
    import torch.distributed as dist

    from chip_smoke import (
        bench_config,
        deterministic,
        dp_graph_against_eager,
        kernel_wrappers,
        scale1_config,
    )
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.parallel import (
        make_dp_train_chunk,
        make_mesh,
        replica_mismatches,
        shard_state,
    )
    from virus_nerf_tpu_torch.training.trainer import Trainer

    wrappers = kernel_wrappers()
    dev = torch.device("cuda", rank)
    mesh = make_mesh(world, rank=rank, device=dev, backend="nccl",
                     init_method=init_method)
    cfg = bench_config() if config == "bench" else scale1_config()
    dataset, scene, _ = make_synthetic_dataset(n_images=16, img_wh=(160, 120),
                                               device=dev)
    trainer = Trainer(cfg, dataset, scene=scene, device=dev)
    graph, eager = (shard_state(trainer.init_state(), mesh) for _ in range(2))
    chunk = make_dp_train_chunk(trainer, mesh, 8)
    runs = {"graph": lambda: chunk(graph)["loss"],
            "eager": lambda: torch.stack([
                m["loss"] for _, m in trainer.run_steps(eager, 8,
                                                        group=mesh.group)])}
    for run in runs.values():  # warm-up: 16 steps, the graphs captured
        run(), run()
    ms = {"graph": [], "eager": []}
    losses = []
    for kind in ("graph", "eager", "eager", "graph"):
        torch.cuda.synchronize(dev)
        dist.barrier()
        tic = time.perf_counter()
        out = [runs[kind](), runs[kind]()]
        torch.cuda.synchronize(dev)
        dist.barrier()
        ms[kind].append((time.perf_counter() - tic) / 16 * 1e3)
        if kind == "graph":
            losses += torch.cat(out).tolist()
    mismatches = replica_mismatches(graph, mesh)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del graph, eager, runs, chunk
    with deterministic():  # fails the rank on a difference
        dp_graph_against_eager(f"rank {rank} of {world}", trainer, mesh,
                               (8, 8), wrappers)
    return {"ms_per_step": ms["graph"], "eager_ms_per_step": ms["eager"],
            "losses": losses, "mismatches": mismatches, "peak_gib": peak}


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
        # a step's time: the slowest rank's, the mean of its two turns
        ms = max(np.mean(r["ms_per_step"]) for r in results)
        eager = max(np.mean(r["eager_ms_per_step"]) for r in results)
        replicas = all(not r["mismatches"] for r in results) and all(
            r["losses"] == results[0]["losses"] for r in results)
        print(json.dumps({
            "world": world, "config": args.config, "rays_per_step": 4096,
            "ms_per_step": ms, "rays_per_s": 4096 / (ms / 1e3),
            "eager_ms_per_step": eager,
            "eager_rays_per_s": 4096 / (eager / 1e3),
            "ms_per_step_by_rank": [r["ms_per_step"] for r in results],
            "eager_ms_per_step_by_rank": [r["eager_ms_per_step"]
                                          for r in results],
            "graph_bit_identical_to_eager": True,
            "replicas_bit_identical": replicas,
            "mismatches": [r["mismatches"] for r in results],
            "peak_gib_by_rank": [r["peak_gib"] for r in results],
            "loss_last": results[0]["losses"][-1],
        }), flush=True)
        if not replicas:
            sys.exit(f"world {world}: replicas diverged")
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
