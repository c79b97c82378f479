"""The port's bench: steady-state training throughput (rays/s) on one card.

Counterpart of the JAX package's ``bench.py`` (:301-385): the bench
configuration (the reference's ETHZ camera + USS + ToF budget at batch
4096, the VIRUS grid updated every 8 steps, the 8-level x F=4 hash of 2^19
rows, a 28-sample-a-ray budget), 288 warm-up steps (the grid reaches its
steady sparsity by then), then 8 chunks of 24 steps (192) timed by the
host clock, closed by a ``float`` of the last loss, grid updates included.
Each chunk is ``Trainer.make_train_chunk``'s: replays of CUDA graphs on
the card.  ``vs_baseline`` is against the reference's implied
500 * 4096 / 45 rays/s; ``kernels_ok`` is ``ops.kernel_checks.check_kernels``
(B1-B5 and L1 against their plain versions), run first.

    python -m virus_nerf_tpu_torch.bench [--scale 0.5] [--levels 8] [--feats 4]

The flags take the place of ``VNERF_BENCH_SCALE/LEVELS/FEATS``.  It runs
on the card and raises without one; it prints the card's name and power
limit, then ONE JSON line ``{"metric", "value", "unit", "vs_baseline",
"kernels_ok"}``.  :func:`run_bench` runs the protocol on any device (on
the CPU ``kernels_ok`` is None).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from virus_nerf_tpu_torch.configs.config import Config

# the reference's implied throughput: 500 steps x 4096 rays / 45 s
BASELINE_RAYS_PER_SEC = 500 * 4096 / 45.0
CHUNK = 24  # steps a chunk: 3 grid-update intervals of 8
WARMUP_STEPS = 288
TIMED_CHUNKS = 200 // CHUNK  # 8 chunks, 192 steps


def bench_config(scale: float = 0.5, levels: int = 8, feats: int = 4) -> Config:
    """``bench.py``'s configuration (:311-348)."""
    cfg = Config()
    cfg.model.grid_type = "occ"
    cfg.model.grid_size = 128
    cfg.model.scale = float(scale)
    cfg.model.hash_levels = int(levels)
    cfg.model.hash_features_per_level = int(feats)
    cfg.model.hash_log2_T = 19
    cfg.model.hash_max_res = 1024
    cfg.training.batch_size = 4096
    cfg.training.max_samples_per_ray = 128
    cfg.training.march_candidates = 1024
    cfg.training.sample_budget = 4096 * 28
    cfg.training.sampling_strategy = {
        "imgs": "all", "pixs": {"valid_uss": 0.4, "valid_tof": 0.4},
    }
    cfg.training.sensors = ["USS", "ToF"]
    cfg.occ_grid.batch_size = 1024
    cfg.occ_grid.update_interval = 8
    return cfg


def run_bench(cfg: Config, warmup_steps: int = WARMUP_STEPS,
              timed_chunks: int = TIMED_CHUNKS, device="cuda",
              chunk: int = CHUNK) -> dict:
    """The bench's protocol on ``device``: the synthetic scene (16 images
    at 160x120), ``warmup_steps`` steps, then ``timed_chunks`` chunks of
    ``chunk`` steps by the host clock; returns the JSON line's dict."""
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.ops.kernel_checks import check_kernels
    from virus_nerf_tpu_torch.training.trainer import Trainer

    device = torch.device(device)
    kernels_ok = check_kernels(device) if device.type == "cuda" else None
    dataset, scene, _ = make_synthetic_dataset(n_images=16, img_wh=(160, 120),
                                               device=device)
    trainer = Trainer(cfg, dataset, scene=scene, device=device)
    state = trainer.init_state()
    train_chunk = trainer.make_train_chunk(chunk)
    for _ in range(warmup_steps // chunk):
        _, keys, metrics = train_chunk(state)
    if warmup_steps >= chunk:
        float(metrics[-1, keys.index("loss")])  # the warm-up has run
    tic = time.perf_counter()
    for _ in range(timed_chunks):
        _, keys, metrics = train_chunk(state)
    loss = float(metrics[-1, keys.index("loss")])  # waits for the chain
    toc = time.perf_counter()
    if loss != loss:
        raise FloatingPointError("bench: non-finite loss")
    rays_per_sec = timed_chunks * chunk * cfg.training.batch_size / (toc - tic)
    return {
        "metric": "train_rays_per_sec",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3),
        "kernels_ok": kernels_ok,
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Steady-state training rays/s of the bench configuration "
                    "on one card.")
    p.add_argument("--scale", type=float, default=0.5,
                   help="model.scale (1.0: two cascades, exponential steps)")
    p.add_argument("--levels", type=int, default=8, help="hash levels")
    p.add_argument("--feats", type=int, default=4, help="features a level")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("virus_nerf_tpu_torch.bench runs on a CUDA card; "
                           "none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else torch.cuda.get_device_name(0), flush=True)
    out = run_bench(bench_config(args.scale, args.levels, args.feats))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
