"""Quality run of the port: train the synthetic scene, then score the map.

    python -m virus_nerf_tpu_torch.quality_run --hash-variant xor \\
        --hash-levels 16 --hash-feats 2 [--steps 2000] [--device cuda]
    python -m virus_nerf_tpu_torch.quality_run --hash-levels 16 \\
        --hash-feats 2 --hash-forward slabs --hash-backward factors \\
        [--dtype mixed|bfloat16]

Counterpart of ``tools/quality_run.py`` with the same flags and the same
JSON keys, plus ``device`` (the card's name, or "cpu"), ``eval_seconds``
and the port's choices ``hash_forward``, ``hash_backward`` (the additive
hash's routes, ``ops/hash_encoder.py``) and ``dtype`` (the compute mode,
``model.dtype``).  It trains the bench synthetic scene (24 images at
160x120, every third image held out) and records PSNR/SSIM and the zone
NND of the NeRF, ToF and USS scans on the held-out images (reference score:
run_optimization.py:123-125, mean NND of the NeRF scan, zone 3).  It runs
on ``--device`` (default ``cuda``; without a card it fails).

``--save-renders DIR`` writes the evaluation's ``metrics.csv`` and colour
renders into DIR (``DIR/renders/``), and with ``--eval-occ both`` the
all-ones renders into ``DIR/renders_ones/``, as the JAX tool does
(tools/quality_run.py:185-193).  One difference from the JAX tool:
``--force-full-hier`` changes nothing, since the port's march always
probes every candidate (the uncompacted path that flag forces in JAX) and
is only recorded in the JSON.  The JSON goes to
``--out`` (default ``results/quality.json`` under the repository root).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data.dataset import DeviceDataset
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
from virus_nerf_tpu_torch.training.trainer import Trainer

_DEFAULT_OUT = Path(__file__).resolve().parent.parent / "results" / "quality.json"


def subset(ds: DeviceDataset, sel: np.ndarray) -> DeviceDataset:
    """The images ``sel`` (bool mask) of a dataset."""
    idx = torch.as_tensor(np.where(sel)[0], device=ds.device)
    return ds._replace(
        poses=ds.poses[idx], cam_idx=ds.cam_idx[idx], rgbs=ds.rgbs[idx],
        depths={k: v[idx] for k, v in ds.depths.items()},
        times=ds.times[idx], sensor_ids=ds.sensor_ids[idx],
    )


def quality_config(args) -> Config:
    """The quality run's configuration (tools/quality_run.py:92-122)."""
    cfg = Config()
    cfg.seed = args.seed
    cfg.model.hash_variant = args.hash_variant
    cfg.model.dtype = args.dtype
    cfg.model.grid_type = "occ"
    cfg.model.grid_size = 128
    cfg.model.hash_levels = args.hash_levels
    cfg.model.hash_features_per_level = args.hash_feats
    cfg.model.hash_log2_T = args.hash_log2t
    cfg.model.hash_max_res = 1024
    cfg.training.batch_size = args.batch_size
    cfg.training.max_samples_per_ray = args.max_samples
    cfg.training.march_candidates = args.march_resolution
    cfg.training.march_resolution = args.march_resolution
    cfg.training.sample_budget = args.batch_size * args.samples_per_ray
    # larger batches train the same TOTAL rays in fewer steps
    cfg.training.max_steps = max(1, args.steps * 4096 // args.batch_size)
    cfg.training.max_time = 1e9
    cfg.training.sampling_strategy = {
        "imgs": "all",
        "pixs": {"valid_uss": 0.4, "valid_tof": 0.4},
    }
    cfg.training.sensors = ["USS", "ToF"]
    cfg.occ_grid.batch_size = 1024
    cfg.occ_grid.update_interval = 8
    cfg.evaluation.eval_every_n_steps = args.eval_every
    cfg.evaluation.num_depth_pts_per_step = 0
    cfg.evaluation.res_angular = 512
    cfg.evaluation.res_map = 256
    cfg.evaluation.batch_size = 8192
    cfg.evaluation.max_samples_per_ray = 256
    return cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--out", default=str(_DEFAULT_OUT))
    p.add_argument("--eval-every", type=int, default=25,
                   help="steps per chunk of fetched training metrics")
    p.add_argument("--hash-variant", default="additive",
                   choices=["additive", "xor"],
                   help="additive-vs-XOR quality ablation knob")
    p.add_argument("--samples-per-ray", type=int, default=32,
                   help="compaction budget per ray")
    p.add_argument("--max-samples", type=int, default=128,
                   help="march per-ray cap S")
    p.add_argument("--march-resolution", type=int, default=1024,
                   help="marching quadrature dt = sqrt(3)/res")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="rays per step (steps scale down to keep total rays)")
    p.add_argument("--hash-forward", default="corners",
                   choices=["corners", "slabs"],
                   help="additive hash forward: 8 corner rows, or one row of "
                        "the widened slabs")
    p.add_argument("--hash-backward", default="product",
                   choices=["product", "factors"],
                   help="additive hash backward: the (8F, K) product stream, "
                        "or the bf16 (8 + F, K) factor stream")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "mixed", "bfloat16"],
                   help="compute mode (model.dtype)")
    p.add_argument("--hash-levels", type=int, default=8)
    p.add_argument("--hash-feats", type=int, default=4,
                   help="features a level: on the card 1, 2, 4 or 8 for "
                   "the corners forward (H1's widths; the model refuses "
                   "another at load), any on the CPU")
    p.add_argument("--hash-log2t", type=int, default=19)
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--save-renders", default=None, metavar="DIR",
                   help="write metrics.csv and the test renders into DIR")
    p.add_argument("--eval-occ", default="grid",
                   choices=["grid", "ones", "both"],
                   help="occupancy for the test renders: the trained grid, "
                        "all ones, or both (headline from the grid plus a "
                        "colour-only row from all ones)")
    p.add_argument("--force-full-hier", action="store_true",
                   help="recorded only: the port's march is always the "
                        "uncompacted one")
    p.add_argument("--curve-every", type=int, default=0, metavar="STEPS",
                   help="train in STEPS-sized segments and record (step, "
                        "train seconds, NeRF nn_mean zone3) after each")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args):
    """Train, evaluate, and return (the result record, the trainer, the
    final train state)."""
    dev = torch.device(args.device)
    cfg = quality_config(args)
    dataset, scene, info = make_synthetic_dataset(
        n_images=24, img_wh=(160, 120), device=dev
    )
    sel_train = np.arange(24) % 3 != 0
    train_ds = subset(dataset, sel_train)
    test_ds = subset(dataset, ~sel_train)
    trainer = Trainer(cfg, train_ds, scene=scene, device=dev,
                      hash_forward=args.hash_forward,
                      hash_backward=args.hash_backward)
    ev = Evaluator(cfg, test_ds, scene, img_wh=info["img_wh"],
                   device=trainer.device)
    test_idxs = np.arange(test_ds.n_images)

    state = trainer.init_state()
    total_steps = cfg.training.max_steps
    seg = total_steps
    if args.curve_every > 0:
        seg = max(1, args.curve_every * 4096 // args.batch_size)
    curve, train_s = [], 0.0
    while state.step < total_steps:
        cfg.training.max_steps = min(state.step + seg, total_steps)
        _sync(trainer.device)
        tic = time.time()
        state = trainer.train(state)
        _sync(trainer.device)
        train_s += time.time() - tic
        if args.curve_every > 0:
            m, _ = ev.evaluate_depth(state.model, state.grid.occ_bool,
                                     test_idxs, sensors=("GT", "NeRF"))
            curve.append({
                "step": int(state.step),
                "train_seconds": round(train_s, 2),
                "nn_mean_zone3": float(m["NeRF"]["nn_mean"]["zone3"]),
            })
            print(json.dumps(curve[-1]), flush=True)
    cfg.training.max_steps = total_steps
    steps = int(state.step)
    rays_per_sec = steps * cfg.training.batch_size / train_s

    occ = state.grid.occ_bool
    tic = time.time()
    metrics = ev.evaluate(
        state.model, torch.ones_like(occ) if args.eval_occ == "ones" else occ,
        depth_img_idxs=test_idxs, sensors=("GT", "NeRF", "ToF", "USS"),
        save_dir=args.save_renders,
    )
    color_ones = None
    if args.eval_occ == "both":
        save_ones = (os.path.join(args.save_renders, "renders_ones")
                     if args.save_renders else None)
        color_ones = ev.evaluate_color(state.model, torch.ones_like(occ),
                                       test_idxs, save_dir=save_ones)
    eval_s = time.time() - tic

    out = {
        "hash_variant": args.hash_variant,
        "hash_forward": args.hash_forward,
        "hash_backward": args.hash_backward,
        "dtype": args.dtype,
        "hash_levels": args.hash_levels,
        "hash_feats": args.hash_feats,
        "hash_log2t": args.hash_log2t,
        "samples_per_ray": args.samples_per_ray,
        "max_samples": args.max_samples,
        "march_resolution": args.march_resolution,
        "batch_size": args.batch_size,
        "seed": args.seed,
        "steps": steps,
        "train_seconds": round(train_s, 1),
        "train_rays_per_sec": round(rays_per_sec, 1),
        "psnr": float(metrics["NeRF"]["psnr"]),
        "ssim": float(metrics["NeRF"]["ssim"]),
        "eval_occ": args.eval_occ,
        "force_full_hier": bool(args.force_full_hier),
        "device": (torch.cuda.get_device_name(trainer.device)
                   if trainer.device.type == "cuda" else trainer.device.type),
        "eval_seconds": eval_s,
    }
    if color_ones is not None:
        out["psnr_occ_ones"] = float(color_ones["psnr"])
        out["ssim_occ_ones"] = float(color_ones["ssim"])
    if curve:
        out["quality_curve"] = curve
    for sensor in ("NeRF", "ToF", "USS"):
        m = metrics[sensor]
        out[sensor] = {
            "nn_mean_zone3": float(m["nn_mean"]["zone3"]),
            "nn_median_zone3": float(m["nn_median"]["zone3"]),
            "nn_inlier_zone3": float(m["nn_inlier"]["zone3"]),
            "nn_mean_inv_zone3": float(m["nn_mean_inv"]["zone3"]),
            "nn_mean_inv_360_zone3": float(m["nn_mean_inv_360"]["zone3"]),
        }
    return out, trainer, state


def main(argv=None) -> None:
    args = parse_args(argv)
    out, _, _ = run(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
