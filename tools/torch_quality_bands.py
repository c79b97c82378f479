"""5-seed quality bands of the port's quality run on one card.

Runs ``virus_nerf_tpu_torch.quality_run`` (2000 steps, 28 samples a ray
by default) for every band and seed in one process, through
``Trainer.train`` (its chunks as CUDA graphs), and prints each run's NeRF
NND zone 3 (m), PSNR, training rays/s and evaluation seconds, then each
band's mean and sample standard deviation (ddof 1, as PERF.md's earlier
bands) beside the card's name and power limit.  The runs' JSON lines go
to ``--out`` as well.

    python tools/torch_quality_bands.py [--bands 8x4,mixed,bfloat16] \
        [--seeds 21,7,42,3,11] [--steps 2000] [--out results/quality_bands.json]

Bands: ``8x4`` (the bench layout, float32: ``--hash-levels 8
--hash-feats 4``), ``mixed`` and ``bfloat16`` (16 x 2 slabs+factors in
that mode); ``slabs`` (the same in float32).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from virus_nerf_tpu_torch import quality_run  # noqa: E402

_SLABS = ["--hash-levels", "16", "--hash-feats", "2", "--hash-forward",
          "slabs", "--hash-backward", "factors"]
BANDS = {
    "8x4": ["--hash-levels", "8", "--hash-feats", "4"],
    "slabs": _SLABS,
    "mixed": _SLABS + ["--dtype", "mixed"],
    "bfloat16": _SLABS + ["--dtype", "bfloat16"],
}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bands", default="8x4,mixed,bfloat16")
    p.add_argument("--seeds", default="21,7,42,3,11")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--samples-per-ray", type=int, default=28)
    p.add_argument("--out", default="results/quality_bands.json")
    args = p.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = {}
    with open(args.out, "w") as f:
        for band in args.bands.split(","):
            runs = []
            for seed in seeds:
                qargs = quality_run.parse_args(
                    [*BANDS[band], "--steps", str(args.steps),
                     "--samples-per-ray", str(args.samples_per_ray),
                     "--seed", str(seed)])
                out, _, _ = quality_run.run(qargs)
                out["band"] = band
                f.write(json.dumps(out) + "\n")
                f.flush()
                runs.append(out)
                print(f"{band} seed {seed}: NeRF nn_mean z3 "
                      f"{out['NeRF']['nn_mean_zone3']:.4f} m, psnr "
                      f"{out['psnr']:.3f}, train {out['train_rays_per_sec']} "
                      f"rays/s, eval {out['eval_seconds']:.2f} s", flush=True)
            nnd = np.array([r["NeRF"]["nn_mean_zone3"] for r in runs])
            psnr = np.array([r["psnr"] for r in runs])
            rate = [r["train_rays_per_sec"] for r in runs]
            summary[band] = {"nnd_z3": nnd.tolist(), "mean": float(nnd.mean()),
                             "std": float(nnd.std(ddof=1)),
                             "psnr_mean": float(psnr.mean()),
                             "psnr_std": float(psnr.std(ddof=1)),
                             "train_rays_per_sec": [min(rate), max(rate)]}
            print(f"band {band}: NeRF nn_mean z3 {nnd.mean():.3f} +- "
                  f"{nnd.std(ddof=1):.3f} m over seeds {seeds}; psnr "
                  f"{psnr.mean():.2f} +- {psnr.std(ddof=1):.2f}; train rays/s "
                  f"{min(rate)}-{max(rate)}; on {card}", flush=True)
    print(json.dumps({"card": card, "bands": summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
