"""Seeded ablation runs: ``python -m virus_nerf_tpu_torch.run_ablation``.

Counterpart of ``virus_nerf_tpu/run_ablation.py`` (reference:
run_ablation.py:12-68): N seeded runs into ``<base_dir>/seed_<k>``,
restart-safe (a seed directory holding ``metrics.csv`` is done and
skipped), stopping early when the card's free memory runs low.
"""

from __future__ import annotations

import argparse
import os

from virus_nerf_tpu_torch.configs.config import Config, load_config
from virus_nerf_tpu_torch.data import make_dataset
from virus_nerf_tpu_torch.run import train_and_evaluate
from virus_nerf_tpu_torch.utils import check_device_memory


def run_ablation(cfg: Config, base_dir: str, num_trainings: int = 10,
                 base_seed: int = 21, device="cuda") -> int:
    """Run the remaining seeds; returns how many are done
    (reference: run_ablation.py:19-65).  The datasets are built once."""
    os.makedirs(base_dir, exist_ok=True)
    train = make_dataset(cfg, "train", device=device)
    test = make_dataset(cfg, "test", scene=train[1], device=device)

    done = 0
    for i in range(num_trainings):
        seed = base_seed + i
        save_dir = os.path.join(base_dir, f"seed_{seed}")
        if os.path.exists(os.path.join(save_dir, "metrics.csv")):
            done += 1
            continue
        train_and_evaluate(cfg.replace(seed=seed), datasets=(train, test),
                           save_dir=save_dir)
        done += 1
        if check_device_memory(device=device):
            print("stopping ablation: device memory low")
            break
    return done


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None)
    p.add_argument("--base-dir", required=True)
    p.add_argument("--num-trainings", type=int, default=10)
    p.add_argument("--base-seed", type=int, default=21)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = load_config(args.config) if args.config else Config()
    n = run_ablation(cfg, args.base_dir, args.num_trainings, args.base_seed,
                     device=args.device)
    print(f"ablation: {n}/{args.num_trainings} seeds complete")


if __name__ == "__main__":
    main()
