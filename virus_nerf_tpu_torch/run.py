"""Train + evaluate one experiment: ``python -m virus_nerf_tpu_torch.run``.

Counterpart of ``virus_nerf_tpu/run.py`` (reference: run.py:1-14) with the
same flags plus ``--device``: train the configured model on the configured
dataset, evaluate it on the test split, and write into ``--save-dir``
``model.npz`` (with ``model.npz.json``), ``logs.csv``, ``hparams.json``,
``metrics.csv`` and ``renders/{rgb,rgb_gt,depth}_###.png``; with
``evaluation.plot_results`` also the plots: ``maps/``, ``metrics.png``,
``curves.png`` and ``occgrids/occgrid.png`` (matplotlib needed; without
it the run raises ImportError before it trains).  The config JSON is the
reference's schema, so one file configures both packages.

Runs on ``cuda`` unless ``--device cpu`` is passed; without a card it
raises.  The datasets are "synthetic", "ETHZ" and "RH2"
(``dataset.name``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Tuple

import numpy as np

from virus_nerf_tpu_torch.configs.config import (
    Config,
    apply_cli_overrides,
    load_config,
)
from virus_nerf_tpu_torch.data import make_dataset
from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
from virus_nerf_tpu_torch.grids.occupancy_grid import (
    OccGridState,
    occ_grid_refresh_bitfield,
)
from virus_nerf_tpu_torch.training.trainer import Trainer
from virus_nerf_tpu_torch.utils.helpers import require_matplotlib


def train_and_evaluate(
    cfg: Config,
    datasets: Optional[Tuple] = None,
    save_dir: Optional[str] = None,
    plot: Optional[bool] = None,
    device="cuda",
) -> Dict[str, dict]:
    """Build the datasets (unless ``datasets`` =
    ((train_ds, scene, info), (test_ds, scene, info)) shares them across
    runs), train, evaluate, and with ``save_dir`` write the checkpoint,
    the logs, the config, the metrics and the renders
    (virus_nerf_tpu/run.py:26-111), and with ``plot`` (default
    ``evaluation.plot_results``) the plots.  Returns the metrics keyed by
    sensor."""
    do_plot = plot if plot is not None else cfg.evaluation.plot_results
    if do_plot and save_dir:
        require_matplotlib()
    if datasets is None:
        train = make_dataset(cfg, "train", device=device)
        test = make_dataset(cfg, "test", scene=train[1], device=device)
    else:
        train, test = datasets
    train_ds, scene, _ = train
    test_ds, _, test_info = test
    img_wh = test_info.get("img_wh")

    trainer = Trainer(cfg, train_ds, scene=scene, device=train_ds.device,
                      test_dataset=test_ds, img_wh=img_wh)
    state = trainer.train()
    evaluator = Evaluator(cfg, test_ds, scene, img_wh=img_wh,
                          device=trainer.device)
    metrics = evaluator.evaluate(state.model, state.grid.occ_bool,
                                 save_dir=save_dir, plot=bool(do_plot))
    if save_dir:
        trainer.save_checkpoint(state, os.path.join(save_dir, "model.npz"))
        trainer.save_logs(os.path.join(save_dir, "logs.csv"))
        cfg.save_json(os.path.join(save_dir, "hparams.json"))
        if do_plot:
            plot_run(trainer, state, scene, save_dir)
    return metrics


def plot_run(trainer: Trainer, state, scene, save_dir: str) -> None:
    """``curves.png`` (loss, PSNR, mean NND) and, on the VIRUS grid,
    ``occgrids/occgrid.png``: the slice at the training poses' mean height
    beside the GT slice, after the Morton bitfield's refresh and its
    round-trip check (virus_nerf_tpu/run.py:69-110)."""
    from virus_nerf_tpu_torch.evaluation.plots import (
        plot_occ_grid_slice,
        plot_training_curves,
    )

    cfg = trainer.cfg
    plot_training_curves(trainer.logs, os.path.join(save_dir, "curves.png"))
    if not isinstance(state.grid, OccGridState):
        return
    bitfield = occ_grid_refresh_bitfield(state.grid, trainer.occ_hp)
    gs, scale = cfg.model.grid_size, cfg.model.scale
    height_c = float(np.mean(trainer.train_dataset.poses[:, 2, 3].cpu().numpy()))
    h_idx = int(np.clip(round((height_c + scale) / (2 * scale) * (gs - 1)),
                        0, gs - 1))
    gt_slice = scene.get_slice_map(
        float(scene.c2w(np.array([[0, 0, height_c]]))[0, 2]),
        gs, cfg.evaluation.height_tolerance, height_in_world_coord=True,
    )
    extent = scene.c2w(
        np.array([[-scale, -scale], [scale, scale]])
    ).T.flatten()
    plot_occ_grid_slice(
        state.grid.occ_3d_grid.cpu().numpy(), gs, height_idx=h_idx,
        gt_slice=gt_slice,
        path=os.path.join(save_dir, "occgrids", "occgrid.png"),
        extent=extent, bitfield=bitfield.cpu().numpy(),
        occ_bool=state.grid.occ_bool.cpu().numpy(),
    )


def main(argv=None) -> Dict[str, dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None, help="experiment JSON")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--override", action="append", default=[], metavar="GROUP.KEY=VALUE",
        help="config override, e.g. ethz.dataset_dir=/data/ethz "
             "(repeatable; values parsed as JSON when possible)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    cfg = load_config(args.config) if args.config else Config()
    if args.seed is not None:
        cfg.seed = args.seed
    apply_cli_overrides(cfg, args.override)
    save_dir = args.save_dir or cfg.make_save_dir()
    metrics = train_and_evaluate(cfg, save_dir=save_dir, device=args.device)
    nerf = metrics.get("NeRF", {})
    mnn = nerf.get("nn_mean", {}).get("zone3", np.nan)
    print(
        f"evaluation: psnr={nerf.get('psnr', np.nan):.2f} | "
        f"ssim={nerf.get('ssim', np.nan):.3f} | depth_mnn={mnn:.3f}"
    )
    return metrics


if __name__ == "__main__":
    main()
