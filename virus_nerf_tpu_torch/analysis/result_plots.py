"""Result-directory analyses: calibration-error study + point-cloud maps.

Counterparts of the reference's offline result scripts
(reference: plotting/datasets/plot_calibration_error.py,
plotting/training/plot_pointclouds.py) and of
``virus_nerf_tpu/analysis/result_plots.py``, made data-driven: the reference
hardcodes its measured numbers inside the script; here they are the
defaults of a reusable function so new studies plot the same figure from
their own results.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from virus_nerf_tpu_torch.utils.helpers import require_matplotlib

# the reference's published ToF-calibration study results
# (reference: plotting/datasets/plot_calibration_error.py:6-10): mapping
# quality and convergence time as a function of injected angular
# calibration error on the ToF extrinsics
REF_CALIBRATION_STUDY = {
    "error_deg": [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0],
    "mnn": [0.1138471090, 0.1112342248, 0.098474841, 0.103809233,
            0.136416359, 0.176717544, 0.178960875, 0.230771927],
    "convergence_s": {
        "50%": [29.7748513222, 23.8469831944, 64.06387997, 54.52338767,
                51.33528614, 21.23815727, 21.24396801, 21.22101927],
        "25%": [83.0932226181, 50.1289546490, 74.48167086, 68.98784113,
                58.90571499, 27.11833215, 69.07346869, 69.75696516],
        "10%": [110.2548644543, 85.0339004993, 77.9802444, 94.47088695,
                105.5333767, 0.0, 118.6691425, 119.8912277],
    },
}


def plot_calibration_error(
    out_path: str,
    error_deg: Optional[Sequence[float]] = None,
    mnn: Optional[Sequence[float]] = None,
    convergence_s: Optional[Dict[str, Sequence[float]]] = None,
) -> str:
    """Two-panel bar chart: mean NND and convergence time (to 50/25/10% of
    the final metric) vs injected angular calibration error
    (reference: plotting/datasets/plot_calibration_error.py).  Defaults to
    the reference's published study numbers."""
    plt = require_matplotlib()
    error_deg = list(
        REF_CALIBRATION_STUDY["error_deg"] if error_deg is None
        else error_deg
    )
    mnn = list(REF_CALIBRATION_STUDY["mnn"] if mnn is None else mnn)
    convergence_s = dict(
        REF_CALIBRATION_STUDY["convergence_s"] if convergence_s is None
        else convergence_s
    )
    x = np.arange(len(error_deg))
    fig, axes = plt.subplots(ncols=2, nrows=1, figsize=(12, 6))

    axes[0].bar(x, mnn, color="tab:blue", width=0.4)
    axes[0].set_xlabel("Angular error [degree]")
    axes[0].set_ylabel("Mean NND [m]")
    axes[0].set_xticks(x, error_deg)

    n = max(len(convergence_s), 1)
    width = 0.6 / n
    for i, (label, vals) in enumerate(convergence_s.items()):
        axes[1].bar(x + (i - (n - 1) / 2) * width, vals, width=width,
                    label=label)
    axes[1].set_xlabel("Angular error [degree]")
    axes[1].set_ylabel("Convergence time [s]")
    axes[1].set_xticks(x, error_deg)
    axes[1].legend()

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_pointclouds(
    pointcloud_dir: str,
    out_path: Optional[str] = None,
    pcl_subdir: str = "nerf_pcl",
    max_points: int = 2_000_000,
) -> str:
    """Top-down scatter of every PCD in a result directory's point-cloud
    folder, colored by acquisition order — the reference's quick-look map
    of an online run's accumulated NeRF point clouds
    (reference: plotting/training/plot_pointclouds.py)."""
    plt = require_matplotlib()
    from virus_nerf_tpu_torch.data.pcl import PCLLoader

    loader = PCLLoader(pointcloud_dir)
    files = loader.get_files(pcl_subdir)
    if not files:
        raise FileNotFoundError(
            f"no .pcd files under {pointcloud_dir}/{pcl_subdir}"
        )
    xyzs = [loader.load_pcl(os.path.join(pcl_subdir, f)) for f in files]
    xyz = np.concatenate([np.asarray(x).reshape(-1, 3) for x in xyzs])
    if xyz.shape[0] > max_points:
        idx = np.linspace(0, xyz.shape[0] - 1, max_points).astype(np.int64)
        xyz = xyz[idx]

    out_path = out_path or os.path.join(pointcloud_dir, "pointclouds.png")
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(xyz[:, 0], xyz[:, 1], s=0.1,
                    c=np.arange(xyz.shape[0]), cmap="jet")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.colorbar(sc, ax=ax, label="acquisition order")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("calibration", help="calibration-error bar chart")
    c.add_argument("--out", default="tof_calibration_error.png")
    q = sub.add_parser("pointclouds", help="point-cloud scatter map")
    q.add_argument("--dir", required=True)
    q.add_argument("--subdir", default="nerf_pcl")
    q.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.cmd == "calibration":
        print(plot_calibration_error(args.out))
    else:
        print(plot_pointclouds(args.dir, args.out, pcl_subdir=args.subdir))


if __name__ == "__main__":
    main()
