"""Ultrasonic-sensor lab-characterization analyses.

The reference characterized three candidate ultrasonic sensors (HC-SR04,
URM37, MB1603) on a lab bench — targets of three sizes and two surface
materials, swept over distance and angle — and shipped the analysis
scripts that turned the recorded CSVs into the paper's polar error fans
(reference: plotting/USS_experiments/plot_{first,second,third}_measurement.py
+ helpers/uss_experiments_fcts.py).  This module rebuilds those analyses
on the same on-disk layout (the port's copy of
``virus_nerf_tpu/analysis/uss_experiments.py``)::

    <data_dir>/firstMeasurement/<SENSOR>_<object>[_plex].csv
    <data_dir>/secondMeasurement/<SENSOR>_<object>[_plex].csv
    <data_dir>/thirdMeasurement/<SENSOR>_<object>[_plex].csv

where each CSV has one column per test point named ``{dist}m_{angle}deg``
(e.g. ``0.25m_-40deg``) holding repeated distance measurements in meters.

Everything is numpy + csv (no pandas) and writes files via the Agg
backend; nothing blocks on a GUI.  matplotlib is imported when a figure
is drawn: the loaders and statistics need none.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from virus_nerf_tpu_torch.utils.helpers import require_matplotlib

# systematic mounting offsets measured during the experiments
# (reference: helpers/uss_experiments_fcts.py correctMeas)
FIRST_MEAS_OFFSET_M = 0.04
LATER_MEAS_OFFSET_M = 0.005

_MEAS_DIRS = {
    "first": "firstMeasurement",
    "second": "secondMeasurement",
    "third": "thirdMeasurement",
}


@dataclass
class USSExperimentData:
    """One experiment CSV: ``columns[(dist_m, angle_deg)] -> samples``."""

    columns: Dict[tuple, np.ndarray] = field(default_factory=dict)

    def get(self, dist: float, angle: float) -> Optional[np.ndarray]:
        return self.columns.get((float(dist), float(angle)))


def _parse_col_name(name: str):
    """``"0.25m_-40deg" -> (0.25, -40.0)``
    (reference: helpers/uss_experiments_fcts.py convertColName)."""
    d, a = name.strip().split("_")
    return float(d[:-1]), float(a[:-3])


def load_experiment_csv(
    data_dir: str,
    sensor: str,
    obj: str,
    surface: str,
    measurement: str,
) -> USSExperimentData:
    """Load one experiment file from the reference layout
    (reference: helpers/uss_experiments_fcts.py loadData)."""
    name = f"{sensor}_{obj}"
    if surface == "plexiglas":
        name += "_plex"
    path = os.path.join(data_dir, _MEAS_DIRS[measurement], name + ".csv")
    with open(path) as f:
        rows = [r for r in csv.reader(f) if r]
    header = rows[0]
    cols = np.array(
        [[float(v) if v else np.nan for v in r] for r in rows[1:]],
        np.float64,
    )
    out = USSExperimentData()
    for i, h in enumerate(header):
        key = _parse_col_name(h)
        v = cols[:, i]
        out.columns[key] = v[~np.isnan(v)]
    return out


def correct_measurement(meas: np.ndarray, first_meas: bool) -> np.ndarray:
    """Remove the per-campaign systematic mounting offset
    (reference: helpers/uss_experiments_fcts.py correctMeas)."""
    off = FIRST_MEAS_OFFSET_M if first_meas else LATER_MEAS_OFFSET_M
    return np.asarray(meas, np.float64) - off


def lin_interpolate(
    data: Sequence[float],
    num_fills: int = 20,
    check_for_invalid_data: bool = True,
) -> np.ndarray:
    """Dense linear interpolation between consecutive samples, zeroing
    spans that touch an invalid (0) sample — used to draw smooth polar
    fans (reference: helpers/uss_experiments_fcts.py linInterpolate)."""
    data = np.asarray(data, np.float64)
    segs = []
    for i in range(len(data) - 1):
        if check_for_invalid_data and (data[i] == 0 or data[i + 1] == 0):
            segs.append(np.zeros(num_fills))
        else:
            segs.append(np.linspace(data[i], data[i + 1], num_fills))
    return np.concatenate(segs) if segs else np.zeros(0)


def _stats_grid(
    data: USSExperimentData,
    dists: Sequence[float],
    angles: Sequence[float],
    first_meas: bool,
    rescale_to: Optional[Dict[float, float]] = None,
):
    """(mean, std, mean-abs-error) arrays over the (dist, angle) lattice;
    ``rescale_to[dist]`` renormalizes each column's mean to the
    second-campaign 0° anchor the way the first-measurement analysis does
    (reference: plot_first_measurement.py:44-60)."""
    D, A = len(dists), len(angles)
    means = np.zeros((D, A))
    stds = np.zeros((D, A))
    mae = np.zeros((D, A))
    for i, dist in enumerate(dists):
        for j, ang in enumerate(angles):
            meas = data.get(dist, ang)
            if meas is None or meas.size == 0:
                continue
            meas = correct_measurement(meas, first_meas)
            if rescale_to is not None and dist in rescale_to:
                meas = rescale_to[dist] * (meas / np.mean(meas))
            means[i, j] = np.mean(meas)
            stds[i, j] = np.std(meas)
            mae[i, j] = np.mean(np.abs(meas - dist))
    return means, stds, mae


def _polar_fan(ax, angles, means, stds, mae, cmap, cnorm):
    """Draw one distance's interpolated mean±std fan, colored by MAE."""
    from matplotlib.patches import Polygon

    a = np.deg2rad(lin_interpolate(angles, check_for_invalid_data=False))
    m = lin_interpolate(means)
    s = lin_interpolate(stds)
    cols = cmap(cnorm(np.maximum(mae, 1e-9)))
    cols = np.stack(
        [lin_interpolate(cols[:, c], check_for_invalid_data=False)
         for c in range(4)],
        axis=1,
    )
    for j in range(len(a) - 1):
        if m[j] == 0 or m[j + 1] == 0:
            continue
        ax.plot(a[j:j + 2], m[j:j + 2], "-", color=cols[j])
        ax.add_patch(Polygon(
            [(a[j], m[j] - s[j]), (a[j], m[j] + s[j]),
             (a[j + 1], m[j + 1] + s[j + 1]),
             (a[j + 1], m[j + 1] - s[j + 1])],
            closed=False, facecolor=cols[j], alpha=0.5,
        ))


def plot_angular_characterization(
    data_dir: str,
    sensor: str,
    out_path: Optional[str] = None,
    dists: Sequence[float] = (0.25, 0.5, 1.0, 2.0),
    angles: Sequence[float] = (-40, -30, -20, -10, 0, 10, 20, 30, 40),
    objects: Sequence[str] = ("large", "medium", "small"),
    surfaces: Sequence[str] = ("cardboard", "plexiglas"),
) -> str:
    """First campaign: per-object x per-surface polar fans of the sensor's
    measured distance vs target angle, colored by mean absolute error —
    the beam-pattern view that picked MB1603 for the robot
    (reference: plotting/USS_experiments/plot_first_measurement.py)."""
    plt = require_matplotlib()
    from matplotlib.colors import LogNorm

    out_path = out_path or os.path.join(data_dir, f"{sensor}.png")
    cmap = plt.colormaps.get_cmap("plasma")
    cnorm = LogNorm(vmin=0.01, vmax=1.0)
    fig, axis = plt.subplots(
        ncols=len(surfaces), nrows=len(objects),
        subplot_kw={"projection": "polar"}, figsize=(10, 9), squeeze=False,
    )
    fig.suptitle(sensor, fontsize=16, weight="bold")
    for k, obj in enumerate(objects):
        for l, surf in enumerate(surfaces):
            ax = axis[k, l]
            first = load_experiment_csv(data_dir, sensor, obj, surf, "first")
            second = load_experiment_csv(
                data_dir, sensor, obj, surf, "second"
            )
            # per-distance anchor: second-campaign 0-degree mean
            anchors = {}
            for d in dists:
                m2 = second.get(d, 0)
                if m2 is not None and m2.size:
                    anchors[d] = float(
                        np.mean(correct_measurement(m2, False))
                    )
            means, stds, mae = _stats_grid(
                first, dists, angles, first_meas=True, rescale_to=anchors
            )
            for i in range(len(dists)):
                _polar_fan(ax, angles, means[i], stds[i], mae[i],
                           cmap, cnorm)
            ax.set_theta_offset(np.pi / 2)
            ax.set_thetamin(min(angles))
            ax.set_thetamax(max(angles))
            ax.set_ylim([0, 3])
            ax.set_yticks([1.0, 2.0, 3.0])
            ax.set_yticklabels(["1m", "2m", "3m"])
            if k == 0:
                ax.set_title(surf.capitalize(), weight="bold", y=1.05)
            if l == 0:
                ax.set_ylabel(obj.capitalize(), weight="bold")
    sm = plt.cm.ScalarMappable(cmap=cmap, norm=cnorm)
    fig.colorbar(sm, ax=axis.ravel().tolist(),
                 label="Mean Absolute Error [m]")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_sensor_comparison(
    data_dir: str,
    out_path: Optional[str] = None,
    sensors: Sequence[str] = ("HC-SR04", "URM37", "MB1603"),
    dists: Sequence[float] = (0.25, 0.5, 1.0, 2.0),
    objects: Sequence[str] = ("large", "medium", "small"),
    surfaces: Sequence[str] = ("cardboard", "plexiglas"),
) -> str:
    """Second campaign: head-on (0 degree) accuracy of all sensors side by
    side, mean +- std error bars colored by MAE
    (reference: plotting/USS_experiments/plot_second_measurement.py)."""
    plt = require_matplotlib()
    from matplotlib.colors import LogNorm

    out_path = out_path or os.path.join(data_dir, "all_sensors.png")
    cmap = plt.colormaps.get_cmap("plasma")
    cnorm = LogNorm(vmin=0.01, vmax=1.0)
    fig, axis = plt.subplots(
        ncols=len(surfaces), nrows=len(objects), figsize=(9, 9),
        squeeze=False,
    )
    for s, sensor in enumerate(sensors):
        for k, obj in enumerate(objects):
            for l, surf in enumerate(surfaces):
                ax = axis[k, l]
                data = load_experiment_csv(
                    data_dir, sensor, obj, surf, "second"
                )
                means, stds, mae = _stats_grid(
                    data, dists, (0,), first_meas=False
                )
                for i in range(len(dists)):
                    c = cmap(cnorm(max(mae[i, 0], 1e-9)))
                    ax.scatter(s, means[i, 0], s=30, color=c)
                    ax.errorbar(s, means[i, 0], yerr=stds[i, 0],
                                fmt="none", ecolor=c, capsize=3)
                ax.set_xticks(range(len(sensors)))
                ax.set_xticklabels(
                    sensors if k == len(objects) - 1 else [""] * len(sensors)
                )
                ax.set_yticks(list(dists))
                ax.set_ylim([0, 1.125 * max(dists)])
                ax.grid(axis="y", linewidth=0.5)
                if k == 0:
                    ax.set_title(surf.capitalize(), weight="bold")
                if l == 0:
                    ax.set_ylabel(obj.capitalize(), weight="bold")
    sm = plt.cm.ScalarMappable(cmap=cmap, norm=cnorm)
    fig.colorbar(sm, ax=axis.ravel().tolist(),
                 label="Mean Absolute Error [m]")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_tilted_object(
    data_dir: str,
    out_path: Optional[str] = None,
    sensors: Sequence[str] = ("HC-SR04", "URM37", "MB1603"),
    dists: Sequence[float] = (1.0, 2.0),
    angles: Sequence[float] = (0, 22, 45, 67, 90),
    obj: str = "large",
    surfaces: Sequence[str] = ("cardboard", "plexiglas"),
) -> str:
    """Third campaign: target TILT sweep (specular-reflection failure
    mode) — raw samples + interpolated mean/std fans per sensor/surface
    (reference: plotting/USS_experiments/plot_third_measurement.py)."""
    plt = require_matplotlib()
    from matplotlib.colors import LogNorm

    out_path = out_path or os.path.join(data_dir, "object_tilted.png")
    cmap = plt.colormaps.get_cmap("plasma")
    cnorm = LogNorm(vmin=0.01, vmax=2.0)
    fig, axis = plt.subplots(
        ncols=len(surfaces), nrows=len(sensors),
        subplot_kw={"projection": "polar"}, figsize=(10, 9), squeeze=False,
    )
    for s, sensor in enumerate(sensors):
        for l, surf in enumerate(surfaces):
            ax = axis[s, l]
            data = load_experiment_csv(data_dir, sensor, obj, surf, "third")
            means, stds, mae = _stats_grid(
                data, dists, angles, first_meas=False
            )
            for i, dist in enumerate(dists):
                for j, ang in enumerate(angles):
                    meas = data.get(dist, ang)
                    if meas is None or meas.size == 0:
                        continue
                    meas = correct_measurement(meas, False)
                    ax.scatter([np.deg2rad(ang)] * len(meas), meas, s=15,
                               color=cmap(cnorm(max(mae[i, j], 1e-9))))
                _polar_fan(ax, angles, means[i], stds[i], mae[i],
                           cmap, cnorm)
            ax.set_theta_offset(np.pi / 2)
            ax.set_thetamin(min(angles))
            ax.set_thetamax(max(angles))
            ax.set_ylim([0, 4])
            if s == 0:
                ax.set_title(surf.capitalize(), weight="bold", y=1.05)
            if l == 0:
                ax.set_ylabel(sensor, weight="bold")
    sm = plt.cm.ScalarMappable(cmap=cmap, norm=cnorm)
    fig.colorbar(sm, ax=axis.ravel().tolist(),
                 label="Mean Absolute Error [m]")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv: Optional[List[str]] = None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True,
                   help="experiment root (firstMeasurement/ etc.)")
    p.add_argument("--sensor", default="MB1603",
                   help="sensor for the angular characterization figure")
    p.add_argument("--out-dir", default=None)
    args = p.parse_args(argv)
    out = args.out_dir or args.data_dir
    os.makedirs(out, exist_ok=True)
    paths = [
        plot_angular_characterization(
            args.data_dir, args.sensor,
            os.path.join(out, f"{args.sensor}.png"),
        ),
        plot_sensor_comparison(
            args.data_dir, os.path.join(out, "all_sensors.png")
        ),
        plot_tilted_object(
            args.data_dir, os.path.join(out, "object_tilted.png")
        ),
    ]
    for path in paths:
        print(path)


if __name__ == "__main__":
    main()
