"""PSO result analysis plots.

Counterpart of ``virus_nerf_tpu/optimization/plots.py`` (reference:
optimization/plotter_ethz.py, optimization/plotter_metric.py): everything
is derived from the ``pso_history.csv`` that :class:`PSOCheckpointed`
writes (one row per evaluation: iteration, particle, exploring flag,
score, elapsed time and the denormalized hyper-parameter values).

All plots write files (Agg backend); nothing blocks on a GUI.
``load_history``, ``hparam_names`` and ``summarize_pso`` are numpy and csv
code; matplotlib is imported when a plot is drawn, so the module imports
where it is missing (a plot then raises ImportError naming it).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from virus_nerf_tpu_torch.utils.helpers import require_matplotlib


def load_history(save_dir: str) -> Dict[str, np.ndarray]:
    """Read ``pso_history.csv`` into arrays.

    Returns a dict with keys 'iteration', 'particle', 'exploring', 'score',
    'time' plus one entry per hyper-parameter column.
    """
    path = os.path.join(save_dir, "pso_history.csv")
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    cols = {h: np.array([r[i] for r in rows], np.float64)
            for i, h in enumerate(header)}
    for k in ("iteration", "particle", "exploring"):
        cols[k] = cols[k].astype(np.int64)
    return cols


def hparam_names(history: Dict[str, np.ndarray]) -> List[str]:
    meta = {"iteration", "particle", "exploring", "score", "time"}
    return [k for k in history if k not in meta]


def plot_convergence(
    save_dir: str,
    out_path: Optional[str] = None,
    score_min: Optional[float] = None,
    score_max: Optional[float] = None,
) -> str:
    """Per-particle score traces + running global best vs evaluation count
    (reference: optimization/plotter_metric.py convergence view).

    ``score_min``/``score_max`` clamp the y-axis the way the reference's
    plot bounds do (optimization/plotter_ethz.py:16-17).
    """
    plt = require_matplotlib()
    h = load_history(save_dir)
    out_path = out_path or os.path.join(save_dir, "pso_convergence.png")
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))

    for p in np.unique(h["particle"]):
        m = h["particle"] == p
        ax1.plot(h["iteration"][m], h["score"][m], marker=".", lw=0.8,
                 label=f"particle {p}")
    ax1.set_xlabel("evaluation")
    ax1.set_ylabel("score")
    ax1.set_title("per-particle score")
    ax1.legend(fontsize=7)

    order = np.argsort(h["iteration"])
    best = np.minimum.accumulate(h["score"][order])
    ax2.plot(h["iteration"][order], best, lw=1.5)
    ax2.set_xlabel("evaluation")
    ax2.set_ylabel("running best score")
    ax2.set_title("global best (lower is better)")
    for ax in (ax1, ax2):
        if score_min is not None or score_max is not None:
            ax.set_ylim(score_min, score_max)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_hparam_scores(
    save_dir: str,
    out_path: Optional[str] = None,
    params: Optional[Sequence[str]] = None,
    max_cols: int = 4,
) -> str:
    """Score vs each hyper-parameter, one panel per parameter — shows which
    regions of each axis the swarm found good
    (reference: optimization/plotter_ethz.py per-parameter panels)."""
    plt = require_matplotlib()
    h = load_history(save_dir)
    names = list(params) if params else hparam_names(h)
    out_path = out_path or os.path.join(save_dir, "pso_hparam_scores.png")
    n = len(names)
    ncols = min(max_cols, max(n, 1))
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(3.2 * ncols, 2.8 * nrows), squeeze=False
    )
    ibest = int(np.argmin(h["score"]))
    for i, name in enumerate(names):
        ax = axes[i // ncols][i % ncols]
        sc = ax.scatter(
            h[name], h["score"], c=h["iteration"], cmap="viridis", s=14
        )
        ax.scatter([h[name][ibest]], [h["score"][ibest]], marker="*",
                   s=120, color="red", zorder=3)
        ax.set_xlabel(name, fontsize=8)
        ax.set_ylabel("score", fontsize=8)
        ax.grid(alpha=0.3)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    if n:
        fig.colorbar(sc, ax=axes.ravel().tolist(), label="evaluation",
                     shrink=0.7)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_hparam_trajectories(
    save_dir: str,
    out_path: Optional[str] = None,
    pairs: Optional[Sequence[Tuple[str, str]]] = None,
    max_pairs: int = 6,
) -> str:
    """2-D projections of the swarm's trajectory through hyper-parameter
    space, per-particle paths + score-colored points, best starred
    (reference: optimization/plotter_ethz.py trajectory slices)."""
    plt = require_matplotlib()
    h = load_history(save_dir)
    names = hparam_names(h)
    if pairs is None:
        pairs = [
            (names[i], names[j])
            for i in range(len(names))
            for j in range(i + 1, len(names))
        ][:max_pairs]
    out_path = out_path or os.path.join(save_dir, "pso_trajectories.png")
    n = len(pairs)
    ncols = min(3, max(n, 1))
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(3.6 * ncols, 3.2 * nrows), squeeze=False
    )
    ibest = int(np.argmin(h["score"]))
    for i, (a, b) in enumerate(pairs):
        ax = axes[i // ncols][i % ncols]
        for p in np.unique(h["particle"]):
            m = h["particle"] == p
            o = np.argsort(h["iteration"][m])
            ax.plot(h[a][m][o], h[b][m][o], lw=0.5, alpha=0.5)
        sc = ax.scatter(h[a], h[b], c=h["score"], cmap="plasma", s=14)
        ax.scatter([h[a][ibest]], [h[b][ibest]], marker="*", s=140,
                   color="lime", edgecolor="k", zorder=3)
        ax.set_xlabel(a, fontsize=8)
        ax.set_ylabel(b, fontsize=8)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    if n:
        fig.colorbar(sc, ax=axes.ravel().tolist(), label="score",
                     shrink=0.7)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _normalized_positions(
    h: Dict[str, np.ndarray], names: Sequence[str]
) -> np.ndarray:
    """(rows, M) positions scaled to [0, 1] per parameter by the observed
    range (the history CSV stores denormalized values; the search lims are
    not persisted, so the observed range stands in — identical up to the
    affine map for visualization)."""
    cols = []
    for name in names:
        v = h[name]
        lo, hi = np.nanmin(v), np.nanmax(v)
        cols.append((v - lo) / (hi - lo) if hi > lo else np.zeros_like(v))
    return np.stack(cols, axis=1)


def _per_particle(h: Dict[str, np.ndarray]):
    """Yield (particle id, row index array ordered by iteration)."""
    for p in np.unique(h["particle"]):
        m = np.nonzero(h["particle"] == p)[0]
        yield int(p), m[np.argsort(h["iteration"][m])]


def plot_pso_results(
    save_dir: str,
    out_path: Optional[str] = None,
    score_min: Optional[float] = None,
    score_max: Optional[float] = None,
    converged_since_n: int = 10,
) -> str:
    """The reference's 3-panel ``pso_results.png``
    (reference: optimization/plotter_ethz.py:24-271): particle speed per
    iteration (swarm mean ± std band + per-particle points colored by
    score), per-particle converged-score boxplots over the last
    ``converged_since_n`` evaluations, and the final normalized position of
    every particle on each hyper-parameter axis, score-colored.

    Speed is the norm of successive normalized position deltas (the
    reference reads its ``pso_vel_i.csv`` files; the single-file state keeps
    positions only, and ``|Δpos|`` equals ``|vel|`` for every non-exploring
    move)."""
    plt = require_matplotlib()
    h = load_history(save_dir)
    names = hparam_names(h)
    out_path = out_path or os.path.join(save_dir, "pso_results.png")
    pos_n = _normalized_positions(h, names)
    smin = np.nanmin(h["score"]) if score_min is None else score_min
    smax = np.nanmax(h["score"]) if score_max is None else score_max
    import matplotlib

    cmap = matplotlib.colormaps["jet"].reversed()
    norm = matplotlib.colors.Normalize(vmin=smin, vmax=smax)

    fig, axes = plt.subplots(3, 1, figsize=(12, 10))

    # ---- panel 1: particle speeds -----------------------------------
    ax = axes[0]
    speeds = {}
    for p, idx in _per_particle(h):
        d = np.diff(pos_n[idx], axis=0)
        speeds[p] = (h["iteration"][idx][1:], np.linalg.norm(d, axis=1),
                     h["score"][idx][1:])
    if speeds:
        max_t = max(int(it.max()) for it, _, _ in speeds.values() if len(it))
        mean_v = np.full(max_t + 1, np.nan)
        std_v = np.full(max_t + 1, np.nan)
        for t in range(max_t + 1):
            vals = [v[it == t] for it, v, _ in speeds.values()]
            vals = np.concatenate(vals) if vals else np.array([])
            if vals.size:
                mean_v[t] = vals.mean()
                std_v[t] = vals.std()
        ts = np.arange(max_t + 1)
        ax.plot(ts, mean_v, c="k", label="mean speed")
        ax.fill_between(ts, mean_v - std_v, mean_v + std_v, alpha=0.2,
                        color="k", label="std speed")
        for p, (it, v, sc) in speeds.items():
            ax.scatter(it, v, c=sc, cmap=cmap, norm=norm, s=18,
                       label=f"particle {p}")
    ax.set_xlabel("iteration")
    ax.set_ylabel("normalized speed")
    ax.legend(fontsize=7, loc="upper right", ncol=3)
    ax.grid(alpha=0.3)

    # ---- panel 2: converged-score boxplots --------------------------
    ax = axes[1]
    for p, idx in _per_particle(h):
        sc = h["score"][idx][-converged_since_n:]
        sc = sc[~np.isnan(sc)]
        if not sc.size:
            continue
        c = cmap(norm(np.mean(sc)))
        ax.boxplot(sc, positions=[p], widths=0.7, whis=[10, 90],
                   patch_artist=True,
                   boxprops=dict(facecolor=c, color=c),
                   medianprops=dict(color="black"))
    ax.set_xlabel("particle")
    ax.set_ylabel("converged score")
    ax.grid(alpha=0.3)

    # ---- panel 3: final normalized positions per hparam -------------
    ax = axes[2]
    im = None
    for p, idx in _per_particle(h):
        last = idx[-1]
        im = ax.scatter(np.arange(len(names)), pos_n[last], c=[
            h["score"][last]] * len(names), cmap=cmap, norm=norm, s=40)
    ax.set_xticks(np.arange(len(names)))
    ax.set_xticklabels([n.replace("_", " ") for n in names], rotation=30,
                       fontsize=8)
    ax.set_ylabel("normalized final position")
    ax.grid(alpha=0.3)
    if im is not None:
        fig.subplots_adjust(right=0.86)
        cax = fig.add_axes([0.89, 0.1, 0.03, 0.8])
        fig.colorbar(im, cax=cax)
        cax.set_ylabel("score", rotation=270, labelpad=14)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_metric_landscape(
    save_dir: str,
    objective,
    out_path: Optional[str] = None,
    params: Optional[Tuple[str, str]] = None,
    res: int = 120,
) -> str:
    """2-D objective landscape + swarm trajectories for synthetic metrics
    (reference: optimization/plotter_metric.py:87-169 ``plot2D``).

    ``objective(X)`` maps an (n, 2) array of hyper-parameter values to (n,)
    scores — pass ``Metric.__call__`` from :mod:`.metric`.  Only the first
    two (or the given pair of) hyper-parameter axes are plotted."""
    plt = require_matplotlib()
    h = load_history(save_dir)
    names = hparam_names(h)
    a, b = params if params else (names[0], names[1])
    out_path = out_path or os.path.join(save_dir, "pso_landscape.png")
    xa = np.linspace(np.nanmin(h[a]), np.nanmax(h[a]), res)
    xb = np.linspace(np.nanmin(h[b]), np.nanmax(h[b]), res)
    ga, gb = np.meshgrid(xa, xb)
    z = np.asarray(
        objective(np.stack([ga.ravel(), gb.ravel()], axis=1))
    ).reshape(res, res)

    fig, ax = plt.subplots(figsize=(7, 6))
    cs = ax.contourf(ga, gb, z, levels=30, cmap="viridis")
    fig.colorbar(cs, ax=ax, label="objective")
    for p, idx in _per_particle(h):
        ax.plot(h[a][idx], h[b][idx], lw=0.8, alpha=0.8, marker=".",
                ms=4, label=f"particle {p}")
    ibest = int(np.nanargmin(h["score"]))
    ax.scatter([h[a][ibest]], [h[b][ibest]], marker="*", s=180,
               color="red", edgecolor="k", zorder=3, label="best")
    ax.set_xlabel(a)
    ax.set_ylabel(b)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_all(save_dir: str, **kwargs) -> List[str]:
    """Write the full analysis suite next to the PSO state files."""
    return [
        plot_convergence(save_dir, **{
            k: v for k, v in kwargs.items()
            if k in ("score_min", "score_max")
        }),
        plot_hparam_scores(save_dir),
        plot_hparam_trajectories(save_dir),
        plot_pso_results(save_dir, **{
            k: v for k, v in kwargs.items()
            if k in ("score_min", "score_max", "converged_since_n")
        }),
    ]


def summarize_pso(
    save_dir: str,
    converged_since_n: int = 10,
) -> Dict[str, object]:
    """Best-particle report + swarm-convergence diagnostic (the printed
    analyses of the reference's PlotterEthz.plot,
    optimization/plotter_ethz.py:43-66): the best particle's final
    hyper-parameters and score, plus the maximal normalized-position
    variation over the last ``converged_since_n`` evaluations per particle
    (mean/min/max over the swarm) — near-zero variation means the swarm
    has converged."""
    h = load_history(save_dir)
    names = hparam_names(h)
    pos_n = _normalized_positions(h, names)

    best = {}
    variations = []
    best_particle, best_score = None, np.inf
    for p, idx in _per_particle(h):
        sc = h["score"][idx]
        ok = ~np.isnan(sc)
        if not ok.any():
            continue
        pbest = float(np.nanmin(sc))
        if pbest < best_score:
            best_score = pbest
            i = idx[int(np.nanargmin(sc))]
            best_particle = p
            best = {n: float(h[n][i]) for n in names}
        tail = pos_n[idx][-converged_since_n:]
        r = np.linalg.norm(tail, axis=1)
        if r.size:
            variations.append(float(np.nanmax(r) - np.nanmin(r)))

    out = {
        "best_particle": best_particle,
        "best_score": float(best_score),
        "best_hparams": best,
        "variation_last_n": {
            "mean": float(np.mean(variations)) if variations else np.nan,
            "min": float(np.min(variations)) if variations else np.nan,
            "max": float(np.max(variations)) if variations else np.nan,
            "n": converged_since_n,
        },
    }
    return out
