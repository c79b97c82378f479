"""The port's plots (``virus_nerf_tpu_torch/evaluation/plots.py``,
``virus_nerf_tpu_torch/optimization/plots.py``) against the JAX package's
on the same seed-made inputs.  Both draw through the same matplotlib, so
each test records the arrays handed to it (``imshow``, ``hist``, ``bar``,
``scatter``, ``plot``, ...) on both sides and holds them equal exactly,
then checks that the file is written; ``summarize_pso``'s table and
``load_history`` are held equal exactly too.  And the port's modules
import, and its numpy/csv functions run, where matplotlib is missing,
while a plot raises ImportError naming it."""

import contextlib
import os
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")
import matplotlib  # noqa: E402
import matplotlib.axes  # noqa: E402

from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset  # noqa: E402
from virus_nerf_tpu.evaluation import plots as JP  # noqa: E402
from virus_nerf_tpu.optimization import plots as JO  # noqa: E402
from virus_nerf_tpu_torch.data.pcl import save_pcd  # noqa: E402
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from virus_nerf_tpu_torch.evaluation import plots as PP  # noqa: E402
from virus_nerf_tpu_torch.grids.base import bitfield_from_grid  # noqa: E402
from virus_nerf_tpu_torch.optimization import PSOWrapper, SyntheticMetric  # noqa: E402
from virus_nerf_tpu_torch.optimization import plots as PO  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWN = ("imshow", "hist", "bar", "scatter", "plot", "vlines", "arrow",
         "fill_between", "boxplot", "contourf", "errorbar", "set_xticks",
         "set_xlim", "set_ylim", "set_yscale")


@contextlib.contextmanager
def recorded():
    """Every call of the ``DRAWN`` Axes methods, as (name, args, kwargs)."""
    calls = []

    def recorder(name, orig):
        def method(self, *args, **kwargs):
            calls.append((name, args, kwargs))
            return orig(self, *args, **kwargs)
        return method

    with contextlib.ExitStack() as stack:
        for name in DRAWN:
            orig = getattr(matplotlib.axes.Axes, name)
            stack.enter_context(mock.patch.object(
                matplotlib.axes.Axes, name, recorder(name, orig)))
        yield calls


def _plain(x):
    """A recorded argument as numbers where it is numbers; matplotlib
    objects (colormaps, norms) by type."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (str, bool, type(None))):
        return x
    if isinstance(x, (list, tuple, np.ndarray, int, float, np.number)):
        try:
            return np.asarray(x, float)
        except (TypeError, ValueError):
            return [_plain(v) for v in x]
    return type(x).__name__


def assert_same_calls(got, want):
    assert [c[0] for c in got] == [c[0] for c in want]
    assert got, "nothing was drawn"
    for (name, a, k), (_, b, l) in zip(got, want):
        pa, pb = _plain(list(a)), _plain(list(b))
        assert len(pa) == len(pb), name
        for x, y in zip(pa, pb):
            _assert_plain_equal(x, y, name)
        assert set(k) == set(l), name
        for key in k:
            _assert_plain_equal(_plain(k[key]), _plain(l[key]), (name, key))


def _assert_plain_equal(x, y, what):
    if isinstance(x, np.ndarray):
        np.testing.assert_array_equal(x, y, err_msg=str(what))
    elif isinstance(x, list):
        assert isinstance(y, list) and len(x) == len(y), what
        for u, v in zip(x, y):
            _assert_plain_equal(u, v, what)
    elif isinstance(x, dict):
        assert set(x) == set(y), what
        for key in x:
            _assert_plain_equal(x[key], y[key], (what, key))
    else:
        assert x == y, what


def both(fn_port, fn_jax):
    """(port result, JAX result) with the drawing calls of each compared."""
    with recorded() as got:
        out_p = fn_port()
    with recorded() as want:
        out_j = fn_jax()
    assert_same_calls(got, want)
    return out_p, out_j


def written(path):
    return os.path.exists(path) and os.path.getsize(path) > 0


# ------------------------------------------------------- evaluation plots
GS = 16


def _grid(seed):
    rng = np.random.default_rng(seed)
    return rng.random((1, GS**3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("corrupt", [False, True])
def test_check_bitfield_roundtrip_matches_jax(seed, corrupt):
    grid = _grid(seed)
    occ = grid > 0.5
    bits = bitfield_from_grid(torch.from_numpy(grid), 0.5, GS).numpy()
    if corrupt:
        bits = bits.copy()
        bits[seed * 7] ^= 1 << (seed % 8)
    got = PP.check_bitfield_roundtrip(occ, bits, GS)
    assert got == JP.check_bitfield_roundtrip(occ, bits, GS) == (not corrupt)


@pytest.mark.parametrize("with_gt", [False, True])
@pytest.mark.parametrize("height", [None, 3])
def test_plot_occ_grid_slice_matches_jax(with_gt, height, tmp_path):
    grid = _grid(2)
    bits = bitfield_from_grid(torch.from_numpy(grid), 0.5, GS).numpy()
    gt = (np.random.default_rng(3).random((GS, GS)) > 0.7) if with_gt else None
    kw = dict(height_idx=height, gt_slice=gt, extent=[-1.0, 1.0, -2.0, 2.0],
              bitfield=bits, occ_bool=grid > 0.5)
    sl_p, sl_j = both(
        lambda: PP.plot_occ_grid_slice(grid, GS, path=str(tmp_path / "p.png"),
                                       **kw),
        lambda: JP.plot_occ_grid_slice(grid, GS, path=str(tmp_path / "j.png"),
                                       **kw))
    np.testing.assert_array_equal(sl_p, sl_j)
    assert written(tmp_path / "p.png")


def test_plot_occ_grid_slice_reports_a_broken_bitfield(tmp_path):
    grid = _grid(4)
    bits = bitfield_from_grid(torch.from_numpy(grid), 0.5, GS).numpy().copy()
    bits[0] ^= 1
    with pytest.raises(AssertionError, match="round-trip"):
        PP.plot_occ_grid_slice(grid, GS, bitfield=bits, occ_bool=grid > 0.5)
    logger = mock.Mock()
    PP.plot_occ_grid_slice(grid, GS, bitfield=bits, occ_bool=grid > 0.5,
                           path=str(tmp_path / "g.png"), logger=logger)
    logger.error.assert_called_once()
    assert written(tmp_path / "g.png")


def _data_dict(n_img=3, per=40, seed=5):
    """evaluate_depth-like dicts for GT, NeRF and USS: (N*M, 2) positions
    around a square room, NaN rows, NND arrays."""
    rng = np.random.default_rng(seed)

    def pos():
        p = rng.uniform(-1.2, 1.2, (n_img * per, 2))
        p[rng.random(n_img * per) < 0.1] = np.nan
        return p

    gt = {"pos": pos(), "pos_o": pos(),
          "rays_o": np.concatenate([rng.uniform(-0.3, 0.3, (n_img * per, 2)),
                                    np.full((n_img * per, 1), 0.1)], 1)}
    data, metrics = {"GT": gt}, {}
    for s in ("NeRF", "USS"):
        data[s] = {"pos": pos(), "pos_o": pos(), "pos_gt": pos()}
        d = rng.random(n_img * per) * 2
        d[::9] = np.nan
        metrics[s] = {"nn_dists": d, "nn_dists_inv": rng.random(n_img * per)}
    return data, metrics


@pytest.mark.parametrize("with_robot", [False, True])
def test_plot_maps_per_image_matches_jax(with_robot, tmp_path):
    # the pixels of combine_imgs (GT map, GT scan, sensor scan), the scan
    # rays, the robot poses and the NND histograms' values and bins
    _, scene, _ = make_synthetic_dataset(n_images=2, img_wh=(8, 6),
                                         n_gt_points=2000, device="cpu")
    _, jscene, _ = j_make_dataset(n_images=2, img_wh=(8, 6), n_gt_points=2000)
    data, metrics = _data_dict()
    robot = None
    if with_robot:
        rng = np.random.default_rng(6)
        robot = {"pos": {"CAM1": rng.random((3, 2))},
                 "orientation": {"CAM1": rng.random(3)}}
    kw = dict(sensors=["GT", "NeRF", "USS"], num_points=3, res_map=32,
              height_tolerance=0.1, num_plot_pts=2, robot=robot,
              num_ray_steps=8)
    both(lambda: PP.plot_maps_per_image(scene, data, metrics,
                                        save_dir=str(tmp_path / "p"), **kw),
         lambda: JP.plot_maps_per_image(jscene, data, metrics,
                                        save_dir=str(tmp_path / "j"), **kw))
    assert sorted(os.listdir(tmp_path / "p")) == ["map0.png", "map2.png"]


def test_plot_scan_maps_matches_jax(tmp_path):
    data, _ = _data_dict(seed=7)
    both(lambda: PP.plot_scan_maps(data, ["NeRF", "USS"], str(tmp_path / "p.png"),
                                   extent=[-1, 1, -1, 1]),
         lambda: JP.plot_scan_maps(data, ["NeRF", "USS"], str(tmp_path / "j.png"),
                                   extent=[-1, 1, -1, 1]))
    assert written(tmp_path / "p.png")


def _metrics(seed=8):
    rng = np.random.default_rng(seed)
    zones = ("zone1", "zone2", "zone3")
    out = {}
    for s in ("NeRF", "ToF", "USS"):
        out[s] = {}
        for suffix in ("", "_inv", "_inv_360"):
            inl = rng.random(3) * 0.6
            out[s]["nn_mean" + suffix] = dict(zip(zones, rng.random(3)))
            out[s]["nn_median" + suffix] = dict(zip(zones, rng.random(3)))
            out[s]["nn_inlier" + suffix] = dict(zip(zones, inl))
            out[s]["nn_outlier_too_close" + suffix] = dict(
                zip(zones, rng.random(3) * 0.3))
    out["ToF"]["nn_mean"]["zone2"] = np.nan
    return out


@pytest.mark.parametrize("ranges", [None, {"zone1": [0, 1], "zone2": [0, 2],
                                           "zone3": [0, 100]}])
def test_plot_nnd_summary_matches_jax(ranges, tmp_path):
    # the bars of each panel: means, medians, inliers and the stacked
    # too-close / too-far outlier shares
    m = _metrics()
    both(lambda: PP.plot_nnd_summary(m, path=str(tmp_path / "p.png"),
                                     zone_ranges=ranges),
         lambda: JP.plot_nnd_summary(m, path=str(tmp_path / "j.png"),
                                     zone_ranges=ranges))
    assert written(tmp_path / "p.png")


@pytest.mark.parametrize("negative_loss", [False, True])
def test_plot_training_curves_matches_jax(negative_loss, tmp_path):
    rng = np.random.default_rng(9)
    logs = {"step": list(range(20)), "loss": list(rng.random(20) + 0.1),
            "psnr": list(rng.random(20) * 20), "mnn": [np.nan] * 19 + [0.3]}
    if negative_loss:
        logs["loss"][3] = -1.0
    both(lambda: PP.plot_training_curves(logs, str(tmp_path / "p.png")),
         lambda: JP.plot_training_curves(logs, str(tmp_path / "j.png")))
    assert written(tmp_path / "p.png")


def test_plot_pointclouds_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    os.makedirs(tmp_path / "nerf_pcl")
    for i in range(3):
        save_pcd(str(tmp_path / "nerf_pcl" / f"{i}.pcd"),
                 rng.standard_normal((50 + i, 3)).astype(np.float32))
    xyz_p, xyz_j = both(
        lambda: PP.plot_pointclouds(str(tmp_path), path=str(tmp_path / "p.png")),
        lambda: JP.plot_pointclouds(str(tmp_path), path=str(tmp_path / "j.png")))
    np.testing.assert_array_equal(xyz_p, xyz_j)
    assert xyz_p.shape == (153, 3) and written(tmp_path / "p.png")


def test_plot_ablation_bars_matches_jax(tmp_path):
    args = ([0, 1, 2, 3], [0.11, 0.10, 0.14, 0.23],
            {"50%": [30, 24, 51, 21], "25%": [83, 50, 59, 70]})
    p, _ = both(
        lambda: PP.plot_ablation_bars(*args, path=str(tmp_path / "p.png")),
        lambda: JP.plot_ablation_bars(*args, path=str(tmp_path / "j.png")))
    assert p == str(tmp_path / "p.png") and written(p)


# ------------------------------------------------------------- PSO plots
LIMS = {"training": {"pixs_valid_uss": [0.1, 0.9], "pixs_valid_tof": [0.1, 0.9]},
        "occ_grid": {"update_interval": [1, 16]}}


@pytest.fixture(scope="module")
def pso_dir(tmp_path_factory):
    """A 20-evaluation swarm of the port's PSO on a synthetic objective."""
    root = tmp_path_factory.mktemp("pso")
    save = str(root / "pso")
    w = PSOWrapper(LIMS, save, T=20, termination_by_time=False,
                   rng=np.random.default_rng(5))
    metric = SyntheticMetric("gauss", np.tile([[0.0, 1.0]], (3, 1)),
                             np.random.default_rng(1), str(root))
    for _ in range(20):
        hp = w.get_next_hparams()
        x = np.array([hp[k] for k in w.space.order])
        w.update(float(metric.gauss(w.space.normalize(x))))
    return save


def test_load_history_matches_jax(pso_dir):
    got, want = PO.load_history(pso_dir), JO.load_history(pso_dir)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert PO.hparam_names(got) == JO.hparam_names(want)
    assert len(PO.hparam_names(got)) == 3 and got["score"].shape == (20,)


@pytest.mark.parametrize("n", [1, 5, 10])
def test_summarize_pso_table_matches_jax(pso_dir, n):
    got, want = PO.summarize_pso(pso_dir, n), JO.summarize_pso(pso_dir, n)
    assert got == want
    assert got["best_score"] == float(np.nanmin(PO.load_history(pso_dir)["score"]))


@pytest.mark.parametrize("name,kw", [
    ("plot_convergence", {}),
    ("plot_convergence", {"score_min": 0.0, "score_max": 2.0}),
    ("plot_hparam_scores", {}),
    ("plot_hparam_trajectories", {}),
    ("plot_pso_results", {}),
    ("plot_pso_results", {"score_min": 0.0, "converged_since_n": 3}),
])
def test_pso_plots_match_jax(pso_dir, name, kw, tmp_path):
    p, _ = both(
        lambda: getattr(PO, name)(pso_dir, out_path=str(tmp_path / "p.png"), **kw),
        lambda: getattr(JO, name)(pso_dir, out_path=str(tmp_path / "j.png"), **kw))
    assert p == str(tmp_path / "p.png") and written(p)


def test_plot_metric_landscape_matches_jax(pso_dir, tmp_path):
    def objective(xy):
        return np.sin(xy[:, 0]) + np.cos(xy[:, 1] / 10.0)

    p, _ = both(
        lambda: PO.plot_metric_landscape(pso_dir, objective,
                                         out_path=str(tmp_path / "p.png"), res=16),
        lambda: JO.plot_metric_landscape(pso_dir, objective,
                                         out_path=str(tmp_path / "j.png"), res=16))
    assert written(p)


def test_plot_all_writes_the_suite(pso_dir):
    paths = PO.plot_all(pso_dir, score_min=0.0, converged_since_n=4)
    assert [os.path.basename(p) for p in paths] == [
        "pso_convergence.png", "pso_hparam_scores.png", "pso_trajectories.png",
        "pso_results.png"]
    assert all(written(p) for p in paths)


# ------------------------------------------------------ without matplotlib
def test_port_modules_import_and_run_without_matplotlib(pso_dir, tmp_path):
    # a fresh interpreter in which matplotlib cannot be imported: every new
    # module imports, the numpy/csv functions run and agree with this
    # process's, and each plot raises ImportError naming matplotlib
    summary = PO.summarize_pso(pso_dir, 5)
    code = textwrap.dedent(f"""
        import importlib, json, sys
        import numpy as np

        class NoMatplotlib:
            def find_spec(self, name, path=None, target=None):
                if name == "matplotlib" or name.startswith("matplotlib."):
                    raise ImportError(f"No module named {{name!r}}")

        sys.meta_path.insert(0, NoMatplotlib())
        mods = ["virus_nerf_tpu_torch.analysis",
                "virus_nerf_tpu_torch.analysis.result_plots",
                "virus_nerf_tpu_torch.analysis.uss_experiments",
                "virus_nerf_tpu_torch.evaluation.plots",
                "virus_nerf_tpu_torch.optimization",
                "virus_nerf_tpu_torch.optimization.plots",
                "virus_nerf_tpu_torch.utils",
                "virus_nerf_tpu_torch.utils.deployment",
                "virus_nerf_tpu_torch.utils.logging",
                "virus_nerf_tpu_torch.run", "virus_nerf_tpu_torch.quality_run"]
        for m in mods:
            importlib.import_module(m)
        from virus_nerf_tpu_torch.optimization import plots as PO
        from virus_nerf_tpu_torch.analysis import uss_experiments as U
        from virus_nerf_tpu_torch.evaluation import plots as PP
        rep = PO.summarize_pso({pso_dir!r}, 5)
        assert U.lin_interpolate([1.0, 2.0], 3).tolist() == [1.0, 1.5, 2.0]
        errors = []
        for fn in (lambda: PO.plot_convergence({pso_dir!r}, {str(tmp_path / "x.png")!r}),
                   lambda: PP.plot_training_curves({{"loss": [1.0]}}),
                   lambda: U.plot_tilted_object("nowhere")):
            try:
                fn()
            except ImportError as e:
                errors.append(str(e))
        assert len(errors) == 3 and all("matplotlib" in e for e in errors), errors
        assert "matplotlib" not in sys.modules and "jax" not in sys.modules
        print(json.dumps(rep))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    assert json.loads(proc.stdout.strip().splitlines()[-1]) == json.loads(
        json.dumps(summary))
    assert not (tmp_path / "x.png").exists()

