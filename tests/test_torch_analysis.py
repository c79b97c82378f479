"""The port's offline analyses (``virus_nerf_tpu_torch/analysis/``) against
the JAX package's (``virus_nerf_tpu/analysis/``) on a seed-made copy of the
reference's USS lab-experiment layout: the loaders, the offset correction,
the interpolation and the statistics grids exactly, and the figures by the
arrays handed to matplotlib (``test_torch_plots.both``) and the files
written."""

import os

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from virus_nerf_tpu.analysis import result_plots as JR  # noqa: E402
from virus_nerf_tpu.analysis import uss_experiments as JU  # noqa: E402
from virus_nerf_tpu_torch import analysis as PA  # noqa: E402
from virus_nerf_tpu_torch.analysis import result_plots as PR  # noqa: E402
from virus_nerf_tpu_torch.analysis import uss_experiments as PU  # noqa: E402
from virus_nerf_tpu_torch.data.pcl import save_pcd  # noqa: E402

from test_analysis import OBJECTS, SENSORS, SURFACES  # noqa: E402
from test_analysis import experiment_dir  # noqa: E402,F401  (the fixture)
from test_torch_plots import both, written  # noqa: E402


def test_package_exports_the_jax_names():
    import virus_nerf_tpu.analysis as JA

    assert PA.__all__ == JA.__all__
    for name in PA.__all__:
        assert callable(getattr(PA, name)), name


@pytest.mark.parametrize("measurement", ["first", "second", "third"])
@pytest.mark.parametrize("surface", SURFACES)
def test_load_experiment_csv_matches_jax(experiment_dir, measurement, surface):
    for sensor in SENSORS:
        for obj in OBJECTS:
            got = PU.load_experiment_csv(experiment_dir, sensor, obj, surface,
                                         measurement)
            want = JU.load_experiment_csv(experiment_dir, sensor, obj, surface,
                                          measurement)
            assert list(got.columns) == list(want.columns)
            for key in want.columns:
                np.testing.assert_array_equal(got.columns[key],
                                              want.columns[key])
            assert got.get(1.0, 0) is None or got.get(1.0, 0).dtype == np.float64


def test_nan_cells_are_dropped_as_jax(tmp_path):
    d = tmp_path / "secondMeasurement"
    d.mkdir()
    (d / "URM37_small.csv").write_text("0.5m_0deg,1m_0deg\n0.51,\n,1.02\n0.5,1.0\n")
    got = PU.load_experiment_csv(str(tmp_path), "URM37", "small", "cardboard",
                                 "second")
    want = JU.load_experiment_csv(str(tmp_path), "URM37", "small", "cardboard",
                                  "second")
    for key in want.columns:
        np.testing.assert_array_equal(got.columns[key], want.columns[key])
    assert got.get(0.5, 0).tolist() == [0.51, 0.5]


@pytest.mark.parametrize("first", [True, False])
def test_correct_measurement_matches_jax(first):
    meas = np.random.default_rng(1).random(30) * 3
    got, want = PU.correct_measurement(meas, first), JU.correct_measurement(
        meas, first)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data,fills,check", [
    ([1.0, 0.0, 2.0], 4, True), ([1.0, 2.0, 3.5, 0.2], 7, True),
    ([1.0, 0.0, 2.0], 4, False), ([3.0], 5, True), ([], 3, False),
])
def test_lin_interpolate_matches_jax(data, fills, check):
    got = PU.lin_interpolate(data, fills, check)
    want = JU.lin_interpolate(data, fills, check)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("measurement,dists,angles,first", [
    ("first", (0.25, 0.5, 1.0, 2.0), (-40, -20, 0, 20, 40), True),
    ("second", (0.25, 0.5, 1.0, 2.0), (0,), False),
    ("third", (1.0, 2.0), (0, 22, 45, 67, 90), False),
    ("third", (1.0, 3.0), (0, 10), False),  # cells with no column: zeros
])
def test_stats_grid_matches_jax(experiment_dir, measurement, dists, angles,
                                first):
    args = (experiment_dir, "MB1603", "large", "cardboard", measurement)
    rescale = {1.0: 1.01, 2.0: 1.98} if first else None
    got = PU._stats_grid(PU.load_experiment_csv(*args), dists, angles, first,
                         rescale)
    want = JU._stats_grid(JU.load_experiment_csv(*args), dists, angles, first,
                          rescale)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,args", [
    ("plot_angular_characterization", ("MB1603",)),
    ("plot_sensor_comparison", ()),
    ("plot_tilted_object", ()),
])
def test_uss_figures_match_jax(experiment_dir, name, args, tmp_path):
    p, _ = both(
        lambda: getattr(PU, name)(experiment_dir, *args,
                                  out_path=str(tmp_path / "p.png")),
        lambda: getattr(JU, name)(experiment_dir, *args,
                                  out_path=str(tmp_path / "j.png")))
    assert p == str(tmp_path / "p.png") and written(p)


def test_uss_main_writes_the_three_figures(experiment_dir, tmp_path, capsys):
    PU.main(["--data-dir", experiment_dir, "--out-dir", str(tmp_path)])
    printed = capsys.readouterr().out.split()
    assert [os.path.basename(p) for p in printed] == [
        "MB1603.png", "all_sensors.png", "object_tilted.png"]
    assert all(written(p) for p in printed)


@pytest.mark.parametrize("custom", [False, True])
def test_calibration_error_chart_matches_jax(custom, tmp_path):
    kw = {}
    if custom:
        kw = dict(error_deg=[0, 1, 2], mnn=[0.1, 0.2, 0.15],
                  convergence_s={"50%": [10, 20, 15], "10%": [30, 40, 5]})
    p, _ = both(lambda: PR.plot_calibration_error(str(tmp_path / "p.png"), **kw),
                lambda: JR.plot_calibration_error(str(tmp_path / "j.png"), **kw))
    assert written(p)
    assert PR.REF_CALIBRATION_STUDY == JR.REF_CALIBRATION_STUDY


@pytest.mark.parametrize("max_points", [2_000_000, 700])
def test_pointcloud_map_matches_jax(tmp_path, max_points):
    d = tmp_path / "run" / "nerf_pcl"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        save_pcd(str(d / f"{100 + i}.pcd"),
                 rng.standard_normal((500, 3)).astype(np.float32))
    run = str(tmp_path / "run")
    p, _ = both(
        lambda: PR.plot_pointclouds(run, str(tmp_path / "p.png"),
                                    max_points=max_points),
        lambda: JR.plot_pointclouds(run, str(tmp_path / "j.png"),
                                    max_points=max_points))
    assert written(p)
    with pytest.raises(FileNotFoundError):
        PR.plot_pointclouds(run, pcl_subdir="missing")


def test_result_plots_main(tmp_path, capsys):
    PR.main(["calibration", "--out", str(tmp_path / "c.png")])
    assert written(tmp_path / "c.png")
    d = tmp_path / "run" / "nerf_pcl"
    d.mkdir(parents=True)
    save_pcd(str(d / "1.pcd"), np.ones((10, 3), np.float32))
    PR.main(["pointclouds", "--dir", str(tmp_path / "run")])
    assert written(tmp_path / "run" / "pointclouds.png")
    assert capsys.readouterr().out.split()[-1].endswith("pointclouds.png")
