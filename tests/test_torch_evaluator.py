"""Parity of the port's evaluator (virus_nerf_tpu_torch/evaluation/) with
the JAX ``Evaluator``: both score the same trained model (the JAX trainer's
parameters and grid after a few steps, converted with ``convert.py``) on
the same images at small sizes (4 images of 32x24, 64-ray scans, 16 x 2
XOR hash of 2^12 rows, 32^3 grid).  Also the density slice, the LiDAR
packing (exactly) and its scoring, the point-cloud export, the plots'
need for matplotlib, the numpy copies (geometry, metrics) against the JAX
modules, and ``quality_run`` end to end at a tiny size."""

import json
import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from virus_nerf_tpu.configs.config import Config as JConfig
from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset
from virus_nerf_tpu.data.dataset import get_sync_idxs
from virus_nerf_tpu.evaluation import Evaluator as JEvaluator
from virus_nerf_tpu.evaluation import geometry as jgeo
from virus_nerf_tpu.evaluation import metrics as jmet
from virus_nerf_tpu.training import Trainer as JTrainer
from virus_nerf_tpu_torch import quality_run
from virus_nerf_tpu.data.pcl import load_pcd as j_load_pcd
from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.convert import grid_from_jax, params_from_jax
from virus_nerf_tpu_torch.data.pcl import load_pcd
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.evaluation import geometry as tgeo
from virus_nerf_tpu_torch.evaluation import metrics as tmet
from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator, _sync_idxs
from virus_nerf_tpu_torch.models.ngp import NGPModel

torch.set_num_threads(1)

DATA_KW = dict(n_images=4, img_wh=(32, 24), n_gt_points=20000)
SENSORS = ("GT", "NeRF", "ToF", "USS")


def eval_config(cfg):
    m, t, ev = cfg.model, cfg.training, cfg.evaluation
    m.hash_variant = "xor"
    m.hash_levels, m.hash_features_per_level = 16, 2
    m.hash_log2_T, m.hash_max_res, m.grid_size = 12, 64, 32
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 256
    t.sample_budget = 128 * 12
    t.sampling_strategy = {"imgs": "all",
                           "pixs": {"valid_uss": 0.4, "valid_tof": 0.4}}
    t.sensors = ["USS", "ToF"]
    t.max_steps, t.max_time = 16, 1e9
    cfg.occ_grid.batch_size, cfg.occ_grid.update_interval = 64, 4
    ev.eval_every_n_steps = 8
    ev.res_angular, ev.res_map = 64, 64
    ev.batch_size, ev.max_samples_per_ray = 512, 32
    return cfg


class Scored:
    """One trained JAX model scored by both evaluators."""

    def __init__(self):
        jcfg, cfg = eval_config(JConfig()), eval_config(Config())
        jds, jscene, info = j_make_dataset(**DATA_KW)
        jt = JTrainer(jcfg, jds, scene=jscene)
        state = jt.train()
        self.jev = JEvaluator(jt.model, jcfg, jds, jscene, img_wh=info["img_wh"])
        self.idxs = np.arange(jds.n_images)
        self.jparams, self.jocc = state.params, state.grid.occ_bool

        pds, pscene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
        m = cfg.model
        self.model = NGPModel(
            scale=m.scale, levels=m.hash_levels,
            feature_per_level=m.hash_features_per_level, log2_T=m.hash_log2_T,
            base_res=m.hash_base_res, max_res=m.hash_max_res,
            grid_size=m.grid_size, hash_variant=m.hash_variant, device="cpu",
        )
        self.model.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, state.params), device="cpu"
        ))
        self.occ = grid_from_jax(jax.tree.map(np.asarray, state.grid),
                                 device="cpu").occ_bool
        self.ev = Evaluator(cfg, pds, pscene, img_wh=info["img_wh"], device="cpu")
        self.metrics_j = self.jev.evaluate(self.jparams, self.jocc,
                                           depth_img_idxs=self.idxs,
                                           sensors=SENSORS)
        self.metrics = self.ev.evaluate(self.model, self.occ,
                                        depth_img_idxs=self.idxs, sensors=SENSORS)


@pytest.fixture(scope="module")
def scored():
    return Scored()


def test_scan_depths_match_jax(scored):
    rays_o, rays_d = tgeo.create_scan_rays(
        scored.ev._scan_origins(scored.idxs), 64
    )
    got = scored.ev.render_batched(scored.model, scored.occ, rays_o, rays_d)
    want = scored.jev.render_batched(scored.jparams, scored.jocc, rays_o, rays_d)
    for k in ("depth", "opacity", "rgb"):
        assert got[k].shape == want[k].shape
        # the same exact march, float32 model and compositing in another
        # op order
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert np.ptp(got["depth"]) > 0.05  # the scan is not trivial


@pytest.mark.parametrize("sensor", ["NeRF", "ToF", "USS"])
def test_depth_metrics_match_jax(scored, sensor):
    got, want = scored.metrics[sensor], scored.metrics_j[sensor]
    assert set(got) == set(want)
    for key in ("nn_mean", "nn_median", "nn_inlier", "nn_mean_inv",
                "nn_inlier_inv", "nn_mean_inv_360"):
        for zone in ("zone1", "zone2", "zone3"):
            # nearest neighbours of scan points that agree within 1e-4
            np.testing.assert_allclose(got[key][zone], want[key][zone],
                                       rtol=1e-4, atol=0, err_msg=(key, zone))
    assert np.isfinite(got["nn_mean"]["zone3"])


def test_color_metrics_match_jax(scored):
    got, want = scored.metrics["NeRF"], scored.metrics_j["NeRF"]
    # mean PSNR / SSIM of renders that agree within 1e-4
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=1e-4)
    assert 5.0 < got["psnr"] < 60.0


def test_numpy_copies_match_jax_modules():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((300, 2)).astype(np.float32)
    b = rng.standard_normal((200, 2)).astype(np.float32)
    a[::7] = np.nan
    for x, y in zip(tgeo.find_nearest_neighbour(a, b, ignore_nan=True),
                    jgeo.find_nearest_neighbour(a, b, ignore_nan=True)):
        np.testing.assert_array_equal(x, y)
    o = rng.standard_normal((3, 3))
    for x, y in zip(tgeo.create_scan_rays(o, 16), jgeo.create_scan_rays(o, 16)):
        np.testing.assert_array_equal(x, y)
    fov = {"CAM1": np.array([[-0.5, 0.5], [2.5, -2.9], [0.0, 1.0]])}
    robot = {"CAM1": rng.standard_normal((3, 2))}
    pos, pos_o = rng.standard_normal((48, 2)), rng.standard_normal((48, 2))
    for x, y in zip(tgeo.limit_fov(pos, pos_o, fov, 3, robot),
                    jgeo.limit_fov(pos, pos_o, fov, 3, robot)):
        np.testing.assert_array_equal(x, y)
    zones = {"zone1": (0, 1), "zone3": (0, 100)}
    d, dg = rng.random(48) * 2, rng.random(48) * 2
    got = tmet.nn_metrics(pos, pos_o, d, dg, 3, True, zones, 0.1)
    want = jmet.nn_metrics(pos, pos_o, d, dg, 3, True, zones, 0.1)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    img, gt = rng.random((2, 16, 16, 3)), rng.random((2, 16, 16, 3))
    assert tmet.psnr(img, gt) == jmet.psnr(img, gt)
    assert tmet.ssim(img, gt) == jmet.ssim(img, gt)


def test_sync_idxs_match_jax():
    jds, _, _ = j_make_dataset(**DATA_KW)
    sids = np.array([0, 1, 0, 1])
    times = np.array([0.0, 0.05, 1.0, 3.0])
    jds = jds._replace(sensor_ids=sids, times=times)
    np.testing.assert_array_equal(_sync_idxs(times, sids, [0, 1, 2, 3]),
                                  get_sync_idxs(jds, [0, 1, 2, 3]))


def test_entry_points_refuse_the_cpu_fallback():
    # without a card, the defaults (cuda) raise instead of running on the CPU
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda defaults are usable")
    with pytest.raises((RuntimeError, AssertionError)):
        make_synthetic_dataset(n_images=2, img_wh=(8, 6), n_gt_points=10)
    ds, scene, _ = make_synthetic_dataset(n_images=2, img_wh=(8, 6),
                                          n_gt_points=10, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        Evaluator(Config(), ds, scene, img_wh=(8, 6))
    # the quality run's default device is the card too; --save-renders is
    # taken (render export is ported)
    args = quality_run.parse_args(["--save-renders", "x"])
    assert args.device == "cuda" and args.save_renders == "x"


def test_quality_run_tiny_on_cpu(tmp_path, monkeypatch):
    # the entry point end to end at a tiny size: its JSON has the JAX
    # tool's keys (tools/quality_run.py:198-231) plus device/eval_seconds
    base = quality_run.quality_config

    def tiny(args):
        cfg = base(args)
        cfg.model.hash_log2_T, cfg.model.hash_max_res = 12, 64
        cfg.model.grid_size = 32
        cfg.training.march_candidates = cfg.training.march_resolution = 128
        cfg.occ_grid.batch_size = 64
        ev = cfg.evaluation
        ev.res_angular, ev.res_map = 32, 64
        ev.batch_size, ev.max_samples_per_ray = 4096, 8
        return cfg

    def small_images(**kw):
        return make_synthetic_dataset(**{**kw, "img_wh": (40, 30),
                                         "n_gt_points": 20000})

    monkeypatch.setattr(quality_run, "quality_config", tiny)
    monkeypatch.setattr(quality_run, "make_synthetic_dataset", small_images)
    out = tmp_path / "q.json"
    quality_run.main([
        "--steps", "2", "--batch-size", "1024", "--hash-variant", "xor",
        "--hash-levels", "16", "--hash-feats", "2", "--samples-per-ray", "4",
        "--max-samples", "8", "--eval-every", "4", "--eval-occ", "both",
        "--device", "cpu", "--out", str(out),
        "--save-renders", str(tmp_path / "renders"),
    ])
    res = json.loads(out.read_text())
    # the JAX tool's layout (tools/quality_run.py:185-193): metrics.csv and
    # renders/ from the grid's evaluation, renders_ones/ from the all-ones
    # colour pass, three images of each of the 8 held-out views
    root = tmp_path / "renders"
    assert (root / "metrics.csv").exists()
    for sub in ("renders", "renders_ones"):
        names = sorted(os.listdir(root / sub))
        assert len(names) == 3 * 8, (sub, names)
        assert {n.split("_0")[0] for n in names} == {"rgb", "rgb_gt", "depth"}
    assert res["steps"] == 8 and res["device"] == "cpu"
    assert set(res) >= {
        "hash_variant", "hash_levels", "hash_feats", "hash_log2t",
        "samples_per_ray", "max_samples", "march_resolution", "batch_size",
        "seed", "steps", "train_seconds", "train_rays_per_sec", "psnr", "ssim",
        "eval_occ", "force_full_hier", "psnr_occ_ones", "ssim_occ_ones",
        "NeRF", "ToF", "USS",
    }
    for sensor in ("NeRF", "ToF", "USS"):
        assert set(res[sensor]) == {
            "nn_mean_zone3", "nn_median_zone3", "nn_inlier_zone3",
            "nn_mean_inv_zone3", "nn_mean_inv_360_zone3",
        }
    assert np.isfinite(res["NeRF"]["nn_mean_zone3"])


# ------------------------------------------------ density slice, LiDAR, export
@pytest.mark.parametrize("heights,tol,threshold", [
    (1, 0.0, 5.0), (3, 0.05, 5.0), (4, 0.2, 1.0)])
def test_density_slice_matches_jax(scored, heights, tol, threshold):
    # 24 x 24 x A probes in chunks of the evaluation's 512 (padded last)
    kw = dict(res_map=24, height_w=0.5, num_avg_heights=heights,
              tolerance_w=tol, threshold=threshold)
    dm, thr = scored.ev.density_slice(scored.model, **kw)
    dm_j, thr_j = scored.jev.density_slice(scored.jparams, **kw)
    assert dm.shape == thr.shape == (24, 24) and dm.dtype == dm_j.dtype
    # float32 densities in another op order (the model tests' tolerance)
    np.testing.assert_allclose(dm, dm_j, rtol=1e-5)
    near = np.abs(dm_j - threshold) <= 1e-5 * threshold
    np.testing.assert_array_equal(thr[~near], thr_j[~near])
    np.testing.assert_array_equal(thr, (dm >= threshold).astype(np.float32))
    assert np.ptp(dm) > 0


def _lidar_inputs(seed):
    rng = np.random.default_rng(seed)
    clouds = [rng.uniform(-2.0, 2.0, (n, 3)) for n in (300, 0, 57, 120)]
    poses = np.tile(np.eye(3, 4), (4, 1, 1))
    poses[:, :, 3] = rng.uniform(-0.5, 0.5, (4, 3))
    heights = rng.uniform(-0.2, 0.2, 4)
    return clouds, poses, heights


@pytest.mark.parametrize("seed,tol", [(0, 0.1), (1, 0.3), (2, 0.0)])
def test_pack_lidar_scans_matches_jax_exactly(seed, tol):
    clouds, poses, heights = _lidar_inputs(seed)
    got = Evaluator.pack_lidar_scans(clouds, poses, heights, tol)
    want = JEvaluator.pack_lidar_scans(clouds, poses, heights, tol)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)  # NaN in the same places


def test_lidar_scored_through_extra_sensor_data_as_jax(scored):
    # one LiDAR cloud a test image around the scene's GT points, packed and
    # scored beside the NeRF scan; with fov={} as well (the GT unlimited)
    gt = scored.ev.scene.c2w(scored.ev._scan_origins(scored.idxs))
    rng = np.random.default_rng(4)
    clouds = [o + rng.uniform(-1.0, 1.0, (200, 3)) for o in gt]
    poses = np.tile(np.eye(3, 4), (len(gt), 1, 1))
    poses[:, :, 3] = gt
    packed = Evaluator.pack_lidar_scans(clouds, poses, gt[:, 2], 0.2)
    for fov in (None, {}):
        got, _ = scored.ev.evaluate_depth(
            scored.model, scored.occ, scored.idxs, ("GT", "NeRF", "LiDAR"),
            fov=fov, extra_sensor_data={"LiDAR": packed})
        want, _ = scored.jev.evaluate_depth(
            scored.jparams, scored.jocc, scored.idxs, ("GT", "NeRF", "LiDAR"),
            fov=fov, extra_sensor_data={"LiDAR": packed})
        for key in ("nn_mean", "nn_median", "nn_inlier", "nn_mean_inv"):
            for zone in ("zone1", "zone2", "zone3"):
                # exact inputs: the LiDAR rows agree bit for bit
                assert got["LiDAR"][key][zone] == want["LiDAR"][key][zone] or (
                    np.isnan(got["LiDAR"][key][zone])
                    and np.isnan(want["LiDAR"][key][zone])), (fov, key, zone)
                np.testing.assert_allclose(got["NeRF"][key][zone],
                                           want["NeRF"][key][zone], rtol=1e-4)


def test_export_nerf_pointcloud_matches_jax(scored, tmp_path):
    origins = scored.ev.scene.c2w(scored.ev._scan_origins(scored.idxs))[:2]
    kw = dict(rays_o_w=origins, num_heights=3, height_range=0.2,
              min_opacity=0.5)
    pts = scored.ev.export_nerf_pointcloud(
        scored.model, scored.occ, save_path=str(tmp_path / "port.pcd"), **kw)
    pts_j = scored.jev.export_nerf_pointcloud(
        scored.jparams, scored.jocc, save_path=str(tmp_path / "jax.pcd"), **kw)
    # the same hits (opacities within 1e-4 of each other, none near the
    # 0.5 cut), at depths within the scan tests' 1e-4 of the scene's scale
    assert pts.shape == pts_j.shape and pts.shape[0] > 0
    np.testing.assert_allclose(pts, pts_j, rtol=0, atol=1e-3)
    back = load_pcd(str(tmp_path / "port.pcd"))
    np.testing.assert_array_equal(back, pts.astype(np.float32))
    np.testing.assert_array_equal(j_load_pcd(str(tmp_path / "port.pcd")), back)


# ------------------------------------------------------------------- plots
def test_plots_need_matplotlib_and_say_so(scored, tmp_path):
    # where matplotlib is missing, plot=True raises ImportError naming it
    # before any render
    with mock.patch.dict(sys.modules, {"matplotlib": None,
                                       "matplotlib.pyplot": None}), \
            mock.patch.object(Evaluator, "render_batched") as render:
        with pytest.raises(ImportError, match="matplotlib"):
            scored.ev.evaluate(scored.model, scored.occ,
                               depth_img_idxs=scored.idxs, sensors=SENSORS,
                               save_dir=str(tmp_path), plot=True)
        render.assert_not_called()
    # without a save_dir nothing is plotted, as in the JAX evaluator
    with mock.patch.dict(sys.modules, {"matplotlib": None}):
        m = scored.ev.evaluate(scored.model, scored.occ, color_img_idxs=[],
                               depth_img_idxs=scored.idxs[:1],
                               sensors=("GT", "NeRF"), plot=True)
    assert np.isfinite(m["NeRF"]["nn_mean"]["zone3"])


def test_evaluate_plot_writes_the_jax_files(scored, tmp_path):
    pytest.importorskip("matplotlib")
    scored.ev.evaluate(scored.model, scored.occ, depth_img_idxs=scored.idxs,
                       sensors=SENSORS, save_dir=str(tmp_path / "port"),
                       plot=True)
    scored.jev.evaluate(scored.jparams, scored.jocc,
                        depth_img_idxs=scored.idxs, sensors=SENSORS,
                        save_dir=str(tmp_path / "jax"), plot=True)
    for side in ("port", "jax"):
        assert (tmp_path / side / "metrics.png").stat().st_size > 0
    assert sorted(os.listdir(tmp_path / "port" / "maps")) == sorted(
        os.listdir(tmp_path / "jax" / "maps")) != []
