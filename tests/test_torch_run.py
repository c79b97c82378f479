"""The port's experiment path on a recorded room (the ETHZ fixture) against
the JAX package: the training step on two cameras and two sensor stacks,
the intermediate evaluation and ``logs.csv``, a JAX checkpoint scored by
the port's evaluator (``metrics.csv``, renders), the port's checkpoints
(resume, drift), and ``run.py`` / ``run_ablation.py`` end to end on the
CPU, also in a fresh interpreter without jax.

Small: the fixture holds 10 images a camera at 64x48 and 20,000 map
points; the model is the additive 16 x F = 2 hash of 2^12 rows a level, a
32^3 grid, 128 rays a step."""

import csv
import math
import os
import shutil
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from virus_nerf_tpu.configs.config import Config as JConfig
from virus_nerf_tpu.data import make_dataset as j_make_dataset
from virus_nerf_tpu.data.dataset import sample_batch as j_sample_batch
from virus_nerf_tpu.evaluation import Evaluator as JEvaluator
from virus_nerf_tpu.run import train_and_evaluate as j_train_and_evaluate
from virus_nerf_tpu.training import Trainer as JTrainer
from virus_nerf_tpu_torch import run, run_ablation
from virus_nerf_tpu_torch.configs.config import Config, apply_cli_overrides
from virus_nerf_tpu_torch.convert import (
    adam_state_from_jax,
    grid_from_jax,
    params_from_jax,
    state_from_jax_checkpoint,
)
from virus_nerf_tpu_torch.data import make_dataset
from virus_nerf_tpu_torch.data.dataset import Batch
from virus_nerf_tpu_torch.data.png import read_png
from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
from virus_nerf_tpu_torch.evaluation.geometry import create_scan_rays
from virus_nerf_tpu_torch.training.trainer import LOG_COLUMNS, Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.make_ethz_fixture import generate_ethz_fixture as tool_fixture  # noqa: E402

FIXTURE_KW = dict(n_images=10, img_wh=(64, 48), n_gt_points=20_000)
RUN_FILES = ("model.npz", "model.npz.json", "logs.csv", "hparams.json",
             "metrics.csv")


def run_config(cfg, dataset_dir):
    """The default config on the ETHZ fixture, cut to a small size."""
    cfg.dataset.name = "ETHZ"
    cfg.ethz.dataset_dir = dataset_dir
    m, t, ev = cfg.model, cfg.training, cfg.evaluation
    m.hash_levels, m.hash_features_per_level = 16, 2
    m.hash_log2_T, m.hash_max_res, m.grid_size = 12, 64, 32
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 256
    t.max_steps, t.max_time = 8, 1e9
    cfg.occ_grid.batch_size, cfg.occ_grid.update_interval = 64, 4
    ev.eval_every_n_steps, ev.num_depth_pts_per_step = 4, 3
    ev.res_angular, ev.res_map = 64, 64
    ev.batch_size, ev.max_samples_per_ray = 512, 32
    ev.num_color_pts = 2
    return cfg


# run.main's flags for the same cut (values are JSON where they parse)
OVERRIDES = [
    "dataset.name=ETHZ", "model.hash_log2_T=12", "model.hash_max_res=64",
    "model.grid_size=32", "training.batch_size=128",
    "training.max_samples_per_ray=32", "training.march_candidates=256",
    "training.march_resolution=256", "training.max_steps=8",
    "training.max_time=1e9", "occ_grid.batch_size=64",
    "occ_grid.update_interval=4", "evaluation.eval_every_n_steps=4",
    "evaluation.num_depth_pts_per_step=3", "evaluation.res_angular=64",
    "evaluation.res_map=64", "evaluation.batch_size=512",
    "evaluation.max_samples_per_ray=32", "evaluation.num_color_pts=2",
]


def copy_of(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return tool_fixture(str(tmp_path_factory.mktemp("ethz")), **FIXTURE_KW)


@pytest.fixture(scope="module")
def data(fixture_dir, tmp_path_factory):
    """Both packages' configs and (train, test) datasets, each loader on its
    own copy of the fixture."""
    base = tmp_path_factory.mktemp("data")
    jcfg = run_config(JConfig(), copy_of(fixture_dir, base / "j"))
    cfg = run_config(Config(), copy_of(fixture_dir, base / "t"))
    jtrain = j_make_dataset(jcfg, "train")
    jtest = j_make_dataset(jcfg, "test", scene=jtrain[1])
    train = make_dataset(cfg, "train", device="cpu")
    test = make_dataset(cfg, "test", scene=train[1], device="cpu")
    return jcfg, cfg, (jtrain, jtest), (train, test)


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX ``train_and_evaluate`` of the config: its save directory
    (model.npz, logs.csv, metrics.csv, renders/) and metrics."""
    jcfg, _, jdata, _ = data
    save = str(tmp_path_factory.mktemp("jax_run") / "run")
    metrics = j_train_and_evaluate(jcfg, datasets=jdata, save_dir=save)
    return save, metrics


def _port_batch(b) -> Batch:
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Batch(
        img_idxs=t(b.img_idxs).long(), pix_idxs=t(b.pix_idxs).long(),
        rays_o=t(b.rays_o), rays_d=t(b.rays_d), rgb=t(b.rgb),
        depths={k: t(v) for k, v in b.depths.items()}, times=t(b.times),
    )


def jax_state_into_port(js, trainer):
    """A port state holding the JAX state's parameters, moments and grid."""
    ps = trainer.init_state()
    ps.model.load_state_dict(params_from_jax(_np(js.params), device="cpu"))
    count, mu, nu = adam_state_from_jax(_np(js.opt_state), device="cpu")
    ps.optimizer.load_moments(ps.model.named_parameters(), count, mu, nu)
    ps.grid = grid_from_jax(_np(js.grid), device="cpu")
    return ps


def _sync_stepped_apart(ps, js, lr):
    """Set the port's parameters and Adam moments to the JAX ones at every
    entry more than 1e-6 apart; returns how many entries that was and the
    largest distance over ``lr`` (as test_torch_trainer_options.py)."""
    pj = params_from_jax(_np(js.params), device="cpu")
    count, mu_j, nu_j = adam_state_from_jax(_np(js.opt_state), device="cpu")
    named = list(ps.model.named_parameters())
    mu, nu, n, worst = {}, {}, 0, 0.0
    with torch.no_grad():
        for name, p in named:
            st = ps.optimizer.state[p]
            apart = (p - pj[name]).abs() > 1e-6
            n += int(apart.sum())
            if apart.any():
                worst = max(worst, float((p - pj[name]).abs()[apart].max()) / lr)
            p.copy_(torch.where(apart, pj[name], p))
            mu[name] = torch.where(apart, mu_j[name], st["mu"])
            nu[name] = torch.where(apart, nu_j[name], st["nu"])
    ps.optimizer.load_moments(named, count, mu, nu)
    return n, worst


def eight_steps(data, sync=False):
    """8 steps of both trainers from the JAX initial state, every draw the
    JAX step bodies' own (their key splits, trainer.py:249, 373) handed to
    the port's train_step_on / grid_update_on, on two cameras (directions
    (2, H*W, 3), cam_idx in {0, 1}) and stacks {1, 3}.  With ``sync`` the
    entries one side's Adam step moved apart are set equal after each
    step.  Returns the losses, sample counts and synced entries a step."""
    jcfg, cfg, ((jds, jscene, _), _), ((pds, pscene, _), _) = data
    jt = JTrainer(jcfg, jds, scene=jscene)
    pt = Trainer(cfg, pds, scene=pscene, device="cpu")
    train_body = jax.jit(jt._make_train_body())
    occ_body = jax.jit(jt._make_occ_body())
    et = jnp.float32(0.0)
    js = jt.init_state(1)
    ps = jax_state_into_port(js, pt)
    t = cfg.training
    out = {k: [] for k in ("loss_j", "loss_p", "rm_j", "rm_p", "vr_j", "vr_p",
                           "synced")}
    for step in range(8):
        if step % pt.grid_update_interval == 0:
            _, k1, k2, k3 = jax.random.split(js.key, 4)
            ray_b, nerf_b = (_port_batch(j_sample_batch(
                jds, k, 32, {"imgs": "all", "pixs": pixs}))
                for k, pixs in ((k1, "valid_tof"), (k2, "valid_uss")))
            noise = jax.random.uniform(jax.random.split(k3)[1], (32, 32, 3),
                                       jnp.float32) * 2.0 - 1.0
            pt.grid_update_on(ps, ray_b, nerf_b, torch.from_numpy(np.array(noise)))
            js = occ_body(js, jds, et)
        _, k_batch, k_render = jax.random.split(js.key, 3)
        batch = j_sample_batch(jds, k_batch, t.batch_size, t.sampling_strategy)
        assert set(np.asarray(jds.cam_idx)[np.asarray(batch.img_idxs)]) == {0, 1}
        noise = torch.from_numpy(np.array(
            jax.random.uniform(k_render, (t.batch_size,))))
        js, mj = train_body(js, jds, et)
        mp = pt.train_step_on(ps, _port_batch(batch), noise)
        for side, m in (("j", mj), ("p", mp)):
            out[f"loss_{side}"].append(float(m["loss"]))
            out[f"rm_{side}"].append(int(m["rm_samples"]))
            out[f"vr_{side}"].append(int(m["vr_samples"]))
        if sync:
            n, worst = _sync_stepped_apart(ps, js, t.lr)
            # an entry is at most one step of each side apart: 2 lr
            assert worst <= 2.0 + 1e-3, (step, worst)
            out["synced"].append(n)
    assert ps.step == 8 and ps.grid.update_step == int(js.grid.update_step) == 2
    assert np.all(np.isfinite(out["loss_p"]))
    # the march is exact: the sample counts agree step by step
    assert out["rm_p"] == out["rm_j"] and out["vr_p"] == out["vr_j"]
    return out


def test_eight_steps_on_ethz_match_jax(data):
    # float32 rendering, loss and Adam in another op order on each side.
    # Adam's step moves a table entry by about lr * sign(g) however small g
    # is, so an entry whose gradient is rounding noise of opposite sign on
    # the two sides (sums in another order: the JAX CPU backward's prefix-
    # sum differences) moves 2 lr apart (ROADMAP C8).  This room gives 280
    # such entries at step 0 and ~10,000 a step after; the losses then
    # drift apart to 7.5e-5 relative at step 2 (measured), within 1e-5
    # through step 1.  The witness below sets those entries equal after
    # each step and holds every step to 1e-5
    out = eight_steps(data)
    np.testing.assert_allclose(out["loss_p"][:2], out["loss_j"][:2], rtol=1e-5)
    np.testing.assert_allclose(out["loss_p"], out["loss_j"], rtol=1e-4)


def test_eight_steps_on_ethz_match_jax_with_entries_stepped_apart_synced(data):
    out = eight_steps(data, sync=True)
    # measured within 3.4e-7 relative
    np.testing.assert_allclose(out["loss_p"], out["loss_j"], rtol=1e-5)
    assert min(out["synced"]) > 0  # every step moves entries apart


def test_intermediate_eval_matches_jax(data, jax_run):
    # the JAX run's trained state in both trainers: the same test images
    # drawn (numpy default_rng(seed).choice, with replacement) and the same
    # mean NND at each chunk end
    jcfg, cfg, ((jds, jscene, _), (jtest, _, jinfo)), \
        ((pds, pscene, _), (ptest, _, info)) = data
    jt = JTrainer(jcfg, jds, test_dataset=jtest, scene=jscene,
                  img_wh=jinfo["img_wh"])
    js = jt.load_checkpoint(os.path.join(jax_run[0], "model.npz"),
                            jt.init_state())
    pt = Trainer(cfg, pds, scene=pscene, device="cpu", test_dataset=ptest,
                 img_wh=info["img_wh"])
    ps = jax_state_into_port(js, pt)
    drawn = {"j": [], "p": []}
    for side, ev in (("j", jt._get_evaluator()), ("p", pt._get_evaluator())):
        orig = ev.evaluate_depth

        def spy(model, occ, idxs, sensors, orig=orig, side=side):
            drawn[side].append(np.asarray(idxs).tolist())
            return orig(model, occ, idxs, sensors=sensors)

        ev.evaluate_depth = spy
    for _ in range(3):
        mnn_j = jt._intermediate_eval(js, 1.0)
        mnn_p = pt._intermediate_eval(ps, 1.0)
        assert math.isfinite(mnn_p)
        np.testing.assert_allclose(mnn_p, mnn_j, rtol=1e-4)
    assert drawn["p"] == drawn["j"] and len(drawn["p"]) == 3
    # min(num_depth_pts_per_step, test images) draws a call
    assert all(len(d) == min(3, ptest.n_images) for d in drawn["p"])
    # no test set: NaN, as the JAX trainer
    assert math.isnan(Trainer(cfg, pds, scene=pscene,
                              device="cpu")._intermediate_eval(ps, 1.0))


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_logs_csv_matches_jax(data, jax_run, tmp_path):
    # the port's own loop (its own draws) over the same 8 steps: the JAX
    # header, one row a step, mnn on each chunk's last row
    _, cfg, _, ((pds, pscene, _), (ptest, _, info)) = data
    pt = Trainer(cfg, pds, scene=pscene, device="cpu", test_dataset=ptest,
                 img_wh=info["img_wh"])
    pt.train()
    pt.save_logs(str(tmp_path / "logs.csv"))
    got = read_csv(tmp_path / "logs.csv")
    want = read_csv(os.path.join(jax_run[0], "logs.csv"))
    assert got[0] == want[0] == list(LOG_COLUMNS)
    assert len(got) == len(want) == 9
    for g, w in zip(got[1:], want[1:]):
        assert g[1] == w[1]  # the step
        assert [v == "nan" for v in g] == [v == "nan" for v in w]
    mnn = [float(r[-1]) for r in got[1:]]
    assert [math.isnan(v) for v in mnn] == [True] * 3 + [False] + [True] * 3 + [False]


def test_chunks_round_down_to_grid_intervals_as_jax(data):
    # eval_every 6 with grid updates every 4: chunks of 4, the JAX rule
    # (trainer.py:564-573), so mnn lands on steps 3 and 7
    _, cfg, _, ((pds, pscene, _), (ptest, _, info)) = data
    c = run_config(Config(), cfg.ethz.dataset_dir)
    c.evaluation.eval_every_n_steps = 6
    pt = Trainer(c, pds, scene=pscene, device="cpu", test_dataset=ptest,
                 img_wh=info["img_wh"])
    pt.train()
    finite = [s for s, v in zip(pt.logs["step"], pt.logs["mnn"])
              if not math.isnan(v)]
    assert finite == [3, 7]


def test_jax_checkpoint_scored_by_the_port(data, jax_run, tmp_path):
    # the JAX run's model.npz through convert.state_from_jax_checkpoint and
    # the port's Evaluator.evaluate(save_dir=...): the JAX run's metrics
    # and metrics.csv layout (tolerances of test_torch_evaluator.py)
    jcfg, cfg, ((jds, jscene, _), (jtest, _, jinfo)), \
        ((pds, pscene, _), (ptest, _, info)) = data
    save, metrics_j = jax_run
    pt = Trainer(cfg, pds, scene=pscene, device="cpu")
    ps = state_from_jax_checkpoint(os.path.join(save, "model.npz"), pt)
    assert ps.step == 8 and ps.optimizer.count == 8
    ev = Evaluator(cfg, ptest, pscene, img_wh=info["img_wh"], device="cpu")
    out = str(tmp_path / "port")
    metrics = ev.evaluate(ps.model, ps.grid.occ_bool, save_dir=out)
    assert list(metrics) == list(metrics_j) == ["USS", "ToF", "NeRF"]
    for sensor in metrics:
        got, want = metrics[sensor], metrics_j[sensor]
        assert set(got) == set(want)
        for key in ("nn_mean", "nn_median", "nn_inlier", "nn_mean_inv",
                    "nn_inlier_inv", "nn_mean_inv_360"):
            for zone in ("zone1", "zone2", "zone3"):
                np.testing.assert_allclose(got[key][zone], want[key][zone],
                                           rtol=1e-4, atol=0,
                                           err_msg=(sensor, key, zone))
        np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-4)
        np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=1e-4)
    assert math.isfinite(metrics["NeRF"]["nn_mean"]["zone3"])
    g, w = read_csv(os.path.join(out, "metrics.csv")), read_csv(
        os.path.join(save, "metrics.csv"))
    assert g[0] == w[0] and [r[0] for r in g] == [r[0] for r in w]
    assert sorted(os.listdir(os.path.join(out, "renders"))) == sorted(
        os.listdir(os.path.join(save, "renders")))
    # the NeRF scans from both sides' states
    jt = JTrainer(jcfg, jds, scene=jscene)
    js = jt.load_checkpoint(os.path.join(save, "model.npz"), jt.init_state())
    jev = JEvaluator(jt.model, jcfg, jtest, jscene, img_wh=jinfo["img_wh"])
    rays_o, rays_d = create_scan_rays(
        ev._scan_origins(np.arange(ptest.n_images)), 64)
    got = ev.render_batched(ps.model, ps.grid.occ_bool, rays_o, rays_d)
    want = jev.render_batched(js.params, js.grid.occ_bool, rays_o, rays_d)
    for k in ("depth", "opacity", "rgb"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert np.ptp(got["depth"]) > 0.05


def test_render_pngs_match_jax_pixels(tmp_path):
    # the same arrays through both save_render_images (the JAX one writes
    # with PIL and matplotlib's turbo): equal pixels
    rng = np.random.default_rng(0)
    rgbs = rng.uniform(-0.1, 1.1, (2, 12, 10, 3)).astype(np.float32)
    gts = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    depths = rng.uniform(0, 3, (2, 12, 10)).astype(np.float32)
    depths[0, 0, :3] = (np.nan, 0.0, -1.0)
    idxs = np.array([3, 11])
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    Evaluator.save_render_images(a, idxs, rgbs, gts, depths)
    JEvaluator.save_render_images(b, idxs, rgbs, gts, depths)
    names = sorted(os.listdir(b))
    assert names == sorted(os.listdir(a)) and len(names) == 6
    assert "depth_011.png" in names
    for name in names:
        want = np.asarray(Image.open(os.path.join(b, name)))
        np.testing.assert_array_equal(read_png(os.path.join(a, name)), want)


def state_equal(trainer, a, b):
    x, y = trainer.state_arrays(a), trainer.state_arrays(b)
    assert x.keys() == y.keys()
    for k in x:
        assert x[k].dtype == y[k].dtype
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("case", ["occ", "ngp_closest"])
def test_save_load_continue_equals_an_unbroken_run(data, tmp_path, case):
    # 8 steps, save, load into a fresh trainer, 8 more: bit for bit the
    # 16-step run (parameters, moments, grid, USS statistics, random stream)
    _, cfg, _, ((pds, pscene, _), _) = data

    def config(steps):
        c = run_config(Config(), cfg.ethz.dataset_dir)
        if case == "ngp_closest":
            c.model.grid_type = "ngp"
            c.ngp_grid.update_interval, c.ngp_grid.warmup_steps = 4, 8
            c.training.sampling_strategy = {
                "imgs": "all", "pixs": {"closest": 0.3, "valid_uss": 0.3}}
        c.training.max_steps = steps
        return c

    whole = Trainer(config(16), pds, scene=pscene, device="cpu")
    want = whole.train()
    first = Trainer(config(8), pds, scene=pscene, device="cpu")
    half = first.train()
    path = str(tmp_path / "ck" / "model.npz")
    first.save_checkpoint(half, path)
    assert os.path.exists(path + ".json")
    second = Trainer(config(16), pds, scene=pscene, device="cpu")
    got = second.train(second.load_checkpoint(path))
    assert got.step == want.step == 16
    assert (got.uss_stats is None) == (case == "occ")
    state_equal(whole, got, want)
    assert first.logs["loss"] + second.logs["loss"] == whole.logs["loss"]


@pytest.mark.parametrize("change", ["hash_levels", "grid_size", "closest"])
def test_loading_a_drifted_config_raises(data, tmp_path, change):
    _, cfg, _, ((pds, pscene, _), _) = data
    trainer = Trainer(cfg, pds, scene=pscene, device="cpu")
    path = str(tmp_path / "model.npz")
    trainer.save_checkpoint(trainer.init_state(), path)
    drifted = run_config(Config(), cfg.ethz.dataset_dir)
    if change == "hash_levels":
        drifted.model.hash_levels = 8
    elif change == "grid_size":
        drifted.model.grid_size = 16
    else:  # the state gains USS statistics
        drifted.training.sampling_strategy = {"imgs": "all", "pixs": "closest"}
    with pytest.raises(ValueError, match="config drift"):
        Trainer(drifted, pds, scene=pscene, device="cpu").load_checkpoint(path)
    # the unchanged config loads it
    trainer.load_checkpoint(path)


def check_run_dir(save, n_color):
    for name in RUN_FILES:
        assert os.path.exists(os.path.join(save, name)), name
    renders = sorted(os.listdir(os.path.join(save, "renders")))
    assert len(renders) == 3 * n_color
    assert {r.split("_")[0] for r in renders} == {"rgb", "depth"}
    rows = read_csv(os.path.join(save, "metrics.csv"))
    assert [r[0] for r in rows[1:]] == ["USS", "ToF", "NeRF"]
    logs = read_csv(os.path.join(save, "logs.csv"))
    assert logs[0] == list(LOG_COLUMNS) and len(logs) == 9


def test_run_main_on_the_cpu_writes_every_file(fixture_dir, tmp_path, capsys):
    d = copy_of(fixture_dir, tmp_path / "ethz")
    save = str(tmp_path / "run")
    args = ["--device", "cpu", "--save-dir", save, "--seed", "3",
            "--override", f"ethz.dataset_dir={d}"]
    for ov in OVERRIDES:
        args += ["--override", ov]
    metrics = run.main(args)
    check_run_dir(save, 2)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("evaluation: psnr=") and "| depth_mnn=" in last
    assert math.isfinite(metrics["NeRF"]["nn_mean"]["zone3"])
    assert Config().seed != 3 and '"seed": 3' in open(
        os.path.join(save, "hparams.json")).read()


def test_run_ablation_skips_a_done_seed(fixture_dir, tmp_path):
    cfg = run_config(Config(), copy_of(fixture_dir, tmp_path / "ethz"))
    base = tmp_path / "abl"
    (base / "seed_21").mkdir(parents=True)
    (base / "seed_21" / "metrics.csv").write_text("done\n")
    assert run_ablation.run_ablation(cfg, str(base), num_trainings=2,
                                     base_seed=21, device="cpu") == 2
    assert os.listdir(base / "seed_21") == ["metrics.csv"]
    check_run_dir(str(base / "seed_22"), 2)
    assert '"seed": 22' in (base / "seed_22" / "hparams.json").read_text()


def test_refusals(data, tmp_path):
    _, cfg, _, ((pds, pscene, _), (ptest, _, info)) = data
    # the plots need matplotlib: where it is missing, ImportError naming
    # it, before the run loads or trains anything
    c = run_config(Config(), cfg.ethz.dataset_dir)
    c.evaluation.plot_results = True
    with mock.patch.dict(sys.modules, {"matplotlib": None}), \
            mock.patch.object(run, "make_dataset") as load:
        with pytest.raises(ImportError, match="matplotlib"):
            run.train_and_evaluate(cfg, plot=True, save_dir=str(tmp_path / "a"),
                                   device="cpu")
        with pytest.raises(ImportError, match="matplotlib"):
            run.train_and_evaluate(c, save_dir=str(tmp_path / "b"),
                                   device="cpu")
        load.assert_not_called()
    # RH2 loads (tests/test_torch_rh.py); a directory without its files
    # needs the external robotathome package
    c = run_config(Config(), cfg.ethz.dataset_dir)
    c.dataset.name = "RH2"
    with pytest.raises(ImportError, match="RH2"):
        run.train_and_evaluate(c, device="cpu")
    ev = Evaluator(cfg, ptest, pscene, img_wh=info["img_wh"], device="cpu")
    model = Trainer(cfg, pds, scene=pscene, device="cpu").init_state().model
    with mock.patch.dict(sys.modules, {"matplotlib": None}):
        with pytest.raises(ImportError, match="matplotlib"):
            ev.evaluate(model, torch.ones(1, 32**3, dtype=torch.bool),
                        save_dir=str(tmp_path / "c"), plot=True)


def test_run_plots_write_the_jax_files(data, tmp_path):
    # evaluation.plot_results: the JAX run's plot files (run.py:69-110,
    # evaluator.py plots): the per-image maps, the NND summary, the
    # training curves and the occupancy-grid slice after the bitfield's
    # refresh and round-trip check
    pytest.importorskip("matplotlib")
    _, cfg, _, pdata = data
    save = tmp_path / "run"
    metrics = run.train_and_evaluate(cfg, datasets=pdata, save_dir=str(save),
                                     plot=True, device="cpu")
    assert math.isfinite(metrics["NeRF"]["nn_mean"]["zone3"])
    for name in ("metrics.png", "curves.png", "occgrids/occgrid.png"):
        assert (save / name).stat().st_size > 0, name
    n = min(cfg.evaluation.num_plot_pts, pdata[1][0].n_images)
    assert len(os.listdir(save / "maps")) == n
    check_run_dir(str(save), 2)


def test_run_without_device_flag_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is usable")
    out = subprocess.run(
        [sys.executable, "-m", "virus_nerf_tpu_torch.run", "--save-dir",
         str(tmp_path / "run")], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr or "cuda" in out.stderr
    assert not os.path.exists(tmp_path / "run" / "metrics.csv")


def test_run_main_without_jax(tmp_path):
    # the port's fixture writer, run.main and run_ablation in a fresh
    # interpreter: every file written, and neither jax nor any module of the
    # JAX package imported
    code = "\n".join([
        "import os, sys",
        "import torch",
        "torch.set_num_threads(1)",
        "from virus_nerf_tpu_torch import run, run_ablation  # noqa: F401",
        "from virus_nerf_tpu_torch.data.ethz_fixture import generate_ethz_fixture",
        f"OVERRIDES = {OVERRIDES!r}",
        f"RUN_FILES = {RUN_FILES!r}",
        f"tmp = {str(tmp_path)!r}",
        f"d = generate_ethz_fixture(os.path.join(tmp, 'ethz'), **{FIXTURE_KW!r})",
        "save = os.path.join(tmp, 'run')",
        "args = ['--device', 'cpu', '--save-dir', save,",
        "        '--override', f'ethz.dataset_dir={d}']",
        "for ov in OVERRIDES:",
        "    args += ['--override', ov]",
        "m = run.main(args)",
        "assert m['NeRF']['nn_mean']['zone3'] == m['NeRF']['nn_mean']['zone3']",
        "for name in RUN_FILES:",
        "    assert os.path.exists(os.path.join(save, name)), name",
        "assert len(os.listdir(os.path.join(save, 'renders'))) == 6",
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')",
        "       or m == 'virus_nerf_tpu' or m.startswith('virus_nerf_tpu.')",
        "       or m in ('cv2', 'PIL', 'matplotlib')]",
        "assert not bad, bad",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_this_file_builds_the_config_it_states():
    # run.main's OVERRIDES are run_config's cut, flag for flag
    cfg = run_config(Config(), "x")
    other = Config()
    apply_cli_overrides(other, OVERRIDES + ["ethz.dataset_dir=x"])
    assert other.to_dict() == cfg.to_dict()


def test_turbo_and_depth2img_match_matplotlib():
    # the port's turbo table and lookup against matplotlib's colormap (the
    # JAX render export's), NaN, out-of-range values and both float widths
    import matplotlib

    from virus_nerf_tpu_torch.utils import check_device_memory, depth2img, turbo

    cmap = matplotlib.colormaps["turbo"]
    rng = np.random.default_rng(0)
    edges = np.array([0, 1, 0.5, -0.1, 1.1, np.nan, 1 / 256, 255 / 256, 1e30])
    for x in (rng.random((40, 30)).astype(np.float32), np.linspace(0, 1, 10001),
              edges, edges.astype(np.float32)):
        np.testing.assert_array_equal(turbo(x), cmap(x)[..., :3])
    depth = rng.uniform(0.2, 5.0, (24, 32))
    norm = (depth - depth.min()) / (depth.max() - depth.min())
    np.testing.assert_array_equal(depth2img(depth),
                                  (cmap(norm)[..., :3] * 255).astype(np.uint8))
    assert depth2img(np.ones((3, 4))).shape == (3, 4, 3)
    assert check_device_memory(device="cpu") is False
