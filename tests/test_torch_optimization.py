"""The port's PSO (virus_nerf_tpu_torch/optimization/, run_optimization.py)
against the JAX package's: the search space, the config patching and the
score; ``run_optimization`` (sequential and ``batch_eval``) and
``run_worker`` with the same stand-in objective, random generator and
clock write the same ``pso_history.csv`` and state JSON byte for byte; a
swarm saved by one package resumes in the other; leases expire and
re-queue with two workers taking turns in one process (no forked
processes); ``run_optimization.main`` over a small RH2 room on the CPU;
and a fresh interpreter that cannot import jax, pandas, cv2 or matplotlib
runs the RH2 load and a PSO iteration."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from virus_nerf_tpu.configs.config import Config as JConfig
from virus_nerf_tpu.configs.config import apply_cli_overrides as j_apply_cli
from virus_nerf_tpu.optimization import metric as j_metric
from virus_nerf_tpu.optimization import pso as j_pso
from virus_nerf_tpu.optimization import runner as j_runner
from virus_nerf_tpu_torch import run_optimization as t_main
from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data.rh_fixture import make_fixture
from virus_nerf_tpu_torch.optimization import metric as t_metric
from virus_nerf_tpu_torch.optimization import pso as t_pso
from virus_nerf_tpu_torch.optimization import runner as t_runner

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMS = {
    "training": {"pixs_valid_uss": [0.0, 0.9], "pixs_valid_tof": [0.0, 0.9],
                 "uss_loss_w": [0.1, 400.0]},
    "occ_grid": {"update_interval": [2.0, 32.0], "std_every_m": [0.05, 0.5]},
    "ToF": {"tof_pix_size": [1.0, 16.0]},
}
PACKAGES = {"jax": (j_pso, j_runner, JConfig), "port": (t_pso, t_runner, Config)}


class Clock:
    """A stand-in for the ``time`` module: every call advances 1.25 s."""

    def __init__(self):
        self.now = 1.0e6

    def time(self):
        self.now += 1.25
        return self.now

    def sleep(self, seconds):
        self.now += seconds


@pytest.fixture
def clock(monkeypatch):
    """One clock for both packages' PSO modules."""
    c = Clock()
    for mod in (j_pso, j_runner, t_pso, t_runner):
        monkeypatch.setattr(mod, "time", c)
    return c


def objective(cfg, iteration):
    """A score from the patched config: exercises apply_hparams."""
    pixs = cfg.training.sampling_strategy["pixs"]
    score = (abs(cfg.training.uss_loss_w - 120.0) / 400.0
             + abs(cfg.occ_grid.update_interval - 8) / 30.0
             + abs(cfg.tof.tof_pix_size - 4) / 16.0
             + abs(pixs["valid_uss"] - 0.3) + abs(pixs["valid_tof"] - 0.2)
             + cfg.occ_grid.std_every_m + 1e-3 * (cfg.seed % 7))
    return {"NeRF": {"nn_mean": {"zone3": float(score)}}}


def read(path):
    with open(path) as f:
        return f.read()


# --------------------------------------------------- space, patching, score
def test_hparam_space_matches_jax():
    from virus_nerf_tpu.run_optimization import DEFAULT_LIMS as J_LIMS

    assert t_main.DEFAULT_LIMS == J_LIMS
    rng = np.random.default_rng(0)
    for lims in (LIMS, J_LIMS):
        a, b = t_pso.HParamSpace(lims), j_pso.HParamSpace(lims)
        assert a.order == b.order and a.groups == b.groups
        np.testing.assert_array_equal(a.lims, b.lims)
        pos = rng.random((5, a.num_dimensions))
        np.testing.assert_array_equal(a.denormalize(pos), b.denormalize(pos))
        for p in pos:
            assert a.to_group_dict(p) == b.to_group_dict(p)
            nd = a.to_name_dict(p)
            assert nd == b.to_name_dict(p)
            np.testing.assert_array_equal(a.from_name_dict(nd), b.from_name_dict(nd))
    with pytest.raises(ValueError, match="duplicate"):
        t_pso.HParamSpace({"a": {"x": [0, 1]}, "b": {"x": [0, 1]}})


@pytest.mark.parametrize("seed", range(6))
def test_apply_hparams_matches_jax(seed):
    from virus_nerf_tpu.run_optimization import DEFAULT_LIMS as J_LIMS

    rng = np.random.default_rng(seed)
    space = t_pso.HParamSpace(J_LIMS)
    pos = rng.random(space.num_dimensions)
    if seed == 0:  # pixel shares summing to under 1: kept as drawn
        pos[:2] = 0.1
    gd = space.to_group_dict(pos)
    got = t_runner.apply_hparams(Config(), gd).to_dict()
    want = j_runner.apply_hparams(JConfig(), gd).to_dict()
    assert got == want
    assert isinstance(got["occ_grid"]["update_interval"], int)
    assert isinstance(got["ToF"]["tof_pix_size"], int)
    # the base config is left as it was
    assert Config().to_dict() == JConfig().to_dict()
    with pytest.raises(ValueError, match="unknown hparam group"):
        t_runner.apply_hparams(Config(), {"nope": {"x": 1.0}})


@pytest.mark.parametrize("metrics", [
    {"NeRF": {"nn_mean": {"zone3": 0.25}}}, {}, {"NeRF": None},
    {"NeRF": {"nn_mean": {"zone3": float("nan")}}},
    {"NeRF": {"nn_mean": {"zone1": 0.1}}},
])
def test_score_from_metrics_matches_jax(metrics):
    assert t_runner.score_from_metrics(metrics) == j_runner.score_from_metrics(metrics)


def test_synthetic_metric_matches_jax_and_persists(tmp_path):
    lims = np.tile([[0.0, 1.0]], (4, 1))
    x = np.random.default_rng(9).random((6, 4))
    for name in ("gauss", "cos", "rand"):
        a = t_metric.SyntheticMetric(name, lims, np.random.default_rng(1),
                                     str(tmp_path / f"t_{name}"))
        b = j_metric.SyntheticMetric(name, lims, np.random.default_rng(1),
                                     str(tmp_path / f"j_{name}"))
        np.testing.assert_array_equal(a(x), b(x))
        assert read(tmp_path / f"t_{name}" / "metric_params.json") == read(
            tmp_path / f"j_{name}" / "metric_params.json")
        # the JAX package's saved objective is the port's on reload
        c = t_metric.SyntheticMetric(name, lims, np.random.default_rng(99),
                                     str(tmp_path / f"j_{name}"))
        np.testing.assert_array_equal(c.centre, b.centre)


# ------------------------------------------------------------------- swarms
def run_swarm(pkg, save, batch=False, iters=12, seed=7):
    pso_mod, runner, C = PACKAGES[pkg]
    kw = dict(T=1e9, termination_by_time=False,
              rng=np.random.default_rng(seed), max_iters=iters)
    if batch:
        def evaluate(positions):
            space = pso_mod.HParamSpace(LIMS)
            return [objective(runner.apply_hparams(C(), space.to_group_dict(p)),
                              0)["NeRF"]["nn_mean"]["zone3"] for p in positions]
        kw["batch_eval"] = evaluate
    return runner.run_optimization(C(), LIMS, save, objective, **kw)


@pytest.mark.parametrize("batch", [False, True])
def test_run_optimization_writes_the_jax_files(tmp_path, monkeypatch, batch):
    # the same objective, generator and clock: the same state JSON and
    # history, byte for byte
    out = {}
    for pkg in ("jax", "port"):
        clock = Clock()
        for mod in (j_pso, j_runner, t_pso, t_runner):
            monkeypatch.setattr(mod, "time", clock)
        save = str(tmp_path / pkg)
        pso = run_swarm(pkg, save, batch=batch)
        out[pkg] = (read(os.path.join(save, "pso_state.json")),
                    read(os.path.join(save, "pso_history.csv")),
                    pso.best_score, pso.best_hparams)
    assert out["port"] == out["jax"]
    state = json.loads(out["port"][0])["state"]
    assert state["t"] == (12 * 5 if batch else 12)
    rows = list(csv.reader(out["port"][1].splitlines()))
    assert rows[0][:5] == ["iteration", "particle", "exploring", "score", "time"]
    assert len(rows) == (1 if batch else 13)
    if not batch:  # the epsilon-greedy rule re-evaluated some personal best
        assert {r[2] for r in rows[1:]} == {"0", "1"}
    assert np.isfinite(out["port"][2])


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_saved_swarm_resumes_in_the_other_package(tmp_path, clock, first):
    # 7 evaluations in one package (mid-swarm), then 6 in the other on the
    # same directory: the next positions and the files are those of an
    # unbroken run in one package
    second = "port" if first == "jax" else "jax"
    scores = iter(np.random.default_rng(3).random(40))
    wrappers = {}
    for pkg, d in (("ref", "ref"), (first, "x")):
        mod = PACKAGES["port" if pkg == "ref" else pkg][0]
        w = mod.PSOWrapper(LIMS, str(tmp_path / d), T=1e9,
                           termination_by_time=False,
                           rng=np.random.default_rng(5))
        wrappers[pkg] = w
    seq = [float(s) for s in scores]
    for s in seq[:7]:
        for pkg in ("ref", first):
            wrappers[pkg].get_next_hparams()
            wrappers[pkg].update(s)
    resumed = PACKAGES[second][0].PSOWrapper(
        LIMS, str(tmp_path / "x"), T=1e9, termination_by_time=False,
        rng=np.random.default_rng(5))
    st_a, st_b = resumed.pso.state, wrappers["ref"].pso.state
    for k in ("pos", "vel", "best_pos", "best_score", "best_count"):
        np.testing.assert_array_equal(getattr(st_a, k), getattr(st_b, k))
    assert (st_a.n, st_a.t) == (st_b.n, st_b.t) == (1, 7)
    for s in seq[7:13]:
        assert resumed.get_next_hparams() == wrappers["ref"].get_next_hparams()
        resumed.update(s)
        wrappers["ref"].update(s)
    a, b = (json.loads(read(os.path.join(str(tmp_path / d), "pso_state.json")))
            for d in ("x", "ref"))
    for d in (a, b):
        d["state"].pop("elapsed")  # wall time of two processes, not one
    assert a == b
    ha = [r.split(",") for r in read(tmp_path / "x" / "pso_history.csv").splitlines()]
    hb = [r.split(",") for r in read(tmp_path / "ref" / "pso_history.csv").splitlines()]
    assert len(ha) == len(hb) == 14
    assert [r[:4] + r[5:] for r in ha] == [r[:4] + r[5:] for r in hb]


def test_resume_refuses_other_pso_params(tmp_path):
    save = str(tmp_path / "pso")
    j_pso.PSOWrapper(LIMS, save, T=10, termination_by_time=False)
    with pytest.raises(ValueError, match="mismatch"):
        t_pso.PSOWrapper(LIMS, save, T=10, termination_by_time=False,
                         pso_params={"num_particles": 7})


def worker_turns(save, packages, rounds=4, per=3, ttl=60.0):
    """Workers w0, w1 take turns (``per`` evaluations each) on one save dir,
    worker k through ``packages[k % 2]``."""
    pools = []
    for r in range(rounds):
        pkg = packages[r % 2]
        pools.append(PACKAGES[pkg][1].run_worker(
            PACKAGES[pkg][2](), LIMS, save, objective, worker=f"w{r % 2}",
            T=1e9, termination_by_time=False, lease_ttl=ttl, max_iters=per,
            seed=5))
    return pools


def test_alternating_workers_write_the_jax_files(tmp_path, monkeypatch):
    # w0 and w1 take turns in one process; mixing the packages changes
    # nothing in the state or the history
    out = {}
    for name, packages in (("jax", ("jax", "jax")), ("port", ("port", "port")),
                           ("mixed", ("port", "jax"))):
        clock = Clock()
        for mod in (j_pso, j_runner, t_pso, t_runner):
            monkeypatch.setattr(mod, "time", clock)
        save = str(tmp_path / name)
        pools = worker_turns(save, packages)
        out[name] = (read(os.path.join(save, "pso_state.json")),
                     read(os.path.join(save, "pso_history.csv")),
                     pools[-1].best_score)
    assert out["port"] == out["jax"] == out["mixed"]
    payload = json.loads(out["port"][0])
    assert payload["state"]["t"] == 12 and payload["leases"] == []
    rows = list(csv.DictReader(out["port"][1].splitlines()))
    assert len(rows) == 12 and {r["worker"] for r in rows} == {"w0", "w1"}
    assert {int(r["particle"]) for r in rows} == set(range(5))


def test_leases_cover_the_swarm_expire_and_requeue(tmp_path, clock):
    save = str(tmp_path / "mw")
    lims = {"g": {"x0": [0.0, 1.0], "x1": [0.0, 1.0]}}
    a = t_pso.MultiWorkerPSO(lims, save, worker="a", T=1e9, lease_ttl=30.0,
                             seed=1)
    b = j_pso.MultiWorkerPSO(lims, save, worker="b", T=1e9, lease_ttl=30.0,
                             seed=1)
    claims = [a.claim(), b.claim(), a.claim(), b.claim(), a.claim()]
    assert sorted(c["particle"] for c in claims) == [0, 1, 2, 3, 4]
    assert b.claim() is None and a.claim() is None  # every particle leased
    with open(os.path.join(save, "pso_state.json")) as f:
        leases = json.load(f)["leases"]
    assert sorted((d["worker"], d["particle"]) for d in leases) == sorted(
        (("a" if i % 2 == 0 else "b"), c["particle"]) for i, c in enumerate(claims))
    assert a.complete(claims[0]["particle"], 0.5)
    nxt = b.claim()
    assert nxt["particle"] == claims[0]["particle"]
    # worker a "dies": its leases expire after the TTL; b re-claims its
    # particles at the stored positions, without a second velocity step
    with a._locked() as payload:
        pos_before = np.array(payload["state"]["pos"])
    clock.sleep(31.0)
    dead = claims[2::2]
    re = {}
    for _ in range(5):  # every lease expired: b takes all five in turn
        c = b.claim()
        re[c["particle"]] = c
    assert b.claim() is None
    for c in dead:
        assert c["particle"] in re
        np.testing.assert_array_equal(re[c["particle"]]["pos"], c["pos"])
        assert re[c["particle"]]["exploring"] == c["exploring"]
    with b._locked() as payload:
        np.testing.assert_array_equal(
            np.array(payload["state"]["pos"])[[c["particle"] for c in dead]],
            pos_before[[c["particle"] for c in dead]])
        t_before = payload["state"]["t"]
    # a's late completion is ignored and logged with particle -1
    assert not a.complete(dead[0]["particle"], 0.123)
    with b._locked() as payload:
        assert payload["state"]["t"] == t_before
        assert 0.123 not in payload["state"]["best_score"]
    assert b.complete(dead[0]["particle"], 0.25)
    rows = list(csv.DictReader(read(os.path.join(save, "pso_history.csv")).splitlines()))
    assert [r["particle"] for r in rows][-2] == "-1"
    assert rows[-1]["worker"] == "b"


# ------------------------------------------------------------ the entry point
TINY = [
    "dataset.name=RH2", "model.scale=1.0", "model.hash_levels=4",
    "model.hash_log2_T=12", "model.hash_max_res=64", "model.grid_size=32",
    "training.batch_size=128", "training.max_samples_per_ray=32",
    "training.march_candidates=256", "training.march_resolution=256",
    "training.max_steps=4", "training.max_time=1e9", "occ_grid.batch_size=64",
    "evaluation.eval_every_n_steps=100", "evaluation.res_angular=32",
    "evaluation.res_map=32", "evaluation.batch_size=1024",
    "evaluation.max_samples_per_ray=32", "evaluation.num_color_pts=1",
    "evaluation.num_depth_pts=1",
]
FIXTURE_KW = dict(n_times=10, img_wh=(64, 48), seed=3)


@pytest.fixture(scope="module")
def rh_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rh"))
    make_fixture(out, **FIXTURE_KW)
    return out


def main_args(rh_dir, save, *extra):
    args = ["--device", "cpu", "--save-dir", save, *extra,
            "--override", f"rh2.dataset_dir={rh_dir}"]
    for ov in TINY:
        args += ["--override", ov]
    return args


def test_main_trains_particles_as_the_jax_swarm_draws_them(rh_dir, tmp_path,
                                                           monkeypatch):
    # two particles, each a training run and its evaluation on the port;
    # the JAX runner, given the same scores, draws the same hyper-parameters
    # and patches the same configs (the first particle's before any score)
    seen, scores, shared = [], [], []
    real = t_main.train_and_evaluate

    def spy(cfg, datasets=None, **kw):
        seen.append(cfg.to_dict())
        shared.append(datasets)  # built once, shared by the particles
        metrics = real(cfg, datasets=datasets, **kw)
        scores.append(t_runner.score_from_metrics(metrics))
        return metrics

    monkeypatch.setattr(t_main, "train_and_evaluate", spy)
    save = str(tmp_path / "pso")
    pso = t_main.main(main_args(rh_dir, save, "--max-iters", "2"))
    rows = list(csv.reader(read(os.path.join(save, "pso_history.csv")).splitlines()))
    assert len(rows) == 3 and len(seen) == 2
    assert all(a is b for a, b in zip(*shared)) and shared[0] is not None
    assert [float(r[3]) for r in rows[1:]] == [float(f"{s:.8g}") for s in scores]
    assert np.all(np.isfinite(scores)) and pso.best_score == min(scores)
    assert [c["seed"] for c in seen] == [22, 23]  # seed + t + 1

    from virus_nerf_tpu.run_optimization import DEFAULT_LIMS as J_LIMS

    jcfg = JConfig()
    j_apply_cli(jcfg, [f"rh2.dataset_dir={rh_dir}"] + TINY)
    j_seen, it = [], iter(scores)

    def j_objective(cfg, iteration):
        j_seen.append(cfg.to_dict())
        return {"NeRF": {"nn_mean": {"zone3": next(it)}}}

    j_runner.run_optimization(jcfg, J_LIMS, str(tmp_path / "jax"), j_objective,
                              T=36000.0, rng=np.random.default_rng(jcfg.seed),
                              max_iters=2)
    assert j_seen == seen
    j_rows = list(csv.reader(read(tmp_path / "jax" / "pso_history.csv").splitlines()))
    assert [r[:4] + r[5:] for r in j_rows] == [r[:4] + r[5:] for r in rows]


def test_main_resumes_and_runs_as_a_worker(rh_dir, tmp_path, monkeypatch):
    # with a stand-in for the training run: a second call resumes at t = 2;
    # a --worker-id call leases a particle and completes it
    monkeypatch.setattr(t_main, "train_and_evaluate",
                        lambda cfg, datasets=None, **kw: objective(cfg, 0))
    save = str(tmp_path / "pso")
    t_main.main(main_args(rh_dir, save, "--max-iters", "2"))
    t_main.main(main_args(rh_dir, save, "--max-iters", "1"))
    rows = list(csv.reader(read(os.path.join(save, "pso_history.csv")).splitlines()))
    assert [r[0] for r in rows[1:]] == ["1", "2", "3"]
    wsave = str(tmp_path / "workers")
    pool = t_main.main(main_args(rh_dir, wsave, "--worker-id", "w0",
                                 "--max-iters", "2", "--lease-ttl", "600"))
    with pool._locked() as payload:
        assert payload["state"]["t"] == 2 and payload["leases"] == []
        assert sum(1 for x in payload["last_claimed"] if x > 0) == 2
    assert os.path.exists(os.path.join(wsave, "pso_state.lock"))
    assert np.isfinite(pool.best_score)


def test_main_without_device_flag_raises_without_a_card(rh_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is usable")
    args = main_args(rh_dir, str(tmp_path / "pso"), "--max-iters", "1")
    args = args[2:]  # no --device cpu
    with pytest.raises((RuntimeError, AssertionError)):
        t_main.main(args)
    assert not os.path.exists(tmp_path / "pso" / "pso_history.csv")


def test_rh2_and_pso_without_jax_pandas_cv2_matplotlib(tmp_path):
    # a fresh interpreter in which these imports fail: the port's fixture
    # writer, the RH2 load and one PSO iteration of run_optimization.main
    code = "\n".join([
        "import sys",
        "BLOCKED = ('jax', 'jaxlib', 'pandas', 'cv2', 'matplotlib',",
        "           'virus_nerf_tpu')",
        "for name in BLOCKED:  # an import of these raises ImportError",
        "    sys.modules[name] = None",
        "import os",
        "import torch",
        "torch.set_num_threads(1)",
        "from virus_nerf_tpu_torch import run_optimization",
        "from virus_nerf_tpu_torch.configs.config import Config",
        "from virus_nerf_tpu_torch.data import make_dataset",
        "from virus_nerf_tpu_torch.data.rh_fixture import make_fixture",
        f"tmp = {str(tmp_path)!r}",
        "d = os.path.join(tmp, 'rh')",
        f"make_fixture(d, **{FIXTURE_KW!r})",
        "cfg = Config()",
        "cfg.dataset.name, cfg.rh2.dataset_dir = 'RH2', d",
        "ds, scene, info = make_dataset(cfg, 'train', device='cpu')",
        "assert ds.n_images == 32 and info['img_wh'] == (64, 48)",
        "save = os.path.join(tmp, 'pso')",
        "args = ['--device', 'cpu', '--save-dir', save, '--max-iters', '1',",
        "        '--override', f'rh2.dataset_dir={d}']",
        f"for ov in {TINY!r}:",
        "    args += ['--override', ov]",
        "pso = run_optimization.main(args)",
        "assert pso.best_score == pso.best_score",
        "rows = open(os.path.join(save, 'pso_history.csv')).read().splitlines()",
        "assert len(rows) == 2, rows",
        "bad = [m for m, mod in sys.modules.items()",
        "       if m.split('.')[0] in BLOCKED and mod is not None]",
        "assert not bad, bad",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
