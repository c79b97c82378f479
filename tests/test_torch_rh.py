"""The port's RH2 path (virus_nerf_tpu_torch/data/rh.py, data/rh_fixture.py,
data/__init__.py, run.py) against the JAX package: the pure functions
exactly (pose assembly, depth decode, the interleaved split and its files
read across packages), the fixture writer against
``tools/make_rh_fixture.py`` (the same files), ``load_rh_dataset`` against
the JAX loader on both splits (every field equal, NaN where NaN; the split
files byte for byte; tied timestamps; depth PNGs with 2, 3 and 4 channels;
``keep_sensor`` and ``keep_N_observations``), 8 training steps at
``model.scale = 1.0`` against the JAX step bodies (with and without the
RGBD depth in the loss), and ``run.main`` on an RH2 room on the CPU.

The JAX loader reads the fixture through the tool's ``robotathome`` reader
(pandas), matplotlib and OpenCV; the port's through its own reader.  Each
loader reads its own copy of the fixture.  Small: 10 trajectory points x 4
cameras at 244x320 (32 train and 4 test images), a 16 x F = 2 hash of 2^12
rows a level, a 32^3 grid, 128 rays a step."""

import filecmp
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.configs.config import Config as JConfig
from virus_nerf_tpu.data import rh as jrh
from virus_nerf_tpu.data.dataset import sample_batch as j_sample_batch
from virus_nerf_tpu.training import Trainer as JTrainer
from virus_nerf_tpu_torch import run
from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data import make_dataset
from virus_nerf_tpu_torch.data import rh as trh
from virus_nerf_tpu_torch.data.png import read_png, write_png
from virus_nerf_tpu_torch.data.rh_fixture import make_fixture
from virus_nerf_tpu_torch.training.trainer import LOG_COLUMNS, Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.make_rh_fixture import make_fixture as tool_fixture  # noqa: E402

# the step-parity helpers of the ETHZ run's tests
from test_torch_run import (  # noqa: E402
    _port_batch,
    _sync_stepped_apart,
    jax_state_into_port,
)

FIXTURE_KW = dict(n_times=10, seed=3)
SPLIT_DIR = ("files", "rgbd", "session_2", "anto", "livingroom1")
RUN_FILES = ("model.npz", "model.npz.json", "logs.csv", "hparams.json",
             "metrics.csv")


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rh_tool"))
    tool_fixture(out, **FIXTURE_KW)
    return out


@pytest.fixture
def jax_reader(fixture_dir, monkeypatch):
    """The tool's ``robotathome`` reader (pandas) for the JAX loader."""
    monkeypatch.syspath_prepend(fixture_dir)
    sys.modules.pop("robotathome", None)
    yield
    sys.modules.pop("robotathome", None)


def copy_of(src, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


def configs(j_dir, t_dir, **dataset):
    out = []
    for C, d in ((JConfig, j_dir), (Config, t_dir)):
        cfg = C()
        cfg.dataset.name = "RH2"
        cfg.rh2.dataset_dir = d
        for k, v in dataset.items():
            setattr(cfg.dataset, k, v)
        out.append(cfg)
    return out


# ------------------------------------------------------------ pure functions
def test_euler_to_pose_and_intrinsics_match_jax():
    rng = np.random.default_rng(0)
    n = 257
    xyz = rng.normal(size=(n, 3)) * 3
    yaw, pitch, roll = (rng.uniform(-4, 4, n) for _ in range(3))
    np.testing.assert_array_equal(trh.euler_to_pose(xyz, yaw, pitch, roll),
                                  jrh.euler_to_pose(xyz, yaw, pitch, roll))
    np.testing.assert_array_equal(trh.rh_intrinsics(), jrh.rh_intrinsics())
    assert trh.RH_DEPTH_SCALE == jrh.RH_DEPTH_SCALE


def test_depth_to_scan_matches_jax():
    from virus_nerf_tpu_torch.data.rays import get_ray_directions

    rng = np.random.default_rng(1)
    dirs = get_ray_directions(24, 20, trh.rh_intrinsics())
    raw = rng.integers(0, 256, (3, 24 * 20)).astype(np.float32)
    raw[0, :50] = 0
    got, want = trh.rh_depth_to_scan(raw, dirs), jrh.rh_depth_to_scan(raw, dirs)
    assert np.isnan(got).sum() >= 50
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ratio", [(0.8, 0.1, 0.1), (0.7, 0.2, 0.1),
                                   (1.0, 0.0, 0.0)])
def test_interleaved_split_matches_jax(tmp_path, ratio):
    rng = np.random.default_rng(2)
    sids = rng.integers(0, 4, 137)
    r = dict(zip(("train", "val", "test"), ratio))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    got = trh.interleaved_split(sids, r, split_dir=a, split_name="s.csv")
    want = jrh.interleaved_split(sids, r, split_dir=b, split_name="s.csv")
    np.testing.assert_array_equal(got, want)
    for name in ("s.csv", "split_description.csv"):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False)
    np.testing.assert_array_equal(trh.interleaved_split(sids, r),
                                  jrh.interleaved_split(sids, r))
    with pytest.raises(ValueError):
        trh.interleaved_split(sids, {"train": 0.75, "val": 0.15, "test": 0.1})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_persisted_split_is_read_across_packages(tmp_path, writer):
    # one package writes the split; the labels are then edited in the file,
    # so only a reader that reuses the file returns them.  Both do; both
    # draw anew when the ratios or the row count differ
    sids = np.arange(60) % 4
    r = {"train": 0.8, "val": 0.1, "test": 0.1}
    d = str(tmp_path)
    write = trh.interleaved_split if writer == "port" else jrh.interleaved_split
    fresh = write(sids, r, split_dir=d, split_name="split_x.csv")
    path = os.path.join(d, "split_x.csv")
    lines = open(path).read().splitlines()
    lines[1], lines[2] = "0,test", "1,val"
    open(path, "w").write("\n".join(lines) + "\n")
    edited = fresh.copy()
    edited[0], edited[1] = "test", "val"
    for read in (trh.interleaved_split, jrh.interleaved_split):
        np.testing.assert_array_equal(
            read(sids, r, split_dir=d, split_name="split_x.csv"), edited)
    other = {"train": 0.7, "val": 0.2, "test": 0.1}
    np.testing.assert_array_equal(
        trh.interleaved_split(sids, other, split_dir=d, split_name="split_x.csv"),
        jrh.interleaved_split(sids, other))
    np.testing.assert_array_equal(
        trh.interleaved_split(sids[:40], r, split_dir=d, split_name="split_x.csv"),
        jrh.interleaved_split(sids[:40], r))


# ------------------------------------------------------------------- fixture
@pytest.mark.parametrize("noise", [True, False])
def test_fixture_writer_writes_the_tools_files(tmp_path, noise):
    kw = dict(n_times=3, img_wh=(40, 32), seed=5, noise=noise)
    a, b = str(tmp_path / "tool"), str(tmp_path / "port")
    info_a, info_b = tool_fixture(a, **kw), make_fixture(b, **kw)
    assert info_a == info_b and info_b["n_obs"] == 12
    assert filecmp.cmp(os.path.join(a, "observations.csv"),
                       os.path.join(b, "observations.csv"), shallow=False)
    pa, pb = (np.load(os.path.join(x, "scene_points.npy")) for x in (a, b))
    assert pa.dtype == pb.dtype and pa.shape == (400_000, 3)
    np.testing.assert_array_equal(pa, pb)
    names = sorted(os.listdir(os.path.join(a, "imgs")))
    assert names == sorted(os.listdir(os.path.join(b, "imgs"))) and len(names) == 24
    for name in names:
        want = read_png(os.path.join(a, "imgs", name))
        got = read_png(os.path.join(b, "imgs", name))
        assert got.shape == ((32, 40) if name.endswith("_d.png") else (32, 40, 3))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_fixture_stub_reads_the_files_without_pandas(tmp_path, monkeypatch):
    # the port fixture's robotathome.py, through RobotAtHomeReader, gives
    # the port reader's columns, files and points
    d = str(tmp_path / "rh")
    make_fixture(d, n_times=3, img_wh=(40, 32), seed=5)
    assert "import pandas" not in open(os.path.join(d, "robotathome.py")).read()
    monkeypatch.syspath_prepend(d)
    sys.modules.pop("robotathome", None)
    try:
        via_stub = trh.RobotAtHomeReader(d)
        own = trh.RHFixtureReader(d)
        a, b = via_stub.get_sensor_observations("lblrgbd"), \
            own.get_sensor_observations("lblrgbd")
        assert list(a) == list(b) == list(trh.OBSERVATION_COLUMNS)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert b["id"].dtype == np.int64 and b["timestamp"].dtype == np.float64
        for name, kind in (("anto", "h"), ("anto_livingroom1", "r"),
                           ("cam_3", "s")):
            assert via_stub.name2id(name, kind) == own.name2id(name, kind)
        assert via_stub.get_RGBD_files(7) == own.get_RGBD_files(7)
        np.testing.assert_array_equal(via_stub.get_scene_points(1, 7),
                                      own.get_scene_points(1, 7))
    finally:
        sys.modules.pop("robotathome", None)


# -------------------------------------------------------------------- loader
def assert_same_dataset(ds, jds, sensors=("RGBD", "USS", "ToF")):
    assert ds.n_images == jds.n_images > 0
    for field in jds._fields:
        want, got = getattr(jds, field), getattr(ds, field)
        if field == "depths":
            assert list(got) == list(want) == list(sensors)
            pairs = [(got[k], want[k], k) for k in want]
        else:
            pairs = [(got, want, field)]
        for g, w, name in pairs:
            w = np.asarray(w)
            assert g.device.type == "cpu"
            # floats exact, NaN where NaN; indices as int64 on the port's side
            if w.dtype.kind in "iu":
                assert g.dtype == torch.int64, name
            else:
                assert g.dtype == torch.float32 and w.dtype == np.float32, name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def load_both(j_dir, t_dir, split, scenes=(None, None), **dataset):
    jcfg, cfg = configs(j_dir, t_dir, **dataset)
    j = jrh.load_rh_dataset(jcfg, split, scene=scenes[0])
    t = trh.load_rh_dataset(cfg, split, scene=scenes[1], device="cpu")
    return j, t


@pytest.mark.parametrize("split", ["train", "test"])
def test_loader_matches_jax(fixture_dir, tmp_path, jax_reader, split):
    # the pose columns go through pandas' C parser on the JAX side and
    # Python's float() on the port's: equal here, bit for bit
    j_dir = copy_of(fixture_dir, tmp_path, "j")
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    (jds, jscene, jinfo), (ds, scene, info) = load_both(j_dir, t_dir, split)
    assert ds.n_images == {"train": 32, "test": 4}[split]
    assert_same_dataset(ds, jds)
    assert ds.directions.shape == (1, 244 * 320, 3)
    assert set(ds.sensor_ids.tolist()) == {0, 1, 2, 3}
    assert bool(torch.all(ds.times[1:] >= ds.times[:-1]))
    assert torch.isnan(ds.depths["RGBD"]).any() and torch.isnan(ds.depths["ToF"]).any()
    assert float(ds.rgbs.max()) <= 1.0 and float(ds.rgbs.max()) > 0.5
    np.testing.assert_array_equal(scene.point_cloud, jscene.point_cloud)
    assert scene.w2c(1.0, only_scale=True) == jscene.w2c(1.0, only_scale=True)
    assert info["img_wh"] == jinfo["img_wh"] == (244, 320)
    assert info["camera_aov_deg"] == jinfo["camera_aov_deg"]
    np.testing.assert_array_equal(info["K"], jinfo["K"])
    for name in ("RGBD", "USS", "ToF"):
        np.testing.assert_array_equal(info["sensor_models"][name].mask,
                                      jinfo["sensor_models"][name].mask)
    # the split files, byte for byte
    sj, st = os.path.join(j_dir, *SPLIT_DIR), os.path.join(t_dir, *SPLIT_DIR)
    assert sorted(os.listdir(sj)) == sorted(os.listdir(st)) == [
        "split_description.csv", "split_subsession_1.csv"]
    for name in os.listdir(sj):
        assert filecmp.cmp(os.path.join(sj, name), os.path.join(st, name),
                           shallow=False), name


def rewrite_observations(d, edit):
    """Apply ``edit(header, rows)`` to ``observations.csv``'s text rows."""
    path = os.path.join(d, "observations.csv")
    lines = open(path).read().splitlines()
    header, rows = lines[0].split(","), [line.split(",") for line in lines[1:]]
    rows = edit(header, rows)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(r) + "\n")


@pytest.mark.parametrize("kind", ["float", "int"])
def test_tied_timestamps_order_as_pandas(fixture_dir, tmp_path, jax_reader, kind):
    # the 4 cameras of a trajectory point share one timestamp, rows
    # shuffled: numpy's quicksort (pandas' sort_values) orders the ties
    # otherwise than a stable sort, and both loaders take its order
    perm = np.random.default_rng(4).permutation(40)

    def edit(header, rows):
        j = header.index("timestamp")
        for r in rows:
            t = int(r[header.index("id")]) // 4
            r[j] = str(1000 + t) if kind == "int" else str(1000.0 + 0.35 * t)
        return [rows[i] for i in perm]

    t_dir = copy_of(fixture_dir, tmp_path, "t")
    rewrite_observations(t_dir, edit)
    stamps = trh.read_columns(os.path.join(t_dir, "observations.csv"))["timestamp"]
    assert stamps.dtype == (np.int64 if kind == "int" else np.float64)
    assert not np.array_equal(np.argsort(stamps, kind="quicksort"),
                              np.argsort(stamps, kind="stable"))
    j_dir = copy_of(t_dir, tmp_path, "j")
    for split in ("train", "test"):
        (jds, _, _), (ds, _, _) = load_both(j_dir, t_dir, split)
        assert_same_dataset(ds, jds)


@pytest.mark.parametrize("channels", [2, 3, 4])
def test_depth_pngs_with_channels_read_as_opencv(fixture_dir, tmp_path, jax_reader,
                                                 channels):
    # the depth PNGs rewritten with several channels that differ: OpenCV's
    # BGR(A) channel 0 is the gray of a gray+alpha file and the blue
    # channel (RGB(A) channel 2) of a colour one; the original plane is
    # put there, so the dataset is the single-channel one's
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    imgs = os.path.join(t_dir, "imgs")
    rng = np.random.default_rng(channels)
    for name in os.listdir(imgs):
        if name.endswith("_d.png"):
            d = read_png(os.path.join(imgs, name))
            img = rng.integers(0, 256, d.shape + (channels,), np.uint8)
            img[:, :, 0 if channels == 2 else 2] = d
            write_png(os.path.join(imgs, name), img)
    j_dir = copy_of(t_dir, tmp_path, "j")
    (jds, _, _), (ds, _, _) = load_both(j_dir, t_dir, "train")
    assert_same_dataset(ds, jds)
    plain = trh.load_rh_dataset(configs(None, copy_of(fixture_dir, tmp_path, "o"))[1],
                                "train", device="cpu")[0]
    for k in ("RGBD", "USS", "ToF"):
        np.testing.assert_array_equal(ds.depths[k].numpy(), plain.depths[k].numpy())


@pytest.mark.parametrize("keep", [dict(keep_sensor="cam_2"),
                                  dict(keep_N_observations=5),
                                  dict(keep_sensor="cam_1", keep_N_observations=3)])
def test_keep_sensor_and_keep_n_match_jax(fixture_dir, tmp_path, jax_reader, keep):
    j_dir = copy_of(fixture_dir, tmp_path, "j")
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    (jds, _, _), (ds, _, _) = load_both(j_dir, t_dir, "train", **keep)
    assert_same_dataset(ds, jds)
    want_n = min(8 if "keep_sensor" in keep else 32,
                 keep.get("keep_N_observations", 32))
    assert ds.n_images == want_n
    if "keep_sensor" in keep:
        assert set(ds.sensor_ids.tolist()) == {int(keep["keep_sensor"][-1])}


def test_only_the_configured_sensors_are_built(fixture_dir, tmp_path, jax_reader):
    j_dir = copy_of(fixture_dir, tmp_path, "j")
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    (jds, _, _), (ds, _, _) = load_both(j_dir, t_dir, "test",
                                        sensors=["ToF", "USS"])
    assert_same_dataset(ds, jds, sensors=("USS", "ToF"))


def test_robotathome_package_path_matches_the_csv_path(fixture_dir, tmp_path,
                                                       jax_reader):
    # the tool's reader returns a pandas frame, as the real package does;
    # through RobotAtHomeReader the port loads the same dataset
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    o_dir = copy_of(fixture_dir, tmp_path, "o")
    _, cfg = configs(None, t_dir)
    ds, scene, _ = trh.load_rh_dataset(cfg, "train", device="cpu",
                                       reader=trh.RobotAtHomeReader(t_dir))
    want = trh.load_rh_dataset(configs(None, o_dir)[1], "train", device="cpu")[0]
    assert isinstance(trh.open_rh_reader(o_dir), trh.RHFixtureReader)
    for field in ds._fields:
        a, b = getattr(ds, field), getattr(want, field)
        for x, y in ((a[k], b[k]) for k in a) if field == "depths" else [(a, b)]:
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=field)


def test_a_directory_without_observations_needs_robotathome(tmp_path):
    sys.modules.pop("robotathome", None)
    _, cfg = configs(None, str(tmp_path))
    with pytest.raises(ImportError, match="RH2"):
        trh.load_rh_dataset(cfg, "train", device="cpu")
    with pytest.raises(ImportError, match="RH2"):
        make_dataset(cfg, "train", device="cpu")


def test_loader_refuses_the_cpu_fallback(fixture_dir, tmp_path):
    # the default device is the card: without one the loader raises before
    # it reads anything (no split files are written)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is usable")
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    _, cfg = configs(None, t_dir)
    with pytest.raises((RuntimeError, AssertionError)):
        trh.load_rh_dataset(cfg, "train")
    assert not os.path.exists(os.path.join(t_dir, "files"))


# ------------------------------------------------------------------ training
def run_config(cfg, dataset_dir, sensors=("USS", "ToF")):
    """The default config on the RH2 fixture at scale 1.0, cut small."""
    cfg.dataset.name = "RH2"
    cfg.rh2.dataset_dir = dataset_dir
    m, t, ev = cfg.model, cfg.training, cfg.evaluation
    m.scale = 1.0
    m.hash_levels, m.hash_features_per_level = 16, 2
    m.hash_log2_T, m.hash_max_res, m.grid_size = 12, 64, 32
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 256
    t.max_steps, t.max_time = 8, 1e9
    t.sensors = list(sensors)
    cfg.occ_grid.batch_size, cfg.occ_grid.update_interval = 64, 4
    ev.eval_every_n_steps, ev.num_depth_pts_per_step = 4, 2
    ev.res_angular, ev.res_map = 64, 32
    ev.batch_size, ev.max_samples_per_ray = 512, 48
    ev.num_color_pts, ev.num_depth_pts = 1, 2
    return cfg


OVERRIDES = [
    "dataset.name=RH2", "model.scale=1.0", "model.hash_log2_T=12",
    "model.hash_max_res=64", "model.grid_size=32", "training.batch_size=128",
    "training.max_samples_per_ray=32", "training.march_candidates=256",
    "training.march_resolution=256", "training.max_steps=8",
    "training.max_time=1e9", 'training.sensors=["USS", "ToF"]',
    "occ_grid.batch_size=64", "occ_grid.update_interval=4",
    "evaluation.eval_every_n_steps=4", "evaluation.num_depth_pts_per_step=2",
    "evaluation.res_angular=64", "evaluation.res_map=32",
    "evaluation.batch_size=512", "evaluation.max_samples_per_ray=48",
    "evaluation.num_color_pts=1", "evaluation.num_depth_pts=2",
]


@pytest.fixture(scope="module")
def train_data(fixture_dir, tmp_path_factory):
    """Both packages' train splits of the fixture, each loader on its own
    copy."""
    base = tmp_path_factory.mktemp("train_data")
    j_dir = str(base / "j")
    shutil.copytree(fixture_dir, j_dir)
    t_dir = str(base / "t")
    shutil.copytree(fixture_dir, t_dir)
    sys.path.insert(0, fixture_dir)
    sys.modules.pop("robotathome", None)
    try:
        jds, jscene, _ = jrh.load_rh_dataset(run_config(JConfig(), j_dir), "train")
    finally:
        sys.path.remove(fixture_dir)
        sys.modules.pop("robotathome", None)
    pds, pscene, _ = trh.load_rh_dataset(run_config(Config(), t_dir), "train",
                                         device="cpu")
    return j_dir, t_dir, (jds, jscene), (pds, pscene)


def eight_steps(train_data, sensors, sync=False):
    """8 steps of both trainers from the JAX initial state, every draw the
    JAX step bodies' own (their key splits, trainer.py:249, 373) handed to
    the port's train_step_on / grid_update_on, as test_torch_run.py's
    eight_steps does on the ETHZ fixture: two cascades, exponential
    stepping, the one-row VIRUS grid marched past its end.  With "RGBD" the
    grid updates take the RGBD depth at random pixels and the loss its
    depth term (the trainer's sensor cascade).  With ``sync`` the entries
    one side's Adam step moved apart are set equal after each step.
    Returns the losses, sample counts and synced entries a step."""
    j_dir, t_dir, (jds, jscene), (pds, pscene) = train_data
    jcfg = run_config(JConfig(), j_dir, sensors)
    cfg = run_config(Config(), t_dir, sensors)
    assert cfg.cascades == 2 and cfg.exp_step_factor == 1 / 256
    jt = JTrainer(jcfg, jds, scene=jscene)
    pt = Trainer(cfg, pds, scene=pscene, device="cpu")
    assert pt.sample_budget is None  # dense at scale 1.0, as the JAX rule
    assert pt.ray_sel[0] == ("random" if "RGBD" in sensors else "valid_tof")
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
                jds, k, n, {"imgs": "all", "pixs": pixs}))
                for k, n, pixs in ((k1, pt.b_ray, pt.ray_sel[0]),
                                   (k2, pt.b_nerf, pt.nerf_sel[0])))
            noise = jax.random.uniform(jax.random.split(k3)[1],
                                       (pt.b_nerf, 32, 3), jnp.float32) * 2.0 - 1.0
            pt.grid_update_on(ps, ray_b, nerf_b, torch.from_numpy(np.array(noise)))
            js = occ_body(js, jds, et)
        _, k_batch, k_render = jax.random.split(js.key, 3)
        batch = j_sample_batch(jds, k_batch, t.batch_size, t.sampling_strategy)
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
    assert min(out["vr_p"]) > 0
    return out


SENSORS = [("USS", "ToF"), ("RGBD", "USS", "ToF")]


@pytest.mark.parametrize("sensors", SENSORS)
def test_eight_steps_at_scale_one_match_jax(train_data, sensors):
    # float32 rendering, loss and Adam in another op order on each side.
    # Adam moves a table entry by about lr * sign(g) however small g is, so
    # an entry whose gradient is rounding noise of opposite sign on the two
    # sides moves 2 lr apart (ROADMAP C8).  On this room, without the RGBD
    # term, 139 entries move apart at step 0 and the losses, within 1.3e-7
    # at step 0, drift to 2.04e-5 relative at step 1 and 2.56e-5 at most
    # (measured; 1e-5 was asked through step 1); with it, 1.04e-5 at most.
    # The witness below sets those entries equal after each step and holds
    # every step to 1e-5 (measured within 9.5e-7)
    out = eight_steps(train_data, sensors)
    np.testing.assert_allclose(out["loss_p"][:1], out["loss_j"][:1], rtol=1e-5)
    np.testing.assert_allclose(out["loss_p"], out["loss_j"], rtol=1e-4)


@pytest.mark.parametrize("sensors", SENSORS)
def test_eight_steps_at_scale_one_match_jax_with_entries_stepped_apart_synced(
        train_data, sensors):
    out = eight_steps(train_data, sensors, sync=True)
    np.testing.assert_allclose(out["loss_p"], out["loss_j"], rtol=1e-5)
    assert min(out["synced"]) > 0  # every step moves entries apart


def test_run_main_maps_an_rh2_room_on_the_cpu(fixture_dir, tmp_path, capsys):
    d = copy_of(fixture_dir, tmp_path, "rh")
    save = str(tmp_path / "run")
    args = ["--device", "cpu", "--save-dir", save, "--seed", "3",
            "--override", f"rh2.dataset_dir={d}"]
    for ov in OVERRIDES:
        args += ["--override", ov]
    metrics = run.main(args)
    for name in RUN_FILES:
        assert os.path.exists(os.path.join(save, name)), name
    renders = sorted(os.listdir(os.path.join(save, "renders")))
    assert len(renders) == 3 and {r.split("_")[0] for r in renders} == {
        "rgb", "depth"}
    rows = [line.split(",")[0] for line in open(os.path.join(save, "metrics.csv"))]
    assert rows[1:] == ["USS", "ToF", "NeRF"]
    logs = [line.rstrip("\n").split(",") for line in open(os.path.join(save, "logs.csv"))]
    assert logs[0] == list(LOG_COLUMNS) and len(logs) == 9
    assert [r[-1] != "nan" for r in logs[1:]] == [False] * 3 + [True] + [False] * 3 + [True]
    assert np.isfinite(metrics["NeRF"]["nn_mean"]["zone3"])
    assert np.isfinite(metrics["NeRF"]["psnr"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("evaluation: psnr=")
    assert '"scale": 1.0' in open(os.path.join(save, "hparams.json")).read()
    # the split the run wrote beside the data
    assert os.path.exists(os.path.join(d, *SPLIT_DIR, "split_subsession_1.csv"))


def test_this_file_builds_the_config_it_states():
    # run.main's OVERRIDES are run_config's cut, flag for flag
    cfg = run_config(Config(), "x")
    other = Config()
    from virus_nerf_tpu_torch.configs.config import apply_cli_overrides

    apply_cli_overrides(other, OVERRIDES + ["rh2.dataset_dir=x"])
    assert other.to_dict() == cfg.to_dict()
