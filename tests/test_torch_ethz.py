"""The port's ETHZ path (virus_nerf_tpu_torch/data/ethz.py,
data/ethz_fixture.py, data/__init__.py) against the JAX package: the
fixture writer against ``tools/make_ethz_fixture.py`` (the same files), and
``load_ethz_dataset`` against the JAX loader on both splits with every
sensor (every field equal, NaN where NaN; the same split files).  Each
loader reads its own copy of the fixture, so the split files it writes are
compared, not shared.  Small: 10 images a camera at 64x48, 20,000 map
points."""

import filecmp
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from virus_nerf_tpu.configs.config import Config as JConfig
from virus_nerf_tpu.data import ethz as jethz
from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data import ethz as tethz
from virus_nerf_tpu_torch.data import make_dataset
from virus_nerf_tpu_torch.data.ethz_fixture import generate_ethz_fixture
from virus_nerf_tpu_torch.data.pcl import load_pcd, save_pcd
from virus_nerf_tpu_torch.data.png import read_png

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools.make_ethz_fixture import generate_ethz_fixture as tool_fixture  # noqa: E402

FIXTURE_KW = dict(n_images=10, img_wh=(64, 48), n_gt_points=20_000)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return tool_fixture(str(tmp_path_factory.mktemp("ethz_tool")), **FIXTURE_KW)


def copy_of(fixture_dir, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(fixture_dir, dst)
    return dst


def configs(j_dir, t_dir, **kw):
    out = []
    for C, d in ((JConfig, j_dir), (Config, t_dir)):
        cfg = C()
        cfg.dataset.name = "ETHZ"
        cfg.ethz.dataset_dir = d
        for k, v in kw.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


def assert_same_files(a, b):
    """Every file of tree ``a`` in ``b``: CSVs byte for byte, arrays equal,
    PNG pixels equal (decoded by OpenCV and by the port), PCD points equal."""
    n = 0
    for root, _, files in os.walk(a):
        for name in files:
            pa = os.path.join(root, name)
            pb = os.path.join(b, os.path.relpath(pa, a))
            assert os.path.exists(pb), pb
            if name.endswith(".png"):
                want = cv2.imread(pa, cv2.IMREAD_COLOR)[:, :, ::-1]
                np.testing.assert_array_equal(read_png(pb), want)
                np.testing.assert_array_equal(
                    cv2.imread(pb, cv2.IMREAD_COLOR)[:, :, ::-1], want)
            elif name.endswith(".npy"):
                x, y = np.load(pa), np.load(pb)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            elif name.endswith(".pcd"):
                np.testing.assert_array_equal(load_pcd(pa), load_pcd(pb))
            else:
                assert filecmp.cmp(pa, pb, shallow=False), pa
            n += 1
    assert n == sum(len(f) for _, _, f in os.walk(b))
    return n


@pytest.mark.parametrize("noise", [True, False])
def test_fixture_writer_writes_the_tools_files(tmp_path, noise):
    kw = dict(FIXTURE_KW, n_images=4, noise=noise)
    a = tool_fixture(str(tmp_path / "tool"), **kw)
    b = generate_ethz_fixture(str(tmp_path / "port"), **kw)
    # 2 cameras x 4 images x (png, npy), 4 pose files + USS + TOF a camera,
    # intrinsics, map
    assert assert_same_files(a, b) == 2 * 4 * 2 + 2 * 6 + 2


def j_np(x):
    return np.asarray(x)


@pytest.mark.parametrize("split", ["train", "test"])
def test_loader_matches_jax(fixture_dir, tmp_path, split):
    j_dir = copy_of(fixture_dir, tmp_path, "j")
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    jcfg, cfg = configs(j_dir, t_dir)
    assert cfg.dataset.sensors == ["RGBD", "USS", "ToF"]
    jds, jscene, jinfo = jethz.load_ethz_dataset(jcfg, split)
    ds, scene, info = tethz.load_ethz_dataset(cfg, split, device="cpu")
    assert ds.n_images == jds.n_images > 0
    for field in jds._fields:
        want, got = getattr(jds, field), getattr(ds, field)
        if field == "depths":
            assert set(got) == set(want) == {"RGBD", "USS", "ToF"}
            pairs = [(got[k], want[k]) for k in want]
        else:
            pairs = [(got, want)]
        for g, w in pairs:
            w = j_np(w)
            assert g.device.type == "cpu"
            # floats exact, NaN where NaN; indices as int64 on the port's side
            if w.dtype.kind in "iu":
                assert g.dtype == torch.int64, field
            else:
                assert g.dtype == torch.float32 and w.dtype == np.float32, field
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    assert set(ds.sensor_ids.tolist()) <= {1, 3} and ds.directions.shape[0] == 2
    assert torch.isnan(ds.depths["RGBD"]).any() and torch.isnan(ds.depths["ToF"]).any()
    # the scene and the info dict
    np.testing.assert_array_equal(scene.point_cloud, jscene.point_cloud)
    assert scene.w2c(1.0, only_scale=True) == jscene.w2c(1.0, only_scale=True)
    assert info["img_wh"] == jinfo["img_wh"] == (64, 48)
    assert info["camera_aov_deg"] == jinfo["camera_aov_deg"]
    np.testing.assert_array_equal(info["poses_lidar"], jinfo["poses_lidar"])
    assert info["K"].keys() == jinfo["K"].keys()
    for cam in info["K"]:
        np.testing.assert_array_equal(info["K"][cam], jinfo["K"][cam])
    for name in ("RGBD", "USS", "ToF"):
        np.testing.assert_array_equal(info["sensor_models"][name].mask,
                                      jinfo["sensor_models"][name].mask)
    # the split files, byte for byte
    sj = os.path.join(j_dir, "commonroom", "split")
    st = os.path.join(t_dir, "commonroom", "split")
    assert sorted(os.listdir(sj)) == sorted(os.listdir(st)) == [
        "split_CAM1.csv", "split_CAM3.csv", "split_description.csv"]
    for name in os.listdir(sj):
        assert filecmp.cmp(os.path.join(sj, name), os.path.join(st, name),
                           shallow=False), name


def test_second_load_reuses_the_split(fixture_dir, tmp_path):
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    _, cfg = configs(t_dir, t_dir)
    first, scene, _ = tethz.load_ethz_dataset(cfg, "test", device="cpu")
    split = os.path.join(t_dir, "commonroom", "split", "split_CAM1.csv")
    before = open(split).read()
    # another seed would draw another split; the stored one is reused
    cfg.seed = 5
    again, _, _ = tethz.load_ethz_dataset(cfg, "test", scene=scene, device="cpu")
    assert open(split).read() == before
    np.testing.assert_array_equal(again.poses.numpy(), first.poses.numpy())
    # the JAX loader reads the port's split the same way
    jcfg, _ = configs(t_dir, t_dir)
    jcfg.seed = 5
    jds, _, _ = jethz.load_ethz_dataset(jcfg, "test")
    np.testing.assert_array_equal(again.poses.numpy(), j_np(jds.poses))


def test_load_lidar_maps_matches_jax(fixture_dir, tmp_path):
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    jcfg, cfg = configs(t_dir, t_dir)
    ds, scene, info = tethz.load_ethz_dataset(cfg, "train", device="cpu")
    rng = np.random.default_rng(0)
    lidar = os.path.join(t_dir, "commonroom", "lidars", "filtered")
    for t in (100.0, 100.5, 102.0, 104.5):
        save_pcd(os.path.join(lidar, f"{t:.3f}.pcd"), rng.normal(size=(30, 3)))
    times = ds.times.numpy()
    got = tethz.load_lidar_maps(cfg, times, info["poses_lidar"], scene)
    want = jethz.load_lidar_maps(jcfg, times, info["poses_lidar"], scene)
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[0]) == len(want[0]) == ds.n_images
    assert any(len(x) for x in got[0]) and any(not len(x) for x in got[0])
    for x, y in zip(*(got[0], want[0])):
        np.testing.assert_array_equal(x, y)


def test_make_dataset_by_name(fixture_dir, tmp_path):
    _, cfg = configs(None, copy_of(fixture_dir, tmp_path, "t"))
    ds, scene, info = make_dataset(cfg, "train", device="cpu")
    assert ds.directions.shape == (2, 64 * 48, 3) and info["img_wh"] == (64, 48)
    test, _, _ = make_dataset(cfg, "test", scene=scene, device="cpu")
    assert test.n_images > 0
    cfg.dataset.name = "synthetic"
    syn, _, _ = make_dataset(cfg, "train", device="cpu")
    assert syn.n_images == 16 and syn.directions.shape[0] == 1
    # RH2 on a directory without its files: the robotathome package
    cfg.dataset.name = "RH2"
    with pytest.raises(ImportError, match="RH2"):
        make_dataset(cfg, "train", device="cpu")
    cfg.dataset.name = "nope"
    with pytest.raises(ValueError):
        make_dataset(cfg, "train", device="cpu")


def test_loader_refuses_the_cpu_fallback(fixture_dir, tmp_path):
    # the default device is the card: without one the loader raises before
    # it reads anything (no split files are written)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is usable")
    t_dir = copy_of(fixture_dir, tmp_path, "t")
    _, cfg = configs(t_dir, t_dir)
    with pytest.raises((RuntimeError, AssertionError)):
        tethz.load_ethz_dataset(cfg, "train")
    assert not os.path.exists(os.path.join(t_dir, "commonroom", "split"))


def test_gray_and_rgba_images_read_as_opencv_colour(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "room" / "measurements" / "CAM1_color_image_raw"
    d.mkdir(parents=True)
    gray = rng.integers(0, 256, (6, 5), np.uint8)
    rgba = rng.integers(0, 256, (6, 5, 4), np.uint8)
    cv2.imwrite(str(d / "img0.png"), gray)
    cv2.imwrite(str(d / "img1.png"), rgba)
    got = tethz._read_imgs(str(tmp_path / "room"), ["CAM1"],
                           {"CAM1": np.array([True, True])})
    for i in range(2):
        want = cv2.imread(str(d / f"img{i}.png"), cv2.IMREAD_COLOR)[:, :, ::-1]
        np.testing.assert_array_equal(
            got[i], want.reshape(-1, 3).astype(np.float32) / 255.0)

