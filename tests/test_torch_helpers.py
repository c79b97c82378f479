"""The port's host helpers (``virus_nerf_tpu_torch/utils/helpers.py``) against
the JAX package's (``virus_nerf_tpu/utils/helpers.py``) on the same
seed-made numpy inputs: numpy copies, so every output is held equal
exactly, dtype and NaN positions included; and the port's logger
(``utils/logging.py``) and the trainer's lines in ``log.txt``."""

import logging

import numpy as np
import pytest

from virus_nerf_tpu.utils import helpers as J
from virus_nerf_tpu_torch.utils import helpers as P


def assert_same(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        # NaN in the same places, every other value bit for bit
        np.testing.assert_array_equal(got, want)
        return
    assert type(got) is type(want) and got == want


def _series(seed, n=64, nan_every=5):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(n))
    x[::nan_every] = np.nan
    return x


@pytest.mark.parametrize("name", [
    "CAM1", "CAM3", "USS1", "TOF3", "RGBD_1",
    np.array(["CAM1", "USS3", "TOF1"], dtype=object), ["CAM3", "CAM1"],
])
def test_sensor_name2id(name):
    assert_same(P.sensor_name2id(name), J.sensor_name2id(name))


@pytest.mark.parametrize("sid,kind", [
    (1, "CAM"), (3, "USS"), (np.int64(1), "TOF"),
    (np.array([1, 3]), "CAM"), ([3, 1, 3], "USS"),
])
def test_sensor_id2name(sid, kind):
    assert_same(P.sensor_id2name(sid, kind), J.sensor_id2name(sid, kind))


@pytest.mark.parametrize("border", ["nan", "nearest"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lin_interpolate_array(border, seed):
    rng = np.random.default_rng(seed)
    x1 = rng.permutation(np.linspace(0.0, 10.0, 40))  # unsorted abscissae
    y1 = rng.standard_normal(40)
    x2 = rng.uniform(-2.0, 12.0, 100)  # some outside on both sides
    assert_same(P.lin_interpolate_array(x1, y1, x2, border),
                J.lin_interpolate_array(x1, y1, x2, border))


def test_lin_interpolate_array_refuses_a_bad_border():
    with pytest.raises(ValueError, match="border_condition"):
        P.lin_interpolate_array(np.arange(3.0), np.arange(3.0), [1.0], "wrap")


@pytest.mark.parametrize("case", ["inner", "edges", "all_nan", "no_nan", "ints"])
def test_lin_interpolate_nans(case):
    x = _series(3)
    if case == "edges":
        x[0] = x[-1] = x[1] = np.nan
    elif case == "all_nan":
        x = np.full(9, np.nan)
    elif case == "no_nan":
        x = np.arange(9.0)
    elif case == "ints":
        x = np.arange(9)
    assert_same(P.lin_interpolate_nans(x), J.lin_interpolate_nans(x))


@pytest.mark.parametrize("kernel", [[1.0], [0.25, 0.5, 0.25], np.ones(7) / 7])
def test_convolve_ignore_nans(kernel):
    x = _series(4, nan_every=3)
    k = np.asarray(kernel)
    assert_same(P.convolve_ignore_nans(x, k), J.convolve_ignore_nans(x, k))


@pytest.mark.parametrize("window,order,n", [(5, 3, 64), (11, 2, 64), (9, 3, 5)])
def test_smooth_ignore_nans(window, order, n):
    x = _series(5, n=n)
    assert_same(P.smooth_ignore_nans(x, window, order),
                J.smooth_ignore_nans(x, window, order))


@pytest.mark.parametrize("increasing", [True, False])
@pytest.mark.parametrize("threshold", [-1.0, 0.0, 0.5, 100.0])
def test_data_converged(increasing, threshold):
    rng = np.random.default_rng(6)
    x = np.cumsum(rng.standard_normal(50) * 0.1) * (1 if increasing else -1)
    assert_same(P.data_converged(x, threshold, increasing),
                J.data_converged(x, threshold, increasing))


@pytest.mark.parametrize("n_down", [1, 3, 8])
def test_downsample_data(n_down):
    rng = np.random.default_rng(7)
    flat = rng.standard_normal((8 * 5, 3))  # (N*M, 3)
    per_img = rng.standard_normal((8, 5, 2))  # (N, M, 2)
    vec = rng.standard_normal(8 * 5)
    assert_same(P.downsample_data([flat, per_img, vec], 8, n_down),
                J.downsample_data([flat, per_img, vec], 8, n_down))


def test_downsample_data_refuses_more_images():
    with pytest.raises(ValueError, match="downsample"):
        P.downsample_data([np.zeros((4, 2))], 4, 5)


@pytest.mark.parametrize("upsample", [1, 3])
def test_combine_imgs_pixels(upsample):
    # the overlay of plot_maps_per_image: GT map, GT scan, sensor scan, in
    # matplotlib colour names; later layers on top
    rng = np.random.default_rng(8)
    masks = [rng.random((24, 16)) > p for p in (0.5, 0.8, 0.9)]
    colors = ["grey", "black", "tab:red"]
    assert_same(P.combine_imgs(masks, colors, upsample),
                J.combine_imgs(masks, colors, upsample))



# ------------------------------------------------------------------ logging
def _text_lines(path):
    """log.txt's lines without their time stamps: "LEVEL message"."""
    with open(path) as f:
        return [line.rstrip("\n").split(" ", 2)[2] for line in f]


def _fresh(logger):
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


@pytest.mark.parametrize("level", ["info", "warning", "error"])
def test_make_logger_writes_log_txt_as_jax(level, tmp_path):
    from types import SimpleNamespace

    from virus_nerf_tpu.utils.logging import make_logger as j_make_logger
    from virus_nerf_tpu_torch.utils.logging import make_logger

    names = ("virus_nerf_tpu_logtest", "virus_nerf_tpu_torch_logtest")
    for name, fn, sub in zip(names, (j_make_logger, make_logger),
                             ("jax", "port")):
        logger = logging.getLogger(name)
        _fresh(logger)
        try:
            log = fn(SimpleNamespace(save_dir=str(tmp_path / sub)), name=name)
            assert log is logger and log.level == logging.INFO
            assert not log.propagate
            getattr(log, level)("one %s line", level)
            log.debug("not written")
        finally:
            _fresh(logger)
    assert _text_lines(tmp_path / "port" / "log.txt") == _text_lines(
        tmp_path / "jax" / "log.txt") == [f"{level.upper()} one {level} line"]


def test_each_run_gets_its_own_log_txt(tmp_path):
    # the JAX function leaves a logger that has handlers as it is (only a
    # process's first run gets a log.txt); the port's moves the file
    # handler to each run's save_dir
    from types import SimpleNamespace

    from virus_nerf_tpu_torch.utils.logging import make_logger

    name = "virus_nerf_tpu_torch_runs"
    try:
        make_logger(None, name=name).info("no file yet")
        for run in ("a", "b", "b"):
            make_logger(SimpleNamespace(save_dir=str(tmp_path / run)),
                        name=name).info("run %s", run)
        logger = logging.getLogger(name)
        assert sum(type(h) is logging.StreamHandler
                   for h in logger.handlers) == 1
        assert sum(isinstance(h, logging.FileHandler)
                   for h in logger.handlers) == 1
    finally:
        _fresh(logging.getLogger(name))
    assert _text_lines(tmp_path / "a" / "log.txt") == ["INFO run a"]
    assert _text_lines(tmp_path / "b" / "log.txt") == ["INFO run b"] * 2


def test_trainer_logs_the_jax_trainers_lines(tmp_path):
    # the JAX trainer's lines (trainer.py:529, 550-553, 651-652): START,
    # a line a chunk, max_time, FINISHED
    from test_torch_slice import DATA_KW, small_config
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.training.trainer import Trainer

    cfg = small_config()
    cfg.save_dir = str(tmp_path / "run")
    cfg.training.max_steps, cfg.training.max_time = 8, 0.0
    cfg.evaluation.eval_every_n_steps = 4
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    logger = logging.getLogger("virus_nerf_tpu_torch")
    try:
        state = Trainer(cfg, ds, scene=scene, device="cpu").train()
    finally:
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
    lines = _text_lines(tmp_path / "run" / "log.txt")
    assert state.step == 4  # max_time ended the run after the first chunk
    assert lines[0] == "INFO ----- START TRAINING -----"
    assert lines[1].startswith("INFO step     3 | loss ")
    assert lines[2] == "INFO max_time reached at step 4"
    assert lines[3].startswith("INFO ----- FINISHED TRAINING ----- ")
    assert lines[3].endswith("s, iter: 4") and len(lines) == 4
