"""E2, the evaluator's nearest-neighbour search (``csrc/nn_search.cu``,
``ops/nn_search.py``), on the CPU.

The kernel cannot run without a card.  Here its plain version
``nn_search_plain`` and ``nn_metrics`` through it are held to the JAX
package's ``find_nearest_neighbour`` and ``nn_metrics`` bit for bit, and a
numpy emulation of the kernel's scheme (``nn_search_cases.emulate_e2``: a
thread a query scanning the references in order, a tile at a time, every
float32 operation rounded once) to the plain version.  The cases: NaN rows
on either side, images with no valid query or reference, exact ties
(duplicated and mirror-symmetric reference points), points whose distance
an FMA-contracted d^2 would change, K != M (LiDAR- and USS-style packing),
inf coordinates, and 1 and 16 images at 512 x 512.  And an evaluator on
the CPU, which searches on the host.
"""

import numpy as np
import pytest
import torch

import nn_search_cases as C
from virus_nerf_tpu.evaluation import geometry as jgeo
from virus_nerf_tpu.evaluation import metrics as jmet
from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.evaluation import metrics as tmet
from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
from virus_nerf_tpu_torch.ops.nn_search import nn_search, nn_search_plain
from virus_nerf_tpu_torch.training.trainer import Trainer
from virus_nerf_tpu_torch.utils import tracing

torch.set_num_threads(1)

ZONES = {"zone1": (0.0, 1.0), "zone2": (0.0, 2.5), "zone3": (0.0, 100.0)}


def _f32(x):
    return torch.from_numpy(np.array(x, np.float32))


def _jax_search(pos, pos_ref, n):
    """The JAX package's search, image by image."""
    p = np.asarray(pos).reshape(n, -1, 2)
    r = np.asarray(pos_ref).reshape(n, -1, 2)
    out = [jgeo.find_nearest_neighbour(p[i], r[i], ignore_nan=True)
           for i in range(n)]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def _same_metrics(a, b):
    """nn_metrics outputs equal: the distances bit for bit, the dicts key
    for key and value for value (NaN for NaN)."""
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].dtype == b[0].dtype
    for x, y in zip(a[1:], b[1:]):
        assert list(x) == list(y)
        assert [repr(v) for v in x.values()] == [repr(v) for v in y.values()]
        if not any(np.isnan(v) for v in x.values()):
            assert x == y


@pytest.mark.parametrize("name", C.CASES)
def test_plain_search_is_the_jax_search(name):
    pos, pos_ref, n = C.case(name)
    with np.errstate(invalid="ignore"):
        idx, dist = nn_search_plain(_f32(pos), _f32(pos_ref), n)
        want_idx, want_dist = _jax_search(pos, pos_ref, n)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    assert idx.shape == dist.shape == want_idx.shape
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert C.same_f32(dist.numpy(), want_dist)


@pytest.mark.parametrize("name", C.CASES)
def test_emulated_kernel_is_the_plain_search(name):
    pos, pos_ref, n = C.case(name)
    with np.errstate(invalid="ignore"):
        want_idx, want_dist = nn_search_plain(_f32(pos), _f32(pos_ref), n)
    idx, dist = C.emulate_e2(pos, pos_ref, n)
    np.testing.assert_array_equal(idx, want_idx.numpy())
    assert C.same_f32(dist, want_dist.numpy())


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("name", ["fma", "n16_512"])
def test_contraction_would_change_the_distances(name, first):
    # the cases the card's test shares catch a fused multiply-add: the
    # emulated kernel with d^2 contracted either way gives other distances
    pos, pos_ref, n = C.case(name)
    _, want = C.emulate_e2(pos, pos_ref, n)
    _, fused = C.emulate_e2(pos, pos_ref, n, fma_first=first)
    found = ~np.isnan(want)
    assert np.count_nonzero(fused[found] != want[found]) >= 0.1 * found.sum()


@pytest.mark.parametrize("ref_pos_is_gt", [True, False])
@pytest.mark.parametrize("name", ["random", "float64_inputs", "nan_rows",
                                  "empty_images", "duplicate_ties",
                                  "mirror_ties", "lidar", "uss", "n1_512",
                                  "n16_512"])
def test_nn_metrics_through_the_search_is_jax(name, ref_pos_is_gt):
    pos, pos_ref, n = C.case(name)
    rng = np.random.default_rng(3)
    k, m = pos.shape[0] // n, pos_ref.shape[0] // n
    # depths of the queries and of the references, one of them the GT's
    d_q, d_r = rng.uniform(0.2, 6.0, n * k), rng.uniform(0.2, 6.0, n * m)
    depths, depths_gt = (d_q, d_r) if ref_pos_is_gt else (d_r, d_q)
    args = (pos, pos_ref, depths, depths_gt, n, ref_pos_is_gt, ZONES, 0.1)
    got = tmet.nn_metrics(*args, device="cpu")
    _same_metrics(got, jmet.nn_metrics(*args))
    _same_metrics(tmet.nn_metrics(*args), got)  # the default is the CPU


def test_nn_search_checks_its_inputs():
    launches = nn_search.launches
    pos, ref = torch.zeros(12, 2), torch.ones(9, 2)
    idx, dist = nn_search(pos, ref, 3)
    assert idx.shape == dist.shape == (3, 4)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    assert (idx == 0).all() and (dist == np.sqrt(np.float32(2))).all()
    for bad in (pos.double(), torch.zeros(12, 3), torch.zeros(24)):
        with pytest.raises(TypeError):
            nn_search(bad, ref, 3)
    with pytest.raises(TypeError):
        nn_search(pos, ref.half(), 3)
    with pytest.raises(ValueError):
        nn_search(pos, torch.ones(10, 2), 3)  # 10 references over 3 images
    with pytest.raises(ValueError):
        nn_search(pos, ref, 0)
    with pytest.raises(ValueError):
        nn_search(pos, ref.to("meta"), 3)
    assert nn_search.launches == launches  # no launch on the CPU


def test_cpu_evaluator_searches_on_the_host(monkeypatch):
    # an evaluator on the CPU searches with the numpy path: no launch,
    # three nnd spans a sensor, and the metrics of the JAX
    # package's nn_metrics exactly
    ds, scene, info = make_synthetic_dataset(device="cpu", n_images=4,
                                             img_wh=(32, 24), n_gt_points=2000)
    cfg = Config()
    m, t, ev = cfg.model, cfg.training, cfg.evaluation
    m.hash_levels, m.hash_log2_T, m.hash_max_res, m.grid_size = 4, 12, 64, 32
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 256
    ev.res_angular, ev.res_map = 64, 64
    ev.batch_size, ev.max_samples_per_ray = 64, 32
    state = Trainer(cfg, ds, scene=scene, device="cpu").init_state(0)
    evaluator = Evaluator(cfg, ds, scene, img_wh=info["img_wh"], device="cpu")
    idxs = np.arange(3)
    launches = nn_search.launches
    tracing.enable()
    tracing.reset()
    try:
        got = evaluator.evaluate_depth(state.model, state.grid.occ_bool, idxs,
                                       sensors=("NeRF",))
        snap = tracing.snapshot()
    finally:
        tracing.enable(False)
        tracing.reset()
    assert snap["span.evaluator.nnd.n"] == 3
    assert nn_search.launches == launches

    def jax_nn_metrics(*args, device, **kwargs):
        assert device == torch.device("cpu")
        return jmet.nn_metrics(*args, **kwargs)

    monkeypatch.setattr(tmet, "nn_metrics", jax_nn_metrics)
    want = evaluator.evaluate_depth(state.model, state.grid.occ_bool, idxs,
                                    sensors=("NeRF",))
    assert np.isfinite(got[0]["NeRF"]["nn_mean"]["zone3"])
    for key, value in want[0]["NeRF"].items():
        if key.startswith("nn_dists"):
            np.testing.assert_array_equal(got[0]["NeRF"][key], value)
        else:
            assert repr(got[0]["NeRF"][key]) == repr(value), key
