"""The port's deployment export and density-map inference
(``virus_nerf_tpu_torch/utils/deployment.py``) against the JAX package's
(``virus_nerf_tpu/utils/deployment.py``) on the same weights (the JAX
model's, converted with ``convert.py``) and the same seed-made grids and
poses.  ``deployment.npy`` is held key for key: the bitfield, the poses
and every flattened weight exactly (the same float32 values in the same
order), the per-level scale exactly.  The density maps are float32 model
outputs in another op order: within the model tests' rtol of 1e-5."""

import jax
import numpy as np
import pytest
import torch

from virus_nerf_tpu.models.ngp import NGPModel as JModel
from virus_nerf_tpu.utils import deployment as J
from virus_nerf_tpu_torch.convert import params_from_jax
from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.utils import deployment as P

torch.set_num_threads(1)

CONFIGS = {
    "additive_8x4": dict(levels=8, feature_per_level=4, log2_T=12, max_res=64),
    "additive_16x2": dict(levels=16, feature_per_level=2, log2_T=12,
                          max_res=64),
    "xor_16x2": dict(levels=16, feature_per_level=2, log2_T=12, max_res=64,
                     hash_variant="xor"),
}
GS = 16


def models(name, seed=0):
    kw = dict(CONFIGS[name], scale=0.5, grid_size=GS)
    jm = JModel(**kw)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = NGPModel(**kw, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       device="cpu"))
    return jm, params, tm


def load(path):
    return np.load(path, allow_pickle=True).item()


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("threshold", [0.5, 0.9])
def test_deployment_npy_matches_jax_key_for_key(name, threshold, tmp_path):
    jm, params, tm = models(name)
    rng = np.random.default_rng(1)
    occ = rng.random((1, GS**3)).astype(np.float32)
    poses = rng.standard_normal((5, 3, 4))
    want = load(J.save_deployment_model(jm, params, occ, poses,
                                        str(tmp_path / "jax"), threshold))
    got = load(P.save_deployment_model(tm, occ, poses, str(tmp_path / "port"),
                                       threshold))
    assert list(got) == list(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["model.density_bitfield"].shape == (GS**3 // 8,)
    # the rgb output layer's 13 rows of zeros
    width = tm.rgb_net[-1].weight.shape[1]
    assert not got["model.rgb_net.params"][-13 * width:].any()


def test_deployment_takes_tensors_on_the_model_device(tmp_path):
    # the trainer's grid and the dataset's poses are tensors
    jm, params, tm = models("additive_8x4")
    rng = np.random.default_rng(2)
    occ = rng.random((1, GS**3)).astype(np.float32)
    poses = rng.standard_normal((3, 3, 4)).astype(np.float32)
    want = load(J.save_deployment_model(jm, params, occ, poses,
                                        str(tmp_path / "jax")))
    got = load(P.save_deployment_model(
        tm, torch.from_numpy(occ), torch.from_numpy(poses),
        str(tmp_path / "port")))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("heights,tol", [(1, 0.0), (2, 0.05), (3, 0.1)])
def test_infer_density_map_matches_jax(name, heights, tol):
    jm, params, tm = models(name, seed=3)
    # 32 x 32 x A probes in chunks of 500: the last chunk is padded
    kw = dict(res_map=32, height_c=0.05, num_avg_heights=heights,
              tolerance_c=tol, batch_size=500)
    want = J.infer_density_map(jm, params, **kw)
    got = P.infer_density_map(tm, **kw)
    assert got.shape == want.shape == (32, 32) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.ptp(got) > 0  # the map is not constant
    # thresholded at the median: the same cells, but for values within
    # the tolerance of the threshold
    thr = float(np.median(want))
    bt = P.infer_density_map(tm, **kw, threshold=thr)
    bj = J.infer_density_map(jm, params, **kw, threshold=thr)
    near = np.abs(want - thr) <= 1e-5 * thr
    np.testing.assert_array_equal(bt[~near], bj[~near])
    assert set(np.unique(bt)) <= {0.0, 1.0}
