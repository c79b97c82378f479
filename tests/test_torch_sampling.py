"""Parity of the port's remaining sampling with the JAX package: the USS
statistics and the "closest" pixel strategy, "entire_img", and the
real-time simulation's image filter (``elapse_time``).

Integers are EQUAL; the statistics' depths are the batch's own float32
values, compared exactly.  The image filter's draws come from another
generator on each side, so the port's is held to its rule: only images
taken by ``elapse_time``, each about equally often, and every image while
none is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset
from virus_nerf_tpu.data.dataset import gather_batch as j_gather_batch
from virus_nerf_tpu.data.dataset import sample_batch as j_sample_batch
from virus_nerf_tpu.data.dataset import sample_pix_idxs as j_sample_pix_idxs
from virus_nerf_tpu.data.uss_stats import uss_stats_init as j_uss_init
from virus_nerf_tpu.data.uss_stats import uss_stats_update as j_uss_update
from virus_nerf_tpu_torch.convert import uss_stats_from_jax
from virus_nerf_tpu_torch.data.dataset import (
    sample_batch,
    sample_img_idxs,
    sample_pix_idxs,
)
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.data.uss_stats import uss_stats_init, uss_stats_update

torch.set_num_threads(1)

DATA_KW = dict(n_images=6, img_wh=(32, 24), n_gt_points=500)


@pytest.fixture(scope="module")
def datasets():
    jds, _, _ = j_make_dataset(**DATA_KW)
    pds, _, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    return jds, pds


def _uss_mask(ds):
    return np.isin(np.arange(ds.n_pixels), np.asarray(ds.uss_mask_idx))


def _fold_both(jst, pst, img, pix, depth, mask):
    jst = jax.jit(j_uss_update)(jst, jnp.asarray(img), jnp.asarray(pix),
                                jnp.asarray(depth), jnp.asarray(mask))
    pst = uss_stats_update(pst, torch.from_numpy(img), torch.from_numpy(pix),
                           torch.from_numpy(depth), torch.from_numpy(mask))
    return jst, pst


def _assert_stats_equal(pst, jst, pix_too=True):
    np.testing.assert_array_equal(pst.min_depth.numpy(), np.asarray(jst.min_depth))
    np.testing.assert_array_equal(pst.counts.numpy(), np.asarray(jst.counts))
    if pix_too:
        np.testing.assert_array_equal(pst.min_pix.numpy(), np.asarray(jst.min_pix))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uss_stats_update_matches_jax(datasets, seed):
    jds, pds = datasets
    mask = _uss_mask(jds)
    rng = np.random.default_rng(seed)
    n_img, hw = jds.n_images, jds.n_pixels
    center = int(np.asarray(jds.uss_mask_idx)[len(jds.uss_mask_idx) // 2])
    jst = j_uss_init(n_img, center)
    pst = uss_stats_init(n_img, center, device="cpu")
    _assert_stats_equal(pst, jst)
    for _ in range(6):
        # batches of distinct depths (no ties); image n_img - 1 never drawn
        img = rng.integers(0, n_img - 1, 64).astype(np.int32)
        pix = rng.integers(0, hw, 64).astype(np.int32)
        pix[:32] = rng.choice(np.asarray(jds.uss_mask_idx), 32)
        depth = rng.permutation(np.linspace(0.1, 2.0, 64)).astype(np.float32)
        jst, pst = _fold_both(jst, pst, img, pix, depth, mask)
        _assert_stats_equal(pst, jst)
    assert int(pst.counts[-1]) == 0 and pst.counts.sum() > 0
    assert int(pst.min_pix[-1]) == center  # untouched image


def test_uss_stats_update_ties_keep_the_last_batch_position(datasets):
    jds, _ = datasets
    mask = _uss_mask(jds)
    fov = np.asarray(jds.uss_mask_idx)
    jst = j_uss_init(jds.n_images, 0)
    pst = uss_stats_init(jds.n_images, 0, device="cpu")
    img = np.array([1, 1, 1, 2, 2], np.int32)
    pix = fov[[3, 5, 7, 9, 11]].astype(np.int32)
    depth = np.array([0.5, 0.3, 0.3, 0.8, 0.8], np.float32)
    jst, pst = _fold_both(jst, pst, img, pix, depth, mask)
    # min_depth and counts always agree; the pixel among tied minima is the
    # port's documented choice
    _assert_stats_equal(pst, jst, pix_too=False)
    assert int(pst.min_pix[1]) == fov[7] and int(pst.min_pix[2]) == fov[11]
    # the tracked pixel's depth is refreshed upward when its minimum moves
    depth2 = np.array([0.9, 0.9, 0.6, 1.0, 1.0], np.float32)
    jst, pst = _fold_both(jst, pst, img[:3], pix[:3], depth2[:3], mask)
    _assert_stats_equal(pst, jst, pix_too=False)
    assert float(pst.min_depth[1]) == np.float32(0.6)


def test_uss_stats_from_jax_round_trip(datasets):
    jds, _ = datasets
    jst = j_uss_init(jds.n_images, 7)
    pst = uss_stats_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    _assert_stats_equal(pst, jst)


@pytest.mark.parametrize("spec", [
    "closest",
    {"closest": 0.25, "valid_uss": 0.5},
    {"valid_tof": 0.3, "closest": 0.3},
])
def test_closest_pixels_match_jax(datasets, spec):
    jds, pds = datasets
    rng = np.random.default_rng(3)
    stats_pix = rng.integers(0, jds.n_pixels, jds.n_images).astype(np.int32)
    img = rng.integers(0, jds.n_images, 40).astype(np.int32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(j_sample_pix_idxs(jds, key, 40, spec,
                                        uss_stats_pix=jnp.asarray(stats_pix),
                                        img_idxs=jnp.asarray(img)))
    got = sample_pix_idxs(pds, torch.Generator().manual_seed(0), 40, spec,
                          uss_stats_pix=torch.from_numpy(stats_pix).long(),
                          img_idxs=torch.from_numpy(img).long())
    assert got.shape == want.shape
    # the "closest" slots are the tracked pixels of the batch's images, at
    # the same offsets as on the JAX side (the other slots are random draws)
    names = [spec] if isinstance(spec, str) else list(spec)
    offset = 0
    for name in names:
        b = int((1.0 if isinstance(spec, str) else spec[name]) * 40)
        if name == "closest":
            np.testing.assert_array_equal(got[offset:offset + b].numpy(),
                                          stats_pix[img[offset:offset + b]])
            np.testing.assert_array_equal(want[offset:offset + b],
                                          stats_pix[img[offset:offset + b]])
        offset += b
    with pytest.raises(ValueError):
        sample_pix_idxs(pds, torch.Generator(), 8, "closest")


def test_entire_img_matches_jax(datasets):
    jds, pds = datasets
    want = np.asarray(j_sample_pix_idxs(jds, jax.random.PRNGKey(0), 8, "entire_img"))
    got = sample_pix_idxs(pds, torch.Generator(), 8, "entire_img")
    np.testing.assert_array_equal(got.numpy(), want)
    # one image rendered whole: "same" image strategy, batch = H*W pixels
    hw = pds.n_pixels
    b = sample_batch(pds, torch.Generator().manual_seed(1), hw,
                     {"imgs": "same", "pixs": "entire_img"})
    assert b.rgb.shape == (hw, 3) and len(torch.unique(b.img_idxs)) == 1
    i = int(b.img_idxs[0])
    np.testing.assert_array_equal(b.rgb.numpy(), pds.rgbs[i].numpy())
    jb = jax.tree.map(np.asarray, j_gather_batch(
        jds, jnp.full(want.shape, i, jnp.int32), jnp.asarray(want)))
    # a float32 rotation in another op order
    np.testing.assert_allclose(b.rays_d.numpy(), jb.rays_d, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("strategy", ["all", "same"])
@pytest.mark.parametrize("elapse", [0.0, 4.5, 7.0])
def test_elapse_time_filter_draws_only_taken_images(datasets, strategy, elapse):
    jds, pds = datasets
    times = pds.times.numpy()  # linspace(0, 10, 6): 0, 2, 4, 6, 8, 10
    np.testing.assert_array_equal(times, np.asarray(jds.times))
    taken = np.where(times <= elapse)[0]
    gen = torch.Generator().manual_seed(2)
    got = np.concatenate([
        sample_img_idxs(pds, gen, 600, strategy, torch.tensor(elapse)).numpy()
        for _ in range(4 if strategy == "all" else 200)])
    assert set(np.unique(got)) == set(taken)
    counts = np.bincount(got, minlength=pds.n_images)[taken]
    assert counts.min() > 0.8 * counts.mean()  # uniform over the taken ones
    # the JAX filter draws from the same set
    for s in range(3):
        jb = j_sample_batch(jds, jax.random.PRNGKey(s), 64,
                            {"imgs": strategy, "pixs": "random"},
                            elapse_time=jnp.float32(elapse))
        assert set(np.unique(np.asarray(jb.img_idxs))) <= set(taken)
    # a float works too, and the batch's images are all taken by then
    b = sample_batch(pds, gen, 64, {"imgs": strategy, "pixs": "random"},
                     elapse_time=elapse)
    assert np.all(b.times.numpy() <= elapse)


def test_elapse_time_before_any_image_draws_every_image(datasets):
    _, pds = datasets
    gen = torch.Generator().manual_seed(4)
    got = sample_img_idxs(pds, gen, 3000, "all", -1.0).numpy()
    assert set(np.unique(got)) == set(range(pds.n_images))
    assert len(torch.unique(sample_img_idxs(pds, gen, 5, "same", -1.0))) == 1
