"""Parity of the port's small ops, model, renderer, loss, grid pieces and
batch sampling with the JAX package, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.grids import occupancy_grid as jog
from virus_nerf_tpu.models.ngp import NGPModel as JModel
from virus_nerf_tpu.models.renderer import render_rays as j_render_rays
from virus_nerf_tpu.ops import common as jcommon
from virus_nerf_tpu.ops.sh import sh_encode as j_sh_encode
from virus_nerf_tpu.training.loss import LossWeights as JWeights
from virus_nerf_tpu.training.loss import compute_loss as j_compute_loss
from virus_nerf_tpu_torch.convert import params_from_jax
from virus_nerf_tpu_torch.data.dataset import Batch, sample_batch
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.grids import occupancy_grid as tog
from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.models.renderer import render_rays
from virus_nerf_tpu_torch.ops import common
from virus_nerf_tpu_torch.ops.sh import sh_encode
from virus_nerf_tpu_torch.training.loss import LossWeights, compute_loss

torch.set_num_threads(1)

MODEL_KW = dict(levels=8, feature_per_level=4, log2_T=12, base_res=16,
                max_res=64, grid_size=32)


def test_trunc_exp_clamps_its_gradient_like_jax():
    x = np.array([-30.0, -15.5, -1.0, 0.0, 2.0, 14.0, 20.0], np.float32)
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    y = common.trunc_exp(t)
    y.backward(torch.ones_like(y))
    gj = jax.grad(lambda v: jnp.sum(jcommon.trunc_exp(v)))(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.exp(x), rtol=1e-6)
    # float32 exp on two backends: a few ulps
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), rtol=2e-6)
    # inputs beyond +-15 get the gradient at +-15
    np.testing.assert_allclose(t.grad[[0, -1]].numpy(), np.exp([-15.0, 15.0]),
                               rtol=1e-6)


def test_calc_dt_and_mip_match_jax():
    rng = np.random.default_rng(0)
    t = rng.uniform(0.0, 3.0, 64).astype(np.float32)
    for esf in (0.0, 1 / 256):
        np.testing.assert_array_equal(
            common.calc_dt(torch.from_numpy(t), esf, 128, 1.0).numpy(),
            np.asarray(jcommon.calc_dt(jnp.asarray(t), esf, 128, 1.0)),
        )
    mx = np.concatenate([[0.0, 0.25, 0.5, 1.0, 2.0], rng.uniform(0, 4, 64)])
    mx = mx.astype(np.float32)
    for cascades in (1, 4):
        np.testing.assert_array_equal(
            common.mip_from_absmax(torch.from_numpy(mx), cascades).numpy(),
            np.asarray(jcommon.mip_from_absmax(jnp.asarray(mx), cascades)),
        )
        np.testing.assert_array_equal(
            common.mip_from_dt(torch.from_numpy(mx / 64), 128, cascades).numpy(),
            np.asarray(jcommon.mip_from_dt(jnp.asarray(mx / 64), 128, cascades)),
        )


def test_sh_encode_matches_jax():
    d = np.random.default_rng(1).random((50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        sh_encode(torch.from_numpy(d)).numpy(), np.asarray(j_sh_encode(d)),
        rtol=1e-6, atol=1e-6,
    )


def _models(seed=0):
    jm = JModel(scale=0.5, hash_variant="additive", **MODEL_KW)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = NGPModel(scale=0.5, **MODEL_KW)
    tm.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    )
    return jm, params, tm


def test_model_forward_matches_jax():
    jm, params, tm = _models()
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    d = rng.standard_normal((200, 3)).astype(np.float32)
    sj, cj = jax.jit(jm.forward)(params, jnp.asarray(x), jnp.asarray(d))
    st, ct = tm(torch.from_numpy(x), torch.from_numpy(d))
    # float32 matmuls and exp in another order
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), rtol=1e-5)
    np.testing.assert_allclose(ct.detach().numpy(), np.asarray(cj),
                               rtol=0, atol=1e-6)


def _render_inputs(seed=3, n=64):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    occ = rng.random((1, 32**3)) < 0.5
    return o, d, occ


@pytest.mark.parametrize("budget", [None, 64 * 6])
def test_render_rays_matches_jax(budget):
    jm, params, tm = _models(seed=1)
    o, d, occ = _render_inputs()
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.uniform(key, (o.shape[0],)))
    kw = dict(exp_step_factor=0.0, max_samples=32, n_candidates=256,
              march_resolution=256, sample_budget=budget)
    rj = jax.jit(lambda *a: j_render_rays(jm, *a, **kw))(
        params, jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d), key)
    rt = render_rays(tm, torch.from_numpy(occ), torch.from_numpy(o),
                     torch.from_numpy(d), torch.from_numpy(noise), **kw)
    for k in ("rm_samples", "vr_samples", "overflow"):
        assert int(rt[k]) == int(rj[k]), k
    if budget is not None:
        assert int(rj["overflow"]) > 0  # the proportional subsample ran
    np.testing.assert_array_equal(rt["valid"].numpy(), np.asarray(rj["valid"]))
    # float32 model and compositing in another op order
    for k in ("opacity", "depth", "rgb"):
        np.testing.assert_allclose(rt[k].detach().numpy(), np.asarray(rj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_compute_loss_matches_jax():
    rng = np.random.default_rng(4)
    n = 96
    depth = (rng.random(n) + 0.2).astype(np.float32)
    meas = {s: (rng.random(n) + 0.2).astype(np.float32) for s in ("USS", "ToF", "RGBD")}
    for v in meas.values():
        v[rng.random(n) < 0.3] = np.nan
    rgb = rng.random((n, 3)).astype(np.float32)
    target = rng.random((n, 3)).astype(np.float32)
    sensors = ("RGBD", "ToF", "USS")
    jb = Batch(*([None] * 4), rgb=jnp.asarray(target),
               depths={k: jnp.asarray(v) for k, v in meas.items()}, times=None)
    tb = jb._replace(rgb=torch.from_numpy(target),
                     depths={k: torch.from_numpy(v) for k, v in meas.items()})
    total_j, dj = j_compute_loss({"rgb": jnp.asarray(rgb), "depth": jnp.asarray(depth)},
                                 jb, JWeights(uss_depth_tol=0.05), sensors)
    total_t, dt = compute_loss({"rgb": torch.from_numpy(rgb),
                                "depth": torch.from_numpy(depth)},
                               tb, LossWeights(uss_depth_tol=0.05), sensors)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-5)
    assert set(dt) == set(dj) - {"distortion"}
    for k in dt:
        np.testing.assert_allclose(float(dt[k]), float(dj[k]), rtol=1e-5, err_msg=k)
    assert float(dt["USS"]) > 0  # the hinge is active for some pixels


def test_grid_sensor_model_and_cells_match_jax():
    hp_kw = dict(grid_size=32, scale=0.5, false_detection_prob_every_m=0.1,
                 std_every_m=0.07, nerf_pos_noise_every_m=0.07)
    jhp, thp = jog.OccGridHParams(**hp_kw), tog.OccGridHParams(**hp_kw)
    assert jhp.grid_decay == thp.grid_decay
    o, d, _ = _render_inputs(seed=5, n=48)
    noise = np.random.default_rng(6).uniform(-1, 1, (48, 32, 3)).astype(np.float32)
    dj, pj, ij = jax.jit(lambda a, b, c: jog._cell_positions(a, b, jhp, c))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(noise))
    dt, pt, it = tog._cell_positions(torch.from_numpy(o), torch.from_numpy(d),
                                     thp, torch.from_numpy(noise))
    # the cell of each sample is exact; distances and positions to float32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    meas = np.random.default_rng(7).uniform(0.05, 0.8, 48).astype(np.float32)
    po_j, pe_j = jog.ray_measurement_probs(jnp.asarray(meas), dj, jhp)
    po_t, pe_t = tog.ray_measurement_probs(torch.from_numpy(meas), dt, thp)
    # float32 survival integral summed in another order
    np.testing.assert_allclose(po_t.numpy(), np.asarray(po_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=1e-6)
    dens = np.random.default_rng(8).lognormal(0, 2, 500).astype(np.float32)
    for a, b in zip(tog.nerf_density_probs(torch.from_numpy(dens), thp),
                    jog.nerf_density_probs(jnp.asarray(dens), jhp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_sample_batch_draws_valid_pixels():
    ds, _, _ = make_synthetic_dataset(n_images=3, img_wh=(32, 24), n_gt_points=100,
                                      device="cpu")
    g = torch.Generator().manual_seed(0)
    b = sample_batch(ds, g, 100, {"imgs": "same",
                                  "pixs": {"valid_uss": 0.4, "valid_tof": 0.3}})
    assert b.rays_o.shape == (100, 3) and b.rgb.shape == (100, 3)
    assert torch.all(b.img_idxs == b.img_idxs[0])
    uss = set(ds.uss_mask_idx.tolist())
    tof = set(ds.tof_mask_idx.tolist())
    assert all(p in uss for p in b.pix_idxs[:40].tolist())
    assert all(p in tof for p in b.pix_idxs[40:70].tolist())
    assert not torch.isnan(b.depths["USS"][:40]).any()
    np.testing.assert_allclose(b.rays_d.norm(dim=1).numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError):
        sample_batch(ds, g, 10, {"pixs": "closest"})
