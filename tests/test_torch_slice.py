"""The port's training slice against the JAX trainer's pieces.

Both sides start from the same parameters and grid (``convert.py``) and
see the same random draws: the test draws every batch and noise with the
JAX functions and the JAX key splits of ``Trainer._make_train_body`` /
``_make_occ_body`` (trainer.py:249, 373), runs the JAX bodies, and hands
the same draws to the port's ``grid_update_on`` / ``train_step_on``.
Small sizes throughout (8 x 4 hash levels of 2^12 rows, 32^3 grid, 128
rays); the XOR cases run the reference's 16 x 2 layout at 2^12 rows.  The
JAX trainer always takes the slab forward and its CPU backward, so the
port's routes (``slabs``/``factors``) are held against the same JAX run as
its defaults; the ``mixed`` case runs both sides in that compute mode."""

import copy
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.configs.config import Config
from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset
from virus_nerf_tpu.data.dataset import sample_batch as j_sample_batch
from virus_nerf_tpu.models.renderer import render_rays as j_render_rays
from virus_nerf_tpu.training import Trainer as JTrainer
from virus_nerf_tpu.training.loss import compute_loss as j_compute_loss
from virus_nerf_tpu_torch.convert import (
    adam_state_from_jax,
    grid_from_jax,
    params_from_jax,
)
from virus_nerf_tpu_torch.data.dataset import Batch
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_KW = dict(n_images=4, img_wh=(32, 24), n_gt_points=2000)


def small_config(hash_variant: str = "additive", dtype: str = "float32") -> Config:
    cfg = Config()
    m = cfg.model
    m.hash_variant = hash_variant
    m.dtype = dtype
    m.hash_levels, m.hash_features_per_level = 8, 4
    if hash_variant == "xor":
        m.hash_levels, m.hash_features_per_level = 16, 2
    m.hash_log2_T, m.hash_max_res, m.grid_size = 12, 64, 32
    t = cfg.training
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 256
    t.sample_budget = 128 * 12  # below the dense count: proportional subsample
    t.sampling_strategy = {"imgs": "all",
                           "pixs": {"valid_uss": 0.4, "valid_tof": 0.4}}
    t.sensors = ["USS", "ToF"]
    cfg.occ_grid.batch_size, cfg.occ_grid.update_interval = 64, 4
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_batch(b) -> Batch:
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Batch(
        img_idxs=t(b.img_idxs).long(), pix_idxs=t(b.pix_idxs).long(),
        rays_o=t(b.rays_o), rays_d=t(b.rays_d), rgb=t(b.rgb),
        depths={k: t(v) for k, v in b.depths.items()}, times=t(b.times),
    )


class Pair:
    """The JAX trainer and the port's trainer on the same config/data."""

    def __init__(self, hash_variant: str = "additive", dtype: str = "float32"):
        self.cfg = small_config(hash_variant, dtype)
        self.jds, jscene, _ = j_make_dataset(**DATA_KW)
        self.pds, self.pscene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
        self.jt = JTrainer(self.cfg, self.jds, scene=jscene)
        self.pt = Trainer(self.cfg, self.pds, scene=self.pscene, device="cpu")
        self.train_body = jax.jit(self.jt._make_train_body())
        self.occ_body = jax.jit(self.jt._make_occ_body())
        self.et = jnp.float32(0.0)

    def start(self, seed=0):
        """JAX state and a port state holding the same numbers."""
        js = self.jt.init_state(seed)
        ps = self.pt.init_state(seed)
        ps.model.load_state_dict(params_from_jax(_np(js.params), device="cpu"))
        count, mu, nu = adam_state_from_jax(_np(js.opt_state), device="cpu")
        ps.optimizer.load_moments(ps.model.named_parameters(), count, mu, nu)
        ps.grid = grid_from_jax(_np(js.grid), device="cpu")
        return js, ps

    def occ_draws(self, js):
        """The draws of occ_update (trainer.py:373-385) and of
        occ_grid_delta's position noise (occupancy_grid.py:219-224)."""
        _, k1, k2, k3 = jax.random.split(js.key, 4)
        ray_b = j_sample_batch(self.jds, k1, 32, {"imgs": "all", "pixs": "valid_tof"})
        nerf_b = j_sample_batch(self.jds, k2, 32, {"imgs": "all", "pixs": "valid_uss"})
        _, k_noise = jax.random.split(k3)
        noise = jax.random.uniform(k_noise, (32, 32, 3), jnp.float32) * 2.0 - 1.0
        return (_port_batch(ray_b), _port_batch(nerf_b),
                torch.from_numpy(np.array(noise)))

    def train_draws(self, js):
        """The draws of train_step (trainer.py:249-260, renderer.py:58)."""
        _, k_batch, k_render = jax.random.split(js.key, 3)
        t = self.cfg.training
        batch = j_sample_batch(self.jds, k_batch, t.batch_size, t.sampling_strategy)
        noise = jax.random.uniform(k_render, (t.batch_size,))
        return batch, k_render, torch.from_numpy(np.array(noise))


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def xor_pair():
    return Pair("xor")


@pytest.fixture(scope="module")
def routes_pair(pair):
    """The additive pair with the port on the slabs forward and the bf16
    factors backward (the JAX side, and its compiled bodies, are shared)."""
    p = copy.copy(pair)
    p.pt = Trainer(p.cfg, p.pds, scene=p.pscene, device="cpu",
                   hash_forward="slabs", hash_backward="factors")
    return p


def test_same_dataset(pair):
    for name in ("poses", "directions", "rgbs", "uss_mask_idx", "tof_mask_idx"):
        np.testing.assert_array_equal(
            getattr(pair.pds, name).numpy(), np.asarray(getattr(pair.jds, name))
        )
    for k, v in pair.jds.depths.items():
        np.testing.assert_array_equal(pair.pds.depths[k].numpy(), np.asarray(v))


def test_grid_update_then_train_step_match_jax(pair):
    check_grid_update_then_train_step(pair)


def test_xor_grid_update_then_train_step_match_jax(xor_pair):
    check_grid_update_then_train_step(xor_pair)


def test_mixed_grid_update_then_train_step_match_jax():
    # both sides in the mixed mode: the same bf16 roundings of the table
    # and the MLP products; the table gradient comes back bf16-rounded on
    # both sides, so it is held to one bf16 ulp of its largest entry
    # (2^-7 relative; measured 5e-4), the MLP gradients matched exactly
    check_grid_update_then_train_step(Pair(dtype="mixed"), grad_rtol=2**-7)


def check_grid_update_then_train_step(pair, grad_rtol=2e-4):
    js, ps = pair.start()
    # ---- grid update at step 0, before the step (trainer.py:484-510)
    ray_b, nerf_b, noise = pair.occ_draws(js)
    js = pair.occ_body(js, pair.jds, pair.et)
    pair.pt.grid_update_on(ps, ray_b, nerf_b, noise)
    jg = _np(js.grid)
    # log-odds evidence summed in another order (index_add_ vs XLA's
    # scatter-add) through a sigmoid: float32 rounding of probabilities
    np.testing.assert_allclose(ps.grid.occ_3d_grid.numpy(), jg.occ_3d_grid,
                               rtol=0, atol=1e-5)
    away = np.abs(jg.occ_3d_grid.reshape(1, -1) - 0.5) > 1e-5
    np.testing.assert_array_equal(ps.grid.occ_bool.numpy()[away], jg.occ_bool[away])
    assert ps.grid.update_step == int(jg.update_step) == 1
    assert 0 < jg.occ_bool.mean() < 1  # the update moved cells both ways
    # the step below marches both sides on the SAME boolean grid
    ps.grid = grid_from_jax(jg, device="cpu")

    # ---- one train step
    batch, k_render, noise = pair.train_draws(js)
    params0 = js.params
    jm = pair.jt.model
    t = pair.cfg.training

    def loss_fn(params):
        res = j_render_rays(
            jm, params, js.grid.occ_bool, batch.rays_o, batch.rays_d, k_render,
            exp_step_factor=0.0, max_samples=t.max_samples_per_ray,
            n_candidates=t.march_candidates, sample_budget=t.sample_budget,
            march_resolution=t.march_resolution,
        )
        loss, _ = j_compute_loss(res, batch, pair.jt.loss_weights, tuple(t.sensors))
        return loss, res

    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params0)
    js, metrics_j = pair.train_body(js, pair.jds, pair.et)
    metrics = pair.pt.train_step_on(ps, _port_batch(batch), noise)

    # the march is exact, so the sample counters agree exactly
    for k in ("rm_samples", "vr_samples", "overflow"):
        assert int(metrics[k]) == int(metrics_j[k]), k
    assert int(metrics_j["overflow"]) > 0  # the proportional subsample ran
    # float32 rendering and loss in another op order
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float(metrics_j["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["psnr"]), float(metrics_j["psnr"]),
                               rtol=1e-5)

    # gradients: the table's differ by the JAX CPU backward's prefix-sum
    # cancellation (eps32 * |prefix| over a level's samples); the MLP
    # weights' by float32 op order
    gj = params_from_jax(_np(grads_j), device="cpu")
    for name, p in ps.model.named_parameters():
        scale = float(np.abs(gj[name].numpy()).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), gj[name].numpy(), rtol=0,
                                   atol=grad_rtol * scale, err_msg=name)

    # updated params: step 1 of Adam with eps = 1e-15 moves every entry of
    # nonzero gradient by lr * sign(g); an entry whose gradient is ~0 may
    # take the other sign on the other side (2 * lr apart).  Allow that
    # for a tiny share of entries whose gradient is rounding noise (within
    # the gradient tolerance above), hold the rest to float32.  The XOR
    # table has more such entries: the JAX CPU backward differences prefix
    # sums over each level's 8N corner samples, which leaves ~1e-8 where
    # the exact gradient is 0 (0.28 % of its entries on this setup).
    pj = params_from_jax(_np(js.params), device="cpu")
    lr = t.lr
    max_share = 5e-3 if pair.cfg.model.hash_variant == "xor" else 2e-3
    for name, p in ps.model.named_parameters():
        diff = np.abs(p.detach().numpy() - pj[name].numpy())
        flipped = diff > 1e-6
        assert flipped.mean() < max_share, (name, flipped.mean())
        assert np.all(diff[flipped] <= 2 * lr * (1 + 1e-5)), name
        noise = grad_rtol * float(np.abs(gj[name].numpy()).max())
        assert np.all(np.abs(gj[name].numpy()[flipped]) <= noise), name
        if name == "pos_table":
            moved = np.abs(pj[name].numpy() - params0.pos_table) > 0
            assert moved.mean() > 0.01  # the kernel path's leaf was updated
    assert ps.optimizer.count == int(js.opt_state.count) == 1


def test_eight_steps_loss_per_step(pair):
    check_eight_steps_loss_per_step(pair)


def test_xor_eight_steps_loss_per_step(xor_pair):
    check_eight_steps_loss_per_step(xor_pair)


def test_slabs_factors_eight_steps_loss_per_step(routes_pair):
    # the slab forward gives the JAX features exactly; the bf16 factors move
    # each table-gradient entry by up to 3 * 2^-8 relative, which Adam's
    # normalised steps carry into the loss far less: measured <= 7.5e-6
    # relative over these 8 steps, held to the same 1e-4
    check_eight_steps_loss_per_step(routes_pair)


def check_eight_steps_loss_per_step(pair):
    js, ps = pair.start(seed=1)
    interval = pair.cfg.occ_grid.update_interval
    losses_j, losses_p = [], []
    for step in range(8):
        if step % interval == 0:
            draws = pair.occ_draws(js)
            js = pair.occ_body(js, pair.jds, pair.et)
            pair.pt.grid_update_on(ps, *draws)
        batch, _, noise = pair.train_draws(js)
        js, mj = pair.train_body(js, pair.jds, pair.et)
        mp = pair.pt.train_step_on(ps, _port_batch(batch), noise)
        losses_j.append(float(mj["loss"]))
        losses_p.append(float(mp["loss"]))
    assert ps.step == 8 and ps.grid.update_step == 2
    assert np.all(np.isfinite(losses_p))
    # the two runs drift apart only through float32 rounding (Adam sign
    # flips of near-zero gradients, grid cells within rounding of the 0.5
    # threshold); measured <= 1e-5 relative over 16 steps on this setup
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    assert np.mean(losses_p[-2:]) < np.mean(losses_p[:2])


def test_port_runs_without_jax():
    # the defaults, then the JAX package's own layout in the mixed mode
    run_port_without_jax("additive", [
        ("float32", {}),
        ("mixed", {"hash_forward": "slabs", "hash_backward": "factors"}),
    ])


def test_xor_port_runs_without_jax():
    run_port_without_jax("xor")


def run_port_without_jax(hash_variant, runs=(("float32", {}),)):
    # the port's own loop (its own draws) in a fresh interpreter: 8 steps
    # per (compute mode, routes) run, finite losses, and neither jax nor any
    # module of the JAX package imported
    code = "\n".join([
        "import sys",
        "import torch",
        "from virus_nerf_tpu_torch.configs.config import Config",
        inspect.getsource(small_config),
        f"DATA_KW = {DATA_KW!r}",
        f"HASH_VARIANT = {hash_variant!r}",
        f"RUNS = {list(runs)!r}",
        """
torch.set_num_threads(1)
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.training.trainer import Trainer
ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
for dtype, routes in RUNS:
    cfg = small_config(HASH_VARIANT, dtype)
    cfg.training.max_steps = 8
    trainer = Trainer(cfg, ds, scene=scene, device="cpu", **routes)
    state = trainer.train()
    losses = trainer.logs["loss"]
    assert state.step == 8 and len(losses) == 8, (dtype, routes, losses)
    assert all(l == l for l in losses), (dtype, routes, losses)
# every module of the port imports without jax (the plots, analysis,
# deployment and logging modules too)
import importlib, pkgutil
import virus_nerf_tpu_torch
for mod in pkgutil.walk_packages(virus_nerf_tpu_torch.__path__,
                                 "virus_nerf_tpu_torch."):
    importlib.import_module(mod.name)
assert "virus_nerf_tpu_torch.analysis.uss_experiments" in sys.modules
assert "jax" not in sys.modules, "the port imported jax"
jax_pkg = [m for m in sys.modules
           if m == "virus_nerf_tpu" or m.startswith("virus_nerf_tpu.")]
assert not jax_pkg, f"the port imported the JAX package: {jax_pkg}"
print("OK", losses[0], losses[-1])
""",
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout
