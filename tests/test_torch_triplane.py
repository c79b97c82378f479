"""The port's tri-plane encoder against the JAX package: the spec, the
corners' cells (bit for bit) and the encode (``virus_nerf_tpu.ops.triplane``
under jit, as the JAX model calls it), its gradient against ``jax.grad``,
``NGPModel(pos_encoder_type="triplane")`` against the JAX model from
converted parameters, a JAX checkpoint through ``convert``, and 8 training
steps against the JAX trainer's bodies on the JAX draws (as
``test_torch_slice.py``).  Small: planes of 64^2 cells (8 levels x F = 4),
a 32^3 grid, 128 rays."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset
from virus_nerf_tpu.models.ngp import NGPModel as JNGPModel
from virus_nerf_tpu.ops import triplane as jtri
from virus_nerf_tpu.training import Trainer as JTrainer
from virus_nerf_tpu_torch.convert import params_from_jax, state_from_jax_checkpoint
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.ops import triplane as ttri
from virus_nerf_tpu_torch.training.trainer import Trainer

from test_torch_slice import DATA_KW, Pair, _np, _port_batch, small_config

torch.set_num_threads(1)

MAX_RES = 64


def _points(n=4096, seed=0, outside=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0.25],
             [0.999999, 1e-7, 0.5], [0.25, 0.75, 1.0]]
    if outside:
        # the grid update's jittered cells reach a little past the cube
        x[6:262] = rng.uniform(-0.15, 1.15, (256, 3)).astype(np.float32)
    return x


@jax.jit
def _jax_cells(xyz):
    """Lines 84-100 of virus_nerf_tpu/ops/triplane.py, the corners' cells
    (the JAX function does not return them)."""
    spec = jtri.TriPlaneSpec.create(max_res=MAX_RES, feat_dim=4)
    mr = spec.max_res
    proj = jnp.stack([xyz[:, [0, 1]], xyz[:, [1, 2]], xyz[:, [2, 0]]],
                     axis=1).astype(jnp.float32)
    resolutions = jnp.asarray(spec.resolutions, jnp.float32)
    pos = proj[:, None] * (resolutions[None, :, None, None] - 1.0) + 0.5
    pg = jnp.floor(pos).astype(jnp.float32)
    corner = jnp.arange(4, dtype=jnp.int32)
    corner_off = jnp.stack([(corner >> d) & 1 for d in range(2)], -1)
    co = corner_off[None, None, None].astype(jnp.float32)
    local = pg[:, :, :, None, :] + co
    ori = (local / resolutions[None, :, None, None, None] * (mr - 1)).astype(
        jnp.int32)
    return ori[..., 0] + ori[..., 1] * mr


def _specs():
    return (jtri.TriPlaneSpec.create(max_res=MAX_RES, feat_dim=4),
            ttri.TriPlaneSpec.create(max_res=MAX_RES, feat_dim=4))


@pytest.mark.parametrize("max_res", [64, 1024, 2048])
def test_spec_matches_jax(max_res):
    js = jtri.TriPlaneSpec.create(max_res=max_res, feat_dim=4)
    ts = ttri.TriPlaneSpec.create(max_res=max_res, feat_dim=4)
    assert ts.resolutions == js.resolutions
    assert (ts.total_params, ts.out_dim, ts.log_b) == (
        js.total_params, js.out_dim, js.log_b)


def test_cells_match_jax_bit_for_bit():
    x = _points()
    cell, w = ttri.triplane_cells(torch.from_numpy(x), _specs()[1])
    np.testing.assert_array_equal(cell.numpy(), np.asarray(_jax_cells(x)))
    assert cell.shape == (x.shape[0], 8, 3, 4) and w.shape == cell.shape
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_encode_matches_jax():
    js, ts = _specs()
    x = _points()
    planes = np.random.default_rng(1).uniform(0, 1, js.total_params).astype(np.float32)
    want = jax.jit(jtri.triplane_encode, static_argnums=2)(
        jnp.asarray(planes), jnp.asarray(x), js)
    got = ttri.triplane_encode(torch.from_numpy(planes), torch.from_numpy(x), ts)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], 32)
    # measured 1.8e-7 apart
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_encode_gradient_matches_jax_grad():
    # the XLA gather's transpose drops a cell outside the planes (its
    # forward clamps it): the out-of-cube points of _points() check that
    js, ts = _specs()
    x = _points()
    rng = np.random.default_rng(2)
    planes = rng.uniform(0, 1, js.total_params).astype(np.float32)
    c = rng.standard_normal((x.shape[0], 32)).astype(np.float32)

    def f(p):
        return jnp.sum(jtri.triplane_encode(p, jnp.asarray(x), js) * c)

    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(planes)))
    p = torch.from_numpy(planes).requires_grad_(True)
    (ttri.triplane_encode(p, torch.from_numpy(x), ts) * torch.from_numpy(c)).sum().backward()
    got = p.grad.numpy()
    assert (want != 0).mean() > 0.05
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_init_planes_uniform_flat_and_in_the_mode_dtype():
    ts = _specs()[1]
    g = torch.Generator().manual_seed(3)
    u = ts.init_planes(generator=g)
    assert u.shape == (3 * MAX_RES**2 * 4,) and u.dtype == torch.float32
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    for mode, dtype in (("float32", torch.float32), ("mixed", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        m = NGPModel(pos_encoder_type="triplane", max_res=MAX_RES,
                     compute_dtype=mode, device="cpu")
        assert m.pos_table.dtype == dtype and m.pos_table.shape == u.shape
        assert m.xyz_net[0].weight.shape[1] == m.pos_out_dim == 32


@pytest.mark.parametrize("mode", ["float32", "mixed", "bfloat16"])
def test_model_matches_jax(mode):
    jm = JNGPModel(pos_encoder_type="triplane", max_res=MAX_RES, compute_dtype=mode)
    params = jm.init(jax.random.PRNGKey(0))
    want_dtype = ml_dtypes.bfloat16 if mode == "bfloat16" else np.float32
    assert np.asarray(params.pos_table).dtype == want_dtype
    tm = NGPModel(pos_encoder_type="triplane", max_res=MAX_RES,
                  compute_dtype=mode, device="cpu")
    tm.load_state_dict(params_from_jax(_np(params), device="cpu"))
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.5, 0.5, (2048, 3)).astype(np.float32)
    d = rng.standard_normal((2048, 3)).astype(np.float32)
    sj, rj = jax.jit(jm.forward)(params, jnp.asarray(x), jnp.asarray(d))
    st, rt = tm(torch.from_numpy(x), torch.from_numpy(d))
    if mode == "float32":
        np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), rtol=1e-5)
        np.testing.assert_allclose(rt.detach().numpy(), np.asarray(rj), rtol=0,
                                   atol=1e-6)
    else:
        # the tolerances of test_torch_compute_modes.py: a bf16 rounding
        # that falls the other way moves an MLP output by one bf16 ulp
        np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), rtol=2**-5)
        np.testing.assert_allclose(rt.detach().numpy(), np.asarray(rj), rtol=0,
                                   atol=2**-8)


class TriPair(Pair):
    """test_torch_slice's pair of trainers on the tri-plane encoder."""

    def __init__(self, dtype="float32"):
        self.cfg = small_config(dtype=dtype)
        self.cfg.model.encoder_type = "triplane"
        self.jds, jscene, _ = j_make_dataset(**DATA_KW)
        self.pds, self.pscene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
        self.jt = JTrainer(self.cfg, self.jds, scene=jscene)
        self.pt = Trainer(self.cfg, self.pds, scene=self.pscene, device="cpu")
        self.train_body = jax.jit(self.jt._make_train_body())
        self.occ_body = jax.jit(self.jt._make_occ_body())
        self.et = jnp.float32(0.0)


@pytest.fixture(scope="module")
def tri_pair():
    return TriPair()


def _sync_stepped_apart(ps, js, lr):
    from virus_nerf_tpu_torch.convert import adam_state_from_jax

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


def eight_steps(pair, sync=False):
    js, ps = pair.start(seed=1)
    assert ps.model.pos_table.shape == (3 * MAX_RES**2 * 4,)
    np.testing.assert_array_equal(ps.model.pos_table.detach().numpy(),
                                  np.asarray(js.params.pos_table))
    out = {"loss_j": [], "loss_p": [], "rm_j": [], "rm_p": [], "synced": []}
    for step in range(8):
        if step % pair.cfg.occ_grid.update_interval == 0:
            draws = pair.occ_draws(js)
            js = pair.occ_body(js, pair.jds, pair.et)
            pair.pt.grid_update_on(ps, *draws)
        batch, _, noise = pair.train_draws(js)
        js, mj = pair.train_body(js, pair.jds, pair.et)
        mp = pair.pt.train_step_on(ps, _port_batch(batch), noise)
        out["loss_j"].append(float(mj["loss"]))
        out["loss_p"].append(float(mp["loss"]))
        out["rm_j"].append(int(mj["rm_samples"]))
        out["rm_p"].append(int(mp["rm_samples"]))
        if sync:
            n, worst = _sync_stepped_apart(ps, js, pair.cfg.training.lr)
            assert worst <= 2.0 + 1e-3, (step, worst)
            out["synced"].append(n)
    assert ps.step == 8 and ps.grid.update_step == 2
    assert ps.optimizer.count == int(js.opt_state.count) == 8
    assert out["rm_p"] == out["rm_j"]  # the march is exact
    return out


def test_eight_steps_match_jax(tri_pair):
    # float32 in another op order on each side: measured 9.5e-8 relative at
    # most over the 8 steps.  The Adam-noise drift of the hash (ROADMAP C8:
    # an entry whose gradient is rounding noise of opposite sign on the two
    # sides steps 2 lr apart) does not show: the planes' gradient is one
    # scatter-add on both sides (the witness below counts such entries)
    out = eight_steps(tri_pair)
    np.testing.assert_allclose(out["loss_p"], out["loss_j"], rtol=1e-5)
    assert np.mean(out["loss_p"][-2:]) < np.mean(out["loss_p"][:2])


def test_eight_steps_step_no_entry_apart(tri_pair):
    # after each step no parameter or moment entry is more than 1e-6 from
    # the JAX one (measured: none at any step)
    out = eight_steps(tri_pair, sync=True)
    assert out["synced"] == [0] * 8
    np.testing.assert_allclose(out["loss_p"], out["loss_j"], rtol=1e-5)


def test_jax_checkpoint_carries_the_planes(tri_pair, tmp_path):
    js = tri_pair.jt.init_state(5)
    js, _ = tri_pair.train_body(js, tri_pair.jds, tri_pair.et)
    path = str(tmp_path / "model.npz")
    tri_pair.jt.save_checkpoint(js, path)
    ps = state_from_jax_checkpoint(path, tri_pair.pt)
    np.testing.assert_array_equal(ps.model.pos_table.detach().numpy(),
                                  np.asarray(js.params.pos_table))
    mu = ps.optimizer.state[ps.model.pos_table]["mu"].numpy()
    np.testing.assert_array_equal(mu, np.asarray(js.opt_state.mu.pos_table))
    assert ps.step == 1 and ps.optimizer.count == 1


def test_port_trainer_updates_the_planes_with_the_mlp(tri_pair):
    # the planes are one leaf of the fused Adam group, beside the MLP's
    ps = tri_pair.pt.init_state(0)
    before = [p.detach().clone() for p in ps.model.parameters()]
    ps.model.pos_table.grad = None
    tri_pair.pt.run_steps(ps, 2)
    leaves = ps.optimizer.param_groups[0]["params"]
    assert leaves[0] is ps.model.pos_table and len(leaves) == 6
    for b, p in zip(before, ps.model.parameters()):
        assert not torch.equal(b, p.detach())
