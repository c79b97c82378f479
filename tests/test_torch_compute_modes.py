"""The port's ``mixed`` and ``bfloat16`` compute modes against the JAX
package: ``NGPModel(compute_dtype=...)`` against the JAX ``NGPModel`` with
the same mode and converted parameters (models/ngp.py:107-168), for the
additive and the XOR hash, 8 training steps of the XOR hash in each mode
against the JAX trainer's bodies on their draws (``test_torch_slice.py``'s
pair), and Adam on a bf16 parameter against ``fused_adam`` +
``optax.apply_updates`` (ops/fused_adam.py:133-142)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from virus_nerf_tpu.models.ngp import NGPModel as JNGPModel
from virus_nerf_tpu.ops.fused_adam import fused_adam
from virus_nerf_tpu_torch.convert import params_from_jax
from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.ops.fused_adam import FusedAdam

from test_torch_slice import Pair, _port_batch

torch.set_num_threads(1)

MODEL_KW = dict(levels=16, feature_per_level=2, log2_T=12, max_res=256)


def _models(mode, seed=0, hash_variant="additive"):
    jm = JNGPModel(compute_dtype=mode, hash_variant=hash_variant, **MODEL_KW)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = NGPModel(compute_dtype=mode, hash_variant=hash_variant, device="cpu",
                  **MODEL_KW)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       device="cpu"))
    return jm, params, tm


def _points(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return x, d


@pytest.mark.parametrize("mode", ["mixed", "bfloat16"])
def test_model_forward_matches_jax(mode):
    check_model_forward(mode, "additive")


@pytest.mark.parametrize("mode", ["mixed", "bfloat16"])
def test_xor_model_forward_matches_jax(mode):
    check_model_forward(mode, "xor")


def check_model_forward(mode, hash_variant):
    jm, params, tm = _models(mode, hash_variant=hash_variant)
    want_table = np.float32 if mode == "mixed" else ml_dtypes.bfloat16
    assert np.asarray(params.pos_table).dtype == want_table
    assert tm.pos_table.dtype == (torch.float32 if mode == "mixed"
                                  else torch.bfloat16)
    assert all(p.dtype == torch.float32 for n, p in tm.named_parameters()
               if n != "pos_table")  # MLP weights stay float32, as in JAX
    x, d = _points()
    sj, rj = jax.jit(jm.forward)(params, jnp.asarray(x), jnp.asarray(d))
    st, rt = tm(torch.from_numpy(x), torch.from_numpy(d))
    # the same bf16 roundings at the same places: a rounding that falls the
    # other way (a float32 sum in another order just before a bf16 cast)
    # moves an MLP output by one bf16 ulp, 2^-7 of it at most, which
    # trunc_exp turns into at most ~2^-7 * |h| relative in sigma; measured
    # 1e-7 in sigma and exact rgb on this setup
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), rtol=2**-5)
    np.testing.assert_allclose(rt.detach().numpy(), np.asarray(rj), rtol=0,
                               atol=2**-8)
    # and the mode is not float32: bf16 products move the outputs
    _, _, t32 = _models("float32", hash_variant=hash_variant)
    s32, _ = t32(torch.from_numpy(x), torch.from_numpy(d))
    assert np.abs(st.detach().numpy() - s32.detach().numpy()).max() > 1e-4


@pytest.mark.parametrize("mode", ["mixed", "bfloat16"])
def test_table_gradient_is_bf16_valued(mode):
    check_table_gradient_is_bf16_valued(mode, "additive")


@pytest.mark.parametrize("mode", ["mixed", "bfloat16"])
def test_xor_table_gradient_is_bf16_valued(mode):
    check_table_gradient_is_bf16_valued(mode, "xor")


def check_table_gradient_is_bf16_valued(mode, hash_variant):
    # the encode runs on a bf16 table in both modes, so the table gradient
    # is bf16-rounded (in float32 storage in mixed mode), as in JAX
    _, _, tm = _models(mode, hash_variant=hash_variant)
    x, d = _points(256)
    sigma, rgb = tm(torch.from_numpy(x), torch.from_numpy(d))
    (sigma.sum() + rgb.sum()).backward()
    g = tm.pos_table.grad
    assert g.dtype == tm.pos_table.dtype
    assert torch.equal(g.float(), g.to(torch.bfloat16).float())
    assert g.abs().max() > 0


def _tree(rng):
    return {
        "table": rng.random((4096, 2)).astype(np.float32),
        "w0": rng.standard_normal((12, 8)).astype(np.float32),
    }


def test_bf16_parameter_adam_matches_optax():
    # three steps of fused Adam with a bf16 table leaf: float32 moments,
    # p = bf16(float32(p) + d) on both sides (optax.apply_updates casts the
    # float32 sum back to the leaf's dtype)
    rng = np.random.default_rng(5)
    params = _tree(rng)
    params["table"] = params["table"].astype(ml_dtypes.bfloat16)
    grads = [_tree(rng) for _ in range(3)]
    for g in grads:
        g["table"] = g["table"].astype(ml_dtypes.bfloat16)
    opt = fused_adam(5e-3, eps=1e-15)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    tparams = {
        "table": torch.nn.Parameter(
            torch.from_numpy(params["table"].astype(np.float32)).to(torch.bfloat16)),
        "w0": torch.nn.Parameter(torch.from_numpy(params["w0"].copy())),
    }
    topt = FusedAdam(list(tparams.values()), lr=5e-3, eps=1e-15)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state)
        jp = optax.apply_updates(jp, upd)
        tparams["table"].grad = torch.from_numpy(
            g["table"].astype(np.float32)).to(torch.bfloat16)
        tparams["w0"].grad = torch.from_numpy(g["w0"])
        topt.step()
    assert np.asarray(jp["table"]).dtype == ml_dtypes.bfloat16
    table = tparams["table"].detach()
    assert table.dtype == torch.bfloat16
    # float32 updates an ulp apart may round p to neighbouring bf16 values:
    # one bf16 ulp, 2^-7 relative at most; measured exact on this setup
    got = table.float().numpy()
    want = np.asarray(jp["table"]).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=0)
    moved = got != params["table"].astype(np.float32)
    assert moved.mean() > 0.5  # the bf16 leaf was updated
    st = topt.state[tparams["table"]]
    assert st["mu"].dtype == torch.float32
    np.testing.assert_allclose(st["mu"].numpy(), np.asarray(state.mu["table"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tparams["w0"].detach().numpy(),
                               np.asarray(jp["w0"]), rtol=0, atol=1e-6)


def test_bf16_leaf_converts_exactly():
    rng = np.random.default_rng(6)
    leaf = rng.standard_normal((64, 2)).astype(ml_dtypes.bfloat16)
    jm = JNGPModel(compute_dtype="bfloat16", **MODEL_KW)
    params = jm.init(jax.random.PRNGKey(1))._replace(pos_table=leaf)
    got = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    assert got["pos_table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["pos_table"].float().numpy(),
                                  leaf.astype(np.float32))


def test_xor_hash_refuses_other_modes():
    # the XOR hash runs in every compute mode but takes one route: the
    # slabs forward and the factors backward stay refused
    for routes in ({"hash_forward": "slabs"}, {"hash_backward": "factors"},
                   {"hash_forward": "slabs", "hash_backward": "factors"}):
        for mode in ("float32", "mixed", "bfloat16"):
            with pytest.raises(NotImplementedError, match="corners/product"):
                NGPModel(hash_variant="xor", compute_dtype=mode, device="cpu",
                         **routes, **MODEL_KW)
    for mode in ("mixed", "bfloat16"):
        NGPModel(hash_variant="xor", compute_dtype=mode, device="cpu", **MODEL_KW)
    with pytest.raises(ValueError):
        NGPModel(compute_dtype="float16", device="cpu", **MODEL_KW)


@pytest.fixture(scope="module", params=["mixed", "bfloat16"])
def xor_mode_pair(request):
    return Pair("xor", request.param)


def test_xor_eight_steps_in_the_mode_match_jax(xor_mode_pair):
    # both sides in the mode, from the same parameters and grid, on the JAX
    # bodies' draws: the same bf16 roundings of the table rows and the MLP
    # products; the table gradient comes back bf16-rounded on both sides
    pair = xor_mode_pair
    js, ps = pair.start(seed=1)
    want = torch.bfloat16 if pair.cfg.model.dtype == "bfloat16" else torch.float32
    assert ps.model.pos_table.dtype == want
    losses_j, losses_p, rm_j, rm_p = [], [], [], []
    for step in range(8):
        if step % pair.cfg.occ_grid.update_interval == 0:
            draws = pair.occ_draws(js)
            js = pair.occ_body(js, pair.jds, pair.et)
            pair.pt.grid_update_on(ps, *draws)
        batch, _, noise = pair.train_draws(js)
        js, mj = pair.train_body(js, pair.jds, pair.et)
        mp = pair.pt.train_step_on(ps, _port_batch(batch), noise)
        losses_j.append(float(mj["loss"]))
        losses_p.append(float(mp["loss"]))
        rm_j.append(int(mj["rm_samples"]))
        rm_p.append(int(mp["rm_samples"]))
    assert ps.step == 8 and ps.grid.update_step == 2
    assert ps.model.pos_table.dtype == want
    assert rm_p == rm_j  # the march is exact
    # a bf16 rounding that falls the other way (float32 sums in another
    # order just before a cast) moves an activation by 2^-8 relative, and
    # an Adam step of a bf16 table entry by a bf16 ulp: held to 1e-3
    # (chip_smoke.py's bf16 tolerance); measured 9.0e-8 at step 0 in both
    # modes, 8.7e-5 (mixed) and 7.5e-5 (bfloat16) at most over the 8 steps
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-3)
    np.testing.assert_allclose(losses_p[0], losses_j[0], rtol=1e-4)
    assert np.mean(losses_p[-2:]) < np.mean(losses_p[:2])
