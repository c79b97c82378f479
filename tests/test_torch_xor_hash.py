"""Parity of the port's XOR hash encoder (virus_nerf_tpu_torch/ops/
hash_encoder.py: ``xor_corner_rows``, ``hash_encode_xor``) with the JAX
functions of the same names: corner rows exactly, weights, the forward and
the table gradient (``jax.grad``, the JAX package's CPU backward) within
stated tolerances, and the ``NGPModel`` of each variant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.models.ngp import NGPModel as JModel
from virus_nerf_tpu.ops import hash_encoder as jhe
from virus_nerf_tpu_torch.convert import params_from_jax
from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.ops import hash_encoder as the

torch.set_num_threads(1)

# (levels, F, base_res, max_res, log2_T)
SPECS = {
    "16x2_small": (16, 2, 16, 256, 12),  # the reference JSONs' layout
    "8x4_small": (8, 4, 16, 64, 12),  # the bench layout
    "16x2_dense_run": (16, 2, 16, 1024, 14),  # several single-size dense levels
}


def _specs(name):
    L, F, b, m, t = SPECS[name]
    kw = dict(levels=L, feat_dim=F, base_res=b, max_res=m, max_params=2**t)
    return jhe.HashGridSpec.create(**kw), the.HashGridSpec.create(**kw)


def _inputs(spec, n=384, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.random((spec.total_rows, spec.feat_dim)).astype(np.float32)
    # a few positions just outside [0, 1]: the grid update's noisy samples
    # (negative cells saturate to 0 as the uint32 cast does)
    xyz = rng.uniform(-0.03, 1.03, (n, 3)).astype(np.float32)
    xyz[:8] = [0.0, 0.5, 1.0]  # lattice-aligned corners
    gout = rng.standard_normal((n, spec.out_dim)).astype(np.float32)
    return table, xyz, gout


@pytest.mark.parametrize("name", list(SPECS))
def test_corner_rows_exact(name):
    js, ts = _specs(name)
    _, xyz, _ = _inputs(ts)
    rows_j, w_j = jax.jit(jhe.xor_corner_rows, static_argnums=0)(
        js, jnp.asarray(xyz)
    )
    rows, w = the.xor_corner_rows(ts, torch.from_numpy(xyz))
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (ts.levels, 8, 384)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_j))
    # the same float32 product of three factors
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-6)
    # the hashed levels really take the XOR branch
    assert ts.begin_fast_hash_level < ts.levels


@pytest.mark.parametrize("name", list(SPECS))
def test_forward_and_table_grad_match_jax(name):
    js, ts = _specs(name)
    table, xyz, gout = _inputs(ts)

    def f(t):
        return jhe.hash_encode_xor(t, jnp.asarray(xyz), js)

    out_j, vjp = jax.vjp(jax.jit(f), jnp.asarray(table))
    grad_j = np.asarray(vjp(jnp.asarray(gout))[0])
    t = torch.from_numpy(table.copy()).requires_grad_(True)
    out = the.hash_encode_xor(t, torch.from_numpy(xyz), ts)
    out.backward(torch.from_numpy(gout))
    # features in [0, 1), weights summing to 1, gathered in float32 on both
    # sides: the 8-term combine in another order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-6)
    # the JAX CPU backward differences float32 prefix sums over each
    # level's 8N sorted corner samples; the port sums each row directly:
    # eps32 * 8N * max|w g| bounds the gap
    np.testing.assert_allclose(t.grad.numpy(), grad_j, rtol=0, atol=1e-4)
    assert np.abs(grad_j).max() > 0.1  # the comparison is not vacuous


def test_grad_matches_dense_autograd_reference():
    # the sort / segment-sum backward equals the gradient autograd takes
    # through a plain gather of the 8 corner rows
    _, ts = _specs("16x2_dense_run")
    table, xyz, gout = _inputs(ts, n=128, seed=2)
    t = torch.from_numpy(table.copy()).requires_grad_(True)
    the.hash_encode_xor(t, torch.from_numpy(xyz), ts).backward(
        torch.from_numpy(gout)
    )
    ref = torch.from_numpy(table.copy()).requires_grad_(True)
    rows, w = the.xor_corner_rows(ts, torch.from_numpy(xyz))
    feats = ref[rows.long()]  # (L, 8, N, F)
    out = torch.einsum("lcnf,lcn->nlf", feats, w).reshape(len(xyz), -1)
    out.backward(torch.from_numpy(gout))
    # float32 sums of the same products in another order
    np.testing.assert_allclose(t.grad.numpy(), ref.grad.numpy(), rtol=0,
                               atol=2e-5)


def test_backward_streams_at_full_width():
    # the reference's 16 x 2 layout of 2^19 rows: the six dense levels merge
    # into one call, the ten hashed levels make one group of G = 10, so one
    # backward launches the segment-sum kernel twice
    spec = the.HashGridSpec.create(levels=16, feat_dim=2, base_res=16,
                                   max_res=1024, max_params=2**19)
    assert spec.sizes[:6] == (4096, 10648, 21952, 50656, 117656, 262144)
    assert spec.sizes[6:] == (524288,) * 10
    assert spec.total_rows == 5_710_032
    n = 16
    xyz = torch.from_numpy(np.random.default_rng(0).random((n, 3), np.float32))
    rows, w = the.xor_corner_rows(spec, xyz)
    g = torch.ones((n, spec.out_dim))
    shapes = [(tuple(sv.shape), tuple(sk.shape), n_rows)
              for sv, sk, n_rows in the.xor_table_grad_streams(spec, rows, w, g)]
    assert shapes == [((1, 6 * 8 * n, 2), (1, 6 * 8 * n), 467_152),
                      ((10, 8 * n, 2), (10, 8 * n), 524_288)]


@pytest.mark.parametrize("variant", ["additive", "xor"])
def test_model_density_and_color_match_jax(variant):
    kw = dict(levels=16, feature_per_level=2, log2_T=12, base_res=16,
              max_res=256, grid_size=32)
    jm = JModel(scale=0.5, hash_variant=variant, **kw)
    params = jm.init(jax.random.PRNGKey(3))
    tm = NGPModel(scale=0.5, hash_variant=variant, **kw)
    tm.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    )
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    sj, cj = jax.jit(jm.forward)(params, jnp.asarray(x), jnp.asarray(d))
    st, ct = tm(torch.from_numpy(x), torch.from_numpy(d))
    # float32 encoder and MLPs in another op order, through trunc_exp
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ct.detach().numpy(), np.asarray(cj), rtol=0,
                               atol=1e-6)


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError):
        NGPModel(hash_variant="triplane", levels=4, feature_per_level=2,
                 log2_T=10, max_res=64, device="cpu")
