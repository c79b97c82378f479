"""Parity of the port's additive hash encoder
(virus_nerf_tpu_torch/ops/hash_encoder.py) with the JAX ``hash_encode``:
base rows exactly, the forward and the table gradient (``jax.grad``, the
JAX package's CPU backward) within stated tolerances for every route
(``forward="corners"|"slabs"``, ``backward="product"|"factors"``) and for
float32 and bf16 tables, and the forward against the sequential numpy
oracle ``hash_encode_np``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_impl import hash_encode_np
from virus_nerf_tpu.ops import hash_encoder as jhe
from virus_nerf_tpu_torch.ops import hash_encoder as the

torch.set_num_threads(1)

# (levels, F, base_res, max_res, log2_T)
SPECS = {
    "8x4_small": (8, 4, 16, 64, 12),  # the bench layout at a small table
    "bf16_level": (4, 4, 16, 128, 17),  # hashed levels of 2^17 rows
    "16x2_small": (16, 2, 16, 256, 12),  # the reference JSONs' layout
}


def _specs(name):
    L, F, b, m, t = SPECS[name]
    kw = dict(levels=L, feat_dim=F, base_res=b, max_res=m, max_params=2**t)
    return jhe.HashGridSpec.create(**kw), the.HashGridSpec.create(**kw)


def _inputs(spec, n=384, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.random((spec.total_rows, spec.feat_dim)).astype(np.float32)
    # a few positions just outside [0, 1]: the grid update's noisy samples
    xyz = rng.uniform(-0.03, 1.03, (n, 3)).astype(np.float32)
    xyz[:8] = [0.0, 0.5, 1.0]  # lattice-aligned corners
    gout = rng.standard_normal((n, spec.out_dim)).astype(np.float32)
    return table, xyz, gout


def test_spec_matches_jax_spec():
    for name in SPECS:
        js, ts = _specs(name)
        for field in ("offsets", "sizes", "scales", "resolutions",
                      "begin_fast_hash_level", "total_rows", "stride_y",
                      "stride_z"):
            assert getattr(js, field) == getattr(ts, field), (name, field)
        np.testing.assert_array_equal(js.corner_offsets, ts.corner_offsets)
    assert the.bf16_rounded_levels(_specs("bf16_level")[1])
    assert not the.bf16_rounded_levels(_specs("8x4_small")[1])


@pytest.mark.parametrize("name", list(SPECS))
def test_base_rows_exact(name):
    js, ts = _specs(name)
    _, xyz, _ = _inputs(ts)
    rows_j, w_j = jax.jit(jhe.hash_base_rows, static_argnums=0)(
        js, jnp.asarray(xyz)
    )
    base, w = the.hash_base_rows(ts, torch.from_numpy(xyz))
    offsets = np.asarray(ts.offsets)[:, None]
    np.testing.assert_array_equal(base.numpy() + offsets, np.asarray(rows_j))
    # the same float32 weights up to the order of the 3-term product
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-6)


def _jax_fwd_grad(js, table, xyz, gout):
    def f(t):
        return jhe.hash_encode(t, jnp.asarray(xyz), js)

    out, vjp = jax.vjp(jax.jit(f), jnp.asarray(table))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(gout))[0])


@functools.cache
def _jax_ref(name):
    """(inputs, JAX forward, JAX table gradient) of a spec's default
    inputs, computed once per spec."""
    js, ts = _specs(name)
    table, xyz, gout = _inputs(ts)
    return (table, xyz, gout), _jax_fwd_grad(js, table, xyz, gout)


def _torch_fwd_grad(ts, table, xyz, gout, **routes):
    t = torch.from_numpy(table.copy()).requires_grad_(True)
    out = the.hash_encode(t, torch.from_numpy(xyz), ts, **routes)
    out.backward(torch.from_numpy(gout))
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("name", list(SPECS))
def test_forward_and_table_grad_match_jax(name):
    _, ts = _specs(name)
    (table, xyz, gout), (out_j, grad_j) = _jax_ref(name)
    out_t, grad_t = _torch_fwd_grad(ts, table, xyz, gout)
    # features in [0, 1), weights summing to 1: float32 combine in another
    # order (bf16-rounded corners on both sides for the 2^17-row levels)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=2e-6)
    # the JAX CPU backward differences float32 prefix sums over each
    # level's N sorted samples (|prefix| <~ N); the port sums each row
    # directly: eps32 * N * max|w g| bounds the gap
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=1e-4)
    assert np.abs(grad_t).max() > 0.1  # the comparison is not vacuous


@pytest.mark.parametrize("name", ["8x4_small", "16x2_small"])
def test_forward_matches_numpy_oracle(name):
    _, ts = _specs(name)
    table, xyz, _ = _inputs(ts, n=64, seed=1)
    xyz = np.clip(xyz, 0.0, 1.0)  # the oracle's uint64 floor needs x >= 0
    want = hash_encode_np(table, xyz, ts)
    got = the.hash_encode(torch.from_numpy(table), torch.from_numpy(xyz), ts)
    # float32 positions/weights against a float64 oracle
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_grad_matches_dense_autograd_reference():
    # the sort / segment-sum / fold backward equals the gradient autograd
    # takes through a plain gather of the 8 corner rows
    _, ts = _specs("8x4_small")
    table, xyz, gout = _inputs(ts, n=128, seed=2)
    _, grad = _torch_fwd_grad(ts, table, xyz, gout)
    t = torch.from_numpy(table.copy()).requires_grad_(True)
    base, w = the.hash_base_rows(ts, torch.from_numpy(xyz))
    co = torch.from_numpy(ts.corner_offsets)
    sizes = torch.tensor(ts.sizes)[:, None, None]
    offs = torch.tensor(ts.offsets)[:, None, None]
    idx = offs + (base[:, None, :] + co[:, :, None]) % sizes
    out = torch.einsum("lcnf,lcn->nlf", t[idx], w).reshape(len(xyz), -1)
    out.backward(torch.from_numpy(gout))
    np.testing.assert_allclose(grad, t.grad.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", list(SPECS))
def test_slabs_forward_matches_jax(name):
    # the JAX forward is the slab forward (hash_encoder.py:538-557): the
    # same features (bf16-rounded on the 2^17-row levels), combined in
    # float32 in another order
    _, ts = _specs(name)
    (table, xyz, gout), (out_j, grad_j) = _jax_ref(name)
    out_t, grad_t = _torch_fwd_grad(ts, table, xyz, gout, forward="slabs")
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(SPECS))
def test_factor_backward_float32_matches_jax(name):
    # float32 factors: the same products and sums as the product route;
    # the gap to the JAX CPU backward is its prefix-sum cancellation over
    # N = 384 samples (measured <= 1.4e-6 here)
    _, ts = _specs(name)
    (table, xyz, gout), (_, grad_j) = _jax_ref(name)
    base, w = the.hash_base_rows(ts, torch.from_numpy(xyz))
    grad_f = the._table_grad(ts, base, w, torch.from_numpy(gout), "factors",
                             factor_dtype=torch.float32)
    grad_p = the._table_grad(ts, base, w, torch.from_numpy(gout), "product")
    assert torch.equal(grad_f, grad_p)
    np.testing.assert_allclose(grad_f.numpy(), grad_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("forward", ["corners", "slabs"])
@pytest.mark.parametrize("name", list(SPECS))
def test_factor_backward_bf16_within_bf16_bound(name, forward):
    # the route's bf16 factors: w and g each rounded to bf16 and their
    # product rounded to bf16, each a relative error of at most 2^-8 (bf16
    # keeps 8 significant bits), so a table entry's gradient moves by at
    # most 3 * 2^-8 * sum|w g| over the (sample, corner) pairs that reach
    # it (to first order), plus the JAX side's 1e-5
    _, ts = _specs(name)
    (table, xyz, gout), (_, grad_j) = _jax_ref(name)
    _, grad_t = _torch_fwd_grad(ts, table, xyz, gout, forward=forward,
                                backward="factors")
    base, w = the.hash_base_rows(ts, torch.from_numpy(xyz))
    mag = the._table_grad(ts, base, w, torch.from_numpy(np.abs(gout)),
                          "factors", factor_dtype=torch.float32).numpy()
    bound = 3.0 * 2.0**-8 * mag + 1e-5
    assert np.all(np.abs(grad_t - grad_j) <= bound), np.max(
        np.abs(grad_t - grad_j) - bound)
    assert np.abs(grad_t - grad_j).max() > 0  # the factors were rounded


@pytest.mark.parametrize("forward", ["corners", "slabs"])
@pytest.mark.parametrize("name", ["bf16_level", "16x2_small"])
def test_bf16_table_matches_jax(name, forward):
    # a bf16 table (the mixed/bfloat16 compute modes): every level's
    # features are the table's bf16 values, combined in float32; the
    # gradient comes back in bf16 on both sides, so entries may differ by
    # the bf16 rounding of float32 sums taken in another order (one bf16
    # ulp, 2^-7 relative)
    js, ts = _specs(name)
    table, xyz, gout = _inputs(ts)
    tb = jnp.asarray(table).astype(jnp.bfloat16)
    out_j, vjp = jax.vjp(
        jax.jit(lambda t: jhe.hash_encode(t, jnp.asarray(xyz), js)), tb)
    grad_j = np.asarray(vjp(jnp.asarray(gout))[0]).astype(np.float32)
    t = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    out = the.hash_encode(t, torch.from_numpy(xyz), ts, forward=forward)
    out.backward(torch.from_numpy(gout))
    assert out.dtype == torch.float32 and t.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.grad.float().numpy(), grad_j,
                               rtol=2.0**-7, atol=1e-4)


def test_unknown_route_is_refused():
    _, ts = _specs("8x4_small")
    table, xyz, _ = _inputs(ts, n=8)
    with pytest.raises(ValueError):
        the.hash_encode(torch.from_numpy(table), torch.from_numpy(xyz), ts,
                        forward="packed")
