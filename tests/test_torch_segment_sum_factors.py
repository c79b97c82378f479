"""Parity of the port's fused factor-stream segment sum
(virus_nerf_tpu_torch/ops/segment_sum.py: ``group_segment_sum_tsf_sorted``,
whose CPU path is the plain version) with the JAX function of that name
(its CPU fallback) and with a float64 sum, in float32 and bf16 factors, on
uniform, skewed, single-row and padded-row keys; and of the F-major fold
``_fold_wide_t_fmajor`` with the JAX one.  The CUDA kernel is compared with
the plain version on the card in test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from virus_nerf_tpu.ops import hash_encoder as jhe
from virus_nerf_tpu.ops import segment_sum_pallas as jss
from virus_nerf_tpu_torch.ops import hash_encoder as the
from virus_nerf_tpu_torch.ops import segment_sum as tss

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
CASES = ["uniform", "skewed", "single_row", "padded_rows"]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _case(name, G, F):
    """(factors (G, 8 + F, K) float32, keys (G, K) sorted int32, n_rows):
    trilinear weights in [0, 1), N(0, 1) gradient features."""
    rng = np.random.default_rng(7 + CASES.index(name))
    K, R = 2000, 700
    if name == "uniform":
        sk = rng.integers(0, R, (G, K))
    elif name == "skewed":
        # a dense level's shape: a few rows take most samples
        hot = rng.integers(0, R, 3)
        sk = np.where(rng.random((G, K)) < 0.8, hot[rng.integers(0, 3, (G, K))],
                      rng.integers(0, R, (G, K)))
    elif name == "single_row":
        sk = np.full((G, K), 123)
    else:
        # keys in the lower part of a dense-level size: trailing rows empty
        R = 4920
        sk = rng.integers(0, 4096, (G, K))
    sk = np.sort(sk, axis=1).astype(np.int32)
    w = rng.random((G, 8, K))
    g = rng.standard_normal((G, F, K))
    return np.concatenate([w, g], axis=1).astype(np.float32), sk, R


def _oracle(wgt, sk, R, F):
    """float64 sums (G, 8F, R) of the products as the factor dtype rounds
    them, and the per-row float32 tolerance 4 * eps32 * sqrt(n) * sum|v|
    over the row's n samples (chip_smoke.py's)."""
    V = tss.factor_products(wgt, F).double().numpy()  # (G, 8F, K)
    G, VF, _ = V.shape
    out = np.zeros((G, R, VF))
    mag = np.zeros((G, R, VF))
    cnt = np.zeros((G, R))
    for i in range(G):
        np.add.at(out[i], sk[i], V[i].T)
        np.add.at(mag[i], sk[i], np.abs(V[i].T))
        np.add.at(cnt[i], sk[i], 1.0)
    tol = 4.0 * EPS32 * np.sqrt(cnt)[:, :, None] * mag
    return out.transpose(0, 2, 1), tol.transpose(0, 2, 1), V


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G", [1, 10])
@pytest.mark.parametrize("name", CASES)
def test_matches_float64_and_jax(name, G, dtype):
    F = 2
    npdt, tdt = DTYPES[dtype]
    wgt32, sk, R = _case(name, G, F)
    wgt = torch.from_numpy(wgt32).to(tdt)
    got = tss.group_segment_sum_tsf_sorted(wgt, torch.from_numpy(sk), R, F).numpy()
    assert got.dtype == np.float32 and got.shape == (G, 8 * F, R)
    exact, tol, V = _oracle(wgt, sk, R, F)
    # the plain version sums each row directly: within the per-row bound
    assert np.all(np.abs(got - exact) <= tol), np.max(np.abs(got - exact) - tol)
    # rows no key hits are exactly zero
    hit = np.zeros((G, R), bool)
    for i in range(G):
        hit[i, sk[i]] = True
    assert np.all(got.transpose(1, 0, 2)[:, ~hit] == 0.0)
    # the JAX fallback forms the same products in the same dtype (bf16 x
    # bf16 rounded to bf16) and differences float32 prefix sums over the
    # whole stream (segment_sum_pallas.py:524-539, 706-716): within 1e-5
    # relative, plus 4 * eps32 * max|prefix| for that cancellation
    want = np.asarray(jss.group_segment_sum_tsf_sorted(
        jnp.asarray(wgt32.astype(npdt)), jnp.asarray(sk), R, F))
    prefix = np.abs(np.cumsum(V, axis=2)).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=4.0 * EPS32 * prefix)
    assert np.abs(got).max() > 1.0  # the comparison is not vacuous


@pytest.mark.parametrize("F", [1, 4, 8])
def test_other_feature_counts_match_float64(F):
    wgt, sk, R = _case("skewed", 3, F)
    got = tss.group_segment_sum_tsf_sorted(
        torch.from_numpy(wgt), torch.from_numpy(sk), R, F
    ).numpy()
    exact, tol, _ = _oracle(torch.from_numpy(wgt), sk, R, F)
    assert np.all(np.abs(got - exact) <= tol)


def test_rows_are_feature_major():
    # row f*8 + c holds sum w[c] * g[f] (the TPU kernel's order)
    wgt = torch.zeros((1, 12, 3))
    wgt[0, :8, :] = torch.arange(8.0)[:, None] + 1.0  # w[c] = c + 1
    wgt[0, 8:, :] = torch.tensor([1.0, 10.0, 100.0, 1000.0])[:, None]
    out = tss.group_segment_sum_tsf_sorted(
        wgt, torch.tensor([[0, 0, 2]], dtype=torch.int32), 3, 4)
    want = torch.tensor([(c + 1.0) * 10.0**f for f in range(4) for c in range(8)])
    assert torch.equal(out[0, :, 0], 2 * want)
    assert torch.equal(out[0, :, 1], torch.zeros(32))
    assert torch.equal(out[0, :, 2], want)


def test_cpu_tensor_takes_plain_version_without_counting():
    wgt, sk, R = _case("uniform", 2, 2)
    before = tss.group_segment_sum_tsf_sorted.launches
    a = tss.group_segment_sum_tsf_sorted(torch.from_numpy(wgt), torch.from_numpy(sk), R, 2)
    b = tss.group_segment_sum_tsf_sorted_plain(
        torch.from_numpy(wgt), torch.from_numpy(sk), R, 2)
    assert torch.equal(a, b)
    assert tss.group_segment_sum_tsf_sorted.launches == before


@pytest.mark.parametrize(
    "wgt, keys, err",
    [
        (torch.zeros(1, 10, 8, dtype=torch.float64),
         torch.zeros(1, 8, dtype=torch.int32), TypeError),
        (torch.zeros(1, 10, 8), torch.zeros(1, 8, dtype=torch.int64), TypeError),
        (torch.zeros(1, 12, 8), torch.zeros(1, 8, dtype=torch.int32), ValueError),
        (torch.zeros(2, 10, 8), torch.zeros(1, 8, dtype=torch.int32), ValueError),
    ],
)
def test_wrapper_rejects_bad_arguments(wgt, keys, err):
    with pytest.raises(err):
        tss.group_segment_sum_tsf_sorted(wgt, keys, 16, 2)


@pytest.mark.parametrize("F", [1, 2, 4])
def test_fold_fmajor_matches_jax_exactly(F):
    rng = np.random.default_rng(F)
    s, sy, sz = 1000, 37, 611
    dt = rng.standard_normal((3, 8 * F, s)).astype(np.float32)
    want = np.asarray(jhe._fold_wide_t_fmajor(jnp.asarray(dt), sy, sz, s, F))
    got = the._fold_wide_t_fmajor(torch.from_numpy(dt), sy, sz, s, F).numpy()
    assert got.shape == (3, F, s)
    np.testing.assert_array_equal(got, want)
