"""Parity of the port's row-major segment sums (virus_nerf_tpu_torch/ops/
segment_sum.py: ``group_segment_sum_t_sorted``, ``group_segment_sum_t``,
``windowed_segment_sum``) with the JAX functions of the same names (their
CPU path) and with a float64 sum, on uniform, skewed, padded-row and
empty-row keys.  The CUDA kernel is compared with the plain version on the
card in test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.ops import segment_sum_pallas as jss
from virus_nerf_tpu_torch.ops import segment_sum as tss

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
CASES = ["uniform", "skewed", "padded_rows", "empty_rows"]
FUNCS = ["group_segment_sum_t_sorted", "group_segment_sum_t",
         "windowed_segment_sum"]


def _case(name, G, F=2):
    """(vals (G, K, F), keys (G, K) sorted, n_rows)."""
    rng = np.random.default_rng(3 + CASES.index(name))
    if name == "uniform":
        K, R = 3000, 1000
        sk = rng.integers(0, R, (G, K))
    elif name == "skewed":
        # the XOR stream's shape: a few rows take most samples
        K, R = 4096, 512
        hot = rng.integers(0, R, 4)
        sk = np.where(rng.random((G, K)) < 0.8, hot[rng.integers(0, 4, (G, K))],
                      rng.integers(0, R, (G, K)))
    elif name == "padded_rows":
        # a dense-level size (8-aligned res^3), keys in its lower part: the
        # trailing rows are hit by no key
        K, R = 1500, 4920
        sk = rng.integers(0, 4096, (G, K))
    else:
        # two bands of keys with an empty gap, and empty rows at both ends
        K, R = 2000, 3000
        sk = np.where(rng.random((G, K)) < 0.5, rng.integers(100, 400, (G, K)),
                      rng.integers(2000, 2100, (G, K)))
    sk = np.sort(sk, axis=1).astype(np.int32)
    sv = rng.standard_normal((G, K, F)).astype(np.float32)
    return sv, sk, R


def _oracle(sv, sk, R):
    """float64 sums (G, F, R) and the per-row float32 tolerance
    4 * eps32 * sqrt(n) * sum|v| over the row's n samples (chip_smoke.py's
    ``segment_tolerance``): rounding of a float32 sum in any order grows like
    a random walk over partial sums each at most sum|v|."""
    G, K, F = sv.shape
    out = np.zeros((G, R, F))
    mag = np.zeros((G, R, F))
    cnt = np.zeros((G, R))
    for g in range(G):
        np.add.at(out[g], sk[g], sv[g].astype(np.float64))
        np.add.at(mag[g], sk[g], np.abs(sv[g]).astype(np.float64))
        np.add.at(cnt[g], sk[g], 1.0)
    tol = 4.0 * EPS32 * np.sqrt(cnt)[:, :, None] * mag
    return out.transpose(0, 2, 1), tol.transpose(0, 2, 1)


def _port(func, sv, sk, R):
    if func == "windowed_segment_sum":
        return tss.windowed_segment_sum(
            torch.from_numpy(sv[0]), torch.from_numpy(sk[0]), R
        ).numpy().T[None]
    if func == "group_segment_sum_t":
        # the unsorted entry point sorts: hand it the stream shuffled
        perm = np.random.default_rng(0).permutation(sv.shape[1])
        return tss.group_segment_sum_t(
            torch.from_numpy(sv[:, perm]), torch.from_numpy(sk[:, perm]), R
        ).numpy()
    return tss.group_segment_sum_t_sorted(
        torch.from_numpy(sv), torch.from_numpy(sk), R
    ).numpy()


def _jax(func, sv, sk, R):
    if func == "windowed_segment_sum":
        return np.asarray(jss.windowed_segment_sum(
            jnp.asarray(sv[0]), jnp.asarray(sk[0]), R
        )).T[None]
    return np.asarray(getattr(jss, func)(jnp.asarray(sv), jnp.asarray(sk), R))


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("name", CASES)
def test_matches_float64_and_jax(name, func):
    G = 1 if func == "windowed_segment_sum" else 3
    sv, sk, R = _case(name, G)
    got = _port(func, sv, sk, R)
    assert got.dtype == np.float32 and got.shape == (G, sv.shape[2], R)
    exact, tol = _oracle(sv, sk, R)
    # the port sums each row directly: within the per-row bound
    assert np.all(np.abs(got - exact) <= tol), np.max(np.abs(got - exact) - tol)
    # rows no key hits are exactly zero
    hit = np.zeros((G, R), bool)
    for g in range(G):
        hit[g, sk[g]] = True
    assert np.all(got.transpose(1, 0, 2)[:, ~hit] == 0.0)
    # the JAX CPU path differences float32 prefix sums over the whole
    # stream (segment_sum_pallas.py:706-716), so its error follows the
    # prefix, not the row: the per-row bound plus 4 * eps32 * max|prefix|
    want = _jax(func, sv, sk, R)
    prefix = np.abs(np.cumsum(sv.astype(np.float64), axis=1)).max(axis=1)
    jax_tol = tol + 4.0 * EPS32 * prefix[:, :, None]
    assert np.all(np.abs(want - exact) <= jax_tol)
    assert np.abs(got).max() > 1.0  # the comparison is not vacuous


@pytest.mark.parametrize("F", [1, 4, 8])
def test_other_widths_match_float64(F):
    sv, sk, R = _case("skewed", 2, F=F)
    got = tss.group_segment_sum_t_sorted(
        torch.from_numpy(sv), torch.from_numpy(sk), R
    ).numpy()
    exact, tol = _oracle(sv, sk, R)
    assert np.all(np.abs(got - exact) <= tol)


def test_cpu_tensor_takes_plain_version_without_counting():
    sv, sk, R = _case("uniform", 2)
    before = tss.group_segment_sum_t_sorted.launches
    a = tss.group_segment_sum_t_sorted(torch.from_numpy(sv), torch.from_numpy(sk), R)
    b = tss.group_segment_sum_t_sorted_plain(
        torch.from_numpy(sv), torch.from_numpy(sk), R
    )
    assert torch.equal(a, b)
    assert tss.group_segment_sum_t_sorted.launches == before


@pytest.mark.parametrize("name", CASES)
def test_out_block_equals_the_returned_result(name):
    sv, sk, R = _case(name, 3)
    G, _, F = sv.shape
    want = tss.group_segment_sum_t_sorted(torch.from_numpy(sv), torch.from_numpy(sk), R)
    # the (G, F, R) result is the transposed view of (G, R, F) storage
    assert tuple(want.shape) == (G, F, R) and want.stride() == (R * F, 1, F)
    assert want.transpose(1, 2).is_contiguous()
    # out=: the block of a larger buffer is written, its neighbours are not
    buf = torch.full((G * R + 5, F), float("nan"))
    block = buf[2:2 + G * R].view(G, R, F)
    got = tss.group_segment_sum_t_sorted(torch.from_numpy(sv), torch.from_numpy(sk),
                                         R, out=block)
    assert got.data_ptr() == block.data_ptr() and got.stride() == want.stride()
    assert torch.equal(got, want)
    assert bool(buf[:2].isnan().all()) and bool(buf[2 + G * R:].isnan().all())


@pytest.mark.parametrize(
    "out",
    [torch.zeros(2, 16, 3), torch.zeros(2, 16, 2, dtype=torch.float64),
     torch.zeros(2, 2, 16).transpose(1, 2), torch.zeros(1, 16, 2)],
)
def test_out_must_be_contiguous_float32_rows(out):
    with pytest.raises(ValueError):
        tss.group_segment_sum_t_sorted(
            torch.zeros(2, 8, 2), torch.zeros(2, 8, dtype=torch.int32), 16, out=out)


def test_empty_stream_gives_zeros():
    out = tss.group_segment_sum_t_sorted(
        torch.zeros((2, 0, 2)), torch.zeros((2, 0), dtype=torch.int32), 7
    )
    assert tuple(out.shape) == (2, 2, 7) and not out.any()


@pytest.mark.parametrize(
    "vals, keys, err",
    [
        (torch.zeros(1, 8, 2, dtype=torch.float64),
         torch.zeros(1, 8, dtype=torch.int32), TypeError),
        (torch.zeros(1, 8, 2), torch.zeros(1, 8, dtype=torch.int64), TypeError),
        (torch.zeros(2, 8, 2), torch.zeros(1, 8, dtype=torch.int32), ValueError),
        (torch.zeros(8, 2), torch.zeros(1, 8, dtype=torch.int32), ValueError),
    ],
)
def test_wrapper_rejects_bad_arguments(vals, keys, err):
    with pytest.raises(err):
        tss.group_segment_sum_t_sorted(vals, keys, 16)
