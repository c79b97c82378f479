"""Parity of the port's widened slabs (virus_nerf_tpu_torch/ops/widen.py:
``build_wide_slabs`` and ``widen_slabs_group``, whose CPU path is the plain
version) with the JAX ``build_wide_slabs``, bit for bit: float32 and bf16
tables, the 16 x 2 and 8 x 4 layouts at small tables, and a group of
2^17-row levels (a multiple of 8192 rows, the size the TPU kernel takes).
The CUDA kernel is compared with the plain version on the card in
test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from virus_nerf_tpu.ops import hash_encoder as jhe
from virus_nerf_tpu_torch.ops import hash_encoder as the
from virus_nerf_tpu_torch.ops import widen

torch.set_num_threads(1)

# (levels, F, base_res, max_res, log2_T)
SPECS = {
    "16x2_small": (16, 2, 16, 256, 12),
    "8x4_small": (8, 4, 16, 64, 12),
    "group_2e17": (6, 2, 16, 2048, 17),  # levels 2-5: 4 x 131,072 rows
}
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _specs(name):
    L, F, b, m, t = SPECS[name]
    kw = dict(levels=L, feat_dim=F, base_res=b, max_res=m, max_params=2**t)
    return jhe.HashGridSpec.create(**kw), the.HashGridSpec.create(**kw)


def _table(spec, npdt, seed=0):
    # values of every exponent, so a float32 -> bf16 cast rounds in both
    # directions (and ties)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((spec.total_rows, spec.feat_dim)) * 10.0 ** rng.integers(
        -3, 3, (spec.total_rows, spec.feat_dim))
    return x.astype(np.float32).astype(npdt)


def _bits(x):
    """The raw bits of a float32 or bf16 array (numpy or torch)."""
    if isinstance(x, torch.Tensor):
        view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        return x.contiguous().view(view).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SPECS))
def test_build_wide_slabs_matches_jax_bit_for_bit(name, dtype):
    npdt, tdt = DTYPES[dtype]
    js, ts = _specs(name)
    table = _table(ts, npdt)
    want = jhe.build_wide_slabs(jnp.asarray(table), js)
    got = widen.build_wide_slabs(
        torch.from_numpy(table.astype(np.float32)).to(tdt), ts)
    assert len(got) == len(want) == ts.levels
    for lvl, (g, w) in enumerate(zip(got, want)):
        s, F = ts.sizes[lvl], ts.feat_dim
        w = np.asarray(w)
        assert g.shape == (s, 8, F) and w.shape == (s, 8 * F)
        # the JAX dtype rules: bf16 for a bf16 table and for >= 2^17 rows
        assert (g.dtype == torch.bfloat16) == (w.dtype == ml_dtypes.bfloat16)
        assert (g.dtype == torch.bfloat16) == (
            dtype == "bfloat16" or the.packable_size(s, F))
        np.testing.assert_array_equal(_bits(g.reshape(s, 8 * F)), _bits(w),
                                      err_msg=f"level {lvl}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_group_kernel_plain_version_matches_jax(dtype):
    # the kernel's contract on one same-size group: bf16 slabs of all G
    # levels in one call
    npdt, tdt = DTYPES[dtype]
    js, ts = _specs("group_2e17")
    size, _, _, lvls = the.same_size_level_groups(ts)[-1]
    assert len(lvls) == 4 and size == 2**17 and size % 8192 == 0
    table = _table(ts, npdt, seed=1)
    want = jhe.build_wide_slabs(jnp.asarray(table), js)
    t = torch.from_numpy(table.astype(np.float32)).to(tdt)
    args = (t, ts.offsets[lvls[0]], size, len(lvls), ts.corner_offsets[lvls[0]])
    before = widen.widen_slabs_group.launches
    got = widen.widen_slabs_group(*args)
    assert widen.widen_slabs_group.launches == before  # CPU: plain version
    assert torch.equal(got, widen.widen_slabs_group_plain(*args))
    assert got.shape == (4, size, 8, 2) and got.dtype == torch.bfloat16
    for j, lvl in enumerate(lvls):
        np.testing.assert_array_equal(
            _bits(got[j].reshape(size, 16)), _bits(np.asarray(want[lvl])))


def test_row_holds_the_eight_corners():
    # W[r, c] = T[offset + (r + o_c) mod s], checked row by row
    _, ts = _specs("8x4_small")
    table = torch.from_numpy(_table(ts, np.float32, seed=2))
    lvl = ts.levels - 1
    s, off = ts.sizes[lvl], ts.offsets[lvl]
    slab = widen.build_wide_slabs(table, ts)[lvl]
    r = torch.arange(s)
    for c, o in enumerate(ts.corner_offsets[lvl]):
        assert torch.equal(slab[:, c], table[off + (r + int(o)) % s])


@pytest.mark.parametrize(
    "kwargs, err",
    [
        (dict(table=torch.zeros(64, 2, dtype=torch.float64)), TypeError),
        (dict(row0=60), ValueError),  # rows past the table
        (dict(corner_offsets=[0, 1, 2]), ValueError),
        (dict(corner_offsets=[0, 1, 2, 3, 4, 5, 6, 40]), ValueError),
    ],
)
def test_wrapper_rejects_bad_arguments(kwargs, err):
    args = dict(table=torch.zeros(64, 2), row0=0, size=32, G=2,
                corner_offsets=list(range(8)))
    args.update(kwargs)
    with pytest.raises(err):
        widen.widen_slabs_group(**args)
