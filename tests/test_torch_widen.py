"""Parity of the port's widened slabs (virus_nerf_tpu_torch/ops/widen.py:
``build_wide_slabs`` and ``widen_slabs_group``, whose CPU path is the plain
version) with the JAX ``build_wide_slabs``, bit for bit: float32 and bf16
tables, the 16 x 2 and 8 x 4 layouts at small tables, and a group of
2^17-row levels (a multiple of 8192 rows, the size the TPU kernel takes).

The CUDA kernel (csrc/widen_slabs.cu) is emulated here in numpy, tile by
tile: each corner's window cut at the mod-size wrap into two runs, each
run placed in its shared-memory corner plane at its element's phase (16-
byte vectors between a scalar head and tail of at most 8 elements, every
vector aligned, both runs' vectors within the window's slots), and
the tile stored as 16-byte pieces of 8/F corners of one row.  Planes start
filled with a sentinel and count their writes, so a run that overlaps
another, leaves its plane or is read where nothing was written fails.  The
kernel itself is compared with the plain version on the card in
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


# ----------------------------------------- the kernel's tiles, emulated
SENTINEL = np.uint16(0x7FC1)  # a NaN no cast produces


def _emulate_widen(flat, F, row0, size, G, offs, mis):
    """The kernel on a flat table (float32, or bf16 as ml_dtypes) whose
    pointer lies ``mis`` elements past a 16-byte (or F-element) boundary:
    (G, size, 8, F) bf16 bit patterns as uint16."""
    TR, plane_len = widen.widen_tile_rows(F), widen.WIDEN_PLANE
    V = 16 // flat.dtype.itemsize  # elements of one 16-byte load
    M, K = max(V, F), 8 // F
    assert mis % F == 0 and 0 <= mis < M
    bits = flat.astype(ml_dtypes.bfloat16).view(np.uint16)  # the cast, RNE
    out = np.full((G, size * 8 * F), SENTINEL, np.uint16)
    written = np.zeros(out.shape, np.int64)

    def copy_run(e0, e1, plane, count, base):
        a = e0 - (e0 + mis) % M
        v0 = min(e0 + (V - (e0 + mis) % V) % V, e1)
        v1 = max(v0, e1 - (e1 + mis) % V)
        # one thread per head or tail element: 8 of each at most
        assert v0 - e0 < min(V, 9) and e1 - v1 < min(V, 9) and (v1 - v0) % V == 0
        pos0 = base + (e0 - a)  # element e goes to pos0 + (e - e0)
        for e in range(v0, v1, V):  # 16-byte loads, aligned shared stores
            assert (e + mis) % V == 0 and (pos0 + e - e0) % V == 0
        assert 0 <= pos0 and pos0 + (e1 - e0) <= plane_len
        plane[pos0:pos0 + e1 - e0] = bits[e0:e1]
        count[pos0:pos0 + e1 - e0] += 1
        return base + (e1 - a), (v1 - v0) // V

    for g in range(G):
        level = (row0 + g * size) * F
        for r0 in range(0, size, TR):
            rows = min(TR, size - r0)
            planes = np.full((8, plane_len), SENTINEL, np.uint16)
            count = np.zeros((8, plane_len), np.int64)
            runs = np.zeros((8, 3), np.int64)
            for c in range(8):
                t0 = r0 + offs[c]
                t0 -= size if t0 >= size else 0
                n1 = min(rows, size - t0)
                e0 = level + t0 * F
                end1, nv1 = copy_run(e0, e0 + n1 * F, planes[c], count[c], 0)
                base2 = -(-end1 // M) * M
                _, nv2 = copy_run(level, level + (rows - n1) * F, planes[c],
                                  count[c], base2)
                # the threads' vector slots cover both runs of a window
                assert nv1 + nv2 <= TR * F // V
                runs[c] = ((e0 + mis) % M, n1, base2 + (level + mis) % M)
            assert count.max() <= 1  # no two runs share a place
            # the store: piece q is row q // F, corners (q % F) * K ... + K
            q = np.arange(rows * F)
            i = q // F
            pieces = np.empty((rows * F, 8), np.uint16)
            for k in range(K):
                c = (q % F) * K + k
                n1 = runs[c, 1]
                pos = np.where(i < n1, runs[c, 0] + i * F, runs[c, 2] + (i - n1) * F)
                assert np.all(pos % F == 0)
                cols = pos[:, None] + np.arange(F)
                assert np.all(count[c[:, None], cols] == 1)  # read what was written
                pieces[:, k * F:(k + 1) * F] = planes[c[:, None], cols]
            lo = r0 * 8 * F
            out[g, lo:lo + rows * 8 * F] = pieces.reshape(-1)
            written[g, lo:lo + rows * 8 * F] += 1
    assert np.all(written == 1)  # every output element stored once
    return out.reshape(G, size, 8, F)


def _offsets(size, o1, o2, o4):
    return [(o1 * (c & 1) + o2 * (c >> 1 & 1) + o4 * (c >> 2 & 1)) % size
            for c in range(8)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_tile_emulation_matches_plain_version(F, dtype):
    # sizes that are not a multiple of the tile (and one under it), offsets
    # that wrap, every table phase the wrapper admits
    npdt, tdt = DTYPES[dtype]
    TR = widen.widen_tile_rows(F)
    rng = np.random.default_rng(F)
    V = 16 // np.dtype(npdt).itemsize
    for size, G, row0 in ((2 * TR + 37, 2, 5), (TR - 3, 1, 0), (3 * TR + 1, 1, 17)):
        offs = _offsets(size, 1, size // 3 + 1, size - 2)
        rows = row0 + G * size + 3
        x = (rng.standard_normal(rows * F) * 10.0 ** rng.integers(-3, 3, rows * F))
        flat = x.astype(np.float32).astype(npdt)
        table = torch.from_numpy(flat.astype(np.float32)).to(tdt).reshape(rows, F)
        want = widen.widen_slabs_group_plain(table, row0, size, G, offs)
        want = want.contiguous().view(torch.int16).numpy().view(np.uint16)
        for mis in range(0, max(V, F), F):
            got = _emulate_widen(flat, F, row0, size, G, offs, mis)
            np.testing.assert_array_equal(got, want, err_msg=f"size {size} mis {mis}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_emulation_matches_jax_build_wide_slabs(dtype):
    # the hashed-size group of the JAX layout: 4 levels of 2^17 rows
    npdt, _ = DTYPES[dtype]
    js, ts = _specs("group_2e17")
    size, _, _, lvls = the.same_size_level_groups(ts)[-1]
    table = _table(ts, npdt, seed=3)
    want = jhe.build_wide_slabs(jnp.asarray(table), js)
    got = _emulate_widen(table.reshape(-1), 2, ts.offsets[lvls[0]], size,
                         len(lvls), [int(o) for o in ts.corner_offsets[lvls[0]]],
                         mis=0)
    for j, lvl in enumerate(lvls):
        np.testing.assert_array_equal(got[j].reshape(size, 16),
                                      _bits(np.asarray(want[lvl])).view(np.uint16))


def test_tile_constants():
    # the (TR, 8, F) bf16 tile is 32 KB at every F; a plane holds TR * F
    # values plus the phases of two runs (3 blocks of up to 8 elements)
    for F in widen.WIDEN_KERNEL_FEATS:
        TR = widen.widen_tile_rows(F)
        assert TR * 8 * F * 2 == widen.WIDEN_TILE_BYTES
        assert widen.WIDEN_PLANE >= TR * F + 3 * 8 - 3
