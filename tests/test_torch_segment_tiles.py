"""The row-tile segment-sum algorithm of csrc/segment_tiles.cuh (the core of
the transposed segment sum B1, the row-major segment sum B3 and the factor
segment sum B4), emulated in numpy launch by launch, against a float64 sum
and against the JAX package's ``group_segment_sum_ts_sorted``,
``group_segment_sum_t_sorted`` and ``group_segment_sum_tsf_sorted`` (their
CPU path).

The CUDA kernels cannot run without a card; this emulation follows them
step for step: the first launch (each tile's first stream entry by a
binary search; one warp per 512-entry chunk that leaves where no long
window reaches it, as two probes or else a search of the window show, or
else leaves run-piece sums at the piece's last position) and the tile
launch (each tile's window from those starts, the cut at the
short-window length C, contiguous pieces of whole 32-entry steps (one per
warp of a plane group) whose inner runs are stored and whose first and
last runs are joined in order, and for a long window each row's bounds
by a search and its join of its chunks' partials).  B1 and B4 take tiles
of ``tile_rows(V)`` rows and C = ``SHORT_WINDOW``; B3 takes
``row_tile_rows(F, dense)`` rows (the dense tiles where
``row_tiles_dense`` says so), C = ``ROW_SHORT_WINDOW``, and stores its
tile as (rows, F).  It reads its constants from ``ops/segment_sum.py``;
the card tests in test_torch_cuda_kernels.py check that the C side has
the same.  Scratch and output start as NaN, so a value read before it is
written, or a row the tiles never store, fails the comparison."""

from collections import namedtuple

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from virus_nerf_tpu.ops import segment_sum_pallas as jss
from virus_nerf_tpu_torch.ops import segment_sum as tss

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
C, CHUNK = tss.SHORT_WINDOW, tss.TILE_CHUNK
WARPS = 8  # warps of a tile CTA
WARP = 32

# a loader's tiles: rows R, short-window cut C, and whether the tile is
# stored as (rows, V) rows
Shape = namedtuple("Shape", "R C row_major")


def _tile_shape(V):
    """B1's and B4's tiles at V planes."""
    return Shape(tss.tile_rows(V), C, False)


def _row_shape(F, dense):
    """B3's sparse or dense tiles at F features."""
    return Shape(tss.row_tile_rows(F, dense), tss.ROW_SHORT_WINDOW, True)


def _pieces(V):
    """Pieces a short window is cut into: the CTA's min(V, TILE_PLANES)
    planes fall into groups of min(V, SCAN_PLANES), one warp per group and
    piece."""
    groups = min(V, tss.TILE_PLANES) // min(V, tss.SCAN_PLANES)
    return WARPS // groups


def _runs(keys, p0, p1):
    """(key, start, end) of every run of equal keys in keys[p0:p1]."""
    k = keys[p0:p1]
    starts = np.concatenate([[0], np.nonzero(k[1:] != k[:-1])[0] + 1])
    ends = np.concatenate([starts[1:], [len(k)]])
    return [(int(k[a]), p0 + a, p0 + b) for a, b in zip(starts, ends)]


def _window(kg, t, n_rows, R):
    lo = int(np.searchsorted(kg, t * R, "left"))
    hi = int(np.searchsorted(kg, min(t * R + R, n_rows), "left"))
    return lo, hi


def _is_long(kg, t, c, n_rows, shape):
    """Launch 1's check whether the window of tile t is longer than C: two
    probes C / 2 entries either side of entry c may show that it is not;
    else the window is searched."""
    r0, K = t * shape.R, len(kg)
    a, b = c - shape.C // 2, c + shape.C // 2
    starts_after = a < 0 or kg[a] < r0
    ends_by = b >= K or kg[b] >= min(r0 + shape.R, n_rows)
    lo, hi = _window(kg, t, n_rows, shape.R)
    if starts_after and ends_by:
        assert hi - lo <= shape.C  # the probes are right when they say so
        return False
    return hi - lo > shape.C


def tile_segment_sum(terms, keys, n_rows, shape):
    """The kernels' two launches on (G, V, K) float32 terms and (G, K)
    sorted int32 keys, at a loader's tile shape.  Returns the (G, V,
    n_rows) float32 sums (read from (G, n_rows, V) storage for a
    row-major store) and the number of long windows."""
    G, V, K = terms.shape
    R, Cw = shape.R, shape.C
    store = np.full((G, n_rows, V) if shape.row_major else (G, V, n_rows),
                    np.nan, np.float32)
    part = np.full((G, K, V), np.nan, np.float32)
    n_long = 0
    for g in range(G):
        kg, vg = keys[g], terms[g]

        def piece_sum(a, b):
            return vg[:, a:b].sum(axis=1, dtype=np.float32)

        # launch 1: each tile's first entry by a search, one warp per chunk
        n_tiles = -(-n_rows // R)
        starts = np.searchsorted(kg, np.minimum(np.arange(n_tiles + 1) * R, n_rows))
        for c0 in range(0, K, CHUNK):
            c1 = min(c0 + CHUNK, K)
            kf, kl = int(kg[c0]), int(kg[c1 - 1])
            if kl < 0 or kf >= n_rows:
                continue
            tf, tl = max(kf, 0) // R, min(kl, n_rows - 1) // R
            if not (_is_long(kg, tf, c0, n_rows, shape)
                    or (tl != tf and _is_long(kg, tl, c1 - 1, n_rows, shape))):
                continue
            for key, a, b in _runs(kg, c0, c1):
                if 0 <= key < n_rows:
                    part[g, b - 1] = piece_sum(a, b)

        # launch 2: one CTA per tile of R rows
        for t in range(-(-n_rows // R)):
            r0 = t * R
            rows = min(R, n_rows - r0)
            acc = np.zeros((V, R), np.float32)
            lo, hi = int(starts[t]), int(starts[t + 1])
            assert (lo, hi) == _window(kg, t, n_rows, R)
            n = hi - lo
            if n <= Cw:
                Q = _pieces(V)
                per = -(-n // Q)
                piece = -(-per // WARP) * WARP
                ends = []  # per non-empty piece: (head, tail) as (key, sums)
                for q in range(Q):
                    p0 = min(lo + q * piece, hi)
                    p1 = min(p0 + piece, hi)
                    if p0 >= p1:
                        break
                    runs = _runs(kg, p0, p1)
                    for key, a, b in runs[1:-1]:
                        acc[:, key - r0] = piece_sum(a, b)
                    head = (runs[0][0], piece_sum(*runs[0][1:]))
                    tail = (runs[-1][0], piece_sum(*runs[-1][1:]))
                    ends.append((head, tail))
                # warp 0 joins the pieces' first and last runs in order
                open_key, open_sum = None, None
                for (hk, hs), (tk, ts) in ends:
                    if hk == open_key:
                        open_sum = open_sum + hs
                    else:
                        if open_key is not None:
                            acc[:, open_key - r0] = open_sum
                        open_key, open_sum = hk, hs
                    if tk != hk:
                        acc[:, open_key - r0] = open_sum
                        open_key, open_sum = tk, ts
                if open_key is not None:
                    acc[:, open_key - r0] = open_sum
            else:
                n_long += 1
                bound = np.searchsorted(kg[lo:hi], r0 + np.arange(rows + 1)) + lo
                bound[rows] = hi
                for r in range(rows):
                    a, b = int(bound[r]), int(bound[r + 1])
                    if a == b:
                        continue
                    s = np.zeros(V, np.float32)
                    for c in range(a // CHUNK, (b - 1) // CHUNK + 1):
                        s = s + part[g, min(b, (c + 1) * CHUNK) - 1]
                    acc[:, r] = s
            if shape.row_major:
                store[g, r0:r0 + rows] = acc[:, :rows].T
            else:
                store[g, :, r0:r0 + rows] = acc[:, :rows]
    out = store.transpose(0, 2, 1) if shape.row_major else store
    return out, n_long


# ------------------------------------------------------------------ cases
CASES = ["uniform", "one_row", "window_C", "window_C_plus_1", "empty",
         "out_of_range", "all_out_of_range", "ragged_last_tile", "groups"]
# cases whose long-window count is known
LONG = {"uniform": 0, "window_C": 0, "window_C_plus_1": 1, "empty": 0,
        "all_out_of_range": 0, "ragged_last_tile": 0}


def _keys(name, R, Cw=C):
    """(keys (G, K) sorted int32, n_rows) of one case, for tiles of R
    rows and a short-window cut of Cw entries."""
    rng = np.random.default_rng(20 + CASES.index(name))
    if name == "uniform":
        return np.sort(rng.integers(0, 12000, (2, 6000)), axis=1), 12000
    if name == "one_row":
        # one row holds 15,000 of 20,000 entries (a dense level's hot row)
        k = rng.integers(0, 5000, (1, 20000))
        k[0, :15000] = 2222
        return np.sort(k, axis=1), 5000
    if name in ("window_C", "window_C_plus_1"):
        # tile 1 (rows R..2R - 1) holds exactly C or C + 1 entries
        n1 = Cw + (name == "window_C_plus_1")
        k = np.concatenate([rng.integers(0, R, 700), rng.integers(R, 2 * R, n1),
                            rng.integers(2 * R, 4 * R, 900)])
        return np.sort(k)[None], 4 * R
    if name == "empty":
        return np.zeros((2, 0), np.int64), 300
    if name == "out_of_range":
        # keys below 0 and at or above n_rows are dropped; a long window
        # sits next to them at both ends
        hot = max(5000, Cw + 1000)
        k = rng.integers(-60, 2060, (2, 2 * hot + 1000))
        k[:, :hot] = rng.integers(0, 100, (2, hot))
        k[:, hot:2 * hot] = rng.integers(1950, 2000, (2, hot))
        return np.sort(k, axis=1), 2000
    if name == "all_out_of_range":
        k = np.concatenate([rng.integers(-500, 0, (1, 700)),
                            rng.integers(900, 5000, (1, 800))], axis=1)
        return np.sort(k, axis=1), 900
    if name == "ragged_last_tile":
        # 1001 rows: a ragged last tile (233 or 489 rows), n_rows % 4 != 0
        return np.sort(rng.integers(0, 1001, (1, 1200)), axis=1), 1001
    # G = 3 of different shapes: uniform, a hot band (long windows), sparse
    k = np.stack([rng.integers(0, 4000, 12000),
                  np.where(rng.random(12000) < 0.7, rng.integers(300, 340, 12000),
                           rng.integers(0, 4000, 12000)),
                  rng.integers(0, 4000, 12000) // 7 * 7])
    return np.sort(k, axis=1), 4000


def _oracle(terms, keys, n_rows):
    """float64 sums (G, V, n_rows) over the keys in range, and the per-row
    float32 tolerance 4 * eps32 * sqrt(n) * sum|v| (chip_smoke's)."""
    G, V, K = terms.shape
    exact = np.zeros((G, n_rows, V))
    mag = np.zeros((G, n_rows, V))
    cnt = np.zeros((G, n_rows))
    for g in range(G):
        ok = (keys[g] >= 0) & (keys[g] < n_rows)
        t = terms[g][:, ok].T.astype(np.float64)
        np.add.at(exact[g], keys[g][ok], t)
        np.add.at(mag[g], keys[g][ok], np.abs(t))
        np.add.at(cnt[g], keys[g][ok], 1.0)
    tol = 4.0 * EPS32 * np.sqrt(cnt)[:, :, None] * mag
    return exact.transpose(0, 2, 1), tol.transpose(0, 2, 1), mag.transpose(0, 2, 1)


def _check(name, terms, keys, n_rows, jax_fn, shape):
    """The emulation against the float64 oracle (per-row bound; empty rows
    exactly 0) and against the JAX contract function."""
    got, n_long = tile_segment_sum(terms, keys, n_rows, shape)
    exact, tol, mag = _oracle(terms, keys, n_rows)
    assert got.shape == exact.shape
    assert np.all(np.abs(got - exact) <= tol), np.nanmax(np.abs(got - exact) - tol)
    assert np.all(got[mag == 0] == 0.0)  # rows no key hits, NaN-free
    if name in LONG:
        assert n_long == LONG[name]
    elif name != "ragged_last_tile":
        assert n_long > 0  # the long-window path ran
    # JAX's contract takes keys in [0, n_rows) (its CPU path gives keys
    # above the range to the last row): each group goes to it without them.
    # That path differences float32 prefix sums over the whole stream
    # (segment_sum_pallas.py:706-716), so its error follows the prefix: the
    # per-row bound plus 4 * eps32 * max|prefix|
    for g in range(keys.shape[0]):
        m = (keys[g] >= 0) & (keys[g] < n_rows)
        if not m.any():
            continue
        want = np.asarray(jax_fn(g, m))[0]
        prefix = np.abs(np.cumsum(terms[g][:, m].astype(np.float64), axis=1)).max()
        assert np.all(np.abs(want - got[g]) <= 2 * tol[g] + 4.0 * EPS32 * prefix)
    return got


@pytest.mark.parametrize("VF", [16, 32, 64])
@pytest.mark.parametrize("name", CASES)
def test_transposed_tiles_match_float64_and_jax(name, VF):
    shape = _tile_shape(VF)
    keys, n_rows = _keys(name, shape.R)
    keys = keys.astype(np.int32)
    rng = np.random.default_rng(VF)
    vals = rng.standard_normal((keys.shape[0], VF, keys.shape[1])).astype(np.float32)

    def jax_fn(g, m):
        return jss.group_segment_sum_ts_sorted(
            jnp.asarray(vals[g:g + 1][:, :, m]), jnp.asarray(keys[g:g + 1][:, m]),
            n_rows)

    got = _check(name, vals, keys, n_rows, jax_fn, shape)
    if keys.size and ((keys >= 0) & (keys < n_rows)).any():
        assert np.abs(got).max() > 1.0  # the comparison is not vacuous


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("name", CASES)
def test_row_tiles_match_float64_and_jax(name, F, dense):
    shape = _row_shape(F, dense)
    keys, n_rows = _keys(name, shape.R, shape.C)
    keys = keys.astype(np.int32)
    rng = np.random.default_rng(200 + F)
    vals = rng.standard_normal((keys.shape[0], keys.shape[1], F)).astype(np.float32)

    def jax_fn(g, m):
        return jss.group_segment_sum_t_sorted(
            jnp.asarray(vals[g:g + 1][:, m]), jnp.asarray(keys[g:g + 1][:, m]),
            n_rows)

    got = _check(name, vals.transpose(0, 2, 1), keys, n_rows, jax_fn, shape)
    if keys.size and ((keys >= 0) & (keys < n_rows)).any():
        assert np.abs(got).max() > 1.0  # the comparison is not vacuous


@pytest.mark.parametrize("F", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES)
def test_factor_tiles_match_float64_and_jax(name, dtype, F):
    keys, n_rows = _keys(name, _tile_shape(8 * F).R)
    keys = keys.astype(np.int32)
    G, K = keys.shape
    rng = np.random.default_rng(100 + F)
    wgt32 = np.concatenate([rng.random((G, 8, K)), rng.standard_normal((G, F, K))],
                           axis=1).astype(np.float32)
    npdt, tdt = {"float32": (np.float32, torch.float32),
                 "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}[dtype]
    wgt = torch.from_numpy(wgt32).to(tdt)
    # the products as the loader forms them (a bf16 product rounded to bf16)
    terms = tss.factor_products(wgt, F).float().numpy()
    wgt_np = wgt32.astype(npdt)

    def jax_fn(g, m):
        return jss.group_segment_sum_tsf_sorted(
            jnp.asarray(wgt_np[g:g + 1][:, :, m]), jnp.asarray(keys[g:g + 1][:, m]),
            n_rows, F)

    _check(name, terms, keys, n_rows, jax_fn, _tile_shape(8 * F))


def test_emulation_uses_the_kernel_constants():
    # a chunk is 16 warp steps; the short-window cut is a whole number of
    # chunks; a CTA's accumulator is 32 KB of static shared memory
    assert (C, CHUNK, tss.TILE_FLOATS) == (2048, 512, 8192)
    assert C % CHUNK == 0 and CHUNK % WARP == 0
    # rows per CTA: 1 KB per plane at 32 planes, 2 KB at 16 or fewer
    assert [tss.tile_rows(V) for V in (1, 8, 16, 32, 64)] == [512, 512, 512, 256, 256]
    # V = 16 (B4 at F = 2): 2 plane groups of 8, 4 pieces; V = 32 and 64:
    # 4 groups, 2 pieces; V <= 8: one group, 8 pieces
    assert [_pieces(V) for V in (1, 8, 16, 32, 64)] == [8, 8, 4, 2, 2]
    # B3: sparse tiles of 1,024 rows (512 at F = 8, so that the
    # accumulator and a long window's row bounds fit 32 KB), dense tiles of
    # 128; a short-window cut of 8 sparse tile rows' worth (the hashed
    # levels hold ~2 entries a row); one plane group, 8 pieces
    assert [tss.row_tile_rows(F, False) for F in (1, 2, 4, 8)] == [1024, 1024, 1024, 512]
    assert [tss.row_tile_rows(F, True) for F in (1, 2, 4, 8)] == [128] * 4
    assert all(tss.row_tile_rows(F, d) * (F + 2) <= tss.TILE_FLOATS
               for F in (1, 2, 4, 8) for d in (False, True))
    assert tss.ROW_SHORT_WINDOW == 8192 and tss.ROW_SHORT_WINDOW % CHUNK == 0
    assert [_pieces(F) for F in (1, 2, 4, 8)] == [8] * 4
    # the dense tiles where a sparse tile's window would average over C:
    # the XOR path's merged dense levels (~12 entries a row), not its
    # hashed group (~2)
    assert tss.row_tiles_dense(2, 6 * 917504, 467152)
    assert not tss.row_tiles_dense(2, 917504, 524288)
