"""Inputs for the tests of E2, the evaluator's nearest-neighbour search
(``virus_nerf_tpu_torch/ops/nn_search.py``), and a numpy emulation of the
kernel's scheme.  Imports neither jax nor the JAX package, so the card's
tests use it too.

Each case is ``(pos, pos_ref, n)``: n images of K query points and n images
of M reference points, (n*K, 2) and (n*M, 2) float32 (float64 where a case
says), image after image.
"""

import zlib

import numpy as np

TILE = 1024  # csrc/nn_search.cu's kTile: the emulation stages as the kernel
NAN32 = np.float32(np.nan)


def ring(rng, n, k, r_lo=1.0, r_hi=6.0):
    """(n, k, 2) float32 points of a room's scan: around the origin at
    radii in [r_lo, r_hi)."""
    ang = rng.uniform(-np.pi, np.pi, (n, k))
    rad = rng.uniform(r_lo, r_hi, (n, k))
    return np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(np.float32)


def fma_pairs(rng, count):
    """(count, 2) float32 queries and references whose distance changes
    when d^2 = dx*dx + dy*dy is contracted into a fused multiply-add, in
    either order (fma(dx, dx, dy*dy) and fma(dy, dy, dx*dx))."""
    qs, rs = [], []
    while sum(len(q) for q in qs) < count:
        q = rng.uniform(-6.0, 6.0, (4096, 2)).astype(np.float32)
        r = (q + rng.uniform(-0.5, 0.5, (4096, 2))).astype(np.float32)
        plain = np.sqrt(square_sum(r - q))
        keep = ((plain != np.sqrt(fma_square_sum(r - q, 0)))
                & (plain != np.sqrt(fma_square_sum(r - q, 1))))
        qs.append(q[keep])
        rs.append(r[keep])
    return np.concatenate(qs)[:count], np.concatenate(rs)[:count]


def square_sum(d):
    """numpy's float32 d^2: each product and the sum rounded once."""
    return np.add(np.multiply(d[..., 0], d[..., 0]),
                  np.multiply(d[..., 1], d[..., 1]))


def fma_square_sum(d, first):
    """d^2 as a contracted multiply-add: coordinate ``first`` squared and
    added to the other's rounded square with one rounding (float64 holds
    the exact square of a float32)."""
    a = d[..., first].astype(np.float64)
    b = d[..., 1 - first]
    return (a * a + np.multiply(b, b).astype(np.float64)).astype(np.float32)


def scans(seed, n=16, k=512, m=512):
    """n images of room scans with what the search must get exactly:
    exact ties (duplicated reference points, and points mirrored about a
    query on a dyadic grid, where every difference is exact), points whose
    distance an FMA would change, NaN rows on both sides, and one image
    with no valid reference point."""
    rng = np.random.default_rng(seed)
    pos = ring(rng, n, k)
    ref = np.concatenate([pos[:, :m], ring(rng, n, max(m - k, 0))], axis=1)
    ref = (ref + rng.normal(0.0, 0.05, ref.shape)).astype(np.float32)
    for i in range(n):
        q, r = fma_pairs(rng, k // 4)
        pos[i, :k // 4], ref[i, :k // 4] = q, r
        # mirrored about queries on a 1/8 grid: 2 or 4 exact ties each
        a = k // 4
        grid = rng.integers(-40, 40, (16, 2)) / 8.0
        off = rng.integers(1, 8, 16) / 16.0
        pos[i, a:a + 16] = grid
        ref[i, a:a + 16] = grid + np.stack([off, 0 * off], 1)
        ref[i, a + 16:a + 32] = grid - np.stack([off, 0 * off], 1)
        ref[i, a + 32:a + 48] = grid + np.stack([0 * off, off], 1)
        # duplicated reference points
        ref[i, a + 48:a + 80] = ref[i, a + 80:a + 112]
        # NaN rows: x, y or both, on both sides
        for arr, count in ((pos, k), (ref, m)):
            rows = rng.choice(count, count // 16, replace=False)
            arr[i, rows, rng.integers(0, 2, rows.shape[0])] = np.nan
            arr[i, rows[: rows.shape[0] // 3]] = np.nan
        ref[i] = ref[i, rng.permutation(m)]
    if n > 1:
        ref[1] = np.nan  # an image with no valid reference point
    return pos.reshape(-1, 2), ref.reshape(-1, 2), n


def case(name):
    """The CPU tests' cases by name."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "random":
        return (rng.normal(size=(3 * 40, 2)).astype(np.float32),
                rng.normal(size=(3 * 57, 2)).astype(np.float32), 3)
    if name == "float64_inputs":
        return rng.normal(size=(2 * 50, 2)), rng.normal(size=(2 * 50, 2)), 2
    if name == "nan_rows":
        pos, ref = ring(rng, 4, 64), ring(rng, 4, 64)
        for arr in (pos, ref):
            arr[:, ::5, 0] = np.nan
            arr[:, 1::7, 1] = np.nan
            arr[:, 2::9] = np.nan
        return pos.reshape(-1, 2), ref.reshape(-1, 2), 4
    if name == "empty_images":
        pos, ref = ring(rng, 4, 32), ring(rng, 4, 48)
        ref[0] = np.nan  # no valid reference
        pos[1] = np.nan  # no valid query
        pos[3], ref[3] = np.nan, np.nan
        ref[2, :47] = np.nan  # one valid reference
        return pos.reshape(-1, 2), ref.reshape(-1, 2), 4
    if name == "duplicate_ties":
        pos = ring(rng, 2, 32)
        half = ring(rng, 2, 32)
        ref = np.concatenate([half, half], axis=1)[:, rng.permutation(64)]
        return pos.reshape(-1, 2), ref.reshape(-1, 2), 2
    if name == "mirror_ties":
        pos = (rng.integers(-40, 40, (2, 24, 2)) / 8.0).astype(np.float32)
        off = (rng.integers(1, 8, (2, 24, 1)) / 16.0).astype(np.float32)
        zero = np.zeros_like(off)
        ref = np.concatenate([pos + np.concatenate([off, zero], -1),
                              pos - np.concatenate([off, zero], -1),
                              pos + np.concatenate([zero, off], -1),
                              pos - np.concatenate([zero, off], -1)], axis=1)
        ref = ref[:, rng.permutation(ref.shape[1])]
        return pos.reshape(-1, 2), ref.reshape(-1, 2), 2
    if name == "fma":
        q, r = fma_pairs(rng, 2 * 128)
        far = ring(rng, 2, 128, 50.0, 60.0)
        ref = np.concatenate([r.reshape(2, 128, 2), far], axis=1)
        return q, ref[:, rng.permutation(256)].reshape(-1, 2), 2
    if name == "lidar":  # K != M: a LiDAR scan packs thousands of points
        return ring(rng, 2, 64).reshape(-1, 2), ring(rng, 2, 3000).reshape(-1, 2), 2
    if name == "uss":  # a USS or ToF scan packs a few dozen
        return ring(rng, 3, 600).reshape(-1, 2), ring(rng, 3, 24).reshape(-1, 2), 3
    if name == "inf":  # inf - inf: a NaN d^2, the minimum to np.argmin
        pos, ref = ring(rng, 2, 16), ring(rng, 2, 40)
        pos[0, :4, 0] = np.inf
        ref[0, 10:13, 0] = np.inf
        ref[1, 5, 1] = -np.inf
        return pos.reshape(-1, 2), ref.reshape(-1, 2), 2
    if name == "n1_512":
        return scans(1, n=1)
    if name == "n16_512":
        return scans(2)
    raise KeyError(name)


CASES = ("random", "float64_inputs", "nan_rows", "empty_images",
         "duplicate_ties", "mirror_ties", "fma", "lidar", "uss", "inf",
         "n1_512", "n16_512")


def emulate_e2(pos, pos_ref, n, fma_first=None):
    """(indices, distances), (n, K) each, on E2's scheme: the float32 cast
    on the host, one thread a query scanning the references in ascending
    order a tile at a time, NaN references skipped, a strict ``<`` (or a
    NaN d^2 over a number), then the square root of the best d^2.  With
    ``fma_first`` d^2 is contracted (:func:`fma_square_sum`): what the
    kernel would give had nvcc fused it."""
    q = np.asarray(pos, np.float32).reshape(n, -1, 1, 2)
    r = np.asarray(pos_ref, np.float32).reshape(n, -1, 2)
    live = ~np.isnan(q).any(-1)[..., 0]
    best = np.zeros(live.shape, np.float32)
    best_i = np.full(live.shape, -1, np.int32)
    with np.errstate(invalid="ignore", over="ignore"):
        for base in range(0, r.shape[1], TILE):
            tile = r[:, base:base + TILE]
            for j in range(tile.shape[1]):
                rj = tile[:, j][:, None, None, :]
                ok = ~np.isnan(rj).any(-1)[..., 0]
                d = np.subtract(rj, q)[..., 0, :]
                d2 = (square_sum(d) if fma_first is None
                      else fma_square_sum(d, fma_first))
                take = live & ok & ((best_i < 0) | (d2 < best)
                                    | (np.isnan(d2) & ~np.isnan(best)))
                best = np.where(take, d2, best)
                best_i = np.where(take, np.int32(base + j), best_i)
        dist = np.where(best_i < 0, NAN32, np.sqrt(best)).astype(np.float32)
    return best_i, dist


def same_f32(a, b):
    """Float32 arrays equal bit for bit, any NaN equal to any NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return (a.shape == b.shape and np.array_equal(nan, np.isnan(b))
            and np.array_equal(a[~nan].view(np.int32), b[~nan].view(np.int32)))
