"""The fused march of csrc/march.cu (lattice, probe and slot selection in
one kernel), emulated in numpy on its own scheme, against its plain version
``march_select_plain`` and, through it, the jitted JAX ``march_rays_train``.

The kernel cannot run without a card; this emulation follows it step for
step: one warp a ray, the candidates in chunks of ``MARCH_CHUNK`` (one
lane each), the exponential chain run ahead a chunk at a time into the
ray's row, pass 1 keeping each chunk's ballot of the valid candidates and
stopping after the chunk whose last candidate is past t2, pass 2 ranking
each kept candidate by the running count plus the ballot's lower lanes and
storing it to its slot (rank, or ceil(jS/c) with its dt scaled by the
candidates it represents for c > S), then the zero tail.  Its float work
is the kernel's: fused multiply-adds rounded once, ceil(log2 x) on the
float's bits, the power-of-two reciprocal in place of the division.  The
outputs start as NaN and every store is counted, so a slot written twice
or never fails.  The chunk width comes from ``ops/ray_march.py``; a card
test checks that the C side has the same.

Cases: constant and exponential lattices, one- and two-row grids, empty,
half-full and full grids, (S, K) of (256, 1024), (512, 1024), (24, 256)
and (300, 256), rays that miss the cube."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.ops.ray_march import march_rays_train as j_march
from virus_nerf_tpu_torch.ops import ray_march
from virus_nerf_tpu_torch.ops.common import SQRT3, SQRT3_2, _ceil_log2
from virus_nerf_tpu_torch.ops.intersection import ray_aabb_intersect
from virus_nerf_tpu_torch.ops.ray_march import march_select, march_select_plain

torch.set_num_threads(1)

CHUNK = ray_march.MARCH_CHUNK
GS = 32
F32 = np.float32

# the two lattices by grid rows: the bench's constant step at scale 0.5 on
# one cascade (two rows: the same step over two cascades at scale 1.0), and
# the exponential step of every scene of scale > 0.5 on two cascades, over
# the NGP grid's two rows or the one-row VIRUS grid read past its end
LATTICES = {
    ("constant", 1): dict(scale=0.5, cascades=1, exp_step_factor=0.0),
    ("constant", 2): dict(scale=1.0, cascades=2, exp_step_factor=0.0),
    ("exponential", 1): dict(scale=1.0, cascades=2, exp_step_factor=1 / 256),
    ("exponential", 2): dict(scale=1.0, cascades=2, exp_step_factor=1 / 256),
}


# ----------------------------------------------------------- the emulation
def fma32(a, b, c):
    """a * b + c rounded once to float32: the product is exact in the
    64-bit significand, and the sum's rounding to it cannot land on a
    float32 tie that the exact sum is not on."""
    ld = np.longdouble
    return (np.asarray(a, F32).astype(ld) * np.asarray(b, F32).astype(ld)
            + np.asarray(c, F32).astype(ld)).astype(F32)


def ceil_log2_bits(x):
    """The kernel's ``ceil_log2``: torch.frexp's exponent, less one where
    the mantissa is 0.5, 0 for 0, worked out from the float's bits."""
    b = np.asarray(x, F32).view(np.uint32) & np.uint32(0x7FFFFFFF)
    e = (b >> 23).astype(np.int64)
    m = (b & np.uint32(0x7FFFFF)).astype(np.int64)
    p = np.frexp(np.maximum(m, 1).astype(np.float64))[1] - 1  # highest bit
    sub = np.where(m & (m - 1), p - 148, p - 149)
    normal = np.where(m != 0, e - 126, e - 127)
    return np.where(e == 0, np.where(m == 0, 0, sub),
                    np.where(e == 255, 0, normal))


def clamp_dt(x, lo, hi):
    return np.where(x > hi, hi, np.where(x < lo, lo, x)).astype(F32)


def probe(grid, o, d, t, dt, cascades, scale):
    """The kernel's ``probe`` at o + t * d ((n, CHUNK) candidates)."""
    gsf, numel = F32(GS), grid.size
    xyz = [fma32(t, d[:, i:i + 1], o[:, i:i + 1]) for i in range(3)]
    mx = np.maximum(np.abs(xyz[0]), np.maximum(np.abs(xyz[1]), np.abs(xyz[2])))
    mip_abs = np.clip(ceil_log2_bits(mx) + 1, 0, cascades - 1)
    mip_dt = np.clip(ceil_log2_bits(dt * gsf), 0, cascades - 1)
    mip = np.maximum(mip_abs, mip_dt)
    mb = ((126 + mip) << 23).astype(np.uint32).view(F32)
    mb = np.where(F32(scale) < mb, F32(scale), mb).astype(F32)
    mbits = mb.view(np.uint32)
    me = (mbits >> 23).astype(np.int64)
    pow2 = ((mbits & 0x7FFFFF) == 0) & (me >= 1) & (me <= 253)
    inv = (np.clip(254 - me, 0, 255) << 23).astype(np.uint32).view(F32)
    cells = []
    for p in xyz:
        with np.errstate(divide="ignore", invalid="ignore"):
            q = np.where(pow2, p * inv, p / mb).astype(F32)
        n = (F32(0.5) * (q + F32(1.0))) * gsf
        cells.append(np.clip(n, F32(0.0), F32(GS - 1)).astype(np.int64))
    ix, iy, iz = cells
    idx = np.minimum(mip * GS**3 + (ix * GS + iy) * GS + iz, numel - 1)
    return grid.reshape(-1)[idx]


def emulate_march(o, d, t1, t2, noise, grid, *, scale, cascades,
                  exp_step_factor, S, K, res):
    """csrc/march.cu's ``march_select_kernel``, warp by warp."""
    n = t1.shape[0]
    esf = F32(exp_step_factor)
    lo = F32(SQRT3 / res)
    hi = F32(SQRT3_2 * scale / GS)
    dt0 = F32(min(max(0.0, SQRT3 / res), SQRT3_2 * scale / GS))
    n_chunks = -(-K // CHUNK)
    lane = np.arange(CHUNK)
    # the producer's rows (exponential); NaN where it never wrote
    rows = np.full((n, n_chunks * CHUNK), np.nan, F32)
    t_chain = fma32(noise, clamp_dt(t1 * esf, lo, hi), t1)

    # pass 1: the chunks of every live ray, their ballots and counts
    live = t1 >= 0.0
    ballots = np.zeros((n, n_chunks), np.uint64)
    count = np.zeros(n, np.int64)
    chunks = np.zeros(n, np.int64)
    for c in range(n_chunks):
        if not live.any():
            break
        k = c * CHUNK + lane
        if exp_step_factor:
            for j in range(min(CHUNK, K - c * CHUNK)):  # the producer lane
                rows[live, c * CHUNK + j] = t_chain[live]
                t_chain = np.where(
                    live, t_chain + clamp_dt(t_chain * esf, lo, hi),
                    t_chain).astype(F32)
            t = rows[:, c * CHUNK:(c + 1) * CHUNK]
            dt = clamp_dt(t * esf, lo, hi)
        else:
            t = fma32(noise[:, None] + k.astype(F32)[None, :], dt0, t1[:, None])
            dt = np.full_like(t, dt0)
        in_range = live[:, None] & (k < K)[None, :] & (t >= 0.0) & (t < t2[:, None])
        hit = in_range & probe(grid, o, d, np.where(in_range, t, F32(0.0)),
                               np.where(in_range, dt, dt0), cascades, scale)
        word = (hit.astype(np.uint64) << lane.astype(np.uint64)).sum(axis=1)
        ballots[live, c] = word[live]
        count[live] += hit.sum(axis=1)[live]
        chunks[live] = c + 1
        live = live & ((c + 1) * CHUNK < K) & (t[:, CHUNK - 1] < t2)

    # pass 2: ranks from the ballots, each kept candidate to its slot
    ts = np.full((n, S), np.nan, F32)
    deltas = np.full((n, S), np.nan, F32)
    stores = np.zeros((n, S), np.int64)
    lower = (np.uint64(1) << lane.astype(np.uint64)) - np.uint64(1)
    for i in range(n):
        cnt, running = int(count[i]), 0
        overflow = cnt > S
        for c in range(int(chunks[i])):
            if running >= cnt:
                break
            word = ballots[i, c]
            bits = ((word >> lane.astype(np.uint64)) & np.uint64(1)).astype(bool)
            rank = running + np.array([bin(int(word & m)).count("1")
                                       for m in lower])
            running += bin(int(word)).count("1")
            if overflow:
                jS = rank * S
                f0 = (jS + cnt - 1) // cnt
                f1 = (jS + S + cnt - 1) // cnt
                kept = bits & (f1 > f0) & (f0 < S)
                slot = f0
                rep = np.maximum(np.minimum((f0 + 1) * cnt // S, cnt) - rank, 1)
            else:
                kept, slot, rep = bits & (rank < S), rank, np.ones(CHUNK, np.int64)
            k = c * CHUNK + lane
            if exp_step_factor:
                t = rows[i, k]
                dt = clamp_dt(t * esf, lo, hi)
            else:
                t = fma32(noise[i] + k.astype(F32), dt0, np.full(CHUNK, t1[i], F32))
                dt = np.full(CHUNK, dt0, F32)
            if overflow:
                dt = (dt * rep.astype(F32)).astype(F32)
            ts[i, slot[kept]] = t[kept]
            deltas[i, slot[kept]] = dt[kept]
            stores[i, slot[kept]] += 1
    n_kept = np.minimum(count, S).astype(np.int32)
    valid = np.arange(S)[None, :] < n_kept[:, None]
    # every slot below n_kept stored exactly once, the rest zero-filled
    assert np.array_equal(stores, valid.astype(np.int64))
    ts[~valid] = 0.0
    deltas[~valid] = 0.0
    return ts, deltas, valid, n_kept, count


# --------------------------------------------------------------- the cases
def march_inputs(seed, scale, rows, fill, n=96):
    """Rays inside and outside the cube (an eighth outside, a sixteenth of
    them pointing away: misses), their hits, noise and a grid."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9 * scale, 0.9 * scale, (n, 3)).astype(F32)
    o[: n // 8] = rng.uniform(1.2 * scale, 1.8 * scale, (n // 8, 3))
    d = rng.standard_normal((n, 3)).astype(F32)
    d[: n // 16] = np.abs(d[: n // 16])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    noise = rng.random(n).astype(F32)
    noise[-2:] = 0.0
    grid = rng.random((rows, GS**3)) < fill
    hits = ray_aabb_intersect(torch.from_numpy(o), torch.from_numpy(d),
                              scale).numpy()
    return o, d, hits, noise, grid


def bits(x):
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype == F32 else np.asarray(x)


@pytest.mark.parametrize("S, K", [(256, 1024), (512, 1024), (24, 256), (300, 256)])
@pytest.mark.parametrize("fill", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("lattice", ["constant", "exponential"])
def test_emulated_kernel_and_plain_equal_the_jitted_jax_march(lattice, rows,
                                                              fill, S, K):
    lat = LATTICES[lattice, rows]
    res = min(K, 1024)
    o, d, hits, noise, grid = march_inputs(S + K + rows, lat["scale"], rows, fill)
    kw = dict(cascades=lat["cascades"], grid_size=GS, scale=lat["scale"],
              exp_step_factor=lat["exp_step_factor"], max_samples=S,
              n_candidates=K, march_resolution=res)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    plain = march_select_plain(t(o), t(d), t(hits[:, 0]), t(hits[:, 1]),
                               t(noise), t(grid), **kw)
    plain = [x.numpy() for x in plain]
    emu = emulate_march(o, d, hits[:, 0], hits[:, 1], noise, grid,
                        scale=lat["scale"], cascades=lat["cascades"],
                        exp_step_factor=lat["exp_step_factor"], S=S, K=K,
                        res=res)
    for name, a, b in zip(("ts", "deltas", "valid", "n_kept"), emu, plain):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
    # the wrapper takes the plain version on the CPU
    before = march_select.launches
    got = march_select(t(o), t(d), t(hits[:, 0]), t(hits[:, 1]), t(noise),
                       t(grid), **kw)
    assert march_select.launches == before
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))

    want = jax.jit(lambda *a: j_march(*a, **kw))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(hits), jnp.asarray(grid),
        jnp.asarray(noise))
    for name, a in zip(("ts", "deltas", "valid", "n_samples"), plain):
        np.testing.assert_array_equal(bits(a), bits(np.asarray(getattr(want, name))),
                                      err_msg=name)

    count, n_kept = emu[4], plain[3]
    assert np.all(n_kept[hits[:, 0] < 0] == 0)  # misses
    assert (hits[:, 0] < 0).any()
    if fill == 0.0:
        assert not count.any()
    else:
        assert n_kept.max() > 0
    if fill == 1.0 and S < K:
        assert (count > S).any() and n_kept.max() == S  # overflowing rays
    if S >= K:
        assert np.all(count <= S)


@pytest.mark.parametrize("lattice", ["constant", "exponential"])
def test_emulated_kernel_divides_where_the_scale_is_no_power_of_two(lattice):
    # mip_bound = scale = 0.75 is no power of two: the kernel divides
    kw = dict(cascades=1, grid_size=GS, scale=0.75, max_samples=48,
              n_candidates=512, march_resolution=512,
              exp_step_factor=0.0 if lattice == "constant" else 1 / 256)
    o, d, hits, noise, grid = march_inputs(5, 0.75, 1, 0.5)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    plain = march_select_plain(t(o), t(d), t(hits[:, 0]), t(hits[:, 1]),
                               t(noise), t(grid), **kw)
    emu = emulate_march(o, d, hits[:, 0], hits[:, 1], noise, grid, scale=0.75,
                        cascades=1, exp_step_factor=kw["exp_step_factor"],
                        S=48, K=512, res=512)
    want = jax.jit(lambda *a: j_march(*a, **kw))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(hits), jnp.asarray(grid),
        jnp.asarray(noise))
    for name, a, b in zip(("ts", "deltas", "valid", "n_samples"), emu, plain):
        np.testing.assert_array_equal(bits(a), bits(b.numpy()), err_msg=name)
        np.testing.assert_array_equal(
            bits(b.numpy()), bits(np.asarray(getattr(want, name))), err_msg=name)
    assert plain[3].numpy().max() == 48


def test_ceil_log2_on_bits_matches_frexp():
    special = np.array([0.0, -0.0, 0.5, 1.0, 2.0, 3.0, 0.75, 1.5, 2**-126,
                        2**-127, 2**-149, 3 * 2**-149, 2**-140 * 1.25,
                        np.finfo(F32).max, 1e-3, 1.7320508 / 1024 * 128], F32)
    rng = np.random.default_rng(0)
    rand = np.concatenate([
        rng.uniform(0, 4, 4000), 2.0 ** rng.integers(-149, 127, 2000),
        rng.integers(1, 2**23, 2000).astype(np.uint32).view(F32),  # subnormal
    ]).astype(F32)
    for x in (special, rand):
        want = _ceil_log2(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(ceil_log2_bits(x), want)


def test_power_of_two_reciprocal_equals_the_division():
    # the probe's q = p / mip_bound: a multiply by the exact reciprocal
    # where mip_bound is a power of two, subnormal quotients included
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.uniform(-3, 3, 20000),
                        rng.uniform(-1e-37, 1e-37, 2000)]).astype(F32)
    for e in range(-3, 8):
        mb = F32(2.0**e)
        inv = F32(2.0**-e)
        np.testing.assert_array_equal(bits(p * inv), bits(p / mb))


def test_fma32_is_one_rounding():
    # against exact rational arithmetic on the march's ranges
    from fractions import Fraction

    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, 3000).astype(F32)
    b = rng.uniform(0, 3.5, 3000).astype(F32)
    c = rng.uniform(-1, 1, 3000).astype(F32)
    a[:1000] = (rng.random(1000) + np.arange(1000)).astype(F32)  # noise + k
    b[:1000] = F32(SQRT3 / 1024)
    got = fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        # g is a float32 nearest the exact value
        below = np.nextafter(g, F32(-np.inf))
        above = np.nextafter(g, F32(np.inf))
        dg = abs(Fraction(float(g)) - exact)
        assert dg <= abs(Fraction(float(below)) - exact)
        assert dg <= abs(Fraction(float(above)) - exact)


def _select_args(n=8, S=16, K=64):
    o = torch.zeros((n, 3))
    d = torch.zeros((n, 3))
    d[:, 0] = 1.0
    t = torch.zeros(n)
    grid = torch.ones((1, GS**3), dtype=torch.bool)
    kw = dict(cascades=1, grid_size=GS, scale=0.5, exp_step_factor=0.0,
              max_samples=S, n_candidates=K)
    return [o, d, t, t + 1.0, t.clone(), grid], kw


@pytest.mark.parametrize("bad, err, match", [
    (lambda a, kw: a.__setitem__(0, a[0].double()), TypeError, "float32 rays_o"),
    (lambda a, kw: a.__setitem__(4, a[4].half()), TypeError, "float32 noise"),
    (lambda a, kw: a.__setitem__(5, a[5].to(torch.uint8)), TypeError, "bool occ_grid"),
    (lambda a, kw: a.__setitem__(2, a[2][:, None]), ValueError, "t1 of shape"),
    (lambda a, kw: a.__setitem__(1, a[1][:, :2]), ValueError, "rays_d of shape"),
    (lambda a, kw: a.__setitem__(3, a[3][:5]), ValueError, "t2 of shape"),
    (lambda a, kw: a.__setitem__(5, a[5].reshape(-1)), ValueError, "occ_grid"),
    (lambda a, kw: a.__setitem__(0, a[0].t().contiguous().t()), ValueError,
     "contiguous"),
    (lambda a, kw: kw.update(n_candidates=1025), ValueError, "K <= 1024"),
    (lambda a, kw: kw.update(max_samples=1025), ValueError, "S <= 1024"),
    (lambda a, kw: kw.update(max_samples=0), ValueError, "1 <= S"),
    (lambda a, kw: kw.update(cascades=0), ValueError, "cascades"),
])
def test_march_select_rejects_bad_arguments(bad, err, match):
    args, kw = _select_args()
    bad(args, kw)
    with pytest.raises(err, match=match):
        march_select(*args, **kw)
