"""Parity of the port's ray march and compositing with the JAX package.

March (constant dt, ``exp_step_factor == 0``, and the exponential-step
lattice at two cascades, over a two-row and a one-row grid): the integer and
boolean outputs and the selected ``ts``/``deltas`` must EQUAL the JAX
``march_rays_train`` under ``jax.jit`` (the rounding the trainer runs) on a
random grid, miss rays and overflowing rays included.  The lattice itself
must equal the jitted ``_candidate_lattice``.  Compositing: ``composite_rays`` and ``composite_stream``
against their JAX counterparts within float32 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.ops.composite import composite_rays as j_composite_rays
from virus_nerf_tpu.ops.composite import composite_stream as j_composite_stream
from virus_nerf_tpu.ops.intersection import ray_aabb_intersect as j_intersect
from virus_nerf_tpu.ops.ray_march import _candidate_lattice as j_candidate_lattice
from virus_nerf_tpu.ops.ray_march import march_rays_train as j_march
from virus_nerf_tpu.ops.ray_march import occupancy_lookup as j_occupancy_lookup
from virus_nerf_tpu_torch.ops.composite import composite_rays, composite_stream
from virus_nerf_tpu_torch.ops.intersection import ray_aabb_intersect
from virus_nerf_tpu_torch.ops.common import SQRT3
from virus_nerf_tpu_torch.ops.ray_march import (
    march_lattice,
    march_lattice_plain,
    march_rays_train,
    occupancy_lookup,
)

torch.set_num_threads(1)

GS = 32


def _rays(seed, n=96):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    o[: n // 8] = rng.uniform(0.6, 0.9, (n // 8, 3))  # outside the cube
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 16] = np.abs(d[: n // 16])  # outside, pointing away: misses
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    noise = rng.random(n).astype(np.float32)
    occ = rng.random((1, GS**3)) < 0.3
    return o, d, noise, occ


def test_intersection_matches_jax():
    o, d, _, _ = _rays(0)
    want = np.asarray(j_intersect(jnp.asarray(o), jnp.asarray(d), 0.5))
    got = ray_aabb_intersect(torch.from_numpy(o), torch.from_numpy(d), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.any(want[:, 0] == -1.0)  # misses present


@pytest.mark.parametrize(
    "S, K, occ_share",
    [
        (16, 256, 0.3),  # most rays overflow the per-ray budget
        (64, 256, 0.3),
        (300, 256, 0.3),  # S > K: the layout is wider than the lattice
        (32, 512, 1.0),  # a fresh, fully occupied grid
    ],
)
def test_march_equals_jax(S, K, occ_share):
    o, d, noise, occ = _rays(1)
    if occ_share == 1.0:
        occ[:] = True
    hits = np.asarray(j_intersect(jnp.asarray(o), jnp.asarray(d), 0.5))
    kw = dict(cascades=1, grid_size=GS, scale=0.5, exp_step_factor=0.0,
              max_samples=S, n_candidates=K)
    want = jax.jit(lambda *a: j_march(*a, **kw))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(hits), jnp.asarray(occ),
        jnp.asarray(noise))
    got = march_rays_train(torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(hits), torch.from_numpy(occ),
                           torch.from_numpy(noise), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.n_samples.numpy(),
                                  np.asarray(want.n_samples))
    assert int(got.total_samples) == int(want.total_samples)
    np.testing.assert_array_equal(got.ts.numpy(), np.asarray(want.ts))
    np.testing.assert_array_equal(got.deltas.numpy(), np.asarray(want.deltas))
    # positions o + t * d: XLA's vectorized loop fuses the multiply-add for
    # some elements only, so they differ by up to an ulp of |x| <= ~1
    np.testing.assert_allclose(got.xyzs.numpy(), np.asarray(want.xyzs),
                               rtol=0, atol=1.2e-7)
    n = got.n_samples.numpy()
    assert n.min() == 0 and n.max() > 0  # empty (miss) and sampled rays
    if S < K:
        assert n.max() == S  # rays at the budget


def _lattice_inputs(seed, n=200):
    rng = np.random.default_rng(seed)
    t1 = rng.uniform(-1.0, 2.5, n).astype(np.float32)
    t1[:8] = -1.0  # miss rays
    noise = rng.random(n).astype(np.float32)
    noise[8:12] = 0.0
    return t1, noise


@pytest.mark.parametrize(
    "esf, gs, scale, K, res",
    [
        (1 / 256, 128, 1.0, 1024, 1024),  # the scale-1.0 bench lattice
        (1 / 256, 32, 1.0, 256, 256),
        (0.01, 64, 2.0, 300, 1024),  # K not a multiple of a warp
        (0.003, 16, 0.75, 64, 512),
        (0.05, 8, 4.0, 33, 1024),  # the upper clamp binds early
    ],
)
def test_lattice_equals_jitted_jax(esf, gs, scale, K, res):
    t1, noise = _lattice_inputs(int(esf * 1e4) + gs)
    want_ts, want_dts = jax.jit(
        lambda a, b: j_candidate_lattice(a, esf, gs, scale, b, K, res)
    )(jnp.asarray(t1), jnp.asarray(noise))
    got_ts, got_dts = march_lattice(torch.from_numpy(t1),
                                    torch.from_numpy(noise), esf, gs, scale,
                                    K, res)
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(want_ts))
    np.testing.assert_array_equal(got_dts.numpy(), np.asarray(want_dts))
    # the first step is one rounding: t1 + noise * dt(t1) as an FMA
    dt1 = np.clip(t1 * np.float32(esf), np.float32(SQRT3 / res),
                  np.float32(2 * SQRT3 * scale / gs))
    fma = (t1.astype(np.float64) + noise.astype(np.float64) * dt1).astype(np.float32)
    np.testing.assert_array_equal(got_ts.numpy()[:, 0], fma)
    assert march_lattice.launches == 0  # the CPU takes the plain version


def test_lattice_plain_steps_by_its_dts():
    t1, noise = _lattice_inputs(5, n=16)
    ts, dts = march_lattice_plain(torch.from_numpy(t1), torch.from_numpy(noise),
                                  1 / 256, 128, 1.0, 40)
    np.testing.assert_array_equal((ts[:, :-1] + dts[:, :-1]).numpy(),
                                  ts[:, 1:].numpy())
    assert float(dts.min()) >= np.float32(SQRT3 / 1024)
    assert float(dts.max()) <= np.float32(2 * SQRT3 / 128)


def test_lattice_rejects_bad_arguments():
    t = torch.zeros(4)
    with pytest.raises(TypeError):
        march_lattice(t.double(), t.double(), 1 / 256, 32, 1.0, 8)
    with pytest.raises(ValueError):
        march_lattice(t, torch.zeros(5), 1 / 256, 32, 1.0, 8)


def _scale1_rays(seed, n=96):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[: n // 8] = rng.uniform(1.1, 1.6, (n // 8, 3))  # outside the cube
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 16] = np.abs(d[: n // 16])  # outside, pointing away: misses
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rng.random(n).astype(np.float32)


def _march_both(o, d, noise, occ, **kw):
    hits = np.asarray(j_intersect(jnp.asarray(o), jnp.asarray(d), kw["scale"]))
    want = jax.jit(lambda *a: j_march(*a, **kw))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(hits), jnp.asarray(occ),
        jnp.asarray(noise))
    got = march_rays_train(torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(hits), torch.from_numpy(occ),
                           torch.from_numpy(noise), **kw)
    return got, want


def _assert_march_equal(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.n_samples.numpy(),
                                  np.asarray(want.n_samples))
    assert int(got.total_samples) == int(want.total_samples)
    np.testing.assert_array_equal(got.ts.numpy(), np.asarray(want.ts))
    np.testing.assert_array_equal(got.deltas.numpy(), np.asarray(want.deltas))
    np.testing.assert_allclose(got.xyzs.numpy(), np.asarray(want.xyzs),
                               rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("rows", [2, 1])  # the NGP grid's two cascades; VIRUS
@pytest.mark.parametrize("S, K", [(24, 256), (300, 256), (64, 1024)])
def test_exponential_march_equals_jax(rows, S, K):
    # cascades 2 at scale 1.0 with exp_step_factor 1/256, as every scene of
    # scale > 0.5 marches; JAX takes its exact probe (_exact) here
    o, d, noise = _scale1_rays(rows * 10 + S)
    occ = np.random.default_rng(S).random((rows, GS**3)) < 0.3
    kw = dict(cascades=2, grid_size=GS, scale=1.0, exp_step_factor=1 / 256,
              max_samples=S, n_candidates=K, march_resolution=min(K, 1024))
    got, want = _march_both(o, d, noise, occ, **kw)
    _assert_march_equal(got, want)
    n = got.n_samples.numpy()
    assert n.min() == 0 and n.max() > 0
    deltas = got.deltas.numpy()[got.valid.numpy()]
    if K == 1024:  # sqrt3 / 1024 < t / 256 past t = 0.43: the step grows
        assert len(np.unique(deltas)) > 10
    if S < K:
        # overflowing rays: their deltas are lattice steps scaled by the
        # number of candidates each slot represents
        assert n.max() == S
        _, dts = march_lattice_plain(torch.zeros(1), torch.zeros(1), 1 / 256,
                                     GS, 1.0, K, min(K, 1024))
        assert np.setdiff1d(deltas, dts.numpy()).size > 0


def test_one_row_grid_reads_the_last_cell_past_its_end():
    # the VIRUS grid is one cascade; a mip-1 probe of a 2-cascade march
    # indexes past its end, and both sides read the last cell (XLA clamps
    # the gather index, the port clamps it likewise).  Only the last cell
    # occupied: every ray, the one going -x too, gets all its samples, each
    # at t > 0.5, where mip 1 starts
    o = np.zeros((4, 3), np.float32)
    d = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0.6, 0.0, 0.8]], np.float32)
    occ = np.zeros((1, GS**3), bool)
    occ[0, -1] = True
    noise = np.full(4, 0.5, np.float32)
    kw = dict(cascades=2, grid_size=GS, scale=1.0, exp_step_factor=1 / 256,
              max_samples=64, n_candidates=1024)
    got, want = _march_both(o, d, noise, occ, **kw)
    _assert_march_equal(got, want)
    np.testing.assert_array_equal(got.n_samples.numpy(), [64, 64, 64, 64])
    assert float(got.ts.min()) > 0.5


def test_occupancy_lookup_clamps_like_xla():
    occ = torch.zeros((1, 8**3), dtype=torch.bool)
    occ[0, -1] = True
    x = torch.tensor([0.9, -0.9, 0.1])
    dt = torch.full((3,), 0.001)
    got = occupancy_lookup(occ, x, x * 0, x * 0, dt, 2, 8, 1.0)
    want = j_occupancy_lookup(jnp.asarray(occ.numpy()), jnp.asarray(x.numpy()),
                              jnp.zeros(3), jnp.zeros(3), jnp.asarray(dt.numpy()),
                              2, 8, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [True, True, False])


def _comp_inputs(seed, n=24, S=40):
    rng = np.random.default_rng(seed)
    sig = (rng.random((n, S)) * 30).astype(np.float32)
    rgb = rng.random((n, S, 3)).astype(np.float32)
    dt = np.full((n, S), 1.7320508075688772 / 1024, np.float32)
    dt *= rng.integers(1, 4, (n, S))  # represented-count scaling
    ts = np.cumsum(dt, axis=1).astype(np.float32)
    counts = rng.integers(0, S + 1, n)
    counts[0], counts[1] = 0, S
    valid = np.arange(S)[None, :] < counts[:, None]
    return sig, rgb, dt, ts, valid, counts


def test_composite_rays_matches_jax():
    sig, rgb, dt, ts, valid, _ = _comp_inputs(3)
    sig[:4] *= 50  # opaque rays: early termination engages
    want = jax.jit(j_composite_rays)(
        *(jnp.asarray(x) for x in (sig, rgb, dt, ts, valid)))
    got = composite_rays(*(torch.from_numpy(x) for x in (sig, rgb, dt, ts, valid)))
    # float32 transmittance products: a few ulps of values <= ~0.1
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(got.vr_samples.numpy(),
                                  np.asarray(want.vr_samples))
    assert np.any(np.asarray(want.vr_samples) < valid.sum(1))


def test_composite_stream_matches_jax():
    sig, rgb, dt, ts, valid, counts = _comp_inputs(4)
    n, S = sig.shape
    # the valid-first ray-major stream, plus an invalid tail
    B = int(counts.sum()) + 17
    m = valid.reshape(-1)
    pad = lambda x: np.concatenate([x.reshape((n * S,) + x.shape[2:])[m],
                                    np.zeros((17,) + x.shape[2:], x.dtype)])
    ray_id = np.concatenate([np.repeat(np.arange(n), counts),
                             np.arange(17) % n]).astype(np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    sv = np.arange(B) < counts.sum()
    args = (pad(sig), pad(rgb), pad(dt), pad(ts), sv, ray_id,
            np.minimum(starts, B - 1), counts.astype(np.int32))
    want = jax.jit(j_composite_stream)(*(jnp.asarray(x) for x in args))
    got = composite_stream(*(torch.from_numpy(x) for x in args), max_count=S)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=2e-6)
    assert int(got[3]) == int(want[3])
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-5, atol=2e-6)
