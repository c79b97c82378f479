"""Parity of the port's Morton codes, bitfields, NGP grid and VIRUS grid
bitfield refresh with the JAX package, on the same numpy inputs.

Integers and booleans must be EQUAL: Morton codes, bitfields, the grids'
boolean layouts.  The NGP update gets the JAX key's own draws
(``ngp_grid.py:86-104``) and the same model weights; its densities are
float32 model outputs, held to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.grids import base as jbase
from virus_nerf_tpu.grids import ngp_grid as jngp
from virus_nerf_tpu.grids import occupancy_grid as jog
from virus_nerf_tpu.models.ngp import NGPModel as JModel
from virus_nerf_tpu.ops import morton as jmorton
from virus_nerf_tpu_torch.convert import (
    grid_from_jax,
    ngp_grid_from_jax,
    params_from_jax,
)
from virus_nerf_tpu_torch.grids import base, ngp_grid
from virus_nerf_tpu_torch.grids import occupancy_grid as tog
from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.ops import morton

torch.set_num_threads(1)

THRESH = 0.01 * 1024 / 3**0.5  # the trainers' NGP density threshold


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("hi", [4, 32, 1024])
def test_morton_codes_and_inverse_match_jax(hi):
    coords = np.random.default_rng(hi).integers(0, hi, (500, 3)).astype(np.int32)
    coords[0] = hi - 1
    want = _np(jmorton.morton3d(jnp.asarray(coords)))
    got = morton.morton3d(torch.from_numpy(coords))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = morton.morton3d_invert(got)
    np.testing.assert_array_equal(back.numpy(),
                                  _np(jmorton.morton3d_invert(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), coords)


def test_packbits_round_trip_matches_jax():
    g = np.random.default_rng(1).random(8 * 77).astype(np.float32)
    want = _np(jmorton.packbits(jnp.asarray(g), 0.4))
    got = morton.packbits(torch.from_numpy(g), 0.4)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(morton.unpackbits(got).numpy(),
                                  _np(jmorton.unpackbits(jnp.asarray(want))))
    np.testing.assert_array_equal(morton.unpackbits(got).numpy(), g > 0.4)


@pytest.mark.parametrize("gs, cascades", [(8, 1), (16, 2), (32, 1)])
def test_bitfield_round_trip_matches_jax(gs, cascades):
    grid = np.random.default_rng(gs).random((cascades, gs**3)).astype(np.float32)
    m = base.cartesian_to_morton(torch.from_numpy(grid), gs)
    np.testing.assert_array_equal(
        m.numpy(), _np(jbase.cartesian_to_morton(jnp.asarray(grid), gs)))
    np.testing.assert_array_equal(base.morton_to_cartesian(m, gs).numpy(), grid)
    bf = base.bitfield_from_grid(torch.from_numpy(grid), 0.7, gs)
    want = _np(jbase.bitfield_from_grid(jnp.asarray(grid), 0.7, gs))
    assert bf.shape == (cascades * gs**3 // 8,)
    np.testing.assert_array_equal(bf.numpy(), want)
    back = base.grid_from_bitfield(bf, cascades, gs)
    np.testing.assert_array_equal(
        back.numpy(), _np(jbase.grid_from_bitfield(jnp.asarray(want), cascades, gs)))
    np.testing.assert_array_equal(back.numpy(), grid > 0.7)
    np.testing.assert_array_equal(
        base.occ_bool_from_grid(torch.from_numpy(grid), 0.7).numpy(), grid > 0.7)


@pytest.mark.parametrize("cascade", [0, 1, 2])
def test_cell_centers_match_jax(cascade):
    got = base.cell_centers(16, 1.0, cascade, device="cpu")
    np.testing.assert_array_equal(got.numpy(), _np(jbase.cell_centers(16, 1.0, cascade)))


def test_occ_grid_refresh_bitfield_matches_jax():
    hp_kw = dict(grid_size=16, scale=0.5)
    js = jog.occ_grid_init(jax.random.PRNGKey(3), jog.OccGridHParams(**hp_kw))
    ps = grid_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    # the init's grid, then a grid moved away from it
    g = np.random.default_rng(4).random((16, 16, 16)).astype(np.float32)
    moved = (js._replace(occ_3d_grid=jnp.asarray(g)),
             ps._replace(occ_3d_grid=torch.from_numpy(g)))
    got = []
    for jst, pst in ((js, ps), moved):
        want = _np(jog.occ_grid_refresh_bitfield(
            jst, jog.OccGridHParams(**hp_kw)).bitfield)
        got.append(tog.occ_grid_refresh_bitfield(pst, tog.OccGridHParams(**hp_kw)))
        assert got[-1].dtype == torch.uint8
        np.testing.assert_array_equal(got[-1].numpy(), want)
    assert not torch.equal(got[0], got[1])


MODEL_KW = dict(levels=4, feature_per_level=2, log2_T=12, base_res=8,
                max_res=64)


def _models(gs, scale, seed=0):
    jm = JModel(scale=scale, hash_variant="additive", grid_size=gs, **MODEL_KW)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = NGPModel(scale=scale, grid_size=gs, **MODEL_KW)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       device="cpu"))
    return jm, params, tm


def _jax_draws(grid, key, warmup, gs):
    """The draws ngp_grid_update makes from its key (ngp_grid.py:86-104)."""
    n = gs**3
    draws = []
    for c in range(grid.shape[0]):
        key, k_uni, k_occ, k_jit = jax.random.split(key, 4)
        if warmup:
            idx = jnp.arange(n, dtype=jnp.int32)
        else:
            m = n // 4
            idx_uni = jax.random.randint(k_uni, (m,), 0, n, jnp.int32)
            logits = jnp.where(grid[c] > THRESH, 0.0, -1e9)
            idx_occ = jax.random.categorical(k_occ, logits, shape=(m,))
            idx = jnp.concatenate([idx_uni, idx_occ.astype(jnp.int32)])
        jit = jax.random.uniform(k_jit, (idx.shape[0], 3)) * 2.0 - 1.0
        draws.append((torch.from_numpy(np.array(idx)).long(),
                      torch.from_numpy(np.array(jit))))
    return draws


def _update_both(js, ps, jm, params, tm, key, warmup, gs, scale):
    kw = dict(density_threshold=THRESH, grid_size=gs, scale=scale)
    jnew = jax.jit(lambda s, k: jngp.ngp_grid_update(
        s, lambda x: jm.density(params, x), k, warmup=warmup,
        cascades=jm.cascades, **kw))(js, key)
    with torch.no_grad():
        pnew = ngp_grid.ngp_grid_update_on(
            ps, tm.density, _jax_draws(js.density_grid, key, warmup, gs), **kw)
    return jnew, pnew


def _assert_grid_equal(pnew, jnew, gs):
    j = jax.tree.map(np.asarray, jnew)
    # float32 model outputs in another op order
    np.testing.assert_allclose(pnew.density_grid.numpy(), j.density_grid,
                               rtol=1e-5, atol=0)
    # the adaptive threshold is a float32 mean over every positive cell,
    # summed in another order on each side (a few ulps apart)
    np.testing.assert_allclose(float(pnew.threshold), float(j.threshold),
                               rtol=1e-6)
    # the boolean grid: equal wherever the cell is not within rounding of
    # the threshold, where the summation order decides (one cell of 65,536
    # in the 32^3 case, its density equal to the JAX threshold)
    off = pnew.occ_bool.numpy() != j.occ_bool
    near = np.abs(j.density_grid - j.threshold) <= 1e-5 * j.threshold
    assert np.all(near[off]) and off.mean() <= 1e-4, off.sum()
    # the port's refreshed bitfield packs its own boolean grid, bit for bit
    np.testing.assert_array_equal(
        base.grid_from_bitfield(
            ngp_grid.ngp_grid_refresh_bitfield(pnew, gs).bitfield,
            pnew.occ_bool.shape[0], gs).numpy(),
        pnew.occ_bool.numpy())
    # on the same density grid and threshold, the boolean grid and the
    # Morton bitfield EQUAL the JAX package's
    same = ngp_grid_from_jax(j, device="cpu")
    np.testing.assert_array_equal(
        base.occ_bool_from_grid(same.density_grid, same.threshold).numpy(),
        j.occ_bool)
    np.testing.assert_array_equal(
        ngp_grid.ngp_grid_refresh_bitfield(same, gs).bitfield.numpy(),
        _np(jngp.ngp_grid_refresh_bitfield(jnew, gs).bitfield))
    np.testing.assert_array_equal(
        ngp_grid.ngp_grid_refresh_bitfield(same, gs).bitfield.numpy(), j.bitfield)


@pytest.mark.parametrize("gs, scale", [(16, 1.0), (16, 0.5), (32, 1.0)])
def test_ngp_update_warmup_then_steady_matches_jax(gs, scale):
    jm, params, tm = _models(gs, scale)
    js = jngp.ngp_grid_init(jm.cascades, gs)
    ps = ngp_grid.ngp_grid_init(tm.cascades, gs, device="cpu")
    assert tm.cascades == jm.cascades == (2 if scale == 1.0 else 1)
    np.testing.assert_array_equal(ps.bitfield.numpy(), _np(js.bitfield))
    key = jax.random.PRNGKey(gs)
    for step, warmup in enumerate((True, False, False)):
        key, k = jax.random.split(key)
        js, ps = _update_both(js, ps, jm, params, tm, k, warmup, gs, scale)
        _assert_grid_equal(ps, js, gs)
        ps = ngp_grid_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    occ = ps.occ_bool.float().mean()
    assert 0 < occ < 1  # the adaptive threshold split the cells


def test_ngp_update_keeps_invisible_cells_pinned():
    gs, scale = 16, 1.0
    jm, params, tm = _models(gs, scale, seed=1)
    js = jngp.ngp_grid_init(jm.cascades, gs)
    g = np.zeros((2, gs**3), np.float32)
    g[:, ::7] = -1.0
    js = js._replace(density_grid=jnp.asarray(g))
    ps = ngp_grid_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for warmup in (True, False):
        jnew, pnew = _update_both(js, ps, jm, params, tm, jax.random.PRNGKey(9),
                                  warmup, gs, scale)
        _assert_grid_equal(pnew, jnew, gs)
        assert np.all(pnew.density_grid.numpy()[:, ::7] == -1.0)


def test_ngp_draws_fall_back_to_uniform_while_nothing_is_occupied():
    gs = 16
    st = ngp_grid.ngp_grid_init(2, gs, device="cpu")
    gen = torch.Generator().manual_seed(0)
    draws = ngp_grid.ngp_cell_draws(st, gen, warmup=False,
                                    density_threshold=THRESH, grid_size=gs)
    assert [d[0].shape[0] for d in draws] == [gs**3 // 2] * 2
    occ_half = draws[0][0][gs**3 // 4:]
    assert occ_half.min() >= 0 and occ_half.max() < gs**3
    assert len(torch.unique(occ_half)) > gs**3 // 8  # spread, not one cell
    # with cells occupied, the second half lands only on them
    g = torch.zeros((2, gs**3))
    g[0, 100:110] = 10.0
    draws = ngp_grid.ngp_cell_draws(st._replace(density_grid=g), gen,
                                    warmup=False, density_threshold=THRESH,
                                    grid_size=gs)
    occ_half = draws[0][0][gs**3 // 4:]
    assert set(occ_half.tolist()) == set(range(100, 110))
    assert torch.all(draws[0][1].abs() <= 1.0)


def test_ngp_update_leaves_the_bitfield_stale_until_refreshed():
    gs = 16
    jm, params, tm = _models(gs, 1.0, seed=2)
    g = torch.zeros((2, gs**3))
    g[:, ::3] = 10.0
    st = ngp_grid.ngp_grid_init(2, gs, device="cpu")._replace(density_grid=g)
    draws = ngp_grid.ngp_cell_draws(st, torch.Generator().manual_seed(5),
                                    warmup=False, density_threshold=THRESH,
                                    grid_size=gs)
    with torch.no_grad():
        new = ngp_grid.ngp_grid_update_on(st, tm.density, draws,
                                          density_threshold=THRESH,
                                          grid_size=gs, scale=1.0)
    assert torch.equal(new.bitfield, st.bitfield)
    fresh = ngp_grid.ngp_grid_refresh_bitfield(new, gs)
    assert new.occ_bool.any() and not torch.equal(fresh.bitfield, st.bitfield)
    np.testing.assert_array_equal(
        base.grid_from_bitfield(fresh.bitfield, 2, gs).numpy(),
        new.occ_bool.numpy())
    # the refresh leaves every other field as it was
    for a, b in zip(fresh[:2] + fresh[3:], new[:2] + new[3:]):
        assert torch.equal(a, b)


def test_mark_invisible_cells_matches_jax():
    gs = 16
    K = np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(2)
    poses = []
    for _ in range(3):
        a = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        t = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    poses = np.stack(poses).astype(np.float32)
    js = jngp.ngp_grid_init(2, gs)
    want = jngp.mark_invisible_cells(js, jnp.asarray(K), jnp.asarray(poses),
                                     (32, 24), cascades=2, grid_size=gs,
                                     scale=1.0)
    got = ngp_grid.mark_invisible_cells(
        ngp_grid.ngp_grid_init(2, gs, device="cpu"), torch.from_numpy(K),
        torch.from_numpy(poses), (32, 24), cascades=2, grid_size=gs, scale=1.0)
    np.testing.assert_array_equal(got.density_grid.numpy(), _np(want.density_grid))
    share = float((got.density_grid == -1).float().mean())
    assert 0 < share < 1
