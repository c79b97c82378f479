"""Parity of the port's fused Adam (virus_nerf_tpu_torch/ops/fused_adam.py)
with the JAX package: the leaf formula against ``_adam_leaf_jnp``, the
device-formed ``scal`` against JAX's at every count 1..2000, and three
optimizer steps against ``fused_adam(lr, eps=1e-15)`` on a small pytree.

The CUDA kernel (csrc/fused_adam.cu) updates every leaf of a group in one
launch; its index map is emulated here in numpy: ``adam_leaf_plan`` splits
each leaf into a scalar head, a body of ``ADAM_CHUNK``-element chunks (16-
byte vectors where the four arrays share their phase) and a scalar tail,
the chunk counts' prefix gives CTA c its (leaf, chunk), one CTA per
chunk, and every element of every leaf must be updated exactly once,
every vector aligned.  The kernel itself is
compared with the plain version on the card in test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from virus_nerf_tpu.ops.fused_adam import _adam_leaf_jnp, fused_adam
from virus_nerf_tpu_torch.ops.fused_adam import (
    ADAM_CHUNK,
    ADAM_MAX_LEAVES,
    FusedAdam,
    adam_hyper,
    adam_leaf_plan,
    adam_scal,
    adam_update_,
    adam_update_leaves_,
    adam_update_plain_,
)

torch.set_num_threads(1)


def _scal(count, lr=1e-2, b1=0.9, b2=0.999):
    """The port's (3,) scal at a step count, on the CPU."""
    return adam_scal(torch.tensor(count, dtype=torch.int32),
                     adam_hyper(lr, b1, b2, "cpu"))


def _jax_scal(count, lr=1e-2, b1=0.9, b2=0.999):
    """JAX's scal (fused_adam.py:123-131) at a step count, jitted as the
    optimizer's update runs it."""
    @jax.jit
    def scal(c):
        t = c.astype(jnp.float32)
        return jnp.stack([jnp.float32(lr), 1.0 - jnp.float32(b1) ** t,
                          1.0 - jnp.float32(b2) ** t])
    return np.asarray(jax.vmap(scal)(jnp.asarray(count, jnp.int32)))


def _leaf(n, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    mu = (rng.standard_normal(n) * 0.1).astype(np.float32)
    nu = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    return p, g, mu, nu


@pytest.mark.parametrize("count", [1, 7])
def test_leaf_matches_adam_leaf_jnp(count):
    p, g, mu, nu = _leaf(1 << 14)
    scal_t = _scal(count)
    scal = jnp.asarray(scal_t.numpy())
    d, mu_j, nu_j = jax.jit(_adam_leaf_jnp, static_argnums=(4, 5, 6))(
        jnp.asarray(g), jnp.asarray(mu), jnp.asarray(nu), scal, 0.9, 0.999,
        1e-15,
    )
    tp, tmu, tnu = (torch.from_numpy(x.copy()) for x in (p, mu, nu))
    adam_update_(tp, torch.from_numpy(g), tmu, tnu, scal_t, 0.9, 0.999, 1e-15)
    # the bench's on-chip gate for this kernel (bench.py:265-278): 1e-6
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tnu.numpy(), np.asarray(nu_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), p + np.asarray(d), rtol=0, atol=1e-6)


def test_scalars_match_jax_step_scalars():
    for count in (1, 2, 100):
        t = jnp.float32(count)
        want = [1e-2, 1.0 - jnp.float32(0.9) ** t, 1.0 - jnp.float32(0.999) ** t]
        got = _scal(count).numpy()
        # float32 pow on two backends: within 2 ulp of 1
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("b1, b2", [(0.9, 0.999), (0.8, 0.99)])
def test_device_scal_matches_jax_scal_at_every_count(b1, b2):
    # the count the kernel reads scal at is an int32 tensor: every count of
    # a 2000-step run, formed as a step forms it (count + 1 in place)
    counts = np.arange(1, 2001)
    want = _jax_scal(counts, b1=b1, b2=b2)
    hyper = adam_hyper(1e-2, b1, b2, "cpu")
    count = torch.zeros((), dtype=torch.int32)
    got = []
    for _ in counts:
        count.add_(1)
        got.append(adam_scal(count, hyper).numpy())
    got = np.stack(got)
    assert got.dtype == np.float32 and got.shape == want.shape
    # bit for bit: lr, and both bias corrections at every count
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _tree(rng):
    return {
        "table": rng.random((300, 4)).astype(np.float32),
        "w0": rng.standard_normal((12, 8)).astype(np.float32),
        "w1": rng.standard_normal((8, 3)).astype(np.float32),
    }


def test_three_steps_match_optax_fused_adam():
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    # on the CPU every leaf takes the plain formula on both sides
    opt = fused_adam(5e-3, eps=1e-15)
    state = opt.init(jax.tree.map(jnp.asarray, params))
    jp = jax.tree.map(jnp.asarray, params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = FusedAdam(list(tparams.values()), lr=5e-3, eps=1e-15)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state)
        jp = optax.apply_updates(jp, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    assert topt.count.dtype == torch.int32
    assert topt.count == int(state.count) == 3
    for k, p in tparams.items():
        # eps = 1e-15 makes step 1 a sign step of size lr, so a float32
        # difference of one ulp in a moment moves p by ~1e-8 at most here
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
        st = topt.state[p]
        np.testing.assert_allclose(st["mu"].numpy(), np.asarray(state.mu[k]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(st["nu"].numpy(), np.asarray(state.nu[k]),
                                   rtol=0, atol=1e-6)


def test_cpu_tensor_takes_plain_version_without_counting():
    p, g, mu, nu = _leaf(4096, seed=1)
    args = (_scal(3), 0.9, 0.999, 1e-15)
    a = [torch.from_numpy(x.copy()) for x in (p, mu, nu)]
    b = [torch.from_numpy(x.copy()) for x in (p, mu, nu)]
    before = adam_update_leaves_.launches
    adam_update_(a[0], torch.from_numpy(g), a[1], a[2], *args)
    adam_update_plain_(b[0], torch.from_numpy(g), b[1], b[2], *args)
    assert adam_update_leaves_.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrapper_rejects_float64():
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError):
        adam_update_(x, x, x, x, _scal(1), 0.9, 0.999, 1e-15)


def test_leaves_on_cpu_take_plain_version_leaf_by_leaf():
    # a bf16 p among float32 ones; the CPU never counts a launch
    rng = np.random.default_rng(4)
    args = (_scal(2), 0.9, 0.999, 1e-15)
    leaves, want = [], []
    for n, dtype in ((1, torch.float32), (1023, torch.bfloat16), (4096, torch.float32)):
        p = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        mu = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
        nu = torch.from_numpy((rng.random(n) * 0.01).astype(np.float32))
        leaves.append((p.clone(), g, mu.clone(), nu.clone()))
        want.append((p.clone(), g, mu.clone(), nu.clone()))
    before = adam_update_leaves_.launches
    adam_update_leaves_(leaves, *args)
    for p, g, mu, nu in want:
        adam_update_plain_(p, g, mu, nu, *args)
    assert adam_update_leaves_.launches == before
    for got, exp in zip(leaves, want):
        for x, y in zip(got, exp):
            assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------- the kernel's index map, emulated
def _emulate_launch(leaves):
    """The kernel's CTAs over one launch's leaves, each (addresses of p,
    g, mu, nu; n; bf16 p).  Returns how often each element of each leaf is
    updated; asserts that every vector access is aligned and that heads
    and tails are scalar remainders."""
    plans = [adam_leaf_plan(*addrs, n, bf16) for addrs, n, bf16 in leaves]
    chunks = [0 if n == 0 else max(1, -(-body // ADAM_CHUNK))
              for (_, n, _), (_, body, _) in zip(leaves, plans)]
    first = np.concatenate([[0], np.cumsum(chunks)])
    hits = [np.zeros(n, np.int64) for _, n, _ in leaves]
    for c in range(int(first[-1])):  # CTA c takes chunk c
        lv = 0
        while c >= first[lv + 1]:
            lv += 1
        (p, g, mu, nu), n, bf16 = leaves[lv]
        head, body, vec = plans[lv]
        j = c - first[lv]
        begin, stop = head + j * ADAM_CHUNK, head + body
        end = min(begin + ADAM_CHUNK, stop)
        if vec:  # quads at begin, begin + 4, ...: one per (thread, vector)
            idx = np.arange(begin, end, 4)
            assert (end - begin) % 4 == 0
            for addr in (g, mu, nu):
                assert np.all((addr + 4 * idx) % 16 == 0)
            assert np.all((p + (2 if bf16 else 4) * idx) % (8 if bf16 else 16) == 0)
            np.add.at(hits[lv], (idx[:, None] + np.arange(4)).ravel(), 1)
        else:
            hits[lv][begin:end] += 1
        if j == 0:  # the scalar head and tail, by the first chunk
            assert head < 4 and (n - stop < 4 or not vec)
            hits[lv][:head] += 1
            hits[lv][stop:] += 1
    return hits


def _addresses(n, bf16, phase=0, skew=0):
    """Addresses of p, g, mu, nu as separate allocations (256-byte aligned)
    viewed from element ``phase``; ``skew`` moves mu by one element more."""
    base = [1 << 20, 1 << 24, 1 << 28, 1 << 30]
    size = (2 if bf16 else 4, 4, 4, 4)
    return tuple(b + s * (phase + (skew if i == 2 else 0))
                 for i, (b, s) in enumerate(zip(base, size)))


@pytest.mark.parametrize("start", [0, 8])
def test_multi_leaf_map_covers_every_element_once(start):
    # lengths 1, 3, 4, 1023 and 2^20 + 5; a misaligned start (phase 1 and
    # 3), arrays out of phase with each other (scalar chunks), a bf16 p
    # among float32 ones, and an empty leaf
    leaves = [
        (_addresses(1, False), 1, False),
        (_addresses(3, True), 3, True),
        (_addresses(4, False), 4, False),
        (_addresses(1023, False, phase=1), 1023, False),
        (_addresses((1 << 20) + 5, True, phase=1), (1 << 20) + 5, True),
        (_addresses(0, False), 0, False),
        (_addresses(5000, False, phase=3), 5000, False),
        (_addresses(4099, False, skew=1), 4099, False),
        (_addresses(2 * ADAM_CHUNK + 3, True, phase=2), 2 * ADAM_CHUNK + 3, True),
    ]
    leaves = leaves[start:] + leaves[:start]  # another leaf order
    assert len(leaves) <= ADAM_MAX_LEAVES
    for hits in _emulate_launch(leaves):
        assert np.all(hits == 1)


@pytest.mark.parametrize("n, bf16, phase, skew, want", [
    (1, False, 0, 0, (0, 0, True)),
    (3, False, 0, 0, (0, 0, True)),
    (4, False, 0, 0, (0, 4, True)),
    (1023, False, 1, 0, (3, 1020, True)),
    (1023, True, 3, 0, (1, 1020, True)),
    (2, False, 3, 0, (1, 0, True)),
    ((1 << 20) + 5, False, 0, 0, (0, 1 << 20 | 4, True)),
    (4099, False, 0, 1, (0, 4099, False)),
])
def test_leaf_plan_splits_head_body_tail(n, bf16, phase, skew, want):
    assert adam_leaf_plan(*_addresses(n, bf16, phase, skew), n, bf16) == want


def test_fused_adam_cpu_step_takes_every_leaf():
    # on the CPU, FusedAdam updates every leaf with a gradient through the
    # plain version, small leaves and bf16 ones included
    rng = np.random.default_rng(6)
    ps = [torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
          for s in ((7, 3), (64,), (5,))]
    ps[1] = torch.nn.Parameter(ps[1].detach().to(torch.bfloat16))
    before = [p.detach().clone() for p in ps]
    opt = FusedAdam(ps, lr=1e-2, eps=1e-15)
    for p in ps[:2]:
        p.grad = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)).to(p.dtype)
    opt.step()
    assert not torch.equal(ps[0], before[0]) and not torch.equal(ps[1], before[1])
    assert torch.equal(ps[2], before[2])  # no gradient: untouched
    assert ps[1].dtype == torch.bfloat16 and opt.state[ps[1]]["mu"].dtype == torch.float32
