"""The port's training chunk (``Trainer.make_train_chunk``), the
counterpart of the JAX trainer's one-dispatch chunk (``_make_train_chunk``
/ ``_make_chunk_body``, virus_nerf_tpu/training/trainer.py:428-519).

On the card a chunk is replays of CUDA graphs of its pieces (a group: the
grid update, then ``update_interval`` steps; one step; one grid update); on
the CPU the same piece bodies run eagerly.  Here, on the CPU:

- the bodies against ``run_steps`` (the step-by-step loop), bit for bit:
  losses and every metric, parameters, Adam moments and count, grid, USS
  statistics and the generator's state, on a small bench-like
  configuration (16 steps, grid updates at 0 and 8) entered aligned, at
  step 3, in chunks shorter than the interval, past the NGP warm-up, with
  "closest" sampling and under real-time simulation;
- every state tensor keeps its address across a chunk (a replay reads
  what the last one wrote);
- the JAX chunk run twice against the port's chunks fed the JAX chunk's
  draws in the chunk's order (the key splits of
  ``tests/test_torch_trainer_options.py``'s ``Pair``), losses per step
  within 1e-5, with and without C8's witness (the table entries one
  side's Adam step moved and the other's did not, set equal after each
  step);
- the converted JAX state owns its tensors: a chunk writes its state in
  place, and a tensor that aliased a JAX buffer wrote into the JAX state
  the reference still read (the witness case above differed from run to
  run by up to 1 % when JAX's asynchronous grid update read the port's);
- the loss weights read from device memory give the host floats' losses
  and states bit for bit; the trainer's graph set holds one state and
  its generators (a state set in place to another seed keeps it);
- the chunk refuses a configuration whose sample counts its float32
  metrics cannot hold exactly.
"""

import gc
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from test_torch_trainer_options import (
    DATA_KW,
    Pair,
    _port_batch,
    _sync_stepped_apart,
    options_config,
)
from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset
from virus_nerf_tpu.training import Trainer as JTrainer
from virus_nerf_tpu_torch import convert
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.training import trainer as trainer_module
from virus_nerf_tpu_torch.training.trainer import Trainer, _state_tensors

torch.set_num_threads(1)


def chunk_config(grid="occ", closest=False, real_time=False):
    """Bench-like at a small size: constant-dt march with a sample budget,
    the USS/ToF pixel shares, the VIRUS grid updated every 8 steps (at 0
    and 8 of 16); the NGP grid every 4 after a 4-step warm-up."""
    cfg = options_config(scale=0.5, grid=grid, budget=128 * 12,
                         closest=closest, real_time=real_time)
    cfg.occ_grid.update_interval = 8
    cfg.training.max_steps = 16
    cfg.evaluation.eval_every_n_steps = 8
    return cfg


@pytest.fixture(scope="module")
def pdata():
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    return ds, scene


def _metrics(pending, keys):
    return torch.stack([torch.stack([m[k].float() for k in keys])
                        for _, m in pending])


def assert_states_equal(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        for x, y in zip(a.optimizer._moments(p), b.optimizer._moments(q)):
            assert torch.equal(x, y), name
    assert a.optimizer.count.dtype == torch.int32
    assert int(a.optimizer.count) == int(b.optimizer.count) == a.step == b.step
    for f, x, y in zip(a.grid._fields, a.grid, b.grid):
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), f
    assert (a.uss_stats is None) == (b.uss_stats is None)
    if a.uss_stats is not None:
        for f, x, y in zip(a.uss_stats._fields, a.uss_stats, b.uss_stats):
            assert torch.equal(x, y), f
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# entry: steps run step by step first; then the chunks' sizes
ENTRIES = {
    "aligned": (0, (8, 8)),
    "unaligned_at_3": (3, (13,)),
    "shorter_than_the_interval": (0, (5, 11)),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_chunk_bodies_are_run_steps_bit_for_bit(pdata, entry):
    pre, sizes = ENTRIES[entry]
    tr = Trainer(chunk_config(), *pdata[:1], scene=pdata[1], device="cpu")
    want, got = tr.init_state(0), tr.init_state(0)
    tr.run_steps(want, pre)
    tr.run_steps(got, pre)
    pending = tr.run_steps(want, sum(sizes))
    keys, rows = None, []
    for n in sizes:
        first, keys, m = tr.make_train_chunk(n)(got)
        assert first == pre + sum(r.shape[0] for r in rows)
        assert m.shape == (n, len(keys))
        rows.append(m)
    assert torch.equal(torch.cat(rows), _metrics(pending, keys))
    assert want.grid.update_step == 2
    assert_states_equal(got, want)


@pytest.mark.parametrize("case", ["ngp_after_warm_up", "closest", "real_time"])
def test_chunk_options_are_run_steps_bit_for_bit(pdata, case):
    cfg = chunk_config(grid="ngp" if case.startswith("ngp") else "occ",
                       closest=case == "closest", real_time=case == "real_time")
    tr = Trainer(cfg, pdata[0], scene=pdata[1], device="cpu")
    want, got = tr.init_state(0), tr.init_state(0)
    pre = cfg.ngp_grid.warmup_steps if case.startswith("ngp") else 0
    tr.run_steps(want, pre)
    tr.run_steps(got, pre)
    n = 16 - pre
    # the images taken by 4 s, then all of them (real time): each step's
    # time, which the grid update at that step reads too
    ets = np.where(np.arange(n) < n // 2, 4.0, 100.0) if case == "real_time" else None
    clock = (lambda: None) if ets is None else (lambda: float(ets[want.step - pre]))
    pending = tr.run_steps(want, n, clock)
    first, keys, m = tr.make_train_chunk(n)(got, ets)
    assert first == pre and torch.equal(m, _metrics(pending, keys))
    assert_states_equal(got, want)
    if case == "closest":
        assert int(got.uss_stats.counts.sum()) > 0
    if case.startswith("ngp"):
        assert float(got.grid.threshold) > 0


def test_chunk_writes_the_state_in_place(pdata):
    cfg = chunk_config(closest=True)
    tr = Trainer(cfg, pdata[0], scene=pdata[1], device="cpu")
    state = tr.init_state(0)
    tensors = _state_tensors(state)
    addresses = [t.data_ptr() for t in tensors]
    before = [t.clone() for t in tensors]
    tr.make_train_chunk(9)(state)
    after = _state_tensors(state)
    assert [t.data_ptr() for t in after] == addresses
    assert all(a is b for a, b in zip(after, tensors))
    # and they moved: parameters, moments, count, grid, statistics
    assert sum(not torch.equal(a, b) for a, b in zip(after, before)) >= len(after) - 2


def test_chunk_refuses_a_wrong_length(pdata):
    tr = Trainer(chunk_config(real_time=True), pdata[0], scene=pdata[1],
                 device="cpu")
    with pytest.raises(ValueError, match="elapse times"):
        tr.make_train_chunk(4)(tr.init_state(0), [1.0, 2.0])
    with pytest.raises(ValueError):
        tr.make_train_chunk(0)


@pytest.fixture(scope="module")
def data():
    jds, jscene, _ = j_make_dataset(**DATA_KW)
    pds, pscene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    return jds, jscene, pds, pscene


class ChunkPair(Pair):
    """``Pair`` on the bench-like chunk configuration."""

    def __init__(self, jds, jscene, pds, pscene):
        self.cfg = chunk_config()
        self.jds, self.pds = jds, pds
        self.jt = JTrainer(self.cfg, jds, scene=jscene)
        self.pt = Trainer(self.cfg, pds, scene=pscene, device="cpu")
        self.train_body = jax.jit(self.jt._make_train_body())
        self.occ_body = jax.jit(self.jt._make_occ_body())
        self.et = None


@pytest.mark.parametrize("witness", [False, True])
def test_chunk_losses_match_the_jax_chunk(data, witness):
    pair = ChunkPair(*data)
    js0, ps = pair.start(seed=1)
    # the JAX chunk of 8, run twice (one dispatch each)
    jchunk = pair.jt._make_train_chunk(8)
    js, losses_j = js0, []
    for _ in range(2):
        js, mj = jchunk(js, pair.jds, 0.0)
        losses_j += np.asarray(mj["loss"]).tolist()
    # the port's chunks, their bodies fed the JAX chunk's draws in the
    # chunk's order: the JAX bodies the chunk scans, stepped alongside
    ref = {"js": js0}
    lr = pair.cfg.training.lr
    synced = []

    def grid_update(state, elapse_time=None, group=None):
        ref["js"] = pair.grid_update(ref["js"], state, state.step)

    def train_step(state, elapse_time=None, group=None):
        batch, _, noise = pair.train_draws(ref["js"])
        ref["js"], _ = pair.train_body(ref["js"], pair.jds, None)
        m = pair.pt.train_step_on(state, _port_batch(batch), noise)
        if witness:
            synced.append(_sync_stepped_apart(state, ref["js"], lr)[0])
        return m

    pair.pt.grid_update, pair.pt.train_step = grid_update, train_step
    losses_p = []
    for _ in range(2):
        _, keys, m = pair.pt.make_train_chunk(8)(ps)
        losses_p += m[:, keys.index("loss")].tolist()
    assert ps.step == 16 and ps.grid.update_step == 2
    assert int(ps.optimizer.count) == int(js.opt_state.count) == 16
    # the chunk's draws are the scanned bodies' own: the reference stepped
    # the same keys
    np.testing.assert_array_equal(np.asarray(ref["js"].key), np.asarray(js.key))
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-5)
    if witness:
        assert max(synced) > 0


def _leaves(tree):
    return [np.array(x) for x in jax.tree.leaves(tree)]


def test_the_port_chunk_leaves_the_jax_state_alone(data):
    # the port's state converted from the JAX one, then a port chunk on its
    # own draws (two grid updates written in place): the JAX state keeps
    # every value
    pair = ChunkPair(*data)
    js0, ps = pair.start(seed=1)
    before = _leaves((js0.params, js0.opt_state, js0.grid))
    pair.pt.make_train_chunk(16)(ps)
    assert ps.grid.update_step == 2
    after = _leaves((js0.params, js0.opt_state, js0.grid))
    assert all(np.array_equal(a, b) for a, b in zip(before, after))


def test_converted_tensors_are_copies():
    # from JAX arrays: a write to the port's tensor leaves the JAX array;
    # from writable numpy arrays: a later write to the source does not
    # reach the port's tensors
    a = jax.numpy.arange(6, dtype=jax.numpy.float32)
    t = convert._t(np.asarray(a), "cpu")
    t.fill_(-1.0)
    np.testing.assert_array_equal(np.asarray(a), np.arange(6))
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.random(s, dtype=np.float32)  # noqa: E731
    params = SimpleNamespace(pos_table=f32(64), xyz_w=[f32(3, 4)],
                             rgb_w=[f32(4, 2)])
    opt = SimpleNamespace(count=np.int32(3), mu=params, nu=params)
    grid = SimpleNamespace(occ_3d_grid=f32(8), occ_bool=f32(8) > 0.5,
                           update_step=np.int32(2))
    ngp = SimpleNamespace(density_grid=f32(2, 8), occ_bool=f32(2, 8) > 0.5,
                          bitfield=np.zeros(2, np.uint8),
                          threshold=np.float32(0.1))
    stats = SimpleNamespace(min_depth=f32(4), min_pix=np.arange(4),
                            counts=np.ones(4, np.int64))
    out = [convert.params_from_jax(params, "cpu"),
           convert.adam_state_from_jax(opt, "cpu")[1:],
           convert.grid_from_jax(grid, "cpu"),
           convert.ngp_grid_from_jax(ngp, "cpu"),
           convert.uss_stats_from_jax(stats, "cpu")]
    tensors = [x for x in jax.tree.leaves(out) if torch.is_tensor(x)]
    copies = [x.clone() for x in tensors]
    assert len(tensors) == 18
    for src in (params.pos_table, params.xyz_w[0], params.rgb_w[0],
                grid.occ_3d_grid, grid.occ_bool, ngp.density_grid,
                ngp.occ_bool, ngp.bitfield, stats.min_depth, stats.min_pix,
                stats.counts):
        src[...] = 1
    assert all(torch.equal(x, y) for x, y in zip(tensors, copies))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_loss_weights_give_the_host_floats_losses(pdata, dtype,
                                                         monkeypatch):
    # 9 steps (grid updates at 0 and 8) with the weights read from the
    # trainer's device tensor, then with the LossWeights floats handed to
    # the loss as they are: every metric and the whole state bit for bit
    cfg = chunk_config()
    cfg.model.dtype = dtype
    tr = Trainer(cfg, pdata[0], scene=pdata[1], device="cpu")
    tr.loss_weights = tr.loss_weights._replace(color=0.2, rgbd=100.0, tof=8.0,
                                               uss=0.1)
    assert torch.equal(tr.device_loss_weights,
                       torch.tensor([0.2, 100.0, 8.0, 0.1]))
    on_device = tr.init_state(0)
    got = tr.run_steps(on_device, 9)
    monkeypatch.setattr(trainer_module, "with_device_weights",
                        lambda weights, values: weights)
    host = tr.init_state(0)
    want = tr.run_steps(host, 9)
    for (_, a), (_, b) in zip(got, want):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), a
    assert_states_equal(on_device, host)


def test_a_graph_set_holds_one_state_and_its_generators(pdata):
    tr = Trainer(chunk_config(), pdata[0], scene=pdata[1], device="cpu")
    a = tr.init_state(0)
    ga = tr.state_graphs(a)
    assert ga.holds(a) and tr.state_graphs(a) is ga
    # a state whose tensors were rebound: a new set
    a.grid = a.grid._replace(occ_3d_grid=a.grid.occ_3d_grid.clone())
    ga2 = tr.state_graphs(a)
    assert ga2 is not ga and tr.state_graphs(a) is ga2
    # a generator rebound (a rank's shard generator made): a new set
    a.shard_generator = torch.Generator()
    ga3 = tr.state_graphs(a)
    assert ga3 is not ga2 and tr.state_graphs(a) is ga3
    a.generator = torch.Generator()
    assert not ga3.holds(a)
    # set in place to another seed (the swarm's particles in turns), the
    # state keeps its set; another state replaces it
    ga4 = tr.state_graphs(a)
    assert tr.state_graphs(tr.reset_state(a, seed=3)) is ga4
    b = tr.init_state(1)
    assert tr.state_graphs(b) is not ga4 and not tr._graphs.holds(a)
    # a dead state's set holds nothing
    del b
    gc.collect()
    assert tr._graphs.state() is None


def test_chunk_refuses_sample_counts_float32_cannot_hold(pdata):
    # the chunk's stacked float32 metrics hold the sample counts exactly
    # below 2^24: 2^14 rays x 1024 samples a step is refused
    cfg = chunk_config()
    cfg.training.batch_size, cfg.training.max_samples_per_ray = 2**14, 1024
    tr = Trainer(cfg, pdata[0], scene=pdata[1], device="cpu")
    with pytest.raises(ValueError, match="2\\^24"):
        tr.make_train_chunk(8)
    cfg.training.max_samples_per_ray = 1023
    tr = Trainer(cfg, pdata[0], scene=pdata[1], device="cpu")
    tr.make_train_chunk(8)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
