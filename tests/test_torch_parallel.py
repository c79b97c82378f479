"""The port's data parallelism over ``torch.distributed`` (gloo ranks on
the CPU) against the JAX package's data-parallel chunk on a 2-device CPU
mesh (``virus_nerf_tpu.parallel``).

Two ranks start from the JAX initial state (``convert.py``) and are each
given their device's JAX draws: the key splits of the JAX step bodies
folded with the device's index (trainer.py:249-253, 373-378), so the
comparison holds the collectives, the shard sizes and the replicated
application against the JAX ones.  The ranks are spawned processes (the
``spawn`` start method, a file store under ``tmp_path``, a timeout on the
group and on the join) that import no jax; the parent computes the JAX
side.  Small: 8 x 4 hash levels of 2^12 rows, a 32^3 grid, 128 rays."""

import copy
from datetime import timedelta

import numpy as np
import pytest
import torch

from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data.dataset import Batch
from virus_nerf_tpu_torch.optimization.parallel_eval import make_population_eval
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.parallel import (
    dryrun_multichip,
    make_dp_occ_update,
    make_dp_train_chunk,
    make_dp_train_step,
    make_mesh,
    replica_mismatches,
    spawn_ranks,
)
from virus_nerf_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

DATA_KW = dict(n_images=4, img_wh=(32, 24), n_gt_points=2000)
TIMEOUT = 240.0  # seconds a group may wait and a spawned test may take


def dp_config(scale: float = 0.5, closest: bool = False) -> Config:
    """``test_torch_slice.small_config`` (additive 8 x 4 of 2^12 rows,
    128 rays, grid updates every 4 steps); at scale 1.0 with the automatic
    budget, which is dense there (exponential stepping)."""
    cfg = Config()
    m, t = cfg.model, cfg.training
    m.scale = scale
    m.hash_levels, m.hash_features_per_level = 8, 4
    m.hash_log2_T, m.hash_max_res, m.grid_size = 12, 64, 32
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 256
    t.sample_budget = 128 * 12 if scale == 0.5 else None
    pixs = {"valid_uss": 0.4, "valid_tof": 0.4}
    if closest:
        pixs = {"closest": 0.2, "valid_uss": 0.3, "valid_tof": 0.3}
    t.sampling_strategy = {"imgs": "all", "pixs": pixs}
    t.sensors = ["USS", "ToF"]
    cfg.occ_grid.batch_size, cfg.occ_grid.update_interval = 64, 4
    return cfg


def _port_batch(b) -> Batch:
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Batch(
        img_idxs=t(b.img_idxs).long(), pix_idxs=t(b.pix_idxs).long(),
        rays_o=t(b.rays_o), rays_d=t(b.rays_d), rgb=t(b.rgb),
        depths={k: t(v) for k, v in b.depths.items()}, times=t(b.times),
    )


def jax_dp_run(cfg, world=2, steps=8, seed=1):
    """The JAX data-parallel chunk over ``steps`` steps on a ``world``-device
    CPU mesh, and each device's draws of it.  Returns (losses, sample
    counts, initial params and grid in the port's form, draws)."""
    import jax
    import jax.numpy as jnp

    from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset
    from virus_nerf_tpu.parallel import make_dp_train_chunk as j_chunk
    from virus_nerf_tpu.parallel import make_mesh as j_make_mesh
    from virus_nerf_tpu.training import Trainer as JTrainer
    from virus_nerf_tpu_torch.convert import grid_from_jax, params_from_jax

    jds, jscene, _ = j_make_dataset(**DATA_KW)
    jt = JTrainer(cfg, jds, scene=jscene)
    js0 = jt.init_state(seed)
    chunk = j_chunk(jt, j_make_mesh(world), chunk_steps=steps)
    js, m = chunk(js0, jds, jnp.float32(0.0))
    draws = jax_dp_draws(cfg, jds, js0.key, world, steps)
    np_tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    return (np.asarray(m["loss"]).tolist(),
            np.asarray(m["rm_samples"]).tolist(),
            params_from_jax(np_tree(js0.params), device="cpu"),
            grid_from_jax(np_tree(js0.grid), device="cpu"), draws,
            int(js.grid.update_step))


def jax_dp_draws(cfg, jds, key, world, steps):
    """Each device's draws of a JAX data-parallel chunk started from
    ``key``: its key chain replayed (trainer.py:373-385, 249-253), every
    split folded with the device's index.  Returns {"occ": {step: [per
    device (ray batch, NeRF batch, noise)]}, "train": {step: [per device
    (batch, noise)]}} in the port's types."""
    import jax
    import jax.numpy as jnp

    from virus_nerf_tpu.data.dataset import sample_batch as j_sample_batch

    og, t = cfg.occ_grid, cfg.training
    b_all = int(og.batch_size * og.batch_ratio_ray_update)
    b_ray = max(1, b_all // world)
    b_nerf = max(1, (og.batch_size - b_all) // world)
    b = t.batch_size // world
    draws = {"occ": {}, "train": {}}
    for step in range(steps):
        if step % og.update_interval == 0:
            key, k1, k2, k3 = jax.random.split(key, 4)
            draws["occ"][step] = []
            for idx in range(world):
                f = lambda k: jax.random.fold_in(k, idx)  # noqa: E731
                ray_b = j_sample_batch(jds, f(k1), b_ray,
                                       {"imgs": "all", "pixs": "valid_tof"})
                nerf_b = j_sample_batch(jds, f(k2), b_nerf,
                                        {"imgs": "all", "pixs": "valid_uss"})
                _, kn = jax.random.split(f(k3))
                noise = jax.random.uniform(kn, (b_nerf, 32, 3), jnp.float32)
                draws["occ"][step].append((
                    _port_batch(ray_b), _port_batch(nerf_b),
                    torch.from_numpy(np.array(noise * 2.0 - 1.0))))
        key, kb, kr = jax.random.split(key, 3)
        draws["train"][step] = []
        for idx in range(world):
            batch = j_sample_batch(jds, jax.random.fold_in(kb, idx), b,
                                   t.sampling_strategy)
            noise = jax.random.uniform(jax.random.fold_in(kr, idx), (b,))
            draws["train"][step].append(
                (_port_batch(batch), torch.from_numpy(np.array(noise))))
    return draws


def _mesh(rank, world, init_method):
    return make_mesh(world, rank=rank, device="cpu", backend="gloo",
                     init_method=init_method,
                     timeout=timedelta(seconds=TIMEOUT))


def _given_draws_rank(rank, world, init_method, cfg, params, grid, draws, steps):
    """A rank's steps on its device's JAX draws (in a spawned process)."""
    torch.set_num_threads(1)
    mesh = _mesh(rank, world, init_method)
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    tr = Trainer(cfg, ds, scene=scene, device="cpu")
    st = tr.init_state(1)
    st.model.load_state_dict(params)
    st.grid = grid
    losses, rm = [], []
    for step in range(steps):
        if step in draws["occ"]:
            tr.grid_update_on(st, *draws["occ"][step][rank], mesh.group)
        batch, noise = draws["train"][step][rank]
        m = tr.train_step_on(st, batch, noise, mesh.group)
        losses.append(float(m["loss"]))
        rm.append(int(m["rm_samples"]))
    return dict(losses=losses, rm=rm, updates=st.grid.update_step,
                mismatches=replica_mismatches(st, mesh),
                table=st.model.pos_table.detach().clone())


def _own_draws_rank(rank, world, init_method, cfg, steps):
    """A rank's data-parallel chunk on its own draws (spawned)."""
    torch.set_num_threads(1)
    mesh = _mesh(rank, world, init_method)
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    tr = Trainer(cfg, ds, scene=scene, device="cpu")
    st = tr.init_state()
    m = make_dp_train_chunk(tr, mesh, steps)(st)
    return dict(losses=m["loss"].tolist(), rm=m["rm_samples"].tolist(),
                mismatches=replica_mismatches(st, mesh),
                updates=st.grid.update_step,
                uss=None if st.uss_stats is None else st.uss_stats.counts.sum().item())


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_two_gloo_ranks_match_the_jax_two_device_mesh(scale, tmp_path):
    # 8 steps crossing the grid updates at steps 0 and 4.  With two ranks
    # the mean of two floats is the same on both sides; scale 1.0 is the
    # case the JAX data-parallel path never ran: two cascades, exponential
    # stepping, a dense step
    cfg = dp_config(scale)
    losses_j, rm_j, params, grid, draws, updates_j = jax_dp_run(cfg)
    results = spawn_ranks(_given_draws_rank, 2,
                          args=(cfg, params, grid, draws, 8),
                          timeout=TIMEOUT, store_dir=str(tmp_path))
    for r in results:
        assert r["mismatches"] == [], r["mismatches"]
        assert r["updates"] == updates_j == 2
        assert r["losses"] == results[0]["losses"]
        # the march is exact: the summed sample counts agree at every step
        assert r["rm"] == rm_j
    # float32 in another op order on each side, through 8 Adam steps
    np.testing.assert_allclose(results[0]["losses"], losses_j, rtol=1e-5)
    assert torch.equal(results[0]["table"], results[1]["table"])


def test_own_draws_keep_replicas_bit_identical(tmp_path):
    # the ranks' own draws ("closest" pixels: the USS statistics fold the
    # batch gathered in rank order), two chunks' worth crossing two grid
    # updates: every replicated tensor bit-identical, the ranks' batches
    # different
    cfg = dp_config(closest=True)
    results = spawn_ranks(_own_draws_rank, 2, args=(cfg, 8), timeout=TIMEOUT,
                          store_dir=str(tmp_path))
    for r in results:
        assert r["mismatches"] == [], r["mismatches"]
        assert r["losses"] == results[0]["losses"]
        assert np.all(np.isfinite(r["losses"])) and r["updates"] == 2
        assert r["uss"] > 0


def test_one_rank_is_bit_identical_to_the_plain_trainer(tmp_path):
    # one gloo rank in this process: its draws are the state's own, its
    # collectives are identities, so the run is the plain trainer's bit for
    # bit, through the step and grid update (steps 0-3) and the chunk (4-7)
    cfg = dp_config(closest=True)
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    plain = Trainer(cfg, ds, scene=scene, device="cpu")
    sp = plain.init_state()
    want = plain.run_steps(sp, 8)
    mesh = make_mesh(1, rank=0, device="cpu",
                     init_method=f"file://{tmp_path / 'store'}",
                     timeout=timedelta(seconds=TIMEOUT))
    try:
        tr = Trainer(copy.deepcopy(cfg), ds, scene=scene, device="cpu")
        sd = tr.init_state()
        update, step = make_dp_occ_update(tr, mesh), make_dp_train_step(tr, mesh)
        first = []
        for _ in range(4):
            if sd.step % tr.grid_update_interval == 0:
                update(sd)
            first.append(step(sd)["loss"])
        got = make_dp_train_chunk(tr, mesh, 4)(sd)
        got["loss"] = torch.cat([torch.stack(first), got["loss"]])
        assert replica_mismatches(sd, mesh) == []
    finally:
        torch.distributed.destroy_process_group()
    assert sd.shard_generator is None
    np.testing.assert_array_equal(
        got["loss"].numpy(), torch.stack([m["loss"] for _, m in want]).numpy())
    a, b = plain.state_arrays(sp), tr.state_arrays(sd)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------ the data-parallel chunk's pieces
# entry: steps run step by step first; then the chunks' sizes (the grid
# update every 4 steps: groups, an unaligned entry's single steps and lone
# grid updates, chunks shorter than the interval)
DP_ENTRIES = {
    "aligned": (0, (4, 4)),
    "unaligned_at_3": (3, (9,)),
    "shorter_than_the_interval": (0, (3, 6)),
}


def _state_bytes(tr, st):
    """Every replicated tensor, both generators' states and the step."""
    out = {k: v.tobytes() for k, v in tr.state_arrays(st).items()}
    out["shard_generator"] = st.shard_generator.get_state().numpy().tobytes()
    return out


def _chunk_against_run_steps_rank(rank, world, init_method, cfg, pre, sizes):
    """A rank's group ``run_steps`` and its group chunks from one seed
    (spawned): every metric of every step and the whole state."""
    from virus_nerf_tpu_torch.parallel import shard_state

    torch.set_num_threads(1)
    mesh = _mesh(rank, world, init_method)
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    tr = Trainer(cfg, ds, scene=scene, device="cpu")
    want, got = (shard_state(tr.init_state(), mesh) for _ in range(2))
    tr.run_steps(want, pre, group=mesh.group)
    tr.run_steps(got, pre, group=mesh.group)
    pending = tr.run_steps(want, sum(sizes), group=mesh.group)
    rows = []
    for n in sizes:
        first, keys, m = tr.make_train_chunk(n, mesh.group)(got)
        assert first == pre + sum(r.shape[0] for r in rows)
        rows.append(m)
    steps = torch.stack([torch.stack([m[k].float() for k in keys])
                         for _, m in pending])
    return dict(equal=torch.equal(torch.cat(rows), steps),
                losses=steps[:, 0].tolist(), want=_state_bytes(tr, want),
                got=_state_bytes(tr, got), updates=got.grid.update_step,
                uss=int(got.uss_stats.counts.sum()),
                mismatches=replica_mismatches(got, mesh))


@pytest.mark.parametrize("entry", list(DP_ENTRIES))
def test_group_chunk_is_group_run_steps_bit_for_bit(entry, tmp_path):
    # 2 gloo ranks, "closest" pixels (the USS statistics fold the batch
    # gathered in rank order): the chunk's pieces under the group against
    # the group's step-by-step loop, bit for bit, shard generators included
    pre, sizes = DP_ENTRIES[entry]
    results = spawn_ranks(_chunk_against_run_steps_rank, 2,
                          args=(dp_config(closest=True), pre, sizes),
                          timeout=TIMEOUT, store_dir=str(tmp_path))
    for r in results:
        assert r["equal"] and r["mismatches"] == []
        assert r["got"].keys() == r["want"].keys()
        assert [k for k in r["got"] if r["got"][k] != r["want"][k]] == []
        assert r["losses"] == results[0]["losses"]
        assert r["updates"] == (pre + sum(sizes) + 3) // 4 and r["uss"] > 0
    # the ranks drew different batches from their own generators
    assert results[0]["got"]["shard_generator"] != results[1]["got"]["shard_generator"]


def _dp_chunk_given_draws_rank(rank, world, init_method, cfg, params, grid,
                               draws, sizes):
    """A rank's ``make_dp_train_chunk`` chunks on its device's JAX draws
    (spawned): the draws stand in for the trainer's own."""
    torch.set_num_threads(1)
    mesh = _mesh(rank, world, init_method)
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    tr = Trainer(cfg, ds, scene=scene, device="cpu")
    st = tr.init_state(1)
    st.model.load_state_dict(params)
    # a copy: the ranks' arguments share memory, and a chunk writes its
    # state's grid in place
    st.grid = type(grid)(*(x.clone() if torch.is_tensor(x) else x
                           for x in grid))

    def grid_update(state, elapse_time=None, group=None):
        assert group is mesh.group
        tr.grid_update_on(state, *draws["occ"][state.step][rank], group)

    def train_step(state, elapse_time=None, group=None):
        assert group is mesh.group
        return tr.train_step_on(state, *draws["train"][state.step][rank], group)

    tr.grid_update, tr.train_step = grid_update, train_step
    losses, rm = [], []
    for n in sizes:
        m = make_dp_train_chunk(tr, mesh, n)(st)
        assert m["rm_samples"].dtype == torch.int64 and m["loss"].shape == (n,)
        losses += m["loss"].tolist()
        rm += m["rm_samples"].tolist()
    return dict(losses=losses, rm=rm, updates=st.grid.update_step,
                mismatches=replica_mismatches(st, mesh))


@pytest.mark.parametrize("sizes", [(8,), (3, 5)])
def test_two_gloo_rank_chunks_match_the_jax_dp_chunk(sizes, tmp_path):
    # make_dp_train_chunk on 2 gloo ranks against the JAX make_dp_train_chunk
    # on a 2-device CPU mesh (8 steps, grid updates at 0 and 4), each rank
    # fed its device's draws: one chunk of 8 (two groups), or 3 + 5 (single
    # steps, a lone grid update, a group)
    cfg = dp_config()
    losses_j, rm_j, params, grid, draws, updates_j = jax_dp_run(cfg)
    results = spawn_ranks(_dp_chunk_given_draws_rank, 2,
                          args=(cfg, params, grid, draws, sizes),
                          timeout=TIMEOUT, store_dir=str(tmp_path))
    for r in results:
        assert r["mismatches"] == [] and r["updates"] == updates_j == 2
        assert r["losses"] == results[0]["losses"] and r["rm"] == rm_j
    # float32 in another op order on each side, the two-rank test's 1e-5
    np.testing.assert_allclose(results[0]["losses"], losses_j, rtol=1e-5)


# ------------------------------------------ the 2-D (pop, data) population
# loss weights (color, rgbd, tof, uss) of four particles
WEIGHTS = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 8.0, 8.0],
                    [0.2, 1.0, 1.0, 1.0], [1.0, 1.0, 0.1, 0.1]], np.float32)
MESH_2X2 = [["cpu", "cpu"], ["cpu", "cpu"]]


def jax_mesh_scores(cfg, steps):
    """The JAX loss-weight evaluator's scores on a 2 x 2 (pop, data) CPU
    mesh, and per particle seed its initial state in the port's form and
    each data device's draws."""
    import jax

    from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset
    from virus_nerf_tpu.optimization.parallel_eval import (
        make_population_eval as j_weights_eval,
    )
    from virus_nerf_tpu.training import Trainer as JTrainer
    from virus_nerf_tpu_torch.convert import (
        adam_state_from_jax,
        grid_from_jax,
        params_from_jax,
    )

    jds, jscene, _ = j_make_dataset(**DATA_KW)
    jt = JTrainer(cfg, jds, scene=jscene)
    devs = np.array(jax.devices("cpu")[:4]).reshape(2, 2)
    mesh = jax.sharding.Mesh(devs, ("pop", "data"))
    scores = j_weights_eval(jt, jds, steps=steps, mesh=mesh)(WEIGHTS)
    np_tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    inits, draws = {}, {}
    for seed in range(len(WEIGHTS)):
        js = jt.init_state(seed)
        inits[seed] = (params_from_jax(np_tree(js.params), device="cpu"),
                       adam_state_from_jax(np_tree(js.opt_state), device="cpu"),
                       grid_from_jax(np_tree(js.grid), device="cpu"))
        draws[seed] = jax_dp_draws(cfg, jds, js.key, 2, steps)
    return np.asarray(scores), inits, draws


def _mesh2d_rank(rank, world, init_method, cfg, inits, draws, steps, calls):
    """A rank of the 2 x 2 nesting (spawned): its trainer takes each
    particle seed's JAX initial state and its data device's JAX draws,
    then the port's 2-D evaluator runs each call's positions."""
    torch.set_num_threads(1)
    _mesh(rank, world, init_method)
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    tr = Trainer(cfg, ds, scene=scene, device="cpu")
    data_i = rank % 2

    # a state's draws by its generator's seed (the evaluator resets one
    # state in place for each particle: its generator takes the seed)
    def init_state(seed=None):
        st = Trainer.init_state(tr, seed)
        params, (count, mu, nu), grid = inits[seed]
        st.model.load_state_dict(params)
        st.optimizer.load_moments(st.model.named_parameters(), count, mu, nu)
        # a copy: a chunk writes its state's grid in place, and every call
        # starts the seed from this one
        st.grid = type(grid)(*(x.clone() if torch.is_tensor(x) else x
                               for x in grid))
        return st

    def grid_update(state, elapse_time=None, group=None):
        own = draws[state.generator.initial_seed()]["occ"][state.step][data_i]
        tr.grid_update_on(state, *own, group)

    def train_step(state, elapse_time=None, group=None):
        own = draws[state.generator.initial_seed()]["train"][state.step][data_i]
        return tr.train_step_on(state, *own, group)

    tr.init_state, tr.grid_update, tr.train_step = (
        init_state, grid_update, train_step)
    be = make_population_eval(tr, steps=steps, devices=MESH_2X2)
    return [be(positions).tolist() for positions in calls]


def test_four_gloo_ranks_match_the_jax_pop_data_mesh(tmp_path):
    # 4 particles on a 2 x 2 (pop, data) nesting, 8 steps crossing the
    # grid updates at steps 0 and 4, each particle data-parallel over its
    # row's two ranks; then 3 particles (padded to 4 by repeating the
    # last, as the JAX function does)
    cfg = dp_config()
    want, inits, draws = jax_mesh_scores(cfg, 8)
    results = spawn_ranks(_mesh2d_rank, 4,
                          args=(cfg, inits, draws, 8, [WEIGHTS, WEIGHTS[:3]]),
                          timeout=TIMEOUT, store_dir=str(tmp_path))
    full, part = results[0]
    # every rank gets every score back, in particle order
    assert all(r == results[0] for r in results)
    assert len(full) == 4 and len(part) == 3 and np.all(np.isfinite(full))
    # the mean of the last 8 losses: float32 in another op order on each
    # side, the tolerance of the two-rank test above
    np.testing.assert_allclose(full, want, rtol=1e-5)
    # a particle's run depends on its weights and seed alone
    assert part == full[:3]
    assert full[1] > full[3]  # up-weighted depth sensors raise the loss


def _mesh2d_own_draws_rank(rank, world, init_method, cfg, steps):
    """A rank of the 2 x 2 nesting on its own draws (spawned): three
    calls, the particles in another order in the last."""
    torch.set_num_threads(1)
    _mesh(rank, world, init_method)
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    tr = Trainer(cfg, ds, scene=scene, device="cpu")
    be = make_population_eval(tr, steps=steps, devices=MESH_2X2, score_tail=2)
    return [be(w).tolist() for w in (WEIGHTS, WEIGHTS, WEIGHTS[[1, 0, 3, 2]])]


def test_pop_data_rows_repeat_on_their_own_draws(tmp_path):
    # each rank's particles take turns on one state reset in place, its
    # shard generator seeded anew: a call repeats bit for bit, and a
    # particle's score follows its (weights, seed) pair alone
    results = spawn_ranks(_mesh2d_own_draws_rank, 4, args=(dp_config(), 4),
                          timeout=TIMEOUT, store_dir=str(tmp_path))
    first, again, swapped = results[0]
    assert all(r == results[0] for r in results)
    assert first == again and np.all(np.isfinite(first))
    # particles 0 and 1 (seeds 0, 1) took each other's weights
    assert swapped != first and len(set(first)) == 4


def test_a_pop_data_nesting_needs_its_process_group(tmp_path):
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    tr = Trainer(dp_config(), ds, scene=scene, device="cpu")
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        make_population_eval(tr, devices=MESH_2X2)
    with pytest.raises(ValueError, match="rows of one length"):
        make_population_eval(tr, devices=[["cpu", "cpu"], ["cpu"]])
    mesh = make_mesh(1, rank=0, device="cpu",
                     init_method=f"file://{tmp_path / 'store'}",
                     timeout=timedelta(seconds=TIMEOUT))
    try:
        # (1, 1) on one rank: the 1-D evaluator's scores bit for bit
        be = make_population_eval(tr, steps=4, devices=[["cpu"]], score_tail=2)
        want = make_population_eval(tr, steps=4, score_tail=2)(WEIGHTS[:2])
        np.testing.assert_array_equal(be(WEIGHTS[:2]), want)
        with pytest.raises(ValueError, match="positions"):
            be(WEIGHTS[:, :3])
    finally:
        torch.distributed.destroy_process_group()
    assert mesh.world == 1


def test_dryrun_multichip_two_ranks():
    dryrun_multichip(2, timeout=TIMEOUT)


def test_a_failing_rank_fails_the_call(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn_ranks(_failing_rank, 2, timeout=TIMEOUT, store_dir=str(tmp_path))


def _failing_rank(rank, world, init_method):
    if rank == 1:
        raise ValueError("this rank fails")
    return rank


def _tensor_rank(rank, world, init_method):
    # returns at once: the parent reads the tensors after the rank's
    # function is done, from a process that must still be there
    base = torch.arange(6, dtype=torch.float32) + 10 * rank
    return dict(rank=rank, table=base.clone(),
                nested={"rows": [base.reshape(2, 3) * 2, (rank, base[:2])]})


def test_tensor_results_reach_the_parent_in_rank_order(tmp_path):
    for _ in range(4):
        results = spawn_ranks(_tensor_rank, 2, timeout=TIMEOUT,
                              store_dir=str(tmp_path))
        assert [r["rank"] for r in results] == [0, 1]
        for rank, r in enumerate(results):
            base = torch.arange(6, dtype=torch.float32) + 10 * rank
            assert torch.equal(r["table"], base)
            rows = r["nested"]["rows"]
            assert torch.equal(rows[0], base.reshape(2, 3) * 2)
            assert rows[1][0] == rank and torch.equal(rows[1][1], base[:2])


def test_make_mesh_refuses_a_mismatched_trainer(tmp_path):
    ds, scene, _ = make_synthetic_dataset(device="cpu", **DATA_KW)
    cfg = dp_config()
    cfg.training.batch_size = 127
    tr = Trainer(cfg, ds, scene=scene, device="cpu")
    with pytest.raises(ValueError, match="make_mesh"):
        make_mesh(2)  # no rank, no torchrun environment
    mesh = make_mesh(1, rank=0, device="cpu",
                     init_method=f"file://{tmp_path / 'store'}")
    try:
        mesh.world = 2  # as a rank of two would see it
        with pytest.raises(ValueError, match="multiple"):
            make_dp_train_chunk(tr, mesh, 4)
    finally:
        torch.distributed.destroy_process_group()
