"""Ray-batch data parallelism over a ``torch.distributed`` process group.

Counterpart of ``virus_nerf_tpu/parallel/data_parallel.py:1-149``: a group
of ranks takes the place of the JAX mesh, one rank a card (NCCL) or one
rank a CPU process (gloo).

- The model, Adam and grid state is replicated: every rank builds it from
  the same seed.
- Each rank draws ``batch_size // world`` rays and takes
  ``sample_budget // world`` samples (JAX trainer.py:216-217, 243) from
  its own generator, seeded from ``(seed, rank)`` (``shard_seed``), the
  counterpart of the JAX key folded with the axis index (:250-251,
  374-375).
- Every gradient, the position table's included, is all-reduced to its
  mean before the fused Adam step (:277-280); the metrics are reduced as
  JAX does (:294-299); the USS statistics of "closest" sampling fold the
  batch gathered in rank order (:313-322).
- The VIRUS grid update: each rank draws its shard of the update batches,
  the NeRF threshold's mean density is averaged and the log-odds evidence
  summed over the ranks; the application, decay and boolean grid stay
  replicated (grids/occupancy_grid.py).  The NGP grid's update is drawn
  alike on every rank.

All of it is the Trainer's own step code with the ``group`` passed
through, so the data-parallel path cannot drift from the one-device one;
one rank is bit for bit the plain trainer.  The chunk
(``make_dp_train_chunk``) runs through ``Trainer.make_train_chunk``: on
the card over NCCL its pieces are CUDA graphs with the collectives
captured inside (the JAX chunk's one dispatch, :128-149); over gloo they
run eagerly.

Start the ranks either with ``torchrun`` (``make_mesh()`` reads ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``; one process a card) or by spawning them
(``spawn_ranks``).  The backend is NCCL for a card and gloo for the CPU,
or the caller's; a backend that fails to start raises.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from virus_nerf_tpu_torch.training.trainer import Trainer, TrainState

DEFAULT_TIMEOUT = timedelta(minutes=5)


@dataclass
class Mesh:
    """The process group of the data-parallel ranks and this rank's place
    in it (the counterpart of a 1-D ``jax.sharding.Mesh``)."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    world: int
    device: torch.device
    backend: str


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def make_mesh(n_devices: Optional[int] = None, *, rank: Optional[int] = None,
              device=None, backend: Optional[str] = None,
              init_method: Optional[str] = None,
              timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """Join (or start) the process group of ``n_devices`` ranks.

    Without an initialized group, ``init_process_group`` starts one: the
    rank and world size come from the arguments, else from ``RANK`` and
    ``WORLD_SIZE`` (``torchrun``); ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``), or give ``file://<path>`` or
    ``tcp://localhost:<port>``.  The device defaults to the card
    ``cuda:<LOCAL_RANK>`` (the rank modulo the cards when unset); the
    backend follows it (NCCL on a card, gloo on the CPU) unless given.
    """
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"the process group has {world} ranks, want "
                             f"{n_devices}")
    else:
        world = n_devices if n_devices is not None else _env_int("WORLD_SIZE")
        rank = rank if rank is not None else _env_int("RANK")
        if world is None or rank is None:
            raise ValueError("make_mesh: give n_devices and rank, or start "
                             "the ranks with torchrun")
    if device is None:
        local = _env_int("LOCAL_RANK")
        n_cards = torch.cuda.device_count()
        if local is None:
            local = rank % max(n_cards, 1)
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world, timeout=timeout,
        )
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"want {backend}")
    return Mesh(group=dist.group.WORLD, rank=rank, world=world, device=device,
                backend=backend)


def shard_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s draws under a run seeded ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1, np.uint64)[0])


def shard_state(state: TrainState, mesh: Mesh, reseed: bool = False
                ) -> TrainState:
    """Give ``state`` this rank's generator of batch draws, seeded from the
    state's seed and the rank (nothing to do on one rank, whose draws
    are the plain trainer's).  ``reseed``: seed a generator the state
    already has anew, in place (a state set to a new seed by
    ``Trainer.reset_state``; its CUDA graphs hold the generator)."""
    if mesh.world > 1 and state.shard_generator is None:
        state.shard_generator = torch.Generator(device=state.generator.device)
        reseed = True
    if reseed and state.shard_generator is not None:
        state.shard_generator.manual_seed(
            shard_seed(state.generator.initial_seed(), mesh.rank))
    return state


def _check(trainer: Trainer, mesh: Mesh) -> None:
    if trainer.device != mesh.device:
        raise ValueError(f"trainer on {trainer.device}, this rank's device is "
                         f"{mesh.device}")
    trainer._shard_batch(mesh.world)  # the batch splits evenly


def make_dp_train_step(trainer: Trainer, mesh: Mesh):
    """The data-parallel train step: ``step(state, elapse_time=None) ->
    metrics``, the Trainer's own step with the group passed through."""
    _check(trainer, mesh)

    def step(state: TrainState, elapse_time=None) -> Dict[str, torch.Tensor]:
        return trainer.train_step(shard_state(state, mesh), elapse_time,
                                  mesh.group)

    return step


def make_dp_occ_update(trainer: Trainer, mesh: Mesh):
    """The data-parallel grid update: ``update(state, elapse_time=None)``;
    each rank draws its shard of the VIRUS update batches and the evidence
    is summed over the ranks before one replicated application."""
    _check(trainer, mesh)

    def update(state: TrainState, elapse_time=None) -> None:
        trainer.grid_update(shard_state(state, mesh), elapse_time, mesh.group)

    return update


def make_dp_train_chunk(trainer: Trainer, mesh: Mesh, chunk_steps: int):
    """``chunk_steps`` data-parallel steps with the grid update before every
    step whose index is a multiple of the update interval, the multi-rank
    twin of one chunk of ``Trainer.train``: ``chunk(state,
    elapse_time=None) -> metrics``, each metric a (chunk_steps,) tensor
    on the device in its step's dtype.  ``elapse_time``: None, seconds
    (every step's), or one a step.  It is ``trainer.make_train_chunk``
    over the mesh's group: CUDA graphs on NCCL (see the module doc)."""
    _check(trainer, mesh)
    run = trainer.make_train_chunk(chunk_steps, mesh.group)
    timed = trainer.cfg.training.real_time_simulation

    def chunk(state: TrainState, elapse_time=None) -> Dict[str, torch.Tensor]:
        ets = None
        if timed and elapse_time is not None:
            ets = np.broadcast_to(np.asarray(elapse_time, np.float32),
                                  (chunk_steps,)).copy()
        _, keys, m = run(shard_state(state, mesh), ets)
        return {k: m[:, j].to(dtype)
                for j, (k, dtype) in enumerate(zip(keys, trainer._metric_dtypes))}

    return chunk


def replica_mismatches(state: TrainState, mesh: Mesh) -> List[str]:
    """The names of the replicated tensors (parameters, Adam moments, grid,
    USS statistics) that differ from rank 0's on any rank, gathered to
    every rank; an empty list when the replicas are bit-identical."""
    named = [(f"params.{n}", p.detach()) for n, p in state.model.named_parameters()]
    for n, p in state.model.named_parameters():
        mu, nu = state.optimizer._moments(p)
        named += [(f"adam.mu.{n}", mu), (f"adam.nu.{n}", nu)]
    named += [(f"grid.{f}", x) for f, x in zip(state.grid._fields, state.grid)
              if torch.is_tensor(x)]
    if state.uss_stats is not None:
        named += [(f"uss_stats.{f}", x)
                  for f, x in zip(state.uss_stats._fields, state.uss_stats)]
    bad = []
    for name, x in named:
        # compared as raw bytes, so NaN payloads and -0.0 count too
        raw = x.contiguous().reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(mesh.world)]
        dist.all_gather(parts, raw, group=mesh.group)
        if not all(torch.equal(parts[0], q) for q in parts[1:]):
            bad.append(name)
    return bad


# ---------------------------------------------------------------- spawning
def _rank_entry(fn, rank, world, init_method, results, read, timeout, args):
    try:
        results.put((rank, True, fn(rank, world, init_method, *args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        # a tensor in the result crosses the queue as a handle to this
        # process's shared memory, which the parent's ``get`` fetches from
        # this process: it stays alive until the parent has read every
        # result (or gave up)
        read.wait(timeout)
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: Sequence = (),
                timeout: float = 300.0,
                store_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` fresh
    processes (the ``spawn`` start method) and return their results in
    rank order.  ``init_method`` is a ``file://`` store in ``store_dir``
    (a temporary directory when None) for ``make_mesh``.  A rank that
    raises, dies, or outlives ``timeout`` seconds fails the call: every
    rank is then killed and RuntimeError or TimeoutError raised.  ``fn``
    and ``args`` must be picklable (``fn`` a module-level function).
    A rank's process lives until every result has been read, so a result
    may hold tensors."""
    ctx = torch.multiprocessing.get_context("spawn")
    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="vnerf_ranks_") if own else store_dir
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    results, read = ctx.Queue(), ctx.Event()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world, f"file://{store}", results, read,
                               timeout, tuple(args)))
             for r in range(world)]
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in out]
                if dead:
                    raise RuntimeError(f"rank processes died: {dead}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks did not finish in {timeout} s "
                                       f"(done: {sorted(out)})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        read.set()
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        read.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world)]


# ----------------------------------------------------------------- dry run
def dryrun_config(n_devices: int):
    """The tiny configuration of the JAX dry run (__graft_entry__.py:78-95):
    a 32^3 VIRUS grid updated every 4 steps, 8 x F=2 hash levels of 2^15
    rows, 16 rays a rank, "closest" pixels."""
    from virus_nerf_tpu_torch.configs.config import Config

    cfg = Config()
    cfg.model.grid_type = "occ"
    cfg.model.grid_size = 32
    cfg.model.hash_levels = 8
    cfg.model.hash_log2_T = 15
    cfg.model.hash_max_res = 128
    cfg.training.batch_size = 16 * n_devices
    cfg.training.max_samples_per_ray = 32
    cfg.training.march_candidates = 128
    cfg.training.sampling_strategy = {
        "imgs": "all",
        "pixs": {"valid_uss": 0.3, "valid_tof": 0.3, "closest": 0.1},
    }
    cfg.training.sensors = ["USS", "ToF"]
    cfg.occ_grid.batch_size = 8 * n_devices
    cfg.occ_grid.update_interval = 4
    return cfg


def _dryrun_rank(rank: int, world: int, init_method: str, timeout_s: float):
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset

    torch.set_num_threads(1)
    mesh = make_mesh(world, rank=rank, device="cpu", backend="gloo",
                     init_method=init_method,
                     timeout=timedelta(seconds=timeout_s))
    dataset, scene, _ = make_synthetic_dataset(n_images=4, img_wh=(32, 24),
                                               device="cpu")
    trainer = Trainer(dryrun_config(world), dataset, scene=scene, device="cpu")
    state = trainer.init_state()
    # 2 chunks x 6 steps with update_interval=4: grid updates at steps 0,
    # 4 and 8, both chunks cross one
    chunk = make_dp_train_chunk(trainer, mesh, chunk_steps=6)
    for _ in range(2):
        metrics = chunk(state)
    loss = float(metrics["loss"][-1])
    return {"loss": loss, "grid_updates": state.grid.update_step,
            "mismatches": replica_mismatches(state, mesh)}


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> None:
    """Counterpart of the JAX dry run (``__graft_entry__.py:36-146``):
    ``n_devices`` CPU ranks on gloo run two data-parallel chunks that cross
    grid updates (batch draws, march, loss, averaged gradients, Adam, the
    VIRUS update with summed evidence, the USS statistics of the gathered
    batch), then every rank's parameters, Adam moments, grid and USS
    statistics are checked bit-identical.  Raises on any failure."""
    results = spawn_ranks(_dryrun_rank, n_devices, args=(timeout,),
                          timeout=timeout)
    r0 = results[0]
    for rank, r in enumerate(results):
        if r["mismatches"]:
            raise AssertionError(f"rank {rank}: {r['mismatches']} diverged")
        if not np.isfinite(r["loss"]) or r["loss"] != r0["loss"]:
            raise AssertionError(f"rank {rank}: loss {r['loss']} vs rank 0's "
                                 f"{r0['loss']}")
        if r["grid_updates"] != 3:
            raise AssertionError(f"rank {rank}: {r['grid_updates']} grid "
                                 f"updates, want 3")
    print(f"dryrun_multichip({n_devices}): ok, loss={r0['loss']:.4f}, "
          f"grid_updates=3, replicas bit-identical")
