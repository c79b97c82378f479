"""Population-parallel PSO evaluation over the sensor-fusion loss weights.

Counterpart of ``virus_nerf_tpu/optimization/parallel_eval.py:1-162``.
The reference evaluates PSO particles one full training run at a time
(run_optimization.py:105-125).  The continuous hyper-parameters here, the
loss weights, change no shape of the run, so every particle trains the
same ``Trainer`` configuration with its own weights: particle ``i`` runs
``steps`` steps from ``init_state(seed=i)``, and its score is the mean of
its last ``score_tail`` values of ``score_key`` (lower is better, as the
PSO minimizes).  Where JAX trains the swarm as one ``vmap`` program with
its particle axis sharded over a 1-D mesh and the weights as traced
scalars, the port takes a list of devices: the particles are split over
them in contiguous blocks, and each device runs its particles in turns
on one training state: the state is set in place to the particle's
``init_state(seed=i)`` (``Trainer.reset_state``), its weights are written
into the trainer's ``device_loss_weights``, and its ``steps`` run as one
chunk of ``make_train_chunk`` (at an elapse time of 0 s under
``real_time_simulation``, as the JAX ``run_one``).  On the card the chunk is replays of the
state's CUDA graphs, captured once by the first particle of the first
call, which read the weights from device memory (the JAX swarm is one
program compiled once).  The host launches the devices' particles in
turns, so each card works through its queue while the host launches the
others'.

A 2-D nesting of devices, ``(pop, data)``, is the JAX 2-D mesh
(parallel_eval.py:101-119): one process a device, joined in a
``torch.distributed`` group (``parallel.make_mesh``), rank ``r`` at
``devices[r // data][r % data]``.  The particles are split over the pop
rows in contiguous blocks, and each particle's run is data-parallel over
its row's ranks (``parallel.make_dp_train_chunk`` on a sub-group a row:
CUDA graphs with the row's NCCL collectives inside, on one state a rank
that the row's particles take in turns); every rank gets every score
back, in particle order.

Feed the returned callable to ``run_optimization(..., batch_eval=...)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from virus_nerf_tpu_torch.data.dataset import dataset_to
from virus_nerf_tpu_torch.training.loss import DEVICE_WEIGHTS, weights_tensor


def make_population_eval(
    trainer,
    *,
    steps: int = 32,
    devices: Optional[Sequence] = None,
    weight_fields: Sequence[str] = DEVICE_WEIGHTS,
    score_key: str = "loss",
    score_tail: int = 8,
):
    """Build a ``batch_eval`` callable: (N, M) positions -> (N,) scores.

    Each particle's position holds values for ``weight_fields`` of the
    trainer's :class:`~virus_nerf_tpu_torch.training.loss.LossWeights`, in
    order (further columns are ignored): fields of ``DEVICE_WEIGHTS``
    (the rest, ``distortion`` among them, stay the trainer's; it gates a
    branch, as in JAX).

    Args:
        trainer: a :class:`~virus_nerf_tpu_torch.training.Trainer` whose
            config and dataset define the (small) per-particle training
            run (the JAX function's ``dataset`` argument is the trainer's
            here).
        steps: train steps a particle an evaluation.
        devices: the devices the particles are split over (default: the
            trainer's).  A 2-D nesting ``(pop, data)`` (a list of pop rows
            of data devices) runs each particle data-parallel over its
            row: every rank of an initialized process group of
            ``pop * data`` ranks calls this with the same nesting and its
            own trainer, on ``devices[rank // data][rank % data]``, and
            then the returned callable with the same positions.
        weight_fields: LossWeights fields taken from position columns.
        score_key: the per-step metric averaged ("loss", "loss_depth", ...).
        score_tail: how many trailing steps the score averages.
    """
    from virus_nerf_tpu_torch.training.trainer import Trainer, _full_device

    if devices is None:
        devices = [trainer.device]
    devices = list(devices)
    n_fields = len(weight_fields)
    other = sorted(set(weight_fields) - set(DEVICE_WEIGHTS))
    if other:
        raise ValueError(f"weight_fields {other}: a particle's weights are "
                         f"among {DEVICE_WEIGHTS}")
    cols = [DEVICE_WEIGHTS.index(f) for f in weight_fields]
    base = weights_tensor(trainer.loss_weights, "cpu")

    def check_positions(positions) -> np.ndarray:
        positions = np.asarray(positions, np.float32)
        if positions.ndim != 2 or positions.shape[1] < n_fields:
            raise ValueError(
                f"positions must be (N, >={n_fields}), got {positions.shape}"
            )
        return positions

    def weights_of(positions: np.ndarray) -> torch.Tensor:
        """(N, 4) float32: each particle's ``DEVICE_WEIGHTS``."""
        w = base.repeat(positions.shape[0], 1)
        w[:, cols] = torch.from_numpy(positions[:, :n_fields])
        return w

    if any(isinstance(d, (list, tuple, np.ndarray)) for d in devices):
        return _mesh_eval(trainer, devices, steps, check_positions,
                          weights_of, score_key, score_tail)
    devices = [_full_device(d) for d in devices]
    routes = dict(hash_forward=trainer.model_kwargs["hash_forward"],
                  hash_backward=trainer.model_kwargs["hash_backward"])
    trainers, slots = {}, {}  # by device: its trainer, its state

    def trainer_on(dev) -> Trainer:
        if dev not in trainers:
            trainers[dev] = trainer if dev == trainer.device else Trainer(
                trainer.cfg, dataset_to(trainer.train_dataset, dev),
                scene=trainer.scene, device=dev, **routes)
        return trainers[dev]

    def batch_eval(positions: np.ndarray) -> np.ndarray:
        positions = check_positions(positions)
        n = positions.shape[0]
        positions = _pad(positions, len(devices))
        per_dev = positions.shape[0] // len(devices)
        weights = weights_of(positions)
        on = {dev: weights.to(dev) for dev in devices}
        # the devices' particles in turns: particle j of every device
        # before particle j + 1 of any
        order = [d * per_dev + j for j in range(per_dev)
                 for d in range(len(devices))]
        scores = [None] * len(positions)
        try:
            for i in order:
                dev = devices[i // per_dev]
                tr = trainer_on(dev)
                state = slots[dev] = (tr.init_state(seed=i) if dev not in slots
                                      else tr.reset_state(slots[dev], seed=i))
                tr.device_loss_weights.copy_(on[dev][i])
                scores[i] = _score(
                    tr.make_train_chunk(steps)(state, _at_zero(tr, steps)),
                    score_key, score_tail)
        finally:
            for tr in trainers.values():  # back to the trainer's own weights
                tr.loss_weights = tr.loss_weights
        return np.asarray([float(s) for s in scores[:n]], np.float64)

    return batch_eval


def _at_zero(trainer, steps: int) -> Optional[np.ndarray]:
    """The chunk's elapse times: 0 s at every step under
    ``real_time_simulation`` (the JAX ``run_one`` trains at 0.0), else
    None."""
    if trainer.cfg.training.real_time_simulation:
        return np.zeros(steps, np.float32)
    return None


def _score(chunk_out, score_key: str, score_tail: int) -> torch.Tensor:
    """The mean of the chunk's last ``score_tail`` values of
    ``score_key``, on the device."""
    _, keys, m = chunk_out
    return m[-score_tail:, keys.index(score_key)].contiguous().mean()


def _pad(positions: np.ndarray, n_blocks: int) -> np.ndarray:
    """Positions padded to a multiple of ``n_blocks`` rows by repeating the
    last one (the JAX function's padding)."""
    pad = (-positions.shape[0]) % n_blocks
    if pad:
        positions = np.concatenate(
            [positions, np.repeat(positions[-1:], pad, axis=0)]
        )
    return positions


def _mesh_eval(trainer, devices, steps, check_positions, weights_of,
               score_key, score_tail):
    """The ``batch_eval`` of a 2-D ``(pop, data)`` nesting on this rank."""
    from virus_nerf_tpu_torch.parallel.data_parallel import (
        Mesh,
        make_dp_train_chunk,
        shard_state,
    )
    from virus_nerf_tpu_torch.training.trainer import _full_device

    rows = [list(r) for r in devices]
    n_pop, n_data = len(rows), len(rows[0])
    if n_data == 0 or any(len(r) != n_data for r in rows):
        raise ValueError(f"a (pop, data) nesting needs rows of one length, "
                         f"got {[len(r) for r in rows]}")
    if not dist.is_initialized() or dist.get_world_size() != n_pop * n_data:
        raise ValueError(
            f"a ({n_pop}, {n_data}) nesting needs a process group of "
            f"{n_pop * n_data} ranks (parallel.make_mesh), one a device"
        )
    rank = dist.get_rank()
    pop_i, data_i = divmod(rank, n_data)
    if _full_device(rows[pop_i][data_i]) != trainer.device:
        raise ValueError(f"rank {rank} sits at {rows[pop_i][data_i]} of the "
                         f"nesting; its trainer is on {trainer.device}")
    # every rank creates every row's group, in row order: new_group is a
    # collective of the whole group, and NCCL pairs groups by creation order
    groups = [dist.new_group([p * n_data + j for j in range(n_data)])
              for p in range(n_pop)]
    row = Mesh(group=groups[pop_i], rank=data_i, world=n_data,
               device=trainer.device, backend=dist.get_backend())
    chunk = make_dp_train_chunk(trainer, row, steps)
    slot = []  # this rank's state, which its row's particles take in turns

    def state_of(i: int):
        if not slot:
            slot.append(trainer.init_state(seed=i))
            return slot[0]
        return shard_state(trainer.reset_state(slot[0], seed=i), row,
                           reseed=True)

    def batch_eval(positions: np.ndarray) -> np.ndarray:
        positions = check_positions(positions)
        n = positions.shape[0]
        positions = _pad(positions, n_pop)
        per_row = positions.shape[0] // n_pop
        weights = weights_of(positions).to(trainer.device)
        scores = []
        try:
            for i in range(pop_i * per_row, (pop_i + 1) * per_row):
                trainer.device_loss_weights.copy_(weights[i])
                m = chunk(state_of(i), 0.0)
                scores.append(
                    m[score_key][-score_tail:].float().contiguous().mean())
        finally:
            trainer.loss_weights = trainer.loss_weights  # its own weights back
        local = torch.stack(scores).double()
        gathered = [torch.empty_like(local) for _ in range(n_pop * n_data)]
        dist.all_gather(gathered, local)
        # the data ranks of a row hold the same scores: row p's from its
        # first rank
        out = torch.cat([gathered[p * n_data] for p in range(n_pop)])
        return out.cpu().numpy()[:n]

    return batch_eval
