"""Population-parallel PSO evaluation over the sensor-fusion loss weights.

Counterpart of ``virus_nerf_tpu/optimization/parallel_eval.py:1-162``.
The reference evaluates PSO particles one full training run at a time
(run_optimization.py:105-125).  The continuous hyper-parameters here, the
loss weights, change no shape of the run, so every particle trains the
same ``Trainer`` configuration with its own weights: particle ``i`` runs
``steps`` steps from ``init_state(seed=i)``, and its score is the mean of
its last ``score_tail`` values of ``score_key`` (lower is better, as the
PSO minimizes).  Where JAX trains the swarm as one ``vmap`` program with
its particle axis sharded over a 1-D mesh, the port takes a list of
devices: the particles are split over them in contiguous blocks, and the
host runs step k of every particle before step k+1 of any, so each card
works through its queue while the host launches the others'.

A 2-D nesting of devices, ``(pop, data)``, is the JAX 2-D mesh
(parallel_eval.py:101-119): one process a device, joined in a
``torch.distributed`` group (``parallel.make_mesh``), rank ``r`` at
``devices[r // data][r % data]``.  The particles are split over the pop
rows in contiguous blocks, and each particle's run is data-parallel over
its row's ranks (``parallel.make_dp_train_chunk`` on a sub-group a row);
every rank gets every score back, in particle order.

Feed the returned callable to ``run_optimization(..., batch_eval=...)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from virus_nerf_tpu_torch.data.dataset import dataset_to

_WEIGHT_FIELDS = ("color", "rgbd", "tof", "uss")


def make_population_eval(
    trainer,
    *,
    steps: int = 32,
    devices: Optional[Sequence] = None,
    weight_fields: Sequence[str] = _WEIGHT_FIELDS,
    score_key: str = "loss",
    score_tail: int = 8,
):
    """Build a ``batch_eval`` callable: (N, M) positions -> (N,) scores.

    Each particle's position holds values for ``weight_fields`` of the
    trainer's :class:`~virus_nerf_tpu_torch.training.loss.LossWeights`, in
    order (further columns are ignored); ``distortion`` stays the
    trainer's.

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
    base_weights = trainer.loss_weights

    def check_positions(positions) -> np.ndarray:
        positions = np.asarray(positions, np.float32)
        if positions.ndim != 2 or positions.shape[1] < n_fields:
            raise ValueError(
                f"positions must be (N, >={n_fields}), got {positions.shape}"
            )
        return positions

    def weights_of(pos):
        return base_weights._replace(
            **{f: float(pos[j]) for j, f in enumerate(weight_fields)})

    if any(isinstance(d, (list, tuple, np.ndarray)) for d in devices):
        return _mesh_eval(trainer, devices, steps, check_positions,
                          weights_of, score_key, score_tail)
    devices = [_full_device(d) for d in devices]
    routes = dict(hash_forward=trainer.model_kwargs["hash_forward"],
                  hash_backward=trainer.model_kwargs["hash_backward"])
    trainers = {}

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
        parts = []
        for i, pos in enumerate(positions):
            tr = trainer_on(devices[i // per_dev])
            parts.append(dict(trainer=tr, weights=weights_of(pos),
                              state=tr.init_state(seed=i), values=[]))
        for _ in range(steps):
            for p in parts:
                tr = p["trainer"]
                tr.loss_weights = p["weights"]
                try:
                    (_, m), = tr.run_steps(p["state"], 1, 0.0)
                finally:
                    tr.loss_weights = base_weights
                p["values"].append(m[score_key])
        tail = min(score_tail, steps)
        scores = [float(torch.stack(p["values"][-tail:]).float().mean())
                  for p in parts]
        return np.asarray(scores[:n], np.float64)

    return batch_eval


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
    base_weights = trainer.loss_weights
    tail = min(score_tail, steps)

    def batch_eval(positions: np.ndarray) -> np.ndarray:
        positions = check_positions(positions)
        n = positions.shape[0]
        positions = _pad(positions, n_pop)
        per_row = positions.shape[0] // n_pop
        mine = range(pop_i * per_row, (pop_i + 1) * per_row)
        scores = []
        for i in mine:
            trainer.loss_weights = weights_of(positions[i])
            try:
                m = chunk(trainer.init_state(seed=i), 0.0)
            finally:
                trainer.loss_weights = base_weights
            scores.append(m[score_key][-tail:].float().mean())
        local = torch.stack(scores).double()
        gathered = [torch.empty_like(local) for _ in range(n_pop * n_data)]
        dist.all_gather(gathered, local)
        # the data ranks of a row hold the same scores: row p's from its
        # first rank
        out = torch.cat([gathered[p * n_data] for p in range(n_pop)])
        return out.cpu().numpy()[:n]

    return batch_eval
