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

Feed the returned callable to ``run_optimization(..., batch_eval=...)``.
The 2-D ``(pop, data)`` mesh, each particle itself data-parallel
(parallel_eval.py:121-139), is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

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
            trainer's).  A 2-D nesting, ``(pop, data)``, raises
            NotImplementedError.
        weight_fields: LossWeights fields taken from position columns.
        score_key: the per-step metric averaged ("loss", "loss_depth", ...).
        score_tail: how many trailing steps the score averages.
    """
    from virus_nerf_tpu_torch.training.trainer import Trainer, _full_device

    if devices is None:
        devices = [trainer.device]
    devices = list(devices)
    if any(isinstance(d, (list, tuple, np.ndarray)) for d in devices):
        raise NotImplementedError(
            "the 2-D (pop, data) mesh of the JAX parallel_eval "
            "(parallel_eval.py:121-139: each particle data-parallel over "
            "the data axis) is not ported; pass a flat list of devices"
        )
    devices = [_full_device(d) for d in devices]
    n_fields = len(weight_fields)
    base_weights = trainer.loss_weights
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
        positions = np.asarray(positions, np.float32)
        if positions.ndim != 2 or positions.shape[1] < n_fields:
            raise ValueError(
                f"positions must be (N, >={n_fields}), got {positions.shape}"
            )
        n = positions.shape[0]
        pad = (-n) % len(devices)
        if pad:
            positions = np.concatenate(
                [positions, np.repeat(positions[-1:], pad, axis=0)]
            )
        per_dev = positions.shape[0] // len(devices)
        parts = []
        for i, pos in enumerate(positions):
            tr = trainer_on(devices[i // per_dev])
            weights = base_weights._replace(
                **{f: float(pos[j]) for j, f in enumerate(weight_fields)})
            parts.append(dict(trainer=tr, weights=weights,
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
