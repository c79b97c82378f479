"""The reference's training steps, in plain PyTorch.

From one seed and the loaded room it builds the weights, the grid and the
random stream as the program does (one ``torch.Generator`` on the device,
the same draws in the same order: the encoder's leaves, the MLP layers,
the grid's initial state, then each grid update's own draws, each step's
batch and march jitter), and runs steps:

- the grid update before every step where one is due;
- the batch (``dataset.sample_batch``), the march (``march.py``: the
  constant-dt closed form or the exponential lattice, the occupancy probe
  and the slot selection), the compaction to the sample budget where the
  configuration has one, the model (``model.py``) and the compositing
  (``renderer.py``, ``composite.py``);
- the colour, ToF and USS losses (``loss.py``), the gradient by autograd,
  and Adam (``optax.adam`` with eps 1e-15: the bias-corrected update).

Over ``world`` data-parallel ranks (``world > 1``) it follows the port's
data parallelism (``parallel/data_parallel.py``) with the ranks as
virtual ranks on one device, taken in rank order:

- each rank draws from its own generator, seeded by ``shard_seed(seed,
  rank)``, its share of each batch (``batch_size // world`` rays) and of
  the sample budget (``budget // world``);
- the loss is the mean of the ranks' losses and the gradient the mean of
  their gradients, then plain Adam as on one rank;
- each rank draws its shard of the grid update's batches, the NeRF
  threshold's mean density is averaged over the ranks and the evidence
  summed (the grid part's ``update_shards``).

The weights and the grid's initial state come from the seed's own
generator, as on one rank.

The encoder and the grid are the configuration's, found by name
(``parts.py``: ``encoders/<name>.py``, ``grids/<grid_type>.py``).
Everything the trainer derives from the configuration and the scene (the
metric-to-cube conversions of the loss and the grid, the batch sizes and
sensors of the grid update, the budget) is worked out here again.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import parts
from benchmark.reference.dataset import sample_batch
from benchmark.reference.loss import LossWeights, compute_loss
from benchmark.reference.model import PlainNGP
from benchmark.reference.renderer import render_rays

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


class StepsRecord(dict):
    """``losses`` (each step's), ``params0`` and ``params`` (the leaves
    before the first step and after the last), ``grads1`` (the first
    step's gradient), ``grid1`` (the grid's ``values()`` after the first
    update), ``grid`` (the grid part, ``parts.grid``, after the last),
    ``names`` (the leaves' names) and ``model`` (the ``PlainNGP`` as the
    last step left it)."""


def _sample_budget(cfg) -> Optional[int]:
    t = cfg.training
    budget = t.sample_budget
    if budget is None:
        budget = 0 if cfg.exp_step_factor != 0.0 else t.batch_size * min(
            32, t.max_samples_per_ray)
    return budget if budget > 0 else None


def shard_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s draws under a run seeded ``seed`` (the
    port's ``parallel.shard_seed``: numpy's ``SeedSequence`` of both)."""
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1, np.uint64)[0])


def run_steps(cfg, dataset, scene, seed: int, n_steps: int,
              tf32: bool = False, world: int = 1) -> StepsRecord:
    """``n_steps`` steps from ``seed`` over ``world`` data-parallel ranks;
    ``tf32`` lets the matrix products round their inputs to TF32 (the
    control)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _run_steps(cfg, dataset, scene, seed, n_steps, world)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _rank_loss(cfg, model, grid, batch, noise, budget, weights):
    t = cfg.training
    results = render_rays(
        model, grid.occ_bool, batch.rays_o, batch.rays_d, noise,
        exp_step_factor=cfg.exp_step_factor, max_samples=t.max_samples_per_ray,
        n_candidates=t.march_candidates, march_resolution=t.march_resolution,
        sample_budget=budget)
    loss, _ = compute_loss(results, batch, weights, tuple(t.sensors))
    return loss


def _run_steps(cfg, dataset, scene, seed: int, n_steps: int,
               world: int = 1) -> StepsRecord:
    dev = dataset.device
    t = cfg.training
    w2c = float(scene.w2c(1.0, only_scale=True))
    weights = LossWeights(color=t.color_loss_w, rgbd=t.rgbd_loss_w,
                          tof=t.tof_loss_w, uss=t.uss_loss_w,
                          uss_depth_tol=float(0.03 * w2c), distortion=0.0)
    grid_part = parts.grid(cfg.model.grid_type)
    budget = _sample_budget(cfg)
    rays = t.batch_size // world
    if world > 1 and budget is not None:
        budget = max(1, budget // world)

    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    model = PlainNGP(cfg, g, dev)
    grid = grid_part.Grid(cfg, dataset, scene, g)
    draws = [g] if world == 1 else [
        torch.Generator(device=dev).manual_seed(shard_seed(seed, r))
        for r in range(world)]
    mu = [torch.zeros_like(p) for p in model.params]
    nu = [torch.zeros_like(p) for p in model.params]
    rec = StepsRecord(names=list(model.names), losses=[],
                      params0=[p.detach().clone() for p in model.params])
    for step in range(n_steps):
        if grid.due(step):
            if world == 1:
                grid.update(model.density, step)
            else:
                grid.update_shards(model.density, step, draws)
            if "grid1" not in rec:
                rec["grid1"] = grid.values().clone()
        losses, grads = [], None
        for gen in draws:
            batch = sample_batch(dataset, gen, rays, t.sampling_strategy)
            noise = torch.rand((rays,), generator=gen, device=dev)
            loss = _rank_loss(cfg, model, grid, batch, noise, budget, weights)
            rank_grads = torch.autograd.grad(loss, model.params)
            losses.append(float(loss.detach()))
            grads = rank_grads if grads is None else [
                a + b for a, b in zip(grads, rank_grads)]
            del loss, rank_grads
        if world > 1:
            grads = [gr / world for gr in grads]
        rec["losses"].append(losses[0] if world == 1 else sum(losses) / world)
        if step == 0:
            rec["grads1"] = [gr.detach().clone() for gr in grads]
        count = torch.tensor(step + 1, dtype=torch.float32, device=dev)
        bc1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, device=dev), count)
        bc2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, device=dev), count)
        with torch.no_grad():
            for p, gr, m1, v1 in zip(model.params, grads, mu, nu):
                m1.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * gr)
                v1.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * gr * gr)
                p.add_(-t.lr * (m1 / bc1) / (torch.sqrt(v1 / bc2) + ADAM_EPS))
        del grads
    rec["params"] = [p.detach().clone() for p in model.params]
    rec.update(grid=grid, model=model)
    return rec


def leaf_norms(tensors: List[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(x.double())) for x in tensors]


def worst_leaf_gap(got: List[float], want: List[float],
                   keep: Optional[List[bool]] = None) -> Dict[str, float]:
    """The largest ``|got - want| / max(want, median of want)`` over the
    leaves (``keep`` selects them), and the leaf it is on."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = sorted(want[i] for i in idx)[len(idx) // 2]
    worst, at = 0.0, -1
    for i in idx:
        gap = abs(got[i] - want[i]) / max(want[i], med, 1e-30)
        if gap > worst or at < 0:
            worst, at = gap, i
    return {"gap": worst, "leaf": at}
