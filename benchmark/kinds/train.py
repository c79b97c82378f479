"""``kind: train``: ``Trainer.make_train_chunk`` chunks, one caller.

Set-up builds the trainer and its state from ``--seed``
(``Trainer.init_state``) and runs chunks of ``chunk_steps`` through
``warmup_steps``.  The first chunk is the one the check compares: of its
pieces (a grid update, then ``update_interval`` steps) the first runs
eagerly, the second is captured and replayed, the later ones are replays,
so the reference follows eager steps and graph replays alike.  The window
runs chunks back to back, grid updates included, to the first chunk end
after ``--seconds``, closed by a device sync.  ``attempted`` counts steps;
a step whose loss is not finite failed.  With ``--trace 1`` the window is
``trace_chunks`` chunks under the profiler, the port's tracer on from the
set-up (its phase stamps in every captured graph) and read over the
window (``harness/trace.py``).

The check: the reference (``reference/train.py``) builds the weights, the
grid and the draws from the same seed and follows the whole first chunk.

- ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the first
  ``check_steps`` losses;
- ``grad_gap``: the first step's gradient as the optimizer got it (its
  first moment after one step over ``1 - b1``), by the worst leaf: the gap
  between the program's norm and the reference's over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same measure on the parameters' change over the
  whole chunk, replays included, leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (they move by
  round-off);
- ``grid_gap``: the largest difference of the grid's values after the
  first update (the VIRUS grid's probabilities), the program's read by
  ``program_values`` of the grid's reference part
  (``reference/grids/<grid_type>.py``).

The losses and the grid are compared at the chunk's start because later
in the chunk they part by chaos on some seeds: the loss takes discrete
choices (which rays a sensor's reading picks), so a round-off difference
can switch a term, and the gap then grows over the steps, in eager steps
as in replays.  The change over the chunk bears that with a limit set
from the faults, which read far above it.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import checks, loads
from benchmark.harness.trace import traced_window
from benchmark.reference import parts

ADAM_B1 = 0.9
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grid_gap")


class FirstStep:
    """The optimizer's post-step hook: the first moments and the grid's
    values (``values(state.grid)``) after the first step (an eager step:
    the hook never fires in a capture or a replay)."""

    def __init__(self, state, values):
        self.state, self.values, self.m1, self.grid1 = state, values, None, None
        self.handle = state.optimizer.register_step_post_hook(self._hook)

    def _hook(self, opt, args, kwargs):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return
        if int(opt.count) == 1:
            self.m1 = [opt._moments(p)[0].clone()
                       for p in self.state.model.parameters()]
            self.grid1 = self.values(self.state.grid).clone()


def run(ctx) -> None:
    from virus_nerf_tpu_torch.training.trainer import Trainer

    tr = ctx.traffic
    cfg = loads.program_config(ctx.conf)
    (ds, scene, _), _ = loads.datasets(cfg, ctx.device, test=False)
    trainer = Trainer(cfg, ds, scene=scene, device=ctx.device)
    state = trainer.init_state(ctx.seed)
    params0 = [p.detach().clone() for p in state.model.parameters()]
    values = parts.grid(cfg.model.grid_type).program_values
    first = FirstStep(state, values)
    chunk = trainer.make_train_chunk(tr["chunk_steps"])
    _, keys, m = chunk(state)
    first.handle.remove()
    ctx.record.update(
        params0=params0, m1=first.m1, grid1=first.grid1,
        params=[p.detach().clone() for p in state.model.parameters()],
        grid=values(state.grid).clone(), occ=state.grid.occ_bool.clone(),
        losses=m[:, keys.index("loss")].tolist())
    while state.step < tr["warmup_steps"]:
        chunk(state)
    ctx.sync()
    ctx.setup_s = time.perf_counter() - ctx.t_start

    rows = []
    steps0 = state.step
    if ctx.trace:
        with traced_window(ctx):
            for _ in range(tr["trace_chunks"]):
                rows.append(chunk(state)[2])
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            rows.append(chunk(state)[2])
        ctx.sync()
        ctx.window_s = time.perf_counter() - t0
    metrics = torch.cat(rows).cpu().numpy()
    steps = state.step - steps0
    loss = metrics[:, keys.index("loss")]
    ctx.attempted = steps
    ctx.failed = int((~np.isfinite(loss)).sum())
    ctx.counters.update(steps=steps, vr_samples=float(metrics[:, keys.index("vr_samples")].sum()),
                        rm_samples=float(metrics[:, keys.index("rm_samples")].sum()))
    if not ctx.trace:
        ctx.e2e["train_rays_per_s"] = steps * cfg.training.batch_size / ctx.window_s
    del trainer, state, chunk, ds, scene


def loss_gaps(rec: dict, ref: dict) -> List[float]:
    return [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(rec["losses"], ref["losses"])]


def grad_norms(m1) -> List[float]:
    """The first gradient as the optimizer got it, a norm a leaf: its first
    moments after one step over ``1 - b1``."""
    from benchmark.reference.train import leaf_norms

    return leaf_norms([m / (1.0 - ADAM_B1) for m in m1])


def change_norms(params, params0) -> List[float]:
    from benchmark.reference.train import leaf_norms

    return leaf_norms([a - b for a, b in zip(params, params0)])


def numbers(rec: dict, ref: dict, n_losses: int) -> Dict[str, float]:
    """The check's numbers from the program's record and the reference's
    (``reference.train.run_steps``); ``n_losses``: the first losses
    compared."""
    if rec.get("m1") is None or len(rec["losses"]) != len(ref["losses"]):
        # the program's first step never reached the optimizer
        return dict.fromkeys(NUMBERS, math.inf)
    return gaps(rec["losses"], grad_norms(rec["m1"]),
                change_norms(rec["params"], rec["params0"]), rec["grid1"], ref,
                n_losses)


def gaps(losses, g_prog, c_prog, grid1, ref: dict, n_losses: int) -> Dict[str, float]:
    """The four numbers from the program's losses, norms a leaf (the first
    gradient's, each leaf's change) and grid after the first update."""
    from benchmark.reference.train import leaf_norms, worst_leaf_gap

    losses = loss_gaps({"losses": losses}, ref)[:n_losses]
    g_ref = leaf_norms(ref["grads1"])
    med = sorted(g_ref)[len(g_ref) // 2]
    keep = [g >= 1e-3 * med for g in g_ref]
    c_ref = change_norms(ref["params"], ref["params0"])
    return {
        "loss_gap": max(losses) if losses else math.inf,
        "grad_gap": worst_leaf_gap(g_prog, g_ref)["gap"],
        "change_gap": worst_leaf_gap(c_prog, c_ref, keep)["gap"],
        "grid_gap": float((grid1.float() - ref["grid1"].float()).abs().max()),
    }


def _reference(ctx, tf32: bool = False):
    from benchmark.reference.train import run_steps

    cfg, (ds, scene, _), _ = checks.reference_room(ctx, "train")
    return run_steps(cfg, ds, scene, ctx.seed, len(ctx.record["losses"]), tf32=tf32)


def check(ctx) -> Dict[str, float]:
    rec = ctx.record
    ref = rec["ref"] = _reference(ctx)
    # for the readings' look at a seed that reads high: where along the
    # chunk the losses part, and how many cells the two grids mark
    # differently after it
    rec["detail"] = {
        "loss_steps": loss_gaps(rec, ref),
        "chunk_grid_gap": float((rec["grid"].float()
                                 - ref["grid"].values().float()).abs().max()),
        "occ_flips": int((rec["occ"] != ref["grid"].occ_bool).sum())}
    return numbers(rec, ref, ctx.traffic["check_steps"])


def short(traffic: dict) -> dict:
    """The mix with the window cut short: the check reads the first chunk,
    which a short run has as a long one does."""
    return dict(traffic, warmup_steps=traffic["chunk_steps"])


def control(ctx) -> Dict[str, float]:
    """The TF32 reference in the program's place, against the float32
    reference of the check."""
    low = _reference(ctx, tf32=True)
    rec = dict(low, m1=[(1.0 - ADAM_B1) * g for g in low["grads1"]])
    return numbers(rec, ctx.record["ref"], ctx.traffic["check_steps"])


def plant_half_batch():
    """The program's loss over the first half of each batch only, the mean
    taken over the rest; returns the undo."""
    from virus_nerf_tpu_torch.training import trainer

    orig = trainer.compute_loss

    def half(results, batch, weights, sensors=("USS", "ToF")):
        n = batch.rgb.shape[0]
        h = n // 2
        cut = {k: (v[:h] if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n else v)
               for k, v in results.items()}
        b = batch._replace(
            img_idxs=batch.img_idxs[:h], pix_idxs=batch.pix_idxs[:h],
            rays_o=batch.rays_o[:h], rays_d=batch.rays_d[:h], rgb=batch.rgb[:h],
            depths={k: v[:h] for k, v in batch.depths.items()}, times=batch.times[:h])
        return orig(cut, b, weights, sensors)

    trainer.compute_loss = half

    def undo():
        trainer.compute_loss = orig

    return undo


# a step that returns its state unchanged reads 1 by ``change_gap`` and
# needs no run
FAULTS = {"half_batch": plant_half_batch}
