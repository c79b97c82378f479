"""The ranks of a data-parallel cell: one process a card, each started by
the port's ``spawn_ranks`` (a ``spawn`` start, so the function a rank runs
lives in this module, which the children import by name; the kinds are
loaded under made-up names that they could not).

``train_dp_rank`` joins the port's process group (``make_mesh``: NCCL on
the cards, gloo on the CPU), loads the room once and runs one job a
``(seed, fault)`` of the spec, each on a trainer and a state of its own
from the seed, through the port's ``make_dp_train_chunk``:

- the first chunk, which the check follows: the first gradient as Adam got
  it and each leaf's change over the chunk, as norms a leaf, the grid after
  its first update, the losses, and ``replica_gap``, the largest difference
  between rank 0's leaves and any other rank's after the chunk;
- with ``window`` (a benchmark run, one job): the warm-up to
  ``warmup_steps``, then the window, which opens and closes on every rank
  together (a device sync and a barrier on a gloo group of the harness's
  own), rank 0 deciding after each chunk whether another starts; with
  ``--trace 1`` every rank profiles its own window and runs the port's
  tracer, and rank 0 hands back its trace and the tracer's readings.

Rank 0 hands back the records; every rank its peak memory, its traced busy
and window seconds, and the forbidden modules it loaded by the time its
window closed.
"""

from __future__ import annotations

import gc
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from benchmark.harness import loads
from benchmark.harness import manifest as mf
from benchmark.harness.trace import traced_window
from benchmark.reference import parts


def _drop_allreduce():
    """Every rank steps on its own gradient: the all-reduce of the
    gradients left out; returns the undo."""
    from virus_nerf_tpu_torch.training import trainer

    orig = trainer.all_reduce_grads_mean_
    trainer.all_reduce_grads_mean_ = lambda params, group: None

    def undo():
        trainer.all_reduce_grads_mean_ = orig

    return undo


def _half_batch():
    return mf.kind_module("train").plant_half_batch()


# the faults a rank plants in the program by name
FAULTS = {"half_batch": _half_batch, "allreduce_dropped": _drop_allreduce}


class RankCtx(loads.Ctx):
    """A rank's context: its ``sync`` waits for its own card, then for
    every rank on the harness's gloo group."""

    def __init__(self, *args, control_group=None):
        super().__init__(*args)
        self.control_group = control_group

    def sync(self):
        super().sync()
        dist.barrier(group=self.control_group)


def replica_gap(params, group) -> float:
    """The largest absolute difference between rank 0's leaves and any
    other rank's (NaN where a leaf is not finite)."""
    worst = None
    for p in params:
        ref = p.detach().clone()
        dist.broadcast(ref, src=0, group=group)
        gap = (p.detach() - ref).abs().max().double()
        worst = gap if worst is None else torch.maximum(worst, gap)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
    return float(worst)


def _first_chunk(mesh, state, chunk, values, keep_grid: bool) -> dict:
    train = mf.kind_module("train")
    first = train.FirstStep(state, values)
    params0 = [p.detach().clone() for p in state.model.parameters()]
    m = chunk(state)
    first.handle.remove()
    params = [p.detach() for p in state.model.parameters()]
    rec = {"losses": m["loss"].double().tolist(),
           "grad_norms": None if first.m1 is None else train.grad_norms(first.m1),
           "change_norms": train.change_norms(params, params0),
           "grid1": None if first.grid1 is None else first.grid1.float().cpu().numpy(),
           "replica_gap": replica_gap(params, mesh.group)}
    if keep_grid:
        rec["grid"] = values(state.grid).float().cpu().numpy()
        rec["occ"] = state.grid.occ_bool.cpu().numpy()
    return rec


def _window(ctx, state, chunk, rank: int) -> list:
    """The measured chunks, back to back, to the first chunk end after
    ``ctx.seconds`` on rank 0's clock; opened and closed by ``ctx.sync``."""
    go = torch.ones(1, dtype=torch.int32)
    rows = []
    ctx.sync()
    t0 = time.perf_counter()
    while True:
        if rank == 0:
            go[0] = int(time.perf_counter() - t0 < ctx.seconds)
        dist.broadcast(go, src=0, group=ctx.control_group)
        if not go[0]:
            break
        rows.append(chunk(state))
    ctx.sync()
    ctx.window_s = time.perf_counter() - t0
    return rows


def train_dp_rank(rank: int, world: int, init_method: str, spec: dict) -> dict:
    from virus_nerf_tpu_torch.parallel.data_parallel import (
        make_dp_train_chunk,
        make_mesh,
    )
    from virus_nerf_tpu_torch.training.trainer import Trainer
    from virus_nerf_tpu_torch.utils import tracing

    from benchmark.harness.main import forbidden_modules

    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    device = (torch.device("cuda", rank) if spec["device"] == "cuda"
              else torch.device("cpu"))
    mesh = make_mesh(world, rank=rank, device=device, init_method=init_method,
                     timeout=timedelta(seconds=spec["timeout"]))
    control = dist.new_group(backend="gloo")
    tr = spec["traffic"]
    trace = bool(spec["window"] and spec["trace"])
    tracing.enable(trace)
    cfg = loads.program_config(spec["conf"])
    (ds, scene, _), _ = loads.datasets(cfg, device, test=False)
    values = parts.grid(cfg.model.grid_type).program_values
    out = {"records": []}
    for seed, fault in spec["jobs"]:
        undo = FAULTS[fault]() if fault else None
        try:
            ctx = RankCtx(spec["cell"], spec["conf"], tr, seed, spec["seconds"], trace,
                          device, 0.0, control_group=control)
            trainer = Trainer(cfg, ds, scene=scene, device=device)
            state = trainer.init_state(seed)
            chunk = make_dp_train_chunk(trainer, mesh, tr["chunk_steps"])
            rec = _first_chunk(mesh, state, chunk, values,
                               keep_grid=fault is None)
            if spec["window"]:
                out.update(_measure(ctx, state, chunk, tr, rank, cfg))
        finally:
            if undo is not None:
                undo()
        if rank == 0:
            out["records"].append(rec)
        del trainer, state, chunk, ctx
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    tracing.enable(False)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    out["forbidden"] = forbidden_modules()
    dist.barrier(group=control)
    return out if rank == 0 else {k: out[k] for k in (
        "peak_bytes", "forbidden", "busy_s", "window_s") if k in out}


def _measure(ctx, state, chunk, tr: dict, rank: int, cfg) -> dict:
    """The warm-up, then the window; rank 0's readings of it, and every
    rank's traced seconds."""
    while state.step < tr["warmup_steps"]:
        chunk(state)
    ctx.sync()
    t_open = time.time()
    steps0 = state.step
    if ctx.trace:
        with traced_window(ctx):
            rows = [chunk(state) for _ in range(tr["trace_chunks"])]
    else:
        rows = _window(ctx, state, chunk, rank)
    steps = state.step - steps0
    res = {}
    if ctx.trace:
        res.update(busy_s=ctx.traced.busy_s, window_s=ctx.traced.window_s)
    if rank != 0:
        return res
    metric = {k: torch.cat([r[k] for r in rows]).double().cpu().numpy()
              for k in ("loss", "vr_samples", "rm_samples")}
    world = dist.get_world_size()
    # the sample counts are summed over the ranks: a card's share is
    # their mean
    ctx.counters.update(steps=steps, ranks=world,
                        vr_samples=float(metric["vr_samples"].sum()) / world,
                        rm_samples=float(metric["rm_samples"].sum()) / world,
                        vr_samples_all=float(metric["vr_samples"].sum()))
    res.update(t_open=t_open, attempted=steps,
               failed=int((~np.isfinite(metric["loss"])).sum()),
               counters=dict(ctx.counters),
               trace=ctx.traced if ctx.trace else None)
    if not ctx.trace:
        res["train_rays_per_s"] = steps * cfg.training.batch_size / ctx.window_s
    return res
