"""``kind: train_dp``: the port's data parallelism, one process a card.

``ranks`` processes (``spawn_ranks``, the rank function
``harness/ranks.train_dp_rank``) join the port's process group
(``make_mesh``: NCCL on the cards) and run ``make_dp_train_chunk`` chunks of
``chunk_steps``: each rank draws ``batch_size // ranks`` rays and
``budget // ranks`` samples from its own generator, the gradients are
all-reduced to their mean before the fused Adam step, the grid update's
evidence is summed over the ranks, the pieces are CUDA graphs with the
collectives inside.  Set-up, as ``kind: train`` on every rank: the trainer
and its state from ``--seed``, the first chunk (which the check follows),
chunks to ``warmup_steps``.  The window opens and closes on every rank
together and runs chunks back to back to the first chunk end after
``--seconds`` on rank 0's clock; ``train_rays_per_s`` is the window's steps
times the whole batch over rank 0's window.  ``peak_mem_gib`` is the largest
peak over the cards; with ``--trace 1`` each rank profiles its own
``trace_chunks`` chunks, the per-layer metrics read rank 0's, and the
device's busy and window seconds are the ranks' means.

The check: the plain reference (``reference/train.run_steps`` over
``ranks`` virtual ranks on one card, ``world=ranks``) follows the first
chunk from the same seed: each rank's draws from its ``shard_seed``, the
loss and gradient the means over the ranks, each rank's shard of the grid
update with the mean density averaged and the evidence summed, then plain
Adam.  ``loss_gap``, ``grad_gap``, ``change_gap`` and ``grid_gap`` as in
``kind: train``; ``replica_gap``, the largest difference between rank 0's
leaves and any other rank's after the chunk, is 0 when every replica holds
the same bytes.  It runs in the process that prints the result, once the
ranks have ended.

The faults (``harness/ranks.FAULTS``) are planted in the ranks: each
rank's loss over half its batch, and the gradients' all-reduce left out.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import checks, loads, ranks
from benchmark.harness import manifest as mf
from benchmark.harness.rooms import room_dir
from benchmark.reference.train import leaf_norms

TRAIN = mf.kind_module("train")
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grid_gap", "replica_gap")
# the fault the next run's ranks plant (``FAULTS`` sets it, its undo
# clears it)
_FAULT = [None]


def _spec(ctx, jobs, window: bool) -> dict:
    return {"cell": ctx.cell, "conf": ctx.conf, "traffic": ctx.traffic,
            "device": ctx.device.type, "jobs": jobs, "window": window,
            "seconds": ctx.seconds, "trace": ctx.trace,
            # one host thread a rank on the CPU, the run's four on a card
            "threads": 1 if ctx.device.type == "cpu" else 0,
            "timeout": 600 + ctx.seconds + 60 * len(jobs)}


def _spawn(ctx, jobs, window: bool) -> list:
    from virus_nerf_tpu_torch.parallel.data_parallel import spawn_ranks

    room_dir(ctx.conf["room"])  # written once, here, before the ranks read it
    spec = _spec(ctx, jobs, window)
    res = spawn_ranks(ranks.train_dp_rank, int(ctx.traffic["ranks"]), args=(spec,),
                      timeout=spec["timeout"] + 60)
    bad = sorted({m for r in res for m in r["forbidden"]})
    if bad:
        raise RuntimeError(f"a rank loaded {bad}")
    return res


def run(ctx) -> None:
    wall0 = time.time() - (time.perf_counter() - ctx.t_start)
    res = _spawn(ctx, [(ctx.seed, _FAULT[0])], window=True)
    r0 = res[0]
    ctx.record.update(r0["records"][0])
    ctx.setup_s = r0["t_open"] - wall0
    ctx.attempted, ctx.failed = r0["attempted"], r0["failed"]
    ctx.counters.update(r0["counters"])
    ctx.peak_bytes = max(r["peak_bytes"] for r in res)
    if ctx.trace:
        ctx.traces.append(r0["trace"])
        ctx.busy_window = (float(np.mean([r["busy_s"] for r in res])),
                           float(np.mean([r["window_s"] for r in res])))
    else:
        ctx.e2e["train_rays_per_s"] = r0["train_rays_per_s"]


def numbers(rec: dict, ref: dict, n_losses: int) -> Dict[str, float]:
    """``kind: train``'s four numbers from rank 0's record (norms a leaf,
    the grid after the first update) and the reference's, and
    ``replica_gap``."""
    if rec.get("grad_norms") is None or len(rec["losses"]) != len(ref["losses"]):
        # the program's first step never reached the optimizer
        return dict.fromkeys(NUMBERS, math.inf)
    grid1 = torch.from_numpy(rec["grid1"]).to(ref["grid1"].device)
    out = TRAIN.gaps(rec["losses"], rec["grad_norms"], rec["change_norms"], grid1,
                     ref, n_losses)
    return dict(out, replica_gap=float(rec["replica_gap"]))


def _reference(ctx, tf32: bool = False):
    from benchmark.reference.train import run_steps

    cfg, (ds, scene, _), _ = checks.reference_room(ctx, "train")
    return run_steps(cfg, ds, scene, ctx.seed, len(ctx.record["losses"]), tf32=tf32,
                     world=int(ctx.traffic["ranks"]))


def check(ctx) -> Dict[str, float]:
    rec = ctx.record
    ref = rec["ref"] = _reference(ctx)
    if "grid" in rec:
        dev = ref["grid"].values().device
        rec["detail"] = {
            "loss_steps": TRAIN.loss_gaps(rec, ref),
            "chunk_grid_gap": float((torch.from_numpy(rec["grid"]).to(dev)
                                     - ref["grid"].values().float()).abs().max()),
            "occ_flips": int((torch.from_numpy(rec["occ"]).to(dev)
                              != ref["grid"].occ_bool).sum())}
    return numbers(rec, ref, ctx.traffic["check_steps"])


def short(traffic: dict) -> dict:
    """The mix with the window cut short: the check reads the first chunk,
    which a short run has as a long one does."""
    return dict(traffic, warmup_steps=traffic["chunk_steps"])


def control(ctx) -> Dict[str, float]:
    """The TF32 reference over the same virtual ranks in the program's
    place, against the float32 reference of the check (one replica, so its
    ``replica_gap`` is 0)."""
    low = _reference(ctx, tf32=True)
    rec = {"losses": low["losses"], "grad_norms": leaf_norms(low["grads1"]),
           "change_norms": TRAIN.change_norms(low["params"], low["params0"]),
           "grid1": low["grid1"].float().cpu().numpy(), "replica_gap": 0.0}
    return numbers(rec, ctx.record["ref"], ctx.traffic["check_steps"])


def _planter(name: str):
    def plant():
        _FAULT[0] = name

        def undo():
            _FAULT[0] = None

        return undo

    return plant


# a step that returns its state unchanged reads 1 by ``change_gap`` and
# needs no run
FAULTS = {name: _planter(name) for name in ranks.FAULTS}


def readings(cell: str, seeds, device, conf: dict, traffic: dict,
             fault_seeds: int) -> list:
    """The readings of ``seeds`` (``harness/readings.py``) with the ranks
    started once: each seed's first chunk, sound and with each fault on the
    first ``fault_seeds`` seeds, then in this process the reference, the
    control and the numbers of each."""
    t0 = time.perf_counter()
    jobs = [(s, None) for s in seeds] + [
        (s, f) for s in seeds[:fault_seeds] for f in FAULTS]
    ctx = loads.Ctx(cell, conf, traffic, seeds[0], 0.0, False, device, t0)
    recs = dict(zip(jobs, _spawn(ctx, jobs, window=False)[0]["records"]))
    lines = []
    for seed in seeds:
        ctx = loads.Ctx(cell, conf, traffic, seed, 0.0, False, device, t0)
        ctx.record.update(recs[(seed, None)])
        line = {"workload": cell, "seed": seed, "program": check(ctx),
                "control": control(ctx), "detail": ctx.record["detail"]}
        for f in FAULTS:
            if (seed, f) in recs:
                line[f] = numbers(recs[(seed, f)], ctx.record["ref"],
                                  traffic["check_steps"])
        line["seconds"] = time.perf_counter() - t0
        lines.append(line)
        del ctx
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return lines
