"""``kind: eval``: ``Evaluator.evaluate_depth`` calls, one caller.

Set-up trains ``train_steps`` steps from ``--seed`` (``Trainer.train``),
the map users score, and makes ``warmup_calls`` calls; the window makes
calls back to back, each of ``images`` test images drawn with replacement
by a generator seeded from ``--seed``, NeRF scans only: the mid-training
evaluation's request.  ``attempted`` counts calls; a call that raises or
returns a non-finite zone-3 NND failed.  With ``--trace 1`` the window is
``trace_calls`` calls under the profiler, the port's tracer on and read
over the window (``harness/trace.py``): its spans ``evaluator.call``,
``evaluator.render``, ``evaluator.gt_scan`` and ``evaluator.nnd``.

The check: no reference can follow the program's training steps to the
same map (float chaos and the march's discrete choices), so the reference
trains a map of its own from the seed (``reference/train.py``, the same
``train_steps``) and hands its weights and grid to both sides.  The
program's model (the window's own ``state.model``) takes the weights, and
the window's evaluator repeats ``check_calls`` of the window's calls,
drawn from the seed with the last one in, on the same image sets; the
reference (``reference/evaluate.py``) makes the same calls on the same
map: the scan rays, the march at ``evaluation.max_samples_per_ray``, the
forward pass, the compositing, the depths and the NND metrics.

- ``depth_gap_m``: the largest difference of a NeRF scan depth, metres;
- ``nnd_gap``: the largest ``|NND_prog - NND_ref| / NND_ref`` of the
  zone-3 mean NND.
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import checks, loads
from benchmark.harness.trace import traced_window

NUMBERS = ("depth_gap_m", "nnd_gap")


def _answer(metrics, data) -> Tuple[float, np.ndarray]:
    """A call's (zone-3 mean NND, NeRF scan depths)."""
    return (float(metrics["NeRF"]["nn_mean"]["zone3"]),
            np.asarray(data["NeRF"]["depths"], np.float32))


def run(ctx) -> None:
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.training.trainer import Trainer

    tr = ctx.traffic
    cfg = loads.program_config(ctx.conf)
    cfg.training.max_steps = tr["train_steps"]
    (ds, scene, _), (test_ds, _, test_info) = loads.datasets(cfg, ctx.device, test=True)
    trainer = Trainer(cfg, ds, scene=scene, device=ctx.device)
    state = trainer.train(trainer.init_state(ctx.seed))
    evaluator = Evaluator(cfg, test_ds, scene, img_wh=test_info.get("img_wh"),
                          device=ctx.device)
    rng = np.random.default_rng(ctx.seed)
    n_img = tr["images"]

    def call(idxs):
        return _answer(*evaluator.evaluate_depth(
            state.model, state.grid.occ_bool, idxs, sensors=("NeRF",)))

    for _ in range(tr["warmup_calls"]):
        call(rng.choice(test_ds.n_images, size=n_img, replace=True))
    ctx.sync()
    ctx.setup_s = time.perf_counter() - ctx.t_start

    calls, times = [], []

    def one():
        idxs = rng.choice(test_ds.n_images, size=n_img, replace=True)
        t = time.perf_counter()
        try:
            nnd, depths = call(idxs)
        except Exception as exc:  # a failed call counts, the run goes on
            nnd, depths = math.nan, None
            print(f"eval call failed: {exc!r}", file=sys.stderr, flush=True)
        times.append(time.perf_counter() - t)
        calls.append((idxs, nnd, depths))

    if ctx.trace:
        with traced_window(ctx):
            for _ in range(tr["trace_calls"]):
                one()
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            one()
        ctx.window_s = time.perf_counter() - t0
    ctx.attempted = len(calls)
    ctx.failed = sum(1 for _, nnd, _ in calls if not math.isfinite(nnd))
    rays = n_img * cfg.evaluation.res_angular
    ctx.counters.update(calls=len(calls), rays=rays * len(calls))
    if not ctx.trace:
        ms = [t * 1e3 for t in times]
        ctx.e2e["eval_rays_per_s"] = rays * len(calls) / ctx.window_s
        ctx.e2e["eval_call_ms_p90"] = (
            statistics.quantiles(ms, n=10, method="inclusive")[8]
            if len(ms) > 1 else ms[0])
        ctx.counters["eval_call_ms_median"] = statistics.median(ms)
    # the check repeats calls through the window's evaluator and model; the
    # trainer, its optimizer state and its graphs go
    ctx.record.update(calls=calls, evaluator=evaluator, model=state.model)
    del trainer, state, ds, scene


def sample_calls(n_calls: int, k: int, seed: int) -> List[int]:
    """``k`` of the window's calls drawn from the seed, the last one in."""
    if n_calls <= k:
        return list(range(n_calls))
    rng = np.random.default_rng(seed)
    rest = rng.choice(n_calls - 1, size=k - 1, replace=False)
    return sorted(int(i) for i in rest) + [n_calls - 1]


def numbers(got, want) -> Dict[str, float]:
    """The numbers from the (NND, depths) of each call on one side and the
    reference's on the other; a call without an answer fails both."""
    depth_gap, nnd_gap = 0.0, 0.0
    for (nnd, depths), (r_nnd, r_depths) in zip(got, want):
        if depths is None or not math.isfinite(nnd):
            return dict.fromkeys(NUMBERS, math.inf)
        a, b = np.asarray(depths, np.float64), np.asarray(r_depths, np.float64)
        if a.shape != b.shape or (np.isnan(a) != np.isnan(b)).any():
            return dict.fromkeys(NUMBERS, math.inf)
        ok = ~np.isnan(a)
        if ok.any():
            depth_gap = max(depth_gap, float(np.abs(a[ok] - b[ok]).max()))
        nnd_gap = max(nnd_gap, abs(nnd - r_nnd) / max(abs(r_nnd), 1e-30))
    return {"depth_gap_m": depth_gap, "nnd_gap": nnd_gap}


def reference_map(ctx) -> dict:
    """The reference's own map (``run_steps`` from the seed: its
    ``PlainNGP`` and grid after ``train_steps`` steps), made once a
    run."""
    if "ref" not in ctx.record:
        from benchmark.reference.train import run_steps

        cfg, (ds, scene, _), _ = checks.reference_room(ctx, "train")
        ref = run_steps(cfg, ds, scene, ctx.seed, ctx.traffic["train_steps"])
        ctx.record["ref"] = {"model": ref["model"], "occ_bool": ref["grid"].occ_bool}
    return ctx.record["ref"]


def reference_calls(ctx, idx_list, tf32: bool = False) -> List[Tuple[float, np.ndarray]]:
    """The reference's (zone-3 NND, NeRF depths) of each call's images on
    its own map."""
    from benchmark.reference.evaluate import DepthEvaluator

    ref = reference_map(ctx)
    cfg, (_, scene, _), (test_ds, _, info) = checks.reference_room(ctx, "test")
    ev = DepthEvaluator(cfg, test_ds, scene, img_wh=info.get("img_wh"),
                        device=ctx.device)
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return [_answer(*ev.evaluate_depth(ref["model"], ref["occ_bool"], idxs,
                                           sensors=("NeRF",)))
                for idxs in idx_list]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def program_calls(ctx, idx_list) -> List[Tuple[float, np.ndarray]]:
    """The window's evaluator and model on the reference's map, the same
    calls; a call that raises has no answer."""
    ref = reference_map(ctx)
    model, evaluator = ctx.record["model"], ctx.record["evaluator"]
    weights = dict(zip(ref["model"].names, ref["model"].params))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name].detach().to(p.dtype))
    out = []
    for idxs in idx_list:
        try:
            out.append(_answer(*evaluator.evaluate_depth(
                model, ref["occ_bool"], idxs, sensors=("NeRF",))))
        except Exception as exc:
            print(f"eval check call failed: {exc!r}", file=sys.stderr, flush=True)
            out.append((math.nan, None))
    return out


def _picked(ctx):
    calls = ctx.record["calls"]
    return [calls[i][0] for i in sample_calls(
        len(calls), ctx.traffic["check_calls"], ctx.seed)]


def check(ctx) -> Dict[str, float]:
    idxs = _picked(ctx)
    want = ctx.record["ref_calls"] = reference_calls(ctx, idxs)
    return numbers(program_calls(ctx, idxs), want)


def short(traffic: dict) -> dict:
    """The mix with the window cut short: the check repeats a sample of
    the calls, which a short window has as a long one does."""
    return dict(traffic, warmup_calls=1)


def control(ctx) -> Dict[str, float]:
    """The TF32 reference in the program's place, against the float32
    reference of the check, on the reference's map."""
    return numbers(reference_calls(ctx, _picked(ctx), tf32=True),
                   ctx.record["ref_calls"])


FAULTS: dict = {}
