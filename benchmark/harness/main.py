"""One run of one cell: set-up, window, check, result line.

``run_cell`` does the work on any device (the tests drive it on the CPU
at a tiny size); ``main`` is the command: it refuses to run without the
cards the cell asks for, and prints the result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
from typing import Dict, Optional

import torch

from benchmark.harness import manifest as mf
from benchmark.harness import roofline
from benchmark.harness.checks import run_check
from benchmark.harness.loads import Ctx, run_load

# modules that must not be loaded in the process that prints a result,
# compared by top-level name (the part before the first dot)
FORBIDDEN = ("jax", "jaxlib", "flax", "virus_nerf_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class MetricCtx:
    """What a per-layer metric's reader sees: the traced window
    (``trace``), the run's counters (the port's tracer's among them), the
    configuration (``cfg``, its file's ``config``) and the roofline
    module."""

    def __init__(self, ctx: Ctx):
        self.trace = ctx.traced
        self.counters = ctx.counters
        self.cfg = ctx.cfg
        self.roofline = roofline


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, manifest: Optional[dict] = None,
             conf: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[Dict[str, float]] = None,
             ctx_out: Optional[list] = None) -> dict:
    """One run; returns the result's dict (without ``device``) and, under
    ``checks``, each number compared beside its limit.  ``conf``,
    ``traffic`` and ``limits`` replace the cell's files (the tests' tiny
    sizes); ``ctx_out`` receives the run's context."""
    man = mf.load_manifest() if manifest is None else manifest
    w = mf.workload(man, cell)
    conf = mf.config_file(man, w["config"]) if conf is None else conf
    traffic = mf.traffic_file(w["traffic"]) if traffic is None else traffic
    limits = mf.limits_file(cell) if limits is None else limits
    ctx = Ctx(cell, conf, traffic, seed, seconds, trace, device, t_start)
    run_load(ctx)
    if ctx_out is not None:
        ctx_out.append(ctx)
    peak = ctx.peak_bytes
    if peak is None:
        peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    if not trace:
        ctx.e2e["peak_mem_gib"] = peak / 2**30
    metrics = {}
    if trace:
        mctx = MetricCtx(ctx)
        for m in mf.per_layer(man, cell):
            value = mf.metric_reader(m["name"])(mctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        ctx.e2e["setup_s"] = ctx.setup_s
        for m in mf.end_to_end(man, cell):
            metrics[m["name"]] = {"value": float(ctx.e2e[m["name"]]), "unit": m["unit"]}
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = run_check(ctx)
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": bool(correct), "attempted": int(ctx.attempted),
           "failed": int(ctx.failed), "metrics": metrics,
           "memory_peak_bytes": int(peak), "counters": ctx.counters}
    if trace and ctx.traced is not None:
        out["busy_s"], out["window_s"] = ctx.busy_window or (
            ctx.traced.busy_s, ctx.traced.window_s)
        out["breakdown"] = ctx.traced.breakdown()
    out["checks"] = checks
    return out


def _power_limit() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def main(argv, t_start: float) -> int:
    args = _parse(argv)
    man = mf.load_manifest()
    w = mf.workload(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell {w['name']} needs {w['chips']} CUDA card(s), "
              f"this machine has {n}; no result", file=sys.stderr, flush=True)
        return 2
    from virus_nerf_tpu_torch.ops import _build

    _build.library()  # the program's kernels: built in the first run only
    card = _power_limit()
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", t_start, manifest=man)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; no result", file=sys.stderr,
              flush=True)
        return 3
    checks = res.pop("checks")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(w["chips"]),
              "memory_peak_bytes": res.pop("memory_peak_bytes"),
              "card": card}
    if args.trace:
        device["busy_s"] = res.pop("busy_s", 0.0)
        device["window_s"] = res.pop("window_s", 0.0)
    res["device"] = device
    res["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0
