"""The two readings every limit of ``benchmark/checks/<cell>.json`` is set
between, read on the card at the cell's own size, many seeds in one
process (the rooms loaded once):

- ``program``: the numbers of sound runs (the lower reading is their
  largest over the seeds);
- ``control``: the reference put in the program's place and computed one
  precision lower than the configuration states, TF32 matrix products for
  float32 with TF32 off (the upper reading is its smallest);
- one entry for each fault of the cell's kind (``FAULTS`` of
  ``benchmark/kinds/<kind>.py``; training: ``half_batch``, half of each
  batch left out of the loss; data-parallel training also
  ``allreduce_dropped``), planted in the program, on every seed or on the
  first ``--fault-seeds``.

    python3 -m benchmark.harness.readings --workload ethz.train \\
        --seeds 11 12 13 [--fault-seeds 3] [--out readings.jsonl]

Each seed's readings are one JSON line.  A kind whose ranks run in
processes of their own (``train_dp``) reads every seed in one start of its
ranks (its ``readings``).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import sys
import time

import torch

from benchmark.harness import checks, loads
from benchmark.harness import manifest as mf
from benchmark.harness.main import run_cell

NO_LIMITS = collections.defaultdict(lambda: math.inf)


def cache_rooms():
    """Load each split once while the readings run, for the program and
    for the reference alike; returns the undo."""
    program, reference = loads.datasets, checks.reference_room
    memo = {}

    def program_datasets(cfg, device, test):
        key = ("program", json.dumps(cfg.to_dict(), sort_keys=True, default=str),
               str(device), test)
        if key not in memo:
            memo[key] = program(cfg, device, test)
        return memo[key]

    def reference_room(ctx, split):
        key = ("reference", json.dumps(ctx.cfg, sort_keys=True),
               json.dumps(ctx.conf["room"], sort_keys=True), split)
        if key not in memo:
            memo[key] = reference(ctx, split)
        return memo[key]

    loads.datasets = program_datasets
    checks.reference_room = reference_room

    def undo():
        loads.datasets, checks.reference_room = program, reference

    return undo


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fault-seeds", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    from virus_nerf_tpu_torch.ops import _build

    _build.library()
    readings(args.workload, args.seeds, args.seconds, "cuda:0", args.out,
             fault_seeds=args.fault_seeds)
    return 0


def _emit(line: dict, out) -> None:
    print(json.dumps(line), flush=True)
    if out:
        out.write(json.dumps(line) + "\n")
        out.flush()


def readings(cell: str, seeds, seconds: float, device, out_path=None,
             manifest=None, conf=None, traffic=None, fault_seeds=None) -> list:
    """The readings of ``seeds``, one JSON line each (printed, and
    appended to ``out_path``); ``manifest``, ``conf`` and ``traffic``
    replace the cell's files (the tests' tiny sizes); the faults run on the
    first ``fault_seeds`` seeds (every seed where None)."""
    man = mf.load_manifest() if manifest is None else manifest
    w = mf.workload(man, cell)
    traffic = mf.traffic_file(w["traffic"]) if traffic is None else traffic
    kind = mf.kind_module(traffic["kind"])
    traffic = kind.short(traffic)
    n_fault = len(seeds) if fault_seeds is None else fault_seeds
    undo_cache = cache_rooms()
    out = open(out_path, "a") if out_path else None
    lines = []
    try:
        if hasattr(kind, "readings"):
            conf = mf.config_file(man, w["config"]) if conf is None else conf
            lines = kind.readings(cell, list(seeds), device, conf, traffic, n_fault)
            for line in lines:
                _emit(line, out)
            return lines
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            line = {"workload": cell, "seed": seed}
            kept = []
            res = run_cell(cell, seed, seconds, False, device, t0, manifest=man,
                           conf=conf, traffic=traffic, limits=NO_LIMITS,
                           ctx_out=kept)
            line["program"] = {k: v["value"] for k, v in res["checks"].items()}
            line["attempted"], line["failed"] = res["attempted"], res["failed"]
            line["control"] = kind.control(kept[0])
            if "detail" in kept[0].record:
                line["detail"] = kept[0].record["detail"]
            for name, plant in kind.FAULTS.items():
                if i >= n_fault:
                    break
                undo = plant()
                try:
                    res = run_cell(cell, seed, 0.5, False, device, t0, manifest=man,
                                   conf=conf, traffic=traffic, limits=NO_LIMITS)
                finally:
                    undo()
                line[name] = {k: v["value"] for k, v in res["checks"].items()}
            line["seconds"] = time.perf_counter() - t0
            kept.clear()
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            lines.append(line)
            _emit(line, out)
    finally:
        undo_cache()
        if out:
            out.close()
    return lines


if __name__ == "__main__":
    sys.exit(main())
