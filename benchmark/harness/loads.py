"""The general generator: a traffic mix (``benchmark/traffic/<mix>.json``)
is data, and its ``kind`` names the closed loop that reads it,
``benchmark/kinds/<kind>.py``, found by name.  A new mix of a kind is a
data file; a new kind is a new module beside the others.

A kind module has:

- ``run(ctx)``: set-up from ``--seed`` through the program's normal entry
  points, then the window (``ctx.seconds``, or with ``--trace 1`` a fixed
  stretch under the profiler, ``trace.traced_window``, the port's tracer
  on from the set-up); it sets ``setup_s``, ``attempted``, ``failed``, the
  end-to-end metrics (``ctx.e2e``), the counters, and what its check reads
  (``ctx.record``); a kind that runs on several cards in processes of its
  own also sets ``peak_bytes`` and, traced, ``busy_window``;
- ``check(ctx)``: the numbers compared with the plain reference, run once
  the window has closed and the peak memory has been read;
- ``NUMBERS``: their names (the keys of ``benchmark/checks/<cell>.json``);
- ``short(traffic)``: the mix with the window cut short, for the limits'
  readings (``harness/readings.py``);
- ``control(ctx)``: the control's numbers (the reference one precision
  lower, in the program's place);
- ``FAULTS``: the faults planted in the program for the readings, each a
  function that plants it and returns the undo.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness import manifest as mf
from benchmark.harness.rooms import room_dir


class Ctx:
    """What a run hands on: the configuration's file (``conf``), the
    traffic mix, the seed, the timings, counters, the trace, and the
    records the check reads."""

    def __init__(self, cell: str, conf: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, t_start: float):
        self.cell, self.conf, self.traffic = cell, conf, traffic
        self.cfg = conf["config"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        self.setup_s = math.nan
        self.window_s = math.nan
        self.attempted = 0
        self.failed = 0
        self.e2e: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.traces: list = []
        self.record: dict = {}
        # set by a kind whose ranks run in processes of their own: the
        # largest peak over its cards, and the device's busy and window
        # seconds averaged over them
        self.peak_bytes = None
        self.busy_window = None

    @property
    def traced(self):
        return self.traces[0] if self.traces else None

    @property
    def kind(self):
        return mf.kind_module(self.traffic["kind"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def program_config(conf: dict):
    """The program's ``Config`` from the configuration's file, its room's
    folder filled in (written first if the cache lacks it)."""
    from virus_nerf_tpu_torch.configs.config import apply_cli_overrides, load_config

    cfg = load_config(conf["config"])
    room = conf["room"]
    apply_cli_overrides(cfg, [f"{room['dataset_dir_key']}={room_dir(room)}"])
    return cfg


def datasets(cfg, device, test: bool):
    """The program's train split (and test split) of the room."""
    from virus_nerf_tpu_torch.data import make_dataset

    train = make_dataset(cfg, "train", device=device)
    return train, (make_dataset(cfg, "test", scene=train[1], device=device)
                   if test else None)


def run_load(ctx: Ctx) -> None:
    """The kind's ``run``; with ``--trace 1`` the port's tracer is on for
    it, from the set-up (so the captured graphs hold its stamps), and off
    afterwards; with ``--trace 0`` it stays off."""
    from virus_nerf_tpu_torch.utils import tracing

    tracing.enable(ctx.trace)
    try:
        ctx.kind.run(ctx)
    finally:
        tracing.enable(False)
