"""What decides ``correct``: the window's path against the plain reference.

Run after the window has closed and the peak memory has been read.  Each
kind's ``check`` (``benchmark/kinds/<kind>.py``) says what it compares;
the reference (``benchmark/reference/``) loads the room itself with its
frozen loaders and imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict


def reference_room(ctx, split: str):
    """The reference's configuration and the room's train split (and test
    split, ``split == "test"``), loaded by the frozen loaders."""
    from benchmark.harness.rooms import room_dir
    from benchmark.reference import config as rc

    cfg = rc.load_config(ctx.cfg)
    room = ctx.conf["room"]
    rc.apply_cli_overrides(cfg, [f"{room['dataset_dir_key']}={room_dir(room)}"])
    if cfg.dataset.name == "ETHZ":
        from benchmark.reference.ethz import load_ethz_dataset as load
    elif cfg.dataset.name == "RH2":
        from benchmark.reference.rh import load_rh_dataset as load
    else:
        raise ValueError(f"no reference loader for {cfg.dataset.name}")
    train = load(cfg, split="train", device=ctx.device)
    if split == "train":
        return cfg, train, None
    return cfg, train, load(cfg, split="test", scene=train[1], device=ctx.device)


def run_check(ctx) -> Dict[str, float]:
    return ctx.kind.check(ctx)
