"""The rooms, written once per checkout into ``benchmark/.cache/rooms/``.

A configuration names its room writer (``benchmark/rooms/<writer>.py``,
whose ``write_room(out, **args)`` writes a room into a folder) and the
writer's arguments; the room's folder is keyed by both, so another
writer or other arguments get their own.  A room is written into a
temporary folder beside its final one and renamed when whole, so a run that
was cut leaves no half room behind.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import shutil

from benchmark.harness.manifest import BENCH_DIR

ROOMS_DIR = os.path.join(BENCH_DIR, ".cache", "rooms")


def room_dir(room: dict, base: str = ROOMS_DIR) -> str:
    """The room's folder, written first if it is not there."""
    key = json.dumps({"writer": room["writer"], "args": room["args"]},
                     sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    out = os.path.join(base, f"{room['writer']}-{digest}")
    if os.path.isdir(out):
        return out
    os.makedirs(base, exist_ok=True)
    tmp = out + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    mod = importlib.import_module(f"benchmark.rooms.{room['writer']}")
    args = dict(room["args"])
    if "img_wh" in args:
        args["img_wh"] = tuple(args["img_wh"])
    mod.write_room(tmp, **args)
    os.replace(tmp, out)
    return out
