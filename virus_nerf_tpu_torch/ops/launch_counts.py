"""Kernel launch counts across CUDA graph replays.

Each kernel wrapper adds one to its ``.launches`` where it launches its
kernel, and nowhere else.  Under a CUDA graph capture the wrapper runs
once, its launch is recorded into the graph, and the card runs the kernel
at every replay with no Python in between.  So a graph's record
(:class:`GraphLaunches`) keeps what the graph holds (how far each
registered counter grew while it was captured) and how often it was
replayed, and :func:`launches` counts what a run launched: the counter,
less what captures added to it, plus what each graph holds times its
replays.  ``Trainer.make_train_chunk`` keeps a record for every graph it
captures.

The kernel wrappers register their counters at import; a caller may
register another object with a ``.launches`` count (a counted wrapper of
its own) before the captures it should see.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List

COUNTERS: List = []  # objects with a ``.launches`` count


def register(counter):
    """Count ``counter.launches`` in every later graph capture; returns
    the counter."""
    if not any(c is counter for c in COUNTERS):
        COUNTERS.append(counter)
    return counter


class GraphLaunches:
    """What one CUDA graph launches a replay, and how often it was
    replayed; every record stays in ``GraphLaunches.records``."""

    records: List["GraphLaunches"] = []

    def __init__(self):
        self.held: Dict[object, int] = {}
        self.replays = 0
        self.captured = 0  # 1 while its capture's increments are counted
        GraphLaunches.records.append(self)

    @contextlib.contextmanager
    def capture(self):
        """Around the capture: what each registered counter gained is what
        the graph holds."""
        before = [c.launches for c in COUNTERS]
        yield
        self.held = {c: c.launches - b for c, b in zip(COUNTERS, before)
                     if c.launches != b}
        self.captured = 1


def launches(counter) -> int:
    """The launches of ``counter``'s kernel since its count was last reset
    (:func:`reset`), graph replays included."""
    return counter.launches + sum(
        r.held.get(counter, 0) * (r.replays - r.captured)
        for r in GraphLaunches.records)


def reset(counters: Iterable) -> None:
    """Set ``counters`` to 0 and every graph's replays since to 0."""
    for c in counters:
        c.launches = 0
    for r in GraphLaunches.records:
        r.replays = r.captured = 0
