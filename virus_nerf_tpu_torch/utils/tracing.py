"""The port's tracer: host spans, counters and device phase stamps.

One module-level tracer, off by default.  Off, every call returns at once:
:func:`span` hands back one shared no-op context manager, :func:`count`
and :func:`stamp` do nothing, so there is no allocation, no
``record_function``, no launch and no sync, and a CUDA graph captured with
tracing off holds exactly the nodes it would without the tracer.

On (:func:`enable`):

- ``span(name)`` (or a function decorated with ``spanned(name)``) opens a
  ``torch.profiler.record_function(name)``, so the range lies on a
  profiler trace beside the device's work and names the idle gaps inside
  it, and adds its ``time.perf_counter_ns`` duration and one call to
  ``span.<name>``;
- ``count(name, n)`` adds ``n`` to ``count.<name>``;
- ``stamp(phase, device)`` marks the END of ``phase`` (one of
  :data:`PHASES`): the time since the last stamp on that device is charged
  to it.  On a CUDA device a one-thread kernel (``ops/trace_stamp.py``)
  reads the card's global timer on the current stream, so a stamp made
  under a CUDA graph capture runs at every replay; on the CPU the same
  arithmetic runs on the host clock.  Stamps read and write only the
  tracer's own buffer, never the step's data.

:func:`reset` zeroes everything and starts the phase clocks now;
:func:`snapshot` copies the sums to the host once (after the caller's
sync) as ``{"phase.<p>.ms", "phase.<p>.n", "span.<name>.s",
"span.<name>.n", "count.<name>"}``.

Where the stamps and spans are (the phases of the training step, in the
order they end):

- ``between`` (``Trainer._piece_body``, at a piece's start: the wait from
  the last piece's end, on the card the wait on the host's graph launch),
  ``grid_update`` (after the grid update), then per step ``sample``
  (``Trainer.train_step``), ``march`` and ``forward`` (``render_rays``),
  ``loss``, ``backward``, ``adam`` and ``stats``
  (``Trainer.train_step_on``);
- spans ``trainer.chunk``, ``trainer.piece``, ``trainer.warm`` and
  ``trainer.capture``;
- spans ``evaluator.call``, ``evaluator.gt_scan``, ``evaluator.render``
  and ``evaluator.nnd``.

The counters ``trainer.captures`` and ``trainer.replays`` are not counted
here: :func:`snapshot` reads them from the graph records that
``ops/launch_counts.py`` keeps (what was added and replayed since
:func:`reset`; a ``launch_counts.reset`` after :func:`reset` zeroes what
lies under it, so reset the counts first).

The state is the process's, as a profiler's is: a caller enables it before
the set-up whose graphs should hold the stamps (the trainer keys its graphs
by :func:`enabled`, so a stamped graph never stands in for an unstamped
one), resets it before the window and reads it after.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from virus_nerf_tpu_torch.ops.launch_counts import GraphLaunches
from virus_nerf_tpu_torch.ops.trace_stamp import stamp_buffer, trace_stamp

PHASES = ("sample", "march", "forward", "loss", "backward", "adam", "stats",
          "grid_update", "between")
_INDEX = {p: i for i, p in enumerate(PHASES)}
_SLOTS = len(PHASES) + 1  # the last slot takes reset's stamp
_NULL = contextlib.nullcontext()

_on = False
_spans: Dict[str, List[int]] = {}  # name -> [ns, calls]
_counts: Dict[str, float] = {}
_clocks: Dict[torch.device, torch.Tensor] = {}  # device -> stamp buffer
_graphs_at_reset = (0, 0)  # graph records and their replays at reset


def enable(on: bool = True) -> None:
    """Turn the tracer on (or off)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.range.__exit__(*exc)
        acc = _spans.setdefault(self.name, [0, 0])
        acc[0] += dt
        acc[1] += 1
        return False


def span(name: str):
    """A host range named ``name`` (see the module doc); a shared no-op
    when the tracer is off."""
    return _Span(name) if _on else _NULL


def spanned(name: str):
    """Decorate a function so that each call is the span ``name`` (a bare
    call when the tracer is off)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing when off)."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def _start(buf: torch.Tensor) -> None:
    trace_stamp(buf, _SLOTS - 1)  # the last stamp's time: now


def _clock(device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    buf = _clocks.get(device)
    if buf is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "tracing: the first stamp on a device was made inside a CUDA "
                "graph capture; stamp it eagerly first (the trainer's "
                "warm-up does)")
        buf = _clocks[device] = stamp_buffer(_SLOTS, device)
        _start(buf)
    return buf


def stamp(phase: str, device="cpu") -> None:
    """Mark the end of ``phase`` on ``device``'s clock (nothing when
    off)."""
    if _on:
        trace_stamp(_clock(device), _INDEX[phase])


def _graphs() -> tuple:
    recs = GraphLaunches.records
    return len(recs), sum(r.replays for r in recs)


def reset() -> None:
    """Zero every span, counter and phase sum and start the phase clocks
    now (on the card: a fill and one stamp on the current stream).  Not
    inside a CUDA graph capture."""
    global _graphs_at_reset
    _graphs_at_reset = _graphs()
    _spans.clear()
    _counts.clear()
    for buf in _clocks.values():
        buf.zero_()
        _start(buf)


def snapshot() -> Dict[str, float]:
    """Everything recorded since :func:`reset`, on the host (one copy of
    each device's sums; sync the device first)."""
    out: Dict[str, float] = {}
    acc_ns = [0] * len(PHASES)
    calls = [0] * len(PHASES)
    for buf in _clocks.values():
        vals = buf.cpu().tolist()
        for i in range(len(PHASES)):
            acc_ns[i] += vals[i]
            calls[i] += vals[_SLOTS + i]
    for p, ns, n in zip(PHASES, acc_ns, calls):
        if n:
            out[f"phase.{p}.ms"] = ns * 1e-6
            out[f"phase.{p}.n"] = n
    for name, (ns, n) in _spans.items():
        out[f"span.{name}.s"] = ns * 1e-9
        out[f"span.{name}.n"] = n
    for name, v in _counts.items():
        out[f"count.{name}"] = v
    captures, replays = (a - b for a, b in zip(_graphs(), _graphs_at_reset))
    if captures or replays:
        out["count.trainer.captures"] = captures
        out["count.trainer.replays"] = replays
    return out
