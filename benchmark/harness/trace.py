"""The traced window: ``torch.profiler`` over it, reduced to what the
per-layer metrics and the ``breakdown`` read.

- ``kernel_s``: device seconds by kernel name (summed over launches);
- ``busy_s``: the length of the union of the device's operations
  (kernels, copies, fills) inside the window, ``window_s`` the window's
  length on the profiler's clock (a ``bench.window`` annotation that ends
  after a device sync);
- ``launches``: the host's launch calls (kernel launches and graph
  launches) inside the window;
- ``gaps``: the device's idle gaps, each named by the innermost host
  operation or program span that spans its middle.

The window also reads the port's tracer (``utils/tracing.py``, on from
the set-up of a ``--trace 1`` run): its phase sums, spans and counters
since a reset made just before the window opens land in the run's
counters, where the per-layer metrics read them.

The arithmetic follows ``tools/torch_profile_step.py`` (time by kernel
name from the profiler's device events), kept here so that the yardstick
does not move with the program.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench.window"
# the harness's window and the program's spans (``utils/tracing.py``): the
# profiler also shows each as a range on the device's timeline, which is no
# device work
ANNOTATIONS = frozenset({
    WINDOW, "trainer.chunk", "trainer.piece", "trainer.warm", "trainer.capture",
    "evaluator.call", "evaluator.render", "evaluator.gt_scan", "evaluator.nnd"})
# the profiler's own bookkeeping on the host, which names no host work
PROFILER_EVENTS = {"Activity Buffer Request", "Command Buffer Full", "Buffer Flush"}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")


@dataclass
class TraceResult:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: Dict[str, float] = field(default_factory=dict)
    launches: int = 0
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, *parts: str) -> float:
        """Device seconds of the kernels whose names hold every part."""
        return sum(s for k, s in self.kernel_s.items()
                   if all(p in k for p in parts))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], s] for k, s in ops],
                "idle_gaps": [[k[:160], s] for k, s in self.gaps[:top]]}


def _get(e, *names):
    for n in names:
        f = getattr(e, n, None)
        if f is not None:
            return f() if callable(f) else f
    raise AttributeError(names)


def _is_device(e) -> bool:
    return str(_get(e, "device_type")).split(".")[-1].upper() == "CUDA"


def _span_ns(e) -> Tuple[int, int]:
    try:
        start = int(_get(e, "start_ns"))
        return start, start + int(_get(e, "duration_ns"))
    except AttributeError:
        start = int(_get(e, "start_us")) * 1000
        return start, start + int(_get(e, "duration_us")) * 1000


def _merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_events(events) -> TraceResult:
    """The profiler's raw events reduced over the ``bench.window``
    annotation (or over all events where it is missing)."""
    host, dev = [], []
    for e in events:
        name = str(_get(e, "name"))
        a, b = _span_ns(e)
        if not _is_device(e):
            host.append((name, a, b))
        elif name not in ANNOTATIONS:
            dev.append((name, a, b))
    win = [(a, b) for n, a, b in host if n == WINDOW]
    if win:
        w0, w1 = win[0]
    else:
        spans = [(a, b) for _, a, b in host + dev]
        w0, w1 = min(a for a, _ in spans), max(b for _, b in spans)
    res = TraceResult(window_s=(w1 - w0) * 1e-9)
    clipped = []
    for name, a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            res.kernel_s[name] = res.kernel_s.get(name, 0.0) + (b - a) * 1e-9
    busy = _merge(clipped)
    res.busy_s = sum(b - a for a, b in busy) * 1e-9
    inside = [(n, a, b) for n, a, b in host if a >= w0 and b <= w1]
    res.launches = sum(1 for n, _, _ in inside if n in LAUNCH_CALLS)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        cover = [(s, n) for n, s, t in inside if s <= mid <= t
                 and n != WINDOW and n not in PROFILER_EVENTS]
        label = max(cover)[1] if cover else "host outside any annotation"
        named.append((label, (b - a) * 1e-9))
    res.gaps = named
    return res


@contextlib.contextmanager
def traced_window(ctx):
    """Profile the ``with`` body as the traced window; appends its
    :class:`TraceResult` to ``ctx.traces`` and the port's tracer's
    readings over it to ``ctx.counters``.  The tracer is reset once the
    profiler runs and the device has done its work, just before the
    window opens: the reset's fill and stamp lie outside the window, and
    the profiler's start outside the phases.  The window closes after a
    device sync."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from virus_nerf_tpu_torch.utils import tracing

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tracing.reset()
        ctx.sync()
        with record_function(WINDOW):
            yield
            ctx.sync()
    ctx.counters.update(tracing.snapshot())
    ctx.traces.append(reduce_events(prof.profiler.kineto_results.events()))
