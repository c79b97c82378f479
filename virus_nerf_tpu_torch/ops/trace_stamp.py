"""The tracer's phase stamp (``csrc/trace_stamp.cu``) and its plain version.

A stamp charges the time since the last stamp to one phase and counts it,
in a buffer of ``2 * slots + 1`` int64 values: ``slots`` sums of
nanoseconds, ``slots`` counts, then the time of the last stamp.  On the
card one thread reads ``%globaltimer``; a launch made under a CUDA graph
capture is a node of the graph, so every replay stamps again.  On the CPU
the plain version does the same arithmetic with ``time.perf_counter_ns``.
``utils/tracing.py`` owns the buffers and the phase table.
"""

from __future__ import annotations

import time

import torch

from virus_nerf_tpu_torch.ops import _build
from virus_nerf_tpu_torch.ops.launch_counts import register


def stamp_buffer(slots: int, device) -> torch.Tensor:
    """A zeroed buffer of ``slots`` phases on ``device``."""
    return torch.zeros(2 * slots + 1, dtype=torch.int64, device=device)


def trace_stamp_plain(buf: torch.Tensor, phase: int) -> None:
    """The stamp on the host clock, in place."""
    slots = (buf.shape[0] - 1) // 2
    now = time.perf_counter_ns()
    buf[phase] += now - int(buf[2 * slots])
    buf[slots + phase] += 1
    buf[2 * slots] = now


def trace_stamp(buf: torch.Tensor, phase: int) -> None:
    """Stamp the end of ``phase`` (``0 <= phase < slots``) into ``buf``
    (:func:`stamp_buffer`).  A CUDA buffer launches the kernel on the
    current stream (or raises); a CPU buffer takes
    :func:`trace_stamp_plain`.  ``.launches`` counts the kernel's
    launches."""
    slots = (buf.shape[0] - 1) // 2
    if buf.dtype != torch.int64 or buf.dim() != 1 or buf.shape[0] != 2 * slots + 1:
        raise ValueError("trace_stamp: want a (2 * slots + 1,) int64 buffer")
    if not 0 <= phase < slots:
        raise ValueError(f"trace_stamp: phase {phase} outside [0, {slots})")
    if buf.device.type == "cpu":
        trace_stamp_plain(buf, phase)
        return
    if not buf.is_cuda:
        raise ValueError(f"trace_stamp: unsupported device {buf.device}")
    err = _build.library().vn_trace_stamp(
        buf.data_ptr(), slots, phase,
        torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(err, "vn_trace_stamp")
    trace_stamp.launches += 1


trace_stamp.launches = 0
register(trace_stamp)
