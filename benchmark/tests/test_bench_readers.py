"""The readers of the port's tracer (``benchmark/metrics/``) on hand-made
counters: each reads its key over the window's steps or calls, and
returns nothing without it."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.harness import manifest as mf

READERS = [
    ("march_ms_per_step.train", {"phase.march.ms": 29.0, "steps": 96}, 29.0 / 96),
    ("forward_ms_per_step.train", {"phase.forward.ms": 384.0, "steps": 96}, 4.0),
    ("backward_ms_per_step.train", {"phase.backward.ms": 403.2, "steps": 96}, 4.2),
    ("grid_update_ms_per_step.train", {"phase.grid_update.ms": 9.6, "steps": 96}, 0.1),
    ("render_ms_per_call.eval", {"span.evaluator.render.s": 1.11, "calls": 8}, 138.75),
    ("gt_scan_ms_per_call.eval", {"span.evaluator.gt_scan.s": 0.032, "calls": 8}, 4.0),
    ("nnd_ms_per_call.eval", {"span.evaluator.nnd.s": 3.68, "calls": 8}, 460.0),
]


@pytest.mark.parametrize("name,counters,want", READERS)
def test_a_reader_reads_its_key(name, counters, want):
    read = mf.metric_reader(name)
    assert read(SimpleNamespace(trace=None, counters=counters)) == pytest.approx(want)
    for key in counters:
        rest = {k: v for k, v in counters.items() if k != key}
        assert read(SimpleNamespace(trace=None, counters=rest)) is None, key
