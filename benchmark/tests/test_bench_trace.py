"""The reduction of the profiler's events to busy time, idle gaps, kernel
times and launches, on made-up events."""

from __future__ import annotations

import pytest

from benchmark.harness.trace import WINDOW, reduce_events


class Ev:
    def __init__(self, name, start_us, dur_us, device):
        self._n, self._s, self._d, self._dev = name, start_us, dur_us, device

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def test_busy_idle_gaps_and_launches():
    evs = [
        Ev(WINDOW, 0, 1000, False),
        Ev("trainer.chunk", 0, 1000, True),  # a program span on the device line
        Ev("host.work", 100, 300, False),
        Ev("cudaGraphLaunch", 10, 1, False),
        Ev("cudaLaunchKernel", 20, 1, False),
        Ev("kernel_a", 0, 100, True),
        Ev("kernel_b", 50, 100, True),  # overlaps a: busy 0..150
        Ev("kernel_a", 400, 100, True),  # busy 400..500; gap 150..400
        Ev("kernel_c", 990, 20, True),  # clipped to 990..1000
        Ev("kernel_out", 2000, 10, True),  # outside the window
    ]
    res = reduce_events(evs)
    assert res.window_s == pytest.approx(1e-3)
    assert res.busy_s == pytest.approx((150 + 100 + 10) * 1e-6)
    assert res.kernel_s["kernel_a"] == pytest.approx(200e-6)
    assert "trainer.chunk" not in res.kernel_s and "kernel_out" not in res.kernel_s
    assert res.launches == 2
    # longest gap first: 500..990 (outside host.work), then 150..400
    assert res.gaps[0] == ("host outside any annotation", pytest.approx(490e-6))
    assert res.gaps[1] == ("host.work", pytest.approx(250e-6))
    assert res.kernel_seconds("kernel_") == pytest.approx(310e-6)
    b = res.breakdown()
    assert b["device_ops"][0][0] == "kernel_a" and len(b["idle_gaps"]) <= 10
