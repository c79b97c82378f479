"""The data-parallel cell (``kind: train_dp``) driven on the CPU at the tiny
size over two gloo ranks, the look for a card skipped: a sound run is
correct with every replica the same, its readers report, each fault it can
have comes out not correct, and the readings start the ranks once."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.harness.main import run_cell
from benchmark.harness.trace import TraceResult
from benchmark.tests.test_bench_imports import _top_level_after
from benchmark.tests.tiny import tiny_cell

CELL = "ethz.train_dp4"
SEED = 4_000_000_011  # more than 32 signed bits hold


def _tiny():
    man, conf, traffic = tiny_cell(CELL)
    traffic["ranks"] = 2
    return man, conf, traffic


def _run(trace=False):
    man, conf, traffic = _tiny()
    return run_cell(CELL, SEED, 0.5, trace, "cpu", time.perf_counter(),
                    manifest=man, conf=conf, traffic=traffic)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct_and_its_readers_report(trace):
    from virus_nerf_tpu_torch.utils import tracing

    res = _run(trace)
    assert res["correct"], res["checks"]
    assert res["checks"]["replica_gap"]["value"] == 0.0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["counters"]["ranks"] == 2
    assert list(res)[-1] == "checks"
    assert not tracing.enabled()
    names = set(res["metrics"])
    if trace:
        want = {m["name"] for m in mf.per_layer(mf.load_manifest(), CELL)}
        # on the CPU no device kernel runs: the readers of the device trace
        # (launches, B2, idle, NCCL) find nothing
        cpu = {"mfu_pct.train", "march_ms_per_step.train", "forward_ms_per_step.train",
               "backward_ms_per_step.train", "grid_update_ms_per_step.train"}
        assert cpu <= want and cpu <= names <= want
        assert all(res["metrics"][n]["value"] > 0 for n in cpu)
        assert res["window_s"] > 0
    else:
        assert names == {"train_rays_per_s", "peak_mem_gib", "setup_s"}
        assert res["metrics"]["train_rays_per_s"]["value"] > 0
        assert not [k for k in res["counters"] if k.startswith(("phase.", "span."))]


@pytest.mark.parametrize("fault,number", [("half_batch", "loss_gap"),
                                          ("allreduce_dropped", "replica_gap")])
def test_a_fault_is_caught(fault, number):
    undo = mf.kind_module("train_dp").FAULTS[fault]()
    try:
        res = _run()
    finally:
        undo()
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_the_readings_start_the_ranks_once():
    from benchmark.harness.readings import readings

    man, conf, traffic = _tiny()
    lines = readings(CELL, [SEED, SEED + 1], 0.5, "cpu", manifest=man, conf=conf,
                     traffic=traffic, fault_seeds=1)
    limits = mf.limits_file(CELL)
    assert [line["seed"] for line in lines] == [SEED, SEED + 1]
    for line in lines:
        assert all(line["program"][k] <= limits[k] for k in limits), line
        assert line["control"]["replica_gap"] == 0.0
    assert set(mf.kind_module("train_dp").FAULTS) <= set(lines[0])
    assert "half_batch" not in lines[1]
    assert lines[0]["allreduce_dropped"]["replica_gap"] > 0


def test_the_allreduce_reader_reads_ncclkernels_alone():
    read = mf.metric_reader("allreduce_ms_per_step.train")
    trace = TraceResult(kernel_s={"ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)": 0.012,
                                  "fused_adam_kernel": 0.5})
    assert read(SimpleNamespace(trace=trace, counters={"steps": 96})) == pytest.approx(0.125)
    assert read(SimpleNamespace(trace=None, counters={"steps": 96})) is None
    assert read(SimpleNamespace(trace=TraceResult(kernel_s={"gemv": 1.0}),
                                counters={"steps": 96})) is None


def test_the_kind_and_its_ranks_load_no_jax():
    loaded = _top_level_after(["benchmark.kinds.train_dp", "benchmark.harness.ranks"])
    assert not loaded & {"jax", "jaxlib", "flax", "virus_nerf_tpu"}


@pytest.mark.cuda
def test_the_control_and_the_faults_fail_and_the_program_passes_on_four_cards():
    """At the cell's own size on three seeds: the TF32 control and each
    fault fail one of the numbers, the program none (a few minutes)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from benchmark.harness.readings import readings

    limits = mf.limits_file(CELL)
    for line in readings(CELL, [4_000_000_111, 4_000_000_112, 4_000_000_113], 4.0,
                         "cuda:0"):
        assert all(line["program"][k] <= limits[k] for k in limits), line
        for other in ["control", *mf.kind_module("train_dp").FAULTS]:
            assert any(line[other][k] > limits[k] for k in limits), (other, line)
