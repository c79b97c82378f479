"""The rest of a run, driven on the CPU at a tiny size (the look for a
card skipped): sound runs come out correct, and each fault a cell can
have, planted under the timed path, comes out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.harness.main import run_cell
from benchmark.tests.tiny import tiny_cell

SEED = 4_000_000_007  # more than 32 signed bits hold


def _run(cell, trace=False, seed=SEED):
    man, conf, traffic = tiny_cell(cell)
    return run_cell(cell, seed, 0.5, trace, "cpu", time.perf_counter(),
                    manifest=man, conf=conf, traffic=traffic)


TRACER_METRICS = {
    "ethz.train": ["march_ms_per_step.train", "forward_ms_per_step.train",
                   "backward_ms_per_step.train", "grid_update_ms_per_step.train"],
    "ethz.eval": ["render_ms_per_call.eval", "gt_scan_ms_per_call.eval",
                  "nnd_ms_per_call.eval"],
}


@pytest.mark.parametrize("cell,trace", [("ethz.train", False), ("rh2.train", False),
                                        ("ethz.eval", False), ("ethz.train", True),
                                        ("ethz.eval", True)])
def test_sound_runs_are_correct(cell, trace):
    """Also: the port's tracer is on for a traced run alone, its readers
    report there, and it is off once the run is done."""
    from virus_nerf_tpu_torch.utils import tracing

    res = _run(cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert not tracing.enabled()
    if trace:
        for name in TRACER_METRICS[cell]:
            assert res["metrics"][name]["value"] > 0, name
    else:
        assert "setup_s" in res["metrics"]
        assert not [k for k in res["counters"] if k.startswith(("phase.", "span."))]


@pytest.mark.parametrize("cell", ["ethz.train", "rh2.train"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    from virus_nerf_tpu_torch.ops import fused_adam

    monkeypatch.setattr(fused_adam, "adam_update_leaves_", lambda *a, **k: None)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["ethz.train", "rh2.train"])
def test_a_replay_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    """Every piece after the first of its kind (on the card: the captured
    graph's replays) runs nothing and moves only the counters, as a
    replay into buffers of its own would: the check follows the whole
    first chunk, so it sees that."""
    from virus_nerf_tpu_torch.training.trainer import Trainer

    run_piece, first = Trainer._run_piece, {}

    def stale(self, state, kind, n, ets, group=None):
        key = (id(self), kind, n)
        if key not in first:
            first[key] = run_piece(self, state, kind, n, ets, group)
            return first[key]
        self._advance(state, kind, n)
        return None if first[key] is None else first[key].clone()

    monkeypatch.setattr(Trainer, "_run_piece", stale)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > res["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("cell", ["ethz.train", "rh2.train"])
def test_half_the_batch_left_out_is_caught(cell):
    undo = mf.kind_module("train").plant_half_batch()
    try:
        res = _run(cell)
    finally:
        undo()
    assert not res["correct"]


def test_an_altered_answer_is_caught(monkeypatch):
    from virus_nerf_tpu_torch.evaluation import evaluator

    render = evaluator.render_rays

    def altered(*a, **k):
        out = render(*a, **k)
        depth = out["depth"].clone()
        depth[0] += 0.01  # one scan ray's depth, in cube units
        return dict(out, depth=depth)

    monkeypatch.setattr(evaluator, "render_rays", altered)
    res = _run("ethz.eval")
    assert not res["correct"]


@pytest.mark.cuda
def test_the_control_fails_and_the_program_passes_on_the_card():
    """At the cells' own size on three seeds: the TF32 control fails one
    of each cell's numbers, the program none (about a minute a cell)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness.readings import readings

    for cell in ("ethz.train", "rh2.train", "ethz.eval"):
        limits = mf.limits_file(cell)
        for line in readings(cell, [4_000_000_101, 4_000_000_102, 4_000_000_103],
                             4.0, "cuda:0"):
            assert all(line["program"][k] <= limits[k] for k in limits), line
            assert any(line["control"][k] > limits[k] for k in limits), line
            for fault in mf.kind_module(mf.traffic_file(
                    mf.workload(mf.load_manifest(), cell)["traffic"])["kind"]).FAULTS:
                assert any(line[fault][k] > limits[k] for k in limits), line
