"""The port's tracer (``virus_nerf_tpu_torch/utils/tracing.py``) and where
the trainer, the renderer and the evaluator call it.

On the CPU, at a tiny size:

- off (the default) it records nothing: no stamp, no span, no counter, no
  ``record_function`` range under a profiler, and a chunk gives the same
  metrics, parameters and grid bit for bit as a chunk run with it on;
- on, every phase of the step is stamped once a step, ``grid_update``
  once an interval and ``between`` once a piece, and the phases add up to
  no more than the time they were taken over;
- ``reset`` and ``snapshot`` on a clock whose readings are set by hand;
- the evaluator's spans nest inside ``evaluator.call`` in a profiler
  trace, and its renders stamp no phase of the training step;
- ``trainer.captures`` and ``trainer.replays`` are read from the graph
  records of ``ops/launch_counts.py``;
- ``training.profile_dir`` writes one Chrome trace of the second chunk and
  the evaluation after it (with ``trainer.piece`` and ``evaluator.*``
  ranges) and the tracer's readings, and turns the tracer off after.

On the card (marker ``cuda``; skipped without one), the stamps are graph
nodes: ``phase.*.n`` grows with each replay of a captured piece, and a
chunk run with the tracer off launches no stamp.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.ops import trace_stamp as ts
from virus_nerf_tpu_torch.ops.launch_counts import (
    GraphLaunches,
    launches,
    reset as reset_launches,
)
from virus_nerf_tpu_torch.training.trainer import Trainer
from virus_nerf_tpu_torch.utils import tracing

torch.set_num_threads(1)

DATA_KW = dict(n_images=4, img_wh=(32, 24), n_gt_points=2000)
STEP_PHASES = ("sample", "march", "forward", "loss", "backward", "adam", "stats")


def tiny_config() -> Config:
    """A budgeted constant-dt step at a tiny width; the VIRUS grid updated
    every 8 steps; a 64-ray scan rendered in chunks of 48 (a padded
    last chunk)."""
    cfg = Config()
    m, t, ev = cfg.model, cfg.training, cfg.evaluation
    m.scale = 0.5
    m.hash_levels, m.hash_features_per_level = 4, 2
    m.hash_log2_T, m.hash_max_res, m.grid_size = 12, 64, 32
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 256
    t.sample_budget = 128 * 12
    t.sampling_strategy = {"imgs": "all",
                           "pixs": {"valid_uss": 0.4, "valid_tof": 0.4}}
    t.sensors = ["USS", "ToF"]
    t.max_steps, t.max_time = 16, 1e9
    cfg.occ_grid.batch_size, cfg.occ_grid.update_interval = 64, 8
    ev.eval_every_n_steps = 8
    ev.num_depth_pts_per_step = 0
    ev.res_angular, ev.res_map = 64, 64
    ev.batch_size, ev.max_samples_per_ray = 48, 32
    return cfg


@pytest.fixture(scope="module")
def data():
    return make_synthetic_dataset(device="cpu", **DATA_KW)


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


def _trainer(data, depth_pts=0, **cfg_kw):
    ds, scene, info = data
    cfg = tiny_config()
    cfg.evaluation.num_depth_pts_per_step = depth_pts
    for k, v in cfg_kw.items():
        setattr(cfg.training, k, v)
    return Trainer(cfg, ds, scene=scene, device=ds.device,
                   test_dataset=ds, img_wh=info["img_wh"])


def _chunk(tr, state, steps=16):
    return tr.make_train_chunk(steps)(state)


OUR_PREFIXES = ("trainer.", "evaluator.")


def _our_ranges(prof):
    return [e for e in prof.events() if e.name.startswith(OUR_PREFIXES)]


def test_tracing_off_records_nothing(data):
    tr = _trainer(data)
    state = tr.init_state(0)
    reset_launches([ts.trace_stamp])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _chunk(tr, state)
        tr._get_evaluator().evaluate_depth(
            state.model, state.grid.occ_bool, np.arange(2), sensors=("NeRF",))
    assert _our_ranges(prof) == []
    assert launches(ts.trace_stamp) == 0
    assert tracing.snapshot() == {}


def test_a_chunk_is_bit_for_bit_the_same_with_tracing_on(data):
    tr = _trainer(data)
    off, on = tr.init_state(0), tr.init_state(0)
    _, keys, m_off = _chunk(tr, off)
    tracing.enable()
    _, keys_on, m_on = _chunk(tr, on)
    assert keys == keys_on and torch.equal(m_off, m_on)
    for (name, p), q in zip(off.model.named_parameters(), on.model.parameters()):
        assert torch.equal(p, q), name
        for x, y in zip(off.optimizer._moments(p), on.optimizer._moments(q)):
            assert torch.equal(x, y), name
    for f, x, y in zip(off.grid._fields, off.grid, on.grid):
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), f
    assert torch.equal(off.generator.get_state(), on.generator.get_state())


@pytest.mark.parametrize("entry", [0, 3])
def test_every_phase_is_stamped_once_a_step(data, entry):
    import time

    tr = _trainer(data)
    state = tr.init_state(0)
    tr.run_steps(state, entry)
    tracing.enable()
    tracing.reset()
    t0 = time.perf_counter_ns()
    _chunk(tr, state)
    wall_ms = (time.perf_counter_ns() - t0) * 1e-6
    snap = tracing.snapshot()
    pieces = tr._pieces(entry, 16)
    updates = sum(kind != "step" for kind, _ in pieces)
    for p in STEP_PHASES:
        assert snap[f"phase.{p}.n"] == 16, p
    assert snap["phase.grid_update.n"] == updates == len(
        [s for s in range(entry, entry + 16) if s % 8 == 0])
    assert snap["phase.between.n"] == len(pieces)
    total = sum(snap[f"phase.{p}.ms"] for p in tracing.PHASES)
    assert all(snap[f"phase.{p}.ms"] >= 0 for p in tracing.PHASES)
    assert 0 < total <= wall_ms
    assert snap["span.trainer.chunk.n"] == 1
    assert snap["span.trainer.piece.n"] == len(pieces)
    assert snap["span.trainer.chunk.s"] * 1e3 <= wall_ms


def test_reset_and_snapshot(monkeypatch):
    now = [1000]
    monkeypatch.setattr(ts, "time", SimpleNamespace(perf_counter_ns=lambda: now[0]))
    tracing.enable()
    tracing.stamp("sample")  # the CPU clock starts here
    tracing.count("c", 2)
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
    tracing.reset()
    assert tracing.snapshot() == {}
    now[0] = 1500
    tracing.stamp("sample")
    now[0] = 1750
    tracing.stamp("march")
    now[0] = 2750
    tracing.stamp("sample")
    tracing.count("rays", 3)
    tracing.count("rays", 4)
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
    snap = tracing.snapshot()
    assert snap["phase.sample.ms"] == pytest.approx((500 + 1000) * 1e-6)
    assert snap["phase.sample.n"] == 2
    assert snap["phase.march.ms"] == pytest.approx(250 * 1e-6)
    assert snap["phase.march.n"] == 1
    assert not any(k.startswith("phase.forward") for k in snap)
    assert snap["count.rays"] == 7 and "count.c" not in snap
    assert snap["span.outer.n"] == snap["span.inner.n"] == 1
    assert snap["span.outer.s"] >= snap["span.inner.s"] >= 0
    # reset starts the clock at its own time
    now[0] = 5000
    tracing.reset()
    now[0] = 5100
    tracing.stamp("loss")
    assert tracing.snapshot() == {"phase.loss.ms": pytest.approx(100e-6),
                                  "phase.loss.n": 1}
    # off again: nothing more is recorded
    tracing.enable(False)
    tracing.stamp("loss")
    tracing.count("rays")
    with tracing.span("outer"):
        pass
    assert tracing.snapshot() == {"phase.loss.ms": pytest.approx(100e-6),
                                  "phase.loss.n": 1}
    with pytest.raises(KeyError):
        tracing.enable()
        tracing.stamp("no_such_phase")


def test_a_stamp_checks_its_buffer():
    buf = ts.stamp_buffer(3, "cpu")
    ts.trace_stamp(buf, 2)
    assert int(buf[3 + 2]) == 1
    with pytest.raises(ValueError, match="phase"):
        ts.trace_stamp(buf, 3)
    with pytest.raises(ValueError, match="int64"):
        ts.trace_stamp(buf.float(), 0)


def _interval(e):
    return e.time_range.start, e.time_range.end


def test_evaluator_spans_nest_inside_the_call(data):
    tr = _trainer(data)
    state = tr.init_state(0)
    ev = tr._get_evaluator()
    tracing.enable()
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ev.evaluate_depth(state.model, state.grid.occ_bool, np.arange(3),
                          sensors=("NeRF",))
    ranges = _our_ranges(prof)
    calls = [e for e in ranges if e.name == "evaluator.call"]
    assert len(calls) == 1
    a, b = _interval(calls[0])
    names = {e.name for e in ranges}
    assert names == {"evaluator.call", "evaluator.gt_scan",
                     "evaluator.render", "evaluator.nnd"}
    for e in ranges:
        s, t = _interval(e)
        assert a <= s <= t <= b, e.name
    snap = tracing.snapshot()
    # three NND directions for the NeRF
    assert snap["span.evaluator.nnd.n"] == 3
    assert snap["span.evaluator.render.n"] == 1
    assert snap["span.evaluator.gt_scan.n"] == snap["span.evaluator.call.n"] == 1
    assert snap["span.evaluator.call.s"] >= (
        snap["span.evaluator.gt_scan.s"] + snap["span.evaluator.nnd.s"])


@pytest.mark.parametrize("n_rays", [48 * 3, 48 * 3 + 5, 7])
def test_the_evaluators_renders_stamp_no_phase(data, n_rays):
    tr = _trainer(data)
    state = tr.init_state(0)
    ev = tr._get_evaluator()
    rng = np.random.default_rng(0)
    o = rng.uniform(-0.1, 0.1, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tracing.enable()
    tracing.reset()
    out = ev.render_batched(state.model, state.grid.occ_bool, o, d)
    assert out["depth"].shape == (n_rays,)
    # one span, in chunks of 48 rays (the last one padded), and no stamp:
    # the march and forward phases are the training step's alone
    snap = tracing.snapshot()
    assert set(snap) == {"span.evaluator.render.n", "span.evaluator.render.s"}
    assert snap["span.evaluator.render.n"] == 1


def test_graph_counts_come_from_the_launch_records():
    tracing.enable()
    before, now = GraphLaunches(), None  # a graph captured before reset
    try:
        before.replays = 5
        tracing.reset()
        assert tracing.snapshot() == {}
        before.replays += 2
        now = GraphLaunches()
        now.replays = 1
        assert tracing.snapshot() == {"count.trainer.captures": 1,
                                      "count.trainer.replays": 3}
        tracing.reset()
        before.replays += 1
        assert tracing.snapshot() == {"count.trainer.captures": 0,
                                      "count.trainer.replays": 1}
    finally:
        GraphLaunches.records[:] = [r for r in GraphLaunches.records
                                    if r is not before and r is not now]


def test_profile_dir_writes_the_second_chunks_trace(data, tmp_path):
    tr = _trainer(data, depth_pts=2, profile_dir=str(tmp_path / "prof"),
                  max_steps=24)
    state = tr.train(tr.init_state(0))
    assert state.step == 24
    assert not tracing.enabled()  # the loop puts the tracer back
    trace = json.loads((tmp_path / "prof" / "chunk_8.trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("trainer.piece") == 1  # one group of 8 steps
    assert "trainer.chunk" in names
    # the evaluation after the chunk, in the same trace
    assert names.count("evaluator.call") == 1
    assert {"evaluator.gt_scan", "evaluator.render",
            "evaluator.nnd"} <= set(names)
    got = json.loads((tmp_path / "prof" / "chunk_8.tracer.json").read_text())
    for p in STEP_PHASES:
        assert got[f"phase.{p}.n"] == 8, p
    assert got["phase.grid_update.n"] == got["phase.between.n"] == 1
    assert got["span.trainer.piece.n"] == 1
    assert got["span.evaluator.call.n"] == got["span.evaluator.gt_scan.n"] == 1
    assert got["span.evaluator.nnd.n"] == 3
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == [
        "chunk_8.trace.json", "chunk_8.tracer.json"]
    # the tracer went off after the profiled chunk: the third chunk and its
    # evaluation added nothing to the readings
    assert tracing.snapshot() == got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stamps_replay_with_the_graph(card):
    ds, scene, info = make_synthetic_dataset(device=card, **DATA_KW)
    tr = Trainer(tiny_config(), ds, scene=scene, device=card)
    state = tr.init_state(0)
    chunk = tr.make_train_chunk(8)  # one group piece a chunk
    chunk(state)
    chunk(state)  # warm-up, then capture and the first replay
    reset_launches([ts.trace_stamp])
    chunk(state)
    torch.cuda.synchronize()
    assert launches(ts.trace_stamp) == 0  # tracing off: no stamp node
    graphs = len(tr.state_graphs(state).graphs)

    tracing.enable()
    chunk(state)
    chunk(state)  # the stamped graph's warm-up and capture
    assert len(tr.state_graphs(state).graphs) == graphs + 1
    reset_launches([ts.trace_stamp])
    tracing.reset()  # after the launch counts' reset, which zeroes replays
    for i in range(1, 4):
        chunk(state)
        torch.cuda.synchronize()
        snap = tracing.snapshot()
        for p in STEP_PHASES:
            assert snap[f"phase.{p}.n"] == 8 * i, p
        assert snap["phase.grid_update.n"] == snap["phase.between.n"] == i
        assert snap["count.trainer.replays"] == i
        assert snap["count.trainer.captures"] == 0
        # 7 a step, the grid update and the piece's start, and reset's own
        assert launches(ts.trace_stamp) == (7 * 8 + 2) * i + 1
    # the phases' sum is the time from reset to the last stamp: positive,
    # and each phase took time
    assert all(snap[f"phase.{p}.ms"] > 0 for p in tracing.PHASES)


@pytest.mark.cuda
def test_profile_dir_on_the_card(card, tmp_path):
    ds, scene, info = make_synthetic_dataset(device=card, **DATA_KW)
    cfg = tiny_config()
    cfg.training.profile_dir = str(tmp_path)
    tr = Trainer(cfg, ds, scene=scene, device=card)
    tr.train(tr.init_state(0))
    trace = json.loads((tmp_path / "chunk_8.trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert "trainer.piece" in names
    got = json.loads((tmp_path / "chunk_8.tracer.json").read_text())
    # the second chunk is the stamped group graph's capture and replay
    for p in STEP_PHASES:
        assert got[f"phase.{p}.n"] == 8, p
    assert got["count.trainer.captures"] == 1
