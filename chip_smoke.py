"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it finishes; any failure exits non-zero:

1. build the CUDA kernels from ``virus_nerf_tpu_torch/csrc`` (nvcc, one
   process per source, all started together);
2. hold each kernel against its plain PyTorch version (and the segment sums
   against a float64 sum; each segment sum also against its own second call,
   bit for bit) on the card and time them (CUDA events, in turns
   kernel/plain/library/library/plain/kernel; a segment sum's library call
   is a zero fill of its output plus one ``index_add_``, the same
   function; each segment sum also gets its ``torch.profiler`` device
   time per call): the transposed segment sum (B1) at the kernel-CI cases
   of bench.py, the row-major segment sum (B3) on uniform, skewed,
   padded-row and odd-group keys, B1, B3 (float32, F = 2) and the factor
   segment sum (B4, bf16, F = 2) on 917,504 entries over 524,288 rows with
   700,000 on one row and on uniform keys, and B1, B3 and B4 with every key
   outside [0, n_rows) (all 0); ptxas's registers and spills of B1, B3 and
   B4 are printed after the build, as are B2's, B5's, L1's and H1's;
3. the bench path: ``Trainer`` at the bench configuration (bench.py:311-348:
   synthetic scene 16 x 160x120, 4096 rays, 8 x F=4 additive hash levels of
   2^19 rows, 128^3 VIRUS grid updated every 8 steps, S=128, budget
   4096*28) for 48 steps from a seeded random init: finite, falling loss;
   B1 and B2 launched on the path, B2 once a step for all leaves; CUDA
   kernel launches a step (host profile of 8 more steps);
4. B1 against its plain version, and timed, on the two streams of the hash
   backward at the positions of the bench path's last step;
5. fused Adam (B2) against its plain version at 2^21 elements and at both
   hash tables' sizes, and on bf16 parameters at the 16 x 2 table's size
   (library call: ``torch._fused_adam_`` on the same leaves);
6. one grid update + train step of a small config on the card against the
   same step on the CPU (the plain versions), for each hash variant;
7. the XOR path: ``python -m virus_nerf_tpu_torch.quality_run --hash-variant
   xor --hash-levels 16 --hash-feats 2`` (the reference's own 16 x F=2 XOR
   hash of 2^19 rows, 5,710,032 rows; synthetic scene 24 x 160x120, every
   third image held out; the bench's batch, march, budget and grid) for 32
   steps from a seeded init, then ``Evaluator.evaluate`` on the 8 held-out
   images: finite, falling loss, finite NND of the NeRF/ToF/USS scans
   against the GT scan; B2 and B3 launched on the path, B2 once a step;
8. B3 against its plain version and a float64 sum, and timed, on the two
   streams of the XOR backward at the positions of the XOR path's last
   step (the merged dense levels and the hashed group of G = 10);
9. the slabs path: ``quality_run --hash-levels 16 --hash-feats 2
   --hash-forward slabs --hash-backward factors`` (the JAX package's own
   16 x F=2 additive layout: widened-slab forward, fused factor-stream
   backward, float32) for 32 steps, then the evaluation, checked as in 7;
   B2, B4 and B5 launched on the path, B2 once a step; B2 on the six
   leaves of the trained model (the table and five MLP weights) in one
   call, with the float32 table and with a bf16 one, against its plain
   version and ``torch._fused_adam_`` over the same leaves;
10. B4 against its plain version and a float64 sum, and timed, on the bf16
    and float32 factor streams at the positions of the slabs path's last
    step; B5 bit-exact against its plain version, and timed, on the
    trained table's bf16 slab groups, each and per forward;
11. one small-config step on the card against the CPU for slabs+factors
    and for the ``mixed`` and ``bfloat16`` compute modes, of the additive
    hash and of the XOR hash (B3 launched, and checked against its plain
    version at the keys of each XOR step);
12. the scale-1.0 path: the bench configuration at ``model.scale = 1.0``
    (two cascades, exponential stepping with exp_step_factor 1/256, the
    one-row VIRUS grid marched past its end as the JAX package does) on 16
    of 24 images, 48 steps: finite, falling loss; B1, B2 and the fused
    march launched, B2 and the march once a step; ms/step and rays/s over
    steps 16-48, launches a step, peak memory; B1 at the keys of its last
    step; CUDA kernel launches a step; the standalone lattice kernel of
    ``csrc/march.cu`` (off every path) bit-exact against its plain loop at
    4096 x 1024 on the path's own rays, and timed; then
    ``Evaluator.evaluate`` on the 8 held-out images;
13. the NGP path: the same at scale 1.0 with ``model.grid_type="ngp"`` (a
    2 x 128^3 grid, a warm-up update at step 0 and a steady one at step
    16), the distortion loss, "closest" pixels with the USS statistics and
    real-time simulation, 32 steps; B1, B2 and the march launched, B2 and
    the march once a step; CUDA kernel launches a step;
14. one small-config step on the card against the CPU at scale 1.0, with
    the NGP grid (its warm-up update too) and with the distortion loss;
15. the ETHZ run: the port's fixture writer at its defaults (a recorded
    room's layout: 300 images a camera at 320x240, two camera stacks,
    800,000 map points) into a temporary directory, its 600 PNGs decoded
    and its map read, then ``python -m virus_nerf_tpu_torch.run``'s
    ``main`` on it with the default config at full width (the additive
    16 x F=2 hash of 2^19 rows a level, 64-wide MLPs, the 128^3 VIRUS grid,
    4096 rays, constant-dt march with the automatic budget 4096*32, the
    default routes), cut to 48 steps (two chunks of 24, so two
    intermediate evaluations) with the clock's limit lifted: finite,
    falling loss; B1 and B2 launched, B2 once a step; every file written
    (logs.csv 48 rows, metrics.csv with the USS, ToF and NeRF rows and a
    finite NeRF zone-3 NND, the renders); the checkpoint reloaded into a
    fresh trainer renders a test image bit-identical to the trained one;
    B1 against its plain version at the keys of the run's last step.
    Printed: the fixture's write time, the decode and read times, each
    split's load time, ms/step and rays/s over steps 24-48 (the host
    clock around the second chunk, after a sync), the
    intermediate and final evaluation seconds and the peak memory;
16. the RH2 run: the port's RH2 fixture writer at its defaults (75
    trajectory points x 4 cameras = 300 observations at 244x320, 400,000
    scene points; 244 train and 28 test images), then ``run.main`` with
    ``dataset.name=RH2`` and ``model.scale=1.0`` (two cascades,
    exponential stepping, the dense automatic budget, the one-row VIRUS
    grid marched past its end) at the default config's full width, cut to
    48 steps with the clock's limit lifted: the checks and prints of 15,
    B1 2, B2 1 and the march 1 launch a step, B1 at the run's last keys;
17. PSO: ``python -m virus_nerf_tpu_torch.run_optimization``'s ``main`` over
    the RH2 fixture at the same width, 24 steps a particle and the
    evaluation cut to one colour image and 4 depth scans, three particles,
    then a second call on the same directory that resumes at t = 3 and
    writes the fourth history row, then a ``--worker-id`` call on another
    directory whose lease is read from the state file during its
    evaluation: every score finite, B1 2, B2 1 and the march 1 launch a
    step; the seconds of each particle;
18. the tri-plane path: the bench configuration with
    ``model.encoder_type="triplane"`` (8 x 4 planes at max_res 1024,
    3 * 1024^2 * 4 parameters), 48 steps: finite, falling loss, B2 once a
    step (the planes and the MLP leaves in one launch) and no other kernel;
    ms/step, peak memory, B2 on the trained model's leaves against its
    plain version, and the planes' backward time (PyTorch's accumulating
    ``index_put_``, no kernel) beside its byte bound;
19. data parallelism on NCCL over ``torch.cuda.device_count()`` ranks,
    ``make_dp_train_chunk`` as CUDA graphs with the collectives captured
    inside, in PyTorch's deterministic mode: with more than one card, the
    bench configuration's 16 steps on every rank (spawned, one card each)
    graphed and eager, bit for bit, and the replicas bit-identical; then
    on one card, a group of one rank: the bench configuration's 16 steps
    (grid updates at steps 0 and 8) and the scale-1.0 configuration's 8
    (chunks of 3 and 5: single-step graphs, the march once a step, checked
    bit for bit on the path's rays and grid) graphed, against the group's
    eager ``run_steps`` and the plain trainer: every metric, every state
    tensor and the generators bit for bit; B1 against its plain version
    at the last step's keys; then a step of eager and graphed one-rank DP
    in turns (host launches, cudaGraphLaunch calls, device ms, host ms);
20. the population evaluators (deterministic mode), each particle's
    chunks as its own CUDA graphs: ``parallel``'s (a Trainer a particle
    over ``run_optimization``'s search space, the bench configuration cut
    to 24 steps on 16 of 24 images, each particle scored on the 8
    held-out images) for 2 calls of 3 particles, and
    ``optimization.parallel_eval``'s (the loss weights, read from device
    memory; the particles in turns on one state) for 4 particles x 32
    steps: every score finite, equal to the eager evaluator's
    (``run_steps``; the loss weights as host floats), particle 0 equal to
    its serial run, no piece of a state captured twice (the captures
    printed; the swarm's second call captures nothing), the peak device
    memory; B1 2 and B2 1 launch a step;
21. the fused march (``csrc/march.cu``, ``march_select``) bit for bit
    against its plain version (``march_select_plain``: the (N, K) lattice,
    the probe and the selection as PyTorch ops) on the rays and trained
    grids of the paths: the bench (constant step, 4096 rays, K = 1024, S =
    128 and the default configuration's 256), a full grid (S = 256), scale
    1.0 (exponential step, the one-row VIRUS grid), the NGP grid's two
    rows, and the evaluator's chunk (8192 rays, S = 512, no jitter); each
    timed in turns with the plain version (events, and profiler device
    time: the kernel's, the plain chain's kernels and their launches)
    beside its bound;
22. the evaluator's remainder on the ETHZ run's map (15 writes its
    ``log.txt`` through ``--override save_dir=``): the trainer's START,
    step and FINISHED lines in it; ``Evaluator.density_slice`` (nanmax
    over 3 heights) and ``utils.deployment.infer_density_map`` (mean) at
    256 x 256 on the card, for the run's corners route and for the slabs
    route (B5 launched), each within 1e-4 of |x| / max(1, |x|) of the same
    calls on a CPU copy of the model; ``export_nerf_pointcloud`` from 16
    test poses at 2 heights (one fused march a chunk) to a PCD read back
    equal, with points; ``save_deployment_model``, reloaded: the JAX
    payload's keys in order, their shapes, the per-level scale and the
    bitfield's set bits equal to the occupied cells;
23. the final evaluation of the ETHZ (after 22) and RH2 (after 16) maps
    dense and with ``evaluation.sample_budget`` = 8192 * 32 (the training
    budget's rule at the evaluation chunk), in turns sampled, dense,
    dense, sampled: seconds, peak device GiB, NeRF NND z3 and PSNR of
    each, samples marched a chunk and samples over the budget;
24. the 2-D ``(pop, data)`` population nesting of
    ``optimization.parallel_eval`` as ``(1, 1)`` on one card (a one-rank
    NCCL group) in deterministic mode: 4 particles x 16 steps of the bench
    configuration through the graphed data-parallel chunk, scores equal to
    the 1-D evaluator's, a call's particles in turns on one state (the
    first call captures, the second replays); B1 2, B2 1 and the march 1
    launch a step;
25. without matplotlib (after 23 on the ETHZ map): every new module
    (analysis, plots, deployment, logging) imports in a fresh interpreter
    that cannot import matplotlib, and ``evaluate(plot=True)`` raises
    ImportError naming matplotlib before it renders;
26. the training chunk as CUDA graphs (``Trainer.make_train_chunk``, which
    ``Trainer.train`` runs on every path above past the NGP warm-up): on
    fresh states from one seed in deterministic mode, graph against eager
    (``run_steps``) for 32 steps of the bench and scale-1.0 configurations
    (the latter entered at step 3: single-step graphs, then groups) and 16
    of the XOR (chunks of 5 and 3: lone grid-update graphs), the
    slabs+factors ``mixed``, the tri-plane and the ETHZ room's
    ``Config()`` configurations: every metric of every step, parameters,
    Adam moments and count, grid, USS statistics and the generator bit for
    bit; then a step of each, eager and graph, in turns on the bench and
    scale-1.0 configurations: host launches (profiler), the port's kernel
    launches (replay-aware), device ms and host ms, the replay-aware
    counts of B2 and the march held once against the device kernels the
    profiler saw;
27. the tracer's phase stamps (``utils/tracing.py``, the one-thread
    ``csrc/trace_stamp.cu``): the bench configuration's chunk of 24 steps
    as CUDA graphs on two trainers from one seed (deterministic mode), the
    tracer off on one and on on the other, two chunks each: off, no stamp
    launched and no graph holding one; on, seven stamps a step, one a
    piece and one a grid update replay-aware (plus reset's own), each
    graph holding its stamps, the phase counts equal to
    ``trace_stamp_plain``'s over the same stamp sequence, no negative
    phase sum, and every metric and the whole state bit for bit the
    tracer-off run's; then one stamped chunk under ``torch.profiler``,
    its device kernels split at the stamps (B2 only in ``adam``, the
    march only in ``march``, B1 only in ``backward``) beside the stamps'
    ms a step; then host ms a step with the tracer off and on in turns.
    No path above launches a stamp;
28. the evaluator's GT slice scan (E1, ``csrc/slice_scan.cu``) on the ETHZ
    run's 800,000-point cloud (after 23) and the RH2 run's 400,000 (after
    its 23), at the run's ``res_map`` and height band, on the evaluator's
    scan rays from 16 test origins (16 x ``res_angular`` rays): the hit
    cells of ``Scene.scan_depths`` on the card ``torch.equal`` to
    ``slice_scan_plain``'s on the cells, band, rays and radii it handed E1,
    and the depths equal to ``Scene.get_slice_scan``'s
    (NaN for NaN); timed: E1 (events, and profiler device time), the plain
    walk, ``get_slice_scan`` (the same walk on the host), a whole
    ``Scene.scan_depths`` call and the scene's set-up (warm), beside E1's
    byte bound;
29. the evaluator's nearest-neighbour search (E2, ``csrc/nn_search.cu``)
    on the ETHZ room's scans at the benchmark cell's size (after 28): one
    ``evaluate_depth`` of 16 test images (16 x ``res_angular`` scan rays)
    records the three ``nn_metrics`` calls' query and reference points,
    and on each E2's indices ``torch.equal`` and its distances bit for bit
    ``nn_search_plain``'s (the JAX package's numpy search); timed: E2
    (events, and profiler device time), the plain search, a whole
    ``nn_metrics`` call on the card, and E2 at a LiDAR scan's width (16
    images of 512 queries over 8,192 reference points), beside E2's
    bound;
30. the hash encoder's ``corners`` forward (H1, ``csrc/hash_corners.cu``)
    at the benchmark cells' sample counts (131,072 ETHZ, 1,048,576 RH2,
    4,194,304 an evaluation chunk) on the 16 x 2 table of 2^19 rows: the
    embedding, base rows and weights ``torch.equal`` to
    ``hash_corners_plain``'s (the plain code on the card); timed: H1 with
    and without the base rows and weights (events, and profiler device
    time) and the plain forward (events, device time and launches),
    beside H1's byte bound; at 100,000 samples, where cuBLAS's batched
    GEMV combines in another order, base rows and weights bit for bit
    and the embedding's largest gap in ulps.

Launch counts are replay-aware (``ops.launch_counts``): a wrapper's count
moves where it launches (at a capture, once), and each CUDA graph adds
what it holds at every replay.  On every path the renderer's marches on
the card are counted, and each must have launched ``march_select`` once
(no path launches the standalone lattice).  The depth evaluations on the
card (``Evaluator.evaluate_depth``) are counted too, and each must have
launched E1 once; so are the ``nn_metrics`` calls that search on the card,
and each must have launched E2 once; so are the additive hash's
``corners`` encodes on the card, and each must have launched H1 once.  The line before the last is the card's name and
power limit (nvidia-smi); before it, one JSON line with the kernels'
results.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def bound_ms(n_bytes: float, n_ops: float):
    """Least time the card could take: bytes over the memory rate or
    float32 operations over the peak rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_turns(fns, iters: int = 10):
    """Mean ms per call of each function, timed with CUDA events in turns
    a, b, c, c, b, a after one warm-up call each."""
    def one(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    first = [one(fn) for fn in fns]
    second = [one(fn) for fn in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def graph_time_turns(fns, iters: int = 10):
    """Mean ms per call of each function replayed from a CUDA graph of
    ``iters`` calls (captured after one warm-up call on the capture's
    stream), timed with CUDA events over 5 replays in turns a, b, b, a:
    the calls without the host between them."""
    stream = torch.cuda.Stream()
    graphs = []
    for fn in fns:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            for _ in range(iters):
                fn()
        graphs.append(g)

    def one(g):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        g.replay()
        start.record()
        for _ in range(5):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (5 * iters)

    first = [one(g) for g in graphs]
    second = [one(g) for g in reversed(graphs)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def device_ms(fn, part: str, iters: int = 10, per_call: int = 1):
    """Device ms per call of the kernels whose name holds ``part``, from
    ``torch.profiler`` over ``iters`` calls of ``fn`` after a warm-up: the
    kernel's own time, without the host's time between launches, which
    CUDA events around a short kernel also count.  Taken per recorded
    launch, as the profiler may drop a launch's record, times the
    ``per_call`` launches of a call.  The first session after a long one
    (a profiled training run) can come back without the kernel's records,
    so a session that kept none is repeated, up to three; NaN if none
    kept any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if part in e.key]
        n = sum(e.count for e in ev)
        if n:
            return sum(e.self_device_time_total for e in ev) / 1e3 / n * per_call
    return float("nan")


def step_device_ms(run, n_steps: int, top: int = 5):
    """Device ms a step over ``run()`` (``n_steps`` steps): every kernel's
    and copy's own time from ``torch.profiler``, summed, over the steps;
    and the ``top`` largest entries as (ms a step, name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ev) / 1e3 / n_steps
    return total, [(round(e.self_device_time_total / 1e3 / n_steps, 4),
                    e.key[:80]) for e in ev[:top]]


# ------------------------------------------------------ segment sums (B1, B3)
def bench_segment_cases(dev):
    """(name, vals, keys, n_rows) on the card: the kernel-CI cases of
    bench.py:134-197 at their sizes, (G, VF, K) streams for B1."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def uniform(G, K, R):
        return torch.sort(torch.randint(0, R, (G, K), generator=gen, device=dev),
                          dim=1).values

    def skewed(G, K, R):
        k = uniform(G, K, R)
        k[1] = torch.sort(torch.randint(1000, 1900, (K,), generator=gen,
                                        device=dev)).values
        return k

    def merged(sizes, ks):
        parts, base = [], 0
        for size, k in zip(sizes, ks):
            parts.append(uniform(1, k, size)[0] + base)
            base += size
        return torch.cat(parts)[None], base

    cases = [
        ("bench_skewed", skewed(2, 8192, 2**14), 2**14),
        ("bench_padded_rows", uniform(1, 4096, 9264), 9264),
        ("bench_odd_blocks", uniform(3, 16384, 3 * 2048), 3 * 2048),
        ("bench_merged", *merged((1000, 4096, 9264), (512, 2048, 4096))),
    ]
    out = []
    for name, k, R in cases:
        G, K = k.shape
        vals = torch.randn((G, 16, K), generator=gen, device=dev)
        out.append((name, vals, k.to(torch.int32).contiguous(), R))
    return out


def skew_segment_cases(dev, layout):
    """(name, vals, keys, n_rows) on the card: a stream of 917,504 entries
    over 524,288 rows with 700,000 of them on one row, and the same K and
    n_rows on uniform keys; (1, 32, K) float32 values for B1 ("ts"), a
    (1, K, 2) float32 row-major stream for B3 ("rows"), a (1, 10, K) bf16
    factor stream (F = 2) for B4 ("tsf")."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    K, R = 917504, 524288
    uniform = torch.sort(torch.randint(0, R, (1, K), generator=gen, device=dev),
                         dim=1).values
    skew = uniform.clone()
    skew[0, 100000:800000] = R // 3  # one row of 700,000 samples
    out = []
    for name, k in (("uniform_917504", uniform),
                    ("one_row_700000", torch.sort(skew, dim=1).values)):
        if layout == "ts":
            vals = torch.randn((1, 32, K), generator=gen, device=dev)
        elif layout == "rows":
            vals = torch.randn((1, K, 2), generator=gen, device=dev)
        else:
            vals = torch.cat([torch.rand((1, 8, K), generator=gen, device=dev),
                              torch.randn((1, 2, K), generator=gen, device=dev)],
                             dim=1).to(torch.bfloat16)
        out.append((f"{layout}_{name}", vals, k.to(torch.int32).contiguous(), R))
    return out


def check_out_of_range(dev, layout):
    """Every key outside [0, n_rows): the output is exactly 0, twice."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    R = 4096
    keys = torch.sort(torch.cat([
        torch.randint(-5000, 0, (2, 30000), generator=gen, device=dev),
        torch.randint(R, R + 900, (2, 60000), generator=gen, device=dev)],
        dim=1), dim=1).values.to(torch.int32).contiguous()
    shape = {"ts": (2, 32, keys.shape[1]), "rows": (2, keys.shape[1], 2),
             "tsf": (2, 10, keys.shape[1])}[layout]
    vals = torch.randn(shape, generator=gen, device=dev)
    if layout == "tsf":
        vals = vals.to(torch.bfloat16)
    kernel = _ops(2)[layout][0]
    got = kernel(vals, keys, R)
    again = kernel(vals, keys, R)
    torch.cuda.synchronize()
    ok = not bool(got.any()) and torch.equal(got, again)
    log(f"segment_sum[{layout}] all keys out of range: G=2 K={keys.shape[1]} "
        f"n_rows={R}: output all 0 and repeatable {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"segment_sum[{layout}] with every key out of range")


def ptxas_report(lib_path, sources=("segment_sum.cu", "segment_sum_rows.cu",
                                    "segment_sum_factors.cu", "fused_adam.cu",
                                    "widen_slabs.cu", "march.cu",
                                    "hash_corners.cu")):
    """Registers and spills of every kernel of ``sources``, from the
    ``-Xptxas -v`` report of the build."""
    from virus_nerf_tpu_torch.ops import _build

    path = _build.ptxas_log(lib_path)
    if not path.exists():
        log(f"ptxas: no report beside {lib_path.name}")
        return
    section, name, spills = None, None, ""
    for line in path.read_text().splitlines():
        if line.startswith("== "):
            section = line.strip("= ")
        elif section in sources and "Compiling entry function" in line:
            name = line.split("'")[1]
        elif section in sources and name and "spill stores" in line:
            spills = line.strip()
        elif section in sources and name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            log(f"ptxas {section}: {_demangle(name)}: {regs}; {spills}")
            name = None


def _demangle(name: str) -> str:
    try:
        out = subprocess.run(["cu++filt", name], capture_output=True, text=True,
                             timeout=10)
    except OSError:
        return name
    return out.stdout.strip() or name


def rows_segment_cases(dev):
    """(name, vals, keys, n_rows) on the card, (G, K, F=2) streams for B3:
    uniform keys, one row holding most of the stream, trailing rows no key
    hits, and an odd number of groups."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def keys(G, K, R):
        return torch.sort(torch.randint(0, R, (G, K), generator=gen,
                                        device=dev), dim=1).values

    skew = keys(1, 917504, 4096)
    skew[0, 100000:800000] = 2000  # one row of 700,000 samples
    cases = [
        ("rows_uniform", keys(10, 114688, 524288), 524288),
        ("rows_skewed", torch.sort(skew, dim=1).values, 4096),
        ("rows_padded_rows", keys(1, 60000, 4096), 4920),
        ("rows_odd_groups", keys(3, 50001, 10648), 10648),
    ]
    out = []
    for name, k, R in cases:
        G, K = k.shape
        vals = torch.randn((G, K, 2), generator=gen, device=dev)
        out.append((name, vals, k.to(torch.int32).contiguous(), R))
    return out


def slice_segment_cases(model, xyz, dev):
    """(name, vals, keys, n_rows) of the additive hash backward at the
    positions one training step of the bench path fed the model: the merged
    run of dense levels and the same-size hashed group, with the skewed keys
    that real samples give.  The output gradient is random (seeded)."""
    from virus_nerf_tpu_torch.ops.hash_encoder import (
        hash_base_rows,
        table_grad_streams,
    )

    spec = model.hash_spec
    x_unit = (xyz.reshape(-1, 3) + model.scale) / (2.0 * model.scale)
    base, w = hash_base_rows(spec, x_unit)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    g = torch.randn((x_unit.shape[0], spec.out_dim), generator=gen, device=dev)
    out = []
    for vals, keys, R, _ in table_grad_streams(spec, base, w, g):
        name = "slice_merged_dense" if keys.shape[0] == 1 else "slice_hashed_group"
        out.append((name, vals, keys, R))
    return out


def b1_at_last_step(name, state, xyz, dev):
    """B1 against its plain version at the keys of a run's last step."""
    cases = slice_segment_cases(state.model, xyz, dev)
    if [c[0] for c in cases] != ["slice_merged_dense", "slice_hashed_group"]:
        fail(f"{name}: unexpected hash backward streams {[c[0] for c in cases]}")
    return sum_results([check_segment_sum(*case, layout="ts") for case in cases])


def xor_segment_cases(model, xyz, dev):
    """(name, vals, keys, n_rows) of the XOR hash backward at the positions
    of one training step of the XOR path: the merged dense levels and the
    hashed group.  The output gradient is random (seeded)."""
    from virus_nerf_tpu_torch.ops.hash_encoder import (
        xor_corner_rows,
        xor_table_grad_streams,
    )

    spec = model.hash_spec
    x_unit = (xyz.reshape(-1, 3) + model.scale) / (2.0 * model.scale)
    rows, w = xor_corner_rows(spec, x_unit)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    g = torch.randn((x_unit.shape[0], spec.out_dim), generator=gen, device=dev)
    out = []
    for vals, keys, R in xor_table_grad_streams(spec, rows, w, g):
        name = "xor_merged_dense" if keys.shape[0] == 1 else "xor_hashed_group"
        out.append((name, vals, keys, R))
    return out


def factor_segment_cases(model, xyz, dev, factor_dtype):
    """(name, factors, keys, n_rows) of the ``factors`` backward at the
    positions of one training step of the slabs path: the merged dense
    levels and the hashed group, (G, 8+F, K) factor streams in
    ``factor_dtype``.  The output gradient is random (seeded)."""
    from virus_nerf_tpu_torch.ops.hash_encoder import (
        hash_base_rows,
        table_grad_factor_streams,
    )

    spec = model.hash_spec
    x_unit = (xyz.reshape(-1, 3) + model.scale) / (2.0 * model.scale)
    base, w = hash_base_rows(spec, x_unit)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    g = torch.randn((x_unit.shape[0], spec.out_dim), generator=gen, device=dev)
    out = []
    for wgt, keys, R, _ in table_grad_factor_streams(spec, base, w, g,
                                                     factor_dtype):
        name = ("factors_merged_dense" if keys.shape[0] == 1
                else "factors_hashed_group")
        out.append((name, wgt, keys, R))
    return out


def _ops(F: int = 0):
    from virus_nerf_tpu_torch.ops import segment_sum as ss

    # layout -> (kernel wrapper, plain version, the summed terms as a
    # (G, width, K) tensor in the dtype the kernel sums them, a part of the
    # kernel's device function names)
    return {
        "ts": (ss.segment_sum_sorted, ss.segment_sum_sorted_plain,
               lambda v: v, "TransposedLoader"),
        "rows": (ss.group_segment_sum_t_sorted,
                 ss.group_segment_sum_t_sorted_plain,
                 lambda v: v.transpose(1, 2), "RowLoader"),
        "tsf": (lambda v, k, R: ss.group_segment_sum_tsf_sorted(v, k, R, F),
                lambda v, k, R: ss.group_segment_sum_tsf_sorted_plain(v, k, R, F),
                lambda v: ss.factor_products(v, F), "FactorLoader"),
    }


def check_segment_sum(name, vals, keys, R, layout: str = "ts"):
    """Kernel against its plain version (and both against a float64 sum) on
    one case.  The tolerance per output is 4 * eps32 * sqrt(n) * sum|v| over
    the row's n samples: rounding errors of a serial or atomic sum grow like
    a random walk over the partial sums, each at most sum|v|, so the bound
    keeps its margin on long segments while a dropped or misplaced sample
    still fails; an empty row must be exactly 0.  For the factor layout the
    summed terms are the products as the factor dtype rounds them.  Returns
    a dict of max_abs_err, ms, device_ms (the kernel's two launches),
    plain_ms, library_ms, bound_ms, bound_by."""
    from virus_nerf_tpu_torch.ops.segment_sum import segment_sum_sorted_plain

    F = vals.shape[1] - 8 if layout == "tsf" else 0
    kernel, plain, terms_of, kernel_name = _ops(F)[layout]
    G, K = keys.shape
    got = kernel(vals, keys, R)
    again = kernel(vals, keys, R)
    want = plain(vals, keys, R)
    terms = terms_of(vals)  # (G, width, K)
    width = terms.shape[1]
    exact = segment_sum_sorted_plain(terms.double(), keys, R)
    counts = torch.stack([torch.bincount(keys[g].long(), minlength=R)
                          for g in range(G)]).double()  # (G, R)
    tol = (4.0 * torch.finfo(torch.float32).eps * counts.sqrt()[:, None, :]
           * segment_sum_sorted_plain(terms.abs().double(), keys, R))
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    # kernel vs plain: both are float32 sums in another order
    ratio = float((diff / (2 * tol)).nan_to_num(posinf=float("inf")).max())
    ratio_exact = float(((got.double() - exact).abs() / tol)
                        .nan_to_num(posinf=float("inf")).max())
    shape_ok = tuple(got.shape) == (G, width, R)
    repeat = torch.equal(got, again)  # deterministic: bit-identical
    ok = shape_ok and repeat and ratio <= 1.0 and ratio_exact <= 1.0

    # the library call, the same function as the kernel: a zero fill of
    # the (G*R, width) output and one index_add_ of the (G*K, width) terms
    # into it (terms, index and layout prepared outside the timing; for the
    # factor layout the products are materialized there)
    src = terms.float().transpose(1, 2).reshape(G * K, width).contiguous()
    idx = (keys.long() + R * torch.arange(G, device=keys.device)[:, None]).reshape(-1)
    ms, plain_ms, lib_ms = time_turns([
        lambda: kernel(vals, keys, R),
        lambda: plain(vals, keys, R),
        lambda: torch.zeros((G * R, width), device=vals.device).index_add_(
            0, idx, src),
    ])
    dev_ms = device_ms(lambda: kernel(vals, keys, R), kernel_name, per_call=2)
    graph = {}
    if layout == "rows":
        # B3 under a CUDA graph, as the training chunk runs it (ROADMAP
        # Queue B open work 2: the small streams' host gap)
        graph["graph_ms"], graph["graph_library_ms"] = graph_time_turns([
            lambda: kernel(vals, keys, R),
            lambda: torch.zeros((G * R, width), device=vals.device).index_add_(
                0, idx, src)])
    # each input read once, each output written once; one add per term
    # (and one multiply for a factor product)
    b_ms, b_by = bound_ms(
        vals.numel() * vals.element_size() + 4.0 * (keys.numel() + G * width * R),
        terms.numel() * (2 if layout == "tsf" else 1))
    top = torch.sort(counts.reshape(-1), descending=True).values
    share = float(top[:max(1, G * R // 100)].sum()) / keys.numel()
    log(f"segment_sum[{layout}] {name}: G={G} width={width} K={K} n_rows={R} "
        f"{vals.dtype} longest segment {int(top[0])}, top 1% rows hold "
        f"{share:.3f} of the samples; max_abs_err {err:.3e}, err/tol "
        f"{ratio:.3f} vs plain, {ratio_exact:.3f} vs float64 (tol "
        f"4*eps32*sqrt(n)*sum|v| per row), two calls bit-identical {repeat}; "
        f"kernel {ms:.4f} ms (device {dev_ms:.4f}) plain "
        f"{plain_ms:.4f} ms zeros+index_add_ {lib_ms:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by}){''.join(f' {k} {v:.4f}' for k, v in graph.items())} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"segment_sum[{layout}] {name} disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, **graph}


def sum_results(results):
    """One kernel entry over several calls (one step's calls): times and
    bounds add, the error is the largest."""
    out = {k: sum(r[k] for r in results)
           for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                     "graph_ms", "graph_library_ms")
           if k in results[0]}
    out["max_abs_err"] = max(r["max_abs_err"] for r in results)
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                     for r in results) else "operations"
    return out


# ------------------------------------------------------- widened slabs (B5)
def slab_group_cases(model):
    """(name, table, row0, size, G, corner_offsets) of every slab group that
    B5 builds from the model's table (the bf16 groups)."""
    from virus_nerf_tpu_torch.ops.hash_encoder import packable_size

    table = model.pos_table.detach()
    consts = model._spec_consts(table.device)
    return [
        (f"slabs_G{len(lvls)}x{size}", table, row0, size, len(lvls), offs)
        for lvls, row0, size, offs in consts.slab_groups
        if table.dtype == torch.bfloat16 or packable_size(size, consts.feat_dim)
    ]


def check_widen(name, table, row0, size, G, offs):
    """B5 against its plain version, bit for bit, and timed; the library
    call is one advanced-index gather of the corner rows cast to bf16."""
    from virus_nerf_tpu_torch.ops.hash_encoder import slab_corner_rows
    from virus_nerf_tpu_torch.ops.widen import (
        widen_slabs_group,
        widen_slabs_group_plain,
    )

    args = (table, row0, size, G, offs)
    got = widen_slabs_group(*args)
    want = widen_slabs_group_plain(*args)
    torch.cuda.synchronize()
    ok = got.shape == want.shape and torch.equal(got.view(torch.int16),
                                                 want.view(torch.int16))
    idx = slab_corner_rows(row0, size, G, offs, table.device)  # (G, s, 8)
    ms, plain_ms, lib_ms = time_turns([
        lambda: widen_slabs_group(*args),
        lambda: widen_slabs_group_plain(*args),
        lambda: table[idx].to(torch.bfloat16),
    ])
    dev_ms = device_ms(lambda: widen_slabs_group(*args), "widen_slabs_kernel")
    F = table.shape[1]
    # the group's table rows read once, the bf16 slabs written once
    b_ms, b_by = bound_ms(G * size * F * (table.element_size() + 8 * 2), 0)
    log(f"widen_slabs {name}: G={G} size={size} F={F} {table.dtype} table; "
        f"bit-exact {ok}; kernel {ms:.4f} ms (device {dev_ms:.4f}) plain {plain_ms:.4f} ms "
        f"table[idx].to(bf16) {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"widen_slabs {name} disagrees with its plain version")
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by}


# ------------------------------------------------------------ fused Adam (B2)
def bf16_ulp_distance(a, b):
    """How many bf16 values lie between a and b, elementwise (0: equal, 1:
    neighbours), from their bit patterns in the order of the values."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def check_adam(dev, name, leaves):
    """Fused Adam on the leaves ``[(shape, p dtype)]`` (float32 moments and
    gradients), all in one ``adam_update_leaves_`` call, against its plain
    version leaf by leaf, and timed.  The library call is PyTorch's fused
    Adam over the same leaf list; with a bf16 p it would keep bf16
    moments, another function, so it is not timed (library_ms None).
    Returns a result dict."""
    from virus_nerf_tpu_torch.ops.fused_adam import (
        adam_hyper,
        adam_scal,
        adam_update_leaves_,
        adam_update_leaves_plain_,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    made = []
    for shape, dtype in leaves:
        p, g = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
        mu = torch.randn(shape, generator=gen, device=dev) * 0.1
        nu = torch.rand(shape, generator=gen, device=dev) * 0.01
        made.append((p.to(dtype), g, mu, nu))
    # scal at step 3, formed on the card as a step forms it
    scal = adam_scal(torch.tensor(3, dtype=torch.int32, device=dev),
                     adam_hyper(1e-2, 0.9, 0.999, dev))
    args = (scal, 0.9, 0.999, 1e-15)
    # kernel, plain and library copies of (p, g, mu, nu)
    a, b, c = ([(p.clone(), g, mu.clone(), nu.clone()) for p, g, mu, nu in made]
               for _ in range(3))
    adam_update_leaves_(a, *args)
    adam_update_leaves_plain_(b, *args)
    torch.cuda.synchronize()
    err = moments_err = 0.0
    p_ulps = 0
    for (pa, _, ma, va), (pb, _, mb, vb) in zip(a, b):
        moments_err = max(moments_err, float((ma - mb).abs().max()),
                          float((va - vb).abs().max()))
        err = max(err, moments_err, float((pa.float() - pb.float()).abs().max()))
        if pa.dtype == torch.bfloat16:
            p_ulps = max(p_ulps, int(bf16_ulp_distance(pa, pb).max()))
    # the bench's gate for the TPU kernel (bench.py:276): 1e-6; a bf16 p
    # rounds a float32 sum that may be an ulp apart: one bf16 ulp
    f32_err = max([float((pa - pb).abs().max()) for (pa, *_), (pb, *_) in zip(a, b)
                   if pa.dtype == torch.float32] + [0.0])
    ok = moments_err <= 1e-6 and f32_err <= 1e-6 and p_ulps <= 1
    fns = [lambda: adam_update_leaves_(a, *args),
           lambda: adam_update_leaves_plain_(b, *args)]
    bf16 = any(dtype == torch.bfloat16 for _, dtype in leaves)
    if not bf16:
        # the library call: PyTorch's fused Adam over the same leaves
        steps = [torch.tensor(3.0, device=dev) for _ in c]
        fns.append(lambda: torch._fused_adam_(
            [x[0] for x in c], [x[1] for x in c], [x[2] for x in c],
            [x[3] for x in c], [], steps, lr=1e-2, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-15, amsgrad=False, maximize=False))
    ms, plain_ms, *lib = time_turns(fns)
    lib_ms = lib[0] if lib else None
    dev_ms = device_ms(lambda: adam_update_leaves_(a, *args), "fused_adam_kernel")
    # reads p, g, mu, nu and writes p, mu, nu; ~12 float32 operations
    # per element
    n = sum(x[0].numel() for x in made)
    n_bytes = sum((2 * x[0].element_size() + 5 * 4.0) * x[0].numel() for x in made)
    b_ms, b_by = bound_ms(n_bytes, 12.0 * n)
    log(f"fused_adam {name}: {len(leaves)} leaves, {n} elements, "
        f"{'bf16 and float32' if bf16 else 'float32'} p, one call: max_abs_err "
        f"{err:.3e} (moments {moments_err:.3e}, float32 p {f32_err:.3e}, tol "
        f"1e-6; bf16 p at most {p_ulps} ulp apart, tol 1) kernel {ms:.4f} ms "
        f"(device {dev_ms:.4f}) "
        f"plain {plain_ms:.4f} ms torch._fused_adam_ "
        f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms bound {b_ms:.4f} ms "
        f"({b_by}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"fused_adam {name} disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def check_adam_per_step(name, launches, steps):
    """B2 launches once a step for every leaf on the card: one launch per
    optimizer step of the path, no plain small-leaf update."""
    n = launches["fused_adam"]
    log(f"{name}: fused_adam launches {n} over {steps} steps ({n / steps:g} "
        f"a step, all leaves)")
    if n != steps:
        fail(f"{name}: {n} fused_adam launches over {steps} steps, want one a step")


# ------------------------------------------------------- small reference
def grid_to(grid, dev):
    """A grid state (VIRUS or NGP) with its tensors moved to ``dev``."""
    return type(grid)(*(x.to(dev) if torch.is_tensor(x) else x for x in grid))


def reference_step(dev, hash_variant: str, dtype: str = "float32",
                   ref=torch.device("cpu"), scale: float = 0.5,
                   grid_type: str = "occ", distortion: float = 0.0, **routes):
    """One grid update + train step of a small config on the card and on
    the CPU (plain versions) from the same weights and draws.  The 16 x 2
    layouts (XOR, and the additive routes and compute modes) take levels of
    up to 2^17 rows, so the additive hashed group has bf16 slabs.  At
    ``scale`` 1.0 the march steps exponentially over two cascades; the NGP
    grid's update is its warm-up.
    Returns the card's model and the positions its training step fed it."""
    from virus_nerf_tpu_torch.configs.config import Config
    from virus_nerf_tpu_torch.data.dataset import Batch, sample_batch
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.grids.ngp_grid import ngp_cell_draws
    from virus_nerf_tpu_torch.training.trainer import (
        NGP_DENSITY_THRESHOLD,
        Trainer,
    )

    cfg = Config()
    m, t = cfg.model, cfg.training
    m.hash_variant, m.dtype = hash_variant, dtype
    m.scale, m.grid_type = scale, grid_type
    t.distortion_loss_w = distortion
    # tables of 8 x 4 levels of up to 2^16 rows or 16 x 2 of up to 2^16
    # (XOR) or 2^17 rows: over 2^20 elements, so the Adam kernel runs
    wide = hash_variant == "xor" or routes or dtype != "float32"
    m.hash_levels, m.hash_features_per_level = (16, 2) if wide else (8, 4)
    m.hash_log2_T = 17 if wide and hash_variant != "xor" else 16
    m.hash_max_res, m.grid_size = 256, 32
    t.batch_size, t.max_samples_per_ray, t.sample_budget = 256, 32, 256 * 12
    t.march_candidates = t.march_resolution = 256
    t.sampling_strategy = {"imgs": "all",
                           "pixs": {"valid_uss": 0.4, "valid_tof": 0.4}}
    t.sensors = ["USS", "ToF"]
    cfg.occ_grid.batch_size = 128
    kw = dict(n_images=4, img_wh=(32, 24), n_gt_points=2000)
    runs = []
    for d in (ref, dev):
        ds, scene, _ = make_synthetic_dataset(device=d, **kw)
        runs.append((Trainer(cfg, ds, scene=scene, device=d, **routes), ds))
    (tc, dsc), (tg, _) = runs
    sc = tc.init_state(0)
    sg = tg.init_state(0)
    sg.model.load_state_dict({k: v.to(dev) for k, v in sc.model.state_dict().items()})
    sg.grid = grid_to(sc.grid, dev)

    gen = torch.Generator()
    gen.manual_seed(5)
    ray_b = sample_batch(dsc, gen, tc.b_ray, {"imgs": "all", "pixs": "valid_tof"})
    nerf_b = sample_batch(dsc, gen, tc.b_nerf, {"imgs": "all", "pixs": "valid_uss"})
    pos_noise = torch.rand((tc.b_nerf, 32, 3), generator=gen) * 2 - 1
    batch = sample_batch(dsc, gen, t.batch_size, t.sampling_strategy)
    noise = torch.rand((t.batch_size,), generator=gen)

    def to(b):
        return Batch(*[{k: v.to(dev) for k, v in x.items()} if isinstance(x, dict)
                       else x.to(dev) for x in b])

    if grid_type == "occ":
        tc.grid_update_on(sc, ray_b, nerf_b, pos_noise)
        tg.grid_update_on(sg, to(ray_b), to(nerf_b), pos_noise.to(dev))
        grid_diff = (sg.grid.occ_3d_grid.cpu() - sc.grid.occ_3d_grid).abs()
    else:
        # the warm-up update: every cell of both cascades, the same jitter
        draws = ngp_cell_draws(sc.grid, gen, warmup=True,
                               density_threshold=NGP_DENSITY_THRESHOLD,
                               grid_size=m.grid_size)
        tc.ngp_update_on(sc, draws)
        tg.ngp_update_on(sg, [(i.to(dev), j.to(dev)) for i, j in draws])
        # densities relative to their size: float32 model on two devices
        grid_diff = ((sg.grid.density_grid.cpu() - sc.grid.density_grid).abs()
                     / sc.grid.density_grid.abs().clamp(min=1.0))
    grid_err = float(grid_diff.max())
    grid_off = float((grid_diff > 1e-5).float().mean())
    # the step marches both on the same boolean grid
    sg.grid = grid_to(sc.grid, dev)
    seen = {}
    hook = sg.model.register_forward_pre_hook(
        lambda mod, args: seen.update(xyz=args[0].detach()))
    mc = tc.train_step_on(sc, batch, noise)
    mg = tg.train_step_on(sg, to(batch), noise.to(dev))
    hook.remove()
    loss_c, loss_g = float(mc["loss"]), float(mg["loss"])
    rel = abs(loss_g - loss_c) / abs(loss_c)
    diff = (sg.model.pos_table.detach().cpu().float()
            - sc.model.pos_table.detach().float()).abs()
    flipped = float((diff > 1e-6).float().mean())
    # float32 in another op order on each device; the table differs only
    # where a near-zero gradient took the other sign at Adam step 1.  In the
    # bf16 modes a bf16 rounding that falls the other way (cuBLAS and the
    # CPU accumulate the bf16 products in other orders) moves an activation
    # by 2^-8 relative: the loss is held to 1e-3, and a bf16 table entry
    # may also round p + d to a neighbouring bf16 value (2^-7 * |p|).  Such
    # a rounding can also move a grid cell's density across its threshold:
    # at most 1e-3 of the cells may differ
    bf16 = dtype != "float32"
    loss_tol, flip_tol = (1e-3, 5e-3) if bf16 else (1e-4, 2e-3)
    grid_ok = grid_off <= 1e-3 if bf16 else grid_err <= 1e-5
    grid_tol = "share 1e-3" if bf16 else "max 1e-5"
    if grid_type == "ngp":
        # a density relative to max(1, itself): the MLP's float32 products
        # in another order on each device
        grid_ok, grid_tol = grid_err <= 1e-4, "max 1e-4 relative"
    step_tol = 2 * t.lr * (1 + 1e-5) + (
        2.0**-7 * float(sc.model.pos_table.detach().float().abs().max())
        if sc.model.pos_table.dtype == torch.bfloat16 else 0.0)
    label = (f"{hash_variant} {dtype} {routes or 'default routes'} scale "
             f"{scale} {grid_type} grid distortion {distortion:g}")
    log(f"reference step ({label} small config, card vs CPU): grid "
        f"max_abs_err {grid_err:.3e}, cells off by > 1e-5 {grid_off:.2e} "
        f"(tol {grid_tol}), loss {loss_g:.6f} vs "
        f"{loss_c:.6f} rel {rel:.2e} (tol {loss_tol:g}), rm "
        f"{int(mg['rm_samples'])} vs {int(mc['rm_samples'])}, table entries "
        f"off by > 1e-6: {flipped:.2e} (tol {flip_tol:g}: Adam sign steps of "
        f"near-zero gradients), largest {float(diff.max()):.3e} (tol "
        f"{step_tol:.3e})")
    if not (grid_ok and rel <= loss_tol and flipped <= flip_tol
            and float(diff.max()) <= step_tol):
        fail(f"the {label} small-config step on the card disagrees with the "
             f"CPU")
    return sg.model, seen["xyz"]


# ---------------------------------------------------------------- the paths
def bench_config():
    """``bench.py``'s configuration (:311-348: the reference's ETHZ camera
    + USS + ToF budget at batch 4096, the VIRUS grid updated every 8 steps,
    the 8-level x F=4 hash of 2^19 rows, a 28-sample-a-ray budget), run
    for 48 steps."""
    from virus_nerf_tpu_torch.configs.config import Config

    cfg = Config()
    cfg.model.grid_type = "occ"
    cfg.model.grid_size = 128
    cfg.model.scale = 0.5
    cfg.model.hash_levels = 8
    cfg.model.hash_features_per_level = 4
    cfg.model.hash_log2_T = 19
    cfg.model.hash_max_res = 1024
    cfg.training.batch_size = 4096
    cfg.training.max_samples_per_ray = 128
    cfg.training.march_candidates = 1024
    cfg.training.sample_budget = 4096 * 28
    cfg.training.sampling_strategy = {
        "imgs": "all", "pixs": {"valid_uss": 0.4, "valid_tof": 0.4},
    }
    cfg.training.sensors = ["USS", "ToF"]
    cfg.occ_grid.batch_size = 1024
    cfg.occ_grid.update_interval = 8
    cfg.training.max_steps = 48
    cfg.training.max_time = 1e9  # the step count ends this run
    cfg.evaluation.eval_every_n_steps = 8  # metrics fetched every 8 steps
    return cfg


def kernel_wrappers():
    """The counted kernel wrappers by name, and the march counter (call
    once a process: it wraps the renderer's march)."""
    from virus_nerf_tpu_torch.ops.fused_adam import adam_update_leaves_
    from virus_nerf_tpu_torch.ops.hash_corners import hash_corners
    from virus_nerf_tpu_torch.ops.nn_search import nn_search
    from virus_nerf_tpu_torch.ops.ray_march import march_lattice, march_select
    from virus_nerf_tpu_torch.ops.segment_sum import (
        group_segment_sum_t_sorted,
        group_segment_sum_tsf_sorted,
        segment_sum_sorted,
    )
    from virus_nerf_tpu_torch.ops.slice_scan import slice_scan
    from virus_nerf_tpu_torch.ops.trace_stamp import trace_stamp
    from virus_nerf_tpu_torch.ops.widen import widen_slabs_group

    return {"segment_sum": segment_sum_sorted, "fused_adam": adam_update_leaves_,
            "segment_sum_rows": group_segment_sum_t_sorted,
            "segment_sum_factors": group_segment_sum_tsf_sorted,
            "widen_slabs": widen_slabs_group,
            "march_select": march_select, "march_lattice": march_lattice,
            "trace_stamp": trace_stamp, "slice_scan": slice_scan,
            "nn_search": nn_search, "marches": count_marches(),
            "evaluations": count_evaluations(),
            "nn_metrics": count_nn_metrics(), "hash_corners": hash_corners,
            "corner_encodes": count_corner_encodes()}


def reset_counts(wrappers):
    """Every count to 0, and every CUDA graph's replays since to 0."""
    from virus_nerf_tpu_torch.ops import launch_counts

    launch_counts.reset(wrappers.values())


def read_counts(wrappers):
    """The launches since the reset, graph replays included: what each
    graph holds times its replays (``ops.launch_counts``; a wrapper's own
    count moves only where it launches, which a replay does not pass)."""
    from virus_nerf_tpu_torch.ops import launch_counts

    return {name: launch_counts.launches(w) for name, w in wrappers.items()}


@contextlib.contextmanager
def training_counted(wrappers, record):
    """Count the launches of the training steps alone and time each chunk:
    ``Trainer.make_train_chunk``'s chunks and ``Trainer.run_steps`` (the
    NGP warm-up's steps) add their replay-aware launches to
    ``record["launches"]`` and (first step, steps, seconds after a sync) to
    ``record["chunks"]``."""
    from virus_nerf_tpu_torch.training.trainer import Trainer

    make_chunk, run_steps = Trainer.make_train_chunk, Trainer.run_steps
    record.setdefault("launches", {k: 0 for k in wrappers})
    record.setdefault("chunks", [])

    def counted(fn, state, *args, **kwargs):
        torch.cuda.synchronize()
        before, first = read_counts(wrappers), state.step
        tic = time.perf_counter()
        out = fn(state, *args, **kwargs)
        torch.cuda.synchronize()
        record["chunks"].append((first, state.step - first,
                                 time.perf_counter() - tic))
        for k, v in read_counts(wrappers).items():
            record["launches"][k] += v - before[k]
        return out

    def make(self, n, group=None):
        chunk = make_chunk(self, n, group)
        return lambda state, *a, **kw: counted(chunk, state, *a, **kw)

    def steps(self, state, *args, **kwargs):
        return counted(lambda st, *a, **kw: run_steps(self, st, *a, **kw),
                       state, *args, **kwargs)

    with mock.patch.object(Trainer, "make_train_chunk", make), \
            mock.patch.object(Trainer, "run_steps", steps):
        yield record


def chunk_step_s(record, first_steady):
    """Seconds a step over the chunks that start at ``first_steady`` or
    later (each timed alone, after a sync)."""
    done = [(n, s) for first, n, s in record["chunks"] if first >= first_steady]
    return sum(s for _, s in done) / sum(n for n, _ in done)


def check_training(name, trainer, state, n_steps, first_steady, falls=True):
    """Finite loss over the run, falling unless ``falls`` is False; returns
    steady-state ms/step from the chunk-end times (each after a device
    sync) after ``first_steady``."""
    logs = trainer.logs
    losses = np.asarray(logs["loss"])
    steps = np.asarray(logs["step"])
    times = np.asarray(logs["time"])
    i0, i1 = int(np.where(steps == first_steady - 1)[0][0]), len(steps) - 1
    step_s = (times[i1] - times[i0]) / (steps[i1] - steps[i0])
    occupied = float(state.grid.occ_bool.float().mean())
    updates = getattr(state.grid, "update_step", "-")
    log(f"{name}: loss first {losses[0]:.4f} last {losses[-1]:.4f}; mean of "
        f"the first 8 steps {losses[:8].mean():.4f}, the last 8 "
        f"{losses[-8:].mean():.4f}; psnr last {logs['psnr'][-1]:.2f}; "
        f"rm_samples last {int(logs['rm_samples'][-1])}; vr_samples last "
        f"{int(logs['vr_samples'][-1])}; overflow last "
        f"{int(logs['overflow'][-1])}; grid updates {updates}; "
        f"occupied cells {occupied:.4f}")
    if state.step != n_steps or len(losses) != n_steps:
        fail(f"{name}: ran {state.step} steps, logged {len(losses)}, want {n_steps}")
    if not np.all(np.isfinite(losses)):
        fail(f"{name}: non-finite loss")
    if falls and not losses[-8:].mean() < losses[:8].mean():
        fail(f"{name}: loss did not fall over {n_steps} steps")
    want_updates = -(-n_steps // trainer.grid_update_interval)
    if updates == "-":  # the NGP grid keeps no count: its densities moved
        if not 0.0 < occupied < 1.0 or not bool(
                (state.grid.density_grid > 0).any()):
            fail(f"{name}: NGP grid not updated (occupied share {occupied})")
    elif updates != want_updates:
        fail(f"{name}: {updates} grid updates, want {want_updates}")
    if not torch.isfinite(state.model.pos_table).all():
        fail(f"{name}: non-finite hash table")
    return step_s


def check_launched(name, launches, kernels):
    for k in kernels:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the {name}")


def run_quality_path(name, argv, wrappers, card):
    """Train and evaluate through ``quality_run`` with the kernel counts
    set to 0 just before and read just after; check the run as the XOR and
    slabs paths must hold.  Returns (result JSON, trainer, state, launches,
    positions of the last training step)."""
    from virus_nerf_tpu_torch import quality_run
    from virus_nerf_tpu_torch.models.ngp import NGPModel

    args = quality_run.parse_args(argv)
    seen = {}

    def keep_train_positions(mod, inputs):
        if isinstance(mod, NGPModel) and torch.is_grad_enabled():
            seen["xyz"] = inputs[0].detach()

    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        keep_train_positions)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    out, trainer, state = quality_run.run(args)
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    hook.remove()
    step_s = check_training(name, trainer, state, 32, 8)
    log(f"{name}: {state.step} steps in {out['train_seconds']} s (incl. "
        f"first-step warm-up, {out['train_rays_per_sec']} rays/s); steady state "
        f"steps 8-32: {1e3 * step_s:.2f} ms/step, "
        f"{trainer.cfg.training.batch_size / step_s:.0f} rays/s; evaluation "
        f"{out['eval_seconds']:.2f} s; on {card}")
    log(f"{name}: NeRF nn_mean z3 {out['NeRF']['nn_mean_zone3']:.4f} m, ToF "
        f"{out['ToF']['nn_mean_zone3']:.4f} m, USS "
        f"{out['USS']['nn_mean_zone3']:.4f} m; psnr {out['psnr']:.3f} ssim "
        f"{out['ssim']:.4f}")
    log(f"{name}: kernel launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if state.model.pos_table.shape != (5_710_032, 2):
        fail(f"{name}: table shape {tuple(state.model.pos_table.shape)}")
    nnd = [out[s][k] for s in ("NeRF", "ToF", "USS") for k in out[s]]
    if not (np.all(np.isfinite(nnd)) and np.isfinite(out["psnr"])):
        fail(f"{name}: non-finite evaluation: {out}")
    return out, trainer, state, launches, seen["xyz"]


# ------------------------------------------------ the exponential-step paths
def scale1_config():
    """The bench configuration at ``model.scale = 1.0``
    (``VNERF_BENCH_SCALE=1.0``, bench.py:313-316): two cascades,
    exp_step_factor 1/256, the budget 4096 * 28 kept."""
    cfg = bench_config()
    cfg.model.scale = 1.0
    return cfg


def ngp_config():
    """The scale-1.0 configuration on the NGP grid (2 x 128^3; a warm-up
    update at step 0, a steady one at step 16) with the distortion loss,
    "closest" pixels and real-time simulation, 32 steps."""
    cfg = scale1_config()
    cfg.model.grid_type = "ngp"
    cfg.ngp_grid.update_interval, cfg.ngp_grid.warmup_steps = 16, 16
    cfg.training.distortion_loss_w = 1e-3
    cfg.training.sampling_strategy = {
        "imgs": "all",
        "pixs": {"closest": 0.2, "valid_uss": 0.3, "valid_tof": 0.3},
    }
    cfg.training.real_time_simulation = True
    cfg.training.max_steps = 32
    return cfg


def run_path(name, trainer, n_steps, first_steady, wrappers, card):
    """Train from a seeded init with the kernel counts set to 0 just before
    and read just after; returns (state, launches, positions of the last
    step, seconds of the whole run).  Under real-time simulation the loss
    is not held to fall: images join the batches as the clock runs."""
    state = trainer.init_state()
    seen = {}
    hook = state.model.register_forward_pre_hook(
        lambda mod, args: seen.update(xyz=args[0].detach()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    tic = time.perf_counter()
    state = trainer.train(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = read_counts(wrappers)
    hook.remove()
    step_s = check_training(
        name, trainer, state, n_steps, first_steady,
        falls=not trainer.cfg.training.real_time_simulation)
    per_step = {k: v / n_steps for k, v in launches.items() if v}
    log(f"{name}: {state.step} steps in {wall:.2f} s (incl. first-step "
        f"warm-up); steady state steps {first_steady}-{n_steps}: "
        f"{1e3 * step_s:.2f} ms/step, "
        f"{trainer.cfg.training.batch_size / step_s:.0f} rays/s on {card}")
    log(f"{name}: kernel launches {launches}, a step {per_step}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches["march_select"] != n_steps:
        fail(f"{name}: {launches['march_select']} march launches over "
             f"{n_steps} steps, want one a step")
    check_marches(name, launches)
    check_launched(name, launches, ("segment_sum", "fused_adam"))
    check_adam_per_step(name, launches, n_steps)
    return state, launches, seen["xyz"], wall


def check_lattice(dev, dataset, cfg):
    """The lattice kernel against its plain loop, bit for bit, on the rays
    of a batch the scale-1.0 path draws (4096 x 1024), and timed.  No
    PyTorch call computes the recurrence (library_ms None)."""
    from virus_nerf_tpu_torch.data.dataset import sample_batch
    from virus_nerf_tpu_torch.ops.intersection import ray_aabb_intersect
    from virus_nerf_tpu_torch.ops.ray_march import (
        march_lattice,
        march_lattice_plain,
    )

    t = cfg.training
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    b = sample_batch(dataset, gen, t.batch_size, t.sampling_strategy)
    t1 = ray_aabb_intersect(b.rays_o, b.rays_d, cfg.model.scale)[:, 0].contiguous()
    noise = torch.rand(t.batch_size, generator=gen, device=dev)
    args = (t1, noise, cfg.exp_step_factor, cfg.model.grid_size,
            cfg.model.scale, t.march_candidates, t.march_resolution)
    ts, dts = march_lattice(*args)
    want_ts, want_dts = march_lattice_plain(*args)
    torch.cuda.synchronize()
    ok = torch.equal(ts, want_ts) and torch.equal(dts, want_dts)
    err = max(float((ts - want_ts).abs().max()), float((dts - want_dts).abs().max()))
    ms, plain_ms = time_turns([lambda: march_lattice(*args),
                               lambda: march_lattice_plain(*args)])
    dev_ms = device_ms(lambda: march_lattice(*args), "march_lattice_kernel")
    n, K = t1.numel(), t.march_candidates
    # ts and dts written once, t1 and noise read once; a multiply and an
    # add a step
    b_ms, b_by = bound_ms(8.0 * n * K + 8.0 * n, 2.0 * n * K)
    log(f"march_lattice: n={n} K={K} esf={cfg.exp_step_factor:g} hits in "
        f"[{float(t1.min()):.3f}, {float(t1.max()):.3f}]; bit-exact {ok} "
        f"(max_abs_err {err:.3e}); kernel {ms:.4f} ms (device {dev_ms:.4f}) "
        f"plain loop {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("march_lattice disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by}


# ------------------------------------------------ the fused march (L1)
def count_marches():
    """Count the marches on the card: the renderer's ``march_rays_train``
    wrapped in a counter (``.launches``, read and reset with the kernel
    counts) of its calls on CUDA tensors.  Every path is held to one
    ``march_select`` launch a march by it."""
    from virus_nerf_tpu_torch.models import renderer

    march = renderer.march_rays_train

    def counted(rays_o, *args, **kwargs):
        if rays_o.is_cuda:
            counted.launches += 1
        return march(rays_o, *args, **kwargs)

    counted.launches = 0
    renderer.march_rays_train = counted
    # a CUDA graph that holds a march counts it at every replay
    from virus_nerf_tpu_torch.ops.launch_counts import register

    return register(counted)


def check_marches(name, launches):
    """One fused-march launch a march on the card, at least one march, and
    no launch of the standalone lattice."""
    if (launches["march_select"] != launches["marches"]
            or launches["marches"] <= 0 or launches["march_lattice"]):
        fail(f"{name}: {launches['march_select']} march_select launches over "
             f"{launches['marches']} marches, {launches['march_lattice']} "
             f"standalone lattice launches; want one fused launch a march")


# ------------------------------------------- the GT slice scan (E1, 28)
# the paths that evaluate depth on the card: each evaluation launches E1
EVALUATING = ("xor", "slabs", "ethz", "rh2", "pso", "population",
              "eval_budget")


def count_evaluations():
    """Count the depth evaluations on the card: ``Evaluator.evaluate_depth``
    wrapped in a counter (``.launches``, read and reset with the kernel
    counts) of its calls by an evaluator on a CUDA device.  Every path is
    held to one E1 launch (``slice_scan``) an evaluation by it."""
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.ops.launch_counts import register

    evaluate = Evaluator.evaluate_depth

    def counted(self, *args, **kwargs):
        if self.device.type == "cuda":
            counted.launches += 1
        return evaluate(self, *args, **kwargs)

    counted.launches = 0
    Evaluator.evaluate_depth = counted
    return register(counted)


def check_gt_scans(paths):
    """One E1 launch a depth evaluation on the card, on every path, and
    at least one evaluation on each path of :data:`EVALUATING`."""
    scans = {p: (c["slice_scan"], c["evaluations"]) for p, c in paths.items()}
    off = {p: v for p, v in scans.items() if v[0] != v[1]}
    idle = [p for p in EVALUATING if scans[p][1] <= 0]
    log(f"E1 launches and depth evaluations a path: "
        f"{ {p: v for p, v in scans.items() if v != (0, 0)} }")
    if off or idle:
        fail(f"E1 launches != depth evaluations on {off}; no evaluation on "
             f"{idle}")


def check_slice_scan(name, trainer, card, n_origins: int = 16):
    """Phase 28 on a recorded room: the scene's walk on the card
    (``Scene.scan_depths``, E1) against its plain version bit for bit, the
    depths against ``Scene.get_slice_scan``, and the times of the module
    doc.  Returns the numbers."""
    from virus_nerf_tpu_torch.data import scene as scene_module
    from virus_nerf_tpu_torch.data.scene import Scene
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.evaluation.geometry import create_scan_rays
    from virus_nerf_tpu_torch.ops.slice_scan import slice_scan, slice_scan_plain

    cfg, scene, dev = trainer.cfg, trainer.scene, trainer.device
    res, tol = cfg.evaluation.res_map, cfg.evaluation.height_tolerance
    ev = Evaluator(cfg, trainer.test_dataset, scene, img_wh=trainer.img_wh,
                   device=dev)
    idxs = np.arange(n_origins) % ev.n_images
    rays_o, rays_d = create_scan_rays(ev._scan_origins(idxs),
                                      cfg.evaluation.res_angular)
    rays_o = np.array(rays_o, np.float64)
    setup_ms = []
    for _ in range(3):  # the first makes the card's first copies
        fresh = Scene(scene.point_cloud, scene.xyz_min, scene.xyz_max)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fresh.slice_scan_setup(res, dev)
        torch.cuda.synchronize()
        setup_ms.append(1e3 * (time.perf_counter() - tic))
    del fresh
    walks = []  # the scene's walk: the inputs it hands to E1

    def recorded(*args):
        walks.append(args)
        return slice_scan(*args)

    scene_module.slice_scan = recorded
    try:
        depths, hits, _ = scene.scan_depths(res, rays_o, rays_d, tol,
                                            device=dev)
    finally:
        scene_module.slice_scan = slice_scan
    (cells, band, _, rays_t, radii), = walks

    def e1():
        return slice_scan(cells, band, res, rays_t, radii)

    got = e1().cpu()
    plain_in = (cells.cpu(), band, res, rays_t.cpu(), radii.cpu())
    tic = time.perf_counter()
    want = slice_scan_plain(*plain_in)
    plain_ms = 1e3 * (time.perf_counter() - tic)
    tic = time.perf_counter()
    numpy_depths = scene.get_slice_scan(res, rays_o, rays_d, tol,
                                        rays_o_in_world_coord=False)[1]
    numpy_ms = 1e3 * (time.perf_counter() - tic)
    call_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        scene.scan_depths(res, rays_o, rays_d, tol, device=dev)
        call_ms.append(1e3 * (time.perf_counter() - tic))
    n, m = rays_t.shape[0], radii.shape[0]
    ms = time_turns([e1])[0]
    dev_ms = device_ms(e1, "slice_", per_call=2)  # the raster and the walk
    words = (res * res + 31) // 32
    # the band's cells, the raster zeroed then set, the rays in and the
    # hits out, the radii
    n_bytes = 4 * (band[1] - band[0]) + 2 * 4 * words + 36 * n + 8 * m
    b_ms, b_by = bound_ms(n_bytes, 0)
    hit = got.numpy() >= 0
    same = torch.equal(got, want) and np.array_equal(hits, want.numpy())
    same_depths = np.array_equal(depths, numpy_depths, equal_nan=True)
    log(f"{name} GT slice scan (E1): {n} rays x {m} samples at res {res}, "
        f"{band[1] - band[0]:,} of {cells.shape[0]:,} points in the band, "
        f"{hit.mean():.4f} of the rays hit; hits equal to the plain walk's "
        f"{same}, depths equal to get_slice_scan's {same_depths}; E1 {ms:.4f} "
        f"ms (device {dev_ms:.4f}), bound {b_ms:.4f} ms ({b_by}); plain walk "
        f"{plain_ms:.1f} ms, get_slice_scan {numpy_ms:.1f} ms, Scene.scan_depths "
        f"{[round(x, 2) for x in call_ms]} ms a call, set-up "
        f"{[round(x, 1) for x in setup_ms]} ms; on {card}")
    if not (same and same_depths):
        fail(f"{name} GT slice scan: E1's hits or depths differ from the "
             f"plain version's")
    if not 0 < band[1] - band[0] < cells.shape[0] or not hit.any():
        fail(f"{name} GT slice scan: band {band}, no hit: not a room's scan")
    return {"rays": n, "samples": m, "res": res,
            "points": int(cells.shape[0]), "band_points": band[1] - band[0],
            "hit_share": float(hit.mean()), "max_abs_err": 0.0, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": None,
            "get_slice_scan_ms": numpy_ms, "depths_call_ms": call_ms,
            "setup_ms": setup_ms, "bound_ms": b_ms, "bound_by": b_by}


# ------------------------------- the nearest-neighbour search (E2, 29)
def count_nn_metrics():
    """Count the ``nn_metrics`` calls that search on the card: the
    evaluator's ``metrics.nn_metrics`` wrapped in a counter (``.launches``,
    read and reset with the kernel counts) of its calls given a CUDA
    device.  Every path is held to one E2 launch (``nn_search``) a call."""
    from virus_nerf_tpu_torch.evaluation import metrics
    from virus_nerf_tpu_torch.ops.launch_counts import register

    nn_metrics = metrics.nn_metrics

    def counted(*args, device="cpu", **kwargs):
        if torch.device(device).type == "cuda":
            counted.launches += 1
        return nn_metrics(*args, device=device, **kwargs)

    counted.launches = 0
    metrics.nn_metrics = counted
    return register(counted)


def check_nn_searches(paths):
    """One E2 launch an ``nn_metrics`` call on the card, on every path,
    and at least one such call on each path of :data:`EVALUATING`."""
    found = {p: (c["nn_search"], c["nn_metrics"]) for p, c in paths.items()}
    off = {p: v for p, v in found.items() if v[0] != v[1]}
    idle = [p for p in EVALUATING if found[p][1] <= 0]
    log(f"E2 launches and nn_metrics calls on the card a path: "
        f"{ {p: v for p, v in found.items() if v != (0, 0)} }")
    if off or idle:
        fail(f"E2 launches != nn_metrics calls on {off}; none on {idle}")


def check_nn_search(name, trainer, state, card, n_origins: int = 16):
    """Phase 29 on a recorded room: E2 against its plain version bit for
    bit on the three searches of one depth evaluation, and the times of
    the module doc.  Returns the numbers."""
    from virus_nerf_tpu_torch.evaluation import metrics
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.ops.nn_search import nn_search, nn_search_plain

    dev = trainer.device
    ev = Evaluator(trainer.cfg, trainer.test_dataset, trainer.scene,
                   img_wh=trainer.img_wh, device=dev)
    idxs = np.arange(n_origins) % ev.n_images
    calls, nn_metrics = [], metrics.nn_metrics

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return nn_metrics(*args, **kwargs)

    with mock.patch.object(metrics, "nn_metrics", recorded):
        ev.evaluate_depth(state.model, state.grid.occ_bool, idxs,
                          sensors=("NeRF",))
    if len(calls) != 3:
        fail(f"{name} NND search: {len(calls)} nn_metrics calls, want 3")

    def as_f32(x):
        return torch.from_numpy(np.array(x, np.float32).reshape(-1, 2))

    searches, same = [], True
    for args, kwargs in calls:
        pos, pos_ref, n = args[0], args[1], args[4]
        p, r = as_f32(pos), as_f32(pos_ref)
        p_dev, r_dev = p.to(dev), r.to(dev)
        got = [t.cpu() for t in nn_search(p_dev, r_dev, n)]
        tic = time.perf_counter()
        want = nn_search_plain(p, r, n)
        plain_ms = 1e3 * (time.perf_counter() - tic)
        ok = (torch.equal(got[0], want[0])
              and torch.equal(got[1].view(torch.int32),
                              want[1].view(torch.int32)))
        same &= ok
        call_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            nn_metrics(*args, **dict(kwargs, device=dev))
            call_ms.append(1e3 * (time.perf_counter() - tic))

        def e2(p_dev=p_dev, r_dev=r_dev, n=n):
            return nn_search(p_dev, r_dev, n)

        k, m = p.shape[0] // n, r.shape[0] // n
        searches.append({
            "images": n, "queries": k, "references": m, "same": ok,
            "found_share": float((want[0] >= 0).float().mean()),
            "ms": time_turns([e2])[0], "device_ms": device_ms(e2, "nn_search"),
            "plain_ms": plain_ms, "nn_metrics_call_ms": call_ms})
    # a LiDAR scan's width: 8,192 reference points an image
    gen = torch.Generator().manual_seed(29)
    p_l = torch.rand(16 * 512, 2, generator=gen) * 10
    r_l = torch.rand(16 * 8192, 2, generator=gen) * 10
    pl_dev, rl_dev = p_l.to(dev), r_l.to(dev)
    got_l = [t.cpu() for t in nn_search(pl_dev, rl_dev, 16)]
    tic = time.perf_counter()
    want_l = nn_search_plain(p_l, r_l, 16)
    lidar_plain_ms = 1e3 * (time.perf_counter() - tic)
    same_l = (torch.equal(got_l[0], want_l[0])
              and torch.equal(got_l[1].view(torch.int32),
                              want_l[1].view(torch.int32)))

    def e2_lidar():
        return nn_search(pl_dev, rl_dev, 16)

    lidar_ms = time_turns([e2_lidar])[0]
    lidar_dev_ms = device_ms(e2_lidar, "nn_search")
    s0 = searches[0]
    n, k, m = s0["images"], s0["queries"], s0["references"]
    # the points in (8 B each) and the index and distance out; five float
    # operations a pair
    b_ms, b_by = bound_ms(8 * n * (k + m) + 8 * n * k, 5 * n * k * m)
    log(f"{name} NND search (E2): {[(s['images'], s['queries'], s['references']) for s in searches]} "
        f"(images, queries, references) a call; found "
        f"{[round(s['found_share'], 4) for s in searches]}; equal to the "
        f"plain search {[s['same'] for s in searches]}; E2 "
        f"{[round(s['ms'], 4) for s in searches]} ms (device "
        f"{[round(s['device_ms'], 4) for s in searches]}), bound {b_ms:.5f} ms "
        f"({b_by}); plain {[round(s['plain_ms'], 1) for s in searches]} ms; "
        f"nn_metrics on the card {[round(x, 2) for x in searches[0]['nn_metrics_call_ms']]} "
        f"ms a call; LiDAR width (16 x 512 over 8,192) equal {same_l}, E2 "
        f"{lidar_ms:.4f} ms (device {lidar_dev_ms:.4f}), plain "
        f"{lidar_plain_ms:.1f} ms; on {card}")
    if not (same and same_l):
        fail(f"{name} NND search: E2's indices or distances differ from the "
             f"plain search's")
    if not all(0 < s["found_share"] for s in searches):
        fail(f"{name} NND search: a search found no neighbour: not a room's scans")
    return {"searches": searches, "ms": s0["ms"], "device_ms": s0["device_ms"],
            "plain_ms": s0["plain_ms"], "library_ms": None, "max_abs_err": 0.0,
            "bound_ms": b_ms, "bound_by": b_by,
            "lidar": {"images": 16, "queries": 512, "references": 8192,
                      "same": same_l, "ms": lidar_ms, "device_ms": lidar_dev_ms,
                      "plain_ms": lidar_plain_ms}}


# -------------------------------------- the hash corners forward (H1, 30)
# the paths whose model encodes by the additive hash's corners forward on
# the card: each such encode launches H1
CORNERS = ("bench", "scale1", "ngp", "ethz", "rh2", "pso", "dp",
           "population", "eval_budget", "graph bench")


def count_corner_encodes():
    """Count the ``corners`` encodes on the card that H1 takes: the
    model's ``hash_encode`` wrapped in a counter (``.launches``, read and
    reset with the kernel counts) of its calls with ``forward="corners"``
    on a card table.  Every path is held to one H1 launch
    (``hash_corners``) such an encode."""
    from virus_nerf_tpu_torch.models import ngp
    from virus_nerf_tpu_torch.ops.launch_counts import register

    encode = ngp.hash_encode

    def counted(table, xyz, spec, consts=None, forward="corners",
                backward="product"):
        if forward == "corners" and table.is_cuda:
            counted.launches += 1
        return encode(table, xyz, spec, consts, forward=forward,
                      backward=backward)

    counted.launches = 0
    ngp.hash_encode = counted
    return register(counted)


def check_corner_encodes(paths):
    """One H1 launch a ``corners`` encode on the card, on every path, and
    at least one such encode on each path of :data:`CORNERS`."""
    found = {p: (c["hash_corners"], c["corner_encodes"])
             for p, c in paths.items()}
    off = {p: v for p, v in found.items() if v[0] != v[1]}
    idle = [p for p in CORNERS if found[p][1] <= 0]
    log(f"H1 launches and corners encodes on the card a path: "
        f"{ {p: v for p, v in found.items() if v != (0, 0)} }")
    if off or idle:
        fail(f"H1 launches != corners encodes on {off}; none on {idle}")


def check_hash_corners(dev, card):
    """Phase 30: H1 against the plain ``corners`` forward bit for bit at
    the cells' sample counts, and the times of the module doc.  Returns
    the numbers."""
    from virus_nerf_tpu_torch.ops.hash_corners import hash_corners
    from virus_nerf_tpu_torch.ops.hash_encoder import (
        HashGridSpec,
        _SpecTensors,
        h1_level_words,
        hash_corners_plain,
    )

    spec = HashGridSpec.create(16, 2, 16.0, 1024.0, 2**19)
    consts, words = _SpecTensors(spec, dev), h1_level_words(spec)
    gen = torch.Generator(device=dev).manual_seed(30)
    table = torch.rand((spec.total_rows, 2), generator=gen, device=dev)
    L, F = spec.levels, spec.feat_dim
    shapes, same = {}, True
    for name, n in (("ETHZ", 131072), ("RH2", 1048576),
                    ("evaluation chunk", 4194304)):
        xyz = torch.rand((n, 3), generator=gen, device=dev) * 1.06 - 0.03
        got = hash_corners(table, xyz, *words)
        want = hash_corners_plain(table, xyz, spec, consts)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        same &= ok
        del got, want

        def h1(xyz=xyz):
            return hash_corners(table, xyz, *words)

        def h1_free(xyz=xyz):
            return hash_corners(table, xyz, *words, keep=False)

        def plain(xyz=xyz):
            return hash_corners_plain(table, xyz, spec, consts)

        ms, free_ms, plain_ms = time_turns([h1, h1_free, plain], iters=5)
        plain_dev_ms, plain_launches = device_total_ms(plain)
        # positions and the table read once; the embedding, and with the
        # gradient's outputs the base rows and weights, written once
        read = 12 * n + 4 * spec.total_rows * F
        b_ms, b_by = bound_ms(read + 4 * n * L * F + 8 * L * n + 32 * L * n, 0)
        shapes[name] = {
            "samples": n, "same": ok, "ms": ms,
            "device_ms": device_ms(h1, "hash_corners_kernel", iters=5),
            "no_grad_ms": free_ms,
            "no_grad_device_ms": device_ms(h1_free, "hash_corners_kernel",
                                           iters=5),
            "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms,
            "plain_launches": plain_launches, "bound_ms": b_ms,
            "bound_by": b_by,
            "no_grad_bound_ms": bound_ms(read + 4 * n * L * F, 0)[0]}
        del xyz
        torch.cuda.empty_cache()
    # a sample count at which cuBLAS's batched GEMV takes its one-kernel
    # path, whose combine order H1 does not follow: base rows and weights
    # still bit for bit, the embedding's largest gap in ulps
    xyz = torch.rand((100000, 3), generator=gen, device=dev) * 1.06 - 0.03
    got = hash_corners(table, xyz, *words)
    want = hash_corners_plain(table, xyz, spec, consts)
    ragged_same = all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    ragged_ulps = int((got[0].view(torch.int32).long()
                       - want[0].view(torch.int32).long()).abs().max())
    ragged_share = float((got[0] == want[0]).float().mean())
    same &= ragged_same
    del xyz, got, want
    log(f"hash corners forward (H1) at 100,000 samples: base and weights "
        f"equal {ragged_same}; embedding equal in {ragged_share:.6f} of its "
        f"values, largest gap {ragged_ulps} ulps")
    log(f"hash corners forward (H1) at 16 x 2, 2^19 rows: " + "; ".join(
        f"{k} {v['samples']}: equal {v['same']}, H1 {v['ms']:.4f} ms (device "
        f"{v['device_ms']:.4f}), without base and w {v['no_grad_ms']:.4f} "
        f"(device {v['no_grad_device_ms']:.4f}), bound {v['bound_ms']:.4f} / "
        f"{v['no_grad_bound_ms']:.4f}; plain {v['plain_ms']:.3f} ms (device "
        f"{v['plain_device_ms']:.3f}, {v['plain_launches']:.0f} launches)"
        for k, v in shapes.items()) + f"; on {card}")
    if not same:
        fail("hash corners forward: H1's embedding, base rows or weights "
             "differ from the plain code's")
    s0 = shapes["ETHZ"]
    return {"shapes": shapes, "ragged_100000": {
                "same_base_w": ragged_same, "out_equal_share": ragged_share,
                "out_max_ulps": ragged_ulps},
            "ms": s0["ms"], "device_ms": s0["device_ms"],
            "plain_ms": s0["plain_ms"], "library_ms": None,
            "max_abs_err": 0.0, "bound_ms": s0["bound_ms"],
            "bound_by": s0["bound_by"]}


def launches_per_step(trainer, state, n_steps: int = 8):
    """CUDA kernel launches a step (grid updates included), from the host
    side of ``torch.profiler`` over ``n_steps`` steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_steps(state, n_steps)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "LaunchKernel" in e.key) / n_steps


def march_case(name, cfg, dataset, grid, dev, n=None, S=None,
               zero_noise=False, full=False):
    """The inputs of one march at a path's shapes: ``n`` rays of the
    path's images (its batch size; the bench's pixel shares, as "closest"
    pixels need the trainer's statistics), their cube hits, noise (zeros,
    as the evaluator renders) and the path's trained grid (or a full one:
    every cell occupied).  Returns (name, args, keyword arguments) of
    ``march_select``."""
    from virus_nerf_tpu_torch.data.dataset import sample_batch
    from virus_nerf_tpu_torch.ops.intersection import ray_aabb_intersect

    t = cfg.training
    n = n or t.batch_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    b = sample_batch(dataset, gen, n, bench_config().training.sampling_strategy)
    t1, t2 = ray_aabb_intersect(b.rays_o, b.rays_d, cfg.model.scale).t().contiguous()
    noise = (torch.zeros(n, device=dev) if zero_noise
             else torch.rand(n, generator=gen, device=dev))
    grid = torch.ones_like(grid) if full else grid.clone()
    kw = dict(cascades=cfg.cascades, grid_size=cfg.model.grid_size,
              scale=cfg.model.scale, exp_step_factor=cfg.exp_step_factor,
              max_samples=S or t.max_samples_per_ray,
              n_candidates=t.march_candidates,
              march_resolution=t.march_resolution)
    return name, (b.rays_o.contiguous(), b.rays_d.contiguous(), t1, t2, noise,
                  grid), kw


def device_total_ms(fn, iters: int = 5):
    """Device ms per call of every kernel ``fn`` launches, and the launches
    a call, from ``torch.profiler`` over ``iters`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in ev) / 1e3 / iters,
            sum(e.count for e in ev) / iters)


def probed_candidates(args, kw):
    """The in-range candidates of a march: those the kernel probes."""
    from virus_nerf_tpu_torch.ops.ray_march import (
        _constant_dt,
        march_lattice_plain,
    )

    _, _, t1, t2, noise, _ = args
    K = kw["n_candidates"]
    if kw["exp_step_factor"] == 0.0:
        k = torch.arange(K, dtype=torch.float32, device=t1.device)
        dt0 = _constant_dt(kw["grid_size"], kw["scale"], kw["march_resolution"])
        ts = torch.addcmul(t1[:, None], noise[:, None] + k[None, :],
                           torch.tensor(dt0, device=t1.device))
    else:
        ts, _ = march_lattice_plain(t1, noise, kw["exp_step_factor"],
                                    kw["grid_size"], kw["scale"], K,
                                    kw["march_resolution"])
    return int(((ts >= 0.0) & (ts < t2[:, None]) & (t1[:, None] >= 0.0)).sum())


def check_march(name, args, kw):
    """``march_select`` against ``march_select_plain`` bit for bit on the
    card, both timed in turns (CUDA events; the kernel's profiler device
    time, and the plain chain's: every kernel it launches), beside the
    bound.  No one PyTorch call computes the march (library_ms None)."""
    from virus_nerf_tpu_torch.ops.ray_march import march_select, march_select_plain

    got = march_select(*args, **kw)
    want = march_select_plain(*args, **kw)
    torch.cuda.synchronize()
    ok = all(torch.equal(a.view(torch.uint8) if a.dtype == torch.bool
                         else a.view(torch.int32),
                         b.view(torch.uint8) if b.dtype == torch.bool
                         else b.view(torch.int32)) for a, b in zip(got, want))
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    ms, plain_ms = time_turns([lambda: march_select(*args, **kw),
                               lambda: march_select_plain(*args, **kw)], iters=5)
    dev_ms = device_ms(lambda: march_select(*args, **kw), "march_select_kernel")
    plain_dev_ms, plain_launches = device_total_ms(
        lambda: march_select_plain(*args, **kw))
    o, _, _, _, _, grid = args
    n, S = o.shape[0], kw["max_samples"]
    probed = probed_candidates(args, kw)
    # inputs read once (rays 24 B, t1, t2, noise 12 B a ray), the grid read
    # once, ts, deltas, valid and n_kept written once; about 64 operations
    # a probed candidate: the positions, the two mips, the three cells and
    # the index (~60), and the lattice step (4)
    b_ms, b_by = bound_ms(36.0 * n + grid.numel() + 9.0 * n * S + 4.0 * n,
                          64.0 * probed)
    kept = int(got[3].sum())
    over = int((got[3] == S).sum())
    log(f"march_select [{name}]: n={n} S={S} K={kw['n_candidates']} "
        f"esf={kw['exp_step_factor']:g} grid {tuple(grid.shape)} occupied "
        f"{float(grid.float().mean()):.4f}; {probed} candidates in range, "
        f"{kept} kept, {over} rays at S; bit-exact {ok} (max_abs_err "
        f"{err:.3e}); kernel {ms:.4f} ms (device {dev_ms:.4f}) plain "
        f"{plain_ms:.4f} ms (device {plain_dev_ms:.4f}, {plain_launches:.0f} "
        f"launches) bound {b_ms:.4f} ms ({b_by}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"march_select [{name}] disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms,
            "plain_launches": plain_launches, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "n": n, "S": S,
            "K": kw["n_candidates"], "probed": probed, "kept": kept,
            "rays_at_S": over}


def evaluate_scale1(trainer, state, test_ds, scene, img_wh, card):
    """``Evaluator.evaluate`` of the trained scale-1.0 map on the held-out
    images: finite NND of every scan and a finite PSNR."""
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator

    ev = Evaluator(trainer.cfg, test_ds, scene, img_wh=img_wh,
                   device=trainer.device)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    m = ev.evaluate(state.model, state.grid.occ_bool,
                    depth_img_idxs=np.arange(test_ds.n_images),
                    sensors=("GT", "NeRF", "ToF", "USS"))
    torch.cuda.synchronize()
    log(f"scale-1.0 evaluation on {test_ds.n_images} held-out images: "
        f"{time.perf_counter() - tic:.2f} s; NeRF nn_mean z3 "
        f"{m['NeRF']['nn_mean']['zone3']:.4f} m, ToF "
        f"{m['ToF']['nn_mean']['zone3']:.4f} m, USS "
        f"{m['USS']['nn_mean']['zone3']:.4f} m; psnr {m['NeRF']['psnr']:.3f} "
        f"ssim {m['NeRF']['ssim']:.4f}; on {card}")
    nnd = [m[s]["nn_mean"][z] for s in ("NeRF", "ToF", "USS")
           for z in ("zone1", "zone2", "zone3")]
    if not (np.all(np.isfinite(nnd)) and np.isfinite(m["NeRF"]["psnr"])):
        fail(f"scale-1.0 evaluation: non-finite metrics {m}")


def instrumented_run(main_fn, argv, loader, wrappers):
    """``main_fn(argv)`` (``run.main``) with the kernel counts set to 0 just
    before and read just after, instrumented: each training chunk's
    seconds and launches (``training_counted``), the seconds of every
    intermediate and final
    evaluation and of the final one's parts (colour renders; depth scans
    of every sensor, where an intermediate one scores the NeRF alone),
    each load by ``loader = (module, function name)`` and the training
    positions of the last step.  Returns a dict of these, the metrics, the
    trainer and its state, the launches of the whole run and of its
    training steps alone (the evaluations march too), the wall seconds and
    the peak device GiB."""
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.models.ngp import NGPModel
    from virus_nerf_tpu_torch.training.trainer import Trainer

    out = {"evals": [], "loads": [], "parts": {}, "training": {}}
    inter_eval = Trainer._intermediate_eval
    train, evaluate = Trainer.train, Evaluator.evaluate
    ev_color, ev_depth = Evaluator.evaluate_color, Evaluator.evaluate_depth
    load = getattr(*loader)

    def timed(fn, record):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record(args, kwargs, time.perf_counter() - t0)
            return result
        return wrapper

    def final_depth(args, kwargs, seconds):
        sensors = kwargs.get("sensors", args[4] if len(args) > 4 else None)
        if tuple(sensors or ()) != ("NeRF",):
            out["parts"]["depth"] = seconds

    def keep_state(self, state=None):
        out["trainer"], out["state"] = self, train(self, state)
        return out["state"]

    def keep_train_positions(mod, inputs):
        if isinstance(mod, NGPModel) and torch.is_grad_enabled():
            out["xyz"] = inputs[0].detach()

    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        keep_train_positions)
    replacements = [
        (Trainer, "train", keep_state),
        (Trainer, "_intermediate_eval", timed(
            inter_eval, lambda a, k, s: out["evals"].append((a[1].step, s)))),
        (Evaluator, "evaluate", timed(
            evaluate, lambda a, k, s: out["evals"].append(("final", s)))),
        (Evaluator, "evaluate_color", timed(
            ev_color, lambda a, k, s: out["parts"].update(color=s))),
        (Evaluator, "evaluate_depth", timed(ev_depth, final_depth)),
        (loader[0], loader[1], timed(load, lambda a, k, s: out["loads"].append(
            (k.get("split", a[1:2]), s)))),
    ]
    with contextlib.ExitStack() as patches:
        for owner, name, replacement in replacements:
            patches.enter_context(mock.patch.object(owner, name, replacement))
        patches.enter_context(training_counted(wrappers, out["training"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        tic = time.perf_counter()
        out["metrics"] = main_fn(argv)
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - tic
        out["launches"] = read_counts(wrappers)
    hook.remove()
    out["step_launches"] = out["training"]["launches"]
    out["peak"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def report_run(name, r, card):
    """Check and print an instrumented 48-step ``run.main`` (training,
    evaluations, loads, memory); returns the trainer and its state."""
    trainer, state, metrics = r["trainer"], r["state"], r["metrics"]
    cfg = trainer.cfg
    check_training(name, trainer, state, 48, 16)
    evals, parts = r["evals"], r["parts"]
    step_s = chunk_step_s(r["training"], 16)
    inter = [s for step, s in evals if step != "final"]
    final = [s for step, s in evals if step == "final"]
    log(f"{name}: {r['wall']:.2f} s in all; loads "
        f"{[(sp, round(s, 2)) for sp, s in r['loads']]} "
        f"s; steady state steps 24-48: {1e3 * step_s:.2f} ms/step, "
        f"{cfg.training.batch_size / step_s:.0f} rays/s (host clock around "
        f"the second chunk, after a sync); intermediate "
        f"evaluations {[round(s, 2) for s in inter]} s, final evaluation "
        f"{final[0]:.2f} s (colour renders of {cfg.evaluation.num_color_pts} "
        f"images {parts['color']:.2f} s, depth scans and NND of "
        f"{cfg.evaluation.num_depth_pts} of {trainer.test_dataset.n_images} "
        f"images {parts['depth']:.2f} s); "
        f"peak device memory {r['peak']:.2f} GiB; on {card}")
    log(f"{name}: kernel launches {r['launches']}; table "
        f"{tuple(state.model.pos_table.shape)}; NeRF nn_mean z3 "
        f"{metrics['NeRF']['nn_mean']['zone3']:.4f} m, ToF "
        f"{metrics['ToF']['nn_mean']['zone3']:.4f} m, USS "
        f"{metrics['USS']['nn_mean']['zone3']:.4f} m; psnr "
        f"{metrics['NeRF']['psnr']:.3f} ssim {metrics['NeRF']['ssim']:.4f}")
    check_launched(name, r["launches"], ("segment_sum", "fused_adam"))
    check_adam_per_step(name, r["launches"], 48)
    return trainer, state


def check_run_files(name, save, metrics, n_color):
    """The files of a 48-step ``run.main`` (two chunks of 24)."""
    with open(os.path.join(save, "logs.csv")) as f:
        logs = [line.rstrip("\n").split(",") for line in f]
    with open(os.path.join(save, "metrics.csv")) as f:
        rows = [line.split(",")[0] for line in f][1:]
    renders = sorted(os.listdir(os.path.join(save, "renders")))
    missing = [n for n in ("model.npz", "model.npz.json", "hparams.json")
               if not os.path.exists(os.path.join(save, n))]
    mnn_rows = [r[1] for r in logs[1:] if r[-1] != "nan"]
    log(f"{name}: files {sorted(os.listdir(save))}; logs.csv {logs[0]} "
        f"{len(logs) - 1} rows, mnn at steps {mnn_rows}; metrics.csv rows "
        f"{rows}; {len(renders)} renders")
    if (missing or len(logs) != 49 or mnn_rows != ["23", "47"]
            or rows != ["USS", "ToF", "NeRF"] or len(renders) != 3 * n_color
            or not np.isfinite(metrics["NeRF"]["nn_mean"]["zone3"])):
        fail(f"{name}: files missing {missing} or wrong logs/metrics/renders")


def ethz_run(dev, wrappers, card, tmp):
    """The ETHZ run (phase 15): fixture, decode and read, ``run.main`` with
    the kernel counts set to 0 just before and read just after, the checks
    of the module doc.  Returns (launches, B1 at the run's last step, the
    trainer, its state, the run's directory)."""
    from virus_nerf_tpu_torch import run
    from virus_nerf_tpu_torch.data import ethz
    from virus_nerf_tpu_torch.data.ethz_fixture import generate_ethz_fixture
    from virus_nerf_tpu_torch.data.pcl import load_pcd
    from virus_nerf_tpu_torch.data.png import read_pngs
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.training.trainer import Trainer

    tic = time.perf_counter()
    root = generate_ethz_fixture(os.path.join(tmp, "ethz"))
    fixture_s = time.perf_counter() - tic
    room = os.path.join(root, "commonroom")
    paths = [os.path.join(room, "measurements", f"{cam}_color_image_raw",
                          f"img{i}.png") for cam in ("CAM1", "CAM3")
             for i in range(300)]
    tic = time.perf_counter()
    imgs = read_pngs(paths)
    png_s = time.perf_counter() - tic
    tic = time.perf_counter()
    cloud = load_pcd(os.path.join(room, "maps", "map_balm.pcd"))
    pcd_s = time.perf_counter() - tic
    log(f"ETHZ fixture: 2 x 300 images at 320x240 and {cloud.shape[0]:,} map "
        f"points written in {fixture_s:.2f} s; PNG decode of the 600 images "
        f"{png_s:.2f} s ({1e3 * png_s / len(imgs):.2f} ms an image, numpy + "
        f"zlib); PCD read of the map {pcd_s:.3f} s")
    if len(imgs) != 600 or imgs[0].shape != (240, 320, 3) or cloud.shape != (
            800_000, 3):
        fail(f"ETHZ fixture: {len(imgs)} images of {imgs[0].shape}, map "
             f"{cloud.shape}")

    save = os.path.join(tmp, "run")
    argv = ["--save-dir", save, "--override", f"save_dir={save}",
            "--override", "dataset.name=ETHZ",
            "--override", f"ethz.dataset_dir={root}",
            "--override", "training.max_steps=48",
            "--override", "training.max_time=1e9"]
    log("ETHZ run: python -m virus_nerf_tpu_torch.run " + " ".join(argv)
        + "; cuts: training.max_steps 500 -> 48 (two chunks of 24: the "
        "chunk is eval_every_n_steps 25 rounded down to whole grid-update "
        "intervals of 8, as in the JAX loop), training.max_time 45 -> 1e9 "
        "(the step count, not the clock, ends training)")
    r = instrumented_run(run.main, argv, (ethz, "load_ethz_dataset"), wrappers)
    trainer, state = report_run("ETHZ run", r, card)
    cfg, launches, metrics = trainer.cfg, r["launches"], r["metrics"]
    idle = [k for k in ("segment_sum_rows", "segment_sum_factors",
                        "widen_slabs") if launches[k]]
    check_marches("ETHZ run", launches)
    if idle or state.model.pos_table.shape != (5_710_032, 2):
        fail(f"ETHZ run: the default path launched {idle} or has table "
             f"{tuple(state.model.pos_table.shape)}")
    if trainer.train_dataset.directions.shape[0] != 2 or set(
            trainer.train_dataset.sensor_ids.tolist()) != {1, 3}:
        fail("ETHZ run: not two cameras and stacks 1, 3")
    check_run_files("ETHZ run", save, metrics, 8)

    # the checkpoint in a fresh trainer: the same state, the same render
    fresh = Trainer(cfg, trainer.train_dataset, scene=trainer.scene, device=dev)
    loaded = fresh.load_checkpoint(os.path.join(save, "model.npz"))
    a, b = trainer.state_arrays(state), fresh.state_arrays(loaded)
    same_state = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    ev = Evaluator(cfg, trainer.test_dataset, trainer.scene,
                   img_wh=trainer.img_wh, device=dev)
    pose = ev.ds["poses"][0]
    rays_d = ev.ds["directions"][int(ev.ds["cam_idx"][0])] @ pose[:3, :3].T
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
    r1 = ev.render_batched(state.model, state.grid.occ_bool, rays_o, rays_d)
    r2 = ev.render_batched(loaded.model, loaded.grid.occ_bool, rays_o, rays_d)
    same_render = all(np.array_equal(r1[k], r2[k]) for k in r1)
    log(f"ETHZ run: checkpoint reloaded into a fresh trainer: {len(a)} arrays "
        f"equal {same_state}; test image 0 ({rays_d.shape[0]} rays) rendered "
        f"bit-identical {same_render}")
    if not (same_state and same_render):
        fail("ETHZ run: the reloaded checkpoint differs from the trained state")

    # B1 at the keys of the run's last step: a real room's keys
    return (launches, b1_at_last_step("ETHZ run", state, r["xyz"], dev),
            trainer, state, save)


def rh2_run(dev, wrappers, card, tmp):
    """The RH2 run (phase 16): fixture, ``run.main`` at scale 1.0 with the
    kernel counts set to 0 just before and read just after, the checks of
    the module doc.  Returns (fixture directory, launches of the run and of
    its training steps, B1 at the run's last step)."""
    from virus_nerf_tpu_torch import run
    from virus_nerf_tpu_torch.data import rh
    from virus_nerf_tpu_torch.data.rh_fixture import make_fixture

    root = os.path.join(tmp, "rh2")
    tic = time.perf_counter()
    info = make_fixture(root)
    fixture_s = time.perf_counter() - tic
    points = np.load(os.path.join(root, "scene_points.npy"))
    log(f"RH2 fixture: {info['n_obs']} observations (75 trajectory points x 4 "
        f"cameras) at {info['img_wh'][0]}x{info['img_wh'][1]} and "
        f"{points.shape[0]:,} scene points written in {fixture_s:.2f} s")
    if info["n_obs"] != 300 or tuple(info["img_wh"]) != (244, 320) or (
            points.shape != (400_000, 3)):
        fail(f"RH2 fixture: {info}, points {points.shape}")

    save = os.path.join(tmp, "rh2_run")
    argv = ["--save-dir", save, "--override", "dataset.name=RH2",
            "--override", f"rh2.dataset_dir={root}",
            "--override", "model.scale=1.0",
            "--override", "training.max_steps=48",
            "--override", "training.max_time=1e9"]
    log("RH2 run: python -m virus_nerf_tpu_torch.run " + " ".join(argv)
        + "; cuts: training.max_steps 500 -> 48 (two chunks of 24), "
        "training.max_time 45 -> 1e9")
    r = instrumented_run(run.main, argv, (rh, "load_rh_dataset"), wrappers)
    trainer, state = report_run("RH2 run", r, card)
    cfg, launches = trainer.cfg, r["launches"]
    per_step = {k: v / 48 for k, v in r["step_launches"].items()}
    log(f"RH2 run: kernel launches in the training steps "
        f"{r['step_launches']}, a step {per_step}")
    if (cfg.cascades != 2 or cfg.exp_step_factor != 1 / 256
            or trainer.sample_budget is not None):
        fail(f"RH2 run: cascades {cfg.cascades}, esf {cfg.exp_step_factor}, "
             f"budget {trainer.sample_budget}: not the scale-1.0 dense path")
    if (per_step["segment_sum"] != 2 or per_step["march_select"] != 1
            or state.model.pos_table.shape != (5_710_032, 2)):
        fail(f"RH2 run: training launches a step {per_step}, want B1 2, "
             f"B2 1, the march 1; table {tuple(state.model.pos_table.shape)}")
    check_marches("RH2 run", launches)
    idle = [k for k in ("segment_sum_rows", "segment_sum_factors",
                        "widen_slabs") if launches[k]]
    if idle:
        fail(f"RH2 run: the default routes launched {idle}")
    ds = trainer.train_dataset
    if (ds.n_images != 244 or trainer.test_dataset.n_images != 28
            or set(ds.sensor_ids.tolist()) != {0, 1, 2, 3}
            or list(ds.depths) != ["RGBD", "USS", "ToF"]):
        fail(f"RH2 run: {ds.n_images} train and "
             f"{trainer.test_dataset.n_images} test images, sensors "
             f"{set(ds.sensor_ids.tolist())}, depths {list(ds.depths)}")
    check_run_files("RH2 run", save, r["metrics"], 8)
    return (root, launches, r["step_launches"],
            b1_at_last_step("RH2 run", state, r["xyz"], dev), trainer, state)


def pso_run(root, wrappers, card, tmp):
    """The PSO run (phase 17): ``run_optimization.main`` over the RH2
    fixture, then a resuming call and a worker call, with the kernel counts
    set to 0 just before the first and read just after the last.  Returns
    (launches of the calls and of their training steps, training steps)."""
    from virus_nerf_tpu_torch import run_optimization

    cuts = ["training.max_steps=24", "training.max_time=1e9",
            "evaluation.num_color_pts=1", "evaluation.num_depth_pts=4",
            "evaluation.num_depth_pts_per_step=4"]
    base = ["--override", "dataset.name=RH2", "--override",
            f"rh2.dataset_dir={root}", "--override", "model.scale=1.0"]
    for c in cuts:
        base += ["--override", c]
    save = os.path.join(tmp, "pso")
    log(f"PSO run: python -m virus_nerf_tpu_torch.run_optimization --save-dir "
        f"{save} --max-iters 3, then --max-iters 1 on the same directory, "
        f"then --worker-id w0 --max-iters 1 on another, over the RH2 fixture "
        f"at the RH2 run's width; cuts: training.max_steps 500 -> 24, "
        f"max_time 45 -> 1e9, evaluation.num_color_pts 8 -> 1, num_depth_pts "
        f"all -> 4, num_depth_pts_per_step 16 -> 4")
    real = run_optimization.train_and_evaluate
    particles, leases = [], []
    training = {}

    def timed_particle(cfg, datasets=None, **kw):
        lease_path = os.path.join(save + "_workers", "pso_state.json")
        if os.path.exists(lease_path):
            with open(lease_path) as f:
                leases.append(json.load(f)["leases"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = real(cfg, datasets=datasets, **kw)
        torch.cuda.synchronize()
        particles.append(time.perf_counter() - t0)
        return metrics

    with mock.patch.object(run_optimization, "train_and_evaluate",
                           timed_particle), \
            training_counted(wrappers, training):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        tic = time.perf_counter()
        run_optimization.main(["--save-dir", save, "--max-iters", "3", *base])
        with open(os.path.join(save, "pso_state.json")) as f:
            t_after_first = json.load(f)["state"]["t"]
        run_optimization.main(["--save-dir", save, "--max-iters", "1", *base])
        pool = run_optimization.main(["--save-dir", save + "_workers",
                                      "--worker-id", "w0", "--max-iters", "1",
                                      "--lease-ttl", "600", *base])
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        launches = read_counts(wrappers)
    in_training = training["launches"]
    with open(os.path.join(save, "pso_history.csv")) as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    with open(os.path.join(save + "_workers", "pso_history.csv")) as f:
        worker_rows = [line.rstrip("\n").split(",") for line in f]
    with pool._locked() as payload:
        worker_state = payload
    steps = 24 * len(particles)
    per_step = {k: v / steps for k, v in in_training.items() if v}
    scores = [float(r[3]) for r in rows[1:] + worker_rows[1:]]
    log(f"PSO run: {wall:.2f} s in all; particles {[round(s, 2) for s in particles]} "
        f"s each (training and evaluation); history iterations "
        f"{[r[0] for r in rows[1:]]}, scores {scores} (NeRF nn_mean z3, m); "
        f"the first call ended at t = {t_after_first}; worker lease during its "
        f"evaluation {leases}, after it {worker_state['leases']} (t = "
        f"{worker_state['state']['t']}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
    log(f"PSO run: kernel launches {launches}; in the training steps "
        f"{in_training} over {steps} steps, a step {per_step}")
    if (t_after_first != 3 or [r[0] for r in rows[1:]] != ["1", "2", "3", "4"]
            or len(particles) != 5 or not np.all(np.isfinite(scores))):
        fail("PSO run: did not resume at t = 3 with 4 finite history rows")
    if (len(leases) != 1 or [(d["worker"], d["particle"]) for d in leases[0]]
            != [("w0", 0)] or worker_state["leases"] != []
            or worker_state["state"]["t"] != 1 or len(worker_rows) != 2):
        fail(f"PSO run: worker lease {leases}, state {worker_state}")
    if (per_step.get("segment_sum") != 2 or per_step.get("march_select") != 1):
        fail(f"PSO run: training launches a step {per_step}, want B1 2, the "
             f"march 1")
    check_marches("PSO run", launches)
    check_adam_per_step("PSO run", in_training, steps)
    return launches, in_training, steps


# ------------------------------------------------- the triplane path (18)
def planes_backward(model, xyz, dev):
    """The tri-plane encode's backward (PyTorch's accumulating index_put_
    of the gather's gradient, no kernel of the port) at the positions of a
    training step: forward alone and forward + backward by CUDA events in
    turns, the backward their difference.  Its byte bound: the incoming
    gradient, the corners' cells (int64) and weights read once, the planes'
    gradient written once."""
    from virus_nerf_tpu_torch.ops.triplane import triplane_encode

    spec = model.triplane_spec
    x_unit = (xyz.reshape(-1, 3) + model.scale) / (2.0 * model.scale)
    planes = model.pos_table.detach().clone().requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    g = torch.randn((x_unit.shape[0], spec.out_dim), generator=gen, device=dev)

    def fwd():
        with torch.no_grad():
            triplane_encode(planes, x_unit, spec)

    def fwd_bwd():
        out = triplane_encode(planes, x_unit, spec)
        torch.autograd.grad(out, planes, g)

    fwd_ms, both_ms = time_turns([fwd, fwd_bwd])
    n, corners = x_unit.shape[0], x_unit.shape[0] * spec.levels * 3 * 4
    b_ms, b_by = bound_ms(4.0 * g.numel() + 12.0 * corners + 4.0 * planes.numel(),
                          2.0 * corners * spec.feat_dim)
    bwd_ms = both_ms - fwd_ms
    log(f"triplane planes backward: {n} samples, {planes.numel()} plane "
        f"entries; forward {fwd_ms:.4f} ms, forward+backward {both_ms:.4f} ms, "
        f"backward {bwd_ms:.4f} ms, byte bound {b_ms:.4f} ms ({b_by})")
    return {"samples": n, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def triplane_run(dev, wrappers, card):
    """Phase 18: the bench configuration with the tri-plane encoder (8 x 4
    planes at max_res 1024, 3 * 1024^2 * 4 parameters), 48 steps: finite,
    falling loss, B2 once a step (the planes and the MLP in one launch), no
    segment sum; ms/step, peak memory, B2 on the trained model's leaves
    and the planes' backward.  Returns (launches, B2 result, backward
    result)."""
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.training.trainer import Trainer

    cfg = bench_config()
    cfg.model.encoder_type = "triplane"
    dataset, scene, _ = make_synthetic_dataset(n_images=16, img_wh=(160, 120),
                                               device=dev)
    trainer = Trainer(cfg, dataset, scene=scene, device=dev)
    state = trainer.init_state()
    seen = {}
    hook = state.model.register_forward_pre_hook(
        lambda mod, args: seen.update(xyz=args[0].detach()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    tic = time.perf_counter()
    state = trainer.train(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = read_counts(wrappers)
    hook.remove()
    step_s = check_training("triplane path", trainer, state, 48, 16)
    log(f"triplane path: {state.step} steps in {wall:.2f} s (incl. first-step "
        f"warm-up); steady state steps 16-48: {1e3 * step_s:.2f} ms/step, "
        f"{cfg.training.batch_size / step_s:.0f} rays/s on {card}")
    log(f"triplane path: kernel launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if tuple(state.model.pos_table.shape) != (3 * 1024**2 * 4,):
        fail(f"triplane path: planes {tuple(state.model.pos_table.shape)}")
    check_adam_per_step("triplane path", launches, 48)
    others = {k: v for k, v in launches.items()
              if k not in ("fused_adam", "march_select", "marches") and v}
    if others:
        fail(f"triplane path: launched {others}, want B2 and the march alone")
    check_marches("triplane path", launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    dev_ms, top = step_device_ms(lambda: trainer.run_steps(state, 8), 8)
    log(f"triplane path: device time {dev_ms:.3f} ms/step over steps 48-56 "
        f"(one grid update); largest {top}")
    leaves = [(tuple(q.shape), q.dtype) for q in state.model.parameters()]
    adam = check_adam(dev, "triplane model", leaves)
    bwd = planes_backward(state.model, seen["xyz"], dev)
    bwd.update(step_ms=1e3 * step_s, device_ms=dev_ms, peak_gib=peak)
    return launches, adam, bwd


# ------------------------------------------- data parallelism (19)
@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (the VIRUS grid's evidence
    ``index_add_`` sums in a fixed order, not by atomics), so two runs of
    one computation are bit-identical; warns where an op has no
    deterministic form, and those warnings are printed."""
    import warnings

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    det = getattr(torch.utils, "deterministic", None)
    fill = getattr(det, "fill_uninitialized_memory", None)
    torch.use_deterministic_algorithms(True, warn_only=True)
    if fill is not None:  # no NaN fill of torch.empty: a cost, not an order
        det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        if fill is not None:
            det.fill_uninitialized_memory = fill
        msgs = sorted({str(w.message).split("\n")[0][:160] for w in caught})
        for m in msgs:
            log(f"deterministic mode warned: {m}")


def state_apart(trainer, a, b):
    """The names of the state entries (``Trainer.state_arrays``: parameters,
    Adam moments and count, grid, USS statistics, step, generator; and the
    shard generator) in which two states differ."""
    x, y = trainer.state_arrays(a), trainer.state_arrays(b)
    apart = [k for k in x if not np.array_equal(x[k], y[k])]
    gens = (a.shard_generator, b.shard_generator)
    if (gens[0] is None) != (gens[1] is None) or (
            gens[0] is not None
            and not torch.equal(gens[0].get_state(), gens[1].get_state())):
        apart.append("shard_generator")
    return apart


def stacked(pending, keys):
    """``run_steps``' metrics as (steps, metrics) float32."""
    return torch.stack([torch.stack([m[k].float() for k in keys])
                        for _, m in pending])


def dp_graph_against_eager(name, trainer, mesh, sizes, wrappers, plain=None):
    """Fresh states from one seed, in deterministic mode: the group's
    eager ``run_steps`` against ``make_dp_train_chunk``'s CUDA graphs
    (chunks of ``sizes``), and on one rank the plain trainer's
    ``run_steps`` too; every metric of every step and the whole state
    (shard generators included) bit for bit.  Returns (the graphed state,
    its metrics, the replay-aware launches of its chunks, captures)."""
    from virus_nerf_tpu_torch.ops.launch_counts import GraphLaunches
    from virus_nerf_tpu_torch.parallel import make_dp_train_chunk, shard_state
    from virus_nerf_tpu_torch.training.trainer import METRIC_KEYS

    n = sum(sizes)
    eager, graph = (shard_state(trainer.init_state(), mesh) for _ in range(2))
    pending = trainer.run_steps(eager, n, group=mesh.group)
    keys = [k for k in METRIC_KEYS if k in pending[0][1]]
    refs = {"eager DP": (stacked(pending, keys), eager)}
    if plain is not None:
        sp = plain.init_state()
        refs["plain trainer"] = (stacked(plain.run_steps(sp, n), keys), sp)
    torch.cuda.synchronize()
    reset_counts(wrappers)
    captures = len(GraphLaunches.records)
    out = [make_dp_train_chunk(trainer, mesh, k)(graph) for k in sizes]
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    captures = len(GraphLaunches.records) - captures
    got = torch.stack([torch.cat([m[k] for m in out]).float() for k in keys], 1)
    for ref, (want, state) in refs.items():
        apart = state_apart(trainer, graph, state)
        if not torch.equal(got, want) or apart:
            fail(f"{name}: the graphed chunks differ from the {ref}: state "
                 f"{apart[:6]}; losses {got[:, 0].tolist()} against "
                 f"{want[:, 0].tolist()}")
    pieces = sorted({k[:2] for k in trainer.state_graphs(graph).graphs})
    log(f"{name}: {n} steps in chunks {sizes}: graphed chunks bit-identical "
        f"to the {' and the '.join(refs)} (every metric, parameters, moments, "
        f"count, grid, generators; deterministic mode); graphs {pieces}, "
        f"{captures} captured; launches {launches}")
    if captures < 1:
        fail(f"{name}: no CUDA graph was captured")
    return graph, {k: torch.cat([m[k] for m in out]) for k in keys}, \
        launches, captures


def _dp_card_rank(rank, world, init_method, steps):
    """A rank of the multi-card data-parallel run (one card each, NCCL):
    the bench configuration's ``steps`` steps eagerly and through the
    graphed chunk, bit for bit (deterministic mode); then the replica
    check."""
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.parallel import make_mesh, replica_mismatches
    from virus_nerf_tpu_torch.training.trainer import Trainer

    dev = torch.device("cuda", rank)
    mesh = make_mesh(world, rank=rank, device=dev, backend="nccl",
                     init_method=init_method)
    dataset, scene, _ = make_synthetic_dataset(n_images=16, img_wh=(160, 120),
                                               device=dev)
    trainer = Trainer(bench_config(), dataset, scene=scene, device=dev)
    with deterministic():
        state, m, _, captures = dp_graph_against_eager(
            f"DP path, rank {rank} of {world}", trainer, mesh,
            (8,) * (steps // 8), kernel_wrappers())
    return {"losses": m["loss"].tolist(), "captures": captures,
            "mismatches": replica_mismatches(state, mesh)}


def dp_run(dev, wrappers, card, tmp):
    """Phase 19: data parallelism over ``torch.cuda.device_count()`` ranks
    on NCCL, ``make_dp_train_chunk`` as CUDA graphs with the collectives
    inside.  On one card (a group of one rank), in PyTorch's deterministic
    mode: the bench configuration, 16 steps (two chunks of 8, grid updates
    at steps 0 and 8), and the scale-1.0 configuration, 8 steps (chunks of
    3 and 5: single steps, the fused march once a step), graphed against
    the group's eager ``run_steps`` and the plain trainer, bit for bit;
    then the graphed and eager DP step in turns.  With more cards, the
    bench configuration's 16 steps on every rank, graphed against eager
    and the replicas checked bit-identical (then the one-card checks on
    card 0).  Returns (launches of the bench run, of the scale-1.0 run,
    B1 at the DP path's last step, the fused march on its rays and grid,
    step times, the turns)."""
    import torch.distributed as dist

    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.parallel import (
        make_dp_train_chunk,
        make_mesh,
        replica_mismatches,
        spawn_ranks,
    )
    from virus_nerf_tpu_torch.quality_run import subset
    from virus_nerf_tpu_torch.training.trainer import Trainer

    world = torch.cuda.device_count()
    log(f"DP path: {world} card(s), NCCL")
    if world > 1:
        results = spawn_ranks(_dp_card_rank, world, args=(16,), timeout=600,
                              store_dir=tmp)
        for rank, r in enumerate(results):
            if r["mismatches"] or r["losses"] != results[0]["losses"]:
                fail(f"DP path: rank {rank} diverged: {r['mismatches']}")
        log(f"DP path: {world} ranks graphed, bit-identical to eager DP, "
            f"replicas bit-identical after 16 steps; captures "
            f"{[r['captures'] for r in results]}; losses "
            f"{results[0]['losses'][:2]} ... {results[0]['losses'][-2:]}")
    # the one-rank group of the checks against the plain trainer
    mesh = make_mesh(1, rank=0, device=dev, backend="nccl",
                     init_method=f"file://{os.path.join(tmp, 'dp_store')}")
    cfg = bench_config()
    dataset, scene, _ = make_synthetic_dataset(n_images=16, img_wh=(160, 120),
                                               device=dev)
    times = {}
    try:
        with deterministic():
            plain = Trainer(cfg, dataset, scene=scene, device=dev)
            tr = Trainer(cfg, dataset, scene=scene, device=dev)
            seen = {}
            torch.cuda.reset_peak_memory_stats()
            with forward_inputs(seen):
                sd, m, launches, _ = dp_graph_against_eager(
                    "DP path (1 rank, bench configuration)", tr, mesh, (8, 8),
                    wrappers, plain)
            times["dp_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            sp = plain.init_state()
            plain.run_steps(sp, 16)
            chunk = make_dp_train_chunk(tr, mesh, 8)
            for name, run in (("plain_ms", lambda: plain.run_steps(sp, 8)),
                              ("dp_ms", lambda: chunk(sd))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times[name] = (time.perf_counter() - t0) / 8 * 1e3
            log(f"DP path (1 rank, bench configuration): loss last "
                f"{float(m['loss'][-1]):.4f}; steps 16-24 graphed "
                f"{times['dp_ms']:.2f} ms/step (plain trainer, eager "
                f"{times['plain_ms']:.2f}; deterministic mode); replicas "
                f"{replica_mismatches(sd, mesh)}")
            check_launched("DP path", launches, ("segment_sum", "fused_adam"))
            check_adam_per_step("DP path", launches, 16)
            check_marches("DP path", launches)
            b1 = b1_at_last_step("DP path", sd, seen["xyz"], dev)
            times["dp_device_ms"], top = step_device_ms(lambda: chunk(sd), 8)
            times["plain_device_ms"], _ = step_device_ms(
                lambda: plain.run_steps(sp, 8), 8)
            log(f"DP path: device time {times['dp_device_ms']:.3f} ms/step "
                f"over steps 24-32 (plain trainer {times['plain_device_ms']:.3f}); "
                f"largest {top}")
            del plain, sp, tr, sd, seen
            torch.cuda.empty_cache()

            # scale 1.0: two cascades, exponential stepping; chunks of 3
            # and 5 from step 0: the grid update and single steps
            cfg1 = scale1_config()
            full, scene1, _ = make_synthetic_dataset(
                n_images=24, img_wh=(160, 120), device=dev)
            train1 = subset(full, np.arange(24) % 3 != 0)
            tr1 = Trainer(cfg1, train1, scene=scene1, device=dev)
            plain1 = Trainer(cfg1, train1, scene=scene1, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s1, m1, launches1, _ = dp_graph_against_eager(
                "DP path, scale 1.0", tr1, mesh, (3, 5), wrappers, plain1)
            times["dp_scale1_s"] = time.perf_counter() - t0
            log(f"DP path, scale 1.0: 8 steps, loss {float(m1['loss'][0]):.4f} "
                f"-> {float(m1['loss'][-1]):.4f}, rm_samples last "
                f"{int(m1['rm_samples'][-1])}; eager DP, plain and graphed "
                f"runs in {times['dp_scale1_s']:.2f} s")
            if launches1["march_select"] != 8 or not bool(
                    torch.isfinite(m1["loss"]).all()):
                fail(f"DP path, scale 1.0: march launches "
                     f"{launches1['march_select']} over 8 steps, or a "
                     f"non-finite loss")
            check_marches("DP path, scale 1.0", launches1)
            check_adam_per_step("DP path, scale 1.0", launches1, 8)
            dp_march = check_march(
                "DP path, scale 1.0", *march_case(
                    "DP path, scale 1.0", cfg1, train1, s1.grid.occ_bool, dev)[1:])
            del tr1, plain1, s1
            torch.cuda.empty_cache()
        # a step in turns: eager DP and graphed DP on the one-rank group
        turns = graph_turns("DP 1 rank", cfg, dataset, scene, wrappers, dev,
                            card, group=mesh.group)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return launches, launches1, b1, dp_march, times, turns


@contextlib.contextmanager
def forward_inputs(seen):
    """``seen["xyz"]``: the positions the last model forward of a
    ``Trainer.train_step_on`` took (a CUDA graph's capture keeps its
    static tensor, which holds the last replay's)."""
    from virus_nerf_tpu_torch.training.trainer import Trainer

    step_on = Trainer.train_step_on

    def hooked(self, state, *args, **kwargs):
        hook = state.model.register_forward_pre_hook(
            lambda mod, a: seen.update(xyz=a[0].detach()))
        try:
            return step_on(self, state, *args, **kwargs)
        finally:
            hook.remove()

    with mock.patch.object(Trainer, "train_step_on", hooked):
        yield seen


# --------------------------------------- the population evaluators (20)
def eager_population_scores(cfg, space, pos, call, train, test, scene,
                            info, dev):
    """The population evaluator as it ran eagerly: each particle's chunks
    through ``run_steps`` (chunk k of every particle before chunk k+1 of
    any), then the NeRF depth evaluation; the reference of the graphed
    evaluator's scores."""
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.optimization.runner import score_from_metrics
    from virus_nerf_tpu_torch.parallel import particle_configs
    from virus_nerf_tpu_torch.training.trainer import Trainer

    parts = []
    for c in particle_configs(cfg, space, pos, call):
        tr = Trainer(c, train, scene=scene, device=dev)
        parts.append((tr, tr.init_state(), max(1, min(
            c.training.max_steps, c.evaluation.eval_every_n_steps))))
    while any(st.step < tr.cfg.training.max_steps for tr, st, _ in parts):
        for tr, st, chunk in parts:
            left = tr.cfg.training.max_steps - st.step
            if left > 0:
                tr.run_steps(st, min(chunk, left), 0.0)
    scores = []
    for tr, st, _ in parts:
        ev = Evaluator(tr.cfg, test, scene, img_wh=info["img_wh"], device=dev)
        metrics, _ = ev.evaluate_depth(st.model, st.grid.occ_bool,
                                       np.arange(test.n_images),
                                       sensors=("NeRF",))
        scores.append(score_from_metrics(metrics))
    return np.asarray(scores)


def eager_weights_scores(trainer, weights, steps, tail):
    """The loss-weight evaluator as it ran eagerly: one ``run_steps`` step
    a particle in turns, the loss given the weights as host floats; the
    reference of the graphed evaluator's scores (read from device
    memory)."""
    from virus_nerf_tpu_torch.training import trainer as trainer_module

    base = trainer.loss_weights
    fields = ("color", "rgbd", "tof", "uss")
    parts = [(trainer.init_state(seed=i),
              base._replace(**{f: float(w[j]) for j, f in enumerate(fields)}),
              []) for i, w in enumerate(weights)]
    try:
        with mock.patch.object(trainer_module, "with_device_weights",
                               lambda weights, values: weights):
            for _ in range(steps):
                for st, w, values in parts:
                    trainer.loss_weights = w
                    (_, m), = trainer.run_steps(st, 1, 0.0)
                    values.append(m["loss"])
    finally:
        trainer.loss_weights = base
    return np.asarray([float(torch.stack(v[-tail:]).float().mean())
                       for _, _, v in parts])


def captured(fn):
    """``fn()``, and the pieces whose CUDA graphs were captured during it:
    (the state's number, piece kind, steps, host flags), one a capture."""
    import itertools

    from virus_nerf_tpu_torch.training.trainer import Trainer

    capture, seen, numbers = Trainer._capture, [], itertools.count()

    def counted(self, state, graphs, kind, n, ets, group=None):
        if not hasattr(state, "smoke_number"):
            state.smoke_number = next(numbers)
        seen.append((state.smoke_number, kind, n)
                    + self._piece_flags(state, kind))
        return capture(self, state, graphs, kind, n, ets, group)

    with mock.patch.object(Trainer, "_capture", counted):
        out = fn()
    return out, seen


def check_captures(name, caps, states):
    """``states`` states captured their pieces, none twice (a recapture on
    a particle switch would repeat a piece of a state)."""
    if len(set(caps)) != len(caps) or len({c[0] for c in caps}) != states:
        fail(f"{name}: captures {caps}: want each piece of {states} "
             f"state(s) once")


def population_run(dev, wrappers, card):
    """Phase 20: both PSO population evaluators on the card, each
    particle's chunks as its own CUDA graphs, in PyTorch's deterministic
    mode.  ``parallel.make_population_eval`` (a Trainer a particle, the
    default search space of ``run_optimization``): the bench configuration
    cut to 24 steps on 16 of 24 images, two calls of 3 particles, each
    scored by the NeRF depth evaluation on the 8 held-out images; then
    ``optimization.parallel_eval`` (the loss weights read from device
    memory, the particles in turns on one state): 4 particles x 32 steps,
    twice.  Every score finite, each equal to the eager evaluator's,
    particle 0 equal to its serial run, and no particle switch recaptures:
    the population evaluator's particles capture each piece of their own
    states once, the swarm's first call captures what one particle's
    serial run does and its second call nothing.
    Returns (launches of each, training steps of each, seconds, peaks,
    captures)."""
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.optimization import HParamSpace
    from virus_nerf_tpu_torch.optimization.parallel_eval import (
        make_population_eval as weights_eval,
    )
    from virus_nerf_tpu_torch.optimization.runner import score_from_metrics
    from virus_nerf_tpu_torch.parallel import (
        make_population_eval,
        particle_configs,
        population_devices,
    )
    from virus_nerf_tpu_torch.quality_run import subset
    from virus_nerf_tpu_torch.run_optimization import DEFAULT_LIMS
    from virus_nerf_tpu_torch.training.trainer import Trainer

    cfg = bench_config()
    cfg.training.max_steps = 24
    full, scene, info = make_synthetic_dataset(n_images=24, img_wh=(160, 120),
                                               device=dev)
    sel = np.arange(24) % 3 != 0
    train, test = subset(full, sel), subset(full, ~sel)
    space = HParamSpace(DEFAULT_LIMS)
    rng = np.random.default_rng(0)
    devices = population_devices()
    be = make_population_eval(cfg, space, ((train, scene, info),
                                           (test, scene, info)), devices=devices)
    out = {}
    with deterministic():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        tic = time.perf_counter()
        calls, caps = [], []
        for _ in range(2):
            pos = rng.random((3, space.num_dimensions))
            scores, cap = captured(lambda: be(pos))
            check_captures("population evaluator", cap, 3)
            calls.append((pos, scores))
            caps.append(len(cap))
        torch.cuda.synchronize()
        out["population_s"] = time.perf_counter() - tic
        out["population_launches"] = read_counts(wrappers)
        out["population_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["population_captures"] = caps
        steps = sum(c.training.max_steps for k, (pos, _) in enumerate(calls)
                    for c in particle_configs(cfg, space, pos, k + 1))
        out["population_steps"] = steps
        pos, scores = calls[1]
        cfg0 = particle_configs(cfg, space, pos, 2)[0]
        tr = Trainer(cfg0, train, scene=scene, device=dev)
        st, serial_caps = captured(tr.train)
        serial_caps = len(serial_caps)
        ev = Evaluator(cfg0, test, scene, img_wh=info["img_wh"], device=dev)
        metrics, _ = ev.evaluate_depth(st.model, st.grid.occ_bool,
                                       np.arange(test.n_images),
                                       sensors=("NeRF",))
        serial = score_from_metrics(metrics)
        del tr, st
        tic = time.perf_counter()
        eager = eager_population_scores(cfg, space, pos, 2, train, test, scene,
                                        info, dev)
        torch.cuda.synchronize()
        out["population_eager_s"] = time.perf_counter() - tic
        all_scores = [float(x) for _, s in calls for x in s]
        log(f"population evaluator: 2 calls x 3 particles on {len(devices)} "
            f"card(s), {steps} training steps, {out['population_s']:.2f} s "
            f"(graphs; one eager call {out['population_eager_s']:.2f} s); scores "
            f"{all_scores} (NeRF nn_mean z3, m); call 2 {scores.tolist()}, the "
            f"eager evaluator's {eager.tolist()}; particle 0's serial run "
            f"{serial!r}; graphs captured a call {caps} (a particle's serial "
            f"run {serial_caps}); peak {out['population_peak_gib']:.2f} GiB; "
            f"launches {out['population_launches']}; on {card}")
        if not np.all(np.isfinite(all_scores)) or scores[0] != serial or (
                not np.array_equal(scores, eager)):
            fail("population evaluator: a non-finite score, or a score "
                 "differs from the eager evaluator's or particle 0's from its "
                 "serial run")
        check_adam_per_step("population evaluator", out["population_launches"],
                            steps)
        check_marches("population evaluator", out["population_launches"])
        torch.cuda.empty_cache()

        # the loss-weight evaluator: 4 particles x 32 steps
        trainer = Trainer(cfg, train, scene=scene, device=dev)
        weights = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 8.0, 8.0],
                            [0.2, 1.0, 1.0, 1.0], [1.0, 1.0, 0.1, 0.1]],
                           np.float32)
        wbe = weights_eval(trainer, steps=32, devices=devices)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        tic = time.perf_counter()
        wscores, wcaps = captured(lambda: wbe(weights))
        # the particles take turns on one state: the first captures
        check_captures("loss-weight evaluator", wcaps, 1)
        wcaps = len(wcaps)
        torch.cuda.synchronize()
        out["weights_s"] = time.perf_counter() - tic
        out["weights_launches"] = read_counts(wrappers)
        out["weights_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["weights_steps"] = 4 * 32
        # a second call replays what the first captured
        tic = time.perf_counter()
        again, recaps = captured(lambda: wbe(weights))
        torch.cuda.synchronize()
        out["weights_again_s"] = time.perf_counter() - tic
        check_captures("loss-weight evaluator, a second call", recaps, 0)
        if not np.array_equal(again, wscores):
            fail(f"loss-weight evaluator: a second call gave {again}, the "
                 f"first {wscores}")
        out["weights_captures"] = wcaps
        # particle 0 alone on a trainer of its own: its weights set on the
        # host, one graphed chunk
        alone = Trainer(cfg, train, scene=scene, device=dev)
        alone.loss_weights = alone.loss_weights._replace(
            color=1.0, rgbd=1.0, tof=1.0, uss=1.0)
        s0 = alone.init_state(seed=0)
        (_, keys, m0), serial_wcaps = captured(
            lambda: alone.make_train_chunk(32)(s0))
        serial_wcaps = len(serial_wcaps)
        serial_w = float(m0[-8:, keys.index("loss")].contiguous().mean())
        tic = time.perf_counter()
        weager = eager_weights_scores(trainer, weights, 32, 8)
        torch.cuda.synchronize()
        out["weights_eager_s"] = time.perf_counter() - tic
        out["step_device_ms"], _ = step_device_ms(
            lambda: alone.run_steps(s0, 8, 0.0), 8)
        log(f"population paths: a particle's step (the bench configuration, "
            f"steps 32-40, eager) takes {out['step_device_ms']:.3f} ms of "
            f"device time; peak {out['population_peak_gib']:.2f} GiB "
            f"(population evaluator), {out['weights_peak_gib']:.2f} GiB (loss "
            f"weights)")
        log(f"loss-weight evaluator: 4 particles x 32 steps, "
            f"{out['weights_s']:.2f} s (graphs; a second call, every graph "
            f"replayed, {out['weights_again_s']:.2f} s; eager "
            f"{out['weights_eager_s']:.2f} s); scores {wscores.tolist()} (mean "
            f"loss of the last 8 steps), the eager evaluator's "
            f"{weager.tolist()}; particle 0's serial run {serial_w!r}; graphs "
            f"captured {wcaps}, then 0 (a particle's serial run "
            f"{serial_wcaps}); "
            f"launches {out['weights_launches']}")
        if not np.all(np.isfinite(wscores)) or wscores[0] != serial_w or (
                not np.array_equal(wscores, weager)):
            fail("loss-weight evaluator: a non-finite score, or a score "
                 "differs from the eager evaluator's or particle 0's from its "
                 "serial run")
        if wcaps != serial_wcaps:
            fail(f"loss-weight evaluator: {wcaps} graphs captured for 4 "
                 f"particles on one state, {serial_wcaps} by one serial run")
        check_adam_per_step("loss-weight evaluator", out["weights_launches"], 128)
        check_marches("loss-weight evaluator", out["weights_launches"])
    return out


# ---------------------------------- the evaluator's remainder (22-25)
def route_model(trainer, model, route, device):
    """A copy of ``model`` on ``device`` with the hash forward ``route``."""
    from virus_nerf_tpu_torch.models.ngp import NGPModel

    copy_ = NGPModel(**{**trainer.model_kwargs, "hash_forward": route},
                     device=device)
    copy_.load_state_dict({k: v.to(device)
                           for k, v in model.state_dict().items()})
    return copy_


def density_gap(card, cpu):
    """Largest |card - cpu| / max(1, |cpu|) (the NGP grid's tolerance of a
    density in ``reference_step``)."""
    return float(np.max(np.abs(card - cpu) / np.maximum(1.0, np.abs(cpu))))


def ethz_remainder(trainer, state, save, wrappers, card, tmp):
    """Phase 22 on the ETHZ run's map: ``log.txt``; ``density_slice`` and
    ``infer_density_map`` on the card, for the run's route and the slabs
    route (B5), each against the same calls on a CPU copy of the model;
    ``export_nerf_pointcloud`` (L1 once a chunk) to a PCD read back; and
    ``save_deployment_model``, reloaded.  Every kernel count is set to 0
    just before each part and read just after.  Returns the launches of
    the density probes and of the export, and their numbers."""
    from virus_nerf_tpu_torch.data.pcl import load_pcd
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.utils.deployment import (
        infer_density_map,
        save_deployment_model,
    )

    cfg, dev, scene = trainer.cfg, trainer.device, trainer.scene
    out = {}
    with open(os.path.join(save, "log.txt")) as f:
        lines = f.read().splitlines()
    marks = [sum("----- START TRAINING -----" in x for x in lines),
             sum("----- FINISHED TRAINING -----" in x for x in lines),
             sum(" | loss " in x for x in lines)]
    log(f"ETHZ log.txt: {len(lines)} lines, START {marks[0]}, FINISHED "
        f"{marks[1]}, step lines {marks[2]}; first {lines[:1]}")
    if marks[:2] != [1, 1] or marks[2] < 1:
        fail("ETHZ run: log.txt lacks the trainer's START/FINISHED/step lines")

    # the density probes: the run's route (corners) and the slabs route
    ev = Evaluator(cfg, trainer.test_dataset, scene, img_wh=trainer.img_wh,
                   device=dev)
    height_w = float(np.mean(scene.c2w(ev.ds["poses"][:, :3, 3])[:, 2]))
    height_c = float(scene.w2c(np.array([[0.0, 0.0, height_w]]))[0, 2])
    tol_c = float(scene.w2c(cfg.evaluation.height_tolerance, only_scale=True))
    L, A, thr = 256, 3, cfg.evaluation.density_map_thr
    B = cfg.evaluation.batch_size
    density_launches = {k: 0 for k in wrappers}
    for route in ("corners", "slabs"):
        res, secs = {}, {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            model = route_model(trainer, state.model, route, d)
            torch.cuda.synchronize()
            reset_counts(wrappers)
            tic = time.perf_counter()
            dm, dthr = ev.density_slice(model, L, height_w, A,
                                        cfg.evaluation.height_tolerance, thr)
            im = infer_density_map(model, L, height_c, A, tol_c, batch_size=B)
            torch.cuda.synchronize()
            secs[where] = time.perf_counter() - tic
            if where == "card":
                for k, v in read_counts(wrappers).items():
                    density_launches[k] += v
            res[where] = (dm, dthr, im)
            del model
        (dm, dthr, im), (dm_c, dthr_c, im_c) = res["card"], res["cpu"]
        gap_slice, gap_map = density_gap(dm, dm_c), density_gap(im, im_c)
        near = np.abs(dm_c - thr) <= 1e-4 * np.maximum(1.0, np.abs(dm_c))
        flips = int((dthr != dthr_c)[~near].sum())
        log(f"ETHZ density, {route} route: density_slice {L}x{L}x{A} at "
            f"{height_w:.3f} m +- {cfg.evaluation.height_tolerance} (nanmax, "
            f"threshold {thr:g}: {int(dthr.sum())} cells) and "
            f"infer_density_map (mean) on the card {secs['card']:.3f} s, on "
            f"the CPU copy {secs['cpu']:.3f} s; max |card - CPU| / max(1, "
            f"|CPU|) {gap_slice:.2e} and {gap_map:.2e} (tol 1e-4); thresholded "
            f"cells that differ away from the threshold {flips}; "
            f"density range [{dm.min():.3g}, {dm.max():.3g}]")
        if gap_slice > 1e-4 or gap_map > 1e-4 or flips or not np.all(
                np.isfinite(dm)) or dm.shape != (L, L):
            fail(f"ETHZ density ({route}): the card disagrees with the CPU")
        out[f"density_{route}"] = {"card_s": secs["card"], "cpu_s": secs["cpu"],
                                   "max_rel_err": max(gap_slice, gap_map)}
    log(f"ETHZ density probes: kernel launches {density_launches}")
    check_launched("ETHZ density probes (slabs route)", density_launches,
                   ("widen_slabs",))

    # the point-cloud export: 16 test poses x 2 heights x res_angular rays
    origins = scene.c2w(ev.ds["poses"][:16, :3, 3])
    path = os.path.join(tmp, "nerf_pcl", "cloud.pcd")
    n_rays = origins.shape[0] * 2 * cfg.evaluation.res_angular
    chunks = -(-n_rays // B)
    torch.cuda.synchronize()
    reset_counts(wrappers)
    tic = time.perf_counter()
    pts = ev.export_nerf_pointcloud(state.model, state.grid.occ_bool, origins,
                                    path)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - tic
    export_launches = read_counts(wrappers)
    back = load_pcd(path)
    log(f"ETHZ export_nerf_pointcloud: {n_rays} rays in {chunks} chunks, "
        f"{pts.shape[0]} points (opacity > 0.5) in {export_s:.3f} s, PCD of "
        f"{os.path.getsize(path)} bytes read back {back.shape}; launches "
        f"{export_launches}")
    check_marches("ETHZ export", export_launches)
    if (export_launches["march_select"] != chunks or pts.shape[0] == 0
            or not np.array_equal(back, pts.astype(np.float32))):
        fail("ETHZ export: wrong launches, an empty cloud, or the PCD differs")
    out["export_s"], out["export_points"] = export_s, int(pts.shape[0])

    # the deployment export
    m = state.model
    grid = state.grid.occ_3d_grid.reshape(1, -1)
    tic = time.perf_counter()
    dpath = save_deployment_model(m, grid, trainer.train_dataset.poses, save)
    dep = np.load(dpath, allow_pickle=True).item()
    dep_s = time.perf_counter() - tic
    width = m.rgb_net[-1].weight.shape[1]
    want = {
        "poses": (trainer.train_dataset.n_images, 3, 4),
        "model.density_bitfield": (cfg.model.grid_size**3 // 8,),
        "model.hash_encoder.params": (m.pos_table.numel(),),
        "model.xyz_encoder.params": (sum(x.weight.numel() for x in m.xyz_net),),
        "model.rgb_net.params": (sum(x.weight.numel() for x in m.rgb_net[:-1])
                                 + 16 * width,),
    }
    shapes = {k: np.shape(v) for k, v in dep.items()}
    bits = int(np.unpackbits(dep["model.density_bitfield"]).sum())
    occupied = int((grid > 0.5).sum())
    log(f"ETHZ deployment.npy: {os.path.getsize(dpath)} bytes in "
        f"{dep_s:.2f} s; keys and shapes {shapes}; per_level_scale "
        f"{dep['model.per_level_scale']!r}; bitfield bits set {bits}, "
        f"occupied cells {occupied}")
    if (list(dep) != ["poses", *list(want)[1:3], "model.per_level_scale",
                      *list(want)[3:]]
            or any(shapes[k] != v for k, v in want.items())
            or dep["model.per_level_scale"] != m.hash_spec.log_b
            or bits != occupied):
        fail("ETHZ deployment.npy: wrong keys, shapes or bitfield")
    return density_launches, export_launches, out


def no_matplotlib_check(trainer, state, tmp):
    """Phase 25: every new module imports in a fresh interpreter in which
    matplotlib cannot be imported, and ``evaluate(plot=True)`` raises
    ImportError naming matplotlib (here, with matplotlib blocked too)."""
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator

    code = """
import importlib, sys
class NoMatplotlib:
    def find_spec(self, name, path=None, target=None):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
sys.meta_path.insert(0, NoMatplotlib())
mods = ["virus_nerf_tpu_torch.analysis",
        "virus_nerf_tpu_torch.analysis.result_plots",
        "virus_nerf_tpu_torch.analysis.uss_experiments",
        "virus_nerf_tpu_torch.evaluation.plots",
        "virus_nerf_tpu_torch.optimization.plots",
        "virus_nerf_tpu_torch.utils.deployment",
        "virus_nerf_tpu_torch.utils.logging"]
for m in mods:
    importlib.import_module(m)
print("imported", len(mods), "modules")
"""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", code], cwd=here,
                          env=dict(os.environ, PYTHONPATH=here),
                          capture_output=True, text=True, timeout=300)
    log(f"without matplotlib: {proc.stdout.strip()} (exit {proc.returncode}) "
        f"{proc.stderr.strip()[-500:]}")
    if proc.returncode != 0:
        fail("a new module does not import without matplotlib")
    ev = Evaluator(trainer.cfg, trainer.test_dataset, trainer.scene,
                   img_wh=trainer.img_wh, device=trainer.device)
    with mock.patch.dict(sys.modules, {"matplotlib": None,
                                       "matplotlib.pyplot": None}):
        try:
            ev.evaluate(state.model, state.grid.occ_bool,
                        save_dir=os.path.join(tmp, "plots"), plot=True)
        except ImportError as e:
            log(f"evaluate(plot=True) without matplotlib: ImportError: {e}")
            if "matplotlib" not in str(e):
                fail("evaluate(plot=True): the ImportError does not name "
                     "matplotlib")
        else:
            fail("evaluate(plot=True) without matplotlib did not raise")


def eval_budget(name, trainer, state, wrappers, card):
    """Phase 23 on a recorded room's trained map: the final evaluation
    (``Evaluator.evaluate`` with the run's defaults) dense and with
    ``evaluation.sample_budget`` = the training's automatic rule at the
    evaluation's chunk (batch_size * min(32, max_samples_per_ray)), in
    turns sampled, dense, dense, sampled: seconds, peak device GiB above
    what the map holds, NND z3 and PSNR of each, and the samples the dense
    march keeps a chunk.  Returns (launches, numbers)."""
    import copy

    from virus_nerf_tpu_torch.evaluation import evaluator as evmod

    cfg = trainer.cfg
    budget = cfg.evaluation.batch_size * min(32, cfg.evaluation.max_samples_per_ray)
    render = evmod.render_rays
    seen = []

    def counted(*args, **kwargs):
        res = render(*args, **kwargs)
        seen.append((res["rm_samples"], res["overflow"]))
        return res

    runs = {"sampled": [], "dense": []}
    launches = {k: 0 for k in wrappers}
    with mock.patch.object(evmod, "render_rays", counted):
        for mode in ("sampled", "dense", "dense", "sampled"):
            c = copy.deepcopy(cfg)
            c.evaluation.sample_budget = budget if mode == "sampled" else None
            ev = evmod.Evaluator(c, trainer.test_dataset, trainer.scene,
                                 img_wh=trainer.img_wh, device=trainer.device)
            seen.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts(wrappers)
            tic = time.perf_counter()
            m = ev.evaluate(state.model, state.grid.occ_bool)
            torch.cuda.synchronize()
            sec = time.perf_counter() - tic
            for k, v in read_counts(wrappers).items():
                launches[k] += v
            samples = torch.stack([x for x, _ in seen]).double()
            over = int(torch.stack([y for _, y in seen]).sum())
            runs[mode].append({
                "seconds": sec,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "above_map_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                "nnd_z3": float(m["NeRF"]["nn_mean"]["zone3"]),
                "psnr": float(m["NeRF"]["psnr"]),
                "chunks": len(seen),
                "samples_a_chunk_mean": float(samples.mean()),
                "samples_a_chunk_max": float(samples.max()),
                "overflow_samples": over})
            del ev
    for mode in ("dense", "sampled"):
        r = runs[mode]
        log(f"{name} evaluation, {mode}"
            f"{f' (sample_budget {budget})' if mode == 'sampled' else ''}: "
            f"{[round(x['seconds'], 2) for x in r]} s, peak "
            f"{[round(x['peak_gib'], 2) for x in r]} GiB "
            f"({[round(x['above_map_gib'], 2) for x in r]} above the map), "
            f"NeRF nn_mean z3 {[x['nnd_z3'] for x in r]} m, psnr "
            f"{[round(x['psnr'], 3) for x in r]}; {r[0]['chunks']} render "
            f"chunks, marched samples a chunk mean "
            f"{r[0]['samples_a_chunk_mean']:.0f} max "
            f"{r[0]['samples_a_chunk_max']:.0f}, samples over the budget "
            f"{r[0]['overflow_samples']}; on {card}")
        if not all(np.isfinite(x["nnd_z3"]) for x in r):
            fail(f"{name} evaluation ({mode}): non-finite NND")
    check_marches(f"{name} evaluations", launches)
    numbers = {mode: {k: [x[k] for x in r] for k in r[0]}
               for mode, r in runs.items()}
    numbers["sample_budget"] = budget
    return launches, numbers


def mesh2d_run(dev, wrappers, card, tmp):
    """Phase 24: ``optimization.parallel_eval``'s 2-D ``(pop, data)``
    nesting on the cards present, ``(1, 1)`` on one card (a process group
    of one rank on NCCL): the loss weights of 4 particles, 16 steps each
    on the bench configuration (16 of 24 images), in PyTorch's
    deterministic mode, each particle's run through the graphed
    data-parallel chunk; the scores equal to the 1-D evaluator's for the
    same positions and seeds (each evaluator on a trainer of its own), the
    particles in turns on one state whose pieces the first call captures
    (the second replays);
    B1 2, B2 1 and the march 1 launch a step.
    Returns (launches, steps, seconds)."""
    import torch.distributed as dist

    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.optimization.parallel_eval import (
        make_population_eval as weights_eval,
    )
    from virus_nerf_tpu_torch.parallel import make_mesh
    from virus_nerf_tpu_torch.quality_run import subset
    from virus_nerf_tpu_torch.training.trainer import Trainer

    cfg = bench_config()
    full, scene, _ = make_synthetic_dataset(n_images=24, img_wh=(160, 120),
                                            device=dev)
    train = subset(full, np.arange(24) % 3 != 0)
    # a trainer each: a trainer keeps the graphs of one state
    trainers = {kind: Trainer(cfg, train, scene=scene, device=dev)
                for kind in ("2-D", "1-D")}
    weights = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 8.0, 8.0],
                        [0.2, 1.0, 1.0, 1.0], [1.0, 1.0, 0.1, 0.1]],
                       np.float32)
    steps = 16
    make_mesh(1, rank=0, device=dev, backend="nccl",
              init_method=f"file://{os.path.join(tmp, 'mesh2d_store')}")
    try:
        with deterministic():
            evals = {"2-D": weights_eval(trainers["2-D"], steps=steps,
                                         devices=[[dev]]),
                     "1-D": weights_eval(trainers["1-D"], steps=steps,
                                         devices=[dev])}
            secs, scores, caps = {"2-D": [], "1-D": []}, {}, {}
            # in turns 2-D, 1-D, 1-D, 2-D; the counts of the first call
            for i, kind in enumerate(("2-D", "1-D", "1-D", "2-D")):
                torch.cuda.synchronize()
                reset_counts(wrappers)
                tic = time.perf_counter()
                got, cap = captured(lambda: evals[kind](weights))
                torch.cuda.synchronize()
                secs[kind].append(time.perf_counter() - tic)
                # one state a rank, captured by the first call of each
                check_captures(f"2-D population, {kind}", cap,
                               0 if kind in caps else 1)
                caps.setdefault(kind, []).append(len(cap))
                if i == 0:
                    launches = read_counts(wrappers)
                if kind in scores and not np.array_equal(scores[kind], got):
                    fail(f"2-D population: two {kind} calls differ")
                scores[kind] = got
    finally:
        dist.destroy_process_group()
    n_steps = len(weights) * steps
    s2, s1 = scores["2-D"], scores["1-D"]
    sec2, sec1 = secs["2-D"], secs["1-D"]
    log(f"2-D (pop, data) population, (1, 1) on one card: 4 particles x "
        f"{steps} steps in {[round(x, 3) for x in sec2]} s (the 1-D "
        f"evaluator {[round(x, 3) for x in sec1]} s; in turns 2-D, 1-D, "
        f"1-D, 2-D); scores {s2.tolist()}, 1-D {s1.tolist()}; CUDA graphs "
        f"captured by each call {caps} (the 2-D rows through the graphed "
        f"data-parallel chunk); launches {launches}; on {card}")
    if not (np.all(np.isfinite(s2)) and np.array_equal(s1, s2)):
        fail("2-D population: scores not finite or not the 1-D evaluator's")
    check_adam_per_step("2-D population", launches, n_steps)
    check_marches("2-D population", launches)
    if launches["segment_sum"] != 2 * n_steps:
        fail(f"2-D population: {launches['segment_sum']} B1 launches over "
             f"{n_steps} steps, want 2 a step")
    return launches, n_steps, {"mesh_s": sec2, "flat_s": sec1}


# -------------------------------------- the chunk as CUDA graphs (26)
def assert_same_state(name, a, b):
    """Parameters, Adam moments and count, grid, USS statistics and the
    generator bit for bit; fails naming the first difference."""
    pairs = [("count", a.optimizer.count, b.optimizer.count),
             ("generator", a.generator.get_state(), b.generator.get_state())]
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        pairs.append((f"params.{n}", p, q))
        pairs += [(f"adam.{m}.{n}", x, y) for m, x, y in
                  zip(("mu", "nu"), a.optimizer._moments(p), b.optimizer._moments(q))]
    pairs += [(f"grid.{f}", x, y) for f, x, y in zip(a.grid._fields, a.grid, b.grid)
              if torch.is_tensor(x)]
    if a.uss_stats is not None:
        pairs += [(f"uss_stats.{f}", x, y) for f, x, y in
                  zip(a.uss_stats._fields, a.uss_stats, b.uss_stats)]
    bad = [n for n, x, y in pairs if not torch.equal(x, y)]
    if bad or a.step != b.step or getattr(a.grid, "update_step", 0) != getattr(
            b.grid, "update_step", 0):
        fail(f"{name}: graph and eager differ in {bad[:6]} (steps {a.step}, "
             f"{b.step})")


def graph_cases(dev, ethz):
    """(name, config, dataset, scene, trainer kwargs, eager steps first,
    chunk sizes) of phase 26: bench and scale 1.0 32 steps, the rest 16;
    the chunk sizes make every piece kind: groups (aligned), single steps
    after an unaligned entry (scale 1.0), lone grid updates (XOR)."""
    from virus_nerf_tpu_torch import quality_run
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset

    ds, scene, _ = make_synthetic_dataset(n_images=16, img_wh=(160, 120),
                                          device=dev)
    wide = ["--hash-levels", "16", "--hash-feats", "2"]
    xor = quality_run.quality_config(quality_run.parse_args(
        ["--hash-variant", "xor", *wide]))
    mixed = quality_run.quality_config(quality_run.parse_args(
        [*wide, "--dtype", "mixed"]))
    tri = bench_config()
    tri.model.encoder_type = "triplane"
    slabs = dict(hash_forward="slabs", hash_backward="factors")
    return [
        ("bench", bench_config(), ds, scene, {}, 0, (32,)),
        ("scale 1.0", scale1_config(), ds, scene, {}, 3, (29,)),
        ("XOR", xor, ds, scene, {}, 0, (5, 3, 5, 3)),
        ("slabs+factors mixed", mixed, ds, scene, slabs, 0, (16,)),
        ("tri-plane", tri, ds, scene, {}, 0, (16,)),
        ("ETHZ Config()", *ethz, {}, 0, (16,)),
    ]


def graph_against_eager(name, cfg, ds, scene, kw, pre, sizes, wrappers, dev):
    """Fresh states from one seed, in deterministic mode (the VIRUS grid's
    evidence sum in a fixed order): ``run_steps`` (eager) against
    ``make_train_chunk``'s graphs; every metric of every step and the whole
    state bit for bit.  Returns the graph run's replay-aware launches."""
    from virus_nerf_tpu_torch.training.trainer import METRIC_KEYS, Trainer

    tr = Trainer(cfg, ds, scene=scene, device=dev, **kw)
    n = sum(sizes)
    with deterministic():
        eager, graph = tr.init_state(7), tr.init_state(7)
        tr.run_steps(eager, pre)
        tr.run_steps(graph, pre)
        pending = tr.run_steps(eager, n)
        torch.cuda.synchronize()
        reset_counts(wrappers)
        rows = []
        for size in sizes:
            _, keys, m = tr.make_train_chunk(size)(graph)
            rows.append(m)
        torch.cuda.synchronize()
        launches = read_counts(wrappers)
    got = torch.cat(rows)
    want = torch.stack([torch.stack([m[k].float() for k in keys])
                        for _, m in pending])
    if keys != [k for k in METRIC_KEYS if k in pending[0][1]] or not torch.equal(
            got, want):
        fail(f"{name}: graph metrics differ from eager: losses "
             f"{got[:, 0].tolist()} against {want[:, 0].tolist()}")
    assert_same_state(name, graph, eager)
    pieces = sorted({k[:2] for k in tr.state_graphs(graph).graphs})
    log(f"graph vs eager, {name}: {pre} eager steps, then chunks {sizes}: "
        f"losses, every metric, parameters, moments, count, grid"
        f"{', USS statistics' if eager.uss_stats is not None else ''} and "
        f"generator bit-identical over {n} steps (deterministic mode); graphs "
        f"{pieces}; launches in the chunks {launches}")
    check_adam_per_step(f"graph {name}", launches, n)
    check_marches(f"graph {name}", launches)
    del tr, eager, graph, pending
    torch.cuda.empty_cache()
    return launches


def profile_launches(fn, n_steps, names=()):
    """Host launches a step (cudaLaunchKernel and cudaGraphLaunch calls),
    device ms a step (every kernel's and copy's own time), and the device
    kernels whose name holds each of ``names``, from ``torch.profiler``
    over ``fn()`` (``n_steps`` steps)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    ev = prof.key_averages()
    kernel = sum(e.count for e in ev if "LaunchKernel" in e.key) / n_steps
    graph = sum(e.count for e in ev if "GraphLaunch" in e.key) / n_steps
    # the device's own entries (a host op's entry repeats its kernels' time)
    on_device = [e for e in ev if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / n_steps
    device_kernels = {k: sum(e.count for e in on_device if k in e.key)
                      for k in names}
    return kernel, graph, dev_ms, device_kernels


def graph_turns(name, cfg, ds, scene, wrappers, dev, card, chunk=24,
                group=None):
    """Eager (``run_steps``) against graph (``make_train_chunk``) a step,
    each on its own state warmed by 48 steps, in turns eager, graph, graph,
    eager over ``chunk`` steps each: host launches (profiler), the port's
    kernel launches (replay-aware counts), device ms and host ms (clock
    after a sync).  Once, on the graph's first turn, the replay-aware
    counts of B2 and the march are held against the kernels the
    profiler saw on the device.  ``group``: a process group of one rank
    (both take its collectives)."""
    from virus_nerf_tpu_torch.training.trainer import Trainer

    tr = Trainer(cfg, ds, scene=scene, device=dev)
    eager, graph = tr.init_state(7), tr.init_state(7)
    tr.run_steps(eager, 48, group=group)
    run_chunk = tr.make_train_chunk(chunk, group)
    run_chunk(graph)
    run_chunk(graph)
    fns = {"eager": lambda: tr.run_steps(eager, chunk, group=group),
           "graph": lambda: run_chunk(graph)}
    out = {k: {"host_ms": [], "device_ms": [], "launches": [],
               "graph_launches": [], "kernel_launches": []} for k in fns}
    checked = False
    for kind in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fns[kind]()
        torch.cuda.synchronize()
        out[kind]["host_ms"].append(1e3 * (time.perf_counter() - tic) / chunk)
        reset_counts(wrappers)
        kernel, glaunch, dev_ms, seen = profile_launches(
            fns[kind], chunk, ("fused_adam_kernel", "march_select_kernel"))
        counts = read_counts(wrappers)
        out[kind]["launches"].append(kernel)
        out[kind]["graph_launches"].append(glaunch)
        out[kind]["device_ms"].append(dev_ms)
        out[kind]["kernel_launches"].append(
            {k: v / chunk for k, v in counts.items() if v})
        if kind == "graph" and not checked:
            checked = True
            want = {"fused_adam_kernel": counts["fused_adam"],
                    "march_select_kernel": counts["march_select"]}
            log(f"graph turns, {name}: replay-aware counts {want} against the "
                f"device kernels the profiler saw {seen} over {chunk} steps")
            # the profiler may drop a kernel's record (see device_ms): a
            # session that saw fewer is profiled again, up to twice; one
            # that saw more, or counts that change, fail at once
            for _ in range(2):
                if want == seen or any(seen[k] > want[k] for k in want):
                    break
                reset_counts(wrappers)
                _, _, _, seen = profile_launches(
                    fns[kind], chunk, tuple(want))
                if read_counts(wrappers) != counts:
                    fail(f"{name}: replay-aware counts changed between "
                         f"calls: {counts}, then {read_counts(wrappers)}")
                log(f"graph turns, {name}: profiled again, the profiler saw "
                    f"{seen}")
            if want != seen or counts["fused_adam"] != chunk:
                fail(f"{name}: replay-aware launch counts {want} differ from "
                     f"the profiler's {seen}")
    for kind, r in out.items():
        log(f"graph turns, {name}, {kind}: host ms a step {r['host_ms']}, device "
            f"ms a step {r['device_ms']}, host launches a step (cudaLaunchKernel) "
            f"{r['launches']}, cudaGraphLaunch a step {r['graph_launches']}, "
            f"port kernels a step {r['kernel_launches'][0]}; on {card}")
    del tr, eager, graph
    torch.cuda.empty_cache()
    return out


TRACE_STEP_PHASES = ("sample", "march", "forward", "loss", "backward", "adam",
                     "stats")


def stamp_sequence(pieces):
    """The phases a chunk's pieces (``Trainer._pieces``) stamp, in order:
    a piece's start, its grid update, then each step's seven."""
    seq = []
    for kind, n in pieces:
        seq.append("between")
        if kind != "step":
            seq.append("grid_update")
        seq += list(TRACE_STEP_PHASES) * n
    return seq


def stamp_kernel_phases(trace_path, seq):
    """The device's kernels, copies and fills of a Chrome trace in time
    order, split at the stamp kernels: {phase: {name: [us, calls]}} (each
    stamp ends the phase ``seq`` names, counted from the last stamp back,
    so records the profiler lost at its start shift nothing; what runs
    after the last one is under "after"), and the stamps the trace
    holds."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    work = sorted((e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    stamps = sum("trace_stamp_kernel" in e["name"] for e in work)
    out, i = {}, len(seq) - stamps
    for e in work:
        if "trace_stamp_kernel" in e["name"]:
            i += 1
            continue
        phase = seq[i] if 0 <= i < len(seq) else "after"
        acc = out.setdefault(phase, {}).setdefault(_demangle(e["name"]),
                                                   [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1
    return out, stamps


def tracing_run(dev, wrappers, card, chunk=24):
    """The tracer's phase stamps on the card (phase 27).  In deterministic
    mode, the bench configuration's chunk of ``chunk`` steps as CUDA graphs
    on two trainers from one seed, one with the tracer off and one with it
    on, two chunks each (warm-up and capture, then replays).  Off: no stamp
    launched and no graph holding one.  On: the replay-aware stamp
    launches (seven a step, one a piece and one a grid update, plus
    reset's own), each graph holding its stamps, the phase counts equal to
    ``trace_stamp_plain``'s over the same stamp sequence, no negative
    phase sum, and the metrics and the whole state bit for bit the
    tracer-off run's.  Then, outside deterministic mode, one state holding
    both graph sets (the key holds the tracer's state): one stamped chunk
    under ``torch.profiler``, whose device kernels between two stamps are
    the phase's (B2 only in ``adam``, the march only in ``march``, B1 only
    in ``backward``), printed beside the stamps' ms a step of an
    unprofiled chunk; then host ms a step with the tracer off and on, in
    turns."""
    from torch.profiler import ProfilerActivity, profile

    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.ops.trace_stamp import (
        stamp_buffer,
        trace_stamp,
        trace_stamp_plain,
    )
    from virus_nerf_tpu_torch.training.trainer import Trainer
    from virus_nerf_tpu_torch.utils import tracing

    ds, scene, _ = make_synthetic_dataset(n_images=16, img_wh=(160, 120),
                                          device=dev)
    cfg = bench_config()
    slots = len(tracing.PHASES) + 1
    try:
        tr_off = Trainer(cfg, ds, scene=scene, device=dev)
        tr_on = Trainer(cfg, ds, scene=scene, device=dev)
        with deterministic():
            off, on = tr_off.init_state(7), tr_on.init_state(7)
            run_off = tr_off.make_train_chunk(chunk)
            run_on = tr_on.make_train_chunk(chunk)
            reset_counts(wrappers)
            m_off = [run_off(off)[2] for _ in range(2)]
            torch.cuda.synchronize()
            off_stamps = read_counts(wrappers)["trace_stamp"]
            tracing.enable()
            m_on = [run_on(on)[2]]
            torch.cuda.synchronize()
            seq = stamp_sequence(tr_on._pieces(on.step, chunk))
            reset_counts(wrappers)
            tracing.reset()  # after the counts' reset, which zeroes replays
            m_on.append(run_on(on)[2])
            torch.cuda.synchronize()
            snap = tracing.snapshot()
            on_stamps = read_counts(wrappers)["trace_stamp"]
            card_buf = tracing._clock(dev).cpu()
            tracing.enable(False)
        held = {name: {k[:2]: g.launches.held.get(trace_stamp, 0)
                       for k, g in tr.state_graphs(st).graphs.items()}
                for name, tr, st in (("off", tr_off, off), ("on", tr_on, on))}
        want_held = {k: 7 * k[1] + 1 + (k[0] != "step") for k in held["on"]}
        log(f"tracing: stamp launches over 48 steps with the tracer off "
            f"{off_stamps}, stamps each graph holds {held}")
        if off_stamps or any(held["off"].values()) or held["on"] != want_held:
            fail(f"tracing: stamps off {off_stamps}, graphs hold {held}, want "
                 f"none off and {want_held} on")
        want = 7 * chunk + seq.count("between") + seq.count("grid_update") + 1
        plain = stamp_buffer(slots, "cpu")
        trace_stamp_plain(plain, slots - 1)
        for p in seq:
            trace_stamp_plain(plain, tracing.PHASES.index(p))
        n_card, n_plain = card_buf[slots:2 * slots], plain[slots:2 * slots]
        phase_ms = {p: snap.get(f"phase.{p}.ms", 0.0) for p in tracing.PHASES}
        log(f"tracing: replayed chunk of {chunk} steps: stamp launches "
            f"{on_stamps} (want {want}), phase counts {n_card.tolist()} "
            f"(trace_stamp_plain over the same sequence {n_plain.tolist()}), "
            f"graph captures {snap.get('count.trainer.captures')} and replays "
            f"{snap.get('count.trainer.replays')}, phase ms {phase_ms}")
        if on_stamps != want or not torch.equal(n_card, n_plain) or bool(
                (card_buf[:slots] < 0).any()) or snap.get(
                "count.trainer.captures") != 0:
            fail(f"tracing: stamps {on_stamps} (want {want}), counts "
                 f"{n_card.tolist()} against {n_plain.tolist()}, sums "
                 f"{card_buf[:slots].tolist()}, snapshot {snap}")
        if not torch.equal(torch.cat(m_off), torch.cat(m_on)):
            fail(f"tracing: metrics differ with the tracer on: losses "
                 f"{torch.cat(m_on)[:, 0].tolist()} against "
                 f"{torch.cat(m_off)[:, 0].tolist()}")
        assert_same_state("tracing on against off", on, off)
        log(f"tracing: {2 * chunk} steps with the tracer on and off: every "
            f"metric, parameters, moments, count, grid and generator "
            f"bit-identical")
        del tr_off, tr_on, off, on, m_off, m_on
        torch.cuda.empty_cache()

        tr = Trainer(cfg, ds, scene=scene, device=dev)
        st = tr.init_state(7)
        run = tr.make_train_chunk(chunk)
        for on in (False, False, True, True):
            tracing.enable(on)
            run(st)
        torch.cuda.synchronize()
        tracing.reset()
        run(st)
        torch.cuda.synchronize()
        snap = tracing.snapshot()  # the phases without the profiler
        seq = stamp_sequence(tr._pieces(st.step, chunk))
        tracing.reset()
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(st)
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            kernels, seen = stamp_kernel_phases(path, seq)
        # the profiler may lose records at its start (see device_ms)
        log(f"tracing: the profiler saw {seen} of the chunk's {len(seq)} "
            f"stamps")
        if not len(seq) - 8 <= seen <= len(seq):
            fail(f"tracing: the profiler saw {seen} of {len(seq)} stamps")
        attribution = {}
        for p in (*tracing.PHASES, "after"):
            ks = kernels.get(p, {})
            top = sorted(ks.items(), key=lambda kv: -kv[1][0])[:4]
            attribution[p] = {
                "stamp_ms_a_step": snap.get(f"phase.{p}.ms", 0.0) / chunk,
                "kernel_ms_a_step": sum(v[0] for v in ks.values()) / 1e3 / chunk,
                "kernels": sum(v[1] for v in ks.values()),
                "top": {k[:80]: [round(v[0] / 1e3 / chunk, 5), v[1]]
                        for k, v in top}}
            log(f"tracing: phase {p}: {attribution[p]}")
        homes = {"fused_adam_kernel": "adam", "march_select_kernel": "march",
                 "TransposedLoader": "backward"}  # B2, the march, B1
        found = {k: [p for p, ks in kernels.items() if any(k in n for n in ks)]
                 for k in homes}
        if any(v != [homes[k]] for k, v in found.items()):
            fail(f"tracing: kernels outside their phase: {found}")

        # host ms a step, the tracer off and on in turns
        turns = {"off": [], "on": []}
        for kind in ("off", "on", "on", "off") * 2:
            tracing.enable(kind == "on")
            torch.cuda.synchronize()
            tic = time.perf_counter()
            run(st)
            torch.cuda.synchronize()
            turns[kind].append(1e3 * (time.perf_counter() - tic) / chunk)
        log(f"tracing: host ms a step with the tracer off {turns['off']}, on "
            f"{turns['on']}; graphs {sorted(tr.state_graphs(st).graphs)}; on "
            f"{card}")
    finally:
        tracing.enable(False)
    del tr, st
    torch.cuda.empty_cache()
    return {"stamps_a_replayed_chunk": on_stamps, "phase_counts":
            n_card.tolist(), "attribution": attribution,
            "host_ms_a_step": turns}


def main() -> None:
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"nvidia-smi failed: {smi.stderr.strip()}"
    )
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} ({card})")

    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.ops import _build
    from virus_nerf_tpu_torch.ops.hash_encoder import HashGridSpec
    from virus_nerf_tpu_torch.quality_run import subset
    from virus_nerf_tpu_torch.training.trainer import Trainer

    wrappers = kernel_wrappers()

    # ---- 1. build
    tic = time.perf_counter()
    lib_path = _build.build_library()
    _build.library()
    log(f"build: {lib_path.name} in {time.perf_counter() - tic:.1f} s")
    ptxas_report(lib_path)

    # ---- 2. the segment sums on synthetic keys
    for case in bench_segment_cases(dev):
        check_segment_sum(*case, layout="ts")
    for case in rows_segment_cases(dev):
        check_segment_sum(*case, layout="rows")
    skew = {}
    for layout in ("ts", "rows", "tsf"):
        uni, hot = (check_segment_sum(*case, layout=layout)
                    for case in skew_segment_cases(dev, layout))
        log(f"segment_sum[{layout}] 700,000 samples on one row: "
            f"{hot['ms'] / uni['ms']:.2f}x the time on uniform keys")
        skew[layout] = {"one_row_700000_ms": hot["ms"],
                        "uniform_917504_ms": uni["ms"]}
        check_out_of_range(dev, layout)

    # ---- 3. the bench path
    cfg = bench_config()
    dataset, scene, _ = make_synthetic_dataset(
        n_images=16, img_wh=(160, 120), device=dev
    )
    trainer = Trainer(cfg, dataset, scene=scene, device=dev)
    state = trainer.init_state()
    bench_table_n = state.model.pos_table.numel()
    # the positions each training step feeds the model (the last one is kept)
    seen = {}
    hook = state.model.register_forward_pre_hook(
        lambda mod, args: seen.update(xyz=args[0].detach())
    )
    torch.cuda.synchronize()
    reset_counts(wrappers)
    tic = time.perf_counter()
    state = trainer.train(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    bench_launches = read_counts(wrappers)
    hook.remove()
    step_s = check_training("bench path", trainer, state, 48, 16)
    log(f"bench path: {state.step} steps in {wall:.2f} s (incl. first-step "
        f"warm-up); steady state steps 16-48: {1e3 * step_s:.2f} ms/step, "
        f"{cfg.training.batch_size / step_s:.0f} rays/s on {card}")
    log(f"bench path: kernel launches {bench_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_launched("bench path", bench_launches, ("segment_sum", "fused_adam"))
    check_adam_per_step("bench path", bench_launches, 48)
    check_marches("bench path", bench_launches)
    if bench_launches["march_select"] != 48:
        fail(f"bench path: {bench_launches['march_select']} march launches "
             f"over 48 steps, want one a step")
    bench_step_launches = launches_per_step(trainer, state)
    log(f"bench path: {bench_step_launches:.1f} CUDA kernel launches a step "
        f"over steps 48-56 (host profile)")
    # the fused march's inputs at the bench path's shapes (phase 21): its
    # own S, the default configuration's S = 256 (the ETHZ run's march),
    # and a full grid on which every long chord overflows
    march_cases = [
        march_case("bench, S=128", cfg, dataset, state.grid.occ_bool, dev),
        march_case("constant, S=256", cfg, dataset, state.grid.occ_bool, dev,
                   S=256),
        march_case("full grid, S=256", cfg, dataset, state.grid.occ_bool, dev,
                   S=256, full=True),
    ]

    # ---- 4. B1 at the keys of the bench path's last step
    b1 = b1_at_last_step("bench path", state, seen["xyz"], dev)
    del trainer, state, dataset, seen
    torch.cuda.empty_cache()

    # ---- 5. fused Adam at 2^21 and at both tables' sizes; bf16 parameters
    xor_table_n = HashGridSpec.create(levels=16, feat_dim=2, max_res=1024,
                                      max_params=2**19).total_params
    adam = {n: check_adam(dev, f"n={n}", [((n,), torch.float32)])
            for n in (1 << 21, bench_table_n, xor_table_n)}
    adam_bf16 = check_adam(dev, f"n={xor_table_n}", [((xor_table_n,), torch.bfloat16)])

    # ---- 6. small configs on the card against the CPU
    reference_step(dev, "additive")
    reference_step(dev, "xor")

    # ---- 7. the XOR path: train, then evaluate the map
    wide = ["--hash-levels", "16", "--hash-feats", "2", "--steps", "32",
            "--eval-every", "8"]
    _, _, state, xor_launches, xyz = run_quality_path(
        "XOR path", ["--hash-variant", "xor", *wide], wrappers, card)
    check_launched("XOR path", xor_launches, ("segment_sum_rows", "fused_adam"))
    check_adam_per_step("XOR path", xor_launches, 32)
    check_marches("XOR path", xor_launches)

    # ---- 8. B3 at the keys of the XOR path's last step
    xor_cases = xor_segment_cases(state.model, xyz, dev)
    if [c[0] for c in xor_cases] != ["xor_merged_dense", "xor_hashed_group"]:
        fail(f"unexpected XOR backward streams {[c[0] for c in xor_cases]}")
    b3 = sum_results([check_segment_sum(*case, layout="rows") for case in xor_cases])
    del state, xyz, xor_cases
    torch.cuda.empty_cache()

    # ---- 9. the slabs path: the JAX package's own layout, float32
    _, _, state, slabs_launches, xyz = run_quality_path(
        "slabs path", ["--hash-forward", "slabs", "--hash-backward", "factors",
                       *wide], wrappers, card)
    check_launched("slabs path", slabs_launches,
                   ("segment_sum_factors", "widen_slabs", "fused_adam"))
    check_adam_per_step("slabs path", slabs_launches, 32)
    check_marches("slabs path", slabs_launches)
    # B2 on every leaf of the slabs model in one launch (the table and the
    # five MLP weights), with a float32 table and with the bfloat16 mode's
    # bf16 one
    leaves = [(tuple(q.shape), q.dtype) for q in state.model.parameters()]
    adam_leaves = check_adam(dev, "slabs model", leaves)
    adam_leaves_bf16 = check_adam(dev, "slabs model, bf16 table",
                                  [(leaves[0][0], torch.bfloat16), *leaves[1:]])

    # ---- 10. B4 at the keys of the slabs path's last step (the route's
    # bf16 factors, and float32), B5 on the trained table
    b4 = {}
    for dtype in (torch.bfloat16, torch.float32):
        cases = factor_segment_cases(state.model, xyz, dev, dtype)
        if [c[0] for c in cases] != ["factors_merged_dense",
                                     "factors_hashed_group"]:
            fail(f"unexpected factor streams {[c[0] for c in cases]}")
        b4[dtype] = sum_results([check_segment_sum(*case, layout="tsf")
                                 for case in cases])
    b5_groups = {case[0]: check_widen(*case) for case in slab_group_cases(state.model)}
    b5 = sum_results(list(b5_groups.values()))
    log(f"widen_slabs per forward ({len(b5_groups)} groups): kernel "
        f"{b5['ms']:.4f} ms (device {b5['device_ms']:.4f}) plain {b5['plain_ms']:.4f} ms table[idx].to(bf16) "
        f"{b5['library_ms']:.4f} ms bound {b5['bound_ms']:.4f} ms")
    del state, xyz
    torch.cuda.empty_cache()

    # ---- 11. the new routes and the compute modes, card against CPU; the
    # XOR hash in the mixed and bfloat16 modes with B3 at its step's keys
    reference_step(dev, "additive", hash_forward="slabs", hash_backward="factors")
    reference_step(dev, "additive", "mixed", hash_forward="slabs",
                   hash_backward="factors")
    reference_step(dev, "additive", "bfloat16")
    xor_modes_launches = {k: 0 for k in wrappers}
    b3_modes = {}
    for mode in ("mixed", "bfloat16"):
        reset_counts(wrappers)
        model, xyz = reference_step(dev, "xor", mode)
        for k, v in read_counts(wrappers).items():
            xor_modes_launches[k] += v
        log(f"XOR {mode} step on the card: kernel launches {read_counts(wrappers)}")
        if model.pos_table.dtype != (torch.bfloat16 if mode == "bfloat16"
                                     else torch.float32):
            fail(f"XOR {mode}: table {model.pos_table.dtype}")
        b3_modes[mode] = sum_results([
            check_segment_sum(*case, layout="rows")
            for case in xor_segment_cases(model, xyz, dev)])
    check_launched("XOR mixed/bfloat16 steps", xor_modes_launches,
                   ("segment_sum_rows", "fused_adam"))
    check_adam_per_step("XOR mixed/bfloat16 steps", xor_modes_launches, 2)
    check_marches("XOR mixed/bfloat16 steps", xor_modes_launches)
    del model, xyz

    # ---- 12. the scale-1.0 path: 16 of 24 images, then the held-out 8
    cfg = scale1_config()
    dataset, scene, info = make_synthetic_dataset(
        n_images=24, img_wh=(160, 120), device=dev
    )
    sel_train = np.arange(24) % 3 != 0
    train_ds, test_ds = subset(dataset, sel_train), subset(dataset, ~sel_train)
    trainer = Trainer(cfg, train_ds, scene=scene, device=dev)
    state, scale1_launches, xyz, _ = run_path(
        "scale-1.0 path", trainer, 48, 16, wrappers, card)
    b1_scale1 = b1_at_last_step("scale-1.0 path", state, xyz, dev)
    scale1_step_launches = launches_per_step(trainer, state)
    log(f"scale-1.0 path: {scale1_step_launches:.1f} CUDA kernel launches a "
        f"step over steps 48-56 (host profile)")
    lattice = check_lattice(dev, train_ds, cfg)
    # the march at scale 1.0 (exponential, the one-row VIRUS grid read past
    # its end) and the evaluator's chunk (8192 rays, S = 512, no jitter)
    march_cases += [
        march_case("scale 1.0, one-row grid", cfg, train_ds,
                   state.grid.occ_bool, dev),
        march_case("evaluator chunk", cfg, train_ds, state.grid.occ_bool, dev,
                   n=cfg.evaluation.batch_size,
                   S=cfg.evaluation.max_samples_per_ray, zero_noise=True),
    ]
    evaluate_scale1(trainer, state, test_ds, scene, info["img_wh"], card)
    del trainer, state, xyz, dataset, train_ds, test_ds
    torch.cuda.empty_cache()

    # ---- 13. the NGP path: distortion, closest pixels, real-time simulation
    cfg = ngp_config()
    dataset, scene, _ = make_synthetic_dataset(
        n_images=16, img_wh=(160, 120), device=dev
    )
    trainer = Trainer(cfg, dataset, scene=scene, device=dev)
    state, ngp_launches, _, wall = run_path("NGP path", trainer, 32, 16,
                                            wrappers, card)
    if state.grid.occ_bool.shape != (2, 128**3):
        fail(f"NGP path: grid {tuple(state.grid.occ_bool.shape)}, want 2 x 128^3")
    # real-time simulation: no image taken after the run's end was drawn
    # (the "closest" statistics count the batches that held each image)
    counts = state.uss_stats.counts.cpu().numpy()
    late = dataset.times.cpu().numpy() > wall
    log(f"NGP path: {wall:.2f} s of training; images drawn "
        f"{np.flatnonzero(counts).tolist()}, images taken after {wall:.2f} s "
        f"{np.flatnonzero(late).tolist()}")
    if counts.sum() <= 0 or counts[late].any():
        fail("NGP path: real-time simulation drew an image not yet taken, or "
             "the USS statistics were never updated")
    if "loss_distortion" not in trainer.logs:
        fail("NGP path: no distortion term in the loss")
    log(f"NGP path: threshold {float(state.grid.threshold):.4f}, USS "
        f"statistics updated {int(state.uss_stats.counts.sum())} times, "
        f"distortion term last {trainer.logs['loss_distortion'][-1]:.3e}")
    # after the real-time checks: these steps draw from every image
    ngp_step_launches = launches_per_step(trainer, state)
    log(f"NGP path: {ngp_step_launches:.1f} CUDA kernel launches a step over "
        f"steps 32-40 (host profile)")
    march_cases.append(march_case("NGP, two-row grid", cfg, dataset,
                                  state.grid.occ_bool, dev))
    del trainer, state, dataset
    torch.cuda.empty_cache()

    # ---- 14. card against CPU at scale 1.0, with the NGP grid, distortion
    reference_step(dev, "additive", scale=1.0)
    reference_step(dev, "additive", scale=1.0, grid_type="ngp")
    reference_step(dev, "additive", distortion=1e-2)

    # ---- 15. the ETHZ run through run.py; 22. the evaluator's remainder
    # on its map; 23. its final evaluation sampled and dense; 25. without
    # matplotlib
    with tempfile.TemporaryDirectory() as tmp:
        ethz_launches, b1_ethz, trainer, state, save = ethz_run(
            dev, wrappers, card, tmp)
        density_launches, export_launches, remainder = ethz_remainder(
            trainer, state, save, wrappers, card, tmp)
        budget = {}
        budget_ethz_launches, budget["ethz"] = eval_budget(
            "ETHZ", trainer, state, wrappers, card)
        e1 = {"ethz": check_slice_scan("ETHZ", trainer, card)}
        e2 = check_nn_search("ETHZ", trainer, state, card)
        no_matplotlib_check(trainer, state, tmp)
        # the ETHZ room's Config() and training split, for phase 26
        ethz_case = (trainer.cfg, trainer.train_dataset, trainer.scene)
        del trainer, state
    torch.cuda.empty_cache()

    # ---- 16. the RH2 run through run.py at scale 1.0; 23. its final
    # evaluation sampled and dense; 17. PSO over it
    with tempfile.TemporaryDirectory() as tmp:
        root, rh2_launches, rh2_step_launches, b1_rh2, trainer, state = rh2_run(
            dev, wrappers, card, tmp)
        torch.cuda.empty_cache()
        budget_rh2_launches, budget["rh2"] = eval_budget(
            "RH2", trainer, state, wrappers, card)
        e1["rh2"] = check_slice_scan("RH2", trainer, card)
        del trainer, state
        torch.cuda.empty_cache()
        pso_launches, pso_step_launches, pso_steps = pso_run(
            root, wrappers, card, tmp)
    torch.cuda.empty_cache()

    # ---- 18. the triplane path
    tri_launches, adam_tri, planes_bwd = triplane_run(dev, wrappers, card)
    torch.cuda.empty_cache()

    # ---- 19. data parallelism on NCCL
    with tempfile.TemporaryDirectory() as tmp:
        dp_launches, dp1_launches, b1_dp, march_dp, dp_times, dp_turns = dp_run(
            dev, wrappers, card, tmp)
    torch.cuda.empty_cache()

    # ---- 20. the population evaluators
    pop = population_run(dev, wrappers, card)
    torch.cuda.empty_cache()

    # ---- 24. the 2-D (pop, data) population nesting
    with tempfile.TemporaryDirectory() as tmp:
        mesh_launches, mesh_steps, mesh_times = mesh2d_run(dev, wrappers,
                                                           card, tmp)
    torch.cuda.empty_cache()

    # ---- 21. the fused march against its plain version at the paths' shapes
    march = {name: check_march(name, args, kw) for name, args, kw in march_cases}
    del march_cases
    torch.cuda.empty_cache()

    # ---- 26. the chunk as CUDA graphs: graph against eager bit for bit,
    # then a step of each in turns
    graph_launches = {}
    for name, *case in graph_cases(dev, ethz_case):
        graph_launches[name] = graph_against_eager(name, *case, wrappers, dev)
    del ethz_case
    turns = {name: graph_turns(name, cfg, ds, scene, wrappers, dev, card)
             for name, cfg, ds, scene, *_ in graph_cases(dev, (None,) * 3)[:2]}

    # ---- 27. the tracer's phase stamps
    traced = tracing_run(dev, wrappers, card)
    torch.cuda.empty_cache()

    # ---- 30. the hash corners forward against its plain version
    h1 = check_hash_corners(dev, card)

    # ms: the kernel's calls of one step at the keys (B1, B3, B4) or table
    # (B5) of its path; fused Adam on the 16 x 2 hash table; one march at
    # the default configuration's S = 256 (each case under "cases")
    paths = {"bench": bench_launches, "xor": xor_launches,
             "slabs": slabs_launches, "scale1": scale1_launches,
             "ngp": ngp_launches, "ethz": ethz_launches, "rh2": rh2_launches,
             "pso": pso_launches, "xor_modes": xor_modes_launches,
             "triplane": tri_launches, "dp": dp_launches,
             "dp_scale1": dp1_launches,
             "population": pop["population_launches"],
             "weights_eval": pop["weights_launches"],
             "mesh_2d": mesh_launches, "ethz_density": density_launches,
             "ethz_export": export_launches,
             "eval_budget": {k: budget_ethz_launches[k] + budget_rh2_launches[k]
                             for k in wrappers},
             **{f"graph {name}": c for name, c in graph_launches.items()}}
    steps = {"bench": 48, "xor": 32, "slabs": 32, "scale1": 48, "ngp": 32,
             "ethz": 48, "rh2": 48, "pso": pso_steps, "xor_modes": 2,
             "triplane": 48, "dp": 16, "dp_scale1": 8,
             "population": pop["population_steps"],
             "weights_eval": pop["weights_steps"], "mesh_2d": mesh_steps,
             "graph bench": 32, "graph scale 1.0": 29, "graph XOR": 16,
             "graph slabs+factors mixed": 16, "graph tri-plane": 16,
             "graph ETHZ Config()": 16}
    # a step's launches of the training paths: the RH2 and PSO runs'
    # evaluations march too, so theirs are counted in the training steps
    # alone
    # the tracer is off on every path: no stamp launched
    stamped = {p: c["trace_stamp"] for p, c in paths.items() if c["trace_stamp"]}
    if stamped:
        fail(f"stamps launched with the tracer off: {stamped}")
    check_gt_scans(paths)
    check_nn_searches(paths)
    check_corner_encodes(paths)
    step_counts = {p: c for p, c in dict(
        paths, rh2=rh2_step_launches, pso=pso_step_launches).items()
        if p in steps}

    def entry(name, key, source, replaces, main_paths, result, **extra):
        return {"name": name, "route": "cuda",
                "source": f"virus_nerf_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(paths[p][key] for p in main_paths),
                "launches_by_path": {p: c[key] for p, c in paths.items()},
                "launches_per_step": {p: c[key] / steps[p]
                                      for p, c in step_counts.items()},
                **result, **extra}

    print(json.dumps({"kernels": [
        entry("segment_sum_sorted", "segment_sum", "segment_sum.cu",
              "virus_nerf_tpu/ops/segment_sum_pallas.py:231",
              ["bench", "scale1", "ngp", "ethz", "rh2", "pso", "dp",
               "dp_scale1", "population", "weights_eval", "mesh_2d",
               "graph bench", "graph scale 1.0", "graph ETHZ Config()"], b1,
              scale1_step=b1_scale1, ethz_step=b1_ethz, rh2_step=b1_rh2,
              dp_step=b1_dp, mesh_2d_seconds=mesh_times, **skew["ts"]),
        entry("fused_adam", "fused_adam", "fused_adam.cu",
              "virus_nerf_tpu/ops/fused_adam.py:37", list(paths),
              adam[xor_table_n], bf16_params=adam_bf16,
              all_leaves=adam_leaves, all_leaves_bf16_table=adam_leaves_bf16,
              triplane_leaves=adam_tri, graph_turns=turns,
              dp_graph={"times": dp_times, "turns": dp_turns},
              population_graphs={k: v for k, v in pop.items()
                                 if not k.endswith("_launches")}),
        entry("group_segment_sum_t_sorted", "segment_sum_rows",
              "segment_sum_rows.cu",
              "virus_nerf_tpu/ops/segment_sum_pallas.py:101",
              ["xor", "xor_modes", "graph XOR"], b3, xor_mixed_step=b3_modes["mixed"],
              xor_bfloat16_step=b3_modes["bfloat16"], **skew["rows"]),
        entry("group_segment_sum_tsf_sorted", "segment_sum_factors",
              "segment_sum_factors.cu",
              "virus_nerf_tpu/ops/segment_sum_pallas.py:333",
              ["slabs", "graph slabs+factors mixed"],
              b4[torch.bfloat16], float32_factors=b4[torch.float32],
              **skew["tsf"]),
        entry("widen_slabs_group", "widen_slabs", "widen_slabs.cu",
              "virus_nerf_tpu/ops/widen_pack_pallas.py:90",
              ["slabs", "ethz_density", "graph slabs+factors mixed"], b5, density_probes=remainder,
              groups_ms={k: v["ms"] for k, v in b5_groups.items()},
              groups_device_ms={k: v["device_ms"] for k, v in b5_groups.items()}),
        # the port's own kernel: the march from the cube hits to the
        # layout (lattice, probe, selection), which has no Pallas
        # counterpart; its standalone lattice entry point is off the paths
        entry("march_select", "march_select", "march.cu",
              "virus_nerf_tpu/ops/ray_march.py:88-158, :368-451",
              list(paths), march["constant, S=256"], cases=march,
              evaluation_sample_budget=budget,
              dp_scale1_check=march_dp, standalone_lattice=lattice,
              launches_a_step={"bench": bench_step_launches,
                               "scale1": scale1_step_launches,
                               "ngp": ngp_step_launches},
              pallas_counterpart=None),
        # the tracer's phase stamp: off every path (the tracer is off)
        entry("trace_stamp", "trace_stamp", "trace_stamp.cu", None, [],
              traced),
        # the port's own kernel: the GT slice scan, numpy on the host in
        # the JAX package; one launch a depth evaluation on the card
        entry("slice_scan", "slice_scan", "slice_scan.cu", None,
              list(EVALUATING), e1["ethz"], rh2=e1["rh2"],
              numpy_counterpart="virus_nerf_tpu/data/scene.py:101"),
        # the port's own kernel: the NND metrics' nearest-neighbour search,
        # numpy on the host in the JAX package; one launch an nn_metrics
        # call on the card
        entry("nn_search", "nn_search", "nn_search.cu", None,
              list(EVALUATING), e2,
              numpy_counterpart="virus_nerf_tpu/evaluation/geometry.py:17"),
        # the port's own kernel: the additive hash's corners forward, the
        # plain code's gather and cuBLAS GEMV before it; one launch a
        # corners encode on the card
        entry("hash_corners", "hash_corners", "hash_corners.cu", None,
              list(CORNERS), h1),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
