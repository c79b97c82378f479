"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it finishes; any failure exits non-zero:

1. build the CUDA kernels from ``virus_nerf_tpu_torch/csrc`` (nvcc, one
   process per source, all started together);
2. hold each kernel against its plain PyTorch version (and the segment sums
   against a float64 sum) on the card and time them (CUDA events, in turns
   kernel/plain/library/library/plain/kernel): the transposed segment sum
   (B1) at the kernel-CI cases of bench.py, the row-major segment sum (B3)
   on uniform, skewed, padded-row and odd-group keys;
3. the bench path: ``Trainer`` at the bench configuration (bench.py:311-348:
   synthetic scene 16 x 160x120, 4096 rays, 8 x F=4 additive hash levels of
   2^19 rows, 128^3 VIRUS grid updated every 8 steps, S=128, budget
   4096*28) for 48 steps from a seeded random init: finite, falling loss;
   B1 and B2 launched on the path;
4. B1 against its plain version, and timed, on the two streams of the hash
   backward at the positions of the bench path's last step;
5. fused Adam (B2) against its plain version at 2^21 elements and at both
   hash tables' sizes;
6. one grid update + train step of a small config on the card against the
   same step on the CPU (the plain versions), for each hash variant;
7. the XOR path: ``python -m virus_nerf_tpu_torch.quality_run --hash-variant
   xor --hash-levels 16 --hash-feats 2`` (the reference's own 16 x F=2 XOR
   hash of 2^19 rows, 5,710,032 rows; synthetic scene 24 x 160x120, every
   third image held out; the bench's batch, march, budget and grid) for 32
   steps from a seeded init, then ``Evaluator.evaluate`` on the 8 held-out
   images: finite, falling loss, finite NND of the NeRF/ToF/USS scans
   against the GT scan; B2 and B3 launched on the path;
8. B3 against its plain version and a float64 sum, and timed, on the two
   streams of the XOR backward at the positions of the XOR path's last
   step (the merged dense levels and the hashed group of G = 10).

The line before the last is the card's name and power limit (nvidia-smi);
before it, one JSON line with the kernels' results.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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


def _ops():
    from virus_nerf_tpu_torch.ops import segment_sum as ss

    # layout -> (kernel wrapper, plain version, values as (G, K, width))
    return {
        "ts": (ss.segment_sum_sorted, ss.segment_sum_sorted_plain,
               lambda v: v.transpose(1, 2)),
        "rows": (ss.group_segment_sum_t_sorted,
                 ss.group_segment_sum_t_sorted_plain, lambda v: v),
    }


def check_segment_sum(name, vals, keys, R, layout: str = "ts"):
    """Kernel against its plain version (and both against a float64 sum) on
    one case.  The tolerance per output is 4 * eps32 * sqrt(n) * sum|v| over
    the row's n samples: rounding errors of a serial or atomic sum grow like
    a random walk over the partial sums, each at most sum|v|, so the bound
    keeps its margin on long segments while a dropped or misplaced sample
    still fails; an empty row must be exactly 0.  Returns a dict of
    max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by."""
    kernel, plain, rows_view = _ops()[layout]
    G, K = keys.shape
    got = kernel(vals, keys, R)
    want = plain(vals, keys, R)
    exact = plain(vals.double(), keys, R)
    counts = torch.stack([torch.bincount(keys[g].long(), minlength=R)
                          for g in range(G)]).double()  # (G, R)
    tol = (4.0 * torch.finfo(torch.float32).eps * counts.sqrt()[:, None, :]
           * plain(vals.abs().double(), keys, R))
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    # kernel vs plain: both are float32 sums in another order
    ratio = float((diff / (2 * tol)).nan_to_num(posinf=float("inf")).max())
    ratio_exact = float(((got.double() - exact).abs() / tol)
                        .nan_to_num(posinf=float("inf")).max())
    width = rows_view(vals).shape[2]
    shape_ok = tuple(got.shape) == (G, width, R)
    ok = shape_ok and ratio <= 1.0 and ratio_exact <= 1.0

    # the library call: one index_add_ of the (G*K, width) values into a
    # (G*R, width) buffer (index and layout prepared outside the timing)
    src = rows_view(vals).reshape(G * K, width).contiguous()
    idx = (keys.long() + R * torch.arange(G, device=keys.device)[:, None]).reshape(-1)
    buf = torch.zeros((G * R, width), device=vals.device)
    ms, plain_ms, lib_ms = time_turns([
        lambda: kernel(vals, keys, R),
        lambda: plain(vals, keys, R),
        lambda: buf.index_add_(0, idx, src),
    ])
    b_ms, b_by = bound_ms(4.0 * (vals.numel() + keys.numel() + G * width * R),
                          vals.numel())
    top = torch.sort(counts.reshape(-1), descending=True).values
    share = float(top[:max(1, G * R // 100)].sum()) / keys.numel()
    log(f"segment_sum[{layout}] {name}: G={G} width={width} K={K} n_rows={R} "
        f"longest segment {int(top[0])}, top 1% rows hold {share:.3f} of the "
        f"samples; max_abs_err {err:.3e}, err/tol {ratio:.3f} vs plain, "
        f"{ratio_exact:.3f} vs float64 (tol 4*eps32*sqrt(n)*sum|v| per row); "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms index_add_ {lib_ms:.4f} "
        f"ms bound {b_ms:.4f} ms ({b_by}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"segment_sum[{layout}] {name} disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}


def sum_results(results):
    """One kernel entry over several calls (one step's calls): times and
    bounds add, the error is the largest."""
    out = {k: sum(r[k] for r in results)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in results)
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                     for r in results) else "operations"
    return out


# ------------------------------------------------------------ fused Adam (B2)
def check_adam(dev, sizes):
    """Fused Adam against its plain version at each size; returns
    {n: result dict}."""
    from virus_nerf_tpu_torch.ops.fused_adam import (
        adam_scalars,
        adam_update_,
        adam_update_plain_,
    )

    out = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for n in sizes:
        p, g = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
        mu = torch.randn(n, generator=gen, device=dev) * 0.1
        nu = torch.rand(n, generator=gen, device=dev) * 0.01
        args = adam_scalars(1e-2, 0.9, 0.999, 3) + (0.9, 0.999, 1e-15)
        a = [x.clone() for x in (p, mu, nu)]
        b = [x.clone() for x in (p, mu, nu)]
        c = [x.clone() for x in (p, mu, nu)]
        adam_update_(a[0], g, a[1], a[2], *args)
        adam_update_plain_(b[0], g, b[1], b[2], *args)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(a, b))
        ok = err <= 1e-6  # the bench's gate for the TPU kernel (bench.py:276)
        step = torch.tensor(3.0, device=dev)
        ms, plain_ms, lib_ms = time_turns([
            lambda: adam_update_(a[0], g, a[1], a[2], *args),
            lambda: adam_update_plain_(b[0], g, b[1], b[2], *args),
            # the library call: PyTorch's fused Adam on one tensor
            lambda: torch._fused_adam_(
                [c[0]], [g], [c[1]], [c[2]], [], [step], lr=1e-2, beta1=0.9,
                beta2=0.999, weight_decay=0.0, eps=1e-15, amsgrad=False,
                maximize=False),
        ])
        # reads p, g, mu, nu and writes p, mu, nu; ~12 float32 operations
        # per element
        b_ms, b_by = bound_ms(7 * 4.0 * n, 12.0 * n)
        log(f"fused_adam n={n}: max_abs_err={err:.3e} (tol 1e-6) kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms torch._fused_adam_ "
            f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"fused_adam n={n} disagrees with its plain version")
        out[n] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    return out


# ------------------------------------------------------- small reference
def reference_step(dev, hash_variant: str, ref=torch.device("cpu")):
    """One grid update + train step of a small config on the card and on
    the CPU (plain versions) from the same weights and draws."""
    from virus_nerf_tpu_torch.configs.config import Config
    from virus_nerf_tpu_torch.data.dataset import Batch, sample_batch
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.training.trainer import Trainer

    cfg = Config()
    m, t = cfg.model, cfg.training
    m.hash_variant = hash_variant
    # tables of 8 x 4 (additive) or 16 x 2 (XOR) levels of up to 2^16 rows:
    # over 2^20 elements, so the Adam kernel runs
    m.hash_levels, m.hash_features_per_level = (
        (16, 2) if hash_variant == "xor" else (8, 4)
    )
    m.hash_log2_T, m.hash_max_res, m.grid_size = 16, 256, 32
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
        runs.append((Trainer(cfg, ds, scene=scene, device=d), ds))
    (tc, dsc), (tg, _) = runs
    sc = tc.init_state(0)
    sg = tg.init_state(0)
    sg.model.load_state_dict({k: v.to(dev) for k, v in sc.model.state_dict().items()})
    sg.grid = type(sc.grid)(sc.grid.occ_3d_grid.to(dev), sc.grid.occ_bool.to(dev), 0)

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

    tc.grid_update_on(sc, ray_b, nerf_b, pos_noise)
    tg.grid_update_on(sg, to(ray_b), to(nerf_b), pos_noise.to(dev))
    grid_err = float((sg.grid.occ_3d_grid.cpu() - sc.grid.occ_3d_grid).abs().max())
    # the step marches both on the same boolean grid
    sg.grid = type(sc.grid)(sc.grid.occ_3d_grid.to(dev), sc.grid.occ_bool.to(dev), 1)
    mc = tc.train_step_on(sc, batch, noise)
    mg = tg.train_step_on(sg, to(batch), noise.to(dev))
    loss_c, loss_g = float(mc["loss"]), float(mg["loss"])
    rel = abs(loss_g - loss_c) / abs(loss_c)
    diff = (sg.model.pos_table.detach().cpu() - sc.model.pos_table.detach()).abs()
    flipped = float((diff > 1e-6).float().mean())
    log(f"reference step ({hash_variant} small config, card vs CPU): grid "
        f"max_abs_err {grid_err:.3e} (tol 1e-5), loss {loss_g:.6f} vs "
        f"{loss_c:.6f} rel {rel:.2e} (tol 1e-4), rm {int(mg['rm_samples'])} vs "
        f"{int(mc['rm_samples'])}, table entries off by > 1e-6: {flipped:.2e} "
        f"(tol 2e-3: Adam sign steps of near-zero gradients)")
    # float32 in another op order on each device; the table differs only
    # where a near-zero gradient took the other sign at Adam step 1
    if not (grid_err <= 1e-5 and rel <= 1e-4 and flipped <= 2e-3
            and float(diff.max()) <= 2 * t.lr * (1 + 1e-5)):
        fail(f"the {hash_variant} small-config step on the card disagrees "
             f"with the CPU")


# ---------------------------------------------------------------- the paths
def bench_config():
    from virus_nerf_tpu_torch.configs.config import Config

    cfg = Config()  # bench.py:311-346
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


def reset_counts(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counts(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


def check_training(name, trainer, state, n_steps, first_steady):
    """Finite, falling loss over the run; returns steady-state ms/step from
    the chunk-end times (each after a device sync) after ``first_steady``."""
    logs = trainer.logs
    losses = np.asarray(logs["loss"])
    steps = np.asarray(logs["step"])
    times = np.asarray(logs["time"])
    i0, i1 = int(np.where(steps == first_steady - 1)[0][0]), len(steps) - 1
    step_s = (times[i1] - times[i0]) / (steps[i1] - steps[i0])
    log(f"{name}: loss first {losses[0]:.4f} last {losses[-1]:.4f}; mean of "
        f"the first 8 steps {losses[:8].mean():.4f}, the last 8 "
        f"{losses[-8:].mean():.4f}; psnr last {logs['psnr'][-1]:.2f}; "
        f"rm_samples last {int(logs['rm_samples'][-1])}; vr_samples last "
        f"{int(logs['vr_samples'][-1])}; overflow last "
        f"{int(logs['overflow'][-1])}; grid updates {state.grid.update_step}; "
        f"occupied cells {float(state.grid.occ_bool.float().mean()):.4f}")
    if state.step != n_steps or len(losses) != n_steps:
        fail(f"{name}: ran {state.step} steps, logged {len(losses)}, want {n_steps}")
    if not np.all(np.isfinite(losses)):
        fail(f"{name}: non-finite loss")
    if not losses[-8:].mean() < losses[:8].mean():
        fail(f"{name}: loss did not fall over {n_steps} steps")
    want_updates = -(-n_steps // trainer.grid_update_interval)
    if state.grid.update_step != want_updates:
        fail(f"{name}: {state.grid.update_step} grid updates, want {want_updates}")
    if not torch.isfinite(state.model.pos_table).all():
        fail(f"{name}: non-finite hash table")
    return step_s


def check_launched(name, launches, kernels):
    for k in kernels:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the {name}")


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

    from virus_nerf_tpu_torch import quality_run
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.models.ngp import NGPModel
    from virus_nerf_tpu_torch.ops import _build
    from virus_nerf_tpu_torch.ops.fused_adam import adam_update_
    from virus_nerf_tpu_torch.ops.hash_encoder import HashGridSpec
    from virus_nerf_tpu_torch.ops.segment_sum import (
        group_segment_sum_t_sorted,
        segment_sum_sorted,
    )
    from virus_nerf_tpu_torch.training.trainer import Trainer

    wrappers = {"segment_sum": segment_sum_sorted, "fused_adam": adam_update_,
                "segment_sum_rows": group_segment_sum_t_sorted}

    # ---- 1. build
    tic = time.perf_counter()
    lib_path = _build.build_library()
    _build.library()
    log(f"build: {lib_path.name} in {time.perf_counter() - tic:.1f} s")

    # ---- 2. the segment sums on synthetic keys
    for case in bench_segment_cases(dev):
        check_segment_sum(*case, layout="ts")
    for case in rows_segment_cases(dev):
        check_segment_sum(*case, layout="rows")

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

    # ---- 4. B1 at the keys of the bench path's last step
    slice_cases = slice_segment_cases(state.model, seen["xyz"], dev)
    if [c[0] for c in slice_cases] != ["slice_merged_dense", "slice_hashed_group"]:
        fail(f"unexpected hash backward streams {[c[0] for c in slice_cases]}")
    b1 = sum_results([check_segment_sum(*case, layout="ts") for case in slice_cases])
    del trainer, state, dataset, seen
    torch.cuda.empty_cache()

    # ---- 5. fused Adam at 2^21 and at both tables' sizes
    xor_table_n = HashGridSpec.create(levels=16, feat_dim=2, max_res=1024,
                                      max_params=2**19).total_params
    adam = check_adam(dev, (1 << 21, bench_table_n, xor_table_n))

    # ---- 6. small configs on the card against the CPU
    reference_step(dev, "additive")
    reference_step(dev, "xor")

    # ---- 7. the XOR path: train, then evaluate the map
    args = quality_run.parse_args([
        "--hash-variant", "xor", "--hash-levels", "16", "--hash-feats", "2",
        "--steps", "32", "--eval-every", "8",
    ])
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
    xor_launches = read_counts(wrappers)
    hook.remove()
    step_s = check_training("XOR path", trainer, state, 32, 8)
    log(f"XOR path: {state.step} steps in {out['train_seconds']} s (incl. "
        f"first-step warm-up, {out['train_rays_per_sec']} rays/s); steady state "
        f"steps 8-32: {1e3 * step_s:.2f} ms/step, "
        f"{trainer.cfg.training.batch_size / step_s:.0f} rays/s; evaluation "
        f"{out['eval_seconds']:.2f} s; on {card}")
    log(f"XOR path: NeRF nn_mean z3 {out['NeRF']['nn_mean_zone3']:.4f} m, ToF "
        f"{out['ToF']['nn_mean_zone3']:.4f} m, USS "
        f"{out['USS']['nn_mean_zone3']:.4f} m; psnr {out['psnr']:.3f} ssim "
        f"{out['ssim']:.4f}")
    log(f"XOR path: kernel launches {xor_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_launched("XOR path", xor_launches, ("segment_sum_rows", "fused_adam"))
    if state.model.pos_table.shape != (5_710_032, 2):
        fail(f"XOR table shape {tuple(state.model.pos_table.shape)}")
    nnd = [out[s][k] for s in ("NeRF", "ToF", "USS") for k in out[s]]
    if not (np.all(np.isfinite(nnd)) and np.isfinite(out["psnr"])):
        fail(f"non-finite evaluation: {out}")

    # ---- 8. B3 at the keys of the XOR path's last step
    xor_cases = xor_segment_cases(state.model, seen["xyz"], dev)
    if [c[0] for c in xor_cases] != ["xor_merged_dense", "xor_hashed_group"]:
        fail(f"unexpected XOR backward streams {[c[0] for c in xor_cases]}")
    b3 = sum_results([check_segment_sum(*case, layout="rows") for case in xor_cases])

    # ms: the segment sums' calls of one step's hash backward at the keys of
    # their path; fused Adam on the XOR path's hash table
    b2 = adam[xor_table_n]
    print(json.dumps({"kernels": [
        {"name": "segment_sum_sorted", "route": "cuda",
         "source": "virus_nerf_tpu_torch/csrc/segment_sum.cu",
         "replaces": "virus_nerf_tpu/ops/segment_sum_pallas.py:231",
         "launches": bench_launches["segment_sum"],
         "launches_by_path": {"bench": bench_launches["segment_sum"],
                              "xor": xor_launches["segment_sum"]}, **b1},
        {"name": "fused_adam", "route": "cuda",
         "source": "virus_nerf_tpu_torch/csrc/fused_adam.cu",
         "replaces": "virus_nerf_tpu/ops/fused_adam.py:37",
         "launches": bench_launches["fused_adam"] + xor_launches["fused_adam"],
         "launches_by_path": {"bench": bench_launches["fused_adam"],
                              "xor": xor_launches["fused_adam"]}, **b2},
        {"name": "group_segment_sum_t_sorted", "route": "cuda",
         "source": "virus_nerf_tpu_torch/csrc/segment_sum_rows.cu",
         "replaces": "virus_nerf_tpu/ops/segment_sum_pallas.py:101",
         "launches": xor_launches["segment_sum_rows"],
         "launches_by_path": {"bench": bench_launches["segment_sum_rows"],
                              "xor": xor_launches["segment_sum_rows"]}, **b3},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
