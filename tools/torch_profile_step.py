"""Step time, device profile and kernel A/B of the PyTorch port on one GPU.

    python tools/torch_profile_step.py [--hash-variant xor] [--trace PATH]
    python tools/torch_profile_step.py --hash-levels 16 --hash-feats 2 \
        [--hash-forward slabs --hash-backward factors] [--dtype mixed] \
        [--route-ab | --quick]
    python tools/torch_profile_step.py --config scale1|ngp [--quick]

At the bench configuration (``chip_smoke.bench_config``, bench.py:311-348;
with ``--hash-variant xor`` the reference's 16 x F=2 XOR hash of 2^19 rows
in its place, with ``--hash-levels``/``--hash-feats`` another additive
layout; ``--hash-forward``/``--hash-backward`` the additive hash's routes
and ``--dtype`` the compute mode; ``--config scale1`` the bench at
``model.scale = 1.0``, ``chip_smoke.scale1_config``, exponential stepping
over two cascades; ``--config ngp`` that on the NGP grid with the
distortion loss and "closest" pixels, ``chip_smoke.ngp_config`` with
real-time simulation off, so that every step draws from all images), from
a seeded random init, in one process and in this order:

1. 288 training steps (bench.py's warm-up: the grid settles);
2. 200 timed steps, grid updates included, host clock after a
   device sync (bench.py's protocol): ms/step and rays/s;
3. the skew of the segment-sum keys at one step's sample positions;
4. 8 steps under ``torch.profiler``: device time per step, top kernels
   (``--trace`` writes the Chrome trace);
5. a host-side profile of 8 steps: kernel launches and synchronising
   runtime calls per step, top operators by host time;
6. 32 steps synced at each phase boundary: ms/step per phase;
7. in-train A/B of the CUDA kernels against their plain versions,
   96 steps per arm in turns kernels/plain/plain/kernels, then
   8 profiled steps per arm.  The plain arm swaps the module globals the
   step calls (``hash_encoder.segment_sum_sorted``,
   ``hash_encoder.group_segment_sum_t_sorted``,
   ``hash_encoder.group_segment_sum_tsf_sorted``,
   ``widen.widen_slabs_group``, ``fused_adam.adam_update_leaves_`` and
   ``ray_march.march_select``) for their plain versions;
8. with ``--route-ab`` (additive hash): in-train A/B of the routes
   ``corners``+``product`` against ``slabs``+``factors`` on the same
   state, 96 steps per turn in turns corners/slabs/slabs/corners twice
   over (the host clock drifts between turns), then 8 profiled steps per
   turn in turns corners/slabs/slabs/corners (device time, top kernels),
   and a host-side profile of 8 steps per route.

``--quick`` stops after 5 (no key skew, phases or A/B): the steps and
both profiles alone, which also run on a tree without this tool's other
hooks, for a before/after comparison in one call.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
import virus_nerf_tpu_torch.ops.fused_adam as fused_adam  # noqa: E402
import virus_nerf_tpu_torch.ops.hash_encoder as hash_encoder  # noqa: E402
import virus_nerf_tpu_torch.ops.ray_march as ray_march  # noqa: E402
import virus_nerf_tpu_torch.ops.widen as widen  # noqa: E402
from virus_nerf_tpu_torch.data.dataset import sample_batch  # noqa: E402
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from virus_nerf_tpu_torch.models.renderer import render_rays  # noqa: E402
from virus_nerf_tpu_torch.ops.segment_sum import (  # noqa: E402
    group_segment_sum_t_sorted_plain,
    group_segment_sum_tsf_sorted_plain,
    segment_sum_sorted_plain,
)
from virus_nerf_tpu_torch.training.loss import compute_loss  # noqa: E402
from virus_nerf_tpu_torch.training.trainer import Trainer  # noqa: E402

WARMUP, STEPS, AB_STEPS = 288, 200, 96


def plain_kernels(on: bool):
    """Context in which the step takes the plain versions of the kernels."""
    if not on:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        hash_encoder, "segment_sum_sorted", segment_sum_sorted_plain))
    stack.enter_context(mock.patch.object(
        hash_encoder, "group_segment_sum_t_sorted",
        group_segment_sum_t_sorted_plain))
    stack.enter_context(mock.patch.object(
        hash_encoder, "group_segment_sum_tsf_sorted",
        group_segment_sum_tsf_sorted_plain))
    stack.enter_context(mock.patch.object(
        widen, "widen_slabs_group", widen.widen_slabs_group_plain))
    stack.enter_context(mock.patch.object(
        fused_adam, "adam_update_leaves_", fused_adam.adam_update_leaves_plain_))
    stack.enter_context(mock.patch.object(
        ray_march, "march_select", ray_march.march_select_plain))
    return stack


def use_routes(model, forward, backward):
    """Switch the model's additive hash routes in place."""
    model.hash_forward, model.hash_backward = forward, backward


def run_steps(trainer, state, n):
    """n steps with the grid update before every interval's first step;
    mean seconds per step, host clock after a device sync."""
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        if state.step % trainer.grid_update_interval == 0:
            trainer.grid_update(state)
        metrics = trainer.train_step(state)
    float(metrics["loss"])
    torch.cuda.synchronize()
    return (time.perf_counter() - tic) / n


# the port's kernels by a part of their device function names (every
# launch of a call: B1, B3 and B4 run a chunk and a tile launch per call)
PORT_KERNELS = {
    "B1 segment_sum_sorted": ("TransposedLoader",),
    "B2 fused_adam": ("fused_adam_kernel",),
    "B3 segment_sum_rows": ("RowLoader",),
    "B4 segment_sum_factors": ("FactorLoader",),
    "B5 widen_slabs": ("widen_slabs_kernel",),
    "L1 march_select": ("march_select_kernel",),
}


def device_profile(trainer, state, n=8, top=14, trace=None):
    """Device time per step over n steps, the top kernels, and the port's
    kernels (all their launches) per step."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_steps(trainer, state, n)
    ev = prof.key_averages()
    total = sum(e.self_device_time_total for e in ev)
    lines = [f"{e.self_device_time_total / 1e3 / n:9.3f} ms/step {e.count / n:7.1f} "
             f"calls/step  {e.key[:100]}"
             for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:top]]
    for name, parts in PORT_KERNELS.items():
        sel = [e for e in ev if any(p in e.key for p in parts)]
        if sel:
            lines.append(
                f"{sum(e.self_device_time_total for e in sel) / 1e3 / n:9.3f} "
                f"ms/step {sum(e.count for e in sel) / n:7.1f} launches/step  "
                f"port kernel {name}")
    if trace:
        prof.export_chrome_trace(trace)
    return total / 1e3 / n, lines


def host_profile(trainer, state, n=8, top=10):
    """The host side of n steps: kernel launches and synchronising CUDA
    runtime calls (synchronize, memcpy) per step with their host ms, and
    the top operators by self host time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps(trainer, state, n)
    ev = prof.key_averages()

    def per_step(pred):
        sel = [e for e in ev if pred(e.key)]
        return (sum(e.count for e in sel) / n,
                sum(e.self_cpu_time_total for e in sel) / 1e3 / n)

    launches = per_step(lambda k: "LaunchKernel" in k)
    syncs = per_step(lambda k: "Synchronize" in k or "Memcpy" in k)
    ops = sorted((e for e in ev if e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)[:top]
    lines = [f"{e.self_cpu_time_total / 1e3 / n:9.3f} host ms/step "
             f"{e.count / n:7.1f} calls/step  {e.key[:80]}" for e in ops]
    return launches, syncs, lines


def print_host_profile(label, trainer, state):
    (n_launch, launch_ms), (n_sync, sync_ms), top = host_profile(trainer, state)
    print(f"{label} over 8 steps: {n_launch:.1f} kernel launches/step "
          f"({launch_ms:.3f} host ms), {n_sync:.1f} synchronising runtime "
          f"calls/step ({sync_ms:.3f} host ms)", flush=True)
    print("\n".join(top), flush=True)


def phase_split(trainer, state, n=32):
    """ms/step per phase, synced at each boundary (inflates the sum)."""
    t = trainer.cfg.training
    acc = dict.fromkeys(
        ("grid_update", "sample", "render_fwd", "loss", "backward", "adam"), 0.0)

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(n):
        a = sync()
        if state.step % trainer.grid_update_interval == 0:
            trainer.grid_update(state)
        b = sync()
        batch = sample_batch(trainer.train_dataset, state.generator,
                             t.batch_size, t.sampling_strategy)
        noise = torch.rand((t.batch_size,), generator=state.generator,
                           device=trainer.device)
        c = sync()
        res = render_rays(
            state.model, state.grid.occ_bool, batch.rays_o, batch.rays_d,
            noise, exp_step_factor=0.0, max_samples=t.max_samples_per_ray,
            n_candidates=t.march_candidates,
            march_resolution=t.march_resolution,
            sample_budget=trainer.sample_budget,
        )
        d = sync()
        loss, _ = compute_loss(res, batch, trainer.loss_weights,
                               tuple(t.sensors))
        e = sync()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        f = sync()
        state.optimizer.step()
        state.step += 1
        g = sync()
        for k, dt in zip(acc, (b - a, c - b, d - c, e - d, f - e, g - f)):
            acc[k] += dt
    return {k: 1e3 * v / n for k, v in acc.items()}, res


def key_skew(trainer, state):
    """Longest segment and top-1 % row share of each segment-sum stream at
    the sample positions of one training step."""
    seen = {}
    hook = state.model.register_forward_pre_hook(
        lambda mod, args: seen.update(xyz=args[0].detach()))
    run_steps(trainer, state, 1)
    hook.remove()
    out = []
    cases = (chip_smoke.xor_segment_cases
             if state.model.hash_variant == "xor"
             else chip_smoke.slice_segment_cases)
    for name, vals, keys, R in cases(state.model, seen["xyz"], trainer.device):
        for g in range(keys.shape[0]):
            cnt = torch.bincount(keys[g].long(), minlength=R)
            top = torch.sort(cnt, descending=True).values
            out.append(f"{name}[{g}] (vals {tuple(vals.shape)}, K={keys.shape[1]}, "
                       f"n_rows={R}): longest segment {int(top[0])}, rows hit "
                       f"{int((cnt > 0).sum())}, top 1% rows hold "
                       f"{float(top[:max(1, R // 100)].sum()) / keys.shape[1]:.3f}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None,
                    help="write the profiled steps' Chrome trace here")
    ap.add_argument("--hash-variant", default="additive",
                    choices=["additive", "xor"],
                    help="xor: the reference's 16 x F=2 XOR hash")
    ap.add_argument("--hash-levels", type=int, default=8,
                    help="additive hash levels (the bench's 8)")
    ap.add_argument("--hash-feats", type=int, default=4,
                    help="additive hash features per level (the bench's 4)")
    ap.add_argument("--hash-forward", default="corners",
                    choices=hash_encoder.FORWARD_ROUTES)
    ap.add_argument("--hash-backward", default="product",
                    choices=hash_encoder.BACKWARD_ROUTES)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "mixed", "bfloat16"],
                    help="compute mode (model.dtype)")
    ap.add_argument("--config", default="bench",
                    choices=["bench", "scale1", "ngp"],
                    help="scale1: the bench at scale 1.0; ngp: that on the "
                         "NGP grid with distortion and closest pixels")
    ap.add_argument("--route-ab", action="store_true",
                    help="also A/B corners+product against slabs+factors")
    ap.add_argument("--quick", action="store_true",
                    help="only the timed steps and the device and host profiles")
    args = ap.parse_args()
    if args.route_ab and args.quick:
        ap.error("--route-ab and --quick exclude each other")
    if args.route_ab and args.hash_variant == "xor":
        ap.error("--route-ab: the XOR hash has one route")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    cfg = {"bench": chip_smoke.bench_config,
           "scale1": chip_smoke.scale1_config,
           "ngp": chip_smoke.ngp_config}[args.config]()
    cfg.training.real_time_simulation = False
    cfg.training.max_steps = WARMUP
    cfg.model.dtype = args.dtype
    cfg.model.hash_levels = args.hash_levels
    cfg.model.hash_features_per_level = args.hash_feats
    if args.hash_variant == "xor":
        cfg.model.hash_variant = "xor"
        cfg.model.hash_levels, cfg.model.hash_features_per_level = 16, 2
    print(f"config: {args.config}, scale {cfg.model.scale}, "
          f"{cfg.model.grid_type} grid, {cfg.model.hash_variant} "
          f"{cfg.model.hash_levels} x "
          f"{cfg.model.hash_features_per_level}, routes {args.hash_forward}/"
          f"{args.hash_backward}, {args.dtype}", flush=True)
    dataset, scene, _ = make_synthetic_dataset(
        n_images=16, img_wh=(160, 120), device=dev)
    trainer = Trainer(cfg, dataset, scene=scene, device=dev,
                      hash_forward=args.hash_forward,
                      hash_backward=args.hash_backward)
    state = trainer.init_state()
    tic = time.perf_counter()
    state = trainer.train(state)
    torch.cuda.synchronize()
    logs = trainer.logs
    print(f"warm-up: {state.step} steps in {time.perf_counter() - tic:.2f} s; "
          f"loss {logs['loss'][-1]:.4f}, rm_samples {logs['rm_samples'][-1]:.0f}, "
          f"overflow {logs['overflow'][-1]:.0f}, occupied "
          f"{float(state.grid.occ_bool.float().mean()):.4f}", flush=True)

    dt = run_steps(trainer, state, STEPS)
    print(f"bench protocol, steps {state.step - STEPS}-{state.step}: "
          f"{1e3 * dt:.3f} ms/step, {cfg.training.batch_size / dt:.0f} rays/s "
          f"(grid updates included)", flush=True)
    if not args.quick:
        for line in key_skew(trainer, state):
            print("keys:", line, flush=True)
    dev_ms, top = device_profile(trainer, state, trace=args.trace)
    print(f"profile, 8 steps after step {state.step - 8}: device time "
          f"{dev_ms:.3f} ms/step", flush=True)
    print("\n".join(top), flush=True)
    print_host_profile("host side", trainer, state)
    if args.quick:
        return
    phases, res = phase_split(trainer, state)
    print("phases ms/step (32 steps, synced at each boundary): "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"; sum {sum(phases.values()):.3f}; last rm_samples "
          f"{int(res['rm_samples'])}, overflow {int(res['overflow'])}",
          flush=True)

    arms = {}
    for arm in ("kernels", "plain", "plain", "kernels"):
        with plain_kernels(arm == "plain"):
            s0 = state.step
            dt = run_steps(trainer, state, AB_STEPS)
        arms.setdefault(arm, []).append(dt)
        print(f"A/B {arm}, steps {s0}-{state.step}: {1e3 * dt:.3f} ms/step, "
              f"{cfg.training.batch_size / dt:.0f} rays/s", flush=True)
    print("A/B mean ms/step: " + ", ".join(
        f"{k} {1e3 * np.mean(v):.3f}" for k, v in arms.items()), flush=True)
    for arm in ("kernels", "plain"):
        with plain_kernels(arm == "plain"):
            dev_ms, top = device_profile(trainer, state)
        print(f"A/B {arm}: device time {dev_ms:.3f} ms/step over 8 steps",
              flush=True)
        print("\n".join(top), flush=True)

    if not args.route_ab:
        return
    routes = {"corners+product": ("corners", "product"),
              "slabs+factors": ("slabs", "factors")}
    turns = ("corners+product", "slabs+factors", "slabs+factors",
             "corners+product")
    arms = {}
    for arm in turns * 2:
        use_routes(state.model, *routes[arm])
        s0 = state.step
        dt = run_steps(trainer, state, AB_STEPS)
        arms.setdefault(arm, []).append(dt)
        print(f"route A/B {arm}, steps {s0}-{state.step}: {1e3 * dt:.3f} "
              f"ms/step, {cfg.training.batch_size / dt:.0f} rays/s", flush=True)
    print("route A/B mean ms/step: " + ", ".join(
        f"{k} {1e3 * np.mean(v):.3f}" for k, v in arms.items()), flush=True)
    for arm in turns:
        use_routes(state.model, *routes[arm])
        dev_ms, top = device_profile(trainer, state)
        print(f"route A/B {arm}: device time {dev_ms:.3f} ms/step over 8 "
              f"steps", flush=True)
        print("\n".join(top), flush=True)
    for arm in turns[:2]:
        use_routes(state.model, *routes[arm])
        print_host_profile(f"route A/B {arm}", trainer, state)


if __name__ == "__main__":
    main()
