"""Design variants of the fused Adam (B2), row-major segment sum (B3) and
widened-slab (B5) kernels, built side by side from edited copies of their
sources and timed in turns on one GPU.

    python tools/torch_kernel_variants.py [--kernels B2,B3,B5]

Each variant is ``csrc/fused_adam.cu``, ``csrc/segment_sum_rows.cu`` or
``csrc/widen_slabs.cu`` with a few lines replaced (``ADAM_VARIANTS``,
``ROWS_VARIANTS``, ``WIDEN_VARIANTS``; "final" is the source as it is),
compiled with the port's nvcc flags into its own library under
``build/variants/`` and swapped in for the port's library while its
wrapper runs.  B2 and B5 take the shapes of the slabs quality run (16 x
F=2 additive table of 2^19 rows, 5,710,032 x 2, random init): B2 on the
table alone, on the model's six leaves in one call and on a bf16 table;
B5 on the table's two bf16 slab groups.  B3's variants are the sparse
tiles' rows R and the short-window cut C (R in {512, 1024, 2048}, C in
{2048, 4096, 8192}), the dense tiles' rows (256, 512, 1024), the steps
whose loads the warp scan has in flight (``prefetch_D``: 0, 1, 4),
launch 1 without its probes (``no_probes``: every chunk searches its
windows; a replacement in ``csrc/segment_tiles.cuh``) and the store
layout (``plane_store``: the (G, F, n_rows) planes of the TPU kernel),
each at the kept values of the others, on the two streams of the XOR
hash backward at the positions of a training step of the XOR
configuration (``chip_smoke.bench_config`` with the 16 x F=2 XOR hash,
budget 4096 * 28, after 32 steps from a seeded init) and on 917,504
entries over 524,288 rows, uniform and with 700,000 on one row.  Every
variant is checked against the plain version first, on fresh inputs made
from a seed (B5 bit for bit; B2 within 1e-6, one bf16 ulp for a bf16 p,
as ``chip_smoke.check_adam``; B3 within 4 * eps32 * sqrt(n) * sum|v| of
a float64 sum per row, and bit-identical on two calls).  Times: device ms
per call from ``torch.profiler`` and CUDA-event ms per call around 10
calls, in two turns (variants in order, then reversed); for B3 also each
launch's device ms (chunk_kernel, tile_kernel).  Needs a CUDA device;
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from virus_nerf_tpu_torch.models.ngp import NGPModel  # noqa: E402
from virus_nerf_tpu_torch.ops import _build, fused_adam, widen  # noqa: E402
from virus_nerf_tpu_torch.ops import segment_sum as ss  # noqa: E402

OUT = _build.BUILD_DIR / "variants"

_ADAM_KERNEL = """  const int c = blockIdx.x;
  int l = 0;
  while (c >= L.first_chunk[l + 1]) ++l;
  const Leaf& leaf = L.leaf[l];
  const long long j = c - L.first_chunk[l];
  if (leaf.bf16) {
    chunk<__nv_bfloat16>(leaf, j, h);
  } else {
    chunk<float>(leaf, j, h);
  }
"""
_ADAM_LAUNCH = "  fused_adam_kernel<<<total, kThreads, 0, stream>>>(L, h);"

# name -> [(text in the source, its replacement)]
ADAM_VARIANTS = {
    "final": [],
    # a grid of SMs x resident CTAs, each walking the chunks
    "persistent_grid": [
        (_ADAM_KERNEL, """  int l = 0;
  for (int c = blockIdx.x; c < L.first_chunk[kMaxLeaves]; c += gridDim.x) {
    while (c >= L.first_chunk[l + 1]) ++l;
    const Leaf& leaf = L.leaf[l];
    const long long j = c - L.first_chunk[l];
    if (leaf.bf16) {
      chunk<__nv_bfloat16>(leaf, j, h);
    } else {
      chunk<float>(leaf, j, h);
    }
  }
"""),
        (_ADAM_LAUNCH, """  for (int l = count; l < kMaxLeaves; ++l) L.first_chunk[l + 1] = total;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_adam_kernel,
                                                kThreads, 0);
  const int grid = total < sms * per_sm ? total : sms * per_sm;
  fused_adam_kernel<<<grid, kThreads, 0, stream>>>(L, h);"""),
    ],
    "one_vector_a_thread": [("constexpr int kVecPerThread = 2;",
                             "constexpr int kVecPerThread = 1;")],
    "four_vectors_a_thread": [("constexpr int kVecPerThread = 2;",
                               "constexpr int kVecPerThread = 4;")],
    "no_cache_hints": [
        ("return __ldcs(reinterpret_cast<const float4*>(a + i));",
         "return *reinterpret_cast<const float4*>(a + i);"),
        ("__stcs(reinterpret_cast<float4*>(a + i), make_float4(x[0], x[1], x[2], x[3]));",
         "*reinterpret_cast<float4*>(a + i) = make_float4(x[0], x[1], x[2], x[3]);"),
    ],
    "512_threads": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
}
_ROWS_SPARSE = "constexpr int kSparseRows = 1024;"
_ROWS_DENSE = "constexpr int kDenseRows = 128;"
_ROWS_SHORT = "constexpr int kRowShortWindow = 8192;"
ROWS_VARIANTS = {"final": []}
# the sparse tiles (the hashed group's) and the cut
for _R in (512, 1024, 2048):
    for _C in (2048, 4096, 8192):
        ROWS_VARIANTS[f"sparse_R{_R}_C{_C}"] = [
            (_ROWS_SPARSE, f"constexpr int kSparseRows = {_R};"),
            (_ROWS_SHORT, f"constexpr int kRowShortWindow = {_C};")]
# the dense tiles (the merged dense levels')
for _R in (256, 512, 1024):
    ROWS_VARIANTS[f"dense_R{_R}"] = [(_ROWS_DENSE, f"constexpr int kDenseRows = {_R};")]
# the warp scan's loads in flight: each step's when it sums it (0), or
# the next D steps' while it sums D (kept: 2)
for _D in (0, 1, 4):
    ROWS_VARIANTS[f"prefetch_{_D}"] = [("  static constexpr int kPrefetch = 2;",
                                        f"  static constexpr int kPrefetch = {_D};")]
# launch 1 searches every chunk's windows, without the probes first
ROWS_VARIANTS["no_probes"] = [(
    """  const bool short_f = surely_short<R>(kfa, kfb, n_rows, tf) ||
                       !long_window<R, C>(kg, K, n_rows, tf);
  if (short_f && (tl == tf || surely_short<R>(kla, klb, n_rows, tl) ||
                  !long_window<R, C>(kg, K, n_rows, tl))) {""",
    """  const bool short_f = !long_window<R, C>(kg, K, n_rows, tf);
  if (short_f && (tl == tf || !long_window<R, C>(kg, K, n_rows, tl))) {""")]
# the TPU kernel's (G, F, n_rows) planes, stored plane by plane
ROWS_VARIANTS["plane_store"] = [("  static constexpr bool kRowMajor = true;",
                                 "  static constexpr bool kRowMajor = false;")]
WIDEN_VARIANTS = {
    "final": [],
    # the loads of one window in flight at a time
    "one_window_at_a_time": [("  constexpr int kBatch = 8 / kSlots;",
                              "  constexpr int kBatch = 1;")],
    "launch_bounds_4_ctas": [
        ("__global__ void __launch_bounds__(kThreads)\n    widen_slabs_kernel",
         "__global__ void __launch_bounds__(kThreads, 4)\n    widen_slabs_kernel")],
    "16_kb_tiles": [("constexpr int kTileBytes = 32768;",
                     "constexpr int kTileBytes = 16384;")],
    "streaming_stores": [("    dst[q] = piece;", "    __stcs(dst + q, piece);")],
}


def build(variants, source):
    """Compile every variant of ``source`` (in parallel); {name: library}.
    A replacement applies to the source, or else to a header of
    ``csrc/``, of which the variant gets its own copy."""
    text = (_build.CSRC_DIR / source).read_text()
    headers = {h.name: h.read_text() for h in _build.CSRC_DIR.glob("*.cuh")}
    procs = {}
    for name, subs in variants.items():
        src, hdrs = text, dict(headers)
        for old, new in subs:
            if old in src:
                src = src.replace(old, new)
                continue
            hit = [h for h, t in hdrs.items() if old in t]
            if not hit:
                raise ValueError(f"{source} variant {name}: text not found: {old[:60]!r}")
            hdrs[hit[0]] = hdrs[hit[0]].replace(old, new)
        vdir = OUT / f"{Path(source).stem}_{name}"
        vdir.mkdir(parents=True, exist_ok=True)
        for h, t in hdrs.items():
            (vdir / h).write_text(t)
        path = vdir / source
        path.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(path.with_suffix(".so")), str(path),
               str(_build.CSRC_DIR / "error.cu")]
        procs[name] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {path.name}:\n{err[-3000:]}")
        regs = sorted(set(re.findall(r"Used (\d+) registers", err)))
        print(f"built {path.parent.name}: registers {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(path.with_suffix(".so")))
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        lib.vn_error_string.argtypes = [ctypes.c_int]
        lib.vn_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def adam_leaves(shapes, gen, dev):
    """(p, g, mu, nu) leaves of these (shape, p dtype), random."""
    out = []
    for shape, dtype in shapes:
        p = torch.randn(shape, generator=gen, device=dev).to(dtype)
        out.append((p, torch.randn(shape, generator=gen, device=dev),
                    torch.randn(shape, generator=gen, device=dev) * 0.1,
                    torch.rand(shape, generator=gen, device=dev) * 0.01))
    return out


def check_adam(shapes, args, dev):
    """The kernel against its plain version on fresh leaves (the timed ones
    drift over many steps with one gradient)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    leaves = adam_leaves(shapes, gen, dev)
    got = [tuple(x.clone() for x in leaf) for leaf in leaves]
    want = [tuple(x.clone() for x in leaf) for leaf in leaves]
    fused_adam.adam_update_leaves_(got, *args)
    fused_adam.adam_update_leaves_plain_(want, *args)
    torch.cuda.synchronize()
    for (p, _, mu, nu), (wp, _, wmu, wnu) in zip(got, want):
        if max(float((mu - wmu).abs().max()), float((nu - wnu).abs().max())) > 1e-6:
            return False
        if p.dtype == torch.float32 and float((p - wp).abs().max()) > 1e-6:
            return False
        if p.dtype == torch.bfloat16 and int(chip_smoke.bf16_ulp_distance(p, wp).max()) > 1:
            return False
    return True


def launch_ms(fn, parts, iters=10):
    """Device ms per call of each launch whose kernel name holds one of
    ``parts`` (torch.profiler over ``iters`` calls after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    out = {}
    for part in parts:
        sel = [e for e in ev if part in e.key]
        n = sum(e.count for e in sel)
        out[part] = (sum(e.self_device_time_total for e in sel) / 1e3 / n
                     if n else float("nan"))
    return out


def xor_streams(dev):
    """(name, vals, keys, n_rows) of B3: the XOR backward's two streams at
    the positions of a training step (32 steps of the XOR configuration
    from a seeded init), and chip_smoke's uniform and one-row streams."""
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.training.trainer import Trainer

    cfg = chip_smoke.bench_config()
    cfg.model.hash_variant = "xor"
    cfg.model.hash_levels, cfg.model.hash_features_per_level = 16, 2
    cfg.training.max_steps = 32
    dataset, scene, _ = make_synthetic_dataset(n_images=16, img_wh=(160, 120),
                                               device=dev)
    trainer = Trainer(cfg, dataset, scene=scene, device=dev)
    state = trainer.init_state()
    seen = {}
    hook = state.model.register_forward_pre_hook(
        lambda mod, args: seen.update(xyz=args[0].detach()))
    state = trainer.train(state)
    hook.remove()
    cases = chip_smoke.xor_segment_cases(state.model, seen["xyz"], dev)
    return cases + chip_smoke.skew_segment_cases(dev, "rows")


def rows_reference(vals, keys, R):
    """float64 sums (G, F, R) and the per-row float32 tolerance."""
    plain = ss.group_segment_sum_t_sorted_plain
    counts = torch.stack([torch.bincount(keys[g].long(), minlength=R)
                          for g in range(keys.shape[0])]).double()
    tol = (4.0 * torch.finfo(torch.float32).eps * counts.sqrt()[:, None]
           * plain(vals.abs().double(), keys, R))
    return plain(vals.double(), keys, R), tol


def rows_result(name, vals, keys, R):
    """B3's (G, F, R) sums; the plane-store variant's storage holds the
    planes themselves."""
    got = ss.group_segment_sum_t_sorted(vals, keys, R)
    if name == "plane_store":
        G, _, F = vals.shape
        return got.transpose(1, 2).reshape(G, F, R)
    return got


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="B2,B3,B5",
                    help="comma-separated subset of B2, B3, B5")
    kernels = set(ap.parse_args().kernels.split(","))
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    adam_libs = build(ADAM_VARIANTS, "fused_adam.cu") if "B2" in kernels else {}
    widen_libs = build(WIDEN_VARIANTS, "widen_slabs.cu") if "B5" in kernels else {}
    rows_libs = build(ROWS_VARIANTS, "segment_sum_rows.cu") if "B3" in kernels else {}
    rows_cases = xor_streams(dev) if rows_libs else []
    rows_ref = [rows_reference(*case[1:]) for case in rows_cases]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = NGPModel(levels=16, feature_per_level=2, log2_T=19, max_res=1024,
                     hash_forward="slabs", hash_backward="factors",
                     generator=gen, device=dev)
    groups = chip_smoke.slab_group_cases(model)
    want = [widen.widen_slabs_group_plain(*case[1:]) for case in groups]
    params = [(tuple(q.shape), q.dtype) for q in model.parameters()]
    adam_shapes = {"table": params[:1], "six leaves": params,
                   "bf16 table": [(params[0][0], torch.bfloat16)]}
    adam_cases = {case: adam_leaves(shapes, gen, dev)
                  for case, shapes in adam_shapes.items()}
    scal = fused_adam.adam_scal(torch.tensor(3, dtype=torch.int32, device=dev),
                                fused_adam.adam_hyper(1e-2, 0.9, 0.999, dev))
    args = (scal, 0.9, 0.999, 1e-15)
    runs = [("B2", name, lib) for name, lib in adam_libs.items()]
    runs += [("B3", name, lib) for name, lib in rows_libs.items()]
    runs += [("B5", name, lib) for name, lib in widen_libs.items()]
    times, ok, split = {}, {}, {}
    library = _build.library
    try:
        for order in (runs, runs[::-1]):
            for kernel, name, lib in order:
                _build.library = lambda lib=lib: lib
                if kernel == "B2":
                    for case, leaves in adam_cases.items():
                        ok[kernel, name, case] = check_adam(adam_shapes[case],
                                                            args, dev)
                        fn = lambda: fused_adam.adam_update_leaves_(leaves, *args)  # noqa: E731
                        times.setdefault((kernel, name, case), []).append(
                            (chip_smoke.device_ms(fn, "fused_adam_kernel"),
                             chip_smoke.time_turns([fn])[0]))
                    continue
                if kernel == "B3":
                    for (case, vals, keys, R), (exact, tol) in zip(rows_cases,
                                                                  rows_ref):
                        got = rows_result(name, vals, keys, R)
                        again = rows_result(name, vals, keys, R)
                        torch.cuda.synchronize()
                        ok[kernel, name, case] = (
                            torch.equal(got, again)
                            and bool(((got.double() - exact).abs() <= tol).all()))
                        fn = lambda: ss.group_segment_sum_t_sorted(vals, keys, R)  # noqa: E731
                        launch = launch_ms(fn, ("chunk_kernel", "tile_kernel"))
                        times.setdefault((kernel, name, case), []).append(
                            (sum(launch.values()), chip_smoke.time_turns([fn])[0]))
                        split.setdefault((name, case), []).append(launch)
                    continue
                for (case, *a), w in zip(groups, want):
                    got = widen.widen_slabs_group(*a)
                    torch.cuda.synchronize()
                    ok[kernel, name, case] = torch.equal(got.view(torch.int16),
                                                         w.view(torch.int16))
                    fn = lambda: widen.widen_slabs_group(*a)  # noqa: E731
                    times.setdefault((kernel, name, case), []).append(
                        (chip_smoke.device_ms(fn, "widen_slabs_kernel"),
                         chip_smoke.time_turns([fn])[0]))
    finally:
        _build.library = library
    for (kernel, name, case), t in times.items():
        print(f"{kernel} {name:22s} {case:26s} device ms "
              + " ".join(f"{d:.4f}" for d, _ in t) + "  events ms "
              + " ".join(f"{e:.4f}" for _, e in t)
              + f"  {'ok' if ok[kernel, name, case] else 'MISMATCH'}", flush=True)
    for (name, case), t in split.items():
        print(f"B3 {name:22s} {case:26s} device ms a launch: " + "; ".join(
            " ".join(f"{k} {d[k]:.4f}" for k in d) for d in t), flush=True)
    for name in rows_libs:
        # one XOR step's two calls, each turn
        step = [sum(times["B3", name, case][turn][0] for case in
                    ("xor_merged_dense", "xor_hashed_group")) for turn in (0, 1)]
        print(f"B3 {name:22s} {'XOR step (2 calls)':26s} device ms "
              + " ".join(f"{d:.4f}" for d in step), flush=True)
    for case in (("table", "six leaves") if adam_libs else ()):
        leaves = adam_cases[case]
        steps = [torch.tensor(3.0, device=dev) for _ in leaves]
        fn = lambda: torch._fused_adam_(  # noqa: E731
            [x[0] for x in leaves], [x[1] for x in leaves], [x[2] for x in leaves],
            [x[3] for x in leaves], [], steps, lr=1e-2, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-15, amsgrad=False, maximize=False)
        print(f"B2 torch._fused_adam_     {case:18s} device ms "
              f"{chip_smoke.device_ms(fn, 'Adam'):.4f}  events ms "
              f"{chip_smoke.time_turns([fn])[0]:.4f}", flush=True)
    if not all(ok.values()):
        sys.exit("a variant disagrees with the plain version")


if __name__ == "__main__":
    main()
