"""Design variants of the fused Adam (B2) and widened-slab (B5) kernels,
built side by side from edited copies of their sources and timed in turns
on one GPU.

    python tools/torch_kernel_variants.py

Each variant is ``csrc/fused_adam.cu`` or ``csrc/widen_slabs.cu`` with a
few lines replaced (``ADAM_VARIANTS``, ``WIDEN_VARIANTS``; "final" is the
source as it is), compiled with the port's nvcc flags into its own library
under ``build/variants/`` and swapped in for the port's library while its
wrapper runs.  Shapes are those of the slabs quality run (16 x F=2 additive
table of 2^19 rows, 5,710,032 x 2, random init): B2 on the table alone, on
the model's six leaves in one call and on a bf16 table; B5 on the table's
two bf16 slab groups.  Every variant is checked against the plain version
first, on fresh inputs made from a seed (B5 bit for bit; B2 within 1e-6,
one bf16 ulp for a bf16 p, as ``chip_smoke.check_adam``).  Times: device
ms per launch from ``torch.profiler`` and CUDA-event ms per call around
10 calls, in two turns (variants in order, then reversed).  Needs a
CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

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
    """Compile every variant of ``source`` (in parallel); {name: library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC_DIR / source).read_text()
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise ValueError(f"{source} variant {name}: text not found: {old[:60]!r}")
            src = src.replace(old, new)
        path = OUT / f"{Path(source).stem}_{name}.cu"
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
        print(f"built {path.name}: registers {', '.join(regs)}", flush=True)
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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    adam_libs = build(ADAM_VARIANTS, "fused_adam.cu")
    widen_libs = build(WIDEN_VARIANTS, "widen_slabs.cu")
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
    args = fused_adam.adam_scalars(1e-2, 0.9, 0.999, 3) + (0.9, 0.999, 1e-15)
    runs = [("B2", name, lib) for name, lib in adam_libs.items()]
    runs += [("B5", name, lib) for name, lib in widen_libs.items()]
    times, ok = {}, {}
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
        print(f"{kernel} {name:22s} {case:18s} device ms "
              + " ".join(f"{d:.4f}" for d, _ in t) + "  events ms "
              + " ".join(f"{e:.4f}" for _, e in t)
              + f"  {'ok' if ok[kernel, name, case] else 'MISMATCH'}", flush=True)
    for case in ("table", "six leaves"):
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
