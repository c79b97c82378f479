"""Build and load the port's CUDA kernels.

All sources under ``virus_nerf_tpu_torch/csrc/*.cu`` (with the headers
``csrc/*.cuh`` they include) compile, at first use, into ONE shared library with a plain C interface: one ``nvcc`` per source,
all started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o build/<hash>/<name>.o \
         csrc/<name>.cu                                   # each
    nvcc -shared -o build/libvnerf_kernels_<hash>.so build/<hash>/*.o

The library lands in ``build/`` at the repository root (resolved from this
file, not from the working directory) under a name that carries a hash of
the sources, headers and flags, so an edited source rebuilds and a stale library is
never loaded.  No PyTorch header is included: the build takes seconds.
ptxas's report of each kernel's registers and spills is kept beside the
library (:func:`ptxas_log`).

The library is bound with ``ctypes``.  Every pointer and the stream pass as
``c_void_p`` (an undeclared pointer argument would be cut to 32 bits);
every C entry point returns ``cudaGetLastError()`` right after its launch,
and :func:`check` raises on anything but ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double

# C signature of every entry point: name -> argtypes (all return int)
_SIGNATURES = {
    # vals, keys, out, part, starts, G, VF, K, n_rows, stream
    "vn_segment_sum_sorted": (_P, _P, _P, _P, _P, _I, _I, _L, _I, _P),
    "vn_segment_tiles_rows": (_I,),
    "vn_segment_tiles_short_window": (),
    "vn_segment_tiles_chunk": (),
    "vn_segment_tiles_planes": (),
    "vn_segment_tiles_scan_planes": (),
    # vals, keys, out, part, starts, G, F, K, n_rows, dense, stream
    "vn_segment_sum_rows": (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    "vn_segment_rows_tile_rows": (_I, _I),
    "vn_segment_rows_short_window": (),
    # wgt, is_bf16, keys, out, part, starts, G, F, K, n_rows, stream
    "vn_segment_sum_factors": (_P, _I, _P, _P, _P, _P, _I, _I, _L, _I, _P),
    # table, is_bf16, out, row0, size, G, F, corner_offsets, stream
    "vn_widen_slabs": (_P, _I, _P, _L, _I, _I, _I, _P, _P),
    "vn_widen_tile_rows": (_I,),
    "vn_widen_plane": (),
    # ptrs (p, g, mu, nu per leaf), plan (n, head, body per leaf), flags
    # (bf16, vec per leaf), leaves, scal (lr, bc1, bc2 on the device), b1,
    # one_minus_b1, b2, one_minus_b2, eps, stream
    "vn_fused_adam": (_P, _P, _P, _I, _P, _F, _F, _F, _F, _F, _P),
    "vn_fused_adam_max_leaves": (),
    "vn_fused_adam_chunk": (),
    # rays_o, rays_d, t1, t2, noise, grid, numel, gs, cascades, scale, esf,
    # lo, hi, dt0, ts, deltas, valid, n_kept, n, S, K, stream
    "vn_march_select": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                        _F, _P, _P, _P, _P, _I, _I, _I, _P),
    "vn_march_chunk": (),
    "vn_march_rays_per_block": (),
    "vn_march_max_candidates": (),
    "vn_march_max_samples": (),
    # t1, noise, ts, dts, n, K, esf, lo, hi, stream
    "vn_march_lattice": (_P, _P, _P, _P, _I, _I, _F, _F, _F, _P),
    # buf, slots, phase, stream
    "vn_trace_stamp": (_P, _I, _I, _P),
    # cells, count, bits, words, rays, radii, m, res, cube_min, span, hit, n,
    # stream
    "vn_slice_scan": (_P, _I, _P, _I, _P, _P, _I, _I, _D, _D, _P, _I, _P),
    # pos, k, ref, m, n, idx, dist, stream
    "vn_nn_search": (_P, _I, _P, _I, _I, _P, _P, _P),
    # xyz, n, table, is_bf16, F, levels, level_words, scales, out, base, w,
    # stream
    "vn_hash_corners": (_P, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of virus_nerf_tpu_torch cannot be built"
    )


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> list:
    """Wait for every started nvcc; raise with the output of the first
    that failed.  Returns each command's standard error."""
    failed, logs = [], []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        logs.append(stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                          f"{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build_library() -> Path:
    """Compile the kernels (if the hashed library is not built yet) and
    return the library path."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = _source_hash(sources + sorted(CSRC_DIR.glob("*.cuh")))
    out = BUILD_DIR / f"libvnerf_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(objdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
            objs.append(obj)
        logs = _run(procs)
        # ptxas -v: registers, shared memory and spills of every kernel
        ptxas_log(out).write_text("".join(
            f"== {src.name} ==\n{log}" for src, log in zip(sources, logs)))
        tmp = os.path.join(objdir, out.name)
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def ptxas_log(lib_path: Path) -> Path:
    """The ``-Xptxas -v`` report written beside a built library, one
    ``== <source> ==`` section per source."""
    return lib_path.with_suffix(".ptxas.txt")


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.vn_error_string.argtypes = [ctypes.c_int]
    lib.vn_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().vn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
