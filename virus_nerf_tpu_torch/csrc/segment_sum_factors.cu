// Fused factor-stream segment sum: the hash-table gradient formed from the
// sorted corner weights and output gradients, without the (8F, K) product.
//
// Replaces the TPU kernel `_tsf_kernel`
// (virus_nerf_tpu/ops/segment_sum_pallas.py:333, entry
// `_sorted_group_segment_sum_tsf_tpu` :454, contract
// `group_segment_sum_tsf_sorted` :504):
//
//     out[g, f*8 + c, r] = sum_{i : keys[g, i] == r} wgt[g, c, i] * wgt[g, 8 + f, i]
//
// wgt (G, 8 + F, K) float32 or bf16 (rows 0..7 the sorted corner weights,
// rows 8..8+F the sorted gradient features), keys (G, K) int32 sorted
// ascending per group, out (G, 8F, n_rows) float32 in F-major row order
// (row f*8 + c, the TPU kernel's order, folded by `_fold_wide_t_fmajor`).
// A row no key hits is 0 and a key outside [0, n_rows) is dropped.
//
// Design: the row-tile core of segment_tiles.cuh, shared with B1 (one CTA
// per 512 output rows, 256 at F >= 4, with a shared-memory accumulator, the segmented warp
// scan inside its window, 512-entry chunk partials for long windows; the
// tile is stored once, coalesced; deterministic, no atomics, no zero
// fill).  Each lane loads its entry's 8 weights and one gradient feature
// (9 coalesced loads) and forms that feature's 8 products in registers, so
// no (8F, K) value matrix is written or read; a warp scans one feature's 8
// planes, so the 8 weights are read once per feature, from L1 after the
// first, and a CTA owns up to 32 planes (F = 8 runs two CTAs per tile over
// blockIdx.z).  The product is rounded once by `__fmul_rn` (never
// contracted into an add); for bf16 factors it is rounded to bf16
// (`__float2bfloat16_rn`) before it is summed, as the plain version (and
// the JAX fallback, segment_sum_pallas.py:524-530) multiplies in bf16.
// The product of two bf16 values is exact in float32, so that is one
// rounding, as in PyTorch's bf16 multiply.  Sums are float32.
//
// The first design (on a chunked segmented scan, since removed) zero-filled
// the output and then stored each run's 8F sums as 8F separate 4-byte stores,
// one per plane: on the hashed levels (~0.25 samples per row) nearly every
// store landed alone in its 32-byte sector, and the output was written
// twice.
//
// Bound on this card: bytes.  At F = 2 in bf16 it reads 20 B of factors +
// 4 B of key per entry and writes 64 B per output row: for the hashed
// group of the 16 x 2 table (G = 10, K = 131,072 samples per level,
// 524,288 rows) 31.5 MB in + 335.5 MB out, 0.11 ms at 3.35 TB/s.  The
// output (the widened gradient before the fold) dominates.

#include <cuda_bf16.h>

#include "segment_tiles.cuh"

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// w * g rounded as the plain version rounds it: float32, or bf16 for bf16
// factors
__device__ __forceinline__ float product(float w, float g, float) {
  return __fmul_rn(w, g);
}
__device__ __forceinline__ float product(float w, float g, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(w, g)));
}

template <typename T, int F>
struct FactorLoader {
  static constexpr int kWidth = 8 * F;
  static constexpr int kSlice = tiles::scan_planes(kWidth);  // 8
  static constexpr int kFeats = kSlice / 8;  // features of one plane group
  static constexpr int kRows = tiles::tile_rows(kWidth);
  static constexpr int kShortWindow = tiles::kShortWindow;
  static constexpr int kPrefetch = 0;
  static constexpr bool kRowMajor = false;
  const T* wgt;
  long long K;

  __device__ __forceinline__ void operator()(int g, int slice, long long i,
                                             float* s) const {
    const T* p = wgt + (long long)g * (8 + F) * K + i;
    float w[8], gf[kFeats];
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = to_float(p[(long long)c * K]);
#pragma unroll
    for (int f = 0; f < kFeats; ++f) {
      gf[f] = to_float(p[(long long)(8 + slice * kFeats + f) * K]);
    }
#pragma unroll
    for (int f = 0; f < kFeats; ++f) {
#pragma unroll
      for (int c = 0; c < 8; ++c) s[f * 8 + c] = product(w[c], gf[f], T());
    }
  }
};

template <typename T>
int dispatch(const T* wgt, const int* keys, float* out, float* part,
             long long* starts, int G, int F, long long K, int n_rows,
             cudaStream_t stream) {
  switch (F) {
#define VN_FACTORS_CASE(F_)                                                 \
  case F_:                                                                  \
    return tiles::segment_tiles(FactorLoader<T, F_>{wgt, K}, keys, part,    \
                                starts, out, G, K, n_rows, stream);
    VN_FACTORS_CASE(1)
    VN_FACTORS_CASE(2)
    VN_FACTORS_CASE(4)
    VN_FACTORS_CASE(8)
#undef VN_FACTORS_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// wgt: (G, 8 + F, K) float32 (bf16 == 0) or bf16 (bf16 == 1); part:
// (G, K, 8F) float32 scratch; starts: (G, ceil(n_rows / R) + 1) int64
// scratch.  Returns the first CUDA error of the two launches
// (cudaErrorInvalidValue for an F without an instantiation; the Python
// wrapper checks F first).
extern "C" int vn_segment_sum_factors(const void* wgt, int bf16,
                                      const int* keys, float* out,
                                      float* part, long long* starts, int G,
                                      int F, long long K, int n_rows,
                                      cudaStream_t stream) {
  if (bf16) {
    return dispatch(static_cast<const __nv_bfloat16*>(wgt), keys, out, part,
                    starts, G, F, K, n_rows, stream);
  }
  return dispatch(static_cast<const float*>(wgt), keys, out, part, starts, G,
                  F, K, n_rows, stream);
}
