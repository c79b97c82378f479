// Widened bf16 slabs of one group of same-size hash levels.
//
// Replaces the TPU kernel `_wp_kernel`
// (virus_nerf_tpu/ops/widen_pack_pallas.py:90, entry `packed_slabs_group`
// :149), which builds the same slab for the forward's one-row-per-sample
// gather (virus_nerf_tpu/ops/hash_encoder.py:330-406):
//
//     out[g, r, c, f] = bf16(table[row0 + g*s + (r + o_c) mod s, f])
//
// table (total_rows, F) float32 or bf16, out (G, s, 8, F) bf16, o_c the 8
// corner row offsets the levels of the group share.  Row r of a level's
// slab holds the features of all 8 trilinear corners of base row r, so the
// forward gathers one 8F-wide row per (sample, level).
//
// Deliberate difference from the TPU kernel: the slab is written in its
// natural row order, (s, 8, F) bf16.  The TPU kernel emits int32 bit-pairs
// of the features in a band-permuted (s/8, 128) order that only suits the
// TPU's (8, 128) tiles and lane rolls (ROADMAP B5); a gather on this card
// reads a row of 8F bf16 values (32 B at F = 2) wherever it lies.  It is
// F = 2 only on the TPU; here F in {1, 2, 4, 8}.
//
// Design: a pure gather plus a cast, so it is bit-exact against the plain
// version (`widen_slabs_group_plain`, the 3-step roll doubling tree).  One
// thread per (row, corner) of a level, the level in blockIdx.y, so no
// thread divides by the level size (the first version, a grid-stride loop
// with a 64-bit division per element and 2-byte stores, took 0.42 ms on
// the hashed group below, 0.16 ms in this form).  Consecutive threads write
// consecutive corners and rows (coalesced; pairs of features go out as one
// 4-byte bf16x2 store), and the 8 corners of 4 consecutive rows a warp
// reads are 8 runs of 4 consecutive table rows.  The float32 -> bf16 cast
// is `__float2bfloat16_rn`, PyTorch's round to nearest even.
//
// Bound on this card: bytes.  For the hashed group of the 16 x 2 table
// (G = 10 levels of 524,288 rows, float32 table) it reads 41.9 MB and
// writes 167.8 MB: 0.063 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct CornerOffsets {
  int o[8];
};

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) {
  return x;
}

template <typename T, int F>
__global__ void widen_slabs_kernel(const T* __restrict__ table,
                                   __nv_bfloat16* __restrict__ out,
                                   long long row0, int s,
                                   CornerOffsets offs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // r * 8 + c
  if (i >= s * 8) return;
  const int g = blockIdx.y;
  const int c = i & 7;
  int t = (i >> 3) + offs.o[c];  // o_c < s, so one subtraction is the mod
  if (t >= s) t -= s;
  const T* src = table + (row0 + (long long)g * s + t) * F;
  __nv_bfloat16* dst = out + ((long long)g * s * 8 + i) * F;
  if constexpr (F % 2 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + f) =
          __halves2bfloat162(to_bf16(src[f]), to_bf16(src[f + 1]));
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) dst[f] = to_bf16(src[f]);
  }
}

template <typename T>
cudaError_t dispatch(const T* table, __nv_bfloat16* out, long long row0,
                     int s, int G, int F, const CornerOffsets& offs,
                     cudaStream_t stream) {
  constexpr int kThreads = 256;
  const dim3 grid((unsigned)(((long long)s * 8 + kThreads - 1) / kThreads),
                  (unsigned)G);
  switch (F) {
#define VN_WIDEN_CASE(F_)                                                    \
  case F_:                                                                   \
    widen_slabs_kernel<T, F_><<<grid, kThreads, 0, stream>>>(table, out,     \
                                                             row0, s, offs); \
    break;
    VN_WIDEN_CASE(1)
    VN_WIDEN_CASE(2)
    VN_WIDEN_CASE(4)
    VN_WIDEN_CASE(8)
#undef VN_WIDEN_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// table: (total_rows, F) float32 (bf16 == 0) or bf16 (bf16 == 1); out:
// (G, size, 8, F) bf16; corner_offsets: 8 ints in [0, size), host memory.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// F without an instantiation; the Python wrapper checks F first).
extern "C" int vn_widen_slabs(const void* table, int bf16, void* out,
                              long long row0, int size, int G, int F,
                              const int* corner_offsets,
                              cudaStream_t stream) {
  if (G == 0 || size == 0) return cudaSuccess;
  CornerOffsets offs;
  for (int c = 0; c < 8; ++c) offs.o[c] = corner_offsets[c];
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (bf16) {
    return dispatch(static_cast<const __nv_bfloat16*>(table), o, row0, size,
                    G, F, offs, stream);
  }
  return dispatch(static_cast<const float*>(table), o, row0, size, G, F,
                  offs, stream);
}
