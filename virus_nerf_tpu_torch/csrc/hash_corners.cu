// H1: the additive hash encoder's `corners` forward, every level of every
// sample in one launch.
//
// Replaces no TPU kernel: the JAX package's forward gathers widened slabs
// through XLA (virus_nerf_tpu/ops/hash_encoder.py:518-557), and the port's
// plain `corners` forward (ops/hash_encoder.py: `hash_base_rows`, then
// `_corner_gather_combine`) built (L, 8, N) index, feature and weight
// tensors and combined them by an einsum that cuBLAS ran as a batched
// GEMV over N * L products of (F, 8) by 8.
//
// Inputs (ops/hash_encoder.py's `h1_level_words` prepares the levels):
//   xyz    (N, 3) float32 positions, [0, 1] for the cube;
//   table  (total_rows, F) float32 or bf16;
//   per level (by value): scale, first table row, size, the strides of a
//          +1 step in y and z (reduced mod size), the 8 corner row offsets
//          from the base row (in [0, size)), and whether the corner
//          features are rounded to bf16 (`packable_size`).
// Outputs:
//   out    (N, L * F) float32, the embedding;
//   base   (L, N) int64 base rows within each level, and
//   w      (L, 8, N) float32 trilinear weights, only when the caller keeps
//          them for the table gradient (null pointers otherwise).
//
// Per (sample, level), as the plain code computes it on the card:
//   pos   = xyz * scale + 0.5 as one fused multiply-add (`torch.addcmul` on
//           the card rounds once);
//   g     = int64(max(floor(pos), 0)) (a NaN stays NaN and converts to 0,
//           as `clamp(min=0).long()` gives), frac = pos - floor(pos);
//   base  = (gx + gy * sy + gz * sz) mod size in 64-bit two's complement
//           with `torch.remainder`'s sign, so NaN, inf, negative and large
//           positions give the plain code's rows, all inside the level;
//   row_c = offset + (base + o_c) mod size;
//   w_c   = (s0 * s1) * s2, s_d = frac_d or 1 - frac_d by corner bit d
//           (`prod(dim=1)`'s order);
//   out_f = h0 + h1, h0 the fused multiply-add chain of feat_c,f * w_c over
//           c = 0..3 from 0 and h1 the chain over c = 4..7: the order in
//           which cuBLAS's batched GEMV (CUDA 12.8, PyTorch 2.11, H100)
//           combines the einsum's (F, 8) by 8 products on its two-kernel
//           path, bit for bit at F = 1, 2, 4 and 8 on every sample count
//           tried that is a multiple of 16,384 (the benchmark cells' among
//           them).  At other counts (70,001, 100,000) cuBLAS takes a
//           one-kernel path that combines otherwise: up to 3 ulps apart.
//           (The plain code on the CPU combines in yet another order.)
// Every float operation is an intrinsic that rounds once (`__fmaf_rn`,
// `__fmul_rn`, `__fadd_rn`, `__fsub_rn`), which nvcc never contracts, so
// base, w and out are the plain code's on the card bit for bit.  A
// bf16-rounded level's features go through `__float2bfloat16_rn`,
// PyTorch's round to nearest even.
//
// Bound on this card: bytes and the table's random reads.  At the RH2
// cell's 1,048,576 samples (L = 16, F = 2, float32) it writes out 134 MB,
// base 134 MB and w 537 MB (0.24 ms at 3.35 TB/s) and reads 134 M corner
// rows of 8 B at random from a 45.7 MB table, about the size of L2.
// Design: one thread a sample, looping over the levels, so base and w are
// stored along N (a warp writes 32 consecutive values of one level and
// corner) and the sample's output row is written by F-wide vector stores
// level after level; the 8 corner loads of a level are independent
// read-only loads (`__ldg`), issued before the combine, and two levels are
// unrolled so the next level's loads overlap this level's arithmetic.  No
// (L, 8, N) tensor exists unless the gradient needs base and w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLevels = 32;
constexpr int kLevelWords = 13;  // int64 a level: offset, size, sy, sz, o[8], bf16

struct Level {
  long long offset, size, stride_y, stride_z;
  int corner[8];
  float scale;
  int bf16;
};

struct Levels {
  Level l[kMaxLevels];
};

// F features of one table row as float32
template <int F> struct Row {
  float v[F];
};

__device__ __forceinline__ Row<1> load_row(const float* t, long long r, Row<1>) {
  return Row<1>{{__ldg(t + r)}};
}
__device__ __forceinline__ Row<2> load_row(const float* t, long long r, Row<2>) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(t) + r);
  return Row<2>{{a.x, a.y}};
}
__device__ __forceinline__ Row<4> load_row(const float* t, long long r, Row<4>) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(t) + r);
  return Row<4>{{a.x, a.y, a.z, a.w}};
}
__device__ __forceinline__ Row<8> load_row(const float* t, long long r, Row<8>) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(t) + 2 * r);
  const float4 b = __ldg(reinterpret_cast<const float4*>(t) + 2 * r + 1);
  return Row<8>{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ float bf(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ __forceinline__ Row<1> load_row(const __nv_bfloat16* t, long long r, Row<1>) {
  return Row<1>{{bf(__ldg(reinterpret_cast<const unsigned short*>(t) + r))}};
}
__device__ __forceinline__ Row<2> load_row(const __nv_bfloat16* t, long long r, Row<2>) {
  const unsigned a = __ldg(reinterpret_cast<const unsigned*>(t) + r);
  return Row<2>{{bf(a & 0xffffu), bf(a >> 16)}};
}
__device__ __forceinline__ Row<4> load_row(const __nv_bfloat16* t, long long r, Row<4>) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(t) + r);
  return Row<4>{{bf(a.x & 0xffffu), bf(a.x >> 16), bf(a.y & 0xffffu), bf(a.y >> 16)}};
}
__device__ __forceinline__ Row<8> load_row(const __nv_bfloat16* t, long long r, Row<8>) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(t) + r);
  return Row<8>{{bf(a.x & 0xffffu), bf(a.x >> 16), bf(a.y & 0xffffu), bf(a.y >> 16),
                 bf(a.z & 0xffffu), bf(a.z >> 16), bf(a.w & 0xffffu), bf(a.w >> 16)}};
}

__device__ __forceinline__ void store_row(float* dst, const float (&v)[1]) { *dst = v[0]; }
__device__ __forceinline__ void store_row(float* dst, const float (&v)[2]) {
  *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_row(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_row(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <int F, typename T>
__global__ void __launch_bounds__(kThreads)
hash_corners_kernel(const float* __restrict__ xyz, long long n, int levels,
                    const T* __restrict__ table, const __grid_constant__ Levels p,
                    float* __restrict__ out, long long* __restrict__ base_out,
                    float* __restrict__ w_out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x[3] = {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]};
  float* row_out = out + i * levels * F;
#pragma unroll 2
  for (int l = 0; l < levels; ++l) {
    const Level& lv = p.l[l];
    long long g[3];
    float fr[3], om[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float pos = __fmaf_rn(x[d], lv.scale, 0.5f);
      const float fl = floorf(pos);
      fr[d] = __fsub_rn(pos, fl);
      om[d] = __fsub_rn(1.0f, fr[d]);
      g[d] = static_cast<long long>(isnan(fl) ? fl : fmaxf(fl, 0.0f));
    }
    // int64 wrap-around as the plain code's tensors have it
    const long long h = static_cast<long long>(
        static_cast<unsigned long long>(g[0]) +
        static_cast<unsigned long long>(g[1]) * static_cast<unsigned long long>(lv.stride_y) +
        static_cast<unsigned long long>(g[2]) * static_cast<unsigned long long>(lv.stride_z));
    long long b = h % lv.size;
    if (b < 0) b += lv.size;
    Row<F> feat[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      long long r = b + lv.corner[c];
      if (r >= lv.size) r -= lv.size;
      feat[c] = load_row(table, lv.offset + r, Row<F>{});
    }
    float w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float s0 = (c & 1) ? fr[0] : om[0];
      const float s1 = (c & 2) ? fr[1] : om[1];
      const float s2 = (c & 4) ? fr[2] : om[2];
      w[c] = __fmul_rn(__fmul_rn(s0, s1), s2);
    }
    if (base_out != nullptr) {
      base_out[l * n + i] = b;
#pragma unroll
      for (int c = 0; c < 8; ++c) w_out[(l * 8LL + c) * n + i] = w[c];
    }
    const bool round = sizeof(T) == 4 && lv.bf16;
    float half[2][F];
#pragma unroll
    for (int f = 0; f < F; ++f) half[0][f] = half[1][f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float v = feat[c].v[f];
        if (round) v = __bfloat162float(__float2bfloat16_rn(v));
        half[c >> 2][f] = __fmaf_rn(v, w[c], half[c >> 2][f]);
      }
    }
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(half[0][f], half[1][f]);
    store_row(row_out + l * F, acc);
  }
}

template <int F, typename T>
void launch(const float* xyz, long long n, int levels, const void* table,
            const Levels& p, float* out, long long* base, float* w,
            cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  hash_corners_kernel<F, T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      xyz, n, levels, static_cast<const T*>(table), p, out, base, w);
}

template <typename T>
void launch_f(int F, const float* xyz, long long n, int levels, const void* table,
              const Levels& p, float* out, long long* base, float* w,
              cudaStream_t stream) {
  switch (F) {
    case 1: launch<1, T>(xyz, n, levels, table, p, out, base, w, stream); break;
    case 2: launch<2, T>(xyz, n, levels, table, p, out, base, w, stream); break;
    case 4: launch<4, T>(xyz, n, levels, table, p, out, base, w, stream); break;
    case 8: launch<8, T>(xyz, n, levels, table, p, out, base, w, stream); break;
  }
}

}  // namespace

// level_words: host (levels, 13) int64, each level's offset, size, stride_y,
// stride_z, 8 corner offsets and bf16 flag; scales: host (levels,) float32.
// base and w null: the outputs the gradient needs are not written.
extern "C" int vn_hash_corners(const void* xyz, long long n, const void* table,
                               int is_bf16, int F, int levels,
                               const void* level_words, const void* scales,
                               void* out, void* base, void* w, void* stream) {
  if (levels < 1 || levels > kMaxLevels || !(F == 1 || F == 2 || F == 4 || F == 8) ||
      (base == nullptr) != (w == nullptr) || n < 0 ||
      (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  Levels p;
  const long long* words = static_cast<const long long*>(level_words);
  const float* sc = static_cast<const float*>(scales);
  for (int l = 0; l < levels; ++l) {
    const long long* q = words + l * kLevelWords;
    Level& lv = p.l[l];
    lv.offset = q[0];
    lv.size = q[1];
    lv.stride_y = q[2];
    lv.stride_z = q[3];
    for (int c = 0; c < 8; ++c) lv.corner[c] = static_cast<int>(q[4 + c]);
    lv.bf16 = static_cast<int>(q[12]);
    lv.scale = sc[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xyz);
  float* o = static_cast<float*>(out);
  long long* b = static_cast<long long*>(base);
  float* wt = static_cast<float*>(w);
  if (is_bf16) {
    launch_f<__nv_bfloat16>(F, x, n, levels, table, p, o, b, wt, s);
  } else {
    launch_f<float>(F, x, n, levels, table, p, o, b, wt, s);
  }
  return static_cast<int>(cudaGetLastError());
}
