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
// Bound on this card: bytes.  For the hashed group of the 16 x 2 table
// (G = 10 levels of 524,288 rows, float32 table) it reads 41.9 MB and
// writes 167.8 MB: 0.063 ms at 3.35 TB/s.
//
// Design: a gather plus a cast, so it is bit-exact against the plain
// version (`widen_slabs_group_plain`, the 3-step roll doubling tree); the
// float32 -> bf16 cast is `__float2bfloat16_rn`, PyTorch's round to nearest
// even.  One CTA per tile of TR consecutive base rows of one level (TR * 8
// * F bf16 = 32 KB), the level on the grid's slow axis, so the CTAs that
// run together read one level's table (4 MB at 2^19 rows x F = 2, float32)
// and its eight windows are served from L2:
// 1. For each corner c the CTA copies the table window of rows
//    (r0 + o_c) mod s ... + TR of its level into corner plane c of a
//    shared-memory tile, converted to bf16.  The mod-s wrap cuts the window
//    into at most two runs of contiguous table elements (eight threads plan
//    the 16 runs first); each run goes in 16-byte loads (a scalar head and
//    tail up to the 16-byte boundaries, one element a thread) and 8- or
//    16-byte shared stores, consecutive threads on consecutive addresses.
//    A thread issues the 8 loads of 4 corners (float32 table; 8 corners of
//    a bf16 one) before it stores the first: a window a thread at a time
//    left the CTA waiting out eight load latencies in a row.  A run starts
//    in its plane at its element's phase within an M-element block (M =
//    max(16 B in elements, F)), so every vector lands aligned and every
//    row's F values stay together.
// 2. After one barrier each thread assembles 16-byte pieces of output rows
//    (8/F corners of one row) from the planes and stores them: each output
//    byte is written once, a warp writes 512 contiguous bytes.
// The planes are 2,072 bf16 long (TR * F + 24 for the two runs' phases),
// 1,036 words, so that at F = 2 the two halves of a warp, which read
// corner planes 4 apart, fall on different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 32768;  // the (TR, 8, F) bf16 output tile
constexpr int kPlane = kTileBytes / 16 + 24;  // bf16 of one corner plane

struct CornerOffsets {
  int o[8];
};

// F values of one table row as the shared-memory unit the output pass reads
template <int F> struct RowUnit;
template <> struct RowUnit<1> { using type = unsigned short; };
template <> struct RowUnit<2> { using type = unsigned; };
template <> struct RowUnit<4> { using type = uint2; };
template <> struct RowUnit<8> { using type = uint4; };

// 16 bytes of table, and their bf16 form stored into the tile
__device__ __forceinline__ float4 load16(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* src) {
  return *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void put16(__nv_bfloat16* dst, const float4& x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      *reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}
__device__ __forceinline__ void put16(__nv_bfloat16* dst, const uint4& x) {
  *reinterpret_cast<uint4*>(dst) = x;
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }

// One run of a window: table elements [e0, e0 + head + n_vec * V + tail),
// a scalar head up to the first 16-byte boundary, n_vec 16-byte vectors,
// a scalar tail; element e0 goes to tile position d0.
struct Run {
  long long e0;
  int d0, head, n_vec, tail;
};

// The run of table elements [e0, e1) placed at plane position base + (e0
// + mis) mod M (mis: the table pointer's phase in elements within an
// M-element block), so that 16-byte-aligned elements land on aligned
// places; returns the position after its last element.
template <int V, int M>
__device__ __forceinline__ int plan_run(long long e0, long long e1, int mis,
                                        int plane, int base, Run& run) {
  long long v0 = e0 + ((V - ((e0 + mis) & (V - 1))) & (V - 1));
  if (v0 > e1) v0 = e1;
  long long v1 = e1 - ((e1 + mis) & (V - 1));
  if (v1 < v0) v1 = v0;
  run.e0 = e0;
  run.d0 = plane + base + (int)((e0 + mis) & (M - 1));
  run.head = (int)(v0 - e0);
  run.n_vec = (int)((v1 - v0) / V);
  run.tail = (int)(e1 - v1);
  return base + (int)((e0 + mis) & (M - 1)) + (int)(e1 - e0);
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    widen_slabs_kernel(const T* __restrict__ table,
                       __nv_bfloat16* __restrict__ out, long long row0, int s,
                       CornerOffsets offs) {
  constexpr int TR = kTileBytes / (16 * F);  // base rows of a tile
  constexpr int V = 16 / sizeof(T);          // table elements of 16 bytes
  constexpr int M = V > F ? V : F;
  constexpr int K = 8 / F;  // corners in one 16-byte output piece
  // 16-byte loads of one window a thread makes (the window's two runs hold
  // at most TR * F / V vectors together), and corners whose loads are all
  // in flight before the first is stored: 8 loads a thread at a time
  constexpr int kSlots = (TR * F / V + kThreads - 1) / kThreads;
  constexpr int kBatch = 8 / kSlots;
  using Vec = typename std::conditional<sizeof(T) == 4, float4, uint4>::type;
  using Unit = typename RowUnit<F>::type;
  __shared__ __align__(16) unsigned short tile_bits[8 * kPlane];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(tile_bits);
  __shared__ Run runs[16];  // corner c: runs 2c (before the wrap), 2c + 1
  // per corner: plane position of run 1's first row, rows in run 1, plane
  // position of run 2's first row
  __shared__ int rows_at[8][3];

  const int g = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, s - r0);
  const long long level = (row0 + (long long)g * s) * F;  // first element
  // a multiple of F (the wrapper hands over a table whose pointer is)
  const int mis =
      (int)((reinterpret_cast<uintptr_t>(table) / sizeof(T)) & (M - 1));

  // 0. each corner's window: rows (r0 + o_c) mod s ... + rows of the
  // level, cut at the wrap into two runs
  if (threadIdx.x < 8) {
    const int c = threadIdx.x;
    int t0 = r0 + offs.o[c];  // o_c < s, so one subtraction is the mod
    if (t0 >= s) t0 -= s;
    const int n1 = min(rows, s - t0);
    const long long e0 = level + (long long)t0 * F;
    const int end1 = plan_run<V, M>(e0, e0 + (long long)n1 * F, mis,
                                    c * kPlane, 0, runs[2 * c]);
    const int base2 = (end1 + M - 1) & ~(M - 1);
    plan_run<V, M>(level, level + (long long)(rows - n1) * F, mis, c * kPlane,
                   base2, runs[2 * c + 1]);
    rows_at[c][0] = runs[2 * c].d0 - c * kPlane;
    rows_at[c][1] = n1;
    rows_at[c][2] = runs[2 * c + 1].d0 - c * kPlane;
  }
  __syncthreads();

  // 1. the windows into their corner planes as bf16.  Scalar heads and
  // tails: thread t takes element t % 16 of run t / 16 (the head's first
  // 8, then the tail's), its load issued before the vectors'
  const Run& mine = runs[threadIdx.x / 16];
  const int j = threadIdx.x % 16;
  const int sj = j < 8 ? j : mine.head + mine.n_vec * V + (j - 8);
  const bool scalar = j < 8 ? j < mine.head : j - 8 < mine.tail;
  T x;
  if (scalar) x = table[mine.e0 + sj];
#pragma unroll
  for (int cb = 0; cb < 8; cb += kBatch) {
    Vec buf[kBatch][kSlots];
    int place[kBatch][kSlots];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        int v = threadIdx.x + k * kThreads;  // vector v of the window
        const Run* run = &runs[2 * (cb + b)];
        if (v >= run->n_vec) v -= (run++)->n_vec;
        place[b][k] = -1;
        if (v < run->n_vec) {
          buf[b][k] = load16(table + run->e0 + run->head + (long long)v * V);
          place[b][k] = run->d0 + run->head + v * V;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (place[b][k] >= 0) put16(tile + place[b][k], buf[b][k]);
      }
    }
  }
  if (scalar) tile[mine.d0 + sj] = to_bf16(x);
  __syncthreads();

  // 2. the tile out: piece q is row q / F, corners (q % F) * K ... + K
  uint4* dst = reinterpret_cast<uint4*>(out + ((long long)g * s + r0) * 8 * F);
  for (int q = threadIdx.x; q < rows * F; q += kThreads) {
    const int i = q / F;
    const int c0 = (q % F) * K;
    uint4 piece;
    Unit* units = reinterpret_cast<Unit*>(&piece);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int* run = rows_at[c0 + k];
      const int pos = i < run[1] ? run[0] + i * F : run[2] + (i - run[1]) * F;
      units[k] = *reinterpret_cast<const Unit*>(tile + (c0 + k) * kPlane + pos);
    }
    dst[q] = piece;
  }
}

template <typename T>
cudaError_t dispatch(const T* table, __nv_bfloat16* out, long long row0,
                     int s, int G, int F, const CornerOffsets& offs,
                     cudaStream_t stream) {
  switch (F) {
#define VN_WIDEN_CASE(F_)                                                     \
  case F_: {                                                                  \
    constexpr int TR = kTileBytes / (16 * F_);                                \
    const dim3 grid((unsigned)((s + TR - 1) / TR), (unsigned)G);              \
    widen_slabs_kernel<T, F_><<<grid, kThreads, 0, stream>>>(table, out,      \
                                                             row0, s, offs);  \
    break;                                                                    \
  }
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

// Base rows of one CTA's tile at F features (0 for an F without a kernel)
extern "C" int vn_widen_tile_rows(int F) {
  return (F == 1 || F == 2 || F == 4 || F == 8) ? kTileBytes / (16 * F) : 0;
}
extern "C" int vn_widen_plane() { return kPlane; }

// table: (total_rows, F) float32 (bf16 == 0) or bf16 (bf16 == 1), its
// pointer a multiple of F elements; out: (G, size, 8, F) bf16;
// corner_offsets: 8 ints in [0, size), host memory.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an F
// without an instantiation; the Python wrapper checks F first).
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
