// Dense segment sum over a key-sorted, row-major value stream.
//
// Replaces the TPU kernel `_t_kernel`
// (virus_nerf_tpu/ops/segment_sum_pallas.py:101, entry
// `_sorted_group_segment_sum_t_tpu` :635, contract
// `group_segment_sum_t_sorted` :725):
//
//     out[g, f, r] = sum_{i : keys[g, i] == r} vals[g, i, f]
//
// vals (G, K, F) float32 row-major, keys (G, K) int32 sorted ascending per
// group, out (G, F, n_rows) float32; a row no key hits is 0 and a key
// outside [0, n_rows) is dropped.  The XOR hash encoder's backward uses it
// for the table gradient (virus_nerf_tpu/ops/hash_encoder.py:1005).
//
// Design: a chunked segmented reduction whose time does not follow the
// longest segment.  The XOR stream is skewed (the densest level spreads
// 8 * 114,688 samples over 4,096 rows), and a one-thread-per-row walk
// (csrc/segment_sum.cu) spends its time on the longest row.
//
// 0. the output is zeroed (cudaMemsetAsync): rows no key hits stay 0.
// 1. one warp per chunk of kChunk = 512 stream entries, in 16 steps of 32
//    consecutive entries (each lane loads its F floats: coalesced).  A
//    segmented inclusive scan over the 32 lanes (5 shuffle steps; equal
//    keys are contiguous because the stream is sorted) plus a carry from
//    the step before gives each run's sum at its last entry.  A run that
//    starts and ends inside the chunk is written there.  The chunk's first
//    run (it may have begun in an earlier chunk) and its last run (it may
//    go on into the next one) are kept in a small scratch per chunk.
// 2. one thread per chunk joins the boundary runs: the chunk in which a
//    run starts adds the first-run sums of the chunks it spans, in chunk
//    order, and writes the row once.  No atomics: the result is
//    deterministic.  A run spanning m chunks costs its owner m adds, so a
//    row of 20,000 samples takes 40 adds, not 20,000.
//
// One deliberate difference from the TPU kernel: values are read in
// float32, not bf16 (the bf16 stream was a TPU bandwidth choice,
// segment_sum_pallas.py:61-69; the JAX CPU reference is float32).
//
// Bound on this card: it reads each value and key once and writes each
// output once.  For the XOR path's hashed group (G = 10, K = 917,504, F = 2,
// 524,288 rows): 73.4 MB of values + 36.7 MB of keys + 41.9 MB of output
// = 152 MB, 0.045 ms at 3.35 TB/s.  The zero fill writes the output a
// second time (+42 MB); tensor cores and TMA are not used.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kSteps = 16;                // 32-entry steps per chunk
constexpr int kChunk = kWarp * kSteps;    // stream entries per warp
constexpr int kWarpsPerBlock = 8;
constexpr int kBoundaryThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// out row `key` of one group's (F, n_rows) block; keys out of range drop
template <int F>
__device__ __forceinline__ void write_row(float* og, int n_rows, int key,
                                          const float* s) {
  if (key < 0 || key >= n_rows) return;
#pragma unroll
  for (int f = 0; f < F; ++f) og[(long long)f * n_rows + key] = s[f];
}

// a finished run: the chunk's first run goes to the scratch (it may have
// begun in an earlier chunk), any other run lies wholly inside the chunk
template <int F>
__device__ __forceinline__ void finish_run(int key, const float* s,
                                           int first_key, float* head,
                                           float* og, int n_rows) {
  if (key == first_key) {
#pragma unroll
    for (int f = 0; f < F; ++f) head[f] = s[f];
  } else {
    write_row<F>(og, n_rows, key, s);
  }
}

template <int F>
__global__ void rows_chunk_kernel(const float* __restrict__ vals,
                                  const int* __restrict__ keys,
                                  float* __restrict__ out,
                                  int* __restrict__ head_key,
                                  int* __restrict__ tail_key,
                                  float* __restrict__ head_sum,
                                  float* __restrict__ tail_sum, long long K,
                                  int n_rows, int n_chunks) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int g = blockIdx.y;
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  const long long c0 = (long long)chunk * kChunk;
  const long long c1 = min(c0 + kChunk, K);
  const int* kg = keys + (long long)g * K;
  const float* vg = vals + (long long)g * K * F;
  float* og = out + (long long)g * F * n_rows;
  const long long slot = (long long)g * n_chunks + chunk;
  const int first_key = __ldg(kg + c0);

  // the run open at the end of the previous step (same in every lane)
  int carry_key = 0;
  bool have_carry = false;
  float carry[F];
#pragma unroll
  for (int f = 0; f < F; ++f) carry[f] = 0.0f;

  for (int step = 0; step < kSteps; ++step) {
    const long long base = c0 + (long long)step * kWarp;
    if (base >= c1) break;  // warp-uniform
    const int last = (int)min((long long)(kWarp - 1), c1 - 1 - base);
    const bool valid = lane <= last;
    const long long i = base + lane;
    int k = valid ? __ldg(kg + i) : INT_MAX;
    float s[F];
#pragma unroll
    for (int f = 0; f < F; ++f) s[f] = valid ? __ldg(vg + i * F + f) : 0.0f;

    // segmented inclusive scan: after the step of offset d, s holds the
    // sum over lanes (lane - 2d, lane] that share this lane's key
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int kd = __shfl_up_sync(kFull, k, d);
      float sd[F];
#pragma unroll
      for (int f = 0; f < F; ++f) sd[f] = __shfl_up_sync(kFull, s[f], d);
      if (lane >= d && kd == k) {
#pragma unroll
        for (int f = 0; f < F; ++f) s[f] += sd[f];
      }
    }

    // join the run carried from the previous step, or finish it
    const int k0 = __shfl_sync(kFull, k, 0);
    if (have_carry) {
      if (k0 == carry_key) {
        if (k == carry_key) {
#pragma unroll
          for (int f = 0; f < F; ++f) s[f] += carry[f];
        }
      } else if (lane == 0) {
        finish_run<F>(carry_key, carry, first_key, head_sum + slot * F, og,
                      n_rows);
      }
    }

    // runs that end inside this step
    const int kn = __shfl_down_sync(kFull, k, 1);
    if (lane < last && kn != k) {
      finish_run<F>(k, s, first_key, head_sum + slot * F, og, n_rows);
    }

    // the run open at the step's last valid lane is carried on
    carry_key = __shfl_sync(kFull, k, last);
#pragma unroll
    for (int f = 0; f < F; ++f) carry[f] = __shfl_sync(kFull, s[f], last);
    have_carry = true;
  }

  // the carried run is the chunk's last run
  if (lane == 0) {
    head_key[slot] = first_key;
    tail_key[slot] = carry_key;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      tail_sum[slot * F + f] = carry[f];
      if (carry_key == first_key) head_sum[slot * F + f] = carry[f];
    }
  }
}

template <int F>
__global__ void rows_boundary_kernel(const int* __restrict__ head_key,
                                     const int* __restrict__ tail_key,
                                     const float* __restrict__ head_sum,
                                     const float* __restrict__ tail_sum,
                                     float* __restrict__ out, int n_rows,
                                     int n_chunks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (b >= n_chunks) return;
  const int* hk = head_key + (long long)g * n_chunks;
  const int* tk = tail_key + (long long)g * n_chunks;
  const float* hs = head_sum + (long long)g * n_chunks * F;
  const float* ts = tail_sum + (long long)g * n_chunks * F;
  float* og = out + (long long)g * F * n_rows;

  const int kh = hk[b];
  const int kt = tk[b];
  // the chunk's first run goes on from the chunk before
  const bool cont = b > 0 && tk[b - 1] == kh;
  if (kh != kt) {
    // several runs: the first one, if it starts here, ends here too
    if (!cont) write_row<F>(og, n_rows, kh, hs + (long long)b * F);
  } else if (cont) {
    return;  // one run that started earlier: its owner adds this chunk
  }
  // the last run starts in this chunk: add the chunks it spans, in order
  float s[F];
#pragma unroll
  for (int f = 0; f < F; ++f) s[f] = ts[(long long)b * F + f];
  for (int c = b + 1; c < n_chunks && hk[c] == kt; ++c) {
#pragma unroll
    for (int f = 0; f < F; ++f) s[f] += hs[(long long)c * F + f];
    if (tk[c] != kt) break;
  }
  write_row<F>(og, n_rows, kt, s);
}

template <int F>
cudaError_t launch(const float* vals, const int* keys, float* out,
                   int* head_key, int* tail_key, float* head_sum,
                   float* tail_sum, int G, long long K, int n_rows,
                   int n_chunks, cudaStream_t stream) {
  const dim3 grid1((n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock, G);
  rows_chunk_kernel<F><<<grid1, kWarpsPerBlock * kWarp, 0, stream>>>(
      vals, keys, out, head_key, tail_key, head_sum, tail_sum, K, n_rows,
      n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((n_chunks + kBoundaryThreads - 1) / kBoundaryThreads, G);
  rows_boundary_kernel<F><<<grid2, kBoundaryThreads, 0, stream>>>(
      head_key, tail_key, head_sum, tail_sum, out, n_rows, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// Stream entries per chunk: the wrapper sizes the scratch with it.
extern "C" int vn_segment_sum_rows_chunk() { return kChunk; }

// head_key, tail_key: (G, n_chunks) int32 scratch; head_sum, tail_sum:
// (G, n_chunks, F) float32 scratch, n_chunks = ceil(K / kChunk).  Returns
// the first CUDA error of the zero fill and the two launches
// (cudaErrorInvalidValue for an F without an instantiation; the Python
// wrapper checks F first).
extern "C" int vn_segment_sum_rows(const float* vals, const int* keys,
                                   float* out, int* head_key, int* tail_key,
                                   float* head_sum, float* tail_sum, int G,
                                   int F, long long K, int n_rows,
                                   cudaStream_t stream) {
  if (G == 0 || n_rows == 0) return cudaSuccess;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)G * (size_t)F * (size_t)n_rows * sizeof(float), stream);
  if (err != cudaSuccess || K == 0) return err;
  const int n_chunks = (int)((K + kChunk - 1) / kChunk);
  switch (F) {
#define VN_ROWS_CASE(F_)                                                    \
  case F_:                                                                  \
    return launch<F_>(vals, keys, out, head_key, tail_key, head_sum,        \
                      tail_sum, G, K, n_rows, n_chunks, stream);
    VN_ROWS_CASE(1)
    VN_ROWS_CASE(2)
    VN_ROWS_CASE(4)
    VN_ROWS_CASE(8)
#undef VN_ROWS_CASE
    default: return cudaErrorInvalidValue;
  }
}
