// Chunked segmented sum over a key-sorted stream: the core of the row-major
// segment sum (segment_sum_rows.cu, B3).  B1 and B4 run on the row-tile
// core of segment_tiles.cuh, which writes each output element once.
//
//     out[g, v, r] = sum_{i : keys[g, i] == r} value(g, i)[v],  v < V
//
// keys (G, K) int32 sorted ascending per group, out (G, V, n_rows) float32;
// a row no key hits is 0 and a key outside [0, n_rows) is dropped.  A
// Loader gives the V float values of stream entry (g, i).
//
// Design: the time does not follow the longest segment (skewed keys put
// thousands of samples on one row; a one-thread-per-row walk spends its
// time there).
//
// 0. the output is zeroed (cudaMemsetAsync): rows no key hits stay 0.
// 1. one warp per chunk of kChunk = 512 stream entries, in 16 steps of 32
//    consecutive entries (each lane loads one entry's values: coalesced
//    across the warp).  A segmented inclusive scan over the 32 lanes (5
//    shuffle steps per value; equal keys are contiguous because the stream
//    is sorted) plus a carry from the step before gives each run's sum at
//    its last entry.  A run that starts and ends inside the chunk is
//    written there.  The chunk's first run (it may have begun in an
//    earlier chunk) and its last run (it may go on into the next one) are
//    kept in a small scratch per chunk.
// 2. one thread per chunk joins the boundary runs: the chunk in which a
//    run starts adds the first-run sums of the chunks it spans, in chunk
//    order, and writes the row once.  No atomics: the result is
//    deterministic.  A run spanning m chunks costs its owner m adds, so a
//    row of 20,000 samples takes 40 adds, not 20,000.
//
// Scratch (the wrapper allocates it): head_key, tail_key (G, n_chunks)
// int32 and head_sum, tail_sum (G, n_chunks, V) float32, n_chunks =
// ceil(K / kChunk).

#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kSteps = 16;                // 32-entry steps per chunk
constexpr int kChunk = kWarp * kSteps;    // stream entries per warp
constexpr int kWarpsPerBlock = 8;
constexpr int kBoundaryThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// out row `key` of one group's (V, n_rows) block; keys out of range drop
template <int V>
__device__ __forceinline__ void write_row(float* og, int n_rows, int key,
                                          const float* s) {
  if (key < 0 || key >= n_rows) return;
#pragma unroll
  for (int v = 0; v < V; ++v) og[(long long)v * n_rows + key] = s[v];
}

// a finished run: the chunk's first run goes to the scratch (it may have
// begun in an earlier chunk), any other run lies wholly inside the chunk
template <int V>
__device__ __forceinline__ void finish_run(int key, const float* s,
                                           int first_key, float* head,
                                           float* og, int n_rows) {
  if (key == first_key) {
#pragma unroll
    for (int v = 0; v < V; ++v) head[v] = s[v];
  } else {
    write_row<V>(og, n_rows, key, s);
  }
}

template <class Loader>
__global__ void scan_chunk_kernel(Loader load, const int* __restrict__ keys,
                                  float* __restrict__ out,
                                  int* __restrict__ head_key,
                                  int* __restrict__ tail_key,
                                  float* __restrict__ head_sum,
                                  float* __restrict__ tail_sum, long long K,
                                  int n_rows, int n_chunks) {
  constexpr int V = Loader::kWidth;
  const int lane = threadIdx.x & (kWarp - 1);
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int g = blockIdx.y;
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  const long long c0 = (long long)chunk * kChunk;
  const long long c1 = min(c0 + kChunk, K);
  const int* kg = keys + (long long)g * K;
  float* og = out + (long long)g * V * n_rows;
  const long long slot = (long long)g * n_chunks + chunk;
  const int first_key = __ldg(kg + c0);

  // the run open at the end of the previous step (same in every lane)
  int carry_key = 0;
  bool have_carry = false;
  float carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = 0.0f;

  for (int step = 0; step < kSteps; ++step) {
    const long long base = c0 + (long long)step * kWarp;
    if (base >= c1) break;  // warp-uniform
    const int last = (int)min((long long)(kWarp - 1), c1 - 1 - base);
    const bool valid = lane <= last;
    const long long i = base + lane;
    int k = valid ? __ldg(kg + i) : INT_MAX;
    float s[V];
    if (valid) {
      load(g, i, s);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] = 0.0f;
    }

    // segmented inclusive scan: after the step of offset d, s holds the
    // sum over lanes (lane - 2d, lane] that share this lane's key
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int kd = __shfl_up_sync(kFull, k, d);
      const bool join = lane >= d && kd == k;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float sd = __shfl_up_sync(kFull, s[v], d);
        if (join) s[v] += sd;
      }
    }

    // join the run carried from the previous step, or finish it
    const int k0 = __shfl_sync(kFull, k, 0);
    if (have_carry) {
      if (k0 == carry_key) {
        if (k == carry_key) {
#pragma unroll
          for (int v = 0; v < V; ++v) s[v] += carry[v];
        }
      } else if (lane == 0) {
        finish_run<V>(carry_key, carry, first_key, head_sum + slot * V, og,
                      n_rows);
      }
    }

    // runs that end inside this step
    const int kn = __shfl_down_sync(kFull, k, 1);
    if (lane < last && kn != k) {
      finish_run<V>(k, s, first_key, head_sum + slot * V, og, n_rows);
    }

    // the run open at the step's last valid lane is carried on
    carry_key = __shfl_sync(kFull, k, last);
#pragma unroll
    for (int v = 0; v < V; ++v) carry[v] = __shfl_sync(kFull, s[v], last);
    have_carry = true;
  }

  // the carried run is the chunk's last run
  if (lane == 0) {
    head_key[slot] = first_key;
    tail_key[slot] = carry_key;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      tail_sum[slot * V + v] = carry[v];
      if (carry_key == first_key) head_sum[slot * V + v] = carry[v];
    }
  }
}

template <int V>
__global__ void scan_boundary_kernel(const int* __restrict__ head_key,
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
  const float* hs = head_sum + (long long)g * n_chunks * V;
  const float* ts = tail_sum + (long long)g * n_chunks * V;
  float* og = out + (long long)g * V * n_rows;

  const int kh = hk[b];
  const int kt = tk[b];
  // the chunk's first run goes on from the chunk before
  const bool cont = b > 0 && tk[b - 1] == kh;
  if (kh != kt) {
    // several runs: the first one, if it starts here, ends here too
    if (!cont) write_row<V>(og, n_rows, kh, hs + (long long)b * V);
  } else if (cont) {
    return;  // one run that started earlier: its owner adds this chunk
  }
  // the last run starts in this chunk: add the chunks it spans, in order
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = ts[(long long)b * V + v];
  for (int c = b + 1; c < n_chunks && hk[c] == kt; ++c) {
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] += hs[(long long)c * V + v];
    if (tk[c] != kt) break;
  }
  write_row<V>(og, n_rows, kt, s);
}

// The zero fill and the two passes; returns the first CUDA error.
template <class Loader>
cudaError_t segment_scan(const Loader& load, const int* keys, float* out,
                         int* head_key, int* tail_key, float* head_sum,
                         float* tail_sum, int G, long long K, int n_rows,
                         cudaStream_t stream) {
  constexpr int V = Loader::kWidth;
  if (G == 0 || n_rows == 0) return cudaSuccess;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)G * (size_t)V * (size_t)n_rows * sizeof(float), stream);
  if (err != cudaSuccess || K == 0) return err;
  const int n_chunks = (int)((K + kChunk - 1) / kChunk);
  const dim3 grid1((n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock, G);
  scan_chunk_kernel<Loader><<<grid1, kWarpsPerBlock * kWarp, 0, stream>>>(
      load, keys, out, head_key, tail_key, head_sum, tail_sum, K, n_rows,
      n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((n_chunks + kBoundaryThreads - 1) / kBoundaryThreads, G);
  scan_boundary_kernel<V><<<grid2, kBoundaryThreads, 0, stream>>>(
      head_key, tail_key, head_sum, tail_sum, out, n_rows, n_chunks);
  return cudaGetLastError();
}

}  // namespace
