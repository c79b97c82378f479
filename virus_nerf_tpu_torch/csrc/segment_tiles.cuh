// Row-tile segment sum over a key-sorted stream: the shared core of the
// transposed segment sum (segment_sum.cu, B1), the row-major segment sum
// (segment_sum_rows.cu, B3) and the fused factor segment sum
// (segment_sum_factors.cu, B4).
//
//     out[g, v, r] = sum_{i : keys[g, i] == r} value(g, i)[v],  v < V
//
// keys (G, K) int32 sorted ascending per group, out (G, V, n_rows) float32
// planes, or (G, n_rows, V) rows for a row-major loader; a row no key hits
// is 0 and a key outside [0, n_rows) is dropped; no float atomics, so the
// result is deterministic.  A Loader gives the values of stream entry
// (g, i) for one group of kSlice = min(V, 8) planes, and carries the
// tile's shape: kRows (R, the rows a CTA owns), kShortWindow (C, the
// longest window a CTA scans itself), kPrefetch (the warp scan's steps in
// flight) and kRowMajor (the store layout).  B1 and B4 take R =
// tile_rows(V), C = kShortWindow, no prefetch and planes; B3 its own
// (segment_sum_rows.cu).
//
// Design: the TPU kernels' block ownership (segment_sum_pallas.py:245-330:
// one grid step owns B output rows, reads only its window of the sorted
// stream, accumulates on chip and writes its block once), with a
// segmented warp scan inside, and per-chunk partials for long windows, so
// that the time does not follow the longest segment.
//
// Launch 1, one warp per kChunk = 512 stream entries and plane group of
// kSlice planes (blockIdx.z), plus one warp per tile boundary:
// - the tiles' windows.  Warp t writes starts[t], the first entry whose
//   key is at or above tile t's first row (n_rows for t = n_tiles), by a
//   32-ary search (5 dependent loads over 6 M keys), so [starts[t],
//   starts[t + 1]) is tile t's window: the TPU kernel's `starts`,
//   computed in the kernel.  (A first version searched each tile's window
//   in its own CTA, on the tile's critical path: on the sparse hashed
//   levels that was most of a tile's latency.  One thread per entry
//   writing the starts of the tiles it opens read every key once more and
//   took 2-4x a plain read of them; one thread per boundary with a binary
//   search waited on 20-23 dependent loads.)
// - the chunk partials.  A chunk that overlaps no long window leaves (only
//   the windows of the tiles of its first and last key can reach past it):
//   two probes C / 2 entries either side of its first and of its last
//   entry, loaded at once, settle most chunks; the others search the
//   window (one warp-wide search and one probe).  Any other chunk scans
//   itself for its plane group and writes the sum of every run piece (a
//   run cut at the chunk's ends) to scratch at the piece's last stream
//   position: part[g, i, :] (G, K, V) float32, which the wrapper allocates
//   (torch.empty) and which is read only where written.  (One warp for all
//   plane groups of a chunk, checking the windows once, took B1 from 0.074
//   to 0.12 ms on chip_smoke's merged dense stream.)  A row's sum is then
//   the sum over the chunks c its segment [a, b) spans of
//   part[g, min(b, (c + 1) * kChunk) - 1].
//
// Launch 2, the tiles: one CTA of 8 warps owns R consecutive rows of one
// group for VC = min(V, 32) planes (V / VC CTAs over blockIdx.z).  For B1
// and B4, R = min(512, 8192 / VC): 256 rows (1 KB per plane) at 32 planes,
// 512 at 16.  A tile's fixed latency (reading its window, three barriers)
// is paid once per R rows: at 32 planes 256 rows took 20-30 % less time
// than 128 on the hashed levels, and the 32 KB accumulator still fits
// static shared memory.
// - A (VC, R) float32 accumulator in shared memory starts at 0: rows no
//   key hits stay 0, and the output needs no zero fill.  A row-major
//   loader keeps it as (R, VC), the layout of its output.
// - A short window (at most C entries): the VC planes fall into P = VC /
//   kSlice plane groups and the window into 8 / P contiguous pieces; warp
//   w scans piece w / P for plane group w % P.  The scan takes 32 entries
//   a step (lanes load consecutive entries: coalesced) and keeps 2 x
//   kSlice floats a lane, the value and the carry: 40-48 registers, 5 CTAs
//   an SM.  (A first version scanned all 32 planes in one warp, needed
//   ~100 registers and fitted 2 CTAs on an SM; for B1 loading the next
//   step ahead cost 16 registers and a CTA an SM, and won on dense windows
//   what it lost on the sparse hashed ones.  B3's 2 planes load 2 steps
//   ahead.)  A run that ends inside a piece is stored into its row of the
//   accumulator; the pieces' first and last runs, which may cross a piece
//   boundary, are joined in piece order by warp 0 after a
//   __syncthreads().  Each row is stored by exactly one warp.  The cut C
//   bounds a warp's serial steps (C / 32 / (8 / P)); the merged dense
//   streams of chip_smoke ran B1 fastest at 2048 of 1024, 2048 and 4096.
// - A long window (the skewed dense levels; one row holding most of the
//   stream) is filled row by row from the chunk partials: the CTA finds
//   every row's segment [a, b) by a binary search per row (one thread
//   each), and the row's partials of the chunks the segment spans are
//   added in a fixed order: by one thread per 4 planes for a row over few
//   chunks, by a warp (lanes over chunks, then a butterfly) for a row over
//   many.  A segment of n entries costs n / kChunk partial reads, split
//   over the lanes.
// - The tile is stored once: for each plane, consecutive threads store
//   consecutive rows, 16 bytes a thread where n_rows % 4 == 0; a
//   row-major tile is one contiguous run of R * V floats, stored in 16
//   bytes a thread where the run is 16-byte aligned.
//
// Two launches per call, for an empty stream too.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {
namespace tiles {

constexpr int kWarp = 32;
constexpr int kTileFloats = 8192;    // accumulator of a CTA: 32 KB
constexpr int kMaxTileRows = 512;
constexpr int kTileWarps = 8;
constexpr int kTileThreads = kTileWarps * kWarp;
constexpr int kTilePlanes = 32;      // planes per CTA (blockIdx.z slices)
constexpr int kScanPlanes = 8;       // planes per warp scan
constexpr int kShortWindow = 2048;   // C of B1 and B4: longer windows use the partials
constexpr int kChunk = 512;          // entries per warp in the chunk launch
constexpr int kChunkWarps = 8;
constexpr int kSerialJoin = 8;       // chunks a row joins without a shuffle tree
constexpr unsigned kFull = 0xffffffffu;

// planes a warp scans at once, and planes a CTA owns, for V planes
__host__ __device__ constexpr int scan_planes(int V) {
  return V < kScanPlanes ? V : kScanPlanes;
}
__host__ __device__ constexpr int tile_planes(int V) {
  return V < kTilePlanes ? V : kTilePlanes;
}
// rows a CTA of B1 or B4 owns for V planes: 256 at 32 planes, 512 at 16
// or fewer
__host__ __device__ constexpr int tile_rows(int V) {
  return kTileFloats / tile_planes(V) < kMaxTileRows
             ? kTileFloats / tile_planes(V)
             : kMaxTileRows;
}

// lower bound of `value` in the sorted kg[lo, hi), one thread
__device__ __forceinline__ long long lower_bound(const int* __restrict__ kg,
                                                 long long lo, long long hi,
                                                 int value) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(kg + mid) < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the same by a whole warp: 32 probes a round cut the range 32-fold, so
// 131,072 keys take 4 dependent loads, not 17.  Every lane returns it.
__device__ __forceinline__ long long warp_lower_bound(
    const int* __restrict__ kg, long long lo, long long hi, int value) {
  const int lane = threadIdx.x & (kWarp - 1);
  // invariant: the answer lies in [lo, hi]
  while (hi - lo > kWarp) {
    const long long step = (hi - lo + kWarp - 1) / kWarp;
    const long long q = lo + lane * step;
    const bool below = q < hi && __ldg(kg + q) < value;
    const int c = __popc(__ballot_sync(kFull, below));  // a prefix of lanes
    if (c == 0) return lo;
    const long long q_last = lo + (long long)(c - 1) * step;  // < value
    hi = min(hi, q_last + step);  // the first probe >= value, if any
    lo = q_last + 1;
  }
  const long long q = lo + lane;
  const bool below = q < hi && __ldg(kg + q) < value;
  return lo + __popc(__ballot_sync(kFull, below));
}

// Segmented sum of the stream entries [p0, p1) by one warp, 32 a step, for
// the loader's slice of planes.  emit(key, pos, s) is called by one lane
// for every run piece that ends before the last entry, with pos its last
// position and s its sums; the run open at the end (the last run) is
// returned: its key, and its sums in `carry` (the same in every lane).
// p0 < p1.  A loader with kPrefetch = D > 0 has the loads of the next D
// steps in flight while it sums D steps; with 0, each step loads its own.
template <class Loader, class Emit>
__device__ __forceinline__ int warp_scan(const Loader& load,
                                         const int* __restrict__ kg, int g,
                                         int slice, long long p0,
                                         long long p1, Emit&& emit,
                                         float* carry) {
  constexpr int S = Loader::kSlice;
  constexpr int D = Loader::kPrefetch;
  const int lane = threadIdx.x & (kWarp - 1);
  int carry_key = 0;
  bool have_carry = false;
#pragma unroll
  for (int v = 0; v < S; ++v) carry[v] = 0.0f;

  // lane l's entry of the step at base: its key (INT_MAX past p1) and sums
  auto fetch = [&](long long base, int& k, float* s) {
    const long long i = base + lane;
    if (i < p1) {
      k = __ldg(kg + i);
      load(g, slice, i, s);
    } else {
      k = INT_MAX;
#pragma unroll
      for (int v = 0; v < S; ++v) s[v] = 0.0f;
    }
  };
  // one step: lane l holds entry base + l
  auto step = [&](long long base, int k, float* s) {
    const int last = (int)min((long long)(kWarp - 1), p1 - 1 - base);
    const long long i = base + lane;

    // segmented inclusive scan: after the step of offset d, s holds the
    // sum over lanes (lane - 2d, lane] that share this lane's key
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int kd = __shfl_up_sync(kFull, k, d);
      const bool join = lane >= d && kd == k;
#pragma unroll
      for (int v = 0; v < S; ++v) {
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
          for (int v = 0; v < S; ++v) s[v] += carry[v];
        }
      } else if (lane == 0) {
        emit(carry_key, base - 1, carry);
      }
    }

    // runs that end inside this step
    const int kn = __shfl_down_sync(kFull, k, 1);
    if (lane < last && kn != k) emit(k, i, s);

    // the run open at the step's last valid lane is carried on
    carry_key = __shfl_sync(kFull, k, last);
#pragma unroll
    for (int v = 0; v < S; ++v) carry[v] = __shfl_sync(kFull, s[v], last);
    have_carry = true;
  };

  if constexpr (D == 0) {
    for (long long base = p0; base < p1; base += kWarp) {
      int k;
      float s[S];
      fetch(base, k, s);
      step(base, k, s);
    }
  } else {
    int kb[D];
    float sb[D][S];
    auto fetch_batch = [&](long long b0) {
#pragma unroll
      for (int d = 0; d < D; ++d) fetch(b0 + d * kWarp, kb[d], sb[d]);
    };
    fetch_batch(p0);
    for (long long b0 = p0; b0 < p1; b0 += D * kWarp) {
      int k[D];
      float s[D][S];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        k[d] = kb[d];
#pragma unroll
        for (int v = 0; v < S; ++v) s[d][v] = sb[d][v];
      }
      if (b0 + D * kWarp < p1) fetch_batch(b0 + D * kWarp);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (b0 + d * kWarp >= p1) break;
        step(b0 + d * kWarp, k[d], s[d]);
      }
    }
  }
  return carry_key;
}

template <int S>
__device__ __forceinline__ void store_sums(float* __restrict__ dst,
                                           const float* s) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int v = 0; v < S; v += 4) {
      *reinterpret_cast<float4*>(dst + v) =
          make_float4(s[v], s[v + 1], s[v + 2], s[v + 3]);
    }
  } else if constexpr (S == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(s[0], s[1]);
  } else {
#pragma unroll
    for (int v = 0; v < S; ++v) dst[v] = s[v];
  }
}

// the tile of R rows of a key: -1 below the rows, n_tiles at or above
// n_rows
template <int R>
__device__ __forceinline__ int tile_of(int key, int n_rows, int n_tiles) {
  return key < 0 ? -1 : key >= n_rows ? n_tiles : key / R;
}

// Is the window of tile t of R rows longer than C entries?  (whole warp)
template <int R, int C>
__device__ __forceinline__ bool long_window(const int* __restrict__ kg,
                                            long long K, int n_rows, int t) {
  const int r0 = t * R;
  const long long lo = warp_lower_bound(kg, 0, K, r0);
  const long long end = min(lo + C + 1, K);
  // more than C entries below the tile's end iff entry lo + C is below it
  return end - lo > C && __ldg(kg + lo + C) < min(r0 + R, n_rows);
}

// Is it certainly not, from the keys ka and kb at the entries C / 2
// before and after an entry of its window (INT_MIN and INT_MAX past the
// stream's ends)?  The window starts after the first if ka lies below the
// tile, and ends by the second if kb lies at or above it.
template <int R>
__device__ __forceinline__ bool surely_short(int ka, int kb, int n_rows,
                                             int t) {
  const int r0 = t * R;
  return ka < r0 && kb >= min(r0 + R, n_rows);
}

// element (plane v, row r) of a tile's accumulator of VC planes and R
// rows: planes of R rows, or rows of VC planes for a row-major store
template <bool RowMajor, int VC, int R>
__device__ __forceinline__ float& acc_at(float* acc, int v, int r) {
  if constexpr (RowMajor) {
    return acc[r * VC + v];
  } else {
    return acc[v * R + r];
  }
}

template <class Loader>
__global__ void __launch_bounds__(kChunkWarps * kWarp)
chunk_kernel(Loader load, const int* __restrict__ keys,
             float* __restrict__ part, long long* __restrict__ starts,
             long long K, int n_rows, long long n_chunks,
             unsigned chunk_blocks) {
  constexpr int S = Loader::kSlice;
  constexpr int V = Loader::kWidth;
  constexpr int R = Loader::kRows;
  constexpr int C = Loader::kShortWindow;
  const int g = blockIdx.y;
  const int* kg = keys + (long long)g * K;
  const int n_tiles = (n_rows + R - 1) / R;
  if (blockIdx.x >= chunk_blocks) {
    // the windows: warp t finds the first entry at or above tile t's
    // first row (at or above n_rows for t = n_tiles)
    if (blockIdx.z != 0) return;
    const long long t = (long long)(blockIdx.x - chunk_blocks) * kChunkWarps +
                        threadIdx.x / kWarp;
    if (t > n_tiles) return;  // the whole warp leaves together
    const long long first =
        warp_lower_bound(kg, 0, K, (int)min(t * R, (long long)n_rows));
    if ((threadIdx.x & (kWarp - 1)) == 0) {
      starts[(long long)g * (n_tiles + 1) + t] = first;
    }
    return;
  }
  const long long chunk =
      (long long)blockIdx.x * kChunkWarps + (threadIdx.x / kWarp);
  const int slice = blockIdx.z;
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  const long long c0 = chunk * kChunk;
  const long long c1 = min(c0 + kChunk, K);
  // the chunk's first and last key, and the probes C / 2 entries either
  // side of its first and last entry, all in flight at once
  auto key_at = [&](long long i) {
    return i < 0 ? INT_MIN : i >= K ? INT_MAX : __ldg(kg + i);
  };
  const int kf = __ldg(kg + c0);
  const int kl = __ldg(kg + c1 - 1);
  const int kfa = key_at(c0 - C / 2), kfb = key_at(c0 + C / 2);
  const int kla = key_at(c1 - 1 - C / 2), klb = key_at(c1 - 1 + C / 2);
  if (kl < 0 || kf >= n_rows) return;  // every key out of range
  // only the tiles of the chunk's first and last key have windows that
  // reach past it; a tile in between lies inside the chunk: short.  The
  // probes settle most chunks; the others search the window.
  const int tf = max(kf, 0) / R;
  const int tl = min(kl, n_rows - 1) / R;
  const bool short_f = surely_short<R>(kfa, kfb, n_rows, tf) ||
                       !long_window<R, C>(kg, K, n_rows, tf);
  if (short_f && (tl == tf || surely_short<R>(kla, klb, n_rows, tl) ||
                  !long_window<R, C>(kg, K, n_rows, tl))) {
    return;
  }

  float* pg = part + (long long)g * K * V + slice * S;
  auto emit = [&](int key, long long pos, const float* s) {
    if (key >= 0 && key < n_rows) store_sums<S>(pg + pos * V, s);
  };
  float carry[S];
  const int last_key = warp_scan(load, kg, g, slice, c0, c1, emit, carry);
  if ((threadIdx.x & (kWarp - 1)) == 0) emit(last_key, c1 - 1, carry);
}

template <class Loader>
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(Loader load, const int* __restrict__ keys,
            const float* __restrict__ part,
            const long long* __restrict__ starts, float* __restrict__ out,
            long long K, int n_rows) {
  constexpr int V = Loader::kWidth;
  constexpr int S = Loader::kSlice;       // planes of one warp scan
  constexpr int VC = tile_planes(V);      // planes of this CTA
  constexpr int R = Loader::kRows;        // rows of this CTA
  constexpr int C = Loader::kShortWindow; // longest window scanned here
  constexpr bool kRowMajor = Loader::kRowMajor;
  constexpr int P = VC / S;               // plane groups of this CTA
  constexpr int Q = kTileWarps / P;       // pieces of the window per group
  static_assert(VC % S == 0 && kTileWarps % P == 0, "whole plane groups");
  static_assert(!kRowMajor || VC == V, "a row-major tile holds every plane");
  __shared__ __align__(16) float acc[VC * R];
  __shared__ float head_sum[kTileWarps][S];
  __shared__ float tail_sum[kTileWarps][S];
  __shared__ int head_key[kTileWarps];
  __shared__ int tail_key[kTileWarps];
  __shared__ long long bound[R + 1];

  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int r0 = t * R;
  const int rows = min(R, n_rows - r0);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int* kg = keys + (long long)g * K;

  const long long* sg = starts + (long long)g * (gridDim.x + 1) + t;
  const long long lo = sg[0];
  const long long hi = sg[1];
  const long long n = hi - lo;
  for (int e = threadIdx.x; e < VC * R / 4; e += kTileThreads) {
    reinterpret_cast<float4*>(acc)[e] = make_float4(0, 0, 0, 0);
  }
  __syncthreads();

  if (n <= C) {
    // warp w scans piece w / P of the window for plane group w % P; the
    // pieces are contiguous, whole 32-entry steps but the last
    const int pgrp = warp % P;
    const int piece_id = warp / P;
    const long long per = (n + Q - 1) / Q;
    const long long piece = (per + kWarp - 1) / kWarp * kWarp;
    const long long p0 = min(lo + piece_id * piece, hi);
    const long long p1 = min(p0 + piece, hi);
    if (p0 < p1) {
      const int first_key = __ldg(kg + p0);
      auto emit = [&](int key, long long, const float* s) {
        if (key == first_key) {
          // the piece's first run may have begun in the piece before
#pragma unroll
          for (int v = 0; v < S; ++v) head_sum[warp][v] = s[v];
        } else if constexpr (kRowMajor) {
          store_sums<S>(acc + (key - r0) * VC + pgrp * S, s);
        } else {
#pragma unroll
          for (int v = 0; v < S; ++v) acc[(pgrp * S + v) * R + key - r0] = s[v];
        }
      };
      float carry[S];
      const int last_key = warp_scan(load, kg, g, blockIdx.z * P + pgrp, p0,
                                     p1, emit, carry);
      if (lane == 0) {
        head_key[warp] = first_key;
        tail_key[warp] = last_key;
#pragma unroll
        for (int v = 0; v < S; ++v) {
          tail_sum[warp][v] = carry[v];
          if (last_key == first_key) head_sum[warp][v] = carry[v];
        }
      }
    } else if (lane == 0) {
      head_key[warp] = tail_key[warp] = INT_MIN;  // an empty piece
    }
    __syncthreads();
    // join the pieces' first and last runs in order; lane l of warp 0
    // keeps plane l % S of group l / S for the run still open
    if (warp == 0 && lane < VC) {
      const int grp = lane / S;
      const int v = lane % S;
      int open_key = INT_MIN;
      float open = 0.0f;
      for (int q = 0; q < Q; ++q) {
        const int w = q * P + grp;
        const int hk = head_key[w];
        if (hk == INT_MIN) break;  // empty pieces are the last ones
        const int tk = tail_key[w];
        if (hk == open_key) {
          open += head_sum[w][v];
        } else {
          if (open_key != INT_MIN) {
            acc_at<kRowMajor, VC, R>(acc, lane, open_key - r0) = open;
          }
          open_key = hk;
          open = head_sum[w][v];
        }
        if (tk != hk) {
          acc_at<kRowMajor, VC, R>(acc, lane, open_key - r0) = open;
          open_key = tk;
          open = tail_sum[w][v];
        }
      }
      if (open_key != INT_MIN) {
        acc_at<kRowMajor, VC, R>(acc, lane, open_key - r0) = open;
      }
    }
  } else {
    // a long window: every row's segment, then its chunks' partials
    for (int r = threadIdx.x; r <= rows; r += kTileThreads) {
      bound[r] = r == rows ? hi : lower_bound(kg, lo, hi, r0 + r);
    }
    __syncthreads();
    const float* pg = part + (long long)g * K * V + blockIdx.z * VC;
    // a row over few chunks: one thread per (row, 4 planes), chunks in
    // order; the rows' loads are independent, so they overlap
    constexpr int kVec = VC % 4 == 0 ? 4 : 1;
    for (int e = threadIdx.x; e < rows * (VC / kVec); e += kTileThreads) {
      const int r = e / (VC / kVec);
      const int v0 = (e % (VC / kVec)) * kVec;
      const long long a = bound[r];
      const long long b = bound[r + 1];
      if (a == b || (b - 1) / kChunk - a / kChunk >= kSerialJoin) continue;
      float sum[kVec] = {};
      for (long long c = a / kChunk; c * kChunk < b; ++c) {
        const float* p = pg + (min(b, (c + 1) * kChunk) - 1) * V + v0;
        if constexpr (kVec == 4) {
          const float4 q = *reinterpret_cast<const float4*>(p);
          sum[0] += q.x;
          sum[1] += q.y;
          sum[2] += q.z;
          sum[3] += q.w;
        } else {
          sum[0] += *p;
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        acc_at<kRowMajor, VC, R>(acc, v0 + j, r) = sum[j];
      }
    }
    // a row over many chunks: one warp
    for (int r = warp; r < rows; r += kTileWarps) {
      const long long a = bound[r];
      const long long b = bound[r + 1];
      const long long cl = a / kChunk;
      const long long ch = (b - 1) / kChunk;
      if (a == b || ch - cl < kSerialJoin) continue;
      // lanes over chunks, then a butterfly over the lanes, one plane
      // group at a time; plane v is taken from lane v, so the order is
      // fixed by the data alone
      for (int grp = 0; grp < P; ++grp) {
        float s[S];
#pragma unroll
        for (int v = 0; v < S; ++v) s[v] = 0.0f;
#pragma unroll 4
        for (long long c = cl + lane; c <= ch; c += kWarp) {
          const float* p = pg + (min(b, (c + 1) * kChunk) - 1) * V + grp * S;
#pragma unroll
          for (int v = 0; v < S; ++v) s[v] += p[v];
        }
#pragma unroll
        for (int d = kWarp / 2; d > 0; d >>= 1) {
#pragma unroll
          for (int v = 0; v < S; ++v) s[v] += __shfl_xor_sync(kFull, s[v], d);
        }
#pragma unroll
        for (int v = 0; v < S; ++v) {
          if (v == lane) acc_at<kRowMajor, VC, R>(acc, grp * S + v, r) = s[v];
        }
      }
    }
  }
  __syncthreads();

  if constexpr (kRowMajor) {
    // store the tile once: its rows * V floats are one run of the output
    float* og = out + ((long long)g * n_rows + r0) * V;
    const int n_floats = rows * V;
    const int quads =
        (reinterpret_cast<uintptr_t>(og) & 15) == 0 ? n_floats / 4 : 0;
    for (int e = threadIdx.x; e < quads; e += kTileThreads) {
      reinterpret_cast<float4*>(og)[e] = reinterpret_cast<const float4*>(acc)[e];
    }
    for (int e = 4 * quads + threadIdx.x; e < n_floats; e += kTileThreads) {
      og[e] = acc[e];
    }
  } else {
    // store the tile once: plane by plane, consecutive rows
    float* og =
        out + ((long long)g * V + (long long)blockIdx.z * VC) * n_rows + r0;
    if (n_rows % 4 == 0) {
      constexpr int kQuads = R / 4;
      for (int e = threadIdx.x; e < VC * kQuads; e += kTileThreads) {
        const int v = e / kQuads;
        const int q = 4 * (e % kQuads);
        if (q < rows) {
          *reinterpret_cast<float4*>(og + (long long)v * n_rows + q) =
              *reinterpret_cast<const float4*>(acc + v * R + q);
        }
      }
    } else {
      for (int e = threadIdx.x; e < VC * R; e += kTileThreads) {
        const int v = e / R;
        const int r = e % R;
        if (r < rows) og[(long long)v * n_rows + r] = acc[v * R + r];
      }
    }
  }
}

// The two launches; returns the first CUDA error.  part: (G, K, V)
// float32 scratch; starts: (G, ceil(n_rows / Loader::kRows) + 1) int64
// scratch.
template <class Loader>
cudaError_t segment_tiles(const Loader& load, const int* keys, float* part,
                          long long* starts, float* out, int G, long long K,
                          int n_rows, cudaStream_t stream) {
  constexpr int V = Loader::kWidth;
  constexpr int kThreads = kChunkWarps * kWarp;
  static_assert(Loader::kSlice == scan_planes(V), "the loader's slice");
  static_assert(V % tile_planes(V) == 0, "whole CTA slices");
  static_assert(Loader::kRows % 4 == 0, "whole 16-byte quads of rows");
  if (G == 0 || n_rows == 0) return cudaSuccess;
  constexpr int R = Loader::kRows;
  const long long n_chunks = (K + kChunk - 1) / kChunk;
  const unsigned chunk_blocks =
      (unsigned)((n_chunks + kChunkWarps - 1) / kChunkWarps);
  const unsigned start_blocks =
      (unsigned)(((n_rows + R - 1) / R + kChunkWarps) / kChunkWarps);
  const dim3 grid1(chunk_blocks + start_blocks, G, V / scan_planes(V));
  chunk_kernel<Loader><<<grid1, kThreads, 0, stream>>>(
      load, keys, part, starts, K, n_rows, n_chunks, chunk_blocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((n_rows + R - 1) / R, G, V / tile_planes(V));
  tile_kernel<Loader><<<grid2, kTileThreads, 0, stream>>>(
      load, keys, part, starts, out, K, n_rows);
  return cudaGetLastError();
}

}  // namespace tiles
}  // namespace
