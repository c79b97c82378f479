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
// group; a row no key hits is 0 and a key outside [0, n_rows) is dropped.
// The sums are stored as (G, n_rows, F) rows, the hash table's own layout
// (the wrapper returns them as the transposed (G, F, n_rows) view): the
// TPU kernel's (F, n_rows) planes were a lane rule of the TPU
// (segment_sum_pallas.py:17-23), and the XOR hash encoder's backward
// (virus_nerf_tpu/ops/hash_encoder.py:1005) wants table rows.
//
// Design: the row-tile core of segment_tiles.cuh, shared with B1 and B4
// (two launches: the tiles' windows and the chunk partials of long
// windows, then one CTA per tile of rows summing its window by warp scans
// into shared memory and storing it once; deterministic, no atomics, no
// zero fill).  The loader reads the row-major stream: lane i of a warp
// loads entry i's F floats, one 8-byte load at F = 2, so a warp's loads
// are one contiguous run, and the warp has the next 2 steps' loads in
// flight while it sums 2 (0.140 -> 0.127 ms a step, against loading each
// step as it is summed; 4 steps took 117-127 registers).  A tile is R rows
// of all F features, stored as one run of R * F floats in 16-byte stores.
//
// Two tile shapes, chosen per call by the stream's density
// (ops/segment_sum.py:row_tiles_dense): the sparse tiles, R = kSparseRows,
// where the window of such a tile averages at most C = kRowShortWindow
// entries, and the dense tiles, R = kDenseRows, elsewhere.  On the XOR
// path's hashed group (~2 entries a row) a 512-row tile holds ~1,000
// entries and its fixed latency (window, zeroing, three barriers) weighs
// on 10,240 CTAs a call; 1,024 rows with C = 8192 ran fastest of R in
// {512, 1024, 2048} and C in {2048, 4096, 8192}, and a C below the
// windows' length sent every tile down the partials path.  On the merged
// dense levels (~12 entries a row, one group of 467,152 rows) the coarse
// levels' tiles have long windows, whose per-row work waits on dependent
// loads: 128 rows give the card 3,650 CTAs to spread it over, against 457
// at 1,024 rows; 128 beat 256, 512 and 1,024
// (tools/torch_kernel_variants.py).  At F > 2 the tiles
// shrink so that the accumulator and a long window's row bounds fit in 32
// KB.
//
// The first design zero-filled the output, scanned 512-entry chunks
// and stored each run's F sums at stride n_rows, one 4-byte store per
// feature; a third launch joined the runs that crossed chunk boundaries.
//
// One deliberate difference from the TPU kernel: values are read in
// float32, not bf16 (the bf16 stream was a TPU bandwidth choice,
// segment_sum_pallas.py:61-69; the JAX CPU reference is float32).
//
// Bound on this card: bytes.  It reads each value and key once and writes
// each output once.  For the XOR path's hashed group (G = 10, K =
// 1,048,576, F = 2, 524,288 rows): 83.9 MB of values + 41.9 MB of keys +
// 41.9 MB of output = 168 MB, 0.050 ms at 3.35 TB/s.  The tiles move all
// of it; launch 1 reads only its searches' and probes' keys, and, for a
// chunk a long window reaches, the chunk.

#include "segment_tiles.cuh"

namespace {

constexpr int kSparseRows = 1024;      // R of a sparse stream's tiles
constexpr int kDenseRows = 128;        // R of a dense stream's tiles
constexpr int kRowShortWindow = 8192;  // C: longer windows use the partials

// largest power of two <= x (x >= 1)
constexpr int floor_pow2(int x) { return x < 2 ? 1 : 2 * floor_pow2(x / 2); }

// rows of a tile at F features: at most `cap`, and the accumulator (F
// floats a row) and a long window's row bounds (8 bytes a row) within
// kTileFloats floats of shared memory
__host__ __device__ constexpr int row_tile_rows(int F, int cap) {
  return floor_pow2(tiles::kTileFloats / (F + 2)) < cap
             ? floor_pow2(tiles::kTileFloats / (F + 2))
             : cap;
}

template <int F, int Rows>
struct RowLoader {
  static constexpr int kWidth = F;
  static constexpr int kSlice = F;
  static constexpr int kRows = Rows;
  static constexpr int kShortWindow = kRowShortWindow;
  static constexpr int kPrefetch = 2;
  static constexpr bool kRowMajor = true;
  const float* vals;  // 4F-byte aligned (the wrapper checks)
  long long K;

  __device__ __forceinline__ void operator()(int g, int, long long i,
                                             float* s) const {
    const float* v = vals + ((long long)g * K + i) * F;
    if constexpr (F == 1) {
      s[0] = __ldg(v);
    } else if constexpr (F == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(v));
      s[0] = q.x;
      s[1] = q.y;
    } else {
#pragma unroll
      for (int f = 0; f < F; f += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(v + f));
        s[f] = q.x;
        s[f + 1] = q.y;
        s[f + 2] = q.z;
        s[f + 3] = q.w;
      }
    }
  }
};

template <int F>
int dispatch(const float* vals, const int* keys, float* out, float* part,
             long long* starts, int G, long long K, int n_rows, int dense,
             cudaStream_t stream) {
  constexpr int kSparse = row_tile_rows(F, kSparseRows);
  constexpr int kDense = row_tile_rows(F, kDenseRows);
  if (dense) {
    return tiles::segment_tiles(RowLoader<F, kDense>{vals, K}, keys, part,
                                starts, out, G, K, n_rows, stream);
  }
  return tiles::segment_tiles(RowLoader<F, kSparse>{vals, K}, keys, part,
                              starts, out, G, K, n_rows, stream);
}

}  // namespace

// The row loader's tile shape: the wrapper and the CPU emulation read it
// (ops/segment_sum.py).
extern "C" int vn_segment_rows_tile_rows(int F, int dense) {
  return row_tile_rows(F, dense ? kDenseRows : kSparseRows);
}
extern "C" int vn_segment_rows_short_window() { return kRowShortWindow; }

// out: (G, n_rows, F) float32, every element written; part: (G, K, F)
// float32 scratch; starts: (G, ceil(n_rows / R) + 1) int64 scratch, R =
// vn_segment_rows_tile_rows(F, dense).  Returns the first CUDA error of
// the two launches (cudaErrorInvalidValue for an F without an
// instantiation; the Python wrapper checks F first).
extern "C" int vn_segment_sum_rows(const float* vals, const int* keys,
                                   float* out, float* part, long long* starts,
                                   int G, int F, long long K, int n_rows,
                                   int dense, cudaStream_t stream) {
  switch (F) {
#define VN_ROWS_CASE(F_)                                                   \
  case F_:                                                                 \
    return dispatch<F_>(vals, keys, out, part, starts, G, K, n_rows, dense, \
                        stream);
    VN_ROWS_CASE(1)
    VN_ROWS_CASE(2)
    VN_ROWS_CASE(4)
    VN_ROWS_CASE(8)
#undef VN_ROWS_CASE
    default: return cudaErrorInvalidValue;
  }
}
