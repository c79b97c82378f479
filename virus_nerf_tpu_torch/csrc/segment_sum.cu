// Dense segment sum over a key-sorted, transposed value stream.
//
// Replaces the TPU kernel `_ts_kernel`
// (virus_nerf_tpu/ops/segment_sum_pallas.py:231, entry
// `_sorted_group_segment_sum_ts_tpu` :542, contract
// `group_segment_sum_ts_sorted` :607):
//
//     out[g, f, r] = sum_{i : keys[g, i] == r} vals[g, f, i]
//
// vals (G, VF, K) float32, keys (G, K) int32 sorted ascending per group,
// out (G, VF, n_rows) float32; a row no key hits is 0 and a key outside
// [0, n_rows) is dropped.  The hash-encoder backward uses it for the
// widened table gradient before the roll fold.
//
// Design: the row-tile core of segment_tiles.cuh (one CTA per 256 output
// rows at VF >= 32, 512 below, window from the first launch, shared-memory accumulator, the
// segmented warp scan, partials of 512-entry chunks for long windows, the
// tile stored once; deterministic, no atomics, no zero fill).  The loader
// reads the transposed stream: lane i of a warp loads entry i of each
// plane of its group of 8, so every load is coalesced and a plane group
// reads only its own rows of vals (a CTA owns 32 planes: VF = 64 runs two
// CTAs per tile over blockIdx.z).  The first design ran one thread per
// output row, which walked its segment alone: on the skewed keys of
// training (a row of 3,824 samples, the top 1 % of rows holding 70 % of
// the samples) one thread set the time of its whole block.
//
// One deliberate difference from the TPU kernel: values are read in
// float32, not bf16.  The bf16 stream was a TPU bandwidth choice
// (segment_sum_pallas.py:61-69); the JAX CPU reference of the hash
// backward is float32 (hash_encoder.py:728-731).
//
// Bound on this card: bytes.  At the bench slice the hashed group writes
// G * VF * n_rows * 4 B = 5 * 32 * 524,288 * 4 B ~ 335 MB of widened
// gradient and reads ~73 MB of values and keys; the tile store writes each
// output element once, coalesced.  Fusing the 3-step roll fold into the
// tile store (F instead of 8F planes) is the next step, not taken here.

#include "segment_tiles.cuh"

namespace {

template <int VF>
struct TransposedLoader {
  static constexpr int kWidth = VF;
  static constexpr int kSlice = tiles::scan_planes(VF);
  static constexpr int kRows = tiles::tile_rows(VF);
  static constexpr int kShortWindow = tiles::kShortWindow;
  static constexpr int kPrefetch = 0;
  static constexpr bool kRowMajor = false;
  const float* vals;
  long long K;

  __device__ __forceinline__ void operator()(int g, int slice, long long i,
                                             float* s) const {
    const float* p = vals + ((long long)g * VF + slice * kSlice) * K + i;
#pragma unroll
    for (int v = 0; v < kSlice; ++v) s[v] = __ldg(p + (long long)v * K);
  }
};

}  // namespace

// The core's constants for B1 and B4: the wrappers and the CPU emulation
// of the algorithm read them (ops/segment_sum.py).
extern "C" int vn_segment_tiles_rows(int V) { return tiles::tile_rows(V); }
extern "C" int vn_segment_tiles_short_window() { return tiles::kShortWindow; }
extern "C" int vn_segment_tiles_chunk() { return tiles::kChunk; }
extern "C" int vn_segment_tiles_planes() { return tiles::kTilePlanes; }
extern "C" int vn_segment_tiles_scan_planes() { return tiles::kScanPlanes; }

// part: (G, K, VF) float32 scratch; starts: (G, ceil(n_rows / R) + 1)
// int64 scratch.  Returns the first CUDA error of the two launches
// (cudaErrorInvalidValue for a VF without an instantiation; the Python
// wrapper checks VF first).
extern "C" int vn_segment_sum_sorted(const float* vals, const int* keys,
                                     float* out, float* part,
                                     long long* starts, int G, int VF,
                                     long long K, int n_rows,
                                     cudaStream_t stream) {
  switch (VF) {
#define VN_SORTED_CASE(VF_)                                                 \
  case VF_:                                                                 \
    return tiles::segment_tiles(TransposedLoader<VF_>{vals, K}, keys, part, \
                                starts, out, G, K, n_rows, stream);
    VN_SORTED_CASE(1)
    VN_SORTED_CASE(2)
    VN_SORTED_CASE(4)
    VN_SORTED_CASE(8)
    VN_SORTED_CASE(16)
    VN_SORTED_CASE(32)
    VN_SORTED_CASE(64)
#undef VN_SORTED_CASE
    default: return cudaErrorInvalidValue;
  }
}
