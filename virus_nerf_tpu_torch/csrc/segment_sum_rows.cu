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
// Design: the chunked segmented reduction of segment_scan.cuh (zero fill,
// one warp per 512-entry chunk with a segmented shuffle scan, an ordered
// join of the runs that cross chunk boundaries; deterministic, no
// atomics), whose time does not follow the longest segment: the XOR
// stream is skewed (the densest level spreads 8 * 114,688 samples over
// 4,096 rows).  Each lane loads one entry's F floats (one coalesced
// 8-byte load at F = 2).
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

#include "segment_scan.cuh"

namespace {

template <int F>
struct RowLoader {
  static constexpr int kWidth = F;
  const float* vals;
  long long K;

  __device__ __forceinline__ void operator()(int g, long long i,
                                             float* s) const {
    const float* v = vals + ((long long)g * K + i) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) s[f] = __ldg(v + f);
  }
};

}  // namespace

// Stream entries per chunk: the wrappers size the scratch with it.
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
  switch (F) {
#define VN_ROWS_CASE(F_)                                                    \
  case F_:                                                                  \
    return segment_scan(RowLoader<F_>{vals, K}, keys, out, head_key,        \
                        tail_key, head_sum, tail_sum, G, K, n_rows, stream);
    VN_ROWS_CASE(1)
    VN_ROWS_CASE(2)
    VN_ROWS_CASE(4)
    VN_ROWS_CASE(8)
#undef VN_ROWS_CASE
    default: return cudaErrorInvalidValue;
  }
}
