// E2: the evaluator's nearest-neighbour search, every image of one
// `nn_metrics` call in one launch.
//
// Replaces no TPU kernel: the JAX package searches in numpy on the host
// (`find_nearest_neighbour`, virus_nerf_tpu/evaluation/geometry.py:17),
// one image at a time over a (K, M, 2) difference tensor, and the port did
// too.
//
// Inputs (ops/nn_search.py prepares them on the host):
//   pos   (N, K, 2) float32: each image's query points x, y;
//   ref   (N, M, 2) float32: each image's reference points.
// Outputs, per query:
//   idx   (N, K) int32: the index of its nearest reference point within its
//         image's set, or -1;
//   dist  (N, K) float32: the distance to it, or NaN.
// A row with a NaN coordinate is no point: a NaN reference is skipped, a
// NaN query gets -1 / NaN, and so does every query of an image with no
// valid reference (numpy's early return gives the same).
//
// One thread a query; the grid spans ceil(K / kThreads) query tiles times
// N images.  A block stages its image's reference points through shared
// memory, kTile at a time, so M has no limit (a LiDAR scan packs
// thousands of points an image, a USS or ToF scan a few dozen), and each
// thread scans them in ascending index order keeping (best d^2, index).
//
// Bit for bit with numpy.  numpy forms d^2 = (rx - qx)^2 + (ry - qy)^2 in
// float32, each operation rounded once: here `__fsub_rn`, `__fmul_rn` and
// `__fadd_rn`, which nvcc never contracts into a fused multiply-add.
// `np.argmin` takes the first minimum, so a later point replaces the best
// only on a strict `<`; a NaN d^2 (from inf - inf) is the minimum to
// argmin, so the first one wins and stays.  The distance is
// `np.linalg.norm` of the same difference, the correctly rounded square
// root (`__fsqrt_rn`) of the same d^2.
//
// Bound on this card: launches.  At the evaluator's size (16 images of 512
// queries and 512 references) the inputs are 131 KB and the search 4.2 M
// point pairs, a few float operations each.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // queries a block
constexpr int kTile = 1024;    // reference points staged at a time

__global__ void __launch_bounds__(kThreads)
nn_search_kernel(const float2* __restrict__ pos, int k,
                 const float2* __restrict__ ref, int m,
                 int* __restrict__ idx, float* __restrict__ dist) {
  __shared__ float tile_x[kTile];
  __shared__ float tile_y[kTile];
  const long long image = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const float2* image_ref = ref + image * m;
  float qx = __int_as_float(0x7fc00000), qy = qx;
  if (q < k) {
    const float2 p = pos[image * k + q];
    qx = p.x;
    qy = p.y;
  }
  const bool live = !(isnan(qx) || isnan(qy));
  float best = 0.0f;
  int best_i = -1;
  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    __syncthreads();  // every thread is done with the last tile
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float2 r = image_ref[base + j];
      tile_x[j] = r.x;
      tile_y[j] = r.y;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float rx = tile_x[j], ry = tile_y[j];
      if (isnan(rx) || isnan(ry)) continue;
      const float dx = __fsub_rn(rx, qx), dy = __fsub_rn(ry, qy);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (best_i < 0 || d2 < best || (isnan(d2) && !isnan(best))) {
        best = d2;
        best_i = base + j;
      }
    }
  }
  if (q < k) {
    idx[image * k + q] = best_i;
    dist[image * k + q] =
        best_i < 0 ? __int_as_float(0x7fc00000) : __fsqrt_rn(best);
  }
}

}  // namespace

extern "C" int vn_nn_search(const void* pos, int k, const void* ref, int m,
                            int n, void* idx, void* dist, void* stream) {
  if (n > 0 && k > 0) {
    dim3 grid((k + kThreads - 1) / kThreads, n);
    nn_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(pos), k, static_cast<const float2*>(ref), m,
        static_cast<int*>(idx), static_cast<float*>(dist));
  }
  return static_cast<int>(cudaGetLastError());
}
