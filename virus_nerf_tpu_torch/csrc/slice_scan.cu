// E1: the evaluator's ground-truth slice scan, a simulated horizontal 2-D
// LiDAR on the slice raster of the ground-truth cloud.
//
// Replaces no TPU kernel: the JAX package runs this scan in numpy on the
// host (`Scene.get_slice_scan`, virus_nerf_tpu/data/scene.py:101), and the
// port did too.  There it materialises every sample of every ray (8192
// rays x 725 samples at res 512) before an argmax finds the first hit.
// Here a ray stops at its first occupied cell.
//
// Inputs (ops/slice_scan.py prepares them on the host):
//   cells   (P,) int32: each cloud point's raster cell ix * res + iy, the
//           points sorted by height, so a call's height band is the range
//           [lo, hi) of it;
//   rays    (N, 4) float64: origin x, y and direction cos, sin of each ray;
//   radii   (M,) float64: the sample distances, linspace(0, 1, M);
//   bits    ceil(res^2 / 32) words of scratch, the raster as bits.
// Output: hit (N,) int32, the cell of the ray's first occupied sample, or
// -1 where no sample is occupied.
//
// Three steps on the stream: the raster is zeroed; one thread a band point
// sets its cell's bit (atomicOr; a cell outside the raster is dropped, so a
// bad input cannot write past it); one warp a ray walks the samples 32 at a
// time, one lane a sample, and the `__ballot_sync` of the occupied lanes
// gives the first hit (`__ffs`), after which the ray stops.
//
// Bit for bit with numpy.  The sample k of a ray and its cell are
//     p = o + r[k] * d                         (x and y)
//     i = clamp(rint((res - 1) * (p - cube_min) / span), 0, res - 1)
// in numpy's order, each operation rounded once: `__dmul_rn`, `__dadd_rn`,
// `__dsub_rn`, `__ddiv_rn`, which nvcc never contracts into a fused
// multiply-add, and `rint` rounds half to even as `np.round` does.  The
// division is skipped where span is 1 (x / 1 is x, exactly).  The cell is
// then the one numpy's `c2idx` gives for every ray and sample, so the
// first hit is too.
//
// Bound on this card: launches.  The bytes are the band's cells (4 B a
// point), 36 B a ray and the raster twice (32 KB at res 512): under a
// megabyte at the evaluator's 8192 rays, 0.3 us at 3.35 TB/s.  The walk is
// at most ceil(M / 32) = 23 chunks of a few dependent float64 operations
// and one L1-resident load a lane; 8192 warps fill the card about once.
// Design: the lanes of a warp take consecutive samples of one ray, so the
// latency chain of a ray is M / 32 steps long, not M; nothing reaches
// device memory but the first hit.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRaysPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void slice_raster_kernel(const int* __restrict__ cells, int count,
                                    unsigned cell_count,
                                    unsigned* __restrict__ bits) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) {
    unsigned c = static_cast<unsigned>(cells[i]);
    if (c < cell_count) atomicOr(bits + (c >> 5), 1u << (c & 31));
  }
}

__device__ __forceinline__ int slice_cell(double p, double res_m1,
                                          double cube_min, double span,
                                          int res) {
  double t = __dmul_rn(res_m1, __dsub_rn(p, cube_min));
  if (span != 1.0) t = __ddiv_rn(t, span);
  int i = static_cast<int>(rint(t));  // NaN converts to 0, as numpy's clip
  return min(max(i, 0), res - 1);
}

__global__ void __launch_bounds__(kWarp * kRaysPerBlock)
slice_walk_kernel(const unsigned* __restrict__ bits,
                  const double* __restrict__ rays,
                  const double* __restrict__ radii, int m, int res,
                  double cube_min, double span, int n, int* __restrict__ hit) {
  int ray = blockIdx.x * kRaysPerBlock + threadIdx.x / kWarp;
  int lane = threadIdx.x % kWarp;
  if (ray >= n) return;  // the whole warp: one ray a warp
  const double ox = rays[4 * ray], oy = rays[4 * ray + 1];
  const double dx = rays[4 * ray + 2], dy = rays[4 * ray + 3];
  const double res_m1 = static_cast<double>(res - 1);
  int found = -1;
  for (int base = 0; base < m; base += kWarp) {
    int k = base + lane;
    int cell = 0;
    bool occupied = false;
    if (k < m) {
      double r = radii[k];
      double x = __dadd_rn(ox, __dmul_rn(r, dx));
      double y = __dadd_rn(oy, __dmul_rn(r, dy));
      cell = slice_cell(x, res_m1, cube_min, span, res) * res +
             slice_cell(y, res_m1, cube_min, span, res);
      occupied = (__ldg(bits + (cell >> 5)) >> (cell & 31)) & 1u;
    }
    unsigned ballot = __ballot_sync(kFull, occupied);
    if (ballot) {
      found = __shfl_sync(kFull, cell, __ffs(ballot) - 1);
      break;
    }
  }
  if (lane == 0) hit[ray] = found;
}

}  // namespace

extern "C" int vn_slice_scan(const void* cells, int count, void* bits,
                             int words, const void* rays, const void* radii,
                             int m, int res, double cube_min, double span,
                             void* hit, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bits, 0, sizeof(unsigned) * words, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count > 0) {
    slice_raster_kernel<<<(count + 255) / 256, 256, 0, s>>>(
        static_cast<const int*>(cells), count,
        static_cast<unsigned>(res) * static_cast<unsigned>(res),
        static_cast<unsigned*>(bits));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n > 0) {
    slice_walk_kernel<<<(n + kRaysPerBlock - 1) / kRaysPerBlock,
                        kWarp * kRaysPerBlock, 0, s>>>(
        static_cast<const unsigned*>(bits), static_cast<const double*>(rays),
        static_cast<const double*>(radii), m, res, cube_min, span, n,
        static_cast<int*>(hit));
  }
  return static_cast<int>(cudaGetLastError());
}
