// The exponential-step candidate lattice of the ray march.
//
// The port's own kernel: it has no Pallas counterpart.  It computes the
// `lax.scan` of `_candidate_lattice` (virus_nerf_tpu/ops/ray_march.py:88-116)
// for `exp_step_factor != 0`, every scene of scale > 0.5:
//
//     dt(t)   = clamp(t * esf, lo, hi)     lo = sqrt3 / resolution,
//                                          hi = 2 sqrt3 * scale / grid_size
//     t_0     = t1 + noise * dt(t1)
//     t_{k+1} = t_k + dt(t_k)
//     ts[i, k] = t_k, dts[i, k] = dt(t_k)          i < n rays, k < K
//
// The plain version (`march_lattice_plain`, ops/ray_march.py) is a Python
// loop of K steps over (n,) tensors: 3 launches a step, 3K a march.
//
// Bit parity: each operation is rounded as XLA rounds the jitted scan, with
// the intrinsics nvcc does not contract: `__fmul_rn` for t * esf,
// `__fadd_rn` for t + dt.  t_0 is ONE fused multiply-add, `__fmaf_rn`: XLA's
// CPU compiler contracts `t1 + noise * dt(t1)` under jit (measured on the
// jitted JAX lattice; the plain version uses `torch.addcmul`, also one
// rounding).  The clamp keeps a NaN, as `torch.clamp` and `jnp.clip` do.
//
// Bound on this card: bytes.  The two (n, K) float32 outputs are written
// once: 4096 x 1024 x 8 B = 33.6 MB, 0.010 ms at 3.35 TB/s; the inputs are
// 8n bytes.  The recurrence is serial in k, so a ray is one thread.
//
// Design: one warp per block, lane i owns ray (32 * block + i) and walks
// its K steps in registers.  A thread writing its own row would store 32
// rows 4K bytes apart per instruction, so each lane puts a chunk of 32
// steps into a shared (32 x 33) tile (the 33 keeps the lanes' columns on
// distinct banks), and after a warp barrier the warp writes the tile row
// by row: 32 lanes on 32 consecutive floats, one 128-byte line a store.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float clamp_dt(float x, float lo, float hi) {
  if (x < lo) x = lo;  // NaN compares false both times and stays NaN
  if (x > hi) x = hi;
  return x;
}

__global__ void __launch_bounds__(kWarp)
    march_lattice_kernel(const float* __restrict__ t1,
                         const float* __restrict__ noise,
                         float* __restrict__ ts, float* __restrict__ dts,
                         int n, int K, float esf, float lo, float hi) {
  __shared__ float tile_t[kWarp][kWarp + 1];
  __shared__ float tile_dt[kWarp][kWarp + 1];
  const int lane = threadIdx.x;
  const int ray0 = blockIdx.x * kWarp;
  const int ray = ray0 + lane;
  float t = 0.0f;
  if (ray < n) {
    const float a = t1[ray];
    t = __fmaf_rn(noise[ray], clamp_dt(__fmul_rn(a, esf), lo, hi), a);
  }
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int steps = min(kWarp, K - k0);
    for (int j = 0; j < steps; ++j) {
      const float dt = clamp_dt(__fmul_rn(t, esf), lo, hi);
      tile_t[lane][j] = t;
      tile_dt[lane][j] = dt;
      t = __fadd_rn(t, dt);
    }
    __syncwarp();
    const int rows = min(kWarp, n - ray0);
    if (lane < steps) {
      for (int r = 0; r < rows; ++r) {
        const long long o = (long long)(ray0 + r) * K + k0 + lane;
        ts[o] = tile_t[r][lane];
        dts[o] = tile_dt[r][lane];
      }
    }
    __syncwarp();
  }
}

}  // namespace

// t1, noise: (n,) float32; ts, dts: (n, K) float32, contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int vn_march_lattice(const float* t1, const float* noise,
                                float* ts, float* dts, int n, int K,
                                float esf, float lo, float hi,
                                cudaStream_t stream) {
  if (n == 0 || K == 0) return cudaSuccess;
  const int blocks = (n + kWarp - 1) / kWarp;
  march_lattice_kernel<<<blocks, kWarp, 0, stream>>>(t1, noise, ts, dts, n, K,
                                                     esf, lo, hi);
  return cudaGetLastError();
}
