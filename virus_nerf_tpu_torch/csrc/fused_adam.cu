// Fused Adam update of one float32 or bf16 leaf, in place.
//
// Replaces the TPU kernel `_adam_kernel`
// (virus_nerf_tpu/ops/fused_adam.py:37, entry `_adam_leaf_pallas` :52):
//
//     mu = b1 * mu + (1 - b1) * g
//     nu = b2 * nu + (1 - b2) * g * g
//     d  = -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
//
// with lr, bc1 = 1 - b1^t and bc2 = 1 - b2^t computed on the host in
// float32.  Unlike the TPU kernel, which writes a separate delta that
// `optax.apply_updates` then adds, this pass reads p, g, mu, nu and writes
// p += d, mu and nu in place: the same result as `apply_updates(p, d)`,
// without the d buffer.
//
// Every step is rounded as its own float32 operation (no contraction into
// fused multiply-adds), in the order of the plain PyTorch version
// `adam_update_plain_`; the two agree to an ulp (PyTorch divides by a host
// scalar as a multiply by its reciprocal).  (1 - b1) and (1 - b2) arrive
// precomputed: the plain version rounds the double difference once, which
// a float32 subtraction here would not reproduce.
//
// A bf16 leaf (the `bfloat16` compute mode's hash table) keeps float32
// moments and a float32 gradient; the update is computed in float32 and
// p = bf16(float32(p) + d), rounded to nearest even, which is what
// `optax.apply_updates` does to a bf16 leaf (JAX fused_adam.py:133-142).
//
// Bound on this card: bandwidth.  Each element moves 16 B in and 12 B out
// (float32 p; 14 B in and 10 B out for bf16 p); at the 11,195,232-element
// hash table that is ~313 MB per step.  One grid-stride elementwise pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename P>
__global__ void fused_adam_kernel(P* __restrict__ p,
                                  const float* __restrict__ g,
                                  float* __restrict__ mu,
                                  float* __restrict__ nu, long long n,
                                  float lr, float bc1, float bc2, float b1,
                                  float omb1, float b2, float omb2,
                                  float eps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float m = __fadd_rn(__fmul_rn(b1, mu[i]), __fmul_rn(omb1, gi));
    const float v =
        __fadd_rn(__fmul_rn(b2, nu[i]), __fmul_rn(__fmul_rn(omb2, gi), gi));
    const float num = __fmul_rn(-lr, __fdiv_rn(m, bc1));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps);
    mu[i] = m;
    nu[i] = v;
    store(p + i, __fadd_rn(to_float(p[i]), __fdiv_rn(num, den)));
  }
}

template <typename P>
int launch(P* p, const float* g, float* mu, float* nu, long long n,
           float lr, float bc1, float bc2, float b1, float omb1, float b2,
           float omb2, float eps, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;  // grid-stride covers the rest
  fused_adam_kernel<P><<<(unsigned)blocks, kThreads, 0, stream>>>(
      p, g, mu, nu, n, lr, bc1, bc2, b1, omb1, b2, omb2, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vn_fused_adam(float* p, const float* g, float* mu, float* nu,
                             long long n, float lr, float bc1, float bc2,
                             float b1, float omb1, float b2, float omb2,
                             float eps, cudaStream_t stream) {
  return launch(p, g, mu, nu, n, lr, bc1, bc2, b1, omb1, b2, omb2, eps,
                stream);
}

// p: bf16; g, mu, nu: float32.
extern "C" int vn_fused_adam_bf16(void* p, const float* g, float* mu,
                                  float* nu, long long n, float lr, float bc1,
                                  float bc2, float b1, float omb1, float b2,
                                  float omb2, float eps, cudaStream_t stream) {
  return launch(static_cast<__nv_bfloat16*>(p), g, mu, nu, n, lr, bc1, bc2,
                b1, omb1, b2, omb2, eps, stream);
}
