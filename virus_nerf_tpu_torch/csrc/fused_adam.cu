// Fused Adam update of every leaf of a parameter group in one launch, in
// place.  Leaves are float32, or bf16 for p alone.
//
// Replaces the TPU kernel `_adam_kernel`
// (virus_nerf_tpu/ops/fused_adam.py:37, entry `_adam_leaf_pallas` :52):
//
//     mu = b1 * mu + (1 - b1) * g
//     nu = b2 * nu + (1 - b2) * g * g
//     d  = -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
//
// with scal = [lr, bc1 = 1 - b1^t, bc2 = 1 - b2^t], float32, read from device
// memory as the TPU kernel reads its `scal_ref` (the step count t lives on
// the device, and `adam_scal` forms scal there each step), so a CUDA graph
// that holds the launch replays each step's own bias correction.  Unlike the TPU kernel, which writes a separate delta that
// `optax.apply_updates` then adds, this pass reads p, g, mu, nu and writes
// p += d, mu and nu in place: the same result as `apply_updates(p, d)`,
// without the d buffer.
//
// Every step is rounded as its own float32 operation (no contraction into
// fused multiply-adds), in the order of the plain PyTorch version
// `adam_update_plain_`, which takes the same scal tensor.  (1 - b1) and
// (1 - b2) arrive precomputed: the plain version rounds the double difference once, which
// a float32 subtraction here would not reproduce.
//
// A bf16 leaf (the `bfloat16` compute mode's hash table) keeps float32
// moments and a float32 gradient; the update is computed in float32 and
// p = bf16(float32(p) + d), rounded to nearest even, which is what
// `optax.apply_updates` does to a bf16 leaf (JAX fused_adam.py:133-142).
//
// Bound on this card: bandwidth.  Each element moves 16 B in and 12 B out
// (float32 p; 14 B in and 10 B out for bf16 p); at the 11,420,064-element
// 16 x 2 hash table that is ~320 MB per step, more than the 50 MB L2.
//
// Design:
// - One launch for all leaves of a group (the hash table and the small MLP
//   weights, which would otherwise cost a dozen elementwise launches each).
//   The leaf list travels by value in the kernel's parameters (`Leaves`,
//   packed per call, since the gradients are new tensors every step), with
//   a prefix of each leaf's chunk count; CTA c takes chunk c and finds its
//   leaf along that prefix.  One CTA per chunk, with no cap on the grid:
//   at the 16 x 2 table a grid of SMs x resident CTAs walking the chunks
//   took 0.116 ms against 0.111 for this one (device time on an H100,
//   tools/torch_kernel_variants.py).
// - A chunk is kChunk elements.  Each thread keeps kVecPerThread 16-byte
//   vectors of each array in flight (float4; 4 bf16 of p as one 8-byte
//   vector) with streaming hints (`__ldcs`/`__stcs`: the data passes once).
// - A leaf whose four arrays share their 16-byte phase takes a scalar head
//   (up to 3 elements, so the vectors are aligned), a vector body and a
//   scalar tail (up to 3); its first chunk does the head and tail.  A leaf
//   whose arrays do not share it runs scalar chunks.  The host computes
//   the split (`adam_leaf_plan` in ops/fused_adam.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 2;  // 16-byte vectors of each array a thread holds
constexpr int kChunk = kThreads * kVecPerThread * 4;  // elements per chunk
constexpr int kMaxLeaves = 16;  // leaves of one launch

struct Leaf {
  void* p;  // float32, or bf16 if bf16
  const float* g;
  float* mu;
  float* nu;
  long long n;     // elements
  long long head;  // scalar elements before the body
  long long body;  // elements the chunks cover (vector quads if vec)
  int bf16;
  int vec;
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int first_chunk[kMaxLeaves + 1];  // prefix of the chunk counts
};

struct Hyper {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps;
};

// the launch's scalars: scal in device memory, the constants by value
struct HyperArgs {
  const float* scal;  // lr, bc1, bc2
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ Hyper load_hyper(const HyperArgs& a) {
  return Hyper{__ldg(a.scal), __ldg(a.scal + 1), __ldg(a.scal + 2),
               a.b1,           a.omb1,          a.b2,
               a.omb2,         a.eps};
}

__device__ __forceinline__ void adam(float g, float& m, float& v, float& p,
                                     const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float num = __fmul_rn(-h.lr, __fdiv_rn(m, h.bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps);
  p = __fadd_rn(p, __fdiv_rn(num, den));
}

__device__ __forceinline__ float4 ld4(const float* a, long long i) {
  return __ldcs(reinterpret_cast<const float4*>(a + i));
}
__device__ __forceinline__ void st4(float* a, long long i, const float (&x)[4]) {
  __stcs(reinterpret_cast<float4*>(a + i), make_float4(x[0], x[1], x[2], x[3]));
}
__device__ __forceinline__ void unpack(const float4& t, float (&x)[4]) {
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

// p's element type: scalar access and 4-element vectors
template <typename P>
struct Param;

template <>
struct Param<float> {
  static __device__ float get(const void* p, long long i) {
    return static_cast<const float*>(p)[i];
  }
  static __device__ void set(void* p, long long i, float x) {
    static_cast<float*>(p)[i] = x;
  }
  static __device__ void load4(const void* p, long long i, float (&x)[4]) {
    unpack(ld4(static_cast<const float*>(p), i), x);
  }
  static __device__ void store4(void* p, long long i, const float (&x)[4]) {
    st4(static_cast<float*>(p), i, x);
  }
};

template <>
struct Param<__nv_bfloat16> {
  static __device__ float get(const void* p, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  static __device__ void set(void* p, long long i, float x) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  }
  // bf16 -> float32 is exact: the bf16 bits are the float's upper half
  static __device__ void load4(const void* p, long long i, float (&x)[4]) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i));
    x[0] = __uint_as_float(t.x << 16); x[1] = __uint_as_float(t.x & 0xffff0000u);
    x[2] = __uint_as_float(t.y << 16); x[3] = __uint_as_float(t.y & 0xffff0000u);
  }
  static __device__ unsigned bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ void store4(void* p, long long i, const float (&x)[4]) {
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i),
           make_uint2(bits(x[0]) | bits(x[1]) << 16, bits(x[2]) | bits(x[3]) << 16));
  }
};

template <typename P>
__device__ __forceinline__ void scalar_step(const Leaf& L, long long i,
                                            const Hyper& h) {
  float m = L.mu[i], v = L.nu[i], x = Param<P>::get(L.p, i);
  adam(L.g[i], m, v, x, h);
  L.mu[i] = m;
  L.nu[i] = v;
  Param<P>::set(L.p, i, x);
}

// Quads [begin, end) of a leaf's body, begin 16-byte aligned: every load
// of a thread is issued before the first update.
template <typename P>
__device__ __forceinline__ void vector_chunk(const Leaf& L, long long begin,
                                             long long end, const Hyper& h) {
  float g[kVecPerThread][4], m[kVecPerThread][4], v[kVecPerThread][4],
      x[kVecPerThread][4];
  long long idx[kVecPerThread];
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    idx[k] = begin + 4LL * (threadIdx.x + k * kThreads);
    if (idx[k] < end) {
      unpack(ld4(L.g, idx[k]), g[k]);
      unpack(ld4(L.mu, idx[k]), m[k]);
      unpack(ld4(L.nu, idx[k]), v[k]);
      Param<P>::load4(L.p, idx[k], x[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    if (idx[k] < end) {
#pragma unroll
      for (int e = 0; e < 4; ++e) adam(g[k][e], m[k][e], v[k][e], x[k][e], h);
      st4(L.mu, idx[k], m[k]);
      st4(L.nu, idx[k], v[k]);
      Param<P>::store4(L.p, idx[k], x[k]);
    }
  }
}

template <typename P>
__device__ __forceinline__ void chunk(const Leaf& L, long long j,
                                      const Hyper& h) {
  const long long begin = L.head + j * kChunk;
  const long long stop = L.head + L.body;
  const long long end = begin + kChunk < stop ? begin + kChunk : stop;
  if (L.vec) {
    vector_chunk<P>(L, begin, end, h);
  } else {
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
      scalar_step<P>(L, i, h);
    }
  }
  if (j == 0) {  // the scalar head and tail (fewer than 4 elements each)
    if (threadIdx.x < L.head) scalar_step<P>(L, threadIdx.x, h);
    if (stop + threadIdx.x < L.n) scalar_step<P>(L, stop + threadIdx.x, h);
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(const __grid_constant__ Leaves L, const HyperArgs args) {
  const Hyper h = load_hyper(args);
  const int c = blockIdx.x;
  int l = 0;
  while (c >= L.first_chunk[l + 1]) ++l;
  const Leaf& leaf = L.leaf[l];
  const long long j = c - L.first_chunk[l];
  if (leaf.bf16) {
    chunk<__nv_bfloat16>(leaf, j, h);
  } else {
    chunk<float>(leaf, j, h);
  }
}

}  // namespace

extern "C" int vn_fused_adam_max_leaves() { return kMaxLeaves; }
extern "C" int vn_fused_adam_chunk() { return kChunk; }

// ptrs: p, g, mu, nu of each leaf (4 * count pointers); plan: n, head, body
// of each leaf (3 * count); flags: bf16 p, vec of each leaf (2 * count);
// all host memory, packed into the kernel's parameters; scal: lr, bc1,
// bc2 as 3 float32 in device memory.  A leaf's chunk
// count is max(1, ceil(body / kChunk)); leaves of 0 elements take none.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// more than kMaxLeaves leaves).
extern "C" int vn_fused_adam(void* const* ptrs, const long long* plan,
                             const int* flags, int count, const float* scal,
                             float b1, float omb1, float b2, float omb2,
                             float eps, cudaStream_t stream) {
  if (count < 0 || count > kMaxLeaves) return cudaErrorInvalidValue;
  Leaves L;
  L.first_chunk[0] = 0;
  for (int l = 0; l < count; ++l) {
    Leaf& leaf = L.leaf[l];
    leaf.p = ptrs[4 * l];
    leaf.g = static_cast<const float*>(ptrs[4 * l + 1]);
    leaf.mu = static_cast<float*>(ptrs[4 * l + 2]);
    leaf.nu = static_cast<float*>(ptrs[4 * l + 3]);
    leaf.n = plan[3 * l];
    leaf.head = plan[3 * l + 1];
    leaf.body = plan[3 * l + 2];
    leaf.bf16 = flags[2 * l];
    leaf.vec = flags[2 * l + 1];
    const long long chunks = (leaf.body + kChunk - 1) / kChunk;
    L.first_chunk[l + 1] =
        L.first_chunk[l] + (leaf.n == 0 ? 0 : chunks > 1 ? (int)chunks : 1);
  }
  const int total = L.first_chunk[count];
  if (total == 0) return cudaSuccess;
  const HyperArgs h{scal, b1, omb1, b2, omb2, eps};
  fused_adam_kernel<<<total, kThreads, 0, stream>>>(L, h);
  return cudaGetLastError();
}
