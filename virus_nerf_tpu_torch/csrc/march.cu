// The ray march: candidate lattice, occupancy probe and slot selection in
// one kernel (L1), and the standalone exponential-step lattice.
//
// The port's own kernels: they have no Pallas counterpart.  The fused march
// computes what `march_rays_train` computes from the cube hits to the
// (N, S) layout (virus_nerf_tpu/ops/ray_march.py:88-158, :368-451:
// `_candidate_lattice`, `occupancy_lookup`, `_rank_select`,
// `_select_from_valid`, `_exact`):
//
//   lattice    constant step (esf == 0):  t_k = t1 + (noise + k) * dt0
//              exponential:  dt(t) = clamp(t * esf, lo, hi),
//                            t_0 = t1 + noise * dt(t1), t_{k+1} = t_k + dt(t_k)
//   in range   t_k >= 0 && t_k < t2 && t1 >= 0,  k < K
//   probe      the cascade-aware cell of o + t_k * d in the bool grid
//              (rows, gs^3); the flat index clamped to numel - 1
//   selection  c = the ray's valid candidates; candidate of rank j goes
//              to slot j (c <= S), or, for c > S, to slot ceil(jS/c)
//              where ceil((j+1)S/c) > ceil(jS/c), its dt scaled by the
//              candidates it represents; zeros past n_kept = min(c, S)
//
// Outputs: ts, deltas (N, S) float32, valid (N, S) bool, n_kept (N,) int32.
// The lattice never reaches device memory.
//
// Design.  One warp marches one ray in chunks of 32 candidates, one lane a
// candidate, probed in parallel.  Pass 1 walks the chunks until the
// chunk's last candidate is past t2 (the lattice never decreases, so no
// later candidate is in range) and keeps each chunk's `__ballot_sync` of
// the valid candidates in shared memory (32 words a ray at K = 1024): the
// count c is the sum of their `__popc`.  Pass 2 walks the kept ballots:
// a lane's rank is the running count plus the `__popc` of the ballot's
// lower lanes, and every kept candidate is stored to its slot; the slots
// of a chunk are consecutive, so its stores coalesce.  No candidate is
// probed twice.
//
// The constant step is closed-form, parallel in k.  The exponential step
// is a serial chain with no parallel prefix under float rounding.  A
// block of 8 rays has a ninth, producer warp: its lane r runs ray r's
// chain 32 steps at a time into a shared row (K floats a ray, 32 KB a
// block at K = 1024) and publishes each chunk with a fence and a shared
// counter, while the ray's warp probes the chunks already published.
// Pass 2 reads t back from the row and recomputes dt(t) bit-exactly.
//
// Bit parity with the plain version (which matches the jitted JAX march
// bit for bit): every float operation is an intrinsic that nvcc does not
// contract.  `__fmaf_rn` where the plain version calls `torch.addcmul`
// (the constant lattice after the rounded noise + k, the exponential t_0,
// the positions o + t * d); `__fmul_rn` / `__fadd_rn` elsewhere, in the
// plain version's order: t * esf, dt * gs, 0.5 * (q + 1) * gs, dt * rep.
// q = p / mip_bound is `__fdiv_rn`, or a multiply by the exact reciprocal
// where mip_bound is a power of two (both round the same real number).
// ceil(log2 x) of `torch.frexp` is integer work on the float's bits (zero,
// subnormals and the mantissa == 0.5 case included); 2^(mip - 1) is built
// from bits.  The integer selection fits int32 at K, S <= 1024.
//
// Bound: bytes.  Inputs 36 B a ray, the grid read once, the outputs
// written once: 4096 rays at S = 256 write 8.4 MB of ts and deltas and
// 1 MB of valid, with the 2 MB grid about 11.5 MB, 0.0034 ms at 3.35 TB/s.
// Second limit, the exponential chain: 4 dependent operations a step
// (multiply, two compare-selects, add; about 16 cycles), up to ~800 steps
// in range at scale 1.0: about 13k cycles, 0.007 ms at 1.98 GHz.
//
// Registers and shared memory (`-Xptxas -v`, printed by chip_smoke.py):
// the constant step 39 registers and 1 KB of ballots for 256 threads; the
// exponential step 37 registers, 1 KB plus the 32 KB of rows (K = 1024)
// for 288 threads; no spills.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;            // candidates a chunk: one lane each
constexpr int kRaysPerBlock = 8;     // consumer warps of a block, a ray each
constexpr int kMaxCandidates = 1024; // K: 32 ballots a ray in shared memory
constexpr int kMaxSamples = 1024;    // S
constexpr int kMaxChunks = kMaxCandidates / kWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp_dt(float x, float lo, float hi) {
  if (x < lo) x = lo;  // NaN compares false both times and stays NaN
  if (x > hi) x = hi;
  return x;
}

__device__ __forceinline__ float exp_dt(float t, float esf, float lo,
                                        float hi) {
  return clamp_dt(__fmul_rn(t, esf), lo, hi);
}

// ceil(log2 x) as `torch.frexp` gives it (exponent, less one where the
// mantissa is 0.5), 0 for x == 0; x >= 0.  Infinity and NaN give 0.
__device__ __forceinline__ int ceil_log2(float x) {
  const unsigned b = __float_as_uint(x) & 0x7fffffffu;
  const int e = b >> 23;
  const unsigned m = b & 0x7fffffu;
  if (e == 0) {
    if (m == 0) return 0;
    const int p = 31 - __clz(m);  // x = m * 2^-149, highest bit p
    return (m & (m - 1)) ? p - 148 : p - 149;
  }
  if (e == 255) return 0;
  return m ? e - 126 : e - 127;
}

struct Grid {
  const unsigned char* __restrict__ cells;  // (rows, gs^3) bool
  int numel;
  int gs;
  int cascades;
  float gsf;    // gs as float
  float cellmax;  // gs - 1 as float
  float scale;
};

// One probe coordinate: floor(clamp(0.5 * (p / mb + 1) * gs, 0, gs - 1)).
__device__ __forceinline__ int cell(float p, float mb, float inv, bool pow2,
                                    const Grid& g) {
  const float q = pow2 ? __fmul_rn(p, inv) : __fdiv_rn(p, mb);
  float n = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(q, 1.0f)), g.gsf);
  n = fminf(fmaxf(n, 0.0f), g.cellmax);
  return __float2int_rz(n);
}

// occupancy_lookup at o + t * d with step dt, for an in-range candidate.
__device__ __forceinline__ bool probe(const float (&o)[3], const float (&d)[3],
                                      float t, int mip_dt, const Grid& g) {
  const float x = __fmaf_rn(t, d[0], o[0]);
  const float y = __fmaf_rn(t, d[1], o[1]);
  const float z = __fmaf_rn(t, d[2], o[2]);
  const float mx = fmaxf(fabsf(x), fmaxf(fabsf(y), fabsf(z)));
  const int mip_abs = min(max(ceil_log2(mx) + 1, 0), g.cascades - 1);
  const int mip = max(mip_abs, mip_dt);
  // mip_bound = min(2^(mip - 1), scale); its reciprocal where it is a
  // power of two with a normal reciprocal
  float mb = __uint_as_float((unsigned)(126 + mip) << 23);
  if (g.scale < mb) mb = g.scale;
  const unsigned mbits = __float_as_uint(mb);
  const int me = mbits >> 23;
  const bool pow2 = (mbits & 0x7fffffu) == 0 && me >= 1 && me <= 253;
  const float inv = __uint_as_float((unsigned)(254 - me) << 23);
  const int ix = cell(x, mb, inv, pow2, g);
  const int iy = cell(y, mb, inv, pow2, g);
  const int iz = cell(z, mb, inv, pow2, g);
  int idx = mip * (g.gs * g.gs * g.gs) + (ix * g.gs + iy) * g.gs + iz;
  idx = min(idx, g.numel - 1);
  return __ldg(g.cells + idx) != 0;
}

__device__ __forceinline__ int mip_from_dt(float dt, const Grid& g) {
  return min(max(ceil_log2(__fmul_rn(dt, g.gsf)), 0), g.cascades - 1);
}

struct MarchArgs {
  const float* __restrict__ rays_o;  // (n, 3)
  const float* __restrict__ rays_d;  // (n, 3)
  const float* __restrict__ t1;      // (n,)
  const float* __restrict__ t2;      // (n,)
  const float* __restrict__ noise;   // (n,)
  float* __restrict__ ts;            // (n, S)
  float* __restrict__ deltas;        // (n, S)
  unsigned char* __restrict__ valid; // (n, S)
  int* __restrict__ n_kept;          // (n,)
  int n, S, K;
  float esf, lo, hi, dt0;
};

template <bool kExp>
__global__ void __launch_bounds__((kRaysPerBlock + 1) * kWarp)
    march_select_kernel(MarchArgs a, Grid g) {
  __shared__ unsigned ballots[kRaysPerBlock][kMaxChunks];
  __shared__ int produced;  // chunks of every live ray in the rows
  extern __shared__ float rows[];  // kExp: (kRaysPerBlock, K rounded up)
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row_len = (a.K + kWarp - 1) / kWarp * kWarp;
  if (threadIdx.x == 0) produced = 0;
  __syncthreads();

  if (warp == kRaysPerBlock) {  // the producer of the exponential chains
    if (!kExp) return;
    const int ray = blockIdx.x * kRaysPerBlock + lane;
    bool live = false;
    float t = 0.0f, t2 = 0.0f;
    float* row = rows + lane * row_len;
    if (lane < kRaysPerBlock && ray < a.n) {
      const float t1 = a.t1[ray];
      t2 = a.t2[ray];
      live = t1 >= 0.0f;
      t = __fmaf_rn(a.noise[ray], exp_dt(t1, a.esf, a.lo, a.hi), t1);
    }
    for (int c = 0; __any_sync(kFull, live); ++c) {
      if (live) {
        const int k0 = c * kWarp;
        const int steps = min(kWarp, a.K - k0);
        float last = t;
        for (int j = 0; j < steps; ++j) {
          row[k0 + j] = t;
          last = t;
          t = __fadd_rn(t, exp_dt(t, a.esf, a.lo, a.hi));
        }
        // the consumer's rule: go on while the chunk's last candidate is
        // short of t2
        live = k0 + kWarp < a.K && last < t2;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) *(volatile int*)&produced = c + 1;
    }
    return;
  }

  const int ray = blockIdx.x * kRaysPerBlock + warp;
  if (ray >= a.n) return;
  float o[3], d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = a.rays_o[3 * ray + i];
    d[i] = a.rays_d[3 * ray + i];
  }
  const float t1 = a.t1[ray], t2 = a.t2[ray], noise = a.noise[ray];
  const float* row = rows + warp * row_len;
  unsigned* ballot = ballots[warp];
  const int mip_dt0 = kExp ? 0 : mip_from_dt(a.dt0, g);

  // pass 1: probe the chunks, keep their ballots, count
  int count = 0, chunks = 0;
  for (bool live = t1 >= 0.0f; live; ++chunks) {
    const int k = chunks * kWarp + lane;
    float t;
    if (kExp) {
      while (*(volatile int*)&produced <= chunks) __nanosleep(32);
      __threadfence_block();
      t = row[k];
    } else {
      t = __fmaf_rn(__fadd_rn(noise, (float)k), a.dt0, t1);
    }
    bool hit = false;
    if (k < a.K && t >= 0.0f && t < t2) {
      const int mip_dt = kExp ? mip_from_dt(exp_dt(t, a.esf, a.lo, a.hi), g)
                              : mip_dt0;
      hit = probe(o, d, t, mip_dt, g);
    }
    const unsigned word = __ballot_sync(kFull, hit);
    if (lane == 0) ballot[chunks] = word;
    count += __popc(word);
    const float last = __shfl_sync(kFull, t, kWarp - 1);
    live = (chunks + 1) * kWarp < a.K && last < t2;
  }
  __syncwarp();

  // pass 2: each kept candidate to its slot
  const int S = a.S;
  const int kept_n = min(count, S);
  const bool overflow = count > S;  // never where S >= K
  float* ts = a.ts + (size_t)ray * S;
  float* deltas = a.deltas + (size_t)ray * S;
  const unsigned lower = (1u << lane) - 1u;
  int running = 0;
  for (int c = 0; c < chunks && running < count; ++c) {
    const unsigned word = ballot[c];
    const int rank = running + __popc(word & lower);
    running += __popc(word);
    if (!((word >> lane) & 1u)) continue;
    int slot = rank, rep = 1;
    bool kept = rank < S;
    if (overflow) {
      const int jS = rank * S;
      const int f0 = (jS + count - 1) / count;  // ceil(jS / c)
      const int f1 = (jS + S + count - 1) / count;
      kept = f1 > f0 && f0 < S;
      slot = f0;
      rep = max(min((f0 + 1) * count / S, count) - rank, 1);
    }
    if (!kept) continue;
    const int k = c * kWarp + lane;
    float t, dt;
    if (kExp) {
      t = row[k];
      dt = exp_dt(t, a.esf, a.lo, a.hi);
    } else {
      t = __fmaf_rn(__fadd_rn(noise, (float)k), a.dt0, t1);
      dt = a.dt0;
    }
    if (overflow) dt = __fmul_rn(dt, (float)rep);
    ts[slot] = t;
    deltas[slot] = dt;
  }
  for (int s = kept_n + lane; s < S; s += kWarp) {
    ts[s] = 0.0f;
    deltas[s] = 0.0f;
  }
  unsigned char* valid = a.valid + (size_t)ray * S;
  for (int s = lane; s < S; s += kWarp) valid[s] = s < kept_n;
  if (lane == 0) a.n_kept[ray] = kept_n;
}

// The standalone exponential-step lattice (ts, dts of every candidate):
// one lane a ray walks its K steps; each lane puts a chunk of 32 steps into
// a shared (32 x 33) tile (the 33 keeps the lanes' columns on distinct
// banks), and the warp writes the tile row by row, one 128-byte line a
// store.  Bound: the two (n, K) outputs, 33.6 MB at 4096 x 1024.
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
    t = __fmaf_rn(noise[ray], exp_dt(a, esf, lo, hi), a);
  }
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int steps = min(kWarp, K - k0);
    for (int j = 0; j < steps; ++j) {
      const float dt = exp_dt(t, esf, lo, hi);
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

// rays_o, rays_d: (n, 3) float32; t1, t2, noise: (n,) float32; grid:
// (rows, gs^3) bool of `numel` cells; ts, deltas: (n, S) float32; valid:
// (n, S) bool; n_kept: (n,) int32; all contiguous.  K <= 1024, S <= 1024.
// esf == 0 selects the constant step dt0.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for K or S out of range).
extern "C" int vn_march_select(const float* rays_o, const float* rays_d,
                               const float* t1, const float* t2,
                               const float* noise, const void* grid,
                               int numel, int gs, int cascades, float scale,
                               float esf, float lo, float hi, float dt0,
                               float* ts, float* deltas, void* valid,
                               int* n_kept, int n, int S, int K,
                               cudaStream_t stream) {
  if (K < 1 || K > kMaxCandidates || S < 1 || S > kMaxSamples)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  MarchArgs a{rays_o, rays_d, t1, t2, noise, ts, deltas,
              static_cast<unsigned char*>(valid), n_kept, n, S, K,
              esf, lo, hi, dt0};
  Grid g{static_cast<const unsigned char*>(grid), numel, gs, cascades,
         (float)gs, (float)(gs - 1), scale};
  const int blocks = (n + kRaysPerBlock - 1) / kRaysPerBlock;
  if (esf != 0.0f) {
    const size_t row_bytes =
        (size_t)kRaysPerBlock * ((K + kWarp - 1) / kWarp * kWarp) * sizeof(float);
    march_select_kernel<true><<<blocks, (kRaysPerBlock + 1) * kWarp,
                                row_bytes, stream>>>(a, g);
  } else {
    march_select_kernel<false><<<blocks, kRaysPerBlock * kWarp, 0, stream>>>(
        a, g);
  }
  return cudaGetLastError();
}

extern "C" int vn_march_chunk() { return kWarp; }
extern "C" int vn_march_rays_per_block() { return kRaysPerBlock; }
extern "C" int vn_march_max_candidates() { return kMaxCandidates; }
extern "C" int vn_march_max_samples() { return kMaxSamples; }

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
