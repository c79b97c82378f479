// The tracer's phase stamp: one thread reads the card's global timer and
// charges the time since the last stamp to a phase.
//
// Replaces no TPU kernel.  Added so that a phase timer replays with a CUDA
// graph: a host range (`record_function`, NVTX) runs once at capture and
// never at replay, while this launch, made on the current stream, is a node
// of the captured graph and runs at every replay
// (virus_nerf_tpu_torch/utils/tracing.py).
//
// The buffer is `slots` int64 sums of nanoseconds, `slots` counts, then the
// time of the last stamp:
//
//     t = %globaltimer; acc[phase] += t - prev; prev = t; n[phase] += 1
//
// A stamp marks the END of its phase.  It runs after the work before it on
// the stream has finished, so the phases of one stream partition its time.
//
// Bound on this card: the launch (a few microseconds a node; one thread,
// 24 bytes read and written).  Design: nothing to tune; the stamp must not
// reorder or join the stream's work, and it does not.

#include <cuda_runtime.h>

namespace {

__global__ void trace_stamp_kernel(long long* buf, int slots, int phase) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  long long now = static_cast<long long>(t);
  long long* prev = buf + 2 * slots;
  buf[phase] += now - *prev;
  buf[slots + phase] += 1;
  *prev = now;
}

}  // namespace

extern "C" int vn_trace_stamp(void* buf, int slots, int phase, void* stream) {
  trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), slots, phase);
  return static_cast<int>(cudaGetLastError());
}
