// Per-task carbon-trace deltas of a batch of candidate schedules, for Hopper.
//
// Replaces the TPU kernel `schedule_delta_pallas` (body `_kernel`) in
// src/repro/kernels/schedule_eval.py.  For instance b, candidate p, task t:
//
//     out[b, p, t] = cum[b, clip(s + d, 0, H)] - cum[b, clip(s, 0, H)]
//
// with s = start[b, p, t], d = dur[b, p, t].  Both epochs are clamped into
// [0, H] before the load, so a candidate that overruns the trace integrates
// to its edge.  Each output is one float subtraction of two loaded values:
// it equals the plain gather version (kernels/ref.py) bitwise.
//
// The TPU kernel turned the gather into a one-hot x trace product because
// the TPU has no fast scalar gather.  Hopper gathers, so this kernel just
// loads: one thread per element, the instance's `cum` row read through the
// read-only path and L2 (a 1501-epoch row is 6 KB; all 1000 rows of the
// paper's batch, 6 MB, sit in the 50 MB L2).
//
// Bound at the main path's shape (B=1000, Pop=96, T=40, H=1500): 3.84 M
// elements, each reading 8 B (start, dur) and writing 4 B, plus 6 MB of
// `cum` read once: 52 MB, about 16 us at 3.35 TB/s.  It does one
// subtraction per element, so it is bound by bytes, not operations.
// Adjacent threads touch adjacent elements, so the int32/float32 streams
// are coalesced; only the two `cum` loads are scattered, and they hit L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void schedule_delta_kernel(const int32_t* __restrict__ start,
                                      const int32_t* __restrict__ dur,
                                      const float* __restrict__ cum,
                                      float* __restrict__ out,
                                      long long n, long long per_instance,
                                      int horizon) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t s = __ldg(start + i);
    // Wrap-around int32 sum, as the reference computes it.
    const int32_t e = (int32_t)((uint32_t)s + (uint32_t)__ldg(dur + i));
    const int s0 = min(max(s, 0), horizon);
    const int e1 = min(max(e, 0), horizon);
    const float* row = cum + (i / per_instance) * (long long)(horizon + 1);
    out[i] = __ldg(row + e1) - __ldg(row + s0);
  }
}

}  // namespace

// start, dur: [batch, per_instance] int32; cum: [batch, horizon + 1] float32;
// out: [batch, per_instance] float32.  All contiguous, on one device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int schedule_delta_launch(const void* start, const void* dur,
                                     const void* cum, void* out, int batch,
                                     int per_instance, int horizon,
                                     void* stream) {
  const long long n = (long long)batch * per_instance;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  // Enough blocks to fill 132 SMs many times over; the loop takes the rest.
  if (blocks > 132 * 64) blocks = 132 * 64;
  schedule_delta_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)start, (const int32_t*)dur, (const float*)cum,
      (float*)out, n, per_instance, horizon);
  return (int)cudaGetLastError();
}
