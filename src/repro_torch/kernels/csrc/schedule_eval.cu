// Per-task carbon-trace deltas of a batch of candidate schedules, for Hopper.
//
// Replaces the TPU kernel `schedule_delta_pallas` (body `_kernel`) in
// src/repro/kernels/schedule_eval.py.  For instance b, candidate p, task t:
//
//     out[b, p, t] = cum[b, clip(s + d, 0, H)] - cum[b, clip(s, 0, H)]
//
// with s = start[b, p, t], d = dur[b, p, t] and s + d the wrap-around int32
// sum the reference computes.  Both epochs are clamped into [0, H] before
// the load, so a candidate that overruns the trace integrates to its edge.
// Each output is one float subtraction of two loaded values: it equals the
// plain gather version (kernels/ref.py) bitwise.
//
// The TPU kernel turned the gather into a one-hot x trace product because
// the TPU has no fast scalar gather.  Hopper gathers; what it needs is to
// keep the memory system busy.  Design: the grid is instance-major, block g
// taking elements [e0, e0 + per_block) of instance g / splits, so no element
// divides to find its instance.  A block
//
//   1. issues its first batch of start/dur loads (16-byte vectors, four a
//      thread for each array) into registers;
//   2. meanwhile stages its instance's `cum` row (H + 1 floats, 6 KB at
//      H = 1500) into shared memory with 16-byte `cp.async` copies, the
//      row's unaligned first and last floats by plain loads;
//   3. gathers both ends from shared memory and stores `out` as float4.
//
// An instance's slice starts where b * P * T puts it, so where P * T is not
// a multiple of 4 each block runs a scalar head and tail around its aligned
// body (and everything scalar if a base pointer is not 16-byte aligned).
// per_block is 4096 elements, or a multiple of 4096 at least H + 1 long,
// so a block never stages more floats than it gathers for; a small batch
// with large P * T splits each instance over many blocks, which re-stage
// the row from L2.  A row too long for shared memory (H + 1 above ~58k
// floats) is gathered from global memory / L2 by the same kernel
// instantiated without the staging.
//
// Bound at the main path's shape (B=1000, Pop=96, T=40, H=1500): 3.84 M
// elements, each reading 8 B (start, dur) and writing 4 B, plus 6 MB of
// `cum` read once: 52 MB, about 16 us at 3.35 TB/s.  It does one
// subtraction per element, so it is bound by bytes, not operations.
// chip_smoke.py measured 0.026 ms on an H100 80GB HBM3 at 700 W, 0.59 of
// the bound: 1000 blocks in two waves of 4 blocks an SM (60 registers).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // 16-byte vectors of each array a thread loads a batch
constexpr int kBatch = kThreads * kVec * 4;  // elements a block takes a batch
constexpr int kMaxShared = 232448;  // dynamic shared memory a block may use
constexpr int kRowPad = 8;  // staged floats beyond H + 1 (alignment, rounding)

template <bool kStaged>
__device__ __forceinline__ float delta(const float* row, int32_t s, int32_t d,
                                       int horizon) {
  // Wrap-around int32 sum, as the reference computes it.
  const int32_t e = (int32_t)((uint32_t)s + (uint32_t)d);
  const int s0 = min(max(s, 0), horizon);
  const int e1 = min(max(e, 0), horizon);
  if (kStaged) return row[e1] - row[s0];
  return __ldg(row + e1) - __ldg(row + s0);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    schedule_delta_kernel(const int32_t* __restrict__ start,
                          const int32_t* __restrict__ dur,
                          const float* __restrict__ cum,
                          float* __restrict__ out, long long per_instance,
                          int horizon, int splits, int per_block, int vec) {
  extern __shared__ __align__(16) float srow[];
  const long long b = blockIdx.x / splits;
  const long long e0 = (long long)(blockIdx.x % splits) * per_block;
  const long long e1 = min(e0 + per_block, per_instance);
  const long long g0 = b * per_instance + e0;
  const long long g1 = b * per_instance + e1;
  // The aligned body [ga, gb) goes in 16-byte vectors; [g0, ga) and
  // [gb, g1) element by element.
  const long long ga = vec ? min((g0 + 3) & ~3LL, g1) : g1;
  const long long gb = vec ? max(g1 & ~3LL, ga) : g1;
  const int nvec = (int)((gb - ga) >> 2);
  const int4* s4 = reinterpret_cast<const int4*>(start + ga);
  const int4* d4 = reinterpret_cast<const int4*>(dur + ga);
  float4* o4 = reinterpret_cast<float4*>(out + ga);
  const int tid = threadIdx.x;

  int4 sv[kVec], dv[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = tid + u * kThreads;
    if (i < nvec) {
      sv[u] = __ldg(s4 + i);
      dv[u] = __ldg(d4 + i);
    }
  }

  const float* crow = cum + b * (horizon + 1);
  const float* row = crow;
  if (kStaged) {
    // srow[pad + i] = crow[i], pad chosen so that 16-byte chunks of srow
    // face 16-byte aligned chunks of crow.
    const int pad = (int)((reinterpret_cast<uintptr_t>(crow) >> 2) & 3);
    const int len = horizon + 1;
    const int chunks = (len + pad + 3) >> 2;
    for (int c = tid; c < chunks; c += kThreads) {
      const int lo = 4 * c - pad;  // row index of the chunk's first float
      if (lo >= 0 && lo + 4 <= len) {
        hopper::cp_async<16>(srow + 4 * c, crow + lo, 16);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = lo + j;
          if (i >= 0 && i < len) srow[4 * c + j] = __ldg(crow + i);
        }
      }
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
    row = srow + pad;
  }

  for (int base = 0; base < nvec; base += kVec * kThreads) {
    if (base > 0) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int i = base + tid + u * kThreads;
        if (i < nvec) {
          sv[u] = __ldg(s4 + i);
          dv[u] = __ldg(d4 + i);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int i = base + tid + u * kThreads;
      if (i < nvec) {
        float4 r;
        r.x = delta<kStaged>(row, sv[u].x, dv[u].x, horizon);
        r.y = delta<kStaged>(row, sv[u].y, dv[u].y, horizon);
        r.z = delta<kStaged>(row, sv[u].z, dv[u].z, horizon);
        r.w = delta<kStaged>(row, sv[u].w, dv[u].w, horizon);
        o4[i] = r;
      }
    }
  }
  for (long long g = g0 + tid; g < ga; g += kThreads)
    out[g] = delta<kStaged>(row, __ldg(start + g), __ldg(dur + g), horizon);
  for (long long g = gb + tid; g < g1; g += kThreads)
    out[g] = delta<kStaged>(row, __ldg(start + g), __ldg(dur + g), horizon);
}

}  // namespace

// start, dur: [batch, per_instance] int32; cum: [batch, horizon + 1] float32;
// out: [batch, per_instance] float32.  All contiguous, on one device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int schedule_delta_launch(const void* start, const void* dur,
                                     const void* cum, void* out, int batch,
                                     int per_instance, int horizon,
                                     void* stream) {
  if ((long long)batch * per_instance == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int vec = ((reinterpret_cast<uintptr_t>(start) |
                    reinterpret_cast<uintptr_t>(dur) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long row_floats = (long long)horizon + 1;
  const long long smem = (row_floats + kRowPad) * (long long)sizeof(float);
  const bool staged = smem <= kMaxShared;
  const long long per_block =
      staged ? (row_floats + kBatch - 1) / kBatch * kBatch : kBatch;
  if (per_block > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long splits = (per_instance + per_block - 1) / per_block;
  const long long blocks = (long long)batch * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (staged) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          schedule_delta_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    schedule_delta_kernel<true><<<(unsigned)blocks, kThreads, (size_t)smem,
                                  s>>>(
        (const int32_t*)start, (const int32_t*)dur, (const float*)cum,
        (float*)out, per_instance, horizon, (int)splits, (int)per_block,
        vec);
  } else {
    schedule_delta_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)start, (const int32_t*)dur, (const float*)cum,
        (float*)out, per_instance, horizon, (int)splits, (int)per_block,
        vec);
  }
  return (int)cudaGetLastError();
}
