// Mamba2 SSD chunk scan (forward), for Hopper.
//
// Replaces the TPU kernel `ssd_scan_pallas` (body `_kernel`) in
// src/repro/kernels/ssd_scan.py.  For x [B, S, H, P], dt [B, S, H] (after
// softplus), A [H] (< 0) and B, C [B, S, G, N] (head h reads group
// h / (H / G)), it runs the recurrence
//
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
//
// chunk by chunk.  Within a chunk of Q steps, with cum the inclusive
// cumulative sum of dt A over the chunk:
//
//     y_i = sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j
//           + exp(cum_i) C_i . h                      (h entering the chunk)
//     h  <- h exp(cum_Q) + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
//
// It writes y [B, S, H, P] in x's dtype and the final state h [B, H, P, N]
// in float32.  All arithmetic is float32 (the reference's note,
// models/ssm.py: a bf16 M breaks the prefill-to-decode handoff).  A
// ragged last chunk acts as if padded with dt = 0 steps, the identity on
// the state: its missing steps are left out.  Sums run in another order
// than the reference's, so the contract is allclose.
//
// Design (the simple first version).  The rows p of the state are
// independent (row p of h and column p of y read only column p of x), so
// the P columns are cut into up to 4 slices of Pt = ceil(P / 4), and one
// block of 256 threads takes one (b, h, slice), walking the chunks in
// order, as the TPU kernel's sequential grid axis does; its state rows
// [Pt, N] live in float32 shared memory (rows padded to N + 1) for the
// whole sequence.  Per chunk: dt and cum are staged; then, for each tile
// of 64 output rows i, C is staged, and for each tile of 64 source steps
// j <= i the block stages B and x, forms the 64 x 64 tile of
// M = exp(cum_i - cum_j) dt_j (C_i . B_j) in shared memory (every slice
// forms it again) and adds M x to the rows' outputs, held in registers
// (up to 32 a thread, so Pt <= 128); the inflow exp(cum_i) C_i . h comes
// last.  Then the state is updated from the chunk's B, x tiles
// (Pt * N <= 8192 entries, up to 32 a thread).  The [Q, Q] score matrix
// never exists whole: hymba-1.5b's (Q=256, Pt=25, N=16) takes 34 KB of
// shared memory and mamba2-370m's (Pt=16, N=128) 96 KB, the second above
// 48 KB, so the launch opts in to dynamic shared memory.  Shapes beyond
// those limits are refused by the wrapper.
//
// Bound at hymba-1.5b's prefill (B=1, S=4096, H=32, P=100, G=1, N=16,
// Q=256): the function needs C_i . B_j over the 0.53 M causal pairs once
// per group, and per head M x over those pairs, the state update and the
// inflow: 4.22 GFLOP, 0.0085 ms on TF32 tensor cores at 495 TFLOP/s,
// against 53 MB of x, dt, B, C, y and state, 0.016 ms at 3.35 TB/s, so
// the bound is the bytes.  At mamba2-370m's (S=2048, P=64, N=128) it is
// 3.29 GFLOP (0.0067 ms) against 19 MB (0.0057 ms): the operations.  This
// kernel runs float32 FFMA from shared memory on B * H * 4 = 128 blocks,
// one wave on the 132 SMs, each walking all 16 chunks in order, and forms
// C . B again for every head and every slice: it sits far above the bound.
// The chunk-parallel form (chunk states, a scan over them, then the
// outputs, the [Q, Q] products on tensor cores) is the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TI = 64;     // output rows per tile
constexpr int TJ = 64;     // source steps per tile
constexpr int MAXY = 32;   // outputs a thread holds: TI * Pt <= THREADS * MAXY
constexpr int MAXH = 32;   // state entries a thread holds: Pt * N <= 8192
constexpr int SLICES = 4;  // column slices of P, one block each

__host__ __device__ inline int n_slices(int P) { return P < SLICES ? P : SLICES; }
__host__ __device__ inline int slice_width(int P) {
  return (P + n_slices(P) - 1) / n_slices(P);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory of one block, for a slice of Pt columns.
size_t smem_floats(int Pt, int N, int Q) {
  return (size_t)Pt * (N + 1) + 2 * Q + TI * N + TJ * (N + 1) + TJ * Pt +
         TI * TJ;
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const TB* __restrict__ Bm,
               const TB* __restrict__ Cm, TX* __restrict__ y,
               float* __restrict__ h_out, int S, int H, int G, int P, int N,
               int Q) {
  // This block's columns: p0 .. p0 + Pn - 1 of P (local index p).
  const int Pt = slice_width(P);
  const int p0 = blockIdx.y * Pt;
  const int Pn = min(Pt, P - p0);
  extern __shared__ float sm[];
  float* hs = sm;                     // [Pn][N + 1] the carried state rows
  float* dts = hs + Pt * (N + 1);     // [Q]
  float* cum = dts + Q;               // [Q]
  float* Cs = cum + Q;                // [TI][N]
  float* Bs = Cs + TI * N;            // [TJ][N + 1]
  float* Xs = Bs + TJ * (N + 1);      // [TJ][Pn]
  float* Ms = Xs + TJ * Pt;           // [TI][TJ]; the state weights w_j

  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh % H, g = hh / (H / G);
  const int tid = threadIdx.x;
  const float a = A[hh];
  // Element offsets of step t: x/y (b, t, hh, p0), dt (b, t, hh), B/C
  // (b, t, g, 0).
  auto xo = [&](int t) {
    return ((long long)(b * S + t) * H + hh) * P + p0;
  };
  auto bo = [&](int t) { return ((long long)(b * S + t) * G + g) * N; };

  for (int e = tid; e < Pn * (N + 1); e += THREADS) hs[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int len = min(Q, S - c0);
    __syncthreads();                  // the last chunk's readers are done
    for (int i = tid; i < Q; i += THREADS)
      dts[i] = i < len ? dt[(long long)(b * S + c0 + i) * H + hh] : 0.f;
    __syncthreads();
    if (tid == 0) {                   // inclusive cumsum of dt * A, in order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], a));
        cum[i] = run;
      }
    }

    // Outputs, one tile of rows at a time (the state is read, not yet
    // updated).
    for (int i0 = 0; i0 < len; i0 += TI) {
      const int ti = min(TI, len - i0);
      __syncthreads();                // cum ready; Cs free
      for (int e = tid; e < TI * N; e += THREADS) {
        const int r = e / N, n = e % N;
        Cs[e] = r < ti ? to_f(Cm[bo(c0 + i0 + r) + n]) : 0.f;
      }
      float acc[MAXY];
#pragma unroll
      for (int u = 0; u < MAXY; ++u) acc[u] = 0.f;

      for (int j0 = 0; j0 < i0 + ti; j0 += TJ) {
        const int tj = min(TJ, len - j0);
        __syncthreads();              // Bs, Xs, Ms free; Cs staged
        for (int e = tid; e < TJ * N; e += THREADS) {
          const int r = e / N, n = e % N;
          Bs[r * (N + 1) + n] = r < tj ? to_f(Bm[bo(c0 + j0 + r) + n]) : 0.f;
        }
        for (int e = tid; e < TJ * Pn; e += THREADS) {
          const int r = e / Pn, p = e % Pn;
          Xs[e] = r < tj ? to_f(x[xo(c0 + j0 + r) + p]) : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < TI * TJ; e += THREADS) {
          const int r = e / TJ, cj = e % TJ;
          const int i = i0 + r, j = j0 + cj;
          float mv = 0.f;
          if (r < ti && cj < tj && j <= i) {
            float dot = 0.f;
            for (int n = 0; n < N; ++n)
              dot = fmaf(Cs[r * N + n], Bs[cj * (N + 1) + n], dot);
            mv = dot * expf(cum[i] - cum[j]) * dts[j];
          }
          Ms[e] = mv;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < MAXY; ++u) {
          const int o = tid + u * THREADS;
          if (o < TI * Pn) {
            const int r = o / Pn, p = o % Pn;
            float s = acc[u];
            for (int cj = 0; cj < tj; ++cj)
              s = fmaf(Ms[r * TJ + cj], Xs[cj * Pn + p], s);
            acc[u] = s;
          }
        }
      }

      // The inflow from the state entering the chunk, then the store.
#pragma unroll
      for (int u = 0; u < MAXY; ++u) {
        const int o = tid + u * THREADS;
        if (o < ti * Pn) {
          const int r = o / Pn, p = o % Pn;
          float dot = 0.f;
          for (int n = 0; n < N; ++n)
            dot = fmaf(Cs[r * N + n], hs[p * (N + 1) + n], dot);
          y[xo(c0 + i0 + r) + p] =
              from_f<TX>(acc[u] + dot * expf(cum[i0 + r]));
        }
      }
    }

    // The state update: h <- h exp(cum_Q) + sum_j w_j x_j B_j^T.
    const float last = cum[Q - 1];
    float hacc[MAXH];
#pragma unroll
    for (int u = 0; u < MAXH; ++u) hacc[u] = 0.f;
    for (int j0 = 0; j0 < len; j0 += TJ) {
      const int tj = min(TJ, len - j0);
      __syncthreads();                // every reader of Bs, Xs, Ms is done
      for (int e = tid; e < TJ * N; e += THREADS) {
        const int r = e / N, n = e % N;
        Bs[r * (N + 1) + n] = r < tj ? to_f(Bm[bo(c0 + j0 + r) + n]) : 0.f;
      }
      for (int e = tid; e < TJ * Pn; e += THREADS) {
        const int r = e / Pn, p = e % Pn;
        Xs[e] = r < tj ? to_f(x[xo(c0 + j0 + r) + p]) : 0.f;
      }
      for (int r = tid; r < TJ; r += THREADS)
        Ms[r] = r < tj ? expf(last - cum[j0 + r]) * dts[j0 + r] : 0.f;
      __syncthreads();
#pragma unroll
      for (int u = 0; u < MAXH; ++u) {
        const int e = tid + u * THREADS;
        if (e < Pn * N) {
          const int p = e / N, n = e % N;
          float s = hacc[u];
          for (int cj = 0; cj < tj; ++cj)
            s = fmaf(Xs[cj * Pn + p] * Ms[cj], Bs[cj * (N + 1) + n], s);
          hacc[u] = s;
        }
      }
    }
    __syncthreads();                  // all inflow reads of hs are done
    const float decay = expf(last);
#pragma unroll
    for (int u = 0; u < MAXH; ++u) {
      const int e = tid + u * THREADS;
      if (e < Pn * N) {
        const int p = e / N, n = e % N;
        hs[p * (N + 1) + n] = hs[p * (N + 1) + n] * decay + hacc[u];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < Pn * N; e += THREADS)
    h_out[((long long)bh * P + p0) * N + e] = hs[(e / N) * (N + 1) + e % N];
}

template <typename TX, typename TB>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* h_out, int Bsz, int S, int H,
           int G, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(slice_width(P), N, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Bsz * H, n_slices(P));
  ssd_kernel<TX, TB><<<grid, THREADS, smem, stream>>>(
      (const TX*)x, (const float*)dt, (const float*)A, (const TB*)Bm,
      (const TB*)Cm, (TX*)y, (float*)h_out, S, H, G, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// The columns of P one block takes, and the shared memory (bytes) it needs
// for (P, N, Q); the wrapper checks both before launching.
extern "C" int ssd_scan_slice_width(int P) { return slice_width(P); }
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Q) {
  return (long long)(smem_floats(slice_width(P), N, Q) * sizeof(float));
}

// x, y: [Bsz, S, H, P] (bfloat16 when x_bf16, else float32); dt: [Bsz, S, H]
// float32; A: [H] float32; Bm, Cm: [Bsz, S, G, N] (bfloat16 when bc_bf16,
// which needs x_bf16, else float32); h_out: [Bsz, H, P, N] float32.  All contiguous, on one
// device; Q is the chunk (<= S).  Launches on `stream` and returns the
// CUDA error code (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* h_out, int Bsz, int S, int H, int G,
                               int P, int N, int Q, int x_bf16, int bc_bf16,
                               void* stream) {
  if (Bsz == 0 || H == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16 && bc_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, y, h_out,
                                                Bsz, S, H, G, P, N, Q, st);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, y, h_out, Bsz, S,
                                        H, G, P, N, Q, st);
  if (bc_bf16) return (int)cudaErrorInvalidValue;  // the wrapper refuses it
  return launch<float, float>(x, dt, A, Bm, Cm, y, h_out, Bsz, S, H, G, P, N,
                              Q, st);
}
