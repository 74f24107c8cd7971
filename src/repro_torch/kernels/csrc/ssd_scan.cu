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
//           + exp(cum_i) C_i . h_in                    (h entering the chunk)
//     h  <- h exp(cum_Q) + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
//
// It writes y [B, S, H, P] in x's dtype and the final state h [B, H, P, N]
// in float32.  A ragged last chunk acts as if padded with dt = 0 steps, the
// identity on the state.  Sums run in another order than the reference's,
// so the contract is allclose.
//
// Bound at hymba-1.5b's prefill (B=1, S=4096, H=32, P=100, G=1, N=16,
// Q=256): C_i . B_j over the 0.53 M causal pairs once per group, and per
// head M x over those pairs, the state products and the inflow: 4.22
// GFLOP, 0.0085 ms on TF32 tensor cores at 495 TFLOP/s, against 53 MB of
// x, dt, B, C, y and state, 0.016 ms at 3.35 TB/s: the bytes bound it.
//
// Design: the chunk-parallel form of the plain version (models/ssm.py
// ssd_chunked), as three kernels launched in order on the caller's stream,
// with two scratch buffers the wrapper allocates (the chunk states
// [B, nc, H, P, N] and cum [B, H, nc * Q], float32):
//   1. states: one block per (b, h, chunk).  cum by a block scan; then
//      S_c = sum_j x_j (w_j B_j)^T, w_j = exp(cum_Q - cum_j) dt_j, a
//      [P, Q] x [Q, N] product on the tensor cores, 64 steps at a time.
//   2. carry: one thread per (b, h, p, n), in order over the chunks:
//      h_in[c] = h (over S_c, in place); h = h exp(cum_Q[c]) + S_c, the
//      plain version's own f32 expression, unfused.  It writes h_final.
//   3. outputs: one block per (b, h, chunk, 64-row tile).  y starts as
//      exp(cum_i) C_i . h_in; then for each 64-step tile of sources j <= i,
//      C B^T on the tensor cores, masked and weighted in f32 into
//      M = (C_i . B_j) exp(cum_i - cum_j) dt_j in registers, and y += M x.
//      y is written once, in x's dtype.
// Precision is the design's point: a bf16 M breaks the logits (the
// reference's note).  C . B with bf16 B, C is mma.sync m16n8k16 bf16 with
// f32 sums: the products are exact.  Every product with an f32 operand
// (M x, the state products, C . h_in) is mma.sync m16n8k8 TF32 with the
// operand split in two TF32 parts, hi = tf32(a) and lo = tf32(a - hi): a
// bf16 operand is exact in TF32, so that is two products (hi b + lo b),
// and three with two f32 operands (hi hi + hi lo + lo hi), which keeps
// near-f32 accuracy.  The bound is bytes and one block's products are
// small, so mma.sync is enough and wgmma is not needed.  Operands are
// staged by 8-byte cp.async copies (x's 200-byte head rows are 8- but not
// always 16-byte aligned; plain loads where a row is not 8-byte aligned),
// double-buffered over 64-step tiles, into padded shared memory: P to a
// multiple of 8 (16 in the states kernel), N to a multiple of 16, zeros
// beyond.  The
// wrapper refuses P > 128 (the outputs kernel keeps a row's P outputs in
// registers), more than 128 state tiles of 16 x 8, and shared memory
// beyond the block's 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int JT = 64;          // steps per staged tile
constexpr int ST_THREADS = 256; // states kernel: 8 warps
constexpr int MAX_TILES = 16;   // state tiles (16 p x 8 n) a warp holds
constexpr int OUT_THREADS = 128;// outputs kernel: 4 warps of 16 rows
constexpr int MAX_PT = 16;      // output column tiles of 8 (P <= 128)

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

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

// The TF32 parts of K values.  An exact operand (a bf16 value) is its
// own hi part and needs no lo part.
template <bool EXACT, int K>
__device__ __forceinline__ void split(const float (&v)[K], uint32_t (&hi)[K],
                                      uint32_t (&lo)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    hi[i] = EXACT ? __float_as_uint(v[i]) : hopper::to_tf32(v[i]);
    lo[i] = EXACT ? 0u : hopper::to_tf32(v[i] - __uint_as_float(hi[i]));
  }
}

// d += a b from split parts: lo hi + hi lo + hi hi, less what is exact.
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if constexpr (!EXACT_A) hopper::mma_tf32_1688(d, al, bh);
  if constexpr (!EXACT_B) hopper::mma_tf32_1688(d, ah, bl);
  hopper::mma_tf32_1688(d, ah, bh);
}

template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma_f32(float (&d)[4], const float (&a)[4],
                                        const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
  split<EXACT_A>(a, ah, al);
  split<EXACT_B>(b, bh, bl);
  mma_split<EXACT_A, EXACT_B>(d, ah, al, bh, bl);
}

// Starts copying `rows` rows of `cols` elements (row r at src + r *
// stride) into shared rows of `ld` elements; rows from `valid` on arrive
// as zeros, and columns past `cols` are left as they are (the kernels zero
// them once).  By 8-byte cp.async copies where every row allows them (a
// 200-byte bf16 head row is 8-byte aligned, not always 16), else by plain
// loads.  The caller commits, waits and synchronises.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           long long stride, int valid,
                                           int rows, int cols) {
  constexpr int V = 8 / sizeof(T);
  if (cols % V == 0 && stride % V == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    const int nv = cols / V;
    for (int e = threadIdx.x; e < rows * nv; e += blockDim.x) {
      const int r = e / nv, v = e - r * nv;
      const bool in = r < valid;
      hopper::cp_async<8>(dst + r * ld + v * V,
                          in ? src + r * stride + v * V : src, in ? 8 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      dst[r * ld + c] = r < valid ? src[r * stride + c] : from_f<T>(0.f);
    }
  }
}

// Starts copying n floats (src[i], those from `valid` on as zeros).
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             long long stride, int valid,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    hopper::cp_async<4>(dst + i, i < valid ? src + i * stride : src,
                        i < valid ? 4 : 0);
}

__device__ __forceinline__ void zero_shared(void* p, size_t bytes) {
  float* f = static_cast<float*>(p);
  for (size_t i = threadIdx.x; i < bytes / 4; i += blockDim.x) f[i] = 0.f;
}

// ------------------------------------------------------------ 1. states

size_t states_smem(int P, int N, int Q, int x_bytes, int bc_bytes) {
  return sizeof(float) * (2 * (size_t)round_up(Q, JT) + 32) +
         2 * (size_t)JT * round_up(P, 16) * x_bytes +
         2 * (size_t)JT * round_up(N, 16) * bc_bytes;
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(ST_THREADS)
    ssd_states_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const TB* __restrict__ Bm,
                      float* __restrict__ states, float* __restrict__ cum_out,
                      int S, int H, int G, int P, int N, int Q, int nc) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int t0 = c * Q, len = min(Q, S - t0);
  const int QP = round_up(Q, JT), PP = round_up(P, 16), NP = round_up(N, 16);
  extern __shared__ float sm[];
  float* cum = sm;                // [QP]
  float* w = cum + QP;            // [QP] dt, then exp(cum_Q - cum_j) dt_j
  float* part = w + QP;           // [32] the scan's warp totals
  TX* xs = reinterpret_cast<TX*>(part + 32);       // [2][JT][PP]
  TB* bs = reinterpret_cast<TB*>(xs + 2 * JT * PP);  // [2][JT][NP]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // x and B come in tiles of JT steps, double-buffered: tile k + 1 is in
  // flight while tile k is multiplied.
  const int ntile = (len + JT - 1) / JT;
  auto stage = [&](int k) {
    const int j0 = k * JT, tj = min(JT, len - j0);
    stage_rows(xs + (k & 1) * JT * PP, PP,
               x + ((long long)(b * S + t0 + j0) * H + h) * P,
               (long long)H * P, tj, JT, P);
    stage_rows(bs + (k & 1) * JT * NP, NP,
               Bm + ((long long)(b * S + t0 + j0) * G + g) * N,
               (long long)G * N, tj, JT, N);
    hopper::cp_async_commit();
  };
  zero_shared(xs, 2 * JT * (PP * sizeof(TX) + NP * sizeof(TB)));
  __syncthreads();
  stage(0);

  // cum: each thread sums a run of steps in order, then a block scan of
  // the runs' totals.  Steps past the chunk have dt = 0.
  const float a = A[h];
  const int per = QP / ST_THREADS + (QP % ST_THREADS != 0);
  const int lo = min(tid * per, QP), hi = min(lo + per, QP);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    const float d = i < len ? dt[(long long)(b * S + t0 + i) * H + h] : 0.f;
    w[i] = d;
    run = __fadd_rn(run, __fmul_rn(d, a));
    cum[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float v = lane < ST_THREADS / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane < ST_THREADS / 32) part[lane] = v;
  }
  __syncthreads();
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float offset = excl + (warp > 0 ? part[warp - 1] : 0.f);
  for (int i = lo; i < hi; ++i) cum[i] += offset;
  __syncthreads();
  const float last = cum[QP - 1];
  float* cum_row = cum_out + ((long long)b * H + h) * nc * Q + t0;
  for (int i = tid; i < QP; i += ST_THREADS) {
    w[i] = expf(last - cum[i]) * w[i];
    if (i < Q) cum_row[i] = cum[i];
  }

  // S_c [P, N] = x^T (w B): tiles of 16 p x 8 n, dealt to the warps.
  const int gq = lane >> 2, tq = lane & 3;
  const int ntn = (N + 7) / 8, ntiles = (PP / 16) * ntn;
  float acc[MAX_TILES][4];
#pragma unroll
  for (int u = 0; u < MAX_TILES; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  for (int k = 0; k < ntile; ++k) {
    const int j0 = k * JT, tj = min(JT, len - j0);
    const TX* xs_k = xs + (k & 1) * JT * PP;
    const TB* bs_k = bs + (k & 1) * JT * NP;
    if (k + 1 < ntile) {
      stage(k + 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();              // tile k and w are ready
#pragma unroll
    for (int u = 0; u < MAX_TILES; ++u) {
      const int tile = warp + u * (ST_THREADS / 32);
      if (tile < ntiles) {
        const int p0 = (tile / ntn) * 16, n0 = (tile % ntn) * 8;
        for (int k0 = 0; k0 < tj; k0 += 8) {
          const TX* xr = xs_k + (k0 + tq) * PP + p0 + gq;
          const float af[4] = {to_f(xr[0]), to_f(xr[8]), to_f(xr[4 * PP]),
                               to_f(xr[4 * PP + 8])};
          const TB* br = bs_k + (k0 + tq) * NP + n0 + gq;
          const float bf[2] = {w[j0 + k0 + tq] * to_f(br[0]),
                               w[j0 + k0 + tq + 4] * to_f(br[4 * NP])};
          mma_f32<kBf16<TX>, false>(acc[u], af, bf);
        }
      }
    }
    __syncthreads();              // tile k is consumed before its refill
  }
  float* st = states + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int u = 0; u < MAX_TILES; ++u) {
    const int tile = warp + u * (ST_THREADS / 32);
    if (tile < ntiles) {
      const int p0 = (tile / ntn) * 16, n0 = (tile % ntn) * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gq + 8 * (e >> 1), n = n0 + 2 * tq + (e & 1);
        if (p < P && n < N) st[p * N + n] = acc[u][e];
      }
    }
  }
}

// ------------------------------------------------------------- 2. carry

__global__ void ssd_carry_kernel(float* __restrict__ states,
                                 const float* __restrict__ cum,
                                 float* __restrict__ h_out, int H, int P,
                                 int N, int Q, int nc, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / ((long long)P * N);   // b * H + h
  const long long pn = e % ((long long)P * N);
  const long long b = bh / H, hh = bh % H;
  const float* cum_row = cum + bh * nc * Q;
  float h = 0.f;
  for (int c = 0; c < nc; ++c) {
    float* slot = states + ((b * nc + c) * H + hh) * P * N + pn;
    const float s = *slot;
    *slot = h;                                   // the state entering c
    h = __fadd_rn(__fmul_rn(h, expf(cum_row[c * Q + Q - 1])), s);
  }
  h_out[e] = h;
}

// ----------------------------------------------------------- 3. outputs

template <typename T>
__host__ __device__ constexpr int bc_stride(int NP) {
  return NP + (sizeof(T) == 2 ? 8 : 4);   // rows off the same banks
}

template <typename TX, typename TB>
size_t out_smem(int P, int N) {
  const int PP = round_up(P, 8), NP = round_up(N, 16);
  return sizeof(float) * (5 * JT + (size_t)PP * (NP + 4)) +
         sizeof(TB) * 3 * JT * bc_stride<TB>(NP) + sizeof(TX) * 2 * JT * PP;
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(OUT_THREADS)
    ssd_out_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                   const TB* __restrict__ Bm, const TB* __restrict__ Cm,
                   const float* __restrict__ h_in,
                   const float* __restrict__ cum, TX* __restrict__ y, int S,
                   int H, int G, int P, int N, int Q, int nc, int row_tiles) {
  const int c = blockIdx.x / row_tiles, i0 = (blockIdx.x % row_tiles) * JT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, len = min(Q, S - t0);
  if (i0 >= len) return;
  const int ti = min(JT, len - i0);
  const int g = h / (H / G);
  const int PP = round_up(P, 8), NP = round_up(N, 16);
  const int HS = NP + 4, CS = bc_stride<TB>(NP);
  extern __shared__ float sm[];
  float* cum_i = sm;                          // [JT]
  float* cum_j = cum_i + JT;                  // [2][JT]
  float* dt_j = cum_j + 2 * JT;               // [2][JT]
  float* hs = dt_j + 2 * JT;                  // [PP][HS] h_in of the chunk
  TB* cs = reinterpret_cast<TB*>(hs + PP * HS);   // [JT][CS]
  TB* bs = cs + JT * CS;                          // [2][JT][CS]
  TX* xs = reinterpret_cast<TX*>(bs + 2 * JT * CS);  // [2][JT][PP]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp + gq;              // this thread's rows r0, r0 + 8
  const float* cum_row = cum + ((long long)b * H + h) * nc * Q + t0;

  // The sources j <= i come in tiles of JT steps, double-buffered: tile
  // k + 1 is in flight while tile k is multiplied.
  const int ntile = (i0 + ti + JT - 1) / JT;
  auto stage = [&](int k) {
    const int j0 = k * JT, tj = min(JT, len - j0), o = k & 1;
    stage_floats(cum_j + o * JT, cum_row + j0, 1, tj, JT);
    stage_floats(dt_j + o * JT, dt + (long long)(b * S + t0 + j0) * H + h,
                 H, tj, JT);
    stage_rows(bs + o * JT * CS, CS,
               Bm + ((long long)(b * S + t0 + j0) * G + g) * N,
               (long long)G * N, tj, JT, N);
    stage_rows(xs + o * JT * PP, PP,
               x + ((long long)(b * S + t0 + j0) * H + h) * P,
               (long long)H * P, tj, JT, P);
    hopper::cp_async_commit();
  };
  zero_shared(hs, sizeof(float) * PP * HS + sizeof(TB) * 3 * JT * CS +
                      sizeof(TX) * 2 * JT * PP);
  __syncthreads();
  stage_floats(cum_i, cum_row + i0, 1, ti, JT);
  stage_rows(hs, HS, h_in + (((long long)b * nc + c) * H + h) * P * N, N, P,
             PP, N);
  stage_rows(cs, CS, Cm + ((long long)(b * S + t0 + i0) * G + g) * N,
             (long long)G * N, ti, JT, N);
  hopper::cp_async_commit();
  stage(0);
  hopper::cp_async_wait<1>();
  __syncthreads();

  // The inflow, y = exp(cum_i) (C_i . h_in), then the intra-chunk terms.
  const int npt = PP / 8;
  float yacc[MAX_PT][4];
#pragma unroll
  for (int u = 0; u < MAX_PT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[u][e] = 0.f;
  for (int k0 = 0; k0 < NP; k0 += 8) {
    const TB* cr = cs + r0 * CS + k0 + tq;
    const float af[4] = {to_f(cr[0]), to_f(cr[8 * CS]), to_f(cr[4]),
                         to_f(cr[8 * CS + 4])};
    uint32_t ah[4], al[4];
    split<kBf16<TB>>(af, ah, al);
#pragma unroll
    for (int u = 0; u < MAX_PT; ++u) {
      if (u < npt) {
        const float* hr = hs + (8 * u + gq) * HS + k0 + tq;
        const float bf[2] = {hr[0], hr[4]};
        uint32_t bh[2], bl[2];
        split<false>(bf, bh, bl);
        mma_split<kBf16<TB>, false>(yacc[u], ah, al, bh, bl);
      }
    }
  }
  const float d0 = expf(cum_i[r0]), d1 = expf(cum_i[r0 + 8]);
#pragma unroll
  for (int u = 0; u < MAX_PT; ++u) {
    yacc[u][0] *= d0;
    yacc[u][1] *= d0;
    yacc[u][2] *= d1;
    yacc[u][3] *= d1;
  }

  for (int k = 0; k < ntile; ++k) {
    const int j0 = k * JT, tj = min(JT, len - j0);
    const float* cj = cum_j + (k & 1) * JT;
    const float* dj = dt_j + (k & 1) * JT;
    const TB* bk = bs + (k & 1) * JT * CS;
    const TX* xk = xs + (k & 1) * JT * PP;
    __syncthreads();                // tile k - 1 is consumed: refill it
    if (k + 1 < ntile) {
      stage(k + 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();                // tile k is ready

    // C_i . B_j for the warp's 16 rows and the tile's 64 sources.
    float sc[8][4];
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[s][e] = 0.f;
    if constexpr (kBf16<TB>) {
      for (int k0 = 0; k0 < NP; k0 += 16) {
        const TB* cr = cs + r0 * CS + k0 + 2 * tq;
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(cr),
            *reinterpret_cast<const uint32_t*>(cr + 8 * CS),
            *reinterpret_cast<const uint32_t*>(cr + 8),
            *reinterpret_cast<const uint32_t*>(cr + 8 * CS + 8)};
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const TB* br = bk + (8 * s + gq) * CS + k0 + 2 * tq;
          const uint32_t bb[2] = {*reinterpret_cast<const uint32_t*>(br),
                                  *reinterpret_cast<const uint32_t*>(br + 8)};
          hopper::mma_bf16_16816(sc[s], a, bb);
        }
      }
    } else {
      for (int k0 = 0; k0 < NP; k0 += 8) {
        const TB* cr = cs + r0 * CS + k0 + tq;
        const float af[4] = {to_f(cr[0]), to_f(cr[8 * CS]), to_f(cr[4]),
                             to_f(cr[8 * CS + 4])};
        uint32_t ah[4], al[4];
        split<false>(af, ah, al);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const TB* br = bk + (8 * s + gq) * CS + k0 + tq;
          const float bf[2] = {to_f(br[0]), to_f(br[4])};
          uint32_t bh[2], bl[2];
          split<false>(bf, bh, bl);
          mma_split<false, false>(sc[s], ah, al, bh, bl);
        }
      }
    }

    // M = (C_i . B_j) exp(cum_i - cum_j) dt_j on j <= i, in f32; then
    // y += M x.  Sources are taken in the accumulator's column order: the
    // TF32 A fragment's k = tq, tq + 4 are columns 2 tq, 2 tq + 1 of each
    // 8-block, and x's rows follow the same order.
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (8 * s >= tj) break;
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1), col = 8 * s + 2 * tq + (e & 1);
        const bool live = row < ti && col < tj && j0 + col <= i0 + row;
        m[e] = live ? sc[s][e] * expf(cum_i[row] - cj[col]) * dj[col] : 0.f;
      }
      const float af[4] = {m[0], m[2], m[1], m[3]};
      uint32_t ah[4], al[4];
      split<false>(af, ah, al);
      const TX* xr = xk + (8 * s + 2 * tq) * PP + gq;
#pragma unroll
      for (int u = 0; u < MAX_PT; ++u) {
        if (u < npt) {
          const float bf[2] = {to_f(xr[8 * u]), to_f(xr[PP + 8 * u])};
          uint32_t bh[2], bl[2];
          split<kBf16<TX>>(bf, bh, bl);
          mma_split<false, kBf16<TX>>(yacc[u], ah, al, bh, bl);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= ti) continue;
    TX* yr = y + ((long long)(b * S + t0 + i0 + row) * H + h) * P;
#pragma unroll
    for (int u = 0; u < MAX_PT; ++u) {
      const int p = 8 * u + 2 * tq;
      if (u >= npt || p >= P) continue;
      const float v0 = yacc[u][2 * half], v1 = yacc[u][2 * half + 1];
      if (P % 2 == 0) {               // p even: a pair, aligned
        if constexpr (kBf16<TX>)
          *reinterpret_cast<__nv_bfloat162*>(yr + p) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(yr + p) = make_float2(v0, v1);
      } else {
        yr[p] = from_f<TX>(v0);
        if (p + 1 < P) yr[p + 1] = from_f<TX>(v1);
      }
    }
  }
}

template <typename TX, typename TB>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* h_out, void* states, void* cum,
           int Bsz, int S, int H, int G, int P, int N, int Q,
           cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const size_t smem1 = states_smem(P, N, Q, sizeof(TX), sizeof(TB));
  const size_t smem3 = out_smem<TX, TB>(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_out_kernel<TX, TB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
  if (err != cudaSuccess) return (int)err;
  ssd_states_kernel<TX, TB><<<dim3(nc, H, Bsz), ST_THREADS, smem1, stream>>>(
      (const TX*)x, (const float*)dt, (const float*)A, (const TB*)Bm,
      (float*)states, (float*)cum, S, H, G, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)Bsz * H * P * N;
  ssd_carry_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (float*)states, (const float*)cum, (float*)h_out, H, P, N, Q, nc,
      total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (Q + JT - 1) / JT;
  ssd_out_kernel<TX, TB>
      <<<dim3(nc * row_tiles, H, Bsz), OUT_THREADS, smem3, stream>>>(
          (const TX*)x, (const float*)dt, (const TB*)Bm, (const TB*)Cm,
          (const float*)states, (const float*)cum, (TX*)y, S, H, G, P, N, Q,
          nc, row_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The shared memory (bytes) the larger of the two tiled kernels needs for
// (P, N, Q) and the dtypes; the wrapper checks it before launching.
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Q, int x_bf16,
                                         int bc_bf16) {
  const size_t s1 = states_smem(P, N, Q, x_bf16 ? 2 : 4, bc_bf16 ? 2 : 4);
  size_t s3;
  if (x_bf16 && bc_bf16)
    s3 = out_smem<__nv_bfloat16, __nv_bfloat16>(P, N);
  else if (x_bf16)
    s3 = out_smem<__nv_bfloat16, float>(P, N);
  else
    s3 = out_smem<float, float>(P, N);
  return (long long)(s1 > s3 ? s1 : s3);
}

// x, y: [Bsz, S, H, P] (bfloat16 when x_bf16, else float32); dt: [Bsz, S, H]
// float32; A: [H] float32; Bm, Cm: [Bsz, S, G, N] (bfloat16 when bc_bf16,
// which needs x_bf16, else float32); h_out: [Bsz, H, P, N] float32;
// scratch: states [Bsz, nc, H, P, N] and cum [Bsz, H, nc * Q], float32,
// nc = ceil(S / Q).  All contiguous, on one device; Q is the chunk (<= S).
// Launches the three kernels on `stream` and returns the CUDA error code
// (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* h_out, void* states, void* cum, int Bsz,
                               int S, int H, int G, int P, int N, int Q,
                               int x_bf16, int bc_bf16, void* stream) {
  if (Bsz == 0 || H == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16 && bc_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, y, h_out,
                                                states, cum, Bsz, S, H, G, P,
                                                N, Q, st);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, y, h_out, states,
                                        cum, Bsz, S, H, G, P, N, Q, st);
  if (bc_bf16) return (int)cudaErrorInvalidValue;  // the wrapper refuses it
  return launch<float, float>(x, dt, A, Bm, Cm, y, h_out, states, cum, Bsz,
                              S, H, G, P, N, Q, st);
}
