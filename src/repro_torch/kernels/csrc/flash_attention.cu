// Causal / sliding-window GQA flash attention (forward), for Hopper.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_kernel`) in
// src/repro/kernels/flash_attention.py.  For q [B, H, Sq, dh] and k, v
// [B, KVH, Skv, dh] (H % KVH == 0; query head h reads kv head
// h / (H / KVH)), it writes o [B, H, Sq, dh] in q's dtype:
//
//     o[i] = sum_j softmax_j(scale * q_i . k_j  over live j) v_j,
//
// with key j live for query i when j < Skv, (not causal or j <= i) and
// (no window or j > i - window).  The arithmetic is the reference's online
// softmax: scores and the running max m, sum l and accumulator in float32;
// a masked score is -1e30 (so a row that has seen no live key yet adds
// exp(0) = 1 per masked key, which the first live key's correction
// exp(-1e30 - m) wipes, as in the reference); p is rounded to the value
// dtype before the PV product; o = acc / max(l, 1e-30).  Sums run in
// another order than the reference's, so the contract is allclose.
//
// Design (the simple first version: FFMA on the CUDA cores, no wgmma/TMA).
// One block of 4 warps per (b * H + h, tile of 64 query rows).  The q tile
// is staged once in shared memory as float32; the block then walks the kv
// tiles of 64 keys that can hold a live key, staging K (rows padded to
// dh + 1 floats, so lanes reading 32 different keys hit 32 banks) and V.
// Tiles fully above the diagonal or fully below the window are skipped, as
// in the reference (flash_attention.py:42-48).  Each warp owns 16 query
// rows: lane l scores keys l and l + 32 against all 16 rows, the row max
// and sum are warp reductions, the rounded p goes to shared memory, and
// lane l accumulates output columns l, l + 32, ... of its 16 rows.  The
// ragged edge (Sq, Skv not multiples of 64) is masked here: ghost keys
// get p = 0, ghost rows are not written.  dh is a template parameter
// (32, 64, 128).
//
// Bound at hymba-1.5b's prefill (B=1, H=25, KVH=5, S=4096, window 2048,
// dh=64): about 6.29 M live (q, k) pairs per head, 2 x 2 x 64 flops each,
// 40.3 GFLOP: 0.041 ms at 989 TFLOP/s bf16 on the tensor cores, against
// 31.5 MB of q, k, v and o (0.009 ms at 3.35 TB/s): bound by operations.
// This kernel runs them as float32 FFMA (67 TFLOP/s peak, so >= 0.6 ms)
// and loads every operand from shared memory, so it sits far above the
// bound; a wgmma/TMA pipeline is the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per kv tile
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;   // query rows per warp
constexpr float NEG_INF = -1e30f;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * DH + BK * (DH + 1) + BK * DH + WARPS * ROWS * BK);
}

template <typename T, int DH>
__global__ void __launch_bounds__(WARPS * 32)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KVH,
                 int Sq, int Skv, float scale, int causal, int window) {
  constexpr int C = DH / 32;       // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][DH]
  float* Ks = Qs + BQ * DH;               // [BK][DH + 1]
  float* Vs = Ks + BK * (DH + 1);         // [BK][DH]
  float* Ps = Vs + BK * DH;               // [WARPS][ROWS][BK]

  const int bh = blockIdx.y;              // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q_lo = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * ROWS;

  const T* qb = q + (long long)bh * Sq * DH;
  const T* kb = k + (long long)(b * KVH + kvh) * Skv * DH;
  const T* vb = v + (long long)(b * KVH + kvh) * Skv * DH;
  T* ob = o + (long long)bh * Sq * DH;

  for (int e = tid; e < BQ * DH; e += WARPS * 32) {
    const int r = e / DH;
    Qs[e] = (q_lo + r < Sq) ? to_f(qb[(long long)q_lo * DH + e]) : 0.f;
  }

  // The kv tiles that can hold a live key of this q tile.
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  int kt_begin = 0, kt_end = (Skv + BK - 1) / BK;
  if (causal) {
    kt_end = min(kt_end, q_hi / BK + 1);               // k0 <= q_hi
    if (window > 0) kt_begin = max(0, q_lo - window + 1) / BK;
  }

  float m[ROWS], l[ROWS], acc[ROWS][C];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                       // the last tile is consumed
    for (int e = tid; e < BK * DH; e += WARPS * 32) {
      const int r = e / DH, c = e % DH;
      const bool in = k0 + r < Skv;
      const long long g = (long long)k0 * DH + e;
      Ks[r * (DH + 1) + c] = in ? to_f(kb[g]) : 0.f;
      Vs[e] = in ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float ka = Ks[lane * (DH + 1) + d];
      const float kc = Ks[(lane + 32) * (DH + 1) + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = Qs[(row0 + r) * DH + d];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kc, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q_lo + row0 + r;
      float sv[2];
      bool ghost[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = k0 + lane + 32 * c;
        ghost[c] = j >= Skv;
        const bool masked = (causal && j > qi) ||
                            (window > 0 && j <= qi - window);
        sv[c] = (ghost[c] || masked) ? NEG_INF : s[r][c] * scale;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sv[0], sv[1])));
      const float corr = expf(m[r] - m_new);
      const float p0 = ghost[0] ? 0.f : expf(sv[0] - m_new);
      const float p1 = ghost[1] ? 0.f : expf(sv[1] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= corr;
      float* prow = Ps + (row0 + r) * BK;
      prow[lane] = to_f(from_f<T>(p0));
      prow[lane + 32] = to_f(from_f<T>(p1));
    }
    __syncwarp();

    for (int j = 0; j < BK; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = Vs[j * DH + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = Ps[(row0 + r) * BK + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q_lo + row0 + r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      ob[(long long)qi * DH + lane + 32 * c] = from_f<T>(acc[r][c] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KVH, int Sq, int Skv, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<T, DH><<<grid, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KVH, Sq, Skv, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int B, int H, int KVH, int Sq, int Skv, float scale,
              int causal, int window, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                            window, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: [B, H, Sq, dh]; k, v: [B, KVH, Skv, dh]; all contiguous, one
// dtype (bfloat16 when is_bf16, else float32), on one device.  dh is 32,
// 64 or 128; window 0 means none.  Launches on `stream` and returns the
// CUDA error code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KVH, int Sq, int Skv, int dh,
                                      int is_bf16, int causal, int window,
                                      float scale, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, B, H, KVH, Sq, Skv,
                                    scale, causal, window, st);
  return launch_dh<float>(dh, q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                          window, st);
}
