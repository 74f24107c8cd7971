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
// Bound at hymba-1.5b's prefill (B=1, H=25, KVH=5, S=4096, window 2048,
// dh=64): about 6.29 M live (q, k) pairs per head, 2 x 2 x 64 flops each,
// 40.3 GFLOP: 0.041 ms at 989 TFLOP/s bf16 on the tensor cores, against
// 31.5 MB of q, k, v and o (0.009 ms at 3.35 TB/s): bound by operations,
// so the products have to run on the tensor cores at their full rate.
//
// The bfloat16 route: both products on wgmma, K/V staged by TMA.  One
// block per (b * H + h, tile of 64 query rows), the longest rows first:
// one consumer warpgroup (128 threads) and one producer warp.  The
// producer loads the q tile once and then the K and V tiles of 64 keys
// that can hold a live key (tiles fully above the diagonal or fully below
// the window are skipped, as in the reference, flash_attention.py:42-48)
// by TMA (cp.async.bulk.tensor over a 3-d map [rows of (b, head), S, dh],
// so rows past S arrive as zeros) into a ring of STAGES stages, each
// signalled on an mbarrier; the consumers release a stage on another.
// Rows are 64 bf16 columns of 128 bytes with the 128-byte swizzle (dh 128
// is two such chunks; dh 32 one chunk of 64 bytes with the 64-byte
// swizzle), the layout wgmma's descriptors read.  S = Q K^T is
// wgmma.m64n64k16 with both operands from shared memory (K-major); the
// softmax runs on the accumulator, whose rows spread over the 4 threads
// of a quad (row max and sum by __shfl_xor_sync); p, rounded to bf16,
// stays in registers as the A operand of O += P V (wgmma.m64n{dh}k16, V
// from shared memory, MN-major by the transpose bit).  The bf16 products
// are exact and sum in f32, so the reference's numerics carry over.  Ghost
// keys past Skv score -inf (p = 0); ghost rows are not written.
//
// The float32 route keeps the first version's FFMA kernel (one block of 4
// warps per 64 query rows, operands from shared memory): TF32 tensor
// cores cannot meet float32's 2e-5 contract, and no serve path runs f32
// attention (the parameters are cast to bf16 at use).  The route is chosen
// by dtype in flash_attention_launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per kv tile
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;   // query rows per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------- the float32 route: FFMA

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * DH + BK * (DH + 1) + BK * DH + WARPS * ROWS * BK);
}

template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int KVH,
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

  const float* qb = q + (long long)bh * Sq * DH;
  const float* kb = k + (long long)(b * KVH + kvh) * Skv * DH;
  const float* vb = v + (long long)(b * KVH + kvh) * Skv * DH;
  float* ob = o + (long long)bh * Sq * DH;

  for (int e = tid; e < BQ * DH; e += WARPS * 32) {
    const int r = e / DH;
    Qs[e] = (q_lo + r < Sq) ? qb[(long long)q_lo * DH + e] : 0.f;
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
      Ks[r * (DH + 1) + c] = in ? kb[g] : 0.f;
      Vs[e] = in ? vb[g] : 0.f;
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
      prow[lane] = p0;
      prow[lane + 32] = p1;
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
      ob[(long long)qi * DH + lane + 32 * c] = acc[r][c] / denom;
  }
}

// ------------------------------------------------ the bf16 route: wgmma + TMA

constexpr int STAGES = 2;                  // K/V ring depth
constexpr int CONSUMERS = 128;             // one warpgroup
constexpr int WG_THREADS = CONSUMERS + 32; // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

// The shared-memory tiles of one head dim.  A 64-row tile is NCH chunks
// of CC columns, each [64 rows][ROW bytes], swizzled by TMA.
template <int DH>
struct Tiles {
  static constexpr int CC = DH < 64 ? DH : 64;
  static constexpr int NCH = DH / CC;
  static constexpr int ROW = 2 * CC;                    // 64 or 128 bytes
  static constexpr uint32_t LAYOUT = ROW == 128 ? 1 : 2; // 128B / 64B swizzle
  static constexpr int CHUNK = BK * ROW;
  static constexpr int TILE = NCH * CHUNK;
  // q, then STAGES (K, V) pairs, the barriers, and room to align to 1 KB.
  static constexpr size_t SMEM =
      1024 + (size_t)TILE * (1 + 2 * STAGES) + 8 * (1 + 2 * STAGES);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__device__ __forceinline__ void pv_product(float (&acc)[DH / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (DH == 32) hopper::wgmma_m64n32k16_rs_tb(acc, a, db);
  if constexpr (DH == 64) hopper::wgmma_m64n64k16_rs_tb(acc, a, db);
  if constexpr (DH == 128) hopper::wgmma_m64n128k16_rs_tb(acc, a, db);
}

template <int DH>
__global__ void __launch_bounds__(WG_THREADS)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int H, int KVH, int Sq,
                       int Skv, float scale, int causal, int window) {
  using T = Tiles<DH>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + T::TILE * (1 + 2 * STAGES));
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;               // [STAGES]: K and V landed
  uint64_t* empty = bars + 1 + STAGES;     // [STAGES]: consumers done

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int bh = blockIdx.y;                           // b * H + h
  const int kv = (bh / H) * KVH + (bh % H) / (H / KVH);
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  int kt_begin = 0, kt_end = (Skv + BK - 1) / BK;
  if (causal) {
    kt_end = min(kt_end, q_hi / BK + 1);
    if (window > 0) kt_begin = max(0, q_lo - window + 1) / BK;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {          // the producer warp
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, T::TILE);
      for (int c = 0; c < T::NCH; ++c)
        tma_load_3d(qs + c * T::CHUNK, &tq, q_full, c * T::CC, q_lo, bh);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        uint8_t* ks = smem + T::TILE * (1 + 2 * s);
        uint8_t* vs = ks + T::TILE;
        mbar_expect_tx(&full[s], 2 * T::TILE);
        for (int c = 0; c < T::NCH; ++c) {
          tma_load_3d(ks + c * T::CHUNK, &tk, &full[s], c * T::CC, kt * BK,
                      kv);
          tma_load_3d(vs + c * T::CHUNK, &tv, &full[s], c * T::CC, kt * BK,
                      kv);
        }
      }
    }
    return;
  }

  // The consumer warpgroup.  Thread (warp w, lane l) holds rows
  // row = 16 w + l / 4 and row + 8 of the tile, and in each 8-column block
  // j of an accumulator columns 8 j + colq and 8 j + colq + 1:
  // d[4 j + 2 half + c] is (row + 8 half, 8 j + colq + c).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * warp + (lane >> 2);
  const int colq = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;         // exp(x) = exp2(x log2 e)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DH / 2];
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) acc[e] = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % STAGES;
    const uint8_t* ks = smem + T::TILE * (1 + 2 * s);
    const uint8_t* vs = ks + T::TILE;
    mbar_wait(&full[s], (i / STAGES) & 1);

    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // k-step kk: 16 columns, 32 bytes into a swizzled row of its chunk
      const int off = (kk * 16 / T::CC) * T::CHUNK + (kk * 16 % T::CC) * 2;
      wgmma_m64n64k16_ss(sc, wgmma_desc(qs + off, 16, 8 * T::ROW, T::LAYOUT),
                         wgmma_desc(ks + off, 16, 8 * T::ROW, T::LAYOUT),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Scores in log2 units; masked -1e30, ghost keys -inf (p = 0).
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q_lo) ||
                      (window > 0 && k0 <= q_lo + BQ - 1 - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int half = (e >> 1) & 1;
      float v = sc[e] * sl2;
      if (edge) {
        const int j = k0 + 8 * (e >> 2) + colq + (e & 1);
        const int qi = q_lo + row + 8 * half;
        if (j >= Skv)
          v = -INFINITY;
        else if ((causal && j > qi) || (window > 0 && j <= qi - window))
          v = NEG_INF;
      }
      sc[e] = v;
      mx[half] = fmaxf(mx[half], v);
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float m_new = fmaxf(m[half], mx[half]);
      corr[half] = exp2f(m[half] - m_new);
      m[half] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int half = (e >> 1) & 1;
      sc[e] = exp2f(sc[e] - m[half]);
      rs[half] += sc[e];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 1);
      rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 2);
      l[half] = l[half] * corr[half] + rs[half];
    }
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) acc[e] *= corr[(e >> 1) & 1];

    // p as wgmma's A fragments: k-step kk covers accumulator blocks 2 kk
    // and 2 kk + 1, which is the fragment layout register for register.
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pv_product<DH>(acc, a[kk],
                     wgmma_desc(vs + kk * 16 * T::ROW, T::CHUNK, 8 * T::ROW,
                                T::LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q_lo + row + 8 * half;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[half], 1e-30f);
    __nv_bfloat16* orow = o + ((long long)bh * Sq + qi) * DH + colq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] / den,
                                acc[4 * j + 2 * half + 1] / den);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 3-d map [depth][rows][dh] of a contiguous bf16 tensor, in boxes of
// 64 rows by one swizzle chunk of columns.
int tensor_map(CUtensorMap* map, const void* ptr, int dh, int rows,
               int depth) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int cc = dh < 64 ? dh : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)rows,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)rows * dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cc, (cuuint32_t)BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int B, int H, int KVH, int Sq, int Skv, float scale,
                 int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, DH, Sq, B * H);
  if (err == 0) err = tensor_map(&tk, k, DH, Skv, B * KVH);
  if (err == 0) err = tensor_map(&tv, v, DH, Skv, B * KVH);
  if (err != 0) return err;
  const size_t smem = Tiles<DH>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_wgmma_kernel<DH><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, H, KVH, Sq, Skv, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_ffma(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KVH, int Sq, int Skv, float scale, int causal,
                int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<DH><<<grid, WARPS * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H, KVH,
      Sq, Skv, scale, causal, window);
  return (int)cudaGetLastError();
}

// The route of q's dtype, for head dim DH.
template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KVH, int Sq, int Skv, int is_bf16, float scale,
           int causal, int window, cudaStream_t stream) {
  if (is_bf16)
    return launch_wgmma<DH>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                            window, stream);
  return launch_ffma<DH>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                         window, stream);
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
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, o, B, H, KVH, Sq, Skv, is_bf16, scale,
                        causal, window, st);
    case 64:
      return launch<64>(q, k, v, o, B, H, KVH, Sq, Skv, is_bf16, scale,
                        causal, window, st);
    case 128:
      return launch<128>(q, k, v, o, B, H, KVH, Sq, Skv, is_bf16, scale,
                         causal, window, st);
  }
  return (int)cudaErrorInvalidValue;
}
