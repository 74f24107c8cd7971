// Order statistics of the online carbon gate's forecast windows, for Hopper.
//
// Replaces the TPU kernel `gate_quantile_stats_pallas` (body `_kernel`) in
// src/repro/kernels/gate_quantile.py.  For row r and epoch t, the window is
//
//     x = intensity[r, t : t + min(window[r], max_window)], cut at E,
//
// with n valid slots.  With lo = floor(theta[r, t] * (n - 1)) in float32 and
// hi = min(lo + 1, n - 1), the kernel writes
//
//     a[r, t] = the value of stable rank lo,  b[r, t] = that of rank hi,
//     n[r, t] = n,
//
// where the stable rank of slot w is #{u : x_u < x_w} + #{u < w : x_u == x_w}
// (the position a stable sort gives it).  It only selects: every output is a
// loaded value, so it equals the plain version (torch.sort, kernels/ref.py)
// bitwise.  theta * (n - 1) is one `__fmul_rn`, so nvcc contracts nothing
// into it, and floorf is exact.  np.quantile's lerp between a and b is left
// to the wrapper (ops.gate_threshold), in torch: an in-kernel lerp came out
// one ulp off in the reference.  Where no slot has rank lo (n == 0) the
// output is +inf, the value the sort puts there.
//
// Design.  One block of 8 warps per (row, tile of 32 epochs).  The tile's
// stretch intensity[t0 : t0 + 32 + max_window - 1] (+inf past E) is staged
// in shared memory once, so the shifted windows are read from there.  Each
// warp takes one epoch at a time; each lane ranks its slots w = lane,
// lane + 32, ... against the whole window by counting (shared loads are
// broadcasts), and the lanes whose rank is lo / hi write a / b.  The TPU's
// [be, 128]-lane padding is gone: the ragged edge and windows wider than
// 128 are masked by n.  Intensities are taken to be finite (NaN ranks
// nowhere).
//
// Bound at the sweep's shape (R = 1000 instances x 3 thetas x 2 windows =
// 6000 rows, E = 768, windows 48 / 96): intensity and theta read once
// (18.4 MB each, intensity is passed per row), window 24 KB, a, b, n written
// once (55.3 MB): 92.2 MB, 0.0275 ms at 3.35 TB/s.  A linear-time selection
// needs ~2n compares per window, 0.66 G in all, 0.01 ms at 67 Tops/s: the
// function is bound by bytes.  Rank counting does n^2 compares instead
// (26.5 G here); its time beside the bound is what that costs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;                   // epochs per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void gate_quantile_kernel(const float* __restrict__ intensity,
                                     const float* __restrict__ theta,
                                     const int32_t* __restrict__ window,
                                     float* __restrict__ a_out,
                                     float* __restrict__ b_out,
                                     int32_t* __restrict__ n_out,
                                     int n_epochs, int max_window,
                                     int tiles) {
  extern __shared__ float stretch[];
  const long long row = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kTile;
  const float* irow = intensity + row * n_epochs;
  const int span = kTile + max_window - 1;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int e = t0 + i;
    stretch[i] = e < n_epochs ? __ldg(irow + e) : INFINITY;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = min(__ldg(window + row), max_window);
  for (int k = warp; k < kTile; k += kWarps) {
    const int t = t0 + k;
    if (t >= n_epochs) break;                // warp-uniform
    const long long o = row * n_epochs + t;
    const int n = max(0, min(w, n_epochs - t));
    const float vi = __fmul_rn(__ldg(theta + o), (float)(n - 1));
    const int lo = (int)floorf(vi);
    const int hi = min(lo + 1, n - 1);
    const float* x = stretch + k;
    bool wrote_a = false, wrote_b = false;
    for (int j = lane; j < n; j += 32) {
      const float xj = x[j];
      int rank = 0;
      for (int u = 0; u < n; ++u) {
        const float xu = x[u];
        rank += (xu < xj) | ((xu == xj) & (u < j));
      }
      if (rank == lo) { a_out[o] = xj; wrote_a = true; }
      if (rank == hi) { b_out[o] = xj; wrote_b = true; }
    }
    const bool any_a = __any_sync(kFull, wrote_a);
    const bool any_b = __any_sync(kFull, wrote_b);
    if (lane == 0) {
      if (!any_a) a_out[o] = INFINITY;
      if (!any_b) b_out[o] = INFINITY;
      n_out[o] = n;
    }
  }
}

}  // namespace

// intensity, theta: [rows, n_epochs] float32; window: [rows] int32;
// a, b: [rows, n_epochs] float32; n: [rows, n_epochs] int32.  All
// contiguous, on one device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int gate_quantile_launch(const void* intensity, const void* theta,
                                    const void* window, void* a, void* b,
                                    void* n, int rows, int n_epochs,
                                    int max_window, void* stream) {
  if (rows == 0 || n_epochs == 0) return 0;
  const int tiles = (n_epochs + kTile - 1) / kTile;
  const long long blocks = (long long)rows * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // The staged stretch: kTile + max_window - 1 floats (the wrapper keeps
  // it within the 227 KB a block may have).
  const int smem = (kTile + max_window - 1) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gate_quantile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  gate_quantile_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                         (cudaStream_t)stream>>>(
      (const float*)intensity, (const float*)theta, (const int32_t*)window,
      (float*)a, (float*)b, (int32_t*)n, n_epochs, max_window, tiles);
  return (int)cudaGetLastError();
}
