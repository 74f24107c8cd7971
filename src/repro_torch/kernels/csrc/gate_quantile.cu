// Order statistics of the online carbon gate's forecast windows, for Hopper.
//
// Replaces the TPU kernel `gate_quantile_stats_pallas` (body `_kernel`) in
// src/repro/kernels/gate_quantile.py.  For row r and epoch t, the window is
//
//     x = intensity[r, t : t + min(window[r], max_window)], cut at E,
//
// with n valid slots.  With lo = floor(theta[r, t] * (n - 1)) in float32 and
// hi = min(lo + 1, n - 1), both clamped to [0, max_window - 1] as the plain
// version's gather clamps them, the kernel writes
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
// one ulp off in the reference.  Where no slot has rank lo (lo >= n, so
// also n == 0) the output is +inf, the value the sort puts there.
//
// Design: a sliding-window selection.  Consecutive epochs' windows share
// n - 1 slots, so each warp owns one segment of one row (kSeg consecutive
// epochs), ranks the segment's first window once by counting, and from then
// on keeps every slot's stable rank up to date as the window slides:
//
//   - the slot of epoch t leaves: it is the window's earliest, so every slot
//     whose key (value, epoch) is greater has value >= x_t; their ranks drop
//     by one;
//   - the slot of epoch t + w enters, unless the window is cut at E: it is
//     the latest, so its rank is #{slots with value <= its value}, and every
//     slot with a greater value moves up by one.
//
// Each step is O(n / 32) compares a lane plus one `__reduce_add_sync`.  Keys
// are compared as floats (`>=`, `>`), never as integer bit patterns: those
// would order -0.0 before +0.0, where the stable sort keeps them in epoch
// order.  NaN intensities are out of scope (a NaN ranks nowhere).
//
// Register path (max_window <= kRegWindow): the window's values and ranks
// live in a ring of w slots, slot i in lane i % 32, register i / 32, with K =
// ceil(w / 32) registers a lane (the kernel is instantiated for K = 1..8 and
// each warp takes its row's K).  The leaving slot is the one the entering
// slot takes over.  An empty slot holds NaN, which no compare counts, and
// rank kEmpty, which no lo/hi selects.  The values that leave and enter and
// each epoch's lo/hi are loaded 32 epochs at a time, one per lane, and
// handed out by `__shfl_sync`; a/b land in shared memory by whichever lane
// holds the rank and leave as one coalesced store per 32 epochs.
//
// Shared-memory path (max_window > kRegWindow): the same update, with the
// ranks in shared memory indexed by epoch (kWideSeg + max_window - 1 ints a
// warp, the span a segment touches) and the values read from L1/L2.  Its
// shared memory admits the widths the kernel admitted before (up to ~58k).
//
// Bound at the sweep's shape (R = 1000 instances x 3 thetas x 2 windows =
// 6000 rows, E = 768, windows 48 / 96): intensity and theta read once
// (18.4 MB each, intensity is passed per row), window 24 KB, a, b, n written
// once (55.3 MB): 92.2 MB, 0.0275 ms at 3.35 TB/s.  The selection needs ~2n
// compares per window, 0.66 G in all, 0.01 ms at 67 Tops/s: the function is
// bound by bytes.  The kernel is bound by instruction issue: each step
// costs a dozen or so warp instructions per register slot (the two
// compares and the rank update, the a/b select, the ring head's takeover)
// plus a fixed few dozen, over 4.6 M steps, and each segment's first
// ranking adds about kSeg steps' worth.  chip_smoke.py measured 0.39 ms on
// an H100 80GB HBM3 at 700 W, 0.07 of the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSeg = 128;         // epochs a warp slides over, register path
constexpr int kRegWindow = 256;   // widest max_window held in registers
constexpr int kRegWarps = 4;      // warps a block, register path
constexpr int kWideSeg = 32;      // epochs a warp slides over, shared path
constexpr int kWideWarps = 8;     // most warps a block, shared path
constexpr int kMaxShared = 232448;  // dynamic shared memory a block may use
constexpr int kEmpty = 1 << 30;   // rank of an empty ring slot

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// lo and hi of an epoch whose window has n slots, clamped to [0, top] as the
// plain version's gather clamps them.
__device__ __forceinline__ void ranks_of(float theta, int n, int top, int& lo,
                                         int& hi) {
  const int l = (int)floorf(__fmul_rn(theta, (float)(n - 1)));
  lo = min(max(l, 0), top);
  hi = min(max(min(l + 1, n - 1), 0), top);
}

// Epochs [t0, t1) of a row whose window is empty (window <= 0).
__device__ void empty_segment(float* a, float* b, int32_t* n, int t0, int t1,
                              int lane) {
  for (int t = t0 + lane; t < t1; t += 32) {
    a[t] = INFINITY;
    b[t] = INFINITY;
    n[t] = 0;
  }
}

// One warp's share of the register path: epochs [t0, t1) of one row (x, th,
// a, b, n point at the row), window w.
struct Segment {
  const float* x;   // the row's intensity
  const float* th;  // the row's theta
  float* a;
  float* b;
  int32_t* n;
  int E, w, top, t0, t1, lane;
  float* sa;  // 32 floats of the warp's shared memory
  float* sb;  // 32 more
};

// Slides over the segment with the window's w <= 32 K slots in registers.
template <int K>
__device__ __forceinline__ void slide_regs(const Segment& s) {
  const float* __restrict__ x = s.x;
  const int E = s.E, w = s.w, t0 = s.t0, t1 = s.t1, lane = s.lane;
  float* sa = s.sa;
  float* sb = s.sb;
  float val[K];
  int rank[K];
  const int n0 = min(w, E - t0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    val[k] = i < n0 ? __ldg(x + t0 + i) : nan_f();
    rank[k] = 0;
  }
  // The first window by counting.  Ring slot i holds epoch t0 + i, so slot
  // 32 kk + src is earlier than 32 k + lane iff kk < k, or kk == k and
  // src < lane: an earlier equal value counts, a later one does not.
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int srcs = min(32, n0 - 32 * kk);  // warp-uniform
    for (int src = 0; src < srcs; ++src) {
      const float xu = __shfl_sync(kFull, val[kk], src);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool before = kk < k || (kk == k && src < lane);
        rank[k] += before ? (xu <= val[k]) : (xu < val[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (32 * k + lane >= n0) rank[k] = kEmpty;

  int head = 0;  // ring slot of epoch t: (t - t0) mod w
  for (int c0 = t0; c0 < t1; c0 += 32) {
    // Lane j loads what epoch c0 + j needs: the value that leaves after it,
    // the value that enters (NaN: none, the window is cut at E), lo/hi.
    const int te = c0 + lane;
    float xo_c = 0.0f, xn_c = nan_f();
    int lohi_c = 0, n_e = 0;
    if (te < t1) {
      xo_c = __ldg(x + te);
      if (te + w < E) xn_c = __ldg(x + te + w);
      n_e = min(w, E - te);
      int lo, hi;
      ranks_of(__ldg(s.th + te), n_e, s.top, lo, hi);
      lohi_c = lo | (hi << 16);
    }
    sa[lane] = INFINITY;
    sb[lane] = INFINITY;
    __syncwarp();
    const int steps = min(32, t1 - c0);
    for (int j = 0; j < steps; ++j) {
      const int lohi = __shfl_sync(kFull, lohi_c, j);
      const int lo = lohi & 0xffff, hi = lohi >> 16;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (rank[k] == lo) sa[j] = val[k];
        if (rank[k] == hi) sb[j] = val[k];
      }
      if (c0 + j + 1 == t1) break;  // warp-uniform: the segment's last epoch
      const float xo = __shfl_sync(kFull, xo_c, j);
      const float xn = __shfl_sync(kFull, xn_c, j);
      int gt = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int g = val[k] > xn;
        rank[k] += g - (int)(val[k] >= xo);
        gt += g;
      }
      // The leaving slot holds xo and is counted in gt where xo > xn.
      const int greater = (int)__reduce_add_sync(kFull, (unsigned)gt) -
                          (int)(xo > xn);
      const int r_new = xn == xn ? w - 1 - greater : kEmpty;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (32 * k + lane == head) {
          val[k] = xn;
          rank[k] = r_new;
        }
      }
      head = head + 1 == w ? 0 : head + 1;
    }
    __syncwarp();
    if (te < t1) {
      s.a[te] = sa[lane];
      s.b[te] = sb[lane];
      s.n[te] = n_e;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kRegWarps * 32)
    gate_slide_regs_kernel(const float* __restrict__ intensity,
                           const float* __restrict__ theta,
                           const int32_t* __restrict__ window,
                           float* __restrict__ a_out,
                           float* __restrict__ b_out,
                           int32_t* __restrict__ n_out, int rows,
                           int n_epochs, int max_window, int segs) {
  __shared__ float stage[kRegWarps][2][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * kRegWarps + warp;
  if (g >= (long long)rows * segs) return;  // the whole warp
  const long long row = g / segs;
  const int t0 = (int)(g % segs) * kSeg;
  const int t1 = min(t0 + kSeg, n_epochs);
  const long long off = row * n_epochs;
  const Segment seg{intensity + off, theta + off, a_out + off, b_out + off,
                    n_out + off, n_epochs,
                    min(__ldg(window + row), max_window), max_window - 1,
                    t0, t1, lane, stage[warp][0], stage[warp][1]};
  switch ((seg.w + 31) >> 5) {  // registers a lane: ceil(w / 32)
    case 1: slide_regs<1>(seg); break;
    case 2: slide_regs<2>(seg); break;
    case 3: slide_regs<3>(seg); break;
    case 4: slide_regs<4>(seg); break;
    case 5: slide_regs<5>(seg); break;
    case 6: slide_regs<6>(seg); break;
    case 7: slide_regs<7>(seg); break;
    case 8: slide_regs<8>(seg); break;
    default: empty_segment(seg.a, seg.b, seg.n, t0, t1, lane);  // w <= 0
  }
}

// The shared-memory path: one warp per (row, kWideSeg epochs); rk holds the
// stable rank of epoch p at rk[p - t0] while p is in the window.
__global__ void gate_slide_shared_kernel(const float* __restrict__ intensity,
                                         const float* __restrict__ theta,
                                         const int32_t* __restrict__ window,
                                         float* __restrict__ a_out,
                                         float* __restrict__ b_out,
                                         int32_t* __restrict__ n_out, int rows,
                                         int n_epochs, int max_window,
                                         int segs, int warps_per_block) {
  extern __shared__ int rank_s[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * warps_per_block + warp;
  if (g >= (long long)rows * segs) return;  // the whole warp
  const long long row = g / segs;
  const int t0 = (int)(g % segs) * kWideSeg;
  const int t1 = min(t0 + kWideSeg, n_epochs);
  const long long off = row * n_epochs;
  const float* x = intensity + off;
  const float* th = theta + off;
  float* a = a_out + off;
  float* b = b_out + off;
  int32_t* nout = n_out + off;
  int* rk = rank_s + warp * (kWideSeg + max_window - 1);
  const int w = min(__ldg(window + row), max_window);
  if (w <= 0) {
    empty_segment(a, b, nout, t0, t1, lane);
    return;
  }
  const int top = max_window - 1;
  const int n0 = min(w, n_epochs - t0);
  for (int j = lane; j < n0; j += 32) {
    const float v = __ldg(x + t0 + j);
    int r = 0;
    for (int u = 0; u < n0; ++u) {
      const float xu = __ldg(x + t0 + u);
      r += (xu < v) | ((xu == v) & (u < j));
    }
    rk[j] = r;
  }
  __syncwarp();
  for (int t = t0; t < t1; ++t) {
    const int n = min(w, n_epochs - t);
    int lo, hi;
    ranks_of(__ldg(th + t), n, top, lo, hi);
    const bool slide = t + 1 < t1;                       // warp-uniform
    const float xo = __ldg(x + t);
    const float xn = slide && t + w < n_epochs ? __ldg(x + t + w) : nan_f();
    int gt = 0;
    for (int j = lane; j < n; j += 32) {
      const float v = __ldg(x + t + j);
      int r = rk[t + j - t0];
      if (r == lo) a[t] = v;
      if (r == hi) b[t] = v;
      if (slide && j > 0) {  // j == 0 is the slot that leaves
        const int gg = v > xn;
        r += gg - (int)(v >= xo);
        gt += gg;
        rk[t + j - t0] = r;
      }
    }
    if (lane == 0) {
      if (lo >= n) a[t] = INFINITY;
      if (hi >= n) b[t] = INFINITY;
      nout[t] = n;
    }
    if (xn == xn) {  // warp-uniform: epoch t + w enters
      const int greater = (int)__reduce_add_sync(kFull, (unsigned)gt);
      if (lane == 0) rk[t + w - t0] = w - 1 - greater;
    }
    __syncwarp();
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
  if (max_window < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (max_window <= kRegWindow) {
    const int segs = (n_epochs + kSeg - 1) / kSeg;
    const long long blocks =
        ((long long)rows * segs + kRegWarps - 1) / kRegWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    gate_slide_regs_kernel<<<(unsigned)blocks, kRegWarps * 32, 0, s>>>(
        (const float*)intensity, (const float*)theta, (const int32_t*)window,
        (float*)a, (float*)b, (int32_t*)n, rows, n_epochs, max_window, segs);
    return (int)cudaGetLastError();
  }
  const int segs = (n_epochs + kWideSeg - 1) / kWideSeg;
  const long long per_warp =
      (long long)(kWideSeg + max_window - 1) * (long long)sizeof(int);
  const int wpb = (int)(kMaxShared / per_warp < kWideWarps
                            ? kMaxShared / per_warp
                            : kWideWarps);
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)rows * segs + wpb - 1) / wpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)(wpb * per_warp);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gate_slide_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  gate_slide_shared_kernel<<<(unsigned)blocks, wpb * 32, smem, s>>>(
      (const float*)intensity, (const float*)theta, (const int32_t*)window,
      (float*)a, (float*)b, (int32_t*)n, rows, n_epochs, max_window, segs,
      wpb);
  return (int)cudaGetLastError();
}
