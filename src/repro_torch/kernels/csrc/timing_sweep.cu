// The carbon-greedy timing sweep of a batch of candidate schedules, for
// Hopper: every sweep of every candidate row in one launch.
//
// It replaces no TPU kernel.  The reference's `timing_sweep`
// (src/repro/core/decoder.py) is plain `jnp` under `lax.scan`, and the
// port's plain version (`decoder.timing_sweep_plain`) loops over the
// T x sweeps task steps in Python, scoring every start s in [0, H] of every
// row at each step: `[rows, H + 1]` index, cost and mask tensors, 80 steps
// a call at the bi-level path's shape.  That loop was ~93% of a phase-2
// fitness call's device time, so this kernel was added for it.
//
// What it computes, row by row (a row is one candidate `[T]`): `sweeps`
// times, rank the row's tasks by the key start * T + t, descending, pads
// last (a stable order: ties by index); then for each task t of that order
// that is sweepable (real and not frozen):
//
//     cap  = min start of t's successors and of the later tasks of t's
//            machine (key above t's), BIG = 1 << 28 if none
//     hi   = min(cap, deadline) - d_t,  lo = start[t]
//     if hi >= lo:  start[t] = argmin over s in [lo, hi] of
//                              cum[min(s + d_t, H)] - cum[s]
//
// with the first index winning ties, as `argmin` does.  Only s in
// [max(lo, 0), min(hi, H)] can win, so the kernel scans that window and no
// other position: work is bounded by each row's slack, not by H.  Where the
// window holds no position (lo > H) or every cost in it is +inf, the plain
// argmin over an all-+inf row returns 0, and so does the kernel.  NaN wins
// as in torch's argmin (the first NaN).  Costs are the same single float32
// subtraction of two loaded values, keys and caps the same wrap-around
// int32 arithmetic: the starts equal the plain version's bit for bit.
//
// Bound at the bi-level path's shape ([250, 96, 40], H = 1500, 2 sweeps):
// by bytes, each input read once and the output written once, 17.26 MB a
// call (cum [250, 1501] f32, starts, servers and durations [250, 96, 40]
// i32, pred [250, 40, 40], the deadline, the new starts), 5.2 us at
// 3.35 TB/s.  Its operations scale with the slack in the data, and its
// steps are sequential within a row (each task's window depends on the
// starts its successors already took), so the time is the latency of a
// row's chain of 80 steps, spread over enough rows to fill the card.
//
// Design.  A block serves one instance and up to 8 of its candidate rows,
// one warp a row.  It stages the instance's `cum` row (6 KB at H = 1500) in
// shared memory with 16-byte loads, and the instance's successor sets as
// bitmasks of ceil(T / 32) words a task; each warp keeps its row's starts,
// keys, machines, durations (gathered from `dur` by the row's servers) and
// order in shared memory.  A task step is two warp reductions: the cap
// (a min over the T tasks) and the window's argmin over (cost, index),
// 32 positions a pass.  Rows a block and the grid follow from the shapes:
// rows sharing an instance and a `cum` row form a group, cut into blocks of
// at most 8 rows (fewer where shared memory would not hold them); a `cum`
// row too long for shared memory (H + 1 above ~58k floats) is read from
// global memory / L2 by the same kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRows = 8;          // rows (warps) a block
constexpr int32_t kBig = 1 << 28;    // the plain version's BIG
constexpr long long kMaxShared = 232448;
constexpr int kRowPad = 8;           // staged floats beyond H + 1
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const int32_t* start;      // [rows, T]
  const int32_t* assign;     // [rows, T]
  int32_t* out;              // [rows, T]
  const int32_t* dur;        // [Gi, T, M]
  const uint8_t* pred;       // [Gi, T, T]; pred[t][u]: u before t
  const uint8_t* task_mask;  // [Gi, T]
  const float* cum;          // [Gc, H + 1]
  const int32_t* deadline;   // [Gd], or null: deadline_scalar
  const uint8_t* frozen;     // [Gf, T], or null
  long long rows_per_inst, rows_per_cum, rows_per_deadline, rows_per_frozen;
  long long group;           // rows a group: one instance, one cum row
  int splits;                // blocks a group
  int rows_per_block;
  int tasks, machines, horizon, words, sweeps, deadline_scalar;
};

// (v, i) before (w, j) in torch's argmin order: NaN first, then the
// smaller value, ties to the smaller index; i < 0 is no position.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  if (j < 0) return i >= 0;
  if (i < 0) return false;
  const bool vn = v != v, wn = w != w;
  if (vn || wn) return vn && (!wn || i < j);
  if (v == w) return i < j;
  return v < w;
}

// a - b in wrap-around int32, as the plain version's tensors compute it.
__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxRows * kWarp)
    timing_sweep_kernel(const Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = p.tasks, W = p.words, H = p.horizon;
  const long long g0 = (long long)(blockIdx.x / p.splits) * p.group;
  const int sub = blockIdx.x % p.splits;
  const long long r0 = g0 + (long long)sub * p.rows_per_block;
  const int nrows =
      (int)min((long long)p.rows_per_block, g0 + p.group - r0);
  const long long gi = g0 / p.rows_per_inst;
  const float* crow = p.cum + (g0 / p.rows_per_cum) * (long long)(H + 1);

  int off = 0;
  const float* cw = crow;
  if (kStaged) {
    // scum[pad + i] = crow[i], pad chosen so that 16-byte chunks of scum
    // face 16-byte aligned chunks of crow.
    float* scum = reinterpret_cast<float*>(smem);
    const int pad = (int)((reinterpret_cast<uintptr_t>(crow) >> 2) & 3);
    const int len = H + 1;
    const int chunks = (len + pad + 3) >> 2;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int lo = 4 * c - pad;
      if (lo >= 0 && lo + 4 <= len) {
        *reinterpret_cast<float4*>(scum + 4 * c) =
            __ldg(reinterpret_cast<const float4*>(crow + lo));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = lo + j;
          if (i >= 0 && i < len) scum[4 * c + j] = __ldg(crow + i);
        }
      }
    }
    cw = scum + pad;
    off = 4 * chunks;
  }
  // succ[t * W + w], bit b: task 32 w + b is a real successor of t.
  uint32_t* succ = smem + off;
  const uint8_t* pred = p.pred + gi * T * T;
  const uint8_t* mask = p.task_mask + gi * T;
  for (int k = threadIdx.x; k < T * W; k += blockDim.x) {
    const int t = k / W, w = k % W;
    uint32_t bits = 0;
    for (int b = 0; b < kWarp; ++b) {
      const int u = w * kWarp + b;
      if (u < T && pred[(long long)u * T + t] && mask[u]) bits |= 1u << b;
    }
    succ[k] = bits;
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (warp >= nrows) return;
  const long long row = r0 + warp;
  int32_t* st = reinterpret_cast<int32_t*>(succ + T * W) +
                warp * (5 * T + W);
  int32_t* key = st + T;
  int32_t* mc = key + T;   // the task's server, -1 on a pad
  int32_t* du = mc + T;
  int32_t* order = du + T;
  uint32_t* sweepable = reinterpret_cast<uint32_t*>(order + T);

  const int32_t* srow = p.start + row * T;
  const int32_t* arow = p.assign + row * T;
  const int32_t* drow = p.dur + gi * T * p.machines;
  const uint8_t* frow =
      p.frozen ? p.frozen + (row / p.rows_per_frozen) * T : nullptr;
  for (int c = 0; c < W; ++c) {
    const int t = c * kWarp + lane;
    bool sw = false;
    if (t < T) {
      const bool real = mask[t] != 0;
      const int32_t a = __ldg(arow + t);
      st[t] = __ldg(srow + t);
      mc[t] = real ? a : -1;
      du[t] = real ? __ldg(drow + (long long)t * p.machines + a) : 0;
      sw = real && !(frow && frow[t]);
    }
    const uint32_t bits = __ballot_sync(kAll, sw);
    if (lane == 0) sweepable[c] = bits;
  }
  const int32_t dl = p.deadline ? p.deadline[row / p.rows_per_deadline]
                                : p.deadline_scalar;
  __syncwarp();

  for (int sweep = 0; sweep < p.sweeps; ++sweep) {
    // The sweep's key, fixed for the sweep: start * T + t (int32).
    __syncwarp();
    for (int t = lane; t < T; t += kWarp)
      key[t] = (int32_t)((uint32_t)st[t] * (uint32_t)T + (uint32_t)t);
    __syncwarp();
    // Rank by (-key on real tasks, BIG on pads) ascending, ties by index:
    // the plain version's stable argsort.
    for (int t = lane; t < T; t += kWarp) {
      const int32_t vt = mc[t] >= 0 ? (int32_t)(0u - (uint32_t)key[t]) : kBig;
      int rank = 0;
      for (int u = 0; u < T; ++u) {
        const int32_t vu =
            mc[u] >= 0 ? (int32_t)(0u - (uint32_t)key[u]) : kBig;
        rank += (vu < vt) || (vu == vt && u < t);
      }
      order[rank] = t;
    }
    __syncwarp();

    for (int j = 0; j < T; ++j) {
      const int t = order[j];
      if (!((sweepable[t / kWarp] >> (t % kWarp)) & 1u)) continue;
      const int32_t kt = key[t], mt = mc[t], dt = du[t], lo = st[t];
      const uint32_t* sw = succ + t * W;
      int32_t cap = kBig;
      for (int u = lane; u < T; u += kWarp) {
        const bool next = ((sw[u / kWarp] >> (u % kWarp)) & 1u) ||
                          (mc[u] == mt && key[u] > kt);
        if (next) cap = min(cap, st[u]);
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)
        cap = min(cap, __shfl_xor_sync(kAll, cap, o));
      const int32_t hi = wrap_sub(min(cap, dl), dt);
      if (hi < lo) continue;
      const int a = max(lo, 0), b = min(hi, H);
      float best = 0.0f;
      int at = -1;
      for (int s = a + lane; s <= b; s += kWarp) {
        const long long e = min((long long)s + dt, (long long)H);
        const float c = cw[e < 0 ? 0 : e] - cw[s];
        if (before(c, s, best, at)) {
          best = c;
          at = s;
        }
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(kAll, best, o);
        const int oa = __shfl_xor_sync(kAll, at, o);
        if (before(ob, oa, best, at)) {
          best = ob;
          at = oa;
        }
      }
      // No position, or +inf everywhere: the plain argmin's 0.
      const int32_t s_star = (at < 0 || best == __int_as_float(0x7f800000))
                                 ? 0 : at;
      __syncwarp();
      if (lane == 0) st[t] = s_star;
      __syncwarp();
    }
  }
  for (int t = lane; t < T; t += kWarp) p.out[row * T + t] = st[t];
}

long long shared_bytes(bool staged, int horizon, int tasks, int words,
                       int rows) {
  const long long cum = staged ? (long long)horizon + 1 + kRowPad : 0;
  return 4 * (cum + (long long)tasks * words +
              (long long)rows * (5LL * tasks + words));
}

}  // namespace

// start, assign, out: [rows, tasks] int32.  dur: [Gi, tasks, machines] int32;
// pred: [Gi, tasks, tasks] bool; task_mask: [Gi, tasks] bool; cum:
// [Gc, horizon + 1] float32; deadline: [Gd] int32 or null (then
// deadline_scalar); frozen: [Gf, tasks] bool or null.  Row r reads group
// r / rows_per_x of each; rows_per_inst and rows_per_cum divide one
// another.  All contiguous, on one device.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int timing_sweep_launch(
    const void* start, const void* assign, void* out, const void* dur,
    const void* pred, const void* task_mask, const void* cum,
    const void* deadline, const void* frozen, long long rows, int tasks,
    int machines, int horizon, long long rows_per_inst,
    long long rows_per_cum, long long rows_per_deadline,
    long long rows_per_frozen, int deadline_scalar, int sweeps,
    void* stream) {
  if (rows == 0 || tasks == 0) return 0;
  Params p;
  p.start = (const int32_t*)start;
  p.assign = (const int32_t*)assign;
  p.out = (int32_t*)out;
  p.dur = (const int32_t*)dur;
  p.pred = (const uint8_t*)pred;
  p.task_mask = (const uint8_t*)task_mask;
  p.cum = (const float*)cum;
  p.deadline = (const int32_t*)deadline;
  p.frozen = (const uint8_t*)frozen;
  p.rows_per_inst = rows_per_inst;
  p.rows_per_cum = rows_per_cum;
  p.rows_per_deadline = rows_per_deadline;
  p.rows_per_frozen = rows_per_frozen;
  p.group = rows_per_inst < rows_per_cum ? rows_per_inst : rows_per_cum;
  p.tasks = tasks;
  p.machines = machines;
  p.horizon = horizon;
  p.words = (tasks + kWarp - 1) / kWarp;
  p.sweeps = sweeps;
  p.deadline_scalar = deadline_scalar;

  int most = (int)(p.group < kMaxRows ? p.group : kMaxRows);
  bool staged = true;
  if (shared_bytes(true, horizon, tasks, p.words, 1) > kMaxShared)
    staged = false;
  while (most > 1 &&
         shared_bytes(staged, horizon, tasks, p.words, most) > kMaxShared)
    --most;
  const long long smem = shared_bytes(staged, horizon, tasks, p.words, most);
  if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
  const long long splits = (p.group + most - 1) / most;
  p.splits = (int)splits;
  p.rows_per_block = (int)((p.group + splits - 1) / splits);
  const long long blocks = rows / p.group * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const int threads = p.rows_per_block * kWarp;
  if (staged) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          timing_sweep_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    timing_sweep_kernel<true><<<(unsigned)blocks, threads, (size_t)smem,
                                s>>>(p);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          timing_sweep_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    timing_sweep_kernel<false><<<(unsigned)blocks, threads, (size_t)smem,
                                 s>>>(p);
  }
  return (int)cudaGetLastError();
}
