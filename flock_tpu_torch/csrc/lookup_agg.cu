// K4 — filter, unique lookup and count by a taken build column in one probe
// pass, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  It was added to fuse the port's chain for an
// Aggregate of counts whose one group key is a column that a unique-build
// lookup join takes from its build side (YSB's views per campaign), which
// ran as the probe filter's ATen compares, K3's gather of the taken column
// and K2's count by it.  Every kernel of that chain ran near its own bytes,
// but the chain wrote and read again the filter mask, the gathered column and
// the hit flags, and K2 read its input twice: ~3.2 GB for a 100 M-row window
// (PERF.md).  The group is a function of the join key, so each probe row's
// group is found through the build's slot table, and nothing of the joined
// rows is written.
//
// Contract (ops/lookup_agg.py).  The build side is slot-dense: slot s holds
// key m + s (m a device scalar), present[s] marks the slots that hold a build
// row, taken[s] is its taken value.  cmin = min(taken[s] | present[s])
// (INT_MAX when none is).  A probe row counts when it is valid, passes every
// term (column op column, or column op int32 literal), 0 <= key - m < span,
// its slot is present and its group taken - cmin is below cap.  The outputs:
// per slot i the int32 count of group cmin + i, the slot keys, valid = count >
// 0, and escape = some slot is present and cmax - cmin >= cap (the caller then
// reruns the unfused plan).  Counts are exact int32 atomics, no floats.
//
// What bounds it on this card.  Bytes: per probe row its key (4 B), valid
// flag (1 B) and each compared column (4 B) are read once, nothing is written
// per row: 900 MB for YSB's 100 M-row window with its one compared column
// (event_type), 0.269 ms at 3.35 TB/s.  The slot table is small (YSB's
// window: 18,432 slots, of which the first 1,000 are present: 4 KB of
// groups) and stays in L1.  Then instruction issue: a row costs a few dozen
// instructions.
//
// Design.
//   * prep (one block of 1,024 threads): cmin, cmax and the last present
//     slot over the slot table (K2's build slotting leaves it in L2), each
//     slot's group up to the last present one (taken - cmin; -1 where the
//     slot is absent or its group falls past cap) into the scratch, the
//     counts zeroed, the escape flag, and the probe pass's ticket reset.
//   * the probe pass, a persistent grid of the card's resident blocks (no
//     grid-wide sync: the last block to finish, by a ticket after a fence,
//     writes the slot keys and out_valid).  Each block
//       - takes, a warp at a time, 32 x kLaneQuads consecutive quads of rows
//         a step: every lane issues the 16-byte evict-first loads of its
//         quads' keys and compared columns and the 4-byte loads of their
//         flags before it uses any, so 72 bytes a thread are in flight for
//         YSB's shape;
//       - evaluates the terms in registers, then reads the group of each
//         passing row's slot through __ldg (L1; slots past the last present
//         one are misses without a read) and adds 1 to the lane's copy of
//         the group: 32 copies of
//         every slot in shared memory, slot g of lane l at g * 32 + l, so a
//         warp's atomics fall on 32 banks and only the block's warps share
//         an address (K2's lane-private variant, dense_agg.cu);
//       - sums each slot's 32 copies with one warp reduction and adds the
//         sum to the output with one global atomic, for the touched slots.
//   * signatures: one compared column (YSB's event_type, or none) is
//     compiled with 4 blocks an SM bound; up to kMaxCols columns take one
//     instantiation that selects among them in registers.
// A copy of the groups in shared memory (4,096 slots, 16 KB a block) was no
// faster than L1 at the benchmark's window: 0.363 against 0.362 ms a call on
// the H100 (PERF.md), so the groups are read from the scratch alone.
// K2's lane-private accumulate and flush are not shared with this kernel
// through warp_agg.cuh: K2 keys its copies by key - m and flushes every
// aggregate beside the count in the same pass over the slots, K4 keys them by
// the looked-up group and flushes the count alone (four lines), so a shared
// helper would change K2's source for no byte of K4's.  The quad loads and
// the slot keys are shared (warp_agg.cuh).

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "warp_agg.cuh"

namespace {

using namespace flock;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
// quads of rows a lane loads before it uses any
constexpr int kLaneQuads = 2;
constexpr int kMaxCols = 4;
constexpr int kMaxTerms = 8;
// the lane-private table's most bytes (32 copies of every slot; the
// wrapper's rule, ops/lookup_agg.py fits)
constexpr int64_t kLaneBytes = 32 * 1024;
constexpr int kPrepThreads = 1024;
constexpr int kMaxDevices = 64;

// comparison codes (ops/lookup_agg.py OPS), and each one's truth table over
// the three outcomes of a comparison: bit 0 where a < b, bit 1 where a == b,
// bit 2 where a > b
enum Op : int32_t { kLt = 0, kLe = 1, kGt = 2, kGe = 3, kEq = 4, kNe = 5 };
constexpr uint8_t kTruth[] = {0b001, 0b011, 0b100, 0b110, 0b010, 0b101};

struct PrepParams {
  const int32_t* taken;
  const uint8_t* present;
  int32_t span;
  int32_t cap;
  int32_t* state;  // [0] cmin, [1] slots up to the last present one, [2] ticket
  int32_t* gid;    // [span] each slot's group, -1 for none
  int32_t* cnt;
  uint8_t* escape;
};

struct Params {
  const int32_t* keys;
  const uint8_t* valid;
  int64_t n;
  bool vec;  // keys and columns 16-byte aligned, valid 4-byte aligned
  const int32_t* m;
  const int32_t* state;
  int32_t* ticket;
  const int32_t* gid;
  int32_t cap;
  int32_t ncols;
  int32_t nterms;
  const int32_t* col[kMaxCols];
  int32_t lhs[kMaxTerms];
  int32_t truth[kMaxTerms];  // kTruth of the term's comparison
  int32_t rhs[kMaxTerms];    // a column's index, or the literal
  bool lit[kMaxTerms];
  int32_t* cnt;
  int32_t* key_out;
  uint8_t* valid_out;
};

__global__ void __launch_bounds__(kPrepThreads)
lookup_agg_prep(const __grid_constant__ PrepParams p) {
  __shared__ int32_t red[3][kPrepThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t lo = INT_MAX, hi = INT_MIN, last = -1;
  for (int s0 = tid; s0 < p.span; s0 += 4 * kPrepThreads) {
    int32_t v[4];
    bool h[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = s0 + u * kPrepThreads;
      h[u] = s < p.span && p.present[s];
      v[u] = s < p.span ? p.taken[s] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (h[u]) {
        lo = min(lo, v[u]);
        hi = max(hi, v[u]);
        last = max(last, s0 + u * kPrepThreads);
      }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  last = __reduce_max_sync(kFull, last);
  if (lane == 0) {
    red[0][warp] = lo;
    red[1][warp] = hi;
    red[2][warp] = last;
  }
  __syncthreads();
  if (warp == 0) {
    lo = __reduce_min_sync(kFull, red[0][lane]);
    hi = __reduce_max_sync(kFull, red[1][lane]);
    last = __reduce_max_sync(kFull, red[2][lane]);
    if (lane == 0) {
      red[0][0] = lo;
      red[1][0] = hi;
      red[2][0] = last;
    }
  }
  __syncthreads();
  const int32_t cmin = red[0][0], cmax = red[1][0], end = red[2][0] + 1;
  for (int s = tid; s < end; s += kPrepThreads) {
    int32_t g = -1;
    if (p.present[s]) {
      const int64_t d = static_cast<int64_t>(p.taken[s]) - cmin;
      if (d < p.cap) g = static_cast<int32_t>(d);
    }
    p.gid[s] = g;
  }
  for (int i = tid; i < p.cap; i += kPrepThreads) p.cnt[i] = 0;
  if (tid == 0) {
    p.state[0] = cmin;
    p.state[1] = end;
    p.state[2] = 0;
    *p.escape = end > 0 && static_cast<int64_t>(cmax) - cmin >= p.cap;
  }
}

// a op b, from the comparison's truth table: no branch on the operator
__device__ __forceinline__ bool compare(int32_t truth, int32_t a, int32_t b) {
  const int outcome = a < b ? 0 : a == b ? 1 : 2;
  return (truth >> outcome) & 1;
}

// Row e's value of compared column c, selected in registers (an index into
// the array would put it in local memory).
template <int kCols>
__device__ __forceinline__ int32_t column_value(const int32_t (&v)[kCols][4],
                                                int c, int e) {
  int32_t r = v[0][e];
#pragma unroll
  for (int j = 1; j < kCols; ++j)
    if (c == j) r = v[j][e];
  return r;
}

template <int kCols>
__device__ __forceinline__ void count_body(const Params& p) {
  extern __shared__ __align__(16) int32_t lookup_smem[];
  __shared__ bool last_block;
  int32_t* lanes = lookup_smem;  // [cap * 32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m = __ldg(p.m);
  const int32_t cmin = p.state[0], end = p.state[1];
  for (int i = threadIdx.x; i < p.cap * 32; i += kThreads) lanes[i] = 0;
  __syncthreads();

  const int64_t nq = (p.n + 3) / 4;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * 32 * kLaneQuads;
  for (int64_t q0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32 * kLaneQuads;
       q0 < nq; q0 += step) {
    int32_t k[kLaneQuads][4];
    bool v[kLaneQuads][4];
    int32_t c[kLaneQuads][kCols][4];
#pragma unroll
    for (int u = 0; u < kLaneQuads; ++u) {
      const int64_t row = 4 * (q0 + 32 * u + lane);
      load_quad<true>(p.keys, row, p.n, p.vec, k[u]);
      load_quad<true>(p.valid, row, p.n, p.vec, v[u]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < p.ncols) load_quad<true>(p.col[j], row, p.n, p.vec, c[u][j]);
    }
#pragma unroll
    for (int u = 0; u < kLaneQuads; ++u) {
      bool pass[4] = {v[u][0], v[u][1], v[u][2], v[u][3]};
#pragma unroll
      for (int t = 0; t < kMaxTerms; ++t) {
        if (t >= p.nterms) break;
        const int32_t truth = p.truth[t], lhs = p.lhs[t], rhs = p.rhs[t];
        const bool lit = p.lit[t];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int32_t a = column_value<kCols>(c[u], lhs, e);
          const int32_t b = lit ? rhs : column_value<kCols>(c[u], rhs, e);
          pass[e] = pass[e] && compare(truth, a, b);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!pass[e]) continue;
        const int64_t s = static_cast<int64_t>(k[u][e]) - m;
        if (s < 0 || s >= end) continue;
        const int32_t g = __ldg(p.gid + s);
        if (g >= 0) atomicAdd(lanes + g * 32 + lane, 1);
      }
    }
  }
  __syncthreads();
  for (int s = warp; s < p.cap; s += kWarps) {
    const int t = __reduce_add_sync(kFull, lanes[s * 32 + lane]);
    if (lane == 0 && t != 0) atomicAdd(p.cnt + s, t);
  }

  // the last block to finish writes the slot keys and out_valid
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(p.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = threadIdx.x; i < p.cap; i += kThreads) {
    p.key_out[i] = slot_key(cmin, i);
    p.valid_out[i] = __ldcg(p.cnt + i) > 0;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lookup_agg_count(const __grid_constant__ Params p) {
  count_body<1>(p);
}

__global__ void __launch_bounds__(kThreads)
lookup_agg_count_wide(const __grid_constant__ Params p) {
  count_body<kMaxCols>(p);
}

// SMs of `device`, asked once (0: not yet)
int sms_of(int device) {
  static std::atomic<int> sms[kMaxDevices];
  int got = sms[device].load(std::memory_order_relaxed);
  if (got > 0) return got;
  const cudaError_t e =
      cudaDeviceGetAttribute(&got, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  sms[device].store(got, std::memory_order_relaxed);
  return got;
}

}  // namespace

// Launches K4 on the given stream: the prep block, then the probe pass.  `a`
// is the packed argument array, one int64 each (ops/lookup_agg.py builds it):
//   [0] keys  [1] valid  [2] n  [3] taken  [4] present  [5] m  [6] span
//   [7] cap  [8] cnt  [9] key_out  [10] valid_out  [11] escape
//   [12] scratch (int32: 4 words of state, then span groups)  [13] stream
//   [14] device  [15] ncols  [16] nterms,
// then ncols column pointers, then per term (lhs column, op, rhs column or
// literal, 1 where rhs is a literal).  Returns the launches' cudaError_t.
extern "C" int flock_lookup_agg(const int64_t* a) {
  const int64_t n = a[2], span = a[6], cap = a[7], device = a[14];
  const int64_t ncols = a[15], nterms = a[16];
  if (n < 0 || span <= 0 || span >= INT_MAX || cap <= 0 ||
      cap * 32 * 4 > kLaneBytes || device < 0 || device >= kMaxDevices ||
      ncols < 0 || ncols > kMaxCols || nterms < 0 || nterms > kMaxTerms)
    return cudaErrorInvalidValue;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[13]);
  int32_t* scratch = reinterpret_cast<int32_t*>(a[12]);

  Params p{};
  p.keys = reinterpret_cast<const int32_t*>(a[0]);
  p.valid = reinterpret_cast<const uint8_t*>(a[1]);
  p.n = n;
  p.m = reinterpret_cast<const int32_t*>(a[5]);
  p.state = scratch;
  p.ticket = scratch + 2;
  p.gid = scratch + 4;
  p.cap = static_cast<int32_t>(cap);
  p.ncols = static_cast<int32_t>(ncols);
  p.nterms = static_cast<int32_t>(nterms);
  p.cnt = reinterpret_cast<int32_t*>(a[8]);
  p.key_out = reinterpret_cast<int32_t*>(a[9]);
  p.valid_out = reinterpret_cast<uint8_t*>(a[10]);
  p.vec = aligned(p.keys, 16) && aligned(p.valid, 4);
  const int64_t* rest = a + 17;
  for (int c = 0; c < ncols; ++c) {
    p.col[c] = reinterpret_cast<const int32_t*>(rest[c]);
    p.vec = p.vec && aligned(p.col[c], 16);
  }
  rest += ncols;
  for (int t = 0; t < nterms; ++t, rest += 4) {
    const bool lit = rest[3] != 0;
    if (rest[0] < 0 || rest[0] >= ncols || rest[1] < kLt || rest[1] > kNe ||
        (!lit && (rest[2] < 0 || rest[2] >= ncols)) ||
        (lit && (rest[2] < INT_MIN || rest[2] > INT_MAX)))
      return cudaErrorInvalidValue;
    p.lhs[t] = static_cast<int32_t>(rest[0]);
    p.truth[t] = kTruth[rest[1]];
    p.rhs[t] = static_cast<int32_t>(rest[2]);
    p.lit[t] = lit;
  }

  const int sms = sms_of(static_cast<int>(device));
  if (sms <= 0) return sms < 0 ? -sms : cudaErrorInvalidConfiguration;

  PrepParams pp{};
  pp.taken = reinterpret_cast<const int32_t*>(a[3]);
  pp.present = reinterpret_cast<const uint8_t*>(a[4]);
  pp.span = static_cast<int32_t>(span);
  pp.cap = p.cap;
  pp.state = scratch;
  pp.gid = scratch + 4;
  pp.cnt = p.cnt;
  pp.escape = reinterpret_cast<uint8_t*>(a[11]);
  lookup_agg_prep<<<1, kPrepThreads, 0, stream>>>(pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // a block per step's worth of quads, no more than are resident at once;
  // the lane-private counts take at most kLaneBytes of shared memory
  const size_t smem = static_cast<size_t>(4 * cap * 32);
  const int64_t per_block = static_cast<int64_t>(kWarps) * 32 * kLaneQuads;
  int64_t blocks = ((n + 3) / 4 + per_block - 1) / per_block;
  if (blocks > static_cast<int64_t>(sms) * kBlocksPerSm) blocks = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  if (ncols <= 1)
    lookup_agg_count<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  else
    lookup_agg_count_wide<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
