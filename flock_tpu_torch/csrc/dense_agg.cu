// K2 — dense-key grouped aggregation, hand-written for Hopper (sm_90a).
//
// Replaces: flock_tpu/pallas/factored.py pallas_factored_agg (kernel
// _agg_kernel :405-457, pallas_call :487).  Its contract is also that of
// flock_tpu/pallas/agg.py pallas_local_agg and pallas_count_max_agg and of
// the XLA formulations ops/blocked.py blocked_local_agg / full_onehot_agg.
//
// Contract.  Slot i holds key m + i, m = min(valid keys) (INT_MAX when no
// row is valid).  Per slot: the row count (int32), and per aggregate
// count_sum (int32), sum (int64, exact, two's complement through 64-bit
// atomics — no row-count bound), min / max (int32, empty slots keep INT_MAX
// / INT_MIN).  A valid key at or beyond m + cap sets the overflow flag and is
// dropped.  The kernel also writes the slot keys, out_valid = count > 0 and a
// flag "some slot counted more than one row" (duplicate build keys).  Count
// aggregates are the row count itself, so the wrapper aliases them and the
// kernel never sees them.
//
// What bounds it on this card.  Bytes: every row reads its key (4 B), its
// valid flag (1 B) and each aggregated column (4 B) once in each of the two
// passes below, every slot is written once — 8 MB for q4's build slotting
// (2.4 us at 3.35 TB/s), 2.2 MB for its per-category pass, 1.0 GB for YSB's
// count of a 100 M-row window (0.30 ms).  The first version was held back
// by two other things: its wrapper issued ~13 device operations around its
// one launch (m, the output fills, the slot keys, count > 0, the flag), each
// a launch the card waits for; and contended atomics (the per-category pass
// folds ~250 k rows onto 5 live keys).  Then the block-shared variant paid a
// warp match, a vote and an atomic that the block's warps contend for on
// every row: 0.84 ms for YSB's count over 100 live slots (PERF.md).
//
// Design.  One cooperative launch (cooperative_groups grid sync; the grid is
// sized to be resident) does everything the wrapper did:
//   (a) each block reduces min(valid keys) over its share of the rows into a
//       per-block partial (no scalar that would need initialising before an
//       atomic), and initialises the outputs and its shared accumulators;
//   grid sync — every block reduces the partials to m itself and writes the
//       slot keys;
//   (b) accumulation, rows in quads through 16-byte loads, in one of three
//       variants that the wrapper picks from the capacity and the
//       aggregates' widths (ops/dense_agg.py accumulator_variant):
//       lanes  — every slot has 32 copies in block-private shared memory,
//                slot s of lane l at s * 32 + l, when they fit the wrapper's
//                budget (32 KB: YSB's 128-slot count, 16 KB; q5's and q7's
//                max over one key, 2 KB).  A warp's 32 atomics fall on 32
//                banks, whatever its keys, so only the block's warps share an
//                address and no row pays a warp vote or match; a warp takes
//                two quads a lane per step, to keep more bytes in flight.
//                The block then sums each slot's copies with one warp
//                reduction and flushes it with one global atomic;
//       shared — one copy of every slot in block-private shared memory when
//                the table fits 48 KB (q4's per-category sum and count: the
//                lane-private table's initialisation and flush cost more
//                than its ~250 k rows save), flushed once per touched slot;
//                the lanes of a warp on one slot add their count with one
//                atomic and, when the warp holds at most kFewSlots slots (hot
//                keys), combine every value first (warp_agg.cuh);
//       global — the same atomics straight into device memory (build
//                slotting: ascending unique keys, almost no contention);
//   grid sync — (c) the epilogue writes out_valid and the duplicate flag.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "warp_agg.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace flock;

constexpr int kMaxAggs = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
// a warp whose live lanes hold at most this many slots combines each slot's
// lanes before its atomics (the shared and global variants); measured on the
// H100 against 4, 16 and 32 (PERF.md)
constexpr int kFewSlots = 8;
// quads of rows a lane of the lane-private variant loads before it adds them
constexpr int kLaneQuads = 2;

// the accumulation variants of pass (b); the wrapper's codes
enum Variant : int32_t { kGlobal = 0, kShared = 1, kLanes = 2 };

struct Params {
  const int32_t* keys;
  const uint8_t* valid;
  int64_t n;
  int32_t cap;
  int32_t naggs;
  bool vec;  // keys and columns 16-byte aligned, valid 4-byte aligned
  int32_t fn[kMaxAggs];
  const int32_t* col[kMaxAggs];
  void* out[kMaxAggs];
  int32_t smem_off[kMaxAggs];  // byte offset of each block-private accumulator
  int32_t smem_cnt_off;
  int32_t* cnt;
  int32_t* key_out;
  uint8_t* valid_out;
  uint8_t* overflow;
  uint8_t* dups;
  int32_t* partial;  // [gridDim.x] per-block minima
};

// The lane-private copies i = s * 32 + lane of one accumulator, combined over
// the warp, into output slot s with one global atomic from lane 0; every lane
// of the warp calls it.  The copies' int32 sums wrap as the shared variant's
// int32 atomics do.
__device__ __forceinline__ void flush_lanes(int32_t fn, void* from, int i,
                                            void* to, int64_t s, int lane) {
  if (fn == kSum) {
    long long t = static_cast<long long*>(from)[i];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) t += __shfl_xor_sync(kFull, t, d);
    if (lane == 0) atomicAdd(static_cast<ull*>(to) + s, static_cast<ull>(t));
    return;
  }
  const int x = static_cast<int*>(from)[i];
  int* o = static_cast<int*>(to) + s;
  switch (fn) {
    case kCountSum: {
      const int t = __reduce_add_sync(kFull, x);
      if (lane == 0) atomicAdd(o, t);
      break;
    }
    case kMin: {
      const int t = __reduce_min_sync(kFull, x);
      if (lane == 0) atomicMin(o, t);
      break;
    }
    case kMax: {
      const int t = __reduce_max_sync(kFull, x);
      if (lane == 0) atomicMax(o, t);
      break;
    }
  }
}

// (b), lane-private: lane l adds each of its rows into copy l of the row's
// slot.  A warp takes 32 * kLaneQuads consecutive quads per step, and each
// lane loads its kLaneQuads quads' keys and flags before it adds any; the
// aggregated columns follow one at a time, so that few registers are live
// and four blocks stay resident on an SM.  Then each warp flushes slots.
__device__ __forceinline__ void accumulate_lanes(const Params& p,
                                                 unsigned char* smem, int* cnt,
                                                 int32_t m, int lane, int warp,
                                                 int64_t tid, int64_t nthreads,
                                                 int64_t nq) {
  for (int64_t q0 = (tid >> 5) * 32 * kLaneQuads; q0 < nq;
       q0 += nthreads * kLaneQuads) {
    int32_t k[kLaneQuads][4];
    bool v[kLaneQuads][4];
#pragma unroll
    for (int u = 0; u < kLaneQuads; ++u) {
      const int64_t row = 4 * (q0 + 32 * u + lane);
      load_quad(p.keys, row, p.n, p.vec, k[u]);
      load_quad(p.valid, row, p.n, p.vec, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kLaneQuads; ++u) {
      int copy[4];  // of each row's slot, -1 where the row adds nothing
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        copy[e] = -1;
        if (!v[u][e]) continue;
        const int64_t s = static_cast<int64_t>(k[u][e]) - m;
        if (s >= p.cap) {
          *p.overflow = 1;
          continue;
        }
        copy[e] = static_cast<int>(s) * 32 + lane;
        atomicAdd(cnt + copy[e], 1);
      }
      for (int a = 0; a < p.naggs; ++a) {
        int32_t val[4];
        load_quad(p.col[a], 4 * (q0 + 32 * u + lane), p.n, p.vec, val);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (copy[e] >= 0)
            apply<true>(p.fn[a], smem + p.smem_off[a], copy[e], val[e]);
      }
    }
  }
  __syncthreads();
  for (int s = warp; s < p.cap; s += kWarps) {
    const int i = s * 32 + lane;
    const int c = __reduce_add_sync(kFull, cnt[i]);
    if (c == 0) continue;  // the whole warp skips an untouched slot
    if (lane == 0) atomicAdd(p.cnt + s, c);
    for (int a = 0; a < p.naggs; ++a)
      flush_lanes(p.fn[a], smem + p.smem_off[a], i, p.out[a], s, lane);
  }
}

// (b), block-shared (kSmem) or global: the lanes of a warp on one slot
// found by a match, each row's atomics on one copy of its slot.
template <bool kSmem>
__device__ __forceinline__ void accumulate_matched(const Params& p,
                                                   unsigned char* smem,
                                                   int* cnt, int32_t m,
                                                   int lane, int64_t tid,
                                                   int64_t nthreads,
                                                   int64_t nq) {
  // a warp takes 32 consecutive quads (128 rows) per step
  for (int64_t q0 = (tid >> 5) * 32; q0 < nq; q0 += nthreads) {
    const int64_t row = 4 * (q0 + lane);
    int32_t k[4], val[kMaxAggs][4];
    bool v[4];
    load_quad(p.keys, row, p.n, p.vec, k);
    load_quad(p.valid, row, p.n, p.vec, v);
#pragma unroll
    for (int a = 0; a < kMaxAggs; ++a)
      if (a < p.naggs) load_quad(p.col[a], row, p.n, p.vec, val[a]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int32_t slot = -1;
      if (v[e]) {
        const int64_t s = static_cast<int64_t>(k[e]) - m;
        if (s < p.cap) slot = static_cast<int32_t>(s);
        else *p.overflow = 1;
      }
      // the lanes on one slot: the leader adds their count; when the warp
      // holds few slots, each group combines its values and its leader
      // makes the atomic, else every lane makes its own (warp_agg.cuh)
      const unsigned peers = __match_any_sync(kFull, slot);
      const bool leader = slot >= 0 && lane == __ffs(peers) - 1;
      const bool few = __popc(__ballot_sync(kFull, leader)) <= kFewSlots;
      if (leader) atomicAdd(cnt + slot, __popc(peers));
      if (slot < 0) continue;
#pragma unroll
      for (int a = 0; a < kMaxAggs; ++a) {
        if (a >= p.naggs) break;
        void* acc = kSmem ? smem + p.smem_off[a] : p.out[a];
        if (few) {
          const long long t = group_combine(p.fn[a], peers, val[a][e]);
          if (leader) apply<kSmem>(p.fn[a], acc, slot, t);
        } else {
          apply<kSmem>(p.fn[a], acc, slot, val[a][e]);
        }
      }
    }
  }
  if (kSmem) {
    __syncthreads();
    for (int s = threadIdx.x; s < p.cap; s += kThreads) {
      const int c = cnt[s];
      if (c == 0) continue;
      atomicAdd(p.cnt + s, c);
      for (int a = 0; a < p.naggs; ++a) flush_slot(p.fn[a], smem + p.smem_off[a], s, p.out[a], s);
    }
  }
}

template <int kVariant>
__device__ __forceinline__ void dense_agg_body(const Params& p) {
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ int32_t red[kWarps];
  constexpr bool kSmem = kVariant != kGlobal;
  constexpr int kCopies = kVariant == kLanes ? 32 : 1;  // of each slot in smem
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tid = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t nq = (p.n + 3) / 4;

  // (a) this block's minimum, and every output at its identity; a thread
  // loads kStep quads, nthreads apart, per step
  constexpr int kStep = kVariant == kLanes ? kLaneQuads : 1;
  int32_t lo = INT_MAX;
  for (int64_t q = tid; q < nq; q += nthreads * kStep) {
    int32_t k[kStep][4];
    bool v[kStep][4];
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      load_quad(p.keys, 4 * (q + u * nthreads), p.n, p.vec, k[u]);
      load_quad(p.valid, 4 * (q + u * nthreads), p.n, p.vec, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kStep; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (v[u][e]) lo = min(lo, k[u][e]);
  }
  lo = __reduce_min_sync(kFull, lo);
  if (lane == 0) red[warp] = lo;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) lo = min(lo, red[w]);
    p.partial[blockIdx.x] = lo;
  }
  for (int64_t i = tid; i < p.cap; i += nthreads) {
    p.cnt[i] = 0;
    for (int a = 0; a < p.naggs; ++a) init_slot(p.fn[a], p.out[a], i);
  }
  if (tid == 0) *p.overflow = *p.dups = 0;
  int* cnt = p.cnt;
  if (kSmem) {
    cnt = reinterpret_cast<int*>(smem + p.smem_cnt_off);
    for (int s = threadIdx.x; s < p.cap * kCopies; s += kThreads) {
      cnt[s] = 0;
      for (int a = 0; a < p.naggs; ++a) init_slot(p.fn[a], smem + p.smem_off[a], s);
    }
  }
  cg::this_grid().sync();

  // m from the partials, in every block
  if (warp == 0) {
    int32_t m = INT_MAX;
    for (int b = lane; b < gridDim.x; b += 32) m = min(m, __ldcg(p.partial + b));
    m = __reduce_min_sync(kFull, m);
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const int32_t m = red[0];
  for (int64_t i = tid; i < p.cap; i += nthreads) p.key_out[i] = slot_key(m, i);

  // (b), then the block's flush of its shared-memory table
  if (kVariant == kLanes)
    accumulate_lanes(p, smem, cnt, m, lane, warp, tid, nthreads, nq);
  else
    accumulate_matched<kSmem>(p, smem, cnt, m, lane, tid, nthreads, nq);
  cg::this_grid().sync();

  // (c) epilogue
  for (int64_t i = tid; i < p.cap; i += nthreads) {
    const int c = __ldcg(p.cnt + i);
    p.valid_out[i] = c > 0;
    if (c > 1) *p.dups = 1;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
dense_agg_lanes(const __grid_constant__ Params p) {
  dense_agg_body<kLanes>(p);
}

__global__ void __launch_bounds__(kThreads)
dense_agg_shared(const __grid_constant__ Params p) {
  dense_agg_body<kShared>(p);
}

__global__ void __launch_bounds__(kThreads)
dense_agg_global(const __grid_constant__ Params p) {
  dense_agg_body<kGlobal>(p);
}

}  // namespace

// Launches K2 on `stream`: one cooperative launch that initialises and
// writes every output.  `aggs` packs `naggs` triples (aggregate code, column
// pointer, output pointer); `cnt`, `key_out` are int32[cap], `valid_out`
// bool[cap], `flags` bool[2] (overflow, duplicates); `scratch` holds
// `scratch_len` int32 for the per-block minima and bounds the grid;
// `variant` is the accumulation variant (enum Variant), which the wrapper
// picks: the launch fails where its shared memory cannot be had.
extern "C" int flock_dense_agg(const int32_t* keys, const uint8_t* valid,
                               int64_t n, int32_t cap, int32_t naggs,
                               const int64_t* aggs, int32_t* cnt,
                               int32_t* key_out, uint8_t* valid_out,
                               uint8_t* flags, int32_t* scratch,
                               int32_t scratch_len, int32_t variant,
                               void* stream) {
  if (naggs < 0 || naggs > kMaxAggs || cap <= 0 || n < 0 || scratch_len <= 0 ||
      variant < kGlobal || variant > kLanes)
    return cudaErrorInvalidValue;
  Params p{};
  p.keys = keys;
  p.valid = valid;
  p.n = n;
  p.cap = cap;
  p.naggs = naggs;
  p.cnt = cnt;
  p.key_out = key_out;
  p.valid_out = valid_out;
  p.overflow = flags;
  p.dups = flags + 1;
  p.partial = scratch;
  p.vec = aligned(keys, 16) && aligned(valid, 4);
  // shared layout: int64 accumulators first (8-byte aligned), then the row
  // counts, then the int32 accumulators; each slot once, or 32 times
  const int64_t copies = variant == kLanes ? 32 : 1;
  int64_t off[kMaxAggs] = {};
  int64_t bytes = 0;
  for (int a = 0; a < naggs; ++a) {
    const int32_t fn = static_cast<int32_t>(aggs[3 * a]);
    if (fn < kCountSum || fn > kMax) return cudaErrorInvalidValue;
    p.fn[a] = fn;
    p.col[a] = reinterpret_cast<const int32_t*>(aggs[3 * a + 1]);
    p.out[a] = reinterpret_cast<void*>(aggs[3 * a + 2]);
    p.vec = p.vec && aligned(p.col[a], 16);
    if (fn == kSum) { off[a] = bytes; bytes += 8LL * cap * copies; }
  }
  const int64_t cnt_off = bytes;
  bytes += 4LL * cap * copies;
  for (int a = 0; a < naggs; ++a)
    if (p.fn[a] != kSum) { off[a] = bytes; bytes += 4LL * cap * copies; }

  const void* kernels[] = {reinterpret_cast<const void*>(dense_agg_global),
                           reinterpret_cast<const void*>(dense_agg_shared),
                           reinterpret_cast<const void*>(dense_agg_lanes)};
  const void* kernel = kernels[variant];
  const bool in_smem = variant != kGlobal;
  if (in_smem && bytes > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = in_smem ? static_cast<size_t>(bytes) : 0;
  static const cudaError_t opted[] = {cudaSuccess,
                                      allow_all_shared(kernels[kShared]),
                                      allow_all_shared(kernels[kLanes])};
  if (opted[variant] != cudaSuccess) return static_cast<int>(opted[variant]);
  if (in_smem) {
    for (int a = 0; a < naggs; ++a) p.smem_off[a] = static_cast<int32_t>(off[a]);
    p.smem_cnt_off = static_cast<int32_t>(cnt_off);
  }
  // enough blocks for one quad of rows or one slot per thread, no more than
  // are resident at once, and no more than the scratch holds
  const int64_t work = (n + 3) / 4 > cap ? (n + 3) / 4 : cap;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int resident = resident_blocks(kernel, kThreads, smem, kBlocksPerSm);
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  if (blocks > resident) blocks = resident;
  if (blocks > scratch_len) blocks = scratch_len;
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* flock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
