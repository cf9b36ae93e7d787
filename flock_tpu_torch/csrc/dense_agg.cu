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
// valid flag (1 B) and each aggregated column (4 B), every slot is written
// once — 8 MB for q4's build slotting (2.4 us at 3.35 TB/s), 2.2 MB for its
// per-category pass.  The first version was held back by two other things:
// its wrapper issued ~13 device operations around its one launch (m, the
// output fills, the slot keys, count > 0, the flag), each a launch the card
// waits for; and the per-category pass folds ~250 k rows onto 5 live keys,
// one shared-memory atomic per row and aggregate on 5 addresses.
//
// Design.  One cooperative launch (cooperative_groups grid sync; the grid is
// sized to be resident) does everything the wrapper did:
//   (a) each block reduces min(valid keys) over its share of the rows into a
//       per-block partial (no scalar that would need initialising before an
//       atomic), and initialises the outputs and its shared accumulators;
//   grid sync — every block reduces the partials to m itself and writes the
//   slot keys;
//   (b) accumulation: rows in quads through 16-byte loads; the lanes of a
//       warp on one slot add their count with one atomic, and when the warp
//       holds at most kFewSlots slots (hot keys) they combine every value
//       first (warp_agg.cuh); atomics go into block-private shared memory
//       when every slot fits 48 KB (q4's
//       128-slot per-category pass: 1.5 KB; flushed once per touched slot),
//       else straight into device memory (build slotting: ascending unique
//       keys, almost no contention);
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
constexpr int64_t kSharedLimit = 48 * 1024;
// a warp whose live lanes hold at most this many slots combines each slot's
// lanes before its atomics (q4's per-category pass: 5); measured on the H100
// against 4, 16 and 32 (PERF.md, PR 3)
constexpr int kFewSlots = 8;

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

template <bool kShared>
__device__ __forceinline__ void dense_agg_body(const Params& p) {
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ int32_t red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tid = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t nq = (p.n + 3) / 4;

  // (a) this block's minimum, and every output at its identity
  int32_t lo = INT_MAX;
  for (int64_t q = tid; q < nq; q += nthreads) {
    int32_t k[4];
    bool v[4];
    load_quad(p.keys, 4 * q, p.n, p.vec, k);
    load_quad(p.valid, 4 * q, p.n, p.vec, v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (v[e]) lo = min(lo, k[e]);
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
  if (kShared) {
    cnt = reinterpret_cast<int*>(smem + p.smem_cnt_off);
    for (int s = threadIdx.x; s < p.cap; s += kThreads) {
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

  // (b) a warp takes 32 consecutive quads (128 rows) per step
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
        void* acc = kShared ? smem + p.smem_off[a] : p.out[a];
        if (few) {
          const long long t = group_combine(p.fn[a], peers, val[a][e]);
          if (leader) apply<kShared>(p.fn[a], acc, slot, t);
        } else {
          apply<kShared>(p.fn[a], acc, slot, val[a][e]);
        }
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int s = threadIdx.x; s < p.cap; s += kThreads) {
      const int c = cnt[s];
      if (c == 0) continue;
      atomicAdd(p.cnt + s, c);
      for (int a = 0; a < p.naggs; ++a) flush_slot(p.fn[a], smem + p.smem_off[a], s, p.out[a], s);
    }
  }
  cg::this_grid().sync();

  // (c) epilogue
  for (int64_t i = tid; i < p.cap; i += nthreads) {
    const int c = __ldcg(p.cnt + i);
    p.valid_out[i] = c > 0;
    if (c > 1) *p.dups = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
dense_agg_shared(const __grid_constant__ Params p) {
  dense_agg_body<true>(p);
}

__global__ void __launch_bounds__(kThreads)
dense_agg_global(const __grid_constant__ Params p) {
  dense_agg_body<false>(p);
}

}  // namespace

// Launches K2 on `stream`: one cooperative launch that initialises and
// writes every output.  `aggs` packs `naggs` triples (aggregate code, column
// pointer, output pointer); `cnt`, `key_out` are int32[cap], `valid_out`
// bool[cap], `flags` bool[2] (overflow, duplicates); `scratch` holds
// `scratch_len` int32 for the per-block minima and bounds the grid.
extern "C" int flock_dense_agg(const int32_t* keys, const uint8_t* valid,
                               int64_t n, int32_t cap, int32_t naggs,
                               const int64_t* aggs, int32_t* cnt,
                               int32_t* key_out, uint8_t* valid_out,
                               uint8_t* flags, int32_t* scratch,
                               int32_t scratch_len, void* stream) {
  if (naggs < 0 || naggs > kMaxAggs || cap <= 0 || n < 0 || scratch_len <= 0)
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
  // counts, then the int32 accumulators
  int64_t off[kMaxAggs] = {};
  int64_t bytes = 0;
  for (int a = 0; a < naggs; ++a) {
    const int32_t fn = static_cast<int32_t>(aggs[3 * a]);
    if (fn < kCountSum || fn > kMax) return cudaErrorInvalidValue;
    p.fn[a] = fn;
    p.col[a] = reinterpret_cast<const int32_t*>(aggs[3 * a + 1]);
    p.out[a] = reinterpret_cast<void*>(aggs[3 * a + 2]);
    p.vec = p.vec && aligned(p.col[a], 16);
    if (fn == kSum) { off[a] = bytes; bytes += 8LL * cap; }
  }
  const int64_t cnt_off = bytes;
  bytes += 4LL * cap;
  for (int a = 0; a < naggs; ++a)
    if (p.fn[a] != kSum) { off[a] = bytes; bytes += 4LL * cap; }

  const bool shared = bytes <= kSharedLimit;
  const void* kernel = shared ? reinterpret_cast<const void*>(dense_agg_shared)
                              : reinterpret_cast<const void*>(dense_agg_global);
  const size_t smem = shared ? static_cast<size_t>(bytes) : 0;
  static const cudaError_t opted = allow_all_shared(
      reinterpret_cast<const void*>(dense_agg_shared));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  if (shared) {
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
