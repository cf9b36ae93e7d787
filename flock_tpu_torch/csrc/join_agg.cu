// K1 — fused lookup join + filter + grouped aggregation, hand-written for
// Hopper (sm_90a).
//
// Replaces: flock_tpu/pallas/join_agg.py fused_join_aggregate (kernel body
// _kernel :55-170, pallas_call :348; int64 rebasing in
// fused_join_aggregate_rebased :250-294, done by the Python wrapper here).
// Its contract is also that of the XLA formulation
// ops/blocked.py blocked_join_aggregate, which q4's fused pass ran on the TPU,
// and of pallas/factored.py pallas_factored_join_agg / pallas_bcast_join_agg.
//
// Contract.  The build side arrives slot-dense: slot i holds key m + i
// (m a device scalar), `present[i]` says whether a build row landed there,
// and the taken build columns are int32[span].  A probe row whose key hits a
// present slot forms a pair; the pair must pass a conjunction of column
// comparisons (q4: b_date_time >= a_date_time AND b_date_time <= expires);
// passing pairs accumulate into the slot: the pair count (int32), and per
// aggregate count_sum (int32), sum (int64 through 64-bit atomics), min / max
// (int32, empty slots keep INT_MAX / INT_MIN).  Aggregated and compared
// columns come from either side.  One more aggregate, kMax64, takes an int64
// probe column that is never compared (q6's __order = price << 32 |
// (2^32 - 1 - b_date_time)): its max per slot, exact for every int64 value
// through signed 64-bit atomics, into an int64 output whose empty slots keep
// INT64_MIN.  Joined rows are never built.  The kernel initialises every
// output itself and writes the slot keys and out_valid = count > 0.
//
// What bounds it on this card.  Bytes: each probe row is read once (q4: key,
// valid flag, price, b_date_time = 13 B), the slot columns once (13 B a
// slot), the outputs written once — ~54 MB for a 3.68 M-bid q4 window,
// 0.0162 ms at 3.35 TB/s.  The gathers hit a ~3 MB slot table that stays in
// the 50 MB L2.  The first version (one thread per probe row, global atomics)
// took 6.9x that: bids cluster on hot auctions (half the bids go to one id
// per 100), so neighbouring lanes added to the same count word in L2.
//
// Design.  One cooperative launch: (a) every output at its identity and the
// slot keys; grid sync; (b) blocks walk tiles of kTile = 1024 consecutive
// probe rows in a persistent loop; grid sync; (c) out_valid.  Per tile:
//   * loads — each thread takes one quad of rows: 16-byte evict-first
//     vector loads of the key and of up to kMaxProbe probe columns into
//     registers, the valid flags as 4 bytes, all issued before any is used.  Vector loads rather
//     than a TMA / cp.async ring: every probe byte is used once, by the
//     thread that loads it, so a shared-memory stage would add a copy and a
//     barrier and buy no reuse.  Tiles of 2048 rows (two quads a thread)
//     measured 1.2x slower on the H100 (PERF.md, PR 3);
//   * the window — a block reduction finds the tile's live slot range
//     [lo, hi]; the window is the kWindow = 2048 slots ending at hi (the
//     auction frontier, with the lookback behind it), cut to start no lower
//     than lo.  The reference bounds the auction ids of a block of bids by
//     S_LOC_AUCTION_OVER_BID = 512 (flock_tpu/ops/kernels.py:162-165), so
//     almost every pair lands in it;
//   * pairs — `present` and the predicate's slot columns are gathered term
//     by term, every row's gathers in flight together;
//   * accumulation — a pair in the window makes shared-memory atomics on
//     block-private accumulators (min / max read first and skip the atomic
//     when they cannot win); any other pair makes global atomics, so
//     correctness never depends on locality and nothing escapes.  The lanes
//     are not combined first: shared-memory atomics resolve lanes on one
//     address in hardware for less than the grouping costs (warp_agg.cuh);
//   * flush — every touched window slot goes out with one global atomic per
//     output, and back to its identity for the next tile.
// Aggregates of a slot column (q4's category carry) take no atomic at all:
// every pair on slot i carries col[i], so the epilogue writes them from
// col[i] and the pair count.  An int64 column (kMax64) is not held in
// registers with the int32 probe columns: a pair loads its 8 bytes just
// before its atomics, and its window accumulator sits with the 8-byte sums.
// What is left on the device: a global atomic per touched slot per tile
// (~1 per 6 bids at q4's frontier), the dependent gathers of `present` and
// the slot columns, and the two grid syncs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "warp_agg.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace flock;

constexpr int kMaxCols = 16;
constexpr int kMaxTerms = 8;
constexpr int kMaxAggs = 8;
constexpr int kMaxProbe = 4;           // probe columns held in registers
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 1;              // quads of rows per thread and tile
constexpr int kRows = 4 * kQuads;
constexpr int kTile = kThreads * kRows;  // 1024 probe rows
constexpr int kWindow = 2048;          // slots accumulated in shared memory
constexpr int kBlocksPerSm = 4;

enum Op : int32_t { kLt = 0, kLe = 1, kGt = 2, kGe = 3, kEq = 4, kNe = 5 };
enum Side : int32_t { kProbe = 0, kSlot = 1, kProbe64 = 2 };

struct Params {
  const int32_t* key;
  const uint8_t* valid;
  int64_t n;
  const uint8_t* present;
  const int32_t* m;
  int32_t span;
  bool vec;  // key and probe columns 16-byte aligned, valid 4-byte aligned
  int32_t ncols;
  const int32_t* col[kMaxCols];  // an int64 column's pointer, cast
  // 1: slot column [span]; 0: int32 probe column [n]; 2: int64 probe column
  // [n], only aggregated (kMax64)
  int32_t col_side[kMaxCols];
  int32_t col_probe[kMaxCols];  // an int32 probe column's register index
  int32_t nprobe;
  const int32_t* probe[kMaxProbe];
  int32_t nterms;
  int32_t lhs[kMaxTerms];
  int32_t op[kMaxTerms];
  int32_t rhs[kMaxTerms];
  int32_t naggs;  // aggregates of probe columns, accumulated pair by pair
  int32_t fn[kMaxAggs];
  int32_t acol[kMaxAggs];
  void* out[kMaxAggs];
  int32_t smem_off[kMaxAggs];  // byte offset of each window accumulator
  int32_t nslot;  // aggregates of slot columns, written from the count
  int32_t sfn[kMaxAggs];
  const int32_t* scol[kMaxAggs];
  void* sout[kMaxAggs];
  int32_t smem_cnt_off;
  int32_t* cnt;
  int32_t* key_out;
  uint8_t* valid_out;
};

// Column c at this thread's row r of the tile (slot s for a slot column).
__device__ __forceinline__ int32_t value(const Params& p, int c, int32_t s,
                                         const int32_t (&pv)[kMaxProbe][kRows],
                                         int r) {
  if (p.col_side[c] == kSlot) return __ldg(p.col[c] + s);
  const int k = p.col_probe[c];
  int32_t v = pv[0][r];
#pragma unroll
  for (int j = 1; j < kMaxProbe; ++j)
    if (k == j) v = pv[j][r];
  return v;
}

__device__ __forceinline__ bool compare(int32_t op, int32_t a, int32_t b) {
  switch (op) {
    case kLt: return a < b;
    case kLe: return a <= b;
    case kGt: return a > b;
    case kGe: return a >= b;
    case kEq: return a == b;
    default: return a != b;
  }
}

// kWide: some aggregate is kMax64.  Without one the kernel holds its
// aggregated values as int32, as before kMax64 existed, so the int32-only
// calls (q4, q9) keep their registers.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
join_agg_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ int32_t red_lo[kWarps], red_hi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tid = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int32_t m = __ldg(p.m);
  int* scnt = reinterpret_cast<int*>(smem + p.smem_cnt_off);

  // (a) outputs and the window at their identities, slot keys
  for (int64_t i = tid; i < p.span; i += nthreads) {
    p.cnt[i] = 0;
    p.key_out[i] = slot_key(m, i);
    for (int a = 0; a < p.naggs; ++a) init_slot(p.fn[a], p.out[a], i);
  }
  for (int k = threadIdx.x; k < kWindow; k += kThreads) {
    scnt[k] = 0;
    for (int a = 0; a < p.naggs; ++a) init_slot(p.fn[a], smem + p.smem_off[a], k);
  }
  cg::this_grid().sync();

  // (b) tiles
  const int64_t ntiles = (p.n + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int32_t s[kRows], pv[kMaxProbe][kRows];
    int32_t lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int64_t row = tile * kTile + 4 * (j * static_cast<int64_t>(kThreads) + threadIdx.x);
      int32_t k4[4];
      bool v4[4];
      load_quad<true>(p.key, row, p.n, p.vec, k4);
      load_quad(p.valid, row, p.n, p.vec, v4);
#pragma unroll
      for (int c = 0; c < kMaxProbe; ++c) {
        int32_t t4[4] = {0, 0, 0, 0};
        if (c < p.nprobe) load_quad<true>(p.probe[c], row, p.n, p.vec, t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[c][4 * j + e] = t4[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t rel = static_cast<int64_t>(k4[e]) - m;
        const bool live = v4[e] && rel >= 0 && rel < p.span;
        s[4 * j + e] = live ? static_cast<int32_t>(rel) : -1;
        if (live) {
          lo = min(lo, s[4 * j + e]);
          hi = max(hi, s[4 * j + e]);
        }
      }
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      red_lo[warp] = lo;
      red_hi[warp] = hi;
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      lo = min(lo, red_lo[w]);
      hi = max(hi, red_hi[w]);
    }
    if (hi >= 0) {  // the tile has live rows (block-uniform)
      const int32_t wbase = max(lo, hi - kWindow + 1);
      // pairs: a present slot and the predicate, term by term so that the
      // gathers of all rows are in flight together
      bool pair[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pair[r] = s[r] >= 0 && __ldg(p.present + s[r]);
      for (int t = 0; t < p.nterms; ++t) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (pair[r])
            pair[r] = compare(p.op[t], value(p, p.lhs[t], s[r], pv, r),
                              value(p, p.rhs[t], s[r], pv, r));
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!pair[r]) continue;
        const int32_t slot = s[r];
        // this thread's row r: quad r / 4 of the tile, element r % 4
        const int64_t row = tile * kTile + 4 * ((r / 4) * static_cast<int64_t>(kThreads)
                                                + threadIdx.x) + r % 4;
        using Value = typename std::conditional<kWide, long long, int32_t>::type;
        Value av[kMaxAggs];  // gathered before the atomics
#pragma unroll
        for (int a = 0; a < kMaxAggs; ++a) {
          if (a >= p.naggs) av[a] = 0;
          else if (kWide && p.fn[a] == kMax64)
            av[a] = static_cast<Value>(
                __ldcs(reinterpret_cast<const long long*>(p.col[p.acol[a]]) + row));
          else av[a] = value(p, p.acol[a], slot, pv, r);
        }
        // a slot in the window (k = slot - wbase >= 0; k < kWindow since
        // slot <= hi) goes to shared memory, any other to device memory
        const int32_t k = slot - wbase;
        if (k >= 0) atomicAdd(scnt + k, 1);
        else atomicAdd(p.cnt + slot, 1);
#pragma unroll
        for (int a = 0; a < kMaxAggs; ++a) {
          if (a >= p.naggs) break;
          if (kWide && p.fn[a] == kMax64) {
            if (k >= 0) apply_max64<true>(smem + p.smem_off[a], k, av[a]);
            else apply_max64<false>(p.out[a], slot, av[a]);
          } else if (k >= 0) {
            apply<true>(p.fn[a], smem + p.smem_off[a], k, av[a]);
          } else {
            apply<false>(p.fn[a], p.out[a], slot, av[a]);
          }
        }
      }
      __syncthreads();
      // flush the window's touched slots, back to their identities
      for (int k = threadIdx.x; k <= hi - wbase; k += kThreads) {
        const int c = scnt[k];
        if (c == 0) continue;
        const int64_t slot = wbase + k;
        atomicAdd(p.cnt + slot, c);
        scnt[k] = 0;
        for (int a = 0; a < p.naggs; ++a)
          flush_slot(p.fn[a], smem + p.smem_off[a], k, p.out[a], slot);
      }
    }
    __syncthreads();
  }
  cg::this_grid().sync();

  // (c) epilogue: validity, and every aggregate of a slot column — all its
  // pairs on slot i carry col[i], so it is a function of col[i] and the
  // count c: min / max col[i] (identity when c = 0), sum col[i]·c in int64,
  // count_sum col[i]·c wrapped to int32 as repeated int32 addition wraps
  for (int64_t i = tid; i < p.span; i += nthreads) {
    const int c = __ldcg(p.cnt + i);
    p.valid_out[i] = c > 0;
    for (int b = 0; b < p.nslot; ++b) {
      const int32_t v = __ldg(p.scol[b] + i);
      switch (p.sfn[b]) {
        case kCountSum:
          static_cast<int*>(p.sout[b])[i] = static_cast<int32_t>(
              static_cast<uint32_t>(v) * static_cast<uint32_t>(c));
          break;
        case kSum: static_cast<long long*>(p.sout[b])[i] = static_cast<long long>(v) * c; break;
        case kMin: static_cast<int*>(p.sout[b])[i] = c > 0 ? v : INT_MAX; break;
        case kMax: static_cast<int*>(p.sout[b])[i] = c > 0 ? v : INT_MIN; break;
      }
    }
  }
}

}  // namespace

// Launches K1 on `stream`: one cooperative launch that initialises and
// writes every output.  `args` packs, as int64: `ncols` column pointers,
// their sides (Side: 1 slot, 0 int32 probe, 2 int64 probe, which only
// kMax64 may aggregate), `nterms` triples (lhs column, Op, rhs column),
// `naggs` pairs (aggregate code, column), `naggs` output pointers.
// `cnt` and `key_out` are int32[span], `valid_out` bool[span].
extern "C" int flock_join_agg(const int32_t* key, const uint8_t* valid,
                              int64_t n, const uint8_t* present,
                              const int32_t* m, int64_t span, int32_t ncols,
                              int32_t nterms, int32_t naggs,
                              const int64_t* args, int32_t* cnt,
                              int32_t* key_out, uint8_t* valid_out,
                              void* stream) {
  if (n < 0 || span <= 0 || span > INT_MAX || ncols < 0 || ncols > kMaxCols ||
      nterms < 0 || nterms > kMaxTerms || naggs < 0 || naggs > kMaxAggs)
    return cudaErrorInvalidValue;
  Params p{};
  p.key = key;
  p.valid = valid;
  p.n = n;
  p.present = present;
  p.m = m;
  p.span = static_cast<int32_t>(span);
  p.vec = aligned(key, 16) && aligned(valid, 4);
  p.ncols = ncols;
  const int64_t* sides = args + ncols;
  for (int c = 0; c < ncols; ++c) {
    p.col[c] = reinterpret_cast<const int32_t*>(args[c]);
    p.col_side[c] = static_cast<int32_t>(sides[c]);
    if (p.col_side[c] < kProbe || p.col_side[c] > kProbe64 ||
        (p.col_side[c] == kProbe64 && !aligned(p.col[c], 8)))
      return cudaErrorInvalidValue;
    if (p.col_side[c] == kProbe) {
      if (p.nprobe == kMaxProbe) return cudaErrorInvalidValue;
      p.col_probe[c] = p.nprobe;
      p.probe[p.nprobe++] = p.col[c];
      p.vec = p.vec && aligned(p.col[c], 16);
    }
  }
  const int64_t* terms = sides + ncols;
  p.nterms = nterms;
  for (int t = 0; t < nterms; ++t) {
    p.lhs[t] = static_cast<int32_t>(terms[3 * t]);
    p.op[t] = static_cast<int32_t>(terms[3 * t + 1]);
    p.rhs[t] = static_cast<int32_t>(terms[3 * t + 2]);
    if (p.lhs[t] < 0 || p.lhs[t] >= ncols || p.rhs[t] < 0 ||
        p.rhs[t] >= ncols || p.op[t] < kLt || p.op[t] > kNe ||
        p.col_side[p.lhs[t]] == kProbe64 || p.col_side[p.rhs[t]] == kProbe64)
      return cudaErrorInvalidValue;
  }
  const int64_t* fns = terms + 3 * nterms;
  const int64_t* outs = fns + 2 * naggs;
  // window layout: int64 accumulators (sums, kMax64) first (8-byte aligned),
  // then the pair counts, then the int32 accumulators
  int64_t bytes = 0;
  for (int a = 0; a < naggs; ++a) {
    const int32_t fn = static_cast<int32_t>(fns[2 * a]);
    const int32_t c = static_cast<int32_t>(fns[2 * a + 1]);
    // kMax64 takes exactly the int64 probe columns, every other code int32
    if (fn < kCountSum || fn > kMax64 || c < 0 || c >= ncols ||
        (fn == kMax64) != (p.col_side[c] == kProbe64))
      return cudaErrorInvalidValue;
    if (p.col_side[c] == kSlot) {
      p.sfn[p.nslot] = fn;
      p.scol[p.nslot] = p.col[c];
      p.sout[p.nslot++] = reinterpret_cast<void*>(outs[a]);
      continue;
    }
    const int b = p.naggs++;
    p.fn[b] = fn;
    p.acol[b] = c;
    p.out[b] = reinterpret_cast<void*>(outs[a]);
    if (fn == kSum || fn == kMax64) {
      p.smem_off[b] = static_cast<int32_t>(bytes);
      bytes += 8LL * kWindow;
    }
  }
  p.smem_cnt_off = static_cast<int32_t>(bytes);
  bytes += 4LL * kWindow;
  for (int a = 0; a < p.naggs; ++a)
    if (p.fn[a] != kSum && p.fn[a] != kMax64) {
      p.smem_off[a] = static_cast<int32_t>(bytes);
      bytes += 4LL * kWindow;
    }
  p.cnt = cnt;
  p.key_out = key_out;
  p.valid_out = valid_out;

  bool wide = false;
  for (int a = 0; a < p.naggs; ++a) wide = wide || p.fn[a] == kMax64;
  const void* narrow_kernel = reinterpret_cast<const void*>(join_agg_kernel<false>);
  const void* wide_kernel = reinterpret_cast<const void*>(join_agg_kernel<true>);
  const void* kernel = wide ? wide_kernel : narrow_kernel;
  const size_t smem = static_cast<size_t>(bytes);  // up to 139 KB (8 sums)
  static const cudaError_t opted = [&] {
    const cudaError_t e = allow_all_shared(narrow_kernel);
    return e != cudaSuccess ? e : allow_all_shared(wide_kernel);
  }();
  if (opted != cudaSuccess) return static_cast<int>(opted);
  // one block per tile, at least enough to initialise the span, no more
  // than are resident at once
  int64_t blocks = (n + kTile - 1) / kTile;
  const int64_t init_blocks = (span + kThreads * 8 - 1) / (kThreads * 8);
  if (blocks < init_blocks) blocks = init_blocks;
  const int resident = resident_blocks(kernel, kThreads, smem, kBlocksPerSm);
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  if (blocks > resident) blocks = resident;
  void* kargs[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), kargs, smem,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* flock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
