// Shared pieces of K1 (join_agg.cu), K2 (dense_agg.cu) and K4 (lookup_agg.cu:
// the quad loads and slot keys): aggregate codes, quad loads, slot
// initialisation and flushing, and the atomics that apply a value — alone, or
// combined over the lanes of a warp that hold one slot.
//
// Combining lanes (K2's block-shared and global variants).  Rows whose keys
// fall on one slot would each make an atomic on the same address, and those
// serialise.  __match_any_sync groups the lanes of a warp that hold the same
// slot; __reduce_{add,min,max}_sync under the group's mask combine their
// int32 values; one lane per group makes the atomic.  An int64 sum of int32
// values is combined exactly as two int32 reductions: v = hi·2¹⁶ + lo with
// hi = v >> 16 (arithmetic, in [-2¹⁵, 2¹⁵)) and lo = v & 0xffff, so 32 lanes
// sum to |Σhi| ≤ 2²⁰ and Σlo < 2²¹ with no wrap.  Reductions under different
// masks run as one pass of the warp per group, so this pays only when a
// warp holds few slots (kFewSlots in dense_agg.cu); measured on the H100
// (PERF.md), combining 32 distinct slots made build slotting 2.7x
// slower, and K1 was faster with plain atomics at every timed shape that
// forms pairs, one hot slot included.  The match itself is paid on every
// row; K2's small tables (q4's five categories, YSB's 100 campaigns) take
// the lane-private variant instead, whose lanes never share an address and
// so need neither match nor combine (dense_agg.cu).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace flock {

constexpr unsigned kFull = 0xffffffffu;

// kMax64 (K1 only): max over an int64 probe column into an int64 output
enum Fn : int32_t { kCountSum = 1, kSum = 2, kMin = 3, kMax = 4, kMax64 = 5 };

using ull = unsigned long long;

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Rows row..row+3 (row a multiple of 4): one 16-byte load when `vec` (every
// column 16-byte aligned) and the quad lies inside [0, n); else element-wise,
// rows at or beyond n reading 0.  kStream marks data read once (K1's probe
// columns, K4's keys, flags and columns): evict-first loads, which leave L2
// to the slot table the kernel gathers from (6 % faster for K1 on the H100,
// PERF.md, PR 3).  The flags' overload (4 bytes a quad) takes the same hint.
template <bool kStream = false>
__device__ __forceinline__ void load_quad(const int32_t* p, int64_t row,
                                          int64_t n, bool vec, int32_t (&v)[4]) {
  if (vec && row + 3 < n) {
    const int4* q = reinterpret_cast<const int4*>(p + row);
    const int4 t = kStream ? __ldcs(q) : __ldg(q);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = row + e < n ? __ldg(p + row + e) : 0;
}

template <bool kStream = false>
__device__ __forceinline__ void load_quad(const uint8_t* p, int64_t row,
                                          int64_t n, bool vec, bool (&v)[4]) {
  if (vec && row + 3 < n) {
    const uchar4* q = reinterpret_cast<const uchar4*>(p + row);
    const uchar4 t = kStream ? __ldcs(q) : __ldg(q);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = row + e < n && __ldg(p + row + e);
}

// An accumulator slot at its identity: 0, INT_MAX for min, INT_MIN for max,
// LLONG_MIN for the int64 max.
__device__ __forceinline__ void init_slot(int32_t fn, void* acc, int64_t i) {
  switch (fn) {
    case kSum: static_cast<long long*>(acc)[i] = 0; break;
    case kMax64: static_cast<long long*>(acc)[i] = LLONG_MIN; break;
    case kMin: static_cast<int*>(acc)[i] = INT_MAX; break;
    case kMax: static_cast<int*>(acc)[i] = INT_MIN; break;
    default: static_cast<int*>(acc)[i] = 0; break;
  }
}

// Block-private slot k (shared memory) into output slot s with one global
// atomic, then back to its identity.
__device__ __forceinline__ void flush_slot(int32_t fn, void* from, int64_t k,
                                           void* to, int64_t s) {
  switch (fn) {
    case kCountSum:
      atomicAdd(static_cast<int*>(to) + s, static_cast<int*>(from)[k]);
      break;
    case kSum:
      atomicAdd(static_cast<ull*>(to) + s,
                static_cast<ull>(static_cast<long long*>(from)[k]));
      break;
    case kMin: atomicMin(static_cast<int*>(to) + s, static_cast<int*>(from)[k]); break;
    case kMax: atomicMax(static_cast<int*>(to) + s, static_cast<int*>(from)[k]); break;
    case kMax64:
      atomicMax(static_cast<long long*>(to) + s, static_cast<long long*>(from)[k]);
      break;
  }
  init_slot(fn, from, k);
}

// The combination of `v` over the lanes of `peers` (lanes holding one slot),
// in each of them.  Every lane of `peers` must call it with the same mask.
__device__ __forceinline__ long long group_combine(int32_t fn, unsigned peers, int32_t v) {
  switch (fn) {
    case kCountSum: return __reduce_add_sync(peers, v);
    case kSum: {
      const int hi = __reduce_add_sync(peers, v >> 16);
      const unsigned lo = __reduce_add_sync(peers, static_cast<unsigned>(v) & 0xffffu);
      return static_cast<long long>(hi) * 65536 + lo;
    }
    case kMin: return __reduce_min_sync(peers, v);
    default: return __reduce_max_sync(peers, v);
  }
}

// One (combined) value into acc[s] with one atomic.  In shared memory, min
// and max read the slot first and skip the atomic when the value cannot win
// (values only move one way, so a stale read only costs an atomic).
template <bool kShared>
__device__ __forceinline__ void apply(int32_t fn, void* acc, int64_t s, long long t) {
  int* o = static_cast<int*>(acc) + s;
  switch (fn) {
    case kCountSum: atomicAdd(o, static_cast<int>(t)); break;
    case kSum: atomicAdd(static_cast<ull*>(acc) + s, static_cast<ull>(t)); break;
    case kMin:
      if (!kShared || static_cast<int>(t) < *static_cast<volatile int*>(o))
        atomicMin(o, static_cast<int>(t));
      break;
    case kMax:
      if (!kShared || static_cast<int>(t) > *static_cast<volatile int*>(o))
        atomicMax(o, static_cast<int>(t));
      break;
  }
}

// kMax64: t into the int64 max acc[s], a signed 64-bit atomicMax (exact for
// every value), skipped in shared memory when t cannot win.
template <bool kShared>
__device__ __forceinline__ void apply_max64(void* acc, int64_t s, long long t) {
  long long* o = static_cast<long long*>(acc) + s;
  if (!kShared || t > *static_cast<volatile long long*>(o)) atomicMax(o, t);
}

// The wrapped int32 key of slot i (m + i mod 2³², as PyTorch's int64 → int32
// conversion of the plain versions).
__device__ __forceinline__ int32_t slot_key(int32_t m, int64_t i) {
  return static_cast<int32_t>(static_cast<uint32_t>(static_cast<int64_t>(m) + i));
}

// Lets `kernel` take all the dynamic shared memory a block may opt into
// (227 KB less its static shared memory on the H100): without it, dynamic
// and static shared memory together must stay within 48 KB.
inline cudaError_t allow_all_shared(const void* kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa{};
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - static_cast<int>(fa.sharedSizeBytes));
}

// Resident blocks of `kernel` on the current device at `threads` threads
// and `smem` dynamic shared bytes, at most `per_sm_cap` per SM — the largest
// grid a cooperative launch accepts.  0 when it cannot run at all.
inline int resident_blocks(const void* kernel, int threads, size_t smem,
                           int per_sm_cap) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return sms * (per_sm < per_sm_cap ? per_sm : per_sm_cap);
}

}  // namespace flock
