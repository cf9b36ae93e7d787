// K3 — probe-side gather of a lookup join, hand-written for Hopper (sm_90a).
//
// Replaces: flock_tpu/pallas/factored.py pallas_factored_gather (kernel
// _gather_kernel :514-552, pallas_call :589), whose contract is also that of
// the XLA formulation ops/blocked.py blocked_local_join.
//
// Contract.  The build side is slot-dense: slot s holds key m + s, where m is
// a device scalar (no host round trip), and present[s] says whether a build
// row has that key.  For every probe row i, hit[i] = valid[i] and
// 0 <= key[i] - m < span and present[key[i] - m]; each taken column's
// gathered value is that slot's value under a hit and 0 otherwise (the
// reference leaves it unspecified; 0 keeps the kernel and its plain version
// bit-equal).  Columns are moved as raw 4- or 8-byte words, so int32 codes
// and int64 timestamps take the same path.  The difference key - m is taken
// in 64 bits: no key wraps into the span.
//
// What bounds it on this card.  Bytes: per probe row the key (4 B) and valid
// flag (1 B) are read and the hit flag (1 B) and each gathered column (4 or
// 8 B) written once, and each slot column and `present` are read at most
// once — about 10 B per row for one column, so a q9 window (3.68 M bids)
// moves ~37 MB, ~11 us at 3.35 TB/s.
//
// Design.  The TPU kernel reached build slots through factored hi (x) lo
// one-hot matmuls over a 1024-aligned window, because a TPU has no fast
// gather, and escaped when a block's keys left the window.  Hopper gathers
// natively: one thread per probe row (grid-stride), one bounds check and one
// load of `present`, then one direct-index read-only load per taken column.
// Neighbouring threads read neighbouring keys and write neighbouring
// outputs, so those accesses coalesce; the slot reads follow the probe keys,
// which cluster near the auction frontier, so most of them hit L2.  Any key
// in the span is handled, so there is no escape.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxCols = 8;
constexpr int kThreads = 256;

struct Params {
  const int32_t* keys;
  const uint8_t* valid;
  const uint8_t* present;
  const int32_t* m;
  int64_t n;
  int64_t span;
  int32_t ncols;
  int32_t width[kMaxCols];  // bytes per element: 4 or 8
  const void* col[kMaxCols];
  void* out[kMaxCols];
  uint8_t* hit;
};

__global__ void __launch_bounds__(kThreads)
gather_kernel(const __grid_constant__ Params p) {
  const int64_t m = *p.m;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < p.n; i += stride) {
    const int64_t s = static_cast<int64_t>(__ldg(p.keys + i)) - m;
    const bool hit = __ldg(p.valid + i) && s >= 0 && s < p.span &&
                     __ldg(p.present + s);
    p.hit[i] = hit;
    for (int c = 0; c < p.ncols; ++c) {
      if (p.width[c] == 4) {
        const uint32_t* col = static_cast<const uint32_t*>(p.col[c]);
        static_cast<uint32_t*>(p.out[c])[i] = hit ? __ldg(col + s) : 0u;
      } else {
        const unsigned long long* col =
            static_cast<const unsigned long long*>(p.col[c]);
        static_cast<unsigned long long*>(p.out[c])[i] = hit ? __ldg(col + s) : 0ull;
      }
    }
  }
}

}  // namespace

// Launches K3 on `stream`.  `widths`, `cols` and `outs` are host arrays of
// `ncols` entries (element bytes, slot column pointers [span], output
// pointers [n]); `hit` is a bool [n] output.
extern "C" int flock_gather(const int32_t* keys, const uint8_t* valid,
                            int64_t n, const uint8_t* present, const int32_t* m,
                            int64_t span, int32_t ncols, const int32_t* widths,
                            const int64_t* cols, const int64_t* outs,
                            uint8_t* hit, void* stream) {
  if (ncols < 0 || ncols > kMaxCols || span <= 0 || n <= 0)
    return cudaErrorInvalidValue;
  Params p{};
  p.keys = keys;
  p.valid = valid;
  p.present = present;
  p.m = m;
  p.n = n;
  p.span = span;
  p.ncols = ncols;
  p.hit = hit;
  for (int c = 0; c < ncols; ++c) {
    if (widths[c] != 4 && widths[c] != 8) return cudaErrorInvalidValue;
    p.width[c] = widths[c];
    p.col[c] = reinterpret_cast<const void*>(cols[c]);
    p.out[c] = reinterpret_cast<void*>(outs[c]);
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 32LL * sms ? want : 32LL * sms);
  gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
