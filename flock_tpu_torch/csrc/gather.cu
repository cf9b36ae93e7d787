// K3 — probe-side gather of a lookup join, hand-written for Hopper (sm_90a).
//
// Replaces: flock_tpu/pallas/factored.py pallas_factored_gather (kernel
// _gather_kernel :514-552, pallas_call :589), whose contract is also that of
// the XLA formulation ops/blocked.py blocked_local_join.  With `rows` > n
// and carried columns, one launch also writes what the reference's
// clean_branch pads (flock_tpu/ops/kernels.py:593-604), so a clean
// duplicate-faithful join needs no padding of its own.
//
// Contract.  The build side is slot-dense: slot s holds key m + s, where m is
// a device scalar (no host round trip), and present[s] says whether a build
// row has that key.  For every probe row i < n, hit[i] = valid[i] and
// 0 <= key[i] - m < span and present[key[i] - m]; each taken column's
// gathered value is that slot's value under a hit and 0 otherwise (the
// reference leaves it unspecified; 0 keeps the kernel and its plain version
// bit-equal).  Columns are moved as raw 4- or 8-byte words, so int32 codes
// and int64 timestamps take the same path.  The difference key - m is taken
// in 64 bits: no key wraps into the span.  Output rows n..rows-1 hold 0 and
// hit = false; each of up to 32 carried probe columns (1, 2, 4 or 8 bytes an
// element) is copied to its output of `rows` elements and zero-padded the
// same way.
//
// What bounds it on this card.  Bytes: per probe row the key (4 B) and valid
// flag (1 B) are read and, per output row, the hit flag (1 B) and each
// gathered column (4 or 8 B) written once; a carried column is read at n rows
// and written at `rows`; each slot column and `present` are read at most once
// and stay in the 50 MB L2 (q9's 248,192 slots of one column are 1.2 MB,
// q3's 328,192 slots of three 4.3 MB).  A q9 window (3.68 M bids) moves
// ~38 MB, ~11 us at 3.35 TB/s; q3's carry case (0.96 M auctions, 1.44 M output
// rows, 3 gathered and 7 carried columns, the probe key among them) ~91 MB,
// ~27 us.  The first version (one row a thread, each column load waiting on
// `present`) took 2x that at q9; this one takes ~1.3x at q9 and q13 and
// ~1.45x at q3 (PERF.md).
//
// Design.  The TPU kernel reached build slots through factored hi (x) lo
// one-hot matmuls over a 1024-aligned window, because a TPU has no fast
// gather, and escaped when a block's keys left the window.  Hopper gathers
// natively, so what is left is hiding the latency of dependent loads:
//   * work items — a thread takes a quad of four consecutive output rows
//     (grid-stride over quads; the grid is the card's resident blocks, asked
//     of the occupancy API once per device and cached here).  The keys are
//     one 16-byte load, the four valid flags one 4-byte load, the four hit
//     flags one 4-byte store, a 4-byte output column one 16-byte store (an
//     8-byte one two);
//   * no load waits on another — for all four rows the slot s and the
//     in-span test come first, an out-of-span s is clamped to 0, then the
//     loads of present[s] and of every taken column at s all start before
//     any value is used, and the values are selected under hit last:
//     4 x (1 + ncols) independent gathers in flight per thread, where a
//     row-at-a-time loop waits on `present` before each column;
//   * loads by use — probe inputs are read once, with evict-first loads
//     (__ldcs); `present` and the slot columns through the read-only path
//     (__ldg), where they stay in L2;
//   * signatures — one and three 4-byte columns (q9/q13, q3) are compiled
//     with the column count and width fixed; any other set of up to 8 columns
//     of 4 or 8 bytes takes one instantiation that reads them at run time,
//     which took 15-38 % longer at q9, q13 and q3's shapes on the H100;
//   * the carry — after the quads, the work items run on through every
//     carried column in 16-byte chunks (copy below n, zeros above), so the
//     padded join output is one launch;
//   * alignment — the 16-byte path runs when every probe-row pointer and
//     output is 16-byte aligned; otherwise, and for a ragged last quad, the
//     same kernel takes rows one by one, and a carried chunk whose source
//     sits off that boundary is copied byte by byte.  Both are inside the
//     kernel: nothing falls back to the plain version.
// Stores are plain (write-back), so the outputs stay in L2 for the operator
// that reads them next.  Streaming stores (__stcs) took 5-14 % off the kernel
// alone at wide outputs on the H100, but made q9's post-filter, which reads
// the gathered column right after, 27 % slower, and gained nothing in q3's
// pass (PERF.md).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxCols = 8;
constexpr int kMaxCarry = 32;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct Params {
  const int32_t* keys;
  const uint8_t* valid;
  const uint8_t* present;
  const int32_t* m;
  uint8_t* hit;
  int64_t n;       // probe rows
  int64_t rows;    // output rows, >= n
  int64_t span;
  int64_t quads;   // ceil(rows / 4): the gather's work items
  int64_t items;   // quads + every carried column's 16-byte chunks
  int32_t ncols;
  int32_t vector;  // keys, valid, hit and every output 16-byte aligned
  int32_t width[kMaxCols];  // bytes per element: 4 or 8
  const void* col[kMaxCols];
  void* out[kMaxCols];
  int32_t carry_width[kMaxCarry];  // bytes per element: 1, 2, 4 or 8
  int64_t carry_end[kMaxCarry];    // one past each carried column's last item
  const uint8_t* carry_in[kMaxCarry];
  uint8_t* carry_out[kMaxCarry];
};

template <bool kGeneric>
__device__ __forceinline__ bool wide(const Params& p, int c) {
  return kGeneric && p.width[c] == 8;
}

template <bool kGeneric>
__device__ __forceinline__ uint64_t load_slot(const Params& p, int c,
                                              int64_t s) {
  if (wide<kGeneric>(p, c))
    return __ldg(static_cast<const unsigned long long*>(p.col[c]) + s);
  return __ldg(static_cast<const unsigned*>(p.col[c]) + s);
}

// Four consecutive rows r..r+3 < n, every pointer 16-byte aligned.
template <int kCols, bool kGeneric>
__device__ __forceinline__ void gather_quad(const Params& p, int64_t m,
                                            int64_t r) {
  const int4 k4 = __ldcs(reinterpret_cast<const int4*>(p.keys + r));
  const unsigned v4 = __ldcs(reinterpret_cast<const unsigned*>(p.valid + r));
  const int32_t key[4] = {k4.x, k4.y, k4.z, k4.w};
  int64_t s[4];
  bool in[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t d = static_cast<int64_t>(key[j]) - m;
    in[j] = ((v4 >> (8 * j)) & 0xffu) != 0 && d >= 0 && d < p.span;
    s[j] = in[j] ? d : 0;
  }
  // every gather of the quad in flight before any is used
  uint8_t pr[4];
  uint64_t g[kCols][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) pr[j] = __ldg(p.present + s[j]);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (kGeneric && c >= p.ncols) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) g[c][j] = load_slot<kGeneric>(p, c, s[j]);
  }
  bool h[4];
  unsigned h4 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = in[j] && pr[j];
    h4 |= static_cast<unsigned>(h[j]) << (8 * j);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (kGeneric && c >= p.ncols) break;
    if (wide<kGeneric>(p, c)) {
      longlong2* o = reinterpret_cast<longlong2*>(
          static_cast<unsigned long long*>(p.out[c]) + r);
      o[0] = make_longlong2(h[0] ? g[c][0] : 0, h[1] ? g[c][1] : 0);
      o[1] = make_longlong2(h[2] ? g[c][2] : 0, h[3] ? g[c][3] : 0);
    } else {
      int4* o = reinterpret_cast<int4*>(static_cast<unsigned*>(p.out[c]) + r);
      *o = make_int4(h[0] ? static_cast<int>(g[c][0]) : 0,
                     h[1] ? static_cast<int>(g[c][1]) : 0,
                     h[2] ? static_cast<int>(g[c][2]) : 0,
                     h[3] ? static_cast<int>(g[c][3]) : 0);
    }
  }
  *reinterpret_cast<unsigned*>(p.hit + r) = h4;
}

// Four consecutive padding rows n <= r, r + 3 < rows, 16-byte aligned.
template <int kCols, bool kGeneric>
__device__ __forceinline__ void zero_quad(const Params& p, int64_t r) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (kGeneric && c >= p.ncols) break;
    if (wide<kGeneric>(p, c)) {
      longlong2* o = reinterpret_cast<longlong2*>(
          static_cast<unsigned long long*>(p.out[c]) + r);
      o[0] = o[1] = make_longlong2(0, 0);
    } else {
      *reinterpret_cast<int4*>(static_cast<unsigned*>(p.out[c]) + r) =
          make_int4(0, 0, 0, 0);
    }
  }
  *reinterpret_cast<unsigned*>(p.hit + r) = 0u;
}

// One row, any alignment: a probe row below n, a padding row above.
template <int kCols, bool kGeneric>
__device__ __forceinline__ void gather_row(const Params& p, int64_t m,
                                           int64_t r) {
  bool in = false;
  int64_t s = 0;
  if (r < p.n) {
    const int64_t d = static_cast<int64_t>(__ldcs(p.keys + r)) - m;
    in = __ldcs(p.valid + r) != 0 && d >= 0 && d < p.span;
    s = in ? d : 0;
  }
  const uint8_t pr = __ldg(p.present + s);
  uint64_t g[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (kGeneric && c >= p.ncols) break;
    g[c] = load_slot<kGeneric>(p, c, s);
  }
  const bool h = in && pr;
  p.hit[r] = h;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (kGeneric && c >= p.ncols) break;
    if (wide<kGeneric>(p, c))
      static_cast<unsigned long long*>(p.out[c])[r] = h ? g[c] : 0ull;
    else
      static_cast<unsigned*>(p.out[c])[r] =
          h ? static_cast<unsigned>(g[c]) : 0u;
  }
}

// One 16-byte chunk of a carried column's output: the probe column's bytes
// below n x width, zeros above.  The output is 16-byte aligned (the entry
// point refuses another); a source off that boundary, and the chunk that
// holds the source's last bytes, are copied byte by byte.
__device__ __forceinline__ void carry_chunk(const Params& p, int64_t i) {
  int c = 0;
  while (i >= p.carry_end[c]) ++c;
  const int64_t o = 16 * (i - (c ? p.carry_end[c - 1] : p.quads));
  const int64_t in_bytes = p.n * p.carry_width[c] - o;
  const int64_t out_bytes = p.rows * p.carry_width[c] - o;
  const uint8_t* src = p.carry_in[c] + o;
  uint8_t* dst = p.carry_out[c] + o;
  if (in_bytes >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    *reinterpret_cast<int4*>(dst) = __ldcs(reinterpret_cast<const int4*>(src));
  } else if (in_bytes <= 0 && out_bytes >= 16) {
    *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
  } else {
    for (int64_t b = 0; b < 16 && b < out_bytes; ++b)
      dst[b] = b < in_bytes ? __ldcs(src + b) : 0;
  }
}

template <int kCols, bool kGeneric>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const __grid_constant__ Params p) {
  const int64_t m = __ldg(p.m);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < p.items; i += stride) {
    if (i >= p.quads) {
      carry_chunk(p, i);
      continue;
    }
    const int64_t r = 4 * i;
    if (p.vector && r + 4 <= p.n) {
      gather_quad<kCols, kGeneric>(p, m, r);
    } else if (p.vector && r >= p.n && r + 4 <= p.rows) {
      zero_quad<kCols, kGeneric>(p, r);
    } else {
      const int64_t end = r + 4 < p.rows ? r + 4 : p.rows;
      for (int64_t row = r; row < end; ++row)
        gather_row<kCols, kGeneric>(p, m, row);
    }
  }
}

template <int kCols, bool kGeneric>
int launch(const Params& p, int device, cudaStream_t stream) {
  // resident blocks on `device`, asked of the occupancy API once (0: not yet)
  static std::atomic<int> resident[kMaxDevices];
  int grid = resident[device].load(std::memory_order_relaxed);
  if (grid == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_kernel<kCols, kGeneric>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    grid = sms * per_sm;
    if (grid <= 0) return cudaErrorInvalidConfiguration;
    resident[device].store(grid, std::memory_order_relaxed);
  }
  const int64_t want = (p.items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < grid ? want : grid);
  gather_kernel<kCols, kGeneric><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Launches K3 on the given stream.  `a` is the packed argument array, one
// int64 each (ops/gather.py builds it):
//   [0] keys  [1] valid  [2] present  [3] m  [4] hit  [5] stream  [6] device
//   [7] n  [8] rows  [9] span  [10] ncols  [11] ncarry,
// then per taken column (element bytes 4/8, slot column [span], output
// [rows]), then per carried column (element bytes 1/2/4/8, probe column [n],
// output [rows]).  Returns the launch's cudaError_t.
extern "C" int flock_gather(const int64_t* a) {
  Params p{};
  p.keys = reinterpret_cast<const int32_t*>(a[0]);
  p.valid = reinterpret_cast<const uint8_t*>(a[1]);
  p.present = reinterpret_cast<const uint8_t*>(a[2]);
  p.m = reinterpret_cast<const int32_t*>(a[3]);
  p.hit = reinterpret_cast<uint8_t*>(a[4]);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[5]);
  const int64_t device = a[6];
  p.n = a[7];
  p.rows = a[8];
  p.span = a[9];
  const int64_t ncols = a[10], ncarry = a[11];
  if (device < 0 || device >= kMaxDevices || p.n < 0 || p.rows < p.n ||
      p.rows <= 0 || p.span <= 0 || ncols < 0 || ncols > kMaxCols ||
      ncarry < 0 || ncarry > kMaxCarry)
    return cudaErrorInvalidValue;
  p.ncols = static_cast<int32_t>(ncols);
  bool vector = aligned16(p.keys) && aligned16(p.valid) && aligned16(p.hit);
  bool all4 = true;
  const int64_t* col = a + 12;
  for (int c = 0; c < ncols; ++c, col += 3) {
    if (col[0] != 4 && col[0] != 8) return cudaErrorInvalidValue;
    p.width[c] = static_cast<int32_t>(col[0]);
    p.col[c] = reinterpret_cast<const void*>(col[1]);
    p.out[c] = reinterpret_cast<void*>(col[2]);
    vector = vector && aligned16(p.out[c]);
    all4 = all4 && col[0] == 4;
  }
  p.quads = (p.rows + 3) / 4;
  int64_t items = p.quads;
  for (int c = 0; c < ncarry; ++c, col += 3) {
    const int64_t w = col[0];
    if (w != 1 && w != 2 && w != 4 && w != 8) return cudaErrorInvalidValue;
    if (!aligned16(reinterpret_cast<const void*>(col[2])))
      return cudaErrorMisalignedAddress;
    p.carry_width[c] = static_cast<int32_t>(w);
    p.carry_in[c] = reinterpret_cast<const uint8_t*>(col[1]);
    p.carry_out[c] = reinterpret_cast<uint8_t*>(col[2]);
    items += (p.rows * w + 15) / 16;
    p.carry_end[c] = items;
  }
  p.items = items;
  p.vector = vector;
  const int dev = static_cast<int>(device);
  if (all4 && ncols == 1) return launch<1, false>(p, dev, stream);
  if (all4 && ncols == 3) return launch<3, false>(p, dev, stream);
  return launch<kMaxCols, true>(p, dev, stream);
}

extern "C" const char* flock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
