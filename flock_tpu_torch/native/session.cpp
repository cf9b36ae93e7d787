// Copy of flock_tpu/native/session.cpp, kept in the PyTorch port so that the
// port imports nothing of flock_tpu.  Keep the two files identical below.
//
// Native per-epoch session statistics (the q11/q12 host bookkeeping hot
// loop).  Reference counterpart: the per-key window bookkeeping Flock's
// session driver does per payload (flock-function/src/aws/window/
// session.rs:64-178); here the epoch's (first second, last second) per key
// fills dense key-span tables in ONE pass (~1-2 ns/row) instead of several
// vectorized numpy passes (measured ~100 ms per 3.7M-row epoch on the
// 2-vCPU host, round 4 q11 profile).
//
// Contract (ctypes, see flock_tpu_torch/native/__init__.py):
//   flock_session_stats(keys, times, n, kmin, span, first, last) -> 0
// * keys/times — int64[n] (times in ms; seconds = times/1000)
// * first/last — int64[span], caller-initialised to -1; on return,
//   first[k-kmin]/last[k-kmin] hold the first/last row SECOND per key
//   (rows are time-ordered within an epoch, so first/last occurrence
//   equals min/max — same assumption as the Python path).

#include <cstdint>

extern "C" int64_t flock_session_stats(
    const int64_t* keys, const int64_t* times, int64_t n,
    int64_t kmin, int64_t span, int64_t* first, int64_t* last) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t p = keys[i] - kmin;
    if (p < 0 || p >= span) return -1;  // caller's span was wrong
    int64_t s = times[i] / 1000;
    if (first[p] < 0) first[p] = s;
    last[p] = s;
  }
  return 0;
}
