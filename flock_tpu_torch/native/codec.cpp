// Copy of flock_tpu/native/codec.cpp, kept in the PyTorch port so that the
// port imports nothing of flock_tpu.  Keep the two files identical below.
//
// Native payload codec: LZ4 block format, from scratch.
//
// The reference compresses every inter-function payload and marshaled
// context with zstd/lz4/snappy (flock/src/encoding.rs:27-112).  On a TPU
// mesh live data rides ICI uncompressed; this codec serves the persistence
// paths (state backend, checkpoints, host spill) where byte-identical,
// dependency-free encode/decode matters.  Implements the public LZ4 block
// format (token | literals | 2-byte LE offset | match), greedy hash-table
// matcher — the same format family the reference selects with
// Encoding::Lz4, without the crate.
//
// Exposed via ctypes (see __init__.py):
//   flock_lz4_max_compressed(n)            -> worst-case dst size
//   flock_lz4_compress(src, n, dst, cap)   -> compressed size or -1
//   flock_lz4_decompress(src, n, dst, cap) -> decompressed size or -1

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> 16; }

constexpr int kHashBits = 16;
constexpr int kHashSize = 1 << kHashBits;
constexpr int kMinMatch = 4;
// format rules: the last 5 bytes are always literals; a match may not start
// within the last 12 bytes of the block
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;

uint8_t *write_len(uint8_t *op, const uint8_t *oend, int64_t len) {
  while (len >= 255) {
    if (op >= oend) return nullptr;
    *op++ = 255;
    len -= 255;
  }
  if (op >= oend) return nullptr;
  *op++ = static_cast<uint8_t>(len);
  return op;
}

}  // namespace

extern "C" {

int64_t flock_lz4_max_compressed(int64_t n) { return n + n / 255 + 16; }

int64_t flock_lz4_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                           int64_t cap) {
  if (n < 0 || cap < 0) return -1;
  uint8_t *op = dst;
  uint8_t *const oend = dst + cap;
  const uint8_t *ip = src;
  const uint8_t *const iend = src + n;
  const uint8_t *anchor = src;

  if (n >= kMfLimit + 1) {
    std::vector<int64_t> table(kHashSize, -1);
    const uint8_t *const mflimit = iend - kMfLimit;
    const uint8_t *const matchlimit = iend - kLastLiterals;
    // step acceleration: after repeated misses, advance faster (bounded so
    // incompressible data stays O(n))
    int64_t search_acc = 1 << 6;

    while (ip < mflimit) {
      uint32_t h = hash4(read32(ip));
      int64_t ref = table[h];
      table[h] = ip - src;
      if (ref >= 0 && (ip - src) - ref <= 65535 &&
          read32(src + ref) == read32(ip)) {
        search_acc = 1 << 6;
        const uint8_t *match = src + ref;
        // extend backwards over pending literals
        while (ip > anchor && match > src && ip[-1] == match[-1]) {
          --ip;
          --match;
        }
        int64_t mlen = kMinMatch;
        while (ip + mlen < matchlimit && ip[mlen] == match[mlen]) ++mlen;

        int64_t litlen = ip - anchor;
        uint8_t *token = op;
        if (op + 1 + litlen + 8 > oend) return -1;
        ++op;
        if (litlen >= 15) {
          *token = 15 << 4;
          op = write_len(op, oend, litlen - 15);
          if (!op) return -1;
        } else {
          *token = static_cast<uint8_t>(litlen << 4);
        }
        if (op + litlen + 2 > oend) return -1;
        std::memcpy(op, anchor, litlen);
        op += litlen;
        uint16_t offset = static_cast<uint16_t>(ip - match);
        *op++ = static_cast<uint8_t>(offset);
        *op++ = static_cast<uint8_t>(offset >> 8);
        int64_t mextra = mlen - kMinMatch;
        if (mextra >= 15) {
          *token |= 15;
          op = write_len(op, oend, mextra - 15);
          if (!op) return -1;
        } else {
          *token |= static_cast<uint8_t>(mextra);
        }
        ip += mlen;
        anchor = ip;
      } else {
        ip += 1 + ((search_acc++) >> 9);
      }
    }
  }

  // final literal run
  int64_t litlen = iend - anchor;
  uint8_t *token = op;
  if (op + 1 > oend) return -1;
  ++op;
  if (litlen >= 15) {
    *token = 15 << 4;
    op = write_len(op, oend, litlen - 15);
    if (!op) return -1;
  } else {
    *token = static_cast<uint8_t>(litlen << 4);
  }
  if (op + litlen > oend) return -1;
  std::memcpy(op, anchor, litlen);
  op += litlen;
  return op - dst;
}

int64_t flock_lz4_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                             int64_t cap) {
  if (n < 0 || cap < 0) return -1;
  const uint8_t *ip = src;
  const uint8_t *const iend = src + n;
  uint8_t *op = dst;
  uint8_t *const oend = dst + cap;

  while (ip < iend) {
    uint8_t token = *ip++;
    // literals
    int64_t litlen = token >> 4;
    if (litlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        litlen += b;
      } while (b == 255);
    }
    if (ip + litlen > iend || op + litlen > oend) return -1;
    std::memcpy(op, ip, litlen);
    ip += litlen;
    op += litlen;
    if (ip >= iend) break;  // last sequence carries no match

    // match
    if (ip + 2 > iend) return -1;
    int64_t offset = ip[0] | (static_cast<int64_t>(ip[1]) << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t mlen = (token & 15) + kMinMatch;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    if (op + mlen > oend) return -1;
    const uint8_t *match = op - offset;
    for (int64_t i = 0; i < mlen; ++i) op[i] = match[i];  // overlap-safe
    op += mlen;
  }
  return op - dst;
}

}  // extern "C"
