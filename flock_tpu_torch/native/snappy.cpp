// Copy of flock_tpu/native/snappy.cpp, kept in the PyTorch port so that the
// port imports nothing of flock_tpu.  Keep the two files identical below.
//
// From-scratch Snappy block-format codec (format spec:
// google/snappy format_description.txt — implemented from the public FORMAT
// only, no code consulted).  Reference counterpart: Flock's Encoding::Snappy
// payload compression (flock/src/encoding.rs:27-112, via the snap crate).
//
// Block format recap:
// * preamble: uncompressed length as little-endian varint;
// * stream of tagged elements, tag = low 2 bits of the first byte:
//   00 literal  (len-1 in tag>>2; 60..63 mean 1/2/3/4 extra length bytes)
//   01 copy     (len = 4 + ((tag>>2)&7), offset = ((tag>>5)<<8) | next byte)
//   10 copy     (len = 1 + (tag>>2), 2-byte LE offset)
//   11 copy     (len = 1 + (tag>>2), 4-byte LE offset)
//
// The compressor mirrors the classic greedy scheme: a 1<<14-entry hash table
// over 4-byte windows, emitting literals between matches and extending
// matches forward; matches ≥4 bytes, offsets ≤ 65535 (tag 11 is decoded but
// never produced — same as the canonical encoder for blocks < 4GB).
//
// ctypes contract (see flock_tpu_torch/native/__init__.py):
//   flock_snappy_max_compressed(n)            -> worst-case dst size
//   flock_snappy_compress(src, n, dst, cap)   -> compressed size or -1
//   flock_snappy_decompress(src, n, dst, cap) -> decompressed size or -1

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) { return (v * 0x1e35a7bdu) >> 18; }  // 14b

// emit a literal run [lit, lit+len)
inline int64_t emit_literal(uint8_t* dst, int64_t cap, int64_t o,
                            const uint8_t* lit, int64_t len) {
  while (len > 0) {
    int64_t n = len;  // snappy literals can carry up to 2^32; chunk at 2^24
    if (n > (1 << 24)) n = 1 << 24;
    if (n <= 60) {
      if (o + 1 + n > cap) return -1;
      dst[o++] = static_cast<uint8_t>((n - 1) << 2);
    } else if (n < (1 << 8)) {
      if (o + 2 + n > cap) return -1;
      dst[o++] = 60 << 2;
      dst[o++] = static_cast<uint8_t>(n - 1);
    } else if (n < (1 << 16)) {
      if (o + 3 + n > cap) return -1;
      dst[o++] = 61 << 2;
      dst[o++] = static_cast<uint8_t>((n - 1) & 0xff);
      dst[o++] = static_cast<uint8_t>((n - 1) >> 8);
    } else {
      if (o + 4 + n > cap) return -1;
      dst[o++] = 62 << 2;
      dst[o++] = static_cast<uint8_t>((n - 1) & 0xff);
      dst[o++] = static_cast<uint8_t>(((n - 1) >> 8) & 0xff);
      dst[o++] = static_cast<uint8_t>(((n - 1) >> 16) & 0xff);
    }
    std::memcpy(dst + o, lit, n);
    o += n;
    lit += n;
    len -= n;
  }
  return o;
}

// emit one copy element (len 4..64 per element, offset ≤ 65535)
inline int64_t emit_copy_one(uint8_t* dst, int64_t cap, int64_t o,
                             int64_t offset, int64_t len) {
  if (len >= 4 && len <= 11 && offset < 2048) {
    if (o + 2 > cap) return -1;
    dst[o++] = static_cast<uint8_t>(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    dst[o++] = static_cast<uint8_t>(offset & 0xff);
  } else {
    if (o + 3 > cap) return -1;
    dst[o++] = static_cast<uint8_t>(2 | ((len - 1) << 2));
    dst[o++] = static_cast<uint8_t>(offset & 0xff);
    dst[o++] = static_cast<uint8_t>(offset >> 8);
  }
  return o;
}

inline int64_t emit_copy(uint8_t* dst, int64_t cap, int64_t o,
                         int64_t offset, int64_t len) {
  while (len >= 68) {
    o = emit_copy_one(dst, cap, o, offset, 64);
    if (o < 0) return -1;
    len -= 64;
  }
  if (len > 64) {
    o = emit_copy_one(dst, cap, o, offset, 60);
    if (o < 0) return -1;
    len -= 60;
  }
  return emit_copy_one(dst, cap, o, offset, len);
}

}  // namespace

extern "C" {

int64_t flock_snappy_max_compressed(int64_t n) {
  // canonical bound: 32 + n + n/6
  return 32 + n + n / 6;
}

int64_t flock_snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap) {
  int64_t o = 0;
  // preamble: uncompressed length varint
  uint64_t v = static_cast<uint64_t>(n);
  while (v >= 0x80) {
    if (o >= cap) return -1;
    dst[o++] = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  if (o >= cap) return -1;
  dst[o++] = static_cast<uint8_t>(v);
  if (n == 0) return o;

  static thread_local int64_t table[1 << 14];
  for (auto& t : table) t = -1;

  int64_t i = 0, lit_start = 0;
  const int64_t limit = n - 4;
  while (i <= limit) {
    uint32_t h = hash4(load32(src + i));
    int64_t cand = table[h];
    table[h] = i;
    if (cand >= 0 && i - cand <= 65535 && load32(src + cand) == load32(src + i)) {
      // flush pending literal
      o = emit_literal(dst, cap, o, src + lit_start, i - lit_start);
      if (o < 0) return -1;
      // extend the match
      int64_t len = 4;
      while (i + len < n && src[cand + len] == src[i + len]) ++len;
      o = emit_copy(dst, cap, o, i - cand, len);
      if (o < 0) return -1;
      i += len;
      lit_start = i;
    } else {
      ++i;
    }
  }
  return emit_literal(dst, cap, o, src + lit_start, n - lit_start);
}

int64_t flock_snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                                int64_t cap) {
  int64_t i = 0;
  uint64_t out_len = 0;
  int shift = 0;
  while (true) {
    if (i >= n || shift > 63) return -1;
    uint8_t b = src[i++];
    out_len |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if (static_cast<int64_t>(out_len) > cap) return -1;
  int64_t o = 0;
  while (i < n) {
    uint8_t tag = src[i++];
    int64_t len;
    switch (tag & 3) {
      case 0: {  // literal
        len = (tag >> 2) + 1;
        if (len > 60) {
          int extra = static_cast<int>(len - 60);
          if (i + extra > n) return -1;
          len = 0;
          for (int k = 0; k < extra; ++k)
            len |= static_cast<int64_t>(src[i + k]) << (8 * k);
          len += 1;
          i += extra;
        }
        if (i + len > n || o + len > cap) return -1;
        std::memcpy(dst + o, src + i, len);
        i += len;
        o += len;
        break;
      }
      case 1: {  // copy, 1-byte offset tail
        if (i >= n) return -1;
        len = 4 + ((tag >> 2) & 7);
        int64_t off = (static_cast<int64_t>(tag >> 5) << 8) | src[i++];
        if (off <= 0 || off > o || o + len > cap) return -1;
        for (int64_t k = 0; k < len; ++k) dst[o + k] = dst[o - off + k];
        o += len;
        break;
      }
      case 2: {  // copy, 2-byte LE offset
        if (i + 2 > n) return -1;
        len = (tag >> 2) + 1;
        int64_t off = src[i] | (static_cast<int64_t>(src[i + 1]) << 8);
        i += 2;
        if (off <= 0 || off > o || o + len > cap) return -1;
        for (int64_t k = 0; k < len; ++k) dst[o + k] = dst[o - off + k];
        o += len;
        break;
      }
      default: {  // copy, 4-byte LE offset (decoded for spec completeness)
        if (i + 4 > n) return -1;
        len = (tag >> 2) + 1;
        int64_t off = 0;
        for (int k = 0; k < 4; ++k)
          off |= static_cast<int64_t>(src[i + k]) << (8 * k);
        i += 4;
        if (off <= 0 || off > o || o + len > cap) return -1;
        for (int64_t k = 0; k < len; ++k) dst[o + k] = dst[o - off + k];
        o += len;
        break;
      }
    }
  }
  return (static_cast<uint64_t>(o) == out_len) ? o : -1;
}

}  // extern "C"
