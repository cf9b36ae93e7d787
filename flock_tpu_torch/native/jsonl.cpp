// Copy of flock_tpu/native/jsonl.cpp, kept in the PyTorch port so that the
// port imports nothing of flock_tpu.  Keep the two files identical below.
//
// Native line-JSON -> columnar parser for all-integer rows (the ingestion
// hot loop).  Reference counterpart: flock's event_bytes_to_batch feeds
// line-delimited JSON through Arrow's native json::Reader
// (flock/src/transmute.rs:255-266, kafka.rs:100-110); this is the same
// C-speed decode for the TPU engine's external fragment streams.
//
// Contract (ctypes, see flock_tpu_torch/native/__init__.py):
//   flock_jsonl_parse_ints(buf, len, keys, n_keys, out, max_rows) -> rows
// * buf/len       — newline-delimited JSON objects (UTF-8)
// * keys/n_keys   — '\n'-joined field names whose values must be integers
// * out           — column-major int64 [n_keys][max_rows]
// * returns rows parsed, or a negative error code when any line is not a
//   flat object with integer values for every requested key (callers fall
//   back to the Python parser — e.g. rows with nested values).
// String-valued fields that are NOT requested are skipped correctly
// (escape-aware), so mixed schemas parse as long as the requested keys are
// integers.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Cursor {
  const char* p;
  const char* end;
  bool eof() const { return p >= end; }
  char peek() const { return *p; }
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  }
};

// Scan a JSON string starting AFTER the opening quote; returns false on
// unterminated strings.  start/len capture the raw (unescaped) bytes.
bool scan_string(Cursor& c, const char** start, int64_t* len) {
  *start = c.p;
  while (!c.eof()) {
    char ch = *c.p;
    if (ch == '\\') {
      c.p += 2;
      continue;
    }
    if (ch == '"') {
      *len = c.p - *start;
      ++c.p;
      return true;
    }
    ++c.p;
  }
  return false;
}

bool parse_int(Cursor& c, int64_t* out) {
  bool neg = false;
  if (!c.eof() && *c.p == '-') {
    neg = true;
    ++c.p;
  }
  if (c.eof() || *c.p < '0' || *c.p > '9') return false;
  int64_t v = 0;
  while (!c.eof() && *c.p >= '0' && *c.p <= '9') {
    int digit = *c.p - '0';
    // reject digit runs that would wrap int64 (callers fall back to Python,
    // which parses arbitrary-precision ints and raises its own error)
    if (v > (INT64_MAX - digit) / 10) return false;
    v = v * 10 + digit;
    ++c.p;
  }
  *out = neg ? -v : v;
  return true;
}

}  // namespace

extern "C" int64_t flock_jsonl_parse_ints(const char* buf, int64_t len,
                                          const char* keys, int64_t n_keys,
                                          int64_t* out, int64_t max_rows) {
  std::vector<std::string> names;
  {
    const char* k = keys;
    const char* kend = keys + std::strlen(keys);
    while (k < kend) {
      const char* nl = static_cast<const char*>(
          std::memchr(k, '\n', kend - k));
      if (!nl) nl = kend;
      names.emplace_back(k, nl - k);
      k = nl + 1;
    }
  }
  if (static_cast<int64_t>(names.size()) != n_keys) return -1;

  int64_t row = 0;
  const char* line = buf;
  const char* bend = buf + len;
  std::vector<char> found(n_keys);
  while (line < bend) {
    const char* nl = static_cast<const char*>(
        std::memchr(line, '\n', bend - line));
    if (!nl) nl = bend;
    Cursor c{line, nl};
    line = nl + 1;
    c.skip_ws();
    if (c.eof()) continue;  // blank line
    if (row >= max_rows) return -2;
    if (c.peek() != '{') return -3;
    ++c.p;
    std::fill(found.begin(), found.end(), 0);
    bool line_ok = true;
    while (line_ok) {
      c.skip_ws();
      if (!c.eof() && c.peek() == '}') break;
      if (c.eof() || c.peek() != '"') {
        line_ok = false;
        break;
      }
      ++c.p;
      const char* kstart;
      int64_t klen;
      if (!scan_string(c, &kstart, &klen)) {
        line_ok = false;
        break;
      }
      c.skip_ws();
      if (c.eof() || c.peek() != ':') {
        line_ok = false;
        break;
      }
      ++c.p;
      c.skip_ws();
      int which = -1;
      for (int64_t i = 0; i < n_keys; ++i) {
        if (static_cast<int64_t>(names[i].size()) == klen &&
            std::memcmp(names[i].data(), kstart, klen) == 0) {
          which = static_cast<int>(i);
          break;
        }
      }
      if (c.eof()) {
        line_ok = false;
        break;
      }
      char v0 = c.peek();
      if (which >= 0) {
        int64_t v;
        if (!parse_int(c, &v)) {
          line_ok = false;  // requested key is not an integer
          break;
        }
        out[which * max_rows + row] = v;
        found[which] = 1;
      } else if (v0 == '"') {
        ++c.p;
        const char* s;
        int64_t sl;
        if (!scan_string(c, &s, &sl)) {
          line_ok = false;
          break;
        }
      } else if (v0 == '-' || (v0 >= '0' && v0 <= '9')) {
        // unrequested number (incl. floats): skip the token
        while (!c.eof() && *c.p != ',' && *c.p != '}') ++c.p;
      } else if (c.end - c.p >= 4 && std::strncmp(c.p, "true", 4) == 0) {
        c.p += 4;
      } else if (c.end - c.p >= 5 && std::strncmp(c.p, "false", 5) == 0) {
        c.p += 5;
      } else if (c.end - c.p >= 4 && std::strncmp(c.p, "null", 4) == 0) {
        c.p += 4;
      } else {
        line_ok = false;  // nested object/array → Python fallback
        break;
      }
      c.skip_ws();
      if (!c.eof() && c.peek() == ',') ++c.p;
    }
    if (!line_ok) return -4;
    for (int64_t i = 0; i < n_keys; ++i)
      if (!found[i]) return -5;  // missing requested key
    ++row;
  }
  return row;
}
