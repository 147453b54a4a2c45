// Native host core of mapreduce_tpu_torch (a copy of the JAX package's
// mapreduce_tpu/native/mr_native.cpp; the port keeps its own).
//
// The reference's native surface is external C++ (luamongo for IO,
// APRIL-ANN for matrices; SURVEY.md §2.9).  What deserves native code on
// the HOST is the tokenizer / pre-aggregator of the host plane's word
// count and the partition hash, exported with a C ABI for ctypes:
//
//   * mr_fnv1a32_batch  — batch FNV-1a over packed byte rows (the
//     partition hash, identical to utils/hashing.py fnv1a32);
//   * mr_tokenize_count — one-pass whitespace tokenizer + 64-bit
//     polynomial word hash (the device tokenizer's two 32-bit lanes,
//     h = a*h + b+1) + open-addressing aggregation into
//     (hash, first_offset, length, count) records.
//
// Build (native/__init__.py does it at first use, into the build dir):
//   g++ -O3 -shared -fPIC -std=c++17 mr_native.cpp -o mr_native-<hash>.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kA1 = 16777619u;     // FNV prime (lane 1 multiplier)
constexpr uint32_t kA2 = 0x85EBCA6Bu;   // Murmur3 constant (lane 2)

inline bool is_space(uint8_t b) {
  return b == ' ' || b == '\t' || b == '\n' || b == '\r' || b == '\f' ||
         b == '\v';
}

struct Slot {
  uint64_t hash;    // combined (h1<<32)|h2; 0 means empty (see kEmpty)
  int64_t start;    // first occurrence byte offset
  int32_t len;      // word length
  int64_t count;
};

constexpr uint64_t kEmpty = 0xFFFFFFFFFFFFFFFFull;

}  // namespace

extern "C" {

// FNV-1a (32-bit) over n rows of a packed [n, width] byte matrix with
// per-row live lengths.  Mirrors utils/hashing.py::fnv1a32.
void mr_fnv1a32_batch(const uint8_t* data, int64_t n, int64_t width,
                      const int32_t* lengths, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* row = data + i * width;
    uint32_t h = 2166136261u;
    const int32_t len = lengths[i];
    for (int32_t j = 0; j < len; ++j) {
      h ^= row[j];
      h *= kA1;
    }
    out[i] = h;
  }
}

// Tokenize `data[0:len]` on ASCII whitespace, aggregate identical words by
// their 64-bit polynomial hash.  Writes up to `capacity` unique records
// into the out_* arrays; returns the number of unique words found (which
// may exceed capacity — caller must retry with more room), or -1 on
// internal table overflow (capacity request way under the uniques).
int64_t mr_tokenize_count(const uint8_t* data, int64_t len,
                          uint64_t* out_hash, int64_t* out_start,
                          int32_t* out_len, int64_t* out_count,
                          int64_t capacity) {
  // open-addressing table, power-of-two, ~50% max load
  uint64_t table_size = 1024;
  while (table_size < (uint64_t)capacity * 2) table_size <<= 1;
  std::vector<Slot> table(table_size, Slot{kEmpty, 0, 0, 0});
  const uint64_t mask = table_size - 1;

  int64_t unique = 0;
  int64_t i = 0;
  while (i < len) {
    while (i < len && is_space(data[i])) ++i;
    if (i >= len) break;
    const int64_t start = i;
    uint32_t h1 = 0, h2 = 0;
    while (i < len && !is_space(data[i])) {
      const uint32_t b = (uint32_t)data[i] + 1u;
      h1 = h1 * kA1 + b;
      h2 = h2 * kA2 + b;
      ++i;
    }
    const int32_t wlen = (int32_t)(i - start);
    uint64_t h = ((uint64_t)h1 << 32) | (uint64_t)h2;
    if (h == kEmpty) h = 0;  // reserve the sentinel
    uint64_t slot = h & mask;
    for (;;) {
      Slot& s = table[slot];
      if (s.hash == kEmpty) {
        if ((uint64_t)unique >= table_size / 2) {
          return -1;  // table saturated: caller retries with capacity*2
        }
        s.hash = h;
        s.start = start;
        s.len = wlen;
        s.count = 1;
        ++unique;
        break;
      }
      if (s.hash == h) {
        ++s.count;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }

  int64_t written = 0;
  for (uint64_t t = 0; t < table_size && written < capacity; ++t) {
    const Slot& s = table[t];
    if (s.hash != kEmpty) {
      out_hash[written] = s.hash;
      out_start[written] = s.start;
      out_len[written] = s.len;
      out_count[written] = s.count;
      ++written;
    }
  }
  return unique;
}

}  // extern "C"
