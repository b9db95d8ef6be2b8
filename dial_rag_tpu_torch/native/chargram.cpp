// Char-n-gram extraction core for the fuzzy-lexical index
// (dial_rag_tpu_torch/index/chargram.py).
//
// Replaces the Python/numpy gram-extraction hot loop: the arm carries
// ~1.5k distinct grams per 1000-char chunk, and the numpy path's global
// 50M-row lexsort measured ~400 chunks/s against the 12k chunks/s
// indexing headline. This core emits per-(chunk, gram) aggregated
// triples with a chunk-local open-addressing table, parallelized over
// chunk ranges (each chunk's output is independent).
//
// Key space (must match the numpy path in index/chargram.py exactly;
// tests/test_torch_chargram.py holds both to each other):
//   - a gram of <= 8 ASCII bytes packs LOSSLESSLY into a uint64,
//     big-endian, left-aligned (byte j << 8*(7-j)); ASCII < 0x80 means
//     the top bit of a packed key is always 0;
//   - a whole marked word "<w>" longer than 8 bytes hashes with
//     FNV-1a 64 and the TOP BIT FORCED SET, so long-word keys can never
//     collide with packed keys (two long words colliding is ~V^2/2^63
//     — negligible, and harmless: they would merely share a term id);
//   - windows never carry both boundary marks (a window is strictly
//     shorter than its marked word), so whole-word packings never
//     alias window packings of other words.
//
// Validation: word bytes must be [a-z0-9] (the chargram_words contract;
// persisted records are untrusted). Anything else returns -1 and the
// caller takes the numpy path. C ABI only, loaded with ctypes
// (dial_rag_tpu_torch/native/build.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 1469598103934665603ull;
constexpr uint64_t kFnvPrime = 1099511628211ull;
constexpr uint64_t kTopBit = 1ull << 63;

inline bool valid_byte(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
}

inline uint64_t pack(const unsigned char* b, int n) {
  uint64_t k = 0;
  for (int j = 0; j < n; ++j) {
    k |= static_cast<uint64_t>(b[j]) << (8 * (7 - j));
  }
  return k;
}

// chunk-local open-addressing (key -> count) with epoch stamping so the
// table clears in O(1) between chunks
struct LocalTable {
  std::vector<uint64_t> keys;
  std::vector<int32_t> counts;
  std::vector<uint32_t> epochs;
  std::vector<uint32_t> order;  // insertion order for deterministic output
  uint32_t epoch = 0;
  uint32_t mask = 0;

  void reset(size_t expected) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    if (cap > keys.size()) {
      keys.assign(cap, 0);
      counts.assign(cap, 0);
      epochs.assign(cap, 0);
    }
    mask = static_cast<uint32_t>(keys.size() - 1);
    ++epoch;
    order.clear();
  }

  void add(uint64_t key) {
    uint32_t slot = static_cast<uint32_t>(key ^ (key >> 29)) & mask;
    for (;;) {
      if (epochs[slot] != epoch) {
        epochs[slot] = epoch;
        keys[slot] = key;
        counts[slot] = 1;
        order.push_back(slot);
        return;
      }
      if (keys[slot] == key) {
        ++counts[slot];
        return;
      }
      slot = (slot + 1) & mask;
    }
  }
};

struct RangeOut {
  std::vector<int32_t> chunk;
  std::vector<uint64_t> key;
  std::vector<int32_t> cnt;
  bool invalid = false;
};

void run_range(const unsigned char* words, const int32_t* word_lens,
               const int64_t* word_prefix, const int64_t* byte_prefix,
               long long c0, long long c1, int n_lo, int n_hi,
               RangeOut* out) {
  LocalTable table;
  std::vector<unsigned char> marked;
  for (long long c = c0; c < c1; ++c) {
    int64_t w0 = word_prefix[c];
    int64_t w1 = word_prefix[c + 1];
    size_t expected = 16;
    for (int64_t w = w0; w < w1; ++w) {
      expected += static_cast<size_t>(word_lens[w]) + 2;
    }
    expected *= static_cast<size_t>(n_hi - n_lo + 1);
    table.reset(expected);
    const unsigned char* p = words + byte_prefix[w0];
    for (int64_t w = w0; w < w1; ++w) {
      int32_t len = word_lens[w];
      if (len < 1 || len > 1024) {
        out->invalid = true;
        return;
      }
      for (int32_t j = 0; j < len; ++j) {
        if (!valid_byte(p[j])) {
          out->invalid = true;
          return;
        }
      }
      int mlen = len + 2;
      marked.clear();
      marked.reserve(mlen);
      marked.push_back('<');
      marked.insert(marked.end(), p, p + len);
      marked.push_back('>');
      if (mlen <= 8) {
        table.add(pack(marked.data(), mlen));
      } else {
        uint64_t h = kFnvOffset;
        for (int j = 0; j < mlen; ++j) {
          h ^= marked[j];
          h *= kFnvPrime;
        }
        table.add(h | kTopBit);
      }
      for (int n = n_lo; n <= n_hi; ++n) {
        if (mlen <= n) continue;
        for (int j = 0; j + n <= mlen; ++j) {
          table.add(pack(marked.data() + j, n));
        }
      }
      p += len;
    }
    for (uint32_t slot : table.order) {
      out->chunk.push_back(static_cast<int32_t>(c));
      out->key.push_back(table.keys[slot]);
      out->cnt.push_back(table.counts[slot]);
    }
  }
}

}  // namespace

extern "C" {

// words: concatenated word bytes (no separators, no marks)
// word_lens[n_words_total], chunk_word_counts[n_chunks]
// out_chunk/out_key/out_cnt: caller-allocated, capacity out_cap
// returns number of triples written, -1 on invalid input, -2 if
// out_cap is too small (caller retries with a bigger buffer)
long long chargram_triples(
    const unsigned char* words, const int32_t* word_lens,
    long long n_words_total, const int32_t* chunk_word_counts,
    long long n_chunks, int n_lo, int n_hi, int32_t* out_chunk,
    uint64_t* out_key, int32_t* out_cnt, long long out_cap,
    int n_threads) {
  if (n_lo < 1 || n_hi > 8 || n_lo > n_hi || n_chunks < 0) return -1;
  std::vector<int64_t> word_prefix(n_chunks + 1, 0);
  for (long long c = 0; c < n_chunks; ++c) {
    word_prefix[c + 1] = word_prefix[c] + chunk_word_counts[c];
  }
  if (word_prefix[n_chunks] != n_words_total) return -1;
  std::vector<int64_t> byte_prefix(n_words_total + 1, 0);
  for (long long w = 0; w < n_words_total; ++w) {
    byte_prefix[w + 1] = byte_prefix[w] + word_lens[w];
  }

  int t = n_threads < 1 ? 1 : n_threads;
  if (t > n_chunks && n_chunks > 0) t = static_cast<int>(n_chunks);
  if (t < 1) t = 1;
  std::vector<RangeOut> outs(t);
  if (t == 1) {
    run_range(words, word_lens, word_prefix.data(), byte_prefix.data(),
              0, n_chunks, n_lo, n_hi, &outs[0]);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(t);
    for (int i = 0; i < t; ++i) {
      long long c0 = n_chunks * i / t;
      long long c1 = n_chunks * (i + 1) / t;
      threads.emplace_back(run_range, words, word_lens,
                           word_prefix.data(), byte_prefix.data(), c0, c1,
                           n_lo, n_hi, &outs[i]);
    }
    for (auto& th : threads) th.join();
  }

  long long total = 0;
  for (auto& o : outs) {
    if (o.invalid) return -1;
    total += static_cast<long long>(o.chunk.size());
  }
  if (total > out_cap) return -2;
  long long pos = 0;
  for (auto& o : outs) {
    long long n = static_cast<long long>(o.chunk.size());
    if (n == 0) continue;
    std::memcpy(out_chunk + pos, o.chunk.data(), n * sizeof(int32_t));
    std::memcpy(out_key + pos, o.key.data(), n * sizeof(uint64_t));
    std::memcpy(out_cnt + pos, o.cnt.data(), n * sizeof(int32_t));
    pos += n;
  }
  return total;
}

}  // extern "C"
