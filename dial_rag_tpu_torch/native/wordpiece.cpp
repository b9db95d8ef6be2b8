// Fast BERT basic+WordPiece tokenizer (C core).
//
// The reference's tokenization runs inside sentence-transformers (Rust
// tokenizers); our Python implementation is exact but the per-character
// loop dominates index-build time on host. This C++ core implements the
// identical algorithm for pure-ASCII text (the overwhelming case for
// English corpora); any text containing non-ASCII bytes is rejected with
// -1 and handled by the Python implementation, keeping byte-exact parity
// (enforced by tests/test_torch_keywords.py).
//
// C ABI only, loaded with ctypes (dial_rag_tpu_torch/native/build.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int> vocab;
  int unk_id = 0;
  size_t max_word_chars = 100;
};

inline bool is_ascii_ws(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == 0x0b ||
         c == 0x0c;
}

inline bool is_ascii_control(unsigned char c) {
  // matches Python's unicodedata Cc category for ASCII minus \t\n\r,
  // plus DEL
  if (c == '\t' || c == '\n' || c == '\r') return false;
  return c < 0x20 || c == 0x7f;
}

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Greedy longest-match WordPiece for one lowercased word. Appends ids.
void wordpiece(const Tokenizer& tok, const std::string& word,
               std::vector<int>* out) {
  if (word.size() > tok.max_word_chars) {
    out->push_back(tok.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int> pieces;
  std::string buf;
  while (start < word.size()) {
    size_t end = word.size();
    int found = -1;
    while (start < end) {
      buf.clear();
      if (start > 0) buf = "##";
      buf.append(word, start, end - start);
      auto it = tok.vocab.find(buf);
      if (it != tok.vocab.end()) {
        found = it->second;
        break;
      }
      --end;
    }
    if (found < 0) {
      out->push_back(tok.unk_id);
      return;
    }
    pieces.push_back(found);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

// vocab_blob: '\n'-separated tokens, id = line index.
void* wp_create(const char* vocab_blob, int blob_len, int unk_id) {
  auto* tok = new Tokenizer();
  tok->unk_id = unk_id;
  int id = 0;
  const char* p = vocab_blob;
  const char* end = vocab_blob + blob_len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t len = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
    tok->vocab.emplace(std::string(p, len), id++);
    if (!nl) break;
    p = nl + 1;
  }
  return tok;
}

void wp_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

// Tokenize pure-ASCII text. Returns the number of ids written, or
// -1 if the text contains non-ASCII bytes (caller falls back to Python),
// or -2 if out_capacity was too small.
int wp_encode(void* handle, const char* text, int text_len, int* out_ids,
              int out_capacity) {
  const Tokenizer& tok = *static_cast<Tokenizer*>(handle);
  // reject non-ASCII up front (parity falls back to Python)
  for (int i = 0; i < text_len; ++i) {
    if (static_cast<unsigned char>(text[i]) >= 0x80) return -1;
  }

  std::vector<int> ids;
  ids.reserve(text_len / 4 + 8);
  std::string word;
  word.reserve(64);

  auto flush_word = [&]() {
    if (!word.empty()) {
      wordpiece(tok, word, &ids);
      word.clear();
    }
  };

  for (int i = 0; i < text_len; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (c == 0 || is_ascii_control(c)) continue;
    if (is_ascii_ws(c)) {
      flush_word();
      continue;
    }
    if (is_ascii_punct(c)) {
      flush_word();
      word.push_back(static_cast<char>(c));
      flush_word();
      continue;
    }
    // lowercase ASCII letters
    if (c >= 'A' && c <= 'Z') c += 32;
    word.push_back(static_cast<char>(c));
  }
  flush_word();

  if (static_cast<int>(ids.size()) > out_capacity) return -2;
  memcpy(out_ids, ids.data(), ids.size() * sizeof(int));
  return static_cast<int>(ids.size());
}

// Batch encode with CLS/SEP framing and pad fill, writing directly into
// a row-strided int32 matrix — one ctypes call per batch instead of one
// per text, and zero per-token Python objects (the per-text wp_encode
// path converts every id through a Python int, which dominates
// tokenization wall time on a single-core host).
//
// texts: concatenated UTF-8 bytes of all rows; offsets: n+1 cumulative
// byte offsets (row i = texts[offsets[i]..offsets[i+1])).
// out_ids: [n, stride] int32 (caller-allocated, any contents).
// out_lens: [n] int32 — real length incl. CLS/SEP, or -1 when the row
// contains non-ASCII bytes (the row is pad-filled; caller re-encodes it
// via the exact Python path, preserving byte parity).
// Rows truncate at stride-2 ids + SEP, matching the Python
// encode()'s ids[: max_len - 2] semantics; padding is pad_id.
void wp_encode_batch(void* handle, const char* texts, const int* offsets,
                     int n, int* out_ids, int stride, int cls_id,
                     int sep_id, int pad_id, int* out_lens) {
  const Tokenizer& tok = *static_cast<Tokenizer*>(handle);
  std::vector<int> ids;
  std::string word;
  word.reserve(64);
  for (int r = 0; r < n; ++r) {
    const char* text = texts + offsets[r];
    const int text_len = offsets[r + 1] - offsets[r];
    int* row = out_ids + static_cast<size_t>(r) * stride;
    bool ascii = true;
    for (int i = 0; i < text_len; ++i) {
      if (static_cast<unsigned char>(text[i]) >= 0x80) {
        ascii = false;
        break;
      }
    }
    if (!ascii) {
      for (int i = 0; i < stride; ++i) row[i] = pad_id;
      out_lens[r] = -1;
      continue;
    }

    ids.clear();
    word.clear();
    const size_t max_ids = static_cast<size_t>(stride) - 2;
    auto flush_word = [&]() {
      if (!word.empty()) {
        // tokenizing past the truncation point cannot change the kept
        // prefix (truncation just drops the tail), so stop early
        if (ids.size() < max_ids) wordpiece(tok, word, &ids);
        word.clear();
      }
    };
    for (int i = 0; i < text_len; ++i) {
      unsigned char c = static_cast<unsigned char>(text[i]);
      if (c == 0 || is_ascii_control(c)) continue;
      if (is_ascii_ws(c)) {
        flush_word();
        continue;
      }
      if (is_ascii_punct(c)) {
        flush_word();
        word.push_back(static_cast<char>(c));
        flush_word();
        continue;
      }
      if (c >= 'A' && c <= 'Z') c += 32;
      word.push_back(static_cast<char>(c));
    }
    flush_word();

    size_t kept = ids.size() < max_ids ? ids.size() : max_ids;
    row[0] = cls_id;
    memcpy(row + 1, ids.data(), kept * sizeof(int));
    row[kept + 1] = sep_id;
    for (size_t i = kept + 2; i < static_cast<size_t>(stride); ++i)
      row[i] = pad_id;
    out_lens[r] = static_cast<int>(kept) + 2;
  }
}

}  // extern "C"
