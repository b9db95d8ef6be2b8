// Native keyword preprocessing for the BM25 index build (C++ core).
//
// The reference's BM25 build spends its host CPU in
// nltk word_tokenize + SnowballStemmer per chunk (reference
// aidial_rag/keywords_search.py:13-18, run in the indexing CPU pool).
// This core implements the identical pipeline for pure-ASCII text:
//
//   sentence split -> Penn-Treebank word tokenization (the regex
//   cascade of nltk's TreebankWordTokenizer, hand-compiled to scanning
//   passes) -> stopword filter on the RAW token (reference quirk) ->
//   lowercase -> Snowball/Porter2 English stemming (a faithful port of
//   the published Snowball English algorithm as implemented by nltk,
//   including its r1/r2-as-string bookkeeping quirks).
//
// Any input containing a non-ASCII byte is rejected with -1 and handled
// by the Python implementation, keeping byte-exact parity (enforced by
// tests/test_torch_keywords.py, which cross-checks against the
// nltk-backed Python path over fuzzed corpora).
//
// C ABI only, loaded with ctypes (dial_rag_tpu_torch/native/build.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

std::unordered_set<std::string> g_stopwords;

inline bool is_ws(char c) {
  // matches Python's str whitespace for ASCII: \t\n\v\f\r space plus the
  // FILE/GROUP/RECORD/UNIT separators \x1c-\x1f (str.split and re \s on
  // str treat those as whitespace too)
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f' || (c >= '\x1c' && c <= '\x1f');
}

inline bool is_word_char(char c) {  // python re \w for ASCII
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

inline char lower(char c) {
  return (c >= 'A' && c <= 'Z') ? char(c - 'A' + 'a') : c;
}

// ---------------------------------------------------------------------------
// Penn Treebank tokenizer passes. Each emulates one re.sub of the nltk
// cascade with left-to-right non-overlapping match semantics.
// ---------------------------------------------------------------------------

// ^" -> ``
void starting_quote_1(std::string* s) {
  if (!s->empty() && (*s)[0] == '"') s->replace(0, 1, "``");
}

// (``) -> " `` "
void starting_quote_2(const std::string& in, std::string* out) {
  out->clear();
  size_t i = 0;
  while (i < in.size()) {
    if (i + 1 < in.size() && in[i] == '`' && in[i + 1] == '`') {
      out->append(" `` ");
      i += 2;
    } else {
      out->push_back(in[i++]);
    }
  }
}

// ([ ([{<])("|'') -> \1 ` `` `  (with trailing space)
void starting_quote_3(const std::string& in, std::string* out) {
  out->clear();
  size_t i = 0;
  while (i < in.size()) {
    char c = in[i];
    bool opener = (c == ' ' || c == '(' || c == '[' || c == '{' || c == '<');
    if (opener && i + 1 < in.size()) {
      if (in[i + 1] == '"') {
        out->push_back(c);
        out->append(" `` ");
        i += 2;
        continue;
      }
      if (i + 2 < in.size() && in[i + 1] == '\'' && in[i + 2] == '\'') {
        out->push_back(c);
        out->append(" `` ");
        i += 3;
        continue;
      }
    }
    out->push_back(c);
    i++;
  }
}

// ([:,])([^\d]) -> " \1 \2"
void punct_1(const std::string& in, std::string* out) {
  out->clear();
  size_t i = 0;
  while (i < in.size()) {
    char c = in[i];
    if ((c == ':' || c == ',') && i + 1 < in.size() && !is_digit(in[i + 1])) {
      out->push_back(' ');
      out->push_back(c);
      out->push_back(' ');
      out->push_back(in[i + 1]);
      i += 2;  // group 2 char consumed
    } else {
      out->push_back(c);
      i++;
    }
  }
}

// ([:,])$ -> " \1 "
void punct_2(std::string* s) {
  if (!s->empty()) {
    char c = s->back();
    if (c == ':' || c == ',') {
      s->pop_back();
      s->push_back(' ');
      s->push_back(c);
      s->push_back(' ');
    }
  }
}

// "..." -> " ... "
void punct_3(const std::string& in, std::string* out) {
  out->clear();
  size_t i = 0;
  while (i < in.size()) {
    if (i + 2 < in.size() && in[i] == '.' && in[i + 1] == '.' &&
        in[i + 2] == '.') {
      out->append(" ... ");
      i += 3;
    } else {
      out->push_back(in[i++]);
    }
  }
}

// [;@#$%&] -> " \0 "
void punct_4(const std::string& in, std::string* out) {
  out->clear();
  for (char c : in) {
    if (c == ';' || c == '@' || c == '#' || c == '$' || c == '%' ||
        c == '&') {
      out->push_back(' ');
      out->push_back(c);
      out->push_back(' ');
    } else {
      out->push_back(c);
    }
  }
}

// ([^.])(\.)([])}>"']*)\s*$ -> "\1 \2\3 "   (final period)
void punct_5(std::string* s) {
  if (s->empty()) return;
  // find trailing whitespace
  size_t end = s->size();
  while (end > 0 && is_ws((*s)[end - 1])) end--;
  // closers before it
  size_t closers_end = end;
  size_t p = end;
  auto is_closer = [](char c) {
    return c == ']' || c == ')' || c == '}' || c == '>' || c == '"' ||
           c == '\'';
  };
  while (p > 0 && is_closer((*s)[p - 1])) p--;
  if (p < 1 || (*s)[p - 1] != '.') return;  // need (\.)
  if (p < 2 || (*s)[p - 2] == '.') return;  // ([^.]) must exist & not '.'
  std::string closers = s->substr(p, closers_end - p);
  std::string head = s->substr(0, p - 1);  // up to and incl. group 1
  *s = head;
  s->push_back(' ');
  s->push_back('.');
  s->append(closers);
  s->push_back(' ');
}

// [?!] -> " \0 "
void punct_6(const std::string& in, std::string* out) {
  out->clear();
  for (char c : in) {
    if (c == '?' || c == '!') {
      out->push_back(' ');
      out->push_back(c);
      out->push_back(' ');
    } else {
      out->push_back(c);
    }
  }
}

// ([^'])' ( -> "\1 ' ")
void punct_7(const std::string& in, std::string* out) {
  out->clear();
  size_t i = 0;
  while (i < in.size()) {
    if (i + 2 < in.size() + 1 && in[i] != '\'' && i + 2 <= in.size() &&
        in[i + 1] == '\'' && i + 2 < in.size() && in[i + 2] == ' ') {
      out->push_back(in[i]);
      out->append(" ' ");
      i += 3;
    } else {
      out->push_back(in[i++]);
    }
  }
}

// [][(){}<>] -> " \0 "   then  -- -> " -- "
void parens_and_dashes(const std::string& in, std::string* out) {
  std::string tmp;
  tmp.reserve(in.size() * 2);
  for (char c : in) {
    if (c == '[' || c == ']' || c == '(' || c == ')' || c == '{' ||
        c == '}' || c == '<' || c == '>') {
      tmp.push_back(' ');
      tmp.push_back(c);
      tmp.push_back(' ');
    } else {
      tmp.push_back(c);
    }
  }
  out->clear();
  size_t i = 0;
  while (i < tmp.size()) {
    if (i + 1 < tmp.size() && tmp[i] == '-' && tmp[i + 1] == '-') {
      out->append(" -- ");
      i += 2;
    } else {
      out->push_back(tmp[i++]);
    }
  }
}

// '' -> " '' "  then  " -> " '' "
void ending_quote_12(const std::string& in, std::string* out) {
  std::string tmp;
  tmp.reserve(in.size() * 2);
  size_t i = 0;
  while (i < in.size()) {
    if (i + 1 < in.size() && in[i] == '\'' && in[i + 1] == '\'') {
      tmp.append(" '' ");
      i += 2;
    } else {
      tmp.push_back(in[i++]);
    }
  }
  out->clear();
  for (char c : tmp) {
    if (c == '"') {
      out->append(" '' ");
    } else {
      out->push_back(c);
    }
  }
}

// ([^' ])('[sSmMdD]|') \s -> "\1 \2 "
void ending_quote_3(const std::string& in, std::string* out) {
  out->clear();
  size_t i = 0;
  while (i < in.size()) {
    char c = in[i];
    if (c != '\'' && c != ' ' && i + 1 < in.size() && in[i + 1] == '\'') {
      // try '[sSmMdD] + space
      if (i + 3 < in.size() + 1 && i + 3 <= in.size() && i + 2 < in.size()) {
        char x = in[i + 2];
        if ((x == 's' || x == 'S' || x == 'm' || x == 'M' || x == 'd' ||
             x == 'D') &&
            i + 3 < in.size() && in[i + 3] == ' ') {
          out->push_back(c);
          out->push_back(' ');
          out->push_back('\'');
          out->push_back(x);
          out->push_back(' ');
          i += 4;
          continue;
        }
      }
      // bare ' + space
      if (i + 2 < in.size() && in[i + 2] == ' ') {
        out->push_back(c);
        out->append(" ' ");
        i += 3;
        continue;
      }
    }
    out->push_back(c);
    i++;
  }
}

// ([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) \s -> "\1 \2 "
void ending_quote_4(const std::string& in, std::string* out) {
  out->clear();
  size_t i = 0;
  auto match2 = [&](size_t pos, const char* pat) -> bool {
    return pos + 2 < in.size() + 1 && pos + 2 <= in.size() &&
           in[pos] == pat[0] && in[pos + 1] == pat[1];
  };
  while (i < in.size()) {
    char c = in[i];
    if (c != '\'' && c != ' ' && i + 3 < in.size() + 1 && i + 3 <= in.size()) {
      const char* pats2[] = {"ll", "LL", "re", "RE", "ve", "VE"};
      bool done = false;
      if (in[i + 1] == '\'') {
        for (const char* p : pats2) {
          if (match2(i + 2, p) && i + 4 < in.size() + 1 && i + 4 <= in.size() &&
              in[i + 4] == ' ') {
            out->push_back(c);
            out->push_back(' ');
            out->push_back('\'');
            out->append(p, 2);
            out->push_back(' ');
            i += 5;
            done = true;
            break;
          }
        }
      } else if ((in[i + 1] == 'n' && match2(i + 2, "'t")) ||
                 (in[i + 1] == 'N' && match2(i + 2, "'T"))) {
        if (i + 4 < in.size() + 1 && i + 4 <= in.size() && in[i + 4] == ' ') {
          out->push_back(c);
          out->push_back(' ');
          out->push_back(in[i + 1]);
          out->push_back('\'');
          out->push_back(in[i + 3]);
          out->push_back(' ');
          i += 5;
          done = true;
        }
      }
      if (done) continue;
    }
    out->push_back(c);
    i++;
  }
}

// CONTRACTIONS2 (case-insensitive, word-boundary): cannot, d'ye, gimme,
// gonna, gotta, lemme, more'n, wanna(?=\s) -> split into two tokens.
// CONTRACTIONS3: " 't is", " 't was".
struct Contraction {
  const char* whole;  // lowercase full form
  int split;          // split position within whole
  bool needs_ws_after;  // wanna uses lookahead (?=\s)
};

const Contraction kContractions2[] = {
    {"cannot", 3, false}, {"d'ye", 1, false},  {"gimme", 3, false},
    {"gonna", 3, false},  {"gotta", 3, false}, {"lemme", 3, false},
    {"more'n", 4, false}, {"wanna", 3, true},
};

inline bool word_boundary_before(const std::string& s, size_t i) {
  // \b before position i: previous char non-word (or start) and s[i] word
  if (i == 0) return true;
  return !is_word_char(s[i - 1]);
}

bool ci_match(const std::string& s, size_t pos, const char* pat) {
  size_t n = std::strlen(pat);
  if (pos + n > s.size()) return false;
  for (size_t j = 0; j < n; j++) {
    if (lower(s[pos + j]) != pat[j]) return false;
  }
  return true;
}

void contractions2(const std::string& in, std::string* out) {
  out->clear();
  size_t i = 0;
  while (i < in.size()) {
    bool matched = false;
    if (word_boundary_before(in, i)) {
      for (const auto& c : kContractions2) {
        if (!ci_match(in, i, c.whole)) continue;
        size_t n = std::strlen(c.whole);
        // trailing word boundary (or \s lookahead for wanna)
        if (c.needs_ws_after) {
          if (i + n >= in.size() || !is_ws(in[i + n])) continue;
        } else {
          if (i + n < in.size() && is_word_char(in[i + n])) continue;
          // apostrophe inside pattern is fine; boundary after last char:
          // last chars of all patterns are word chars, so boundary holds
          // iff next is non-word (checked above)
        }
        out->push_back(' ');
        out->append(in, i, c.split);
        out->push_back(' ');
        out->append(in, i + c.split, n - c.split);
        out->push_back(' ');
        i += n;
        matched = true;
        break;
      }
    }
    if (!matched) out->push_back(in[i++]);
  }
}

void contractions3(const std::string& in, std::string* out) {
  out->clear();
  size_t i = 0;
  while (i < in.size()) {
    bool matched = false;
    if (in[i] == ' ' && ci_match(in, i + 1, "'t")) {
      for (const char* tail : {"is", "was"}) {
        size_t n = std::strlen(tail);
        if (ci_match(in, i + 3, tail) &&
            (i + 3 + n >= in.size() || !is_word_char(in[i + 3 + n]))) {
          out->push_back(' ');
          out->append(in, i + 1, 2);  // 't
          out->push_back(' ');
          out->append(in, i + 3, n);
          out->push_back(' ');
          i += 3 + n;
          matched = true;
          break;
        }
      }
    }
    if (!matched) out->push_back(in[i++]);
  }
}

void treebank_tokenize(const std::string& sent, std::vector<std::string>* out) {
  std::string a = sent, b;
  starting_quote_1(&a);
  starting_quote_2(a, &b);
  starting_quote_3(b, &a);
  punct_1(a, &b);
  punct_2(&b);
  punct_3(b, &a);
  punct_4(a, &b);
  punct_5(&b);
  punct_6(b, &a);
  punct_7(a, &b);
  parens_and_dashes(b, &a);
  a = " " + a + " ";
  ending_quote_12(a, &b);
  ending_quote_3(b, &a);
  ending_quote_4(a, &b);
  contractions2(b, &a);
  contractions3(a, &b);
  // split on whitespace
  size_t i = 0;
  while (i < b.size()) {
    while (i < b.size() && is_ws(b[i])) i++;
    size_t start = i;
    while (i < b.size() && !is_ws(b[i])) i++;
    if (i > start) out->emplace_back(b, start, i - start);
  }
}

// ---------------------------------------------------------------------------
// Snowball (Porter2) English stemmer — port of the published algorithm
// as realized in nltk.stem.snowball.EnglishStemmer, including its
// r1/r2 string bookkeeping (whose edge cases, e.g. r2 becoming the
// literal "e" after an -ation rewrite, affect step 5 decisions).
// ---------------------------------------------------------------------------

inline bool is_vowel(char c) {
  return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' || c == 'y';
}

inline bool ends_with(const std::string& s, const char* suf) {
  size_t n = std::strlen(suf);
  return s.size() >= n && std::memcmp(s.data() + s.size() - n, suf, n) == 0;
}

inline void chop(std::string* s, size_t n) {
  s->resize(s->size() >= n ? s->size() - n : 0);
}

inline void suffix_replace(std::string* s, size_t old_len, const char* neu) {
  chop(s, old_len);
  s->append(neu);
}

struct SpecialWord {
  const char* from;
  const char* to;
};

const SpecialWord kSpecial[] = {
    {"skis", "ski"},        {"skies", "sky"},      {"dying", "die"},
    {"lying", "lie"},       {"tying", "tie"},      {"idly", "idl"},
    {"gently", "gentl"},    {"ugly", "ugli"},      {"early", "earli"},
    {"only", "onli"},       {"singly", "singl"},   {"sky", "sky"},
    {"news", "news"},       {"howe", "howe"},      {"atlas", "atlas"},
    {"cosmos", "cosmos"},   {"bias", "bias"},      {"andes", "andes"},
    {"inning", "inning"},   {"innings", "inning"}, {"outing", "outing"},
    {"outings", "outing"},  {"canning", "canning"}, {"cannings", "canning"},
    {"herring", "herring"}, {"herrings", "herring"}, {"earring", "earring"},
    {"earrings", "earring"}, {"proceed", "proceed"}, {"proceeds", "proceed"},
    {"proceeded", "proceed"}, {"proceeding", "proceed"},
    {"exceed", "exceed"},   {"exceeds", "exceed"}, {"exceeded", "exceed"},
    {"exceeding", "exceed"}, {"succeed", "succeed"}, {"succeeds", "succeed"},
    {"succeeded", "succeed"}, {"succeeding", "succeed"},
};

const char* kStep2[] = {"ization", "ational", "fulness", "ousness",
                        "iveness", "tional",  "biliti",  "lessli",
                        "entli",   "ation",   "alism",   "aliti",
                        "ousli",   "iviti",   "fulli",   "enci",
                        "anci",    "abli",    "izer",    "ator",
                        "alli",    "bli",     "ogi",     "li"};
const char* kStep3[] = {"ational", "tional", "alize", "icate", "iciti",
                        "ative",   "ical",   "ness",  "ful"};
const char* kStep4[] = {"ement", "ance", "ence", "able", "ible", "ment",
                        "ant",   "ent",  "ism",  "ate",  "iti",  "ous",
                        "ive",   "ize",  "ion",  "al",   "er",   "ic"};

inline bool is_double_consonant(const std::string& w) {
  static const char* kd[] = {"bb", "dd", "ff", "gg", "mm",
                             "nn", "pp", "rr", "tt"};
  for (const char* d : kd)
    if (ends_with(w, d)) return true;
  return false;
}

std::string porter2(std::string word) {
  if (word.size() <= 2) return word;

  for (const auto& sp : kSpecial) {
    if (word == sp.from) return sp.to;
  }

  if (!word.empty() && word[0] == '\'') word.erase(0, 1);
  if (!word.empty() && word[0] == 'y') word[0] = 'Y';
  for (size_t i = 1; i < word.size(); i++) {
    if (is_vowel(word[i - 1]) && word[i] == 'y') word[i] = 'Y';
  }

  std::string r1, r2;
  if (word.rfind("gener", 0) == 0 || word.rfind("commun", 0) == 0 ||
      word.rfind("arsen", 0) == 0) {
    size_t p = (word.rfind("commun", 0) == 0) ? 6 : 5;
    r1 = word.substr(p);
    for (size_t i = 1; i < r1.size(); i++) {
      if (!is_vowel(r1[i]) && is_vowel(r1[i - 1])) {
        r2 = r1.substr(i + 1);
        break;
      }
    }
  } else {
    for (size_t i = 1; i < word.size(); i++) {
      if (!is_vowel(word[i]) && is_vowel(word[i - 1])) {
        r1 = word.substr(i + 1);
        break;
      }
    }
    for (size_t i = 1; i < r1.size(); i++) {
      if (!is_vowel(r1[i]) && is_vowel(r1[i - 1])) {
        r2 = r1.substr(i + 1);
        break;
      }
    }
  }

  // STEP 0
  for (const char* suf : {"'s'", "'s", "'"}) {
    if (ends_with(word, suf)) {
      size_t n = std::strlen(suf);
      chop(&word, n);
      chop(&r1, n);
      chop(&r2, n);
      break;
    }
  }

  // STEP 1a
  bool step1a_vowel = false, step1b_vowel = false;
  for (const char* suf : {"sses", "ied", "ies", "us", "ss", "s"}) {
    if (!ends_with(word, suf)) continue;
    if (std::strcmp(suf, "sses") == 0) {
      chop(&word, 2);
      chop(&r1, 2);
      chop(&r2, 2);
    } else if (std::strcmp(suf, "ied") == 0 || std::strcmp(suf, "ies") == 0) {
      size_t n = (word.size() > std::strlen(suf) + 1) ? 2 : 1;
      // len(word[:-len(suffix)]) > 1
      if (word.size() - 3 > 1) {
        n = 2;
      } else {
        n = 1;
      }
      chop(&word, n);
      chop(&r1, n);
      chop(&r2, n);
    } else if (std::strcmp(suf, "s") == 0) {
      for (size_t i = 0; i + 2 < word.size(); i++) {
        if (is_vowel(word[i])) {
          step1a_vowel = true;
          break;
        }
      }
      if (step1a_vowel) {
        chop(&word, 1);
        chop(&r1, 1);
        chop(&r2, 1);
      }
    }
    break;  // "us"/"ss": matched but unchanged
  }

  // STEP 1b
  for (const char* suf : {"eedly", "ingly", "edly", "eed", "ing", "ed"}) {
    if (!ends_with(word, suf)) continue;
    size_t n = std::strlen(suf);
    if (std::strcmp(suf, "eed") == 0 || std::strcmp(suf, "eedly") == 0) {
      if (ends_with(r1, suf)) {
        suffix_replace(&word, n, "ee");
        if (r1.size() >= n) {
          suffix_replace(&r1, n, "ee");
        } else {
          r1.clear();
        }
        if (r2.size() >= n) {
          suffix_replace(&r2, n, "ee");
        } else {
          r2.clear();
        }
      }
    } else {
      for (size_t i = 0; i + n < word.size(); i++) {
        if (is_vowel(word[i])) {
          step1b_vowel = true;
          break;
        }
      }
      if (step1b_vowel) {
        chop(&word, n);
        chop(&r1, n);
        chop(&r2, n);
        if (ends_with(word, "at") || ends_with(word, "bl") ||
            ends_with(word, "iz")) {
          word.push_back('e');
          r1.push_back('e');
          if (word.size() > 5 || r1.size() >= 3) r2.push_back('e');
        } else if (is_double_consonant(word)) {
          chop(&word, 1);
          chop(&r1, 1);
          chop(&r2, 1);
        } else if ((r1.empty() && word.size() >= 3 &&
                    !is_vowel(word[word.size() - 1]) &&
                    word[word.size() - 1] != 'w' &&
                    word[word.size() - 1] != 'x' &&
                    word[word.size() - 1] != 'Y' &&
                    is_vowel(word[word.size() - 2]) &&
                    !is_vowel(word[word.size() - 3])) ||
                   (r1.empty() && word.size() == 2 && is_vowel(word[0]) &&
                    !is_vowel(word[1]))) {
          word.push_back('e');
          if (!r1.empty()) r1.push_back('e');
          if (!r2.empty()) r2.push_back('e');
        }
      }
    }
    break;
  }

  // STEP 1c
  if (word.size() > 2 &&
      (word[word.size() - 1] == 'y' || word[word.size() - 1] == 'Y') &&
      !is_vowel(word[word.size() - 2])) {
    word[word.size() - 1] = 'i';
    if (!r1.empty()) {
      r1[r1.size() - 1] = 'i';
    }
    if (!r2.empty()) {
      r2[r2.size() - 1] = 'i';
    }
  }

  // STEP 2
  for (const char* suf : kStep2) {
    if (!ends_with(word, suf)) continue;
    size_t n = std::strlen(suf);
    if (ends_with(r1, suf)) {
      if (std::strcmp(suf, "tional") == 0) {
        chop(&word, 2);
        chop(&r1, 2);
        chop(&r2, 2);
      } else if (std::strcmp(suf, "enci") == 0 ||
                 std::strcmp(suf, "anci") == 0 ||
                 std::strcmp(suf, "abli") == 0) {
        word[word.size() - 1] = 'e';
        if (!r1.empty()) {
          r1[r1.size() - 1] = 'e';
        }
        if (!r2.empty()) {
          r2[r2.size() - 1] = 'e';
        }
      } else if (std::strcmp(suf, "entli") == 0) {
        chop(&word, 2);
        chop(&r1, 2);
        chop(&r2, 2);
      } else if (std::strcmp(suf, "izer") == 0 ||
                 std::strcmp(suf, "ization") == 0) {
        suffix_replace(&word, n, "ize");
        if (r1.size() >= n) {
          suffix_replace(&r1, n, "ize");
        } else {
          r1.clear();
        }
        if (r2.size() >= n) {
          suffix_replace(&r2, n, "ize");
        } else {
          r2.clear();
        }
      } else if (std::strcmp(suf, "ational") == 0 ||
                 std::strcmp(suf, "ation") == 0 ||
                 std::strcmp(suf, "ator") == 0) {
        suffix_replace(&word, n, "ate");
        if (r1.size() >= n) {
          suffix_replace(&r1, n, "ate");
        } else {
          r1.clear();
        }
        if (r2.size() >= n) {
          suffix_replace(&r2, n, "ate");
        } else {
          r2 = "e";
        }
      } else if (std::strcmp(suf, "alism") == 0 ||
                 std::strcmp(suf, "aliti") == 0 ||
                 std::strcmp(suf, "alli") == 0) {
        suffix_replace(&word, n, "al");
        if (r1.size() >= n) {
          suffix_replace(&r1, n, "al");
        } else {
          r1.clear();
        }
        if (r2.size() >= n) {
          suffix_replace(&r2, n, "al");
        } else {
          r2.clear();
        }
      } else if (std::strcmp(suf, "fulness") == 0) {
        chop(&word, 4);
        chop(&r1, 4);
        chop(&r2, 4);
      } else if (std::strcmp(suf, "ousli") == 0 ||
                 std::strcmp(suf, "ousness") == 0) {
        suffix_replace(&word, n, "ous");
        if (r1.size() >= n) {
          suffix_replace(&r1, n, "ous");
        } else {
          r1.clear();
        }
        if (r2.size() >= n) {
          suffix_replace(&r2, n, "ous");
        } else {
          r2.clear();
        }
      } else if (std::strcmp(suf, "iveness") == 0 ||
                 std::strcmp(suf, "iviti") == 0) {
        suffix_replace(&word, n, "ive");
        if (r1.size() >= n) {
          suffix_replace(&r1, n, "ive");
        } else {
          r1.clear();
        }
        if (r2.size() >= n) {
          suffix_replace(&r2, n, "ive");
        } else {
          r2 = "e";
        }
      } else if (std::strcmp(suf, "biliti") == 0 ||
                 std::strcmp(suf, "bli") == 0) {
        suffix_replace(&word, n, "ble");
        if (r1.size() >= n) {
          suffix_replace(&r1, n, "ble");
        } else {
          r1.clear();
        }
        if (r2.size() >= n) {
          suffix_replace(&r2, n, "ble");
        } else {
          r2.clear();
        }
      } else if (std::strcmp(suf, "ogi") == 0) {
        if (word.size() >= 4 && word[word.size() - 4] == 'l') {
          chop(&word, 1);
          chop(&r1, 1);
          chop(&r2, 1);
        }
      } else if (std::strcmp(suf, "fulli") == 0 ||
                 std::strcmp(suf, "lessli") == 0) {
        chop(&word, 2);
        chop(&r1, 2);
        chop(&r2, 2);
      } else if (std::strcmp(suf, "li") == 0) {
        if (word.size() >= 3) {
          char c = word[word.size() - 3];
          static const char* li_ending = "cdeghkmnrt";
          if (std::strchr(li_ending, c) != nullptr) {
            chop(&word, 2);
            chop(&r1, 2);
            chop(&r2, 2);
          }
        }
      }
    }
    break;
  }

  // STEP 3
  for (const char* suf : kStep3) {
    if (!ends_with(word, suf)) continue;
    size_t n = std::strlen(suf);
    if (ends_with(r1, suf)) {
      if (std::strcmp(suf, "tional") == 0) {
        chop(&word, 2);
        chop(&r1, 2);
        chop(&r2, 2);
      } else if (std::strcmp(suf, "ational") == 0) {
        suffix_replace(&word, n, "ate");
        if (r1.size() >= n) {
          suffix_replace(&r1, n, "ate");
        } else {
          r1.clear();
        }
        if (r2.size() >= n) {
          suffix_replace(&r2, n, "ate");
        } else {
          r2.clear();
        }
      } else if (std::strcmp(suf, "alize") == 0) {
        chop(&word, 3);
        chop(&r1, 3);
        chop(&r2, 3);
      } else if (std::strcmp(suf, "icate") == 0 ||
                 std::strcmp(suf, "iciti") == 0 ||
                 std::strcmp(suf, "ical") == 0) {
        suffix_replace(&word, n, "ic");
        if (r1.size() >= n) {
          suffix_replace(&r1, n, "ic");
        } else {
          r1.clear();
        }
        if (r2.size() >= n) {
          suffix_replace(&r2, n, "ic");
        } else {
          r2.clear();
        }
      } else if (std::strcmp(suf, "ful") == 0 ||
                 std::strcmp(suf, "ness") == 0) {
        chop(&word, n);
        chop(&r1, n);
        chop(&r2, n);
      } else if (std::strcmp(suf, "ative") == 0) {
        if (ends_with(r2, suf)) {
          chop(&word, 5);
          chop(&r1, 5);
          chop(&r2, 5);
        }
      }
    }
    break;
  }

  // STEP 4
  for (const char* suf : kStep4) {
    if (!ends_with(word, suf)) continue;
    size_t n = std::strlen(suf);
    if (ends_with(r2, suf)) {
      if (std::strcmp(suf, "ion") == 0) {
        if (word.size() >= 4 &&
            (word[word.size() - 4] == 's' || word[word.size() - 4] == 't')) {
          chop(&word, 3);
          chop(&r1, 3);
          chop(&r2, 3);
        }
      } else {
        chop(&word, n);
        chop(&r1, n);
        chop(&r2, n);
      }
    }
    break;
  }

  // STEP 5
  if (ends_with(r2, "l") && word.size() >= 2 &&
      word[word.size() - 2] == 'l') {
    chop(&word, 1);
  } else if (ends_with(r2, "e")) {
    chop(&word, 1);
  } else if (ends_with(r1, "e")) {
    if (word.size() >= 4 &&
        (is_vowel(word[word.size() - 2]) || word[word.size() - 2] == 'w' ||
         word[word.size() - 2] == 'x' || word[word.size() - 2] == 'Y' ||
         !is_vowel(word[word.size() - 3]) ||
         is_vowel(word[word.size() - 4]))) {
      chop(&word, 1);
    }
  }

  for (char& c : word) {
    if (c == 'Y') c = 'y';
  }
  return word;
}

}  // namespace

extern "C" {

// Register the stopword list: newline-separated raw tokens.
void kw_set_stopwords(const char* data, int32_t len) {
  g_stopwords.clear();
  const char* end = data + len;
  const char* p = data;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (nl == nullptr) nl = end;
    if (nl > p) g_stopwords.emplace(p, nl - p);
    p = nl + 1;
  }
}

// Full pipeline: sentence split -> treebank tokenize -> stopword filter
// (raw token) -> lowercase+stem. Output: '\n'-joined stems written to
// out (capacity out_cap). Returns bytes written, -1 for non-ASCII input
// (caller falls back to Python), -2 if out_cap is too small.
int32_t kw_preprocess(const char* text, int32_t len, char* out,
                      int32_t out_cap) {
  for (int32_t i = 0; i < len; i++) {
    if (static_cast<unsigned char>(text[i]) >= 0x80) return -1;
  }
  std::string input(text, len);

  // sentence split: (?<=[.!?])\s+
  std::vector<std::string> sentences;
  size_t start = 0;
  size_t i = 0;
  while (i < input.size()) {
    if ((input[i] == '.' || input[i] == '!' || input[i] == '?') &&
        i + 1 < input.size() && is_ws(input[i + 1])) {
      sentences.emplace_back(input, start, i + 1 - start);
      i++;
      while (i < input.size() && is_ws(input[i])) i++;
      start = i;
    } else {
      i++;
    }
  }
  if (start < input.size()) sentences.emplace_back(input, start);

  std::vector<std::string> tokens;
  for (const auto& sent : sentences) {
    treebank_tokenize(sent, &tokens);
  }

  std::string result;
  result.reserve(len);
  for (auto& tok : tokens) {
    if (g_stopwords.count(tok)) continue;
    for (char& c : tok) c = lower(c);
    std::string stem = porter2(std::move(tok));
    result.append(stem);
    result.push_back('\n');
  }
  if (static_cast<int32_t>(result.size()) > out_cap) return -2;
  std::memcpy(out, result.data(), result.size());
  return static_cast<int32_t>(result.size());
}

}  // extern "C"
