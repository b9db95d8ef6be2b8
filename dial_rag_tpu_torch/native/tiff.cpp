// TIFF strip decoders, the host core of the port's TIFF documents (page
// images are drawn without PIL, which the card's machine lacks).
//
// Each entry point decodes one strip or tile, its bytes already in
// most-significant-bit-first order (the caller reverses them for
// FillOrder 2), as libtiff decodes it for Pillow:
//   - LZW (compression 5): codes of 9 to 12 bits, most significant bit
//     first, the width growing one code early (at 511, 1023, 2047), Clear
//     256 and EndOfInformation 257; and the old-style bit order libtiff
//     also accepts (a stream that starts with a zero byte and an odd
//     second byte): least significant bit first, the width growing at 512;
//   - PackBits (32773);
//   - CCITT (2, 3 and 4): Modified Huffman runs with each row on a byte
//     boundary (2, "CCITT RLE"), Group 3 rows each after an EOL, one-
//     dimensional or, with T4Options bit 0, two-dimensional after a tag
//     bit (3), and Group 4 rows, all two-dimensional (4); the first row of
//     a strip refers to an all-white row. Rows come out packed, most
//     significant bit first, a black pixel a 1 bit (libtiff's convention,
//     which the photometric interpretation then reads).
//
// C interface (ctypes, native/build.py):
//   long long dial_tiff_lzw(data, n, out, out_len)
//     -> bytes written (the stream may end sooner), or -1 for a code the
//        table does not hold
//   long long dial_tiff_packbits(data, n, out, out_len) -> bytes written
//   long long dial_tiff_ccitt(data, n, compression, t4_options, width, rows, out, out_len)
//     -> rows decoded, or -1 for a code no table holds

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// -- LZW ------------------------------------------------------------------------

long long lzw(const uint8_t* data, long long n, uint8_t* out, long long out_len) {
  const bool old_style = n >= 2 && data[0] == 0 && (data[1] & 1);
  constexpr int kClear = 256, kEoi = 257, kMax = 4096;
  std::vector<int16_t> prefix(kMax);
  std::vector<uint8_t> suffix(kMax), first(kMax);
  std::vector<int32_t> length(kMax);
  for (int c = 0; c < 256; c++) {
    prefix[c] = -1;
    suffix[c] = first[c] = uint8_t(c);
    length[c] = 1;
  }
  int width = 9, next = 258, previous = -1;
  uint64_t bits = 0;
  int nbits = 0;
  long long pos = 0, written = 0;
  // the code count at which the width grows: one early in the new style
  auto grow_at = [&](int w) { return (1 << w) - (old_style ? 0 : 1); };
  while (written < out_len) {
    while (nbits < width && pos < n) {
      if (old_style) {
        bits |= uint64_t(data[pos++]) << nbits;
      } else {
        bits = (bits << 8) | data[pos++];
      }
      nbits += 8;
    }
    if (nbits < width) break;
    int code;
    if (old_style) {
      code = int(bits & ((1u << width) - 1));
      bits >>= width;
    } else {
      code = int((bits >> (nbits - width)) & ((1u << width) - 1));
    }
    nbits -= width;
    if (!old_style) bits &= (uint64_t(1) << nbits) - 1;
    if (code == kClear) {
      width = 9;
      next = 258;
      previous = -1;
      continue;
    }
    if (code == kEoi) break;
    if (previous < 0) {
      if (code >= 256) return -1;
    } else if (next < kMax) {
      if (code > next) return -1;
      const int head = code == next ? previous : code;
      prefix[next] = int16_t(previous);
      suffix[next] = first[head];
      first[next] = first[previous];
      length[next] = length[previous] + 1;
      next++;
      if (next >= grow_at(width) && width < 12) width++;
    } else if (code >= next) {
      return -1;
    }
    const long long len = length[code];
    const long long keep = len < out_len - written ? len : out_len - written;
    int c = code;
    for (long long i = len - 1; i >= 0; i--) {
      if (i < keep) out[written + i] = suffix[c];
      c = prefix[c];
    }
    written += keep;
    previous = code;
  }
  return written;
}

// -- PackBits -------------------------------------------------------------------

long long packbits(const uint8_t* data, long long n, uint8_t* out, long long out_len) {
  long long pos = 0, written = 0;
  while (pos < n && written < out_len) {
    const int8_t header = int8_t(data[pos++]);
    if (header >= 0) {
      long long count = header + 1;
      if (count > n - pos) count = n - pos;
      if (count > out_len - written) count = out_len - written;
      std::memcpy(out + written, data + pos, size_t(count));
      pos += header + 1;
      written += count;
    } else if (header != -128) {
      if (pos >= n) break;
      long long count = 1 - header;
      if (count > out_len - written) count = out_len - written;
      std::memset(out + written, data[pos++], size_t(count));
      written += count;
    }
  }
  return written;
}

// -- CCITT ----------------------------------------------------------------------

// (code, run length) of ITU-T T.4's Modified Huffman tables
struct Code {
  const char* bits;
  int value;
};

const Code kWhite[] = {
    {"00110101", 0},     {"000111", 1},       {"0111", 2},         {"1000", 3},         {"1011", 4},
    {"1100", 5},         {"1110", 6},         {"1111", 7},         {"10011", 8},        {"10100", 9},
    {"00111", 10},       {"01000", 11},       {"001000", 12},      {"000011", 13},      {"110100", 14},
    {"110101", 15},      {"101010", 16},      {"101011", 17},      {"0100111", 18},     {"0001100", 19},
    {"0001000", 20},     {"0010111", 21},     {"0000011", 22},     {"0000100", 23},     {"0101000", 24},
    {"0101011", 25},     {"0010011", 26},     {"0100100", 27},     {"0011000", 28},     {"00000010", 29},
    {"00000011", 30},    {"00011010", 31},    {"00011011", 32},    {"00010010", 33},    {"00010011", 34},
    {"00010100", 35},    {"00010101", 36},    {"00010110", 37},    {"00010111", 38},    {"00101000", 39},
    {"00101001", 40},    {"00101010", 41},    {"00101011", 42},    {"00101100", 43},    {"00101101", 44},
    {"00000100", 45},    {"00000101", 46},    {"00001010", 47},    {"00001011", 48},    {"01010010", 49},
    {"01010011", 50},    {"01010100", 51},    {"01010101", 52},    {"00100100", 53},    {"00100101", 54},
    {"01011000", 55},    {"01011001", 56},    {"01011010", 57},    {"01011011", 58},    {"01001010", 59},
    {"01001011", 60},    {"00110010", 61},    {"00110011", 62},    {"00110100", 63},    {"11011", 64},
    {"10010", 128},      {"010111", 192},     {"0110111", 256},    {"00110110", 320},   {"00110111", 384},
    {"01100100", 448},   {"01100101", 512},   {"01101000", 576},   {"01100111", 640},   {"011001100", 704},
    {"011001101", 768},  {"011010010", 832},  {"011010011", 896},  {"011010100", 960},  {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664},
    {"010011011", 1728}};

const Code kBlack[] = {
    {"0000110111", 0},     {"010", 1},            {"11", 2},             {"10", 3},
    {"011", 4},            {"0011", 5},           {"0010", 6},           {"00011", 7},
    {"000101", 8},         {"000100", 9},         {"0000100", 10},       {"0000101", 11},
    {"0000111", 12},       {"00000100", 13},      {"00000111", 14},      {"000011000", 15},
    {"0000010111", 16},    {"0000011000", 17},    {"0000001000", 18},    {"00001100111", 19},
    {"00001101000", 20},   {"00001101100", 21},   {"00000110111", 22},   {"00000101000", 23},
    {"00000010111", 24},   {"00000011000", 25},   {"000011001010", 26},  {"000011001011", 27},
    {"000011001100", 28},  {"000011001101", 29},  {"000001101000", 30},  {"000001101001", 31},
    {"000001101010", 32},  {"000001101011", 33},  {"000011010010", 34},  {"000011010011", 35},
    {"000011010100", 36},  {"000011010101", 37},  {"000011010110", 38},  {"000011010111", 39},
    {"000001101100", 40},  {"000001101101", 41},  {"000011011010", 42},  {"000011011011", 43},
    {"000001010100", 44},  {"000001010101", 45},  {"000001010110", 46},  {"000001010111", 47},
    {"000001100100", 48},  {"000001100101", 49},  {"000001010010", 50},  {"000001010011", 51},
    {"000000100100", 52},  {"000000110111", 53},  {"000000111000", 54},  {"000000100111", 55},
    {"000000101000", 56},  {"000001011000", 57},  {"000001011001", 58},  {"000000101011", 59},
    {"000000101100", 60},  {"000001011010", 61},  {"000001100110", 62},  {"000001100111", 63},
    {"0000001111", 64},    {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512},
    {"0000001101101", 576},  {"0000001001010", 640},  {"0000001001011", 704},  {"0000001001100", 768},
    {"0000001001101", 832},  {"0000001110010", 896},  {"0000001110011", 960},  {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728}};

// the makeup codes both colours share
const Code kExtended[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},  {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

// two-dimensional modes
enum { kPass = 100, kHorizontal, kV0, kVR1, kVR2, kVR3, kVL1, kVL2, kVL3 };
const Code kModes[] = {{"0001", kPass}, {"001", kHorizontal}, {"1", kV0},        {"011", kVR1},
                       {"000011", kVR2}, {"0000011", kVR3},  {"010", kVL1},     {"000010", kVL2},
                       {"0000010", kVL3}};

constexpr int kPeek = 13;  // the longest code

// a table of 2^13 entries: (code length << 16) | value, 0 where no code starts
struct Table {
  std::vector<uint32_t> entry = std::vector<uint32_t>(1 << kPeek, 0);
  void add(const Code* codes, size_t count) {
    for (size_t i = 0; i < count; i++) {
      const int len = int(std::strlen(codes[i].bits));
      uint32_t code = 0;
      for (int k = 0; k < len; k++) code = code << 1 | uint32_t(codes[i].bits[k] == '1');
      const uint32_t lo = code << (kPeek - len), hi = (code + 1) << (kPeek - len);
      for (uint32_t j = lo; j < hi; j++) entry[j] = uint32_t(len) << 16 | uint32_t(codes[i].value);
    }
  }
};

const Table& white_table() {
  static const Table t = [] {
    Table x;
    x.add(kWhite, sizeof(kWhite) / sizeof(Code));
    x.add(kExtended, sizeof(kExtended) / sizeof(Code));
    return x;
  }();
  return t;
}

const Table& black_table() {
  static const Table t = [] {
    Table x;
    x.add(kBlack, sizeof(kBlack) / sizeof(Code));
    x.add(kExtended, sizeof(kExtended) / sizeof(Code));
    return x;
  }();
  return t;
}

const Table& mode_table() {
  static const Table t = [] {
    Table x;
    x.add(kModes, sizeof(kModes) / sizeof(Code));
    return x;
  }();
  return t;
}

struct Bits {
  const uint8_t* data;
  long long n;
  long long pos = 0;  // in bits
  // libtiff's bit accumulator, kept for CCITT RLE rows: the bytes loaded
  // and the bits it counts as available, which at the end of the data it
  // pads to what a lookup needs (NeedBits16)
  bool track = false;
  long long loaded = 0;
  int avail = 0;
  void need(int count) {
    if (!track || avail >= count) return;
    if (loaded >= n) {
      if (avail) avail = count;
      return;
    }
    loaded++;
    avail += 8;
    if (avail < count) {
      if (loaded >= n) {
        avail = count;
      } else {
        loaded++;
        avail += 8;
      }
    }
  }
  // the end of a row of CCITT RLE: libtiff drops the accumulator's bits
  // past the last whole byte it counts, padding included, so a row after
  // the data ran out within a lookup starts late, as libtiff reads it
  void align_rle() {
    const int skip = avail & 7;
    pos += skip;
    avail -= skip;
  }
  // the next ``count`` (at most 13) bits, zeros past the end
  int peek(int count) const {
    const long long at = pos >> 3;
    uint32_t w = 0;
    for (int k = 0; k < 3; k++) w = w << 8 | (at + k < n ? data[at + k] : 0u);
    return int((w >> (24 - int(pos & 7) - count)) & ((1u << count) - 1));
  }
  bool done() const { return pos >= n * 8; }
  void skip(int count) {
    pos += count;
    avail -= count;
  }
};

// one code of ``table``: its value, or -1 (no code), or -2 (the end of the data)
int read_code(Bits& br, const Table& table) {
  if (br.track ? br.avail <= 0 : br.done()) return -2;
  const uint32_t e = table.entry[size_t(br.peek(kPeek))];
  if (!e) return -1;
  br.skip(int(e >> 16));
  return int(e & 0xFFFF);
}

// a run: makeup codes then a terminating code
int read_run(Bits& br, bool black) {
  const Table& table = black ? black_table() : white_table();
  int run = 0;
  for (;;) {
    br.need(black ? 13 : 12);
    const int v = read_code(br, table);
    if (v < 0) return v;
    run += v;
    if (v < 64) return run;
  }
}

// skips to past the next EOL (eleven or more zero bits, then a one); false at the end
bool sync_eol(Bits& br) {
  for (;;) {
    if (br.pos + 12 > br.n * 8) return false;
    if (br.peek(11) == 0) break;
    br.skip(1);
  }
  br.skip(11);
  while (!br.done() && br.peek(1) == 0) br.skip(1);
  if (br.done()) return false;
  br.skip(1);
  return true;
}

// a one-dimensional row into changing elements (positions where the colour flips)
bool row_1d(Bits& br, int width, std::vector<int>& changes) {
  changes.clear();
  int a0 = 0;
  bool black = false;
  while (a0 < width) {
    const int run = read_run(br, black);
    if (run == -1 && br.track) {
      // libtiff ends a CCITT RLE row at an EOL (its twelve zero bits) or a
      // code no table holds, and fills the rest of the row white
      if (br.peek(12) == 0) br.skip(12);
      if (black) changes.push_back(a0);
      changes.push_back(width);
      return true;
    }
    if (run < 0) return false;
    a0 += run;
    if (a0 > width) a0 = width;
    changes.push_back(a0);
    black = !black;
  }
  return true;
}

// a two-dimensional row against the reference row's changing elements
bool row_2d(Bits& br, int width, const std::vector<int>& ref, std::vector<int>& changes) {
  changes.clear();
  int a0 = -1;
  bool black = false;
  size_t i = 0;  // the first reference element that can be b1
  auto b1_index = [&]() {
    // b1: the first changing element past a0 of the colour opposite to a0's
    // (an even index flips white to black)
    size_t k = i;
    while (k < ref.size() && (ref[k] <= a0 || (k & 1) != (black ? 1u : 0u))) k++;
    return k;
  };
  while (a0 < width) {
    const int mode = read_code(br, mode_table());
    if (mode < 0) return false;
    const size_t k = b1_index();
    const int b1 = k < ref.size() ? ref[k] : width;
    const int b2 = k + 1 < ref.size() ? ref[k + 1] : width;
    if (mode == kPass) {
      a0 = b2;
      i = k;
      continue;
    }
    if (mode == kHorizontal) {
      const int start = a0 < 0 ? 0 : a0;
      const int r1 = read_run(br, black);
      if (r1 < 0) return false;
      const int r2 = read_run(br, !black);
      if (r2 < 0) return false;
      int a1 = start + r1, a2 = a1 + r2;
      if (a1 > width) a1 = width;
      if (a2 > width) a2 = width;
      changes.push_back(a1);
      changes.push_back(a2);
      a0 = a2;
      continue;
    }
    const int delta = mode == kV0 ? 0 : mode == kVR1 ? 1 : mode == kVR2 ? 2 : mode == kVR3 ? 3
                      : mode == kVL1 ? -1 : mode == kVL2 ? -2 : -3;
    int a1 = b1 + delta;
    if (a1 < 0 || a1 < a0) return false;
    if (a1 > width) a1 = width;
    changes.push_back(a1);
    a0 = a1;
    black = !black;
    i = k > 0 ? k - 1 : 0;
  }
  return true;
}

void fill_row(const std::vector<int>& changes, int width, uint8_t* row) {
  std::memset(row, 0, size_t((width + 7) / 8));
  int at = 0;
  bool black = false;
  for (int c : changes) {
    const int end = c < width ? c : width;
    if (black) {
      for (int x = at; x < end; x++) row[x >> 3] |= uint8_t(0x80 >> (x & 7));
    }
    if (end > at) at = end;
    black = !black;
  }
}

long long ccitt(const uint8_t* data, long long n, int compression, int t4_options, int width, int rows,
                uint8_t* out, long long out_len) {
  const long long stride = (width + 7) / 8;
  if (width <= 0 || rows < 0 || stride * rows > out_len) return -1;
  Bits br{data, n};
  br.track = compression == 2;
  std::vector<int> ref{width, width}, cur;
  const bool two_d_g3 = compression == 3 && (t4_options & 1);
  for (int y = 0; y < rows; y++) {
    bool ok;
    if (compression == 2) {
      ok = row_1d(br, width, cur);
      br.align_rle();
    } else if (compression == 3) {
      if (!sync_eol(br)) return y;
      bool one_d = true;
      if (two_d_g3) {
        one_d = br.peek(1) == 1;
        br.skip(1);
      }
      ok = one_d ? row_1d(br, width, cur) : row_2d(br, width, ref, cur);
    } else {
      ok = row_2d(br, width, ref, cur);
    }
    if (!ok) return y == 0 ? -1 : y;
    fill_row(cur, width, out + stride * y);
    ref = cur;
    ref.push_back(width);
    ref.push_back(width);
  }
  return rows;
}

}  // namespace

extern "C" {

// no exception crosses the C interface (an allocation that fails)
long long dial_tiff_lzw(const uint8_t* data, long long n, uint8_t* out, long long out_len) {
  try {
    return lzw(data, n, out, out_len);
  } catch (...) {
    return -1;
  }
}

long long dial_tiff_packbits(const uint8_t* data, long long n, uint8_t* out, long long out_len) {
  return packbits(data, n, out, out_len);
}

long long dial_tiff_ccitt(const uint8_t* data, long long n, int compression, int t4_options, int width, int rows,
                          uint8_t* out, long long out_len) {
  try {
    return ccitt(data, n, compression, t4_options, width, rows, out, out_len);
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
