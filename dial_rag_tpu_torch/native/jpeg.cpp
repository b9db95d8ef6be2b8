// JPEG decoder, the host core of the port's image path (page images are
// drawn without PIL, which the card's machine lacks).
//
// Reads every JPEG coding libjpeg-turbo 3.1 reads at 8 bits with 1, 3 or 4
// components: sequential (SOF0 and SOF1) and progressive (SOF2) Huffman,
// sequential and progressive arithmetic coding (SOF9 and SOF10), and
// lossless Huffman (SOF3); any scan layout (interleaved or one component a
// scan), any integral sampling factors, and restart intervals. It gives
// the samples Pillow's JPEG plugin gets from libjpeg-turbo with its
// defaults:
//   - progressive scans as jdphuff.c reads them: DC first and refinement
//     scans (interleaved or not), AC first scans with end-of-band runs and
//     AC refinement scans (successive approximation), into one coefficient
//     buffer for the whole image, which then takes the sequential path's
//     stages below;
//   - arithmetic-coded scans as jdarith.c decodes them (T.81 Annex D, F
//     and G): the QM coder with jaricom.c's table, DC and AC statistics
//     conditioned by DAC (L = 0, U = 1, Kx = 5 by default), statistics and
//     predictions reset at each restart, zeros fed past a marker, a
//     spectral or magnitude overflow leaving the rest of the interval; a
//     scan that reads past the 64 KiB blocks Pillow had handed libjpeg
//     when it began fails, as it fails under Pillow (kPillowBlock);
//   - block smoothing (jdcoefct.c's decompress_smooth_data) of a
//     progressive image whose DC is known and some of whose AC 1-9 are not
//     fully refined: each still-zero coefficient of AC 1-9 estimated from
//     the 5 x 5 blocks' DC values (and the DC too where no AC arrived);
//   - the integer "islow" inverse DCT of jidctint.c (13-bit constants, two
//     passes, the post-IDCT range-limit table with its wrap-around);
//   - lossless scans as jdlhuff.c, jddiffct.c and jdlossls.c read them:
//     predictors 1-7, the first row (and the first after each restart)
//     predicted from the left, each sample modulo 2^16, shifted up by the
//     point transform into 8 bits; subsampled components replicated, not
//     fancy-upsampled; three components are RGB, not converted (a JFIF or
//     Adobe YCbCr marker fails the decode, as it does there);
//   - fancy (triangular) upsampling of jdsample.c: h2v1 and h2v2 where the
//     component is more than 2 samples wide, h1v2, else box replication;
//     rows past a component's last real row repeat it;
//   - YCbCr -> RGB with jdcolor.c's 16-bit fixed-point tables; YCCK ->
//     CMYK (Adobe transform 2); RGB (Adobe transform 0, or component ids
//     'R', 'G', 'B') unconverted.
// Four-component output is inverted, as Pillow reads CMYK ("CMYK;I",
// Adobe conventions). EXIF orientation is not applied: Image.open and
// convert do not apply it.
//
// What Pillow or libjpeg-turbo refuse returns CORRUPT (1): a precision
// other than 8 and 2 components (Pillow's SOF handler), the hierarchical
// processes (SOF5-7, SOF13-15), lossless arithmetic coding (SOF11), a
// frame without its height (DNL), sampling factors that do not divide the
// largest, an interleaved MCU of more than 10 blocks. Nothing is skipped
// silently.
//
// C interface (ctypes, native/build.py):
//   int dial_jpeg_info(data, n, info[3])   -> status; info = width, height, channels
//   int dial_jpeg_decode(data, n, out, out_len) -> status; out = height x width x channels

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int OK = 0;
struct Fail {
  int status;
};
constexpr int CORRUPT = 1;
// Pillow's decompression-bomb limit (twice MAX_IMAGE_PIXELS): larger frames are refused
constexpr int64_t kMaxPixels = 178956970;

// zigzag -> natural order, and jpeg_natural_order's 16 guard entries: a
// progressive run past coefficient 63 lands on 63
constexpr int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};
// libjpeg smooths the blocks of a progressive image while one of its
// first SAVED_COEFS coefficients (DC and AC 1-9) is not fully refined
constexpr int kSavedCoefs = 10;

// jaricom.c's jpeg_aritab (T.81 Table D.2): Qe, next state after an MPS,
// after an LPS, and whether an LPS switches the MPS; state 113 is the
// fixed 0.5 estimate
struct QmState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
constexpr QmState kQm[114] = {
    {0x5a1d, 1, 1, 1},    {0x2586, 2, 14, 0},   {0x1114, 3, 16, 0},   {0x080b, 4, 18, 0},   {0x03d8, 5, 20, 0},
    {0x01da, 6, 23, 0},   {0x00e5, 7, 25, 0},   {0x006f, 8, 28, 0},   {0x0036, 9, 30, 0},   {0x001a, 10, 33, 0},
    {0x000d, 11, 35, 0},  {0x0006, 12, 9, 0},   {0x0003, 13, 10, 0},  {0x0001, 13, 12, 0},  {0x5a7f, 15, 15, 1},
    {0x3f25, 16, 36, 0},  {0x2cf2, 17, 38, 0},  {0x207c, 18, 39, 0},  {0x17b9, 19, 40, 0},  {0x1182, 20, 42, 0},
    {0x0cef, 21, 43, 0},  {0x09a1, 22, 45, 0},  {0x072f, 23, 46, 0},  {0x055c, 24, 48, 0},  {0x0406, 25, 49, 0},
    {0x0303, 26, 51, 0},  {0x0240, 27, 52, 0},  {0x01b1, 28, 54, 0},  {0x0144, 29, 56, 0},  {0x00f5, 30, 57, 0},
    {0x00b7, 31, 59, 0},  {0x008a, 32, 60, 0},  {0x0068, 33, 62, 0},  {0x004e, 34, 63, 0},  {0x003b, 35, 32, 0},
    {0x002c, 9, 33, 0},   {0x5ae1, 37, 37, 1},  {0x484c, 38, 64, 0},  {0x3a0d, 39, 65, 0},  {0x2ef1, 40, 67, 0},
    {0x261f, 41, 68, 0},  {0x1f33, 42, 69, 0},  {0x19a8, 43, 70, 0},  {0x1518, 44, 72, 0},  {0x1177, 45, 73, 0},
    {0x0e74, 46, 74, 0},  {0x0bfb, 47, 75, 0},  {0x09f8, 48, 77, 0},  {0x0861, 49, 78, 0},  {0x0706, 50, 79, 0},
    {0x05cd, 51, 48, 0},  {0x04de, 52, 50, 0},  {0x040f, 53, 50, 0},  {0x0363, 54, 51, 0},  {0x02d4, 55, 52, 0},
    {0x025c, 56, 53, 0},  {0x01f8, 57, 54, 0},  {0x01a4, 58, 55, 0},  {0x0160, 59, 56, 0},  {0x0125, 60, 57, 0},
    {0x00f6, 61, 58, 0},  {0x00cb, 62, 59, 0},  {0x00ab, 63, 61, 0},  {0x008f, 32, 61, 0},  {0x5b12, 65, 65, 1},
    {0x4d04, 66, 80, 0},  {0x412c, 67, 81, 0},  {0x37d8, 68, 82, 0},  {0x2fe8, 69, 83, 0},  {0x293c, 70, 84, 0},
    {0x2379, 71, 86, 0},  {0x1edf, 72, 87, 0},  {0x1aa9, 73, 87, 0},  {0x174e, 74, 72, 0},  {0x1424, 75, 72, 0},
    {0x119c, 76, 74, 0},  {0x0f6b, 77, 74, 0},  {0x0d51, 78, 75, 0},  {0x0bb6, 79, 77, 0},  {0x0a40, 48, 77, 0},
    {0x5832, 81, 80, 1},  {0x4d1c, 82, 88, 0},  {0x438e, 83, 89, 0},  {0x3bdd, 84, 90, 0},  {0x34ee, 85, 91, 0},
    {0x2eae, 86, 92, 0},  {0x299a, 87, 93, 0},  {0x2516, 71, 86, 0},  {0x5570, 89, 88, 1},  {0x4ca9, 90, 95, 0},
    {0x44d9, 91, 96, 0},  {0x3e22, 92, 97, 0},  {0x3824, 93, 99, 0},  {0x32b4, 94, 99, 0},  {0x2e17, 86, 93, 0},
    {0x56a8, 96, 95, 1},  {0x4f46, 97, 101, 0}, {0x47e5, 98, 102, 0}, {0x41cf, 99, 103, 0}, {0x3c3d, 100, 104, 0},
    {0x375e, 93, 99, 0},  {0x5231, 102, 105, 0}, {0x4c0f, 103, 106, 0}, {0x4639, 104, 107, 0}, {0x415e, 99, 103, 0},
    {0x5627, 106, 105, 1}, {0x50e7, 107, 108, 0}, {0x4b85, 103, 109, 0}, {0x5597, 109, 110, 0}, {0x504f, 107, 111, 0},
    {0x5a10, 111, 110, 1}, {0x5522, 109, 112, 0}, {0x59eb, 111, 112, 1}, {0x5a1d, 113, 113, 0}};
constexpr int kDcBins = 64, kAcBins = 256;
// Pillow hands libjpeg the file 64 KiB at a time (ImageFile.MAXBLOCK), a
// block more each time libjpeg suspends for data; the arithmetic decoder
// cannot suspend (JERR_CANT_SUSPEND), so Pillow fails an arithmetic scan
// that reads past the blocks handed over when the scan began
constexpr size_t kPillowBlock = 65536;

struct Huffman {
  bool defined = false;
  // canonical decoding: for each length, the largest code + 1 and the
  // offset of its first symbol
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t values[256];
  // 9-bit lookahead: (length << 8) | symbol, or 0 where the code is longer
  uint16_t look[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;         // table selectors of the current scan
  int dw = 0, dh = 0;         // downsampled width and height (samples)
  int bw = 0, bh = 0;         // block grid, padded to whole MCUs
  int pred = 0;               // DC predictor (Huffman)
  int dc_context = 0;         // arithmetic DC conditioning category
  int coef_bits[64];          // progressive: the Al of the last scan of each coefficient, -1 before any
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane; // samples, `stride` a row
  int stride = 0;
  std::vector<int32_t> undiff; // lossless: the last row undifferenced, the next row's predictors
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool frame_seen = false;
  bool progressive = false, arithmetic = false, lossless = false;
  int eobrun = 0;
  // arithmetic coding (jdarith.c): DAC conditioning, statistics, the QM decoder's registers
  uint8_t dac_l[16], dac_u[16], dac_k[16];
  uint8_t dc_stats[16][kDcBins], ac_stats[16][kAcBins];
  uint8_t fixed_bin = 113;
  int64_t qc = 0, qa = 0;
  int qct = 0;
  bool unread_marker = false;
  size_t delivered = 0;  // the bytes Pillow has handed libjpeg so far

  // a suspendable read up to `upto`: Pillow hands over blocks until it is there
  void need(size_t upto) {
    while (delivered < upto && delivered < n) delivered += kPillowBlock;
    if (delivered > n) delivered = n;
  }
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];
  // bit reader
  uint64_t bits = 0;
  int nbits = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {
    for (int i = 0; i < 16; i++) {
      dac_l[i] = 0;
      dac_u[i] = 1;
      dac_k[i] = 5;
    }
  }

  int u16(size_t at) const { return (data[at] << 8) | data[at + 1]; }
  static int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!hit_marker && pos < n) {
        byte = data[pos];
        if (byte == 0xFF) {
          int next = pos + 1 < n ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // a marker ends the segment: feed zeros, as libjpeg does
            byte = 0;
          }
        } else {
          pos++;
        }
      }
      bits |= uint64_t(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  int get_bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    int value = int(bits >> (64 - k));
    bits <<= k;
    nbits -= k;
    return value;
  }

  int decode(const Huffman& t) {
    if (nbits < 16) fill();
    int peek = int(bits >> 55);
    int entry = t.look[peek];
    if (entry) {
      int len = entry >> 8;
      bits <<= len;
      nbits -= len;
      return entry & 0xFF;
    }
    int code = int(bits >> 54);  // 10 bits
    int len = 10;
    while (len <= 16 && code > t.maxcode[len]) {
      len++;
      code = int(bits >> (64 - len));
    }
    if (len > 16) return -1;
    bits <<= len;
    nbits -= len;
    return t.values[t.valoffset[len] + code];
  }

  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  int read_dht(size_t at, size_t end) {
    while (at < end) {
      int tc = data[at] >> 4, th = data[at] & 15;
      if (tc > 1 || th > 3 || at + 17 > end) return CORRUPT;
      Huffman& t = tc ? ac[th] : dc[th];
      int counts[17] = {0};
      int total = 0;
      for (int i = 1; i <= 16; i++) total += counts[i] = data[at + i];
      if (total > 256 || at + 17 + total > end) return CORRUPT;
      std::memcpy(t.values, data + at + 17, total);
      std::memset(t.look, 0, sizeof(t.look));
      int code = 0, k = 0;
      for (int len = 1; len <= 16; len++) {
        t.valoffset[len] = k - code;
        for (int i = 0; i < counts[len]; i++, k++, code++) {
          if (code >= (1 << len)) return CORRUPT;  // more codes than the length holds
          if (len <= 9) {
            int shift = 9 - len;
            for (int fillv = 0; fillv < (1 << shift); fillv++)
              t.look[(code << shift) | fillv] = uint16_t((len << 8) | t.values[k]);
          }
        }
        t.maxcode[len] = counts[len] ? code - 1 : -1;
        code <<= 1;
      }
      t.maxcode[17] = 0x7FFFFFFF;
      t.defined = true;
      at += 17 + total;
    }
    return OK;
  }

  int read_dqt(size_t at, size_t end) {
    while (at < end) {
      int pq = data[at] >> 4, tq = data[at] & 15;
      if (tq > 3) return CORRUPT;
      int size = pq ? 128 : 64;
      if (at + 1 + size > end) return CORRUPT;
      for (int i = 0; i < 64; i++)
        quant[tq][kZigzag[i]] = uint16_t(pq ? u16(at + 1 + 2 * i) : data[at + 1 + i]);
      quant_defined[tq] = true;
      at += 1 + size;
    }
    return OK;
  }

  int read_sof(size_t at, size_t end) {
    if (frame_seen || end - at < 6) return CORRUPT;
    if (data[at] != 8) return CORRUPT;  // Pillow: "cannot handle 12-bit layers"
    height = u16(at + 1);
    width = u16(at + 3);
    ncomp = data[at + 5];
    if (width == 0 || height == 0) return CORRUPT;  // a DNL-defined height: Pillow's size is empty
    if (int64_t(width) * height > kMaxPixels) return CORRUPT;
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) return CORRUPT;  // Pillow: "cannot handle n-layer images"
    if (end - at < size_t(6 + 3 * ncomp)) return CORRUPT;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = data[at + 6 + 3 * i];
      c.h = data[at + 7 + 3 * i] >> 4;
      c.v = data[at + 7 + 3 * i] & 15;
      c.tq = data[at + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return CORRUPT;
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) return CORRUPT;  // jdsample.c: fractional upsampling not implemented
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      if (lossless) {
        // a sample a "block": MCUs of hmax x vmax samples, the planes padded to whole MCUs
        c.stride = int(ceil_div(width, hmax)) * c.h;
        c.plane.assign(size_t(c.stride) * size_t(ceil_div(height, vmax) * c.v), 0);
      } else {
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      }
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    frame_seen = true;
    return OK;
  }

  int decode_block(Component& c, int16_t* block) {
    const Huffman& tdc = dc[c.td];
    const Huffman& tac = ac[c.ta];
    int s = decode(tdc);
    if (s < 0 || s > 11) return CORRUPT;
    int diff = s ? extend(get_bits(s), s) : 0;
    c.pred += diff;
    block[0] = int16_t(c.pred);
    for (int k = 1; k < 64;) {
      int rs = decode(tac);
      if (rs < 0) return CORRUPT;
      int r = rs >> 4, size = rs & 15;
      if (size) {
        k += r;
        if (k > 63) return CORRUPT;
        block[kZigzag[k]] = int16_t(extend(get_bits(size), size));
        k++;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    return OK;
  }

  // -- progressive scans (jdphuff.c) ----------------------------------------

  int decode_dc_first(Component& c, int16_t* block, int al) {
    int s = decode(dc[c.td]);
    if (s < 0 || s > 11) return CORRUPT;
    int diff = s ? extend(get_bits(s), s) : 0;
    c.pred += diff;
    block[0] = int16_t(unsigned(c.pred) << al);
    return OK;
  }

  void decode_dc_refine(int16_t* block, int al) {
    if (get_bits(1)) block[0] = int16_t(block[0] | (1 << al));
  }

  int decode_ac_first(Component& c, int16_t* block, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return OK;
    }
    const Huffman& tac = ac[c.ta];
    for (int k = ss; k <= se; k++) {
      int rs = decode(tac);
      if (rs < 0) return CORRUPT;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        block[kZigzag[k]] = int16_t(unsigned(extend(get_bits(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get_bits(r);
        eobrun--;
        break;
      }
    }
    return OK;
  }

  int decode_ac_refine(Component& c, int16_t* block, int ss, int se, int al) {
    const Huffman& tac = ac[c.ta];
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto refine = [&](int16_t& coef) {
      if (get_bits(1) && (coef & p1) == 0) coef = int16_t(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode(tac);
        if (rs < 0) return CORRUPT;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;  // a newly nonzero coefficient is +-1 at this bit
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get_bits(r);
          break;  // the rest of the band goes as an end-of-band run
        }
        // pass over nonzero coefficients (each takes a correction bit) and r zeros
        do {
          int16_t& coef = block[kZigzag[k]];
          if (coef != 0) {
            refine(coef);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) block[kZigzag[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t& coef = block[kZigzag[k]];
        if (coef != 0) refine(coef);
      }
      eobrun--;
    }
    return OK;
  }

  // -- arithmetic decoding (jdarith.c) ------------------------------------------

  // the next entropy-coded byte: a stuffed 0xFF as 0xFF, zeros from a marker on
  // (a read past the bytes Pillow handed over fails, as it fails there)
  int entropy_byte() {
    if (unread_marker) return 0;
    if (pos >= delivered) throw Fail{CORRUPT};
    int byte = data[pos++];
    if (byte != 0xFF) return byte;
    do {
      if (pos >= delivered) throw Fail{CORRUPT};
      byte = data[pos++];
    } while (byte == 0xFF);
    if (byte == 0) return 0xFF;
    unread_marker = true;  // a marker ends the data: leave it for the scan's end
    pos -= 2;
    return 0;
  }

  int arith_decode(uint8_t* st) {
    while (qa < 0x8000) {
      if (--qct < 0) {
        qc = (qc << 8) | entropy_byte();
        if ((qct += 8) < 0)
          if (++qct == 0) qa = 0x8000;  // two initial bytes read
      }
      qa <<= 1;
    }
    int sv = *st;
    const QmState& q = kQm[sv & 0x7F];
    int64_t qe = q.qe;
    int nl = q.nlps | (q.sw << 7), nm = q.nmps;
    int64_t temp = qa - qe;
    qa = temp;
    temp <<= qct;
    if (qc >= temp) {
      qc -= temp;
      if (qa < qe) {  // conditional LPS exchange
        qa = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        qa = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (qa < 0x8000) {  // conditional MPS exchange
      if (qa < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // a DC difference (F.19 - F.24); false on a magnitude overflow
  bool arith_dc_diff(Component& c, int& v) {
    uint8_t* stats = dc_stats[c.td];
    uint8_t* st = stats + c.dc_context;
    if (arith_decode(st) == 0) {
      c.dc_context = 0;
      v = 0;
      return true;
    }
    int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = stats + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < int((1L << dac_l[c.td]) >> 1))
      c.dc_context = 0;
    else if (m > int((1L << dac_u[c.td]) >> 1))
      c.dc_context = 12 + sign * 4;
    else
      c.dc_context = 4 + sign * 4;
    v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }

  // an AC value's sign, category and magnitude at band index k (st at the
  // coefficient's first bin); false on a magnitude overflow
  bool arith_ac_value(Component& c, uint8_t* st, int k, int& v) {
    int sign = arith_decode(&fixed_bin);
    st += 2;
    int m = arith_decode(st);
    if (m != 0) {
      if (arith_decode(st)) {
        m <<= 1;
        st = ac_stats[c.ta] + (k <= dac_k[c.ta] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
    }
    v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }

  // one block of a sequential arithmetic scan; false on an error (qct = -1)
  bool arith_block(Component& c, int16_t* block) {
    int v;
    if (!arith_dc_diff(c, v)) return false;
    c.pred = (c.pred + v) & 0xFFFF;
    block[0] = int16_t(c.pred);
    int k = 0;
    do {
      uint8_t* st = ac_stats[c.ta] + 3 * k;
      if (arith_decode(st)) break;  // EOB
      for (;;) {
        k++;
        if (arith_decode(st + 1)) break;
        st += 3;
        if (k >= 63) return false;  // spectral overflow
      }
      if (!arith_ac_value(c, st, k, v)) return false;
      block[kZigzag[k]] = int16_t(v);
    } while (k < 63);
    return true;
  }

  bool arith_dc_first(Component& c, int16_t* block, int al) {
    int v;
    if (!arith_dc_diff(c, v)) return false;
    c.pred += v;
    block[0] = int16_t(unsigned(c.pred) << al);
    return true;
  }

  bool arith_ac_first(Component& c, int16_t* block, int ss, int se, int al) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[c.ta] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        k++;
        if (k > se) return false;  // spectral overflow
      }
      int v;
      if (!arith_ac_value(c, st, k, v)) return false;
      block[kZigzag[k]] = int16_t(unsigned(v) << al);
    }
    return true;
  }

  bool arith_ac_refine(Component& c, int16_t* block, int ss, int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (block[kZigzag[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[c.ta] + 3 * (k - 1);
      if (k > kex)
        if (arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t& coef = block[kZigzag[k]];
        if (coef) {  // previously nonzero: a correction bit
          if (arith_decode(st + 2)) coef = int16_t(coef < 0 ? coef + m1 : coef + p1);
          break;
        }
        if (arith_decode(st + 1)) {  // newly nonzero
          coef = int16_t(arith_decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        k++;
        if (k > se) return false;  // spectral overflow
      }
    }
    return true;
  }

  // statistics and predictions at a scan's start and at each restart
  void arith_reset(Component** scomp, int ns, int ss, int ah) {
    for (int i = 0; i < ns; i++) {
      Component& c = *scomp[i];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c.td], 0, kDcBins);
        c.pred = 0;
        c.dc_context = 0;
      }
      if (!progressive || ss) std::memset(ac_stats[c.ta], 0, kAcBins);
    }
    qc = 0;
    qa = 0;
    qct = -16;  // two bytes to read first
  }

  // -- scans --------------------------------------------------------------------

  void restart(Component** scomp, int ns) {
    bits = 0;
    nbits = 0;
    hit_marker = false;
    unread_marker = false;
    // skip to the RSTn marker and past it
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)) {
      if (data[pos] == 0xFF && data[pos + 1] != 0xFF && data[pos + 1] != 0x00) break;  // another marker
      pos++;
    }
    if (pos + 1 < n && data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) pos += 2;
    for (int i = 0; i < ns; i++) scomp[i]->pred = 0;
    eobrun = 0;
  }

  int read_scan(size_t at, size_t end) {
    if (!frame_seen) return CORRUPT;
    int ns = data[at];
    if (ns < 1 || ns > 4 || end - at < size_t(1 + 2 * ns + 3)) return CORRUPT;
    Component* scomp[4];
    int tables = arithmetic ? 15 : 3;
    for (int i = 0; i < ns; i++) {
      int id = data[at + 1 + 2 * i];
      int sel = data[at + 2 + 2 * i];
      Component* found = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) found = &comp[j];
      if (!found) return CORRUPT;
      found->td = sel >> 4;
      found->ta = sel & 15;
      if (found->td > tables || found->ta > tables) return CORRUPT;
      found->pred = 0;
      scomp[i] = found;
    }
    if (ns > 1) {  // jdinput.c: at most 10 blocks (samples, lossless) an interleaved MCU
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += scomp[i]->h * scomp[i]->v;
      if (blocks > 10) return CORRUPT;
    }
    int ss = data[at + 1 + 2 * ns], se = data[at + 2 + 2 * ns];
    int ah = data[at + 3 + 2 * ns] >> 4, al = data[at + 3 + 2 * ns] & 15;
    if (lossless) {
      // jddiffct.c: a predictor 1-7, no spectral selection, a point transform below the precision
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8) return CORRUPT;
    } else if (progressive) {
      // jdphuff.c's (and jdarith.c's) progression checks
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) return CORRUPT;
      if (al > 13 || (ah && ah - 1 != al)) return CORRUPT;
      for (int i = 0; i < ns; i++) {
        int* bits = scomp[i]->coef_bits;
        for (int k = ss; k <= se; k++) bits[k] = al;
      }
    } else {
      ss = 0, se = 63, ah = al = 0;
    }
    if (!arithmetic)
      for (int i = 0; i < ns; i++) {
        bool need_dc = lossless || (ss == 0 && ah == 0), need_ac = !lossless && se > 0;
        if ((need_dc && !dc[scomp[i]->td].defined) || (need_ac && !ac[scomp[i]->ta].defined)) return CORRUPT;
      }
    eobrun = 0;
    pos = end;
    bits = 0;
    nbits = 0;
    hit_marker = false;
    unread_marker = false;
    if (arithmetic) arith_reset(scomp, ns, ss, ah);
    int st = lossless ? lossless_scan(scomp, ns, ss, al) : dct_scan(scomp, ns, ss, se, ah, al);
    if (st) return st;
    if (!arithmetic) need(pos);  // the Huffman decoder suspends for data as it needs it
    // leave pos at the next marker
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF &&
                            !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      pos++;
    return OK;
  }

  int dct_scan(Component** scomp, int ns, int ss, int se, int ah, int al) {
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = (scomp[0]->dw + 7) / 8;
      mcus_y = (scomp[0]->dh + 7) / 8;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    int todo = restart_interval;
    for (int my = 0; my < mcus_y; my++) {
      for (int mx = 0; mx < mcus_x; mx++) {
        if (restart_interval) {
          if (todo == 0) {
            restart(scomp, ns);
            if (arithmetic) arith_reset(scomp, ns, ss, ah);
            todo = restart_interval;
          }
          todo--;
        }
        if (arithmetic && qct == -1) continue;  // an error: nothing more until the next restart
        for (int i = 0; i < ns; i++) {
          Component& c = *scomp[i];
          auto one = [&](int16_t* block) {
            if (arithmetic) {
              bool ok;
              if (!progressive)
                ok = arith_block(c, block);
              else if (ss == 0)
                ok = ah ? (block[0] = int16_t(block[0] | (arith_decode(&fixed_bin) << al)), true)
                        : arith_dc_first(c, block, al);
              else
                ok = ah ? arith_ac_refine(c, block, ss, se, al) : arith_ac_first(c, block, ss, se, al);
              if (!ok) qct = -1;
              return OK;
            }
            if (!progressive) return decode_block(c, block);
            if (ss == 0) {
              if (ah) {
                decode_dc_refine(block, al);
                return OK;
              }
              return decode_dc_first(c, block, al);
            }
            return ah ? decode_ac_refine(c, block, ss, se, al) : decode_ac_first(c, block, ss, se, al);
          };
          if (ns == 1) {
            int st = one(&c.coef[(size_t(my) * c.bw + mx) * 64]);
            if (st) return st;
            continue;
          }
          for (int v = 0; v < c.v && qct != -1; v++)
            for (int h = 0; h < c.h && qct != -1; h++) {
              size_t b = size_t(my * c.v + v) * c.bw + size_t(mx * c.h + h);
              int st = one(&c.coef[b * 64]);
              if (st) return st;
            }
          if (arithmetic && qct == -1) break;
        }
      }
    }
    return OK;
  }

  // -- lossless scans (jdlhuff.c, jddiffct.c, jdlossls.c) -------------------------

  int lossless_scan(Component** scomp, int ns, int psv, int al) {
    if (arithmetic) return CORRUPT;  // SOF11: libjpeg-turbo has no lossless arithmetic decoder
    // MCUs: one sample of a lone component, else hmax x vmax samples' worth of each
    int mcus_x = ns == 1 ? scomp[0]->dw : int(ceil_div(width, hmax));
    int mcus_y = ns == 1 ? scomp[0]->dh : int(ceil_div(height, vmax));
    if (restart_interval % mcus_x) return CORRUPT;  // jddiffct.c: a restart interval of whole MCU rows
    int restart_rows = restart_interval / mcus_x, rows_to_go = restart_rows;
    bool first_row = true;
    std::vector<int32_t> cur;
    for (int my = 0; my < mcus_y; my++) {
      if (restart_interval) {
        if (rows_to_go == 0) {
          restart(scomp, ns);
          rows_to_go = restart_rows;
          first_row = true;
        }
        rows_to_go--;
      }
      // the MCU row's differences, each component's rows (v) of its width
      std::vector<std::vector<int32_t>> rows(static_cast<size_t>(ns));
      for (int i = 0; i < ns; i++) {
        Component& c = *scomp[i];
        int h = ns == 1 ? 1 : c.h, v = ns == 1 ? 1 : c.v;
        rows[size_t(i)].assign(size_t(v) * size_t(mcus_x) * size_t(h), 0);
      }
      for (int mx = 0; mx < mcus_x; mx++)
        for (int i = 0; i < ns; i++) {
          Component& c = *scomp[i];
          int h = ns == 1 ? 1 : c.h, v = ns == 1 ? 1 : c.v;
          for (int y = 0; y < v; y++)
            for (int x = 0; x < h; x++) {
              int s = decode(dc[c.td]);
              if (s < 0 || s > 16) return CORRUPT;
              int d = 0;
              if (s == 16)
                d = 32768;
              else if (s)
                d = extend(get_bits(s), s);
              rows[size_t(i)][size_t(y) * size_t(mcus_x * h) + size_t(mx * h + x)] = d;
            }
        }
      for (int i = 0; i < ns; i++) {
        Component& c = *scomp[i];
        int h = ns == 1 ? 1 : c.h, v = ns == 1 ? 1 : c.v;
        int w = mcus_x * h;
        for (int y = 0; y < v; y++) {
          int row = my * v + y;
          const int32_t* df = &rows[size_t(i)][size_t(y) * size_t(w)];
          uint8_t* out = &c.plane[size_t(row) * c.stride];
          cur.assign(size_t(w), 0);
          if (first_row && y == 0) {
            int ra = (df[0] + (1 << (7 - al))) & 0xFFFF;
            cur[0] = ra;
            for (int x = 1; x < w; x++) cur[size_t(x)] = ra = (df[x] + ra) & 0xFFFF;
          } else {
            // the previous row of this component, as undifferenced (kept beside the plane)
            const int32_t* up = &c.undiff[0];
            int ra = (df[0] + up[0]) & 0xFFFF;  // the first column from above
            cur[0] = ra;
            for (int x = 1; x < w; x++) {
              int64_t rb = up[x], rc = up[x - 1], pred;
              switch (psv) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
              }
              cur[size_t(x)] = ra = int((df[x] + pred) & 0xFFFF);
            }
          }
          c.undiff.assign(cur.begin(), cur.end());
          int n_out = std::min(w, c.stride);
          for (int x = 0; x < n_out; x++) out[x] = uint8_t(cur[size_t(x)] << al);
        }
      }
      first_row = false;
    }
    return OK;
  }

  int parse(bool header_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return CORRUPT;
    pos = 2;
    delivered = 0;
    need(1);
    while (pos + 4 <= n) {
      if (data[pos] != 0xFF) {
        pos++;
        continue;
      }
      int marker = data[pos + 1];
      if (marker == 0xFF) {
        pos++;
        continue;
      }
      if (marker == 0xD9) break;  // EOI
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) {
        pos += 2;
        continue;
      }
      size_t len = size_t(u16(pos + 2));
      size_t at = pos + 4, end = pos + 2 + len;
      if (len < 2 || end > n) return CORRUPT;
      need(end);
      int st = OK;
      if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2 || marker == 0xC3 || marker == 0xC9 ||
          marker == 0xCA) {
        progressive = marker == 0xC2 || marker == 0xCA;
        arithmetic = marker == 0xC9 || marker == 0xCA;
        lossless = marker == 0xC3;
        st = read_sof(at, end);
        if (!st && header_only) return OK;
      } else if (marker == 0xCB || (marker >= 0xC5 && marker <= 0xC8) || (marker >= 0xCD && marker <= 0xCF)) {
        return CORRUPT;  // lossless arithmetic, hierarchical, JPG: libjpeg-turbo refuses them
      } else if (marker == 0xCC) {
        st = read_dac(at, end);
      } else if (marker == 0xC4) {
        st = read_dht(at, end);
      } else if (marker == 0xDB) {
        st = read_dqt(at, end);
      } else if (marker == 0xDD) {
        if (len < 4) return CORRUPT;
        restart_interval = u16(at);
      } else if (marker == 0xE0) {
        if (len >= 7 && std::memcmp(data + at, "JFIF\0", 5) == 0) saw_jfif = true;
      } else if (marker == 0xEE) {
        if (len >= 14 && std::memcmp(data + at, "Adobe", 5) == 0) {
          saw_adobe = true;
          adobe_transform = data[at + 11];
        }
      } else if (marker == 0xDA) {
        if (header_only) return CORRUPT;
        st = read_scan(at, end);
        if (st) return st;
        continue;  // pos is at the next marker
      }
      if (st) return st;
      pos = end;
    }
    if (!frame_seen) return CORRUPT;
    return OK;
  }

  int read_dac(size_t at, size_t end) {
    if ((end - at) % 2) return CORRUPT;
    for (; at < end; at += 2) {
      int index = data[at], val = data[at + 1];
      if (index >= 32) return CORRUPT;
      if (index >= 16) {
        dac_k[index - 16] = uint8_t(val);
      } else {
        dac_l[index] = uint8_t(val & 15);
        dac_u[index] = uint8_t(val >> 4);
        if (dac_l[index] > dac_u[index]) return CORRUPT;
      }
    }
    return OK;
  }

  // jdcoefct.c's smoothing_ok: every component's DC known, the ten
  // quantizers it reads nonzero, and some component's AC 1-9 not fully refined
  bool smoothing() const {
    if (!progressive) return false;
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      const uint16_t* q = quant[c.tq];
      if (!q[0] || !q[1] || !q[8] || !q[16] || !q[9] || !q[2] || !q[3] || !q[10] || !q[17] || !q[24]) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < kSavedCoefs; k++) useful = useful || c.coef_bits[k] != 0;
    }
    return useful;
  }

  // -- islow inverse DCT (jidctint.c) ----------------------------------------

  static uint8_t limit_idct(int64_t x) {
    // the post-IDCT range-limit table of jdmaster.c, indexed by x & 1023
    int i = int(x & 1023);
    if (i < 128) return uint8_t(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return uint8_t(i - 896);
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int s) { return (x + (int64_t(1) << (s - 1))) >> s; };
    int64_t ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int64_t dcval = (int64_t(ip[0]) * qp[0]) * (1 << P1);
        for (int r = 0; r < 8; r++) ws[r * 8 + col] = dcval;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = int64_t(ip[0]) * qp[0];
      z3 = int64_t(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = int64_t(ip[56]) * qp[56];
      tmp1 = int64_t(ip[40]) * qp[40];
      tmp2 = int64_t(ip[24]) * qp[24];
      tmp3 = int64_t(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      ws[0 * 8 + col] = descale(tmp10 + tmp3, CB - P1);
      ws[7 * 8 + col] = descale(tmp10 - tmp3, CB - P1);
      ws[1 * 8 + col] = descale(tmp11 + tmp2, CB - P1);
      ws[6 * 8 + col] = descale(tmp11 - tmp2, CB - P1);
      ws[2 * 8 + col] = descale(tmp12 + tmp1, CB - P1);
      ws[5 * 8 + col] = descale(tmp12 - tmp1, CB - P1);
      ws[3 * 8 + col] = descale(tmp13 + tmp0, CB - P1);
      ws[4 * 8 + col] = descale(tmp13 - tmp0, CB - P1);
    }
    constexpr int S2 = CB + P1 + 3;
    for (int row = 0; row < 8; row++) {
      const int64_t* w = ws + row * 8;
      uint8_t* op = out + row * stride;
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (w[0] + w[4]) * (1 << CB);
      int64_t tmp1 = (w[0] - w[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      op[0] = limit_idct(descale(tmp10 + tmp3, S2));
      op[7] = limit_idct(descale(tmp10 - tmp3, S2));
      op[1] = limit_idct(descale(tmp11 + tmp2, S2));
      op[6] = limit_idct(descale(tmp11 - tmp2, S2));
      op[2] = limit_idct(descale(tmp12 + tmp1, S2));
      op[5] = limit_idct(descale(tmp12 - tmp1, S2));
      op[3] = limit_idct(descale(tmp13 + tmp0, S2));
      op[4] = limit_idct(descale(tmp13 - tmp0, S2));
    }
  }

  int inverse_dct() {
    if (lossless) return OK;  // the scans wrote the samples
    bool smooth = smoothing();
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (!quant_defined[c.tq]) return CORRUPT;
      c.stride = c.bw * 8;
      c.plane.assign(size_t(c.stride) * c.bh * 8, 0);
      if (smooth) {
        smooth_component(c);
        continue;
      }
      int rows = (c.dh + 7) / 8, cols = (c.dw + 7) / 8;
      for (int by = 0; by < rows; by++)
        for (int bx = 0; bx < cols; bx++)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], quant[c.tq],
                     &c.plane[size_t(by) * 8 * c.stride + size_t(bx) * 8], c.stride);
    }
    return OK;
  }

  // -- block smoothing (jdcoefct.c's decompress_smooth_data) -------------------------

  // a still-zero coefficient estimated as num / (q << 8), rounded, within 2^Al
  static int16_t estimate(int64_t q, int64_t num, int al, bool clamp) {
    int pred;
    if (num >= 0) {
      pred = int(((q << 7) + num) / (q << 8));
      if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = int(((q << 7) - num) / (q << 8));
      if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return int16_t(pred);
  }

  void smooth_component(Component& c) {
    const int* cb = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < kSavedCoefs; k++) change_dc = change_dc && cb[k] == -1;
    const uint16_t* q = quant[c.tq];
    int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2];
    int64_t Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
    int hib = (c.dh + 7) / 8, wib = (c.dw + 7) / 8;
    int last_col = wib - 1;
    int16_t ws[64];
    for (int imcu = 0; imcu < mcuy; imcu++) {
      int block_rows = c.v;
      if (imcu == mcuy - 1) {
        block_rows = hib % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      int image_block_rows = block_rows * mcuy;  // as jdcoefct.c counts them
      for (int br = 0; br < block_rows; br++) {
        int row = imcu * c.v + br;
        int ibr = imcu * block_rows + br;
        int prev = ibr > 0 ? row - 1 : row;
        int prev2 = ibr > 1 ? row - 2 : prev;
        int next = ibr < image_block_rows - 1 ? row + 1 : row;
        int next2 = ibr < image_block_rows - 2 ? row + 2 : next;
        auto dcv = [&](int r, int col) -> int {
          r = std::min(std::max(r, 0), c.bh - 1);
          return c.coef[(size_t(r) * c.bw + size_t(col)) * 64];
        };
        int rs[5] = {prev2, prev, row, next, next2};
        for (int col = 0; col <= last_col; col++) {
          std::memcpy(ws, &c.coef[(size_t(row) * c.bw + size_t(col)) * 64], sizeof(ws));
          // the 5 x 5 blocks' DC values around this one, columns past either edge repeating it
          int D[25];
          for (int i = 0; i < 5; i++)
            for (int j = 0; j < 5; j++) D[5 * i + j] = dcv(rs[i], std::min(std::max(col + j - 2, 0), last_col));
          const int DC01 = D[0], DC02 = D[1], DC03 = D[2], DC04 = D[3], DC05 = D[4], DC06 = D[5], DC07 = D[6],
                    DC08 = D[7], DC09 = D[8], DC10 = D[9], DC11 = D[10], DC12 = D[11], DC13 = D[12],
                    DC14 = D[13], DC15 = D[14], DC16 = D[15], DC17 = D[16], DC18 = D[17], DC19 = D[18],
                    DC20 = D[19], DC21 = D[20], DC22 = D[21], DC23 = D[22], DC24 = D[23], DC25 = D[24];
          int al;
          if ((al = cb[1]) != 0 && ws[1] == 0) {
            int64_t num = Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                              3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                                              13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                                           : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
            ws[1] = estimate(Q01, num, al, true);
          }
          if ((al = cb[2]) != 0 && ws[8] == 0) {
            int64_t num = Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                                              38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                                              13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                           : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
            ws[8] = estimate(Q10, num, al, true);
          }
          if ((al = cb[3]) != 0 && ws[16] == 0) {
            int64_t num = Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                              5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                                           : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
            ws[16] = estimate(Q20, num, al, true);
          }
          if ((al = cb[4]) != 0 && ws[9] == 0) {
            int64_t num = Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
                                              DC25)
                                           : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
                                              DC04 - DC06 + 10 * DC07 - 10 * DC09));
            ws[9] = estimate(Q11, num, al, true);
          }
          if ((al = cb[5]) != 0 && ws[2] == 0) {
            int64_t num = Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                              7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                                           : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
            ws[2] = estimate(Q02, num, al, true);
          }
          if (change_dc) {
            if ((al = cb[6]) != 0 && ws[3] == 0)
              ws[3] = estimate(Q03, Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), al, true);
            if ((al = cb[7]) != 0 && ws[10] == 0)
              ws[10] = estimate(Q12, Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), al, true);
            if ((al = cb[8]) != 0 && ws[17] == 0)
              ws[17] = estimate(Q21, Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), al, true);
            if ((al = cb[9]) != 0 && ws[24] == 0)
              ws[24] = estimate(Q30, Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), al, true);
            int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                                 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
                                 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
                                 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
            ws[0] = estimate(Q00, num, 0, false);
          }
          idct_islow(ws, q, &c.plane[size_t(row) * 8 * c.stride + size_t(col) * 8], c.stride);
        }
      }
    }
  }

  // -- upsampling (jdsample.c) -----------------------------------------------

  // component i at full resolution, width x height
  std::vector<uint8_t> upsample(const Component& c) const {
    int stride = c.stride;
    int fx = hmax / c.h, fy = vmax / c.v;
    std::vector<uint8_t> full(size_t(width) * height);
    auto in = [&](int y, int x) -> int {
      if (y < 0) y = 0;
      if (y >= c.dh) y = c.dh - 1;  // rows past the last real row repeat it
      return c.plane[size_t(y) * stride + x];
    };
    bool fancy_h = fx == 2 && c.dw > 2 && !lossless;  // lossless frames upsample by replication
    if (fx == 1 && fy == 1) {
      for (int y = 0; y < height; y++) std::memcpy(&full[size_t(y) * width], &c.plane[size_t(y) * stride], width);
      return full;
    }
    if (fx == 2 && fy == 1 && fancy_h) {
      for (int y = 0; y < height; y++) {
        uint8_t* o = &full[size_t(y) * width];
        int last = c.dw - 1;
        for (int i = 0; i <= last; i++) {
          int x3 = 3 * in(y, i);
          int a = i == 0 ? in(y, 0) : (x3 + in(y, i - 1) + 1) >> 2;
          int b = i == last ? in(y, last) : (x3 + in(y, i + 1) + 2) >> 2;
          if (2 * i < width) o[2 * i] = uint8_t(a);
          if (2 * i + 1 < width) o[2 * i + 1] = uint8_t(b);
        }
      }
      return full;
    }
    if (fx == 2 && fy == 2 && fancy_h) {
      std::vector<int> sum(c.dw);
      for (int y = 0; y < height; y++) {
        int row = y >> 1;
        int nb = (y & 1) ? row + 1 : row - 1;
        for (int i = 0; i < c.dw; i++) sum[i] = 3 * in(row, i) + in(nb, i);
        uint8_t* o = &full[size_t(y) * width];
        int last = c.dw - 1;
        for (int i = 0; i <= last; i++) {
          int a = i == 0 ? (sum[0] * 4 + 8) >> 4 : (sum[i] * 3 + sum[i - 1] + 8) >> 4;
          int b = i == last ? (sum[last] * 4 + 7) >> 4 : (sum[i] * 3 + sum[i + 1] + 7) >> 4;
          if (2 * i < width) o[2 * i] = uint8_t(a);
          if (2 * i + 1 < width) o[2 * i + 1] = uint8_t(b);
        }
      }
      return full;
    }
    if (fx == 1 && fy == 2 && !lossless) {
      for (int y = 0; y < height; y++) {
        int row = y >> 1;
        int nb = (y & 1) ? row + 1 : row - 1;
        int bias = (y & 1) ? 2 : 1;
        uint8_t* o = &full[size_t(y) * width];
        for (int x = 0; x < width; x++) o[x] = uint8_t((3 * in(row, x) + in(nb, x) + bias) >> 2);
      }
      return full;
    }
    // box replication (int_upsample, and h2v1 / h2v2 of components at most 2 samples wide)
    for (int y = 0; y < height; y++) {
      uint8_t* o = &full[size_t(y) * width];
      for (int x = 0; x < width; x++) o[x] = uint8_t(in(y / fy, x / fx));
    }
    return full;
  }

  // -- colour conversion (jdcolor.c) -------------------------------------------

  int channels() const { return ncomp; }

  // lossless frames are not colour-converted (jdmaster.c refuses a
  // conversion there): three components read as RGB unless a JFIF or
  // Adobe marker says YCbCr, which fails the decode; YCCK fails too
  bool lossless_conversion() const {
    if (ncomp == 3) return saw_jfif || (saw_adobe && adobe_transform != 0);
    return ncomp == 4 && saw_adobe && adobe_transform == 2;
  }

  bool is_rgb() const {
    if (lossless) return true;
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  int write(uint8_t* out) const {
    std::vector<std::vector<uint8_t>> planes;
    for (int i = 0; i < ncomp; i++) planes.push_back(upsample(comp[i]));
    size_t count = size_t(width) * height;
    if (ncomp == 1) {
      std::memcpy(out, planes[0].data(), count);
      return OK;
    }
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return int64_t(x * (1 << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = int((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
    if (ncomp == 3) {
      bool rgb = is_rgb();
      for (size_t i = 0; i < count; i++) {
        uint8_t* o = out + 3 * i;
        if (rgb) {
          o[0] = p0[i];
          o[1] = p1[i];
          o[2] = p2[i];
          continue;
        }
        int y = p0[i], cb = p1[i], cr = p2[i];
        o[0] = clamp(y + cr_r[cr]);
        o[1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> SB));
        o[2] = clamp(y + cb_b[cb]);
      }
      return OK;
    }
    // four components: CMYK, or YCCK (Adobe transform 2) converted to CMYK;
    // then inverted, as Pillow reads CMYK JPEGs
    bool ycck = saw_adobe && adobe_transform == 2;
    const uint8_t* p3 = planes[3].data();
    for (size_t i = 0; i < count; i++) {
      uint8_t* o = out + 4 * i;
      if (ycck) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        o[0] = uint8_t(255 - clamp(255 - (y + cr_r[cr])));
        o[1] = uint8_t(255 - clamp(255 - (y + int((cb_g[cb] + cr_g[cr]) >> SB))));
        o[2] = uint8_t(255 - clamp(255 - (y + cb_b[cb])));
      } else {
        o[0] = uint8_t(255 - p0[i]);
        o[1] = uint8_t(255 - p1[i]);
        o[2] = uint8_t(255 - p2[i]);
      }
      o[3] = uint8_t(255 - p3[i]);
    }
    return OK;
  }
};

}  // namespace

extern "C" {

int dial_jpeg_info(const uint8_t* data, long long n, int* info) {
  try {
    Decoder d(data, size_t(n));
    int st = d.parse(true);
    if (st) return st;
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.channels();
    return OK;
  } catch (const Fail& f) {
    return f.status;
  } catch (...) {  // no exception crosses the C interface (an allocation that fails)
    return CORRUPT;
  }
}

int dial_jpeg_decode(const uint8_t* data, long long n, uint8_t* out, long long out_len) {
  try {
    Decoder d(data, size_t(n));
    int st = d.parse(false);
    if (st) return st;
    if (out_len < (long long)d.width * d.height * d.channels()) return CORRUPT;
    if (d.lossless && d.lossless_conversion()) return CORRUPT;
    st = d.inverse_dct();
    if (st) return st;
    return d.write(out);
  } catch (const Fail& f) {
    return f.status;
  } catch (...) {
    return CORRUPT;
  }
}

}  // extern "C"
