// Huffman JPEG decoder, the host core of the port's image path (page
// images are drawn without PIL, which the card's machine lacks).
//
// Reads sequential (SOF0 and SOF1) and progressive (SOF2) Huffman JPEGs at
// 8 bits with 1, 3 or 4 components, any scan layout (interleaved or one
// component a scan), any integral sampling factors, and restart
// intervals, and gives the samples Pillow's JPEG plugin gets from
// libjpeg-turbo with its defaults:
//   - progressive scans as jdphuff.c reads them: DC first and refinement
//     scans (interleaved or not), AC first scans with end-of-band runs and
//     AC refinement scans (successive approximation), into one coefficient
//     buffer for the whole image, which then takes the sequential path's
//     stages below;
//   - the integer "islow" inverse DCT of jidctint.c (13-bit constants, two
//     passes, the post-IDCT range-limit table with its wrap-around);
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
// Lossless, hierarchical and arithmetic-coded JPEGs, 12-bit samples, and
// progressive JPEGs whose scans leave one of the first nine AC
// coefficients of a component unrefined (where libjpeg smooths the
// blocks, jdcoefct.c's block smoothing), return UNSUPPORTED (2); the
// caller raises for them (ROADMAP item 9d). Nothing is skipped silently.
//
// C interface (ctypes, native/build.py):
//   int dial_jpeg_info(data, n, info[3])   -> status; info = width, height, channels
//   int dial_jpeg_decode(data, n, out, out_len) -> status; out = height x width x channels

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int OK = 0;
constexpr int CORRUPT = 1;
constexpr int UNSUPPORTED = 2;
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
  int pred = 0;               // DC predictor
  int coef_bits[64];          // progressive: the Al of the last scan of each coefficient, -1 before any
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane; // (bw * 8) x (bh * 8) samples
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
  bool progressive = false;
  int eobrun = 0;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];
  // bit reader
  uint64_t bits = 0;
  int nbits = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u16(size_t at) const { return (data[at] << 8) | data[at + 1]; }

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
    if (data[at] != 8) return UNSUPPORTED;  // 12-bit samples
    height = u16(at + 1);
    width = u16(at + 3);
    ncomp = data[at + 5];
    if (width == 0 || height == 0) return height == 0 ? UNSUPPORTED : CORRUPT;  // DNL-defined height
    if (int64_t(width) * height > kMaxPixels) return CORRUPT;
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) return UNSUPPORTED;
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
      if (hmax % c.h || vmax % c.v) return UNSUPPORTED;  // non-integral upsampling
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
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

  void restart(Component** scomp, int ns) {
    bits = 0;
    nbits = 0;
    hit_marker = false;
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
    for (int i = 0; i < ns; i++) {
      int id = data[at + 1 + 2 * i];
      int tables = data[at + 2 + 2 * i];
      Component* found = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) found = &comp[j];
      if (!found) return CORRUPT;
      found->td = tables >> 4;
      found->ta = tables & 15;
      if (found->td > 3 || found->ta > 3) return CORRUPT;
      found->pred = 0;
      scomp[i] = found;
    }
    int ss = data[at + 1 + 2 * ns], se = data[at + 2 + 2 * ns];
    int ah = data[at + 3 + 2 * ns] >> 4, al = data[at + 3 + 2 * ns] & 15;
    if (progressive) {
      // jdphuff.c's progression checks
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) return CORRUPT;
      if (al > 13 || (ah && ah - 1 != al)) return CORRUPT;
      for (int i = 0; i < ns; i++) {
        int* bits = scomp[i]->coef_bits;
        for (int k = ss; k <= se; k++) bits[k] = al;
      }
    } else {
      ss = 0, se = 63, ah = al = 0;
    }
    for (int i = 0; i < ns; i++) {
      bool need_dc = ss == 0 && ah == 0, need_ac = se > 0;
      if ((need_dc && !dc[scomp[i]->td].defined) || (need_ac && !ac[scomp[i]->ta].defined)) return CORRUPT;
    }
    eobrun = 0;
    pos = end;
    bits = 0;
    nbits = 0;
    hit_marker = false;
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
            todo = restart_interval;
          }
          todo--;
        }
        for (int i = 0; i < ns; i++) {
          Component& c = *scomp[i];
          auto one = [&](int16_t* block) {
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
          for (int v = 0; v < c.v; v++)
            for (int h = 0; h < c.h; h++) {
              size_t b = size_t(my * c.v + v) * c.bw + size_t(mx * c.h + h);
              int st = one(&c.coef[b * 64]);
              if (st) return st;
            }
        }
      }
    }
    // leave pos at the next marker
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      pos++;
    return OK;
  }

  int parse(bool header_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return CORRUPT;
    pos = 2;
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
      int st = OK;
      if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
        progressive = marker == 0xC2;
        st = read_sof(at, end);
        if (!st && header_only) return OK;
      } else if ((marker >= 0xC2 && marker <= 0xCF) && marker != 0xC4 && marker != 0xC8 && marker != 0xCC) {
        return UNSUPPORTED;  // lossless, hierarchical, arithmetic
      } else if (marker == 0xCC) {
        return UNSUPPORTED;  // arithmetic conditioning
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
    if (progressive && !header_only) {
      // jdcoefct.c's smoothing_ok: every component's DC known, and some
      // component's AC 1-9 not fully refined
      bool dc_known = true, unrefined = false;
      for (int i = 0; i < ncomp; i++) {
        dc_known = dc_known && comp[i].coef_bits[0] >= 0;
        for (int k = 1; k < kSavedCoefs; k++) unrefined = unrefined || comp[i].coef_bits[k] != 0;
      }
      if (dc_known && unrefined) return UNSUPPORTED;
    }
    return OK;
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
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (!quant_defined[c.tq]) return CORRUPT;
      int stride = c.bw * 8;
      c.plane.assign(size_t(stride) * c.bh * 8, 0);
      int rows = (c.dh + 7) / 8, cols = (c.dw + 7) / 8;
      for (int by = 0; by < rows; by++)
        for (int bx = 0; bx < cols; bx++)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], quant[c.tq],
                     &c.plane[size_t(by) * 8 * stride + size_t(bx) * 8], stride);
    }
    return OK;
  }

  // -- upsampling (jdsample.c) -----------------------------------------------

  // component i at full resolution, width x height
  std::vector<uint8_t> upsample(const Component& c) const {
    int stride = c.bw * 8;
    int fx = hmax / c.h, fy = vmax / c.v;
    std::vector<uint8_t> full(size_t(width) * height);
    auto in = [&](int y, int x) -> int {
      if (y < 0) y = 0;
      if (y >= c.dh) y = c.dh - 1;  // rows past the last real row repeat it
      return c.plane[size_t(y) * stride + x];
    };
    bool fancy_h = fx == 2 && c.dw > 2;
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
    if (fx == 1 && fy == 2) {
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

  bool is_rgb() const {
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
    st = d.inverse_dct();
    if (st) return st;
    return d.write(out);
  } catch (...) {
    return CORRUPT;
  }
}

}  // extern "C"
