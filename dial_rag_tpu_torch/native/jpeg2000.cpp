// JPEG 2000 Part 1 codestream decoder, the host core of the port's JPX
// images (a PDF's JPXDecode streams; page images are drawn without PIL,
// which the card's machine lacks).
//
// It gives the samples OpenJPEG 2.5 gives Pillow, stage for stage:
//   - the main header: SIZ (image and tile offsets, precision, sign,
//     XRsiz / YRsiz subsampling), COD / COC (precincts, SOP / EPH, the five
//     progression orders, layers, MCT, decomposition levels, code-block
//     size and style, 5/3 or 9/7), QCD / QCC (none, scalar derived, scalar
//     expounded; guard bits), RGN (max-shift ROI), POC, PPM; PLM, TLM, CRG,
//     COM and unknown segments are skipped. Precedence: a tile's COC, the
//     tile's COD, the main COC, the main COD (QCC / QCD alike);
//   - tile-parts (SOT / SOD) in any order, a tile's parts joined in the
//     order they come, PPT in the tile-part headers; tier-2 packet headers
//     (tag trees, Lblock, the bit stuffing after 0xFF) over precincts in
//     the progression order, POC volumes skipping the packets an earlier
//     volume read (pi.c's iterators, their position steps and checks);
//   - tier-1: the MQ decoder (T.800 Annex C, mqc.c's byte-in with the two
//     0xFF bytes appended to each segment), the significance, refinement
//     and cleanup passes with run-length coding, every code-block style
//     (bypass, reset, termall, vertically causal, predictable termination,
//     segmentation symbols); reconstruction at the midpoint of the last
//     decoded bit (t1.c keeps values at twice their magnitude);
//   - the ROI shift, then dequantization (the 5/3 path halves, the 9/7 path
//     multiplies by half of tcd.c's step in float, whose Rb leaves out the
//     band gain, BUG_WEIRD_TWO_INVK), the inverse 5/3 DWT in integers and
//     the inverse 9/7 in float with dwt.c's lifting order and constants
//     (low band times K, high band times 2 / K, a single sample at an odd
//     origin halved by 5/3 and left as it is by 9/7), rows then columns,
//     level by level;
//   - the inverse RCT or ICT (mct.c's float constants) when COD asks for
//     it on three or more components of one size, then the DC level shift
//     with clamping (lrintf for 9/7).
// The build turns FP contraction off (native/build.py), so no product and
// sum fuse where OpenJPEG's SSE code rounds each.
//
// OpenJPEG 2.5 runs in strict mode under Pillow: a tile-part whose Psot
// runs past the end of the stream, a code-block segment longer than its
// tile's data, or a stream that ends before EOC fails the decode. Tiles
// the tile-parts never name stay zero, as Pillow's image was.
//
// What the port does not read returns UNSUPPORTED (2): the high-throughput
// block coder (Part 15), Part 2 extensions (custom MCT, arbitrary
// wavelets, a Rsiz with Part 2 bits set), more than 4 components, and a
// precision above 31 bits (OpenJPEG refuses those too, as CORRUPT).
//
// C interface (ctypes, native/build.py):
//   int dial_j2k_info(data, n, info[27]) -> status; info = x0, y0, x1, y1,
//       components, XTOsiz, YTOsiz, XTsiz, YTsiz, tiles across, tiles down,
//       then per component (up to 4): precision, signed, dx, dy
//   int dial_j2k_decode(data, n, out, out_len) -> status; out = each
//       component's int32 plane (ceil(x1 / dx) - ceil(x0 / dx) wide), one
//       after the other

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int OK = 0;
constexpr int CORRUPT = 1;
constexpr int UNSUPPORTED = 2;
constexpr int kMaxComps = 4;
// Pillow's decompression-bomb limit (twice MAX_IMAGE_PIXELS): larger images are refused
constexpr int64_t kMaxPixels = 178956970;
// code-blocks and precincts of one tile: past this the structures alone
// would take gigabytes (64M samples in 4 x 4 code-blocks)
constexpr int64_t kMaxBlocks = int64_t(1) << 22;

struct Fail {
  int status;
};
[[noreturn]] void fail(int status) { throw Fail{status}; }

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// -- the MQ decoder (T.800 Annex C, as mqc.c decodes) ---------------------------

struct MqState {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};
constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1C01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02A1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run, 18 uniform
constexpr int CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19;

struct Mq {
  const uint8_t* bp = nullptr;  // into a buffer that ends with two 0xFF bytes
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[NUM_CTX], mps[NUM_CTX];

  void reset_states() {
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[0] = 4;
  }

  void bytein() {
    if (bp[0] == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += uint32_t(bp[0]) << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += uint32_t(bp[0]) << 8;
      ct = 8;
    }
  }

  void init(const uint8_t* start, size_t len) {
    bp = start;
    c = len == 0 ? 0xFFu << 16 : uint32_t(bp[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }

  int decode(int cx) {
    const MqState& s = kMq[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        d = !mps[cx];
        if (s.sw) mps[cx] = uint8_t(!mps[cx]);
        state[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= s.qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = uint8_t(!mps[cx]);
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }

  // raw (bypass) segments
  void raw_init(const uint8_t* start) {
    bp = start;
    c = 0;
    ct = 0;
  }

  int raw_decode() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (bp[0] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = bp[0];
          bp++;
          ct = 7;
        }
      } else {
        c = bp[0];
        bp++;
        ct = 8;
      }
    }
    ct--;
    return int((c >> ct) & 1);
  }
};

// -- coding parameters ---------------------------------------------------------

constexpr int STY_LAZY = 1, STY_RESET = 2, STY_TERMALL = 4, STY_VSC = 8, STY_PTERM = 16, STY_SEGSYM = 32;

struct CompCoding {
  // COD / COC
  int numres = 1, cblkw = 6, cblkh = 6, cblksty = 0, qmfbid = 0;
  int prcw[33], prch[33];
  // QCD / QCC
  int qntsty = 0, numgbits = 0, expn[97], mant[97];
  // RGN
  int roishift = 0;
};

struct Poc {
  int rs, cs, lye, re, ce, prg;
};

struct Coding {
  int csty = 0, prg = 0, numlayers = 1, mct = 0;
  CompCoding comp[kMaxComps];
  std::vector<Poc> pocs;
};

// -- tier-2 structures -----------------------------------------------------------

struct TagTree {
  std::vector<int> value, low, parent;

  void build(int lw, int lh) {
    value.clear();
    low.clear();
    parent.clear();
    if (lw <= 0 || lh <= 0) return;
    std::vector<int> start, ws, hs;
    int cw = lw, chh = lh, total = 0;
    for (;;) {
      start.push_back(total);
      ws.push_back(cw);
      hs.push_back(chh);
      total += cw * chh;
      if (cw * chh <= 1) break;
      cw = (cw + 1) / 2;
      chh = (chh + 1) / 2;
    }
    value.assign(total, 999);
    low.assign(total, 0);
    parent.assign(total, -1);
    for (size_t lv = 0; lv + 1 < start.size(); lv++)
      for (int y = 0; y < hs[lv]; y++)
        for (int x = 0; x < ws[lv]; x++)
          parent[start[lv] + y * ws[lv] + x] = start[lv + 1] + (y / 2) * ws[lv + 1] + x / 2;
  }
};

struct Bio {
  const uint8_t* bp;
  const uint8_t* start;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;

  Bio(const uint8_t* s, const uint8_t* e) : bp(s), start(s), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  int bit() {
    if (ct == 0) bytein();
    ct--;
    return int((buf >> ct) & 1);
  }
  int bits(int n) {
    int v = 0;
    for (int i = n - 1; i >= 0; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  size_t numbytes() const { return size_t(bp - start); }
};

int tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
  int stk[32], depth = 0;
  int node = leaf;
  while (t.parent[node] >= 0) {
    if (depth >= 32) fail(CORRUPT);
    stk[depth++] = node;
    node = t.parent[node];
  }
  int low = 0;
  for (;;) {
    if (low > t.low[node])
      t.low[node] = low;
    else
      low = t.low[node];
    while (low < threshold && low < t.value[node]) {
      if (bio.bit())
        t.value[node] = low;
      else
        ++low;
    }
    t.low[node] = low;
    if (depth == 0) break;
    node = stk[--depth];
  }
  return t.value[node] < threshold ? 1 : 0;
}

struct Seg {
  int len = 0, numpasses = 0, maxpasses = 0, newpasses = 0, newlen = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numsegs = 0;
  int first_new = 0, newsegs = 0;  // the segments the current packet adds to
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno = 0;
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int numbps = 0;
  float stepsize = 0;
  std::vector<Precinct> precs;
  bool empty() const { return x0 == x1 || y0 == y1; }
};

struct Resolution {
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int pw = 0, ph = 0, pdx = 0, pdy = 0, numbands = 0;
  Band bands[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int numres = 0;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
};

struct TilePart {
  size_t start, end;  // the bitstream after SOD
};

struct TileState {
  bool seen = false;
  Coding coding;      // from the main header, then this tile's first tile-part header
  bool has_cod = false, has_qcd = false, has_poc = false;
  std::vector<TilePart> parts;
  std::vector<uint8_t> ppt;  // joined in Zppt order
  std::vector<std::pair<int, std::vector<uint8_t>>> ppt_segs;
  std::vector<uint8_t> ppm;  // this tile's packed headers from PPM
  bool has_ppm = false;
};

// -- the decoder -----------------------------------------------------------------

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  // SIZ
  int64_t X0 = 0, Y0 = 0, X1 = 0, Y1 = 0, TX0 = 0, TY0 = 0, TDX = 0, TDY = 0;
  int ncomp = 0, tw = 0, th = 0;
  int prec[kMaxComps], sgnd[kMaxComps], dx[kMaxComps], dy[kMaxComps];
  // main header
  Coding main;
  bool main_cod = false, main_qcd = false, main_coc[kMaxComps] = {}, main_qcc[kMaxComps] = {};
  CompCoding main_cod_comp, main_qcd_comp;  // COD's and QCD's own values, before COC / QCC
  std::vector<std::pair<int, std::vector<uint8_t>>> ppm_segs;
  bool has_ppm = false;
  std::vector<uint8_t> ppm_all;
  size_t ppm_at = 0;
  std::vector<TileState> tiles;
  // output
  std::vector<int32_t>* planes = nullptr;  // per component, [comp h, comp w]
  int64_t cw[kMaxComps], chh[kMaxComps], cx0[kMaxComps], cy0[kMaxComps];

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8(size_t at) const {
    if (at >= n) fail(CORRUPT);
    return data[at];
  }
  int u16(size_t at) const { return (u8(at) << 8) | u8(at + 1); }
  int64_t u32(size_t at) const { return (int64_t(u16(at)) << 16) | u16(at + 2); }

  // -- marker segments -------------------------------------------------------

  void read_siz(size_t at, size_t end) {
    if (end - at < 36) fail(CORRUPT);
    int rsiz = u16(at);
    X1 = u32(at + 2);
    Y1 = u32(at + 6);
    X0 = u32(at + 10);
    Y0 = u32(at + 14);
    TDX = u32(at + 18);
    TDY = u32(at + 22);
    TX0 = u32(at + 26);
    TY0 = u32(at + 30);
    ncomp = u16(at + 34);
    if (ncomp < 1 || end - at < size_t(36 + 3 * ncomp)) fail(CORRUPT);
    if (X0 >= X1 || Y0 >= Y1 || TDX == 0 || TDY == 0 || TX0 > X0 || TY0 > Y0 || TX0 + TDX <= X0 ||
        TY0 + TDY <= Y0)
      fail(CORRUPT);
    for (int i = 0; i < ncomp; i++) {
      int ssiz = u8(at + 36 + 3 * i), xr = u8(at + 37 + 3 * i), yr = u8(at + 38 + 3 * i);
      if (xr == 0 || yr == 0) fail(CORRUPT);
      if ((ssiz & 0x7F) + 1 > 31) fail(CORRUPT);  // OpenJPEG reads up to 31 bits
      if (i < kMaxComps) {
        prec[i] = (ssiz & 0x7F) + 1;
        sgnd[i] = ssiz >> 7;
        dx[i] = xr;
        dy[i] = yr;
      }
    }
    if ((X1 - X0) * (Y1 - Y0) > kMaxPixels) fail(CORRUPT);
    tw = int(ceildiv(X1 - TX0, TDX));
    th = int(ceildiv(Y1 - TY0, TDY));
    if (int64_t(tw) * th > 65535) fail(CORRUPT);  // Isot is 16 bits
    if (rsiz & 0x8000) fail(UNSUPPORTED);  // Part 2 extensions
    if (rsiz & 0x4000) fail(UNSUPPORTED);  // Part 15 (HTJ2K)
  }

  int comp_index(size_t& at) const {
    int c = ncomp < 257 ? u8(at) : u16(at);
    at += ncomp < 257 ? 1 : 2;
    if (c >= ncomp) fail(CORRUPT);
    return c;
  }

  // SPcod / SPcoc from `at`; precincts defined when `prc`
  void read_spcod(size_t at, size_t end, bool prc, CompCoding& cc) {
    if (end - at < 5) fail(CORRUPT);
    cc.numres = u8(at) + 1;
    cc.cblkw = u8(at + 1) + 2;
    cc.cblkh = u8(at + 2) + 2;
    cc.cblksty = u8(at + 3);
    cc.qmfbid = u8(at + 4);
    if (cc.numres > 33 || cc.cblkw > 10 || cc.cblkh > 10 || cc.cblkw + cc.cblkh > 12) fail(CORRUPT);
    if (cc.cblksty & 0x40) fail(UNSUPPORTED);  // high-throughput block coder
    if (cc.cblksty & 0x80) fail(CORRUPT);
    if (cc.qmfbid > 1) fail(UNSUPPORTED);  // Part 2 wavelets
    if (prc) {
      if (end - at < size_t(5 + cc.numres)) fail(CORRUPT);
      for (int r = 0; r < cc.numres; r++) {
        int v = u8(at + 5 + r);
        cc.prcw[r] = v & 15;
        cc.prch[r] = v >> 4;
        if (r > 0 && (cc.prcw[r] == 0 || cc.prch[r] == 0)) fail(CORRUPT);
      }
    } else {
      for (int r = 0; r < cc.numres; r++) cc.prcw[r] = cc.prch[r] = 15;
    }
  }

  void read_cod(size_t at, size_t end, Coding& coding, CompCoding& own) {
    if (end - at < 5) fail(CORRUPT);
    coding.csty = u8(at);
    if (coding.csty & ~7) fail(CORRUPT);
    coding.prg = u8(at + 1);
    coding.numlayers = u16(at + 2);
    coding.mct = u8(at + 4);
    if (coding.prg > 4 || coding.numlayers < 1) fail(CORRUPT);
    if (coding.mct > 1) fail(coding.mct == 2 ? UNSUPPORTED : CORRUPT);
    read_spcod(at + 5, end, coding.csty & 1, own);
  }

  void read_qcx(size_t at, size_t end, CompCoding& cc) {
    if (end - at < 1) fail(CORRUPT);
    int sq = u8(at);
    cc.qntsty = sq & 31;
    cc.numgbits = sq >> 5;
    at++;
    if (cc.qntsty == 0) {
      int count = int(end - at);
      if (count > 97) fail(CORRUPT);
      for (int b = 0; b < count; b++) {
        cc.expn[b] = u8(at + b) >> 3;
        cc.mant[b] = 0;
      }
      for (int b = count; b < 97; b++) cc.expn[b] = cc.mant[b] = 0;
    } else if (cc.qntsty == 1 || cc.qntsty == 2) {
      int count = cc.qntsty == 1 ? 1 : int(end - at) / 2;
      if (count < 1 || count > 97) fail(CORRUPT);
      for (int b = 0; b < count; b++) {
        int v = u16(at + 2 * b);
        cc.expn[b] = v >> 11;
        cc.mant[b] = v & 0x7FF;
      }
      for (int b = count; b < 97; b++) cc.expn[b] = cc.mant[b] = 0;
      if (cc.qntsty == 1)  // derived: the other bands from band 0 (j2k.c)
        for (int b = 1; b < 97; b++) {
          cc.expn[b] = cc.expn[0] - (b - 1) / 3 > 0 ? cc.expn[0] - (b - 1) / 3 : 0;
          cc.mant[b] = cc.mant[0];
        }
    } else {
      fail(CORRUPT);
    }
  }

  // the segments of a main or tile-part header that set coding parameters
  bool coding_segment(int marker, size_t at, size_t end, Coding& coding, bool* cod_seen, bool* qcd_seen,
                      bool* coc, bool* qcc, CompCoding& cod_own, CompCoding& qcd_own, bool* poc_seen) {
    if (marker == 0xFF52) {  // COD
      read_cod(at, end, coding, cod_own);
      *cod_seen = true;
      for (int c = 0; c < ncomp && c < kMaxComps; c++)
        if (!coc[c]) copy_cod(cod_own, coding.comp[c]);
      return true;
    }
    if (marker == 0xFF53) {  // COC
      size_t p = at;
      int c = comp_index(p);
      if (p >= end) fail(CORRUPT);
      int scoc = u8(p);
      if (c < kMaxComps) {
        read_spcod(p + 1, end, scoc & 1, coding.comp[c]);
        coc[c] = true;
      }
      return true;
    }
    if (marker == 0xFF5C) {  // QCD
      read_qcx(at, end, qcd_own);
      *qcd_seen = true;
      for (int c = 0; c < ncomp && c < kMaxComps; c++)
        if (!qcc[c]) copy_qcd(qcd_own, coding.comp[c]);
      return true;
    }
    if (marker == 0xFF5D) {  // QCC
      size_t p = at;
      int c = comp_index(p);
      if (c < kMaxComps) {
        read_qcx(p, end, coding.comp[c]);
        qcc[c] = true;
      }
      return true;
    }
    if (marker == 0xFF5E) {  // RGN
      size_t p = at;
      int c = comp_index(p);
      if (end - p < 2) fail(CORRUPT);
      if (u8(p) != 0) fail(CORRUPT);  // only max-shift
      if (c < kMaxComps) coding.comp[c].roishift = u8(p + 1);
      return true;
    }
    if (marker == 0xFF5F) {  // POC
      if (!*poc_seen) coding.pocs.clear();
      *poc_seen = true;
      size_t entry = ncomp < 257 ? 7 : 9;
      if ((end - at) % entry || end == at) fail(CORRUPT);
      for (size_t p = at; p < end;) {
        Poc poc;
        poc.rs = u8(p++);
        poc.cs = ncomp < 257 ? u8(p++) : (p += 2, u16(p - 2));
        poc.lye = u16(p);
        p += 2;
        poc.re = u8(p++);
        poc.ce = ncomp < 257 ? u8(p++) : (p += 2, u16(p - 2));
        poc.prg = u8(p++);
        if (poc.ce == 0) poc.ce = 256;
        if (poc.prg > 4) fail(CORRUPT);
        coding.pocs.push_back(poc);
      }
      return true;
    }
    return false;
  }

  static void copy_cod(const CompCoding& from, CompCoding& to) {
    to.numres = from.numres;
    to.cblkw = from.cblkw;
    to.cblkh = from.cblkh;
    to.cblksty = from.cblksty;
    to.qmfbid = from.qmfbid;
    std::memcpy(to.prcw, from.prcw, sizeof(to.prcw));
    std::memcpy(to.prch, from.prch, sizeof(to.prch));
  }
  static void copy_qcd(const CompCoding& from, CompCoding& to) {
    to.qntsty = from.qntsty;
    to.numgbits = from.numgbits;
    std::memcpy(to.expn, from.expn, sizeof(to.expn));
    std::memcpy(to.mant, from.mant, sizeof(to.mant));
  }

  // the main header; leaves pos at the first SOT (or EOC)
  void read_main_header() {
    if (n < 4 || u16(0) != 0xFF4F || u16(2) != 0xFF51) fail(CORRUPT);
    pos = 2;
    bool first = true, poc_seen = false;
    for (;;) {
      if (pos + 2 > n) fail(CORRUPT);
      int marker = u16(pos);
      if (marker == 0xFF90 || marker == 0xFFD9) break;  // SOT, EOC
      if (marker < 0xFF00) fail(CORRUPT);
      size_t len = size_t(u16(pos + 2));
      size_t at = pos + 4, end = pos + 2 + len;
      if (len < 2 || end > n) fail(CORRUPT);
      if (first) {
        if (marker != 0xFF51) fail(CORRUPT);
        read_siz(at, end);
        first = false;
        if (ncomp > kMaxComps) return;  // the info reads no further
      } else if (coding_segment(marker, at, end, main, &main_cod, &main_qcd, main_coc, main_qcc, main_cod_comp,
                                main_qcd_comp, &poc_seen)) {
      } else if (marker == 0xFF60) {  // PPM
        if (len < 3) fail(CORRUPT);
        ppm_segs.push_back({u8(at), std::vector<uint8_t>(data + at + 1, data + end)});
        has_ppm = true;
      } else if (marker == 0xFF74 || marker == 0xFF75 || marker == 0xFF77 || marker == 0xFF78) {
        fail(UNSUPPORTED);  // Part 2 multiple component transformations (MCT, MCC, MCO, CBD)
      }
      // CAP, PLM, TLM, CRG, COM and unknown segments are skipped
      pos = end;
    }
    if (!main_cod || !main_qcd) fail(CORRUPT);
    if (has_ppm) {
      std::stable_sort(ppm_segs.begin(), ppm_segs.end(),
                       [](const auto& a, const auto& b) { return a.first < b.first; });
      for (auto& s : ppm_segs) ppm_all.insert(ppm_all.end(), s.second.begin(), s.second.end());
    }
  }

  // tile-parts up to EOC or the end of the stream
  void read_tiles() {
    tiles.assign(size_t(tw) * th, TileState());
    for (;;) {
      if (pos + 2 > n) fail(CORRUPT);  // no EOC: OpenJPEG fails reading the next tile header
      int marker = u16(pos);
      if (marker == 0xFFD9) break;
      if (marker != 0xFF90) fail(CORRUPT);
      if (pos + 12 > n) fail(CORRUPT);
      int lsot = u16(pos + 2);
      if (lsot != 10) fail(CORRUPT);
      int isot = u16(pos + 4);
      int64_t psot = u32(pos + 6);
      if (isot >= tw * th) fail(CORRUPT);
      TileState& t = tiles[size_t(isot)];
      size_t sot_at = pos;
      size_t tp_end;
      if (psot == 0) {
        // the last tile-part runs to EOC
        if (n < 2 || data[n - 2] != 0xFF || data[n - 1] != 0xD9) fail(CORRUPT);
        tp_end = n - 2;
      } else {
        if (psot < 14) fail(CORRUPT);
        if (sot_at + size_t(psot) > n) fail(CORRUPT);  // strict: the tile-part runs past the stream
        tp_end = sot_at + size_t(psot);
      }
      bool first_part = !t.seen;
      if (first_part) {
        t.seen = true;
        t.coding = main;
      }
      pos = sot_at + 12;
      CompCoding cod_own = main_cod_comp, qcd_own = main_qcd_comp;
      bool tile_coc[kMaxComps] = {}, tile_qcc[kMaxComps] = {};
      for (;;) {
        if (pos + 2 > tp_end) fail(CORRUPT);
        int m = u16(pos);
        if (m == 0xFF93) {  // SOD
          pos += 2;
          break;
        }
        size_t len = size_t(u16(pos + 2));
        size_t at = pos + 4, end = pos + 2 + len;
        if (len < 2 || end > tp_end) fail(CORRUPT);
        if (first_part && coding_segment(m, at, end, t.coding, &t.has_cod, &t.has_qcd, tile_coc, tile_qcc, cod_own,
                                         qcd_own, &t.has_poc)) {
          // a tile's COD overrides every main COC (tile_coc starts clear); its own COC overrides its COD
        } else if (m == 0xFF61) {  // PPT
          if (len < 3) fail(CORRUPT);
          t.ppt_segs.push_back({u8(at), std::vector<uint8_t>(data + at + 1, data + end)});
        }
        pos = end;
      }
      t.parts.push_back({pos, tp_end});
      if (has_ppm) {
        // this tile-part's packed headers: Nppm bytes from the joined PPM data
        if (ppm_at + 4 > ppm_all.size()) fail(CORRUPT);
        size_t nppm = (size_t(ppm_all[ppm_at]) << 24) | (size_t(ppm_all[ppm_at + 1]) << 16) |
                      (size_t(ppm_all[ppm_at + 2]) << 8) | ppm_all[ppm_at + 3];
        ppm_at += 4;
        if (ppm_at + nppm > ppm_all.size()) fail(CORRUPT);
        t.ppm.insert(t.ppm.end(), ppm_all.begin() + ppm_at, ppm_all.begin() + ppm_at + nppm);
        ppm_at += nppm;
        t.has_ppm = true;
      }
      pos = tp_end;
    }
  }

  // -- one tile --------------------------------------------------------------

  struct Tile {
    int64_t x0, y0, x1, y1;
    std::vector<TileComp> comps;
  };

  void init_tile(int index, TileState& ts, Tile& tile) {
    int p = index % tw, q = index / tw;
    tile.x0 = std::max(TX0 + p * TDX, X0);
    tile.y0 = std::max(TY0 + q * TDY, Y0);
    tile.x1 = std::min(TX0 + (p + 1) * TDX, X1);
    tile.y1 = std::min(TY0 + (q + 1) * TDY, Y1);
    tile.comps.resize(ncomp);
    int64_t blocks = 0;
    for (int c = 0; c < ncomp; c++) {
      CompCoding& cc = ts.coding.comp[c];
      TileComp& tc = tile.comps[c];
      tc.x0 = ceildiv(tile.x0, dx[c]);
      tc.y0 = ceildiv(tile.y0, dy[c]);
      tc.x1 = ceildiv(tile.x1, dx[c]);
      tc.y1 = ceildiv(tile.y1, dy[c]);
      tc.numres = cc.numres;
      tc.res.resize(cc.numres);
      size_t samples = size_t(tc.x1 - tc.x0) * size_t(tc.y1 - tc.y0);
      if (cc.qmfbid == 1)
        tc.idata.assign(samples, 0);
      else
        tc.fdata.assign(samples, 0.0f);
      for (int r = 0; r < cc.numres; r++) {
        Resolution& res = tc.res[r];
        int level = cc.numres - 1 - r;
        res.x0 = ceildivpow2(tc.x0, level);
        res.y0 = ceildivpow2(tc.y0, level);
        res.x1 = ceildivpow2(tc.x1, level);
        res.y1 = ceildivpow2(tc.y1, level);
        res.pdx = cc.prcw[r];
        res.pdy = cc.prch[r];
        int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx, py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
        int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx, py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
        res.pw = res.x0 == res.x1 ? 0 : int((px1 - px0) >> res.pdx);
        res.ph = res.y0 == res.y1 ? 0 : int((py1 - py0) >> res.pdy);
        int64_t cbgx0, cbgy0;
        int cbgw, cbgh;
        if (r == 0) {
          cbgx0 = px0;
          cbgy0 = py0;
          cbgw = res.pdx;
          cbgh = res.pdy;
          res.numbands = 1;
        } else {
          cbgx0 = ceildivpow2(px0, 1);
          cbgy0 = ceildivpow2(py0, 1);
          cbgw = res.pdx - 1;
          cbgh = res.pdy - 1;
          res.numbands = 3;
        }
        int cbw = std::min(cc.cblkw, cbgw), cbh = std::min(cc.cblkh, cbgh);
        int64_t nprec = int64_t(res.pw) * res.ph;
        blocks += nprec;
        if (blocks > kMaxBlocks) fail(CORRUPT);
        for (int b = 0; b < res.numbands; b++) {
          Band& band = res.bands[b];
          if (r == 0) {
            band.bandno = 0;
            band.x0 = ceildivpow2(tc.x0, level);
            band.y0 = ceildivpow2(tc.y0, level);
            band.x1 = ceildivpow2(tc.x1, level);
            band.y1 = ceildivpow2(tc.y1, level);
          } else {
            band.bandno = b + 1;
            int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
            band.x0 = ceildivpow2(tc.x0 - (xob << level), level + 1);
            band.y0 = ceildivpow2(tc.y0 - (yob << level), level + 1);
            band.x1 = ceildivpow2(tc.x1 - (xob << level), level + 1);
            band.y1 = ceildivpow2(tc.y1 - (yob << level), level + 1);
          }
          int step_index = r == 0 ? 0 : 3 * (r - 1) + b + 1;
          int expn = cc.expn[step_index], mant = cc.mant[step_index];
          // tcd.c: Rb = prec + log2 gain, the gain left out for 9/7 (BUG_WEIRD_TWO_INVK)
          int gain = cc.qmfbid == 0 ? 0 : (band.bandno == 0 ? 0 : (band.bandno == 3 ? 2 : 1));
          band.stepsize = float((1.0 + mant / 2048.0) * std::pow(2.0, double(prec[c] + gain - expn)));
          band.numbps = expn + cc.numgbits - 1;
          band.precs.resize(size_t(nprec));
          for (int64_t pi = 0; pi < nprec; pi++) {
            Precinct& prc = band.precs[size_t(pi)];
            int64_t gx0 = cbgx0 + (pi % res.pw) * (int64_t(1) << cbgw);
            int64_t gy0 = cbgy0 + (pi / res.pw) * (int64_t(1) << cbgh);
            int64_t gx1 = gx0 + (int64_t(1) << cbgw), gy1 = gy0 + (int64_t(1) << cbgh);
            int64_t x0 = std::max(gx0, band.x0), y0 = std::max(gy0, band.y0);
            int64_t x1 = std::min(gx1, band.x1), y1 = std::min(gy1, band.y1);
            if (x1 < x0) x1 = x0;
            if (y1 < y0) y1 = y0;
            int64_t bx0 = floordivpow2(x0, cbw) << cbw, by0 = floordivpow2(y0, cbh) << cbh;
            int64_t bx1 = ceildivpow2(x1, cbw) << cbw, by1 = ceildivpow2(y1, cbh) << cbh;
            prc.cw = int((bx1 - bx0) >> cbw);
            prc.ch = int((by1 - by0) >> cbh);
            int64_t ncb = int64_t(prc.cw) * prc.ch;
            blocks += ncb;
            if (blocks > kMaxBlocks) fail(CORRUPT);
            prc.cblks.resize(size_t(ncb));
            for (int64_t k = 0; k < ncb; k++) {
              Cblk& cb = prc.cblks[size_t(k)];
              int64_t sx = bx0 + (k % prc.cw) * (int64_t(1) << cbw), sy = by0 + (k / prc.cw) * (int64_t(1) << cbh);
              cb.x0 = int(std::max(sx, x0));
              cb.y0 = int(std::max(sy, y0));
              cb.x1 = int(std::min(sx + (int64_t(1) << cbw), x1));
              cb.y1 = int(std::min(sy + (int64_t(1) << cbh), y1));
            }
            prc.incl.build(prc.cw, prc.ch);
            prc.imsb.build(prc.cw, prc.ch);
          }
        }
      }
    }
  }

  // the packet (layer, res, comp, prec): header from `hdr`, body from `body`
  void read_packet(Tile& tile, TileState& ts, int layer, int r, int c, int p, const uint8_t*& hp,
                   const uint8_t* hend, const uint8_t*& bp, const uint8_t* bend, bool packed) {
    TileComp& tc = tile.comps[c];
    Resolution& res = tc.res[r];
    CompCoding& cc = ts.coding.comp[c];
    int csty = ts.coding.csty;
    // SOP in the bitstream
    if ((csty & 2) && bp + 6 <= bend && bp[0] == 0xFF && bp[1] == 0x91) bp += 6;
    const uint8_t* h = packed ? hp : bp;
    const uint8_t* he = packed ? hend : bend;
    Bio bio(h, he);
    int present = bio.bit();
    std::vector<Cblk*> included;
    if (present) {
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        if (size_t(p) >= band.precs.size()) fail(CORRUPT);
        Precinct& prc = band.precs[size_t(p)];
        int ncb = prc.cw * prc.ch;
        for (int k = 0; k < ncb; k++) {
          Cblk& cb = prc.cblks[size_t(k)];
          int inc;
          if (cb.numsegs == 0)
            inc = tgt_decode(bio, prc.incl, k, layer + 1);
          else
            inc = bio.bit();
          if (!inc) {
            cb.newsegs = 0;
            continue;
          }
          if (cb.numsegs == 0) {
            int i = 0;
            while (!tgt_decode(bio, prc.imsb, k, i)) {
              ++i;
              if (i > 74) fail(CORRUPT);
            }
            cb.numbps = band.numbps + 1 - i;
            cb.numlenbits = 3;
          }
          // number of new passes
          int np;
          if (!bio.bit())
            np = 1;
          else if (!bio.bit())
            np = 2;
          else if ((np = bio.bits(2)) != 3)
            np = 3 + np;
          else if ((np = bio.bits(5)) != 31)
            np = 6 + np;
          else
            np = 37 + bio.bits(7);
          int incr = 0;
          while (bio.bit()) {
            if (++incr > 32) fail(CORRUPT);
          }
          cb.numlenbits += incr;
          int segno;
          if (cb.numsegs == 0) {
            segno = 0;
            cb.segs.assign(1, Seg());
            init_seg(cb, 0, cc.cblksty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[size_t(segno)].numpasses == cb.segs[size_t(segno)].maxpasses) {
              ++segno;
              cb.segs.resize(size_t(segno) + 1);
              init_seg(cb, segno, cc.cblksty, false);
            }
          }
          int first_new = segno;
          int left = np;
          for (;;) {
            Seg& s = cb.segs[size_t(segno)];
            s.newpasses = std::min(s.maxpasses - s.numpasses, left);
            int nbits = cb.numlenbits + floorlog2(s.newpasses);
            if (nbits > 32) fail(CORRUPT);
            s.newlen = int(bio.bits(nbits > 31 ? 31 : nbits));
            left -= s.newpasses;
            if (left <= 0) break;
            ++segno;
            if (segno > 200) fail(CORRUPT);
            cb.segs.resize(size_t(segno) + 1);
            init_seg(cb, segno, cc.cblksty, false);
          }
          cb.newsegs = segno + 1;  // segments [first_new, segno] get data
          cb.numsegs = std::max(cb.numsegs, 1);
          cb.first_new = first_new;
          included.push_back(&cb);
        }
      }
    }
    bio.inalign();
    h += bio.numbytes();  // a header read past its data takes zeros there, as bio.c does
    if ((csty & 4) && h + 2 <= he && h[0] == 0xFF && h[1] == 0x92) h += 2;  // EPH
    if (packed)
      hp = h;
    else
      bp = h;
    // the body
    for (Cblk* cbp : included) {
      Cblk& cb = *cbp;
      for (int s = cb.first_new; s < cb.newsegs; s++) {
        Seg& seg = cb.segs[size_t(s)];
        if (seg.newlen < 0 || bp + seg.newlen > bend) fail(CORRUPT);  // strict: segment too long
        cb.data.insert(cb.data.end(), bp, bp + seg.newlen);
        bp += seg.newlen;
        seg.len += seg.newlen;
        seg.numpasses += seg.newpasses;
        seg.newlen = 0;
        seg.newpasses = 0;
      }
      cb.numsegs = cb.newsegs;
    }
  }

  static int floorlog2(int v) {
    int l = 0;
    while (v > 1) {
      v >>= 1;
      l++;
    }
    return l;
  }

  static void init_seg(Cblk& cb, int index, int sty, bool first) {
    Seg& s = cb.segs[size_t(index)];
    s = Seg();
    if (sty & STY_TERMALL) {
      s.maxpasses = 1;
    } else if (sty & STY_LAZY) {
      if (first)
        s.maxpasses = 10;
      else
        s.maxpasses = (cb.segs[size_t(index) - 1].maxpasses == 1 || cb.segs[size_t(index) - 1].maxpasses == 10) ? 2 : 1;
    } else {
      s.maxpasses = 109;
    }
  }

  // -- progression (pi.c) -----------------------------------------------------

  struct Packet {
    int l, r, c, p;
  };

  void packets(Tile& tile, TileState& ts, std::vector<Packet>& out) {
    int maxres = 0, maxprec = 0;
    for (int c = 0; c < ncomp; c++) {
      TileComp& tc = tile.comps[c];
      maxres = std::max(maxres, tc.numres);
      for (int r = 0; r < tc.numres; r++) maxprec = std::max(maxprec, tc.res[r].pw * tc.res[r].ph);
    }
    int L = ts.coding.numlayers;
    std::vector<Poc> vols;
    if (!ts.coding.pocs.empty()) {
      for (Poc v : ts.coding.pocs) {
        v.lye = std::min(v.lye, L);
        v.ce = std::min(v.ce, ncomp);
        vols.push_back(v);
      }
    } else {
      vols.push_back({0, 0, L, maxres, ncomp, ts.coding.prg});
    }
    size_t step_c = size_t(maxprec), step_r = size_t(ncomp) * step_c, step_l = size_t(maxres) * step_r;
    size_t total = size_t(L) * step_l;
    if (total > size_t(1) << 28) fail(CORRUPT);
    std::vector<uint8_t> include(total, 0);
    auto emit = [&](int l, int r, int c, int p) {
      size_t idx = size_t(l) * step_l + size_t(r) * step_r + size_t(c) * step_c + size_t(p);
      if (idx >= total) fail(CORRUPT);
      if (include[idx]) return;
      include[idx] = 1;
      out.push_back({l, r, c, p});
      if (out.size() > total) fail(CORRUPT);
    };
    for (const Poc& v : vols) {
      int r0 = v.rs, r1 = v.re, c0 = v.cs, c1 = v.ce, l1 = v.lye;
      switch (v.prg) {
        case 0:  // LRCP
          for (int l = 0; l < l1; l++)
            for (int r = r0; r < r1; r++)
              for (int c = c0; c < c1; c++) {
                if (r >= tile.comps[c].numres) continue;
                const Resolution& res = tile.comps[c].res[r];
                for (int p = 0; p < res.pw * res.ph; p++) emit(l, r, c, p);
              }
          break;
        case 1:  // RLCP
          for (int r = r0; r < r1; r++)
            for (int l = 0; l < l1; l++)
              for (int c = c0; c < c1; c++) {
                if (r >= tile.comps[c].numres) continue;
                const Resolution& res = tile.comps[c].res[r];
                for (int p = 0; p < res.pw * res.ph; p++) emit(l, r, c, p);
              }
          break;
        case 2:  // RPCL
        case 3:  // PCRL
        {
          int64_t sdx = 0, sdy = 0;
          for (int c = 0; c < ncomp; c++) position_steps(tile.comps[c], c, sdx, sdy);
          if (sdx == 0 || sdy == 0) fail(CORRUPT);
          if (v.prg == 2) {
            for (int r = r0; r < r1; r++)
              for (int64_t y = tile.y0; y < tile.y1; y += sdy - (y % sdy))
                for (int64_t x = tile.x0; x < tile.x1; x += sdx - (x % sdx))
                  for (int c = c0; c < c1; c++) position_packet(tile, c, r, x, y, l1, emit);
          } else {
            for (int64_t y = tile.y0; y < tile.y1; y += sdy - (y % sdy))
              for (int64_t x = tile.x0; x < tile.x1; x += sdx - (x % sdx))
                for (int c = c0; c < c1; c++)
                  for (int r = r0; r < std::min(r1, tile.comps[c].numres); r++)
                    position_packet(tile, c, r, x, y, l1, emit);
          }
          break;
        }
        case 4:  // CPRL
          for (int c = c0; c < c1; c++) {
            int64_t sdx = 0, sdy = 0;
            position_steps(tile.comps[c], c, sdx, sdy);
            if (sdx == 0 || sdy == 0) fail(CORRUPT);
            for (int64_t y = tile.y0; y < tile.y1; y += sdy - (y % sdy))
              for (int64_t x = tile.x0; x < tile.x1; x += sdx - (x % sdx))
                for (int r = r0; r < std::min(r1, tile.comps[c].numres); r++)
                  position_packet(tile, c, r, x, y, l1, emit);
          }
          break;
      }
    }
  }

  void position_steps(const TileComp& tc, int c, int64_t& sdx, int64_t& sdy) const {
    for (int r = 0; r < tc.numres; r++) {
      const Resolution& res = tc.res[r];
      int sh = res.pdx + tc.numres - 1 - r;
      if (sh < 32) {
        int64_t d = int64_t(dx[c]) << sh;
        sdx = sdx ? std::min(sdx, d) : d;
      }
      sh = res.pdy + tc.numres - 1 - r;
      if (sh < 32) {
        int64_t d = int64_t(dy[c]) << sh;
        sdy = sdy ? std::min(sdy, d) : d;
      }
    }
  }

  template <class Emit>
  void position_packet(Tile& tile, int c, int r, int64_t x, int64_t y, int l1, Emit& emit) {
    TileComp& tc = tile.comps[c];
    if (r >= tc.numres) return;
    Resolution& res = tc.res[r];
    int level = tc.numres - 1 - r;
    int64_t cdx = int64_t(dx[c]) << level, cdy = int64_t(dy[c]) << level;
    int64_t trx0 = ceildiv(tile.x0, cdx), try0 = ceildiv(tile.y0, cdy);
    int64_t trx1 = ceildiv(tile.x1, cdx), try1 = ceildiv(tile.y1, cdy);
    int rpx = res.pdx + level, rpy = res.pdy + level;
    if (rpx >= 31 || rpy >= 31) return;
    if (!(y % (int64_t(dy[c]) << rpy) == 0 || (y == tile.y0 && ((try0 << level) % (int64_t(1) << rpy)))))
      return;
    if (!(x % (int64_t(dx[c]) << rpx) == 0 || (x == tile.x0 && ((trx0 << level) % (int64_t(1) << rpx)))))
      return;
    if (res.pw == 0 || res.ph == 0) return;
    if (trx0 == trx1 || try0 == try1) return;
    int64_t prci = floordivpow2(ceildiv(x, cdx), res.pdx) - floordivpow2(trx0, res.pdx);
    int64_t prcj = floordivpow2(ceildiv(y, cdy), res.pdy) - floordivpow2(try0, res.pdy);
    int64_t p = prci + prcj * res.pw;
    if (p < 0 || p >= int64_t(res.pw) * res.ph) fail(CORRUPT);
    for (int l = 0; l < l1; l++) emit(l, r, c, int(p));
  }

  // -- tier-1 -----------------------------------------------------------------

  enum : uint8_t { F_SIG = 1, F_NEG = 2, F_VISIT = 4, F_REFINED = 8 };

  struct T1 {
    int w = 0, h = 0, fw = 0;
    std::vector<int32_t> val;
    std::vector<uint8_t> fl;  // (h + 2) x (w + 2), a border of zeros
    Mq mq;
    int orient = 0;
    bool vsc = false;

    uint8_t& f(int y, int x) { return fl[size_t(y + 1) * fw + size_t(x + 1)]; }
    int sig(int y, int x) { return f(y, x) & F_SIG; }

    // neighbours of (y, x), the row below a stripe left out in vertically causal mode
    void neighbours(int y, int x, int& hn, int& vn, int& dn) {
      bool south = !(vsc && (y & 3) == 3);
      hn = sig(y, x - 1) + sig(y, x + 1);
      vn = sig(y - 1, x) + (south ? sig(y + 1, x) : 0);
      dn = sig(y - 1, x - 1) + sig(y - 1, x + 1) + (south ? sig(y + 1, x - 1) + sig(y + 1, x + 1) : 0);
    }

    int zc_ctx(int y, int x) {
      int hn, vn, dn;
      neighbours(y, x, hn, vn, dn);
      if (orient == 1) std::swap(hn, vn);  // HL
      if (orient == 3) {
        int hv = hn + vn;
        if (dn == 0) return hv == 0 ? 0 : (hv == 1 ? 1 : 2);
        if (dn == 1) return hv == 0 ? 3 : (hv == 1 ? 4 : 5);
        if (dn == 2) return hv == 0 ? 6 : 7;
        return 8;
      }
      if (hn == 0) {
        if (vn == 0) return dn == 0 ? 0 : (dn == 1 ? 1 : 2);
        return vn == 1 ? 3 : 4;
      }
      if (hn == 1) {
        if (vn == 0) return dn == 0 ? 5 : 6;
        return 7;
      }
      return 8;
    }

    bool any_neighbour(int y, int x) {
      int hn, vn, dn;
      neighbours(y, x, hn, vn, dn);
      return hn + vn + dn != 0;
    }

    int contribution(int y, int x) {
      uint8_t v = f(y, x);
      if (!(v & F_SIG)) return 0;
      return (v & F_NEG) ? -1 : 1;
    }

    // sign context and the bit it is XORed with
    void sc_ctx(int y, int x, int& ctx, int& xorbit) {
      bool south = !(vsc && (y & 3) == 3);
      int hc = contribution(y, x - 1) + contribution(y, x + 1);
      int vc = contribution(y - 1, x) + (south ? contribution(y + 1, x) : 0);
      hc = hc > 0 ? 1 : (hc < 0 ? -1 : 0);
      vc = vc > 0 ? 1 : (vc < 0 ? -1 : 0);
      if (hc < 0) {
        hc = -hc;
        vc = -vc;
        xorbit = 1;
      } else if (hc == 0 && vc < 0) {
        vc = -vc;
        xorbit = 1;
      } else {
        xorbit = 0;
      }
      // (hc, vc) now (1, 1) 13, (1, 0) 12, (1, -1) 11, (0, 1) 10, (0, 0) 9
      if (hc == 1) ctx = vc == 1 ? 13 : (vc == 0 ? 12 : 11);
      else ctx = vc == 1 ? 10 : 9;
    }

    void set_sig(int y, int x, int neg, int32_t v) {
      val[size_t(y) * w + x] = neg ? -v : v;
      f(y, x) |= F_SIG | (neg ? F_NEG : 0);
    }

    void sigpass(int bpno, bool raw) {
      int32_t one = int32_t(1) << bpno, oph = one | (one >> 1);
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; x++)
          for (int y = k; y < std::min(k + 4, h); y++) {
            uint8_t& fv = f(y, x);
            if ((fv & (F_SIG | F_VISIT)) || !any_neighbour(y, x)) continue;
            if (raw) {
              if (mq.raw_decode()) set_sig(y, x, mq.raw_decode(), oph);
            } else if (mq.decode(zc_ctx(y, x))) {
              int ctx, xorbit;
              sc_ctx(y, x, ctx, xorbit);
              set_sig(y, x, mq.decode(ctx) ^ xorbit, oph);
            }
            fv |= F_VISIT;
          }
    }

    void refpass(int bpno, bool raw) {
      int32_t poshalf = (int32_t(1) << bpno) >> 1;
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; x++)
          for (int y = k; y < std::min(k + 4, h); y++) {
            uint8_t& fv = f(y, x);
            if ((fv & (F_SIG | F_VISIT)) != F_SIG) continue;
            int bit;
            if (raw) {
              bit = mq.raw_decode();
            } else {
              int ctx = (fv & F_REFINED) ? CTX_MAG + 2 : (any_neighbour(y, x) ? CTX_MAG + 1 : CTX_MAG);
              bit = mq.decode(ctx);
            }
            int32_t& v = val[size_t(y) * w + x];
            v += (bit ^ (v < 0)) ? poshalf : -poshalf;
            fv |= F_REFINED;
          }
    }

    void decode_one(int y, int x, int32_t oph) {
      if (mq.decode(zc_ctx(y, x))) {
        int ctx, xorbit;
        sc_ctx(y, x, ctx, xorbit);
        set_sig(y, x, mq.decode(ctx) ^ xorbit, oph);
      }
    }

    void clnpass(int bpno, bool segsym) {
      int32_t one = int32_t(1) << bpno, oph = one | (one >> 1);
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; x++) {
          int start = k;
          if (k + 3 < h) {
            bool run = true;
            for (int y = k; y < k + 4 && run; y++)
              run = !(f(y, x) & (F_SIG | F_VISIT)) && !any_neighbour(y, x);
            if (run) {
              if (!mq.decode(CTX_AGG)) continue;
              int r = mq.decode(CTX_UNI) << 1;
              r |= mq.decode(CTX_UNI);
              int y = k + r;
              int ctx, xorbit;
              sc_ctx(y, x, ctx, xorbit);
              set_sig(y, x, mq.decode(ctx) ^ xorbit, oph);
              start = y + 1;
            }
          }
          for (int y = start; y < std::min(k + 4, h); y++)
            if (!(f(y, x) & (F_SIG | F_VISIT))) decode_one(y, x, oph);
        }
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) f(y, x) &= uint8_t(~F_VISIT);
      if (segsym) {
        for (int i = 0; i < 4; i++) mq.decode(CTX_UNI);  // the symbol 1010 (a warning in OpenJPEG if not)
      }
    }
  };

  void decode_cblk(Cblk& cb, int orient, int roishift, int sty, T1& t1) {
    t1.w = cb.x1 - cb.x0;
    t1.h = cb.y1 - cb.y0;
    t1.fw = t1.w + 2;
    t1.val.assign(size_t(t1.w) * t1.h, 0);
    t1.fl.assign(size_t(t1.h + 2) * t1.fw, 0);
    t1.orient = orient;
    t1.vsc = sty & STY_VSC;
    t1.mq.reset_states();
    int64_t bpno = int64_t(roishift) + cb.numbps;
    if (bpno >= 31) fail(CORRUPT);  // t1.c refuses bpno_plus_one >= 31
    if (cb.numsegs == 0 || t1.w == 0 || t1.h == 0) return;
    int passtype = 2;
    size_t at = 0;
    std::vector<uint8_t> buf;
    for (int s = 0; s < cb.numsegs; s++) {
      Seg& seg = cb.segs[size_t(s)];
      bool raw = (bpno <= int64_t(cb.numbps) - 4) && passtype < 2 && (sty & STY_LAZY);
      if (at + size_t(seg.len) > cb.data.size()) fail(CORRUPT);
      buf.assign(cb.data.begin() + at, cb.data.begin() + at + seg.len);
      buf.push_back(0xFF);
      buf.push_back(0xFF);
      if (raw)
        t1.mq.raw_init(buf.data());
      else
        t1.mq.init(buf.data(), size_t(seg.len));
      at += size_t(seg.len);
      for (int p = 0; p < seg.numpasses && bpno >= 1; p++) {
        if (passtype == 0)
          t1.sigpass(int(bpno), raw);
        else if (passtype == 1)
          t1.refpass(int(bpno), raw);
        else
          t1.clnpass(int(bpno), sty & STY_SEGSYM);
        if ((sty & STY_RESET) && !raw) t1.mq.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          bpno--;
        }
      }
    }
  }

  // code-blocks -> the tile-component's coefficients
  void tier1(Tile& tile, TileState& ts) {
    T1 t1;
    for (int c = 0; c < ncomp; c++) {
      TileComp& tc = tile.comps[c];
      CompCoding& cc = ts.coding.comp[c];
      int64_t stride = tc.x1 - tc.x0;
      for (int r = 0; r < tc.numres; r++) {
        Resolution& res = tc.res[r];
        for (int b = 0; b < res.numbands; b++) {
          Band& band = res.bands[b];
          if (band.empty()) continue;
          for (Precinct& prc : band.precs)
            for (Cblk& cb : prc.cblks) {
              decode_cblk(cb, band.bandno, cc.roishift, cc.cblksty, t1);
              int64_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
              if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
              if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
              if (cc.roishift) {
                int32_t thresh = int32_t(1) << std::min(cc.roishift, 30);
                for (int32_t& v : t1.val) {
                  if (cc.roishift >= 31) {
                    v = 0;
                    continue;
                  }
                  int32_t mag = v < 0 ? -v : v;
                  if (mag >= thresh) {
                    mag >>= cc.roishift;
                    v = v < 0 ? -mag : mag;
                  }
                }
              }
              for (int j = 0; j < t1.h; j++)
                for (int i = 0; i < t1.w; i++) {
                  size_t at = size_t(y + j) * size_t(stride) + size_t(x + i);
                  int32_t v = t1.val[size_t(j) * t1.w + i];
                  if (cc.qmfbid == 1)
                    tc.idata[at] = v / 2;
                  else
                    tc.fdata[at] = float(v) * (0.5f * band.stepsize);
                }
            }
        }
      }
    }
  }

  // -- inverse DWT (dwt.c) ----------------------------------------------------

  // one line of `len` samples whose first lies at an even (cas 0) or odd
  // (cas 1) coordinate: low band first (sn samples), then the high band
  static void idwt53_line(int32_t* line, int sn, int dn, int cas, std::vector<int32_t>& tmp) {
    int len = sn + dn;
    if (cas == 0) {
      if (len <= 1) return;
    } else if (len == 1) {
      line[0] /= 2;
      return;
    }
    tmp.resize(size_t(len));
    // interleave: low at cas + 2k, high at 1 - cas + 2k
    for (int k = 0; k < sn; k++) tmp[size_t(cas + 2 * k)] = line[k];
    for (int k = 0; k < dn; k++) tmp[size_t(1 - cas + 2 * k)] = line[sn + k];
    auto at = [&](int i) {
      if (i < 0) i = -i;
      if (i >= len) i = 2 * (len - 1) - i;
      return tmp[size_t(i)];
    };
    for (int i = cas; i < len; i += 2) tmp[size_t(i)] -= (at(i - 1) + at(i + 1) + 2) >> 2;
    for (int i = 1 - cas; i < len; i += 2) tmp[size_t(i)] += (at(i - 1) + at(i + 1)) >> 1;
    std::memcpy(line, tmp.data(), sizeof(int32_t) * size_t(len));
  }

  static void idwt97_line(float* line, int sn, int dn, int cas, std::vector<float>& tmp) {
    int len = sn + dn;
    if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;  // left as it is
    constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f, kDelta = 0.443506852f;
    constexpr float kK = 1.230174105f, kTwoInvK = 1.625732422f;
    tmp.resize(size_t(len));
    for (int k = 0; k < sn; k++) tmp[size_t(cas + 2 * k)] = line[k];
    for (int k = 0; k < dn; k++) tmp[size_t(1 - cas + 2 * k)] = line[sn + k];
    int a = cas, b = 1 - cas;
    for (int i = a; i < len; i += 2) tmp[size_t(i)] *= kK;
    for (int i = b; i < len; i += 2) tmp[size_t(i)] *= kTwoInvK;
    auto lift = [&](int first, float coef) {
      for (int i = first; i < len; i += 2) {
        int l = i - 1 < 0 ? i + 1 : i - 1;
        if (i + 1 < len) {
          tmp[size_t(i)] = tmp[size_t(i)] + ((tmp[size_t(l)] + tmp[size_t(i + 1)]) * coef);
        } else if (i - 1 >= 0) {
          tmp[size_t(i)] = tmp[size_t(i)] + tmp[size_t(i - 1)] * (coef + coef);
        }
      }
    };
    lift(a, -kDelta);
    lift(b, -kGamma);
    lift(a, -kBeta);
    lift(b, -kAlpha);
    std::memcpy(line, tmp.data(), sizeof(float) * size_t(len));
  }

  template <class T, class F>
  static void idwt(std::vector<T>& d, const TileComp& tc, F line_fn) {
    int64_t stride = tc.x1 - tc.x0;
    std::vector<T> tmp, col;
    for (int r = 1; r < tc.numres; r++) {
      const Resolution& prev = tc.res[r - 1];
      const Resolution& res = tc.res[r];
      int rw = int(res.x1 - res.x0), rh = int(res.y1 - res.y0);
      int sn = int(prev.x1 - prev.x0), dn = rw - sn;
      int cas = int(res.x0 % 2);
      for (int y = 0; y < rh; y++) line_fn(&d[size_t(y) * size_t(stride)], sn, dn, cas, tmp);
      int vsn = int(prev.y1 - prev.y0), vdn = rh - vsn;
      int vcas = int(res.y0 % 2);
      col.resize(size_t(rh));
      for (int x = 0; x < rw; x++) {
        for (int y = 0; y < rh; y++) col[size_t(y)] = d[size_t(y) * size_t(stride) + size_t(x)];
        line_fn(col.data(), vsn, vdn, vcas, tmp);
        for (int y = 0; y < rh; y++) d[size_t(y) * size_t(stride) + size_t(x)] = col[size_t(y)];
      }
    }
  }

  // -- MCT, level shift, and into the component planes -----------------------------

  void finish_tile(Tile& tile, TileState& ts) {
    for (int c = 0; c < ncomp; c++) {
      TileComp& tc = tile.comps[c];
      if (ts.coding.comp[c].qmfbid == 1)
        idwt(tc.idata, tc, idwt53_line);
      else
        idwt(tc.fdata, tc, idwt97_line);
    }
    if (ts.coding.mct == 1 && ncomp >= 3) {
      size_t count = tile.comps[0].idata.size() + tile.comps[0].fdata.size();
      for (int c = 1; c < 3; c++)
        if (tile.comps[c].idata.size() + tile.comps[c].fdata.size() != count) fail(CORRUPT);  // tcd.c fails
      if (ts.coding.comp[0].qmfbid == 1) {
        for (int c = 1; c < 3; c++)
          if (tile.comps[c].idata.size() != count) fail(CORRUPT);
        int32_t *c0 = tile.comps[0].idata.data(), *c1 = tile.comps[1].idata.data(), *c2 = tile.comps[2].idata.data();
        for (size_t i = 0; i < count; i++) {
          int32_t y = c0[i], u = c1[i], v = c2[i];
          int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        for (int c = 1; c < 3; c++)
          if (tile.comps[c].fdata.size() != count) fail(CORRUPT);
        float *c0 = tile.comps[0].fdata.data(), *c1 = tile.comps[1].fdata.data(), *c2 = tile.comps[2].fdata.data();
        for (size_t i = 0; i < count; i++) {
          float y = c0[i], u = c1[i], v = c2[i];
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f) - (v * 0.71414f);
          float b = y + (u * 1.772f);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
    }
    for (int c = 0; c < ncomp; c++) {
      TileComp& tc = tile.comps[c];
      int64_t lo = sgnd[c] ? -(int64_t(1) << (prec[c] - 1)) : 0;
      int64_t hi = sgnd[c] ? (int64_t(1) << (prec[c] - 1)) - 1 : (int64_t(1) << prec[c]) - 1;
      int64_t shift = sgnd[c] ? 0 : int64_t(1) << (prec[c] - 1);
      int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
      std::vector<int32_t>& plane = planes[c];
      for (int64_t y = 0; y < h; y++)
        for (int64_t x = 0; x < w; x++) {
          size_t i = size_t(y * w + x);
          int64_t v;
          if (ts.coding.comp[c].qmfbid == 1) {
            v = int64_t(tc.idata[i]) + shift;
          } else {
            float fv = tc.fdata[i];
            if (fv > float(INT32_MAX))
              v = hi;
            else if (fv < float(INT32_MIN))
              v = lo;
            else
              v = int64_t(std::lrintf(fv)) + shift;
          }
          v = std::min(std::max(v, lo), hi);
          plane[size_t((tc.y0 - cy0[c] + y) * cw[c] + (tc.x0 - cx0[c] + x))] = int32_t(v);
        }
    }
  }

  void decode_tile(int index) {
    TileState& ts = tiles[size_t(index)];
    if (!ts.seen) return;  // never reached: stays zero
    for (int c = 0; c < ncomp; c++)
      if (ts.coding.comp[c].numres < 1) fail(CORRUPT);
    Tile tile;
    init_tile(index, ts, tile);
    // the tile's bitstream and packed headers
    std::vector<uint8_t> body;
    for (const TilePart& tp : ts.parts) body.insert(body.end(), data + tp.start, data + tp.end);
    std::vector<uint8_t> packed;
    bool is_packed = ts.has_ppm || !ts.ppt_segs.empty();
    if (!ts.ppt_segs.empty()) {
      if (has_ppm) fail(CORRUPT);
      std::stable_sort(ts.ppt_segs.begin(), ts.ppt_segs.end(),
                       [](const auto& a, const auto& b) { return a.first < b.first; });
      for (auto& s : ts.ppt_segs) packed.insert(packed.end(), s.second.begin(), s.second.end());
    } else if (ts.has_ppm) {
      packed = ts.ppm;
    }
    std::vector<Packet> order;
    packets(tile, ts, order);
    const uint8_t* bp = body.data();
    const uint8_t* bend = body.data() + body.size();
    const uint8_t* hp = packed.data();
    const uint8_t* hend = packed.data() + packed.size();
    for (const Packet& pk : order) read_packet(tile, ts, pk.l, pk.r, pk.c, pk.p, hp, hend, bp, bend, is_packed);
    tier1(tile, ts);
    finish_tile(tile, ts);
  }

  void decode(std::vector<int32_t>* out_planes) {
    planes = out_planes;
    read_main_header();
    if (ncomp > kMaxComps) fail(UNSUPPORTED);
    for (int c = 0; c < ncomp; c++) {
      cx0[c] = ceildiv(X0, dx[c]);
      cy0[c] = ceildiv(Y0, dy[c]);
      cw[c] = ceildiv(X1, dx[c]) - cx0[c];
      chh[c] = ceildiv(Y1, dy[c]) - cy0[c];
    }
    read_tiles();
    for (int t = 0; t < tw * th; t++) decode_tile(t);
  }
};

}  // namespace

extern "C" {

int dial_j2k_info(const uint8_t* data, long long n, int* info) {
  try {
    Decoder d(data, size_t(n));
    d.read_main_header();
    int64_t vals[11] = {d.X0, d.Y0, d.X1, d.Y1, d.ncomp, d.TX0, d.TY0, d.TDX, d.TDY, d.tw, d.th};
    for (int i = 0; i < 11; i++) {
      if (vals[i] > INT32_MAX) return CORRUPT;
      info[i] = int(vals[i]);
    }
    for (int c = 0; c < d.ncomp && c < kMaxComps; c++) {
      info[11 + 4 * c] = d.prec[c];
      info[12 + 4 * c] = d.sgnd[c];
      info[13 + 4 * c] = d.dx[c];
      info[14 + 4 * c] = d.dy[c];
    }
    return OK;
  } catch (const Fail& f) {
    return f.status;
  } catch (...) {  // no exception crosses the C interface (an allocation that fails)
    return CORRUPT;
  }
}

int dial_j2k_decode(const uint8_t* data, long long n, int32_t* out, long long out_len) {
  try {
    Decoder d(data, size_t(n));
    std::vector<int32_t> planes[kMaxComps];
    // sizes first, from the header alone
    {
      Decoder h(data, size_t(n));
      h.read_main_header();
      if (h.ncomp > kMaxComps) return UNSUPPORTED;
      long long total = 0;
      for (int c = 0; c < h.ncomp; c++) {
        int64_t w = ceildiv(h.X1, h.dx[c]) - ceildiv(h.X0, h.dx[c]);
        int64_t hh = ceildiv(h.Y1, h.dy[c]) - ceildiv(h.Y0, h.dy[c]);
        planes[c].assign(size_t(w * hh), 0);
        total += w * hh;
      }
      if (total > out_len) return CORRUPT;
    }
    d.decode(planes);
    long long at = 0;
    for (int c = 0; c < d.ncomp; c++) {
      std::memcpy(out + at, planes[c].data(), planes[c].size() * sizeof(int32_t));
      at += (long long)planes[c].size();
    }
    return OK;
  } catch (const Fail& f) {
    return f.status;
  } catch (...) {
    return CORRUPT;
  }
}

}  // extern "C"
