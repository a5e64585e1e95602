// JPEG 2000 Part 1 codestream decoder (ISO/IEC 15444-1), for io/jpeg2000.py.
//
// What PIL hands its JPEG 2000 plugin comes from OpenJPEG 2.5.4
// (Pillow 12.1.0's bundled libopenjp2): each component's samples after the
// DC level shift, clamped to the component's range. This file computes the
// same samples from the codestream:
//
//  * the main and tile-part headers: SIZ, COD, COC, QCD, QCC, COM, TLM,
//    PLM, PLT, CRG, SOT (tile-parts of a tile in TPsot order, tiles in any
//    order), SOD, EOC; packet headers inline or in PPM/PPT, SOP and EPH
//    markers skipped where the coding style allows them; a POC that
//    restates the COD's progression over every layer, resolution and
//    component is read as the COD's order;
//  * tier 2: tag trees, layers, the five progression orders (the
//    position-driven ones visit each precinct where OpenJPEG's iterator
//    does: at the tile's first row and column, else at its own corner on
//    the reference grid), precincts, empty packets, code-blocks of any
//    size, Lblock and the pass-count code words;
//  * tier 1: the MQ decoder (Annex C, with 0xFF 0xFF past the end of the
//    data) and the three EBCOT passes with their context labels (Annex
//    D), default code-block style. Values are kept doubled, as OpenJPEG
//    keeps them: a coefficient that becomes significant at bit-plane p is
//    3·2^(p−1) in units of half the last plane, each refinement moves it
//    by half of what remains, so a coefficient left short of the last
//    plane sits in the middle of its interval;
//  * dequantisation: reversible (doubled value / 2, truncated toward 0 as
//    C's integer division), scalar-derived and scalar-expounded (doubled
//    value × half the step size Δb = (1 + μb/2^11)·2^(R − εb), R the
//    component's precision — OpenJPEG's decoder leaves out the band's
//    gain and folds it into the 9/7 high-pass scaling, 2/K, below), guard
//    bits in Mb = G + εb − 1;
//  * the inverse transforms: the 5/3 integer lifting and the 9/7 float
//    lifting (K on low-pass samples, 2/K on high-pass ones, then the four
//    lifting steps with OpenJPEG's constants, x + (l + r)·c and at a
//    mirrored edge x + l·2c), rows first then columns at each level, a
//    one-sample signal left as it is (halved by 5/3 at an odd start);
//    RCT and ICT (OpenJPEG's single-precision coefficients) on the first
//    three components when the COD asks for it; the DC level shift, a
//    9/7 sample rounded by lrintf (ties to even) before it, and the clamp
//    to the component's range.
//
// Float arithmetic must round as OpenJPEG's does: every product and sum
// is rounded on its own (OpenJPEG's SSE lifting and ICT have no fused
// multiply-add). The port builds with -march=native, so the pragma after
// the includes turns contraction off: g++ then fuses no a·b + c into an
// FMA on a host CPU that has one.
//
// Refused by name (ImageFormatError in Python), being things PIL's
// encoder never writes: code-block styles (BYPASS, RESET, TERMALL, VSC,
// PTERM, SEGSYM, HT), RGN, a POC that changes the order, component
// subsampling, Part 2 codestreams (Rsiz bit 15, their markers) and
// Part 15 (CAP). A truncated or corrupt codestream raises.
#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#pragma GCC optimize("fp-contract=off")

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[512];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error(buf);
}

int ceildiv(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }
int ceildivpow2(int64_t a, int e) { return (int)((a + ((int64_t)1 << e) - 1) >> e); }
int floordivpow2(int64_t a, int e) { return (int)(a >> e); }

// ------------------------------------------------------------ byte reader
struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  void need(size_t k) const {
    if (pos + k > n) fail("truncated codestream");
  }
  int u8() { need(1); return p[pos++]; }
  int u16() { need(2); int v = (p[pos] << 8) | p[pos + 1]; pos += 2; return v; }
  uint32_t u32() {
    need(4);
    uint32_t v = ((uint32_t)p[pos] << 24) | ((uint32_t)p[pos + 1] << 16) |
                 ((uint32_t)p[pos + 2] << 8) | p[pos + 3];
    pos += 4;
    return v;
  }
};

// ------------------------------------------------------------- parameters
constexpr int kMaxRes = 33;

struct CompStyle {  // SPcod / SPcoc
  bool set = false;
  int nl = 0, xcb = 6, ycb = 6, cblksty = 0, qmfbid = 1;
  int prcw[kMaxRes], prch[kMaxRes];
};

struct StepSize {
  int expn = 0, mant = 0;
};

struct Quant {  // SPqcd / SPqcc
  bool set = false;
  int style = 0, guard = 0;
  std::vector<StepSize> steps;
};

struct Params {  // one level of COD/COC/QCD/QCC (main header or a tile's)
  bool cod_set = false;
  int csty = 0, prog = 0, layers = 1, mct = 0;
  CompStyle cod;
  std::vector<CompStyle> coc;
  Quant qcd;
  std::vector<Quant> qcc;
  bool poc = false;
  std::vector<int> poc_entries;  // RS, CS, LYE, RE, CE, P per entry
};

struct Siz {
  int rsiz = 0;
  int64_t xsiz = 0, ysiz = 0, xo = 0, yo = 0, xt = 0, yt = 0, xto = 0, yto = 0;
  int nc = 0;
  std::vector<int> prec, sgnd, dx, dy;
};

void read_spcod(Reader& r, CompStyle& s, bool precincts, size_t end) {
  s.nl = r.u8();
  s.xcb = r.u8() + 2;
  s.ycb = r.u8() + 2;
  s.cblksty = r.u8();
  s.qmfbid = r.u8();
  if (s.nl > 32) fail("%d decomposition levels (at most 32)", s.nl);
  if (s.xcb > 10 || s.ycb > 10 || s.xcb + s.ycb > 12)
    fail("code-block size 2^%d x 2^%d is not allowed", s.xcb, s.ycb);
  if (s.qmfbid > 1) fail("Part 2 (JPX) codestream: wavelet transform %d", s.qmfbid);
  if (s.cblksty) {
    static const char* names[7] = {"BYPASS", "RESET", "TERMALL", "VSC", "PTERM", "SEGSYM", "HT"};
    std::string got;
    for (int b = 0; b < 8; ++b)
      if (s.cblksty & (1 << b)) {
        if (!got.empty()) got += ", ";
        got += b < 7 ? names[b] : "bit 7";
      }
    fail("code-block style %s is not read (PIL's encoder writes none)", got.c_str());
  }
  for (int i = 0; i <= s.nl; ++i) {
    if (precincts) {
      if (r.pos >= end) fail("COD/COC: precinct sizes missing");
      int v = r.u8();
      s.prcw[i] = v & 15;
      s.prch[i] = v >> 4;
      if (i > 0 && (s.prcw[i] == 0 || s.prch[i] == 0))
        fail("precinct exponent 0 at resolution %d", i);
    } else {
      s.prcw[i] = s.prch[i] = 15;
    }
  }
  s.set = true;
}

void read_quant(Reader& r, Quant& q, size_t end) {
  int sq = r.u8();
  q.style = sq & 31;
  q.guard = sq >> 5;
  q.steps.clear();
  if (q.style == 0) {
    while (r.pos < end) q.steps.push_back({r.u8() >> 3, 0});
  } else if (q.style == 1 || q.style == 2) {
    while (r.pos + 2 <= end) {
      int v = r.u16();
      q.steps.push_back({v >> 11, v & 0x7ff});
    }
  } else {
    fail("quantization style %d is not Part 1", q.style);
  }
  if (q.steps.empty()) fail("QCD/QCC without step sizes");
  q.set = true;
}

// ------------------------------------------------------------ tag trees
struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  int w = 0, h = 0;
  void init(int w_, int h_) {
    w = w_;
    h = h_;
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw, lh;
    int cw = w, ch = h;
    for (;;) {
      lw.push_back(cw);
      lh.push_back(ch);
      if (cw == 1 && ch == 1) break;
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    }
    size_t total = 0;
    for (size_t i = 0; i < lw.size(); ++i) total += (size_t)lw[i] * lh[i];
    nodes.assign(total, {-1, 999, 0});
    size_t base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      size_t next = base + (size_t)lw[l] * lh[l];
      for (int y = 0; y < lh[l]; ++y)
        for (int x = 0; x < lw[l]; ++x)
          nodes[base + (size_t)y * lw[l] + x].parent =
              (int)(next + (size_t)(y / 2) * lw[l + 1] + x / 2);
      base = next;
    }
  }
};

// ------------------------------------------------------ packet header bits
struct BitReader {
  const uint8_t* p;
  size_t n, pos;
  uint32_t buf = 0;
  int ct = 0;
  BitReader(const uint8_t* p_, size_t n_, size_t pos_) : p(p_), n(n_), pos(pos_) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (pos < n) buf |= p[pos++];
    else fail("truncated packet header");
  }
  int bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  int bits(int k) {
    int v = 0;
    while (k-- > 0) v = (v << 1) | bit();
    return v;
  }
  void align() {  // opj_bio_inalign
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
};

int tag_decode(BitReader& b, TagTree& t, int leaf, int threshold) {
  int stack[40], sp = 0;
  int node = leaf;
  while (t.nodes[node].parent >= 0) {
    stack[sp++] = node;
    node = t.nodes[node].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node& nd = t.nodes[node];
    if (low > nd.low) nd.low = low;
    else low = nd.low;
    while (low < threshold && low < nd.value) {
      if (b.bit()) nd.value = low;
      else ++low;
    }
    nd.low = low;
    if (sp == 0) break;
    node = stack[--sp];
  }
  return t.nodes[node].value < threshold;
}

// --------------------------------------------------------- tile structure
struct CodeBlock {
  int x0, y0, x1, y1;
  bool included = false;
  int numbps = 0, lblock = 3, passes = 0;
  std::vector<uint8_t> data;
};

struct PrecBand {
  int cw = 0, ch = 0;
  std::vector<CodeBlock> cbs;
  TagTree incl, zbp;
};

struct Precinct {
  PrecBand bands[3];
  int64_t xref = 0, yref = 0;
};

struct Band {
  int orient = 0;  // 0 LL, 1 HL, 2 LH, 3 HH
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int numbps = 0;
  float step = 0.f;  // half of OpenJPEG's band step size
};

struct Resolution {
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int ppx = 15, ppy = 15, pw = 0, ph = 0;
  int nb = 1;
  Band bands[3];
  std::vector<Precinct> precs;
};

struct TileComp {
  int x0, y0, x1, y1;
  CompStyle cs;
  Quant q;
  std::vector<Resolution> res;
  std::vector<int32_t> ci;  // 5/3 coefficients, then samples
  std::vector<float> cf;    // 9/7 coefficients
};

struct TilePart {
  int tpsot;
  size_t start, end;   // the tile-part's data in the codestream
  std::vector<uint8_t> ppm;  // its packet headers from the main header's PPM
};

struct Tile {
  Params p;
  bool seen = false;
  int tnsot = 0;
  std::vector<TilePart> parts;
  std::vector<std::pair<int, std::vector<uint8_t>>> ppt;  // (Zppt, Ippt)
};

// ------------------------------------------------------------- MQ decoder
struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

struct Mq {
  const uint8_t* bp;  // data followed by 0xFF 0xFF
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[19], mps[19];
  void bytein() {
    if (bp[0] == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += (uint32_t)bp[0] << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += (uint32_t)bp[0] << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, size_t len) {
    bp = data;
    c = len == 0 ? (0xffu << 16) : ((uint32_t)bp[0] << 16);
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
    for (int i = 0; i < 19; ++i) state[i] = mps[i] = 0;
    state[0] = 4;    // all-zero neighbourhood
    state[17] = 3;   // run length
    state[18] = 46;  // uniform
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
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
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = 1 - mps[cx];
        state[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= (uint32_t)s.qe << 16;
      if (!(a & 0x8000)) {
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = 1 - mps[cx];
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
};

// ----------------------------------------------------------------- tier 1
constexpr uint8_t kSig = 1, kNeg = 2, kVisit = 4, kRefined = 8;

struct T1 {
  int w, h, fw;
  std::vector<uint8_t> f;  // (h + 2) × (w + 2), a border of insignificant cells
  std::vector<int32_t> v;  // doubled values
  Mq mq;
  int orient;

  uint8_t& at(int x, int y) { return f[(size_t)(y + 1) * fw + x + 1]; }
  bool sig(int x, int y) { return f[(size_t)(y + 1) * fw + x + 1] & kSig; }

  void counts(int x, int y, int& hs, int& vs, int& ds) {
    hs = sig(x - 1, y) + sig(x + 1, y);
    vs = sig(x, y - 1) + sig(x, y + 1);
    ds = sig(x - 1, y - 1) + sig(x + 1, y - 1) + sig(x - 1, y + 1) + sig(x + 1, y + 1);
  }

  int zc_ctx(int x, int y) {
    int hs, vs, ds;
    counts(x, y, hs, vs, ds);
    if (orient == 1) std::swap(hs, vs);  // HL: the table with H and V swapped
    if (orient == 3) {
      int hv = hs + vs;
      if (ds >= 3) return 8;
      if (ds == 2) return hv >= 1 ? 7 : 6;
      if (ds == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
      return hv >= 2 ? 2 : hv;
    }
    if (hs == 2) return 8;
    if (hs == 1) return vs >= 1 ? 7 : ds >= 1 ? 6 : 5;
    if (vs == 2) return 4;
    if (vs == 1) return 3;
    return ds >= 2 ? 2 : ds;
  }

  int contrib(int x, int y) {
    uint8_t c = at(x, y);
    if (!(c & kSig)) return 0;
    return (c & kNeg) ? -1 : 1;
  }

  // the sign: context 9-13 and the XOR bit of Table D.3
  void decode_sign(int x, int y, int p) {
    int hc = std::max(-1, std::min(1, contrib(x - 1, y) + contrib(x + 1, y)));
    int vc = std::max(-1, std::min(1, contrib(x, y - 1) + contrib(x, y + 1)));
    int ctx, xb;
    if (hc == 0) {
      ctx = vc == 0 ? 9 : 10;
      xb = vc < 0;
    } else {
      ctx = vc == 0 ? 12 : (vc == hc ? 13 : 11);
      xb = hc < 0;
    }
    int neg = mq.decode(ctx) ^ xb;
    const int32_t one = 1 << p, oneplushalf = one | (one >> 1);
    v[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
    at(x, y) |= kSig | (neg ? kNeg : 0);
  }

  bool any_neighbour(int x, int y) {
    return sig(x - 1, y) || sig(x + 1, y) || sig(x, y - 1) || sig(x, y + 1) ||
           sig(x - 1, y - 1) || sig(x + 1, y - 1) || sig(x - 1, y + 1) || sig(x + 1, y + 1);
  }

  void sigpass(int p) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint8_t& c = at(x, y);
          if ((c & (kSig | kVisit)) || !any_neighbour(x, y)) continue;
          c |= kVisit;
          if (mq.decode(zc_ctx(x, y))) decode_sign(x, y, p);
        }
  }

  void refpass(int p) {
    const int32_t half = (1 << p) >> 1;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint8_t& c = at(x, y);
          if ((c & (kSig | kVisit)) != kSig) continue;
          int ctx = (c & kRefined) ? 16 : any_neighbour(x, y) ? 15 : 14;
          int bit = mq.decode(ctx);
          int32_t& val = v[(size_t)y * w + x];
          val += (bit ^ (val < 0)) ? half : -half;
          c |= kRefined;
        }
  }

  void clnpass(int p) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int y = y0;
        const int y1 = std::min(y0 + 4, h);
        if (y1 - y0 == 4) {
          bool run = true;
          for (int yy = y0; yy < y1 && run; ++yy)
            run = !(at(x, yy) & (kSig | kVisit)) && !any_neighbour(x, yy);
          if (run) {
            if (!mq.decode(17)) {
              for (int yy = y0; yy < y1; ++yy) at(x, yy) &= ~kVisit;
              continue;
            }
            int r = mq.decode(18) << 1;
            r |= mq.decode(18);
            y = y0 + r;
            decode_sign(x, y, p);
            ++y;
          }
        }
        for (; y < y1; ++y) {
          uint8_t& c = at(x, y);
          if (!(c & (kSig | kVisit)) && mq.decode(zc_ctx(x, y))) decode_sign(x, y, p);
        }
        for (int yy = y0; yy < y1; ++yy) at(x, yy) &= ~kVisit;
      }
  }

  void decode(CodeBlock& cb, int orient_) {
    w = cb.x1 - cb.x0;
    h = cb.y1 - cb.y0;
    fw = w + 2;
    orient = orient_;
    f.assign((size_t)(h + 2) * fw, 0);
    v.assign((size_t)w * h, 0);
    if (!cb.included || cb.passes == 0) return;
    size_t len = cb.data.size();
    cb.data.push_back(0xff);
    cb.data.push_back(0xff);
    mq.init(cb.data.data(), len);
    int p = cb.numbps, type = 2;  // the first pass: cleanup at the top plane
    for (int pass = 0; pass < cb.passes && p >= 1; ++pass) {
      if (type == 0) sigpass(p);
      else if (type == 1) refpass(p);
      else clnpass(p);
      if (++type == 3) {
        type = 0;
        --p;
      }
    }
  }
};

// ------------------------------------------------------------- the lifting
// 9/7 (OpenJPEG dwt.c): constants, K on low-pass samples, 2/K on high-pass
// ones (the band gain left out of the step size comes back here)
constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
                kDelta = 0.443506852f, kK = 1.230174105f, kTwoInvK = 1.625732422f;

// x[i0 + 2i] += (x[left] + x[right])·c for the `cnt` samples of one
// parity, their neighbours the other parity's, mirrored at the ends
void lift97(float* x, int n, int first, float c) {
  for (int i = first; i < n; i += 2) {
    const bool l = i - 1 >= 0, r = i + 1 < n;
    if (l && r) x[i] = x[i] + ((x[i - 1] + x[i + 1]) * c);
    else if (l) x[i] = x[i] + x[i - 1] * (c + c);
    else if (r) x[i] = x[i] + ((x[i + 1] + x[i + 1]) * c);
  }
}

void idwt97_1d(float* x, int n, int cas) {
  const int sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  const int a = cas, b = 1 - cas;  // low-pass samples at a + 2i, high-pass at b + 2i
  for (int i = a; i < n; i += 2) x[i] = x[i] * kK;
  for (int i = b; i < n; i += 2) x[i] = x[i] * kTwoInvK;
  lift97(x, n, a, -kDelta);
  lift97(x, n, b, -kGamma);
  lift97(x, n, a, -kBeta);
  lift97(x, n, b, -kAlpha);
}

void idwt53_1d(int32_t* x, int n, int cas) {
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  auto at = [&](int i) { return x[i < 0 ? -i : i >= n ? 2 * (n - 1) - i : i]; };
  const int a = cas, b = 1 - cas;
  for (int i = a; i < n; i += 2) x[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = b; i < n; i += 2) x[i] += (at(i - 1) + at(i + 1)) >> 1;
}

// interleave the low (first sn) and high samples of `in` (stride `st`)
// into `line`, transform, write back
template <typename T, typename F>
void idwt_2d(T* data, int stride, const Resolution* res, int nl, F transform) {
  std::vector<T> line;
  for (int r = 1; r <= nl; ++r) {
    const Resolution& lo = res[r - 1];
    const Resolution& cur = res[r];
    const int rw = cur.x1 - cur.x0, rh = cur.y1 - cur.y0;
    const int snw = lo.x1 - lo.x0, snh = lo.y1 - lo.y0;
    const int casx = cur.x0 & 1, casy = cur.y0 & 1;
    line.resize(std::max(rw, rh));
    if (rw > 0)
      for (int y = 0; y < rh; ++y) {
        T* row = data + (size_t)y * stride;
        for (int i = 0; i < rw; ++i) {
          // sample i of the row: low-pass at even absolute positions,
          // the (i / 2)-th of its band either way
          const bool low = ((i + casx) & 1) == 0;
          line[i] = low ? row[i / 2] : row[snw + i / 2];
        }
        transform(line.data(), rw, casx);
        std::copy(line.begin(), line.begin() + rw, row);
      }
    if (rh > 0)
      for (int x = 0; x < rw; ++x) {
        for (int i = 0; i < rh; ++i) {
          const bool low = ((i + casy) & 1) == 0;
          line[i] = data[(size_t)(low ? i / 2 : snh + i / 2) * stride + x];
        }
        transform(line.data(), rh, casy);
        for (int i = 0; i < rh; ++i) data[(size_t)i * stride + x] = line[i];
      }
  }
}

// ---------------------------------------------------------------- decoder
struct Decoder {
  const uint8_t* d;
  size_t n;
  Siz siz;
  Params main;
  std::vector<Tile> tiles;
  std::vector<uint8_t> ppm_all;  // Ippm in Zppm order
  std::vector<std::pair<int, std::vector<uint8_t>>> ppm_segs;
  bool has_ppm = false;
  int ntx = 0, nty = 0;
  std::vector<int64_t>* log = nullptr;
  bool parsed = false;

  Decoder(const uint8_t* d_, size_t n_) : d(d_), n(n_) {}

  void read_siz(Reader& r) {
    siz.rsiz = r.u16();
    siz.xsiz = r.u32();
    siz.ysiz = r.u32();
    siz.xo = r.u32();
    siz.yo = r.u32();
    siz.xt = r.u32();
    siz.yt = r.u32();
    siz.xto = r.u32();
    siz.yto = r.u32();
    siz.nc = r.u16();
    if (siz.rsiz & 0x8000) fail("Part 2 (JPX) codestream (Rsiz 0x%04x)", siz.rsiz);
    if (siz.rsiz & 0x4000) fail("HTJ2K (Part 15) codestream (Rsiz 0x%04x)", siz.rsiz);
    if (siz.nc < 1 || siz.nc > 16384) fail("%d components", siz.nc);
    // OpenJPEG keeps tile coordinates in 32-bit ints and refuses the rest
    if (siz.xsiz > INT32_MAX || siz.ysiz > INT32_MAX)
      fail("SIZ: image coordinates past 2^31 - 1 (Xsiz %lld, Ysiz %lld)", (long long)siz.xsiz,
           (long long)siz.ysiz);
    if (siz.xsiz <= siz.xo || siz.ysiz <= siz.yo || siz.xt == 0 || siz.yt == 0 ||
        siz.xto > siz.xo || siz.yto > siz.yo || siz.xto + siz.xt <= siz.xo ||
        siz.yto + siz.yt <= siz.yo)
      fail("SIZ: inconsistent image and tile geometry");
    for (int c = 0; c < siz.nc; ++c) {
      int s = r.u8();
      siz.prec.push_back((s & 0x7f) + 1);
      siz.sgnd.push_back(s >> 7);
      siz.dx.push_back(r.u8());
      siz.dy.push_back(r.u8());
      if (siz.prec.back() > 16) fail("component %d has %d-bit samples (at most 16)", c,
                                     siz.prec.back());
      if (siz.dx.back() != 1 || siz.dy.back() != 1)
        fail("component subsampling (component %d: %dx%d) is not read", c, siz.dx.back(),
             siz.dy.back());
    }
    ntx = ceildiv(siz.xsiz - siz.xto, siz.xt);
    nty = ceildiv(siz.ysiz - siz.yto, siz.yt);
    if ((int64_t)ntx * nty > 65535) fail("%d tiles", ntx * nty);
    tiles.resize((size_t)ntx * nty);
    main.coc.resize(siz.nc);
    main.qcc.resize(siz.nc);
  }

  int comp_index(Reader& r) { return siz.nc < 257 ? r.u8() : r.u16(); }

  // a marker segment of a header; `tile` null in the main header
  void header_segment(int marker, Reader& r, size_t end, Params& p, Tile* tile) {
    switch (marker) {
      case 0xFF52: {  // COD
        p.csty = r.u8();
        if (p.csty & ~7) fail("COD: coding style 0x%02x", p.csty);
        p.prog = r.u8();
        p.layers = r.u16();
        p.mct = r.u8();
        if (p.prog > 4) fail("progression order %d", p.prog);
        if (p.layers < 1) fail("COD: no layers");
        if (p.mct > 1) fail("Part 2 (JPX) codestream: multiple component transform %d", p.mct);
        read_spcod(r, p.cod, p.csty & 1, end);
        p.cod_set = true;
        break;
      }
      case 0xFF53: {  // COC
        int c = comp_index(r);
        if (c >= siz.nc) fail("COC for component %d of %d", c, siz.nc);
        int s = r.u8();
        read_spcod(r, p.coc[c], s & 1, end);
        break;
      }
      case 0xFF5C: read_quant(r, p.qcd, end); break;  // QCD
      case 0xFF5D: {  // QCC
        int c = comp_index(r);
        if (c >= siz.nc) fail("QCC for component %d of %d", c, siz.nc);
        read_quant(r, p.qcc[c], end);
        break;
      }
      case 0xFF5E: fail("RGN (region of interest) is not read (PIL's encoder writes none)");
      case 0xFF5F: {  // POC
        p.poc = true;
        while (r.pos < end) {
          p.poc_entries.push_back(r.u8());
          p.poc_entries.push_back(comp_index(r));
          p.poc_entries.push_back(r.u16());
          p.poc_entries.push_back(r.u8());
          p.poc_entries.push_back(siz.nc < 257 ? r.u8() : r.u16());
          p.poc_entries.push_back(r.u8());
        }
        break;
      }
      case 0xFF60: {  // PPM
        if (tile) fail("PPM in a tile-part header");
        int z = r.u8();
        ppm_segs.push_back({z, std::vector<uint8_t>(d + r.pos, d + end)});
        has_ppm = true;
        break;
      }
      case 0xFF61: {  // PPT
        if (!tile) fail("PPT in the main header");
        int z = r.u8();
        tile->ppt.push_back({z, std::vector<uint8_t>(d + r.pos, d + end)});
        break;
      }
      case 0xFF55: case 0xFF57: case 0xFF58: case 0xFF63: case 0xFF64:
        break;  // TLM, PLM, PLT, CRG, COM: nothing the samples depend on
      case 0xFF50: fail("HTJ2K (Part 15) codestream: CAP marker");
      default:
        if (marker >= 0xFF70 && marker <= 0xFF7F)
          fail("Part 2 (JPX) codestream: marker 0x%04X", marker);
        fail("unknown marker 0x%04X", marker);
    }
  }

  void parse() {  // once: decode() parses unless a caller has
    if (parsed) return;
    parsed = true;
    Reader r(d, n);
    if (r.u16() != 0xFF4F) fail("not a JPEG 2000 codestream (no SOC)");
    if (r.u16() != 0xFF51) fail("no SIZ after SOC");
    size_t seg = r.pos;
    int len = r.u16();
    if (len < 41) fail("SIZ too short");
    r.need(len - 2);
    read_siz(r);
    r.pos = seg + len;
    // main header
    for (;;) {
      int marker = r.u16();
      if (marker == 0xFF90) break;
      if (marker == 0xFFD9) fail("no tile in the codestream");
      if ((marker & 0xFF00) != 0xFF00) fail("corrupt main header");
      size_t at = r.pos;
      int l = r.u16();
      if (l < 2) fail("marker 0x%04X: length %d", marker, l);
      r.need(l - 2);
      header_segment(marker, r, at + l, main, nullptr);
      r.pos = at + l;
    }
    if (!main.cod_set) fail("no COD in the main header");
    if (!main.qcd.set) fail("no QCD in the main header");
    if (has_ppm) {
      std::stable_sort(ppm_segs.begin(), ppm_segs.end(),
                       [](const auto& a, const auto& b) { return a.first < b.first; });
      for (auto& s : ppm_segs) ppm_all.insert(ppm_all.end(), s.second.begin(), s.second.end());
    }
    size_t ppm_pos = 0;
    // tile-parts; r sits after an SOT marker
    for (;;) {
      size_t sot = r.pos - 2;
      int l = r.u16();
      if (l != 10) fail("SOT length %d", l);
      int isot = r.u16();
      uint32_t psot = r.u32();
      int tpsot = r.u8(), tnsot = r.u8();
      if (isot >= (int)tiles.size()) fail("tile %d of %zu", isot, tiles.size());
      Tile& t = tiles[isot];
      if (!t.seen) {
        t.p = main;
        t.p.cod_set = false;
        t.p.qcd.set = false;
        for (auto& c : t.p.coc) c.set = false;
        for (auto& q : t.p.qcc) q.set = false;
        t.p.poc = false;
        t.p.poc_entries.clear();
        t.seen = true;
      }
      if (tnsot) {
        if (t.tnsot && t.tnsot != tnsot) fail("tile %d: TNsot %d then %d", isot, t.tnsot, tnsot);
        t.tnsot = tnsot;
      }
      size_t end = psot ? sot + psot : n - 2;
      if (psot && psot < 14) fail("Psot %u", psot);
      if (end > n) fail("truncated codestream: tile-part of tile %d runs past the end", isot);
      for (;;) {
        int marker = r.u16();
        if (marker == 0xFF93) break;
        if ((marker & 0xFF00) != 0xFF00) fail("corrupt tile-part header");
        size_t at = r.pos;
        int ml = r.u16();
        if (ml < 2) fail("marker 0x%04X: length %d", marker, ml);
        r.need(ml - 2);
        if (tpsot != 0 && marker != 0xFF61 && marker != 0xFF58 && marker != 0xFF64)
          fail("marker 0x%04X in tile-part %d of tile %d", marker, tpsot, isot);
        header_segment(marker, r, at + ml, t.p, &t);
        r.pos = at + ml;
      }
      if (r.pos > end) fail("tile-part header past Psot");
      TilePart tp{tpsot, r.pos, end, {}};
      if (has_ppm) {
        if (ppm_pos + 4 > ppm_all.size()) fail("PPM: no packet headers for a tile-part");
        uint32_t nppm = ((uint32_t)ppm_all[ppm_pos] << 24) | (ppm_all[ppm_pos + 1] << 16) |
                        (ppm_all[ppm_pos + 2] << 8) | ppm_all[ppm_pos + 3];
        ppm_pos += 4;
        if (ppm_pos + nppm > ppm_all.size()) fail("PPM: truncated packet headers");
        tp.ppm.assign(ppm_all.begin() + ppm_pos, ppm_all.begin() + ppm_pos + nppm);
        ppm_pos += nppm;
      }
      t.parts.push_back(std::move(tp));
      r.pos = end;
      int marker = r.u16();
      if (marker == 0xFFD9) break;
      if (marker != 0xFF90) fail("corrupt codestream: marker 0x%04X after a tile-part", marker);
    }
    for (size_t i = 0; i < tiles.size(); ++i) {
      Tile& t = tiles[i];
      if (!t.seen) fail("tile %zu is missing", i);
      std::stable_sort(t.parts.begin(), t.parts.end(),
                       [](const TilePart& a, const TilePart& b) { return a.tpsot < b.tpsot; });
      for (size_t k = 0; k < t.parts.size(); ++k)
        if (t.parts[k].tpsot != (int)k) fail("tile %zu: tile-part %zu is missing", i, k);
      if (t.tnsot && (int)t.parts.size() != t.tnsot)
        fail("tile %zu: %zu of %d tile-parts", i, t.parts.size(), t.tnsot);
    }
  }

  // the effective parameters of component c in tile t
  void resolve(const Tile& t, int c, CompStyle& cs, Quant& q, int& csty, int& prog, int& layers,
               int& mct) const {
    const Params& m = main;
    const Params& p = t.p;
    csty = p.cod_set ? p.csty : m.csty;
    prog = p.cod_set ? p.prog : m.prog;
    layers = p.cod_set ? p.layers : m.layers;
    mct = p.cod_set ? p.mct : m.mct;
    cs = p.coc[c].set ? p.coc[c] : p.cod_set ? p.cod : m.coc[c].set ? m.coc[c] : m.cod;
    q = p.qcc[c].set ? p.qcc[c] : p.qcd.set ? p.qcd : m.qcc[c].set ? m.qcc[c] : m.qcd;
  }

  // every tile into out (components, H, W), which holds `out_len` samples
  void decode(int32_t* out, int64_t out_len) {
    parse();
    const int W = (int)(siz.xsiz - siz.xo), H = (int)(siz.ysiz - siz.yo);
    if (out_len < (int64_t)siz.nc * W * H) fail("sample buffer too small");
    for (int ty = 0; ty < nty; ++ty)
      for (int tx = 0; tx < ntx; ++tx) decode_tile(ty * ntx + tx, tx, ty, out, W, H);
  }

  void decode_tile(int ti, int tx, int ty, int32_t* out, int W, int H) {
    Tile& t = tiles[ti];
    const int64_t tx0 = std::max(siz.xto + tx * siz.xt, siz.xo);
    const int64_t ty0 = std::max(siz.yto + ty * siz.yt, siz.yo);
    const int64_t tx1 = std::min(siz.xto + (tx + 1) * siz.xt, siz.xsiz);
    const int64_t ty1 = std::min(siz.yto + (ty + 1) * siz.yt, siz.ysiz);
    int csty = 0, prog = 0, layers = 1, mct = 0;
    std::vector<TileComp> comps(siz.nc);
    int maxres = 0;
    for (int c = 0; c < siz.nc; ++c) {
      TileComp& tc = comps[c];
      resolve(t, c, tc.cs, tc.q, csty, prog, layers, mct);
      tc.x0 = (int)tx0;
      tc.y0 = (int)ty0;
      tc.x1 = (int)tx1;
      tc.y1 = (int)ty1;
      build_comp(tc, c);
      maxres = std::max(maxres, tc.cs.nl + 1);
    }
    if (t.p.poc || main.poc) check_poc(t.p.poc ? t.p : main, prog, layers, maxres);
    // packet headers: inline, or from PPT (per tile) or PPM (per tile-part)
    std::vector<uint8_t> body;
    std::vector<std::pair<size_t, size_t>> spans;  // (body offset, codestream offset)
    for (auto& tp : t.parts) {
      spans.push_back({body.size(), tp.start});
      body.insert(body.end(), d + tp.start, d + tp.end);
    }
    std::vector<uint8_t> hdr;
    bool sep = false;
    if (!t.ppt.empty()) {
      if (has_ppm) fail("both PPM and PPT");
      std::stable_sort(t.ppt.begin(), t.ppt.end(),
                       [](const auto& a, const auto& b) { return a.first < b.first; });
      for (auto& s : t.ppt) hdr.insert(hdr.end(), s.second.begin(), s.second.end());
      sep = true;
    } else if (has_ppm) {
      for (auto& tp : t.parts) hdr.insert(hdr.end(), tp.ppm.begin(), tp.ppm.end());
      sep = true;
    }
    read_packets(comps, prog, layers, maxres, csty, body, sep ? &hdr : nullptr, spans, ti);
    // tier 1, dequantisation, inverse transforms
    for (TileComp& tc : comps) decode_comp(tc);
    if (mct) {
      if (siz.nc < 3) fail("multiple component transform with %d components", siz.nc);
      const size_t np = (size_t)(tx1 - tx0) * (ty1 - ty0);
      if (comps[0].cs.qmfbid == 1) {
        int32_t *c0 = comps[0].ci.data(), *c1 = comps[1].ci.data(), *c2 = comps[2].ci.data();
        if (comps[1].cs.qmfbid != 1 || comps[2].cs.qmfbid != 1)
          fail("RCT over components of different transforms");
        for (size_t i = 0; i < np; ++i) {
          const int32_t y = c0[i], u = c1[i], v = c2[i];
          const int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        if (comps[1].cs.qmfbid != 0 || comps[2].cs.qmfbid != 0)
          fail("ICT over components of different transforms");
        float *c0 = comps[0].cf.data(), *c1 = comps[1].cf.data(), *c2 = comps[2].cf.data();
        for (size_t i = 0; i < np; ++i) {
          const float y = c0[i], u = c1[i], v = c2[i];
          const float r = y + (v * 1.402f);
          const float g = y - (u * 0.34413f) - (v * 0.71414f);
          const float b = y + (u * 1.772f);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
    }
    // DC level shift and clamp, into the image
    const int w = (int)(tx1 - tx0), h = (int)(ty1 - ty0);
    for (int c = 0; c < siz.nc; ++c) {
      TileComp& tc = comps[c];
      const int prec = siz.prec[c];
      const bool sg = siz.sgnd[c];
      const int64_t lo = sg ? -(1LL << (prec - 1)) : 0;
      const int64_t hi = sg ? (1LL << (prec - 1)) - 1 : (1LL << prec) - 1;
      const int64_t shift = sg ? 0 : 1LL << (prec - 1);
      int32_t* plane = out + (size_t)c * W * H;
      for (int y = 0; y < h; ++y) {
        int32_t* row = plane + (size_t)(ty0 - siz.yo + y) * W + (tx0 - siz.xo);
        for (int x = 0; x < w; ++x) {
          int64_t v;
          if (tc.cs.qmfbid == 1) {
            v = (int64_t)tc.ci[(size_t)y * w + x] + shift;
          } else {
            const float f = tc.cf[(size_t)y * w + x];
            if (f > (float)INT32_MAX) { row[x] = (int32_t)hi; continue; }
            if (f < (float)INT32_MIN) { row[x] = (int32_t)lo; continue; }
            v = (int64_t)lrintf(f) + shift;
          }
          row[x] = (int32_t)std::min(hi, std::max(lo, v));
        }
      }
    }
  }

  void check_poc(const Params& p, int prog, int layers, int maxres) {
    const std::vector<int>& e = p.poc_entries;
    if (e.size() == 6 && e[0] == 0 && e[1] == 0 && e[2] == layers && e[3] == maxres &&
        e[4] == siz.nc && e[5] == prog)
      return;
    fail("POC (progression order change) is not read (PIL's encoder writes none)");
  }

  void build_comp(TileComp& tc, int c) {
    const CompStyle& cs = tc.cs;
    const int nl = cs.nl;
    tc.res.resize(nl + 1);
    const int nbands_needed = 3 * nl + 1;
    if (tc.q.style != 1 && (int)tc.q.steps.size() < nbands_needed)
      fail("component %d: %zu step sizes for %d bands", c, tc.q.steps.size(), nbands_needed);
    for (int r = 0; r <= nl; ++r) {
      Resolution& res = tc.res[r];
      const int lev = nl - r;
      res.x0 = ceildivpow2(tc.x0, lev);
      res.y0 = ceildivpow2(tc.y0, lev);
      res.x1 = ceildivpow2(tc.x1, lev);
      res.y1 = ceildivpow2(tc.y1, lev);
      res.ppx = cs.prcw[r];
      res.ppy = cs.prch[r];
      const int64_t prx0 = (int64_t)floordivpow2(res.x0, res.ppx) << res.ppx;
      const int64_t pry0 = (int64_t)floordivpow2(res.y0, res.ppy) << res.ppy;
      const int64_t prx1 = (int64_t)ceildivpow2(res.x1, res.ppx) << res.ppx;
      const int64_t pry1 = (int64_t)ceildivpow2(res.y1, res.ppy) << res.ppy;
      res.pw = res.x0 == res.x1 ? 0 : (int)((prx1 - prx0) >> res.ppx);
      res.ph = res.y0 == res.y1 ? 0 : (int)((pry1 - pry0) >> res.ppy);
      res.nb = r == 0 ? 1 : 3;
      for (int b = 0; b < res.nb; ++b) {
        Band& band = res.bands[b];
        band.orient = r == 0 ? 0 : b + 1;
        if (r == 0) {
          band.x0 = res.x0; band.y0 = res.y0; band.x1 = res.x1; band.y1 = res.y1;
        } else {
          const int nb = nl - r + 1;
          const int64_t xo = band.orient & 1, yo = band.orient >> 1;
          band.x0 = (int)ceildivpow2(tc.x0 - (xo << (nb - 1)), nb);
          band.y0 = (int)ceildivpow2(tc.y0 - (yo << (nb - 1)), nb);
          band.x1 = (int)ceildivpow2(tc.x1 - (xo << (nb - 1)), nb);
          band.y1 = (int)ceildivpow2(tc.y1 - (yo << (nb - 1)), nb);
        }
        const int gb = r == 0 ? 0 : 3 * (r - 1) + b + 1;
        StepSize st;
        if (tc.q.style == 1) {
          st.mant = tc.q.steps[0].mant;
          const int e = tc.q.steps[0].expn - (gb == 0 ? 0 : (gb - 1) / 3);
          st.expn = e > 0 ? e : 0;
        } else {
          st = tc.q.steps[gb];
        }
        band.numbps = st.expn + tc.q.guard - 1;
        // OpenJPEG tcd.c: (float)((1 + μ/2048)·2^(prec − ε)), the decoder's
        // irreversible gain 0; t1 scales by half of it
        band.step = 0.5f * (float)((1.0 + st.mant / 2048.0) *
                                   std::pow(2.0, (double)(siz.prec[c] - st.expn)));
      }
      // precincts and their code-blocks
      const int cbgw = r == 0 ? res.ppx : res.ppx - 1;
      const int cbgh = r == 0 ? res.ppy : res.ppy - 1;
      const int cbw = std::min(cs.xcb, cbgw), cbh = std::min(cs.ycb, cbgh);
      const int64_t cbg_x0 = r == 0 ? prx0 : ceildivpow2(prx0, 1);
      const int64_t cbg_y0 = r == 0 ? pry0 : ceildivpow2(pry0, 1);
      res.precs.resize((size_t)res.pw * res.ph);
      for (int pj = 0; pj < res.ph; ++pj)
        for (int pi = 0; pi < res.pw; ++pi) {
          Precinct& pr = res.precs[(size_t)pj * res.pw + pi];
          for (int b = 0; b < res.nb; ++b) {
            const Band& band = res.bands[b];
            PrecBand& pb = pr.bands[b];
            const int64_t gx0 = cbg_x0 + ((int64_t)pi << cbgw);
            const int64_t gy0 = cbg_y0 + ((int64_t)pj << cbgh);
            const int px0 = (int)std::max<int64_t>(gx0, band.x0);
            const int py0 = (int)std::max<int64_t>(gy0, band.y0);
            const int px1 = (int)std::min<int64_t>(gx0 + ((int64_t)1 << cbgw), band.x1);
            const int py1 = (int)std::min<int64_t>(gy0 + ((int64_t)1 << cbgh), band.y1);
            if (px0 >= px1 || py0 >= py1) continue;
            const int cx0 = floordivpow2(px0, cbw) << cbw, cy0 = floordivpow2(py0, cbh) << cbh;
            pb.cw = (int)((((int64_t)ceildivpow2(px1, cbw) << cbw) - cx0) >> cbw);
            pb.ch = (int)((((int64_t)ceildivpow2(py1, cbh) << cbh) - cy0) >> cbh);
            pb.cbs.resize((size_t)pb.cw * pb.ch);
            for (int j = 0; j < pb.ch; ++j)
              for (int i = 0; i < pb.cw; ++i) {
                CodeBlock& cb = pb.cbs[(size_t)j * pb.cw + i];
                cb.x0 = std::max(cx0 + (i << cbw), px0);
                cb.y0 = std::max(cy0 + (j << cbh), py0);
                cb.x1 = std::min(cx0 + ((i + 1) << cbw), px1);
                cb.y1 = std::min(cy0 + ((j + 1) << cbh), py1);
              }
            pb.incl.init(pb.cw, pb.ch);
            pb.zbp.init(pb.cw, pb.ch);
          }
          // where OpenJPEG's position iterators visit this precinct
          const int64_t rpx = res.ppx + (nl - r), rpy = res.ppy + (nl - r);
          const int64_t ax = (int64_t)(floordivpow2(res.x0, res.ppx) + pi);
          const int64_t ay = (int64_t)(floordivpow2(res.y0, res.ppy) + pj);
          auto first = [&](int64_t t0, int64_t tr0, int64_t rp, int64_t idx, int k) {
            if (k > 0) return idx << rp;
            if (t0 % ((int64_t)1 << rp) == 0 || ((tr0 << (nl - r)) % ((int64_t)1 << rp)) != 0)
              return t0;
            return tr0 << (nl - r);
          };
          pr.xref = first(tc.x0, res.x0, rpx, ax, pi);
          pr.yref = first(tc.y0, res.y0, rpy, ay, pj);
        }
    }
  }

  struct PacketId {
    int c, r, p, l;
  };

  void read_packets(std::vector<TileComp>& comps, int prog, int layers, int maxres, int csty,
                    const std::vector<uint8_t>& body, const std::vector<uint8_t>* hdr,
                    const std::vector<std::pair<size_t, size_t>>& spans, int ti) {
    std::vector<PacketId> order;
    const int nc = siz.nc;
    auto nprec = [&](int c, int r) {
      return r <= comps[c].cs.nl ? (int)comps[c].res[r].precs.size() : 0;
    };
    if (prog == 0 || prog == 1) {
      for (int a = 0; a < (prog == 0 ? layers : maxres); ++a)
        for (int b = 0; b < (prog == 0 ? maxres : layers); ++b)
          for (int c = 0; c < nc; ++c) {
            const int l = prog == 0 ? a : b, r = prog == 0 ? b : a;
            for (int p = 0; p < nprec(c, r); ++p) order.push_back({c, r, p, l});
          }
    } else {
      struct Key {
        int64_t k[4];
        int c, r, p;
      };
      std::vector<Key> keys;
      for (int c = 0; c < nc; ++c)
        for (int r = 0; r <= comps[c].cs.nl; ++r)
          for (int p = 0; p < nprec(c, r); ++p) {
            const Precinct& pr = comps[c].res[r].precs[p];
            Key key{{0, 0, 0, 0}, c, r, p};
            if (prog == 2) key = {{r, pr.yref, pr.xref, c}, c, r, p};       // RPCL
            else if (prog == 3) key = {{pr.yref, pr.xref, c, r}, c, r, p};  // PCRL
            else key = {{c, pr.yref, pr.xref, r}, c, r, p};                 // CPRL
            keys.push_back(key);
          }
      std::stable_sort(keys.begin(), keys.end(), [](const Key& a, const Key& b) {
        return std::lexicographical_compare(a.k, a.k + 4, b.k, b.k + 4);
      });
      for (const Key& k : keys)
        for (int l = 0; l < layers; ++l) order.push_back({k.c, k.r, k.p, l});
    }
    size_t pos = 0, hpos = 0;
    const std::vector<uint8_t>& hsrc = hdr ? *hdr : body;
    auto codestream_offset = [&](size_t off) -> int64_t {
      int64_t at = -1;
      for (auto& s : spans)
        if (off >= s.first) at = (int64_t)(s.second + (off - s.first));
      return at;
    };
    for (const PacketId& id : order) {
      Resolution& res = comps[id.c].res[id.r];
      Precinct& pr = res.precs[id.p];
      // SOP
      if ((csty & 2) && pos + 6 <= body.size() && body[pos] == 0xFF && body[pos + 1] == 0x91)
        pos += 6;
      size_t& hp = hdr ? hpos : pos;
      const size_t hstart = hp;
      BitReader br(hsrc.data(), hsrc.size(), hp);
      std::vector<std::pair<CodeBlock*, int>> segs;
      if (br.bit()) {
        for (int b = 0; b < res.nb; ++b) {
          PrecBand& pb = pr.bands[b];
          const int nbps = res.bands[b].numbps;
          for (int k = 0; k < (int)pb.cbs.size(); ++k) {
            CodeBlock& cb = pb.cbs[k];
            int inc;
            if (!cb.included) inc = tag_decode(br, pb.incl, k, id.l + 1);
            else inc = br.bit();
            if (!inc) continue;
            if (!cb.included) {
              int i = 0;
              while (!tag_decode(br, pb.zbp, k, i)) {
                ++i;
                if (i > 74) fail("corrupt packet header (zero bit-planes)");
              }
              cb.numbps = nbps + 1 - i;
              if (cb.numbps < 0 || cb.numbps > 30) fail("corrupt packet header (bit-planes)");
              cb.included = true;
            }
            int np;
            if (!br.bit()) np = 1;
            else if (!br.bit()) np = 2;
            else if ((np = br.bits(2)) != 3) np += 3;
            else if ((np = br.bits(5)) != 31) np += 6;
            else np = 37 + br.bits(7);
            while (br.bit()) ++cb.lblock;
            int lb = cb.lblock, t = np;
            while (t > 1) { ++lb; t >>= 1; }
            if (lb > 32) fail("corrupt packet header (length bits)");
            const int len = br.bits(lb);
            cb.passes += np;
            segs.push_back({&cb, len});
          }
        }
      }
      br.align();
      hp = br.pos;
      // EPH
      if ((csty & 4) && hp + 2 <= hsrc.size() && hsrc[hp] == 0xFF && hsrc[hp + 1] == 0x92)
        hp += 2;
      const size_t hend = hp, bstart = pos;
      for (auto& s : segs) {
        if (pos + s.second > body.size()) fail("truncated codestream: packet data");
        s.first->data.insert(s.first->data.end(), body.begin() + pos,
                             body.begin() + pos + s.second);
        pos += s.second;
      }
      if (log) {
        log->push_back(ti);
        log->push_back(hdr ? -1 : codestream_offset(hstart));
        log->push_back(hdr ? -1 : codestream_offset(hend));
        log->push_back(codestream_offset(bstart));
        log->push_back(codestream_offset(pos));
      }
    }
  }

  void decode_comp(TileComp& tc) {
    const int w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
    const bool rev = tc.cs.qmfbid == 1;
    if (rev) tc.ci.assign((size_t)w * h, 0);
    else tc.cf.assign((size_t)w * h, 0.f);
    T1 t1;
    for (int r = 0; r <= tc.cs.nl; ++r) {
      Resolution& res = tc.res[r];
      const int offx_hl = r ? tc.res[r - 1].x1 - tc.res[r - 1].x0 : 0;
      const int offy_lh = r ? tc.res[r - 1].y1 - tc.res[r - 1].y0 : 0;
      for (auto& pr : res.precs)
        for (int b = 0; b < res.nb; ++b) {
          const Band& band = res.bands[b];
          const int ox = (band.orient & 1) ? offx_hl : 0, oy = (band.orient & 2) ? offy_lh : 0;
          for (CodeBlock& cb : pr.bands[b].cbs) {
            t1.decode(cb, band.orient);
            const int cw = cb.x1 - cb.x0;
            for (int y = 0; y < cb.y1 - cb.y0; ++y)
              for (int x = 0; x < cw; ++x) {
                const size_t at = (size_t)(cb.y0 - band.y0 + oy + y) * w + (cb.x0 - band.x0 + ox + x);
                const int32_t v = t1.v[(size_t)y * cw + x];
                if (rev) tc.ci[at] = v / 2;
                else tc.cf[at] = (float)v * band.step;
              }
          }
        }
    }
    if (rev) idwt_2d(tc.ci.data(), w, tc.res.data(), tc.cs.nl, idwt53_1d);
    else idwt_2d(tc.cf.data(), w, tc.res.data(), tc.cs.nl, idwt97_1d);
  }
};

int report(const std::exception& e, char* msg, int msg_len) {
  if (msg && msg_len > 0) {
    std::strncpy(msg, e.what(), (size_t)msg_len - 1);
    msg[msg_len - 1] = 0;
  }
  return 1;
}

}  // namespace

// Header: info = [width, height, XOsiz, YOsiz, components, Rsiz, then per
// component precision, signed]; `cap` values. 0, or 1 with a message.
extern "C" int cv_j2k_header(const uint8_t* data, int64_t n, int64_t* info, int cap, char* msg,
                             int msg_len) {
  try {
    Decoder dec(data, (size_t)n);
    Reader r(data, (size_t)n);
    if (r.u16() != 0xFF4F) fail("not a JPEG 2000 codestream (no SOC)");
    if (r.u16() != 0xFF51) fail("no SIZ after SOC");
    r.u16();
    dec.read_siz(r);
    if (cap < 6 + 2 * dec.siz.nc) fail("header buffer too small");
    info[0] = dec.siz.xsiz - dec.siz.xo;
    info[1] = dec.siz.ysiz - dec.siz.yo;
    info[2] = dec.siz.xo;
    info[3] = dec.siz.yo;
    info[4] = dec.siz.nc;
    info[5] = dec.siz.rsiz;
    for (int c = 0; c < dec.siz.nc; ++c) {
      info[6 + 2 * c] = dec.siz.prec[c];
      info[7 + 2 * c] = dec.siz.sgnd[c];
    }
    return 0;
  } catch (const std::exception& e) {
    return report(e, msg, msg_len);
  }
}

// Samples: out (components, height, width) int32, what OpenJPEG gives
// after the DC level shift and clamp. 0, or 1 with a message.
extern "C" int cv_j2k_decode(const uint8_t* data, int64_t n, int32_t* out, int64_t out_len,
                             char* msg, int msg_len) {
  try {
    Decoder(data, (size_t)n).decode(out, out_len);
    return 0;
  } catch (const std::exception& e) {
    return report(e, msg, msg_len);
  }
}

// Packet positions (fixture writer): for each packet in codestream order,
// (tile, header start, header end, body start, body end) as offsets in the
// codestream (−1 for headers kept in PPM/PPT); returns the packet count
// (the first `cap` / 5 written), or −1 with a message.
extern "C" int64_t cv_j2k_packets(const uint8_t* data, int64_t n, int64_t* out, int64_t cap,
                                  char* msg, int msg_len) {
  try {
    Decoder dec(data, (size_t)n);
    std::vector<int64_t> log;
    dec.log = &log;
    dec.parse();
    std::vector<int32_t> samples((size_t)dec.siz.nc * (dec.siz.xsiz - dec.siz.xo) *
                                 (dec.siz.ysiz - dec.siz.yo));
    dec.decode(samples.data(), (int64_t)samples.size());
    for (int64_t i = 0; i < (int64_t)log.size() && i < cap; ++i) out[i] = log[i];
    return (int64_t)log.size() / 5;
  } catch (const std::exception& e) {
    report(e, msg, msg_len);
    return -1;
  }
}
