// Baseline JPEG encoder: the bytes PIL's `save(format="JPEG", quality=q)`
// writes for an RGB image through libjpeg-turbo with its defaults.
//
//   * SOI, a JFIF 1.01 APP0 (no density unit, 1:1), one DQT per table,
//     SOF0, one DHT per table (DC 0, AC 0, DC 1, AC 1), SOS, EOI;
//   * jcparam.c: the standard tables scaled by jpeg_quality_scaling,
//     clamped to 1..255 (force_baseline);
//   * jccolor.c: RGB -> YCbCr with its 16-bit fixed-point tables;
//   * jcsample.c / jcprepct.c: 4:2:0, h2v2_downsample's alternating
//     1, 2 bias; right edges replicated to the block width (luma) or to
//     twice the chroma block width, bottom edges to a whole MCU row;
//   * jccoefct.c: blocks past the component's width or height in an
//     edge MCU are zero with the DC of the block before them;
//   * jfdctint.c (ISLOW) and jcdctmgr.c's quantizer with 16-bit
//     reciprocals (the SIMD build's DCTELEM);
//   * jchuff.c with the standard Huffman tables (optimize off), 0xFF
//     stuffed, the last byte padded with ones.
//
// Built with g++ at first use (core/native.build_library); a plain C
// interface loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const unsigned kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const unsigned kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: bits[1..16] and values of the four standard tables
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  unsigned code[256];
  int size[256];

  HuffTable(const uint8_t* b, const uint8_t* v, int n) : bits(b), vals(v), nvals(n) {
    std::memset(code, 0, sizeof(code));
    std::memset(size, 0, sizeof(size));
    unsigned c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len]; ++i, ++k) {
        code[vals[k]] = c++;
        size[vals[k]] = len;
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c compute_reciprocal with DCTELEM = int16: (reciprocal,
// correction, shift) for a divisor of quantval << 3.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r - 16};
}

// jfdctint.c jpeg_fdct_islow, in place, rows then columns
void fdct_islow(int32_t* d) {
  const int CB = 13, P1 = 2;
  const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 8; ++i) {
      int32_t* p = pass == 0 ? d + 8 * i : d + i;
      int st = pass == 0 ? 1 : 8;
      int64_t tmp0 = p[0] + p[7 * st], tmp7 = p[0] - p[7 * st];
      int64_t tmp1 = p[st] + p[6 * st], tmp6 = p[st] - p[6 * st];
      int64_t tmp2 = p[2 * st] + p[5 * st], tmp5 = p[2 * st] - p[5 * st];
      int64_t tmp3 = p[3 * st] + p[4 * st], tmp4 = p[3 * st] - p[4 * st];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int sh = pass == 0 ? CB - P1 : CB + P1;
      if (pass == 0) {
        p[0] = (int32_t)((tmp10 + tmp11) * (1 << P1));
        p[4 * st] = (int32_t)((tmp10 - tmp11) * (1 << P1));
      } else {
        p[0] = descale(tmp10 + tmp11, P1);
        p[4 * st] = descale(tmp10 - tmp11, P1);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * st] = descale(z1 + tmp13 * F0765, sh);
      p[6 * st] = descale(z1 + tmp12 * (-F1847), sh);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * st] = descale(tmp4 + z1 + z3, sh);
      p[5 * st] = descale(tmp5 + z2 + z4, sh);
      p[3 * st] = descale(tmp6 + z2 + z3, sh);
      p[st] = descale(tmp7 + z1 + z4, sh);
    }
  }
}

struct Writer {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nacc = 0;

  void byte(int b) { out.push_back((uint8_t)b); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void bits(unsigned v, int n) {
    if (n == 0) return;
    acc = (acc << n) | (v & ((1u << n) - 1));
    nacc += n;
    while (nacc >= 8) {
      int b = (int)((acc >> (nacc - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      nacc -= 8;
    }
  }
  void flush() {
    if (nacc > 0) bits(0x7F, 8 - nacc);
    acc = 0;
    nacc = 0;
  }
};

// One component plane, padded as libjpeg pads it, in 8x8 blocks.
struct Plane {
  int bw, bh;  // blocks across and down that hold image data
  int pw, ph;  // padded sample width and height (whole MCU rows)
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const { return px[(size_t)y * pw + x]; }
};

void encode_block(Writer& w, const int32_t* q, int& last_dc, const HuffTable& dc,
                  const HuffTable& ac) {
  int temp = q[0] - last_dc, temp2 = temp;
  last_dc = q[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  w.bits(dc.code[nbits], dc.size[nbits]);
  w.bits((unsigned)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = q[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int i = (r << 4) + nbits;
    w.bits(ac.code[i], ac.size[i]);
    w.bits((unsigned)temp2, nbits);
    r = 0;
  }
  if (r > 0) w.bits(ac.code[0], ac.size[0]);
}

void forward_block(const Plane& p, int by, int bx, const Divisor* div, int32_t* q) {
  int32_t d[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) d[8 * y + x] = (int32_t)p.at(8 * by + y, 8 * bx + x) - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    // the SIMD build's DCTELEM is 16 bits: the transform's output fits
    int32_t t = d[i];
    bool neg = t < 0;
    uint32_t a = (uint32_t)(neg ? -t : t);
    uint32_t prod = ((a + div[i].corr) & 0xFFFF) * div[i].recip;
    int32_t v = (int32_t)((prod >> (16 + div[i].shift)) & 0xFFFF);
    q[i] = neg ? -v : v;
  }
}

void marker_dht(Writer& w, int cls_index, const HuffTable& t) {
  w.word(0xFFC4);
  w.word(2 + 1 + 16 + t.nvals);
  w.byte(cls_index);
  for (int i = 1; i <= 16; ++i) w.byte(t.bits[i]);
  for (int i = 0; i < t.nvals; ++i) w.byte(t.vals[i]);
}

}  // namespace

extern "C" {

// Upper bound of the encoded size of a w x h image.
size_t cv_jpeg_encode_bound(int w, int h) {
  return (size_t)(w + 16) * (h + 16) * 3 * 2 + 2048;
}

// Encodes an (h, w, 3) RGB uint8 image at `quality` (1..100) into out
// (cv_jpeg_encode_bound bytes); returns the encoded length, or 0 when the
// size is out of range.
size_t cv_jpeg_encode(const uint8_t* rgb, int w, int h, int quality, uint8_t* out) {
  if (w <= 0 || h <= 0 || w > 65500 || h > 65500) return 0;
  // jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  unsigned qt[2][64];
  for (int t = 0; t < 2; ++t) {
    const unsigned* base = t == 0 ? kStdLuma : kStdChroma;
    for (int i = 0; i < 64; ++i) {
      long v = ((long)base[i] * scale + 50L) / 100L;
      if (v <= 0) v = 1;
      if (v > 32767) v = 32767;
      if (v > 255) v = 255;
      qt[t][i] = (unsigned)v;
    }
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(qt[t][i] << 3);

  // jccolor.c rgb_ycc_convert (SCALEBITS 16)
  const int64_t ONE_HALF = 1 << 15, CBCR_OFF = (int64_t)128 << 16;
  auto FIX = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  int64_t ry[256], gy[256], by_[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
  for (int i = 0; i < 256; ++i) {
    ry[i] = FIX(0.29900) * i;
    gy[i] = FIX(0.58700) * i;
    by_[i] = FIX(0.11400) * i + ONE_HALF;
    rcb[i] = -FIX(0.16874) * i;
    gcb[i] = -FIX(0.33126) * i;
    bcb[i] = FIX(0.50000) * i + CBCR_OFF + ONE_HALF - 1;
    gcr[i] = -FIX(0.41869) * i;
    bcr[i] = -FIX(0.08131) * i;
  }
  int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  Plane Y, C[2];
  Y.bw = (w + 7) / 8;
  Y.bh = (h + 7) / 8;
  Y.pw = 8 * Y.bw;
  Y.ph = 16 * mcuy;
  Y.px.resize((size_t)Y.pw * Y.ph);
  // chroma full resolution, right edge to 16 * ceil(w / 16), even rows
  int cw_full = 16 * mcux, ch_full = h + (h & 1);
  std::vector<uint8_t> full[2];
  for (int k = 0; k < 2; ++k) full[k].resize((size_t)cw_full * ch_full);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgb + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {
      int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
      Y.px[(size_t)y * Y.pw + x] = (uint8_t)((ry[r] + gy[g] + by_[b]) >> 16);
      full[0][(size_t)y * cw_full + x] = (uint8_t)((rcb[r] + gcb[g] + bcb[b]) >> 16);
      full[1][(size_t)y * cw_full + x] = (uint8_t)((bcb[r] + gcr[g] + bcr[b]) >> 16);
    }
    for (int x = w; x < Y.pw; ++x) Y.px[(size_t)y * Y.pw + x] = Y.px[(size_t)y * Y.pw + w - 1];
    for (int k = 0; k < 2; ++k)
      for (int x = w; x < cw_full; ++x)
        full[k][(size_t)y * cw_full + x] = full[k][(size_t)y * cw_full + w - 1];
  }
  for (int y = h; y < Y.ph; ++y)
    std::memcpy(&Y.px[(size_t)y * Y.pw], &Y.px[(size_t)(h - 1) * Y.pw], Y.pw);
  if (h & 1)
    for (int k = 0; k < 2; ++k)
      std::memcpy(&full[k][(size_t)h * cw_full], &full[k][(size_t)(h - 1) * cw_full], cw_full);
  // h2v2_downsample, then the bottom padded to whole MCU rows
  for (int k = 0; k < 2; ++k) {
    Plane& p = C[k];
    p.bw = mcux;
    p.bh = (h + 15) / 16;
    p.pw = 8 * mcux;
    p.ph = 8 * mcuy;
    p.px.resize((size_t)p.pw * p.ph);
    int rows = ch_full / 2;
    for (int oy = 0; oy < rows; ++oy) {
      const uint8_t* r0 = &full[k][(size_t)(2 * oy) * cw_full];
      const uint8_t* r1 = r0 + cw_full;
      int bias = 1;
      for (int ox = 0; ox < p.pw; ++ox) {
        p.px[(size_t)oy * p.pw + ox] =
            (uint8_t)((r0[2 * ox] + r0[2 * ox + 1] + r1[2 * ox] + r1[2 * ox + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int oy = rows; oy < p.ph; ++oy)
      std::memcpy(&p.px[(size_t)oy * p.pw], &p.px[(size_t)(rows - 1) * p.pw], p.pw);
  }

  Writer wr;
  wr.out.reserve(cv_jpeg_encode_bound(w, h));
  wr.word(0xFFD8);
  const uint8_t app0[16] = {0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  wr.word(0xFFE0);
  for (int i = 0; i < 16; ++i) wr.byte(app0[i]);
  for (int t = 0; t < 2; ++t) {
    wr.word(0xFFDB);
    wr.word(67);
    wr.byte(t);
    for (int i = 0; i < 64; ++i) wr.byte((int)qt[t][kNatural[i]]);
  }
  wr.word(0xFFC0);
  wr.word(17);
  wr.byte(8);
  wr.word(h);
  wr.word(w);
  wr.byte(3);
  const int comp[3][3] = {{1, 0x22, 0}, {2, 0x11, 1}, {3, 0x11, 1}};
  for (auto& c : comp) {
    wr.byte(c[0]);
    wr.byte(c[1]);
    wr.byte(c[2]);
  }
  HuffTable dc0(kDcLumaBits, kDcLumaVals, 12), ac0(kAcLumaBits, kAcLumaVals, 162);
  HuffTable dc1(kDcChromaBits, kDcChromaVals, 12), ac1(kAcChromaBits, kAcChromaVals, 162);
  marker_dht(wr, 0x00, dc0);
  marker_dht(wr, 0x10, ac0);
  marker_dht(wr, 0x01, dc1);
  marker_dht(wr, 0x11, ac1);
  wr.word(0xFFDA);
  wr.word(12);
  wr.byte(3);
  wr.byte(1);
  wr.byte(0x00);
  wr.byte(2);
  wr.byte(0x11);
  wr.byte(3);
  wr.byte(0x11);
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);

  int last_dc[3] = {0, 0, 0};
  int32_t blk[4][64];
  // luma blocks in an MCU: 2 x 2; the last MCU column and row may hold
  // fewer (jccoefct.c last_col_width, last_row_height)
  int ylast_w = Y.bw % 2 ? 1 : 2, ylast_h = Y.bh % 2 ? 1 : 2;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      int cols = mx < mcux - 1 ? 2 : ylast_w;
      int rows = my < mcuy - 1 ? 2 : ylast_h;
      for (int yi = 0; yi < 2; ++yi) {
        if (yi < rows) {
          for (int xi = 0; xi < cols; ++xi) forward_block(Y, 2 * my + yi, 2 * mx + xi, div[0],
                                                          blk[2 * yi + xi]);
          for (int xi = cols; xi < 2; ++xi) {
            std::memset(blk[2 * yi + xi], 0, sizeof(blk[0]));
            blk[2 * yi + xi][0] = blk[2 * yi + xi - 1][0];
          }
        } else {
          for (int xi = 0; xi < 2; ++xi) {
            std::memset(blk[2 * yi + xi], 0, sizeof(blk[0]));
            blk[2 * yi + xi][0] = blk[2 * yi - 1][0];
          }
        }
      }
      for (int b = 0; b < 4; ++b) encode_block(wr, blk[b], last_dc[0], dc0, ac0);
      for (int k = 0; k < 2; ++k) {
        forward_block(C[k], my, mx, div[1], blk[0]);
        encode_block(wr, blk[0], last_dc[1 + k], dc1, ac1);
      }
    }
  }
  wr.flush();
  wr.word(0xFFD9);
  std::memcpy(out, wr.out.data(), wr.out.size());
  return wr.out.size();
}

}  // extern "C"
