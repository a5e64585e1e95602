// JPEG decoding for the port's image reader (circuitvision_tpu_torch/io/
// image_io.py), held byte for byte to what PIL makes of a file with
// libjpeg-turbo's defaults, then convert("RGB"):
//
//   * Huffman- and arithmetic-coded (ITU T.81 Annex D and F, jdarith.c:
//     the Qe table D.2, DAC conditioning) baseline, extended-sequential and
//     progressive frames of 8-bit samples, 1 component (grey), 3 (YCbCr;
//     RGB where an Adobe APP14 marker says transform 0, or, with neither a
//     JFIF nor an Adobe marker, the component ids are 'R', 'G', 'B') or 4
//     (CMYK; YCCK where an Adobe marker says a transform other than 0,
//     converted to CMYK as jdcolor.c's ycck_cmyk_convert does), each
//     component sampled 1 to 4 times on each axis, at most 10 blocks in an
//     MCU; restart intervals; partial MCUs at the right and bottom edges;
//   * lossless (SOF3) Huffman frames of 8-bit samples (jdlhuff.c,
//     jdpred.c: predictors 1-7, the first row and column of a scan or
//     restart interval, the point transform), as libjpeg-turbo 3 reads
//     them: subsampled components upsampled by replication (no fancy
//     upsampling at a DCT size of 1), no colour conversion, so a JFIF
//     marker or an Adobe transform other than 0 is refused;
//   * the integer inverse DCT (libjpeg's JDCT_ISLOW, jidctint.c) with its
//     range-limit table, fancy upsampling (jdsample.c: h2v1, h1v2 and h2v2
//     with their alternating rounding, the first and last rows replicated
//     for context and the edge columns handled as libjpeg does), other
//     integral ratios replicated (int_upsample), and jdcolor.c's
//     fixed-point YCbCr -> RGB tables (SCALEBITS 16);
//   * block smoothing (jdcoefct.c decompress_smooth_data), which libjpeg
//     applies to a progressive file whose scans leave one of the first nine
//     AC coefficients short of full precision: those coefficients, and
//     where no AC scan has arrived the DC too, estimated from the DC values
//     of each block's 5 x 5 neighbourhood.
//
// Pillow hands libjpeg a file 65536 bytes at a time and the arithmetic
// decoder cannot suspend, so PIL fails ("broken data stream") on an
// arithmetic-coded scan that reads past the block in hand when the scan
// starts; such a scan is refused here too (kPilBlock).
//
// Everything else is refused with a message that names it: hierarchical
// frames, lossless frames with arithmetic coding,
// other sample precisions, 2 or more than 4 components, sampling ratios
// that do not divide. No system libjpeg is loaded.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <exception>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // extra entries absorb a corrupt run past the end, as libjpeg's table does
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ITU T.81 Table D.2 as jaricom.c packs it: Qe << 16, Next_Index_MPS << 8,
// Switch_MPS << 7, Next_Index_LPS; entry 113 is the fixed 0.5 estimate
#define V(i, qe, nl, nm, sw) (((int64_t)(qe) << 16) | ((nm) << 8) | ((sw) << 7) | (nl))
const int64_t kAriTab[114] = {
    V(0, 0x5a1d, 1, 1, 1), V(1, 0x2586, 14, 2, 0), V(2, 0x1114, 16, 3, 0),
    V(3, 0x080b, 18, 4, 0), V(4, 0x03d8, 20, 5, 0), V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0), V(7, 0x006f, 28, 8, 0), V(8, 0x0036, 30, 9, 0),
    V(9, 0x001a, 33, 10, 0), V(10, 0x000d, 35, 11, 0), V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0), V(13, 0x0001, 12, 13, 0), V(14, 0x5a7f, 15, 15, 1),
    V(15, 0x3f25, 36, 16, 0), V(16, 0x2cf2, 38, 17, 0), V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0), V(19, 0x1182, 42, 20, 0), V(20, 0x0cef, 43, 21, 0),
    V(21, 0x09a1, 45, 22, 0), V(22, 0x072f, 46, 23, 0), V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0), V(25, 0x0303, 51, 26, 0), V(26, 0x0240, 52, 27, 0),
    V(27, 0x01b1, 54, 28, 0), V(28, 0x0144, 56, 29, 0), V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0), V(31, 0x008a, 60, 32, 0), V(32, 0x0068, 62, 33, 0),
    V(33, 0x004e, 63, 34, 0), V(34, 0x003b, 32, 35, 0), V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1), V(37, 0x484c, 64, 38, 0), V(38, 0x3a0d, 65, 39, 0),
    V(39, 0x2ef1, 67, 40, 0), V(40, 0x261f, 68, 41, 0), V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0), V(43, 0x1518, 72, 44, 0), V(44, 0x1177, 73, 45, 0),
    V(45, 0x0e74, 74, 46, 0), V(46, 0x0bfb, 75, 47, 0), V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0), V(49, 0x0706, 79, 50, 0), V(50, 0x05cd, 48, 51, 0),
    V(51, 0x04de, 50, 52, 0), V(52, 0x040f, 50, 53, 0), V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0), V(55, 0x025c, 53, 56, 0), V(56, 0x01f8, 54, 57, 0),
    V(57, 0x01a4, 55, 58, 0), V(58, 0x0160, 56, 59, 0), V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0), V(61, 0x00cb, 59, 62, 0), V(62, 0x00ab, 61, 63, 0),
    V(63, 0x008f, 61, 32, 0), V(64, 0x5b12, 65, 65, 1), V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0), V(67, 0x37d8, 82, 68, 0), V(68, 0x2fe8, 83, 69, 0),
    V(69, 0x293c, 84, 70, 0), V(70, 0x2379, 86, 71, 0), V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0), V(73, 0x174e, 72, 74, 0), V(74, 0x1424, 72, 75, 0),
    V(75, 0x119c, 74, 76, 0), V(76, 0x0f6b, 74, 77, 0), V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0), V(79, 0x0a40, 77, 48, 0), V(80, 0x5832, 80, 81, 1),
    V(81, 0x4d1c, 88, 82, 0), V(82, 0x438e, 89, 83, 0), V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0), V(85, 0x2eae, 92, 86, 0), V(86, 0x299a, 93, 87, 0),
    V(87, 0x2516, 86, 71, 0), V(88, 0x5570, 88, 89, 1), V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0), V(91, 0x3e22, 97, 92, 0), V(92, 0x3824, 99, 93, 0),
    V(93, 0x32b4, 99, 94, 0), V(94, 0x2e17, 93, 86, 0), V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0), V(97, 0x47e5, 102, 98, 0), V(98, 0x41cf, 103, 99, 0),
    V(99, 0x3c3d, 104, 100, 0), V(100, 0x375e, 99, 93, 0), V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0), V(104, 0x415e, 103, 99, 0),
    V(105, 0x5627, 105, 106, 1), V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1),
    V(111, 0x5522, 112, 109, 0), V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0),
};
#undef V

// Pillow's ImageFile.decodermaxblock: the bytes handed to libjpeg per call
const size_t kPilBlock = 65536;

struct Error {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Error{what}; }

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
  // lookahead of kLook bits: length (0: longer code) and value
  static const int kLook = 9;
  uint8_t look_len[1 << kLook];
  uint8_t look_val[1 << kLook];

  void build(const uint8_t* counts, const uint8_t* values, int nvals) {
    std::memcpy(vals, values, nvals);
    int code = 0, k = 0;
    std::memset(look_len, 0, sizeof(look_len));
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        if (l <= kLook) {
          const int shift = kLook - l;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = (uint8_t)l;
            look_val[(code << shift) | j] = vals[k];
          }
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) fail("JPEG: a Huffman table has more codes than bits allow");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int sh = 1, sv = 1;         // sampling factors as the file gives them
  int td = 0, ta = 0;         // Huffman tables of the current scan
  int bw = 0, bh = 0;         // blocks of the padded MCU grid
  int cw = 0, ch = 0;         // downsampled size in samples
  int dc_pred = 0;
  int dc_context = 0;         // arithmetic DC conditioning category
  bool latched = false;       // quantisation table copied at its first scan
  uint16_t quant[64];
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
  std::vector<int> diff;      // lossless: the differences, then the samples (lw x lh)
  int lw = 0, lh = 0;
  int coef_bits[64];          // progressive: Al of the last scan per coefficient
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : d_(data), n_(n) {
    for (int t = 0; t < 16; ++t) {
      dc_L_[t] = 0;
      dc_U_[t] = 1;
      ac_K_[t] = 5;
    }
  }

  void header();   // through the first SOS
  void decode();   // all scans
  void output(uint8_t* out) const;

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return ncomp_; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;

  int width_ = 0, height_ = 0, ncomp_ = 0;
  bool progressive_ = false, jfif_ = false, adobe_ = false, smooth_ = false;
  bool arith_ = false, lossless_ = false;
  int adobe_transform_ = -1;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  bool frame_ = false, eoi_ = false;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  Component comp_[4];
  // arithmetic conditioning (DAC) and the decoder's state (jdarith.c)
  int dc_L_[16], dc_U_[16], ac_K_[16];  // 0, 1 and 5 until a DAC segment says
  uint8_t dc_stats_[16][64], ac_stats_[16][256], fixed_bin_ = 113;
  int64_t ac_c_ = 0, ac_a_ = 0;
  int ac_ct_ = -16, unread_marker_ = 0;
  size_t arith_limit_ = 0;
  size_t sos_end_ = 0;

  // current scan
  int scomp_[4];
  int sn_ = 0, ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int eobrun_ = 0;
  // bit reader
  uint64_t bits_ = 0;
  int nbits_ = 0;
  bool marker_hit_ = false;

  int u8() {
    if (pos_ >= n_) fail("JPEG: truncated");
    return d_[pos_++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void read_frame(int marker);
  void read_dqt(size_t end);
  void read_dht(size_t end);
  void read_sos();
  void read_app(int marker, size_t end);
  void read_dac(size_t end);
  int next_marker();
  void scan();
  void scan_lossless();
  int arith_byte();
  int arith_decode(uint8_t* st);
  void arith_restart();
  void arith_block(Component& c, int16_t* blk);
  int lossless_diff(const Huffman& h);

  // bits
  void reset_bits() {
    bits_ = 0;
    nbits_ = 0;
    marker_hit_ = false;
  }
  void fill() {
    while (nbits_ <= 56) {
      int byte = 0;
      if (!marker_hit_ && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          int next = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
          if (next == 0x00) {
            pos_ += 2;
          } else {
            marker_hit_ = true;  // leave the marker; feed zeros, as libjpeg does
            byte = 0;
          }
        } else {
          ++pos_;
        }
      } else {
        marker_hit_ = true;
      }
      bits_ |= (uint64_t)byte << (56 - nbits_);
      nbits_ += 8;
    }
  }
  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits_ < n) fill();
    int v = (int)(bits_ >> (64 - n));
    bits_ <<= n;
    nbits_ -= n;
    return v;
  }
  int get_bit() { return get_bits(1); }
  int decode_huff(const Huffman& h) {
    if (nbits_ < 16) fill();
    const int peek = (int)(bits_ >> (64 - Huffman::kLook));
    const int len = h.look_len[peek];
    if (len) {
      bits_ <<= len;
      nbits_ -= len;
      return h.look_val[peek];
    }
    int code = get_bits(Huffman::kLook);
    int l = Huffman::kLook;
    while (code > h.maxcode[l]) {
      code = (code << 1) | get_bit();
      if (++l > 16) fail("JPEG: corrupt Huffman code");
    }
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }
  int receive_extend(int s) { return s ? extend(get_bits(s), s) : 0; }

  void decode_block(Component& c, int16_t* blk);
  void smooth_block(const Component& c, int by, int bx, int16_t* ws) const;
};

int Decoder::next_marker() {
  // skip fill bytes and any stray data (stuffed FF 00 pairs too) up to the
  // next marker, as jdmarker.c next_marker does
  if (unread_marker_) {  // the arithmetic decoder read it already
    const int m = unread_marker_;
    unread_marker_ = 0;
    return m;
  }
  for (;;) {
    while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
    if (pos_ >= n_) fail("JPEG: truncated before EOI");
    const int m = d_[pos_++];
    if (m != 0) return m;
  }
}

void Decoder::read_frame(int marker) {
  if (frame_) fail("JPEG: more than one frame");
  if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7 || marker >= 0xCD)
    fail("JPEG: hierarchical (differential) frames are not read");
  if (marker == 0xCB) fail("JPEG: lossless frames with arithmetic coding are not read");
  progressive_ = marker == 0xC2 || marker == 0xCA;
  arith_ = marker >= 0xC9;
  lossless_ = marker == 0xC3;
  const int precision = u8();
  if (precision != 8)
    fail("JPEG: " + std::to_string(precision) + "-bit samples are not read; only 8-bit");
  height_ = u16();
  width_ = u16();
  ncomp_ = u8();
  if (width_ < 1 || height_ < 1) fail("JPEG: image has no rows or columns");
  if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
    fail("JPEG: " + std::to_string(ncomp_) + " components; only 1, 3 or 4 are read");
  for (int i = 0; i < ncomp_; ++i) {
    Component& c = comp_[i];
    c.id = u8();
    const int hv = u8();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.sh = c.h;
    c.sv = c.v;
    c.tq = u8() & 3;
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  for (int i = 0; i < ncomp_; ++i) {
    const Component& c = comp_[i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
      fail("JPEG: sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
           " are not valid; each is 1 to 4");
  }
  if (ncomp_ > 1)
    for (int i = 0; i < ncomp_; ++i) {
      const Component& c = comp_[i];
      if ((hmax_ % c.h) || (vmax_ % c.v))  // jdsample.c: JERR_FRACT_SAMPLE_NOTIMPL
        fail("JPEG: sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
             " against " + std::to_string(hmax_) + "x" + std::to_string(vmax_) +
             " are not an integral ratio, which libjpeg does not upsample");
    }
  if (ncomp_ == 1) hmax_ = vmax_ = comp_[0].h = comp_[0].v = 1;  // one component: no MCU
  const int unit = lossless_ ? 1 : 8;  // a lossless "block" is one sample
  mcux_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
  mcuy_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
  for (int i = 0; i < ncomp_; ++i) {
    Component& c = comp_[i];
    c.cw = (width_ * c.h + hmax_ - 1) / hmax_;
    c.ch = (height_ * c.v + vmax_ - 1) / vmax_;
    c.bw = mcux_ * c.h;
    c.bh = mcuy_ * c.v;
    if (ncomp_ == 1) {  // libjpeg pads the lone component's blocks to its sampling factors
      c.bw = (c.bw + c.sh - 1) / c.sh * c.sh;
      c.bh = (c.bh + c.sv - 1) / c.sv * c.sv;
    }
    if (!lossless_) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
  frame_ = true;
}

void Decoder::read_dqt(size_t end) {
  while (pos_ < end) {
    const int pq = u8();
    const int t = pq & 15;
    if (t > 3) fail("JPEG: quantisation table id out of range");
    for (int k = 0; k < 64; ++k) qt_[t][kZigzag[k]] = (uint16_t)((pq >> 4) ? u16() : u8());
    qt_defined_[t] = true;
  }
}

void Decoder::read_dht(size_t end) {
  while (pos_ < end) {
    const int tc = u8();
    const int cls = tc >> 4, id = tc & 15;
    if (cls > 1 || id > 3) fail("JPEG: Huffman table id out of range");
    uint8_t counts[16], vals[256];
    int total = 0;
    for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)u8();
    if (total > 256) fail("JPEG: Huffman table has more than 256 values");
    for (int i = 0; i < total; ++i) vals[i] = (uint8_t)u8();
    (cls ? ac_ : dc_)[id].build(counts, vals, total);
  }
}

void Decoder::read_app(int marker, size_t end) {
  const size_t len = end - pos_;
  const uint8_t* s = d_ + pos_;
  if (marker == 0xE0 && len >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) jfif_ = true;
  if (marker == 0xEE && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
    adobe_ = true;
    adobe_transform_ = s[11];
  }
  pos_ = end;
}

void Decoder::read_dac(size_t end) {
  while (pos_ < end) {
    const int index = u8(), val = u8();
    if (index >= 32) fail("JPEG: DAC table index out of range");
    if (index >= 16) {
      ac_K_[index - 16] = val;
    } else {
      dc_L_[index] = val & 15;
      dc_U_[index] = val >> 4;
      if (dc_L_[index] > dc_U_[index]) fail("JPEG: DAC lower bound above its upper bound");
    }
  }
  if (pos_ != end) fail("JPEG: DAC segment length");
}

void Decoder::read_sos() {
  if (!frame_) fail("JPEG: scan before frame header");
  sn_ = u8();
  if (sn_ < 1 || sn_ > ncomp_) fail("JPEG: bad component count in scan");
  for (int i = 0; i < sn_; ++i) {
    const int id = u8(), t = u8();
    int ci = -1;
    for (int j = 0; j < ncomp_; ++j)
      if (comp_[j].id == id) ci = j;
    if (ci < 0) fail("JPEG: scan names an unknown component");
    scomp_[i] = ci;
    comp_[ci].td = t >> 4;
    comp_[ci].ta = t & 15;
    if (!arith_ && (comp_[ci].td > 3 || comp_[ci].ta > 3))
      fail("JPEG: Huffman table id out of range");
  }
  ss_ = u8();
  se_ = u8();
  const int a = u8();
  ah_ = a >> 4;
  al_ = a & 15;
  sos_end_ = pos_;
  if (sn_ > 1) {
    int blocks = 0;
    for (int i = 0; i < sn_; ++i) blocks += comp_[scomp_[i]].h * comp_[scomp_[i]].v;
    if (blocks > 10) fail("JPEG: more than 10 blocks in an MCU");
  }
  if (lossless_) {  // Ss is the predictor, Al the point transform
    if (ss_ < 1 || ss_ > 7 || se_ != 0 || ah_ != 0 || al_ >= 8)
      fail("JPEG: bad lossless scan parameters");
    for (int i = 0; i < sn_; ++i) {
      const Component& c = comp_[scomp_[i]];
      if (!dc_[c.td].defined) fail("JPEG: scan uses an undefined DC table");
    }
    return;
  }
  if (progressive_ && arith_ && ah_ != 0 && al_ != ah_ - 1)
    fail("JPEG: bad progressive scan parameters");
  if (progressive_) {
    if (ss_ > se_ || se_ > 63 || (ss_ == 0 && se_ != 0) || (ss_ > 0 && sn_ != 1) || al_ > 13)
      fail("JPEG: bad progressive scan parameters");
  } else {
    ss_ = 0;
    se_ = 63;
    ah_ = al_ = 0;
  }
  for (int i = 0; i < sn_; ++i) {
    Component& c = comp_[scomp_[i]];
    if (!c.latched) {
      if (!qt_defined_[c.tq]) fail("JPEG: component uses an undefined quantisation table");
      std::memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
      c.latched = true;
    }
    for (int k = ss_; k <= se_; ++k) c.coef_bits[k] = al_;
    const bool need_dc = ss_ == 0 && ah_ == 0;
    const bool need_ac = se_ > 0 || !progressive_;
    if (arith_) continue;
    if (need_dc && !dc_[c.td].defined) fail("JPEG: scan uses an undefined DC table");
    if (need_ac && (!progressive_ || ss_ > 0) && !ac_[c.ta].defined)
      fail("JPEG: scan uses an undefined AC table");
  }
}

void Decoder::decode_block(Component& c, int16_t* blk) {
  if (!progressive_) {
    const int t = decode_huff(dc_[c.td]);
    if (t > 11) fail("JPEG: corrupt DC difference");
    c.dc_pred += receive_extend(t);
    blk[0] = (int16_t)c.dc_pred;
    const Huffman& ac = ac_[c.ta];
    for (int k = 1; k < 64; ++k) {
      const int rs = decode_huff(ac);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = (int16_t)receive_extend(s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return;
  }
  if (ss_ == 0) {
    if (ah_ == 0) {
      const int t = decode_huff(dc_[c.td]);
      if (t > 11) fail("JPEG: corrupt DC difference");
      c.dc_pred += receive_extend(t);
      blk[0] = (int16_t)(c.dc_pred * (1 << al_));
    } else if (get_bit()) {
      blk[0] = (int16_t)(blk[0] | (1 << al_));
    }
    return;
  }
  const Huffman& ac = ac_[c.ta];
  if (ah_ == 0) {  // AC first
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    for (int k = ss_; k <= se_; ++k) {
      const int rs = decode_huff(ac);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = (int16_t)(receive_extend(s) * (1 << al_));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        --eobrun_;
        break;
      }
    }
    return;
  }
  // AC refinement (jdphuff.c decode_mcu_AC_refine)
  const int p1 = 1 << al_, m1 = -1 * (1 << al_);
  int k = ss_;
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      const int rs = decode_huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bit() ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        break;
      }
      do {
        int16_t* coef = blk + kZigzag[k];
        if (*coef != 0) {
          if (get_bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se_);
      if (s) blk[kZigzag[k]] = (int16_t)s;
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t* coef = blk + kZigzag[k];
      if (*coef != 0 && get_bit() && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    --eobrun_;
  }
}

// ------------------------------------------------------ arithmetic decoding
// jdarith.c get_byte within the block PIL has handed libjpeg (kPilBlock)
int Decoder::arith_byte() {
  if (pos_ >= arith_limit_) {
    if (arith_limit_ >= n_) fail("JPEG: arithmetic-coded data runs past the end of the file");
    fail("JPEG: an arithmetic-coded scan reads past the " + std::to_string(kPilBlock) +
         "-byte block Pillow hands libjpeg, which cannot suspend there (PIL: broken data "
         "stream)");
  }
  return d_[pos_++];
}

// jdarith.c arith_decode: one binary decision with the statistics bin st
int Decoder::arith_decode(uint8_t* st) {
  while (ac_a_ < 0x8000) {
    if (--ac_ct_ < 0) {
      int data;
      if (unread_marker_) {
        data = 0;
      } else {
        data = arith_byte();
        if (data == 0xFF) {
          do data = arith_byte();
          while (data == 0xFF);
          if (data == 0) {
            data = 0xFF;
          } else {
            unread_marker_ = data;
            data = 0;
          }
        }
      }
      ac_c_ = (ac_c_ << 8) | data;
      if ((ac_ct_ += 8) < 0)
        if (++ac_ct_ == 0) ac_a_ = 0x8000;
    }
    ac_a_ <<= 1;
  }
  int sv = *st;
  int64_t qe = kAriTab[sv & 0x7F];
  const uint8_t nl = (uint8_t)(qe & 0xFF);
  qe >>= 8;
  const uint8_t nm = (uint8_t)(qe & 0xFF);
  qe >>= 8;
  int64_t temp = ac_a_ - qe;
  ac_a_ = temp;
  temp <<= ac_ct_;
  if (ac_c_ >= temp) {
    ac_c_ -= temp;
    if (ac_a_ < qe) {
      ac_a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nm);
    } else {
      ac_a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (ac_a_ < 0x8000) {
    if (ac_a_ < qe) {
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = (uint8_t)((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

// jdarith.c process_restart
void Decoder::arith_restart() {
  int m;
  if (unread_marker_) {
    m = unread_marker_;
    unread_marker_ = 0;
  } else {
    m = next_marker();
    if (pos_ > arith_limit_) arith_byte();  // the marker lies past PIL's block
  }
  if (m < 0xD0 || m > 0xD7) fail("JPEG: missing restart marker");
  for (int i = 0; i < sn_; ++i) {
    Component& c = comp_[scomp_[i]];
    if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
      std::memset(dc_stats_[c.td], 0, 64);
      c.dc_pred = 0;
      c.dc_context = 0;
    }
    if (!progressive_ || ss_) std::memset(ac_stats_[c.ta], 0, 256);
  }
  ac_c_ = 0;
  ac_a_ = 0;
  ac_ct_ = -16;
}

void Decoder::arith_block(Component& c, int16_t* blk) {
  if (progressive_ && ss_ == 0 && ah_ != 0) {  // DC refinement: the next bit
    if (arith_decode(&fixed_bin_)) blk[0] = (int16_t)(blk[0] | (1 << al_));
    return;
  }
  if (ac_ct_ == -1) return;  // a bad code stopped the scan: the rest stays as it is
  if (!progressive_ || ss_ == 0) {
    // Figures F.19-F.24: the DC difference
    uint8_t* st = dc_stats_[c.td] + c.dc_context;
    if (arith_decode(st) == 0) {
      c.dc_context = 0;
    } else {
      const int sign = arith_decode(st + 1);
      st += 2 + sign;
      int m = arith_decode(st);
      if (m != 0) {
        st = dc_stats_[c.td] + 20;
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ac_ct_ = -1;
            return;
          }
          st += 1;
        }
      }
      if (m < (int)((1L << dc_L_[c.td]) >> 1)) c.dc_context = 0;
      else if (m > (int)((1L << dc_U_[c.td]) >> 1)) c.dc_context = 12 + sign * 4;
      else c.dc_context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c.dc_pred = (c.dc_pred + v) & 0xffff;
    }
    blk[0] = (int16_t)(uint16_t)((unsigned)c.dc_pred << (progressive_ ? al_ : 0));
    if (progressive_) return;
  }
  const int start = progressive_ ? ss_ : 1, end = progressive_ ? se_ : 63;
  uint8_t* const stats = ac_stats_[c.ta];
  if (progressive_ && ah_ != 0) {  // AC refinement
    const int p1 = 1 << al_, m1 = -1 * (1 << al_);
    int kex;
    for (kex = end; kex > 0; --kex)
      if (blk[kZigzag[kex]]) break;
    for (int k = start; k <= end; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;
      for (;;) {
        int16_t* coef = blk + kZigzag[k];
        if (*coef) {
          if (arith_decode(st + 2)) *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = (int16_t)(arith_decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > end) {
          ac_ct_ = -1;
          return;
        }
      }
    }
    return;
  }
  // Figure F.20 (first AC scan, or the sequential block's AC)
  for (int k = start; k <= end; ++k) {
    uint8_t* st = stats + 3 * (k - 1);
    if (arith_decode(st)) break;  // EOB
    while (arith_decode(st + 1) == 0) {
      st += 3;
      if (++k > end) {
        ac_ct_ = -1;
        return;
      }
    }
    const int sign = arith_decode(&fixed_bin_);
    st += 2;
    int m = arith_decode(st);
    if (m != 0 && arith_decode(st)) {
      m <<= 1;
      st = stats + (k <= ac_K_[c.ta] ? 189 : 217);
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ac_ct_ = -1;
          return;
        }
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    blk[kZigzag[k]] = (int16_t)((unsigned)v << (progressive_ ? al_ : 0));
  }
}

void Decoder::scan() {
  if (lossless_) {
    scan_lossless();
    return;
  }
  reset_bits();
  eobrun_ = 0;
  for (int i = 0; i < ncomp_; ++i) comp_[i].dc_pred = 0;
  if (arith_) {  // jdarith.c start_pass
    for (int i = 0; i < sn_; ++i) {
      Component& c = comp_[scomp_[i]];
      if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
        std::memset(dc_stats_[c.td], 0, 64);
        c.dc_context = 0;
      }
      if (!progressive_ || ss_) std::memset(ac_stats_[c.ta], 0, 256);
    }
    ac_c_ = 0;
    ac_a_ = 0;
    ac_ct_ = -16;
    unread_marker_ = 0;
    arith_limit_ = std::min(n_, (sos_end_ + kPilBlock - 1) / kPilBlock * kPilBlock);
  }
  int units_x, units_y;
  const bool single = sn_ == 1;
  if (single) {  // a non-interleaved scan walks the component's own blocks
    const Component& c = comp_[scomp_[0]];
    units_x = (c.cw + 7) / 8;
    units_y = (c.ch + 7) / 8;
  } else {
    units_x = mcux_;
    units_y = mcuy_;
  }
  const int total = units_x * units_y;
  int todo = restart_;
  for (int u = 0; u < total; ++u) {
    if (restart_ && todo == 0 && arith_) {
      arith_restart();
      todo = restart_;
    } else if (restart_ && todo == 0) {
      // byte-align, expect RSTn, reset predictors
      reset_bits();
      const int m = next_marker();
      if (m < 0xD0 || m > 0xD7) fail("JPEG: missing restart marker");
      eobrun_ = 0;
      for (int i = 0; i < ncomp_; ++i) comp_[i].dc_pred = 0;
      todo = restart_;
    }
    const int ux = u % units_x, uy = u / units_x;
    if (single) {
      Component& c = comp_[scomp_[0]];
      int16_t* blk = &c.coef[((size_t)uy * c.bw + ux) * 64];
      if (arith_) arith_block(c, blk);
      else decode_block(c, blk);
    } else {
      for (int i = 0; i < sn_; ++i) {
        Component& c = comp_[scomp_[i]];
        for (int by = 0; by < c.v; ++by)
          for (int bx = 0; bx < c.h; ++bx) {
            const size_t b = (size_t)(uy * c.v + by) * c.bw + (ux * c.h + bx);
            if (arith_) arith_block(c, &c.coef[b * 64]);
            else decode_block(c, &c.coef[b * 64]);
          }
      }
    }
    if (restart_) --todo;
  }
  // leave the reader at the marker that ends the scan
  if (!arith_) reset_bits();
}

// ------------------------------------------------------------ lossless
// jdlhuff.c: a difference's category, then its bits; category 16 is 32768
int Decoder::lossless_diff(const Huffman& h) {
  const int s = decode_huff(h);
  if (s == 0) return 0;
  if (s == 16) return 32768;
  if (s > 16) fail("JPEG: corrupt lossless difference");
  return extend(get_bits(s), s);
}

// A lossless scan: the differences of every sample, then jdpred.c's
// undifferencing row by row into samples (value << Pt, kept to 8 bits).
void Decoder::scan_lossless() {
  reset_bits();
  const bool single = sn_ == 1;
  for (int i = 0; i < sn_; ++i) {
    Component& c = comp_[scomp_[i]];
    c.lw = single ? c.cw : mcux_ * c.h;
    c.lh = single ? c.ch : mcuy_ * c.v;
    c.diff.assign((size_t)c.lw * c.lh, 0);
  }
  const int units_x = single ? comp_[scomp_[0]].cw : mcux_;
  const int units_y = single ? comp_[scomp_[0]].ch : mcuy_;
  if (restart_ && restart_ % units_x)
    fail("JPEG: a lossless restart interval that is not a whole number of MCU rows");
  std::vector<char> first_row(units_y, 0);
  first_row[0] = 1;
  int todo = restart_;
  const size_t total = (size_t)units_x * units_y;
  for (size_t u = 0; u < total; ++u) {
    const int ux = (int)(u % units_x), uy = (int)(u / units_x);
    if (restart_ && todo == 0) {
      reset_bits();
      const int m = next_marker();
      if (m < 0xD0 || m > 0xD7) fail("JPEG: missing restart marker");
      first_row[uy] = 1;
      todo = restart_;
    }
    for (int i = 0; i < sn_; ++i) {
      Component& c = comp_[scomp_[i]];
      const int h = single ? 1 : c.h, v = single ? 1 : c.v;
      for (int by = 0; by < v; ++by)
        for (int bx = 0; bx < h; ++bx)
          c.diff[(size_t)(uy * v + by) * c.lw + ux * h + bx] = lossless_diff(dc_[c.td]);
    }
    if (restart_) --todo;
  }
  reset_bits();
  const int pt = al_;
  for (int i = 0; i < sn_; ++i) {
    Component& c = comp_[scomp_[i]];
    const int rows_per = single ? 1 : c.v, w = c.lw;
    std::vector<int> prev(w), cur(w);
    for (int r = 0; r < c.lh; ++r) {
      int* d = &c.diff[(size_t)r * w];
      if (r % rows_per == 0 && first_row[r / rows_per]) {
        int ra = (d[0] + (1 << (7 - pt))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < w; ++x) cur[x] = ra = (d[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0], ra = (d[0] + rb) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < w; ++x) {
          const int rc = rb;
          rb = prev[x];
          int p;
          switch (ss_) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (d[x] + p) & 0xFFFF;
        }
      }
      for (int x = 0; x < w; ++x) d[x] = (uint8_t)(cur[x] << pt);
      prev.swap(cur);
    }
  }
}

void Decoder::header() {
  if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail("JPEG: no SOI marker");
  pos_ = 2;
  for (;;) {
    const int m = next_marker();
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) fail("JPEG: no scan before EOI");
    const size_t start = pos_;
    const int len = u16();
    const size_t end = start + len;
    if (len < 2 || end > n_) fail("JPEG: segment runs past the end");
    if (m == 0xDA) {
      read_sos();
      return;
    }
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      read_frame(m);
    } else if (m == 0xC4) {
      read_dht(end);
    } else if (m == 0xCC) {
      read_dac(end);
    } else if (m == 0xDB) {
      read_dqt(end);
    } else if (m == 0xDD) {
      restart_ = u16();
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m, end);
    }
    pos_ = end;
  }
}

void Decoder::decode() {
  for (;;) {
    scan();
    // markers between scans
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) {
        eoi_ = true;
        break;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray restart marker
      const size_t start = pos_;
      const int len = u16();
      const size_t end = start + len;
      if (len < 2 || end > n_) fail("JPEG: segment runs past the end");
      if (m == 0xDA) {
        read_sos();
        break;
      }
      if (m == 0xC4) read_dht(end);
      else if (m == 0xDB) read_dqt(end);
      else if (m == 0xDD) restart_ = u16();
      else if (m == 0xCC) read_dac(end);
      pos_ = end;
    }
    if (eoi_) break;
  }
  if (progressive_) {
    // libjpeg smooths blocks (jdcoefct.c decompress_smooth_data) when the
    // DC is known and one of the first nine AC coefficients of a component
    // is not refined to full precision; that is not reproduced
    bool smooth = true, useful = false;
    for (int i = 0; i < ncomp_; ++i) {
      const Component& c = comp_[i];
      if (c.coef_bits[0] < 0) smooth = false;
      static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
      for (int q : kQ)
        if (!c.latched || c.quant[q] == 0) smooth = false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    smooth_ = smooth && useful;
  }
}

// jdcoefct.c decompress_smooth_data without DC interpolation: each of the
// first five AC coefficients (zigzag 1-5) still zero and not known to full
// precision is estimated from the DC values of the block's 5 x 5
// neighbourhood. Columns past the component's blocks repeat the edge
// column; rows come as libjpeg's row pointers take them, by iMCU row, so
// near the bottom they may reach the padding rows of the coefficient
// buffer (a lone component's are zero, the interleaved DC scan fills the
// others'). Writes the smoothed block into `ws`.
void Decoder::smooth_block(const Component& c, int by, int bx, int16_t* ws) const {
  const int wib = (c.cw + 7) / 8, hib = (c.ch + 7) / 8;
  const int v = c.sv;
  // iMCU rows: of the frame, or of the lone component at its own factors
  const int total = ncomp_ == 1 ? (height_ + 8 * v - 1) / (8 * v) : mcuy_;
  const int imcu = by / v, last_imcu = total - 1;
  int block_rows = v;
  if (imcu == last_imcu) {
    block_rows = hib % v;
    if (block_rows == 0) block_rows = v;
  }
  const int image_block_row = imcu * block_rows + by % v;
  const int image_block_rows = block_rows * total;
  auto dc = [&](int row, int col) { return (int64_t)c.coef[((size_t)row * c.bw + col) * 64]; };
  const int r0 = by;
  const int rp = image_block_row > 0 ? r0 - 1 : r0;
  const int rpp = image_block_row > 1 ? r0 - 2 : rp;
  const int rn = image_block_row < image_block_rows - 1 ? r0 + 1 : r0;
  const int rnn = image_block_row < image_block_rows - 2 ? r0 + 2 : rn;
  const int rows[5] = {rpp, rp, r0, rn, rnn};
  // DC01..DC25: columns bx - 2 .. bx + 2 clamped to the component's blocks
  int64_t reg[5][5];
  for (int r = 0; r < 5; ++r)
    for (int k = 0; k < 5; ++k) reg[r][k] = dc(rows[r], std::min(std::max(bx + k - 2, 0), wib - 1));
  const int64_t DC01 = reg[0][0], DC02 = reg[0][1], DC03 = reg[0][2], DC04 = reg[0][3],
                DC05 = reg[0][4], DC06 = reg[1][0], DC07 = reg[1][1], DC08 = reg[1][2],
                DC09 = reg[1][3], DC10 = reg[1][4], DC11 = reg[2][0], DC12 = reg[2][1],
                DC13 = reg[2][2], DC14 = reg[2][3], DC15 = reg[2][4], DC16 = reg[3][0],
                DC17 = reg[3][1], DC18 = reg[3][2], DC19 = reg[3][3], DC20 = reg[3][4],
                DC21 = reg[4][0], DC22 = reg[4][1], DC23 = reg[4][2], DC24 = reg[4][3],
                DC25 = reg[4][4];
  std::memcpy(ws, &c.coef[((size_t)by * c.bw + bx) * 64], 64 * sizeof(int16_t));
  const int64_t Q00 = c.quant[0];
  auto estimate = [&](int zz, int pos, int64_t q, int64_t sum) {
    const int al = c.coef_bits[zz];
    if (al == 0 || ws[pos] != 0) return;
    const int64_t num = Q00 * sum;
    int64_t pred;
    if (num >= 0) {
      pred = ((q << 7) + num) / (q << 8);
      if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
    } else {
      pred = ((q << 7) - num) / (q << 8);
      if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
      pred = -pred;
    }
    ws[pos] = (int16_t)pred;
  };
  // DC interpolation when no AC coefficient of 1-9 has arrived at all
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc = change_dc && c.coef_bits[k] == -1;
  if (!change_dc) {
    estimate(1, 1, c.quant[1], -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);          // AC01
    estimate(2, 8, c.quant[8], -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);          // AC10
    estimate(3, 16, c.quant[16], -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);    // AC20
    estimate(4, 9, c.quant[9], DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                   DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09);         // AC11
    estimate(5, 2, c.quant[2], -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);      // AC02
    return;
  }
  estimate(1, 1, c.quant[1], -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                 DC24 + DC25);                                           // AC01
  estimate(2, 8, c.quant[8], -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25);                 // AC10
  estimate(3, 16, c.quant[16], DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                   14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                                   DC23);                                                // AC20
  estimate(4, 9, c.quant[9], -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
                                 DC25);                                                  // AC11
  estimate(5, 2, c.quant[2], 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19);     // AC02
  estimate(6, 3, c.quant[3], DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);          // AC03
  estimate(7, 10, c.quant[10], DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);        // AC12
  estimate(8, 17, c.quant[17], DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);        // AC21
  estimate(9, 24, c.quant[24], DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);        // AC30
  const int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                             6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                             8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                             6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                             2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
  ws[0] = (int16_t)(num >= 0 ? ((Q00 << 7) + num) / (Q00 << 8)
                             : -(((Q00 << 7) - num) / (Q00 << 8)));                     // DC
}

// ------------------------------------------------------------ reconstruction
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t t[1024];  // jdmaster.c prepare_range_limit_table, post-IDCT half
  RangeLimit() {
    for (int j = 0; j < 1024; ++j)
      t[j] = j < 128 ? (uint8_t)(128 + j) : j < 512 ? 255 : j < 896 ? 0 : (uint8_t)(j - 896);
  }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow: coef in natural order, q the quantisation
// table; writes 8 rows of 8 samples at out (row stride `stride`).
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, size_t stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* in = coef + col;
    const uint16_t* qt = q + col;
    int* w = ws + col;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      const int dc = (int)in[0] * qt[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = (int)descale(tmp10 + tmp3, sh);
    w[56] = (int)descale(tmp10 - tmp3, sh);
    w[8] = (int)descale(tmp11 + tmp2, sh);
    w[48] = (int)descale(tmp11 - tmp2, sh);
    w[16] = (int)descale(tmp12 + tmp1, sh);
    w[40] = (int)descale(tmp12 - tmp1, sh);
    w[24] = (int)descale(tmp13 + tmp0, sh);
    w[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int row = 0; row < 8; ++row) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + row * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = kRange.t[(int)descale(w[0], PASS1_BITS + 3) & 1023];
      for (int i = 0; i < 8; ++i) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[(int)descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.t[(int)descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.t[(int)descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.t[(int)descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.t[(int)descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.t[(int)descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.t[(int)descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.t[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// One component's samples upsampled to (out_h, out_w) >= the image, from
// its cw x ch samples (plane row stride ps). Rows past ch repeat row
// ch - 1 and the row above row 0 is row 0, as jdmainct.c's context rows.
void upsample(const uint8_t* plane, size_t ps, int cw, int ch, int fx, int fy, uint8_t* out,
              int out_w, int out_h) {
  auto row = [&](int y) { return plane + (size_t)std::min(std::max(y, 0), ch - 1) * ps; };
  if (fx == 1 && fy == 1) {
    for (int y = 0; y < out_h; ++y) std::memcpy(out + (size_t)y * out_w, row(y), out_w);
    return;
  }
  std::vector<uint8_t> tmp(2 * (size_t)cw);
  if (fx == 2 && fy == 1) {
    for (int y = 0; y < out_h; ++y) {
      const uint8_t* in = row(y);
      uint8_t* o = out + (size_t)y * out_w;
      if (cw > 2) {  // jdsample.c h2v1_fancy_upsample
        tmp[0] = in[0];
        tmp[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < cw - 1; ++x) {
          const int v = in[x] * 3;
          tmp[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
          tmp[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
        }
        tmp[2 * cw - 2] = (uint8_t)((in[cw - 1] * 3 + in[cw - 2] + 1) >> 2);
        tmp[2 * cw - 1] = in[cw - 1];
      } else {  // h2v1_upsample
        for (int x = 0; x < cw; ++x) tmp[2 * x] = tmp[2 * x + 1] = in[x];
      }
      std::memcpy(o, tmp.data(), out_w);
    }
    return;
  }
  if (fx == 1 && fy == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < out_h; ++y) {
      const int yi = y / 2;
      const uint8_t* in0 = row(yi);
      const uint8_t* in1 = (y & 1) ? row(yi + 1) : row(yi - 1);
      const int bias = (y & 1) ? 2 : 1;
      uint8_t* o = out + (size_t)y * out_w;
      for (int x = 0; x < out_w; ++x) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    }
    return;
  }
  if (fx != 2 || fy != 2) {  // jdsample.c int_upsample: replicate
    for (int y = 0; y < out_h; ++y) {
      const uint8_t* in = row(y / fy);
      uint8_t* o = out + (size_t)y * out_w;
      for (int x = 0; x < out_w; ++x) o[x] = in[x / fx];
    }
    return;
  }
  // fx == 2 && fy == 2
  for (int y = 0; y < out_h; ++y) {
    const int yi = y / 2;
    const uint8_t* in0 = row(yi);
    const uint8_t* in1 = (y & 1) ? row(yi + 1) : row(yi - 1);
    uint8_t* o = out + (size_t)y * out_w;
    if (cw > 2) {  // h2v2_fancy_upsample
      int thiscol = in0[0] * 3 + in1[0];
      int nextcol = in0[1] * 3 + in1[1];
      tmp[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
      tmp[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 1; x < cw - 1; ++x) {
        nextcol = in0[x + 1] * 3 + in1[x + 1];
        tmp[2 * x] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        tmp[2 * x + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      tmp[2 * cw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      tmp[2 * cw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
    } else {  // h2v2_upsample: replicate
      for (int x = 0; x < cw; ++x) tmp[2 * x] = tmp[2 * x + 1] = in0[x];
    }
    std::memcpy(o, tmp.data(), out_w);
  }
}

void Decoder::output(uint8_t* out) const {
  const int W = width_, H = height_;
  std::vector<std::vector<uint8_t>> full(ncomp_);
  if (lossless_) {  // libjpeg-turbo converts no colours in lossless mode
    if (ncomp_ == 3 && (jfif_ || (adobe_ && adobe_transform_ != 0)))
      fail("JPEG: a lossless frame marked YCbCr (JFIF, or an Adobe transform other than 0) "
           "would need a colour conversion, which libjpeg-turbo refuses in lossless mode");
    if (ncomp_ == 4 && adobe_ && adobe_transform_ != 0)
      fail("JPEG: a lossless YCCK frame would need a colour conversion, which libjpeg-turbo "
           "refuses in lossless mode");
    for (int i = 0; i < ncomp_; ++i)
      if (comp_[i].diff.empty()) fail("JPEG: a component no scan covered");
    // a subsampled component is upsampled by replication: jdsample.c
    // takes no fancy upsampling when min_DCT_scaled_size is 1
    for (size_t p = 0; p < (size_t)W * H; ++p) {
      const int x = (int)(p % W), y = (int)(p / W);
      for (int i = 0; i < ncomp_; ++i) {
        const Component& c = comp_[i];
        const int fx = hmax_ / c.h, fy = vmax_ / c.v;
        out[ncomp_ * p + i] = (uint8_t)c.diff[(size_t)(y / fy) * c.lw + x / fx];
      }
    }
    return;
  }
  for (int i = 0; i < ncomp_; ++i) {
    const Component& c = comp_[i];
    const size_t ps = (size_t)c.bw * 8;
    std::vector<uint8_t> plane(ps * c.bh * 8);
    const int wib = (c.cw + 7) / 8, hib = (c.ch + 7) / 8;
    int16_t ws[64];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) {
        const int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
        if (smooth_ && by < hib && bx < wib) {
          smooth_block(c, by, bx, ws);
          blk = ws;
        }
        idct_islow(blk, c.quant, plane.data() + (size_t)by * 8 * ps + bx * 8, ps);
      }
    const int fx = hmax_ / c.h, fy = vmax_ / c.v;
    full[i].resize((size_t)W * H);
    // the fancy h2v2 and h2v1 edge column sits at the downsampled width
    upsample(plane.data(), ps, c.cw, c.ch, fx, fy, full[i].data(), W, H);
  }
  if (ncomp_ == 1) {
    std::memcpy(out, full[0].data(), (size_t)W * H);
    return;
  }
  bool plain;  // no colour conversion: RGB or CMYK
  if (ncomp_ == 4) plain = !adobe_ || adobe_transform_ == 0;
  else if (jfif_) plain = false;
  else if (adobe_) plain = adobe_transform_ == 0;
  else plain = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
  const size_t npix = (size_t)W * H;
  if (plain) {
    for (size_t p = 0; p < npix; ++p)
      for (int k = 0; k < ncomp_; ++k) out[ncomp_ * p + k] = full[k][p];
    return;
  }
  // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
  static int cr_r[256], cb_b[256];
  static int64_t cr_g[256], cb_g[256];
  static bool built = false;
  if (!built) {
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    built = true;
  }
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  if (ncomp_ == 4) {  // ycck_cmyk_convert: inverted YCbCr -> RGB, K as it is
    for (size_t p = 0; p < npix; ++p) {
      const int y = full[0][p], cb = full[1][p], cr = full[2][p];
      out[4 * p] = clamp(255 - (y + cr_r[cr]));
      out[4 * p + 1] = clamp(255 - (y + (int)((cb_g[cb] + cr_g[cr]) >> 16)));
      out[4 * p + 2] = clamp(255 - (y + cb_b[cb]));
      out[4 * p + 3] = full[3][p];
    }
    return;
  }
  for (size_t p = 0; p < npix; ++p) {
    const int y = full[0][p], cb = full[1][p], cr = full[2][p];
    out[3 * p] = clamp(y + cr_r[cr]);
    out[3 * p + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * p + 2] = clamp(y + cb_b[cb]);
  }
}

void copy_error(const std::string& what, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", what.c_str());
}

}  // namespace

extern "C" {

// Reads the headers of a JPEG (through its first scan's header): writes
// width, height and channels (1 grey, 3 RGB, 4 CMYK as libjpeg gives it)
// to dims. Returns 0, or 1 with
// the reason in err.
int cv_jpeg_info(const uint8_t* data, size_t n, int* dims, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.header();
    dims[0] = d.width();
    dims[1] = d.height();
    dims[2] = d.channels();
    return 0;
  } catch (const Error& e) {
    copy_error(e.what, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(std::string("JPEG: ") + e.what(), err, errlen);
    return 1;
  }
}

// Decodes a JPEG into out: height x width x channels uint8 as cv_jpeg_info
// gives them. Returns 0, or 1 with the reason in err.
int cv_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.header();
    d.decode();
    d.output(out);
    return 0;
  } catch (const Error& e) {
    copy_error(e.what, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(std::string("JPEG: ") + e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
