// CCITT T.4 and T.6 decoding as libtiff's fax codec decodes a TIFF strip for
// Pillow: compression 2 (modified Huffman, each row byte-aligned, no EOL), 3
// (T.4: EOLs, 1-D rows or, with T4Options bit 0, a tag bit choosing 1-D or
// 2-D per row) and 4 (T.6: 2-D rows against the previous one, the first
// against an all-white line). A row's runs alternate white and black,
// white first; the row is written packed, most significant bit first, a
// black run's pixels as 1 (the reader applies the photometric). Each strip
// starts afresh, as in libtiff. Built with g++ at first use.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// the run-length codes of T.4 (tables 2 and 3), terminating then makeup,
// then the makeup codes both colours share (1792-2560)
const char* const kWhiteTerm[] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100",
};
const char* const kWhiteMakeup[] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011",
};
const char* const kBlackTerm[] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111",
};
const char* const kBlackMakeup[] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101",
};
const char* const kExtMakeup[] = {
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111",
};

// 2-D mode codes (T.4 table 4): pass, horizontal, vertical -3..3
const char* const kModes[] = {"0001", "001", "0000010", "000010", "010", "1", "011", "000011",
                              "0000011"};
enum { kPass = 0, kHorizontal = 1, kV0 = 5 };  // vertical k is kV0 + k

const int kBits = 13;
struct Entry {
  int16_t value = -1;  // a run length, or a mode; -1 for no code
  int8_t length = 0;
};

struct Table {
  std::vector<Entry> e = std::vector<Entry>(1 << kBits);
  void add(const char* code, int value) {
    const int n = (int)std::strlen(code);
    int bits = 0;
    for (int i = 0; i < n; ++i) bits = bits * 2 + (code[i] == '1');
    const int lo = bits << (kBits - n), hi = (bits + 1) << (kBits - n);
    for (int i = lo; i < hi; ++i) e[i] = Entry{(int16_t)value, (int8_t)n};
  }
};

struct Tables {
  Table white, black, modes;
  Tables() {
    for (int i = 0; i < 64; ++i) {
      white.add(kWhiteTerm[i], i);
      black.add(kBlackTerm[i], i);
    }
    for (int i = 0; i < 27; ++i) {
      white.add(kWhiteMakeup[i], 64 * (i + 1));
      black.add(kBlackMakeup[i], 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
      white.add(kExtMakeup[i], 1792 + 64 * i);
      black.add(kExtMakeup[i], 1792 + 64 * i);
    }
    for (int i = 0; i < 9; ++i) modes.add(kModes[i], i);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

struct Reader {
  const uint8_t* in;
  size_t bits;  // bits in the input
  size_t pos = 0;
  int peek(int n) const {  // the next n bits, zeros past the end
    int v = 0;
    for (int i = 0; i < n; ++i) {
      const size_t p = pos + i;
      v = v * 2 + (p < bits ? (in[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    return v;
  }
  bool code(const Table& t, int* value) {
    if (pos >= bits) return false;
    const Entry& e = t.e[peek(kBits)];
    if (e.value < 0 || pos + e.length > bits) return false;
    pos += e.length;
    *value = e.value;
    return true;
  }
  bool run(int color, int* total) {  // makeup codes, then a terminating one
    const Table& t = color ? tables().black : tables().white;
    *total = 0;
    for (;;) {
      int r;
      if (!code(t, &r)) return false;
      *total += r;
      if (r < 64) return true;
    }
  }
  void align() { pos = (pos + 7) & ~size_t(7); }
  void skip_eol() {  // fill zeros before an EOL's 1, when at least 11 zeros come
    if (peek(11) != 0 || pos >= bits) return;
    while (pos < bits && peek(1) == 0) ++pos;
    ++pos;
  }
};

// one row's changing elements (positions where the colour changes, white
// first), 1-D
bool row_1d(Reader& r, int w, std::vector<int>& cur) {
  cur.clear();
  int a0 = 0, color = 0;
  while (a0 < w) {
    int run;
    if (!r.run(color, &run)) return false;
    a0 += run;
    cur.push_back(a0 < w ? a0 : w);
    color ^= 1;
  }
  return true;
}

// 2-D against the reference row's changing elements
bool row_2d(Reader& r, int w, const std::vector<int>& ref, std::vector<int>& cur) {
  cur.clear();
  int a0 = -1, color = 0;
  while (a0 < w) {
    int mode;
    if (!r.code(tables().modes, &mode)) return false;
    size_t i = 0;  // b1: the first change right of a0 to the other colour
    while (i < ref.size() && (ref[i] <= a0 || (int)(i & 1) != color)) ++i;
    const int b1 = i < ref.size() ? ref[i] : w;
    const int b2 = i + 1 < ref.size() ? ref[i + 1] : w;
    if (mode == kPass) {
      a0 = b2;
    } else if (mode == kHorizontal) {
      int r1, r2;
      if (!r.run(color, &r1) || !r.run(color ^ 1, &r2)) return false;
      const int a1 = (a0 < 0 ? 0 : a0) + r1, a2 = a1 + r2;
      cur.push_back(a1 < w ? a1 : w);
      cur.push_back(a2 < w ? a2 : w);
      a0 = a2;
    } else {
      const int a1 = b1 + (mode - kV0);
      if (a1 < 0 || a1 < a0) return false;
      cur.push_back(a1 < w ? a1 : w);
      a0 = a1;
      color ^= 1;
    }
  }
  return true;
}

void pack(const std::vector<int>& changes, int w, uint8_t* row) {
  std::memset(row, 0, (w + 7) / 8);
  int x = 0, color = 0;
  for (size_t i = 0; i <= changes.size(); ++i) {
    const int c = i < changes.size() ? changes[i] : w;
    if (color)
      for (int p = x; p < c && p < w; ++p) row[p >> 3] |= 0x80 >> (p & 7);
    x = c;
    color ^= 1;
  }
}

}  // namespace

extern "C" {

// Decodes `rows` rows `width` pixels wide of one strip; returns the rows
// decoded, which are fewer where a code is not one of the tables'.
int cv_ccitt_decode(const uint8_t* in, size_t n, int scheme, int t4_options, int width,
                    int rows, uint8_t* out) {
  Reader r{in, n * 8};
  std::vector<int> ref, cur;
  const int stride = (width + 7) / 8;
  for (int y = 0; y < rows; ++y) {
    bool ok;
    if (scheme == 2) {
      if (y) r.align();
      ok = row_1d(r, width, cur);
    } else if (scheme == 3) {
      r.skip_eol();
      if (t4_options & 1) {
        const int one_d = r.peek(1);
        ++r.pos;
        ok = one_d ? row_1d(r, width, cur) : row_2d(r, width, ref, cur);
      } else {
        ok = row_1d(r, width, cur);
      }
    } else {
      ok = row_2d(r, width, ref, cur);
    }
    if (!ok) return y;
    pack(cur, width, out + (size_t)y * stride);
    ref.swap(cur);
  }
  return rows;
}

}  // extern "C"
