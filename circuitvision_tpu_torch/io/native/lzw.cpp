// The byte-stream decoders of the GIF and TIFF readers (io/gif.py,
// io/tiff.py), built with g++ at first use and called through ctypes:
//
//   cv_gif_lzw     GIF's LZW: codes packed least significant bit first,
//                  from the minimum code size + 1 bits up to 12; a full
//                  table (4096 codes) is kept until the next clear code,
//                  as Pillow's GifDecode.c keeps it;
//   cv_tiff_lzw    TIFF's LZW (compression 5) as libtiff's LZWDecode reads
//                  it: codes packed most significant bit first, 9 to 12
//                  bits, the code width growing one code early;
//   cv_packbits    PackBits (compression 32773) as libtiff's
//                  PackBitsDecode reads it.
//
// Each returns 0 and the bytes written, or 1 with a message naming what
// was wrong. Output stops when the buffer is full.
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Table {
    // each code: its prefix code, last byte, first byte and length
    std::vector<int32_t> prefix = std::vector<int32_t>(4096);
    std::vector<uint8_t> last = std::vector<uint8_t>(4096), first = std::vector<uint8_t>(4096);
    std::vector<int32_t> length = std::vector<int32_t>(4096);
    std::vector<uint8_t> scratch = std::vector<uint8_t>(4096);
};

int fail(char *err, int errlen, const char *msg) {
    std::snprintf(err, errlen, "%s", msg);
    return 1;
}

// writes the string of `code` at out[*pos...], cut at cap
void emit(Table &t, int code, uint8_t *out, size_t cap, size_t *pos) {
    int n = t.length[code];
    for (int i = n - 1, c = code; i >= 0; --i, c = t.prefix[c]) t.scratch[i] = t.last[c];
    size_t take = static_cast<size_t>(n);
    if (*pos + take > cap) take = cap - *pos;
    std::memcpy(out + *pos, t.scratch.data(), take);
    *pos += take;
}

}  // namespace

extern "C" {

int cv_gif_lzw(const uint8_t *in, size_t n, int min_bits, uint8_t *out, size_t cap,
               size_t *written, int *ended, char *err, int errlen) {
    *written = 0;
    *ended = 0;
    if (min_bits < 0 || min_bits > 11) return fail(err, errlen, "LZW minimum code size out of range");
    Table t;
    const int clear = 1 << min_bits, eoi = clear + 1;
    for (int i = 0; i < clear; ++i) {
        t.prefix[i] = -1;
        t.last[i] = t.first[i] = static_cast<uint8_t>(i);
        t.length[i] = 1;
    }
    int width = min_bits + 1, next = clear + 2, prev = -1;
    uint32_t acc = 0;
    int bits = 0;
    size_t at = 0, pos = 0;
    while (pos < cap) {
        while (bits < width && at < n) {
            acc |= static_cast<uint32_t>(in[at++]) << bits;
            bits += 8;
        }
        if (bits < width) break;  // the data ends before the image does
        int code = static_cast<int>(acc & ((1u << width) - 1));
        acc >>= width;
        bits -= width;
        if (code == clear) {
            width = min_bits + 1;
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == eoi) {
            *ended = 1;
            break;
        }
        if (prev < 0) {
            if (code >= clear) return fail(err, errlen, "LZW code out of range after a clear code");
            emit(t, code, out, cap, &pos);
            prev = code;
            continue;
        }
        int firstbyte;
        if (code < next) {
            firstbyte = t.first[code];
        } else if (code == next) {
            firstbyte = t.first[prev];
        } else {
            return fail(err, errlen, "LZW code past the end of the table");
        }
        if (next < 4096) {
            t.prefix[next] = prev;
            t.last[next] = static_cast<uint8_t>(firstbyte);
            t.first[next] = t.first[prev];
            t.length[next] = t.length[prev] + 1;
            ++next;
            if (next == (1 << width) && width < 12) ++width;
        }
        emit(t, code, out, cap, &pos);
        prev = code;
    }
    *written = pos;
    return 0;
}

int cv_tiff_lzw(const uint8_t *in, size_t n, uint8_t *out, size_t cap, size_t *written,
                char *err, int errlen) {
    *written = 0;
    if (n >= 2 && in[0] == 0 && (in[1] & 1))
        return fail(err, errlen, "old-style (LSB-first) LZW is not read");
    Table t;
    for (int i = 0; i < 256; ++i) {
        t.prefix[i] = -1;
        t.last[i] = t.first[i] = static_cast<uint8_t>(i);
        t.length[i] = 1;
    }
    const int clear = 256, eoi = 257;
    int width = 9, next = 258, prev = -1;
    uint64_t acc = 0;
    int bits = 0;
    size_t at = 0, pos = 0;
    while (pos < cap) {
        while (bits < width && at < n) {
            acc = (acc << 8) | in[at++];
            bits += 8;
        }
        if (bits < width) break;
        int code = static_cast<int>((acc >> (bits - width)) & ((1u << width) - 1));
        bits -= width;
        if (code == clear) {
            width = 9;
            next = 258;
            prev = -1;
            continue;
        }
        if (code == eoi) break;
        if (prev < 0) {
            if (code >= clear) return fail(err, errlen, "LZW code out of range after a clear code");
            emit(t, code, out, cap, &pos);
            prev = code;
            continue;
        }
        int firstbyte;
        if (code < next) {
            firstbyte = t.first[code];
        } else if (code == next) {
            firstbyte = t.first[prev];
        } else {
            return fail(err, errlen, "corrupted LZW table (a code past its end)");
        }
        if (next >= 4096) return fail(err, errlen, "corrupted LZW table (more than 4096 codes)");
        t.prefix[next] = prev;
        t.last[next] = static_cast<uint8_t>(firstbyte);
        t.first[next] = t.first[prev];
        t.length[next] = t.length[prev] + 1;
        ++next;
        // libtiff widens the code one entry early
        if (next >= (1 << width) - 1 && width < 12) ++width;
        emit(t, code, out, cap, &pos);
        prev = code;
    }
    *written = pos;
    return 0;
}

int cv_packbits(const uint8_t *in, size_t n, uint8_t *out, size_t cap, size_t *written,
                size_t *consumed) {
    size_t at = 0, pos = 0;
    while (pos < cap && at < n) {
        int c = static_cast<int8_t>(in[at++]);
        if (c < 0) {
            if (c == -128) continue;
            if (at >= n) break;
            size_t run = static_cast<size_t>(1 - c);
            if (run > cap - pos) run = cap - pos;
            std::memset(out + pos, in[at++], run);
            pos += run;
        } else {
            size_t run = static_cast<size_t>(c) + 1;
            if (run > n - at) run = n - at;
            if (run > cap - pos) run = cap - pos;
            std::memcpy(out + pos, in + at, run);
            pos += run;
            at += static_cast<size_t>(c) + 1;
        }
    }
    *written = pos;
    *consumed = at < n ? at : n;
    return 0;
}

// PCX run-length lines as Pillow's PcxDecode reads them: a byte with its
// two high bits set repeats the next byte as often as its low six bits
// say, any other byte is itself. Decodes up to `lines` lines of
// `line_bytes` into out; returns the lines decoded (fewer when the data
// ends), or -1 where a run reaches past the end of a line (Pillow's overrun,
// which fails the image).
int cv_pcx_rle(const uint8_t *in, size_t n, uint8_t *out, int line_bytes, int lines) {
  size_t p = 0;
  int x = 0, y = 0;
  while (y < lines && p < n) {
    uint8_t *line = out + (size_t)y * line_bytes;
    if ((in[p] & 0xC0) == 0xC0) {
      if (p + 1 >= n) break;
      for (int k = in[p] & 0x3F; k > 0; --k) {
        if (x >= line_bytes) return -1;
        line[x++] = in[p + 1];
      }
      p += 2;
    } else {
      line[x++] = in[p++];
    }
    if (x >= line_bytes) {
      x = 0;
      ++y;
    }
  }
  return y;
}

}  // extern "C"
