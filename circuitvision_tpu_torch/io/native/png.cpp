// PNG row unfiltering (PNG specification, section 9: filter types 0-4).
//
// Host half of the port's PNG reader (circuitvision_tpu_torch/io/
// image_io.py), which does everything else in Python: chunks, zlib,
// colour types, EXIF orientation. The Sub, Average and Paeth filters
// each depend on the pixel to the left as already reconstructed, so a
// row cannot be undone with whole-row numpy operations; a 1000 x 750 RGB
// image is 2.25 M such steps.
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// `filtered` holds `height` rows of 1 + `stride` bytes (the filter type,
// then the row); `out` receives height x stride reconstructed bytes.
// `bpp` is the bytes per pixel. Returns 0, or 1 + the row whose filter
// type is not 0-4.
int cv_png_unfilter(const uint8_t* filtered, int height, int stride, int bpp, uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = filtered + static_cast<int64_t>(y) * (stride + 1);
    const int type = src[0];
    ++src;
    uint8_t* row = out + static_cast<int64_t>(y) * stride;
    const uint8_t* up = y ? row - stride : nullptr;
    switch (type) {
      case 0:
        for (int i = 0; i < stride; ++i) row[i] = src[i];
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) row[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= bpp ? row[i - bpp] : 0, above = up ? up[i] : 0;
          row[i] = static_cast<uint8_t>(src[i] + ((left + above) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= bpp ? row[i - bpp] : 0, above = up ? up[i] : 0;
          const int diag = (i >= bpp && up) ? up[i - bpp] : 0;
          row[i] = static_cast<uint8_t>(src[i] + paeth(left, above, diag));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
