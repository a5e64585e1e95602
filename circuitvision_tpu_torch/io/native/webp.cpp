// WebP decoding for the port's image reader (circuitvision_tpu_torch/io/
// webp.py, which parses the RIFF container and composes frames), held byte
// for byte to what libwebp 1.6.0's WebPAnimDecoder writes in MODE_RGBA
// (not premultiplied; the decoder Pillow 12.1.0 reads every WebP through):
//
//   * VP8L, the lossless bitstream (WebP Lossless Bitstream specification):
//     the predictor (14 modes; 14 and 15 act as mode 0, as libwebp's
//     sentinels do), cross-colour, subtract-green and colour-indexing
//     transforms with pixel bundling, meta prefix codes, the colour cache,
//     and LZ77 back-references with the 120-entry distance map. Prefix
//     codes are built as libwebp builds them: a code with one used symbol
//     reads no bits, any other must be complete;
//   * VP8, the lossy key frame (RFC 6386): the boolean decoder as
//     libwebp's bit reader runs it (its end-of-data rule included), the
//     segment, filter and quantiser headers, token partitions, intra
//     prediction with libwebp's edge values (127 above the frame, 129 to
//     its left) and DC special cases, the inverse WHT and DCT, and the
//     simple and normal loop filters in raster order; then libwebp's
//     "fancy" 4:2:0 upsampler and its 14-bit fixed-point YUV -> RGB
//     (VP8YUVToR/G/B), which are libwebp's own rather than the RFC's;
//   * ALPH: uncompressed or VP8L-compressed (the green channel), with the
//     horizontal, vertical and gradient unfilters. libwebp smooths alpha
//     levels only when asked for alpha dithering, which WebPAnimDecoder
//     never asks for, so the pre-processing bit changes nothing here.
//
// The constant tables are RFC 6386's (dc_qlookup and ac_qlookup, 14.1;
// default_coeff_probs, 13.5; coeff_update_probs, 13.4; kf_bmode_probs,
// 11.5, with the modes in libwebp's order DC, TM, VE, HE, RD, VR, LD, VL,
// HD, HU) and the lossless specification's distance map (4.2.2, as
// (yoffset << 4) | (8 - xoffset)). No system image library is loaded.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Error{what}; }

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {  // [type][band][context][11]
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[10 * 10 * 9] = {  // [above][left][9]
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ===================================================================== VP8L
// LSB-first bit reader; bits past the end read as zero and are counted, so
// a stream that needed them is refused as libwebp refuses it (eos).
class LBits {
 public:
  LBits(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  uint32_t peek(int nb) const {
    const size_t i = (size_t)(pos_ >> 3);
    uint64_t v = 0;
    if (i + 8 <= n_) {
      std::memcpy(&v, d_ + i, 8);
    } else {
      for (size_t k = 0; k < 8 && i + k < n_; ++k) v |= (uint64_t)d_[i + k] << (8 * k);
    }
    return (uint32_t)((v >> (pos_ & 7)) & ((nb >= 32) ? 0xffffffffull : ((1ull << nb) - 1)));
  }
  void skip(int nb) { pos_ += (uint64_t)nb; }
  uint32_t read(int nb) {
    const uint32_t v = peek(nb);
    skip(nb);
    return v;
  }
  bool overrun() const { return pos_ > 8 * (uint64_t)n_; }

 private:
  const uint8_t* d_;
  size_t n_;
  uint64_t pos_ = 0;
};

// A canonical prefix code, the first stream bit being the code's top bit.
struct LCode {
  int single = -1;        // one used symbol: no bits read
  uint32_t root[256];     // (length << 16) | symbol for codes of 8 bits or less
  int count[16], first[16], offset[16];
  std::vector<uint16_t> sorted;

  // libwebp's BuildHuffmanTable: false for no used symbol, a length over
  // 15 or a code that is over- or under-subscribed.
  bool build(const int* lens, int n) {
    std::memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) {
      if (lens[s] > 15) return false;
      ++count[lens[s]];
    }
    if (count[0] == n) return false;
    if (n - count[0] == 1) {
      for (int s = 0; s < n; ++s)
        if (lens[s]) single = s;
      return true;
    }
    int left = 1;
    for (int l = 1; l <= 15; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int code = 0, off = 0;
    for (int l = 1; l <= 15; ++l) {
      first[l] = code;
      offset[l] = off;
      code = (code + count[l]) << 1;
      off += count[l];
    }
    sorted.assign(off, 0);
    int fill[16];
    std::memcpy(fill, offset, sizeof(fill));
    std::memset(root, 0, sizeof(root));
    for (int s = 0; s < n; ++s) {
      const int l = lens[s];
      if (!l) continue;
      const int idx = fill[l]++;
      sorted[idx] = (uint16_t)s;
      if (l <= 8) {
        const int c = first[l] + (idx - offset[l]);
        int r = 0;
        for (int b = 0; b < l; ++b) r |= ((c >> b) & 1) << (l - 1 - b);
        for (int j = r; j < 256; j += 1 << l) root[j] = ((uint32_t)l << 16) | (uint32_t)s;
      }
    }
    return true;
  }
  int decode(LBits& br) const {
    if (single >= 0) return single;
    const uint32_t e = root[br.peek(8)];
    if (e) {
      br.skip((int)(e >> 16));
      return (int)(e & 0xffff);
    }
    int code = 0;
    for (int l = 1; l <= 15; ++l) {
      code = (code << 1) | (int)br.read(1);
      const int idx = code - first[l];
      if (idx >= 0 && idx < count[l]) return sorted[offset[l] + idx];
    }
    return sorted[0];  // unreachable for a complete code
  }
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((a >> s) & 255) + (int)((b >> s) & 255) -
                             (int)((c >> s) & 255)) << s;
  return out;
}
inline uint32_t clamp_add_sub_half(uint32_t l, uint32_t t, uint32_t tl) {
  const uint32_t ave = average2(l, t);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 255), b = (int)((tl >> s) & 255);
    out |= (uint32_t)clip255(a + (a - b) / 2) << s;
  }
  return out;
}
inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int d = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((t >> s) & 255), b = (int)((l >> s) & 255), c = (int)((tl >> s) & 255);
    d += std::abs(b - c) - std::abs(a - c);
  }
  return d <= 0 ? t : l;
}

uint32_t predict(int mode, uint32_t l, const uint32_t* top) {
  switch (mode) {
    case 1: return l;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(l, top[1]), top[0]);
    case 6: return average2(l, top[-1]);
    case 7: return average2(l, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(l, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], l, top[-1]);
    case 12: return clamp_add_sub_full(l, top[0], top[-1]);
    case 13: return clamp_add_sub_half(l, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and libwebp's sentinels 14 and 15
  }
}

struct LTransform {
  int type = 0, bits = 0, xsize = 0;
  std::vector<uint32_t> data;
};

class LDecoder {
 public:
  LDecoder(const uint8_t* d, size_t n) : br_(d, n) {}
  // the ARGB pixels of a (level 0) image stream of xsize x ysize
  std::vector<uint32_t> stream(int xsize, int ysize, bool level0);
  LBits br_;

 private:
  void read_code(int alphabet, LCode& code);
  void check() const {
    if (br_.overrun()) fail("WebP: lossless bitstream ends early");
  }
};

void LDecoder::read_code(int alphabet, LCode& code) {
  std::vector<int> lens(std::max(alphabet, 256), 0);
  if (br_.read(1)) {  // simple code: one or two symbols of length 1
    const int nsym = (int)br_.read(1) + 1;
    const int first_bits = br_.read(1) ? 8 : 1;
    lens[br_.read(first_bits)] = 1;
    if (nsym == 2) lens[br_.read(8)] = 1;
  } else {
    static const int kOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                   7,  8,  9, 10, 11, 12, 13, 14, 15};
    int cl_lens[19] = {0};
    const int ncodes = (int)br_.read(4) + 4;
    for (int i = 0; i < ncodes; ++i) cl_lens[kOrder[i]] = (int)br_.read(3);
    LCode cl;
    if (!cl.build(cl_lens, 19)) fail("WebP: invalid lossless code-length code");
    int max_symbol = alphabet;
    if (br_.read(1)) {
      const int nbits = 2 + 2 * (int)br_.read(3);
      max_symbol = 2 + (int)br_.read(nbits);
      if (max_symbol > alphabet) fail("WebP: lossless code lengths run past the alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int len = cl.decode(br_);
      if (len < 16) {
        lens[symbol++] = len;
        if (len) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = (int)br_.read(kExtra[len - 16]) + kOffset[len - 16];
        if (symbol + repeat > alphabet) fail("WebP: lossless code lengths run past the alphabet");
        const int v = len == 16 ? prev : 0;
        while (repeat-- > 0) lens[symbol++] = v;
      }
    }
  }
  check();
  if (!code.build(lens.data(), alphabet)) fail("WebP: invalid lossless prefix code");
}

std::vector<uint32_t> LDecoder::stream(int xsize, int ysize, bool level0) {
  int tx = xsize;
  std::vector<LTransform> transforms;
  if (level0) {
    int seen = 0;
    while (br_.read(1)) {
      LTransform t;
      t.type = (int)br_.read(2);
      if (seen & (1 << t.type)) fail("WebP: a lossless transform is used twice");
      seen |= 1 << t.type;
      t.xsize = tx;
      if (t.type == 0 || t.type == 1) {
        t.bits = (int)br_.read(3) + 2;
        t.data = stream(subsample(tx, t.bits), subsample(ysize, t.bits), false);
      } else if (t.type == 3) {
        const int ncolors = (int)br_.read(8) + 1;
        t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
        const std::vector<uint32_t> pal = stream(ncolors, 1, false);
        t.data.assign((size_t)1 << (8 >> t.bits), 0);
        t.data[0] = pal[0];
        for (int i = 1; i < ncolors; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
        tx = subsample(tx, t.bits);
      }
      transforms.push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br_.read(1)) {
    cache_bits = (int)br_.read(4);
    if (cache_bits < 1 || cache_bits > 11) fail("WebP: lossless colour cache of " +
                                                std::to_string(cache_bits) + " bits");
  }
  int hbits = 0, hxs = 1, ngroups = 1;
  std::vector<uint32_t> himage;
  if (level0 && br_.read(1)) {
    hbits = (int)br_.read(3) + 2;
    hxs = subsample(tx, hbits);
    himage = stream(hxs, subsample(ysize, hbits), false);
    for (uint32_t& p : himage) {
      p = (p >> 8) & 0xffff;
      ngroups = std::max(ngroups, (int)p + 1);
    }
  }
  check();
  static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
  std::vector<LCode> codes((size_t)ngroups * 5);
  for (int g = 0; g < ngroups; ++g)
    for (int j = 0; j < 5; ++j)
      read_code(kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0), codes[g * 5 + j]);

  const size_t total = (size_t)tx * ysize;
  std::vector<uint32_t> px(total);
  std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0);
  size_t pos = 0, cached = 0;
  auto insert = [&](size_t upto) {
    for (; cached < upto; ++cached)
      cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
  };
  auto prefix_value = [&](int sym) -> int {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    return ((2 + (sym & 1)) << extra) + (int)br_.read(extra) + 1;
  };
  while (pos < total) {
    const int col = (int)(pos % tx), row = (int)(pos / tx);
    const LCode* g = &codes[hbits ? (size_t)himage[(row >> hbits) * hxs + (col >> hbits)] * 5 : 0];
    const int code = g[0].decode(br_);
    if (code < 256) {
      const uint32_t red = g[1].decode(br_), blue = g[2].decode(br_), alpha = g[3].decode(br_);
      px[pos++] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
    } else if (code < 256 + 24) {
      const size_t length = prefix_value(code - 256);
      const int dcode = prefix_value(g[4].decode(br_));
      size_t dist;
      if (dcode > 120) {
        dist = dcode - 120;
      } else {
        const int v = kCodeToPlane[dcode - 1];
        const long d = (long)(v >> 4) * tx + (8 - (v & 15));
        dist = d >= 1 ? (size_t)d : 1;
      }
      if (pos < dist || total - pos < length) fail("WebP: lossless back-reference out of range");
      for (size_t k = 0; k < length; ++k) px[pos + k] = px[pos + k - dist];
      pos += length;
    } else {
      insert(pos);
      px[pos] = cache[code - 256 - 24];
      ++pos;
    }
    if (cache_bits) insert(pos);
    check();
  }

  // inverse transforms, last read first
  for (int ti = (int)transforms.size() - 1; ti >= 0; --ti) {
    const LTransform& t = transforms[ti];
    const int w = t.xsize;
    if (t.type == 0) {  // predictor
      std::vector<uint32_t> out(px.size());
      const int tw = subsample(w, t.bits);
      for (int y = 0; y < ysize; ++y) {
        const uint32_t* in = &px[(size_t)y * w];
        uint32_t* o = &out[(size_t)y * w];
        const uint32_t* top = o - w;
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) pred = x == 0 ? 0xff000000u : o[x - 1];
          else if (x == 0) pred = top[0];
          else pred = predict((t.data[(size_t)(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 15,
                              o[x - 1], top + x);
          o[x] = add_pixels(in[x], pred);
        }
      }
      px.swap(out);
    } else if (t.type == 1) {  // cross-colour
      const int tw = subsample(w, t.bits);
      for (int y = 0; y < ysize; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(size_t)(y >> t.bits) * tw + (x >> t.bits)];
          const int g2r = (int8_t)(m & 255), g2b = (int8_t)((m >> 8) & 255),
                    r2b = (int8_t)((m >> 16) & 255);
          uint32_t& p = px[(size_t)y * w + x];
          const int green = (int8_t)((p >> 8) & 255);
          int red = (int)((p >> 16) & 255), blue = (int)(p & 255);
          red = (red + ((g2r * green) >> 5)) & 255;
          blue = (blue + ((g2b * green) >> 5) + ((r2b * (int8_t)red) >> 5)) & 255;
          p = (p & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
        }
    } else if (t.type == 2) {  // subtract green
      for (uint32_t& p : px) {
        const uint32_t g = (p >> 8) & 255;
        const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
    } else {  // colour indexing
      const int packed_w = subsample(w, t.bits);
      std::vector<uint32_t> out((size_t)w * ysize);
      const int bpp = 8 >> t.bits, per = 1 << t.bits;
      const uint32_t mask = (1u << bpp) - 1;
      for (int y = 0; y < ysize; ++y) {
        const uint32_t* in = &px[(size_t)y * packed_w];
        uint32_t* o = &out[(size_t)y * w];
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & (per - 1)) == 0) packed = (*in++ >> 8) & 255;
          o[x] = t.data[packed & mask];
          packed >>= bpp;
        }
      }
      px.swap(out);
    }
  }
  return px;
}

// The 5-byte VP8L header: width, height.
void vp8l_header(LBits& br, int* w, int* h) {
  if (br.read(8) != 0x2f) fail("WebP: lossless bitstream without its signature byte");
  *w = (int)br.read(14) + 1;
  *h = (int)br.read(14) + 1;
  br.read(1);  // alpha_is_used: a hint only
  if (br.read(3) != 0) fail("WebP: lossless bitstream version is not 0");
}

// ====================================================================== VP8
class BoolDec {
 public:
  void init(const uint8_t* d, size_t n) {
    p_ = d;
    end_ = d + n;
    value_ = 0;
    range_ = 255 - 1;
    bits_ = -8;
    eof_ = false;
    load();
  }
  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    const uint32_t value = (uint32_t)(value_ >> pos);
    int b;
    if (value > split) {
      range -= split;
      value_ -= (uint64_t)(split + 1) << pos;
      b = 1;
    } else {
      range = split + 1;
      b = 0;
    }
    int log2 = 31 - __builtin_clz(range);
    const int shift = 7 ^ log2;
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }
  int value(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= bit(0x80) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    const int v = value(nbits);
    return value(1) ? -v : v;
  }
  bool eof() const { return eof_; }

 private:
  // libwebp's VP8LoadFinalBytes, a byte at a time: one zero byte past the
  // end sets eof
  void load() {
    if (p_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *p_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* p_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 254;
  int bits_ = -8;
  bool eof_ = false;
};

const uint8_t kZigzag4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// libwebp's kYModesIntra4 tree over its mode order
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};
enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3 };

struct MBInfo {
  int segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t imodes[16];
  bool nonzero = false;       // any coefficient left non-zero
  int16_t coeffs[384];
};

struct FilterInfo {
  int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

class VP8Decoder {
 public:
  VP8Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  void header();
  void decode(uint8_t* rgba);  // width x height x 4, alpha 255
  int width = 0, height = 0;

 private:
  const uint8_t* d_;
  size_t n_;
  int mb_w_ = 0, mb_h_ = 0;
  size_t first_len_ = 0;
  BoolDec br_;
  std::vector<BoolDec> parts_;
  // segment and filter headers
  int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  int seg_proba_[3] = {255, 255, 255};
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  int filter_type_ = 0;
  int dq_[4][3][2];  // segment, (y1, y2, uv), (dc, ac)
  uint8_t proba_[4][8][3][11];
  int use_skip_ = 0, skip_p_ = 0;
  std::vector<MBInfo> mbs_;
  FilterInfo fstrength_[4][2];

  void parse_modes(int mb_y, std::vector<uint8_t>& intra_t);
  void parse_residuals(int mb_x, MBInfo& mb, BoolDec& br, std::vector<uint8_t>& nz_top,
                       uint8_t* nz_left);
  int get_coeffs(BoolDec& br, int type, int ctx, const int* dq, int n, int16_t* out);
};

void VP8Decoder::header() {
  if (n_ < 10) fail("WebP: VP8 frame too short");
  const uint32_t bits = d_[0] | (d_[1] << 8) | (d_[2] << 16);
  const int key = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  first_len_ = bits >> 5;
  if (!key) fail("WebP: VP8 frame is not a key frame");
  if (profile > 3) fail("WebP: VP8 profile " + std::to_string(profile));
  if (!show) fail("WebP: VP8 frame not displayable");
  if (d_[3] != 0x9d || d_[4] != 0x01 || d_[5] != 0x2a)
    fail("WebP: VP8 frame without its start code");
  width = (d_[6] | (d_[7] << 8)) & 0x3fff;
  height = (d_[8] | (d_[9] << 8)) & 0x3fff;
  if (!width || !height) fail("WebP: VP8 frame has no pixels");
  if (first_len_ >= n_) fail("WebP: VP8 first partition runs past the frame");
  mb_w_ = (width + 15) >> 4;
  mb_h_ = (height + 15) >> 4;
}

void VP8Decoder::parse_modes(int mb_y, std::vector<uint8_t>& intra_t) {
  uint8_t left[4] = {B_DC, B_DC, B_DC, B_DC};
  for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
    MBInfo& mb = mbs_[(size_t)mb_y * mb_w_ + mb_x];
    uint8_t* top = &intra_t[4 * mb_x];
    if (update_map_) {
      mb.segment = !br_.bit(seg_proba_[0]) ? br_.bit(seg_proba_[1]) : br_.bit(seg_proba_[2]) + 2;
    } else {
      mb.segment = 0;
    }
    mb.skip = use_skip_ ? br_.bit(skip_p_) : 0;
    mb.is_i4x4 = !br_.bit(145);
    if (!mb.is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? TM_PRED : H_PRED)
                                     : (br_.bit(163) ? V_PRED : DC_PRED);
      mb.imodes[0] = (uint8_t)ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = &kBModesProba[(top[x] * 10 + ymode) * 9];
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(mb.imodes + 4 * y, top, 4);
        left[y] = (uint8_t)ymode;
      }
    }
    mb.uvmode = !br_.bit(142) ? DC_PRED : !br_.bit(114) ? V_PRED : br_.bit(183) ? TM_PRED : H_PRED;
  }
  if (br_.eof()) fail("WebP: VP8 first partition ends early");
}

int VP8Decoder::get_coeffs(BoolDec& br, int type, int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = proba_[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = proba_[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const int band_next = kBands[n + 1];
    if (!br.bit(p[2])) {
      v = 1;
      p = proba_[type][band_next][1];
    } else {
      if (!br.bit(p[3])) {
        if (!br.bit(p[4])) v = 2;
        else v = 3 + br.bit(p[5]);
      } else if (!br.bit(p[6])) {
        if (!br.bit(p[7])) {
          v = 5 + br.bit(159);
        } else {
          v = 7 + 2 * br.bit(165);
          v += br.bit(145);
        }
      } else {
        const int bit1 = br.bit(p[8]);
        const int bit0 = br.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = proba_[type][band_next][2];
    }
    const int s = br.bit(0x80) ? -v : v;
    out[kZigzag4[n]] = (int16_t)(s * dq[n > 0]);
  }
  return 16;
}

// libwebp's TransformWHT_C
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

void VP8Decoder::parse_residuals(int mb_x, MBInfo& mb, BoolDec& br, std::vector<uint8_t>& nz_top,
                                 uint8_t* nz_left) {
  // nz_top per MB: [0..3] Y columns, [4..5] U, [6..7] V, [8] Y2; nz_left the same by rows
  uint8_t* tnz = &nz_top[9 * mb_x];
  int16_t* dst = mb.coeffs;
  std::memset(dst, 0, sizeof(mb.coeffs));
  const int (*dq)[2] = dq_[mb.segment];
  int first, ac_type;
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = tnz[8] + nz_left[8];
    const int nz = get_coeffs(br, 1, ctx, dq[1], 0, dc);
    tnz[8] = nz_left[8] = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      const int ctx = tnz[x] + nz_left[y];
      const int nz = get_coeffs(br, ac_type, ctx, dq[0], first, dst + 16 * (4 * y + x));
      tnz[x] = nz_left[y] = nz > first;
    }
  for (int ch = 0; ch < 2; ++ch)
    for (int y = 0; y < 2; ++y)
      for (int x = 0; x < 2; ++x) {
        const int ctx = tnz[4 + 2 * ch + x] + nz_left[4 + 2 * ch + y];
        const int nz = get_coeffs(br, 2, ctx, dq[2], 0, dst + 16 * (16 + 4 * ch + 2 * y + x));
        tnz[4 + 2 * ch + x] = nz_left[4 + 2 * ch + y] = nz > 0;
      }
  bool any = false;
  for (int i = 0; i < 384 && !any; ++i) any = dst[i] != 0;
  mb.nonzero = any;
}

// libwebp's TransformOne_C: adds the inverse DCT of `in` to the 4 x 4
// block at dst (row stride bps)
void transform_add(const int16_t* in, uint8_t* dst, int bps) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += bps;
  }
}

#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * bps]

void pred4(int mode, uint8_t* dst, int bps) {
  const uint8_t* top = dst - bps;
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * bps];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * bps, dc, 4);
      break;
    }
    case B_TM: {
      const int tl = top[-1];
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = clip8(top[x] + dst[-1 + y * bps] - tl);
      break;
    }
    case B_VE: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * bps, vals, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - bps], B = dst[-1], C = dst[-1 + bps], D = dst[-1 + 2 * bps],
                E = dst[-1 + 3 * bps];
      std::memset(dst, AVG3(A, B, C), 4);
      std::memset(dst + bps, AVG3(B, C, D), 4);
      std::memset(dst + 2 * bps, AVG3(C, D, E), 4);
      std::memset(dst + 3 * bps, AVG3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], L = dst[-1 + 3 * bps],
                X = dst[-1 - bps], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
                G = top[6], H = top[7];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], X = dst[-1 - bps],
                A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
                G = top[6], H = top[7];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HD: {
      const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], L = dst[-1 + 3 * bps],
                X = dst[-1 - bps], A = top[0], B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
    default: {  // B_HU
      const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], L = dst[-1 + 3 * bps];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    }
  }
}

// 16 x 16 luma or 8 x 8 chroma prediction, with libwebp's CheckMode: DC
// without the top or the left row averages what there is, 128 without both
void pred_block(int mode, int size, int mb_x, int mb_y, uint8_t* dst, int bps) {
  const uint8_t* top = dst - bps;
  const int shift = size == 16 ? 4 : 3;
  if (mode == DC_PRED) {
    int v;
    if (mb_x == 0 && mb_y == 0) {
      v = 0x80;
    } else if (mb_y == 0) {  // no top
      int s = 0;
      for (int j = 0; j < size; ++j) s += dst[-1 + j * bps];
      v = (s + (size >> 1)) >> shift;
    } else if (mb_x == 0) {  // no left
      int s = 0;
      for (int j = 0; j < size; ++j) s += top[j];
      v = (s + (size >> 1)) >> shift;
    } else {
      int s = 0;
      for (int j = 0; j < size; ++j) s += top[j] + dst[-1 + j * bps];
      v = (s + size) >> (shift + 1);
    }
    for (int j = 0; j < size; ++j) std::memset(dst + j * bps, v, size);
  } else if (mode == TM_PRED) {
    const int tl = top[-1];
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x) dst[x + y * bps] = clip8(top[x] + dst[-1 + y * bps] - tl);
  } else if (mode == V_PRED) {
    for (int j = 0; j < size; ++j) std::memcpy(dst + j * bps, top, size);
  } else {  // H_PRED
    for (int j = 0; j < size; ++j) std::memset(dst + j * bps, dst[-1 + j * bps], size);
  }
}

// ---------------------------------------------------------- loop filters
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int t) {
  return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// `hstride` crosses the edge, `vstride` walks along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}
void complex_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                  int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) filter2(p, hstride);
    else if (mb_edge) filter6(p, hstride);
    else filter4(p, hstride);
  }
}

void VP8Decoder::decode(uint8_t* rgba) {
  const uint8_t* buf = d_ + 10;
  size_t left = n_ - 10;
  if (first_len_ > left) fail("WebP: VP8 first partition runs past the frame");
  br_.init(buf, first_len_);
  buf += first_len_;
  left -= first_len_;
  br_.value(1);  // colour space
  br_.value(1);  // clamping type
  use_segment_ = br_.value(1);
  if (use_segment_) {
    update_map_ = br_.value(1);
    if (br_.value(1)) {
      absolute_delta_ = br_.value(1);
      for (int s = 0; s < 4; ++s) quantizer_[s] = br_.value(1) ? br_.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.value(1) ? br_.signed_value(6) : 0;
    }
    if (update_map_)
      for (int s = 0; s < 3; ++s) seg_proba_[s] = br_.value(1) ? br_.value(8) : 255;
  }
  if (br_.eof()) fail("WebP: VP8 segment header ends early");
  simple_ = br_.value(1);
  level_ = br_.value(6);
  sharpness_ = br_.value(3);
  use_lf_delta_ = br_.value(1);
  if (use_lf_delta_ && br_.value(1)) {
    for (int i = 0; i < 4; ++i)
      if (br_.value(1)) ref_lf_delta_[i] = br_.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br_.value(1)) mode_lf_delta_[i] = br_.signed_value(6);
  }
  filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  if (br_.eof()) fail("WebP: VP8 filter header ends early");
  // token partitions
  const int nparts = 1 << br_.value(2);
  const size_t last = nparts - 1;
  if (left < 3 * last) fail("WebP: VP8 partition sizes run past the frame");
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  size_t size_left = left - 3 * last;
  parts_.resize(nparts);
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts_[p].init(start, psize);
    start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts_[last].init(start, size_left);
  if (start >= buf + left) fail("WebP: VP8 token partitions run past the frame");
  // quantisers
  {
    const int base_q0 = br_.value(7);
    int dq[5];
    for (int i = 0; i < 5; ++i) dq[i] = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2], dquv_dc = dq[3], dquv_ac = dq[4];
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
      } else if (i > 0) {
        std::memcpy(dq_[i], dq_[0], sizeof(dq_[0]));
        continue;
      } else {
        q = base_q0;
      }
      dq_[i][0][0] = kDcTable[clip(q + dqy1_dc, 127)];
      dq_[i][0][1] = kAcTable[clip(q, 127)];
      dq_[i][1][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      dq_[i][1][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (dq_[i][1][1] < 8) dq_[i][1][1] = 8;
      dq_[i][2][0] = kDcTable[clip(q + dquv_dc, 117)];
      dq_[i][2][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }
  br_.value(1);  // refresh_entropy_probs: ignored, as libwebp does
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          proba_[t][b][c][p] =
              (uint8_t)(br_.bit(kCoeffsUpdateProba[k]) ? br_.value(8) : kCoeffsProba0[k]);
        }
  use_skip_ = br_.value(1);
  if (use_skip_) skip_p_ = br_.value(8);

  // filter strengths (libwebp PrecomputeFilterStrengths)
  if (filter_type_ > 0) {
    for (int s = 0; s < 4; ++s) {
      int base = use_segment_ ? filter_strength_[s] + (absolute_delta_ ? 0 : level_) : level_;
      for (int i4 = 0; i4 <= 1; ++i4) {
        FilterInfo& f = fstrength_[s][i4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int il = level;
          if (sharpness_ > 0) {
            il >>= sharpness_ > 4 ? 2 : 1;
            if (il > 9 - sharpness_) il = 9 - sharpness_;
          }
          if (il < 1) il = 1;
          f.ilevel = il;
          f.limit = 2 * level + il;
          f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
  }

  // modes, tokens and reconstruction, row by row
  const int yw = mb_w_ * 16, yh = mb_h_ * 16, cw = mb_w_ * 8, chh = mb_h_ * 8;
  std::vector<uint8_t> Y((size_t)yw * yh), U((size_t)cw * chh), V((size_t)cw * chh);
  mbs_.assign((size_t)mb_w_ * mb_h_, MBInfo());
  std::vector<uint8_t> intra_t(4 * mb_w_, B_DC), nz_top(9 * mb_w_, 0);
  std::vector<FilterInfo> finfo((size_t)mb_w_ * mb_h_);
  const int BPS = 32;
  uint8_t work[BPS * 17], uwork[BPS * 9], vwork[BPS * 9];
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    parse_modes(mb_y, intra_t);
    BoolDec& tbr = parts_[mb_y & (nparts - 1)];
    uint8_t nz_left[9] = {0};
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      MBInfo& mb = mbs_[(size_t)mb_y * mb_w_ + mb_x];
      int skip = mb.skip;
      if (!skip) {
        parse_residuals(mb_x, mb, tbr, nz_top, nz_left);
        skip = !mb.nonzero;
      } else {
        std::memset(&nz_top[9 * mb_x], 0, 8);
        std::memset(nz_left, 0, 8);
        if (!mb.is_i4x4) nz_top[9 * mb_x + 8] = nz_left[8] = 0;
        std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
      }
      if (filter_type_ > 0) {
        FilterInfo& f = finfo[(size_t)mb_y * mb_w_ + mb_x];
        f = fstrength_[mb.segment][mb.is_i4x4];
        f.inner |= !skip;
      }
      if (tbr.eof()) fail("WebP: VP8 token partition ends early");
    }
    // reconstruct the row: work buffers hold the MB with its top row and
    // left column at libwebp's edge values
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      MBInfo& mb = mbs_[(size_t)mb_y * mb_w_ + mb_x];
      uint8_t* y_dst = work + BPS + 1;
      uint8_t* u_dst = uwork + BPS + 1;
      uint8_t* v_dst = vwork + BPS + 1;
      auto Yat = [&](int x, int y) { return Y[(size_t)y * yw + x]; };
      // left column and top-left
      for (int j = 0; j < 16; ++j)
        y_dst[j * BPS - 1] = mb_x ? Yat(16 * mb_x - 1, 16 * mb_y + j) : 129;
      for (int j = 0; j < 8; ++j) {
        u_dst[j * BPS - 1] = mb_x ? U[(size_t)(8 * mb_y + j) * cw + 8 * mb_x - 1] : 129;
        v_dst[j * BPS - 1] = mb_x ? V[(size_t)(8 * mb_y + j) * cw + 8 * mb_x - 1] : 129;
      }
      if (mb_y == 0) {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
      } else {
        y_dst[-1 - BPS] = mb_x ? Yat(16 * mb_x - 1, 16 * mb_y - 1) : 129;
        u_dst[-1 - BPS] = mb_x ? U[(size_t)(8 * mb_y - 1) * cw + 8 * mb_x - 1] : 129;
        v_dst[-1 - BPS] = mb_x ? V[(size_t)(8 * mb_y - 1) * cw + 8 * mb_x - 1] : 129;
        std::memcpy(y_dst - BPS, &Y[(size_t)(16 * mb_y - 1) * yw + 16 * mb_x], 16);
        std::memcpy(u_dst - BPS, &U[(size_t)(8 * mb_y - 1) * cw + 8 * mb_x], 8);
        std::memcpy(v_dst - BPS, &V[(size_t)(8 * mb_y - 1) * cw + 8 * mb_x], 8);
      }
      const int16_t* coeffs = mb.coeffs;
      if (mb.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1) {
            std::memset(top_right, Yat(16 * mb_x + 15, 16 * mb_y - 1), 4);
          } else {
            std::memcpy(top_right, &Y[(size_t)(16 * mb_y - 1) * yw + 16 * mb_x + 16], 4);
          }
        }
        for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          pred4(mb.imodes[n], dst, BPS);
          transform_add(coeffs + n * 16, dst, BPS);
        }
      } else {
        pred_block(mb.imodes[0], 16, mb_x, mb_y, y_dst, BPS);
        for (int n = 0; n < 16; ++n)
          transform_add(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS, BPS);
      }
      pred_block(mb.uvmode, 8, mb_x, mb_y, u_dst, BPS);
      pred_block(mb.uvmode, 8, mb_x, mb_y, v_dst, BPS);
      for (int n = 0; n < 4; ++n) {
        transform_add(coeffs + (16 + n) * 16, u_dst + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
        transform_add(coeffs + (20 + n) * 16, v_dst + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&Y[(size_t)(16 * mb_y + j) * yw + 16 * mb_x], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&U[(size_t)(8 * mb_y + j) * cw + 8 * mb_x], u_dst + j * BPS, 8);
        std::memcpy(&V[(size_t)(8 * mb_y + j) * cw + 8 * mb_x], v_dst + j * BPS, 8);
      }
    }
  }

  // loop filter, macroblocks in raster order (libwebp DoFilter)
  if (filter_type_ > 0) {
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FilterInfo& f = finfo[(size_t)mb_y * mb_w_ + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* yd = &Y[(size_t)16 * mb_y * yw + 16 * mb_x];
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_edge(yd, 1, yw, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_edge(yd + 4 * k, 1, yw, limit);
          if (mb_y > 0) simple_edge(yd, yw, 1, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_edge(yd + 4 * k * yw, yw, 1, limit);
        } else {
          uint8_t* ud = &U[(size_t)8 * mb_y * cw + 8 * mb_x];
          uint8_t* vd = &V[(size_t)8 * mb_y * cw + 8 * mb_x];
          const int il = f.ilevel, hv = f.hev;
          if (mb_x > 0) {
            complex_edge(yd, 1, yw, 16, limit + 4, il, hv, true);
            complex_edge(ud, 1, cw, 8, limit + 4, il, hv, true);
            complex_edge(vd, 1, cw, 8, limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k) complex_edge(yd + 4 * k, 1, yw, 16, limit, il, hv, false);
            complex_edge(ud + 4, 1, cw, 8, limit, il, hv, false);
            complex_edge(vd + 4, 1, cw, 8, limit, il, hv, false);
          }
          if (mb_y > 0) {
            complex_edge(yd, yw, 1, 16, limit + 4, il, hv, true);
            complex_edge(ud, cw, 1, 8, limit + 4, il, hv, true);
            complex_edge(vd, cw, 1, 8, limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k)
              complex_edge(yd + 4 * k * yw, yw, 1, 16, limit, il, hv, false);
            complex_edge(ud + 4 * cw, cw, 1, 8, limit, il, hv, false);
            complex_edge(vd + 4 * cw, cw, 1, 8, limit, il, hv, false);
          }
        }
      }
  }

  // libwebp's fancy upsampler (UpsampleRgbaLinePair) and VP8YuvToRgb
  auto mult_hi = [](int v, int c) { return (v * c) >> 8; };
  auto clip_yuv = [](int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; };
  auto put = [&](uint8_t* o, int y, int u, int v) {
    o[0] = (uint8_t)clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    o[1] = (uint8_t)clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    o[2] = (uint8_t)clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
    o[3] = 255;
  };
  const int W = width, H = height, ch = (H + 1) / 2;
  for (int y = 0; y < H; ++y) {
    const int k = y >> 1;
    const int far = y & 1 ? std::min(k + 1, ch - 1) : std::max(k - 1, 0);
    const uint8_t *nu = &U[(size_t)k * cw], *nv = &V[(size_t)k * cw];
    const uint8_t *fu = &U[(size_t)far * cw], *fv = &V[(size_t)far * cw];
    const uint8_t* yrow = &Y[(size_t)y * yw];
    uint8_t* o = rgba + (size_t)y * W * 4;
    put(o, yrow[0], (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2);
    const int last_pair = (W - 1) >> 1;
    for (int x = 1; x <= last_pair; ++x) {
      int out_u[2], out_v[2];
      for (int c = 0; c < 2; ++c) {
        const uint8_t* N = c ? nv : nu;
        const uint8_t* F = c ? fv : fu;
        const int tl = N[x - 1], t = N[x], l = F[x - 1], uv = F[x];
        const int avg = tl + t + l + uv + 8;
        const int d12 = (avg + 2 * (t + l)) >> 3, d03 = (avg + 2 * (tl + uv)) >> 3;
        (c ? out_v : out_u)[0] = (d12 + tl) >> 1;
        (c ? out_v : out_u)[1] = (d03 + t) >> 1;
      }
      put(o + 4 * (2 * x - 1), yrow[2 * x - 1], out_u[0], out_v[0]);
      put(o + 4 * (2 * x), yrow[2 * x], out_u[1], out_v[1]);
    }
    if (!(W & 1)) {
      const int lx = (W - 1) >> 1;
      put(o + 4 * (W - 1), yrow[W - 1], (3 * nu[lx] + fu[lx] + 2) >> 2,
          (3 * nv[lx] + fv[lx] + 2) >> 2);
    }
  }
}

// ================================================================== ALPH
// The alpha plane of a lossy frame (WebP container specification, ALPH).
void decode_alpha(const uint8_t* d, size_t n, int w, int h, uint8_t* out) {
  if (n < 1) fail("WebP: empty ALPH chunk");
  const int method = d[0] & 3, filter = (d[0] >> 2) & 3, pre = (d[0] >> 4) & 3,
            reserved = d[0] >> 6;
  if (method > 1 || pre > 1 || reserved) fail("WebP: ALPH header is not valid");
  const size_t npx = (size_t)w * h;
  std::vector<uint8_t> raw(npx);
  if (method == 0) {
    if (n - 1 < npx) fail("WebP: uncompressed ALPH chunk too short");
    std::memcpy(raw.data(), d + 1, npx);
  } else {
    LDecoder dec(d + 1, n - 1);
    const std::vector<uint32_t> px = dec.stream(w, h, true);
    for (size_t i = 0; i < npx; ++i) raw[i] = (uint8_t)((px[i] >> 8) & 255);
  }
  // unfilter (libwebp's Horizontal/Vertical/GradientUnfilter_C)
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = &raw[(size_t)y * w];
    uint8_t* o = out + (size_t)y * w;
    const uint8_t* prev = y ? out + (size_t)(y - 1) * w : nullptr;
    if (filter == 0) {
      std::memcpy(o, in, w);
    } else if (filter == 1 || prev == nullptr) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int i = 0; i < w; ++i) {
        o[i] = (uint8_t)(pred + in[i]);
        pred = o[i];
      }
    } else if (filter == 2) {
      for (int i = 0; i < w; ++i) o[i] = (uint8_t)(prev[i] + in[i]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < w; ++i) {
        top = prev[i];
        left = (uint8_t)(in[i] + clip255(left + top - top_left));
        top_left = top;
        o[i] = left;
      }
    }
  }
}

void copy_error(const std::string& what, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", what.c_str());
}

}  // namespace

extern "C" {

// The size of a frame's bitstream: a "VP8L" chunk's payload when lossless
// is 1, else a "VP8 " chunk's. Writes width and height to dims. Returns 0,
// or 1 with the reason in err.
int cv_webp_frame_info(const uint8_t* data, size_t n, int lossless, int* dims, char* err,
                       int errlen) {
  try {
    if (lossless) {
      LBits br(data, n);
      vp8l_header(br, &dims[0], &dims[1]);
      if (br.overrun()) fail("WebP: lossless header truncated");
    } else {
      VP8Decoder d(data, n);
      d.header();
      dims[0] = d.width;
      dims[1] = d.height;
    }
    return 0;
  } catch (const Error& e) {
    copy_error(e.what, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(std::string("WebP: ") + e.what(), err, errlen);
    return 1;
  }
}

// Decodes a frame into out: height x width x 4 RGBA as cv_webp_frame_info
// gives them; `alpha` (n_alpha bytes, may be null) is a lossy frame's ALPH
// payload. Returns 0, or 1 with the reason in err.
int cv_webp_frame_decode(const uint8_t* data, size_t n, int lossless, const uint8_t* alpha,
                         size_t n_alpha, uint8_t* out, char* err, int errlen) {
  try {
    int w, h;
    if (lossless) {
      LBits hdr(data, n);
      vp8l_header(hdr, &w, &h);
      LDecoder dec(data, n);
      dec.br_.skip(40);
      const std::vector<uint32_t> px = dec.stream(w, h, true);
      for (size_t i = 0; i < (size_t)w * h; ++i) {
        const uint32_t p = px[i];
        out[4 * i] = (uint8_t)(p >> 16);
        out[4 * i + 1] = (uint8_t)(p >> 8);
        out[4 * i + 2] = (uint8_t)p;
        out[4 * i + 3] = (uint8_t)(p >> 24);
      }
    } else {
      VP8Decoder d(data, n);
      d.header();
      w = d.width;
      h = d.height;
      d.decode(out);
      if (alpha) {
        std::vector<uint8_t> a((size_t)w * h);
        decode_alpha(alpha, n_alpha, w, h, a.data());
        for (size_t i = 0; i < a.size(); ++i) out[4 * i + 3] = a[i];
      }
    }
    return 0;
  } catch (const Error& e) {
    copy_error(e.what, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(std::string("WebP: ") + e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
