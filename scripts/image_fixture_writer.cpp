// Writer of the image fixtures PIL and cv2 cannot write: arithmetic-coded
// and YCCK JPEGs through libjpeg(-turbo)'s own encoder, and lossy WebPs with
// encoder settings Pillow does not expose (the simple loop filter, its
// sharpness, token partitions, segments). Used only by
// scripts/make_image_fixtures.py, which builds it with
//
//     g++ -O2 scripts/image_fixture_writer.cpp -o writer -ljpeg -lwebp
//
// against the system's jpeglib.h (libjpeg-turbo 2.1.5, built with
// arithmetic coding) and webp/encode.h. The port never loads either
// library. Pixels come on stdin (height x width x components uint8), the
// file goes to stdout.
//
//   writer jpeg W H IN_COMPONENTS OUT_SPACE QUALITY ARITH PROGRESSIVE RESTART H0 V0 [H1 V1 ...]
//     IN_COMPONENTS 3 (RGB) or 4 (CMYK); OUT_SPACE ycc, rgb, cmyk or ycck
//   writer webp W H CHANNELS QUALITY METHOD FILTER_TYPE SHARPNESS STRENGTH SEGMENTS
//               PARTITIONS SNS ALPHA_FILTERING
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <jpeglib.h>
#include <webp/encode.h>

static std::vector<unsigned char> read_stdin(size_t n) {
  std::vector<unsigned char> buf(n);
  if (std::fread(buf.data(), 1, n, stdin) != n) {
    std::fprintf(stderr, "expected %zu bytes on stdin\n", n);
    std::exit(2);
  }
  return buf;
}

static int jpeg(int argc, char** argv) {
  const int w = std::atoi(argv[2]), h = std::atoi(argv[3]), nin = std::atoi(argv[4]);
  const std::string out_space = argv[5];
  const int quality = std::atoi(argv[6]), arith = std::atoi(argv[7]),
            progressive = std::atoi(argv[8]), restart = std::atoi(argv[9]);
  std::vector<unsigned char> px = read_stdin((size_t)w * h * nin);
  jpeg_compress_struct c;
  jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  unsigned char* mem = nullptr;
  unsigned long mem_size = 0;
  jpeg_mem_dest(&c, &mem, &mem_size);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nin;
  c.in_color_space = nin == 4 ? JCS_CMYK : JCS_RGB;
  jpeg_set_defaults(&c);
  if (out_space == "rgb") jpeg_set_colorspace(&c, JCS_RGB);
  else if (out_space == "cmyk") jpeg_set_colorspace(&c, JCS_CMYK);
  else if (out_space == "ycck") jpeg_set_colorspace(&c, JCS_YCCK);
  jpeg_set_quality(&c, quality, TRUE);
  for (int i = 0; i < c.num_components && 10 + 2 * i + 1 < argc; ++i) {
    c.comp_info[i].h_samp_factor = std::atoi(argv[10 + 2 * i]);
    c.comp_info[i].v_samp_factor = std::atoi(argv[11 + 2 * i]);
  }
  c.arith_code = arith ? TRUE : FALSE;
  c.restart_interval = restart;
  if (progressive) jpeg_simple_progression(&c);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = &px[(size_t)c.next_scanline * w * nin];
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  std::fwrite(mem, 1, mem_size, stdout);
  jpeg_destroy_compress(&c);
  std::free(mem);
  return 0;
}

static int webp(char** argv) {
  const int w = std::atoi(argv[2]), h = std::atoi(argv[3]), ch = std::atoi(argv[4]);
  std::vector<unsigned char> px = read_stdin((size_t)w * h * ch);
  WebPConfig config;
  if (!WebPConfigInit(&config)) return 3;
  config.quality = (float)std::atof(argv[5]);
  config.method = std::atoi(argv[6]);
  config.filter_type = std::atoi(argv[7]);
  config.filter_sharpness = std::atoi(argv[8]);
  config.filter_strength = std::atoi(argv[9]);
  config.segments = std::atoi(argv[10]);
  config.partitions = std::atoi(argv[11]);
  config.sns_strength = std::atoi(argv[12]);
  config.alpha_filtering = std::atoi(argv[13]);
  if (!WebPValidateConfig(&config)) return 4;
  WebPPicture pic;
  if (!WebPPictureInit(&pic)) return 5;
  pic.width = w;
  pic.height = h;
  const int ok = ch == 4 ? WebPPictureImportRGBA(&pic, px.data(), w * 4)
                         : WebPPictureImportRGB(&pic, px.data(), w * 3);
  if (!ok) return 6;
  WebPMemoryWriter writer;
  WebPMemoryWriterInit(&writer);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &writer;
  if (!WebPEncode(&config, &pic)) return 7;
  std::fwrite(writer.mem, 1, writer.size, stdout);
  WebPMemoryWriterClear(&writer);
  WebPPictureFree(&pic);
  return 0;
}

int main(int argc, char** argv) {
  if (argc >= 10 && std::strcmp(argv[1], "jpeg") == 0) return jpeg(argc, argv);
  if (argc == 14 && std::strcmp(argv[1], "webp") == 0) return webp(argv);
  std::fprintf(stderr, "usage: see the comment at the top of image_fixture_writer.cpp\n");
  return 1;
}
