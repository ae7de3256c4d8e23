// PNG row unfiltering (PNG specification, section 9: filter types 0-4).
//
// core/image_io.py decodes PNG files without an imaging library; this is
// its one loop that numpy cannot vectorise: the Average and Paeth filters
// make each byte depend on the reconstructed byte to its left, so a row
// is a serial scan. Host code, compiled with g++ at first use into the
// port's build directory (utils/build.py) and called through ctypes.
//
// src: rows x (1 + rowbytes) filtered bytes, each row led by its filter
// type; dst: rows x rowbytes reconstructed bytes. bpp: bytes per complete
// pixel, at least 1 (the left neighbour's distance). One call per image,
// or per Adam7 pass (each pass starts from a zero prior row).
// Returns 0, or 1 + the index of the first row with an unknown filter.

#include <cstdint>
#include <cstdlib>

extern "C" int64_t tb_png_unfilter(const uint8_t* src, uint8_t* dst,
                                   int64_t rows, int64_t rowbytes,
                                   int64_t bpp) {
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* in = src + r * (rowbytes + 1);
    const int ftype = in[0];
    ++in;
    uint8_t* out = dst + r * rowbytes;
    const uint8_t* up = r > 0 ? out - rowbytes : nullptr;
    switch (ftype) {
      case 0:
        for (int64_t x = 0; x < rowbytes; ++x) out[x] = in[x];
        break;
      case 1:
        for (int64_t x = 0; x < rowbytes; ++x)
          out[x] = in[x] + (x >= bpp ? out[x - bpp] : 0);
        break;
      case 2:
        for (int64_t x = 0; x < rowbytes; ++x)
          out[x] = in[x] + (up ? up[x] : 0);
        break;
      case 3:
        for (int64_t x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          out[x] = in[x] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a);
          const int pb = std::abs(p - b);
          const int pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[x] = in[x] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}
