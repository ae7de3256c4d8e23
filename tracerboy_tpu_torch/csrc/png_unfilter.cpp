// PNG row unfiltering (PNG specification, section 9: filter types 0-4),
// and the filter choice of PIL's PNG writer.
//
// core/image_io.py decodes PNG files without an imaging library; this is
// its one loop that numpy cannot vectorise: the Average and Paeth filters
// make each byte depend on the reconstructed byte to its left, so a row
// is a serial scan. Host code, compiled with g++ at first use into the
// port's build directory (utils/build.py) and called through ctypes.
//
// tb_png_filter is Pillow's ZipEncode.c for core/image_save.py's PNG
// writer: each row of rowbytes raw bytes filtered as ZipEncode.c chooses
// (its filter byte first, in dst's rows of 1 + rowbytes). A filtered
// byte v costs min(v, 256 - v); the row stays unfiltered (0) unless it
// costs more than 0, then Up (2) is taken where it costs less, then Sub
// (1) where it costs less still, then Paeth (4), each tried only while
// the best so far costs more than 0 (Average only under PIL's optimize
// option, which write_png does not set). The previous row is the raw
// one, zero above the first.
//
// src: rows x (1 + rowbytes) filtered bytes, each row led by its filter
// type; dst: rows x rowbytes reconstructed bytes. bpp: bytes per complete
// pixel, at least 1 (the left neighbour's distance). One call per image,
// or per Adam7 pass (each pass starts from a zero prior row).
// Returns 0, or 1 + the index of the first row with an unknown filter.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

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

extern "C" int64_t tb_png_filter(const uint8_t* src, uint8_t* dst,
                                 int64_t rows, int64_t rowbytes,
                                 int64_t bpp) {
  std::vector<uint8_t> zero(rowbytes, 0), up(rowbytes), sub(rowbytes),
      paeth(rowbytes);
  const auto cost = [](uint8_t v) { return v < 128 ? v : 256 - v; };
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* row = src + r * rowbytes;
    const uint8_t* prev = r > 0 ? row - rowbytes : zero.data();
    const uint8_t* out = row;
    int kind = 0;
    int64_t best = 0;
    for (int64_t x = 0; x < rowbytes; ++x) best += cost(row[x]);
    if (best > 0) {
      int64_t s = 0;
      for (int64_t x = 0; x < rowbytes; ++x) {
        up[x] = uint8_t(row[x] - prev[x]);
        s += cost(up[x]);
      }
      if (s < best) out = up.data(), kind = 2, best = s;
    }
    if (best > 0) {
      int64_t s = 0;
      for (int64_t x = 0; x < rowbytes; ++x) {
        sub[x] = uint8_t(row[x] - (x >= bpp ? row[x - bpp] : 0));
        s += cost(sub[x]);
      }
      if (s < best) out = sub.data(), kind = 1, best = s;
    }
    if (best > 0) {
      int64_t s = 0;
      for (int64_t x = 0; x < rowbytes; ++x) {
        const int a = x >= bpp ? row[x - bpp] : 0;
        const int b = prev[x];
        const int c = x >= bpp ? prev[x - bpp] : 0;
        const int pa = std::abs(b - c), pb = std::abs(a - c);
        const int pc = std::abs(a + b - 2 * c);
        const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        paeth[x] = uint8_t(row[x] - pred);
        s += cost(paeth[x]);
      }
      if (s < best) out = paeth.data(), kind = 4;
    }
    uint8_t* o = dst + r * (rowbytes + 1);
    o[0] = uint8_t(kind);
    std::memcpy(o + 1, out, size_t(rowbytes));
  }
  return 0;
}
