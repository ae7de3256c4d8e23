// The resampler of the port's ICO and ICNS writers (core/resample.py;
// loaded by core/codecs.py). Host code, compiled with g++ at first use
// into the port's build directory (utils/build.py), with
// -ffp-contract=off, and called through ctypes.
//
// It repeats Pillow 12.1's libImaging for 8-bit images, whose results
// IcoImagePlugin (thumbnails, LANCZOS) and IcnsImagePlugin (Image.resize,
// BICUBIC) write:
// - Resample.c: each axis's coefficients in double (precompute_coeffs:
//   the filter's support widened by the scale where the image shrinks,
//   each output's window [xmin, xmax) rounded from its centre, the
//   weights divided by their sum where it is not 0), then rounded to
//   fixed point of PRECISION_BITS = 22 away from zero
//   (normalize_coeffs_8bpc); the horizontal pass over only the rows the
//   vertical pass reads, then the vertical pass, each sum started at half
//   of the last place and clipped to 0..255 after its shift (clip8). The
//   sums are int, as in C: every band on its own, the same arithmetic.
// - Convert.c's premultiplication around a resize of LA and RGBA
//   (Image.resize converts to La / RGBa and back): MULDIV255 one way,
//   255 x c / alpha truncated and clipped the other, alpha 0 and 255
//   copied.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

double lanczos_filter(double x) {
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};

// PIL's Resampling values: LANCZOS 1, BICUBIC 3.
bool filter_of(int64_t id, Filter* f) {
  if (id == 1) *f = {lanczos_filter, 3.0};
  else if (id == 3) *f = {bicubic_filter, 2.0};
  else return false;
  return true;
}

struct Coeffs {
  int ksize;
  std::vector<int> bounds;    // (xmin, xmax - xmin) an output
  std::vector<int32_t> k;     // ksize an output, fixed point
};

// precompute_coeffs over the box (0, in_size), then normalize_coeffs_8bpc.
Coeffs precompute(int in_size, int out_size, const Filter& f) {
  const float in0 = 0.0f, in1 = float(in_size);
  double scale = double(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = f.support * filterscale;
  Coeffs c;
  c.ksize = int(std::ceil(support)) * 2 + 1;
  c.bounds.assign(size_t(out_size) * 2, 0);
  c.k.assign(size_t(out_size) * c.ksize, 0);
  std::vector<double> kk(c.ksize);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      double w = f.fn((x + xmin - center + 0.5) * ss);
      kk[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) kk[x] /= ww;
    }
    int32_t* k = &c.k[size_t(xx) * c.ksize];
    for (int x = 0; x < xmax; x++) {
      k[x] = kk[x] < 0 ? int(-0.5 + kk[x] * (1 << kPrecisionBits))
                       : int(0.5 + kk[x] * (1 << kPrecisionBits));
    }
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

uint8_t clip8(int in) {
  int v = in >> kPrecisionBits;
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// (rows, out_w, bands) from rows [offset, offset + rows) of (.., in_w, bands).
void horizontal(const uint8_t* in, int in_w, int bands, int offset, int rows,
                uint8_t* out, int out_w, const Coeffs& c) {
  for (int yy = 0; yy < rows; yy++) {
    const uint8_t* row = in + size_t(yy + offset) * in_w * bands;
    for (int xx = 0; xx < out_w; xx++) {
      int xmin = c.bounds[xx * 2], xmax = c.bounds[xx * 2 + 1];
      const int32_t* k = &c.k[size_t(xx) * c.ksize];
      for (int b = 0; b < bands; b++) {
        int ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; x++)
          ss += int(row[size_t(x + xmin) * bands + b]) * k[x];
        out[(size_t(yy) * out_w + xx) * bands + b] = clip8(ss);
      }
    }
  }
}

// (out_h, w, bands) from (.., w, bands), the bounds relative to its row 0.
void vertical(const uint8_t* in, int w, int bands, uint8_t* out, int out_h,
              const Coeffs& c) {
  for (int yy = 0; yy < out_h; yy++) {
    int ymin = c.bounds[yy * 2], ymax = c.bounds[yy * 2 + 1];
    const int32_t* k = &c.k[size_t(yy) * c.ksize];
    for (int xx = 0; xx < w; xx++) {
      for (int b = 0; b < bands; b++) {
        int ss = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < ymax; y++)
          ss += int(in[(size_t(y + ymin) * w + xx) * bands + b]) * k[y];
        out[(size_t(yy) * w + xx) * bands + b] = clip8(ss);
      }
    }
  }
}

}  // namespace

// ImagingResampleInner with the box (0, 0, w, h): (h, w, bands) uint8 to
// (out_h, out_w, bands), a size other than (h, w). Returns 0, or -1 for a
// filter it does not know or an empty output (PIL's "height and width
// must be > 0").
extern "C" int64_t tb_resample(const uint8_t* in, int64_t h, int64_t w,
                               int64_t bands, uint8_t* out, int64_t out_h,
                               int64_t out_w, int64_t filter) {
  Filter f;
  if (!filter_of(filter, &f) || out_h < 1 || out_w < 1) return -1;
  const int nb = int(bands);
  Coeffs ch = precompute(int(w), int(out_w), f);
  if (out_h == h) {
    horizontal(in, int(w), nb, 0, int(h), out, int(out_w), ch);
    return 0;
  }
  Coeffs cv = precompute(int(h), int(out_h), f);
  std::vector<uint8_t> temp;
  const uint8_t* src = in;
  if (out_w != w) {
    // Only the rows the vertical pass reads, its bounds moved to match.
    int ybox_first = cv.bounds[0];
    int ybox_last = cv.bounds[out_h * 2 - 2] + cv.bounds[out_h * 2 - 1];
    for (int64_t i = 0; i < out_h; i++) cv.bounds[i * 2] -= ybox_first;
    temp.resize(size_t(ybox_last - ybox_first) * out_w * nb);
    horizontal(in, int(w), nb, ybox_first, ybox_last - ybox_first,
               temp.data(), int(out_w), ch);
    src = temp.data();
  }
  vertical(src, int(out_w), nb, out, int(out_h), cv);
  return 0;
}

// RGBA -> RGBa and LA -> La (Convert.c rgbA2rgba, la2lA): n pixels of
// `bands` bytes, the last alpha, in place.
extern "C" int64_t tb_premultiply(uint8_t* px, int64_t n, int64_t bands) {
  for (int64_t i = 0; i < n; i++) {
    uint8_t* p = px + i * bands;
    unsigned alpha = p[bands - 1];
    for (int b = 0; b < bands - 1; b++) {
      unsigned tmp = p[b] * alpha + 128;
      p[b] = uint8_t(((tmp >> 8) + tmp) >> 8);
    }
  }
  return 0;
}

// RGBa -> RGBA and La -> LA (Convert.c rgba2rgbA, lA2la), in place.
extern "C" int64_t tb_unpremultiply(uint8_t* px, int64_t n, int64_t bands) {
  for (int64_t i = 0; i < n; i++) {
    uint8_t* p = px + i * bands;
    unsigned alpha = p[bands - 1];
    if (alpha == 255 || alpha == 0) continue;
    for (int b = 0; b < bands - 1; b++) {
      unsigned v = (255 * unsigned(p[b])) / alpha;
      p[b] = uint8_t(v > 255 ? 255 : v);
    }
  }
  return 0;
}
