// The pixel stages and the entropy coder of the port's JPEG writer
// (core/image_save.py writes the markers; loaded by core/codecs.py).
// Host code, compiled with g++ at first use into the port's build
// directory (utils/build.py) and called through ctypes.
//
// It repeats what libjpeg-turbo 3.1 does for PIL's Image.save at PIL's
// defaults (quality 75, 4:2:0, islow DCT, standard Huffman tables, no
// restart markers), so that the bytes are libjpeg-turbo's. The C code is
// the contract: libjpeg-turbo's SIMD forward path gives the same bytes.
// - jccolor.c rgb_ycc_convert: fixed-point tables of 16 fraction bits,
//   Cb and Cr rounded by 0.5 - 2^-16; grayscale is copied.
// - jcprepct.c and jcsample.c: each component's rows are widened to its
//   width in blocks by repeating the last column; h2v2_downsample averages
//   2x2 pixels with a bias of 1, 2, 1, 2, ... along each output row, its
//   input widened to twice its output width; the image's last row is
//   repeated down to the end of its iMCU row.
// - jcdctmgr.c: samples - 128, jfdctint.c's jpeg_fdct_islow (13 constant
//   bits, 2 pass-1 bits), then the quantiser's reciprocal multiply
//   (compute_reciprocal on quantval << 3, 16-bit DCTELEM).
// - jccoefct.c compress_data: an MCU's blocks past the component's width
//   or height are dummies, all AC zero and DC that of the block before.
// - jchuff.c encode_one_block: DC differences per component, AC runs with
//   ZRL and EOB, 0xFF stuffed with 0x00, the last byte padded with ones.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jccolor.c's table: R_Y, G_Y, B_Y, R_CB, G_CB, B_CB (= R_CR), G_CR, B_CR.
struct ColorTable {
  int64_t t[8][256];
  ColorTable() {
    const auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    const int64_t half = int64_t(1) << 15, offset = int64_t(128) << 16;
    for (int64_t i = 0; i < 256; ++i) {
      t[0][i] = fix(0.29900) * i;
      t[1][i] = fix(0.58700) * i;
      t[2][i] = fix(0.11400) * i + half;
      t[3][i] = -fix(0.16874) * i;
      t[4][i] = -fix(0.33126) * i;
      t[5][i] = fix(0.50000) * i + offset + half - 1;
      t[6][i] = -fix(0.41869) * i;
      t[7][i] = -fix(0.08131) * i;
    }
  }
};

// One component's samples, widened and heightened to whole blocks of its
// iMCU rows, and its place in the MCU.
struct Plane {
  int64_t cols = 0, rows = 0;       // padded size in samples
  int64_t wblocks = 0, hblocks = 0; // width and height in real blocks
  int h = 1, v = 1;                 // sampling factors
  int table = 0;                    // quantisation and Huffman table
  std::vector<uint8_t> px;
};

// compute_reciprocal for a divisor of 8 or more, 16-bit DCTELEM: the
// quantised value is ((|x| + corr) * recip) >> shift, sign restored.
struct Divisor {
  uint32_t recip, corr, shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {uint32_t(fq & 0xFFFF), c, uint32_t(r)};
}

int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// jfdctint.c jpeg_fdct_islow, in place on 64 samples - 128.
void fdct_islow(int32_t* d) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433,
                    F0765 = 6270, F0899 = 7373, F1175 = 9633,
                    F1501 = 12299, F1847 = 15137, F1961 = 16069,
                    F2053 = 16819, F2562 = 20995, F3072 = 25172;
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    const int odd_shift = pass == 0 ? kConst - kPass1 : kConst + kPass1;
    for (int k = 0; k < 8; ++k) {
      int32_t* p = d + k * stride;
      const auto at = [&](int i) -> int32_t& { return p[i * step]; };
      int64_t tmp0 = at(0) + at(7), tmp7 = at(0) - at(7);
      int64_t tmp1 = at(1) + at(6), tmp6 = at(1) - at(6);
      int64_t tmp2 = at(2) + at(5), tmp5 = at(2) - at(5);
      int64_t tmp3 = at(3) + at(4), tmp4 = at(3) - at(4);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        at(0) = int32_t((tmp10 + tmp11) * (1 << kPass1));
        at(4) = int32_t((tmp10 - tmp11) * (1 << kPass1));
      } else {
        at(0) = int32_t(descale(tmp10 + tmp11, kPass1));
        at(4) = int32_t(descale(tmp10 - tmp11, kPass1));
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      at(2) = int32_t(descale(z1 + tmp13 * F0765, odd_shift));
      at(6) = int32_t(descale(z1 + tmp12 * -F1847, odd_shift));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      at(7) = int32_t(descale(tmp4 + z1 + z3, odd_shift));
      at(5) = int32_t(descale(tmp5 + z2 + z4, odd_shift));
      at(3) = int32_t(descale(tmp6 + z2 + z3, odd_shift));
      at(1) = int32_t(descale(tmp7 + z1 + z4, odd_shift));
    }
  }
}

// jpeg_make_c_derived_tbl: code and length of each symbol.
struct Huffman {
  uint32_t code[256] = {0};
  uint8_t size[256] = {0};
  explicit Huffman(const uint8_t* spec) {  // 16 counts, then the symbols
    int p = 0;
    uint32_t c = 0;
    for (int len = 1; len <= 16; ++len, c <<= 1) {
      for (int i = 0; i < spec[len - 1]; ++i, ++p, ++c) {
        code[spec[16 + p]] = c;
        size[spec[16 + p]] = uint8_t(len);
      }
    }
  }
};

class BitWriter {
 public:
  BitWriter(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}
  void put(uint32_t bits, int n) {
    acc_ = (acc_ << n) | (bits & ((uint64_t(1) << n) - 1));
    count_ += n;
    while (count_ >= 8) {
      count_ -= 8;
      emit(uint8_t(acc_ >> count_));
    }
  }
  // flush_bits: the partial byte filled with ones.
  void flush() {
    if (count_) put(0x7F, 8 - count_);
  }
  int64_t size() const { return overflow_ ? -1 : n_; }

 private:
  void emit(uint8_t b) {
    if (n_ + 2 > cap_) {
      overflow_ = true;
      return;
    }
    out_[n_++] = b;
    if (b == 0xFF) out_[n_++] = 0;
  }
  uint8_t* out_;
  int64_t cap_, n_ = 0;
  uint64_t acc_ = 0;
  int count_ = 0;
  bool overflow_ = false;
};

int nbits(int32_t v) {
  uint32_t a = uint32_t(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

void encode_block(BitWriter& bw, const int16_t* blk, int32_t* last_dc,
                  const Huffman& dc, const Huffman& ac) {
  const int32_t diff = blk[0] - *last_dc;
  *last_dc = blk[0];
  int n = nbits(diff);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(uint32_t(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int32_t c = blk[kNaturalOrder[k]];
    if (c == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) bw.put(ac.code[0xF0], ac.size[0xF0]);
    n = nbits(c);
    const int sym = (run << 4) + n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(uint32_t(c < 0 ? c - 1 : c), n);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

// A block of `pl` at block coordinates (by, bx): FDCT and quantisation.
void forward_dct(const Plane& pl, int64_t by, int64_t bx,
                 const Divisor* div, int16_t* out) {
  int32_t ws[64];
  for (int y = 0; y < 8; ++y) {
    const uint8_t* row = &pl.px[(by * 8 + y) * pl.cols + bx * 8];
    for (int x = 0; x < 8; ++x) ws[y * 8 + x] = int32_t(row[x]) - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    const int32_t t = ws[i];
    const uint32_t a = uint32_t(t < 0 ? -t : t);
    const int32_t q =
        int32_t(((uint64_t(a) + div[i].corr) * div[i].recip) >> div[i].shift);
    out[i] = int16_t(t < 0 ? -q : q);
  }
}

// Repeat each row's last real sample to the padded width, and the last
// real row down to the padded height.
void pad_plane(Plane& pl, int64_t real_cols, int64_t real_rows) {
  for (int64_t y = 0; y < real_rows; ++y) {
    uint8_t* row = &pl.px[y * pl.cols];
    for (int64_t x = real_cols; x < pl.cols; ++x) row[x] = row[real_cols - 1];
  }
  for (int64_t y = real_rows; y < pl.rows; ++y)
    std::memcpy(&pl.px[y * pl.cols], &pl.px[(real_rows - 1) * pl.cols],
                size_t(pl.cols));
}

}  // namespace

// The entropy-coded segment of a baseline JPEG of an (h, w, c) uint8
// image, c 1 (one component) or 3 (RGB to YCbCr at 4:2:0): quant holds
// the luma and chroma tables (64 each, natural order), huff the DC and AC
// tables of luma, then of chroma (16 counts and 256 symbol slots each).
// Returns its length, or -1 if it does not fit in cap bytes.
extern "C" int64_t tb_jpeg_encode_scan(const uint8_t* img, int64_t h,
                                       int64_t w, int64_t c,
                                       const uint16_t* quant,
                                       const uint8_t* huff, uint8_t* out,
                                       int64_t cap) {
  const int nc = c == 3 ? 3 : 1;
  const int hmax = nc == 3 ? 2 : 1, vmax = hmax;
  const int64_t mcu_cols = (w + 8 * hmax - 1) / (8 * hmax);
  const int64_t mcu_rows = (h + 8 * vmax - 1) / (8 * vmax);
  Plane planes[3];
  for (int ci = 0; ci < nc; ++ci) {
    Plane& pl = planes[ci];
    pl.h = pl.v = ci == 0 ? hmax : 1;
    pl.table = ci == 0 ? 0 : 1;
    pl.wblocks = (w * pl.h + 8 * hmax - 1) / (8 * hmax);
    pl.hblocks = (h * pl.v + 8 * vmax - 1) / (8 * vmax);
    pl.cols = pl.wblocks * 8;
    pl.rows = mcu_rows * pl.v * 8;
    pl.px.assign(size_t(pl.cols * pl.rows), 0);
  }
  if (nc == 1) {
    Plane& pl = planes[0];
    for (int64_t y = 0; y < h; ++y)
      std::memcpy(&pl.px[y * pl.cols], img + y * w * c, size_t(w));
    pad_plane(pl, w, h);
  } else {
    static const ColorTable ct;
    // Full-resolution Cb and Cr, widened to whole MCUs (the downsampler's
    // input width) and to an even number of rows.
    const int64_t cw = planes[1].cols * 2, ch = (h + 1) / 2 * 2;
    std::vector<uint8_t> cb(size_t(cw * ch)), cr(size_t(cw * ch));
    Plane& yp = planes[0];
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* src = img + y * w * 3;
      for (int64_t x = 0; x < w; ++x) {
        const int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
        yp.px[y * yp.cols + x] =
            uint8_t((ct.t[0][r] + ct.t[1][g] + ct.t[2][b]) >> 16);
        cb[y * cw + x] = uint8_t((ct.t[3][r] + ct.t[4][g] + ct.t[5][b]) >> 16);
        cr[y * cw + x] = uint8_t((ct.t[5][r] + ct.t[6][g] + ct.t[7][b]) >> 16);
      }
    }
    pad_plane(yp, w, h);
    for (std::vector<uint8_t>* full : {&cb, &cr}) {
      std::vector<uint8_t>& f = *full;
      for (int64_t y = 0; y < h; ++y)
        for (int64_t x = w; x < cw; ++x) f[y * cw + x] = f[y * cw + w - 1];
      if (ch > h)
        std::memcpy(&f[(ch - 1) * cw], &f[(h - 1) * cw], size_t(cw));
    }
    for (int ci = 1; ci < 3; ++ci) {
      Plane& pl = planes[ci];
      const std::vector<uint8_t>& f = ci == 1 ? cb : cr;
      const int64_t out_rows = ch / 2;
      for (int64_t y = 0; y < out_rows; ++y) {
        const uint8_t* r0 = &f[(2 * y) * cw];
        const uint8_t* r1 = &f[(2 * y + 1) * cw];
        int bias = 1;
        for (int64_t x = 0; x < pl.cols; ++x, bias ^= 3)
          pl.px[y * pl.cols + x] = uint8_t(
              (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >>
              2);
      }
      pad_plane(pl, pl.cols, out_rows);
    }
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(quant[t * 64 + i] << 3);
  const Huffman tables[4] = {Huffman(huff), Huffman(huff + 272),
                             Huffman(huff + 544), Huffman(huff + 816)};
  BitWriter bw(out, cap);
  int32_t last_dc[3] = {0, 0, 0};
  int16_t mcu[6][64];
  for (int64_t my = 0; my < mcu_rows; ++my) {
    for (int64_t mx = 0; mx < mcu_cols; ++mx) {
      int blkn = 0;
      for (int ci = 0; ci < nc; ++ci) {
        const Plane& pl = planes[ci];
        for (int yi = 0; yi < pl.v; ++yi) {
          const int64_t by = my * pl.v + yi;
          for (int xi = 0; xi < pl.h; ++xi, ++blkn) {
            const int64_t bx = mx * pl.h + xi;
            if (by < pl.hblocks && bx < pl.wblocks) {
              forward_dct(pl, by, bx, div[pl.table], mcu[blkn]);
              continue;
            }
            // A dummy block: the DC of the block before it in this MCU (the
            // last of the row above for a row of dummies).
            const int16_t dc = mcu[by < pl.hblocks ? blkn - 1
                                                   : blkn - xi - 1][0];
            std::memset(mcu[blkn], 0, sizeof(mcu[blkn]));
            mcu[blkn][0] = dc;
          }
        }
      }
      blkn = 0;
      for (int ci = 0; ci < nc; ++ci) {
        const Plane& pl = planes[ci];
        for (int b = 0; b < pl.h * pl.v; ++b, ++blkn)
          encode_block(bw, mcu[blkn], &last_dc[ci], tables[2 * pl.table],
                       tables[2 * pl.table + 1]);
      }
    }
  }
  bw.flush();
  return bw.size();
}
