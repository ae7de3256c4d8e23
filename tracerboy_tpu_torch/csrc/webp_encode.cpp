// The lossy WebP writer of core/image_save.py: libwebp 1.6's VP8 encoder
// as PIL 12.1's Image.save runs it (WebPEncode with
// lossy coding, quality 80, method 4, the default preset otherwise: 4
// segments, sns_strength 50, filter_strength 60 with the normal filter
// and sharpness 0, one token partition, one pass, no preprocessing, no
// target size, no sharp YUV). Host code, compiled with g++ at first use
// into the port's build directory (utils/build.py) with
// -ffp-contract=off and called through ctypes. Its tables are the
// decoder's (webp_vp8_tables.inc) and the encoder's own
// (webp_enc_tables.inc).
//
// The stages follow libwebp's files, in the order WebPEncode runs them:
// - RGB to YUV 4:2:0 (picture_csp_enc.c, ImportYUVAFromRGBA without
//   dithering): Y by VP8RGBToY in 16-bit fixed point, U and V from the
//   2x2 average of each channel taken through the gamma tables
//   (pow(x, 0.8) in 12 bits, the inverse interpolated from 33 entries),
//   an odd last column or row averaged with itself; with alpha below 255
//   somewhere (ImportYUVAFromRGBA), each 2x2 chroma sample whose alphas
//   are neither all 0 nor all 255 weighted by them (AccumulateRGBA,
//   libwebp's kInvAlpha division), then WebPCleanupTransparentArea
//   (picture_tools_enc.c, as exact is 0): wholly transparent 8x8 blocks
//   flattened to the first of their run, transparent pixels of the others
//   set to the mean luma of the visible ones;
// - analysis (analysis_enc.c): per macroblock the DCT histogram's
//   "alpha" of the I16 and UV modes DC and TM, mixed 3:1, then
//   k-means of the alphas into 4 segments and SetSegmentAlphas;
// - segment parameters (quant_enc.c VP8SetSegmentParams): the quantiser
//   of each segment from quality 80 through pow, SetupFilterStrength,
//   SimplifySegments, SetupMatrices (q, iq, bias, zthresh, sharpen and
//   the lambdas, tlambda from sns_strength as method 4 has it);
// - mode decision at RD_OPT_BASIC (no trellis): PickBestIntra16,
//   PickBestIntra4 with its early exits, PickBestUV with the DC error
//   diffusion that quality <= 98 turns on; rate from the level cost
//   tables, distortion as SSE plus the weighted spectral TDisto;
// - the token loop (frame_enc.c VP8EncTokenLoop): tokens recorded with
//   their statistics, the coefficient probabilities refreshed every
//   max(96, MBs / 8) macroblocks and once more at the end, an update
//   written only where it is cheaper; the skip flag is not coded (the
//   token path never uses it); the segment map written unless every
//   probability is 255; the frame's filter level from each segment's
//   max_edge (VP8AdjustFilterStrength);
// - the bitstream (syntax_enc.c, tree_enc.c, bit_writer_utils.c): the
//   bool coder with its carry over pending 0xff bytes and its end of
//   9 - nb_bits zero bits, partition 0 (headers, probability updates,
//   modes) and one token partition in a RIFF "VP8 " chunk whose size
//   counts the pad byte.
//
// Where PIL's libwebp runs SIMD on x86, it runs the SSE2 inverse
// transform, whose 16-bit lanes wrap: ITransform follows it (the C
// version differs only where an intermediate passes 16 bits). The other
// SSE2/SSE4.1 routines (forward transform, quantiser, distortions,
// histograms, predictors) give the C results, so they are written as C.
// A quirk of token_enc.c is kept: the statistics of categories 5 and 6's
// second branch (probability 10) are counted on probability 9.
//
// Entry points (0 or a positive size on success, negative on error):
// - tb_webp_encode(rgb, w, h, out, cap): an RGB image to its .webp file;
//   returns the file's size, or -(its size) when cap is too small, -1
//   for a side outside 1-16383, -2 where partition 0 would overflow;
// - tb_webp_encode_rgba(rgba, w, h, out, cap): the same for an RGBA image
//   with alpha below 255 somewhere: its colours as above (the ALPH chunk
//   is webp_alpha_encode.cpp's, the container core/image_save.py's);
// - tb_webp_yuv(rgb, w, h, y, u, v): the YUV 4:2:0 planes of stage 1;
// - tb_webp_yuva(rgba, w, h, clean, y, u, v, a): the YUVA planes of an
//   RGBA image, after the cleanup where clean is set;
// - tb_webp_mb_info(rgb, w, h, info): per macroblock (raster order) six
//   bytes, libwebp's WebPPicture.extra_info types 1-5 and 7: type (1 =
//   I16), segment, quantiser, I16 mode (0xff for I4), UV mode, alpha (the
//   segment's centre); returns the number of macroblocks.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

#include "webp_vp8_tables.inc"
#include "webp_enc_tables.inc"

constexpr int BPS = 32;   // libwebp's work-buffer stride

// ---------------------------------------------------------------------------
// Stage 1: RGB to YUV 4:2:0

constexpr int YUV_FIX = 16;
constexpr int YUV_HALF = 1 << (YUV_FIX - 1);
constexpr int kGammaFix = 12;
constexpr int kGammaScale = (1 << kGammaFix) - 1;
constexpr int kGammaTabFix = 7;
constexpr int kGammaTabScale = 1 << kGammaTabFix;
constexpr int kGammaTabRounder = kGammaTabScale >> 1;
constexpr int kGammaTabSize = 1 << (kGammaFix - kGammaTabFix);

struct GammaTables {
  int linear_to_gamma[kGammaTabSize + 1];
  uint16_t gamma_to_linear[256];
  GammaTables() {
    const double kGamma = 0.80;
    const double scale = double(1 << kGammaTabFix) / kGammaScale;
    const double norm = 1. / 255.;
    for (int v = 0; v <= 255; ++v)
      gamma_to_linear[v] =
          uint16_t(std::pow(norm * v, kGamma) * kGammaScale + .5);
    for (int v = 0; v <= kGammaTabSize; ++v)
      linear_to_gamma[v] = int(255. * std::pow(scale * v, 1. / kGamma) + .5);
  }
};

const GammaTables& Gamma() {
  static const GammaTables tables;
  return tables;
}

inline int LinearToGamma(uint32_t base_value, int shift) {
  const int* tab = Gamma().linear_to_gamma;
  const int v = int(base_value << shift);
  const int tab_pos = v >> (kGammaTabFix + 2);
  const int x = v & ((kGammaTabScale << 2) - 1);
  const int y = tab[tab_pos + 1] * x + tab[tab_pos] * ((kGammaTabScale << 2) - x);
  return (y + kGammaTabRounder) >> kGammaTabFix;
}

inline int ClipUV(int uv, int rounding) {
  uv = (uv + rounding + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2);
  return (uv & ~0xff) == 0 ? uv : uv < 0 ? 0 : 255;
}
inline int RGBToY(int r, int g, int b, int rounding) {
  const int luma = 16839 * r + 33059 * g + 6420 * b;
  return (luma + rounding + (16 << YUV_FIX)) >> YUV_FIX;
}
inline int RGBToU(int r, int g, int b, int rounding) {
  return ClipUV(-9719 * r - 19081 * g + 28800 * b, rounding);
}
inline int RGBToV(int r, int g, int b, int rounding) {
  return ClipUV(+28800 * r - 24116 * g - 4684 * b, rounding);
}

struct Picture {
  int width = 0, height = 0;
  int y_stride = 0, uv_stride = 0;
  std::vector<uint8_t> y, u, v;
};

// Rows r0 and r1 (equal for an odd last row) of the RGB image averaged
// into U and V, as AccumulateRGB and ConvertRGBA32ToUV do.
void RowsToUV(const uint8_t* r0, const uint8_t* r1, int width, uint8_t* u,
              uint8_t* v) {
  const uint16_t* g2l = Gamma().gamma_to_linear;
  int i = 0;
  for (; i < (width >> 1); ++i) {
    int c[3];
    for (int k = 0; k < 3; ++k) {
      const uint8_t* p0 = r0 + 6 * i + k;
      const uint8_t* p1 = r1 + 6 * i + k;
      c[k] = LinearToGamma(g2l[p0[0]] + g2l[p0[3]] + g2l[p1[0]] + g2l[p1[3]],
                           0);
    }
    u[i] = uint8_t(RGBToU(c[0], c[1], c[2], YUV_HALF << 2));
    v[i] = uint8_t(RGBToV(c[0], c[1], c[2], YUV_HALF << 2));
  }
  if (width & 1) {
    int c[3];
    for (int k = 0; k < 3; ++k)
      c[k] = LinearToGamma(g2l[r0[6 * i + k]] + g2l[r1[6 * i + k]], 1);
    u[i] = uint8_t(RGBToU(c[0], c[1], c[2], YUV_HALF << 2));
    v[i] = uint8_t(RGBToV(c[0], c[1], c[2], YUV_HALF << 2));
  }
}

void ImportRGB(const uint8_t* rgb, int width, int height, Picture* pic) {
  pic->width = width;
  pic->height = height;
  pic->y_stride = width;
  pic->uv_stride = (width + 1) >> 1;
  const int uv_height = (height + 1) >> 1;
  pic->y.assign(size_t(width) * height, 0);
  pic->u.assign(size_t(pic->uv_stride) * uv_height, 0);
  pic->v.assign(size_t(pic->uv_stride) * uv_height, 0);
  const size_t stride = size_t(3) * width;
  for (int j = 0; j < height; ++j) {
    const uint8_t* row = rgb + j * stride;
    uint8_t* dst = &pic->y[size_t(j) * width];
    for (int i = 0; i < width; ++i)
      dst[i] = uint8_t(RGBToY(row[3 * i], row[3 * i + 1], row[3 * i + 2],
                              YUV_HALF));
  }
  for (int j = 0; j < uv_height; ++j) {
    const uint8_t* r0 = rgb + size_t(2 * j) * stride;
    const uint8_t* r1 = (2 * j + 1 < height) ? r0 + stride : r0;
    RowsToUV(r0, r1, width, &pic->u[size_t(j) * pic->uv_stride],
             &pic->v[size_t(j) * pic->uv_stride]);
  }
}

// AccumulateRGBA's weighted average (LinearToGammaWeighted): sum is the
// alpha-weighted sum of four linear values, total_a their alphas' sum;
// kInvAlpha[a] = (1 << 19) / a stands for the division by a, with the
// factor 4 LinearToGamma expects folded into the shift.
inline int DivideByAlpha(uint32_t sum, uint32_t total_a) {
  const uint32_t inv = total_a ? (1u << 19) / total_a : 0;
  return int((sum * inv) >> (19 - 2));
}

// An RGBA image with some alpha below 255 to YUVA 4:2:0, as
// ImportYUVAFromRGBA does it: Y as for RGB, the A plane copied, and each
// 2x2 chroma sample whose alphas are neither all 0 nor all 255 averaged
// with the alphas as weights in the linear domain (AccumulateRGBA); an
// odd last column or row stands for two, as in RowsToUV.
void ImportRGBA(const uint8_t* rgba, int width, int height, Picture* pic,
                std::vector<uint8_t>* a) {
  const uint16_t* g2l = Gamma().gamma_to_linear;
  std::vector<uint8_t> rgb(size_t(3) * width * height);
  a->resize(size_t(width) * height);
  for (size_t n = 0; n < a->size(); ++n) {
    std::memcpy(&rgb[3 * n], rgba + 4 * n, 3);
    (*a)[n] = rgba[4 * n + 3];
  }
  ImportRGB(rgb.data(), width, height, pic);
  const size_t stride = size_t(4) * width;
  for (int j = 0; j < (height + 1) >> 1; ++j) {
    const uint8_t* r0 = rgba + size_t(2 * j) * stride;
    const uint8_t* r1 = (2 * j + 1 < height) ? r0 + stride : r0;
    for (int i = 0; i < (width + 1) >> 1; ++i) {
      const int x0 = 8 * i, x1 = (2 * i + 1 < width) ? x0 + 4 : x0;
      const uint32_t al[4] = {r0[x0 + 3], r0[x1 + 3], r1[x0 + 3], r1[x1 + 3]};
      const uint32_t total = al[0] + al[1] + al[2] + al[3];
      if (total == 4 * 255 || total == 0) continue;   // RowsToUV's value
      int c[3];
      for (int k = 0; k < 3; ++k) {
        const uint32_t sum = al[0] * g2l[r0[x0 + k]] + al[1] * g2l[r0[x1 + k]]
            + al[2] * g2l[r1[x0 + k]] + al[3] * g2l[r1[x1 + k]];
        c[k] = LinearToGamma(uint32_t(DivideByAlpha(sum, total)), 0);
      }
      const size_t o = size_t(j) * pic->uv_stride + i;
      pic->u[o] = uint8_t(RGBToU(c[0], c[1], c[2], YUV_HALF << 2));
      pic->v[o] = uint8_t(RGBToV(c[0], c[1], c[2], YUV_HALF << 2));
    }
  }
}

// WebPCleanupTransparentArea on a YUVA picture (picture_tools_enc.c), which
// WebPEncode runs because exact is 0. Over whole 8x8 luma blocks in raster
// order: a block whose alphas are all 0 is flattened, luma and its 4x4
// chroma, to the values of the first block of its run of such blocks in
// the row; a block partly transparent gets the mean luma of its visible
// pixels in its transparent ones (SmoothenBlock). The leftovers at the
// right and bottom are only smoothened.
bool SmoothenBlock(const uint8_t* a, int a_stride, uint8_t* y, int y_stride,
                   int width, int height) {
  int sum = 0, count = 0;
  for (int j = 0; j < height; ++j)
    for (int i = 0; i < width; ++i)
      if (a[j * a_stride + i] != 0) {
        ++count;
        sum += y[j * y_stride + i];
      }
  if (count > 0 && count < width * height) {
    const uint8_t avg = uint8_t(sum / count);
    for (int j = 0; j < height; ++j)
      for (int i = 0; i < width; ++i)
        if (a[j * a_stride + i] == 0) y[j * y_stride + i] = avg;
  }
  return count == 0;
}

void Flatten(uint8_t* p, int v, int stride, int size) {
  for (int j = 0; j < size; ++j) std::memset(p + j * stride, v, size);
}

void CleanupTransparentArea(Picture* pic, const std::vector<uint8_t>& alpha) {
  const int width = pic->width, height = pic->height;
  const int ys = pic->y_stride, uvs = pic->uv_stride, as = width;
  const uint8_t* a = alpha.data();
  uint8_t* y = pic->y.data();
  uint8_t* u = pic->u.data();
  uint8_t* v = pic->v.data();
  int values[3] = {0, 0, 0};
  int row = 0;
  for (; row + 8 <= height; row += 8) {
    bool need_reset = true;
    int x = 0;
    for (; x + 8 <= width; x += 8) {
      if (SmoothenBlock(a + x, as, y + x, ys, 8, 8)) {
        if (need_reset) {
          values[0] = y[x];
          values[1] = u[x >> 1];
          values[2] = v[x >> 1];
          need_reset = false;
        }
        Flatten(y + x, values[0], ys, 8);
        Flatten(u + (x >> 1), values[1], uvs, 4);
        Flatten(v + (x >> 1), values[2], uvs, 4);
      } else {
        need_reset = true;
      }
    }
    if (x < width) SmoothenBlock(a + x, as, y + x, ys, width - x, 8);
    a += 8 * as;
    y += 8 * ys;
    u += 4 * uvs;
    v += 4 * uvs;
  }
  if (row < height) {
    const int sub_height = height - row;
    int x = 0;
    for (; x + 8 <= width; x += 8)
      SmoothenBlock(a + x, as, y + x, ys, 8, sub_height);
    if (x < width) SmoothenBlock(a + x, as, y + x, ys, width - x, sub_height);
  }
}

// ---------------------------------------------------------------------------
// The pixel routines of src/dsp/enc.c

// Offsets in the work buffers (libwebp's layout): the 16x16 luma, then
// the 8x8 U and V side by side.
constexpr int Y_OFF = 0, U_OFF = 16;
constexpr int I16DC16 = 0, I16TM16 = 16, I16VE16 = 16 * BPS,
              I16HE16 = 16 * BPS + 16;
constexpr int C8DC8 = 2 * 16 * BPS, C8TM8 = C8DC8 + 16,
              C8VE8 = 2 * 16 * BPS + 8 * BPS, C8HE8 = C8VE8 + 16;
constexpr int I4DC4 = 3 * 16 * BPS, I4HD4 = 3 * 16 * BPS + 4 * BPS,
              I4TMP = I4HD4 + 8;
constexpr int PRED_SIZE = 3 * 16 * BPS + 8 * BPS;
constexpr int kI16ModeOffsets[4] = {I16DC16, I16TM16, I16VE16, I16HE16};
constexpr int kUVModeOffsets[4] = {C8DC8, C8TM8, C8VE8, C8HE8};
constexpr int kI4ModeOffsets[10] = {
    I4DC4,      I4DC4 + 4,  I4DC4 + 8, I4DC4 + 12, I4DC4 + 16,
    I4DC4 + 20, I4DC4 + 24, I4DC4 + 28, I4HD4,     I4HD4 + 4};
constexpr int kScan[16] = {
    0,        4,            8,            12,
    4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
    8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
    12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
constexpr int kScanUV[8] = {0, 4, 4 * BPS, 4 + 4 * BPS,
                            8, 12, 8 + 4 * BPS, 12 + 4 * BPS};

enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  TM_PRED = B_TM_PRED
};

inline uint8_t Clip8b(int v) {
  return (v & ~255) == 0 ? uint8_t(v) : v < 0 ? 0 : 255;
}

void FTransform(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += BPS, ref += BPS) {
    const int d0 = src[0] - ref[0];
    const int d1 = src[1] - ref[1];
    const int d2 = src[2] - ref[2];
    const int d3 = src[3] - ref[3];
    const int a0 = d0 + d3;
    const int a1 = d1 + d2;
    const int a2 = d1 - d2;
    const int a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i];
    const int a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i];
    const int a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = int16_t((a0 + a1 + 7) >> 4);
    out[4 + i] = int16_t(((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0));
    out[8 + i] = int16_t((a0 - a1 + 7) >> 4);
    out[12 + i] = int16_t((a3 * 2217 - a2 * 5352 + 51000) >> 16);
  }
}

void FTransform2(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  FTransform(src, ref, out);
  FTransform(src + 4, ref + 4, out + 16);
}

void FTransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, in += 64) {
    const int a0 = in[0 * 16] + in[2 * 16];
    const int a1 = in[1 * 16] + in[3 * 16];
    const int a2 = in[1 * 16] - in[3 * 16];
    const int a3 = in[0 * 16] - in[2 * 16];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i];
    const int a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i];
    const int a3 = tmp[0 + i] - tmp[8 + i];
    const int b0 = a0 + a1;
    const int b1 = a3 + a2;
    const int b2 = a3 - a2;
    const int b3 = a0 - a1;
    out[0 + i] = int16_t(b0 >> 1);
    out[4 + i] = int16_t(b1 >> 1);
    out[8 + i] = int16_t(b2 >> 1);
    out[12 + i] = int16_t(b3 >> 1);
  }
}

// The inverse WHT (TransformWHT_C): the 16 DCs back into tmp[n][0].
void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// ITransform_SSE2: the inverse DCT of one block in 16-bit lanes (sums
// wrap, the products are _mm_mulhi_epi16 by k - 65536 plus the input),
// added to ref with a 16-bit wrap and saturated to 8 bits.
inline int16_t W16(int v) { return int16_t(uint16_t(v)); }
inline int16_t MulHi16(int16_t a, int k) {
  return int16_t((int32_t(a) * k) >> 16);
}

void ITransformOne(const uint8_t* ref, const int16_t* in, uint8_t* dst) {
  int16_t t[16];
  for (int j = 0; j < 4; ++j) {
    const int16_t i0 = in[j], i1 = in[4 + j], i2 = in[8 + j];
    const int16_t i3 = in[12 + j];
    const int16_t a = W16(i0 + i2), b = W16(i0 - i2);
    const int16_t c = W16(W16(i1 - i3) +
                          W16(MulHi16(i1, -30068) - MulHi16(i3, 20091)));
    const int16_t d = W16(W16(i1 + i3) +
                          W16(MulHi16(i1, 20091) + MulHi16(i3, -30068)));
    t[4 * j + 0] = W16(a + d);
    t[4 * j + 1] = W16(b + c);
    t[4 * j + 2] = W16(b - c);
    t[4 * j + 3] = W16(a - d);
  }
  for (int i = 0; i < 4; ++i) {
    const int16_t T0 = t[i], T1 = t[4 + i], T2 = t[8 + i], T3 = t[12 + i];
    const int16_t dc = W16(T0 + 4);
    const int16_t a = W16(dc + T2), b = W16(dc - T2);
    const int16_t c = W16(W16(T1 - T3) +
                          W16(MulHi16(T1, -30068) - MulHi16(T3, 20091)));
    const int16_t d = W16(W16(T1 + T3) +
                          W16(MulHi16(T1, 20091) + MulHi16(T3, -30068)));
    const int16_t v[4] = {int16_t(W16(a + d) >> 3), int16_t(W16(b + c) >> 3),
                          int16_t(W16(b - c) >> 3), int16_t(W16(a - d) >> 3)};
    for (int x = 0; x < 4; ++x) {
      const int16_t s = W16(ref[x + i * BPS] + v[x]);
      dst[x + i * BPS] = uint8_t(s < 0 ? 0 : s > 255 ? 255 : s);
    }
  }
}

void ITransform(const uint8_t* ref, const int16_t* in, uint8_t* dst,
                bool do_two) {
  ITransformOne(ref, in, dst);
  if (do_two) ITransformOne(ref + 4, in + 16, dst + 4);
}

struct Matrix {
  uint16_t q[16];
  uint16_t iq[16];
  uint32_t bias[16];
  uint32_t zthresh[16];
  uint16_t sharpen[16];
};

constexpr int QFIX = 17;
constexpr int MAX_LEVEL = 2047;

inline int QuantDiv(uint32_t n, uint32_t iq, uint32_t b) {
  return int((n * iq + b) >> QFIX);
}

int QuantizeBlock(int16_t in[16], int16_t out[16], const Matrix& mtx) {
  int last = -1;
  for (int n = 0; n < 16; ++n) {
    const int j = kZigzag[n];
    const bool sign = in[j] < 0;
    const uint32_t coeff = uint32_t((sign ? -in[j] : in[j]) + mtx.sharpen[j]);
    if (coeff > mtx.zthresh[j]) {
      int level = QuantDiv(coeff, mtx.iq[j], mtx.bias[j]);
      if (level > MAX_LEVEL) level = MAX_LEVEL;
      if (sign) level = -level;
      in[j] = int16_t(level * int(mtx.q[j]));
      out[n] = int16_t(level);
      if (level) last = n;
    } else {
      out[n] = 0;
      in[j] = 0;
    }
  }
  return last >= 0;
}

int Quantize2Blocks(int16_t in[32], int16_t out[32], const Matrix& mtx) {
  int nz = QuantizeBlock(in, out, mtx) << 0;
  nz |= QuantizeBlock(in + 16, out + 16, mtx) << 1;
  return nz;
}

int SSE(const uint8_t* a, const uint8_t* b, int w, int h) {
  int count = 0;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int diff = int(a[x]) - b[x];
      count += diff * diff;
    }
    a += BPS;
    b += BPS;
  }
  return count;
}

constexpr uint16_t kWeightY[16] = {38, 32, 20, 9, 32, 28, 17, 7,
                                   20, 17, 10, 4, 9,  7,  4,  2};

int TTransform(const uint8_t* in, const uint16_t* w) {
  int sum = 0;
  int tmp[16];
  for (int i = 0; i < 4; ++i, in += BPS) {
    const int a0 = in[0] + in[2];
    const int a1 = in[1] + in[3];
    const int a2 = in[1] - in[3];
    const int a3 = in[0] - in[2];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i, ++w) {
    const int a0 = tmp[0 + i] + tmp[8 + i];
    const int a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i];
    const int a3 = tmp[0 + i] - tmp[8 + i];
    const int b0 = a0 + a1;
    const int b1 = a3 + a2;
    const int b2 = a3 - a2;
    const int b3 = a0 - a1;
    sum += w[0] * std::abs(b0);
    sum += w[4] * std::abs(b1);
    sum += w[8] * std::abs(b2);
    sum += w[12] * std::abs(b3);
  }
  return sum;
}

int Disto4x4(const uint8_t* a, const uint8_t* b, const uint16_t* w) {
  return std::abs(TTransform(b, w) - TTransform(a, w)) >> 5;
}

int Disto16x16(const uint8_t* a, const uint8_t* b, const uint16_t* w) {
  int D = 0;
  for (int y = 0; y < 16 * BPS; y += 4 * BPS)
    for (int x = 0; x < 16; x += 4) D += Disto4x4(a + x + y, b + x + y, w);
  return D;
}

// Predictors (an absent left or top edge is passed as nullptr).
void Fill(uint8_t* dst, int value, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, value, size);
}

void VerticalPred(uint8_t* dst, const uint8_t* top, int size) {
  if (top) {
    for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, top, size);
  } else {
    Fill(dst, 127, size);
  }
}

void HorizontalPred(uint8_t* dst, const uint8_t* left, int size) {
  if (left) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, left[j], size);
  } else {
    Fill(dst, 129, size);
  }
}

void TrueMotion(uint8_t* dst, const uint8_t* left, const uint8_t* top,
                int size) {
  if (left) {
    if (top) {
      for (int y = 0; y < size; ++y) {
        for (int x = 0; x < size; ++x)
          dst[x] = Clip8b(top[x] + left[y] - left[-1]);
        dst += BPS;
      }
    } else {
      HorizontalPred(dst, left, size);
    }
  } else if (top) {
    VerticalPred(dst, top, size);
  } else {
    Fill(dst, 129, size);
  }
}

void DCMode(uint8_t* dst, const uint8_t* left, const uint8_t* top, int size,
            int round, int shift) {
  int DC = 0;
  if (top) {
    for (int j = 0; j < size; ++j) DC += top[j];
    if (left) {
      for (int j = 0; j < size; ++j) DC += left[j];
    } else {
      DC += DC;
    }
    DC = (DC + round) >> shift;
  } else if (left) {
    for (int j = 0; j < size; ++j) DC += left[j];
    DC += DC;
    DC = (DC + round) >> shift;
  } else {
    DC = 0x80;
  }
  Fill(dst, DC, size);
}

void Intra16Preds(uint8_t* dst, const uint8_t* left, const uint8_t* top) {
  DCMode(I16DC16 + dst, left, top, 16, 16, 5);
  VerticalPred(I16VE16 + dst, top, 16);
  HorizontalPred(I16HE16 + dst, left, 16);
  TrueMotion(I16TM16 + dst, left, top, 16);
}

void IntraChromaPreds(uint8_t* dst, const uint8_t* left, const uint8_t* top) {
  for (int ch = 0; ch < 2; ++ch) {   // U, then V 8 columns further
    DCMode(C8DC8 + dst, left, top, 8, 8, 4);
    VerticalPred(C8VE8 + dst, top, 8);
    HorizontalPred(C8HE8 + dst, left, 8);
    TrueMotion(C8TM8 + dst, left, top, 8);
    dst += 8;
    if (top) top += 8;
    if (left) left += 16;
  }
}

inline uint8_t Avg3(int a, int b, int c) {
  return uint8_t((a + 2 * b + c + 2) >> 2);
}
inline uint8_t Avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

#define DST(x, y) dst[(x) + (y) * BPS]

// The ten 4x4 predictors from top (top[-1] the corner, top[-2..-5] the
// left column downwards, top[0..7] the row above and its right).
void Intra4Preds(uint8_t* base, const uint8_t* top) {
  const int X = top[-1], I = top[-2], J = top[-3], K = top[-4], L = top[-5];
  const int A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  uint8_t* dst = base + kI4ModeOffsets[B_DC_PRED];
  {
    uint32_t dc = 4;
    for (int i = 0; i < 4; ++i) dc += top[i] + top[-5 + i];
    Fill(dst, int(dc >> 3), 4);
  }
  dst = base + kI4ModeOffsets[B_TM_PRED];
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) DST(x, y) = Clip8b(top[x] + top[-2 - y] - X);
  dst = base + kI4ModeOffsets[B_VE_PRED];
  {
    const uint8_t vals[4] = {Avg3(X, A, B), Avg3(A, B, C), Avg3(B, C, D),
                             Avg3(C, D, E)};
    for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
  }
  dst = base + kI4ModeOffsets[B_HE_PRED];
  {
    const uint8_t vals[4] = {Avg3(X, I, J), Avg3(I, J, K), Avg3(J, K, L),
                             Avg3(K, L, L)};
    for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, vals[i], 4);
  }
  dst = base + kI4ModeOffsets[B_RD_PRED];
  DST(0, 3) = Avg3(J, K, L);
  DST(0, 2) = DST(1, 3) = Avg3(I, J, K);
  DST(0, 1) = DST(1, 2) = DST(2, 3) = Avg3(X, I, J);
  DST(0, 0) = DST(1, 1) = DST(2, 2) = DST(3, 3) = Avg3(A, X, I);
  DST(1, 0) = DST(2, 1) = DST(3, 2) = Avg3(B, A, X);
  DST(2, 0) = DST(3, 1) = Avg3(C, B, A);
  DST(3, 0) = Avg3(D, C, B);
  dst = base + kI4ModeOffsets[B_VR_PRED];
  DST(0, 0) = DST(1, 2) = Avg2(X, A);
  DST(1, 0) = DST(2, 2) = Avg2(A, B);
  DST(2, 0) = DST(3, 2) = Avg2(B, C);
  DST(3, 0) = Avg2(C, D);
  DST(0, 3) = Avg3(K, J, I);
  DST(0, 2) = Avg3(J, I, X);
  DST(0, 1) = DST(1, 3) = Avg3(I, X, A);
  DST(1, 1) = DST(2, 3) = Avg3(X, A, B);
  DST(2, 1) = DST(3, 3) = Avg3(A, B, C);
  DST(3, 1) = Avg3(B, C, D);
  dst = base + kI4ModeOffsets[B_LD_PRED];
  DST(0, 0) = Avg3(A, B, C);
  DST(1, 0) = DST(0, 1) = Avg3(B, C, D);
  DST(2, 0) = DST(1, 1) = DST(0, 2) = Avg3(C, D, E);
  DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = Avg3(D, E, F);
  DST(3, 1) = DST(2, 2) = DST(1, 3) = Avg3(E, F, G);
  DST(3, 2) = DST(2, 3) = Avg3(F, G, H);
  DST(3, 3) = Avg3(G, H, H);
  dst = base + kI4ModeOffsets[B_VL_PRED];
  DST(0, 0) = Avg2(A, B);
  DST(1, 0) = DST(0, 2) = Avg2(B, C);
  DST(2, 0) = DST(1, 2) = Avg2(C, D);
  DST(3, 0) = DST(2, 2) = Avg2(D, E);
  DST(0, 1) = Avg3(A, B, C);
  DST(1, 1) = DST(0, 3) = Avg3(B, C, D);
  DST(2, 1) = DST(1, 3) = Avg3(C, D, E);
  DST(3, 1) = DST(2, 3) = Avg3(D, E, F);
  DST(3, 2) = Avg3(E, F, G);
  DST(3, 3) = Avg3(F, G, H);
  dst = base + kI4ModeOffsets[B_HD_PRED];
  DST(0, 0) = DST(2, 1) = Avg2(I, X);
  DST(0, 1) = DST(2, 2) = Avg2(J, I);
  DST(0, 2) = DST(2, 3) = Avg2(K, J);
  DST(0, 3) = Avg2(L, K);
  DST(3, 0) = Avg3(A, B, C);
  DST(2, 0) = Avg3(X, A, B);
  DST(1, 0) = DST(3, 1) = Avg3(I, X, A);
  DST(1, 1) = DST(3, 2) = Avg3(J, I, X);
  DST(1, 2) = DST(3, 3) = Avg3(K, J, I);
  DST(1, 3) = Avg3(L, K, J);
  dst = base + kI4ModeOffsets[B_HU_PRED];
  DST(0, 0) = Avg2(I, J);
  DST(2, 0) = DST(0, 1) = Avg2(J, K);
  DST(2, 1) = DST(0, 2) = Avg2(K, L);
  DST(1, 0) = Avg3(I, J, K);
  DST(3, 0) = DST(1, 1) = Avg3(J, K, L);
  DST(3, 1) = DST(1, 2) = Avg3(K, L, L);
  DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
      uint8_t(L);
}

#undef DST

// ---------------------------------------------------------------------------
// The bool coder (bit_writer_utils.c)

struct BitWriter {
  int32_t range = 255 - 1;
  int32_t value = 0;
  int run = 0;
  int nb_bits = -8;
  std::vector<uint8_t> buf;

  void Flush() {
    const int s = 8 + nb_bits;
    const int32_t bits = value >> s;
    value -= bits << s;
    nb_bits -= 8;
    if ((bits & 0xff) != 0xff) {
      if ((bits & 0x100) && !buf.empty()) buf.back()++;
      for (; run > 0; --run) buf.push_back((bits & 0x100) ? 0x00 : 0xff);
      buf.push_back(uint8_t(bits & 0xff));
    } else {
      run++;   // a 0xff byte waits for a carry
    }
  }
  int PutBit(int bit, int prob) {
    const int split = (range * prob) >> 8;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    if (range < 127) {
      const int shift = kNorm[range];
      range = kNewRange[range];
      value <<= shift;
      nb_bits += shift;
      if (nb_bits > 0) Flush();
    }
    return bit;
  }
  int PutBitUniform(int bit) {
    const int split = range >> 1;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    if (range < 127) {
      range = kNewRange[range];
      value <<= 1;
      nb_bits += 1;
      if (nb_bits > 0) Flush();
    }
    return bit;
  }
  void PutBits(uint32_t v, int n) {
    for (uint32_t mask = 1u << (n - 1); mask; mask >>= 1)
      PutBitUniform((v & mask) != 0);
  }
  void PutSignedBits(int v, int n) {
    if (!PutBitUniform(v != 0)) return;
    if (v < 0) {
      PutBits(uint32_t((-v) << 1) | 1, n + 1);
    } else {
      PutBits(uint32_t(v << 1), n + 1);
    }
  }
  void Finish() {
    PutBits(0, 9 - nb_bits);
    nb_bits = 0;   // pad with zeros
    Flush();
  }
};

// ---------------------------------------------------------------------------
// The encoder's state

constexpr int NUM_MB_SEGMENTS = 4;
constexpr int MAX_ALPHA = 255;               // analysis
constexpr int ALPHA_SCALE = 2 * MAX_ALPHA;
constexpr int MAX_COEFF_THRESH = 31;
constexpr int MAX_INTRA16_MODE = 2;          // the analysis tries DC and TM
constexpr int MAX_UV_MODE = 2;
constexpr int MAX_ITERS_K_MEANS = 6;
constexpr int MAX_VARIABLE_LEVEL = 67;
constexpr int NUM_TYPES = 4, NUM_BANDS = 8, NUM_CTX = 3, NUM_PROBAS = 11;
constexpr int FLATNESS_LIMIT_I16 = 0;
constexpr int FLATNESS_LIMIT_I4 = 3;
constexpr int FLATNESS_LIMIT_UV = 2;
constexpr int FLATNESS_PENALTY = 140;
constexpr int RD_DISTO_MULT = 256;
constexpr int DSHIFT = 4, DSCALE = 1, C1 = 7, C2 = 8;   // UV error diffusion
constexpr uint64_t PARTITION0_SIZE_LIMIT = (uint64_t(1 << 19) - 2048) << 11;

// The configuration PIL's call gives (WebPConfigPreset default, quality
// 80, method 4).
constexpr float kQuality = 80.f;
constexpr int kSegments = 4;
constexpr int kSnsStrength = 50;
constexpr int kFilterStrength = 60;
constexpr int kFilterSharpness = 0;

typedef int64_t score_t;
constexpr score_t MAX_COST = 0x7fffffffffffffLL;

struct SegmentInfo {
  Matrix y1, y2, uv;
  int alpha, beta;
  int quant;
  int fstrength;
  int max_edge;
  int min_disto;
  int lambda_i16, lambda_i4, lambda_uv, lambda_mode, tlambda;
};

struct MBInfo {
  uint8_t type;       // 0 = I4, 1 = I16
  uint8_t uv_mode;
  uint8_t skip;
  uint8_t segment;
  uint8_t alpha;
};

struct ModeScore {
  score_t D, SD, H, R, score;
  int16_t y_dc_levels[16];
  int16_t y_ac_levels[16][16];
  int16_t uv_levels[4 + 4][16];
  int mode_i16;
  uint8_t modes_i4[16];
  int mode_uv;
  uint32_t nz;
  int8_t derr[2][3];
};

struct Histogram {
  int max_value;
  int last_non_zero;
};

struct Residual {
  int first;
  int last;
  const int16_t* coeffs;
  int coeff_type;
};

struct Encoder;

// VP8EncIterator
struct Iterator {
  Encoder* enc;
  int x, y;
  uint8_t yuv_mem[4 * 16 * BPS + PRED_SIZE];
  uint8_t* yuv_in;
  uint8_t* yuv_out;
  uint8_t* yuv_out2;
  uint8_t* yuv_p;
  uint8_t left_mem[64];
  uint8_t* y_left;
  uint8_t* u_left;
  uint8_t* v_left;
  uint8_t* y_top;
  uint8_t* uv_top;
  uint8_t i4_boundary[40];
  uint8_t* i4_top;
  int i4;
  int top_nz[9];
  int left_nz[9];
  uint32_t* nz;
  uint8_t* preds;
  MBInfo* mb;
  int8_t left_derr[2][2];
  int count_down;
};

struct Encoder {
  const Picture* pic;
  int mb_w, mb_h, preds_w;
  int num_segments;
  bool update_map;
  int64_t segment_size;
  int filter_level;
  SegmentInfo dqm[NUM_MB_SEGMENTS];
  int base_quant;
  int dq_uv_ac, dq_uv_dc;
  int uv_alpha;
  int max_i4_header_bits;
  // probabilities
  uint8_t segments_proba[3];
  uint8_t coeffs[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  uint32_t stats[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  uint16_t level_cost[NUM_TYPES][NUM_BANDS][NUM_CTX][MAX_VARIABLE_LEVEL + 1];
  bool dirty;
  std::vector<MBInfo> mb_info;
  std::vector<uint8_t> preds_mem;
  uint8_t* preds;
  std::vector<uint32_t> nz_mem;
  uint32_t* nz;
  std::vector<uint8_t> y_top_mem;   // luma tops, then U/V tops
  uint8_t* y_top;
  uint8_t* uv_top;
  std::vector<int8_t> top_derr;      // [mb_w][2][2]
  std::vector<uint16_t> tokens;
  BitWriter bw, part;
};

inline int Clip(int v, int m, int M) { return v < m ? m : v > M ? M : v; }

inline int BitCost(int bit, uint8_t proba) {
  return !bit ? kEntropyCost[proba] : kEntropyCost[255 - proba];
}

// ---------------------------------------------------------------------------
// The iterator (iterator_enc.c)

void InitLeft(Iterator* it) {
  it->y_left[-1] = it->u_left[-1] = it->v_left[-1] = (it->y > 0) ? 129 : 127;
  std::memset(it->y_left, 129, 16);
  std::memset(it->u_left, 129, 8);
  std::memset(it->v_left, 129, 8);
  it->left_nz[8] = 0;
  std::memset(it->left_derr, 0, sizeof(it->left_derr));
}

void SetRow(Iterator* it, int y) {
  Encoder* enc = it->enc;
  it->x = 0;
  it->y = y;
  it->preds = enc->preds + y * 4 * enc->preds_w;
  it->nz = enc->nz;
  it->mb = enc->mb_info.data() + y * enc->mb_w;
  it->y_top = enc->y_top;
  it->uv_top = enc->uv_top;
  InitLeft(it);
}

void IteratorInit(Encoder* enc, Iterator* it) {
  it->enc = enc;
  it->yuv_in = it->yuv_mem;
  it->yuv_out = it->yuv_in + 16 * BPS;
  it->yuv_out2 = it->yuv_out + 16 * BPS;
  it->yuv_p = it->yuv_out2 + 16 * BPS;
  std::memset(it->yuv_mem, 0, sizeof(it->yuv_mem));
  it->y_left = it->left_mem + 1;
  it->u_left = it->y_left + 16 + 16;
  it->v_left = it->u_left + 16;
  SetRow(it, 0);
  it->count_down = enc->mb_w * enc->mb_h;
  std::memset(enc->y_top, 127, size_t(2) * enc->mb_w * 16);
  std::memset(enc->nz, 0, enc->mb_w * sizeof(*enc->nz));
  std::fill(enc->top_derr.begin(), enc->top_derr.end(), 0);
}

bool IteratorNext(Iterator* it) {
  if (++it->x == it->enc->mb_w) {
    SetRow(it, ++it->y);
  } else {
    it->preds += 4;
    it->mb += 1;
    it->nz += 1;
    it->y_top += 16;
    it->uv_top += 16;
  }
  return 0 < --it->count_down;
}

void ImportBlock(const uint8_t* src, int src_stride, uint8_t* dst, int w,
                 int h, int size) {
  int i;
  for (i = 0; i < h; ++i) {
    std::memcpy(dst, src, w);
    if (w < size) std::memset(dst + w, dst[w - 1], size - w);
    dst += BPS;
    src += src_stride;
  }
  for (; i < size; ++i) {
    std::memcpy(dst, dst - BPS, size);
    dst += BPS;
  }
}

void ImportLine(const uint8_t* src, int src_stride, uint8_t* dst, int len,
                int total_len) {
  int i;
  for (i = 0; i < len; ++i, src += src_stride) dst[i] = *src;
  for (; i < total_len; ++i) dst[i] = dst[len - 1];
}

// VP8IteratorImport: the macroblock's source samples; with tmp_32 (the
// analysis pass) also its source top and left edges.
void IteratorImport(Iterator* it, uint8_t* tmp_32) {
  const Picture* pic = it->enc->pic;
  const int x = it->x, y = it->y;
  const uint8_t* ysrc = pic->y.data() + (y * pic->y_stride + x) * 16;
  const uint8_t* usrc = pic->u.data() + (y * pic->uv_stride + x) * 8;
  const uint8_t* vsrc = pic->v.data() + (y * pic->uv_stride + x) * 8;
  const int w = std::min(pic->width - x * 16, 16);
  const int h = std::min(pic->height - y * 16, 16);
  const int uv_w = (w + 1) >> 1;
  const int uv_h = (h + 1) >> 1;
  ImportBlock(ysrc, pic->y_stride, it->yuv_in + Y_OFF, w, h, 16);
  ImportBlock(usrc, pic->uv_stride, it->yuv_in + U_OFF, uv_w, uv_h, 8);
  ImportBlock(vsrc, pic->uv_stride, it->yuv_in + U_OFF + 8, uv_w, uv_h, 8);
  if (tmp_32 == nullptr) return;
  if (x == 0) {
    InitLeft(it);
  } else {
    if (y == 0) {
      it->y_left[-1] = it->u_left[-1] = it->v_left[-1] = 127;
    } else {
      it->y_left[-1] = ysrc[-1 - pic->y_stride];
      it->u_left[-1] = usrc[-1 - pic->uv_stride];
      it->v_left[-1] = vsrc[-1 - pic->uv_stride];
    }
    ImportLine(ysrc - 1, pic->y_stride, it->y_left, h, 16);
    ImportLine(usrc - 1, pic->uv_stride, it->u_left, uv_h, 8);
    ImportLine(vsrc - 1, pic->uv_stride, it->v_left, uv_h, 8);
  }
  it->y_top = tmp_32 + 0;
  it->uv_top = tmp_32 + 16;
  if (y == 0) {
    std::memset(tmp_32, 127, 32);
  } else {
    ImportLine(ysrc - pic->y_stride, 1, tmp_32, w, 16);
    ImportLine(usrc - pic->uv_stride, 1, tmp_32 + 16, uv_w, 8);
    ImportLine(vsrc - pic->uv_stride, 1, tmp_32 + 16 + 8, uv_w, 8);
  }
}

void NzToBytes(Iterator* it) {
  const uint32_t tnz = it->nz[0], lnz = it->nz[-1];
  int* top = it->top_nz;
  int* left = it->left_nz;
  auto bit = [](uint32_t nz, int n) { return int((nz >> n) & 1); };
  top[0] = bit(tnz, 12);
  top[1] = bit(tnz, 13);
  top[2] = bit(tnz, 14);
  top[3] = bit(tnz, 15);
  top[4] = bit(tnz, 18);
  top[5] = bit(tnz, 19);
  top[6] = bit(tnz, 22);
  top[7] = bit(tnz, 23);
  top[8] = bit(tnz, 24);
  left[0] = bit(lnz, 3);
  left[1] = bit(lnz, 7);
  left[2] = bit(lnz, 11);
  left[3] = bit(lnz, 15);
  left[4] = bit(lnz, 17);
  left[5] = bit(lnz, 19);
  left[6] = bit(lnz, 21);
  left[7] = bit(lnz, 23);
}

void BytesToNz(Iterator* it) {
  uint32_t nz = 0;
  const int* top = it->top_nz;
  const int* left = it->left_nz;
  nz |= (top[0] << 12) | (top[1] << 13);
  nz |= (top[2] << 14) | (top[3] << 15);
  nz |= (top[4] << 18) | (top[5] << 19);
  nz |= (top[6] << 22) | (top[7] << 23);
  nz |= (top[8] << 24);
  nz |= (left[0] << 3) | (left[1] << 7);
  nz |= (left[2] << 11);
  nz |= (left[4] << 17) | (left[6] << 21);
  *it->nz = nz;
}

void SaveBoundary(Iterator* it) {
  Encoder* enc = it->enc;
  const uint8_t* ysrc = it->yuv_out + Y_OFF;
  const uint8_t* uvsrc = it->yuv_out + U_OFF;
  if (it->x < enc->mb_w - 1) {
    for (int i = 0; i < 16; ++i) it->y_left[i] = ysrc[15 + i * BPS];
    for (int i = 0; i < 8; ++i) {
      it->u_left[i] = uvsrc[7 + i * BPS];
      it->v_left[i] = uvsrc[15 + i * BPS];
    }
    it->y_left[-1] = it->y_top[15];
    it->u_left[-1] = it->uv_top[0 + 7];
    it->v_left[-1] = it->uv_top[8 + 7];
  }
  if (it->y < enc->mb_h - 1) {
    std::memcpy(it->y_top, ysrc + 15 * BPS, 16);
    std::memcpy(it->uv_top, uvsrc + 7 * BPS, 8 + 8);
  }
}

constexpr uint8_t kTopLeftI4[16] = {17, 21, 25, 29, 13, 17, 21, 25,
                                    9,  13, 17, 21, 5,  9,  13, 17};

void StartI4(Iterator* it) {
  it->i4 = 0;
  it->i4_top = it->i4_boundary + kTopLeftI4[0];
  for (int i = 0; i < 17; ++i) it->i4_boundary[i] = it->y_left[15 - i];
  for (int i = 0; i < 16; ++i) it->i4_boundary[17 + i] = it->y_top[i];
  if (it->x < it->enc->mb_w - 1) {
    for (int i = 16; i < 16 + 4; ++i) it->i4_boundary[17 + i] = it->y_top[i];
  } else {   // the far right: the last sample four times
    for (int i = 16; i < 16 + 4; ++i)
      it->i4_boundary[17 + i] = it->i4_boundary[17 + 15];
  }
  NzToBytes(it);
}

bool RotateI4(Iterator* it, const uint8_t* yuv_out) {
  const uint8_t* blk = yuv_out + kScan[it->i4];
  uint8_t* top = it->i4_top;
  for (int i = 0; i <= 3; ++i) top[-4 + i] = blk[i + 3 * BPS];
  if ((it->i4 & 3) != 3) {
    for (int i = 0; i <= 2; ++i) top[i] = blk[3 + (2 - i) * BPS];
  } else {
    for (int i = 0; i <= 3; ++i) top[i] = top[i + 4];
  }
  ++it->i4;
  if (it->i4 == 16) return false;
  it->i4_top = it->i4_boundary + kTopLeftI4[it->i4];
  return true;
}

void SetIntra16Mode(Iterator* it, int mode) {
  uint8_t* preds = it->preds;
  for (int y = 0; y < 4; ++y) {
    std::memset(preds, mode, 4);
    preds += it->enc->preds_w;
  }
  it->mb->type = 1;
}

void SetIntra4Mode(Iterator* it, const uint8_t* modes) {
  uint8_t* preds = it->preds;
  for (int y = 4; y > 0; --y) {
    std::memcpy(preds, modes, 4);
    preds += it->enc->preds_w;
    modes += 4;
  }
  it->mb->type = 0;
}

void MakeLuma16Preds(Iterator* it) {
  Intra16Preds(it->yuv_p, it->x ? it->y_left : nullptr,
               it->y ? it->y_top : nullptr);
}

void MakeChroma8Preds(Iterator* it) {
  IntraChromaPreds(it->yuv_p, it->x ? it->u_left : nullptr,
                   it->y ? it->uv_top : nullptr);
}

// ---------------------------------------------------------------------------
// Stage 2: analysis (analysis_enc.c)

void CollectHistogram(const uint8_t* ref, const uint8_t* pred,
                      int start_block, int end_block, Histogram* histo) {
  static const int kDspScan[16 + 4 + 4] = {
      0,        4,            8,            12,
      4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
      8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
      12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS,
      0,        4,            4 * BPS,      4 + 4 * BPS,
      8,        12,           8 + 4 * BPS,  12 + 4 * BPS};
  int distribution[MAX_COEFF_THRESH + 1] = {0};
  for (int j = start_block; j < end_block; ++j) {
    int16_t out[16];
    FTransform(ref + kDspScan[j], pred + kDspScan[j], out);
    for (int k = 0; k < 16; ++k) {
      const int v = std::abs(out[k]) >> 3;
      ++distribution[v > MAX_COEFF_THRESH ? MAX_COEFF_THRESH : v];
    }
  }
  int max_value = 0, last_non_zero = 1;
  for (int k = 0; k <= MAX_COEFF_THRESH; ++k) {
    const int value = distribution[k];
    if (value > 0) {
      if (value > max_value) max_value = value;
      last_non_zero = k;
    }
  }
  histo->max_value = max_value;
  histo->last_non_zero = last_non_zero;
}

int GetAlpha(const Histogram& histo) {
  return (histo.max_value > 1)
             ? ALPHA_SCALE * histo.last_non_zero / histo.max_value
             : 0;
}

int MBAnalyzeBestIntra16Mode(Iterator* it) {
  int best_alpha = -1;
  int best_mode = 0;
  MakeLuma16Preds(it);
  for (int mode = 0; mode < MAX_INTRA16_MODE; ++mode) {
    Histogram histo;
    CollectHistogram(it->yuv_in + Y_OFF, it->yuv_p + kI16ModeOffsets[mode], 0,
                     16, &histo);
    const int alpha = GetAlpha(histo);
    if (alpha > best_alpha) {
      best_alpha = alpha;
      best_mode = mode;
    }
  }
  SetIntra16Mode(it, best_mode);
  return best_alpha;
}

int MBAnalyzeBestUVMode(Iterator* it) {
  int best_alpha = -1;
  int smallest_alpha = 0;
  int best_mode = 0;
  MakeChroma8Preds(it);
  for (int mode = 0; mode < MAX_UV_MODE; ++mode) {
    Histogram histo;
    CollectHistogram(it->yuv_in + U_OFF, it->yuv_p + kUVModeOffsets[mode], 16,
                     16 + 4 + 4, &histo);
    const int alpha = GetAlpha(histo);
    if (alpha > best_alpha) best_alpha = alpha;
    if (mode == 0 || alpha < smallest_alpha) {
      smallest_alpha = alpha;
      best_mode = mode;
    }
  }
  it->mb->uv_mode = uint8_t(best_mode);
  return best_alpha;
}

void AssignSegments(Encoder* enc, const int alphas[MAX_ALPHA + 1]) {
  const int nb = enc->num_segments;
  int centers[NUM_MB_SEGMENTS];
  int weighted_average = 0;
  int map[MAX_ALPHA + 1];
  int accum[NUM_MB_SEGMENTS], dist_accum[NUM_MB_SEGMENTS];
  int n;
  for (n = 0; n <= MAX_ALPHA && alphas[n] == 0; ++n) {}
  const int min_a = n;
  for (n = MAX_ALPHA; n > min_a && alphas[n] == 0; --n) {}
  const int max_a = n;
  const int range_a = max_a - min_a;
  for (int k = 0, m = 1; k < nb; ++k, m += 2)
    centers[k] = min_a + (m * range_a) / (2 * nb);
  for (int k = 0; k < MAX_ITERS_K_MEANS; ++k) {
    for (n = 0; n < nb; ++n) accum[n] = dist_accum[n] = 0;
    n = 0;
    for (int a = min_a; a <= max_a; ++a) {
      if (alphas[a]) {
        while (n + 1 < nb && std::abs(a - centers[n + 1]) <
                                 std::abs(a - centers[n])) {
          n++;
        }
        map[a] = n;
        dist_accum[n] += a * alphas[a];
        accum[n] += alphas[a];
      }
    }
    int displaced = 0;
    int total_weight = 0;
    weighted_average = 0;
    for (n = 0; n < nb; ++n) {
      if (accum[n]) {
        const int new_center = (dist_accum[n] + accum[n] / 2) / accum[n];
        displaced += std::abs(centers[n] - new_center);
        centers[n] = new_center;
        weighted_average += new_center * accum[n];
        total_weight += accum[n];
      }
    }
    weighted_average = (weighted_average + total_weight / 2) / total_weight;
    if (displaced < 5) break;
  }
  for (MBInfo& mb : enc->mb_info) {
    mb.segment = uint8_t(map[mb.alpha]);
    mb.alpha = uint8_t(centers[map[mb.alpha]]);
  }
  // SetSegmentAlphas
  int mn = centers[0], mx = centers[0];
  if (nb > 1) {
    for (n = 0; n < nb; ++n) {
      if (mn > centers[n]) mn = centers[n];
      if (mx < centers[n]) mx = centers[n];
    }
  }
  if (mx == mn) mx = mn + 1;
  for (n = 0; n < nb; ++n) {
    const int alpha = 255 * (centers[n] - weighted_average) / (mx - mn);
    const int beta = 255 * (centers[n] - mn) / (mx - mn);
    enc->dqm[n].alpha = Clip(alpha, -127, 127);
    enc->dqm[n].beta = Clip(beta, 0, 255);
  }
}

void Analyze(Encoder* enc) {
  int alphas[MAX_ALPHA + 1] = {0};
  int uv_alpha = 0;
  Iterator it;
  IteratorInit(enc, &it);
  uint8_t scratch[32];
  do {
    IteratorImport(&it, scratch);
    SetIntra16Mode(&it, 0);
    it.mb->skip = 0;
    it.mb->segment = 0;
    int best_alpha = MBAnalyzeBestIntra16Mode(&it);
    const int best_uv_alpha = MBAnalyzeBestUVMode(&it);
    best_alpha = (3 * best_alpha + best_uv_alpha + 2) >> 2;
    best_alpha = Clip(MAX_ALPHA - best_alpha, 0, MAX_ALPHA);
    alphas[best_alpha]++;
    it.mb->alpha = uint8_t(best_alpha);
    uv_alpha += best_uv_alpha;
  } while (IteratorNext(&it));
  enc->uv_alpha = uv_alpha / (enc->mb_w * enc->mb_h);
  AssignSegments(enc, alphas);
}

// ---------------------------------------------------------------------------
// Stage 3: segment parameters (quant_enc.c)

constexpr uint8_t kFreqSharpening[16] = {0,  30, 60, 90, 30, 60, 90, 90,
                                         60, 90, 90, 90, 90, 90, 90, 90};
constexpr int SHARPEN_BITS = 11;
constexpr int kBiasMatrices[3][2] = {{96, 110}, {96, 108}, {110, 115}};

int ExpandMatrix(Matrix* m, int type) {
  for (int i = 0; i < 2; ++i) {
    const int bias = kBiasMatrices[type][i > 0];
    m->iq[i] = uint16_t((1 << QFIX) / m->q[i]);
    m->bias[i] = uint32_t(bias << (QFIX - 8));
    m->zthresh[i] = ((1 << QFIX) - 1 - m->bias[i]) / m->iq[i];
  }
  for (int i = 2; i < 16; ++i) {
    m->q[i] = m->q[1];
    m->iq[i] = m->iq[1];
    m->bias[i] = m->bias[1];
    m->zthresh[i] = m->zthresh[1];
  }
  int sum = 0;
  for (int i = 0; i < 16; ++i) {
    m->sharpen[i] = (type == 0)
                        ? uint16_t((kFreqSharpening[i] * m->q[i]) >> SHARPEN_BITS)
                        : 0;
    sum += m->q[i];
  }
  return (sum + 8) >> 4;
}

void SetupMatrices(Encoder* enc) {
  const int tlambda_scale = kSnsStrength;   // method >= 4
  for (int i = 0; i < enc->num_segments; ++i) {
    SegmentInfo* m = &enc->dqm[i];
    const int q = m->quant;
    m->y1.q[0] = kDcTable[Clip(q, 0, 127)];
    m->y1.q[1] = kAcTable[Clip(q, 0, 127)];
    m->y2.q[0] = uint16_t(kDcTable[Clip(q, 0, 127)] * 2);
    m->y2.q[1] = kAcTable2[Clip(q, 0, 127)];
    m->uv.q[0] = kDcTable[Clip(q + enc->dq_uv_dc, 0, 117)];
    m->uv.q[1] = kAcTable[Clip(q + enc->dq_uv_ac, 0, 127)];
    const int q_i4 = ExpandMatrix(&m->y1, 0);
    const int q_i16 = ExpandMatrix(&m->y2, 1);
    const int q_uv = ExpandMatrix(&m->uv, 2);
    m->lambda_i4 = std::max(1, (3 * q_i4 * q_i4) >> 7);
    m->lambda_i16 = std::max(1, 3 * q_i16 * q_i16);
    m->lambda_uv = std::max(1, (3 * q_uv * q_uv) >> 6);
    m->lambda_mode = std::max(1, (1 * q_i4 * q_i4) >> 7);
    m->tlambda = std::max(1, (tlambda_scale * q_i4) >> 5);
    m->min_disto = 20 * m->y1.q[0];
    m->max_edge = 0;
  }
}

// VP8FilterStrengthFromDelta at sharpness 0: kLevelsFromDelta[0][delta],
// which is delta itself, up to 63.
inline int FilterStrengthFromDelta(int delta) { return delta < 63 ? delta : 63; }

void SetupFilterStrength(Encoder* enc) {
  const int level0 = 5 * kFilterStrength;
  for (int i = 0; i < NUM_MB_SEGMENTS; ++i) {
    SegmentInfo* m = &enc->dqm[i];
    const int qstep = kAcTable[Clip(m->quant, 0, 127)] >> 2;
    const int base_strength = FilterStrengthFromDelta(qstep);
    const int f = base_strength * level0 / (256 + m->beta);
    m->fstrength = (f < 2) ? 0 : (f > 63) ? 63 : f;
  }
  enc->filter_level = enc->dqm[0].fstrength;
}

void SimplifySegments(Encoder* enc) {
  int map[NUM_MB_SEGMENTS] = {0, 1, 2, 3};
  const int num_segments = enc->num_segments;
  int num_final_segments = 1;
  for (int s1 = 1; s1 < num_segments; ++s1) {
    const SegmentInfo& S1 = enc->dqm[s1];
    bool found = false;
    int s2;
    for (s2 = 0; s2 < num_final_segments; ++s2) {
      const SegmentInfo& S2 = enc->dqm[s2];
      if (S1.quant == S2.quant && S1.fstrength == S2.fstrength) {
        found = true;
        break;
      }
    }
    map[s1] = s2;
    if (!found) {
      if (num_final_segments != s1)
        enc->dqm[num_final_segments] = enc->dqm[s1];
      ++num_final_segments;
    }
  }
  if (num_final_segments < num_segments) {
    for (MBInfo& mb : enc->mb_info) mb.segment = uint8_t(map[mb.segment]);
    enc->num_segments = num_final_segments;
    for (int i = num_final_segments; i < num_segments; ++i)
      enc->dqm[i] = enc->dqm[num_final_segments - 1];
  }
}

void SetSegmentParams(Encoder* enc, float quality) {
  const int num_segments = enc->num_segments;
  const double amp = 0.9 * kSnsStrength / 100. / 128.;
  const double Q = quality / 100.;
  const double linear_c = (Q < 0.75) ? Q * (2. / 3.) : 2. * Q - 1.;
  const double c_base = std::pow(linear_c, 1 / 3.);
  for (int i = 0; i < num_segments; ++i) {
    const double expn = 1. - amp * enc->dqm[i].alpha;
    const double c = std::pow(c_base, expn);
    const int q = int(127. * (1. - c));
    enc->dqm[i].quant = Clip(q, 0, 127);
  }
  enc->base_quant = enc->dqm[0].quant;
  for (int i = num_segments; i < NUM_MB_SEGMENTS; ++i)
    enc->dqm[i].quant = enc->base_quant;
  // MID_ALPHA 64, MIN_ALPHA 30, MAX_ALPHA 100, dq_uv in [-4, 6]
  int dq_uv_ac = (enc->uv_alpha - 64) * (6 - (-4)) / (100 - 30);
  dq_uv_ac = dq_uv_ac * kSnsStrength / 100;
  enc->dq_uv_ac = Clip(dq_uv_ac, -4, 6);
  enc->dq_uv_dc = Clip(-4 * kSnsStrength / 100, -15, 15);
  SetupFilterStrength(enc);
  if (num_segments > 1) SimplifySegments(enc);
  SetupMatrices(enc);
}

int GetProba(int a, int b) {
  const int total = a + b;
  return (total == 0) ? 255 : (255 * a + total / 2) / total;
}

void SetSegmentProbas(Encoder* enc) {
  int p[NUM_MB_SEGMENTS] = {0};
  for (const MBInfo& mb : enc->mb_info) ++p[mb.segment];
  if (enc->num_segments > 1) {
    uint8_t* probas = enc->segments_proba;
    probas[0] = uint8_t(GetProba(p[0] + p[1], p[2] + p[3]));
    probas[1] = uint8_t(GetProba(p[0], p[1]));
    probas[2] = uint8_t(GetProba(p[2], p[3]));
    enc->update_map =
        (probas[0] != 255) || (probas[1] != 255) || (probas[2] != 255);
    if (!enc->update_map)
      for (MBInfo& mb : enc->mb_info) mb.segment = 0;
    enc->segment_size =
        int64_t(p[0]) * (BitCost(0, probas[0]) + BitCost(0, probas[1])) +
        int64_t(p[1]) * (BitCost(0, probas[0]) + BitCost(1, probas[1])) +
        int64_t(p[2]) * (BitCost(1, probas[0]) + BitCost(0, probas[2])) +
        int64_t(p[3]) * (BitCost(1, probas[0]) + BitCost(1, probas[2]));
  } else {
    enc->update_map = false;
    enc->segment_size = 0;
  }
}

// ---------------------------------------------------------------------------
// Costs (cost_enc.c, dsp/cost.c)

void CalculateLevelCosts(Encoder* enc) {
  if (!enc->dirty) return;
  for (int ctype = 0; ctype < NUM_TYPES; ++ctype) {
    for (int band = 0; band < NUM_BANDS; ++band) {
      for (int ctx = 0; ctx < NUM_CTX; ++ctx) {
        const uint8_t* p = enc->coeffs[ctype][band][ctx];
        uint16_t* table = enc->level_cost[ctype][band][ctx];
        const int cost0 = (ctx > 0) ? BitCost(1, p[0]) : 0;
        const int cost_base = BitCost(1, p[1]) + cost0;
        table[0] = uint16_t(BitCost(0, p[1]) + cost0);
        for (int v = 1; v <= MAX_VARIABLE_LEVEL; ++v) {
          int pattern = kLevelCodes[v - 1][0];
          int bits = kLevelCodes[v - 1][1];
          int cost = 0;
          for (int i = 2; pattern; ++i) {
            if (pattern & 1) cost += BitCost(bits & 1, p[i]);
            bits >>= 1;
            pattern >>= 1;
          }
          table[v] = uint16_t(cost_base + cost);
        }
      }
    }
  }
  enc->dirty = false;
}

inline int LevelCost(const uint16_t* table, int level) {
  return kLevelFixedCosts[level] +
         table[(level > MAX_VARIABLE_LEVEL) ? MAX_VARIABLE_LEVEL : level];
}

void SetResidualCoeffs(const int16_t* coeffs, Residual* res) {
  res->last = -1;
  for (int n = 15; n >= 0; --n) {
    if (coeffs[n]) {
      res->last = n;
      break;
    }
  }
  res->coeffs = coeffs;
}

int GetResidualCost(const Encoder* enc, int ctx0, const Residual& res) {
  int n = res.first;
  const int t_ = res.coeff_type;
  const int p0 = enc->coeffs[t_][n][ctx0][0];
  const uint16_t* t = enc->level_cost[t_][kBands[n]][ctx0];
  int cost = (ctx0 == 0) ? BitCost(1, uint8_t(p0)) : 0;
  if (res.last < 0) return BitCost(0, uint8_t(p0));
  for (; n < res.last; ++n) {
    const int v = std::abs(res.coeffs[n]);
    const int ctx = (v >= 2) ? 2 : v;
    cost += LevelCost(t, v);
    t = enc->level_cost[t_][kBands[n + 1]][ctx];
  }
  {
    const int v = std::abs(res.coeffs[n]);
    cost += LevelCost(t, v);
    if (n < 15) {
      const int b = kBands[n + 1];
      const int ctx = (v == 1) ? 1 : 2;
      cost += BitCost(0, enc->coeffs[t_][b][ctx][0]);
    }
  }
  return cost;
}

int GetCostLuma4(Iterator* it, const int16_t levels[16]) {
  const int x = it->i4 & 3, y = it->i4 >> 2;
  Residual res = {0, -1, nullptr, 3};
  SetResidualCoeffs(levels, &res);
  return GetResidualCost(it->enc, it->top_nz[x] + it->left_nz[y], res);
}

int GetCostLuma16(Iterator* it, const ModeScore& rd) {
  NzToBytes(it);
  Residual res = {0, -1, nullptr, 1};
  SetResidualCoeffs(rd.y_dc_levels, &res);
  int R = GetResidualCost(it->enc, it->top_nz[8] + it->left_nz[8], res);
  res = {1, -1, nullptr, 0};
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) {
      const int ctx = it->top_nz[x] + it->left_nz[y];
      SetResidualCoeffs(rd.y_ac_levels[x + y * 4], &res);
      R += GetResidualCost(it->enc, ctx, res);
      it->top_nz[x] = it->left_nz[y] = (res.last >= 0);
    }
  }
  return R;
}

int GetCostUV(Iterator* it, const ModeScore& rd) {
  NzToBytes(it);
  Residual res = {0, -1, nullptr, 2};
  int R = 0;
  for (int ch = 0; ch <= 2; ch += 2) {
    for (int y = 0; y < 2; ++y) {
      for (int x = 0; x < 2; ++x) {
        const int ctx = it->top_nz[4 + ch + x] + it->left_nz[4 + ch + y];
        SetResidualCoeffs(rd.uv_levels[ch * 2 + x + y * 2], &res);
        R += GetResidualCost(it->enc, ctx, res);
        it->top_nz[4 + ch + x] = it->left_nz[4 + ch + y] = (res.last >= 0);
      }
    }
  }
  return R;
}

// ---------------------------------------------------------------------------
// Stage 4: mode decision (quant_enc.c at RD_OPT_BASIC)

void InitScore(ModeScore* rd) {
  rd->D = rd->SD = rd->R = rd->H = 0;
  rd->nz = 0;
  rd->score = MAX_COST;
}

void CopyScore(ModeScore* dst, const ModeScore* src) {
  dst->D = src->D;
  dst->SD = src->SD;
  dst->R = src->R;
  dst->H = src->H;
  dst->nz = src->nz;
  dst->score = src->score;
}

void AddScore(ModeScore* dst, const ModeScore* src) {
  dst->D += src->D;
  dst->SD += src->SD;
  dst->R += src->R;
  dst->H += src->H;
  dst->nz |= src->nz;
  dst->score += src->score;
}

inline void SetRDScore(int lambda, ModeScore* rd) {
  rd->score = (rd->R + rd->H) * lambda + RD_DISTO_MULT * (rd->D + rd->SD);
}

inline int Mult8B(int a, int b) { return (a * b + 128) >> 8; }

bool IsFlat(const int16_t* levels, int num_blocks, int thresh) {
  int score = 0;
  while (num_blocks-- > 0) {
    for (int i = 1; i < 16; ++i) {
      score += (levels[i] != 0);
      if (score > thresh) return false;
    }
    levels += 16;
  }
  return true;
}

bool IsFlatSource16(const uint8_t* src) {
  for (int i = 0; i < 16; ++i) {
    for (int x = 0; x < 16; ++x)
      if (src[x] != src[-i * BPS]) return false;
    src += BPS;
  }
  return true;
}

void SwapOut(Iterator* it) { std::swap(it->yuv_out, it->yuv_out2); }

int ReconstructIntra16(Iterator* it, ModeScore* rd, uint8_t* yuv_out,
                       int mode) {
  const uint8_t* ref = it->yuv_p + kI16ModeOffsets[mode];
  const uint8_t* src = it->yuv_in + Y_OFF;
  const SegmentInfo& dqm = it->enc->dqm[it->mb->segment];
  int nz = 0;
  int16_t tmp[16][16], dc_tmp[16];
  for (int n = 0; n < 16; n += 2)
    FTransform2(src + kScan[n], ref + kScan[n], tmp[n]);
  FTransformWHT(tmp[0], dc_tmp);
  nz |= QuantizeBlock(dc_tmp, rd->y_dc_levels, dqm.y2) << 24;
  for (int n = 0; n < 16; n += 2) {
    tmp[n][0] = tmp[n + 1][0] = 0;
    nz |= Quantize2Blocks(tmp[n], rd->y_ac_levels[n], dqm.y1) << n;
  }
  TransformWHT(dc_tmp, tmp[0]);
  for (int n = 0; n < 16; n += 2)
    ITransform(ref + kScan[n], tmp[n], yuv_out + kScan[n], true);
  return nz;
}

int ReconstructIntra4(Iterator* it, int16_t levels[16], const uint8_t* src,
                      uint8_t* yuv_out, int mode) {
  const uint8_t* ref = it->yuv_p + kI4ModeOffsets[mode];
  const SegmentInfo& dqm = it->enc->dqm[it->mb->segment];
  int16_t tmp[16];
  FTransform(src, ref, tmp);
  const int nz = QuantizeBlock(tmp, levels, dqm.y1);
  ITransform(ref, tmp, yuv_out, false);
  return nz;
}

int QuantizeSingle(int16_t* v, const Matrix& mtx) {
  int V = *v;
  const bool sign = V < 0;
  if (sign) V = -V;
  if (V > int(mtx.zthresh[0])) {
    const int qV = QuantDiv(uint32_t(V), mtx.iq[0], mtx.bias[0]) * mtx.q[0];
    const int err = V - qV;
    *v = int16_t(sign ? -qV : qV);
    return (sign ? -err : err) >> DSCALE;
  }
  *v = 0;
  return (sign ? -V : V) >> DSCALE;
}

void CorrectDCValues(Iterator* it, const Matrix& mtx, int16_t tmp[][16],
                     ModeScore* rd) {
  for (int ch = 0; ch <= 1; ++ch) {
    const int8_t* top = &it->enc->top_derr[(it->x * 2 + ch) * 2];
    const int8_t* left = it->left_derr[ch];
    int16_t(*c)[16] = &tmp[ch * 4];
    c[0][0] += int16_t((C1 * top[0] + C2 * left[0]) >> (DSHIFT - DSCALE));
    const int err0 = QuantizeSingle(&c[0][0], mtx);
    c[1][0] += int16_t((C1 * top[1] + C2 * err0) >> (DSHIFT - DSCALE));
    const int err1 = QuantizeSingle(&c[1][0], mtx);
    c[2][0] += int16_t((C1 * err0 + C2 * left[1]) >> (DSHIFT - DSCALE));
    const int err2 = QuantizeSingle(&c[2][0], mtx);
    c[3][0] += int16_t((C1 * err1 + C2 * err2) >> (DSHIFT - DSCALE));
    const int err3 = QuantizeSingle(&c[3][0], mtx);
    rd->derr[ch][0] = int8_t(err1);
    rd->derr[ch][1] = int8_t(err2);
    rd->derr[ch][2] = int8_t(err3);
  }
}

void StoreDiffusionErrors(Iterator* it, const ModeScore* rd) {
  for (int ch = 0; ch <= 1; ++ch) {
    int8_t* top = &it->enc->top_derr[(it->x * 2 + ch) * 2];
    int8_t* left = it->left_derr[ch];
    left[0] = rd->derr[ch][0];
    left[1] = int8_t((3 * rd->derr[ch][2]) >> 2);
    top[0] = rd->derr[ch][1];
    top[1] = int8_t(rd->derr[ch][2] - left[1]);
  }
}

int ReconstructUV(Iterator* it, ModeScore* rd, uint8_t* yuv_out, int mode) {
  const uint8_t* ref = it->yuv_p + kUVModeOffsets[mode];
  const uint8_t* src = it->yuv_in + U_OFF;
  const SegmentInfo& dqm = it->enc->dqm[it->mb->segment];
  int nz = 0;
  int16_t tmp[8][16];
  for (int n = 0; n < 8; n += 2)
    FTransform2(src + kScanUV[n], ref + kScanUV[n], tmp[n]);
  CorrectDCValues(it, dqm.uv, tmp, rd);
  for (int n = 0; n < 8; n += 2)
    nz |= Quantize2Blocks(tmp[n], rd->uv_levels[n], dqm.uv) << n;
  for (int n = 0; n < 8; n += 2)
    ITransform(ref + kScanUV[n], tmp[n], yuv_out + kScanUV[n], true);
  return nz << 16;
}

void StoreMaxDelta(SegmentInfo* dqm, const int16_t DCs[16]) {
  const int v0 = std::abs(DCs[1]);
  const int v1 = std::abs(DCs[2]);
  const int v2 = std::abs(DCs[4]);
  int max_v = (v1 > v0) ? v1 : v0;
  max_v = (v2 > max_v) ? v2 : max_v;
  if (max_v > dqm->max_edge) dqm->max_edge = max_v;
}

void PickBestIntra16(Iterator* it, ModeScore* rd) {
  SegmentInfo* dqm = &it->enc->dqm[it->mb->segment];
  const int lambda = dqm->lambda_i16;
  const int tlambda = dqm->tlambda;
  const uint8_t* src = it->yuv_in + Y_OFF;
  ModeScore rd_tmp;
  ModeScore* rd_cur = &rd_tmp;
  ModeScore* rd_best = rd;
  bool is_flat = IsFlatSource16(src);
  rd->mode_i16 = -1;
  for (int mode = 0; mode < 4; ++mode) {
    uint8_t* tmp_dst = it->yuv_out2 + Y_OFF;
    rd_cur->mode_i16 = mode;
    rd_cur->nz = uint32_t(ReconstructIntra16(it, rd_cur, tmp_dst, mode));
    rd_cur->D = SSE(src, tmp_dst, 16, 16);
    rd_cur->SD = tlambda ? Mult8B(tlambda, Disto16x16(src, tmp_dst, kWeightY))
                         : 0;
    rd_cur->H = kFixedCostsI16[mode];
    rd_cur->R = GetCostLuma16(it, *rd_cur);
    if (is_flat) {
      is_flat = IsFlat(rd_cur->y_ac_levels[0], 16, FLATNESS_LIMIT_I16);
      if (is_flat) {
        rd_cur->D *= 2;
        rd_cur->SD *= 2;
      }
    }
    SetRDScore(lambda, rd_cur);
    if (mode == 0 || rd_cur->score < rd_best->score) {
      std::swap(rd_cur, rd_best);
      SwapOut(it);
    }
  }
  if (rd_best != rd) std::memcpy(rd, rd_best, sizeof(*rd));
  SetRDScore(dqm->lambda_mode, rd);
  SetIntra16Mode(it, rd->mode_i16);
  if ((rd->nz & 0x100ffff) == 0x1000000 && rd->D > dqm->min_disto)
    StoreMaxDelta(dqm, rd->y_dc_levels);
}

const uint16_t* GetCostModeI4(Iterator* it, const uint8_t modes[16]) {
  const int preds_w = it->enc->preds_w;
  const int x = it->i4 & 3, y = it->i4 >> 2;
  const int left = (x == 0) ? it->preds[y * preds_w - 1] : modes[it->i4 - 1];
  const int top = (y == 0) ? it->preds[-preds_w + x] : modes[it->i4 - 4];
  return kFixedCostsI4[top][left];
}

bool PickBestIntra4(Iterator* it, ModeScore* rd) {
  Encoder* enc = it->enc;
  const SegmentInfo& dqm = enc->dqm[it->mb->segment];
  const int lambda = dqm.lambda_i4;
  const int tlambda = dqm.tlambda;
  const uint8_t* src0 = it->yuv_in + Y_OFF;
  uint8_t* best_blocks = it->yuv_out2 + Y_OFF;
  int total_header_bits = 0;
  ModeScore rd_best;
  if (enc->max_i4_header_bits == 0) return false;
  InitScore(&rd_best);
  rd_best.H = 211;   // VP8BitCost(0, 145)
  SetRDScore(dqm.lambda_mode, &rd_best);
  StartI4(it);
  do {
    ModeScore rd_i4;
    int best_mode = -1;
    const uint8_t* src = src0 + kScan[it->i4];
    const uint16_t* mode_costs = GetCostModeI4(it, rd->modes_i4);
    uint8_t* best_block = best_blocks + kScan[it->i4];
    uint8_t* tmp_dst = it->yuv_p + I4TMP;
    InitScore(&rd_i4);
    Intra4Preds(it->yuv_p, it->i4_top);
    for (int mode = 0; mode < NUM_BMODES; ++mode) {
      ModeScore rd_tmp;
      int16_t tmp_levels[16];
      rd_tmp.nz = uint32_t(ReconstructIntra4(it, tmp_levels, src, tmp_dst, mode))
                  << it->i4;
      rd_tmp.D = SSE(src, tmp_dst, 4, 4);
      rd_tmp.SD = tlambda ? Mult8B(tlambda, Disto4x4(src, tmp_dst, kWeightY))
                          : 0;
      rd_tmp.H = mode_costs[mode];
      if (mode > 0 && IsFlat(tmp_levels, 1, FLATNESS_LIMIT_I4)) {
        rd_tmp.R = FLATNESS_PENALTY;
      } else {
        rd_tmp.R = 0;
      }
      SetRDScore(lambda, &rd_tmp);
      if (best_mode >= 0 && rd_tmp.score >= rd_i4.score) continue;
      rd_tmp.R += GetCostLuma4(it, tmp_levels);
      SetRDScore(lambda, &rd_tmp);
      if (best_mode < 0 || rd_tmp.score < rd_i4.score) {
        CopyScore(&rd_i4, &rd_tmp);
        best_mode = mode;
        std::swap(tmp_dst, best_block);
        std::memcpy(rd_best.y_ac_levels[it->i4], tmp_levels,
                    sizeof(rd_best.y_ac_levels[it->i4]));
      }
    }
    SetRDScore(dqm.lambda_mode, &rd_i4);
    AddScore(&rd_best, &rd_i4);
    if (rd_best.score >= rd->score) return false;
    total_header_bits += int(rd_i4.H);
    if (total_header_bits > enc->max_i4_header_bits) return false;
    if (best_block != best_blocks + kScan[it->i4]) {
      for (int j = 0; j < 4; ++j)
        std::memcpy(best_blocks + kScan[it->i4] + j * BPS, best_block + j * BPS,
                    4);
    }
    rd->modes_i4[it->i4] = uint8_t(best_mode);
    it->top_nz[it->i4 & 3] = it->left_nz[it->i4 >> 2] = rd_i4.nz ? 1 : 0;
  } while (RotateI4(it, best_blocks));
  CopyScore(rd, &rd_best);
  SetIntra4Mode(it, rd->modes_i4);
  SwapOut(it);
  std::memcpy(rd->y_ac_levels, rd_best.y_ac_levels, sizeof(rd->y_ac_levels));
  return true;
}

void PickBestUV(Iterator* it, ModeScore* rd) {
  const SegmentInfo& dqm = it->enc->dqm[it->mb->segment];
  const int lambda = dqm.lambda_uv;
  const uint8_t* src = it->yuv_in + U_OFF;
  uint8_t* tmp_dst = it->yuv_out2 + U_OFF;
  uint8_t* dst0 = it->yuv_out + U_OFF;
  uint8_t* dst = dst0;
  ModeScore rd_best;
  rd->mode_uv = -1;
  InitScore(&rd_best);
  for (int mode = 0; mode < 4; ++mode) {
    ModeScore rd_uv;
    rd_uv.nz = uint32_t(ReconstructUV(it, &rd_uv, tmp_dst, mode));
    rd_uv.D = SSE(src, tmp_dst, 16, 8);
    rd_uv.SD = 0;
    rd_uv.H = kFixedCostsUV[mode];
    rd_uv.R = GetCostUV(it, rd_uv);
    if (mode > 0 && IsFlat(rd_uv.uv_levels[0], 8, FLATNESS_LIMIT_UV))
      rd_uv.R += FLATNESS_PENALTY * 8;
    SetRDScore(lambda, &rd_uv);
    if (mode == 0 || rd_uv.score < rd_best.score) {
      CopyScore(&rd_best, &rd_uv);
      rd->mode_uv = mode;
      std::memcpy(rd->uv_levels, rd_uv.uv_levels, sizeof(rd->uv_levels));
      std::memcpy(rd->derr, rd_uv.derr, sizeof(rd_uv.derr));
      std::swap(dst, tmp_dst);
    }
  }
  it->mb->uv_mode = uint8_t(rd->mode_uv);
  AddScore(rd, &rd_best);
  if (dst != dst0) {
    for (int j = 0; j < 8; ++j)
      std::memcpy(dst0 + j * BPS, dst + j * BPS, 16);
  }
  StoreDiffusionErrors(it, rd);
}

void Decimate(Iterator* it, ModeScore* rd) {
  InitScore(rd);
  MakeLuma16Preds(it);
  MakeChroma8Preds(it);
  PickBestIntra16(it, rd);
  PickBestIntra4(it, rd);
  PickBestUV(it, rd);
  it->mb->skip = (rd->nz == 0);
}

// ---------------------------------------------------------------------------
// Stage 5: tokens and probabilities (token_enc.c, frame_enc.c)

constexpr uint16_t FIXED_PROBA_BIT = 1u << 14;

inline int TokenId(int t, int b, int ctx) {
  return NUM_PROBAS * (ctx + NUM_CTX * (b + NUM_BANDS * t));
}

inline void RecordStats(int bit, uint32_t* stats) {
  uint32_t p = *stats;
  if (p >= 0xfffe0000u) p = ((p + 1u) >> 1) & 0x7fff7fffu;
  p += 0x00010000u + uint32_t(bit);
  *stats = p;
}

struct TokenRecorder {
  std::vector<uint16_t>* tokens;
  uint32_t (*stats)[NUM_CTX][NUM_PROBAS];
  int AddToken(int bit, int proba_idx, uint32_t* s) {
    tokens->push_back(uint16_t((bit << 15) | proba_idx));
    RecordStats(bit, s);
    return bit;
  }
  void AddConstantToken(int bit, int proba) {
    tokens->push_back(uint16_t((bit << 15) | FIXED_PROBA_BIT | proba));
  }
};

int RecordCoeffTokens(Encoder* enc, int ctx, const Residual& res) {
  TokenRecorder rec = {&enc->tokens, enc->stats[res.coeff_type]};
  const int16_t* coeffs = res.coeffs;
  const int coeff_type = res.coeff_type;
  const int last = res.last;
  int n = res.first;
  int base_id = TokenId(coeff_type, n, ctx);
  uint32_t* s = rec.stats[n][ctx];
  if (!rec.AddToken(last >= 0, base_id + 0, s + 0)) return 0;
  while (n < 16) {
    const int c = coeffs[n++];
    const bool sign = c < 0;
    const uint32_t v = uint32_t(sign ? -c : c);
    if (!rec.AddToken(v != 0, base_id + 1, s + 1)) {
      base_id = TokenId(coeff_type, kBands[n], 0);
      s = rec.stats[kBands[n]][0];
      continue;
    }
    if (!rec.AddToken(v > 1, base_id + 2, s + 2)) {
      base_id = TokenId(coeff_type, kBands[n], 1);
      s = rec.stats[kBands[n]][1];
    } else {
      if (!rec.AddToken(v > 4, base_id + 3, s + 3)) {
        if (rec.AddToken(v != 2, base_id + 4, s + 4))
          rec.AddToken(v == 4, base_id + 5, s + 5);
      } else if (!rec.AddToken(v > 10, base_id + 6, s + 6)) {
        if (!rec.AddToken(v > 6, base_id + 7, s + 7)) {
          rec.AddConstantToken(v == 6, 159);
        } else {
          rec.AddConstantToken(v >= 9, 165);
          rec.AddConstantToken(!(v & 1), 145);
        }
      } else {
        int mask;
        const uint8_t* tab;
        uint32_t residue = v - 3;
        if (residue < (8 << 1)) {
          rec.AddToken(0, base_id + 8, s + 8);
          rec.AddToken(0, base_id + 9, s + 9);
          residue -= (8 << 0);
          mask = 1 << 2;
          tab = kCat3;
        } else if (residue < (8 << 2)) {
          rec.AddToken(0, base_id + 8, s + 8);
          rec.AddToken(1, base_id + 9, s + 9);
          residue -= (8 << 1);
          mask = 1 << 3;
          tab = kCat4;
        } else if (residue < (8 << 3)) {
          rec.AddToken(1, base_id + 8, s + 8);
          rec.AddToken(0, base_id + 10, s + 9);
          residue -= (8 << 2);
          mask = 1 << 4;
          tab = kCat5;
        } else {
          rec.AddToken(1, base_id + 8, s + 8);
          rec.AddToken(1, base_id + 10, s + 9);
          residue -= (8 << 3);
          mask = 1 << 10;
          tab = kCat6;
        }
        while (mask) {
          rec.AddConstantToken((residue & mask) != 0, *tab++);
          mask >>= 1;
        }
      }
      base_id = TokenId(coeff_type, kBands[n], 2);
      s = rec.stats[kBands[n]][2];
    }
    rec.AddConstantToken(sign, 128);
    if (n == 16 || !rec.AddToken(n <= last, base_id + 0, s + 0)) return 1;
  }
  return 1;
}

void RecordTokens(Iterator* it, const ModeScore& rd) {
  Encoder* enc = it->enc;
  Residual res;
  NzToBytes(it);
  if (it->mb->type == 1) {
    const int ctx = it->top_nz[8] + it->left_nz[8];
    res = {0, -1, nullptr, 1};
    SetResidualCoeffs(rd.y_dc_levels, &res);
    it->top_nz[8] = it->left_nz[8] = RecordCoeffTokens(enc, ctx, res);
    res = {1, -1, nullptr, 0};
  } else {
    res = {0, -1, nullptr, 3};
  }
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) {
      const int ctx = it->top_nz[x] + it->left_nz[y];
      SetResidualCoeffs(rd.y_ac_levels[x + y * 4], &res);
      it->top_nz[x] = it->left_nz[y] = RecordCoeffTokens(enc, ctx, res);
    }
  }
  res = {0, -1, nullptr, 2};
  for (int ch = 0; ch <= 2; ch += 2) {
    for (int y = 0; y < 2; ++y) {
      for (int x = 0; x < 2; ++x) {
        const int ctx = it->top_nz[4 + ch + x] + it->left_nz[4 + ch + y];
        SetResidualCoeffs(rd.uv_levels[ch * 2 + x + y * 2], &res);
        it->top_nz[4 + ch + x] = it->left_nz[4 + ch + y] =
            RecordCoeffTokens(enc, ctx, res);
      }
    }
  }
  BytesToNz(it);
}

int BranchCost(int nb, int total, int proba) {
  return nb * BitCost(1, uint8_t(proba)) +
         (total - nb) * BitCost(0, uint8_t(proba));
}

void FinalizeTokenProbas(Encoder* enc) {
  bool has_changed = false;
  for (int t = 0; t < NUM_TYPES; ++t) {
    for (int b = 0; b < NUM_BANDS; ++b) {
      for (int c = 0; c < NUM_CTX; ++c) {
        for (int p = 0; p < NUM_PROBAS; ++p) {
          const uint32_t stats = enc->stats[t][b][c][p];
          const int nb = int(stats & 0xffff);
          const int total = int((stats >> 16) & 0xffff);
          const int update_proba = kCoeffsUpdateProba[t][b][c][p];
          const int old_p = kCoeffsProba0[t][b][c][p];
          const int new_p = nb ? (255 - nb * 255 / total) : 255;
          const int old_cost = BranchCost(nb, total, old_p) +
                               BitCost(0, uint8_t(update_proba));
          const int new_cost = BranchCost(nb, total, new_p) +
                               BitCost(1, uint8_t(update_proba)) + 8 * 256;
          if (old_cost > new_cost) {
            enc->coeffs[t][b][c][p] = uint8_t(new_p);
            has_changed |= (new_p != old_p);
          } else {
            enc->coeffs[t][b][c][p] = uint8_t(old_p);
          }
        }
      }
    }
  }
  enc->dirty = has_changed;
}

void AdjustFilterStrength(Encoder* enc) {
  int max_level = 0;
  for (int s = 0; s < NUM_MB_SEGMENTS; s++) {
    SegmentInfo* dqm = &enc->dqm[s];
    const int delta = (dqm->max_edge * dqm->y2.q[1]) >> 3;
    const int level = FilterStrengthFromDelta(delta);
    if (level > dqm->fstrength) dqm->fstrength = level;
    if (max_level < dqm->fstrength) max_level = dqm->fstrength;
  }
  enc->filter_level = max_level;
}

void TokenLoop(Encoder* enc) {
  int max_count = (enc->mb_w * enc->mb_h) >> 3;
  if (max_count < 96) max_count = 96;
  for (;;) {
    uint64_t size_p0 = 0;
    int cnt = max_count;
    Iterator it;
    IteratorInit(enc, &it);
    SetSegmentParams(enc, kQuality);
    SetSegmentProbas(enc);
    CalculateLevelCosts(enc);
    std::memset(enc->stats, 0, sizeof(enc->stats));
    enc->tokens.clear();
    do {
      ModeScore info;
      IteratorImport(&it, nullptr);
      if ((--cnt) < 0) {
        FinalizeTokenProbas(enc);
        CalculateLevelCosts(enc);
        cnt = max_count;
      }
      Decimate(&it, &info);
      RecordTokens(&it, info);
      size_p0 += uint64_t(info.H);
      SaveBoundary(&it);
    } while (IteratorNext(&it));
    size_p0 += uint64_t(enc->segment_size);
    if (enc->max_i4_header_bits > 0 && size_p0 > PARTITION0_SIZE_LIMIT) {
      enc->max_i4_header_bits >>= 1;   // fewer I4 header bits, and again
      continue;
    }
    break;
  }
  FinalizeTokenProbas(enc);
  for (uint16_t token : enc->tokens) {
    const int bit = token >> 15;
    if (token & FIXED_PROBA_BIT) {
      enc->part.PutBit(bit, token & 0xff);
    } else {
      enc->part.PutBit(bit, (&enc->coeffs[0][0][0][0])[token & 0x3fff]);
    }
  }
  enc->part.Finish();
  AdjustFilterStrength(enc);
}

// ---------------------------------------------------------------------------
// Stage 6: the bitstream (syntax_enc.c, tree_enc.c)

void PutSegmentHeader(Encoder* enc) {
  BitWriter& bw = enc->bw;
  if (bw.PutBitUniform(enc->num_segments > 1)) {
    bw.PutBitUniform(enc->update_map);
    if (bw.PutBitUniform(1)) {   // update_data
      bw.PutBitUniform(1);       // absolute values
      for (int s = 0; s < NUM_MB_SEGMENTS; ++s)
        bw.PutSignedBits(enc->dqm[s].quant, 7);
      for (int s = 0; s < NUM_MB_SEGMENTS; ++s)
        bw.PutSignedBits(enc->dqm[s].fstrength, 6);
    }
    if (enc->update_map) {
      for (int s = 0; s < 3; ++s) {
        if (bw.PutBitUniform(enc->segments_proba[s] != 255u))
          bw.PutBits(enc->segments_proba[s], 8);
      }
    }
  }
}

void PutI4Mode(BitWriter& bw, int mode, const uint8_t* prob) {
  if (bw.PutBit(mode != B_DC_PRED, prob[0])) {
    if (bw.PutBit(mode != B_TM_PRED, prob[1])) {
      if (bw.PutBit(mode != B_VE_PRED, prob[2])) {
        if (!bw.PutBit(mode >= B_LD_PRED, prob[3])) {
          if (bw.PutBit(mode != B_HE_PRED, prob[4]))
            bw.PutBit(mode != B_RD_PRED, prob[5]);
        } else {
          if (bw.PutBit(mode != B_LD_PRED, prob[6])) {
            if (bw.PutBit(mode != B_VL_PRED, prob[7]))
              bw.PutBit(mode != B_HD_PRED, prob[8]);
          }
        }
      }
    }
  }
}

void CodeIntraModes(Encoder* enc) {
  BitWriter& bw = enc->bw;
  Iterator it;
  IteratorInit(enc, &it);
  do {
    const MBInfo* mb = it.mb;
    const uint8_t* preds = it.preds;
    if (enc->update_map) {
      const uint8_t* p = enc->segments_proba;
      const int s = mb->segment;
      if (bw.PutBit(s >= 2, p[0])) p += 1;
      bw.PutBit(s & 1, p[1]);
    }
    if (bw.PutBit(mb->type != 0, 145)) {   // I16
      const int mode = preds[0];
      if (bw.PutBit(mode == TM_PRED || mode == H_PRED, 156)) {
        bw.PutBit(mode == TM_PRED, 128);
      } else {
        bw.PutBit(mode == V_PRED, 163);
      }
    } else {
      const int preds_w = enc->preds_w;
      const uint8_t* top_pred = preds - preds_w;
      for (int y = 0; y < 4; ++y) {
        int left = preds[-1];
        for (int x = 0; x < 4; ++x) {
          PutI4Mode(bw, preds[x], kBModesProba[top_pred[x]][left]);
          left = preds[x];
        }
        top_pred = preds;
        preds += preds_w;
      }
    }
    const int uv_mode = mb->uv_mode;
    if (bw.PutBit(uv_mode != DC_PRED, 142)) {
      if (bw.PutBit(uv_mode != V_PRED, 114))
        bw.PutBit(uv_mode != H_PRED, 183);
    }
  } while (IteratorNext(&it));
}

void GeneratePartition0(Encoder* enc) {
  BitWriter& bw = enc->bw;
  bw.PutBitUniform(0);   // colorspace
  bw.PutBitUniform(0);   // clamp type
  PutSegmentHeader(enc);
  // PutFilterHeader: normal filter, no loop-filter deltas
  bw.PutBitUniform(0);
  bw.PutBits(uint32_t(enc->filter_level), 6);
  bw.PutBits(kFilterSharpness, 3);
  bw.PutBitUniform(0);
  bw.PutBits(0, 2);      // one token partition
  // PutQuant
  bw.PutBits(uint32_t(enc->base_quant), 7);
  bw.PutSignedBits(0, 4);   // y1 dc
  bw.PutSignedBits(0, 4);   // y2 dc
  bw.PutSignedBits(0, 4);   // y2 ac
  bw.PutSignedBits(enc->dq_uv_dc, 4);
  bw.PutSignedBits(enc->dq_uv_ac, 4);
  bw.PutBitUniform(0);   // no proba update
  // VP8WriteProbas
  for (int t = 0; t < NUM_TYPES; ++t) {
    for (int b = 0; b < NUM_BANDS; ++b) {
      for (int c = 0; c < NUM_CTX; ++c) {
        for (int p = 0; p < NUM_PROBAS; ++p) {
          const uint8_t p0 = enc->coeffs[t][b][c][p];
          const int update = (p0 != kCoeffsProba0[t][b][c][p]);
          if (bw.PutBit(update, kCoeffsUpdateProba[t][b][c][p]))
            bw.PutBits(p0, 8);
        }
      }
    }
  }
  bw.PutBitUniform(0);   // no skip probability
  CodeIntraModes(enc);
  bw.Finish();
}

inline void PutLE32(std::vector<uint8_t>* out, uint32_t v) {
  for (int i = 0; i < 4; ++i) out->push_back(uint8_t(v >> (8 * i)));
}

void InitEncoder(Encoder* enc, const Picture* pic) {
  enc->pic = pic;
  enc->mb_w = (pic->width + 15) >> 4;
  enc->mb_h = (pic->height + 15) >> 4;
  enc->preds_w = 4 * enc->mb_w + 1;
  const int preds_h = 4 * enc->mb_h + 1;
  enc->num_segments = kSegments;
  enc->update_map = kSegments > 1;
  enc->segment_size = 0;
  enc->filter_level = 0;
  std::memset(enc->dqm, 0, sizeof(enc->dqm));
  enc->base_quant = 0;
  enc->dq_uv_ac = enc->dq_uv_dc = 0;
  enc->max_i4_header_bits = 256 * 16 * 16;   // partition_limit 0
  std::memset(enc->segments_proba, 255, sizeof(enc->segments_proba));
  std::memcpy(enc->coeffs, kCoeffsProba0, sizeof(enc->coeffs));
  std::memset(enc->stats, 0, sizeof(enc->stats));
  enc->dirty = true;
  enc->mb_info.assign(size_t(enc->mb_w) * enc->mb_h, MBInfo{});
  enc->preds_mem.assign(size_t(enc->preds_w) * preds_h + 1, B_DC_PRED);
  enc->preds = enc->preds_mem.data() + 1 + enc->preds_w;
  enc->nz_mem.assign(size_t(enc->mb_w) + 1, 0);
  enc->nz = enc->nz_mem.data() + 1;
  enc->y_top_mem.assign(size_t(2) * enc->mb_w * 16, 127);
  enc->y_top = enc->y_top_mem.data();
  enc->uv_top = enc->y_top + enc->mb_w * 16;
  enc->top_derr.assign(size_t(enc->mb_w) * 4, 0);
}

// The whole encoder; false where the first partition would overflow.
bool Encode(const Picture& pic, Encoder* enc, std::vector<uint8_t>* out) {
  InitEncoder(enc, &pic);
  Analyze(enc);
  TokenLoop(enc);
  GeneratePartition0(enc);
  const size_t size0 = enc->bw.buf.size();
  const size_t size1 = enc->part.buf.size();
  if (size0 >= (1u << 19)) return false;
  size_t vp8_size = 10 + size0 + size1;
  const size_t pad = vp8_size & 1;
  vp8_size += pad;
  const size_t riff_size = 4 + 8 + vp8_size;
  if (riff_size > 0xfffffffeU) return false;
  out->clear();
  out->reserve(8 + riff_size);
  for (char c : {'R', 'I', 'F', 'F'}) out->push_back(uint8_t(c));
  PutLE32(out, uint32_t(riff_size));
  for (char c : {'W', 'E', 'B', 'P', 'V', 'P', '8', ' '})
    out->push_back(uint8_t(c));
  PutLE32(out, uint32_t(vp8_size));
  const uint32_t bits = 0 | (0 << 1) | (1 << 4) | (uint32_t(size0) << 5);
  out->push_back(uint8_t(bits));
  out->push_back(uint8_t(bits >> 8));
  out->push_back(uint8_t(bits >> 16));
  out->push_back(0x9d);
  out->push_back(0x01);
  out->push_back(0x2a);
  out->push_back(uint8_t(pic.width & 0xff));
  out->push_back(uint8_t(pic.width >> 8));
  out->push_back(uint8_t(pic.height & 0xff));
  out->push_back(uint8_t(pic.height >> 8));
  out->insert(out->end(), enc->bw.buf.begin(), enc->bw.buf.end());
  out->insert(out->end(), enc->part.buf.begin(), enc->part.buf.end());
  if (pad) out->push_back(0);
  return true;
}

}  // namespace

extern "C" {

int64_t tb_webp_encode(const uint8_t* rgb, int64_t w, int64_t h, uint8_t* out,
                       int64_t cap) {
  if (w < 1 || h < 1 || w > 16383 || h > 16383) return -1;
  Picture pic;
  ImportRGB(rgb, int(w), int(h), &pic);
  Encoder enc;
  std::vector<uint8_t> data;
  if (!Encode(pic, &enc, &data)) return -2;
  const int64_t n = int64_t(data.size());
  if (n > cap) return -n;
  std::memcpy(out, data.data(), data.size());
  return n;
}

int64_t tb_webp_encode_rgba(const uint8_t* rgba, int64_t w, int64_t h,
                            uint8_t* out, int64_t cap) {
  if (w < 1 || h < 1 || w > 16383 || h > 16383) return -1;
  Picture pic;
  std::vector<uint8_t> alpha;
  ImportRGBA(rgba, int(w), int(h), &pic, &alpha);
  CleanupTransparentArea(&pic, alpha);
  Encoder enc;
  std::vector<uint8_t> data;
  if (!Encode(pic, &enc, &data)) return -2;
  const int64_t n = int64_t(data.size());
  if (n > cap) return -n;
  std::memcpy(out, data.data(), data.size());
  return n;
}

int64_t tb_webp_yuva(const uint8_t* rgba, int64_t w, int64_t h, int64_t clean,
                     uint8_t* y, uint8_t* u, uint8_t* v, uint8_t* a) {
  if (w < 1 || h < 1) return -1;
  Picture pic;
  std::vector<uint8_t> alpha;
  ImportRGBA(rgba, int(w), int(h), &pic, &alpha);
  if (clean) CleanupTransparentArea(&pic, alpha);
  std::memcpy(y, pic.y.data(), pic.y.size());
  std::memcpy(u, pic.u.data(), pic.u.size());
  std::memcpy(v, pic.v.data(), pic.v.size());
  std::memcpy(a, alpha.data(), alpha.size());
  return 0;
}

int64_t tb_webp_yuv(const uint8_t* rgb, int64_t w, int64_t h, uint8_t* y,
                    uint8_t* u, uint8_t* v) {
  if (w < 1 || h < 1) return -1;
  Picture pic;
  ImportRGB(rgb, int(w), int(h), &pic);
  std::memcpy(y, pic.y.data(), pic.y.size());
  std::memcpy(u, pic.u.data(), pic.u.size());
  std::memcpy(v, pic.v.data(), pic.v.size());
  return 0;
}

int64_t tb_webp_mb_info(const uint8_t* rgb, int64_t w, int64_t h,
                        uint8_t* info) {
  if (w < 1 || h < 1 || w > 16383 || h > 16383) return -1;
  Picture pic;
  ImportRGB(rgb, int(w), int(h), &pic);
  Encoder enc;
  std::vector<uint8_t> data;
  if (!Encode(pic, &enc, &data)) return -2;
  for (size_t n = 0; n < enc.mb_info.size(); ++n) {
    const MBInfo& mb = enc.mb_info[n];
    const int x = int(n % enc.mb_w), yy = int(n / enc.mb_w);
    uint8_t* p = info + 6 * n;
    p[0] = mb.type;
    p[1] = mb.segment;
    p[2] = uint8_t(enc.dqm[mb.segment].quant);
    p[3] = mb.type == 1 ? enc.preds[yy * 4 * enc.preds_w + x * 4] : 0xff;
    p[4] = mb.uv_mode;
    p[5] = mb.alpha;
  }
  return int64_t(enc.mb_info.size());
}

}  // extern "C"
