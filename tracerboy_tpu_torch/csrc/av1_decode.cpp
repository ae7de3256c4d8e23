// The AV1 decoder of the port's AVIF reader (core/avif.py): one intra frame
// from its OBUs to 8-bit Y, U and V planes (a grid's tiles each, stitched
// by core/avif.py), and the YUV-to-RGB(A) step that gives Pillow's
// pixels: libyuv's routines here, libavif's float routines in
// avif_reformat.inc. Host code, compiled with g++ at first use into the
// port's build directory (core/codecs.av1_library) and called through
// ctypes. The constant tables (default CDFs, quantizer lookups, matrices,
// weights, scans, the CDEF directions, the self-guided parameter sets, the
// Wiener and self-guided coefficient ranges, the Gaussian sequence and the
// grain overlap weights) are in av1_tables.inc, read out of the AV1
// libraries by tests/make_av1_tables.py; the in-loop filters are in
// av1_filters.inc, film grain synthesis in av1_grain.inc. What the AV1
// writer (av1_encode.cpp) shares with the syntax walk here, the symbol
// contexts among it, is in av1_syntax.inc; tb_av1_record hands the writer
// a frame's decisions as this walk reads them.
//
// The decoding process is the AV1 specification's (version 1.0.0 with
// errata 1), section by section: the OBU syntax (5.3-5.12, the loop filter,
// CDEF and loop restoration parameters 5.9.11, 5.9.19 and 5.9.20 and the
// restoration units 5.11.57-58 among it), the symbol decoder (8.2), block
// decoding (5.11, 6.10) and prediction, reconstruction and the inverse
// transforms (7.11.2, 7.12, 7.13), then the in-loop filters in their
// order: the deblocking filter (7.14), CDEF (7.15) and loop restoration
// (7.17). Intra block copy (use_intrabc) follows the inter syntax an
// intra frame can hold: find_mv_stack's spatial scans (7.10.2), read_mv
// under MV_INTRABC_CONTEXT, the var-tx tree, the inter transform sets and
// transform_tree (5.11.15-17, 5.11.36, 5.11.47-48), and the prediction
// from the frame being decoded (7.11.3). It is normative, so a decoder that
// follows it gives dav1d's samples bit for bit. The 1D inverse DCT is
// written as its recursive butterfly (the even half a DCT of half the size,
// the odd half's rotations and Hadamard stages in libaom's order,
// av1_inv_txfm1d.c), which is the specification's flow graph; every Hadamard
// output is clamped to 16 bits, as libaom and dav1d clamp their 8-bit
// intermediates.
//
// What the port still leaves out raises (kUnsupported, with the feature
// named): superres, high bit depth, and a frame that is not a shown key
// frame. These are checked in the headers before any block is decoded.
// Where the frame is coded lossless or allows intra block copy the
// filters are off, as the specification says. Film grain is applied to
// the planes handed out, not to the frame (av1_grain.inc).
//
// Departures from libavif's conversion: none in the values; 8-bit RGB(A)
// output only (what Pillow asks for), and no libyuv scaling of a tile
// whose frame differs from its ispe (core/avif.py refuses it).
//
// Departures from the specification: none in the decoding. A sequence
// with several operating points decodes operating point 0, as libavif
// asks dav1d to (all layers); OBUs outside it are dropped. What a damaged
// stream does follows dav1d 1.5, which Pillow's libavif decodes with:
// obu_forbidden_bit, tile list and reserved OBUs are ignored; a vertical
// partition at 4:2:2 (whose chroma has no block size) is refused; a
// sequence header or frame header OBU must hold its trailing one bit; an
// operating_point_idc naming layers of one kind only, identity matrix
// coefficients without 4:4:4, and film grain points dav1d's parser
// refuses, are refused; an intra block copy vector outside the decoded
// area (is_mv_valid, which dav1d does not check) is refused as corrupt;
// a tile whose symbol decoder reads more than 14 bits past its data is
// refused (SymbolMaxBits < -14, dav1d's check after each superblock
// row); and after the frame,
// the OBU headers up to the next frame are still read (an OBU past the
// data, or a sequence header that changes, fails the decode).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

#include "av1_tables.inc"

// The tools a frame's blocks use, reported in info[15] for the tests'
// coverage checks.
enum {
  kToolPalette = 1, kToolFilterIntra = 2, kToolCfl = 4, kToolAngleDelta = 8,
  kToolTx64 = 16, kTool1D = 32, kToolWht = 64, kToolDirectional = 128,
  kToolSmooth = 256, kToolPaeth = 512, kToolUpsample = 1024,
  kToolEdgeFilter = 2048, kToolAdst = 4096, kToolSegments = 8192,
  kToolDeltaQ = 16384, kToolQm = 32768, kToolExtPartition = 65536
};
// The in-loop filters a frame used, in the bits above them: deblocking
// (any edge filtered), its 13-tap luma filter, a chroma edge, a block's
// delta LF not 0, CDEF (an 8x8 filtered), on a chroma plane, Wiener and
// self-guided restoration units,
// self-guided sets with r0 = 0 and with r1 = 0, and units of a plane whose
// restoration type is switchable.
enum {
  kFilterDeblock = 1 << 17, kFilterDeblock14 = 1 << 18,
  kFilterDeblockChroma = 1 << 19, kFilterDeltaLf = 1 << 20,
  kFilterCdef = 1 << 21, kFilterCdefChroma = 1 << 22,
  kFilterWiener = 1 << 23, kFilterSgrproj = 1 << 24,
  kFilterSgrR0Zero = 1 << 25, kFilterSgrR1Zero = 1 << 26,
  kFilterSwitchable = 1 << 27
};
// Intra block copy, above them: a block that used it, its vector from the
// stack or the default one, a var-tx split, each inter transform type set
// read, and a chroma block of a block under 8 samples wide or high at
// subsampling. Film grain (av1_grain.inc): applied, its AR lag (one bit
// each), overlap, chroma scaling from luma, the restricted clip, luma
// grain without chroma grain, chroma grain without luma grain.
const uint64_t kIntrabc = 1ull << 28, kIntrabcStackDv = 1ull << 29,
               kIntrabcDefaultDv = 1ull << 30, kIntrabcVarTx = 1ull << 31,
               kIntrabcTxSet1 = 1ull << 32, kIntrabcSub8x8Chroma = 1ull << 35;
const uint64_t kGrain = 1ull << 36, kGrainLag0 = 1ull << 37,
               kGrainOverlap = 1ull << 41, kGrainFromLuma = 1ull << 42,
               kGrainClip = 1ull << 43, kGrainLumaOnly = 1ull << 44,
               kGrainChromaOnly = 1ull << 45;

#include "av1_syntax.inc"

// ---------------------------------------------------------------------------
// Inverse transforms (7.13.2).

const int32_t kCos128[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
    3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
    3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
    2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
    1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995,
    897, 799, 700, 601, 501, 401, 301, 201, 101, 0};
const int32_t kSinPi[5] = {0, 1321, 2482, 3344, 3803};

inline int32_t r12(int64_t x) { return (int32_t)((x + 2048) >> 12); }
inline int32_t c16(int64_t x) {
  return (int32_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}
int brev(int nbits, int x) {
  int r = 0;
  for (int i = 0; i < nbits; i++) r |= ((x >> i) & 1) << (nbits - 1 - i);
  return r;
}

// The DCT of the permuted x[0..N): the even half a DCT of N / 2, the odd
// half's stages, then the final butterflies.
void idct_core(int32_t* x, int N, int n) {
  if (N == 2) {
    int64_t a = x[0], b = x[1];
    x[0] = r12(kCos128[32] * a + kCos128[32] * b);
    x[1] = r12(kCos128[32] * a - kCos128[32] * b);
    return;
  }
  int M = N / 2;
  idct_core(x, M, n - 1);
  int32_t* o = x + M;
  for (int i = 0; i < M / 2; i++) {
    int k = brev(n, M + i), th = 64 - k * 64 / N;
    int64_t a = o[i], b = o[M - 1 - i];
    o[i] = r12(kCos128[th] * a - kCos128[64 - th] * b);
    o[M - 1 - i] = r12(kCos128[64 - th] * a + kCos128[th] * b);
  }
  if (M >= 4) {
    for (int B = 2; B <= M / 2; B *= 2) {
      for (int q = 0; q < M / B; q++)
        for (int t = 0; t < B / 2; t++) {
          int ia = q * B + t, ib = q * B + B - 1 - t;
          int64_t a = o[ia], b = o[ib];
          if (q % 2 == 0) {
            o[ia] = c16(a + b);
            o[ib] = c16(a - b);
          } else {
            o[ia] = c16(b - a);
            o[ib] = c16(a + b);
          }
        }
      if (B < M / 2) {
        int Q = M / (2 * B), lq = floor_log2(2 * Q);
        for (int q = 0; q < Q / 2; q++) {
          int k = brev(lq, Q + q), th = 64 - k * 64 / (2 * Q);
          int64_t cs = kCos128[th], sn = kCos128[64 - th];
          for (int t = 0; t < B; t++) {
            int p = 2 * B * q + B / 2 + t, m = M - 1 - p;
            int64_t a = o[p], b = o[m];
            if (t < B / 2) {
              o[p] = r12(-sn * a + cs * b);
              o[m] = r12(cs * a + sn * b);
            } else {
              o[p] = r12(-cs * a - sn * b);
              o[m] = r12(-sn * a + cs * b);
            }
          }
        }
      }
    }
    for (int p = M / 4; p < M / 2; p++) {
      int m = M - 1 - p;
      int64_t a = o[p], b = o[m];
      o[p] = r12(-kCos128[32] * a + kCos128[32] * b);
      o[m] = r12(kCos128[32] * a + kCos128[32] * b);
    }
  }
  for (int i = 0; i < M; i++) {
    int64_t e = x[i], d = x[N - 1 - i];
    x[i] = c16(e + d);
    x[N - 1 - i] = c16(e - d);
  }
}

void idct(int32_t* x, int n) {
  int N = 1 << n;
  int32_t t[64];
  for (int i = 0; i < N; i++) t[i] = x[brev(n, i)];
  idct_core(t, N, n);
  memcpy(x, t, N * sizeof(int32_t));
}

void iadst4(int32_t* x) {
  int64_t x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  int64_t s0 = kSinPi[1] * x0, s1 = kSinPi[2] * x0, s2 = kSinPi[3] * x1,
          s3 = kSinPi[4] * x2, s4 = kSinPi[1] * x2, s5 = kSinPi[2] * x3,
          s6 = kSinPi[4] * x3;
  int64_t a7 = x0 - x2, b7 = a7 + x3;
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = kSinPi[3] * b7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  int64_t y0 = s0 + s3, y1 = s1 + s3, y2 = s2, y3 = s0 + s1 - s3;
  x[0] = r12(y0);
  x[1] = r12(y1);
  x[2] = r12(y2);
  x[3] = r12(y3);
}

inline int32_t hb(int w0, int64_t a, int w1, int64_t b) {
  return r12(w0 * a + w1 * b);
}
#define CS(i) kCos128[i]

void iadst8(int32_t* x) {
  int32_t b[8], s[8];
  s[0] = x[7]; s[1] = x[0]; s[2] = x[5]; s[3] = x[2];
  s[4] = x[3]; s[5] = x[4]; s[6] = x[1]; s[7] = x[6];
  b[0] = hb(CS(4), s[0], CS(60), s[1]);
  b[1] = hb(CS(60), s[0], -CS(4), s[1]);
  b[2] = hb(CS(20), s[2], CS(44), s[3]);
  b[3] = hb(CS(44), s[2], -CS(20), s[3]);
  b[4] = hb(CS(36), s[4], CS(28), s[5]);
  b[5] = hb(CS(28), s[4], -CS(36), s[5]);
  b[6] = hb(CS(52), s[6], CS(12), s[7]);
  b[7] = hb(CS(12), s[6], -CS(52), s[7]);
  for (int i = 0; i < 4; i++) {
    s[i] = c16((int64_t)b[i] + b[i + 4]);
    s[i + 4] = c16((int64_t)b[i] - b[i + 4]);
  }
  b[0] = s[0]; b[1] = s[1]; b[2] = s[2]; b[3] = s[3];
  b[4] = hb(CS(16), s[4], CS(48), s[5]);
  b[5] = hb(CS(48), s[4], -CS(16), s[5]);
  b[6] = hb(-CS(48), s[6], CS(16), s[7]);
  b[7] = hb(CS(16), s[6], CS(48), s[7]);
  s[0] = c16((int64_t)b[0] + b[2]); s[1] = c16((int64_t)b[1] + b[3]);
  s[2] = c16((int64_t)b[0] - b[2]); s[3] = c16((int64_t)b[1] - b[3]);
  s[4] = c16((int64_t)b[4] + b[6]); s[5] = c16((int64_t)b[5] + b[7]);
  s[6] = c16((int64_t)b[4] - b[6]); s[7] = c16((int64_t)b[5] - b[7]);
  b[0] = s[0]; b[1] = s[1]; b[4] = s[4]; b[5] = s[5];
  b[2] = hb(CS(32), s[2], CS(32), s[3]);
  b[3] = hb(CS(32), s[2], -CS(32), s[3]);
  b[6] = hb(CS(32), s[6], CS(32), s[7]);
  b[7] = hb(CS(32), s[6], -CS(32), s[7]);
  x[0] = b[0]; x[1] = -b[4]; x[2] = b[6]; x[3] = -b[2];
  x[4] = b[3]; x[5] = -b[7]; x[6] = b[5]; x[7] = -b[1];
}

void iadst16(int32_t* x) {
  int32_t b[16], s[16];
  static const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6,
                               7, 8, 5, 10, 3, 12, 1, 14};
  for (int i = 0; i < 16; i++) s[i] = x[perm[i]];
  for (int i = 0; i < 8; i++) {
    int c = 2 + 8 * i, d = 64 - c;  // (2,62), (10,54), ... (58,6)
    b[2 * i] = hb(CS(c), s[2 * i], CS(d), s[2 * i + 1]);
    b[2 * i + 1] = hb(CS(d), s[2 * i], -CS(c), s[2 * i + 1]);
  }
  for (int i = 0; i < 8; i++) {
    s[i] = c16((int64_t)b[i] + b[i + 8]);
    s[i + 8] = c16((int64_t)b[i] - b[i + 8]);
  }
  for (int i = 0; i < 8; i++) b[i] = s[i];
  b[8] = hb(CS(8), s[8], CS(56), s[9]);
  b[9] = hb(CS(56), s[8], -CS(8), s[9]);
  b[10] = hb(CS(40), s[10], CS(24), s[11]);
  b[11] = hb(CS(24), s[10], -CS(40), s[11]);
  b[12] = hb(-CS(56), s[12], CS(8), s[13]);
  b[13] = hb(CS(8), s[12], CS(56), s[13]);
  b[14] = hb(-CS(24), s[14], CS(40), s[15]);
  b[15] = hb(CS(40), s[14], CS(24), s[15]);
  for (int g = 0; g < 16; g += 8)
    for (int i = 0; i < 4; i++) {
      s[g + i] = c16((int64_t)b[g + i] + b[g + i + 4]);
      s[g + i + 4] = c16((int64_t)b[g + i] - b[g + i + 4]);
    }
  for (int g = 0; g < 16; g += 8) {
    b[g + 0] = s[g + 0]; b[g + 1] = s[g + 1];
    b[g + 2] = s[g + 2]; b[g + 3] = s[g + 3];
    b[g + 4] = hb(CS(16), s[g + 4], CS(48), s[g + 5]);
    b[g + 5] = hb(CS(48), s[g + 4], -CS(16), s[g + 5]);
    b[g + 6] = hb(-CS(48), s[g + 6], CS(16), s[g + 7]);
    b[g + 7] = hb(CS(16), s[g + 6], CS(48), s[g + 7]);
  }
  for (int g = 0; g < 16; g += 4) {
    s[g + 0] = c16((int64_t)b[g + 0] + b[g + 2]);
    s[g + 1] = c16((int64_t)b[g + 1] + b[g + 3]);
    s[g + 2] = c16((int64_t)b[g + 0] - b[g + 2]);
    s[g + 3] = c16((int64_t)b[g + 1] - b[g + 3]);
  }
  for (int g = 0; g < 16; g += 4) {
    b[g + 0] = s[g + 0];
    b[g + 1] = s[g + 1];
    b[g + 2] = hb(CS(32), s[g + 2], CS(32), s[g + 3]);
    b[g + 3] = hb(CS(32), s[g + 2], -CS(32), s[g + 3]);
  }
  static const int op[16] = {0, 8, 12, 4, 6, 14, 10, 2,
                             3, 11, 15, 7, 5, 13, 9, 1};
  for (int i = 0; i < 16; i++) x[i] = (i & 1) ? -b[op[i]] : b[op[i]];
}
#undef CS

void iidentity(int32_t* x, int n) {
  int N = 1 << n;
  for (int i = 0; i < N; i++) {
    int64_t v = x[i];
    if (n == 2) x[i] = r12(v * 5793);
    else if (n == 3) x[i] = (int32_t)(v * 2);
    else if (n == 4) x[i] = r12(v * 11586);
    else x[i] = (int32_t)(v * 4);
  }
}

void iwht(int32_t* x, int shift) {
  int32_t a = x[0] >> shift, c = x[1] >> shift, d = x[2] >> shift,
          b = x[3] >> shift;
  a += c;
  d -= b;
  int32_t e = (a - d) >> 1;
  b = e - b;
  c = e - c;
  a -= b;
  d += c;
  x[0] = a; x[1] = b; x[2] = c; x[3] = d;
}

enum { T_DCT, T_ADST, T_IDN };
void inverse_1d(int32_t* x, int kind, int n) {
  if (kind == T_DCT) idct(x, n);
  else if (kind == T_IDN) iidentity(x, n);
  else if (n == 2) iadst4(x);
  else if (n == 3) iadst8(x);
  else iadst16(x);
}

// ---------------------------------------------------------------------------
// The frame.

struct Plane {
  std::vector<uint8_t> px;
  int stride = 0, rows = 0;
  uint8_t* at(int y, int x) { return &px[(size_t)y * stride + x]; }
};

struct Decoder : FrameState {
  // Frame header (the fields contexts read are FrameState's).
  int frame_w = 0, frame_h = 0;
  int disable_cdf_update = 0;
  int dq_ydc = 0, dq_udc = 0, dq_uac = 0, dq_vdc = 0, dq_vac = 0;
  int using_qm = 0, qm_y = 0, qm_u = 0, qm_v = 0;
  int seg_qm_level[3][8];
  int only_4x4 = 0;
  // loop_filter_params, cdef_params and lr_params.
  int lf_level[4] = {0}, lf_sharpness = 0, lf_delta_enabled = 0;
  int lf_ref_deltas[8] = {0};
  int cdef_damping = 3, cdef_y_pri[8] = {0}, cdef_y_sec[8] = {0},
      cdef_uv_pri[8] = {0}, cdef_uv_sec[8] = {0};
  int tile_cols = 0, tile_rows = 0, tile_cols_log2 = 0, tile_rows_log2 = 0;
  int mi_col_starts[65], mi_row_starts[65], tile_size_bytes = 4;
  GrainParams grain;
  FrameHeader fh;
  bool have_frame = false, frame_done = false;

  // Per-mi state beyond FrameState's.
  std::vector<uint8_t> uv_modes;
  std::vector<int8_t> delta_lfs;  // 4 a mi
  // LoopfilterTxSizes: each plane's transform size at each of its 4x4s.
  std::vector<uint8_t> lf_tx[3];
  int lf_tx_stride = 0;
  // Each plane's restoration units (5.11.58).
  struct LrUnit {
    uint8_t type = RESTORE_NONE, sgr_set = 0;
    int8_t wiener[2][3] = {{0}};
    int8_t xqd[2] = {0};
  };
  std::vector<LrUnit> lr_units[3];
  Plane planes[3];

  // Tile state.
  SymbolDecoder sd;
  int delta_lf[4] = {0}, read_deltas = 0;
  int ref_lr_wiener[3][2][3], ref_sgr_xqd[3][2];
  uint8_t block_decoded[3][34][34];

  // Block state.
  int avail_u_chroma = 0, avail_l_chroma = 0;
  int skip = 0;
  int y_mode = 0, angle_delta_y = 0, angle_delta_uv = 0;
  int cfl_alpha_u = 0, cfl_alpha_v = 0;
  int use_filter_intra = 0, filter_intra_mode = 0;
  int use_intrabc = 0, mv[2] = {0, 0};
  int pal_size_y = 0, pal_size_uv = 0;
  uint16_t pal_y[8], pal_u[8], pal_v[8];
  uint8_t color_map_y[64][64], color_map_uv[64][64];
  int tx_size = 0, max_luma_w = 0, max_luma_h = 0;
  int32_t resid[64][64];
  int pred_buf[64][64];
  int32_t dq_buf[64][64];
  bool header_only = false;
  uint64_t tools = 0;  // what the frame used (kTool*, kFilter*, ... bits)
  // The decision record (tb_av1_record), when one is asked for, and an
  // intra block copy's var-tx leaves (mi row, mi column, TX_*).
  std::vector<int32_t>* rec = nullptr;
  std::vector<int32_t> var_leaves;

  void emit(int tag, const void* v, size_t n) {
    rec->push_back(tag);
    rec->push_back((int32_t)n);
    const int32_t* p = (const int32_t*)v;
    rec->insert(rec->end(), p, p + n);
  }

  // --- OBU level --------------------------------------------------------

  void sequence_header(BitReader& br) {
    SeqHeader s;
    s.profile = br.f(3);
    s.still = br.f(1);
    s.reduced = br.f(1);
    if (s.profile > 2) corrupt("seq_profile");
    if (s.reduced) {
      s.op_cnt = 1;
      s.op_idc[0] = 0;
      s.op_level[0] = br.f(5);  // seq_level_idx[0]
    } else {
      s.timing_info = br.f(1);
      if (s.timing_info) {
        s.num_units_in_display_tick = (int)br.f(32);
        s.time_scale = (int)br.f(32);
        s.equal_picture_interval = br.f(1);
        if (s.equal_picture_interval)
          s.num_ticks_per_picture = (int)(br.uvlc() + 1);
        s.decoder_model_info = br.f(1);
        if (s.decoder_model_info) {
          int bdl = br.f(5) + 1;
          s.num_units_in_decoding_tick = (int)br.f(32);
          s.buffer_removal_time_len = br.f(5) + 1;
          s.frame_presentation_time_len = br.f(5) + 1;
          s.buffer_delay_len = bdl;
        }
      }
      s.idd_present = br.f(1);
      s.op_cnt = br.f(5) + 1;
      int bdl = s.buffer_delay_len;
      for (int i = 0; i < s.op_cnt; i++) {
        s.op_idc[i] = br.f(12);
        if (s.op_idc[i] && (!(s.op_idc[i] & 0xff) || !(s.op_idc[i] & 0xf00)))
          corrupt("operating_point_idc");  // dav1d refuses it
        int lvl = br.f(5);
        s.op_level[i] = lvl;
        if (lvl > 7) s.op_tier[i] = br.f(1);
        if (s.decoder_model_info) {
          s.decoder_model_present[i] = br.f(1);
          if (s.decoder_model_present[i]) {
            s.op_decoder_delay[i] = br.f(bdl);
            s.op_encoder_delay[i] = br.f(bdl);
            s.op_low_delay[i] = br.f(1);
          }
        }
        if (s.idd_present && (s.op_idd_present[i] = br.f(1)))
          s.op_idd[i] = br.f(4);
      }
    }
    s.frame_width_bits = br.f(4) + 1;
    s.frame_height_bits = br.f(4) + 1;
    s.max_w = br.f(s.frame_width_bits) + 1;
    s.max_h = br.f(s.frame_height_bits) + 1;
    if (!s.reduced) s.frame_id_numbers = br.f(1);
    if (s.frame_id_numbers) {
      s.delta_frame_id_len = br.f(4) + 2;
      s.add_frame_id_len = br.f(3) + 1;
    }
    s.sb128 = br.f(1);
    s.enable_filter_intra = br.f(1);
    s.enable_intra_edge = br.f(1);
    if (s.reduced) {
      s.force_screen_content = 2;
      s.force_integer_mv = 2;
    } else {
      s.enable_interintra = br.f(1);
      s.enable_masked = br.f(1);
      s.enable_warped = br.f(1);
      s.enable_dual_filter = br.f(1);
      s.enable_order_hint = br.f(1);
      if (s.enable_order_hint) {
        s.enable_jnt_comp = br.f(1);
        s.enable_ref_frame_mvs = br.f(1);
      }
      if (br.f(1))  // seq_choose_screen_content_tools
        s.force_screen_content = 2;
      else
        s.force_screen_content = br.f(1);
      if (s.force_screen_content > 0) {
        if (br.f(1)) s.force_integer_mv = 2;
        else s.force_integer_mv = br.f(1);
      } else {
        s.force_integer_mv = 2;
      }
      if (s.enable_order_hint) s.order_hint_bits = br.f(3) + 1;
    }
    s.enable_superres = br.f(1);
    s.enable_cdef = br.f(1);
    s.enable_restoration = br.f(1);
    // color_config
    int high_bitdepth = br.f(1);
    if (s.profile == 2 && high_bitdepth) s.bit_depth = br.f(1) ? 12 : 10;
    else s.bit_depth = high_bitdepth ? 10 : 8;
    s.mono = s.profile == 1 ? 0 : br.f(1);
    if ((s.color_description = br.f(1))) {
      s.cp = br.f(8);
      s.tc = br.f(8);
      s.mc = br.f(8);
    }
    if (s.mono) {
      s.full_range = br.f(1);
      s.ssx = s.ssy = 1;
      s.separate_uv_delta_q = 0;
    } else {
      if (s.cp == 1 && s.tc == 13 && s.mc == 0) {
        s.full_range = 1;
        s.ssx = s.ssy = 0;
      } else {
        s.full_range = br.f(1);
        if (s.profile == 0) {
          s.ssx = s.ssy = 1;
        } else if (s.profile == 1) {
          s.ssx = s.ssy = 0;
        } else if (s.bit_depth == 12) {
          s.ssx = br.f(1);
          s.ssy = s.ssx ? br.f(1) : 0;
        } else {
          s.ssx = 1;
          s.ssy = 0;
        }
        if (s.ssx && s.ssy) s.csp = br.f(2);
      }
      s.separate_uv_delta_q = br.f(1);
    }
    s.film_grain_present = br.f(1);
    if (s.mc == 0 && !s.mono && (s.ssx || s.ssy))
      corrupt("identity matrix without 4:4:4");  // dav1d refuses it
    s.valid = true;
    if (seq.valid && (seq.max_w != s.max_w || seq.max_h != s.max_h ||
                      seq.bit_depth != s.bit_depth || seq.mono != s.mono ||
                      seq.ssx != s.ssx || seq.ssy != s.ssy))
      corrupt("the sequence header changes");
    seq = s;
  }

  int read_delta_q(BitReader& br) { return br.f(1) ? br.su(7) : 0; }

  // uncompressed_header (5.9.2) for the frames this decoder takes; header
  // only: returns after film_grain_params.
  void frame_header(BitReader& br, int temporal_id, int spatial_id) {
    if (!seq.valid) corrupt("frame before a sequence header");
    fh = FrameHeader();
    const SeqHeader& s = seq;
    if (s.bit_depth != 8)
      unsupported("high bit depth (10 or 12 bits)");
    int frame_type = 0, show_frame = 1;
    if (!s.reduced) {
      if (br.f(1)) unsupported("show_existing_frame");
      frame_type = br.f(2);
      show_frame = br.f(1);
      if (show_frame && s.decoder_model_info && !s.equal_picture_interval)
        fh.frame_presentation_time = br.f(s.frame_presentation_time_len);
      if (!show_frame) br.f(1);                      // showable_frame
      if (frame_type != 3 && !(frame_type == 0 && show_frame))
        br.f(1);                                     // error_resilient_mode
    }
    if (frame_type != 0 || !show_frame)
      unsupported("a frame that is not a shown key frame");
    disable_cdf_update = br.f(1);
    allow_sct = s.force_screen_content == 2 ? br.f(1) : s.force_screen_content;
    if (allow_sct && s.force_integer_mv == 2) fh.force_integer_mv = br.f(1);
    if (s.frame_id_numbers)
      fh.frame_id = br.f(s.add_frame_id_len + s.delta_frame_id_len + 1);
    int size_override = s.reduced ? 0 : br.f(1);
    fh.size_override = size_override;
    fh.order_hint = br.f(s.order_hint_bits);
    // primary_ref_frame: none for an intra frame.
    if (s.decoder_model_info) {
      if ((fh.buffer_removal_present = br.f(1))) {
        for (int op = 0; op < s.op_cnt; op++)
          if (s.decoder_model_present[op]) {
            int idc = s.op_idc[op];
            int in_t = (idc >> temporal_id) & 1,
                in_s = (idc >> (spatial_id + 8)) & 1;
            if (idc == 0 || (in_t && in_s))
              fh.buffer_removal[op] = br.f(s.buffer_removal_time_len);
          }
      }
    }
    // frame_size
    if (size_override) {
      frame_w = br.f(s.frame_width_bits) + 1;
      frame_h = br.f(s.frame_height_bits) + 1;
    } else {
      frame_w = s.max_w;
      frame_h = s.max_h;
    }
    // libavif gives dav1d its image size limit as frame_size_limit.
    if ((int64_t)frame_w * frame_h > 16384 * 16384)
      corrupt("a frame past the size limit");
    if (s.enable_superres && br.f(1)) unsupported("superres");
    mi_cols = 2 * ((frame_w + 7) >> 3);
    mi_rows = 2 * ((frame_h + 7) >> 3);
    if ((fh.render_diff = br.f(1))) {  // render_and_frame_size_different
      fh.render_w = br.f(16);
      fh.render_h = br.f(16);
    }
    allow_intrabc = 0;
    if (allow_sct) allow_intrabc = br.f(1);
    // disable_frame_end_update_cdf
    fh.disable_frame_end_update_cdf = 1;
    if (!s.reduced && !disable_cdf_update)
      fh.disable_frame_end_update_cdf = br.f(1);
    tile_info(br);
    // quantization_params
    base_q_idx = br.f(8);
    dq_ydc = read_delta_q(br);
    dq_udc = dq_uac = dq_vdc = dq_vac = 0;
    num_planes = s.mono ? 1 : 3;
    if (num_planes > 1) {
      int diff_uv = s.separate_uv_delta_q ? br.f(1) : 0;
      dq_udc = read_delta_q(br);
      dq_uac = read_delta_q(br);
      if (diff_uv) {
        dq_vdc = read_delta_q(br);
        dq_vac = read_delta_q(br);
      } else {
        dq_vdc = dq_udc;
        dq_vac = dq_uac;
      }
    }
    using_qm = br.f(1);
    if (using_qm) {
      qm_y = br.f(4);
      qm_u = br.f(4);
      qm_v = s.separate_uv_delta_q ? br.f(4) : qm_u;
    }
    // segmentation_params
    seg_enabled = br.f(1);
    memset(feature_enabled, 0, sizeof(feature_enabled));
    memset(feature_data, 0, sizeof(feature_data));
    if (seg_enabled) {
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          int en = br.f(1), v = 0;
          feature_enabled[i][j] = en;
          if (en) {
            int bits = kSegFeatureBits[j], lim = kSegFeatureMax[j];
            if (kSegFeatureSigned[j])
              v = clip3(-lim, lim, br.su(1 + bits));
            else
              v = clip3(0, lim, (int)br.f(bits));
          }
          feature_data[i][j] = v;
        }
    }
    seg_id_pre_skip = 0;
    last_active_seg_id = 0;
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        if (feature_enabled[i][j]) {
          last_active_seg_id = i;
          if (j >= 5) seg_id_pre_skip = 1;
        }
    // delta_q_params, delta_lf_params
    delta_q_res = delta_q_present = 0;
    if (base_q_idx > 0) delta_q_present = br.f(1);
    if (delta_q_present) delta_q_res = br.f(2);
    delta_lf_present = delta_lf_res = delta_lf_multi = 0;
    if (delta_q_present) {
      if (!allow_intrabc) delta_lf_present = br.f(1);
      if (delta_lf_present) {
        delta_lf_res = br.f(2);
        delta_lf_multi = br.f(1);
      }
    }
    coded_lossless = 1;
    for (int sid = 0; sid < 8; sid++) {
      int q = get_qindex(1, sid);
      lossless_array[sid] = q == 0 && dq_ydc == 0 && dq_uac == 0 &&
                            dq_udc == 0 && dq_vac == 0 && dq_vdc == 0;
      if (!lossless_array[sid]) coded_lossless = 0;
      for (int p = 0; p < 3; p++) {
        int lvl = p == 0 ? qm_y : p == 1 ? qm_u : qm_v;
        seg_qm_level[p][sid] =
            (using_qm && !lossless_array[sid]) ? lvl : 15;
      }
    }
    // loop_filter_params (5.9.11), the deltas from
    // setup_past_independence: a key frame has no reference to load
    // them from. An intra frame reads only the INTRA_FRAME delta; the
    // mode deltas are for inter blocks.
    bool filters = !coded_lossless && !allow_intrabc;
    static const int kRefDeltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
    memcpy(lf_ref_deltas, kRefDeltas, sizeof(lf_ref_deltas));
    for (int i = 0; i < 4; i++) lf_level[i] = 0;
    lf_sharpness = lf_delta_enabled = 0;
    if (filters) {
      lf_level[0] = br.f(6);
      lf_level[1] = br.f(6);
      if (num_planes > 1 && (lf_level[0] || lf_level[1])) {
        lf_level[2] = br.f(6);
        lf_level[3] = br.f(6);
      }
      lf_sharpness = br.f(3);
      lf_delta_enabled = br.f(1);
      if (lf_delta_enabled && (fh.lf_delta_update = br.f(1))) {
        for (int i = 0; i < 8; i++)
          if (br.f(1)) lf_ref_deltas[i] = br.su(7);
        for (int i = 0; i < 2; i++)
          if (br.f(1)) fh.lf_mode_deltas[i] = br.su(7);
      }
    }
    // cdef_params (5.9.19): a secondary strength of 3 means 4.
    cdef_bits = 0;
    cdef_damping = 3;
    memset(cdef_y_pri, 0, sizeof(cdef_y_pri));
    memset(cdef_y_sec, 0, sizeof(cdef_y_sec));
    memset(cdef_uv_pri, 0, sizeof(cdef_uv_pri));
    memset(cdef_uv_sec, 0, sizeof(cdef_uv_sec));
    if (filters && s.enable_cdef) {
      cdef_damping = br.f(2) + 3;
      cdef_bits = br.f(2);
      for (int i = 0; i < (1 << cdef_bits); i++) {
        cdef_y_pri[i] = br.f(4);
        cdef_y_sec[i] = br.f(2);
        if (cdef_y_sec[i] == 3) cdef_y_sec[i] = 4;
        if (num_planes > 1) {
          cdef_uv_pri[i] = br.f(4);
          cdef_uv_sec[i] = br.f(2);
          if (cdef_uv_sec[i] == 3) cdef_uv_sec[i] = 4;
        }
      }
    }
    // lr_params (5.9.20): Remap_Lr_Type, and LoopRestorationSize.
    for (int i = 0; i < 3; i++) lr_type[i] = RESTORE_NONE, lr_size[i] = 0;
    if (filters && s.enable_restoration) {
      static const int kRemap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE,
                                    RESTORE_WIENER, RESTORE_SGRPROJ};
      bool uses_lr = false, chroma_lr = false;
      for (int i = 0; i < num_planes; i++) {
        lr_type[i] = kRemap[br.f(2)];
        if (lr_type[i] != RESTORE_NONE) {
          uses_lr = true;
          chroma_lr |= i > 0;
        }
      }
      if (uses_lr) {
        int shift = br.f(1);
        if (s.sb128) shift++;
        else if (shift) shift += br.f(1);
        lr_size[0] = 256 >> (2 - shift);
        int uv_shift = (s.ssx && s.ssy && chroma_lr) ? br.f(1) : 0;
        lr_size[1] = lr_size[2] = lr_size[0] >> uv_shift;
      }
    }
    // read_tx_mode
    only_4x4 = coded_lossless;
    tx_mode_select = coded_lossless ? 0 : br.f(1);
    // frame_reference_mode, skip_mode_params: nothing for an intra frame.
    // allow_warped_motion: not read for an intra frame.
    reduced_tx_set = br.f(1);
    // global_motion_params: nothing for an intra frame.
    grain = GrainParams();
    if (s.film_grain_present) film_grain_params(br);
    have_frame = true;
    header_record();
  }

  // The FrameHeader of the decision record from what frame_header read.
  void header_record() {
    FrameHeader& h = fh;
    h.disable_cdf_update = disable_cdf_update;
    h.allow_sct = allow_sct;
    h.frame_w = frame_w;
    h.frame_h = frame_h;
    h.allow_intrabc = allow_intrabc;
    h.tile_cols_log2 = tile_cols_log2;
    h.tile_rows_log2 = tile_rows_log2;
    h.tile_cols = tile_cols;
    h.tile_rows = tile_rows;
    memcpy(h.mi_col_starts, mi_col_starts, sizeof(mi_col_starts));
    memcpy(h.mi_row_starts, mi_row_starts, sizeof(mi_row_starts));
    h.base_q_idx = base_q_idx;
    h.dq_ydc = dq_ydc;
    h.dq_udc = dq_udc;
    h.dq_uac = dq_uac;
    h.dq_vdc = dq_vdc;
    h.dq_vac = dq_vac;
    h.using_qm = using_qm;
    h.qm_y = qm_y;
    h.qm_u = qm_u;
    h.qm_v = qm_v;
    h.seg_enabled = seg_enabled;
    memcpy(h.feature_enabled, feature_enabled, sizeof(feature_enabled));
    memcpy(h.feature_data, feature_data, sizeof(feature_data));
    h.delta_q_present = delta_q_present;
    h.delta_q_res = delta_q_res;
    h.delta_lf_present = delta_lf_present;
    h.delta_lf_res = delta_lf_res;
    h.delta_lf_multi = delta_lf_multi;
    memcpy(h.lf_level, lf_level, sizeof(lf_level));
    h.lf_sharpness = lf_sharpness;
    h.lf_delta_enabled = lf_delta_enabled;
    memcpy(h.lf_ref_deltas, lf_ref_deltas, sizeof(lf_ref_deltas));
    h.cdef_damping = cdef_damping;
    h.cdef_bits = cdef_bits;
    memcpy(h.cdef_y_pri, cdef_y_pri, sizeof(cdef_y_pri));
    memcpy(h.cdef_y_sec, cdef_y_sec, sizeof(cdef_y_sec));
    memcpy(h.cdef_uv_pri, cdef_uv_pri, sizeof(cdef_uv_pri));
    memcpy(h.cdef_uv_sec, cdef_uv_sec, sizeof(cdef_uv_sec));
    memcpy(h.lr_type, lr_type, sizeof(lr_type));
    memcpy(h.lr_size, lr_size, sizeof(lr_size));
    h.tx_mode_select = tx_mode_select;
    h.reduced_tx_set = reduced_tx_set;
  }

  // film_grain_params (5.9.30) of a shown key frame: update_grain is 1,
  // so nothing is loaded from a reference. What dav1d refuses is corrupt:
  // more than 14 luma or 10 chroma points, points whose values do not
  // increase, and at 4:2:0 one chroma plane with points and not the other.
  void film_grain_params(BitReader& br) {
    GrainParams& g = grain;
    g.apply = br.f(1);
    if (!g.apply) return;
    g.seed = br.f(16);
    auto points = [&](int (*pts)[2], int max) {
      int n = br.f(4);
      if (n > max) corrupt("film grain scaling points");
      for (int i = 0; i < n; i++) {
        pts[i][0] = br.f(8);
        if (i && pts[i - 1][0] >= pts[i][0])
          corrupt("film grain scaling points");
        pts[i][1] = br.f(8);
      }
      return n;
    };
    g.num_y = points(g.y_pts, 14);
    g.from_luma = seq.mono ? 0 : br.f(1);
    if (!seq.mono && !g.from_luma &&
        !(seq.ssx && seq.ssy && g.num_y == 0)) {
      g.num_cb = points(g.cb_pts, 10);
      g.num_cr = points(g.cr_pts, 10);
      if (seq.ssx && seq.ssy && !g.num_cb != !g.num_cr)
        corrupt("film grain chroma points");
    }
    g.scaling_shift = br.f(2) + 8;
    g.lag = br.f(2);
    int num_pos_luma = 2 * g.lag * (g.lag + 1);
    int num_pos_chroma = num_pos_luma + (g.num_y > 0);
    memset(g.ar_y, 0, sizeof(g.ar_y));
    memset(g.ar_cb, 0, sizeof(g.ar_cb));
    memset(g.ar_cr, 0, sizeof(g.ar_cr));
    if (g.num_y)
      for (int i = 0; i < num_pos_luma; i++) g.ar_y[i] = (int)br.f(8) - 128;
    if (g.from_luma || g.num_cb)
      for (int i = 0; i < num_pos_chroma; i++)
        g.ar_cb[i] = (int)br.f(8) - 128;
    if (g.from_luma || g.num_cr)
      for (int i = 0; i < num_pos_chroma; i++)
        g.ar_cr[i] = (int)br.f(8) - 128;
    g.ar_shift = br.f(2) + 6;
    g.scale_shift = br.f(2);
    if (g.num_cb) {
      g.cb_mult = (int)br.f(8) - 128;
      g.cb_luma_mult = (int)br.f(8) - 128;
      g.cb_offset = (int)br.f(9) - 256;
    }
    if (g.num_cr) {
      g.cr_mult = (int)br.f(8) - 128;
      g.cr_luma_mult = (int)br.f(8) - 128;
      g.cr_offset = (int)br.f(9) - 256;
    }
    g.overlap = br.f(1);
    g.clip = br.f(1);
  }

  int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) k++;
    return k;
  }

  void tile_info(BitReader& br) {
    int sb_cols = seq.sb128 ? (mi_cols + 31) >> 5 : (mi_cols + 15) >> 4;
    int sb_rows = seq.sb128 ? (mi_rows + 31) >> 5 : (mi_rows + 15) >> 4;
    int sb_shift = seq.sb128 ? 5 : 4, sb_size = sb_shift + 2;
    int max_tile_w_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    int min_log2_cols = tile_log2(max_tile_w_sb, sb_cols);
    int max_log2_cols = tile_log2(1, imin(sb_cols, 64));
    int max_log2_rows = tile_log2(1, imin(sb_rows, 64));
    int min_log2_tiles =
        imax(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    int uniform = br.f(1);
    fh.uniform_tiles = uniform;
    if (uniform) {
      tile_cols_log2 = min_log2_cols;
      while (tile_cols_log2 < max_log2_cols && br.f(1)) tile_cols_log2++;
      int tw = (sb_cols + (1 << tile_cols_log2) - 1) >> tile_cols_log2;
      int i = 0;
      for (int st = 0; st < sb_cols; st += tw) mi_col_starts[i++] = st << sb_shift;
      mi_col_starts[i] = mi_cols;
      tile_cols = i;
      int min_log2_rows = imax(min_log2_tiles - tile_cols_log2, 0);
      tile_rows_log2 = min_log2_rows;
      while (tile_rows_log2 < max_log2_rows && br.f(1)) tile_rows_log2++;
      int th = (sb_rows + (1 << tile_rows_log2) - 1) >> tile_rows_log2;
      i = 0;
      for (int st = 0; st < sb_rows; st += th) mi_row_starts[i++] = st << sb_shift;
      mi_row_starts[i] = mi_rows;
      tile_rows = i;
    } else {
      int widest = 0, st = 0, i = 0;
      for (; st < sb_cols; i++) {
        if (i >= 64) corrupt("tile columns");
        mi_col_starts[i] = st << sb_shift;
        int mw = imin(sb_cols - st, max_tile_w_sb);
        int sz = br.ns(mw) + 1;
        widest = imax(sz, widest);
        st += sz;
      }
      mi_col_starts[i] = mi_cols;
      tile_cols = i;
      tile_cols_log2 = tile_log2(1, tile_cols);
      if (min_log2_tiles > 0)
        max_tile_area_sb = (sb_rows * sb_cols) >> (min_log2_tiles + 1);
      else
        max_tile_area_sb = sb_rows * sb_cols;
      int max_th = imax(max_tile_area_sb / widest, 1);
      st = 0;
      for (i = 0; st < sb_rows; i++) {
        if (i >= 64) corrupt("tile rows");
        mi_row_starts[i] = st << sb_shift;
        int mh = imin(sb_rows - st, max_th);
        st += br.ns(mh) + 1;
      }
      mi_row_starts[i] = mi_rows;
      tile_rows = i;
      tile_rows_log2 = tile_log2(1, tile_rows);
    }
    if (tile_cols_log2 > 0 || tile_rows_log2 > 0) {
      br.f(tile_rows_log2 + tile_cols_log2);  // context_update_tile_id
      tile_size_bytes = br.f(2) + 1;
    }
  }

  void alloc_frame() {
    alloc_state();
    size_t n = (size_t)mi_rows * mi_cols;
    uv_modes.assign(n, 0);
    delta_lfs.assign(n * 4, 0);
    lf_tx_stride = mi_cols + 17;
    for (int p = 0; p < 3; p++)
      lf_tx[p].assign((size_t)(mi_rows + 17) * lf_tx_stride, 0);
    for (int p = 0; p < num_planes; p++) {
      int sx = p ? seq.ssx : 0, sy = p ? seq.ssy : 0;
      if (lr_type[p] == RESTORE_NONE) continue;
      lr_unit_rows[p] = count_units(lr_size[p], (frame_h + sy) >> sy);
      lr_unit_cols[p] = count_units(lr_size[p], (frame_w + sx) >> sx);
      lr_units[p].assign((size_t)lr_unit_rows[p] * lr_unit_cols[p], LrUnit());
    }
    int aw = ((mi_cols * 4 + 127) & ~127) + 160;
    int ah = ((mi_rows * 4 + 127) & ~127) + 160;
    for (int p = 0; p < num_planes; p++) {
      int sx = p ? seq.ssx : 0, sy = p ? seq.ssy : 0;
      planes[p].stride = (aw >> sx) + 64;
      planes[p].rows = (ah >> sy) + 64;
      planes[p].px.assign((size_t)planes[p].stride * planes[p].rows, 0);
    }
  }

  void tile_group(const uint8_t* d, size_t sz) {
    if (!have_frame) corrupt("tile group before a frame header");
    BitReader br(d, sz);
    int num_tiles = tile_cols * tile_rows;
    int tg_start = 0, tg_end = num_tiles - 1;
    if (num_tiles > 1 && br.f(1)) {
      int bits = tile_cols_log2 + tile_rows_log2;
      tg_start = br.f(bits);
      tg_end = br.f(bits);
    }
    br.byte_align();
    size_t off = br.pos / 8;
    if (tg_start == 0) alloc_frame();
    if (tg_end < tg_start || tg_end >= num_tiles) corrupt("tile group range");
    for (int t = tg_start; t <= tg_end; t++) {
      int tr = t / tile_cols, tc = t % tile_cols;
      size_t tsize;
      if (t == tg_end) {
        if (off > sz) corrupt("tile data");
        tsize = sz - off;
      } else {
        if (off + tile_size_bytes > sz) corrupt("tile size");
        tsize = 0;
        for (int i = 0; i < tile_size_bytes; i++)
          tsize |= (size_t)d[off + i] << (8 * i);
        tsize += 1;
        off += tile_size_bytes;
        if (off + tsize > sz) corrupt("tile size");
      }
      mi_row_start = mi_row_starts[tr];
      mi_row_end = mi_row_starts[tr + 1];
      mi_col_start = mi_col_starts[tc];
      mi_col_end = mi_col_starts[tc + 1];
      current_q = base_q_idx;
      cdf.init(base_q_idx);
      sd.init(d + off, tsize, disable_cdf_update);
      if (rec) emit(kRecTile, &t, 1);
      decode_tile();
      off += tsize;
    }
    if (tg_end == num_tiles - 1) {
      frame_done = true;
      apply_filters();
    }
  }

  // --- Tiles and blocks (5.11) ------------------------------------------

  void decode_tile() {
    for (int p = 0; p < 3; p++) {
      std::fill(above_level[p].begin(), above_level[p].end(), 0);
      std::fill(above_dc[p].begin(), above_dc[p].end(), 0);
    }
    for (int i = 0; i < 4; i++) delta_lf[i] = 0;
    for (int p = 0; p < num_planes; p++)
      for (int pass = 0; pass < 2; pass++) {
        ref_sgr_xqd[p][pass] = Sgrproj_Xqd_Mid[pass];
        for (int i = 0; i < 3; i++)
          ref_lr_wiener[p][pass][i] = Wiener_Taps_Mid[i];
      }
    int sb_size = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    int sb4 = kNum4x4W[sb_size];
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < 3; p++) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = delta_q_present;
        clear_cdef(r, c);
        clear_block_decoded(r, c, sb4);
        read_lr(r, c, sb_size);
        decode_partition(r, c, sb_size);
      }
      // dav1d refuses a tile whose symbol decoder read more than 14
      // bits past its data (SymbolMaxBits < -14).
      if (sd.max_bits < -14) corrupt("the symbol decoder read past a tile");
    }
  }

  // --- Loop restoration units (5.11.57-58) ------------------------------

  void read_lr(int r, int c, int bsize) {
    if (allow_intrabc) return;
    for (int p = 0; p < num_planes; p++) {
      if (lr_type[p] == RESTORE_NONE) continue;
      int row0, row1, col0, col1;
      lr_units_of(p, r, c, bsize, &row0, &row1, &col0, &col1);
      for (int ur = row0; ur < row1; ur++)
        for (int uc = col0; uc < col1; uc++) read_lr_unit(p, ur, uc);
    }
  }

  void read_lr_unit(int p, int ur, int uc) {
    LrUnit& u = lr_units[p][(size_t)ur * lr_unit_cols[p] + uc];
    int t;
    if (lr_type[p] == RESTORE_WIENER) {
      t = sd.symbol(cdf.use_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
    } else if (lr_type[p] == RESTORE_SGRPROJ) {
      t = sd.symbol(cdf.use_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    } else {
      t = sd.symbol(cdf.restoration_type, 3);
      tools |= kFilterSwitchable;
    }
    u.type = (uint8_t)t;
    if (t == RESTORE_WIENER) {
      tools |= kFilterWiener;
      for (int pass = 0; pass < 2; pass++) {
        int first = p ? 1 : 0;
        u.wiener[pass][0] = 0;
        for (int j = first; j < 3; j++) {
          int v = signed_subexp_with_ref(Wiener_Taps_Min[j],
                                         Wiener_Taps_Max[j] + 1,
                                         Wiener_Taps_K[j],
                                         ref_lr_wiener[p][pass][j]);
          u.wiener[pass][j] = (int8_t)v;
          ref_lr_wiener[p][pass][j] = v;
        }
      }
    } else if (t == RESTORE_SGRPROJ) {
      tools |= kFilterSgrproj;
      int set = sd.literal(4);
      u.sgr_set = (uint8_t)set;
      if (Sgr_Params[set][0] == 0) tools |= kFilterSgrR0Zero;
      if (Sgr_Params[set][2] == 0) tools |= kFilterSgrR1Zero;
      for (int i = 0; i < 2; i++) {
        int radius = Sgr_Params[set][i * 2];
        int mn = Sgrproj_Xqd_Min[i], mx = Sgrproj_Xqd_Max[i], v = 0;
        if (radius)
          v = signed_subexp_with_ref(mn, mx + 1, 4, ref_sgr_xqd[p][i]);
        else if (i == 1)
          v = clip3(mn, mx, 128 - ref_sgr_xqd[p][0]);
        u.xqd[i] = (int8_t)v;
        ref_sgr_xqd[p][i] = v;
      }
    }
    if (rec) {
      int32_t e[10] = {p, ur, uc, t};
      if (t == RESTORE_WIENER) {
        for (int k = 0; k < 6; k++) e[4 + k] = u.wiener[k / 3][k % 3];
        emit(kRecLr, e, 10);
      } else if (t == RESTORE_SGRPROJ) {
        e[4] = u.sgr_set;
        e[5] = u.xqd[0];
        e[6] = u.xqd[1];
        emit(kRecLr, e, 7);
      } else {
        emit(kRecLr, e, 4);
      }
    }
  }

  int signed_subexp_with_ref(int low, int high, int k, int r) {
    int mx = high - low, ref = r - low;
    int v = subexp(mx, k);
    int x = (ref << 1) <= mx ? inverse_recenter(ref, v)
                             : mx - 1 - inverse_recenter(mx - 1 - ref, v);
    return x + low;
  }

  int subexp(int num_syms, int k) {
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k, a = 1 << b2;
      if (num_syms <= mk + 3 * a) return sd.ns(num_syms - mk) + mk;
      if (!sd.literal(1)) return sd.literal(b2) + mk;
      i++;
      mk += a;
    }
  }

  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
  }

  // --- The in-loop filters (av1_filters.inc) -----------------------------

  void apply_filters();
  void loop_filter_frame();
  void edge_loop_filter(int plane, int pass, int row, int col);
  void filter_level(int row, int col, int plane, int pass, int* lvl,
                    int* limit, int* blimit, int* thresh);
  void sample_filtering(uint8_t* px, int step, int plane, int limit,
                        int blimit, int thresh, int filter_size);
  void cdef_frame(Plane* out);
  int cdef_direction(int r, int c, int* var);
  void cdef_filter(Plane* out, int plane, int r, int c, int pri, int sec,
                   int damping, int dir);
  void lr_frame(const Plane* cdef, Plane* out);
  void lr_rect(int plane, const LrUnit& u, const Plane& cdef, Plane& out,
               int x0, int x1, int y0, int y1, int stripe0, int stripe1);

  // --- Film grain (av1_grain.inc), on the planes handed out --------------

  int grain_tmpl[3][73][82];
  void apply_grain(uint8_t* const out[3]);

  void clear_block_decoded(int r, int c, int sb4) {
    for (int p = 0; p < num_planes; p++) {
      int sx = p ? seq.ssx : 0, sy = p ? seq.ssy : 0;
      int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); y++)
        for (int x = -1; x <= (sb4 >> sx); x++) {
          uint8_t v;
          if (y < 0 && x < sbw4) v = 1;
          else if (x < 0 && y < sbh4) v = 1;
          else v = 0;
          block_decoded[p][y + 1][x + 1] = v;
        }
      block_decoded[p][(sb4 >> sy) + 1][0] = 0;
    }
  }

  void decode_partition(int r, int c, int bsize) {
    if (r >= mi_rows || c >= mi_cols) return;
    int num4 = kNum4x4W[bsize], half = num4 >> 1, quarter = half >> 1;
    int has_rows = (r + half) < mi_rows, has_cols = (c + half) < mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      int n;
      uint16_t* pc = partition_cdf(r, c, bsize, &n);
      if (has_rows && has_cols) {
        partition = sd.symbol(pc, n);
      } else if (has_cols || has_rows) {
        uint16_t bc[3];
        edge_split_cdf(pc, bsize, has_cols, bc);
        bool saved = sd.no_update;
        sd.no_update = true;
        partition = sd.symbol(bc, 2) ? PARTITION_SPLIT
                    : has_cols ? PARTITION_HORZ : PARTITION_VERT;
        sd.no_update = saved;
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    if (partition > PARTITION_SPLIT) tools |= kToolExtPartition;
    if (rec && bsize >= BLOCK_8X8) {
      int32_t e[4] = {r, c, bsize, partition};
      emit(kRecPart, e, 4);
    }
    // At 4:2:2 a vertical split's halves (w/2 x h) have no chroma size
    // (Subsampled_Size is BLOCK_INVALID: a conformance requirement of
    // 5.11.4), and dav1d refuses the stream.
    if (num_planes > 1 && seq.ssx && !seq.ssy &&
        (partition == PARTITION_VERT || partition == PARTITION_VERT_A ||
         partition == PARTITION_VERT_B || partition == PARTITION_VERT_4))
      corrupt("a vertical partition at 4:2:2");
    int sub = partition_subsize(partition, bsize);
    int split = partition_subsize(PARTITION_SPLIT, bsize);
    if (sub == BLOCK_INVALID) corrupt("partition");
    switch (partition) {
      case PARTITION_NONE: decode_block(r, c, sub); break;
      case PARTITION_HORZ:
        decode_block(r, c, sub);
        if (has_rows) decode_block(r + half, c, sub);
        break;
      case PARTITION_VERT:
        decode_block(r, c, sub);
        if (has_cols) decode_block(r, c + half, sub);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, split);
        decode_block(r, c + half, split);
        decode_block(r + half, c, sub);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, sub);
        decode_block(r + half, c, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, split);
        decode_block(r + half, c, split);
        decode_block(r, c + half, sub);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, sub);
        decode_block(r, c + half, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || r + quarter * 3 < mi_rows)
            decode_block(r + quarter * i, c, sub);
        break;
      case PARTITION_VERT_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || c + quarter * 3 < mi_cols)
            decode_block(r, c + quarter * i, sub);
        break;
    }
  }

  void decode_block(int r, int c, int bsize) {
    start_block(r, c, bsize);
    int bw4 = kNum4x4W[bsize], bh4 = kNum4x4H[bsize];
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (seq.ssy && bh4 == 1) avail_u_chroma = is_inside(r - 2, c);
      if (seq.ssx && bw4 == 1) avail_l_chroma = is_inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = 0;
    }
    if (has_chroma &&
        subsampled_size(bsize, seq.ssx, seq.ssy) == BLOCK_INVALID)
      corrupt("block size for the subsampling");
    intra_frame_mode_info();
    palette_tokens();
    var_leaves.clear();
    read_block_tx_size();
    if (rec) block_record();
    if (skip) reset_block_context(bw4, bh4);
    store_block(y_mode, skip, mv[0], mv[1], pal_size_y, pal_size_uv, pal_y,
                pal_u);
    for (int y = 0; y < bh4 && r + y < mi_rows; y++)
      for (int x = 0; x < bw4 && c + x < mi_cols; x++) {
        size_t i = mi_index(r + y, c + x);
        uv_modes[i] = (uint8_t)uv_mode;
        for (int k = 0; k < 4; k++) delta_lfs[i * 4 + k] = (int8_t)delta_lf[k];
      }
    if (is_inter) predict_intrabc();
    residual();
  }

  // The block's kRecBlock entry, and its colour maps' kRecMap entries.
  void block_record() {
    std::vector<int32_t> e(kBFixed, 0);
    e[kBRow] = mi_row;
    e[kBCol] = mi_col;
    e[kBSize] = mi_size;
    e[kBSkip] = skip;
    e[kBSegment] = segment_id;
    e[kBCdef] = cdef_idx.empty() ? -1 : cdef_at(mi_row, mi_col);
    e[kBQindex] = current_q;
    for (int k = 0; k < 4; k++) e[kBDeltaLf + k] = delta_lf[k];
    e[kBIntrabc] = use_intrabc;
    e[kBMv] = mv[0];
    e[kBMv + 1] = mv[1];
    e[kBYMode] = y_mode;
    e[kBAngleY] = angle_delta_y;
    e[kBUvMode] = uv_mode;
    e[kBAngleUv] = angle_delta_uv;
    e[kBCflU] = cfl_alpha_u;
    e[kBCflV] = cfl_alpha_v;
    e[kBFilterIntra] = use_filter_intra;
    e[kBFilterMode] = use_filter_intra ? filter_intra_mode : 0;
    e[kBPalY] = pal_size_y;
    e[kBPalUv] = pal_size_uv;
    for (int k = 0; k < 8; k++) {
      e[kBPalColors + k] = k < pal_size_y ? pal_y[k] : 0;
      e[kBPalColors + 8 + k] = k < pal_size_uv ? pal_u[k] : 0;
      e[kBPalColors + 16 + k] = k < pal_size_uv ? pal_v[k] : 0;
    }
    e[kBTxSize] = tx_size;
    e.push_back((int32_t)var_leaves.size() / 3);
    e.insert(e.end(), var_leaves.begin(), var_leaves.end());
    emit(kRecBlock, e.data(), e.size());
    for (int p = 0; p < 2; p++) {
      int n = p ? pal_size_uv : pal_size_y;
      if (!n) continue;
      int onh = imin(4 * kNum4x4H[mi_size], (mi_rows - mi_row) * 4);
      int onw = imin(4 * kNum4x4W[mi_size], (mi_cols - mi_col) * 4);
      if (p) {
        onh >>= seq.ssy;
        onw >>= seq.ssx;
        if ((4 * kNum4x4W[mi_size]) >> seq.ssx < 4) onw += 2;
        if ((4 * kNum4x4H[mi_size]) >> seq.ssy < 4) onh += 2;
      }
      std::vector<int32_t> m = {p, onw, onh};
      uint8_t(*map)[64] = p ? color_map_uv : color_map_y;
      for (int i = 0; i < onh; i++)
        for (int j = 0; j < onw; j++) m.push_back(map[i][j]);
      emit(kRecMap, m.data(), m.size());
    }
  }

  void intra_frame_mode_info() {
    skip = 0;
    if (seg_id_pre_skip) intra_segment_id();
    read_skip();
    if (!seg_id_pre_skip) intra_segment_id();
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = 0;
    use_intrabc = allow_intrabc ? sd.symbol(cdf.intrabc, 2) : 0;
    is_inter = use_intrabc;
    mv[0] = mv[1] = 0;
    if (use_intrabc) {
      // is_inter, SIMPLE motion, BILINEAR filters and no palette; the
      // modes later blocks read as context are DC_PRED, as libaom and
      // dav1d store them.
      tools |= kIntrabc;
      y_mode = uv_mode = DC_PRED;
      angle_delta_y = angle_delta_uv = 0;
      cfl_alpha_u = cfl_alpha_v = 0;
      pal_size_y = pal_size_uv = 0;
      memset(pal_y, 0, sizeof(pal_y));
      memset(pal_u, 0, sizeof(pal_u));
      use_filter_intra = 0;
      assign_dv();
      return;
    }
    y_mode = sd.symbol(y_mode_cdf(), 13);
    angle_delta_y = 0;
    if (mi_size >= BLOCK_8X8 && y_mode >= V_PRED && y_mode <= D67_PRED)
      angle_delta_y = sd.symbol(cdf.angle_delta[y_mode - V_PRED], 7) - 3;
    uv_mode = DC_PRED;
    angle_delta_uv = 0;
    cfl_alpha_u = cfl_alpha_v = 0;
    if (has_chroma) {
      if (cfl_allowed())
        uv_mode = sd.symbol(cdf.uv_cfl[y_mode], 14);
      else
        uv_mode = sd.symbol(cdf.uv_nocfl[y_mode], 13);
      if (uv_mode == UV_CFL_PRED) {
        read_cfl_alphas();
        tools |= kToolCfl;
      }
      if (mi_size >= BLOCK_8X8 && uv_mode >= V_PRED && uv_mode <= D67_PRED)
        angle_delta_uv = sd.symbol(cdf.angle_delta[uv_mode - V_PRED], 7) - 3;
    }
    pal_size_y = pal_size_uv = 0;
    memset(pal_y, 0, sizeof(pal_y));
    memset(pal_u, 0, sizeof(pal_u));
    if (mi_size >= BLOCK_8X8 && 4 * kNum4x4W[mi_size] <= 64 &&
        4 * kNum4x4H[mi_size] <= 64 && allow_sct)
      palette_mode_info();
    use_filter_intra = 0;
    if (seq.enable_filter_intra && y_mode == DC_PRED && pal_size_y == 0 &&
        imax(4 * kNum4x4W[mi_size], 4 * kNum4x4H[mi_size]) <= 32) {
      use_filter_intra = sd.symbol(cdf.filter_intra[mi_size], 2);
      if (use_filter_intra) {
        filter_intra_mode = sd.symbol(cdf.filter_intra_mode, 5);
        tools |= kToolFilterIntra;
      }
    }
  }

  void intra_segment_id() {
    if (seg_enabled) read_segment_id();
    else segment_id = 0;
    lossless = lossless_array[segment_id];
  }

  void read_segment_id() {
    int ctx, pred = segment_pred(&ctx);
    if (skip) {
      segment_id = pred;
      return;
    }
    tools |= kToolSegments;
    int s = sd.symbol(cdf.segment_id[ctx], 8);
    int mx = last_active_seg_id + 1;
    segment_id = clip3(0, last_active_seg_id, neg_deinterleave(s, pred, mx));
  }

  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
      if (diff <= 2 * ref) {
        if (diff & 1) return ref + ((diff + 1) >> 1);
        return ref - (diff >> 1);
      }
      return diff;
    }
    if (diff <= 2 * (max - ref - 1)) {
      if (diff & 1) return ref + ((diff + 1) >> 1);
      return ref - (diff >> 1);
    }
    return max - (diff + 1);
  }

  void read_skip() {
    if (seg_id_pre_skip && seg_feature_active(6)) {
      skip = 1;
      return;
    }
    skip = sd.symbol(cdf.skip[skip_ctx()], 2);
  }

  void read_cdef() {
    if (skip || coded_lossless || !seq.enable_cdef || allow_intrabc) return;
    int r = mi_row & ~15, c = mi_col & ~15;
    if (cdef_at(r, c) == -1) {
      int v = sd.literal(cdef_bits);
      int w4 = kNum4x4W[mi_size], h4 = kNum4x4H[mi_size];
      for (int y = r; y < r + h4; y += 16)
        for (int x = c; x < c + w4; x += 16) cdef_at(y, x) = (int8_t)v;
    }
  }

  void read_delta_qindex() {
    int sb = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb && skip) return;
    if (read_deltas) {
      int a = sd.symbol(cdf.delta_q, 4);
      if (a == 3) {
        int rb = sd.literal(3) + 1;
        a = sd.literal(rb) + (1 << rb) + 1;
      }
      if (a) {
        tools |= kToolDeltaQ;
        int sign = sd.literal(1);
        int red = sign ? -a : a;
        current_q = clip3(1, 255, current_q + (red << delta_q_res));
      }
    }
  }

  void read_delta_lf() {
    int sb = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb && skip) return;
    if (read_deltas && delta_lf_present) {
      int cnt = 1;
      if (delta_lf_multi) cnt = num_planes > 1 ? 4 : 2;
      for (int i = 0; i < cnt; i++) {
        uint16_t* c = delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf;
        int a = sd.symbol(c, 4);
        if (a == 3) {
          int n = sd.literal(3) + 1;
          a = sd.literal(n) + (1 << n) + 1;
        }
        if (a) {
          int sign = sd.literal(1);
          int red = sign ? -a : a;
          delta_lf[i] = clip3(-63, 63, delta_lf[i] + red * (1 << delta_lf_res));
          tools |= kFilterDeltaLf;
        }
      }
    }
  }

  void read_cfl_alphas() {
    int signs = sd.symbol(cdf.cfl_sign, 8);
    int su = (signs + 1) / 3, sv = (signs + 1) % 3;
    if (su) {
      int ctx = (su - 1) * 3 + sv;
      cfl_alpha_u = 1 + sd.symbol(cdf.cfl_alpha[ctx], 16);
      if (su == 1) cfl_alpha_u = -cfl_alpha_u;
    } else {
      cfl_alpha_u = 0;
    }
    if (sv) {
      int ctx = (sv - 1) * 3 + su;
      cfl_alpha_v = 1 + sd.symbol(cdf.cfl_alpha[ctx], 16);
      if (sv == 1) cfl_alpha_v = -cfl_alpha_v;
    } else {
      cfl_alpha_v = 0;
    }
  }

  // --- Intra block copy (5.11.23-5.11.32, 7.10.2, 7.11.3) ---------------

  int ibc_tmp[128 + 7][128];  // predict_intrabc's horizontal pass

  // assign_mv(0) for use_intrabc (5.11.26): FrameState's dv_ref, plus
  // read_mv.
  void assign_dv() {
    int pred[2];
    tools |= dv_ref(pred) ? kIntrabcStackDv : kIntrabcDefaultDv;
    // read_mv under MV_INTRABC_CONTEXT: whole samples only.
    int joint = sd.symbol(cdf.mv_joint, 4);
    mv[0] = pred[0] + (joint == 2 || joint == 3 ? read_mv_component(0) : 0);
    mv[1] = pred[1] + (joint == 1 || joint == 3 ? read_mv_component(1) : 0);
    if (!dv_valid())
      corrupt("an intra block copy vector outside the decoded area");
  }

  int read_mv_component(int comp) {
    int sign = sd.symbol(cdf.mv_sign[comp], 2);
    int cls = sd.symbol(cdf.mv_class[comp], 11);
    int mag;
    if (cls == 0) {
      mag = ((sd.symbol(cdf.mv_class0[comp], 2) << 3) | 7) + 1;
    } else {
      int d = 0;
      for (int i = 0; i < cls; i++)
        d |= sd.symbol(cdf.mv_bits[comp][i], 2) << i;
      mag = (2 << (cls + 2)) + ((d << 3) | 7) + 1;
    }
    return sign ? -mag : mag;
  }

  // is_mv_valid for an intra block copy (the specification's, which is
  // libaom's av1_is_dv_valid): whole samples, the source inside the tile
  // (a sub-8x8 chroma block's 4 more samples too), in a superblock decoded
  // INTRABC_DELAY_SB64 64-sample columns before this one, inside the
  // wavefront. dav1d does not check it and copies what its frame buffer
  // holds there, which no decoder repeats: the port refuses it.
  bool dv_valid() const {
    if (abs(mv[0]) >= (1 << 14) || abs(mv[1]) >= (1 << 14)) return false;
    if ((mv[0] & 7) || (mv[1] & 7)) return false;
    int bw = 4 * kNum4x4W[mi_size], bh = 4 * kNum4x4H[mi_size];
    int top = mi_row * 4 + (mv[0] >> 3), left = mi_col * 4 + (mv[1] >> 3);
    int bottom = top + bh, right = left + bw;
    int t_top = mi_row_start * 4, t_left = mi_col_start * 4;
    if (top < t_top || left < t_left || bottom > mi_row_end * 4 ||
        right > mi_col_end * 4)
      return false;
    if (has_chroma) {
      if (bw < 8 && seq.ssx && left < t_left + 4) return false;
      if (bh < 8 && seq.ssy && top < t_top + 4) return false;
    }
    int sb_log2 = seq.sb128 ? 5 : 4, sb_size = 4 << sb_log2;
    int active_row = mi_row >> sb_log2, active_col64 = (mi_col * 4) >> 6;
    int src_row = (bottom - 1) / sb_size, src_col64 = (right - 1) >> 6;
    int per_row = ((mi_col_end - mi_col_start - 1) >> 4) + 1;
    if (src_row * per_row + src_col64 >=
        active_row * per_row + active_col64 - 4)
      return false;
    int wf_offset = (5 + (sb_size > 64)) * (active_row - src_row);
    return src_row <= active_row && src_col64 < active_col64 - 4 + wf_offset;
  }

  // compute_prediction for an intra block copy (7.11.3): someUseIntra is
  // always 1 in an intra frame (every block's RefFrame[0] is INTRA_FRAME),
  // so each plane is predicted whole with this block's vector, the chroma
  // of a sub-8x8 block over the 4x4 chroma block it shares. The reference
  // is the frame being decoded, before any filter, clamped to MiCols x
  // MiRows; BILINEAR taps, InterRound0 3 and InterRound1 11 at 8 bits.
  void predict_intrabc() {
    for (int p = 0; p < 1 + 2 * has_chroma; p++) {
      int sx = p ? seq.ssx : 0, sy = p ? seq.ssy : 0;
      int psz = subsampled_size(mi_size, sx, sy);
      int w = 4 * kNum4x4W[psz], h = 4 * kNum4x4H[psz];
      if (p && ((sx && kNum4x4W[mi_size] == 1) ||
                (sy && kNum4x4H[mi_size] == 1)))
        tools |= kIntrabcSub8x8Chroma;
      int x = (mi_col >> sx) * 4, y = (mi_row >> sy) * 4;
      // motion_vector_scaling with a reference of the frame's own size
      int start_x = (((x << 4) + ((2 * mv[1]) >> sx)) << 6) + 32;
      int start_y = (((y << 4) + ((2 * mv[0]) >> sy)) << 6) + 32;
      int last_x = ((mi_cols * 4 + sx) >> sx) - 1;
      int last_y = ((mi_rows * 4 + sy) >> sy) - 1;
      Plane& P = planes[p];
      int (*inter)[128] = ibc_tmp;
      for (int r = 0; r < h + 7; r++) {
        int ry = clip3(0, last_y, (start_y >> 10) + r - 3);
        for (int c = 0; c < w; c++) {
          int pos = start_x + 1024 * c, f = (pos >> 6) & 15;
          int x0 = (pos >> 10) - 3;
          int a = *P.at(ry, clip3(0, last_x, x0 + 3));
          int b = *P.at(ry, clip3(0, last_x, x0 + 4));
          inter[r][c] = round2((128 - 8 * f) * a + 8 * f * b, 3);
        }
      }
      for (int r = 0; r < h; r++) {
        int pos = (start_y & 1023) + 1024 * r, f = (pos >> 6) & 15;
        int r0 = (pos >> 10) + 3;
        for (int c = 0; c < w; c++) {
          int v = round2((128 - 8 * f) * inter[r0][c] +
                         8 * f * inter[r0 + 1][c], 11);
          *P.at(y + r, x + c) = (uint8_t)clip3(0, 255, v);
        }
      }
    }
  }

  void palette_mode_info() {
    int bsize_ctx = kMiWLog2[mi_size] + kMiHLog2[mi_size] - 2;
    const int bd = 8;
    if (y_mode == DC_PRED) {
      if (sd.symbol(cdf.pal_y_mode[bsize_ctx][palette_mode_ctx()], 2)) {
        pal_size_y = sd.symbol(cdf.pal_y_size[bsize_ctx], 7) + 2;
        uint16_t cache[16];
        int cn = get_palette_cache(0, cache), idx = 0;
        for (int i = 0; i < cn && idx < pal_size_y; i++)
          if (sd.literal(1)) pal_y[idx++] = cache[i];
        if (idx < pal_size_y) pal_y[idx++] = (uint16_t)sd.literal(bd);
        int bits = 0;
        if (idx < pal_size_y) bits = bd - 3 + sd.literal(2);
        while (idx < pal_size_y) {
          int delta = sd.literal(bits) + 1;
          pal_y[idx] = (uint16_t)imin(pal_y[idx - 1] + delta, 255);
          int range = (1 << bd) - pal_y[idx] - 1;
          bits = imin(bits, ceil_log2(range));
          idx++;
        }
        std::sort(pal_y, pal_y + pal_size_y);
      }
    }
    if (has_chroma && uv_mode == DC_PRED) {
      int ctx = pal_size_y > 0;
      if (sd.symbol(cdf.pal_uv_mode[ctx], 2)) {
        pal_size_uv = sd.symbol(cdf.pal_uv_size[bsize_ctx], 7) + 2;
        uint16_t cache[16];
        int cn = get_palette_cache(1, cache), idx = 0;
        for (int i = 0; i < cn && idx < pal_size_uv; i++)
          if (sd.literal(1)) pal_u[idx++] = cache[i];
        if (idx < pal_size_uv) pal_u[idx++] = (uint16_t)sd.literal(bd);
        int bits = 0;
        if (idx < pal_size_uv) bits = bd - 3 + sd.literal(2);
        while (idx < pal_size_uv) {
          int delta = sd.literal(bits);
          pal_u[idx] = (uint16_t)imin(pal_u[idx - 1] + delta, 255);
          int range = (1 << bd) - pal_u[idx];
          bits = imin(bits, ceil_log2(range));
          idx++;
        }
        std::sort(pal_u, pal_u + pal_size_uv);
        if (sd.literal(1)) {
          int maxv = 1 << bd;
          int vbits = bd - 4 + sd.literal(2);
          pal_v[0] = (uint16_t)sd.literal(bd);
          for (idx = 1; idx < pal_size_uv; idx++) {
            int delta = sd.literal(vbits);
            if (delta && sd.literal(1)) delta = -delta;
            int val = pal_v[idx - 1] + delta;
            if (val < 0) val += maxv;
            if (val >= maxv) val -= maxv;
            pal_v[idx] = (uint16_t)clip3(0, 255, val);
          }
        } else {
          for (idx = 0; idx < pal_size_uv; idx++)
            pal_v[idx] = (uint16_t)sd.literal(bd);
        }
      }
    }
  }

  void read_color_map(uint8_t map[64][64], int n, int plane, int bw, int bh,
                      int onw, int onh) {
    map[0][0] = (uint8_t)sd.ns(n);
    int order[8], ctx;
    for (int i = 1; i < onh + onw - 1; i++)
      for (int j = imin(i, onw - 1); j >= imax(0, i - onh + 1); j--) {
        ctx = color_context(&map[0][0], 64, i - j, j, n, order);
        if (ctx == 255) corrupt("palette colour context");
        int s = sd.symbol(cdf.pal_color[plane][n - 2][ctx], n);
        map[i - j][j] = (uint8_t)order[s];
      }
    for (int i = 0; i < onh; i++)
      for (int j = onw; j < bw; j++) map[i][j] = map[i][onw - 1];
    for (int i = onh; i < bh; i++)
      for (int j = 0; j < bw; j++) map[i][j] = map[onh - 1][j];
  }

  void palette_tokens() {
    int bh = 4 * kNum4x4H[mi_size], bw = 4 * kNum4x4W[mi_size];
    int onh = imin(bh, (mi_rows - mi_row) * 4);
    int onw = imin(bw, (mi_cols - mi_col) * 4);
    if (pal_size_y) read_color_map(color_map_y, pal_size_y, 0, bw, bh, onw, onh);
    if (pal_size_uv) {
      bh >>= seq.ssy;
      bw >>= seq.ssx;
      onh >>= seq.ssy;
      onw >>= seq.ssx;
      if (bw < 4) {
        bw += 2;
        onw += 2;
      }
      if (bh < 4) {
        bh += 2;
        onh += 2;
      }
      read_color_map(color_map_uv, pal_size_uv, 1, bw, bh, onw, onh);
    }
  }

  // read_block_tx_size (5.11.15-17): an inter block (an intra block copy)
  // that is not skipped takes the var-tx tree; every other block one
  // TxSize, which is also its InterTxSizes.
  void read_block_tx_size() {
    int bw4 = kNum4x4W[mi_size], bh4 = kNum4x4H[mi_size];
    if (tx_mode_select && mi_size > BLOCK_4X4 && is_inter && !skip &&
        !lossless) {
      int max_tx = max_tx_rect(mi_size);
      int tw4 = kTxW[max_tx] >> 2, th4 = kTxH[max_tx] >> 2;
      for (int r = mi_row; r < mi_row + bh4; r += th4)
        for (int c = mi_col; c < mi_col + bw4; c += tw4)
          read_var_tx_size(r, c, max_tx, 0);
      return;
    }
    read_tx_size(!skip || !is_inter);
    for (int r = mi_row; r < imin(mi_rows, mi_row + bh4); r++)
      for (int c = mi_col; c < imin(mi_cols, mi_col + bw4); c++)
        tx_sizes[mi_index(r, c)] = (uint8_t)tx_size;
  }

  void read_var_tx_size(int row, int col, int txsz, int depth) {
    if (row >= mi_rows || col >= mi_cols) return;
    int split = 0;
    if (txsz != TX_4X4 && depth < 2) {  // MAX_VARTX_DEPTH
      split = sd.symbol(cdf.txfm_split[var_tx_ctx(row, col, txsz)], 2);
      if (split) tools |= kIntrabcVarTx;
    }
    int w4 = kTxW[txsz] >> 2, h4 = kTxH[txsz] >> 2;
    if (rec && !split) var_leaves.insert(var_leaves.end(), {row, col, txsz});
    if (split) {
      int sub = kSplitTx[txsz];
      int sw = kTxW[sub] >> 2, sh = kTxH[sub] >> 2;
      for (int i = 0; i < h4; i += sh)
        for (int j = 0; j < w4; j += sw)
          read_var_tx_size(row + i, col + j, sub, depth + 1);
      return;
    }
    for (int i = 0; i < h4 && row + i < mi_rows; i++)
      for (int j = 0; j < w4 && col + j < mi_cols; j++)
        tx_sizes[mi_index(row + i, col + j)] = (uint8_t)txsz;
    tx_size = txsz;
  }

  void read_tx_size(int allow_select) {
    if (lossless) {
      tx_size = TX_4X4;
      return;
    }
    int max_rect = max_tx_rect(mi_size);
    tx_size = max_rect;
    if (mi_size > BLOCK_4X4 && allow_select && tx_mode_select) {
      int n;
      uint16_t* c = tx_depth_cdf(max_rect, &n);
      int depth = sd.symbol(c, n);
      for (int i = 0; i < depth; i++) tx_size = kSplitTx[tx_size];
    }
  }

  // --- Residual (5.11.34-39) and reconstruction --------------------------

  void residual() {
    residual_blocks(tx_size, [&](int p, int bx, int by, int txsz, int x,
                                 int y) {
      transform_block(p, bx, by, txsz, x, y);
    });
  }

  void transform_block(int plane, int base_x, int base_y, int txsz, int x,
                       int y) {
    int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    int sx = plane ? seq.ssx : 0, sy = plane ? seq.ssy : 0;
    int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    int sb_mask = seq.sb128 ? 31 : 15;
    int sbr = row & sb_mask, sbc = col & sb_mask;
    int stepx = kTxW[txsz] >> 2, stepy = kTxH[txsz] >> 2;
    int max_x = (mi_cols * 4) >> sx, max_y = (mi_rows * 4) >> sy;
    if (start_x >= max_x || start_y >= max_y) return;
    // An inter block (an intra block copy) was predicted whole before
    // its residual (predict_intrabc).
    if (!is_inter && ((plane == 0 && pal_size_y) ||
                      (plane != 0 && pal_size_uv))) {
      tools |= kToolPalette;
      predict_palette(plane, start_x, start_y, x, y, txsz);
    } else if (!is_inter) {
      int is_cfl = plane > 0 && uv_mode == UV_CFL_PRED;
      int mode = plane == 0 ? y_mode : (is_cfl ? DC_PRED : uv_mode);
      int have_left = (plane == 0 ? avail_l : avail_l_chroma) || x > 0;
      int have_above = (plane == 0 ? avail_u : avail_u_chroma) || y > 0;
      int above_rt = block_decoded[plane][(sbr >> sy) - 1 + 1]
                                  [(sbc >> sx) + stepx + 1];
      int below_lt = block_decoded[plane][(sbr >> sy) + stepy + 1]
                                  [(sbc >> sx) - 1 + 1];
      predict_intra(plane, start_x, start_y, have_left, have_above, above_rt,
                    below_lt, mode, kTxWLog2[txsz], kTxHLog2[txsz]);
      if (is_cfl) predict_cfl(plane, start_x, start_y, txsz);
    }
    if (plane == 0) {
      max_luma_w = start_x + stepx * 4;
      max_luma_h = start_y + stepy * 4;
    }
    if (!skip) {
      int eob = coeffs(plane, start_x, start_y, txsz);
      if (eob > 0) reconstruct(plane, start_x, start_y, txsz);
    }
    for (int i = 0; i < stepy; i++)
      for (int j = 0; j < stepx; j++) {
        lf_tx[plane][(size_t)((row >> sy) + i) * lf_tx_stride + (col >> sx) +
                     j] = (uint8_t)txsz;
        int rr = (sbr >> sy) + i + 1, cc = (sbc >> sx) + j + 1;
        if (rr < 34 && cc < 34) block_decoded[plane][rr][cc] = 1;
      }
  }

  // --- Prediction (7.11.2) ----------------------------------------------

  void predict_palette(int plane, int sx0, int sy0, int x, int y, int txsz) {
    int w = kTxW[txsz], h = kTxH[txsz];
    const uint16_t* pal = plane == 0 ? pal_y : plane == 1 ? pal_u : pal_v;
    uint8_t(*map)[64] = plane == 0 ? color_map_y : color_map_uv;
    Plane& P = planes[plane];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++)
        *P.at(sy0 + i, sx0 + j) = (uint8_t)pal[map[y * 4 + i][x * 4 + j]];
  }

  int is_smooth(int r, int c, int plane) {
    int mode = plane == 0 ? y_modes[mi_index(r, c)] : uv_modes[mi_index(r, c)];
    return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED ||
           mode == SMOOTH_H_PRED;
  }

  int get_filter_type(int plane) {
    int as = 0, ls = 0;
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (seq.ssx && !(mi_col & 1)) c++;
        if (seq.ssy && (mi_row & 1)) r--;
      }
      as = is_smooth(r, c, plane);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (seq.ssx && (mi_col & 1)) c--;
        if (seq.ssy && !(mi_row & 1)) r++;
      }
      ls = is_smooth(r, c, plane);
    }
    return as || ls;
  }

  static int edge_strength(int w, int h, int type, int delta) {
    int d = delta < 0 ? -delta : delta, wh = w + h, s = 0;
    if (type == 0) {
      if (wh <= 8) {
        if (d >= 56) s = 1;
      } else if (wh <= 12) {
        if (d >= 40) s = 1;
      } else if (wh <= 16) {
        if (d >= 40) s = 1;
      } else if (wh <= 24) {
        if (d >= 8) s = 1;
        if (d >= 16) s = 2;
        if (d >= 32) s = 3;
      } else if (wh <= 32) {
        if (d >= 1) s = 1;
        if (d >= 4) s = 2;
        if (d >= 32) s = 3;
      } else {
        if (d >= 1) s = 3;
      }
    } else {
      if (wh <= 8) {
        if (d >= 40) s = 1;
        if (d >= 64) s = 2;
      } else if (wh <= 16) {
        if (d >= 20) s = 1;
        if (d >= 48) s = 2;
      } else if (wh <= 24) {
        if (d >= 4) s = 3;
      } else {
        if (d >= 1) s = 3;
      }
    }
    return s;
  }

  static int use_upsample(int w, int h, int type, int delta) {
    int d = delta < 0 ? -delta : delta, wh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return type == 0 ? wh <= 16 : wh <= 8;
  }

  // buf points at index 0 of an edge with index -1 (and -2) valid.
  void edge_filter(int* buf, int sz, int strength) {
    if (!strength) return;
    tools |= kToolEdgeFilter;
    int edge[300];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        int k = clip3(0, sz - 1, i - 2 + j);
        s += kIntraEdgeKernel[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
  }

  static void edge_upsample(int* buf, int num_px) {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
    dup[num_px + 2] = buf[num_px - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < num_px; i++) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = clip3(0, 255, round2(s, 4));
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, int have_left, int have_above,
                     int above_rt, int below_lt, int mode, int log2w,
                     int log2h) {
    Plane& P = planes[plane];
    int w = 1 << log2w, h = 1 << log2h;
    int sx = plane ? seq.ssx : 0, sy = plane ? seq.ssy : 0;
    int max_x = ((mi_cols * 4) >> sx) - 1, max_y = ((mi_rows * 4) >> sy) - 1;
    int above_buf[300], left_buf[300];
    int* above = above_buf + 16;
    int* left = left_buf + 16;
    for (int i = 0; i < w + h; i++) {
      if (!have_above && have_left) above[i] = *P.at(y, x - 1);
      else if (!have_above && !have_left) above[i] = 127;
      else {
        int lim = imin(max_x, x + (above_rt ? 2 * w : w) - 1);
        above[i] = *P.at(y - 1, imin(lim, x + i));
      }
    }
    for (int i = 0; i < w + h; i++) {
      if (!have_left && have_above) left[i] = *P.at(y - 1, x);
      else if (!have_left && !have_above) left[i] = 129;
      else {
        int lim = imin(max_y, y + (below_lt ? 2 * h : h) - 1);
        left[i] = *P.at(imin(lim, y + i), x - 1);
      }
    }
    if (have_above && have_left) above[-1] = *P.at(y - 1, x - 1);
    else if (have_above) above[-1] = *P.at(y - 1, x);
    else if (have_left) above[-1] = *P.at(y, x - 1);
    else above[-1] = 128;
    left[-1] = above[-1];
    int (*pred)[64] = pred_buf;
    if (plane == 0 && use_filter_intra) {
      filter_intra(above, left, w, h, pred);
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      directional(plane, x, y, have_left, have_above, mode, w, h, max_x,
                  max_y, above, left, pred);
    } else if (mode == SMOOTH_PRED) {
      tools |= kToolSmooth;
      const uint8_t* wx = sm_weights(log2w);
      const uint8_t* wy = sm_weights(log2h);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] +
                  wx[j] * left[i] + (256 - wx[j]) * above[w - 1];
          pred[i][j] = round2(s, 9);
        }
    } else if (mode == SMOOTH_V_PRED) {
      const uint8_t* wy = sm_weights(log2h);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] =
              round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
    } else if (mode == SMOOTH_H_PRED) {
      const uint8_t* wx = sm_weights(log2w);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] =
              round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
    } else if (mode == DC_PRED) {
      int avg;
      if (have_left && have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        for (int k = 0; k < h; k++) sum += left[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += left[k];
        avg = clip3(0, 255, (sum + (h >> 1)) >> log2h);
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        avg = clip3(0, 255, (sum + (w >> 1)) >> log2w);
      } else {
        avg = 128;
      }
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) pred[i][j] = avg;
    } else {  // PAETH
      tools |= kToolPaeth;
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int base = above[j] + left[i] - above[-1];
          int pl = abs(base - left[i]), pt = abs(base - above[j]),
              ptl = abs(base - above[-1]);
          if (pl <= pt && pl <= ptl) pred[i][j] = left[i];
          else if (pt <= ptl) pred[i][j] = above[j];
          else pred[i][j] = above[-1];
        }
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) *P.at(y + i, x + j) = (uint8_t)pred[i][j];
  }

  static const uint8_t* sm_weights(int log2) {
    static const int off[7] = {0, 0, 0, 4, 12, 28, 60};
    return Sm_Weights + off[log2];
  }

  void filter_intra(const int* above, const int* left, int w, int h,
                    int pred[64][64]) {
    int w4 = w >> 2, h2 = h >> 1;
    for (int i2 = 0; i2 < h2; i2++)
      for (int j4 = 0; j4 < w4; j4++) {
        int p[7];
        for (int i = 0; i < 7; i++) {
          if (i < 5) {
            if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
            else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
            else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
          } else {
            if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
            else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
          }
        }
        for (int i = 0; i < 8; i++) {
          int pr = 0;
          for (int j = 0; j < 7; j++)
            pr += Filter_Intra_Taps[filter_intra_mode][i][j] * p[j];
          pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] =
              clip3(0, 255, round2signed(pr, 4));
        }
      }
  }

  void directional(int plane, int x, int y, int have_left, int have_above,
                   int mode, int w, int h, int max_x, int max_y, int* above,
                   int* left, int pred[64][64]) {
    int delta = plane == 0 ? angle_delta_y : angle_delta_uv;
    int p_angle = kModeToAngle[mode] + delta * 3;
    tools |= kToolDirectional | (delta ? kToolAngleDelta : 0);
    int up_above = 0, up_left = 0;
    if (seq.enable_intra_edge) {
      if (p_angle != 90 && p_angle != 180) {
        if (p_angle > 90 && p_angle < 180 && (w + h) >= 24) {
          int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
          left[-1] = above[-1] = v;
        }
        int ft = get_filter_type(plane);
        if (have_above) {
          int st = edge_strength(w, h, ft, p_angle - 90);
          int num = imin(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
          edge_filter(above, num, st);
        }
        if (have_left) {
          int st = edge_strength(w, h, ft, p_angle - 180);
          int num = imin(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
          edge_filter(left, num, st);
        }
      }
      int ft = get_filter_type(plane);
      up_above = use_upsample(w, h, ft, p_angle - 90);
      int num = w + (p_angle < 90 ? h : 0);
      if (up_above) edge_upsample(above, num);
      if (up_above) tools |= kToolUpsample;
      up_left = use_upsample(w, h, ft, p_angle - 180);
      num = h + (p_angle > 180 ? w : 0);
      if (up_left) edge_upsample(left, num);
    }
    int dx = 0, dy = 0;
    if (p_angle < 90) dx = Dr_Intra_Derivative[p_angle];
    else if (p_angle > 90 && p_angle < 180)
      dx = Dr_Intra_Derivative[180 - p_angle];
    if (p_angle > 90 && p_angle < 180) dy = Dr_Intra_Derivative[p_angle - 90];
    else if (p_angle > 180) dy = Dr_Intra_Derivative[270 - p_angle];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int v;
        if (p_angle < 90) {
          int idx = (i + 1) * dx;
          int base = (idx >> (6 - up_above)) + (j << up_above);
          int shift = ((idx << up_above) >> 1) & 0x1f;
          int max_base = (w + h - 1) << up_above;
          if (base < max_base)
            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          else
            v = above[max_base];
        } else if (p_angle > 90 && p_angle < 180) {
          int idx = (j << 6) - (i + 1) * dx;
          int base = idx >> (6 - up_above);
          if (base >= -(1 << up_above)) {
            int shift = ((idx * (1 << up_above)) >> 1) & 0x1f;
            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          } else {
            idx = (i << 6) - (j + 1) * dy;
            base = idx >> (6 - up_left);
            int shift = ((idx * (1 << up_left)) >> 1) & 0x1f;
            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
          }
        } else if (p_angle > 180) {
          int idx = (j + 1) * dy;
          int base = (idx >> (6 - up_left)) + (i << up_left);
          int shift = ((idx << up_left) >> 1) & 0x1f;
          v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
        } else if (p_angle == 90) {
          v = above[j];
        } else {
          v = left[i];
        }
        pred[i][j] = v;
      }
  }

  void predict_cfl(int plane, int sx0, int sy0, int txsz) {
    int w = kTxW[txsz], h = kTxH[txsz];
    int ssx = seq.ssx, ssy = seq.ssy;
    int alpha = plane == 1 ? cfl_alpha_u : cfl_alpha_v;
    int (*L)[64] = pred_buf;
    int64_t sum = 0;
    Plane& Y = planes[0];
    for (int i = 0; i < h; i++) {
      int ly = imin((sy0 + i) << ssy, max_luma_h - (1 << ssy));
      for (int j = 0; j < w; j++) {
        int lx = imin((sx0 + j) << ssx, max_luma_w - (1 << ssx));
        int t = 0;
        for (int dy = 0; dy <= ssy; dy++)
          for (int dx = 0; dx <= ssx; dx++) t += *Y.at(ly + dy, lx + dx);
        int v = t << (3 - ssx - ssy);
        L[i][j] = v;
        sum += v;
      }
    }
    int avg = round2(sum, kTxWLog2[txsz] + kTxHLog2[txsz]);
    Plane& P = planes[plane];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        uint8_t* px = P.at(sy0 + i, sx0 + j);
        int scaled = round2signed((int64_t)alpha * (L[i][j] - avg), 6);
        *px = (uint8_t)clip3(0, 255, *px + scaled);
      }
  }

  // --- Coefficients (5.11.39) -------------------------------------------

  void read_tx_type(int x4, int y4, int txsz) {
    int set = get_tx_set(txsz);
    int t = DCT_DCT;
    int q = seg_enabled ? get_qindex(1, segment_id) : base_q_idx;
    if (set > 0 && q > 0 && is_inter) {
      int sqr = kTxSqr[txsz];
      if (set == 1) t = kTxInterInv1[sd.symbol(cdf.inter_set1[sqr], 16)];
      else if (set == 2) t = kTxInterInv2[sd.symbol(cdf.inter_set2, 12)];
      else t = sd.symbol(cdf.inter_set3[sqr], 2) ? DCT_DCT : IDTX;
      tools |= kIntrabcTxSet1 << (set - 1);
    } else if (set > 0 && q > 0) {
      int dir = use_filter_intra ? kFilterIntraModeToDir[filter_intra_mode]
                                 : y_mode;
      int sqr = kTxSqr[txsz];
      if (set == 1) t = kTxInv1[sd.symbol(cdf.tx_set1[sqr][dir], 7)];
      else t = kTxInv2[sd.symbol(cdf.tx_set2[sqr][dir], 5)];
    }
    set_tx_type(x4, y4, txsz, t);
  }

  int coeffs(int plane, int sx0, int sy0, int txsz) {
    int x4 = sx0 >> 2, y4 = sy0 >> 2;
    int ctx_sz = (kTxSqr[txsz] + kTxSqrUp[txsz] + 1) >> 1;
    int ptype = plane > 0;
    int seg_eob = (txsz == TX_16X64 || txsz == TX_64X16)
                      ? 512
                      : imin(1024, kTxW[txsz] * kTxH[txsz]);
    memset(quant, 0, sizeof(int32_t) * seg_eob);
    int eob = 0, cul = 0, dc_cat = 0;
    int all_zero =
        sd.symbol(cdf.txb_skip[ctx_sz][txb_skip_ctx(plane, x4, y4, txsz)], 2);
    if (all_zero) {
      if (plane == 0) set_tx_type(x4, y4, txsz, DCT_DCT);
    } else {
      if (plane == 0) read_tx_type(x4, y4, txsz);
      plane_tx_type = compute_tx_type(plane, txsz, x4, y4);
      int cls = tx_class(plane_tx_type);
      const uint16_t* scan = get_scan(txsz);
      int n;
      uint16_t* eob_cdf = eob_pt_cdf(txsz, ptype, cls, &n);
      int eob_pt = sd.symbol(eob_cdf, n) + 1;
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int eob_shift = eob_pt - 3;
      if (eob_shift >= 0) {
        if (sd.symbol(cdf.eob_extra[ctx_sz][ptype][eob_pt - 3], 2))
          eob += 1 << eob_shift;
        for (int i = 1; i < imax(eob_pt - 2, 1); i++) {
          eob_shift = imax(eob_pt - 2, 1) - 1 - i;
          if (sd.literal(1)) eob += 1 << eob_shift;
        }
      }
      if (eob > seg_eob) corrupt("end of block");
      int adj = kAdjustedTx[txsz];
      int bwl = kTxWLog2[adj], txh = kTxH[adj];
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c], level;
        if (c == eob - 1) {
          int cx = coeff_base_eob_ctx(c, bwl, txh);
          level = sd.symbol(cdf.base_eob[ctx_sz][ptype][cx], 3) + 1;
        } else {
          int cx = coeff_base_ctx(txsz, bwl, txh, pos, cls);
          level = sd.symbol(cdf.base[ctx_sz][ptype][cx], 4);
        }
        if (level > 2) {
          int bctx = coeff_br_ctx(bwl, txh, pos, cls);
          for (int idx = 0; idx < 4; idx++) {
            int br = sd.symbol(cdf.br[imin(ctx_sz, 3)][ptype][bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        int pos = scan[c], sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dctx = dc_sign_ctx(plane, x4, y4, txsz);
            sign = sd.symbol(cdf.dc_sign[ptype][dctx], 2);
          } else {
            sign = sd.literal(1);
          }
        }
        if (quant[pos] > 14) {
          int length = 0, bit;
          do {
            length++;
            bit = sd.literal(1);
            if (length > 32) corrupt("golomb");
          } while (!bit);
          int x = 1;
          for (int i = length - 2; i >= 0; i--) x = (x << 1) | sd.literal(1);
          quant[pos] = x + 14;
        }
        if (pos == 0 && quant[pos] > 0) dc_cat = sign ? 1 : 2;
        quant[pos] &= 0xfffff;
        cul += quant[pos];
        if (sign) quant[pos] = -quant[pos];
      }
      cul = imin(63, cul);
    }
    if (rec) {
      std::vector<int32_t> e = {plane, sx0, sy0, txsz,
                                all_zero ? DCT_DCT : plane_tx_type, eob};
      if (eob) {
        const uint16_t* scan = get_scan(txsz);
        for (int c = 0; c < eob; c++) e.push_back(quant[scan[c]]);
      }
      emit(kRecTxb, e.data(), e.size());
    }
    set_coeff_context(plane, x4, y4, txsz, cul, dc_cat);
    return eob;
  }

  int dc_q(int b) { return Dc_Qlookup[clip3(0, 255, b)]; }
  int ac_q(int b) { return Ac_Qlookup[clip3(0, 255, b)]; }

  void reconstruct(int plane, int x, int y, int txsz) {
    int dq_shift = 0;
    int pels = kTxW[txsz] * kTxH[txsz];
    if (pels > 256) dq_shift = 1;
    if (pels > 1024) dq_shift = 2;
    int log2w = kTxWLog2[txsz], log2h = kTxHLog2[txsz];
    int w = 1 << log2w, h = 1 << log2h;
    int tw = imin(32, w), th = imin(32, h);
    int t = plane_tx_type;
    int flip_ud = t == FLIPADST_DCT || t == FLIPADST_ADST || t == V_FLIPADST ||
                  t == FLIPADST_FLIPADST;
    int flip_lr = t == DCT_FLIPADST || t == ADST_FLIPADST || t == H_FLIPADST ||
                  t == FLIPADST_FLIPADST;
    int qi = get_qindex(0, segment_id);
    int dcq, acq;
    if (plane == 0) {
      dcq = dc_q(qi + dq_ydc);
      acq = ac_q(qi);
    } else if (plane == 1) {
      dcq = dc_q(qi + dq_udc);
      acq = ac_q(qi + dq_uac);
    } else {
      dcq = dc_q(qi + dq_vdc);
      acq = ac_q(qi + dq_vac);
    }
    int qml = seg_qm_level[plane][segment_id];
    const uint8_t* qm = nullptr;
    if (!lossless && qml < 15 && t < IDTX)
      qm = &Quantizer_Matrix[(qml * 2 + (plane > 0)) * 3344 + kQmOffset[txsz]];
    int32_t (*dq)[64] = dq_buf;
    for (int i = 0; i < th; i++)
      for (int j = 0; j < tw; j++) {
        int32_t v = quant[i * tw + j];
        if (!v) {
          dq[i][j] = 0;
          continue;
        }
        int q = (i == 0 && j == 0) ? dcq : acq;
        if (qm) q = round2((int64_t)q * qm[i * tw + j], 5);
        int64_t mag = (int64_t)(v < 0 ? -v : v) * q;
        mag &= 0xffffff;
        mag >>= dq_shift;
        int32_t d = (int32_t)(v < 0 ? -mag : mag);
        dq[i][j] = clip3(-(1 << 15), (1 << 15) - 1, d);
      }
    // 2D inverse transform (7.13.3).
    int row_kind, col_kind;
    switch (t) {
      case DCT_DCT: case ADST_DCT: case FLIPADST_DCT: case H_DCT:
        row_kind = T_DCT; break;
      case DCT_ADST: case ADST_ADST: case DCT_FLIPADST: case FLIPADST_FLIPADST:
      case ADST_FLIPADST: case FLIPADST_ADST: case H_ADST: case H_FLIPADST:
        row_kind = T_ADST; break;
      default: row_kind = T_IDN;
    }
    switch (t) {
      case DCT_DCT: case DCT_ADST: case DCT_FLIPADST: case V_DCT:
        col_kind = T_DCT; break;
      case ADST_DCT: case ADST_ADST: case FLIPADST_DCT: case FLIPADST_FLIPADST:
      case ADST_FLIPADST: case FLIPADST_ADST: case V_ADST: case V_FLIPADST:
        col_kind = T_ADST; break;
      default: col_kind = T_IDN;
    }
    if (lossless) tools |= kToolWht;
    if (w == 64 || h == 64) tools |= kToolTx64;
    if (tx_class(t) != TX_CLASS_2D) tools |= kTool1D;
    if (row_kind == T_ADST || col_kind == T_ADST) tools |= kToolAdst;
    if (qm) tools |= kToolQm;
    int row_shift = lossless ? 0 : kRowShift[txsz];
    int col_shift = lossless ? 0 : 4;
    int32_t tmp[64];
    for (int i = 0; i < h; i++) {
      if (i >= 32) {
        for (int j = 0; j < w; j++) resid[i][j] = 0;
        continue;
      }
      for (int j = 0; j < w; j++) tmp[j] = (i < th && j < tw) ? dq[i][j] : 0;
      if (abs(log2w - log2h) == 1)
        for (int j = 0; j < w; j++) tmp[j] = r12((int64_t)tmp[j] * 2896);
      if (lossless) iwht(tmp, 2);
      else inverse_1d(tmp, row_kind, log2w);
      for (int j = 0; j < w; j++)
        resid[i][j] = c16(round2(tmp[j], row_shift));
    }
    for (int j = 0; j < w; j++) {
      for (int i = 0; i < h; i++) tmp[i] = resid[i][j];
      if (lossless) iwht(tmp, 0);
      else inverse_1d(tmp, col_kind, log2h);
      for (int i = 0; i < h; i++) resid[i][j] = round2(tmp[i], col_shift);
    }
    Plane& P = planes[plane];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int xp = x + (flip_lr ? w - j - 1 : j);
        int yp = y + (flip_ud ? h - i - 1 : i);
        uint8_t* px = P.at(yp, xp);
        *px = (uint8_t)clip3(0, 255, *px + resid[i][j]);
      }
  }

  // --- The temporal unit ------------------------------------------------

  // The OBUs of one temporal unit, until the first frame is complete;
  // the OBU headers after it are still read to the end of the sample, and
  // each sequence header among them parsed (dav1d, with frame threads,
  // parses ahead: an OBU past the data or a sequence header that changes
  // fails the decode, also past a later frame).
  void decode(const uint8_t* d, size_t n) {
    size_t pos = 0;
    while (pos < n) {
      BitReader hb(d + pos, n - pos);
      hb.f(1);  // obu_forbidden_bit, ignored as dav1d ignores it
      int type = hb.f(4), ext = hb.f(1), has_size = hb.f(1);
      hb.f(1);
      int tid = 0, sid = 0;
      if (ext) {
        tid = hb.f(3);
        sid = hb.f(2);
        hb.f(3);
      }
      size_t hdr = hb.pos / 8, size;
      if (has_size) {
        uint64_t s = hb.leb128();
        hdr = hb.pos / 8;
        if (s > n - pos - hdr) corrupt("obu_size past the end of the data");
        size = (size_t)s;
      } else {
        size = n - pos - hdr;
      }
      const uint8_t* body = d + pos + hdr;
      pos += hdr + size;
      if (frame_done) {
        if (type == 1) {
          BitReader br(body, size);
          sequence_header(br);
        }
        continue;
      }
      if (type != 1 && type != 2 && ext && seq.valid) {
        int idc = seq.op_idc[0];
        if (idc && (!((idc >> tid) & 1) || !((idc >> (sid + 8)) & 1)))
          continue;
      }
      switch (type) {
        case 1: {  // OBU_SEQUENCE_HEADER
          BitReader br(body, size);
          sequence_header(br);
          br.f(1);  // trailing_one_bit: must be there (dav1d)
          if (rec) emit(kRecSeq, &seq, sizeof(seq) / 4);
          break;
        }
        case 3:   // OBU_FRAME_HEADER
        case 6: {  // OBU_FRAME
          BitReader br(body, size);
          frame_header(br, tid, sid);
          if (type == 3) br.f(1);  // trailing_one_bit (dav1d)
          if (rec) {
            emit(kRecFrame, &fh, sizeof(fh) / 4);
            size_t n = rec->size();
            rec->insert(rec->end(), (const int32_t*)&grain,
                        (const int32_t*)&grain + sizeof(grain) / 4);
            (*rec)[n - 1 - sizeof(fh) / 4] += sizeof(grain) / 4;
          }
          if (header_only) {
            frame_done = true;
            break;
          }
          if (type == 6) {
            br.byte_align();
            size_t off = br.pos / 8;
            tile_group(body + off, size - off);
          }
          break;
        }
        case 4:  // OBU_TILE_GROUP
          tile_group(body, size);
          break;
        case 7:  // OBU_REDUNDANT_FRAME_HEADER
          break;
        default:  // temporal delimiter, metadata, tile list, padding,
          break;  // reserved: skipped, as dav1d skips them
      }
    }
    if (!frame_done) corrupt("no complete frame in the data");
  }
};

// ---------------------------------------------------------------------------
// YUV to RGB(A) as Pillow gets it from libavif 1.3 (avifImageYUVToRGB with
// Pillow's defaults: 8-bit RGB or RGBA, automatic chroma upsampling,
// alpha not premultiplied), which hands 8-bit images to the libyuv built
// into Pillow's wheel:
// - the matrix: BT.601 (libyuv's I601 and JPEG constants) for matrix
//   coefficients 2 (unspecified), 5 and 6, BT.709 (H709, F709) for 1,
//   BT.2020 (2020, V2020) for 9; 12 (chroma-derived) takes the one its
//   colour primaries name (1 and 2: BT.709, 5 and 6: BT.601, 9: BT.2020).
//   The range is the colr box's full_range_flag, else the sequence
//   header's color_range. Each pixel is libyuv's YuvPixel (row_common.cc):
//   y1 = (y * 0x0101 * YG) >> 16, then (y1 + u * UB - BB) >> 6 and so on,
//   clamped; libyuv built without LIBYUV_UNLIMITED_DATA (UB <= 128).
// - chroma: libyuv's bilinear 2x upsampling (I420ToRGB24MatrixFilter and
//   kin, kFilterBilinear): rows (3a + b + 2) >> 2, interior 2x2 cells
//   (9a + 3b + 3c + d + 8) >> 4, the first and last output row and column
//   taken from the nearest chroma row alone, and the last output column
//   from chroma column (w - 1) / 2 alone (libyuv's _Any rows), which at
//   an odd width is not the blend.
// - 4:0:0: Y alone, through YuvPixel with u = v = 128: with an alpha
//   plane the matrix's constants, without one (I400ToARGB) the BT.2020
//   ones whatever the matrix (YG 19003 at limited range).
// - identity (0), 4:4:4 only: G = Y, B = U, R = V at full range (libavif's
//   avifImageIdentity8ToRGB8ColorFullRange); at limited range libavif's
//   float routine (avif_reformat.inc).
// - alpha: the alpha item's Y plane as it is (libavif 1.x treats alpha as
//   full range). Premultiplied alpha (a prem reference) is undone by
//   libyuv's ARGBUnattenuate as its SIMD rows compute it:
//   ((c | c << 8) * ia) >> 16, ia = 65536 / a (0 for a = 0, 0xffff for
//   a = 1, 0x100 for a = 255), packed with signed saturation: 255 above
//   255, 0 above 32767.
// Other matrix coefficients go through libavif's own float routines
// (avif_reformat.inc).

struct YuvConstants {
  int ub, ug, vg, vr, yg, yb;
};
const YuvConstants kYuv[2][3] = {
    // limited: I601, H709, 2020
    {{128, 25, 52, 102, 18997, -1160},
     {128, 14, 34, 115, 18997, -1160},
     {128, 12, 42, 107, 19003, -1160}},
    // full: JPEG, F709, V2020
    {{113, 22, 46, 90, 16320, 32},
     {119, 12, 30, 101, 16320, 32},
     {120, 11, 37, 94, 16320, 32}}};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

void yuv_pixel(int y, int u, int v, const YuvConstants& c, uint8_t* rgb) {
  int y1 = (int)(((uint32_t)(y * 0x0101) * (uint32_t)c.yg) >> 16);
  int bb = c.ub * 128 - c.yb, bg = c.ug * 128 + c.vg * 128 + c.yb,
      br = c.vr * 128 - c.yb;
  rgb[2] = clamp255((y1 + u * c.ub - bb) >> 6);
  rgb[1] = clamp255((y1 + bg - (u * c.ug + v * c.vg)) >> 6);
  rgb[0] = clamp255((y1 + v * c.vr - br) >> 6);
}

// One chroma row upsampled 2x horizontally to w samples (w <= 2 cw).
void up_row(const uint8_t* s, int cw, int w, int* out) {
  if (cw == 1) {
    for (int x = 0; x < w; x++) out[x] = s[0];
    return;
  }
  out[0] = s[0];
  for (int k = 0; k + 1 < cw; k++) {
    if (2 * k + 1 < w) out[2 * k + 1] = (s[k] * 3 + s[k + 1] + 2) >> 2;
    if (2 * k + 2 < w) out[2 * k + 2] = (s[k] + s[k + 1] * 3 + 2) >> 2;
  }
  out[w - 1] = s[(w - 1) / 2];
}

// Two chroma rows s (near) and t (far) upsampled 2x2 into one output row.
void up_row2(const uint8_t* s, const uint8_t* t, int cw, int w, int* out) {
  if (cw == 1) {
    for (int x = 0; x < w; x++) out[x] = (s[0] * 3 + t[0] + 2) >> 2;
    return;
  }
  out[0] = (s[0] * 3 + t[0] + 2) >> 2;
  for (int k = 0; k + 1 < cw; k++) {
    int a = s[k], b = s[k + 1], c = t[k], d = t[k + 1];
    if (2 * k + 1 < w) out[2 * k + 1] = (a * 9 + b * 3 + c * 3 + d + 8) >> 4;
    if (2 * k + 2 < w) out[2 * k + 2] = (a * 3 + b * 9 + c + d * 3 + 8) >> 4;
  }
  out[w - 1] = (s[(w - 1) / 2] * 3 + t[(w - 1) / 2] + 2) >> 2;
}

// The chroma of output row yy of plane p (cw x ch) at w samples.
void chroma_row(const uint8_t* p, int cw, int ch, int ssx, int ssy, int yy,
                int w, int* out) {
  if (!ssy) {
    const uint8_t* s = p + (size_t)yy * cw;
    if (ssx) up_row(s, cw, w, out);
    else for (int x = 0; x < w; x++) out[x] = s[x];
    return;
  }
  if (yy == 0 || yy >= 2 * ch - 1 || ch == 1) {
    up_row(p + (size_t)(yy == 0 ? 0 : ch - 1) * cw, cw, w, out);
    return;
  }
  int k = (yy - 1) / 2;  // rows k, k + 1
  const uint8_t* a = p + (size_t)k * cw;
  const uint8_t* b = p + (size_t)(k + 1) * cw;
  if (yy % 2 == 1) up_row2(a, b, cw, w, out);
  else up_row2(b, a, cw, w, out);
}

#include "av1_filters.inc"
#include "av1_grain.inc"
#include "avif_reformat.inc"

}  // namespace

extern "C" {

// Parse and decode one AV1 temporal unit (an AVIF item's data).
// info (int64[16]) out: width, height, mono, ssx, ssy, full_range, cp, tc,
// mc, bit_depth, chroma_sample_position, coded_lossless, tiles, 128x128
// superblocks, header flags (using_qmatrix 1, segmentation 2, delta q 4,
// screen content tools 8, delta lf 16, reduced tx set 32, tx mode select
// 64, disable_cdf_update 128; above them loop_filter_sharpness at bit 8,
// lr_unit_shift (LoopRestorationSize[0] = 64 << it) at 11, lr_uv_shift
// at 13, cdef_bits at 14 and each plane's FrameRestorationType, 2 bits
// from bit 16) and the tools the blocks and
// the in-loop filters used (kTool* and kFilter* bits; 0 when only the
// headers are read). With planes == null only the
// headers are read (through the first frame header; film grain included)
// and the frame is not decoded. planes: Y then U then V, each
// (height >> ss) x (width >> ss) rounded up, tightly packed. msg: the
// reason of a failure (cap bytes). Returns 0, kCorrupt (-1),
// kUnsupported (-2) or kSmall (-3: planes too small).
int64_t tb_av1_decode(const uint8_t* data, int64_t n, uint8_t* planes,
                      int64_t planes_cap, int64_t* info, char* msg,
                      int64_t cap) {
  Decoder* dec = new Decoder();
  dec->header_only = planes == nullptr;
  int64_t rc = kOk;
  try {
    dec->decode(data, (size_t)n);
    const SeqHeader& s = dec->seq;
    int64_t flags = dec->using_qm | dec->seg_enabled << 1 |
                    dec->delta_q_present << 2 | dec->allow_sct << 3 |
                    dec->delta_lf_present << 4 | dec->reduced_tx_set << 5 |
                    dec->tx_mode_select << 6 | dec->disable_cdf_update << 7;
    int lr_shift = 0;
    while (dec->lr_size[0] && (64 << lr_shift) < dec->lr_size[0]) lr_shift++;
    flags |= (int64_t)dec->lf_sharpness << 8 | (int64_t)lr_shift << 11 |
             (int64_t)(dec->lr_size[0] != dec->lr_size[1] &&
                       dec->lr_size[1]) << 13 |
             (int64_t)dec->cdef_bits << 14;
    for (int p = 0; p < 3; p++)
      flags |= (int64_t)dec->lr_type[p] << (16 + 2 * p);
    if (planes) {
      int w = dec->frame_w, h = dec->frame_h;
      int cw = (w + s.ssx) >> s.ssx, ch = (h + s.ssy) >> s.ssy;
      int64_t need = (int64_t)w * h + (s.mono ? 0 : 2 * (int64_t)cw * ch);
      if (need > planes_cap) {
        rc = kSmall;
      } else {
        uint8_t* o = planes;
        uint8_t* out[3] = {nullptr, nullptr, nullptr};
        for (int p = 0; p < (s.mono ? 1 : 3); p++) {
          int pw = p ? cw : w, ph = p ? ch : h;
          out[p] = o;
          for (int y = 0; y < ph; y++) {
            memcpy(o, dec->planes[p].at(y, 0), pw);
            o += pw;
          }
        }
        dec->apply_grain(out);
      }
    }
    int64_t v[16] = {dec->frame_w, dec->frame_h, s.mono, s.ssx, s.ssy,
                     s.full_range, s.cp, s.tc, s.mc, s.bit_depth, s.csp,
                     dec->coded_lossless, dec->tile_cols * dec->tile_rows,
                     s.sb128, flags, (int64_t)dec->tools};
    for (int i = 0; i < 16; i++) info[i] = v[i];
  } catch (const Error& e) {
    rc = e.code;
    if (msg && cap > 0) {
      strncpy(msg, e.what, (size_t)cap - 1);
      msg[cap - 1] = 0;
    }
  } catch (const std::exception& e) {
    rc = kCorrupt;
    if (msg && cap > 0) {
      strncpy(msg, e.what(), (size_t)cap - 1);
      msg[cap - 1] = 0;
    }
  }
  delete dec;
  return rc;
}

// The decision record (av1_syntax.inc) of one AV1 temporal unit: what its
// sequence header, frame header and tiles decided, as the decoder read
// them. out (int32[cap]) gets the record; returns its length (more than
// cap: nothing useful was written, call again with that much room), or
// kCorrupt or kUnsupported with the reason in msg (cap bytes).
int64_t tb_av1_record(const uint8_t* data, int64_t n, int32_t* out,
                      int64_t cap, char* msg, int64_t msg_cap) {
  Decoder* dec = new Decoder();
  std::vector<int32_t> rec;
  dec->rec = &rec;
  int64_t rc;
  try {
    dec->decode(data, (size_t)n);
    rc = (int64_t)rec.size();
    if (rc <= cap) memcpy(out, rec.data(), rec.size() * 4);
  } catch (const Error& e) {
    rc = e.code;
    if (msg && msg_cap > 0) {
      strncpy(msg, e.what, (size_t)msg_cap - 1);
      msg[msg_cap - 1] = 0;
    }
  }
  delete dec;
  return rc;
}

// Y, U, V (U and V null for 4:0:0) of a w x h image to RGB, or RGBA with
// alpha (an h x w plane) not null. kind: 0 BT.601, 1 BT.709, 2 BT.2020,
// 3 identity at full range (libyuv's routines and libavif's copy), 4
// libavif's float routines with the Kr and Kb of matrix coefficients mc
// under colour primaries cp, 5 its float YCgCo, 6 its float identity
// (avif_reformat.inc). Returns 0, or -1 for a kind or layout it
// does not take.
int64_t tb_avif_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                       int64_t w, int64_t h, int64_t ssx, int64_t ssy,
                       int64_t full, const uint8_t* alpha,
                       int64_t premultiplied, uint8_t* out, int64_t cp,
                       int64_t mc) {
  const int kind = avif_route((int)cp, (int)mc, (int)full, !u, alpha != nullptr,
                              (int)ssx, (int)ssy);
  if (kind < 0) return kind;
  if (kind >= kFloatCoeffs) {
    float_to_rgb(y, u, v, (int)w, (int)h, (int)ssx, (int)ssy, (int)kind,
                 (int)full, (int)cp, (int)mc, alpha, (int)premultiplied,
                 out);
    return 0;
  }
  int ch_n = alpha ? 4 : 3;
  int cw = (int)((w + ssx) >> ssx), chh = (int)((h + ssy) >> ssy);
  std::vector<int> ur(w), vr(w);
  const YuvConstants& c = kYuv[full ? 1 : 0][kind == 3 ? 0 : kind];
  for (int64_t yy = 0; yy < h; yy++) {
    const uint8_t* yrow = y + yy * w;
    uint8_t* o = out + yy * w * ch_n;
    if (u && kind != 3) {
      chroma_row(u, cw, chh, (int)ssx, (int)ssy, (int)yy, (int)w, ur.data());
      chroma_row(v, cw, chh, (int)ssx, (int)ssy, (int)yy, (int)w, vr.data());
    }
    for (int64_t x = 0; x < w; x++) {
      uint8_t* px = o + x * ch_n;
      if (kind == 3) {
        px[0] = v[yy * w + x];
        px[1] = yrow[x];
        px[2] = u[yy * w + x];
      } else if (u) {
        yuv_pixel(yrow[x], ur[x], vr[x], c, px);
      } else {
        yuv_pixel(yrow[x], 128, 128, c, px);
      }
      if (alpha) {
        px[3] = alpha[yy * w + x];
        if (premultiplied) unattenuate(px);
      }
    }
  }
  return 0;
}

}  // extern "C"
