// JPEG entropy decoding, lossless undifferencing, block smoothing,
// inverse DCT, chroma upsampling and colour conversion, with libjpeg-
// turbo's integer arithmetic so that the pixels equal what PIL (on
// libjpeg-turbo 3.1, default decompression settings) returns, bit for bit.
//
// core/jpeg.py parses the markers and calls this file:
// - tb_jpeg_scan once a scan (SOS) of a DCT frame: Huffman- or
//   arithmetic-decodes the scan's entropy-coded segment into the
//   coefficient blocks of its components (sequential and progressive,
//   restart intervals included);
// - tb_jpeg_lossless_scan once a scan of a lossless frame: decodes,
//   undifferences and point-transforms its samples;
// - tb_jpeg_pixels once at the end: dequantises, block-smooths where
//   libjpeg does, runs the islow IDCT on every block (a lossless frame
//   takes its samples), upsamples each component to the full image and
//   converts the colours.
// Host code, compiled with g++ at first use into the port's build
// directory (utils/build.py) and called through ctypes.
//
// Where libjpeg's arithmetic is easy to lose (each has a test of its own
// in tests/test_torch_jpeg.py or tests/test_torch_jpeg_variants.py):
// - jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2, DESCALE
//   rounding, integer dequantisation and the DC-only shortcuts of both
//   passes; the output is clamped to [0, 255] as the SIMD version that
//   PIL runs saturates it, where the C version's lookup through
//   prepare_range_limit_table (index & RANGE_MASK) wraps values beyond
//   +-512 (out_sample);
// - jdsample.c: fancy (triangle) upsampling rounds h2v1 with +1/+2, h2v2
//   with +8/+7 on column sums, h1v2 (libjpeg-turbo's) with +1/+2; the
//   context rows above the first and below the last row replicate the
//   edge rows (jdmainct.c); fancy h2v1/h2v2 only where the component's
//   downsampled width is above 2, every other integral ratio replicates
//   (int_upsample), and so does every ratio of a lossless frame;
// - jdcolor.c ycc_rgb_convert: SCALEBITS 16 fixed-point tables and the
//   sample range limit; ycck_cmyk_convert: the same on Y, Cb and Cr,
//   then 255 less each clamped value (255 - clamp(v) equals libjpeg's
//   range_limit[255 - v]), K passed through;
// - jdphuff.c: DC first/refine, AC first with EOBRUN, the AC refinement
//   scan's correction bits; a restart resets the DC predictors and
//   EOBRUN; a non-interleaved scan covers ceil(component width / 8)
//   blocks a row, not the MCU-padded count;
// - jdarith.c: the QM decoder's registers (two bytes read before the
//   first decision, zeros fed from a marker on), the statistics of each
//   of 16 tables shared by the components that name it and cleared at
//   each scan and restart, the DC context from the DAC bounds L and U,
//   AC magnitudes from bin 189 or 217 by K, signs and refinement bits
//   at the fixed bin; an overflow stops the blocks until the restart
//   (ct = -1), as libjpeg does;
// - jdlossls.c / jddiffct.c: sums modulo 2^16, the point transform's
//   shift cast to 8 bits, predictors 5-7 with arithmetic shifts, and a
//   restart's predictor reset taking effect at the first row of the iMCU
//   row it falls in (the rows are undifferenced after the whole iMCU row
//   is decoded);
// - jdcoefct.c decompress_smooth_data (idct_smoothed): the 5x5 kernels,
//   the DC interpolation when no AC coefficient is known, the clamp of an
//   estimate to the bits still unknown, and libjpeg's row indexing in a
//   component's last iMCU row.
// Corrupt Huffman-coded data is an error here (libjpeg warns and
// substitutes zeros).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// Zigzag index -> natural (row-major) index, with libjpeg's 16 extra
// entries for a run that overshoots 63 in corrupt data.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kLookBits = 9;

struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: longer code
};

// jdhuff.c jpeg_make_d_derived_tbl. bits[1..16] code counts, vals the
// symbols, each at most max_symbol (a DC table's 15, or 16 in a lossless
// frame; 255). Returns false on a table no canonical code fits.
bool build_huff(const uint8_t* bits, const uint8_t* vals, int max_symbol,
                Huff* h) {
  int size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = bits[l];
    if (p + n > 256) return false;
    while (n--) size[p++] = l;
  }
  size[p] = 0;
  const int nsym = p;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      h->valoffset[l] = p - static_cast<int32_t>(code_of[p]);
      p += bits[l];
      h->maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->valoffset[17] = 0;
  h->maxcode[17] = 0xFFFFF;
  std::memcpy(h->vals, vals, 256);
  for (int i = 0; i < nsym; ++i)
    if (vals[i] > max_symbol) return false;
  std::memset(h->look, 0, sizeof(h->look));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      const uint32_t lo = code_of[p] << (kLookBits - l);
      for (uint32_t j = 0; j < (1u << (kLookBits - l)); ++j)
        h->look[lo + j] = static_cast<uint16_t>((l << 8) | vals[p]);
    }
  }
  return true;
}

struct Fail {
  const char* what;
};

// The entropy-coded segment's bits, 0xFF00 unstuffed, stopping at a
// marker. Bits past the data read as zeros; consuming one is an error.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // left-aligned
  int cnt = 0;       // bits in buf
  int fake = 0;      // zero bits appended past the data or a marker
  int marker = -1;   // the marker the reader stopped at

  void fill() {
    while (cnt <= 56) {
      int byte = 0;
      if (marker < 0 && p < end) {
        int c = *p++;
        if (c == 0xFF) {
          int c2 = -1;
          while (p < end) {
            c2 = *p++;
            if (c2 != 0xFF) break;
          }
          if (c2 == 0) {
            byte = 0xFF;
          } else {
            marker = c2;  // -1 when the data ends inside fill bytes
            if (marker < 0) marker = 0x100;
            fake += 8;
          }
        } else {
          byte = c;
        }
      } else {
        fake += 8;
      }
      buf |= static_cast<uint64_t>(byte) << (56 - cnt);
      cnt += 8;
    }
  }
  int peek(int n) {
    if (cnt < n) fill();
    return static_cast<int>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
    if (cnt < fake) throw Fail{"entropy-coded data ends early"};
  }
  int get(int n) {
    if (n == 0) return 0;
    const int v = peek(n);
    skip(n);
    return v;
  }
  int decode(const Huff& h) {
    const int look = h.look[peek(kLookBits)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = peek(l);
    while (code > h.maxcode[l]) {
      ++l;
      if (l > 16) throw Fail{"bad Huffman code"};
      code = peek(l);
    }
    skip(l);
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  // jdhuff.c process_restart: drop the bits left of the byte, then read
  // RSTn (skipping garbage up to the next marker, as libjpeg does).
  void restart(int expect) {
    buf = 0;
    cnt = 0;
    fake = 0;
    while (marker < 0 && p < end) {
      if (*p++ != 0xFF) continue;
      while (p < end && *p == 0xFF) ++p;
      if (p < end && *p != 0) marker = *p++;
    }
    if (marker != 0xD0 + expect) throw Fail{"missing restart marker"};
    marker = -1;
  }
};

inline int extend(int r, int s) {  // HUFF_EXTEND
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

// jaricom.c jpeg_aritab, T.81 Table D.2: per state Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; state 113 is
// the fixed estimate of 1/2 (no adaptation) that signs and refinement bits
// use.
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder registers and byte input. A marker (or the end of
// the segment) met inside the data is legal in arithmetic coding: zeros
// are fed from there on (arith_decode).
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0;  // C register: base of the interval and input bits
  int64_t a = 0;  // A register: the interval's normalised size
  int ct = -16;   // bits left in C's input part; -16: 2 bytes to read
  int marker = -1;
  // jdarith.c's ct = -1: a spectral or magnitude overflow (corrupt data,
  // or a progression that refines what no scan sent) stops the decoding
  // of the blocks until the next restart, with a warning.
  bool dead = false;

  int next_byte() {
    if (marker >= 0) return 0;
    if (p >= end) {
      marker = 0x100;
      return 0;
    }
    int data = *p++;
    if (data != 0xFF) return data;
    do {
      if (p >= end) {
        marker = 0x100;
        return 0;
      }
      data = *p++;
    } while (data == 0xFF);
    if (data == 0) return 0xFF;  // stuffed zero
    marker = data;
    return 0;
  }
  // arith_decode: one binary decision under the statistics bin *st.
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalisation and input, D.2.6
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // 2 bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // conditional MPS exchange
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // process_restart's input half: the RSTn marker (bytes before it
  // skipped, as jdmarker.c next_marker does), then fresh registers.
  void restart(int expect) {
    while (marker < 0 && p < end) {
      if (*p++ != 0xFF) continue;
      while (p < end && *p == 0xFF) ++p;
      if (p < end && *p != 0) marker = *p++;
    }
    if (marker != 0xD0 + expect) throw Fail{"missing restart marker"};
    marker = -1;
    c = a = 0;
    ct = -16;
    dead = false;
  }
};

struct Overflow {};  // ArithReader::dead from here on

struct ScanComp {
  int16_t* coef;  // the component's block array, row-major blocks of 64
  int64_t bw;     // blocks a row of that array
  int h, v;       // sampling factors (interleaved scans)
  int64_t wib, hib;  // width and height in blocks of the component
  const Huff* dc;
  const Huff* ac;
  int last_dc;
  int dc_tbl, ac_tbl;  // arithmetic coding: statistics tables 0-15
  int dc_context;      // arithmetic coding: S0 of the next DC difference
};

// jdarith.c's statistics: 64 DC and 256 AC bins a table, the DAC
// conditioning (L, U, K) of each table, and the scan's MCU decoders.
struct ArithStats {
  uint8_t dc[16][64];
  uint8_t ac[16][256];
  uint8_t fixed_bin = 113;
  const uint8_t* cond;  // L[16], U[16], K[16]

  // Figures F.19-F.24: a DC difference under the component's context.
  int dc_diff(ArithReader& ar, ScanComp& sc) {
    const int tbl = sc.dc_tbl;
    uint8_t* st = dc[tbl] + sc.dc_context;
    if (ar.decode(st) == 0) {
      sc.dc_context = 0;
      return 0;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = dc[tbl] + 20;  // X1
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) throw Overflow{};
        ++st;
      }
    }
    const int lo = (1 << cond[tbl]) >> 1, hi = (1 << cond[16 + tbl]) >> 1;
    if (m < lo)
      sc.dc_context = 0;
    else if (m > hi)
      sc.dc_context = 12 + sign * 4;
    else
      sc.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }
  // Figures F.21-F.24 for AC coefficient k (its sign at the fixed bin).
  int ac_value(ArithReader& ar, int tbl, uint8_t* st, int64_t k) {
    const int sign = ar.decode(&fixed_bin);
    st += 2;
    int m = ar.decode(st);
    if (m != 0 && ar.decode(st)) {
      m <<= 1;
      st = ac[tbl] + (k <= cond[32 + tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) throw Overflow{};
        ++st;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }
  // decode_mcu's and decode_mcu_AC_first's loop over k = ss..se (a run
  // past se, a spectral overflow, throws Overflow).
  void ac_band(ArithReader& ar, int tbl, int16_t* block, int64_t ss,
               int64_t se, int al) {
    for (int64_t k = ss; k <= se; ++k) {
      uint8_t* st = ac[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) throw Overflow{};
      }
      const int v = ac_value(ar, tbl, st, k);
      block[kNatural[k]] =
          static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
  }
  // decode_mcu_AC_refine.
  void ac_refine(ArithReader& ar, int tbl, int16_t* block, int64_t ss,
                 int64_t se, int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    int64_t kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (block[kNatural[kex]]) break;
    for (int64_t k = ss; k <= se; ++k) {
      uint8_t* st = ac[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = block + kNatural[k];
        if (*coef) {  // previously nonzero: a correction bit
          if (ar.decode(st + 2))
            *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) throw Overflow{};
      }
    }
  }
};

}  // namespace

extern "C" {

// Decode one scan into the coefficient arrays.
//   data, len: the scan's entropy-coded segment (restart markers inside).
//   coef: every component's blocks (int16, 64 a block, natural order).
//   geom: per component of the scan, 7 int64: element offset of its
//     array in coef, blocks a row of the array, h, v, width and height in
//     blocks, DC table slot * 16 + AC table slot (slots 0-3, -1 unused).
//   tables: 8 slots (DC 0-3, AC 0-3) of 273 bytes: bits[0..16], 256
//     symbols; present: which slots are defined.
//   mcus_per_row, mcu_rows: the interleaved MCU grid.
//   ss, se, ah, al, progressive: the scan header and the frame type.
//   cond: null for Huffman coding; for arithmetic coding (jdarith.c) the
//     DAC conditioning of tables 0-15, L[16], U[16], K[16], the table
//     selectors of geom then naming statistics tables 0-15.
// Returns 0, or 1 with msg (256 bytes) filled.
int64_t tb_jpeg_scan(const uint8_t* data, int64_t len, int16_t* coef,
                     int64_t ncomp, const int64_t* geom,
                     const uint8_t* tables, const uint8_t* present,
                     int64_t mcus_per_row, int64_t mcu_rows, int64_t ss,
                     int64_t se, int64_t ah, int64_t al,
                     int64_t progressive, int64_t restart_interval,
                     const uint8_t* cond, char* msg) {
  Huff huff[8];
  bool built[8] = {false};
  ScanComp comps[4];
  const bool dc_scan = !progressive || ss == 0;
  const bool needs_dc_table = !progressive || (ss == 0 && ah == 0);
  const bool needs_ac_table = !progressive || ss > 0;
  ArithStats as{};
  as.cond = cond;
  try {
    for (int c = 0; c < ncomp; ++c) {
      const int64_t* g = geom + 7 * c;
      ScanComp& sc = comps[c];
      sc.coef = coef + g[0];
      sc.bw = g[1];
      sc.h = static_cast<int>(g[2]);
      sc.v = static_cast<int>(g[3]);
      sc.wib = g[4];
      sc.hib = g[5];
      sc.last_dc = 0;
      sc.dc = sc.ac = nullptr;
      sc.dc_tbl = static_cast<int>(g[6] >> 4);
      sc.ac_tbl = static_cast<int>(g[6] & 15);
      sc.dc_context = 0;
      if (cond) continue;
      const int slots[2] = {static_cast<int>(g[6] >> 4),
                            4 + static_cast<int>(g[6] & 15)};
      const bool need[2] = {needs_dc_table, needs_ac_table};
      for (int k = 0; k < 2; ++k) {
        if (!need[k]) continue;
        const int s = slots[k];
        if (!present[s]) throw Fail{"scan uses an undefined Huffman table"};
        if (!built[s]) {
          const uint8_t* t = tables + 273 * s;
          if (!build_huff(t, t + 17, k == 0 ? 15 : 255, &huff[s]))
            throw Fail{"bad Huffman table"};
          built[s] = true;
        }
        (k == 0 ? sc.dc : sc.ac) = &huff[s];
      }
    }
    BitReader br{data, data + len};
    ArithReader ar{data, data + len};
    const bool interleaved = ncomp > 1;
    const int64_t n_mcu =
        interleaved ? mcus_per_row * mcu_rows : comps[0].wib * comps[0].hib;
    int64_t eobrun = 0;
    int rst = 0;
    const int p1 = 1 << al;
    const int m1 = -(1 << al);
    // jdarith.c start_pass / process_restart: the statistics of the
    // scan's tables cleared, DC ones only where the scan codes DC values
    // from scratch, AC ones where it codes AC values.
    auto reset_stats = [&]() {
      for (int c = 0; c < ncomp; ++c) {
        if (needs_dc_table) std::memset(as.dc[comps[c].dc_tbl], 0, 64);
        if (needs_ac_table) std::memset(as.ac[comps[c].ac_tbl], 0, 256);
      }
    };
    if (cond) reset_stats();

    auto decode_block_arith = [&](ScanComp& sc, int16_t* block) {
      if (ar.dead) return;
      try {
        if (!progressive) {  // jdarith.c decode_mcu
          sc.last_dc = (sc.last_dc + as.dc_diff(ar, sc)) & 0xFFFF;
          block[0] = static_cast<int16_t>(sc.last_dc);
          as.ac_band(ar, sc.ac_tbl, block, 1, 63, 0);
        } else if (dc_scan && ah == 0) {  // decode_mcu_DC_first
          sc.last_dc = (sc.last_dc + as.dc_diff(ar, sc)) & 0xFFFF;
          block[0] = static_cast<int16_t>(
              static_cast<uint32_t>(sc.last_dc) << al);
        } else if (dc_scan) {  // decode_mcu_DC_refine
          if (ar.decode(&as.fixed_bin))
            block[0] = static_cast<int16_t>(block[0] | p1);
        } else if (ah == 0) {  // decode_mcu_AC_first
          as.ac_band(ar, sc.ac_tbl, block, ss, se, static_cast<int>(al));
        } else {  // decode_mcu_AC_refine
          as.ac_refine(ar, sc.ac_tbl, block, ss, se, static_cast<int>(al));
        }
      } catch (const Overflow&) {
        ar.dead = true;
      }
    };

    auto decode_block = [&](ScanComp& sc, int16_t* block) {
      if (cond) return decode_block_arith(sc, block);
      if (!progressive) {  // jdhuff.c decode_mcu
        int s = br.decode(*sc.dc);
        if (s) s = extend(br.get(s), s);
        sc.last_dc += s;
        block[0] = static_cast<int16_t>(sc.last_dc);
        for (int k = 1; k < 64; ++k) {
          s = br.decode(*sc.ac);
          int r = s >> 4;
          s &= 15;
          if (s) {
            k += r;
            block[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        return;
      }
      if (dc_scan) {
        if (ah == 0) {  // jdphuff.c decode_mcu_DC_first
          int s = br.decode(*sc.dc);
          if (s) s = extend(br.get(s), s);
          sc.last_dc += s;
          block[0] = static_cast<int16_t>(
              static_cast<uint32_t>(sc.last_dc) << al);
        } else if (br.get(1)) {  // decode_mcu_DC_refine
          block[0] = static_cast<int16_t>(block[0] | p1);
        }
        return;
      }
      if (ah == 0) {  // decode_mcu_AC_first
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        for (int64_t k = ss; k <= se; ++k) {
          int s = br.decode(*sc.ac);
          int r = s >> 4;
          s &= 15;
          if (s) {
            k += r;
            const int val = extend(br.get(s), s);
            block[kNatural[k]] =
                static_cast<int16_t>(static_cast<uint32_t>(val) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            --eobrun;
            break;
          }
        }
        return;
      }
      // decode_mcu_AC_refine
      int64_t k = ss;
      if (eobrun == 0) {
        for (; k <= se; ++k) {
          int s = br.decode(*sc.ac);
          int r = s >> 4;
          s &= 15;
          if (s) {
            s = br.get(1) ? p1 : m1;  // libjpeg warns when s != 1
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            break;
          }
          do {
            int16_t* coef_k = block + kNatural[k];
            if (*coef_k != 0) {
              if (br.get(1) && (*coef_k & p1) == 0)
                *coef_k = static_cast<int16_t>(*coef_k + (*coef_k >= 0 ? p1
                                                                      : m1));
            } else if (--r < 0) {
              break;
            }
            ++k;
          } while (k <= se);
          if (s) block[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int16_t* coef_k = block + kNatural[k];
          if (*coef_k != 0 && br.get(1) && (*coef_k & p1) == 0)
            *coef_k = static_cast<int16_t>(*coef_k + (*coef_k >= 0 ? p1 : m1));
        }
        --eobrun;
      }
    };

    for (int64_t m = 0; m < n_mcu; ++m) {
      if (restart_interval > 0 && m > 0 && m % restart_interval == 0) {
        if (cond) {
          ar.restart(rst);
          reset_stats();
        } else {
          br.restart(rst);
        }
        rst = (rst + 1) & 7;
        for (int c = 0; c < ncomp; ++c) comps[c].last_dc = 0;
        for (int c = 0; c < ncomp; ++c) comps[c].dc_context = 0;
        eobrun = 0;
      }
      if (interleaved) {
        const int64_t mr = m / mcus_per_row, mc = m % mcus_per_row;
        for (int c = 0; c < ncomp; ++c) {
          ScanComp& sc = comps[c];
          for (int y = 0; y < sc.v; ++y)
            for (int x = 0; x < sc.h; ++x)
              decode_block(sc, sc.coef + ((mr * sc.v + y) * sc.bw +
                                          mc * sc.h + x) * 64);
        }
      } else {
        ScanComp& sc = comps[0];
        const int64_t r = m / sc.wib, c = m % sc.wib;
        decode_block(sc, sc.coef + (r * sc.bw + c) * 64);
      }
    }
  } catch (const Fail& f) {
    std::snprintf(msg, 256, "%s", f.what);
    return 1;
  }
  return 0;
}

// Decode one scan of a lossless (SOF3) frame into the components' sample
// planes: jdlhuff.c's difference decoding, jddiffct.c's MCU-row loop and
// jdlossls.c's undifferencing and point transform.
//   samples: every component's plane of 8-bit samples.
//   geom: per component of the scan, 7 int64: element offset of its plane
//     in samples, its row stride, h, v, its width and height in samples
//     (width_in_blocks and height_in_blocks of a lossless frame), DC table
//     slot * 16.
//   mcus_per_row, mcu_rows: the interleaved MCU grid, mcu_rows also the
//     frame's iMCU rows.
//   psv, pt: the predictor (Ss) and the point transform (Al).
// Returns 0, or 1 with msg (256 bytes) filled.
int64_t tb_jpeg_lossless_scan(const uint8_t* data, int64_t len,
                              uint8_t* samples, int64_t ncomp,
                              const int64_t* geom, const uint8_t* tables,
                              const uint8_t* present, int64_t mcus_per_row,
                              int64_t mcu_rows, int64_t psv, int64_t pt,
                              int64_t restart_interval, char* msg) {
  Huff huff[4];
  try {
    const bool interleaved = ncomp > 1;
    struct Comp {
      uint8_t* plane;
      int64_t stride, width, height;
      int h, v;
      const Huff* dc;
      std::vector<int> diff, undiff;  // v rows of row_width
      bool first_row;
    };
    std::vector<Comp> comps(static_cast<size_t>(ncomp));
    // Samples an MCU row of the scan: MCUs_per_row, a non-interleaved
    // scan's MCU being one sample.
    const int64_t mpr = interleaved ? mcus_per_row : geom[4];
    for (int c = 0; c < ncomp; ++c) {
      const int64_t* g = geom + 7 * c;
      Comp& cp = comps[c];
      cp.plane = samples + g[0];
      cp.stride = g[1];
      cp.h = static_cast<int>(g[2]);
      cp.v = static_cast<int>(g[3]);
      cp.width = g[4];
      cp.height = g[5];
      const int slot = static_cast<int>(g[6] >> 4);
      if (!present[slot]) throw Fail{"scan uses an undefined Huffman table"};
      const uint8_t* t = tables + 273 * slot;
      if (!build_huff(t, t + 17, 16, &huff[slot]))
        throw Fail{"bad Huffman table"};
      cp.dc = &huff[slot];
      const int64_t row = interleaved ? mpr * cp.h : cp.width;
      cp.diff.assign(static_cast<size_t>(row * cp.v), 0);
      cp.undiff.assign(static_cast<size_t>(row * cp.v), 0);
      cp.first_row = true;
    }
    BitReader br{data, data + len};
    auto diff = [&](const Huff& h) {  // jdlhuff.c decode_mcus
      const int s = br.decode(h);
      if (s == 16) return 32768;
      return s ? extend(br.get(s), s) : 0;
    };
    const int initial = 1 << (8 - pt - 1);
    // jdlossls.c: undifference_first_row (the initial predictor, then
    // Ra), then jpeg_undifference1..7 (Rb in the first column).
    auto undifference = [&](Comp& cp, const int* d, const int* prev,
                            int* out) {
      const int64_t w = cp.width;
      if (cp.first_row) {
        int ra = (d[0] + initial) & 0xFFFF;
        out[0] = ra;
        for (int64_t x = 1; x < w; ++x) out[x] = ra = (d[x] + ra) & 0xFFFF;
        cp.first_row = false;
        return;
      }
      int rb = prev[0];
      int ra = (d[0] + rb) & 0xFFFF;
      out[0] = ra;
      for (int64_t x = 1; x < w; ++x) {
        const int rc = rb;
        rb = prev[x];
        int p;
        switch (psv) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        out[x] = ra = (d[x] + p) & 0xFFFF;
      }
    };
    int64_t rows_to_go = restart_interval / mpr;
    int rst = 0;
    for (int64_t imcu = 0; imcu < mcu_rows; ++imcu) {
      const bool last = imcu == mcu_rows - 1;
      // MCU rows in this iMCU row: one interleaved; a non-interleaved
      // scan's v sample rows, in the last iMCU row only the real ones.
      int64_t mcu_rows_here = 1;
      if (!interleaved) {
        const Comp& cp = comps[0];
        mcu_rows_here = cp.v;
        if (last && cp.height % cp.v) mcu_rows_here = cp.height % cp.v;
      }
      for (int64_t y = 0; y < mcu_rows_here; ++y) {
        if (restart_interval > 0 && rows_to_go == 0) {
          // jddiffct.c process_restart: the predictors restart with the
          // next row undifferenced, which in libjpeg is the first row of
          // this iMCU row however far into it the marker falls.
          br.restart(rst);
          rst = (rst + 1) & 7;
          for (Comp& cp : comps) cp.first_row = true;
          rows_to_go = restart_interval / mpr;
        }
        for (int64_t m = 0; m < mpr; ++m) {
          if (interleaved) {
            for (Comp& cp : comps) {
              const int64_t row = mpr * cp.h;
              for (int yy = 0; yy < cp.v; ++yy)
                for (int xx = 0; xx < cp.h; ++xx)
                  cp.diff[yy * row + m * cp.h + xx] = diff(*cp.dc);
            }
          } else {
            Comp& cp = comps[0];
            cp.diff[y * cp.width + m] = diff(*cp.dc);
          }
        }
        if (restart_interval > 0) --rows_to_go;
      }
      for (Comp& cp : comps) {
        const int64_t row = interleaved ? mpr * cp.h : cp.width;
        int64_t rows = cp.v;
        if (last && cp.height % cp.v) rows = cp.height % cp.v;
        for (int64_t r = 0; r < rows; ++r) {
          const int64_t prev = r == 0 ? cp.v - 1 : r - 1;
          int* out = cp.undiff.data() + r * row;
          undifference(cp, cp.diff.data() + r * row,
                       cp.undiff.data() + prev * row, out);
          uint8_t* o = cp.plane + (imcu * cp.v + r) * cp.stride;
          for (int64_t x = 0; x < cp.width; ++x)
            o[x] = static_cast<uint8_t>(out[x] << pt);  // scaler_scale
        }
      }
    }
  } catch (const Fail& f) {
    std::snprintf(msg, 256, "%s", f.what);
    return 1;
  }
  return 0;
}

}  // extern "C"

namespace {

// The colour converter's sample range limit (jdmaster.c's
// prepare_range_limit_table, 8-bit samples): clamp to [0, 255].
inline uint8_t limit(int x) {
  return static_cast<uint8_t>(std::min(std::max(x, 0), 255));
}

const int kConstBits = 13;
const int kPass1Bits = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// The largest dequantised coefficient and pass-1 value seen. PIL runs
// libjpeg-turbo's SIMD islow IDCT, which holds both in 16-bit lanes:
// products (pmullw), DC-only values shifted by PASS1_BITS and pairwise
// sums wrap there, and pass-1 results saturate (packssdw). Up to
// kMaxDequant and kMaxPass1 none of that can happen and the SIMD code
// computes what this integer code computes; an 8-bit encoder's data stays
// far below (a dequantised coefficient within about 1,200). Beyond them
// the file is refused.
const int64_t kMaxDequant = 8191;
const int64_t kMaxPass1 = 16383;
struct IdctRange {
  int64_t dequant = 0;
  int64_t pass1 = 0;
};

// The output sample of a pass-2 value x (centred on 0): clamp(x, -128,
// 127) + 128, the saturating packs of libjpeg-turbo's SIMD islow IDCT.
// The C code's lookup (prepare_range_limit_table, index & RANGE_MASK)
// wraps instead for |x| >= 512; PIL's pixels are the clamped ones
// (tests/test_torch_jpeg.py::test_idct_output_saturates).
inline uint8_t out_sample(int64_t x) {
  return static_cast<uint8_t>(std::min<int64_t>(std::max<int64_t>(x, -128),
                                                127) + 128);
}

// jidctint.c jpeg_idct_islow: 8x8 block of coefficients (natural order)
// times quant -> 8x8 samples at out (row stride `stride`).
void idct_islow(const int16_t* in, const uint16_t* quant, IdctRange* rng,
                uint8_t* out, int64_t stride) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                F2_562 = 20995, F3_072 = 25172;
  int64_t dq[64];
  int64_t dmax = 0;
  for (int i = 0; i < 64; ++i) {
    dq[i] = int64_t{in[i]} * quant[i];  // DEQUANTIZE, in integer
    dmax = std::max(dmax, dq[i] < 0 ? -dq[i] : dq[i]);
  }
  rng->dequant = std::max(rng->dequant, dmax);
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    const int64_t* col = dq + c;
    int64_t* w = ws + c;
    if (col[8] == 0 && col[16] == 0 && col[24] == 0 && col[32] == 0 &&
        col[40] == 0 && col[48] == 0 && col[56] == 0) {
      const int64_t dc = col[0] * (1 << kPass1Bits);  // DC-only shortcut
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = col[16], z3 = col[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = col[0];
    z3 = col[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = col[56];
    tmp1 = col[40];
    tmp2 = col[24];
    tmp3 = col[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, sh);
    w[56] = descale(tmp10 - tmp3, sh);
    w[8] = descale(tmp11 + tmp2, sh);
    w[48] = descale(tmp11 - tmp2, sh);
    w[16] = descale(tmp12 + tmp1, sh);
    w[40] = descale(tmp12 - tmp1, sh);
    w[24] = descale(tmp13 + tmp0, sh);
    w[32] = descale(tmp13 - tmp0, sh);
  }
  int64_t wmax = 0;
  for (int i = 0; i < 64; ++i) wmax = std::max(wmax, ws[i] < 0 ? -ws[i] : ws[i]);
  rng->pass1 = std::max(rng->pass1, wmax);
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {  // DC-only shortcut
      const uint8_t dc = out_sample(descale(w[0], kPass1Bits + 3));
      for (int x = 0; x < 8; ++x) o[x] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (w[0] + w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (w[0] - w[4]) * (int64_t{1} << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = out_sample(descale(tmp10 + tmp3, sh));
    o[7] = out_sample(descale(tmp10 - tmp3, sh));
    o[1] = out_sample(descale(tmp11 + tmp2, sh));
    o[6] = out_sample(descale(tmp11 - tmp2, sh));
    o[2] = out_sample(descale(tmp12 + tmp1, sh));
    o[5] = out_sample(descale(tmp12 - tmp1, sh));
    o[3] = out_sample(descale(tmp13 + tmp0, sh));
    o[4] = out_sample(descale(tmp13 - tmp0, sh));
  }
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo's 5x5 version), at
// the final output pass: each block of a component is read with its first
// 10 coefficients estimated from the DC values of the 25 blocks around it
// where they are still zero and not known to full precision; with no AC
// coefficient seen at all (change_dc) the DC value is replaced too.
//   blocks: the component's array (bw blocks a row), wib x hib real,
//     v block rows an iMCU row, total_imcu iMCU rows.
//   bits: the latched coef_bits of the first 10 coefficients (zigzag).
// The rows around a block follow libjpeg's indexing, which in the last
// iMCU row of a component whose height in blocks is not a multiple of v
// counts rows as if every iMCU row had that many (image_block_row); the
// columns, its sliding registers (edge blocks repeated).
void idct_smoothed(const int16_t* blocks, int64_t bw, int64_t wib,
                   int64_t hib, int v, int64_t total_imcu,
                   const uint16_t* q, const int64_t* bits, IdctRange* rng,
                   uint8_t* plane, int64_t stride) {
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
  const int64_t q00 = q[0], q01 = q[1], q10 = q[8], q20 = q[16],
                q11 = q[9], q02 = q[2], q03 = q[3], q12 = q[10], q21 = q[17],
                q30 = q[24];
  auto estimate = [](int64_t num, int64_t qk, int64_t al) {
    const bool neg = num < 0;
    int64_t pred = ((qk << 7) + (neg ? -num : num)) / (qk << 8);
    if (al > 0 && pred >= (int64_t{1} << al)) pred = (int64_t{1} << al) - 1;
    return static_cast<int16_t>(neg ? -pred : pred);
  };
  int16_t ws[64];
  for (int64_t imcu = 0; imcu < total_imcu; ++imcu) {
    int64_t block_rows = v;
    if (imcu == total_imcu - 1 && hib % v) block_rows = hib % v;
    const int64_t image_block_rows = block_rows * total_imcu;
    for (int64_t br = 0; br < block_rows; ++br) {
      const int64_t actual = imcu * v + br;
      const int64_t ibr = imcu * block_rows + br;
      auto row = [&](int64_t r) { return blocks + r * bw * 64; };
      const int16_t* cur = row(actual);
      const int16_t* prev = ibr > 0 ? row(actual - 1) : cur;
      const int16_t* pprev = ibr > 1 ? row(actual - 2) : prev;
      const int16_t* next = ibr < image_block_rows - 1 ? row(actual + 1) : cur;
      const int16_t* nnext =
          ibr < image_block_rows - 2 ? row(actual + 2) : next;
      int dc01, dc02, dc03, dc04, dc05, dc06, dc07, dc08, dc09, dc10, dc11,
          dc12, dc13, dc14, dc15, dc16, dc17, dc18, dc19, dc20, dc21, dc22,
          dc23, dc24, dc25;
      dc01 = dc02 = dc03 = dc04 = dc05 = pprev[0];
      dc06 = dc07 = dc08 = dc09 = dc10 = prev[0];
      dc11 = dc12 = dc13 = dc14 = dc15 = cur[0];
      dc16 = dc17 = dc18 = dc19 = dc20 = next[0];
      dc21 = dc22 = dc23 = dc24 = dc25 = nnext[0];
      const int64_t last_col = wib - 1;
      for (int64_t b = 0; b <= last_col; ++b) {
        const int64_t o = b * 64;
        std::memcpy(ws, cur + o, sizeof(ws));
        if (b == 0 && b < last_col) {
          dc04 = dc05 = pprev[o + 64];
          dc09 = dc10 = prev[o + 64];
          dc14 = dc15 = cur[o + 64];
          dc19 = dc20 = next[o + 64];
          dc24 = dc25 = nnext[o + 64];
        }
        if (b + 1 < last_col) {
          dc05 = pprev[o + 128];
          dc10 = prev[o + 128];
          dc15 = cur[o + 128];
          dc20 = next[o + 128];
          dc25 = nnext[o + 128];
        }
        int64_t al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
          const int64_t num = q00 * (change_dc ?
              (-dc01 - dc02 + dc04 + dc05 - 3 * dc06 + 13 * dc07 -
               13 * dc09 + 3 * dc10 - 3 * dc11 + 38 * dc12 - 38 * dc14 +
               3 * dc15 - 3 * dc16 + 13 * dc17 - 13 * dc19 + 3 * dc20 -
               dc21 - dc22 + dc24 + dc25) :
              (-7 * dc11 + 50 * dc12 - 50 * dc14 + 7 * dc15));
          ws[1] = estimate(num, q01, al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
          const int64_t num = q00 * (change_dc ?
              (-dc01 - 3 * dc02 - 3 * dc03 - 3 * dc04 - dc05 - dc06 +
               13 * dc07 + 38 * dc08 + 13 * dc09 - dc10 + dc16 -
               13 * dc17 - 38 * dc18 - 13 * dc19 + dc20 + dc21 +
               3 * dc22 + 3 * dc23 + 3 * dc24 + dc25) :
              (-7 * dc03 + 50 * dc08 - 50 * dc18 + 7 * dc23));
          ws[8] = estimate(num, q10, al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
          const int64_t num = q00 * (change_dc ?
              (dc03 + 2 * dc07 + 7 * dc08 + 2 * dc09 - 5 * dc12 -
               14 * dc13 - 5 * dc14 + 2 * dc17 + 7 * dc18 + 2 * dc19 +
               dc23) :
              (-dc03 + 13 * dc08 - 24 * dc13 + 13 * dc18 - dc23));
          ws[16] = estimate(num, q20, al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
          const int64_t num = q00 * (change_dc ?
              (-dc01 + dc05 + 9 * dc07 - 9 * dc09 - 9 * dc17 + 9 * dc19 +
               dc21 - dc25) :
              (dc10 + dc16 - 10 * dc17 + 10 * dc19 - dc02 - dc20 + dc22 -
               dc24 + dc04 - dc06 + 10 * dc07 - 10 * dc09));
          ws[9] = estimate(num, q11, al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
          const int64_t num = q00 * (change_dc ?
              (2 * dc07 - 5 * dc08 + 2 * dc09 + dc11 + 7 * dc12 -
               14 * dc13 + 7 * dc14 + dc15 + 2 * dc17 - 5 * dc18 +
               2 * dc19) :
              (-dc11 + 13 * dc12 - 24 * dc13 + 13 * dc14 - dc15));
          ws[2] = estimate(num, q02, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
            ws[3] = estimate(q00 * (dc07 - dc09 + 2 * dc12 - 2 * dc14 +
                                    dc17 - dc19), q03, al);
          if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
            ws[10] = estimate(q00 * (dc07 - 3 * dc08 + dc09 - dc17 +
                                     3 * dc18 - dc19), q12, al);
          if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
            ws[17] = estimate(q00 * (dc07 - dc09 - 3 * dc12 + 3 * dc14 +
                                     dc17 - dc19), q21, al);
          if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
            ws[24] = estimate(q00 * (dc07 + 2 * dc08 + dc09 - dc17 -
                                     2 * dc18 - dc19), q30, al);
          // The DC value, smoothed by a kernel whose weights sum to 256.
          ws[0] = estimate(q00 *
              (-2 * dc01 - 6 * dc02 - 8 * dc03 - 6 * dc04 - 2 * dc05 -
               6 * dc06 + 6 * dc07 + 42 * dc08 + 6 * dc09 - 6 * dc10 -
               8 * dc11 + 42 * dc12 + 152 * dc13 + 42 * dc14 - 8 * dc15 -
               6 * dc16 + 6 * dc17 + 42 * dc18 + 6 * dc19 - 6 * dc20 -
               2 * dc21 - 6 * dc22 - 8 * dc23 - 6 * dc24 - 2 * dc25),
              q00, 0);
        }
        idct_islow(ws, q, rng, plane + actual * 8 * stride + b * 8, stride);
        dc01 = dc02; dc02 = dc03; dc03 = dc04; dc04 = dc05;
        dc06 = dc07; dc07 = dc08; dc08 = dc09; dc09 = dc10;
        dc11 = dc12; dc12 = dc13; dc13 = dc14; dc14 = dc15;
        dc16 = dc17; dc17 = dc18; dc18 = dc19; dc19 = dc20;
        dc21 = dc22; dc22 = dc23; dc23 = dc24; dc24 = dc25;
      }
    }
  }
}

// One component upsampled to the full image (jdsample.c). src: the
// component's samples, dw x dh meaningful, row stride `stride`; rows
// above 0 and below dh - 1 read the edge rows (jdmainct.c's context).
// hx, vx: the expansion factors (max_h / h, max_v / v). fancy: false in
// a lossless frame (jdsample.c: do_fancy needs a DCT scaled size above
// 1), where every ratio replicates.
void upsample(const uint8_t* src, int64_t stride, int64_t dw, int64_t dh,
              int hx, int vx, int64_t W, int64_t H, bool fancy,
              uint8_t* dst) {
  auto row = [&](int64_t i) {
    if (i < 0) i = 0;
    if (i > dh - 1) i = dh - 1;
    return src + i * stride;
  };
  std::vector<int> sums(static_cast<size_t>(dw));
  std::vector<uint8_t> tmp(static_cast<size_t>(2 * dw + 2));
  for (int64_t y = 0; y < H; ++y) {
    uint8_t* out = dst + y * W;
    if (hx == 1 && vx == 1) {  // fullsize_upsample
      std::memcpy(out, row(y), static_cast<size_t>(W));
    } else if (fancy && hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy
      const uint8_t* in = row(y);
      uint8_t* o = tmp.data();
      *o++ = in[0];
      *o++ = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int64_t j = 1; j < dw - 1; ++j) {
        const int v3 = in[j] * 3;
        *o++ = static_cast<uint8_t>((v3 + in[j - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>((v3 + in[j + 1] + 2) >> 2);
      }
      *o++ = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      *o++ = in[dw - 1];
      std::memcpy(out, tmp.data(), static_cast<size_t>(W));
    } else if (fancy && hx == 1 && vx == 2) {  // h1v2_fancy_upsample
      const int64_t i = y >> 1;
      const uint8_t* near = row(i);
      const uint8_t* far = row((y & 1) ? i + 1 : i - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int64_t x = 0; x < W; ++x)
        out[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
    } else if (fancy && hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy
      const int64_t i = y >> 1;
      const uint8_t* near = row(i);
      const uint8_t* far = row((y & 1) ? i + 1 : i - 1);
      for (int64_t j = 0; j < dw; ++j) sums[j] = near[j] * 3 + far[j];
      uint8_t* o = tmp.data();
      *o++ = static_cast<uint8_t>((sums[0] * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((sums[0] * 3 + sums[1] + 7) >> 4);
      for (int64_t j = 1; j < dw - 1; ++j) {
        *o++ = static_cast<uint8_t>((sums[j] * 3 + sums[j - 1] + 8) >> 4);
        *o++ = static_cast<uint8_t>((sums[j] * 3 + sums[j + 1] + 7) >> 4);
      }
      *o++ = static_cast<uint8_t>((sums[dw - 1] * 3 + sums[dw - 2] + 8) >> 4);
      *o++ = static_cast<uint8_t>((sums[dw - 1] * 4 + 7) >> 4);
      std::memcpy(out, tmp.data(), static_cast<size_t>(W));
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      const uint8_t* in = src + (y / vx) * stride;
      for (int64_t x = 0; x < W; ++x) out[x] = in[x / hx];
    }
  }
}

}  // namespace

extern "C" {

// Dequantise and inverse-transform every component, upsample it to the
// W x H image and convert the colours into out: (H, W, 3) uint8, or
// (H, W, 4) for the four-component spaces.
//   geom: per component, 8 int64: element offset of its blocks in coef,
//     blocks a row of the array, width and height in blocks, h, v, and
//     the downsampled width and height.
//   quant: per component, 64 uint16 in natural order.
//   color: 0 grey (one component, replicated to RGB as PIL's convert
//     does), 1 YCbCr, 2 RGB; 3 CMYK and 4 YCCK, both out as CMYK (the
//     samples libjpeg hands PIL, before its CMYK;I unpacker inverts
//     them).
//   samples: null, or a lossless frame's sample planes (coef and quant
//     unused; geom's offset and row stride then index samples).
//   smooth: null, or per component the 10 coef_bits that block smoothing
//     reads (idct_smoothed), with mcu_rows the frame's iMCU rows.
// Returns 0, or with msg filled 1 (a sampling ratio that is not
// integral, which libjpeg refuses too) or 2 (coefficients beyond the SIMD
// IDCT's range: see kMaxDequant).
int64_t tb_jpeg_pixels(const int16_t* coef, const uint8_t* samples,
                       int64_t ncomp, const int64_t* geom,
                       const uint16_t* quant, const int64_t* smooth,
                       int64_t mcu_rows, int64_t W, int64_t H,
                       int64_t color, uint8_t* out, char* msg) {
  IdctRange idct_range;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    hmax = std::max<int>(hmax, static_cast<int>(geom[8 * c + 4]));
    vmax = std::max<int>(vmax, static_cast<int>(geom[8 * c + 5]));
  }
  std::vector<std::vector<uint8_t>> full(static_cast<size_t>(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    const int64_t* g = geom + 8 * c;
    const int64_t bw = g[1], wib = g[2], hib = g[3];
    const int h = static_cast<int>(g[4]), v = static_cast<int>(g[5]);
    if (hmax % h != 0 || vmax % v != 0) {
      std::snprintf(msg, 256, "fractional sampling not implemented yet");
      return 1;
    }
    full[c].resize(static_cast<size_t>(W * H));
    if (samples) {  // lossless: the samples as decoded
      upsample(samples + g[0], bw, g[6], g[7], hmax / h, vmax / v, W, H,
               false, full[c].data());
      continue;
    }
    const int64_t stride = wib * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride * hib * 8));
    if (smooth) {
      idct_smoothed(coef + g[0], bw, wib, hib, v, mcu_rows, quant + 64 * c,
                    smooth + 10 * c, &idct_range, plane.data(), stride);
    } else {
      for (int64_t by = 0; by < hib; ++by)
        for (int64_t bx = 0; bx < wib; ++bx)
          idct_islow(coef + g[0] + (by * bw + bx) * 64, quant + 64 * c,
                     &idct_range, plane.data() + by * 8 * stride + bx * 8,
                     stride);
    }
    if (idct_range.dequant > kMaxDequant || idct_range.pass1 > kMaxPass1) {
      std::snprintf(msg, 256,
                    "out-of-range coefficients (dequantised %lld, pass 1 "
                    "%lld: beyond the 16-bit SIMD IDCT's range)",
                    static_cast<long long>(idct_range.dequant),
                    static_cast<long long>(idct_range.pass1));
      return 2;
    }
    upsample(plane.data(), stride, g[6], g[7], hmax / h, vmax / v, W, H,
             true, full[c].data());
  }
  const int64_t n = W * H;
  if (color == 1 || color == 4) {  // jdcolor.c ycc_rgb_convert
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t one_half = int64_t{1} << 15;
    const auto fix = [](double x) {
      return static_cast<int64_t>(x * 65536.0 + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    const int ch = color == 4 ? 4 : 3;
    for (int64_t i = 0; i < n; ++i) {
      const int y = full[0][i], cb = full[1][i], cr = full[2][i];
      uint8_t* o = out + ch * i;
      o[0] = limit(y + cr_r[cr]);
      o[1] = limit(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
      o[2] = limit(y + cb_b[cb]);
      if (color == 4) {  // ycck_cmyk_convert: C, M, Y inverted, K kept
        for (int k = 0; k < 3; ++k) o[k] = static_cast<uint8_t>(255 - o[k]);
        o[3] = full[3][i];
      }
    }
  } else if (color == 3) {  // CMYK: null_convert
    for (int64_t i = 0; i < n; ++i)
      for (int k = 0; k < 4; ++k) out[4 * i + k] = full[k][i];
  } else {
    for (int64_t i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k)
        out[3 * i + k] = full[color == 0 ? 0 : k][i];
  }
  return 0;
}

}  // extern "C"
