// JPEG entropy decoding, inverse DCT, chroma upsampling and colour
// conversion, with libjpeg-turbo's integer arithmetic so that the pixels
// equal what PIL (on libjpeg-turbo, default decompression settings)
// returns, bit for bit.
//
// core/jpeg.py parses the markers and calls this file twice:
// - tb_jpeg_scan once a scan (SOS): Huffman-decodes the scan's entropy-
//   coded segment into the coefficient blocks of its components
//   (sequential and progressive, restart intervals included);
// - tb_jpeg_pixels once at the end: dequantises, runs the islow IDCT on
//   every block, upsamples each component to the full image and converts
//   the colours.
// Host code, compiled with g++ at first use into the port's build
// directory (utils/build.py) and called through ctypes.
//
// Where libjpeg's arithmetic is easy to lose (each has a test of its own
// in tests/test_torch_jpeg.py):
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
//   (int_upsample);
// - jdcolor.c ycc_rgb_convert: SCALEBITS 16 fixed-point tables and the
//   sample range limit; ycck_cmyk_convert: the same on Y, Cb and Cr,
//   then 255 less each clamped value (255 - clamp(v) equals libjpeg's
//   range_limit[255 - v]), K passed through;
// - jdphuff.c: DC first/refine, AC first with EOBRUN, the AC refinement
//   scan's correction bits; a restart resets the DC predictors and
//   EOBRUN; a non-interleaved scan covers ceil(component width / 8)
//   blocks a row, not the MCU-padded count.
// Corrupt data is an error here (libjpeg warns and substitutes zeros).

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
// symbols. Returns false on a table no canonical code fits.
bool build_huff(const uint8_t* bits, const uint8_t* vals, bool is_dc,
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
  if (is_dc) {
    for (int i = 0; i < nsym; ++i)
      if (vals[i] > 15) return false;
  }
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

struct ScanComp {
  int16_t* coef;  // the component's block array, row-major blocks of 64
  int64_t bw;     // blocks a row of that array
  int h, v;       // sampling factors (interleaved scans)
  int64_t wib, hib;  // width and height in blocks of the component
  const Huff* dc;
  const Huff* ac;
  int last_dc;
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
// Returns 0, or 1 with msg (256 bytes) filled.
int64_t tb_jpeg_scan(const uint8_t* data, int64_t len, int16_t* coef,
                     int64_t ncomp, const int64_t* geom,
                     const uint8_t* tables, const uint8_t* present,
                     int64_t mcus_per_row, int64_t mcu_rows, int64_t ss,
                     int64_t se, int64_t ah, int64_t al,
                     int64_t progressive, int64_t restart_interval,
                     char* msg) {
  Huff huff[8];
  bool built[8] = {false};
  ScanComp comps[4];
  const bool dc_scan = !progressive || ss == 0;
  const bool needs_dc_table = !progressive || (ss == 0 && ah == 0);
  const bool needs_ac_table = !progressive || ss > 0;
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
      const int slots[2] = {static_cast<int>(g[6] >> 4),
                            4 + static_cast<int>(g[6] & 15)};
      const bool need[2] = {needs_dc_table, needs_ac_table};
      for (int k = 0; k < 2; ++k) {
        if (!need[k]) continue;
        const int s = slots[k];
        if (!present[s]) throw Fail{"scan uses an undefined Huffman table"};
        if (!built[s]) {
          const uint8_t* t = tables + 273 * s;
          if (!build_huff(t, t + 17, k == 0, &huff[s]))
            throw Fail{"bad Huffman table"};
          built[s] = true;
        }
        (k == 0 ? sc.dc : sc.ac) = &huff[s];
      }
    }
    BitReader br{data, data + len};
    const bool interleaved = ncomp > 1;
    const int64_t n_mcu =
        interleaved ? mcus_per_row * mcu_rows : comps[0].wib * comps[0].hib;
    int64_t eobrun = 0;
    int rst = 0;
    const int p1 = 1 << al;
    const int m1 = -(1 << al);

    auto decode_block = [&](ScanComp& sc, int16_t* block) {
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
        br.restart(rst);
        rst = (rst + 1) & 7;
        for (int c = 0; c < ncomp; ++c) comps[c].last_dc = 0;
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

// One component upsampled to the full image (jdsample.c). src: the
// component's samples, dw x dh meaningful, row stride `stride`; rows
// above 0 and below dh - 1 read the edge rows (jdmainct.c's context).
// hx, vx: the expansion factors (max_h / h, max_v / v).
void upsample(const uint8_t* src, int64_t stride, int64_t dw, int64_t dh,
              int hx, int vx, int64_t W, int64_t H, uint8_t* dst) {
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
    } else if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
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
    } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
      const int64_t i = y >> 1;
      const uint8_t* near = row(i);
      const uint8_t* far = row((y & 1) ? i + 1 : i - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int64_t x = 0; x < W; ++x)
        out[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
    } else if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
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
// Returns 0, or with msg filled 1 (a sampling ratio that is not
// integral, which libjpeg refuses too) or 2 (coefficients beyond the SIMD
// IDCT's range: see kMaxDequant).
int64_t tb_jpeg_pixels(const int16_t* coef, int64_t ncomp,
                       const int64_t* geom, const uint16_t* quant,
                       int64_t W, int64_t H, int64_t color, uint8_t* out,
                       char* msg) {
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
    const int64_t stride = wib * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride * hib * 8));
    for (int64_t by = 0; by < hib; ++by)
      for (int64_t bx = 0; bx < wib; ++bx)
        idct_islow(coef + g[0] + (by * bw + bx) * 64, quant + 64 * c,
                   &idct_range, plane.data() + by * 8 * stride + bx * 8,
                   stride);
    if (idct_range.dequant > kMaxDequant || idct_range.pass1 > kMaxPass1) {
      std::snprintf(msg, 256,
                    "out-of-range coefficients (dequantised %lld, pass 1 "
                    "%lld: beyond the 16-bit SIMD IDCT's range)",
                    static_cast<long long>(idct_range.dequant),
                    static_cast<long long>(idct_range.pass1));
      return 2;
    }
    full[c].resize(static_cast<size_t>(W * H));
    upsample(plane.data(), stride, g[6], g[7], hmax / h, vmax / v, W, H,
             full[c].data());
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
