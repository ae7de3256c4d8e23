// Block-compressed DDS texture decoding: BC1-BC7 (DXT1/3/5, ATI1/2).
//
// core/dds.py reads the DDS container without an imaging library; this
// file turns its 4x4 blocks into pixels. The result is what PIL's "bcn"
// decoder returns (Pillow 12.1, BcnDecode.c), bit for bit, which departs
// from the D3D specification where noted below:
//   - BC1: the interpolated colours are (2 c0 + c1) / 3 and (c0 + c1) / 2
//     on the 8-bit expanded endpoints, truncated (D3D rounds, and allows
//     a +-3% error); the 3-colour mode (transparent black) is taken when
//     c0 <= c1 as 16-bit words. BC2 and BC3 colour blocks always use the
//     4-colour mode.
//   - BC2: a 4-bit alpha a becomes a * 17.
//   - BC3/BC4/BC5 ramps: (k a0 + (7 - k) a1) / 7 and (k a0 + (5 - k) a1)
//     / 5, truncated, on the 8-bit endpoints. BC5S (signed) adds 128 to
//     each signed endpoint and interpolates as if unsigned, so its ramp
//     is the unsigned ramp shifted by 128, not the SNORM one; its blue
//     is 128 (BC5's is 0).
//   - BC7: the D3D weights and rounding ((64 - w) e0 + w e1 + 32) >> 6; a
//     block whose first byte is 0 (no mode bit, "mode 8") decodes to
//     opaque black.
//   - BC6H: endpoints unquantised as in the specification, interpolated
//     without the +32 rounding term, scaled by 31/64 (31/32 signed) into
//     half-float bits, and each half converted to 8 bits as
//     (uint8)(clamp(h, 0, 1) * 255.0f): no tone mapping, everything
//     above 1.0 is 255. With SF16, an endpoint made from a delta is
//     masked to the endpoint bits and not sign-extended again, so a
//     negative sum reads as a large positive one (except at 16 bits,
//     where the word is read back as int16). The reserved mode codes
//     decode to black.
// Blocks are independent: one call decodes a whole surface. Host code,
// compiled with g++ at first use into the port's build directory
// (utils/build.py) and called through ctypes.

#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

inline int load16(const uint8_t* p) { return p[0] | (p[1] << 8); }

inline uint32_t load32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

inline int get_bit(const uint8_t* src, int bit) {
  return (src[bit >> 3] >> (bit & 7)) & 1;
}

// `count` (<= 8) bits at bit offset `bit`, least significant first.
inline int get_bits(const uint8_t* src, int bit, int count) {
  if (!count) return 0;
  const int by = bit >> 3;
  bit &= 7;
  if (bit + count <= 8) return (src[by] >> bit) & ((1 << count) - 1);
  const int x = src[by] | (src[by + 1] << 8);
  return (x >> bit) & ((1 << count) - 1);
}

Rgba decode_565(int x) {
  Rgba c;
  int r = (x & 0xf800) >> 8;
  c.r = static_cast<uint8_t>(r | (r >> 5));
  int g = (x & 0x7e0) >> 3;
  c.g = static_cast<uint8_t>(g | (g >> 6));
  int b = (x & 0x1f) << 3;
  c.b = static_cast<uint8_t>(b | (b >> 5));
  c.a = 255;
  return c;
}

// BC1 colour block (8 bytes) into 16 pixels; four_colour forces the
// 4-colour mode (BC2, BC3).
void bc1_colour(Rgba* col, const uint8_t* src, bool four_colour) {
  const int c0 = load16(src), c1 = load16(src + 2);
  const uint32_t lut = load32(src + 4);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  const int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four_colour) {
    p[2] = {static_cast<uint8_t>((2 * r0 + r1) / 3),
            static_cast<uint8_t>((2 * g0 + g1) / 3),
            static_cast<uint8_t>((2 * b0 + b1) / 3), 255};
    p[3] = {static_cast<uint8_t>((r0 + 2 * r1) / 3),
            static_cast<uint8_t>((g0 + 2 * g1) / 3),
            static_cast<uint8_t>((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {static_cast<uint8_t>((r0 + r1) / 2),
            static_cast<uint8_t>((g0 + g1) / 2),
            static_cast<uint8_t>((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) col[n] = p[3 & (lut >> (2 * n))];
}

// A BC3 alpha / BC4 / BC5 channel block (8 bytes) into byte `o` of 16
// pixels `stride` bytes apart. sign: the endpoints are signed bytes
// (BC5S), moved to 0..255 by adding 128.
void bc3_channel(uint8_t* dst, int stride, int o, const uint8_t* src,
                 bool sign) {
  int a0 = src[0], a1 = src[1];
  if (sign) {
    a0 = static_cast<int8_t>(src[0]) + 128;
    a1 = static_cast<int8_t>(src[1]) + 128;
  }
  uint8_t a[8];
  a[0] = static_cast<uint8_t>(a0);
  a[1] = static_cast<uint8_t>(a1);
  if (a0 > a1) {
    for (int k = 1; k <= 6; ++k)
      a[k + 1] = static_cast<uint8_t>(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k <= 4; ++k)
      a[k + 1] = static_cast<uint8_t>(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  const int lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  const int lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  for (int n = 0; n < 8; ++n) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; ++n)
    dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

void bc2_block(Rgba* col, const uint8_t* src) {
  bc1_colour(col, src + 8, true);
  for (int n = 0; n < 16; ++n) {
    const int av = 0xf & (src[n >> 1] >> (4 * (n & 1)));
    col[n].a = static_cast<uint8_t>((av << 4) | av);
  }
}

// ---------------------------------------------------------------------------
// BC7 (and the partition tables BC6H shares)

struct Bc7Mode {
  int ns;   // subsets
  int pb;   // partition bits
  int rb;   // rotation bits
  int isb;  // index selection bits
  int cb;   // colour bits an endpoint channel
  int ab;   // alpha bits an endpoint
  int epb;  // a p-bit an endpoint
  int spb;  // a p-bit a subset
  int ib;   // index bits
  int ib2;  // secondary index bits
};

constexpr Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// Two-subset partitions: bit n is the subset of pixel n.
constexpr uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};

// Three-subset partitions: bits 2n, 2n+1 are the subset of pixel n.
constexpr uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};

// Anchor pixel of subset 1 in a two-subset partition.
constexpr uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};

// Anchor pixels of subsets 1 and 2 in a three-subset partition.
constexpr uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
constexpr uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

constexpr uint8_t kWeights2[4] = {0, 21, 43, 64};
constexpr uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr uint8_t kWeights4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                                   34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset_of(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kPartition2[partition] >> n);
  if (ns == 3) return 3 & (kPartition3[partition] >> (2 * n));
  return 0;
}

// Index bits of pixel n: one fewer at each subset's anchor.
int index_bits(int ns, int partition, int n, int bits) {
  if (n == 0) return bits - 1;
  if (ns == 2 && n == kAnchor2[partition]) return bits - 1;
  if (ns == 3 && (n == kAnchor3a[partition] || n == kAnchor3b[partition]))
    return bits - 1;
  return bits;
}

inline uint8_t expand(int v, int bits) {
  v = (v << (8 - bits)) & 0xff;
  return static_cast<uint8_t>(v | (v >> bits));
}

inline uint8_t lerp64(int e0, int e1, int w) {
  return static_cast<uint8_t>(((64 - w) * e0 + w * e1 + 32) >> 6);
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (!src[0]) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  const Bc7Mode& m = kBc7Modes[mode];
  int bit = mode + 1;
  auto take = [&](int n) {
    const int v = get_bits(src, bit, n);
    bit += n;
    return v;
  };
  const int partition = take(m.pb);
  const int rotation = take(m.rb);
  const int index_sel = take(m.isb);
  const int numep = 2 * m.ns;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i) ep[i][c] = take(m.cb);
  for (int i = 0; i < numep; ++i) ep[i][3] = m.ab ? take(m.ab) : 255;
  int cb = m.cb, ab = m.ab;
  if (m.epb || m.spb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) {
      if (m.epb || i % 2 == 0) {
        const int p = take(1);
        for (int j = i; j < i + (m.epb ? 1 : 2); ++j)
          for (int c = 0; c < (ab ? 4 : 3); ++c) ep[j][c] = (ep[j][c] << 1) | p;
      }
    }
  }
  for (int i = 0; i < numep; ++i) {
    for (int c = 0; c < 3; ++c) ep[i][c] = expand(ep[i][c], cb);
    if (ab) ep[i][3] = expand(ep[i][3], ab);
  }
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  int cbit = bit;
  int abit = cbit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; ++i) {
    const int s = 2 * subset_of(m.ns, partition, i);
    const int nb = index_bits(m.ns, partition, i, m.ib);
    const int i0 = get_bits(src, cbit, nb);
    cbit += nb;
    int wc = cw[i0], wa = cw[i0];
    if (ab && m.ib2) {
      const int nb2 = i == 0 ? m.ib2 - 1 : m.ib2;
      const int i1 = get_bits(src, abit, nb2);
      abit += nb2;
      if (index_sel) {
        wc = aw[i1];
        wa = cw[i0];
      } else {
        wa = aw[i1];
      }
    }
    const int* e0 = ep[s];
    const int* e1 = ep[s + 1];
    uint8_t px[4] = {lerp64(e0[0], e1[0], wc), lerp64(e0[1], e1[1], wc),
                     lerp64(e0[2], e1[2], wc), lerp64(e0[3], e1[3], wa)};
    if (rotation) {
      const uint8_t t = px[rotation - 1];
      px[rotation - 1] = px[3];
      px[3] = t;
    }
    col[i] = {px[0], px[1], px[2], px[3]};
  }
}

// ---------------------------------------------------------------------------
// BC6H

struct Bc6Mode {
  int ns;   // subsets
  int tr;   // endpoints are deltas from the first
  int pb;   // partition bits
  int epb;  // endpoint bits
  int rb, gb, bb;  // delta bits a channel
};

// In the order of their mode codes: 00, 01, then 00010 ... 11110 (step
// 4), then 00011 ... 01111 (step 4).
constexpr Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10},
    {1, 1, 0, 11, 9, 9, 9}, {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// The endpoint bits after each mode code (D3D BC6H format, "compressed
// endpoint format" table), as runs {field, first bit, last bit} read in
// order from the first bit to the last (the last three modes read their
// high bits from the top down). Fields: 0-2 r0 g0 b0 (w), 3-5 r1 g1 b1
// (x), 6-8 r2 g2 b2 (y), 9-11 r3 g3 b3 (z).
struct Run {
  int8_t field, first, last;
};
enum { R0, G0, B0, R1, G1, B1, R2, G2, B2, R3, G3, B3 };

#define RUNS_END {-1, 0, 0}
constexpr Run kBc6Runs[14][32] = {
    {{G2, 4, 4}, {B2, 4, 4}, {B3, 4, 4}, {R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9},
     {R1, 0, 4}, {G3, 4, 4}, {G2, 0, 3}, {G1, 0, 4}, {B3, 0, 0}, {G3, 0, 3},
     {B1, 0, 4}, {B3, 1, 1}, {B2, 0, 3}, {R2, 0, 4}, {B3, 2, 2}, {R3, 0, 4},
     {B3, 3, 3}, RUNS_END},
    {{G2, 5, 5}, {G3, 4, 5}, {R0, 0, 6}, {B3, 0, 1}, {B2, 4, 4}, {G0, 0, 6},
     {B2, 5, 5}, {B3, 2, 2}, {G2, 4, 4}, {B0, 0, 6}, {B3, 3, 3}, {B3, 5, 5},
     {B3, 4, 4}, {R1, 0, 5}, {G2, 0, 3}, {G1, 0, 5}, {G3, 0, 3}, {B1, 0, 5},
     {B2, 0, 3}, {R2, 0, 5}, {R3, 0, 5}, RUNS_END},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 4}, {R0, 10, 10},
     {G2, 0, 3}, {G1, 0, 3}, {G0, 10, 10}, {B3, 0, 0}, {G3, 0, 3},
     {B1, 0, 3}, {B0, 10, 10}, {B3, 1, 1}, {B2, 0, 3}, {R2, 0, 4},
     {B3, 2, 2}, {R3, 0, 4}, {B3, 3, 3}, RUNS_END},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 3}, {R0, 10, 10},
     {G3, 4, 4}, {G2, 0, 3}, {G1, 0, 4}, {G0, 10, 10}, {G3, 0, 3},
     {B1, 0, 3}, {B0, 10, 10}, {B3, 1, 1}, {B2, 0, 3}, {R2, 0, 3},
     {B3, 0, 0}, {B3, 2, 2}, {R3, 0, 3}, {G2, 4, 4}, {B3, 3, 3}, RUNS_END},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 3}, {R0, 10, 10},
     {B2, 4, 4}, {G2, 0, 3}, {G1, 0, 3}, {G0, 10, 10}, {B3, 0, 0},
     {G3, 0, 3}, {B1, 0, 4}, {B0, 10, 10}, {B2, 0, 3}, {R2, 0, 3},
     {B3, 1, 2}, {R3, 0, 3}, {B3, 4, 4}, {B3, 3, 3}, RUNS_END},
    {{R0, 0, 8}, {B2, 4, 4}, {G0, 0, 8}, {G2, 4, 4}, {B0, 0, 8}, {B3, 4, 4},
     {R1, 0, 4}, {G3, 4, 4}, {G2, 0, 3}, {G1, 0, 4}, {B3, 0, 0}, {G3, 0, 3},
     {B1, 0, 4}, {B3, 1, 1}, {B2, 0, 3}, {R2, 0, 4}, {B3, 2, 2}, {R3, 0, 4},
     {B3, 3, 3}, RUNS_END},
    {{R0, 0, 7}, {G3, 4, 4}, {B2, 4, 4}, {G0, 0, 7}, {B3, 2, 2}, {G2, 4, 4},
     {B0, 0, 7}, {B3, 3, 4}, {R1, 0, 5}, {G2, 0, 3}, {G1, 0, 4}, {B3, 0, 0},
     {G3, 0, 3}, {B1, 0, 4}, {B3, 1, 1}, {B2, 0, 3}, {R2, 0, 5}, {R3, 0, 5},
     RUNS_END},
    {{R0, 0, 7}, {B3, 0, 0}, {B2, 4, 4}, {G0, 0, 7}, {G2, 5, 4}, {B0, 0, 7},
     {G3, 5, 5}, {B3, 4, 4}, {R1, 0, 4}, {G3, 4, 4}, {G2, 0, 3}, {G1, 0, 5},
     {G3, 0, 3}, {B1, 0, 4}, {B3, 1, 1}, {B2, 0, 3}, {R2, 0, 4}, {B3, 2, 2},
     {R3, 0, 4}, {B3, 3, 3}, RUNS_END},
    {{R0, 0, 7}, {B3, 1, 1}, {B2, 4, 4}, {G0, 0, 7}, {B2, 5, 5}, {G2, 4, 4},
     {B0, 0, 7}, {B3, 5, 4}, {R1, 0, 4}, {G3, 4, 4}, {G2, 0, 3}, {G1, 0, 4},
     {B3, 0, 0}, {G3, 0, 3}, {B1, 0, 5}, {B2, 0, 3}, {R2, 0, 4}, {B3, 2, 2},
     {R3, 0, 4}, {B3, 3, 3}, RUNS_END},
    {{R0, 0, 5}, {G3, 4, 4}, {B3, 0, 1}, {B2, 4, 4}, {G0, 0, 5}, {G2, 5, 5},
     {B2, 5, 5}, {B3, 2, 2}, {G2, 4, 4}, {B0, 0, 5}, {G3, 5, 5}, {B3, 3, 3},
     {B3, 5, 4}, {R1, 0, 5}, {G2, 0, 3}, {G1, 0, 5}, {G3, 0, 3}, {B1, 0, 5},
     {B2, 0, 3}, {R2, 0, 5}, {R3, 0, 5}, RUNS_END},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 9}, {G1, 0, 9}, {B1, 0, 9},
     RUNS_END},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 8}, {R0, 10, 10},
     {G1, 0, 8}, {G0, 10, 10}, {B1, 0, 8}, {B0, 10, 10}, RUNS_END},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 7}, {R0, 11, 10},
     {G1, 0, 7}, {G0, 11, 10}, {B1, 0, 7}, {B0, 11, 10}, RUNS_END},
    {{R0, 0, 9}, {G0, 0, 9}, {B0, 0, 9}, {R1, 0, 3}, {R0, 15, 10},
     {G1, 0, 3}, {G0, 15, 10}, {B1, 0, 3}, {B0, 15, 10}, RUNS_END},
};
#undef RUNS_END

inline int sign_extend(int x, int bits) {
  x &= (1 << bits) - 1;
  return (x & (1 << (bits - 1))) ? x - (1 << bits) : x;
}

int bc6_unquantize(int x, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15 || x == 0) return x;
    if (x == (1 << bits) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (bits - 1);
  }
  if (bits >= 16) return x;
  const bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0) {
    x = x >= (1 << (bits - 1)) - 1 ? 0x7fff
                                   : ((x << 15) + 0x4000) >> (bits - 1);
  }
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  // The magic-number conversion PIL uses (exact for every finite half).
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = static_cast<uint32_t>(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= static_cast<uint32_t>(h & 0x8000) << 16;
  return o.f;
}

uint8_t bc6_channel(int v, bool sign) {
  uint16_t h;
  if (!sign) {
    h = static_cast<uint16_t>((v * 31) / 64);
  } else if (v < 0) {
    h = static_cast<uint16_t>(0x8000 | (((-v) * 31) / 32));
  } else {
    h = static_cast<uint16_t>((v * 31) / 32);
  }
  const float f = half_to_float(h);
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return static_cast<uint8_t>(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1f, bit = 5;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
  } else {
    mode = 10 + (mode >> 2);
  }
  if (mode >= 14) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 0};
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  int ep[12] = {0};
  for (const Run* r = kBc6Runs[mode]; r->field >= 0; ++r) {
    const int step = r->last >= r->first ? 1 : -1;
    for (int b = r->first;; b += step) {
      ep[r->field] |= get_bit(src, bit++) << b;
      if (b == r->last) break;
    }
  }
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int numep = m.ns == 2 ? 12 : 6;
  const int delta_bits[3] = {m.rb, m.gb, m.bb};
  if (sign)
    for (int c = 0; c < 3; ++c) ep[c] = sign_extend(ep[c], m.epb);
  if (sign || m.tr)
    for (int i = 3; i < numep; ++i)
      ep[i] = sign_extend(ep[i], delta_bits[i % 3]);
  // PIL masks a delta-coded endpoint to epb bits and does not sign-extend
  // it again: with SF16, a sum that is negative reads as a large positive.
  if (m.tr)
    for (int i = 3; i < numep; ++i)
      ep[i] = (ep[i] + ep[i % 3]) & ((1 << m.epb) - 1);
  // PIL keeps endpoints as 16-bit words and reads them back as int16
  // when signed (so a 16-bit delta sum may still turn negative), as the
  // low epb bits when unsigned.
  for (int i = 0; i < numep; ++i) {
    ep[i] = sign ? static_cast<int16_t>(ep[i] & 0xffff)
                 : ep[i] & ((1 << m.epb) - 1);
    ep[i] = bc6_unquantize(ep[i], m.epb, sign);
  }
  const int ib = m.ns == 2 ? 3 : 4;
  const uint8_t* w = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int s = 6 * subset_of(m.ns, partition, i);
    const int nb = index_bits(m.ns, partition, i, ib);
    const int wi = w[get_bits(src, bit, nb)];
    bit += nb;
    uint8_t px[3];
    for (int c = 0; c < 3; ++c)
      px[c] = bc6_channel((ep[s + c] * (64 - wi) + ep[s + 3 + c] * wi) >> 6,
                          sign);
    col[i] = {px[0], px[1], px[2], 0};
  }
}

}  // namespace

extern "C" {

// Decode a surface of BCn blocks into out (height, width, channels) uint8,
// cropping the blocks at the right and bottom edges as PIL does.
//   n: 1 BC1, 2 BC2, 3 BC3, 4 BC4 (L), 5 BC5 (RGB, blue 0), 6 BC6H (RGB),
//      7 BC7; channels 4 (RGBA) for 1, 2, 3 and 7, 1 for 4, 3 for 5, 6.
//      BC5's blue is 0, or 128 for BC5S (PIL's signed zero).
//   sign: BC5S or BC6H SF16.
//   src must hold ceil(w/4) * ceil(h/4) blocks (8 bytes for n 1 and 4,
//   else 16). Returns 0, or -1 for an unknown n.
int64_t tb_dds_decode_bcn(const uint8_t* src, uint8_t* out, int64_t width,
                          int64_t height, int64_t n, int64_t sign) {
  if (n < 1 || n > 7) return -1;
  const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
  const int64_t block_bytes = (n == 1 || n == 4) ? 8 : 16;
  const int channels = (n == 4) ? 1 : (n == 5 || n == 6) ? 3 : 4;
  for (int64_t by = 0; by < bh; ++by) {
    for (int64_t bx = 0; bx < bw; ++bx) {
      const uint8_t* blk = src + (by * bw + bx) * block_bytes;
      Rgba col[16];
      std::memset(col, 0, sizeof(col));
      switch (n) {
        case 1: bc1_colour(col, blk, false); break;
        case 2: bc2_block(col, blk); break;
        case 3:
          bc1_colour(col, blk + 8, true);
          bc3_channel(&col[0].r, 4, 3, blk, false);
          break;
        case 4: bc3_channel(&col[0].r, 4, 0, blk, false); break;
        case 5:
          if (sign)
            for (int i = 0; i < 16; ++i) col[i].b = 128;
          bc3_channel(&col[0].r, 4, 0, blk, sign != 0);
          bc3_channel(&col[0].r, 4, 1, blk + 8, sign != 0);
          break;
        case 6: bc6_block(col, blk, sign != 0); break;
        default: bc7_block(col, blk); break;
      }
      for (int j = 0; j < 4; ++j) {
        const int64_t y = by * 4 + j;
        if (y >= height) break;
        for (int i = 0; i < 4; ++i) {
          const int64_t x = bx * 4 + i;
          if (x >= width) break;
          const uint8_t* px = &col[j * 4 + i].r;
          std::memcpy(out + (y * width + x) * channels, px, channels);
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
