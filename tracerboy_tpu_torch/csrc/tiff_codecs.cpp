// The byte-serial loops of the TIFF layouts that texture tools other than
// the common ones write (GDAL's GeoTIFF and COG writers, fax software,
// old scanners), for core/tiff.py: Zstandard, CCITT fax (modified
// Huffman, Group 3, Group 4), ThunderScan, libtiff's YCbCr-to-RGB route
// and Pillow's CIELab-to-RGB conversion (TIFF's and PSD's). Host code,
// compiled with g++ at first use (core/codecs.py tiff_library,
// -ffp-contract=off) and called through ctypes. Each returns the bytes
// written, or a negative code.
//
// Zstandard (RFC 8878) as libtiff's tif_zstd.c feeds a strip or tile to
// libzstd 1.5 (ZSTD_decompressStream until the strip is full):
// - one frame only (a skippable or unknown frame is an error), a frame
//   with a dictionary ID is an error (no dictionary is loaded);
// - with a Frame_Content_Size that fits the strip and the whole frame in
//   the strip's bytes, libzstd decodes the frame in one pass: any error,
//   a content size that differs from the blocks' output, or a wrong
//   content checksum fails the strip. Otherwise it streams: decoding
//   stops once the strip is full, after the block that filled it (and
//   after one more block, or the frame's end and checksum, when the
//   output ended exactly at a block's end and the input holds them);
// - block sizes are checked against min(window, 128 KiB); the literals
//   and sequences sections against libzstd's checks (a 4-stream literal
//   section needs 6 literals and 10 bytes; every Huffman stream and the
//   sequence bitstream must end exactly at their first bit; reserved
//   bits of the sequence modes must be 0; nbSeq 0 ends the block).
//
// CCITT (ITU-T T.4, T.6) as libtiff's tif_fax3.c decodes it, into 1 bits
// for black runs (the photometric is only the caller's business):
// - modified Huffman (2): each row starts on a byte boundary, no EOLs;
// - Group 3 (3): optional EOLs with fill bits (T4Options bit 2), 2D rows
//   tagged by the bit after EOL (T4Options bit 0);
// - Group 4 (4): 2D rows against an all-white reference row;
// - libtiff's leniency, which PIL returns as pixels: a bad code ends the
//   row ("Bad code word"), a row that ends short or long is padded with
//   white or cut to the width ("Line length mismatch"), data that ends
//   early pads the rest of the strip with white ("Premature EOL/EOF"),
//   and decoding goes on with the next row (Group 3 resynchronises on
//   the next EOL; Group 4 and MH go on from where the bits are).
//
// ThunderScan (32809): tif_thunder.c's 4-bit runs and deltas.
//
// YCbCr (libtiff's TIFFRGBAImage, tif_getimage.c putcontig8bitYCbCr*
// and tif_color.c TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB): the fixed-point
// tables of ReferenceBlackWhite and YCbCrCoefficients, whole h x v blocks
// of luma followed by Cb and Cr, cropped at the right and bottom edges;
// in a tile cropped at the right, the 4x4 routine skips the blocks it
// does not put as if they were 4x2 blocks (10 bytes, not 18).
//
// CIELab: Pillow's "LAB" to "RGBA" conversion is littleCMS 2's transform
// from its Lab profile to its sRGB profile (perceptual intent): littleCMS
// samples the float pipeline (Lab to XYZ against D50, the inverse of
// sRGB's D65 matrix adapted to D50 by Bradford, the inverse sRGB curve)
// at 33^3 nodes into 16-bit values, then interpolates each 8-bit input
// tetrahedrally in 16.16 fixed point. Every float step keeps littleCMS's
// types (float32 between stages, double inside them), and the 16-bit
// quantiser is its _cmsQuickSaturateWord (a floor at 2^-16 resolution).
// core/psd.py takes the same conversion for Lab PSDs (its RGB is PIL's on
// all 2^24 inputs; the alpha Pillow copies from the image's extra byte is
// set there). Departures from littleCMS: none in the values; only the
// 8-bit Lab-to-RGB path Pillow builds is repeated.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ----------------------------------------------------------------------------
// Zstandard

struct ZFail {};

inline void zcheck(bool ok) {
  if (!ok) throw ZFail{};
}

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                 P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                 P5 = 0x27D4EB2F165667C5ULL;
  auto rd64 = [](const uint8_t* q) {
    uint64_t v;
    std::memcpy(&v, q, 8);
    return v;
  };
  auto round = [&](uint64_t acc, uint64_t in) {
    return rotl(acc + in * P2, 31) * P1;
  };
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (p + 32 <= end) {
      v1 = round(v1, rd64(p));
      v2 = round(v2, rd64(p + 8));
      v3 = round(v3, rd64(p + 16));
      v4 = round(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ round(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= round(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    h ^= uint64_t{v} * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t{*p++} * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// A backward bitstream (Huffman streams, FSE weights, sequences): read
// from the end, the highest set bit of the last byte is the start mark.
// Bits past the stream's start read as zeros and count as consumed.
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t total = 0;     // bits of the stream after the mark
  int64_t consumed = 0;  // bits read
  void init(const uint8_t* src, size_t n) {
    zcheck(n >= 1);
    const uint8_t last = src[n - 1];
    zcheck(last != 0);
    p = src;
    total = static_cast<int64_t>(8 * (n - 1)) + highbit(last);
    consumed = 0;
  }
  // Bit i counted from the stream's end (0: just below the mark).
  inline uint64_t read(int nb) {
    if (nb == 0) return 0;
    uint64_t v = 0;
    for (int k = 0; k < nb; ++k) {
      const int64_t pos = total - 1 - consumed - k;  // bit index from 0
      int bit = 0;
      if (pos >= 0) bit = (p[pos >> 3] >> (pos & 7)) & 1;
      v = (v << 1) | static_cast<uint64_t>(bit);
    }
    consumed += nb;
    return v;
  }
  inline uint64_t peek(int nb) const {
    uint64_t v = 0;
    for (int k = 0; k < nb; ++k) {
      const int64_t pos = total - 1 - consumed - k;
      int bit = 0;
      if (pos >= 0) bit = (p[pos >> 3] >> (pos & 7)) & 1;
      v = (v << 1) | static_cast<uint64_t>(bit);
    }
    return v;
  }
  bool overflowed() const { return consumed > total; }
  bool exact_end() const { return consumed == total; }
};

// A forward little-endian bit reader (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  int64_t pos = 0;
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int k = 0; k < nb; ++k, ++pos) {
      const int64_t byte = pos >> 3;
      const int bit =
          byte < static_cast<int64_t>(n) ? (p[byte] >> (pos & 7)) & 1 : 0;
      v |= static_cast<uint32_t>(bit) << k;
    }
    return v;
  }
  uint32_t peek(int nb) {
    const int64_t save = pos;
    const uint32_t v = read(nb);
    pos = save;
    return v;
  }
};

// FSE_readNCount: the normalised counts of an FSE table description.
// Returns the bytes used; max_sym in: the largest symbol allowed, out:
// the last symbol described.
size_t read_ncount(const uint8_t* src, size_t n, int* counts, int* max_sym,
                   int* table_log, int max_log) {
  FwdBits bits{src, n};
  const int log = static_cast<int>(bits.read(4)) + 5;
  zcheck(log <= 15 && log <= max_log);
  *table_log = log;
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb = log + 1;
  const int maxsv1 = *max_sym + 1;
  int sym = 0;
  bool previous0 = false;
  std::fill(counts, counts + maxsv1, 0);
  while (remaining > 1 && sym < maxsv1) {
    if (previous0) {
      int rep;
      while ((rep = static_cast<int>(bits.read(2))) == 3) sym += 3;
      sym += rep;
      zcheck(sym < maxsv1);
    }
    const int maxv = (2 * threshold - 1) - remaining;
    int count;
    const int low = static_cast<int>(bits.peek(nb - 1));
    if (low < maxv) {
      count = low;
      bits.read(nb - 1);
    } else {
      count = static_cast<int>(bits.read(nb));
      if (count >= threshold) count -= maxv;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    counts[sym++] = count;
    previous0 = count == 0;
    if (remaining <= 1) break;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  zcheck(remaining == 1);
  const size_t used = static_cast<size_t>((bits.pos + 7) >> 3);
  zcheck(used <= n);
  *max_sym = sym - 1;
  return used;
}

struct FseCell {
  uint16_t sym;
  uint8_t nb;
  uint16_t next;  // baseline of the next state
};

struct FseTable {
  int log = 0;
  std::vector<FseCell> cells;
};

// FSE_buildDTable / ZSTD_buildFSETable: spread the symbols, then each
// cell's bit count and next-state baseline.
void build_fse(const int* counts, int max_sym, int log, FseTable* t) {
  const int size = 1 << log;
  t->log = log;
  t->cells.assign(static_cast<size_t>(size), FseCell{0, 0, 0});
  std::vector<int> next(static_cast<size_t>(max_sym + 1));
  int high = size - 1;
  for (int s = 0; s <= max_sym; ++s) {
    if (counts[s] == -1) {
      t->cells[static_cast<size_t>(high--)].sym = static_cast<uint16_t>(s);
      next[static_cast<size_t>(s)] = 1;
    } else {
      next[static_cast<size_t>(s)] = counts[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  int pos = 0;
  for (int s = 0; s <= max_sym; ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      t->cells[static_cast<size_t>(pos)].sym = static_cast<uint16_t>(s);
      do {
        pos = (pos + step) & (size - 1);
      } while (pos > high);
    }
  }
  zcheck(pos == 0);
  for (int u = 0; u < size; ++u) {
    FseCell& c = t->cells[static_cast<size_t>(u)];
    const int ns = next[c.sym]++;
    c.nb = static_cast<uint8_t>(log - highbit(static_cast<uint32_t>(ns)));
    c.next = static_cast<uint16_t>((ns << c.nb) - size);
  }
}

struct Huffman {
  int log = 0;
  std::vector<uint8_t> sym, len;  // indexed by the top `log` bits
};

// HUF_readStats + the decoding table of the weights' prefix code.
size_t read_huffman(const uint8_t* src, size_t n, Huffman* h) {
  zcheck(n >= 1);
  uint8_t w[256];
  int nw = 0;
  const int head = src[0];
  size_t used;
  if (head >= 128) {
    nw = head - 127;
    used = 1 + static_cast<size_t>((nw + 1) / 2);
    zcheck(used <= n);
    for (int i = 0; i < nw; ++i) {
      const uint8_t b = src[1 + i / 2];
      w[i] = static_cast<uint8_t>(i % 2 == 0 ? b >> 4 : b & 15);
    }
  } else {
    used = 1 + static_cast<size_t>(head);
    zcheck(used <= n && head > 0);
    int counts[256];
    int max_sym = 255, log = 0;
    const size_t hsize = read_ncount(src + 1, static_cast<size_t>(head),
                                     counts, &max_sym, &log, 6);
    FseTable t;
    build_fse(counts, max_sym, log, &t);
    BackBits bits;
    bits.init(src + 1 + hsize, static_cast<size_t>(head) - hsize);
    uint32_t s1 = static_cast<uint32_t>(bits.read(log));
    uint32_t s2 = static_cast<uint32_t>(bits.read(log));
    auto decode = [&](uint32_t* s) {
      const FseCell& c = t.cells[*s];
      *s = c.next + static_cast<uint32_t>(bits.read(c.nb));
      return static_cast<uint8_t>(c.sym);
    };
    for (;;) {
      zcheck(nw <= 253);
      w[nw++] = decode(&s1);
      if (bits.overflowed()) {
        w[nw++] = static_cast<uint8_t>(t.cells[s2].sym);
        break;
      }
      zcheck(nw <= 253);
      w[nw++] = decode(&s2);
      if (bits.overflowed()) {
        w[nw++] = static_cast<uint8_t>(t.cells[s1].sym);
        break;
      }
    }
  }
  int rank[13] = {0};
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    zcheck(w[i] <= 12);
    rank[w[i]]++;
    total += (1u << w[i]) >> 1;
  }
  zcheck(total != 0);
  const int log = highbit(total) + 1;
  zcheck(log <= 12);
  const uint32_t rest = (1u << log) - total;
  zcheck((1u << highbit(rest)) == rest);
  w[nw] = static_cast<uint8_t>(highbit(rest) + 1);
  rank[w[nw]]++;
  ++nw;
  zcheck(rank[1] >= 2 && (rank[1] & 1) == 0);
  h->log = log;
  h->sym.assign(static_cast<size_t>(1) << log, 0);
  h->len.assign(static_cast<size_t>(1) << log, 0);
  // Codes by increasing weight; within a weight by symbol: each symbol of
  // weight k holds 2^(k-1) consecutive cells.
  uint32_t pos = 0;
  for (int k = 1; k <= log; ++k) {
    for (int s = 0; s < nw; ++s) {
      if (w[s] != k) continue;
      const uint32_t span = 1u << (k - 1);
      for (uint32_t j = 0; j < span; ++j) {
        h->sym[pos + j] = static_cast<uint8_t>(s);
        h->len[pos + j] = static_cast<uint8_t>(log + 1 - k);
      }
      pos += span;
    }
  }
  return used;
}

void huffman_stream(const Huffman& h, const uint8_t* src, size_t n,
                    uint8_t* out, size_t count) {
  BackBits bits;
  bits.init(src, n);
  for (size_t i = 0; i < count; ++i) {
    const uint32_t v = static_cast<uint32_t>(bits.peek(h.log));
    out[i] = h.sym[v];
    bits.consumed += h.len[v];
  }
  zcheck(bits.exact_end());
}

const uint32_t kLLBase[36] = {0,  1,  2,    3,    4,    5,    6,    7,    8,
                              9,  10, 11,   12,   13,   14,   15,   16,   18,
                              20, 22, 24,   28,   32,   40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2,  2,
                            2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,  2,
                            2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct ZState {
  Huffman huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

// One sequence table of a compressed block: mode 0 predefined, 1 RLE,
// 2 FSE-described, 3 repeat. Returns the bytes the description used.
size_t seq_table(int mode, const uint8_t* src, size_t n, int max_sym,
                 int max_log, const int* dflt, int dflt_max, int dflt_log,
                 FseTable* t, bool* have) {
  switch (mode) {
    case 0:
      build_fse(dflt, dflt_max, dflt_log, t);
      *have = true;
      return 0;
    case 1: {
      zcheck(n >= 1 && src[0] <= max_sym);
      t->log = 0;
      t->cells.assign(1, FseCell{src[0], 0, 0});
      *have = true;
      return 1;
    }
    case 2: {
      int counts[64];
      int ms = max_sym, log = 0;
      const size_t used = read_ncount(src, n, counts, &ms, &log, max_log);
      build_fse(counts, ms, log, t);
      *have = true;
      return used;
    }
    default:
      zcheck(*have);
      return 0;
  }
}

// One compressed block appended to out.
void zstd_block(const uint8_t* src, size_t n, ZState* st,
                std::vector<uint8_t>* out, size_t block_max,
                size_t frame_start) {
  // Literals section.
  zcheck(n >= 1);
  const int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t lh, regen, csize = 0;
  std::vector<uint8_t> lit;
  if (ltype <= 1) {
    if (sf == 0 || sf == 2) {
      lh = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      zcheck(n >= 2);
      lh = 2;
      regen = (src[0] >> 4) + (size_t{src[1]} << 4);
    } else {
      zcheck(n >= 3);
      lh = 3;
      regen = (src[0] >> 4) + (size_t{src[1]} << 4) + (size_t{src[2]} << 12);
    }
    zcheck(regen <= block_max);
    if (ltype == 0) {
      zcheck(lh + regen <= n);
      lit.assign(src + lh, src + lh + regen);
      csize = regen;
    } else {
      zcheck(lh + 1 <= n);
      lit.assign(regen, src[lh]);
      csize = 1;
    }
  } else {
    const int bits = sf <= 1 ? 10 : sf == 2 ? 14 : 18;
    lh = sf <= 1 ? 3 : sf == 2 ? 4 : 5;
    zcheck(n >= lh);
    uint64_t v = 0;
    for (size_t i = 0; i < lh; ++i) v |= uint64_t{src[i]} << (8 * i);
    regen = static_cast<size_t>((v >> 4) & ((1u << bits) - 1));
    csize = static_cast<size_t>((v >> (4 + bits)) & ((1u << bits) - 1));
    zcheck(regen <= block_max && lh + csize <= n);
    const bool single = sf == 0;
    zcheck(single || regen >= 6);
    const uint8_t* p = src + lh;
    size_t left = csize;
    if (ltype == 2) {
      const size_t used = read_huffman(p, left, &st->huf);
      st->have_huf = true;
      p += used;
      left -= used;
    } else {
      zcheck(st->have_huf);
    }
    lit.resize(regen);
    if (single) {
      huffman_stream(st->huf, p, left, lit.data(), regen);
    } else {
      zcheck(left >= 10);
      const size_t s1 = p[0] | (size_t{p[1]} << 8);
      const size_t s2 = p[2] | (size_t{p[3]} << 8);
      const size_t s3 = p[4] | (size_t{p[5]} << 8);
      zcheck(s1 + s2 + s3 + 6 <= left);
      const size_t s4 = left - 6 - s1 - s2 - s3;
      const size_t seg = (regen + 3) / 4;
      zcheck(3 * seg <= regen);
      const size_t sizes[4] = {s1, s2, s3, s4};
      const uint8_t* q = p + 6;
      for (int k = 0; k < 4; ++k) {
        const size_t cnt = k < 3 ? seg : regen - 3 * seg;
        huffman_stream(st->huf, q, sizes[k], lit.data() + k * seg, cnt);
        q += sizes[k];
      }
    }
  }
  size_t pos = lh + csize;
  // Sequences section.
  zcheck(pos + 1 <= n);
  size_t nseq = src[pos];
  if (nseq == 0) {
    zcheck(pos + 1 == n);
    out->insert(out->end(), lit.begin(), lit.end());
    zcheck(lit.size() <= block_max);
    return;
  }
  if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    zcheck(pos + 2 <= n);
    nseq = ((nseq - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    zcheck(pos + 3 <= n);
    nseq = src[pos + 1] + (size_t{src[pos + 2]} << 8) + 0x7F00;
    pos += 3;
  }
  zcheck(pos + 1 <= n);
  const uint8_t modes = src[pos++];
  zcheck((modes & 3) == 0);
  pos += seq_table(modes >> 6, src + pos, n - pos, 35, 9, kLLDefault, 35, 6,
                   &st->ll, &st->have_ll);
  pos += seq_table((modes >> 4) & 3, src + pos, n - pos, 31, 8, kOFDefault,
                   28, 5, &st->of, &st->have_of);
  pos += seq_table((modes >> 2) & 3, src + pos, n - pos, 52, 9, kMLDefault,
                   52, 6, &st->ml, &st->have_ml);
  zcheck(pos < n);
  BackBits bits;
  bits.init(src + pos, n - pos);
  uint32_t sll = static_cast<uint32_t>(bits.read(st->ll.log));
  uint32_t sof = static_cast<uint32_t>(bits.read(st->of.log));
  uint32_t sml = static_cast<uint32_t>(bits.read(st->ml.log));
  const size_t start = out->size();
  size_t lp = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const int llc = st->ll.cells[sll].sym, ofc = st->of.cells[sof].sym,
              mlc = st->ml.cells[sml].sym;
    zcheck(llc <= 35 && mlc <= 52 && ofc <= 31);
    const uint64_t ofv = (uint64_t{1} << ofc) + bits.read(ofc);
    const uint64_t ml = kMLBase[mlc] + bits.read(kMLBits[mlc]);
    const uint64_t ll = kLLBase[llc] + bits.read(kLLBits[llc]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      st->rep[2] = st->rep[1];
      st->rep[1] = st->rep[0];
      st->rep[0] = offset;
    } else {
      const uint64_t idx = ofv - (ll == 0 ? 0 : 1);  // 0..3
      if (idx == 0) {
        offset = st->rep[0];
      } else {
        offset = idx == 3 ? st->rep[0] - 1 : st->rep[idx];
        if (offset == 0) offset = ~uint64_t{0};  // corrupt: caught below
        if (idx != 1) st->rep[2] = st->rep[1];
        st->rep[1] = st->rep[0];
        st->rep[0] = offset;
      }
    }
    zcheck(ll <= lit.size() - lp);
    out->insert(out->end(), lit.begin() + static_cast<int64_t>(lp),
                lit.begin() + static_cast<int64_t>(lp + ll));
    lp += ll;
    zcheck(out->size() - start + ml <= block_max);
    zcheck(offset <= out->size() - frame_start);
    const size_t from = out->size() - static_cast<size_t>(offset);
    for (uint64_t k = 0; k < ml; ++k) out->push_back((*out)[from + k]);
    if (i + 1 < nseq) {
      const FseCell& a = st->ll.cells[sll];
      sll = a.next + static_cast<uint32_t>(bits.read(a.nb));
      const FseCell& b = st->ml.cells[sml];
      sml = b.next + static_cast<uint32_t>(bits.read(b.nb));
      const FseCell& c = st->of.cells[sof];
      sof = c.next + static_cast<uint32_t>(bits.read(c.nb));
    }
  }
  zcheck(bits.exact_end());
  out->insert(out->end(), lit.begin() + static_cast<int64_t>(lp), lit.end());
  zcheck(out->size() - start <= block_max);
}

// ----------------------------------------------------------------------------
// CCITT fax

// Run-length codes (T.4 tables 2 and 3, and the extended make-up codes
// common to both colours): {length in bits, code, run}.
struct FaxCode {
  int len;
  int code;
  int run;
};

const FaxCode kWhite[] = {
    {8, 0x35, 0},    {6, 0x7, 1},     {4, 0x7, 2},     {4, 0x8, 3},
    {4, 0xB, 4},     {4, 0xC, 5},     {4, 0xE, 6},     {4, 0xF, 7},
    {5, 0x13, 8},    {5, 0x14, 9},    {5, 0x7, 10},    {5, 0x8, 11},
    {6, 0x8, 12},    {6, 0x3, 13},    {6, 0x34, 14},   {6, 0x35, 15},
    {6, 0x2A, 16},   {6, 0x2B, 17},   {7, 0x27, 18},   {7, 0xC, 19},
    {7, 0x8, 20},    {7, 0x17, 21},   {7, 0x3, 22},    {7, 0x4, 23},
    {7, 0x28, 24},   {7, 0x2B, 25},   {7, 0x13, 26},   {7, 0x24, 27},
    {7, 0x18, 28},   {8, 0x2, 29},    {8, 0x3, 30},    {8, 0x1A, 31},
    {8, 0x1B, 32},   {8, 0x12, 33},   {8, 0x13, 34},   {8, 0x14, 35},
    {8, 0x15, 36},   {8, 0x16, 37},   {8, 0x17, 38},   {8, 0x28, 39},
    {8, 0x29, 40},   {8, 0x2A, 41},   {8, 0x2B, 42},   {8, 0x2C, 43},
    {8, 0x2D, 44},   {8, 0x4, 45},    {8, 0x5, 46},    {8, 0xA, 47},
    {8, 0xB, 48},    {8, 0x52, 49},   {8, 0x53, 50},   {8, 0x54, 51},
    {8, 0x55, 52},   {8, 0x24, 53},   {8, 0x25, 54},   {8, 0x58, 55},
    {8, 0x59, 56},   {8, 0x5A, 57},   {8, 0x5B, 58},   {8, 0x4A, 59},
    {8, 0x4B, 60},   {8, 0x32, 61},   {8, 0x33, 62},   {8, 0x34, 63},
    {5, 0x1B, 64},   {5, 0x12, 128},  {6, 0x17, 192},  {7, 0x37, 256},
    {8, 0x36, 320},  {8, 0x37, 384},  {8, 0x64, 448},  {8, 0x65, 512},
    {8, 0x68, 576},  {8, 0x67, 640},  {9, 0xCC, 704},  {9, 0xCD, 768},
    {9, 0xD2, 832},  {9, 0xD3, 896},  {9, 0xD4, 960},  {9, 0xD5, 1024},
    {9, 0xD6, 1088}, {9, 0xD7, 1152}, {9, 0xD8, 1216}, {9, 0xD9, 1280},
    {9, 0xDA, 1344}, {9, 0xDB, 1408}, {9, 0x98, 1472}, {9, 0x99, 1536},
    {9, 0x9A, 1600}, {6, 0x18, 1664}, {9, 0x9B, 1728},
};
const FaxCode kBlack[] = {
    {10, 0x37, 0},    {3, 0x2, 1},      {2, 0x3, 2},      {2, 0x2, 3},
    {3, 0x3, 4},      {4, 0x3, 5},      {4, 0x2, 6},      {5, 0x3, 7},
    {6, 0x5, 8},      {6, 0x4, 9},      {7, 0x4, 10},     {7, 0x5, 11},
    {7, 0x7, 12},     {8, 0x4, 13},     {8, 0x7, 14},     {9, 0x18, 15},
    {10, 0x17, 16},   {10, 0x18, 17},   {10, 0x8, 18},    {11, 0x67, 19},
    {11, 0x68, 20},   {11, 0x6C, 21},   {11, 0x37, 22},   {11, 0x28, 23},
    {11, 0x17, 24},   {11, 0x18, 25},   {12, 0xCA, 26},   {12, 0xCB, 27},
    {12, 0xCC, 28},   {12, 0xCD, 29},   {12, 0x68, 30},   {12, 0x69, 31},
    {12, 0x6A, 32},   {12, 0x6B, 33},   {12, 0xD2, 34},   {12, 0xD3, 35},
    {12, 0xD4, 36},   {12, 0xD5, 37},   {12, 0xD6, 38},   {12, 0xD7, 39},
    {12, 0x6C, 40},   {12, 0x6D, 41},   {12, 0xDA, 42},   {12, 0xDB, 43},
    {12, 0x54, 44},   {12, 0x55, 45},   {12, 0x56, 46},   {12, 0x57, 47},
    {12, 0x64, 48},   {12, 0x65, 49},   {12, 0x52, 50},   {12, 0x53, 51},
    {12, 0x24, 52},   {12, 0x37, 53},   {12, 0x38, 54},   {12, 0x27, 55},
    {12, 0x28, 56},   {12, 0x58, 57},   {12, 0x59, 58},   {12, 0x2B, 59},
    {12, 0x2C, 60},   {12, 0x5A, 61},   {12, 0x66, 62},   {12, 0x67, 63},
    {10, 0xF, 64},    {12, 0xC8, 128},  {12, 0xC9, 192},  {12, 0x5B, 256},
    {12, 0x33, 320},  {12, 0x34, 384},  {12, 0x35, 448},  {13, 0x6C, 512},
    {13, 0x6D, 576},  {13, 0x4A, 640},  {13, 0x4B, 704},  {13, 0x4C, 768},
    {13, 0x4D, 832},  {13, 0x72, 896},  {13, 0x73, 960},  {13, 0x74, 1024},
    {13, 0x75, 1088}, {13, 0x76, 1152}, {13, 0x77, 1216}, {13, 0x52, 1280},
    {13, 0x53, 1344}, {13, 0x54, 1408}, {13, 0x55, 1472}, {13, 0x5A, 1536},
    {13, 0x5B, 1600}, {13, 0x64, 1664}, {13, 0x65, 1728},
};
const FaxCode kExtended[] = {
    {11, 0x8, 1792},  {11, 0xC, 1856},  {11, 0xD, 1920},  {12, 0x12, 1984},
    {12, 0x13, 2048}, {12, 0x14, 2112}, {12, 0x15, 2176}, {12, 0x16, 2240},
    {12, 0x17, 2304}, {12, 0x1C, 2368}, {12, 0x1D, 2432}, {12, 0x1E, 2496},
    {12, 0x1F, 2560},
};

// libtiff's state tables (mkg3states.c): indexed by the next 7 (2D
// modes), 12 (white) or 13 (black) bits in stream order, the first bit
// lowest; an EOL is 7 (2D) or 11 (1D) zero bits; a pattern that is no
// code is S_Null with width 0, so it consumes nothing.
enum FaxState {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct FaxEnt {
  uint8_t state = S_Null;
  uint8_t width = 0;
  int32_t param = 0;
};

struct FaxTables {
  std::vector<FaxEnt> main, white, black;
  static int reverse(int code, int len) {
    int r = 0;
    for (int i = 0; i < len; ++i) r |= ((code >> (len - 1 - i)) & 1) << i;
    return r;
  }
  static void fill(std::vector<FaxEnt>& t, int size, int code, int len,
                   int state, int param) {
    const int lsb = reverse(code, len);
    for (int i = lsb; i < (1 << size); i += 1 << len) {
      t[static_cast<size_t>(i)].state = static_cast<uint8_t>(state);
      t[static_cast<size_t>(i)].width = static_cast<uint8_t>(len);
      t[static_cast<size_t>(i)].param = param;
    }
  }
  FaxTables() : main(1 << 7), white(1 << 12), black(1 << 13) {
    fill(main, 7, 0x1, 3, S_Horiz, 0);
    fill(main, 7, 0x1, 4, S_Pass, 0);
    fill(main, 7, 0x1, 1, S_V0, 0);
    fill(main, 7, 0x3, 3, S_VR, 1);
    fill(main, 7, 0x3, 6, S_VR, 2);
    fill(main, 7, 0x3, 7, S_VR, 3);
    fill(main, 7, 0x2, 3, S_VL, 1);
    fill(main, 7, 0x2, 6, S_VL, 2);
    fill(main, 7, 0x2, 7, S_VL, 3);
    fill(main, 7, 0x1, 7, S_Ext, 0);
    fill(main, 7, 0x0, 7, S_EOL, 0);
    for (const FaxCode& c : kWhite)
      fill(white, 12, c.code, c.len, c.run < 64 ? S_TermW : S_MakeUpW, c.run);
    for (const FaxCode& c : kBlack)
      fill(black, 13, c.code, c.len, c.run < 64 ? S_TermB : S_MakeUpB, c.run);
    for (const FaxCode& c : kExtended) {
      fill(white, 12, c.code, c.len, S_MakeUp, c.run);
      fill(black, 13, c.code, c.len, S_MakeUp, c.run);
    }
    fill(white, 12, 0x0, 11, S_EOL, 0);
    fill(black, 13, 0x0, 11, S_EOL, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

uint8_t kRev[256];
bool kRevReady = [] {
  for (int i = 0; i < 256; ++i) kRev[i] = static_cast<uint8_t>(
      FaxTables::reverse(i, 8));
  return true;
}();

// _TIFFFax3fillruns: white runs as 0 bits, black as 1, each run cut to
// the row (and written back cut: the row is the next row's reference).
void fax_fill(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; ++k) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      if (k == 1)
        for (uint32_t i = x; i < x + run; ++i)
          buf[i >> 3] = static_cast<uint8_t>(buf[i >> 3] | (0x80 >> (i & 7)));
      else
        for (uint32_t i = x; i < x + run; ++i)
          buf[i >> 3] = static_cast<uint8_t>(buf[i >> 3] & ~(0x80 >> (i & 7)));
      x += runs[k];
    }
  }
}


// ----------------------------------------------------------------------------
// The CCITT decoder: tif_fax3.c's Fax3DecodeRLE, Fax3Decode1D,
// Fax3Decode2D and Fax4Decode with tif_fax3.h's macros, the bit
// accumulator kept as libtiff keeps it (first bit lowest, zeros padded
// at the end of the data once some bits are left).

struct FaxDecoder {
  const uint8_t* cp;
  const uint8_t* ep;
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  int EOLcnt = 0;
  int line = 0;
};

#define EndOfData() (d.cp >= d.ep)
#define GetBits(n) (d.BitAcc & ((1u << (n)) - 1))
#define ClrBits(n) \
  do {             \
    d.BitsAvail -= (n); \
    d.BitAcc >>= (n);   \
  } while (0)
#define NeedBits8(n, eoflab)                                   \
  do {                                                         \
    if (d.BitsAvail < (n)) {                                   \
      if (EndOfData()) {                                       \
        if (d.BitsAvail == 0) goto eoflab;                     \
        d.BitsAvail = (n);                                     \
      } else {                                                 \
        d.BitAcc |= static_cast<uint32_t>(kRev[*d.cp++]) << d.BitsAvail; \
        d.BitsAvail += 8;                                      \
      }                                                        \
    }                                                          \
  } while (0)
#define NeedBits16(n, eoflab)                                  \
  do {                                                         \
    if (d.BitsAvail < (n)) {                                   \
      if (EndOfData()) {                                       \
        if (d.BitsAvail == 0) goto eoflab;                     \
        d.BitsAvail = (n);                                     \
      } else {                                                 \
        d.BitAcc |= static_cast<uint32_t>(kRev[*d.cp++]) << d.BitsAvail; \
        if ((d.BitsAvail += 8) < (n)) {                        \
          if (EndOfData()) {                                   \
            d.BitsAvail = (n);                                 \
          } else {                                             \
            d.BitAcc |= static_cast<uint32_t>(kRev[*d.cp++]) << d.BitsAvail; \
            d.BitsAvail += 8;                                  \
          }                                                    \
        }                                                      \
      }                                                        \
    }                                                          \
  } while (0)
#define LOOKUP8(wid, tab, eoflab)     \
  do {                                \
    NeedBits8(wid, eoflab);           \
    TabEnt = &(tab)[GetBits(wid)];    \
    ClrBits(TabEnt->width);           \
  } while (0)
#define LOOKUP16(wid, tab, eoflab)    \
  do {                                \
    NeedBits16(wid, eoflab);          \
    TabEnt = &(tab)[GetBits(wid)];    \
    ClrBits(TabEnt->width);           \
  } while (0)
#define SETVALUE(x)                                    \
  do {                                                 \
    if (pa >= thisrun + nruns) return -1;              \
    *pa++ = static_cast<uint32_t>(RunLength + (x));    \
    a0 += (x);                                         \
    RunLength = 0;                                     \
  } while (0)
#define CLEANUP_RUNS()                                 \
  do {                                                 \
    if (RunLength) SETVALUE(0);                        \
    if (a0 != lastx) {                                 \
      while (a0 > lastx && pa > thisrun)               \
        a0 -= static_cast<int>(*--pa);                 \
      if (a0 < lastx) {                                \
        if (a0 < 0) a0 = 0;                            \
        if ((pa - thisrun) & 1) SETVALUE(0);           \
        SETVALUE(lastx - a0);                          \
      } else if (a0 > lastx) {                         \
        SETVALUE(lastx);                               \
        SETVALUE(0);                                   \
      }                                                \
    }                                                  \
  } while (0)
#define SYNC_EOL(eoflab)                               \
  do {                                                 \
    if (d.EOLcnt == 0) {                               \
      for (;;) {                                       \
        NeedBits16(11, eoflab);                        \
        if (GetBits(11) == 0) break;                   \
        ClrBits(1);                                    \
      }                                                \
    }                                                  \
    for (;;) {                                         \
      NeedBits8(8, eoflab);                            \
      if (GetBits(8)) break;                           \
      ClrBits(8);                                      \
    }                                                  \
    while (GetBits(1) == 0) ClrBits(1);                \
    ClrBits(1);                                        \
    d.EOLcnt = 0;                                      \
  } while (0)
#define EXPAND1D(eoflab)                                         \
  do {                                                           \
    for (;;) {                                                   \
      for (;;) {                                                 \
        LOOKUP16(12, T.white, eof1d);                            \
        switch (TabEnt->state) {                                 \
          case S_EOL:                                            \
            d.EOLcnt = 1;                                        \
            goto done1d;                                         \
          case S_TermW:                                          \
            SETVALUE(TabEnt->param);                             \
            goto doneWhite1d;                                    \
          case S_MakeUpW:                                        \
          case S_MakeUp:                                         \
            a0 += TabEnt->param;                                 \
            RunLength += TabEnt->param;                          \
            break;                                               \
          default:                                               \
            goto done1d;                                         \
        }                                                        \
      }                                                          \
    doneWhite1d:                                                 \
      if (a0 >= lastx) goto done1d;                              \
      for (;;) {                                                 \
        LOOKUP16(13, T.black, eof1d);                            \
        switch (TabEnt->state) {                                 \
          case S_EOL:                                            \
            d.EOLcnt = 1;                                        \
            goto done1d;                                         \
          case S_TermB:                                          \
            SETVALUE(TabEnt->param);                             \
            goto doneBlack1d;                                    \
          case S_MakeUpB:                                        \
          case S_MakeUp:                                         \
            a0 += TabEnt->param;                                 \
            RunLength += TabEnt->param;                          \
            break;                                               \
          default:                                               \
            goto done1d;                                         \
        }                                                        \
      }                                                          \
    doneBlack1d:                                                 \
      if (a0 >= lastx) goto done1d;                              \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;             \
    }                                                            \
  eof1d:                                                         \
    CLEANUP_RUNS();                                              \
    goto eoflab;                                                 \
  done1d:                                                        \
    CLEANUP_RUNS();                                              \
  } while (0)
#define CHECK_b1                                                 \
  do {                                                           \
    if (pa != thisrun)                                           \
      while (b1 <= a0 && b1 < lastx) {                           \
        if (pb + 1 >= refruns + nruns) return -1;                \
        b1 += static_cast<int>(pb[0] + pb[1]);                   \
        pb += 2;                                                 \
      }                                                          \
  } while (0)
#define EXPAND2D(eoflab)                                         \
  do {                                                           \
    while (a0 < lastx) {                                         \
      if (pa >= thisrun + nruns) return -1;                      \
      LOOKUP8(7, T.main, eof2d);                                 \
      switch (TabEnt->state) {                                   \
        case S_Pass:                                             \
          CHECK_b1;                                              \
          if (pb + 1 >= refruns + nruns) return -1;              \
          b1 += static_cast<int>(*pb++);                         \
          RunLength += b1 - a0;                                  \
          a0 = b1;                                               \
          b1 += static_cast<int>(*pb++);                         \
          break;                                                 \
        case S_Horiz:                                            \
          if ((pa - thisrun) & 1) {                              \
            for (;;) {                                           \
              LOOKUP16(13, T.black, eof2d);                      \
              switch (TabEnt->state) {                           \
                case S_TermB:                                    \
                  SETVALUE(TabEnt->param);                       \
                  goto doneWhite2da;                             \
                case S_MakeUpB:                                  \
                case S_MakeUp:                                   \
                  a0 += TabEnt->param;                           \
                  RunLength += TabEnt->param;                    \
                  break;                                         \
                default:                                         \
                  goto badBlack2d;                               \
              }                                                  \
            }                                                    \
          doneWhite2da:;                                         \
            for (;;) {                                           \
              LOOKUP16(12, T.white, eof2d);                      \
              switch (TabEnt->state) {                           \
                case S_TermW:                                    \
                  SETVALUE(TabEnt->param);                       \
                  goto doneBlack2da;                             \
                case S_MakeUpW:                                  \
                case S_MakeUp:                                   \
                  a0 += TabEnt->param;                           \
                  RunLength += TabEnt->param;                    \
                  break;                                         \
                default:                                         \
                  goto badWhite2d;                               \
              }                                                  \
            }                                                    \
          doneBlack2da:;                                         \
          } else {                                               \
            for (;;) {                                           \
              LOOKUP16(12, T.white, eof2d);                      \
              switch (TabEnt->state) {                           \
                case S_TermW:                                    \
                  SETVALUE(TabEnt->param);                       \
                  goto doneWhite2db;                             \
                case S_MakeUpW:                                  \
                case S_MakeUp:                                   \
                  a0 += TabEnt->param;                           \
                  RunLength += TabEnt->param;                    \
                  break;                                         \
                default:                                         \
                  goto badWhite2d;                               \
              }                                                  \
            }                                                    \
          doneWhite2db:;                                         \
            for (;;) {                                           \
              LOOKUP16(13, T.black, eof2d);                      \
              switch (TabEnt->state) {                           \
                case S_TermB:                                    \
                  SETVALUE(TabEnt->param);                       \
                  goto doneBlack2db;                             \
                case S_MakeUpB:                                  \
                case S_MakeUp:                                   \
                  a0 += TabEnt->param;                           \
                  RunLength += TabEnt->param;                    \
                  break;                                         \
                default:                                         \
                  goto badBlack2d;                               \
              }                                                  \
            }                                                    \
          doneBlack2db:;                                         \
          }                                                      \
          CHECK_b1;                                              \
          break;                                                 \
        case S_V0:                                               \
          CHECK_b1;                                              \
          SETVALUE(b1 - a0);                                     \
          if (pb >= refruns + nruns) return -1;                  \
          b1 += static_cast<int>(*pb++);                         \
          break;                                                 \
        case S_VR:                                               \
          CHECK_b1;                                              \
          SETVALUE(b1 - a0 + TabEnt->param);                     \
          if (pb >= refruns + nruns) return -1;                  \
          b1 += static_cast<int>(*pb++);                         \
          break;                                                 \
        case S_VL:                                               \
          CHECK_b1;                                              \
          if (b1 < a0 + TabEnt->param) goto eol2d;               \
          SETVALUE(b1 - a0 - TabEnt->param);                     \
          b1 -= static_cast<int>(*--pb);                         \
          break;                                                 \
        case S_Ext:                                              \
          *pa++ = static_cast<uint32_t>(lastx - a0);             \
          goto eol2d;                                            \
        case S_EOL:                                              \
          *pa++ = static_cast<uint32_t>(lastx - a0);             \
          NeedBits8(4, eof2d);                                   \
          ClrBits(4);                                            \
          d.EOLcnt = 1;                                          \
          goto eol2d;                                            \
        default:                                                 \
        badMain2d:                                               \
          goto eol2d;                                            \
        badBlack2d:                                              \
          goto eol2d;                                            \
        badWhite2d:                                              \
          goto eol2d;                                            \
        eof2d:                                                   \
          CLEANUP_RUNS();                                        \
          goto eoflab;                                           \
      }                                                          \
    }                                                            \
    if (RunLength) {                                             \
      if (RunLength + a0 < lastx) {                              \
        NeedBits8(1, eof2d);                                     \
        if (!GetBits(1)) goto badMain2d;                         \
        ClrBits(1);                                              \
      }                                                          \
      SETVALUE(0);                                               \
    }                                                            \
  eol2d:                                                         \
    CLEANUP_RUNS();                                              \
  } while (0)

// The state every decode function below starts from (Fax3PreDecode and
// Fax3SetupState): runs for a row and, for 2D coding, the reference row,
// all white.
#define FAX_PROLOGUE(twod)                                                \
  const FaxTables& T = fax_tables();                                      \
  FaxDecoder d{src, src + n};                                             \
  const int lastx = static_cast<int>(width);                              \
  const int64_t nruns =                                                   \
      (twod) ? 2 * ((width + 31) / 32 * 32) : (width + 31) / 32 * 32 + 2; \
  std::vector<uint32_t> runs(static_cast<size_t>(2 * nruns + 4), 0);      \
  uint32_t* curruns = runs.data();                                        \
  uint32_t* refruns = runs.data() + nruns;                                \
  refruns[0] = static_cast<uint32_t>(width);                              \
  refruns[1] = 0;                                                         \
  const int64_t rowbytes = (width + 7) / 8;                               \
  const FaxEnt* TabEnt = nullptr;                                         \
  uint32_t* thisrun = curruns;                                            \
  uint32_t* pa = nullptr;                                                 \
  uint32_t* pb = nullptr;                                                 \
  int a0 = 0, RunLength = 0, b1 = 0;                                      \
  uint8_t* buf = out;                                                     \
  int64_t row = 0;                                                        \
  (void)pb;                                                               \
  (void)b1;                                                               \
  (void)T

// Fax3DecodeRLE: modified Huffman, each row from a byte boundary. With
// word_align (RLE-word) the bits left in the accumulator are cut to a
// multiple of 16 and, when none are left, a byte is skipped where the
// input pointer is odd: libtiff reads the strip in place in the mapped
// file, so `parity` is the strip's file offset's. Premature end of data
// fails the strip.
int64_t fax_rle(const uint8_t* src, int64_t n, uint8_t* out, int64_t rows,
                int64_t width, bool word_align, int parity) {
  FAX_PROLOGUE(false);
  for (; row < rows; ++row) {
    buf = out + row * rowbytes;
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    EXPAND1D(EOFRLE);
    fax_fill(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    if (!word_align) {
      const int k = d.BitsAvail - (d.BitsAvail & ~7);
      ClrBits(k);
    } else {
      const int k = d.BitsAvail - (d.BitsAvail & ~15);
      ClrBits(k);
      if (d.BitsAvail == 0 && ((d.cp - src + parity) & 1)) d.cp++;
    }
  }
  return rows;
EOFRLE:
  return -1;
}

// Fax3Decode1D: Group 3 with an EOL before every row. Data that ends
// early ends the strip after the current row, white from where it
// stopped (libtiff 4.7 keeps the rows decoded when there is one before
// it, and fails the strip otherwise).
int64_t fax_g3_1d(const uint8_t* src, int64_t n, uint8_t* out, int64_t rows,
                  int64_t width) {
  FAX_PROLOGUE(false);
  for (; row < rows; ++row) {
    buf = out + row * rowbytes;
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    SYNC_EOL(EOF1D);
    EXPAND1D(EOF1D);
    fax_fill(buf, thisrun, pa, static_cast<uint32_t>(lastx));
  }
  return rows;
EOF1D:
  fax_fill(buf, thisrun, pa, static_cast<uint32_t>(lastx));
  return row > 0 ? row + 1 : -1;
}

// Fax3Decode2D: Group 3 with T4Options bit 0, each row's EOL followed by
// its tag bit (1: 1D, 0: 2D against the row above). Data that ends
// early returns -3: libtiff 4.7 fails some such strips and returns the
// rest of others from its caller's buffer, by a rule not ported here.
int64_t fax_g3_2d(const uint8_t* src, int64_t n, uint8_t* out, int64_t rows,
                  int64_t width) {
  FAX_PROLOGUE(true);
  int is1d = 0;
  for (; row < rows; ++row) {
    buf = out + row * rowbytes;
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    SYNC_EOL(EOF2D);
    NeedBits8(1, EOF2D);
    is1d = static_cast<int>(GetBits(1));
    ClrBits(1);
    pb = refruns;
    b1 = static_cast<int>(*pb++);
    if (is1d) {
      EXPAND1D(EOF2Da);
    } else {
      EXPAND2D(EOF2Da);
    }
    fax_fill(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    if (pa < thisrun + nruns) SETVALUE(0);
    std::swap(curruns, refruns);
  }
  return rows;
EOF2D:
EOF2Da:
  return -3;
}

// Fax4Decode: Group 4. An EOL or the end of the data ends the strip
// after the current row: libtiff returns the rows decoded when there is
// at least one before it, and fails the strip otherwise.
int64_t fax_g4(const uint8_t* src, int64_t n, uint8_t* out, int64_t rows,
               int64_t width) {
  FAX_PROLOGUE(true);
  for (; row < rows; ++row) {
    buf = out + row * rowbytes;
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    pb = refruns;
    b1 = static_cast<int>(*pb++);
    EXPAND2D(EOFG4);
    if (d.EOLcnt) goto EOFG4;
    fax_fill(buf, thisrun, pa, static_cast<uint32_t>(lastx));
    SETVALUE(0);
    std::swap(curruns, refruns);
  }
  return rows;
EOFG4:
  fax_fill(buf, thisrun, pa, static_cast<uint32_t>(lastx));
  return row > 0 ? row + 1 : -1;
}

#undef FAX_PROLOGUE
#undef EndOfData
#undef GetBits
#undef ClrBits
#undef NeedBits8
#undef NeedBits16
#undef LOOKUP8
#undef LOOKUP16
#undef SETVALUE
#undef CLEANUP_RUNS
#undef SYNC_EOL
#undef EXPAND1D
#undef CHECK_b1
#undef EXPAND2D

// ----------------------------------------------------------------------------
// ThunderScan: tif_thunder.c ThunderDecode, one row of `maxpixels` 4-bit
// pixels; returns 0 where libtiff reports not enough or too much data
// (the row's rest then zeroed), 2 where a run that reaches the row's end
// leaves its pixels unwritten (libtiff writes a run only while it ends
// before the row's end), else 1.

int thunder_row(const uint8_t*& bp, int64_t& cc, uint8_t* op0,
                int64_t maxpixels) {
  bool unwritten = false;
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  uint8_t* op = op0;
  unsigned lastpixel = 0;
  int64_t npixels = 0;
  auto setpixel = [&](unsigned v) {
    lastpixel = v & 0xf;
    if (npixels < maxpixels) {
      if (npixels++ & 1)
        *op++ |= static_cast<uint8_t>(lastpixel);
      else
        op[0] = static_cast<uint8_t>(lastpixel << 4);
    }
  };
  while (cc > 0 && npixels < maxpixels) {
    int n = *bp++;
    cc--;
    int delta;
    switch (n & 0xc0) {
      case 0x00:
        n &= 0x3f;
        if (npixels & 1) {
          op[0] = static_cast<uint8_t>(op[0] | lastpixel);
          lastpixel = *op++;
          npixels++;
          n--;
        } else {
          lastpixel |= lastpixel << 4;
        }
        npixels += n;
        if (npixels < maxpixels)
          for (; n > 0; n -= 2) *op++ = static_cast<uint8_t>(lastpixel);
        else if (n > 0)
          unwritten = true;  // a run that reaches the row's end
        if (n == -1) *--op &= 0xf0;
        lastpixel &= 0xf;
        break;
      case 0x40:
        if ((delta = (n >> 4) & 3) != 2)
          setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) +
                                         two[delta]));
        if ((delta = (n >> 2) & 3) != 2)
          setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) +
                                         two[delta]));
        if ((delta = n & 3) != 2)
          setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) +
                                         two[delta]));
        break;
      case 0x80:
        if ((delta = (n >> 3) & 7) != 4)
          setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) +
                                         three[delta]));
        if ((delta = n & 7) != 4)
          setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) +
                                         three[delta]));
        break;
      default:
        setpixel(static_cast<unsigned>(n));
        break;
    }
  }
  if (npixels != maxpixels) {
    uint8_t* op_end = op0 + (maxpixels + 1) / 2;
    if (op < op_end) std::memset(op, 0, static_cast<size_t>(op_end - op));
    return 0;
  }
  return unwritten ? 2 : 1;
}

// ----------------------------------------------------------------------------
// CIELab: littleCMS's Lab (D50) -> sRGB transform.

typedef double Mat3[3][3];

void mat_inverse(const Mat3 a, Mat3 b) {  // _cmsMAT3inverse
  const double c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const double c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0];
  const double c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  const double det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2;
  b[0][0] = c0 / det;
  b[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det;
  b[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det;
  b[1][0] = c1 / det;
  b[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det;
  b[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det;
  b[2][0] = c2 / det;
  b[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det;
  b[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det;
}

void mat_mul(const Mat3 a, const Mat3 b, Mat3 r) {  // _cmsMAT3per
  Mat3 t;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      t[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
  std::memcpy(r, t, sizeof(Mat3));
}

void mat_eval(const Mat3 a, const double v[3], double r[3]) {
  double t[3];
  for (int i = 0; i < 3; ++i)
    t[i] = a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2];
  r[0] = t[0];
  r[1] = t[1];
  r[2] = t[2];
}

// cmsCreate_sRGBProfile's colorant matrix (_cmsBuildRGB2XYZtransferMatrix
// with D65 = (0.3127, 0.3290) and Rec. 709 primaries, adapted to D50 by
// Bradford), inverted and scaled by MAX_ENCODEABLE_XYZ as
// BuildRGBOutputMatrixShaper does.
void srgb_output_matrix(Mat3 out) {
  const double xn = 0.3127, yn = 0.3290;
  const double xr = 0.64, yr = 0.33, xg = 0.30, yg = 0.60, xb = 0.15,
               yb = 0.06;
  Mat3 prim = {{xr, xg, xb}, {yr, yg, yb},
               {(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)}};
  Mat3 inv;
  mat_inverse(prim, inv);
  const double white[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn};
  double coef[3];
  mat_eval(inv, white, coef);
  Mat3 m = {{coef[0] * xr, coef[1] * xg, coef[2] * xb},
            {coef[0] * yr, coef[1] * yg, coef[2] * yb},
            {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
             coef[2] * (1.0 - xb - yb)}};
  // _cmsAdaptMatrixToD50: Bradford from the D65 XYZ to D50.
  const double src[3] = {(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0};
  const double dst[3] = {0.9642, 1.0, 0.8249};
  Mat3 brad = {{0.8951, 0.2664, -0.1614},
               {-0.7502, 1.7135, 0.0367},
               {0.0389, -0.0685, 1.0296}};
  Mat3 brad_inv;
  mat_inverse(brad, brad_inv);
  double cs[3], cd[3];
  mat_eval(brad, src, cs);
  mat_eval(brad, dst, cd);
  Mat3 cone = {{cd[0] / cs[0], 0.0, 0.0},
               {0.0, cd[1] / cs[1], 0.0},
               {0.0, 0.0, cd[2] / cs[2]}};
  Mat3 tmp, conv;
  mat_mul(cone, brad, tmp);
  mat_mul(brad_inv, tmp, conv);
  mat_mul(conv, m, m);
  mat_inverse(m, out);
  const double adj = 1.0 + 32767.0 / 32768.0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i][j] *= adj;
}

inline double lab_f1(double t) {  // cmsLab2XYZ's inverse of f
  const double limit = 24.0 / 116.0;
  if (t <= limit) return (108.0 / 841.0) * (t - (16.0 / 116.0));
  return t * t * t;
}

// _cmsQuickSaturateWord.
inline uint16_t quick_saturate(double d) {
  d += 0.5;
  if (d <= 0) return 0;
  if (d >= 65535.0) return 0xffff;
  const double magic = 68719476736.0 * 1.5;
  volatile double t = (d - 32767.0) + magic;
  int64_t bits;
  std::memcpy(&bits, const_cast<double*>(&t), 8);
  const int32_t low = static_cast<int32_t>(bits & 0xffffffff);
  return static_cast<uint16_t>((low >> 16) + 32767);
}

inline float srgb_inverse(float v) {  // parametric type -4 (sRGB)
  const double g = 2.4, a = 1.0 / 1.055, b = 0.055 / 1.055, c = 1.0 / 12.92,
               dd = 0.04045;
  const double R = v;
  const double e = a * dd + b;
  const double disc = e < 0 ? 0 : std::pow(e, g);
  double val;
  if (R >= disc)
    val = (std::pow(R, 1.0 / g) - b) / a;
  else
    val = R / c;
  return static_cast<float>(val);
}

struct LabClut {
  std::vector<uint16_t> nodes;  // 33^3 x 3
  LabClut() : nodes(33 * 33 * 33 * 3) {
    Mat3 m;
    srgb_output_matrix(m);
    const double adj = 1.0 + 32767.0 / 32768.0;
    for (int i = 0; i < 33; ++i)
      for (int j = 0; j < 33; ++j)
        for (int k = 0; k < 33; ++k) {
          const int idx[3] = {i, j, k};
          float in[3];
          for (int c = 0; c < 3; ++c) {
            const uint16_t q = quick_saturate(idx[c] * 65535.0 / 32.0);
            in[c] = static_cast<float>(q / 65535.0);
          }
          const double L = in[0] * 100.0;
          const double A = in[1] * 255.0 - 128.0;
          const double B = in[2] * 255.0 - 128.0;
          const double y = (L + 16.0) / 116.0;
          const double x = y + 0.002 * A;
          const double z = y - 0.005 * B;
          float xyz[3] = {static_cast<float>(lab_f1(x) * 0.9642 / adj),
                          static_cast<float>(lab_f1(y) * 1.0 / adj),
                          static_cast<float>(lab_f1(z) * 0.8249 / adj)};
          for (int r = 0; r < 3; ++r) {
            double t = 0;
            for (int c = 0; c < 3; ++c) t += xyz[c] * m[r][c];
            const float lin = static_cast<float>(t);
            const float out = srgb_inverse(lin);
            nodes[static_cast<size_t>(((i * 33 + j) * 33 + k) * 3 + r)] =
                quick_saturate(out * 65535.0);
          }
        }
  }
};

const LabClut& lab_clut() {
  static const LabClut t;
  return t;
}

// TetrahedralInterp16 on the 33^3 table, for 16-bit inputs.
void tetra16(const uint16_t* lut, const uint16_t in[3], uint16_t out[3]) {
  int fx[3], x0[3], rx[3];
  for (int c = 0; c < 3; ++c) {
    const int a = in[c] * 32;
    fx[c] = a + (a + 0x7fff) / 0xffff;
    x0[c] = fx[c] >> 16;
    rx[c] = fx[c] & 0xffff;
  }
  const int opta[3] = {33 * 33 * 3, 33 * 3, 3};
  int X1 = in[0] == 0xffff ? 0 : opta[0];
  int Y1 = in[1] == 0xffff ? 0 : opta[1];
  int Z1 = in[2] == 0xffff ? 0 : opta[2];
  const uint16_t* t = lut + x0[0] * opta[0] + x0[1] * opta[1] + x0[2] * opta[2];
  const int rX = rx[0], rY = rx[1], rZ = rx[2];
  for (int o = 0; o < 3; ++o) {
    int c0 = t[o], c1, c2, c3;
    if (rX >= rY) {
      if (rY >= rZ) {
        c1 = t[X1 + o];
        c2 = t[X1 + Y1 + o];
        c3 = t[X1 + Y1 + Z1 + o];
        c3 -= c2;
        c2 -= c1;
        c1 -= c0;
      } else if (rZ >= rX) {
        c1 = t[X1 + Z1 + o];
        c2 = t[X1 + Y1 + Z1 + o];
        c3 = t[Z1 + o];
        c2 -= c1;
        c1 -= c3;
        c3 -= c0;
      } else {
        c1 = t[X1 + o];
        c2 = t[X1 + Y1 + Z1 + o];
        c3 = t[X1 + Z1 + o];
        c2 -= c3;
        c3 -= c1;
        c1 -= c0;
      }
    } else {
      if (rX >= rZ) {
        c1 = t[X1 + Y1 + o];
        c2 = t[Y1 + o];
        c3 = t[X1 + Y1 + Z1 + o];
        c3 -= c1;
        c1 -= c2;
        c2 -= c0;
      } else if (rY >= rZ) {
        c1 = t[X1 + Y1 + Z1 + o];
        c2 = t[Y1 + o];
        c3 = t[Y1 + Z1 + o];
        c1 -= c3;
        c3 -= c2;
        c2 -= c0;
      } else {
        c1 = t[X1 + Y1 + Z1 + o];
        c2 = t[Y1 + Z1 + o];
        c3 = t[Z1 + o];
        c1 -= c2;
        c2 -= c3;
        c3 -= c0;
      }
    }
    const int rest = c1 * rX + c2 * rY + c3 * rZ + 0x8001;
    out[o] = static_cast<uint16_t>(c0 + ((rest + (rest >> 16)) >> 16));
  }
}

}  // namespace

extern "C" {

// Zstandard: one strip or tile, `need` bytes into out. Returns need, or
// -1 on an error or too little output (out then holds the output of the
// blocks decoded before the error).
int64_t tb_zstd_decode(const uint8_t* src, int64_t n, uint8_t* out,
                       int64_t need) {
  std::vector<uint8_t> buf;
  size_t flushed = 0;  // the output of the blocks decoded whole
  try {
    const size_t len = static_cast<size_t>(n);
    zcheck(len >= 4);
    uint32_t magic;
    std::memcpy(&magic, src, 4);
    zcheck(magic == 0xFD2FB528u);
    size_t pos = 4;
    zcheck(pos < len);
    const uint8_t fhd = src[pos++];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
              checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    zcheck((fhd & 8) == 0);
    uint64_t window = 0;
    if (!single) {
      zcheck(pos < len);
      const uint8_t wd = src[pos++];
      const int wlog = 10 + (wd >> 3);
      zcheck(wlog <= 31);
      const uint64_t base = uint64_t{1} << wlog;
      window = base + (base / 8) * (wd & 7);
    }
    const int did_size = did_flag == 0 ? 0 : did_flag == 3 ? 4 : did_flag;
    zcheck(pos + static_cast<size_t>(did_size) <= len);
    uint32_t dict_id = 0;
    for (int i = 0; i < did_size; ++i)
      dict_id |= static_cast<uint32_t>(src[pos + i]) << (8 * i);
    pos += static_cast<size_t>(did_size);
    zcheck(dict_id == 0);  // libzstd: dictionary_wrong
    const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0)
                         : fcs_flag == 1 ? 2
                         : fcs_flag == 2 ? 4
                                         : 8;
    zcheck(pos + static_cast<size_t>(fcs_size) <= len);
    uint64_t fcs = 0;
    for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t{src[pos + i]} << (8 * i);
    if (fcs_size == 2) fcs += 256;
    pos += static_cast<size_t>(fcs_size);
    const bool has_fcs = fcs_size > 0;
    if (single) window = fcs;
    zcheck(window <= (uint64_t{1} << 27));  // ZSTD_d_windowLogMax's default
    const size_t block_max =
        static_cast<size_t>(std::min<uint64_t>(window, 128 * 1024));
    const size_t want = static_cast<size_t>(need);
    // The frame's extent: libzstd's one-pass path needs it all.
    size_t end = pos;
    bool whole = false;
    for (;;) {
      if (end + 3 > len) break;
      const uint32_t bh = src[end] | (uint32_t{src[end + 1]} << 8) |
                          (uint32_t{src[end + 2]} << 16);
      const size_t bsize = (bh >> 1 & 3) == 1 ? 1 : bh >> 3;
      if (end + 3 + bsize > len) break;
      end += 3 + bsize;
      if (bh & 1) {
        whole = end + (checksum ? 4 : 0) <= len;
        break;
      }
    }
    const bool one_pass = has_fcs && fcs <= want && whole;
    ZState st;
    buf.reserve(want + block_max);
    bool exact = false;  // the strip filled exactly at a block's end
    for (;;) {
      if (pos + 3 > len) break;
      const uint32_t bh = src[pos] | (uint32_t{src[pos + 1]} << 8) |
                          (uint32_t{src[pos + 2]} << 16);
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t bsize = bh >> 3;
      zcheck(type != 3);
      const size_t csize = type == 1 ? 1 : bsize;
      if (pos + 3 + csize > len) break;  // libzstd waits for more input
      pos += 3;
      zcheck(bsize <= block_max);
      if (type == 0) {
        buf.insert(buf.end(), src + pos, src + pos + bsize);
      } else if (type == 1) {
        buf.insert(buf.end(), bsize, src[pos]);
      } else {
        zstd_block(src + pos, bsize, &st, &buf, block_max, 0);
      }
      pos += csize;
      flushed = buf.size();
      if (one_pass) zcheck(buf.size() <= want);
      if (last) {
        if (has_fcs) zcheck(buf.size() == fcs);
        if (checksum && pos + 4 <= len && (one_pass || buf.size() <= want)) {
          uint32_t stored;
          std::memcpy(&stored, src + pos, 4);
          zcheck(stored == static_cast<uint32_t>(xxh64(buf.data(),
                                                       buf.size())));
        }
        break;
      }
      if (!one_pass) {
        if (exact || buf.size() > want) break;
        exact = buf.size() == want;
      }
    }
    if (buf.size() < want) return -1;
    std::memcpy(out, buf.data(), want);
    return need;
  } catch (...) {
    // What libzstd's streaming decode flushed to the strip before the
    // failing block (TIFFRGBAImage keeps it).
    std::memcpy(out, buf.data(), std::min(flushed, static_cast<size_t>(need)));
    return -1;
  }
}


// CCITT: one strip or tile, `rows` rows of `width` pixels into out
// (rows of ceil(width / 8) bytes, black as 1 bits, zeroed by the
// caller). scheme: 2 MH, 32771 MH word-aligned (options: the parity of
// the strip's file offset), 3 Group 3 (options: its T4Options), 4
// Group 4. Returns the rows libtiff writes (rows, or fewer
// for a Group 3 1D or Group 4 strip that ends early), -1 where its
// decode fails, -3 for a 2D Group 3 strip that ends early.
int64_t tb_fax_decode(const uint8_t* src, int64_t n, uint8_t* out,
                      int64_t rows, int64_t width, int64_t scheme,
                      int64_t options) {
  if (scheme == 2 || scheme == 32771)
    return fax_rle(src, n, out, rows, width, scheme == 32771,
                   static_cast<int>(options & 1));
  if (scheme == 3)
    return (options & 1) ? fax_g3_2d(src, n, out, rows, width)
                         : fax_g3_1d(src, n, out, rows, width);
  return fax_g4(src, n, out, rows, width);
}

// ThunderScan: `rows` rows of `width` 4-bit pixels (rows of
// ceil(width / 2) bytes). Returns rows, -1 where a row has not enough or
// too much data (libtiff's error), -3 where a row's last run is left
// unwritten (PIL then shows its buffer's old bytes).
int64_t tb_thunder_decode(const uint8_t* src, int64_t n, uint8_t* out,
                          int64_t rows, int64_t width) {
  const uint8_t* bp = src;
  int64_t cc = n;
  const int64_t rowbytes = (width + 1) / 2;
  bool unwritten = false;
  for (int64_t r = 0; r < rows; ++r) {
    const int ok = thunder_row(bp, cc, out + r * rowbytes, width);
    if (!ok) return -1;
    unwritten = unwritten || ok == 2;
  }
  return unwritten ? -3 : rows;
}

// Pillow's LAB -> RGB of n pixels: lab (n, 3) as Pillow holds LAB (a and
// b offset by 128) -> rgb (n, 3).
int64_t tb_lab_to_rgb(const uint8_t* lab, int64_t n, uint8_t* rgb) {
  const uint16_t* lut = lab_clut().nodes.data();
  for (int64_t i = 0; i < n; ++i) {
    const uint16_t in[3] = {static_cast<uint16_t>(lab[3 * i] * 257),
                            static_cast<uint16_t>(lab[3 * i + 1] * 257),
                            static_cast<uint16_t>(lab[3 * i + 2] * 257)};
    uint16_t out[3];
    tetra16(lut, in, out);
    for (int c = 0; c < 3; ++c)
      rgb[3 * i + c] = static_cast<uint8_t>((out[c] * 65281 + 8388608) >> 24);
  }
  return n;
}

// TIFFRGBAImage's YCbCr route over one decoded strip or tile: `data`
// holds block rows of ceil(data_w / h) blocks of h * v luma bytes then Cb
// and Cr; rgb receives the first bw x bh pixels (row stride `stride`
// pixels, 3 bytes each). coeffs: YCbCrCoefficients, rbw:
// ReferenceBlackWhite (as libtiff's floats). Bytes past n read zeros.
int64_t tb_ycbcr_to_rgb(const uint8_t* data, int64_t n, int64_t data_w,
                        int64_t bw, int64_t bh, int64_t h, int64_t v,
                        const float* coeffs, const float* rbw, uint8_t* rgb,
                        int64_t stride) {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y_tab[256];
  const float lr = coeffs[0], lg = coeffs[1], lb = coeffs[2];
  auto clampf = [](float f, float lo, float hi) {
    return !(f >= lo) ? lo : f > hi ? hi : f;
  };
  auto fix = [](float x) {
    return static_cast<int32_t>(static_cast<double>(x * 65536.0f) + 0.5);
  };
  const float f1 = 2 - 2 * lr;
  const int32_t D1 = fix(clampf(f1, 0.0F, 2.0F));
  const float f2 = lr * f1 / lg;
  const int32_t D2 = -fix(clampf(f2, 0.0F, 2.0F));
  const float f3 = 2 - 2 * lb;
  const int32_t D3 = fix(clampf(f3, 0.0F, 2.0F));
  const float f4 = lb * f3 / lg;
  const int32_t D4 = -fix(clampf(f4, 0.0F, 2.0F));
  auto code2v = [](int c, float rb, float rw, float cr) {
    const float den = (rw - rb != 0) ? (rw - rb) : 1;
    return (static_cast<float>(c - static_cast<int32_t>(rb)) * cr) / den;
  };
  const int32_t one_half = 1 << 15;
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    const int32_t Cr = static_cast<int32_t>(
        clampf(code2v(x, rbw[4] - 128.0F, rbw[5] - 128.0F, 127), -128.0F * 32,
               128.0F * 32));
    const int32_t Cb = static_cast<int32_t>(
        clampf(code2v(x, rbw[2] - 128.0F, rbw[3] - 128.0F, 127), -128.0F * 32,
               128.0F * 32));
    cr_r[i] = (D1 * Cr + one_half) >> 16;
    cb_b[i] = (D3 * Cb + one_half) >> 16;
    cr_g[i] = D2 * Cr;
    cb_g[i] = D4 * Cb + one_half;
    y_tab[i] = static_cast<int32_t>(clampf(code2v(x + 128, rbw[0], rbw[1], 255),
                                           -128.0F * 32, 128.0F * 32));
  }
  auto clamp255 = [](int32_t i) {
    return static_cast<uint8_t>(i < 0 ? 0 : i > 255 ? 255 : i);
  };
  // Bytes from one block row to the next: the blocks put, then the
  // put routine's "fromskew" over the rest of the data's row, which
  // putcontig8bitYCbCr44tile counts in 10-byte (4x2) blocks.
  const int64_t block = h * v + 2;
  const int64_t skew_block = (h == 4 && v == 4) ? 10 : block;
  const int64_t pitch =
      (bw + h - 1) / h * block + (data_w - bw) / h * skew_block;
  for (int64_t y = 0; y < bh; ++y) {
    for (int64_t x = 0; x < bw; ++x) {
      const int64_t at = (y / v) * pitch + (x / h) * block;
      auto byte = [&](int64_t k) -> int { return k < n ? data[k] : 0; };
      const int Y = byte(at + (y % v) * h + x % h);
      const int Cb = byte(at + h * v), Cr = byte(at + h * v + 1);
      uint8_t* o = rgb + 3 * (y * stride + x);
      o[0] = clamp255(y_tab[Y] + cr_r[Cr]);
      o[1] = clamp255(y_tab[Y] + static_cast<int32_t>((cb_g[Cb] + cr_g[Cr]) >> 16));
      o[2] = clamp255(y_tab[Y] + cb_b[Cb]);
    }
  }
  return bw * bh;
}

}  // extern "C"
