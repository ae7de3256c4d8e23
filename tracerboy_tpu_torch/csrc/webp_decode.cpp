// The bitstream decoders of the port's WebP and QOI readers
// (core/webp.py, core/qoi.py): VP8L (lossless WebP), VP8 (lossy WebP) with
// libwebp's RGB conversion, the ALPH chunk's alpha plane, and QOI's
// per-pixel loops (the decoder, and the specification's encoder that
// core/qoi.write_qoi uses). Host code, compiled with g++ at first use into the
// port's build directory (utils/build.py) and called through ctypes; the
// containers (RIFF chunks, animation frames, the canvas) are parsed in
// Python.
//
// The readers must give the pixels PIL gives, and PIL reads WebP through
// libwebp's WebPAnimDecoder (RGBA output, fancy upsampling on, no
// dithering), so each routine follows libwebp where the specifications
// (RFC 9649 for VP8L and ALPH, RFC 6386 for VP8) leave it a choice:
// - tb_webp_vp8l_decode / the ALPH stream: prefix codes must be complete
//   (a single used symbol codes with zero bits); a transform type may
//   appear once; a colour-indexing palette is delta-coded and padded
//   with transparent black to 2^(8 >> bits) entries; predictor modes 14
//   and 15 predict black; reading past the data is an error, where the
//   data is counted as at least 8 bytes (libwebp's 64-bit window), but
//   for an alpha plane libwebp decodes 8 bits a pixel (colour indexing
//   alone), where it is one only while pixels remain.
// - tb_webp_vp8_decode: libwebp's frame decoder: 127 above the first
//   macroblock row and 129 left of the first column (the corner 127 on
//   the first row, 129 below it), the top-right samples of the last
//   column replicated, intra prediction from unfiltered samples, the
//   loop filter in macroblock order (left edge, inner vertical edges,
//   top edge, inner horizontal edges) and off for the whole frame when
//   the frame's level is 0, inner edges skipped for 16x16 macroblocks
//   without coefficients, coefficients stored as int16. Output:
//   VP8YUVToR/G/B (14-bit fixed point, MultHi) after the "fancy"
//   upsampler, (9a + 3b + 3c + d + 8) >> 4 per chroma sample from its
//   nearest and next rows and columns, mirrored at the edges.
// - tb_webp_alpha_decode: ALPH compression 0 (raw) and 1 (a VP8L stream
//   without header, its green channel), then the filter undone as
//   libwebp's HorizontalUnfilter / VerticalUnfilter / GradientUnfilter.
// - tb_qoi_decode: Pillow's QoiDecoder (QoiImagePlugin.py), whose index
//   starts empty (a missing entry reads as 0, 0, 0, 0) and is not
//   updated by runs; a stream that ends early is an error.
//
// Each entry point returns 0 on success and a negative code on error.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

#include "webp_vp8l_tables.inc"

// ---------------------------------------------------------------------------
// VP8L

// LSB-first bit reader. Bits past the data read as 0; `eos` once more
// bits were consumed than the data holds (at least 64, as libwebp's
// window holds 8 bytes from the start).
struct LBits {
  const uint8_t* buf;
  int64_t len;
  int64_t pos = 0;
  uint64_t val = 0;
  int nbits = 0;
  int64_t consumed = 0;
  int64_t limit;

  LBits(const uint8_t* b, int64_t n) : buf(b), len(n) {
    limit = std::max<int64_t>(n, 8) * 8;
  }
  void fill() {
    while (nbits <= 56) {
      const uint64_t b = pos < len ? buf[pos] : 0;
      ++pos;
      val |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return uint32_t(val & ((uint64_t(1) << n) - 1));
  }
  void skip(int n) {
    val >>= n;
    nbits -= n;
    consumed += n;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  bool eos() const { return consumed > limit; }
};

constexpr int kRootBits = 8;

// A canonical prefix code read MSB-first from an LSB-first stream: a
// root table for codes of up to kRootBits bits, a search by length for
// the longer ones.
struct Huffman {
  int single = -1;                     // the one symbol of a 0-bit code
  std::vector<uint16_t> root_sym;      // (1 << kRootBits) entries
  std::vector<uint8_t> root_len;       // 0: longer than kRootBits
  int first_code[16] = {0};
  int first_index[16] = {0};
  int count[16] = {0};
  std::vector<uint16_t> sorted;

  // libwebp's VP8LBuildHuffmanTable rules: lengths <= 15, not all zero,
  // a single used symbol is a 0-bit code, else the code must be full.
  bool build(const int* lengths, int n) {
    int cnt[16] = {0};
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15 || lengths[s] < 0) return false;
      ++cnt[lengths[s]];
    }
    if (cnt[0] == n) return false;
    if (n - cnt[0] == 1) {
      for (int s = 0; s < n; ++s)
        if (lengths[s]) single = s;
      return true;
    }
    int open = 1;
    for (int l = 1; l <= 15; ++l) {
      open = open * 2 - cnt[l];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    int code = 0, index = 0;
    for (int l = 1; l <= 15; ++l) {
      count[l] = cnt[l];
      first_code[l] = code;
      first_index[l] = index;
      code = (code + cnt[l]) << 1;
      index += cnt[l];
    }
    sorted.assign(index, 0);
    int next[16];
    for (int l = 0; l < 16; ++l) next[l] = first_index[l];
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[next[lengths[s]]++] = uint16_t(s);
    root_sym.assign(1 << kRootBits, 0);
    root_len.assign(1 << kRootBits, 0);
    for (int l = 1; l <= kRootBits; ++l) {
      for (int i = 0; i < count[l]; ++i) {
        const int c = first_code[l] + i;
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> (l - 1 - b)) & 1) << b;
        for (int k = rev; k < (1 << kRootBits); k += 1 << l) {
          root_sym[k] = sorted[first_index[l] + i];
          root_len[k] = uint8_t(l);
        }
      }
    }
    return true;
  }

  int read(LBits& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(15);
    const int l0 = root_len[bits & ((1 << kRootBits) - 1)];
    if (l0) {
      br.skip(l0);
      return root_sym[bits & ((1 << kRootBits) - 1)];
    }
    int code = 0;
    for (int l = 1; l <= 15; ++l) {
      code = (code << 1) | int((bits >> (l - 1)) & 1);
      const int d = code - first_code[l];
      if (d >= 0 && d < count[l]) {
        br.skip(l);
        return sorted[first_index[l] + d];
      }
    }
    return -1;   // unreachable for a full code
  }
};

constexpr int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

bool ReadCodeLengths(LBits& br, const int* cl_lengths, int num_symbols,
                     int* lengths) {
  Huffman t;
  if (!t.build(cl_lengths, 19)) return false;
  int max_symbol = num_symbols;
  if (br.read(1)) {
    const int nbits = 2 + 2 * int(br.read(3));
    max_symbol = 2 + int(br.read(nbits));
    if (max_symbol > num_symbols) return false;
  }
  int prev = 8;
  int symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const int code_len = t.read(br);
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev = code_len;
    } else {
      static const int kExtra[3] = {2, 3, 7};
      static const int kOffset[3] = {3, 3, 11};
      const int slot = code_len - 16;
      const int repeat = int(br.read(kExtra[slot])) + kOffset[slot];
      if (symbol + repeat > num_symbols) return false;
      const int v = code_len == 16 ? prev : 0;
      for (int i = 0; i < repeat; ++i) lengths[symbol++] = v;
    }
  }
  return true;
}

bool ReadCode(LBits& br, int alphabet, Huffman* out) {
  std::vector<int> lengths(std::max(alphabet, 256), 0);
  if (br.read(1)) {            // simple code
    const int num = int(br.read(1)) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
  } else {
    int cl[19] = {0};
    const int num_codes = int(br.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i)
      cl[kCodeLengthOrder[i]] = int(br.read(3));
    if (!ReadCodeLengths(br, cl, alphabet, lengths.data())) return false;
  }
  if (br.eos()) return false;
  return out->build(lengths.data(), alphabet);
}

struct Group {
  Huffman codes[5];
};


inline int SubSample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

struct Transform {
  int type;
  int bits;
  int xsize;           // width of the image the transform produces
  std::vector<uint32_t> data;
};

inline int64_t PlaneCodeToDistance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int64_t d = int64_t(kDistanceMap[code - 1][1]) * xsize +
                    kDistanceMap[code - 1][0];
  return d >= 1 ? d : 1;
}

inline int PrefixValue(int symbol, LBits& br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

// libwebp's VP8LBitReader itself (bit_reader_utils.c), for the one loop
// whose result depends on it past the end of the data: a 64-bit window of
// the last bytes loaded, read at bit_pos & 63 (so past the end it wraps
// to the window's start), eos once bit_pos passes 64 with no byte left,
// which also rewinds bit_pos to 0. Bytes are shifted in one at a time
// (libwebp's 32-bit fast fill gives the same bits away from the end).
struct WBits {
  const uint8_t* buf;
  int64_t len, pos;
  uint64_t val = 0;
  int bit_pos = 0;
  bool eos = false;

  // The reader after `consumed` bits of the stream.
  WBits(const uint8_t* b, int64_t n, int64_t consumed) : buf(b), len(n) {
    pos = std::min<int64_t>(n, 8);
    for (int64_t i = 0; i < pos; ++i) val |= uint64_t(b[i]) << (8 * i);
    bit_pos = int(consumed);
    shift_bytes();
  }
  bool is_eos() const { return eos || (pos == len && bit_pos > 64); }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val = (val >> 8) | (uint64_t(buf[pos++]) << 56);
      bit_pos -= 8;
    }
    if (is_eos()) {
      eos = true;
      bit_pos = 0;
    }
  }
  void fill() {
    if (bit_pos >= 32) shift_bytes();
  }
  uint32_t prefetch() const { return uint32_t(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (eos) {
      bit_pos = 0;
      return 0;
    }
    const uint32_t v = prefetch() & ((1u << n) - 1);
    bit_pos += n;
    shift_bytes();
    return v;
  }
  // ReadSymbol: the first 8 bits from one prefetch, a longer code's
  // others from a second prefetch 8 bits on.
  int symbol(const Huffman& h) {
    if (h.single >= 0) return h.single;
    const uint32_t v1 = prefetch();
    int code = 0;
    for (int l = 1; l <= 8; ++l) {
      code = (code << 1) | int((v1 >> (l - 1)) & 1);
      const int d = code - h.first_code[l];
      if (d >= 0 && d < h.count[l]) {
        bit_pos += l;
        return h.sorted[h.first_index[l] + d];
      }
    }
    bit_pos += 8;
    const uint32_t v2 = prefetch();
    for (int l = 9; l <= 15; ++l) {
      code = (code << 1) | int((v2 >> (l - 9)) & 1);
      const int d = code - h.first_code[l];
      if (d >= 0 && d < h.count[l]) {
        bit_pos += l - 8;
        return h.sorted[h.first_index[l] + d];
      }
    }
    return -1;   // unreachable for a full code
  }
  int prefix_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + int(read(extra)) + 1;
  }
};

// libwebp's DecodeAlphaData: the green codes alone, a byte a pixel, the
// eos flag tested between symbols; reading past the data is an error
// only while pixels remain, and what the last symbols read there is
// what libwebp's window holds.
bool DecodeAlpha8b(const LBits& lb, const std::vector<Group>& groups,
                   const std::vector<uint32_t>& meta, int meta_bits,
                   int meta_xsize, int xsize, int64_t total,
                   std::vector<uint32_t>& out) {
  WBits br(lb.buf, lb.len, lb.consumed);
  const uint32_t mask = meta_bits ? (1u << meta_bits) - 1 : ~0u;
  auto group_at = [&](int c, int r) -> const Group& {
    if (!meta_bits) return groups[0];
    return groups[meta[int64_t(r >> meta_bits) * meta_xsize +
                       (c >> meta_bits)]];
  };
  int64_t pos = 0;
  int col = 0, row = 0;
  const Group* group = &groups[0];
  while (!br.eos && pos < total) {
    if ((uint32_t(col) & mask) == 0) group = &group_at(col, row);
    br.fill();
    const int code = br.symbol(group->codes[0]);
    if (code < 256) {
      out[pos++] = uint32_t(code) << 8;
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
    } else if (code < 256 + 24) {
      const int length = br.prefix_value(code - 256);
      const int dist_symbol = br.symbol(group->codes[4]);
      br.fill();
      const int64_t dist =
          PlaneCodeToDistance(xsize, br.prefix_value(dist_symbol));
      if (pos < dist || total - pos < length) return false;
      for (int i = 0; i < length; ++i) out[pos + i] = out[pos + i - dist];
      pos += length;
      col += length;
      while (col >= xsize) {
        col -= xsize;
        ++row;
      }
      if (pos < total && (uint32_t(col) & mask)) group = &group_at(col, row);
    } else {
      return false;
    }
    br.eos = br.is_eos();
  }
  return pos == total;
}

// One image stream of the VP8L format (RFC 9649 section 5): its
// transforms when level0, its colour cache, its prefix codes (with the
// meta image when level0), then the entropy-coded pixels, ARGB.
// `xsize` is updated to the coded width (after colour indexing).
bool DecodeImageStream(LBits& br, int& xsize, int ysize, bool level0,
                       std::vector<Transform>* transforms,
                       std::vector<uint32_t>& out, bool alpha = false);

bool ReadTransform(LBits& br, int& xsize, int ysize, unsigned& seen,
                   std::vector<Transform>& transforms) {
  const int type = int(br.read(2));
  if (seen & (1u << type)) return false;
  seen |= 1u << type;
  Transform t;
  t.type = type;
  t.bits = 0;
  t.xsize = xsize;
  if (type == 0 || type == 1) {
    t.bits = int(br.read(3)) + 2;
    int sx = SubSample(xsize, t.bits);
    if (!DecodeImageStream(br, sx, SubSample(ysize, t.bits), false, nullptr,
                           t.data))
      return false;
  } else if (type == 3) {
    const int num_colors = int(br.read(8)) + 1;
    t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2
                                                                       : 3;
    xsize = SubSample(xsize, t.bits);
    int nc = num_colors;
    std::vector<uint32_t> pal;
    if (!DecodeImageStream(br, nc, 1, false, nullptr, pal)) return false;
    const int final_colors = 1 << (8 >> t.bits);
    t.data.assign(final_colors, 0);
    t.data[0] = pal[0];
    for (int i = 1; i < num_colors; ++i)
      t.data[i] = AddPixels(pal[i], t.data[i - 1]);
  }
  transforms.push_back(std::move(t));
  return true;
}

bool DecodeImageStream(LBits& br, int& xsize, int ysize, bool level0,
                       std::vector<Transform>* transforms,
                       std::vector<uint32_t>& out, bool alpha) {
  if (level0) {
    unsigned seen = 0;
    while (br.read(1))
      if (!ReadTransform(br, xsize, ysize, seen, *transforms)) return false;
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = int(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  int meta_bits = 0, meta_xsize = 0;
  std::vector<uint32_t> meta;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = int(br.read(3)) + 2;
    meta_xsize = SubSample(xsize, meta_bits);
    int mx = meta_xsize;
    if (!DecodeImageStream(br, mx, SubSample(ysize, meta_bits), false,
                           nullptr, meta))
      return false;
    for (auto& m : meta) {
      m = (m >> 8) & 0xffff;
      num_groups = std::max<int>(num_groups, int(m) + 1);
    }
  }
  if (br.eos()) return false;
  std::vector<Group> groups(num_groups);
  for (auto& g : groups) {
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabet[j];
      if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
      if (!ReadCode(br, alphabet, &g.codes[j])) return false;
    }
  }
  // libwebp decodes an alpha plane whose only transform is colour
  // indexing, without colour cache and with single-symbol red, blue and
  // alpha codes, by DecodeAlphaData (DecodeAlpha8b).
  bool lenient = alpha && transforms->size() == 1 &&
                 (*transforms)[0].type == 3 && cache_bits == 0;
  for (const auto& g : groups)
    for (int j = 1; j <= 3; ++j) lenient &= g.codes[j].single >= 0;
  const int64_t total = int64_t(xsize) * ysize;
  out.assign(total, 0);
  std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0);
  const int cache_shift = 32 - cache_bits;
  int64_t last_cached = 0;
  const int len_limit = 256 + 24;
  int64_t pos = 0;
  int col = 0, row = 0;
  const uint32_t meta_mask = meta_bits ? (1u << meta_bits) - 1 : ~0u;
  const Group* group = &groups[0];
  auto group_at = [&](int c, int r) -> const Group* {
    if (!meta_bits) return &groups[0];
    return &groups[meta[int64_t(r >> meta_bits) * meta_xsize +
                        (c >> meta_bits)]];
  };
  if (lenient)
    return DecodeAlpha8b(br, groups, meta, meta_bits, meta_xsize, xsize,
                         total, out);
  while (pos < total) {
    if ((uint32_t(col) & meta_mask) == 0) group = group_at(col, row);
    const int code = group->codes[0].read(br);
    if (code < 256) {
      const int red = group->codes[1].read(br);
      const int blue = group->codes[2].read(br);
      const int alpha = group->codes[3].read(br);
      if (br.eos()) return false;
      out[pos] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) |
                 (uint32_t(code) << 8) | uint32_t(blue);
      ++pos;
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
    } else if (code < len_limit) {
      const int length = PrefixValue(code - 256, br);
      const int dist_symbol = group->codes[4].read(br);
      const int dist_code = PrefixValue(dist_symbol, br);
      const int64_t dist = PlaneCodeToDistance(xsize, dist_code);
      if (br.eos()) return false;
      if (pos < dist || total - pos < length) return false;
      for (int i = 0; i < length; ++i) out[pos + i] = out[pos + i - dist];
      pos += length;
      col += length;
      while (col >= xsize) {
        col -= xsize;
        ++row;
      }
      if (pos < total && (uint32_t(col) & meta_mask))
        group = group_at(col, row);
    } else {
      const int key = code - len_limit;
      if (key >= int(cache.size())) return false;
      while (last_cached < pos) {
        const uint32_t p = out[last_cached++];
        cache[(0x1e35a7bdu * p) >> cache_shift] = p;
      }
      out[pos] = cache[key];
      ++pos;
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
    }
    if (cache_bits) {
      while (last_cached < pos) {
        const uint32_t p = out[last_cached++];
        cache[(0x1e35a7bdu * p) >> cache_shift] = p;
      }
    }
  }
  return !br.eos();
}

// The inverse transforms, last read first; `xsize` is the coded width.
void InverseTransforms(const std::vector<Transform>& transforms, int height,
                       std::vector<uint32_t>& img) {
  for (int k = int(transforms.size()) - 1; k >= 0; --k) {
    const Transform& t = transforms[k];
    const int w = t.xsize;
    if (t.type == 0) {                    // predictor
      const int tw = SubSample(w, t.bits);
      for (int y = 0; y < height; ++y) {
        uint32_t* row = img.data() + int64_t(y) * w;
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : row[x - 1];
          } else if (x == 0) {
            pred = row[x - w];
          } else {
            const uint32_t* up = row - w;
            const int mode =
                (t.data[int64_t(y >> t.bits) * tw + (x >> t.bits)] >> 8) &
                0xf;
            pred = Predict(mode, row[x - 1], up[x], up[x + 1], up[x - 1]);
          }
          row[x] = AddPixels(row[x], pred);
        }
      }
    } else if (t.type == 1) {             // cross-colour
      const int tw = SubSample(w, t.bits);
      for (int y = 0; y < height; ++y) {
        uint32_t* row = img.data() + int64_t(y) * w;
        for (int x = 0; x < w; ++x) {
          const uint32_t m =
              t.data[int64_t(y >> t.bits) * tw + (x >> t.bits)];
          const int8_t g2r = int8_t(m & 0xff);
          const int8_t g2b = int8_t((m >> 8) & 0xff);
          const int8_t r2b = int8_t((m >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = int8_t(argb >> 8);
          int red = int((argb >> 16) & 0xff);
          int blue = int(argb & 0xff);
          red += (int(g2r) * green) >> 5;
          red &= 0xff;
          blue += (int(g2b) * green) >> 5;
          blue += (int(r2b) * int8_t(red)) >> 5;
          blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) |
                   uint32_t(blue);
        }
      }
    } else if (t.type == 2) {             // subtract green
      for (auto& p : img) {
        const uint32_t g = (p >> 8) & 0xff;
        const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) &
                            0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
    } else {                              // colour indexing
      const int coded = SubSample(w, t.bits);
      std::vector<uint32_t> dst(int64_t(w) * height);
      const int per_byte = 1 << t.bits;
      const int bpp = 8 >> t.bits;
      const uint32_t mask = (1u << bpp) - 1;
      for (int y = 0; y < height; ++y) {
        const uint32_t* src = img.data() + int64_t(y) * coded;
        uint32_t* d = dst.data() + int64_t(y) * w;
        if (t.bits == 0) {
          for (int x = 0; x < w; ++x) d[x] = t.data[(src[x] >> 8) & 0xff];
        } else {
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & (per_byte - 1)) == 0) packed = (*src++ >> 8) & 0xff;
            d[x] = t.data[packed & mask];
            packed >>= bpp;
          }
        }
      }
      img.swap(dst);
    }
  }
}

// A VP8L stream without its 5-byte header (ALPH) or with it: ARGB pixels.
int64_t DecodeVP8L(const uint8_t* data, int64_t size, int width, int height,
                   bool with_header, std::vector<uint32_t>& img) {
  LBits br(data, size);
  if (with_header) {
    if (br.read(8) != 0x2f) return -1;
    const int w = int(br.read(14)) + 1;
    const int h = int(br.read(14)) + 1;
    br.read(1);
    if (br.read(3) != 0) return -1;
    if (w != width || h != height) return -1;
    if (br.eos()) return -2;
  }
  std::vector<Transform> transforms;
  int xsize = width;
  if (!DecodeImageStream(br, xsize, height, true, &transforms, img,
                         !with_header))
    return br.eos() ? -2 : -3;
  InverseTransforms(transforms, height, img);
  return 0;
}

// ---------------------------------------------------------------------------
// VP8

#include "webp_vp8_tables.inc"

constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's mode numbers.
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  TM_PRED = B_TM_PRED
};

constexpr int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

// The boolean decoder as libwebp runs it (range kept as range - 1,
// bytes loaded one at a time; `eof` once a byte past the end was needed).
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 255 - 1;
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* b, int64_t n) {
    buf = b;
    end = b + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(get_bit(0x80)) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = int(get_value(n));
    return get_value(1) ? -v : v;
  }
  int get_signed(int v) { return get_bit(0x80) ? -v : v; }
};

struct FilterInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t is_i4x4 = 0, uvmode = 0, segment = 0, skip = 0;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

inline int ClipQ(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

int GetLargeValue(BoolDec& br, const uint8_t* p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get_bit(p[5]);
    }
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
        v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// libwebp's GetCoeffs: the coefficient tokens of one 4x4 block from
// position n on, dequantised into out (int16, zigzag undone); returns
// the position after the last token read.
int GetCoeffs(BoolDec& br, const uint8_t (*const bands[17])[11], int ctx,
              const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[n][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      p = bands[++n][0];
      if (n == 16) return 16;
    }
    const uint8_t (*const p_ctx)[11] = bands[n + 1];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = GetLargeValue(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t NzCodeBits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

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

constexpr int BPS = 32;          // libwebp's work-buffer stride

inline uint8_t Clip8b(int v) {
  return (v & ~255) == 0 ? uint8_t(v) : v < 0 ? 0 : 255;
}

inline int Mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int Mul2(int a) { return (a * 35468) >> 16; }

void TransformOne(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = Mul2(in[4]) - Mul1(in[12]);
    const int d = Mul1(in[4]) + Mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = Mul2(tmp[4]) - Mul1(tmp[12]);
    const int d = Mul1(tmp[4]) + Mul2(tmp[12]);
    dst[0] = Clip8b(dst[0] + ((a + d) >> 3));
    dst[1] = Clip8b(dst[1] + ((b + c) >> 3));
    dst[2] = Clip8b(dst[2] + ((b - c) >> 3));
    dst[3] = Clip8b(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

// libwebp's Transform_SSE2, which PIL's libwebp runs for blocks with a
// coefficient past the third (and for chroma with any AC coefficient):
// the same butterflies in 16-bit lanes, each sum wrapping, the products
// as _mm_mulhi_epi16 with k - 65536 plus the input, the result added
// with a 16-bit wrap and saturated to 8 bits. Equal to TransformOne
// while nothing wraps; streams with huge coefficients differ.
inline int16_t W16(int v) { return int16_t(uint16_t(v)); }
inline int16_t MulHi16(int16_t a, int k) {
  return int16_t((int32_t(a) * k) >> 16);
}

void TransformSIMD(const int16_t* in, uint8_t* dst) {
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
      const int16_t s = W16(dst[x + i * BPS] + v[x]);
      dst[x + i * BPS] = uint8_t(s < 0 ? 0 : s > 255 ? 255 : s);
    }
  }
}

inline uint8_t Avg3(int a, int b, int c) {
  return uint8_t((a + 2 * b + c + 2) >> 2);
}
inline uint8_t Avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

#define DST(x, y) dst[(x) + (y) * BPS]

void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1 + y * BPS];
    for (int x = 0; x < size; ++x) DST(x, y) = Clip8b(top[x] + l - tl);
  }
}

void Predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = uint8_t(dc);
      break;
    }
    case B_TM_PRED:
      TrueMotion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t v[4] = {Avg3(X, A, B), Avg3(A, B, C), Avg3(B, C, D),
                            Avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[x];
      break;
    }
    case B_HE_PRED: {
      const uint8_t v[4] = {Avg3(X, I, J), Avg3(I, J, K), Avg3(J, K, L),
                            Avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[y];
      break;
    }
    case B_RD_PRED:
      DST(0, 3) = Avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = Avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = Avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = Avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = Avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = Avg3(C, B, A);
      DST(3, 0) = Avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = Avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = Avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = Avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = Avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = Avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = Avg3(F, G, H);
      DST(3, 3) = Avg3(G, H, H);
      break;
    case B_VR_PRED:
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
      break;
    case B_VL_PRED:
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
      break;
    case B_HD_PRED:
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
      break;
    case B_HU_PRED:
      DST(0, 0) = Avg2(I, J);
      DST(2, 0) = DST(0, 1) = Avg2(J, K);
      DST(2, 1) = DST(0, 2) = Avg2(K, L);
      DST(1, 0) = Avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = Avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = Avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = uint8_t(L);
      break;
  }
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) prediction; DC by
// libwebp's CheckMode: without the top row and/or left column at the
// frame's edges.
void PredictBlock(int mode, uint8_t* dst, int size, int mb_x, int mb_y) {
  const int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case DC_PRED: {
      int dc;
      if (mb_x > 0 && mb_y > 0) {
        dc = size;
        for (int i = 0; i < size; ++i)
          dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc >>= shift;
      } else if (mb_y > 0) {          // no left
        dc = size >> 1;
        for (int i = 0; i < size; ++i) dc += dst[i - BPS];
        dc >>= shift - 1;
      } else if (mb_x > 0) {          // no top
        dc = size >> 1;
        for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
        dc >>= shift - 1;
      } else {
        dc = 0x80;
      }
      for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x) DST(x, y) = uint8_t(dc);
      break;
    }
    case TM_PRED:
      TrueMotion(dst, size);
      break;
    case V_PRED:
      for (int y = 0; y < size; ++y)
        std::memcpy(dst + y * BPS, dst - BPS, size_t(size));
      break;
    case H_PRED:
      for (int y = 0; y < size; ++y)
        std::memset(dst + y * BPS, dst[-1 + y * BPS], size_t(size));
      break;
  }
}

#undef DST

// ----- loop filter (libwebp dsp/dec.c, plain C versions) -----

inline int SClip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int SClip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline uint8_t UClip(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline void DoFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + SClip1(p1 - q1);
  const int a1 = SClip2((a + 4) >> 3);
  const int a2 = SClip2((a + 3) >> 3);
  p[-step] = UClip(p0 + a2);
  p[0] = UClip(q0 - a1);
}

inline void DoFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = SClip2((a + 4) >> 3);
  const int a2 = SClip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = UClip(p1 + a3);
  p[-step] = UClip(p0 + a2);
  p[0] = UClip(q0 - a1);
  p[step] = UClip(q1 - a3);
}

inline void DoFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = SClip1(3 * (q0 - p0) + SClip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = UClip(p2 + a3);
  p[-2 * step] = UClip(p1 + a2);
  p[-step] = UClip(p0 + a1);
  p[0] = UClip(q0 - a1);
  p[step] = UClip(q1 - a2);
  p[2 * step] = UClip(q2 - a3);
}

inline bool Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void SimpleFilter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (NeedsFilter(p + i * vstride, hstride, t2))
      DoFilter2(p + i * vstride, hstride);
}

void FilterLoop26(uint8_t* p, int hstride, int vstride, int size,
                  int thresh, int ithresh, int hev_thresh) {
  const int t2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, t2, ithresh)) {
      if (Hev(p, hstride, hev_thresh)) {
        DoFilter2(p, hstride);
      } else {
        DoFilter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void FilterLoop24(uint8_t* p, int hstride, int vstride, int size,
                  int thresh, int ithresh, int hev_thresh) {
  const int t2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, t2, ithresh)) {
      if (Hev(p, hstride, hev_thresh)) {
        DoFilter2(p, hstride);
      } else {
        DoFilter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct VP8Frame {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int filter_type = 0;          // 0 none, 1 simple, 2 normal
  bool use_skip = false;
  int skip_p = 0;
  uint8_t segments_p[3] = {255, 255, 255};
  bool update_map = false;
  Quant dqm[4];
  FilterInfo fstrengths[4][2];
  uint8_t proba[4][8][3][11];
  int num_parts = 1;
  BoolDec br;
  BoolDec parts[8];
  std::vector<uint8_t> Y, U, V;  // unfiltered, then filtered planes
  int ystride = 0, uvstride = 0;
};

// libwebp's VP8GetHeaders (key frames), ParseSegmentHeader,
// ParseFilterHeader, ParsePartitions, VP8ParseQuant, VP8ParseProba and
// PrecomputeFilterStrengths.
int64_t ParseHeaders(VP8Frame& f, const uint8_t* data, int64_t size) {
  if (size < 10) return -2;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  if (bits & 1) return -4;                       // not a key frame
  if (((bits >> 1) & 7) > 3) return -3;
  if (!((bits >> 4) & 1)) return -4;             // not displayable
  const uint32_t part_len = bits >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return -3;
  f.width = ((data[7] << 8) | data[6]) & 0x3fff;
  f.height = ((data[9] << 8) | data[8]) & 0x3fff;
  f.mb_w = (f.width + 15) >> 4;
  f.mb_h = (f.height + 15) >> 4;
  const uint8_t* buf = data + 10;
  int64_t buf_size = size - 10;
  if (part_len > buf_size) return -2;
  BoolDec& br = f.br;
  br.init(buf, part_len);
  buf += part_len;
  buf_size -= part_len;
  br.get_value(1);                               // colour space
  br.get_value(1);                               // clamping type
  // segment header
  bool use_segment = br.get_value(1);
  bool absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  if (use_segment) {
    f.update_map = br.get_value(1);
    if (br.get_value(1)) {
      absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; ++s)
        quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
    }
    if (f.update_map)
      for (int s = 0; s < 3; ++s)
        f.segments_p[s] = br.get_value(1) ? uint8_t(br.get_value(8)) : 255;
  } else {
    f.update_map = false;
  }
  if (br.eof) return -2;
  // filter header
  const bool simple = br.get_value(1);
  const int level = int(br.get_value(6));
  const int sharpness = int(br.get_value(3));
  const bool use_lf_delta = br.get_value(1);
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  if (use_lf_delta && br.get_value(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
  }
  f.filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) return -2;
  // partitions
  f.num_parts = 1 << br.get_value(2);
  const int last = f.num_parts - 1;
  if (buf_size < 3 * last) return -2;
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last * 3;
  int64_t left = buf_size - last * 3;
  for (int p = 0; p < last; ++p) {
    int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    f.parts[p].init(part_start, psize);
    part_start += psize;
    left -= psize;
    sz += 3;
  }
  f.parts[last].init(part_start, left);
  if (!(part_start < buf + buf_size)) return -2;
  // quantisers
  const int base_q0 = int(br.get_value(7));
  const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        f.dqm[i] = f.dqm[0];
        continue;
      }
      q = base_q0;
    }
    Quant& m = f.dqm[i];
    m.y1[0] = kDcTable[ClipQ(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[ClipQ(q, 127)];
    m.y2[0] = kDcTable[ClipQ(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[ClipQ(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[ClipQ(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[ClipQ(q + dquv_ac, 127)];
  }
  br.get_value(1);                               // update_proba, ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          f.proba[t][b][c][p] = br.get_bit(kCoeffsUpdateProba[t][b][c][p])
                                    ? uint8_t(br.get_value(8))
                                    : kCoeffsProba0[t][b][c][p];
  f.use_skip = br.get_value(1);
  if (f.use_skip) f.skip_p = int(br.get_value(8));
  // filter strengths
  if (f.filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = f.fstrengths[s][i4x4];
        int lv = base_level;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4x4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int ilevel = lv;
          if (sharpness > 0) {
            if (sharpness > 4) {
              ilevel >>= 2;
            } else {
              ilevel >>= 1;
            }
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = uint8_t(ilevel);
          info.limit = uint8_t(2 * lv + ilevel);
          info.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = uint8_t(i4x4);
      }
    }
  }
  return 0;
}

void ParseIntraMode(BoolDec& br, VP8Frame& f, uint8_t* top, uint8_t* left,
                    MBData& block) {
  if (f.update_map) {
    block.segment = !br.get_bit(f.segments_p[0])
                        ? br.get_bit(f.segments_p[1])
                        : br.get_bit(f.segments_p[2]) + 2;
  } else {
    block.segment = 0;
  }
  block.skip = f.use_skip ? br.get_bit(f.skip_p) : 0;
  block.is_i4x4 = !br.get_bit(145);
  if (!block.is_i4x4) {
    const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                      : (br.get_bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = uint8_t(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.get_bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.get_bit(prob[i])];
        ymode = -i;
        top[x] = uint8_t(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = uint8_t(ymode);
    }
  }
  block.uvmode = !br.get_bit(142)   ? DC_PRED
                 : !br.get_bit(114) ? V_PRED
                 : br.get_bit(183)  ? TM_PRED
                                    : H_PRED;
}

struct NzCtx {
  uint8_t nz = 0, nz_dc = 0;
};

// libwebp's ParseResiduals; returns true when the macroblock has no
// non-zero coefficient.
bool ParseResiduals(VP8Frame& f, NzCtx& mb, NzCtx& left, BoolDec& br,
                    MBData& block) {
  const uint8_t (*bands[4][17])[11];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 17; ++b) bands[t][b] = f.proba[t][kBands[b]];
  const Quant& q = f.dqm[block.segment];
  int16_t* dst = block.coeffs;
  std::memset(dst, 0, sizeof(block.coeffs));
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  const uint8_t (*const* ac_proba)[11];
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left.nz_dc;
    const int nz = GetCoeffs(br, bands[1], ctx, q.y2, 0, dc);
    mb.nz_dc = left.nz_dc = (nz > 0);
    if (nz > 1) {
      TransformWHT(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
    }
    first = 1;
    ac_proba = bands[0];
  } else {
    first = 0;
    ac_proba = bands[3];
  }
  uint32_t tnz = mb.nz & 0x0f;
  uint32_t lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = GetCoeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (tnz >> 1) | (uint32_t(l) << 7);
      nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (uint32_t(l) << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = mb.nz >> (4 + ch);
    lnz = left.nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = GetCoeffs(br, bands[2], ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (tnz >> 1) | (uint32_t(l) << 3);
        nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (uint32_t(l) << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  mb.nz = uint8_t(out_t_nz);
  left.nz = uint8_t(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// libwebp's DoTransform / DoUVTransform dispatch: more than three
// coefficients (or any chroma AC) through the SIMD transform, else the
// plain C one (TransformAC3_C and TransformDC_C are its special cases).
inline void DoTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: TransformSIMD(src, dst); break;
    case 2: case 1: TransformOne(src, dst); break;
    default: break;
  }
}

inline void DoUVTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (bits & 0xaa) {
      TransformSIMD(src + 16 * n, d);
    } else {
      TransformOne(src + 16 * n, d);
    }
  }
}

// Reconstruct one macroblock into the (unfiltered) planes, from a work
// buffer laid out as libwebp's yuv_b_ (borders: 127 above the first
// row, 129 left of the first column, the top-right samples replicated
// down the right column of 4x4 blocks).
void Reconstruct(VP8Frame& f, int mb_x, int mb_y, const MBData& block) {
  uint8_t ybuf[17 * BPS], ubuf[9 * BPS], vbuf[9 * BPS];
  uint8_t* y_dst = ybuf + BPS + 8;
  uint8_t* u_dst = ubuf + BPS + 8;
  uint8_t* v_dst = vbuf + BPS + 8;
  const int ys = f.ystride, uvs = f.uvstride;
  uint8_t* Yp = f.Y.data() + int64_t(mb_y) * 16 * ys + mb_x * 16;
  uint8_t* Up = f.U.data() + int64_t(mb_y) * 8 * uvs + mb_x * 8;
  uint8_t* Vp = f.V.data() + int64_t(mb_y) * 8 * uvs + mb_x * 8;
  // top row, top-left and top-right
  if (mb_y == 0) {
    std::memset(y_dst - BPS - 1, 127, 21);
    std::memset(u_dst - BPS - 1, 127, 9);
    std::memset(v_dst - BPS - 1, 127, 9);
  } else {
    std::memcpy(y_dst - BPS, Yp - ys, 16);
    std::memcpy(u_dst - BPS, Up - uvs, 8);
    std::memcpy(v_dst - BPS, Vp - uvs, 8);
    if (mb_x == 0) {
      y_dst[-BPS - 1] = u_dst[-BPS - 1] = v_dst[-BPS - 1] = 129;
    } else {
      y_dst[-BPS - 1] = Yp[-ys - 1];
      u_dst[-BPS - 1] = Up[-uvs - 1];
      v_dst[-BPS - 1] = Vp[-uvs - 1];
    }
    if (mb_x >= f.mb_w - 1) {
      std::memset(y_dst - BPS + 16, Yp[-ys + 15], 4);
    } else {
      std::memcpy(y_dst - BPS + 16, Yp - ys + 16, 4);
    }
  }
  // left column
  for (int j = 0; j < 16; ++j)
    y_dst[j * BPS - 1] = mb_x > 0 ? Yp[j * ys - 1] : 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = mb_x > 0 ? Up[j * uvs - 1] : 129;
    v_dst[j * BPS - 1] = mb_x > 0 ? Vp[j * uvs - 1] : 129;
  }
  const int16_t* coeffs = block.coeffs;
  uint32_t bits = block.non_zero_y;
  if (block.is_i4x4) {
    for (int r = 1; r < 4; ++r)
      std::memcpy(y_dst - BPS + 16 + 4 * r * BPS, y_dst - BPS + 16, 4);
    for (int n = 0; n < 16; ++n, bits <<= 2) {
      uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
      Predict4(block.imodes[n], dst);
      DoTransform(bits, coeffs + n * 16, dst);
    }
  } else {
    PredictBlock(block.imodes[0], y_dst, 16, mb_x, mb_y);
    if (bits != 0)
      for (int n = 0; n < 16; ++n, bits <<= 2)
        DoTransform(bits, coeffs + n * 16,
                    y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
  }
  PredictBlock(block.uvmode, u_dst, 8, mb_x, mb_y);
  PredictBlock(block.uvmode, v_dst, 8, mb_x, mb_y);
  DoUVTransform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
  DoUVTransform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
  for (int j = 0; j < 16; ++j) std::memcpy(Yp + j * ys, y_dst + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    std::memcpy(Up + j * uvs, u_dst + j * BPS, 8);
    std::memcpy(Vp + j * uvs, v_dst + j * BPS, 8);
  }
}

void FilterMB(VP8Frame& f, int mb_x, int mb_y, const FilterInfo& fi) {
  const int limit = fi.limit;
  if (limit == 0) return;
  const int ys = f.ystride, uvs = f.uvstride;
  uint8_t* y = f.Y.data() + int64_t(mb_y) * 16 * ys + mb_x * 16;
  if (f.filter_type == 1) {
    if (mb_x > 0) SimpleFilter(y, 1, ys, limit + 4);
    if (fi.inner)
      for (int k = 1; k <= 3; ++k) SimpleFilter(y + 4 * k, 1, ys, limit);
    if (mb_y > 0) SimpleFilter(y, ys, 1, limit + 4);
    if (fi.inner)
      for (int k = 1; k <= 3; ++k)
        SimpleFilter(y + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t* u = f.U.data() + int64_t(mb_y) * 8 * uvs + mb_x * 8;
  uint8_t* v = f.V.data() + int64_t(mb_y) * 8 * uvs + mb_x * 8;
  const int il = fi.ilevel, hev = fi.hev_thresh;
  if (mb_x > 0) {
    FilterLoop26(y, 1, ys, 16, limit + 4, il, hev);
    FilterLoop26(u, 1, uvs, 8, limit + 4, il, hev);
    FilterLoop26(v, 1, uvs, 8, limit + 4, il, hev);
  }
  if (fi.inner) {
    for (int k = 1; k <= 3; ++k)
      FilterLoop24(y + 4 * k, 1, ys, 16, limit, il, hev);
    FilterLoop24(u + 4, 1, uvs, 8, limit, il, hev);
    FilterLoop24(v + 4, 1, uvs, 8, limit, il, hev);
  }
  if (mb_y > 0) {
    FilterLoop26(y, ys, 1, 16, limit + 4, il, hev);
    FilterLoop26(u, uvs, 1, 8, limit + 4, il, hev);
    FilterLoop26(v, uvs, 1, 8, limit + 4, il, hev);
  }
  if (fi.inner) {
    for (int k = 1; k <= 3; ++k)
      FilterLoop24(y + 4 * k * ys, ys, 1, 16, limit, il, hev);
    FilterLoop24(u + 4 * uvs, uvs, 1, 8, limit, il, hev);
    FilterLoop24(v + 4 * uvs, uvs, 1, 8, limit, il, hev);
  }
}

inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t YuvClip8(int v) {
  return (v & ~16383) == 0 ? uint8_t(v >> 6) : v < 0 ? 0 : 255;
}

// libwebp's VP8YUVToR/G/B after the fancy upsampler; RGB into an RGBA
// buffer (the alpha byte untouched).
void EmitRGB(const VP8Frame& f, uint8_t* out) {
  const int w = f.width, h = f.height;
  const int uv_w = (w + 1) >> 1, uv_h = (h + 1) >> 1;
  std::vector<uint8_t> urow(w), vrow(w);
  for (int y = 0; y < h; ++y) {
    const int ny = y >> 1;
    int fy = (y & 1) ? ny + 1 : ny - 1;
    fy = std::min(std::max(fy, 0), uv_h - 1);
    const uint8_t* un = f.U.data() + int64_t(ny) * f.uvstride;
    const uint8_t* uf = f.U.data() + int64_t(fy) * f.uvstride;
    const uint8_t* vn = f.V.data() + int64_t(ny) * f.uvstride;
    const uint8_t* vf = f.V.data() + int64_t(fy) * f.uvstride;
    const uint8_t* yr = f.Y.data() + int64_t(y) * f.ystride;
    uint8_t* o = out + int64_t(y) * w * 4;
    for (int x = 0; x < w; ++x) {
      const int nx = x >> 1;
      int fx = (x & 1) ? nx + 1 : nx - 1;
      fx = std::min(std::max(fx, 0), uv_w - 1);
      const int u = (9 * un[nx] + 3 * un[fx] + 3 * uf[nx] + uf[fx] + 8) >> 4;
      const int v = (9 * vn[nx] + 3 * vn[fx] + 3 * vf[nx] + vf[fx] + 8) >> 4;
      const int yy = MultHi(yr[x], 19077);
      o[4 * x + 0] = YuvClip8(yy + MultHi(v, 26149) - 14234);
      o[4 * x + 1] = YuvClip8(yy - MultHi(u, 6419) - MultHi(v, 13320) + 8708);
      o[4 * x + 2] = YuvClip8(yy + MultHi(u, 33050) - 17685);
    }
  }
}

int64_t DecodeVP8(const uint8_t* data, int64_t size, int width, int height,
                  uint8_t* out) {
  VP8Frame f;
  int64_t st = ParseHeaders(f, data, size);
  if (st) return st;
  if (f.width != width || f.height != height) return -1;
  f.ystride = f.mb_w * 16;
  f.uvstride = f.mb_w * 8;
  f.Y.assign(int64_t(f.ystride) * f.mb_h * 16, 0);
  f.U.assign(int64_t(f.uvstride) * f.mb_h * 8, 0);
  f.V.assign(int64_t(f.uvstride) * f.mb_h * 8, 0);
  std::vector<uint8_t> intra_t(4 * f.mb_w, B_DC_PRED);
  std::vector<NzCtx> top_nz(f.mb_w);
  std::vector<MBData> row(f.mb_w);
  std::vector<FilterInfo> finfo(int64_t(f.mb_w) * f.mb_h);
  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x)
      ParseIntraMode(f.br, f, &intra_t[4 * mb_x], intra_l, row[mb_x]);
    if (f.br.eof) return -2;
    BoolDec& tbr = f.parts[mb_y & (f.num_parts - 1)];
    NzCtx left;
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      MBData& block = row[mb_x];
      NzCtx& mb = top_nz[mb_x];
      bool skip = f.use_skip ? block.skip : false;
      if (!skip) {
        skip = ParseResiduals(f, mb, left, tbr, block);
      } else {
        left.nz = mb.nz = 0;
        if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
      }
      if (f.filter_type > 0) {
        FilterInfo fi = f.fstrengths[block.segment][block.is_i4x4];
        fi.inner |= !skip;
        finfo[int64_t(mb_y) * f.mb_w + mb_x] = fi;
      }
      if (tbr.eof) return -2;
      Reconstruct(f, mb_x, mb_y, block);
    }
  }
  if (f.filter_type > 0)
    for (int mb_y = 0; mb_y < f.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < f.mb_w; ++mb_x)
        FilterMB(f, mb_x, mb_y, finfo[int64_t(mb_y) * f.mb_w + mb_x]);
  EmitRGB(f, out);
  return 0;
}

// libwebp's unfilters (filters.c), one row given the row above (none for
// the first row).
void Unfilter(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 0) return;
  if (filter == 1 || prev == nullptr) {
    uint8_t pred = (filter == 1 && prev != nullptr) ? prev[0] : 0;
    for (int i = 0; i < width; ++i) {
      row[i] = uint8_t(pred + row[i]);
      pred = row[i];
    }
  } else if (filter == 2) {
    for (int i = 0; i < width; ++i) row[i] = uint8_t(prev[i] + row[i]);
  } else {
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
      left = uint8_t(row[i] + pred);
      top_left = top;
      row[i] = left;
    }
  }
}

}  // namespace

// A VP8L chunk's payload (with its 5-byte header): RGBA pixels.
// -1: bad header, -2: data ends early, -3: a bitstream error.
extern "C" int64_t tb_webp_vp8l_decode(const uint8_t* data, int64_t size,
                                       int64_t width, int64_t height,
                                       uint8_t* out) {
  std::vector<uint32_t> img;
  const int64_t st = DecodeVP8L(data, size, int(width), int(height), true,
                                img);
  if (st) return st;
  for (int64_t i = 0; i < width * height; ++i) {
    const uint32_t p = img[i];
    out[4 * i + 0] = uint8_t(p >> 16);
    out[4 * i + 1] = uint8_t(p >> 8);
    out[4 * i + 2] = uint8_t(p);
    out[4 * i + 3] = uint8_t(p >> 24);
  }
  return 0;
}

// A VP8 chunk's payload (a key frame): RGB into the first three bytes of
// each RGBA pixel. -1: size mismatch, -2: data ends early, -3: bad
// header, -4: not a displayable key frame.
extern "C" int64_t tb_webp_vp8_decode(const uint8_t* data, int64_t size,
                                      int64_t width, int64_t height,
                                      uint8_t* out) {
  return DecodeVP8(data, size, int(width), int(height), out);
}

// An ALPH chunk's payload: the alpha plane (width * height bytes).
// -1: bad header or short raw data, -2/-3: the lossless stream's errors.
extern "C" int64_t tb_webp_alpha_decode(const uint8_t* data, int64_t size,
                                        int64_t width, int64_t height,
                                        uint8_t* out) {
  if (size <= 1) return -1;
  const int method = data[0] & 3;
  const int filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6) != 0) return -1;
  const int64_t n = width * height;
  if (method == 0) {
    if (size - 1 < n) return -1;
    std::memcpy(out, data + 1, size_t(n));
  } else {
    std::vector<uint32_t> img;
    const int64_t st = DecodeVP8L(data + 1, size - 1, int(width),
                                  int(height), false, img);
    if (st) return st;
    for (int64_t i = 0; i < n; ++i) out[i] = uint8_t(img[i] >> 8);
  }
  for (int64_t y = 0; y < height; ++y)
    Unfilter(filter, y ? out + (y - 1) * width : nullptr, out + y * width,
             int(width));
  return 0;
}

// Pillow's QOI decoder: npix pixels of `channels` (3 or 4) bytes from
// the stream after the 14-byte header. Returns -1 when the stream ends
// before the last pixel (Pillow's IndexError), else 0.
extern "C" int64_t tb_qoi_decode(const uint8_t* data, int64_t size,
                                 int64_t npix, int64_t channels,
                                 uint8_t* out) {
  uint8_t index[64][4];
  bool seen[64] = {false};
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t ip = 0, op = 0;
  const int64_t need = npix * channels;
  auto put = [&](const uint8_t* px) {
    for (int c = 0; c < channels && op < need; ++c) out[op++] = px[c];
  };
  auto remember = [&](const uint8_t* px) {
    std::memcpy(prev, px, 4);
    const int h = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64;
    std::memcpy(index[h], px, 4);
    seen[h] = true;
  };
  while (op < need) {
    if (ip >= size) return -1;
    const uint8_t byte = data[ip++];
    uint8_t px[4];
    if (byte == 0xfe) {
      if (size - ip < 3) return -1;
      px[0] = data[ip];
      px[1] = data[ip + 1];
      px[2] = data[ip + 2];
      px[3] = prev[3];
      ip += 3;
    } else if (byte == 0xff) {
      if (size - ip < 4) return -1;
      std::memcpy(px, data + ip, 4);
      ip += 4;
    } else {
      const int op2 = byte >> 6;
      if (op2 == 0) {
        const int i = byte & 0x3f;
        if (seen[i]) {
          std::memcpy(px, index[i], 4);
        } else {
          px[0] = px[1] = px[2] = px[3] = 0;
        }
      } else if (op2 == 1) {
        px[0] = uint8_t(prev[0] + ((byte >> 4) & 3) - 2);
        px[1] = uint8_t(prev[1] + ((byte >> 2) & 3) - 2);
        px[2] = uint8_t(prev[2] + (byte & 3) - 2);
        px[3] = prev[3];
      } else if (op2 == 2) {
        if (ip >= size) return -1;
        const uint8_t second = data[ip++];
        const int dg = (byte & 0x3f) - 32;
        const int dr = ((second >> 4) & 0xf) - 8;
        const int db = (second & 0xf) - 8;
        px[0] = uint8_t(prev[0] + dg + dr);
        px[1] = uint8_t(prev[1] + dg);
        px[2] = uint8_t(prev[2] + dg + db);
        px[3] = prev[3];
      } else {
        const int run = (byte & 0x3f) + 1;
        for (int r = 0; r < run; ++r) put(prev);
        continue;
      }
    }
    remember(px);
    put(px);
  }
  return 0;
}

// The QOI specification's encoder (Pillow's QoiEncoder writes the same
// ops): `npix` pixels of `channels` bytes into out (at least 14 + npix *
// (channels + 1) + 8 bytes) after the header; returns the bytes written.
extern "C" int64_t tb_qoi_encode(const uint8_t* px, int64_t npix,
                                 int64_t channels, int64_t width,
                                 int64_t height, uint8_t* out) {
  int64_t o = 0;
  const uint8_t head[4] = {'q', 'o', 'i', 'f'};
  std::memcpy(out, head, 4);
  for (int i = 0; i < 4; ++i) out[4 + i] = uint8_t(width >> (24 - 8 * i));
  for (int i = 0; i < 4; ++i) out[8 + i] = uint8_t(height >> (24 - 8 * i));
  out[12] = uint8_t(channels);
  out[13] = 1;            // "all channels linear", as Pillow writes
  o = 14;
  uint8_t index[64][4] = {{0}};
  uint8_t prev[4] = {0, 0, 0, 255};
  int run = 0;
  for (int64_t i = 0; i < npix; ++i) {
    uint8_t p[4] = {px[i * channels], px[i * channels + 1],
                    px[i * channels + 2],
                    uint8_t(channels == 4 ? px[i * channels + 3] : 255)};
    if (std::memcmp(p, prev, 4) == 0) {
      if (++run == 62) {
        out[o++] = uint8_t(0xc0 | (run - 1));
        run = 0;
      }
      continue;
    }
    if (run) {
      out[o++] = uint8_t(0xc0 | (run - 1));
      run = 0;
    }
    const int h = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64;
    if (std::memcmp(index[h], p, 4) == 0) {
      out[o++] = uint8_t(h);
    } else {
      std::memcpy(index[h], p, 4);
      if (p[3] == prev[3]) {
        const int dr = int8_t(p[0] - prev[0]);
        const int dg = int8_t(p[1] - prev[1]);
        const int db = int8_t(p[2] - prev[2]);
        const int dgr = dr - dg, dgb = db - dg;
        if (dr >= -2 && dr < 2 && dg >= -2 && dg < 2 && db >= -2 && db < 2) {
          out[o++] = uint8_t(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2));
        } else if (dgr >= -8 && dgr < 8 && dg >= -32 && dg < 32 &&
                   dgb >= -8 && dgb < 8) {
          out[o++] = uint8_t(0x80 | (dg + 32));
          out[o++] = uint8_t((dgr + 8) << 4 | (dgb + 8));
        } else {
          out[o++] = 0xfe;
          out[o++] = p[0];
          out[o++] = p[1];
          out[o++] = p[2];
        }
      } else {
        out[o++] = 0xff;
        std::memcpy(out + o, p, 4);
        o += 4;
      }
    }
    std::memcpy(prev, p, 4);
  }
  if (run) out[o++] = uint8_t(0xc0 | (run - 1));
  for (int i = 0; i < 7; ++i) out[o++] = 0;
  out[o++] = 1;
  return o;
}
