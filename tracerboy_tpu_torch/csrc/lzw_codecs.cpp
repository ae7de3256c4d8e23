// The byte-serial loops of the port's TIFF, GIF and PSD readers
// (core/tiff.py, core/gif.py, core/psd.py, loaded by core/codecs.py):
// TIFF LZW (decode and encode; the encoder writes the demo scenes' TIFFs
// and the tests' LZW fixtures), PackBits (libtiff's and Pillow's), the
// TIFF predictors' undifferencing, and GIF LZW into a frame's rows.
// Host code, compiled with g++ at first use into the port's build
// directory (utils/build.py) and called through ctypes; numpy does the
// rest (containers, byte order, unpacking).
//
// The readers must give the pixels PIL gives. PIL reads compressed TIFFs
// through libtiff and GIFs through its own decoder, so each routine here
// follows that decoder's rules, down to what it does with a broken
// stream:
// - tb_tiff_lzw_decode: libtiff's LZWDecode (tif_lzw.c, new-style codes):
//   9-12 bit codes MSB first; the width grows once the next free entry
//   passes 2^n - 2 (one code early); a clear code resets the table and a
//   second clear writes the byte 0; a code past the table's last entry
//   is an error; a string longer than the room left is cut; a stream
//   that ends (end code, or no bits left) before `need` bytes is an
//   error, as libtiff's "Not enough data" is.
// - tb_tiff_lzw_decode_compat: libtiff's LZWDecodeCompat, for streams
//   whose first byte is 0 and whose second has its low bit set (old-style
//   codes, as 4.x detects them): codes LSB first, the width grown once
//   the next free entry passes 2^n - 1 (no early change), no sentinel at
//   a full table (an entry past libtiff's CSIZE is an error); otherwise
//   as tb_tiff_lzw_decode.
// - tb_packbits_decode: libtiff's PackBitsDecode (tif_packbits.c): -128
//   is a no-op, runs and literals are cut to the room left, a literal
//   short of input ends the strip; short output is an error.
// - tb_tiff_unpredict: libtiff's horAcc8/16/32 (Predictor 2, samples
//   already in native order) and fpAcc (Predictor 3: bytes accumulated,
//   then the byte planes, most significant first, woven into native
//   little-endian samples).
// - tb_gif_decode: Pillow's GifDecode.c: LSB-first codes from bits + 1
//   up to 12, the width grown when the entry added is 2^n - 1, no entry
//   past 4095, interlaced rows in four passes; only the frame's last
//   row ends the data without error.
// - tb_pil_packbits_rows: Pillow's PackBitsDecode.c (PSD channels): the
//   packets decoded row by row, a packet that overflows a row cut at the
//   row's end, 0x80 a no-op; data that ends before the last row is an
//   error (PIL's "image file is truncated").

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kLzwClear = 256;
constexpr int kLzwEoi = 257;
constexpr int kLzwFirst = 258;
constexpr int kLzwCsize = 4095 + 1024;   // libtiff's CSIZE

struct LzwEntry {
  int32_t next;       // prefix entry, -1 for a literal
  int32_t length;     // 0: unused
  uint8_t value;
  uint8_t firstchar;
};

}  // namespace

// Returns the bytes written to dst (== need on success); -1: corrupt
// table or code; -2: a string of zero length (a code past the table).
extern "C" int64_t tb_tiff_lzw_decode(const uint8_t* src, int64_t n,
                                      uint8_t* dst, int64_t need) {
  std::vector<LzwEntry> tab(kLzwCsize);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  for (int i = 256; i < kLzwCsize; ++i) tab[i] = {-1, 0, 0, 0};
  int64_t free_ent = kLzwFirst;
  int nbits = 9;
  int64_t maxcode = (1 << nbits) - 2;   // the last entry before growing
  int64_t oldcode = -1;                 // none yet
  int64_t ip = 0;                       // next byte to load
  uint64_t acc = 0;                     // bits not yet taken, at the bottom
  int nacc = 0;
  int64_t op = 0;
  auto get = [&](int width) -> int {
    while (nacc < width && ip < n) {
      acc = (acc << 8) | src[ip++];
      nacc += 8;
    }
    if (nacc < width) return kLzwEoi;   // not terminated
    nacc -= width;
    return int((acc >> nacc) & ((1u << width) - 1));
  };
  while (op < need) {
    int code = get(nbits);
    if (code == kLzwEoi) break;
    if (code == kLzwClear) {
      for (int i = kLzwFirst; i < kLzwCsize; ++i) tab[i] = {-1, 0, 0, 0};
      free_ent = kLzwFirst;
      nbits = 9;
      maxcode = (1 << nbits) - 2;
      code = get(nbits);
      if (code == kLzwEoi) break;
      if (code > kLzwClear) return -1;
      dst[op++] = uint8_t(code);
      oldcode = code;
      continue;
    }
    // Add oldcode + first char of code as a new entry.
    if (free_ent < 0 || free_ent >= kLzwCsize) return -1;
    if (oldcode < 0 || oldcode >= kLzwCsize) return -1;
    LzwEntry& fe = tab[free_ent];
    fe.next = int32_t(oldcode);
    fe.firstchar = tab[oldcode].firstchar;
    fe.length = tab[oldcode].length + 1;
    fe.value = code < free_ent ? tab[code].firstchar : fe.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = (1 << nbits) - 2;
      if (free_ent >= kLzwCsize) free_ent = -1;   // table full: sentinel
    }
    oldcode = code;
    if (code >= 256) {
      const LzwEntry& e = tab[code];
      if (e.length == 0) return -2;
      int64_t len = e.length;
      int64_t c = code;
      if (len > need - op) {      // cut: the first need - op bytes
        while (c >= 0 && tab[c].length > need - op) c = tab[c].next;
        len = need - op;
      }
      int64_t w = op + len;
      while (c >= 0 && w > op) {
        dst[--w] = tab[c].value;
        c = tab[c].next;
      }
      op += len;
    } else {
      dst[op++] = uint8_t(code);
    }
  }
  return op;
}

// libtiff's LZWDecodeCompat (see the head of this file). Returns as
// tb_tiff_lzw_decode.
extern "C" int64_t tb_tiff_lzw_decode_compat(const uint8_t* src, int64_t n,
                                             uint8_t* dst, int64_t need) {
  std::vector<LzwEntry> tab(kLzwCsize);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  for (int i = 256; i < kLzwCsize; ++i) tab[i] = {-1, 0, 0, 0};
  int64_t free_ent = -1;                // libtiff: dec_codetab - 1
  int nbits = 9;
  int64_t maxcode = (1 << nbits) - 2;   // LZWPreDecode's, until a clear
  int64_t oldcode = 0;
  int64_t ip = 0;
  uint64_t acc = 0;                     // LSB first
  int nacc = 0;
  int64_t bitsleft = n * 8;
  int64_t op = 0;
  auto get = [&](int width) -> int {
    if (bitsleft < width) return kLzwEoi;   // not terminated
    while (nacc < width) {
      acc |= uint64_t(src[ip++]) << nacc;
      nacc += 8;
    }
    const int code = int(acc & ((1u << width) - 1));
    acc >>= width;
    nacc -= width;
    bitsleft -= width;
    return code;
  };
  while (op < need) {
    int code = get(nbits);
    if (code == kLzwEoi) break;
    if (code == kLzwClear) {
      do {
        for (int i = kLzwFirst; i < kLzwCsize; ++i) tab[i] = {-1, 0, 0, 0};
        free_ent = kLzwFirst;
        nbits = 9;
        maxcode = (1 << nbits) - 1;
        code = get(nbits);
      } while (code == kLzwClear);
      if (code == kLzwEoi) break;
      if (code > kLzwClear) return -1;
      dst[op++] = uint8_t(code);
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kLzwCsize) return -1;
    LzwEntry& fe = tab[free_ent];
    fe.next = int32_t(oldcode);
    fe.firstchar = tab[oldcode].firstchar;
    fe.length = tab[oldcode].length + 1;
    fe.value = code < free_ent ? tab[code].firstchar : fe.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = (1 << nbits) - 1;
    }
    oldcode = code;
    if (code >= 256) {
      const LzwEntry& e = tab[code];
      if (e.length == 0) return -2;
      int64_t len = e.length;
      int64_t c = code;
      if (len > need - op) {
        while (c >= 0 && tab[c].length > need - op) c = tab[c].next;
        len = need - op;
      }
      int64_t w = op + len;
      while (c >= 0 && w > op) {
        dst[--w] = tab[c].value;
        c = tab[c].next;
      }
      op += len;
    } else {
      dst[op++] = uint8_t(code);
    }
  }
  return op;
}

// TIFF LZW as libtiff's LZWEncode writes it: a clear code first, codes
// of 9 to 12 bits MSB first, the width raised once the next free code
// reaches 512, 1024, 2048 (a code early for the decoder, which is one
// entry behind), a clear code once the table reaches 4094, the end code
// last. dst must hold at least 2 * n + 16 bytes. Returns the bytes
// written.
extern "C" int64_t tb_tiff_lzw_encode(const uint8_t* src, int64_t n,
                                      uint8_t* dst) {
  // child[code * 256 + byte]: the entry extending `code` by `byte`.
  std::vector<int16_t> child(4096 * 256, -1);
  int64_t op = 0;
  uint64_t acc = 0;
  int nacc = 0;
  int nbits = 9;
  int free_ent = kLzwFirst;
  auto put = [&](int code) {
    acc = (acc << nbits) | uint64_t(code);
    nacc += nbits;
    while (nacc >= 8) {
      nacc -= 8;
      dst[op++] = uint8_t(acc >> nacc);
    }
    acc &= (uint64_t(1) << nacc) - 1;
  };
  auto reset = [&]() {
    std::fill(child.begin(), child.end(), int16_t(-1));
    free_ent = kLzwFirst;
  };
  auto grow = [&]() {
    if (free_ent == 4094) {
      put(kLzwClear);
      nbits = 9;
      reset();
    } else if (free_ent > (1 << nbits) - 1) {
      ++nbits;
    }
  };
  put(kLzwClear);
  if (n == 0) {
    put(kLzwEoi);
    if (nacc) dst[op++] = uint8_t(acc << (8 - nacc));
    return op;
  }
  int cur = src[0];
  for (int64_t i = 1; i < n; ++i) {
    const uint8_t b = src[i];
    const int16_t nxt = child[size_t(cur) * 256 + b];
    if (nxt >= 0) {
      cur = nxt;
      continue;
    }
    put(cur);
    child[size_t(cur) * 256 + b] = int16_t(free_ent++);
    grow();
    cur = b;
  }
  put(cur);
  ++free_ent;
  grow();
  put(kLzwEoi);
  if (nacc) dst[op++] = uint8_t(acc << (8 - nacc));
  return op;
}

// Returns the bytes written (need on success).
extern "C" int64_t tb_packbits_decode(const uint8_t* src, int64_t n,
                                      uint8_t* dst, int64_t need) {
  int64_t ip = 0, op = 0;
  while (ip < n && op < need) {
    int64_t c = src[ip++];
    if (c >= 128) c -= 256;
    if (c < 0) {
      if (c == -128) continue;
      int64_t run = -c + 1;
      if (need - op < run) run = need - op;
      if (ip >= n) break;
      const uint8_t b = src[ip++];
      std::memset(dst + op, b, size_t(run));
      op += run;
    } else {
      int64_t lit = c + 1;
      if (need - op < lit) lit = need - op;
      if (n - ip < lit) break;
      std::memcpy(dst + op, src + ip, size_t(lit));
      op += lit;
      ip += lit;
    }
  }
  return op;
}

// Undo a predictor in place over `rows` rows of `rowbytes` bytes.
// predictor 2: bps 8, 16 or 32 (native-order samples), `stride` samples
// apart; predictor 3: bps 16, 24, 32 or 64 (bytes). Returns 0, or -1
// when a row is not a whole number of strides (libtiff's error).
extern "C" int64_t tb_tiff_unpredict(uint8_t* buf, int64_t rows,
                                     int64_t rowbytes, int64_t predictor,
                                     int64_t bps, int64_t stride) {
  const int64_t bytes = bps / 8;
  std::vector<uint8_t> tmp(predictor == 3 ? size_t(rowbytes) : 0);
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* row = buf + r * rowbytes;
    if (predictor == 2) {
      const int64_t wc = rowbytes / bytes;
      if (wc % stride) return -1;
      if (bytes == 1) {
        for (int64_t i = stride; i < wc; ++i) row[i] += row[i - stride];
      } else if (bytes == 2) {
        uint16_t* s = reinterpret_cast<uint16_t*>(row);
        for (int64_t i = stride; i < wc; ++i) s[i] += s[i - stride];
      } else {
        uint32_t* s = reinterpret_cast<uint32_t*>(row);
        for (int64_t i = stride; i < wc; ++i) s[i] += s[i - stride];
      }
    } else {
      if (rowbytes % (bytes * stride)) return -1;
      const int64_t wc = rowbytes / bytes;
      for (int64_t i = stride; i < rowbytes; ++i) row[i] += row[i - stride];
      std::memcpy(tmp.data(), row, size_t(rowbytes));
      for (int64_t c = 0; c < wc; ++c)
        for (int64_t b = 0; b < bytes; ++b)
          row[bytes * c + b] = tmp[(bytes - b - 1) * wc + c];
    }
  }
  return 0;
}

// Pillow's GIF decoder over the data sub-blocks at src (n bytes, starting
// at the first block's size byte), writing indices into img: ysize rows
// of xsize pixels, `stride` bytes apart. bits: the LZW minimum code size.
// Returns 0 once the last row is written; 1 when the data stops first,
// at an end code, a zero-length block or the end of the bytes (Pillow's
// decoder then returns short and ImageFile.load raises "image file is
// truncated"); -2 for a broken stream.
extern "C" int64_t tb_gif_decode(const uint8_t* src, int64_t n, uint8_t* img,
                                 int64_t xsize, int64_t ysize, int64_t stride,
                                 int64_t bits, int64_t interlace) {
  constexpr int kTable = 4096;
  constexpr int kBuffer = 4096;
  std::vector<uint8_t> data(kTable), buffer(kBuffer);
  std::vector<int16_t> link(kTable);
  const int clear = 1 << bits, end = clear + 1;
  int next = 0, codesize = 0, codemask = 0;
  int lastdata = 0, lastcode = 0;
  int state = 1;
  int64_t ip = 0, blocksize = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0;
  int64_t x = 0, y = 0;
  int step = interlace ? 8 : 1;
  int pass = interlace ? 1 : 0;
  if (xsize <= 0 || ysize <= 0) return 0;
  uint8_t* out = img;
  // NEWLINE: false when the image is complete.
  auto newline = [&]() -> bool {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return false;
      }
    }
    out = img + y * stride;
    return true;
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = int(bits) + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
    }
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuffer |= uint32_t(src[ip++]) << bitcount;
        --blocksize;
        bitcount += 8;
      } else {
        if (ip >= n) return 1;
        const int64_t c = src[ip];
        if (n - ip < c + 1) return 1;
        blocksize = c;
        ++ip;
        if (blocksize == 0) return 1;
      }
    }
    int c = int(bitbuffer & uint32_t(codemask));
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    if (c == end) return 1;
    const uint8_t* p;
    int len = 1;
    int bufindex = kBuffer;
    if (state == 2) {
      if (c > clear) return -2;
      lastdata = lastcode = c;
      state = 3;
      buffer[--bufindex] = uint8_t(c);
    } else {
      const int thiscode = c;
      if (c > next) return -2;
      if (c == next) {
        buffer[--bufindex] = uint8_t(lastdata);
        c = lastcode;
      }
      while (c >= clear) {
        if (bufindex <= 0 || c >= kTable) return -2;
        buffer[--bufindex] = data[c];
        c = link[c];
      }
      lastdata = c;
      buffer[--bufindex] = uint8_t(c);
      if (next < kTable) {
        data[next] = uint8_t(c);
        link[next] = int16_t(lastcode);
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
    }
    p = buffer.data() + bufindex;
    len = kBuffer - bufindex;
    for (int k = 0; k < len; ++k) {
      out[x] = p[k];
      if (++x >= xsize) {
        if (!newline()) return 0;
      }
    }
  }
}

// Returns the input bytes used, or -1 when the data ends before the
// last of `rows` rows of `rowbytes` bytes is complete.
extern "C" int64_t tb_pil_packbits_rows(const uint8_t* src, int64_t n,
                                        uint8_t* dst, int64_t rows,
                                        int64_t rowbytes) {
  int64_t ip = 0, x = 0, y = 0;
  uint8_t* row = dst;
  while (true) {
    if (n - ip < 1) return -1;
    const uint8_t c = src[ip];
    if (c & 0x80) {
      if (c == 0x80) {
        ++ip;
        continue;
      }
      if (n - ip < 2) return -1;
      for (int cnt = 257 - c; cnt > 0 && x < rowbytes; --cnt)
        row[x++] = src[ip + 1];
      ip += 2;
    } else {
      const int64_t m = int64_t(c) + 2;
      if (n - ip < m) return -1;
      for (int64_t i = 1; i < m && x < rowbytes; ++i) row[x++] = src[ip + i];
      ip += m;
    }
    if (x >= rowbytes) {
      x = 0;
      row += rowbytes;
      if (++y >= rows) return ip;
    }
  }
}
