// The byte-serial loops of the port's readers of PIL's small formats
// (core/pcx.py, core/sgi.py, core/icns.py, core/sun.py, core/msp.py,
// core/xbm.py, core/im.py and core/fli.py, loaded by core/codecs.py):
// PCX run lengths, SGI RLE rows, the ICNS PackBits-like channels, Sun's
// RLE, MSP's LinS rows, XBM's hex bytes, IM's packed float samples and
// an FLI frame's chunks.
// Host code, compiled with g++ at first use into the port's build
// directory (utils/build.py) and called through ctypes; numpy unpacks
// the rows.
//
// Each routine follows the decoder PIL reads the format with, down to
// what it does with a broken stream:
// - tb_pcx_decode: Pillow's PcxDecode.c. A byte with its two high bits
//   set is a run of (byte & 0x3F) copies of the next byte, any other byte
//   a literal; a line is `bytes` bytes (planes x PIL's stride). A run
//   that crosses the end of its line overruns (its remaining count is
//   dropped, and PIL raises once the image is done); data that ends
//   before the last line is truncated. Before a line is unpacked its
//   planes are moved together (the first left in place) as PcxDecode.c
//   moves them: for the unpacker's 2 and 4 bits a pixel (P;2L, P;4L),
//   `bits` planes of (width + 7) / 8 bytes taken bytes / bits apart; else
//   bytes / width planes of width bytes, where their spacing is wider.
// - tb_sgi_rle_decode: Pillow's SgiRleDecode.c. The start and length
//   tables (4 bytes each, bands x rows of each, after the 512-byte
//   header), then each row of each band expanded into one row buffer that
//   is never cleared (a row whose data ends early keeps the previous
//   row's samples, as does a row whose length, taken as a signed int,
//   is not positive): a control byte (the low byte of a 16-bit word at 2
//   bytes a sample) of count & 0x7F samples, copied (0x80 set) or one
//   repeated; count 0 ends the row; the row's last control byte must be
//   0, or decoding stops there, silently, the rows not yet stored left
//   zero. A row past the data, a table shorter than bands x rows x 8
//   bytes, a run past the row's width, or reads past the data's last
//   byte (checked as SgiRleDecode.c checks them: a copy may not reach the
//   last byte) overrun. Rows are stored bottom-up.
// - tb_icns_rle_decode: IcnsImagePlugin.read_32's loop: three channels in
//   turn from one stream, a byte with its high bit set a run of byte -
//   125 copies of the next, any other byte + 1 literal bytes; a channel
//   ends once its count of pixels is reached or passed. Where the count
//   is passed, or the data ends first, PIL raises SyntaxError; where the
//   count is met but reads at the end of the data came up short, the
//   channel's buffer is too small (ValueError).
// - tb_sun_rle_decode: Pillow's SunRleDecode.c. A byte 0x80 followed by
//   0 is one literal 0x80; 0x80, n, v (n > 0) is a run of n + 1 bytes of
//   v, which carries on into the next lines where it is longer than what
//   is left of its line; any other byte is a literal. Lines are the
//   unpacker's (w x bits + 7) / 8 bytes, not padded to 16 bits as the
//   raw layout's are. Data that ends before the last line is truncated.
// - tb_msp_decode: MspImagePlugin.MspDecoder's loop on the LinS rows
//   after the row map: a row of length 0 is a line of 0xFF bytes; else
//   its bytes are runs (0, count, value) and literal blocks (count, then
//   count bytes, fewer where the row ends first). Every row's output is
//   appended to one stream, which PIL then cuts into lines: rows do not
//   have to make lines. A row past the data, or a run cut by the row's
//   end, is refused (PIL's OSError).
// - tb_xbm_decode: Pillow's XbmDecode.c. Skip to the next 'x', take the
//   two bytes after it as hex digits (a byte that is not one counts as
//   0), (w + 7) / 8 bytes a line; data that ends first is truncated.
// - tb_bit_decode: Pillow's BitDecode.c with ImImagePlugin's arguments
//   (bits, pad 8, fill 3, no sign, bottom-up): samples of `bits` bits
//   taken from the low end of a bit buffer that each byte fills from
//   above, as floats. At the end of a line the bit count is reset but
//   the buffer is not: its leftover bits are OR'd into the next line's
//   first byte, and where the count passes 32 the buffer is rebuilt from
//   the last byte, as BitDecode.c does.
// - tb_fli_decode: Pillow's FliDecode.c on the bytes ImageFile.load has
//   read so far of one frame (core/fli.py repeats load's reads). It
//   returns 0 (more data wanted) while the buffer is shorter than the
//   frame's size (a pad byte allowed), else walks the frame's chunks:
//   4 and 11 (colours) and 18 (postage stamp) skipped; 7 (SS2: lines of
//   word packets, flag words that skip lines or set a line's last byte);
//   12 (LC: byte packets from a first line); 13 (BLACK); 15 (BRUN: each
//   line's packet-count byte ignored, runs and literals to the line's
//   end); 16 (COPY; short data returns the bytes walked, as FliDecode.c
//   does); any other type is unknown. Reads are bounded by the buffer,
//   not by the chunk, as FliDecode.c bounds them; a packet that would
//   write past its line ends the line's packets, and a chunk whose
//   lines are not all done overruns.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kOk = 0;
constexpr int64_t kOverrun = -1;
constexpr int64_t kTruncated = -2;
constexpr int64_t kShort = -3;

}  // namespace

extern "C" {

// PCX: `height` lines of `bytes` bytes from src[0, n) into out.
int64_t tb_pcx_decode(const uint8_t* src, int64_t n, uint8_t* out,
                      int64_t width, int64_t height, int64_t bytes,
                      int64_t bits) {
  std::vector<uint8_t> line(bytes);
  int64_t pos = 0, x = 0, y = 0;
  bool overrun = false;
  while (y < height) {
    if (pos >= n) return kTruncated;
    uint8_t b = src[pos];
    if ((b & 0xC0) == 0xC0) {
      if (pos + 2 > n) return kTruncated;
      int count = b & 0x3F;
      while (count > 0) {
        if (x >= bytes) {
          overrun = true;
          break;
        }
        line[x++] = src[pos + 1];
        count--;
      }
      pos += 2;
    } else {
      line[x++] = b;
      pos++;
    }
    if (x >= bytes) {
      // The planes moved together: 2 or 4 bit planes (P;2L, P;4L) of
      // (width + 7) / 8 bytes, else bytes / width planes of width bytes.
      int64_t size, bands, stride = 0;
      if (bits == 2 || bits == 4) {
        size = (width + 7) / 8;
        bands = bits;
        stride = bytes / bits;
      } else {
        size = width;
        bands = bytes / width;
        if (bands) stride = bytes / bands;
      }
      if (stride > size)
        for (int64_t i = 1; i < bands; i++)
          std::memmove(&line[i * size], &line[i * stride], size);
      std::memcpy(out + y * bytes, line.data(), bytes);
      x = 0;
      y++;
    }
  }
  return overrun ? kOverrun : kOk;
}

namespace {

// SgiRleDecode.c's expandrow (z = bands) and expandrow2.
int expand_row(uint8_t* dest, const uint8_t* src, int64_t n, int z,
               int xsize, const uint8_t* end, int bpc) {
  int x = 0;
  for (; n > 0; n--) {
    if (src + (bpc - 1) > end) return -1;
    uint8_t pixel = bpc == 1 ? src[0] : src[1];
    src += bpc;
    if (n == 1 && pixel != 0) return (int)n;
    int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + bpc * count > end) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        src += bpc;
        dest += z * bpc;
      }
    } else {
      if (src + (bpc - 1) > end) return -1;
      if (bpc == 2 && src + 2 > end) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        dest += z * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         p[3];
}

}  // namespace

// SGI RLE: buf is the file after its 512-byte header (bufsize bytes);
// out receives ysize rows of xsize x bands samples of bpc bytes,
// interleaved, top row first.
int64_t tb_sgi_rle_decode(const uint8_t* buf, int64_t bufsize, uint8_t* out,
                          int64_t xsize, int64_t ysize, int64_t bands,
                          int64_t bpc) {
  const int64_t tablen = bands * ysize;
  if (bufsize < 8 * tablen) return kOverrun;
  const int64_t rowbytes = xsize * bands * bpc;
  std::vector<uint8_t> row(xsize * bands * 2, 0);
  const uint8_t* end = buf + bufsize - 1;
  for (int64_t r = 0; r < ysize; r++) {
    for (int64_t c = 0; c < bands; c++) {
      int64_t k = r + c * ysize;
      uint32_t offset = be32(buf + 4 * k);
      uint32_t length = be32(buf + 4 * (tablen + k));
      if (offset < 512) return kOverrun;
      offset -= 512;
      if (offset >= bufsize) {  // its first read would be past the data
        if ((int32_t)length > 0) return kOverrun;
        continue;
      }
      // SgiRleDecode.c hands the 32-bit length on as an int: a length of
      // 2^31 or more is negative there, and the row is not touched.
      int status = expand_row(row.data() + c * bpc, buf + offset,
                              (int32_t)length, (int)bands, (int)xsize, end,
                              (int)bpc);
      if (status == -1) return kOverrun;
      if (status == 1) return kOk;
    }
    std::memcpy(out + (ysize - 1 - r) * rowbytes, row.data(), rowbytes);
  }
  return kOk;
}

// ICNS RLE: three channels of sizesq bytes each, planar, into out, read
// from src[0, n).
int64_t tb_icns_rle_decode(const uint8_t* src, int64_t n, uint8_t* out,
                           int64_t sizesq) {
  int64_t pos = 0;
  for (int band = 0; band < 3; band++) {
    uint8_t* dst = out + band * sizesq;
    int64_t got = 0, left = sizesq;
    while (left > 0) {
      if (pos >= n) break;
      int b = src[pos++];
      int64_t block;
      if (b & 0x80) {
        block = b - 125;
        if (pos < n) {
          std::memset(dst + got, src[pos], block <= sizesq - got
                                               ? block : sizesq - got);
          got += block;
          pos++;
        }
      } else {
        block = b + 1;
        int64_t take = n - pos < block ? n - pos : block;
        std::memcpy(dst + got, src + pos,
                    take <= sizesq - got ? take : sizesq - got);
        got += take;
        pos += take;
      }
      left -= block;
    }
    if (left != 0) return kTruncated;
    if (got < sizesq) return kShort;
  }
  return kOk;
}

// Sun RLE: `lines` lines of `bytes` bytes from src[0, n) into out.
int64_t tb_sun_rle_decode(const uint8_t* src, int64_t n, uint8_t* out,
                          int64_t bytes, int64_t lines) {
  int64_t pos = 0, x = 0, y = 0;
  uint8_t* line = out;
  while (pos < n) {
    int64_t count;
    uint8_t extra_data = 0;
    uint8_t extra_bytes = 0;
    if (src[pos] == 0x80) {
      if (pos + 2 > n) break;
      count = src[pos + 1];
      if (count == 0) {
        count = 1;
        line[x] = 0x80;
        pos += 2;
      } else {
        if (pos + 3 > n) break;
        count += 1;
        if (x + count > bytes) {
          extra_bytes = (uint8_t)count;
          count = bytes - x;
          extra_bytes = (uint8_t)(extra_bytes - count);
          extra_data = src[pos + 2];
        }
        std::memset(line + x, src[pos + 2], count);
        pos += 3;
      }
    } else {
      count = 1;
      line[x] = src[pos];
      pos += 1;
    }
    for (;;) {
      x += count;
      if (x >= bytes) {
        x = 0;
        if (++y >= lines) return kOk;
        line = out + y * bytes;
      }
      if (extra_bytes == 0 || x > 0) break;
      count = extra_bytes >= bytes ? bytes : extra_bytes;
      std::memset(line + x, extra_data, count);
      extra_bytes = (uint8_t)(extra_bytes - count);
    }
  }
  return kTruncated;
}

// MSP LinS: the rows (lengths rowlen[0, rows)) at src[0, n) into out,
// which holds `cap` bytes; returns the stream's whole length, or
// kTruncated for a row past the data, kOverrun for a run cut short.
int64_t tb_msp_decode(const uint8_t* src, int64_t n, const uint16_t* rowlen,
                      int64_t rows, int64_t linebytes, uint8_t* out,
                      int64_t cap) {
  int64_t pos = 0, got = 0;
  auto put = [&](const uint8_t* p, int64_t k) {
    if (got < cap) std::memcpy(out + got, p, k < cap - got ? k : cap - got);
    got += k;
  };
  auto fill = [&](uint8_t v, int64_t k) {
    if (got < cap) std::memset(out + got, v, k < cap - got ? k : cap - got);
    got += k;
  };
  for (int64_t r = 0; r < rows; r++) {
    int64_t len = rowlen[r];
    if (len == 0) {
      fill(0xFF, linebytes);
      continue;
    }
    if (pos + len > n) return kTruncated;
    const uint8_t* row = src + pos;
    pos += len;
    int64_t i = 0;
    while (i < len) {
      int type = row[i++];
      if (type == 0) {
        if (i + 2 > len) return kOverrun;
        fill(row[i + 1], row[i]);
        i += 2;
      } else {
        int64_t take = len - i < type ? len - i : type;
        put(row + i, take);
        i += type;
      }
    }
  }
  return got;
}

namespace {

int hex_digit(uint8_t v) {
  if (v >= '0' && v <= '9') return v - '0';
  if (v >= 'a' && v <= 'f') return v - 'a' + 10;
  if (v >= 'A' && v <= 'F') return v - 'A' + 10;
  return 0;
}

}  // namespace

// XBM: `lines` lines of `bytes` bytes from src[0, n) into out.
int64_t tb_xbm_decode(const uint8_t* src, int64_t n, uint8_t* out,
                      int64_t bytes, int64_t lines) {
  int64_t pos = 0, total = bytes * lines;
  for (int64_t k = 0; k < total; k++) {
    while (pos < n && src[pos] != 'x') pos++;
    if (n - pos < 3) return kTruncated;
    out[k] = (uint8_t)((hex_digit(src[pos + 1]) << 4) +
                       hex_digit(src[pos + 2]));
    pos += 3;
  }
  return kOk;
}

// IM's packed samples: xsize x ysize floats into out, bottom-up; returns
// kTruncated where src[0, n) ends first.
int64_t tb_bit_decode(const uint8_t* src, int64_t n, float* out,
                      int64_t xsize, int64_t ysize, int64_t bits) {
  const unsigned long mask = (unsigned long)((1ull << bits) - 1);
  unsigned long buffer = 0;
  int64_t count = 0, x = 0, y = ysize - 1;
  for (int64_t pos = 0; pos < n; pos++) {
    uint8_t byte = src[pos];
    buffer |= (unsigned long)byte << count;
    count += 8;
    while (count >= bits) {
      unsigned long data = buffer & mask;
      if (count > 32)
        buffer = byte >> (8 - (count - bits));
      else
        buffer >>= bits;
      count -= bits;
      out[y * xsize + x] = (float)data;
      if (++x >= xsize) {
        if (--y < 0) return kOk;
        x = 0;
        count = 0;
      }
    }
  }
  return kTruncated;
}

// FLI: one frame from buf[0, n) into im (ysize lines of xsize indices,
// zero or the frame before). Returns the bytes taken (>= 0: more data
// wanted) or -1 with *err set: 0 for the frame's end, else
// kFliOverrun, kFliBroken or kFliUnknown (Pillow's IMAGING_CODEC_*).
int64_t tb_fli_decode(const uint8_t* buf, int64_t n, uint8_t* im,
                      int64_t xsize, int64_t ysize, int64_t* err) {
  constexpr int64_t kFliOverrun = -1, kFliBroken = -2, kFliUnknown = -3;
  auto i16 = [](const uint8_t* p) { return (int)p[0] | (int)p[1] << 8; };
  auto i32 = [](const uint8_t* p) {
    return (int32_t)((uint32_t)p[0] | (uint32_t)p[1] << 8 |
                     (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24);
  };
  *err = 0;
  if (n < 4) return 0;
  const uint8_t* ptr = buf;
  int64_t bytes = n;
  const uint32_t framesize = (uint32_t)i32(ptr);  // unsigned, as Pillow's
  if (bytes + (bytes % 2) < (int64_t)framesize) return 0;
  auto fail = [&](int64_t code) {
    *err = code;
    return (int64_t)-1;
  };
  if (bytes < 8) return fail(kFliOverrun);
  if (i16(ptr + 4) != 0xF1FA) return fail(kFliUnknown);
  const int chunks = i16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) return fail(kFliOverrun);
    const uint8_t* data = ptr + 6;
    const uint8_t* end = ptr + bytes;
#define FLI_OOB(k) \
  if (data + (k) > end) return fail(kFliOverrun)
    int64_t x = 0, y, i = 0;
    switch (i16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2
        const int lines = i16(data);
        data += 2;
        int l;
        for (l = 0, y = 0; l < lines && y < ysize; l++, y++) {
          uint8_t* line = im + y * xsize;
          FLI_OOB(2);
          int packets = i16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= ysize) return fail(kFliOverrun);
              line = im + y * xsize;
            } else {
              line[xsize - 1] = (uint8_t)packets;
            }
            FLI_OOB(2);
            packets = i16(data);
            data += 2;
          }
          int p;
          for (p = 0, x = 0; p < packets; p++) {
            FLI_OOB(2);
            x += data[0];
            if (data[1] >= 128) {
              FLI_OOB(4);
              i = 256 - data[1];
              if (x + i + i > xsize) break;
              for (int64_t j = 0; j < i; j++) {
                line[x++] = data[2];
                line[x++] = data[3];
              }
              data += 4;
            } else {
              i = 2 * (int64_t)data[1];
              if (x + i > xsize) break;
              FLI_OOB(2 + i);
              std::memcpy(line + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return fail(kFliOverrun);
        break;
      }
      case 12: {  // LC
        y = i16(data);
        const int64_t ymax = y + i16(data + 2);
        data += 4;
        for (; y < ymax && y < ysize; y++) {
          uint8_t* line = im + y * xsize;
          FLI_OOB(1);
          const int packets = *data++;
          int p;
          for (p = 0, x = 0; p < packets; p++, x += i) {
            FLI_OOB(2);
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xsize) break;
              FLI_OOB(3);
              std::memset(line + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > xsize) break;
              FLI_OOB(2 + i);
              std::memcpy(line + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return fail(kFliOverrun);
        break;
      }
      case 13:  // BLACK
        std::memset(im, 0, xsize * ysize);
        break;
      case 15:  // BRUN
        for (y = 0; y < ysize; y++) {
          uint8_t* line = im + y * xsize;
          data += 1;
          for (x = 0; x < xsize; x += i) {
            FLI_OOB(2);
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xsize) break;
              FLI_OOB(i + 1);
              std::memcpy(line + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xsize) break;
              std::memset(line + x, data[1], i);
              data += 2;
            }
          }
          if (x != xsize) return fail(kFliOverrun);
        }
        break;
      case 16:  // COPY
        if (INT32_MAX / xsize < ysize) return fail(kFliOverrun);
        if (data + xsize * ysize > end) return ptr - buf;
        std::memcpy(im, data, xsize * ysize);
        break;
      default:
        return fail(kFliUnknown);
    }
#undef FLI_OOB
    const int32_t advance = i32(ptr);
    if (advance == 0) return fail(kFliBroken);
    if (advance < 0 || advance > bytes) return fail(kFliOverrun);
    ptr += advance;
    bytes -= advance;
  }
  return -1;
}

}  // extern "C"
