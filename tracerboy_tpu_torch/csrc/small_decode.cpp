// The byte-serial loops of the port's readers of PIL's small formats
// (core/pcx.py, core/sgi.py, core/icns.py, loaded by core/codecs.py):
// PCX run lengths, SGI RLE rows and the ICNS PackBits-like channels.
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

}  // extern "C"
