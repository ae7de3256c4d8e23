"""Writers of the small texture formats' files that PIL does not write, for
the port's readers' tests (core/sgi.py, core/pcx.py, core/ico.py,
core/ftex.py, core/blp.py, core/icns.py): each function returns the
file's bytes and lays them out field by field, so that a test can also
write what no encoder would (a run across a line, a row table past the
data, a BLP2 in raw BGRA).

- sgi_rle: SGI RLE of rows of repeat and copy packets at 8 or 16 bits
  a sample, any row replaced by given bytes (a broken row);
- pcx: a PCX header and any run-length stream; pcx_encode the runs PIL's
  encoder would write for given lines;
- dcx: a DCX directory over PCX pages;
- cur: a cursor directory over DIB bitmaps (dib_bitmap: a bitmap with
  its XOR image and AND mask);
- ftex: an FTEX header, format entries and mipmaps;
- blp1_jpeg, blp1_palette, blp2: BLP files in every encoding the header
  can name;
- icns: an icns file of raw entries; icns_rle: the PackBits-like code of
  the 24-bit entries;
- im: an IM header of any lines (a Lut, a NUL-ended header) over any
  rows; sun and sun_rle: a Sun raster of any depth, type and colour map,
  and Sun's byte RLE with given run and literal choices; msp_lins: a
  LinS MSP of given rows; pixar, gbr, imt, mcidas, spider, xvthumb and
  xpm: the headers of those formats over any pixel bytes;
- fits_card and fits: FITS header units of any cards over any data;
  fits_gzip_words: FitsGzipDecoder's 4-byte words of a sample array;
- fli_chunk, fli_frame and fli: an FLI/FLC header, frames and chunks of
  any type and body (fli_colour, fli_brun, fli_lc, fli_ss2 lay out
  those chunks' packets, fli_brun_packets a line's BRUN packets);
- iptc_record and iptc: IPTC/NAA fields (extended sizes too) of an image
  record set;
- pcd: a PhotoCD of given base-image chunks and orientation byte.
"""

from __future__ import annotations

import io
import struct

import numpy as np

# ----------------------------------------------------------------------------
# SGI


def sgi_header(w: int, h: int, z: int, bpc: int = 1, rle: bool = True,
               dimension: int | None = None) -> bytes:
    if dimension is None:
        dimension = 2 if z == 1 else 3
    return struct.pack(">hBBHHHH", 474, int(rle), bpc, dimension, w, h,
                       z) + bytes(500)


def sgi_row_packets(samples: np.ndarray, rng=None, bpc: int = 1) -> bytes:
    """One row's RLE packets: runs of equal samples as repeat packets,
    the rest as copy packets of random lengths (at most 127), then the
    terminating 0 (one word at 16 bits)."""
    out = bytearray()
    n = len(samples)
    i = 0

    def word(v):
        return struct.pack(">H", v) if bpc == 2 else bytes((v,))

    while i < n:
        j = i
        while j + 1 < n and samples[j + 1] == samples[i] and j - i < 126:
            j += 1
        if j > i:
            out += word(j - i + 1) + word(int(samples[i]))
            i = j + 1
            continue
        k = i + 1
        limit = min(n, i + (int(rng.integers(1, 128)) if rng is not None
                            else 127))
        while k < limit and samples[k] != samples[k - 1]:
            k += 1
        out += word(0x80 | (k - i)) + b"".join(word(int(v))
                                               for v in samples[i:k])
        i = k
    return bytes(out + word(0))


def sgi_rle(img: np.ndarray, bpc: int = 1, rng=None,
            rows: dict | None = None, dimension=None) -> bytes:
    """An SGI RLE file of (H, W, Z) samples (uint8, or uint16 at bpc 2);
    rows maps (row, channel) to the bytes to store instead of the
    encoded row (a broken row, say)."""
    h, w, z = img.shape
    planes = img[::-1].transpose(2, 0, 1)            # bottom-up rows
    data = []
    for c in range(z):
        for r in range(h):
            data.append((rows or {}).get((r, c)) or sgi_row_packets(
                planes[c, r], rng, bpc))
    start = 512 + 8 * h * z
    offsets, pos = [], start
    for d in data:
        offsets.append(pos)
        pos += len(d)
    tables = struct.pack(f">{h * z}I", *offsets) + struct.pack(
        f">{h * z}I", *map(len, data))
    return sgi_header(w, h, z, bpc, True, dimension) + tables + b"".join(
        data)


# ----------------------------------------------------------------------------
# PCX and DCX


def pcx_header(w: int, h: int, bits: int, planes: int, stride: int,
               version: int = 5, palette16: bytes = bytes(48),
               x0: int = 0, y0: int = 0) -> bytes:
    return (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0,
                        x0 + w - 1, y0 + h - 1, 72, 72) + palette16
            + bytes(1) + struct.pack("<BH", planes, stride) + bytes(60))


def pcx_encode(lines: np.ndarray, per_line: bool = True) -> bytes:
    """The run-length stream of (H, bytes) lines: runs of equal bytes
    (at most 63), a lone byte under 0xC0 as itself; each line's runs
    end with it unless per_line is False (an encoder that runs on across
    lines, which PIL refuses)."""
    out = bytearray()
    seq = list(lines) if per_line else [lines.reshape(-1)]
    for line in seq:
        i = 0
        while i < len(line):
            j = i
            while (j + 1 < len(line) and line[j + 1] == line[i]
                   and j - i + 1 < 63):
                j += 1
            n = j - i + 1
            if n == 1 and line[i] < 0xC0:
                out.append(int(line[i]))
            else:
                out += bytes((0xC0 | n, int(line[i])))
            i = j + 1
    return bytes(out)


def dcx(pages: list[bytes]) -> bytes:
    offsets, pos = [], 4 + 4 * (len(pages) + 1)
    for p in pages:
        offsets.append(pos)
        pos += len(p)
    head = struct.pack("<I", 0x3ADE68B1) + struct.pack(
        f"<{len(pages)}I", *offsets)
    return head + struct.pack("<I", 0) + b"".join(pages)


# ----------------------------------------------------------------------------
# CUR and DIB


def dib_bitmap(img: np.ndarray, bits: int = 24, palette=None) -> bytes:
    """A BITMAPINFOHEADER DIB of (H, W, 3|4) uint8 (or (H, W) indices with
    a palette at 1, 4 or 8 bits), its height doubled for the AND mask
    (of zeros) that follows the XOR image, as icons and cursors hold
    them."""
    h, w = img.shape[:2]
    colors = 0 if palette is None else len(palette)
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                       colors, 0)
    pal = b""
    if palette is not None:
        pal = b"".join(bytes((b, g, r, 0)) for r, g, b in palette)
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    if bits <= 8:
        per = 8 // bits
        idx = np.zeros((h, stride * per), np.uint8)
        idx[:, :w] = img
        packed = np.zeros((h, stride), np.uint8)
        for k in range(per):
            packed |= idx[:, k::per][:, :stride] << (8 - bits * (k + 1))
        rows = packed
    else:
        c = bits // 8
        px = img[..., [2, 1, 0, 3][:c]] if c == 4 else img[..., 2::-1]
        rows[:, :w * c] = px.reshape(h, w * c)
    mask_stride = ((w + 31) >> 3) & ~3
    return head + pal + rows[::-1].tobytes() + bytes(mask_stride * h)


def cur(bitmaps: list[tuple[int, int, bytes]], offsets=None) -> bytes:
    """A cursor of (width byte, height byte, bitmap) entries; offsets
    overrides where each entry says its bitmap starts."""
    n = len(bitmaps)
    pos = 6 + 16 * n
    entries, body = b"", b""
    for k, (wb, hb, bmp) in enumerate(bitmaps):
        off = pos if offsets is None else offsets[k]
        entries += struct.pack("<BBBBHHII", wb, hb, 0, 0, 1, 1, len(bmp),
                               off)
        pos += len(bmp)
        body += bmp
    return struct.pack("<HHH", 0, 2, n) + entries + body


# ----------------------------------------------------------------------------
# FTEX


def ftex(w: int, h: int, formats: list[tuple[int, bytes]]) -> bytes:
    """An FTEX of one mipmap for each (format, bytes) entry."""
    head = b"FTEX" + struct.pack("<5i", 1, w, h, 1, len(formats))
    pos = len(head) + 8 * len(formats)
    table, body = b"", b""
    for fmt, mip in formats:
        table += struct.pack("<2i", fmt, pos)
        block = struct.pack("<i", len(mip)) + mip
        body += block
        pos += len(block)
    return head + table + body


# ----------------------------------------------------------------------------
# BLP


def _tables(offset: int, length: int) -> bytes:
    return struct.pack("<16I", offset, *(0,) * 15) + struct.pack(
        "<16I", length, *(0,) * 15)


def blp1_jpeg(jpeg: bytes, w: int, h: int, alpha: int = 0,
              header_len: int | None = None) -> bytes:
    """A BLP1 of a JPEG: its first header_len bytes (default: up to the
    SOS segment's end) as the shared header, the rest as mipmap 0."""
    if header_len is None:
        sos = jpeg.index(b"\xff\xda")
        header_len = sos + 2 + struct.unpack(">H", jpeg[sos + 2:sos + 4])[0]
    shared, mip = jpeg[:header_len], jpeg[header_len:]
    head = b"BLP1" + struct.pack("<iIIIiI", 0, alpha, w, h, 5, 0)
    start = 28 + 128 + 4 + len(shared)
    return head + _tables(start, len(mip)) + struct.pack(
        "<I", len(shared)) + shared + mip


def blp1_palette(idx: np.ndarray, palette: np.ndarray, alpha: int = 8,
                 encoding: int = 4) -> bytes:
    """A BLP1 of (H, W) indices into (256, 4) RGBA entries."""
    h, w = idx.shape
    head = b"BLP1" + struct.pack("<iIIIiI", 1, alpha, w, h, encoding, 0)
    pal = palette[:, [2, 1, 0, 3]].astype(np.uint8).tobytes()
    data = idx.astype(np.uint8).tobytes()
    return head + _tables(28 + 128 + 1024, len(data)) + pal + data


def blp2(w: int, h: int, payload: bytes, encoding: int = 2,
         alpha_depth: int = 0, alpha_encoding: int = 0,
         palette: np.ndarray | None = None, compression: int = 1) -> bytes:
    """A BLP2 of one mipmap (payload: DXT blocks, palette indices or
    BGRA pixels, as `encoding` says)."""
    head = b"BLP2" + struct.pack("<iBBBBII", compression, encoding,
                                 alpha_depth, alpha_encoding, 0, w, h)
    pal = bytes(1024) if palette is None else palette[:, [2, 1, 0, 3]] \
        .astype(np.uint8).tobytes()
    return head + _tables(20 + 128 + 1024, len(payload)) + pal + payload


# ----------------------------------------------------------------------------
# ICNS


def icns_rle(channels: np.ndarray, rng=None) -> bytes:
    """The code of read_32's RLE: the three channels (3, N) one after
    another, runs of 3-130 equal bytes as 0x80 + (n - 3), the rest as
    literal runs of random lengths (at most 128)."""
    out = bytearray()
    for ch in channels:
        i, n = 0, len(ch)
        while i < n:
            j = i
            while j + 1 < n and ch[j + 1] == ch[i] and j - i < 129:
                j += 1
            if j - i >= 2:
                out += bytes((0x80 + (j - i + 1) - 3, int(ch[i])))
                i = j + 1
                continue
            k = min(n, i + (int(rng.integers(1, 129)) if rng is not None
                            else 128))
            out += bytes((k - i - 1,)) + ch[i:k].astype(np.uint8).tobytes()
            i = k
    return bytes(out)


def icns(entries: list[tuple[bytes, bytes]]) -> bytes:
    body = b"".join(t + struct.pack(">I", 8 + len(d)) + d
                    for t, d in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def png_bytes(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


# ----------------------------------------------------------------------------
# Part 2: IM, SUN, MSP, PIXAR, GBR, IMT, McIdas, SPIDER, XVThumb, XPM


def im(kind: str | None, w: int, h: int, body: bytes, lines=(),
       lut: bytes | None = None, end: bytes = b"\0") -> bytes:
    """An IM file: "Image type: <kind>" (none where kind is None), the
    size, any further "Key: value" lines, a Lut line where lut is given,
    the header ended by `end` and padded with NULs to a 0x1A at byte
    511, the Lut's 768 bytes, then body."""
    head = [f"Image type: {kind}"] if kind is not None else []
    head += [f"Image size (x*y): {w}*{h}", *lines]
    if lut is not None:
        head.append("Lut: 1")
    text = "".join(f"{line}\r\n" for line in head).encode("latin-1") + end
    return text.ljust(511, b"\0") + b"\x1a" + (lut or b"") + body


def im_rows(img: np.ndarray, planar: bool = True) -> bytes:
    """An image's rows bottom-up, each row's channels planar (IM's ;L
    raw modes) or interleaved."""
    rows = img[::-1]
    if img.ndim == 3 and planar:
        rows = rows.transpose(0, 2, 1)
    return np.ascontiguousarray(rows).tobytes()


def sun(w: int, h: int, depth: int, kind: int, body: bytes,
        cmap: bytes = b"", map_type: int = 1) -> bytes:
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), kind,
                       map_type if cmap else 0, len(cmap)) + cmap + body


def sun_rows(lines: np.ndarray) -> bytes:
    """Rows of (H, linebytes) uint8 padded to 16 bits, the raw layout."""
    pad = lines.shape[1] % 2
    return np.pad(lines, ((0, 0), (0, pad))).tobytes()


def sun_rle(stream: bytes, rng=None) -> bytes:
    """Sun's byte RLE of a stream: runs of 3 or more as 0x80, n - 1, v
    (at most 256; where rng is given, some runs of 2 too), a 0x80 as
    0x80 0 (or a run of 1, 0x80 0x00 being a literal), the rest
    literal."""
    out = bytearray()
    i, n = 0, len(stream)
    while i < n:
        j = i
        while j + 1 < n and stream[j + 1] == stream[i] and j - i < 255:
            j += 1
        run = j - i + 1
        if run >= 3 or (run == 2 and rng is not None and rng.random() < .5):
            out += bytes((0x80, run - 1, stream[i]))
            i = j + 1
        elif stream[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(stream[i])
            i += 1
    return bytes(out)


def msp_lins(w: int, h: int, rows: list[bytes]) -> bytes:
    """A LinS MSP file: the header (its checksum word set), the row map
    and the rows' bytes."""
    words = [*struct.unpack("<2H", b"LinS"), w, h] + [0] * 12
    check = 0
    for v in words[:15]:
        check ^= v
    words[15] = check
    return (struct.pack("<16H", *words)
            + struct.pack(f"<{len(rows)}H", *map(len, rows))
            + b"".join(rows))


def msp_row(line: bytes, rng) -> bytes:
    """One LinS row of a line's bytes: runs of equal bytes as
    (0, count, value), the rest in literal blocks of random length."""
    out = bytearray()
    i, n = 0, len(line)
    while i < n:
        j = i
        while j + 1 < n and line[j + 1] == line[i] and j - i < 254:
            j += 1
        if j > i:
            out += bytes((0, j - i + 1, line[i]))
            i = j + 1
            continue
        k = min(n, i + int(rng.integers(1, 6)))
        out += bytes((k - i,)) + line[i:k]
        i = k
    return bytes(out)


def pixar(w: int, h: int, rgb: bytes, layout=(14, 2)) -> bytes:
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<2H", head, 416, h, w)
    struct.pack_into("<2H", head, 424, *layout)
    return bytes(head) + rgb


def gbr(w: int, h: int, depth: int, body: bytes, version: int = 2,
        comment: bytes = b"brush\0") -> bytes:
    size = (20 if version == 1 else 28) + len(comment)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 10)
    return head + comment + body


def imt(w: int, h: int, body: bytes, comment: bool = True) -> bytes:
    lines = [f"width {w}", f"height {h}", "pixel n8"]
    if comment:
        lines.insert(1, "* IM Tools image")
    return "".join(f"{x}\n" for x in lines).encode() + b"\x0c" + body


def mcidas(w: int, h: int, bpp: int, body: bytes, prefix: int = 0,
           bands: int = 1, data_offset: int = 256) -> bytes:
    """A McIdas area: the directory's words 9-11 (height, width, bytes a
    sample), 14 (bands), 15 (line prefix bytes) and 34 (data offset)."""
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10] = h, w, bpp
    words[13], words[14], words[33] = bands, prefix, data_offset
    head = struct.pack(">64i", *words)
    return head + bytes(max(0, data_offset - 256)) + body


def spider(img: np.ndarray, big: bool = True, stack: int = 0) -> bytes:
    """A SPIDER image of float32 samples, one header record of 1024
    bytes (labrec 1, lenbyt 1024); with stack > 0 a stack header (istack
    `stack`, maxim 1) before the image's own header."""
    h, w = img.shape
    order = ">" if big else "<"

    def header(istack, imgnumber, maxim):
        t = [0.0] * 256
        t[0], t[1], t[4], t[11], t[12] = 1, h, 1, w, 1
        t[21], t[22] = 1024, 1024
        t[23], t[25], t[26] = istack, maxim, imgnumber
        return struct.pack(f"{order}256f", *t)

    body = img.astype(order + "f4").tobytes()
    if stack:
        return header(stack, 0, 1) + header(0, 1, 0) + body
    return header(0, 0, 0) + body


def xvthumb(w: int, h: int, body: bytes, comments=("#XVVERSION:Version "
                                                   "3.10", "#END_OF_"
                                                   "COMMENTS")) -> bytes:
    lines = ["P7 332", *comments, f"{w} {h} 255"]
    return "".join(f"{x}\n" for x in lines).encode() + body


def xpm(w: int, h: int, colours: list[tuple[bytes, bytes]],
        rows: list[bytes], pixels_comment: bool = False) -> bytes:
    """An XPM: the values line, one line a colour (key, colour spec),
    then the quoted rows."""
    bpp = len(colours[0][0]) if colours else 1
    lines = [b"/* XPM */", b"static char *image[] = {",
             b"/* columns rows colors chars-per-pixel */",
             f'"{w} {h} {len(colours)} {bpp}",'.encode()]
    lines += [b'"' + k + b" c " + c + b'",' for k, c in colours]
    if pixels_comment:
        lines.append(b"/* pixels */")
    lines += [b'"' + r + b'",' for r in rows]
    return b"\n".join(lines) + b"\n};\n"


# ----------------------------------------------------------------------------
# FITS


def fits_card(key: str | bytes, value=None) -> bytes:
    """One 80-byte card: `key` padded to 8, then "= " and the value
    right-aligned to 20 (bytes are written as they are)."""
    card = key.encode() if isinstance(key, str) else key
    card = card.ljust(8)
    if value is not None:
        v = value if isinstance(value, bytes) else str(value).encode()
        card += b"= " + v.rjust(20)
    return card.ljust(80)[:80]


def fits(units: list[tuple[list, bytes]], pad: bool = True) -> bytes:
    """FITS units: each a list of cards ((key, value) pairs or raw 80-byte
    cards), an END card and padding to 2880 bytes, then its data (padded
    to 2880 bytes with zeros where `pad`)."""
    out = bytearray()
    for cards, data in units:
        head = b"".join(c if isinstance(c, bytes) else fits_card(*c)
                        for c in cards) + fits_card("END")
        out += head.ljust(-(-len(head) // 2880) * 2880, b" ")
        out += data.ljust(-(-len(data) // 2880) * 2880, b"\0") if pad \
            else data
    return bytes(out)


def fits_gzip_words(samples: np.ndarray, bits: int) -> bytes:
    """A (H, W) sample array as FitsGzipDecoder reads it before gzip:
    4-byte words, the sample's min(bits // 8, 4) bytes (little-endian, as
    PIL's raw modes read them) at the word's end, the rows bottom-up."""
    keep = max(min(bits // 8, 4), 1)
    h, w = samples.shape
    dtype = {1: "u1", 2: "<u2", 4: "<f4" if bits < 0 else "<i4"}[keep]
    raw = np.ascontiguousarray(samples[::-1]).astype(dtype).view(
        np.uint8).reshape(h, w, keep)
    words = np.zeros((h, w, 4), np.uint8)
    words[..., 4 - keep:] = raw
    return words.tobytes()


# ----------------------------------------------------------------------------
# FLI


def fli_chunk(kind: int, body: bytes, size: int | None = None) -> bytes:
    return struct.pack("<IH", 6 + len(body) if size is None else size,
                       kind) + body


def fli_frame(chunks: list[bytes], magic: int = 0xF1FA,
              size: int | None = None, count: int | None = None) -> bytes:
    body = b"".join(chunks)
    return struct.pack("<IHH8x", 16 + len(body) if size is None else size,
                       magic, len(chunks) if count is None else count) + body


def fli(w: int, h: int, frames: list[bytes], magic: int = 0xAF12,
        flags: int = 3, prefix: bytes = b"") -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) header, then an optional prefix
    chunk's bytes, then the frames."""
    body = prefix + b"".join(frames)
    head = struct.pack("<IHHHHHHI", 128 + len(body), magic, len(frames), w,
                       h, 8, flags, 5)
    return head.ljust(128, b"\0") + body


def fli_colour(packets: list[tuple[int, bytes]]) -> bytes:
    """A COLOR_256/COLOR_64 body: (skip, entry bytes) packets, the count
    byte 0 for 256 entries."""
    out = struct.pack("<H", len(packets))
    for skip, entries in packets:
        n = len(entries) // 3
        out += bytes((skip, n & 255)) + entries
    return out


def fli_brun_packets(line: np.ndarray, rng) -> bytes:
    """One line's BRUN packets, split at random: a run (count, value)
    where the piece is one value, else a literal (256 - count, bytes)."""
    out = bytearray()
    x, w = 0, len(line)
    while x < w:
        n = int(rng.integers(1, min(w - x, 127) + 1))
        piece = line[x:x + n]
        if (piece == piece[0]).all():
            out += bytes((n, int(piece[0])))
        else:
            out += bytes((256 - n,)) + piece.tobytes()
        x += n
    return bytes(out)


def fli_brun(idx: np.ndarray, rng) -> bytes:
    return b"".join(bytes((int(rng.integers(0, 256)),)) + fli_brun_packets(
        line, rng) for line in idx)


def fli_lc(first: int, lines: list[list[tuple]]) -> bytes:
    """An LC body: the first line, the line count, then each line's
    packets: (skip, bytes) literals or (skip, count, value) runs."""
    out = bytearray(struct.pack("<HH", first, len(lines)))
    for packets in lines:
        out.append(len(packets) & 255)
        for p in packets:
            if len(p) == 2:
                out += bytes((p[0], len(p[1]))) + p[1]
            else:
                out += bytes((p[0], 256 - p[1], p[2]))
    return bytes(out)


def fli_ss2(lines: list[tuple[list[int], list[tuple]]]) -> bytes:
    """An SS2 body: per line its flag words (0xC000 | ... skips, 0x8000 |
    byte sets the last byte), then word packets: (skip, bytes) literals
    of an even length or (skip, count, two bytes) runs."""
    out = bytearray(struct.pack("<H", len(lines)))
    for flags, packets in lines:
        for f in flags:
            out += struct.pack("<H", f)
        out += struct.pack("<H", len(packets))
        for p in packets:
            if len(p) == 2:
                out += bytes((p[0], len(p[1]) // 2)) + p[1]
            else:
                out += bytes((p[0], 256 - p[1])) + p[2]
    return bytes(out)


# ----------------------------------------------------------------------------
# IPTC


def iptc_record(rec: int, tag: int, data: bytes, extended: int = 0) -> bytes:
    """One field: 0x1C, record, tag and a 16-bit size, or (extended n) an
    extended size: 0x80 + n, a byte, then the size in n bytes."""
    if extended:
        return bytes((0x1C, rec, tag, 0x80 + extended, 0)) + len(
            data).to_bytes(extended, "big") + data
    return bytes((0x1C, rec, tag)) + struct.pack(">H", len(data)) + data


def iptc(w: int, h: int, payload: bytes, layers: int = 1,
         component: int = 0, compression: int = 1, band: int | None = None,
         pieces: int = 1, extra: bytes = b"") -> bytes:
    """IPTC fields of an image: (3, 60) layers and component, the size
    (4 bytes each), compression, an optional (3, 65) band byte, any
    extra fields, then the payload in `pieces` (8, 10) records."""
    out = (iptc_record(3, 60, bytes((layers, component)))
           + iptc_record(3, 20, struct.pack(">I", w))
           + iptc_record(3, 30, struct.pack(">I", h))
           + iptc_record(3, 120, bytes((compression,))))
    if band is not None:
        out += iptc_record(3, 65, bytes((band,)))
    out += extra
    step = -(-len(payload) // pieces) or 1
    return out + b"".join(iptc_record(8, 10, payload[k:k + step])
                          for k in range(0, max(len(payload), 1), step))


# ----------------------------------------------------------------------------
# PCD


def pcd(chunks: bytes, orientation: int = 0) -> bytes:
    """A PhotoCD: "PCD_" at 2048, the orientation byte at 2048 + 1538,
    the base image's chunks at sector 96."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + chunks


def gzip_bytes(data: bytes) -> bytes:
    """gzip of `data` with a zero mtime (the same bytes on each run with
    one zlib)."""
    import gzip

    return gzip.compress(data, 6, mtime=0)
