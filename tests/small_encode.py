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
  the 24-bit entries.
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
