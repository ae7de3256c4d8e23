"""A small numpy TIFF, GIF and ICO writer for the tests of the port's
readers (core/tiff.py, core/gif.py, core/ico.py).

PIL's writer covers strips of the common layouts; this one writes the
layouts it cannot: tiles (edge tiles padded), PlanarConfiguration 2,
big-endian ("MM") files, BigTIFF, Predictor 2 (horizontal differencing)
and 3 (floating point), FillOrder 2 (every stored byte bit-reversed, as
libtiff reverses the raw strip before decoding it), associated alpha,
16-bit colour maps, every bit depth at either photometric; LZW by the
port's encoder (core/tiff.lzw_encode, whose output PIL decodes to the
same pixels: PIL and the JAX read_ldr decide what is right), Deflate by
zlib, PackBits by its own encoder.
GIFs: global and local colour tables, interlaced rows, a first frame
smaller than the screen at an offset, a graphic control extension with
a transparent index. ICOs: directories of PNG and BMP (DIB) payloads at
1, 4, 8, 24 and 32 bits a pixel with their AND masks.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tracerboy_tpu_torch.core.tiff import lzw_encode

# Tag numbers.
WIDTH, LENGTH, BPS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILLORDER, STRIPOFFSETS, SPP, ROWSPERSTRIP, STRIPBYTECOUNTS = (266, 273, 277,
                                                                278, 279)
PLANAR, PREDICTOR, COLORMAP = 284, 317, 320
TILEWIDTH, TILELENGTH, TILEOFFSETS, TILEBYTECOUNTS = 322, 323, 324, 325
EXTRASAMPLES, SAMPLEFORMAT = 338, 339
SHORT, LONG, LONG8 = 3, 4, 16
_TYPE_FMT = {SHORT: "H", LONG: "L", LONG8: "Q"}

_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


# ----------------------------------------------------------------------------
# Compressors


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (1 - n, byte), literal runs
    of up to 128 bytes as (n - 1, bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += struct.pack("b", i - j) + data[i:i + 1]
            i = j + 1
            continue
        j = i
        while (j + 1 < n and j - i < 127
               and not (j + 2 < n and data[j + 1] == data[j + 2])):
            j += 1
        out.append(j - i)
        out += data[i:j + 1]
        i = j + 1
    return bytes(out)


def compress(data: bytes, compression: int) -> bytes:
    if compression == 1:
        return data
    if compression == 5:
        return lzw_encode(data)
    if compression in (8, 32946):
        return zlib.compress(data, 6)
    if compression == 32773:
        return packbits(data)
    raise ValueError(f"no encoder for compression {compression}")


# ----------------------------------------------------------------------------
# TIFF


def pack_rows(samples: np.ndarray, bits: int, endian: str) -> np.ndarray:
    """(rows, n) sample values as (rows, rowbytes) uint8: bits < 8 and 12
    packed MSB first, each row padded to a byte; 16 and 32 bits in `endian`
    ("<" or ">"; float32 samples as IEEE floats)."""
    rows, n = samples.shape
    if bits == 12:
        shifts = np.arange(bits - 1, -1, -1, dtype=np.uint16)
        v = ((samples.astype(np.uint16)[..., None] >> shifts) & 1).astype(
            np.uint8).reshape(rows, n * bits)
        return np.packbits(v, axis=1)
    if bits < 8:
        per = 8 // bits
        padded = np.zeros((rows, -(-n // per) * per), np.uint8)
        padded[:, :n] = samples
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        return (padded.reshape(rows, -1, per) << shifts).sum(
            -1, dtype=np.uint8)
    if bits == 8:
        return samples.astype(np.uint8)
    kind = "f" if samples.dtype.kind == "f" else "u"
    typed = samples.astype(f"{endian}{kind}{bits // 8}")
    return np.ascontiguousarray(typed).view(np.uint8).reshape(rows, -1)


def predict(samples: np.ndarray, bits: int, stride: int) -> np.ndarray:
    """Predictor 2 on (rows, n) integer samples: each sample minus the one
    `stride` before it in its row, modulo 2**bits."""
    s = samples.astype(np.int64)
    d = s.copy()
    d[:, stride:] = s[:, stride:] - s[:, :-stride]
    return (d % (1 << bits)).astype(samples.dtype)


def predict_float(samples: np.ndarray, stride: int) -> np.ndarray:
    """Predictor 3 on (rows, n) float32 samples: each row's bytes in
    planes, most significant byte first, then each byte minus the one
    `stride` before it. Returns (rows, 4 n) uint8 (byte order free)."""
    rows, n = samples.shape
    be = samples.astype(">f4").view(np.uint8).reshape(rows, n, 4)
    planes = be.transpose(0, 2, 1).reshape(rows, 4 * n).astype(np.int64)
    d = planes.copy()
    d[:, stride:] = planes[:, stride:] - planes[:, :-stride]
    return (d % 256).astype(np.uint8)


def _entry(tag, typ, values, endian):
    values = list(values) if isinstance(values, (list, tuple)) else [values]
    return tag, typ, struct.pack(f"{endian}{len(values)}{_TYPE_FMT[typ]}",
                                 *values), len(values)


def tiff_file(samples: np.ndarray, *, bits: int, photometric: int,
              order: str = "II", bigtiff: bool = False,
              sample_format: int = 1, extra: tuple = (),
              compression: int = 1, predictor: int = 1, tile=None,
              rows_per_strip: int | None = None, planar: int = 1,
              fill_order: int = 1, colormap: np.ndarray | None = None,
              truncate: int = 0, ifd_first: bool = False, drop=(),
              tags=()) -> bytes:
    """One IFD over (H, W, S) samples (or (H, W)): strips of
    `rows_per_strip` rows (default all) or `tile` = (tw, th) tiles, each
    compressed alone; colormap (3, 2**bits) uint16; truncate drops that many bytes off the end of the last strip or tile; the IFD
    goes after the data, or before it with ifd_first (so cutting the
    file cuts the data); `drop` lists tags to leave out and `tags` adds
    (tag, type, values) entries."""
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    endian = "<" if order == "II" else ">"
    planes = ([samples[..., c:c + 1] for c in range(spp)] if planar == 2
              else [samples])
    chunks = []
    if tile is None:
        rps = rows_per_strip or h
        regions = [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)]
    else:
        tw, th = tile
        regions = [(x, y, tw, th) for y in range(0, h, th)
                   for x in range(0, w, tw)]
    for plane in planes:
        c = plane.shape[2]
        for x, y, rw, rh in regions:
            block = np.zeros((rh, rw, c), plane.dtype)
            part = plane[y:y + rh, x:x + rw]
            block[:part.shape[0], :part.shape[1]] = part
            flat = block.reshape(rh, rw * c)
            if predictor == 2:
                raw = pack_rows(predict(flat, bits, c), bits, endian)
            elif predictor == 3:
                raw = predict_float(flat, c)
            else:
                raw = pack_rows(flat, bits, endian)
            data = compress(raw.tobytes(), compression)
            if fill_order == 2:
                data = _REVERSE[np.frombuffer(data, np.uint8)].tobytes()
            chunks.append(data)
    if truncate:
        chunks[-1] = chunks[-1][:-truncate]
    head = 16 if bigtiff else 8
    off_type = LONG8 if bigtiff else LONG

    def entries(offsets):
        out = [
            (WIDTH, LONG, w), (LENGTH, LONG, h),
            (BPS, SHORT, [bits] * spp), (COMPRESSION, SHORT, compression),
            (PLANAR, SHORT, planar), (SPP, SHORT, spp),
            (PHOTOMETRIC, SHORT, photometric),
        ]
        if fill_order != 1:
            out.append((FILLORDER, SHORT, fill_order))
        if tile is None:
            out += [(STRIPOFFSETS, off_type, offsets),
                    (ROWSPERSTRIP, LONG, rows_per_strip or h),
                    (STRIPBYTECOUNTS, off_type, [len(c) for c in chunks])]
        else:
            out += [(TILEWIDTH, LONG, tile[0]), (TILELENGTH, LONG, tile[1]),
                    (TILEOFFSETS, off_type, offsets),
                    (TILEBYTECOUNTS, off_type, [len(c) for c in chunks])]
        if predictor != 1:
            out.append((PREDICTOR, SHORT, predictor))
        if colormap is not None:
            out.append((COLORMAP, SHORT, [int(v) for v in
                                          np.asarray(colormap).reshape(-1)]))
        if extra:
            out.append((EXTRASAMPLES, SHORT, list(extra)))
        if sample_format != 1:
            out.append((SAMPLEFORMAT, SHORT, [sample_format] * spp))
        out = [e for e in out if e[0] not in drop] + list(tags)
        return sorted(_entry(t, typ, v, endian) for t, typ, v in out)

    def ifd_bytes(ifd_pos, offsets):
        inline = 8 if bigtiff else 4
        count_fmt, entry_fmt = ("Q", "HHQ") if bigtiff else ("H", "HHL")
        ents = entries(offsets)
        size = (8 if bigtiff else 2) + len(ents) * (20 if bigtiff else 12) \
            + (8 if bigtiff else 4)
        ifd = struct.pack(f"{endian}{count_fmt}", len(ents))
        far = b""
        for tag, typ, payload, count in ents:
            ifd += struct.pack(f"{endian}{entry_fmt}", tag, typ, count)
            if len(payload) <= inline:
                ifd += payload.ljust(inline, b"\0")
            else:
                ifd += struct.pack(f"{endian}{'Q' if bigtiff else 'L'}",
                                   ifd_pos + size + len(far))
                far += payload + b"\0" * (len(payload) % 2)
        return ifd + bytes(8 if bigtiff else 4) + far

    def place(start):
        offsets, pos = [], start
        for data in chunks:
            offsets.append(pos)
            pos += len(data)
        return offsets, pos

    if ifd_first:
        ifd_pos = head
        size = len(ifd_bytes(ifd_pos, [0] * len(chunks)))
        offsets, _ = place(ifd_pos + size)
        tail = ifd_bytes(ifd_pos, offsets) + b"".join(chunks)
    else:
        offsets, pos = place(head)
        ifd_pos = pos + pos % 2
        tail = b"".join(chunks) + bytes(ifd_pos - pos) + ifd_bytes(
            ifd_pos, offsets)
    if bigtiff:
        header = order.encode() + struct.pack(f"{endian}HHHQ", 43, 8, 0,
                                              ifd_pos)
    else:
        header = order.encode() + struct.pack(f"{endian}HL", 42, ifd_pos)
    return header + tail


# ----------------------------------------------------------------------------
# GIF


def lzw_gif(indices: bytes, min_bits: int) -> bytes:
    """GIF LZW: codes LSB first from min_bits + 1 bits, a clear code
    first, the width raised once the next free code passes the current
    width's range, a clear code when the table is full, the end code
    last."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    out = bytearray()
    acc = nacc = 0

    def put(code, width):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        return {bytes((i,)): i for i in range(clear)}, clear + 2, min_bits + 1

    table, nxt, width = reset()
    put(clear, width)
    cur = b""
    for b in indices:
        s = cur + bytes((b,))
        if s in table:
            cur = s
            continue
        put(table[cur], width)
        if nxt < 4096:
            table[s] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            put(clear, width)
            table, nxt, width = reset()
        cur = bytes((b,))
    if cur:
        put(table[cur], width)
    put(end, width)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    return b"".join(bytes((len(data[i:i + size]),)) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def interlace_order(h: int) -> list:
    return [*range(0, h, 8), *range(4, h, 8), *range(2, h, 4),
            *range(1, h, 2)]


def gif_file(indices: np.ndarray, *, screen=None, offset=(0, 0),
             global_table: np.ndarray | None = None,
             local_table: np.ndarray | None = None, interlace=False,
             transparency: int | None = None, min_bits: int | None = None,
             truncate: int = 0) -> bytes:
    """A one-frame GIF of (h, w) colour indices at `offset` on a screen
    of `screen` = (W, H) (default the frame's size). Tables are (2**n, 3)
    uint8; a graphic control extension carries `transparency`."""
    h, w = indices.shape
    sw, sh = screen or (w, h)
    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    if global_table is not None:
        n = int(np.log2(len(global_table)))
        out += bytes((0x80 | 0x70 | (n - 1), 0, 0))
        out += global_table.astype(np.uint8).tobytes()
    else:
        out += bytes((0x70, 0, 0))
    if transparency is not None:
        out += b"!\xf9\x04" + bytes((1, 0, 0, transparency)) + b"\0"
    flags = 0x40 if interlace else 0
    if local_table is not None:
        n = int(np.log2(len(local_table)))
        flags |= 0x80 | (n - 1)
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, flags)
    if local_table is not None:
        out += local_table.astype(np.uint8).tobytes()
    if min_bits is None:
        top = max(int(indices.max()), 1)
        min_bits = max(2, top.bit_length())
    rows = indices[interlace_order(h)] if interlace else indices
    data = lzw_gif(rows.astype(np.uint8).tobytes(), min_bits)
    out += bytes((min_bits,)) + sub_blocks(data) + b";"
    return bytes(out[:len(out) - truncate] if truncate else out)


# ----------------------------------------------------------------------------
# ICO


def dib(pixels: np.ndarray, bits: int, palette: np.ndarray | None = None,
        mask: np.ndarray | None = None) -> bytes:
    """An ICO's BMP payload: a 40-byte BITMAPINFOHEADER with the doubled
    height, the palette (BGRX), the bottom-up XOR rows (indices at 1, 4
    and 8 bits, BGR at 24, BGRA at 32) and, below 32 bits, the AND mask
    (1: transparent), each row padded to 4 bytes."""
    h, w = pixels.shape[:2]
    colors = 0 if palette is None else len(palette)
    header = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                         colors, 0)
    pal = b""
    if palette is not None:
        pal = np.concatenate([palette[:, ::-1],
                              np.zeros((colors, 1), np.uint8)],
                             1).astype(np.uint8).tobytes()
    stride = ((w * bits + 31) >> 3) & ~3
    if bits >= 24:
        raw = pixels[..., [2, 1, 0, 3][:bits // 8]].astype(np.uint8).reshape(
            h, -1)
    else:
        raw = pack_rows(pixels.reshape(h, w), bits, "<")
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :raw.shape[1]] = raw
    out = header + pal + rows[::-1].tobytes()
    if bits < 32:
        m = np.zeros((h, w), np.uint8) if mask is None else mask
        mstride = ((w + 31) >> 3) & ~3
        mrows = np.zeros((h, mstride), np.uint8)
        packed = pack_rows(m, 1, "<")
        mrows[:, :packed.shape[1]] = packed
        out += mrows[::-1].tobytes()
    return out


def ico_file(entries) -> bytes:
    """An ICO of (width, height, bits, payload) entries, in that order
    (a width or height of 256 written as 0)."""
    out = struct.pack("<HHH", 0, 1, len(entries))
    pos = 6 + 16 * len(entries)
    body = b""
    for w, h, bits, payload in entries:
        colors = (1 << bits) if bits < 8 else 0
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colors % 256, 0, 1,
                           bits, len(payload), pos + len(body))
        body += payload
    return out + body
