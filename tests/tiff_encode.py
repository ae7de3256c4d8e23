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
zlib, PackBits by its own encoder, LZMA by the standard library's lzma
(.xz), Zstandard by the libzstd that Pillow's wheel carries (ctypes) or
by zstd_frame, a writer of raw and RLE blocks.
The layouts of GDAL's and the fax tools' writers: JPEG-in-TIFF from
PIL's JPEG encoder (jpeg_tiff: strips or tiles, 4:4:4, 4:2:2, 4:2:0,
each segment a whole datastream or an abbreviated one after a
JPEGTables stream), subsampled YCbCr blocks (ycbcr_segment), old-style
LZW (lzw_compat), ThunderScan (thunderscan) and modified Huffman rows
(mh_rows, byte- or word-aligned).
GIFs: global and local colour tables, interlaced rows, a first frame
smaller than the screen at an offset, a graphic control extension with
a transparent index. ICOs: directories of PNG and BMP (DIB) payloads at
1, 4, 8, 24 and 32 bits a pixel with their AND masks.
"""

from __future__ import annotations

import lzma
import os
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
SHORT, LONG, RATIONAL, LONG8 = 3, 4, 5, 16
UNDEFINED, FLOAT = 7, 11
_TYPE_FMT = {SHORT: "H", LONG: "L", RATIONAL: "L", LONG8: "Q",
             UNDEFINED: "B", FLOAT: "f"}

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
    if compression == 34925:
        return lzma.compress(data, format=lzma.FORMAT_XZ)
    if compression == 50000:
        return zstd_compress(data)
    raise ValueError(f"no encoder for compression {compression}")


_zstd = None


def zstd_compress(data: bytes, level: int = 3, checksum: bool = False,
                  content_size: bool = True) -> bytes:
    """A Zstandard frame by the libzstd of Pillow's wheel (ctypes)."""
    global _zstd
    if _zstd is None:
        import ctypes
        import glob

        import PIL

        libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
            PIL.__file__)), "pillow.libs", "libzstd*"))
        if not libs:
            raise RuntimeError("no libzstd beside PIL")
        lib = ctypes.CDLL(libs[0])
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_int]
        lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_size_t, ctypes.c_void_p,
                                       ctypes.c_size_t]
        lib.ZSTD_compress2.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        _zstd = lib
    import ctypes

    cctx = _zstd.ZSTD_createCCtx()
    try:
        for param, value in ((100, level), (200, int(content_size)),
                             (201, int(checksum))):
            _zstd.ZSTD_CCtx_setParameter(cctx, param, value)
        out = ctypes.create_string_buffer(2 * len(data) + 1024)
        n = _zstd.ZSTD_compress2(cctx, out, len(out), data, len(data))
        if _zstd.ZSTD_isError(n):
            raise RuntimeError("ZSTD_compress2 failed")
        return out.raw[:n]
    finally:
        _zstd.ZSTD_freeCCtx(cctx)


_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5, _M64 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5, (1 << 64) - 1


def xxh64(data: bytes) -> int:
    """XXH64 with seed 0 (a Zstandard frame's content checksum is its low
    32 bits)."""
    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & _M64

    def rnd(acc, lane):
        return rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64

    n, i = len(data), 0
    if n >= 32:
        v = [(_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64]
        while i + 32 <= n:
            for k in range(4):
                v[k] = rnd(v[k], int.from_bytes(data[i + 8 * k:i + 8 * k + 8],
                                                "little"))
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12)
             + rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ rnd(0, x)) * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= rnd(0, int.from_bytes(data[i:i + 8], "little"))
        h = (rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= int.from_bytes(data[i:i + 4], "little") * _P1 & _M64
        h = (rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= data[i] * _P5 & _M64
        h = rotl(h, 11) * _P1 & _M64
        i += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


def zstd_frame(data: bytes, block: int = 1000, rle: bool = True,
               checksum: bool = True, dict_id: int = 0,
               content_size: bool = True) -> bytes:
    """A Zstandard frame of raw blocks of `block` bytes, a run of one byte
    value as an RLE block (rle), with the content size, the XXH64
    checksum and a dictionary ID as asked."""
    did = (0 if not dict_id else 1 if dict_id < 256 else 2
           if dict_id < 65536 else 3)
    fcs = 3 if content_size else 0
    out = bytearray(struct.pack("<I", 0xFD2FB528))
    out.append(fcs << 6 | int(checksum) << 2 | did)
    out.append(17 << 3)                  # window 2^27
    out += dict_id.to_bytes({0: 0, 1: 1, 2: 2, 3: 4}[did], "little")
    if content_size:
        out += struct.pack("<Q", len(data))
    pos = 0
    while True:
        chunk = data[pos:pos + block]
        last = pos + block >= len(data)
        if rle and chunk and chunk == chunk[:1] * len(chunk):
            out += struct.pack("<I", (len(chunk) << 3) | 2 | last)[:3]
            out += chunk[:1]
        else:
            out += struct.pack("<I", (len(chunk) << 3) | last)[:3] + chunk
        pos += block
        if last:
            break
    if checksum:
        out += struct.pack("<I", xxh64(data) & 0xFFFFFFFF)
    return bytes(out)


def lzw_compat(data: bytes) -> bytes:
    """Old-style TIFF LZW (4.2BSD compress's codes): a clear code first,
    codes LSB first, the width raised once the next free code passes 2^n
    (no early change), a clear code when the table is full, the end code
    last. The leading clear code makes the stream start 0x00 with the
    low bit of the second byte set, which is how libtiff tells it."""
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

    width, table, nxt = 9, {}, 258
    put(256, width)
    prefix = None
    for b in data:
        key = (prefix, b)
        if prefix is not None and key in table:
            prefix = table[key]
            continue
        if prefix is not None:
            put(prefix, width)
            table[key] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
            if nxt >= 4093:
                put(256, width)
                table, nxt, width = {}, 258, 9
        prefix = b
    if prefix is not None:
        put(prefix, width)
    put(257, width)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def thunderscan(pixels: np.ndarray, seed: int = 0) -> bytes:
    """ThunderScan 4-bit rows (pixels (H, W) in 0-15): each pixel as a raw
    code, a 2-bit or 3-bit delta pair or triple, or a run of the last
    pixel that ends before the row's end (libtiff writes no other), chosen
    at random so every code appears."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    for row in pixels:
        last, i, w = 0, 0, len(row)
        while i < w:
            v = int(row[i])
            run = 0
            while i + run < w and int(row[i + run]) == last and run < 63:
                run += 1
            choice = rng.integers(0, 4)
            if run >= 2 and choice == 0 and i + run < w:
                out.append(run)
                i += run
                continue
            d = [int(row[j]) for j in range(i, min(i + 3, w))]
            steps, prev = [], last
            for x in d:
                steps.append(x - prev)
                prev = x
            if (choice == 1 and len(steps) == 3
                    and all(s in two for s in steps)):
                out.append(0x40 | two[steps[0]] << 4 | two[steps[1]] << 2
                           | two[steps[2]])
                i, last = i + 3, d[2]
                continue
            if (choice == 2 and len(steps) >= 2
                    and all(s in three for s in steps[:2])):
                out.append(0x80 | three[steps[0]] << 3 | three[steps[1]])
                i, last = i + 2, d[1]
                continue
            out.append(0xC0 | v)
            i, last = i + 1, v
    return bytes(out)


# T.4 run-length codes: (bits as a string, run) for white and black.
_WHITE_TERM = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 "
               "00111 01000 001000 000011 110100 110101 101010 101011 "
               "0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
               "0101011 0010011 0100100 0011000 00000010 00000011 00011010 "
               "00011011 00010010 00010011 00010100 00010101 00010110 "
               "00010111 00101000 00101001 00101010 00101011 00101100 "
               "00101101 00000100 00000101 00001010 00001011 01010010 "
               "01010011 01010100 01010101 00100100 00100101 01011000 "
               "01011001 01011010 01011011 01001010 01001011 00110010 "
               "00110011 00110100").split()
_WHITE_MAKEUP = ("11011 10010 010111 0110111 00110110 00110111 01100100 "
                 "01100101 01101000 01100111 011001100 011001101 011010010 "
                 "011010011 011010100 011010101 011010110 011010111 "
                 "011011000 011011001 011011010 011011011 010011000 "
                 "010011001 010011010 011000 010011011").split()
_BLACK_TERM = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 "
               "0000100 0000101 0000111 00000100 00000111 000011000 "
               "0000010111 0000011000 0000001000 00001100111 00001101000 "
               "00001101100 00000110111 00000101000 00000010111 "
               "00000011000 000011001010 000011001011 000011001100 "
               "000011001101 000001101000 000001101001 000001101010 "
               "000001101011 000011010010 000011010011 000011010100 "
               "000011010101 000011010110 000011010111 000001101100 "
               "000001101101 000011011010 000011011011 000001010100 "
               "000001010101 000001010110 000001010111 000001100100 "
               "000001100101 000001010010 000001010011 000000100100 "
               "000000110111 000000111000 000000100111 000000101000 "
               "000001011000 000001011001 000000101011 000000101100 "
               "000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = ("0000001111 000011001000 000011001001 000001011011 "
                 "000000110011 000000110100 000000110101 0000001101100 "
                 "0000001101101 0000001001010 0000001001011 0000001001100 "
                 "0000001001101 0000001110010 0000001110011 0000001110100 "
                 "0000001110101 0000001110110 0000001110111 0000001010010 "
                 "0000001010011 0000001010100 0000001010101 0000001011010 "
                 "0000001011011 0000001100100 0000001100101").split()


def _mh_run(run: int, black: bool) -> str:
    term, makeup = ((_BLACK_TERM, _BLACK_MAKEUP) if black
                    else (_WHITE_TERM, _WHITE_MAKEUP))
    code = ""
    while run >= 64:
        m = min(run // 64, 27)
        code += makeup[m - 1]
        run -= 64 * m
    return code + term[run]


def mh_rows(bits: np.ndarray, word_align: bool = False) -> bytes:
    """Modified Huffman (compression 2, or 32771 with word_align): each
    row's runs (white first, 1 = black) as T.4 codes, the row padded to
    a byte (a 16-bit word)."""
    out = bytearray()
    for row in np.asarray(bits, bool):
        code, x, black = "", 0, False
        while x < len(row):
            r = 0
            while x + r < len(row) and bool(row[x + r]) == black:
                r += 1
            code += _mh_run(r, black)
            x += r
            black = not black
        if black is False and x == len(row) and code == "":
            code = _mh_run(0, False)
        align = 16 if word_align else 8
        code += "0" * (-len(code) % align)
        out += int(code, 2).to_bytes(len(code) // 8, "big") if code else b""
    return bytes(out)


def ycbcr_segment(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, h: int,
                  v: int) -> bytes:
    """A strip or tile of subsampled YCbCr as TIFF stores it: for each
    h x v block (rows of blocks, padded with zeros at the edges) its luma
    row by row, then one Cb and one Cr. y is (rows, width); cb and cr are
    (ceil(rows / v), ceil(width / h))."""
    rows, width = y.shape
    by, bx = -(-rows // v), -(-width // h)
    pad = np.zeros((by * v, bx * h), np.uint8)
    pad[:rows, :width] = y
    blocks = pad.reshape(by, v, bx, h).transpose(0, 2, 1, 3).reshape(
        by, bx, v * h)
    return np.concatenate([blocks, cb[..., None].astype(np.uint8),
                           cr[..., None].astype(np.uint8)], -1).tobytes()


def jpeg_stream(pixels: np.ndarray, quality: int, subsampling: int,
                keep_rgb: bool = False) -> bytes:
    """PIL's JPEG encoder on (H, W, 3) or (H, W) uint8."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", quality=quality,
                                 subsampling=subsampling, keep_rgb=keep_rgb)
    return buf.getvalue()


def split_tables(stream: bytes) -> tuple[bytes, bytes]:
    """A datastream as (tables-only stream, abbreviated stream): its DQT
    and DHT segments between SOI and EOI, and the stream without them."""
    tables, image = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    pos = 2
    while pos < len(stream):
        code = stream[pos + 1]
        n = struct.unpack_from(">H", stream, pos + 2)[0]
        seg = stream[pos:pos + 2 + n]
        (tables if code in (0xDB, 0xC4) else image).extend(seg)
        pos += 2 + n
        if code == 0xDA:
            image += stream[pos:]
            break
    return bytes(tables + b"\xff\xd9"), bytes(image)


def jpeg_tiff(pixels: np.ndarray, *, photometric: int, quality: int = 90,
              subsampling: int = 2, tile=None, rows_per_strip=None,
              tables: bool = True, keep_rgb: bool = False,
              sampling_tag: bool = True, full_last_strip: bool = False,
              **kw) -> bytes:
    """A JPEG-compressed TIFF (compression 7) of (H, W, 3) or (H, W)
    pixels: each strip or tile (edge tiles padded by replication, the
    last strip as many rows as are left unless full_last_strip) a JPEG
    from PIL's encoder; with `tables`, their DQT and DHT moved into one
    JPEGTables (every segment's tables the same, as PIL's encoder writes
    them for one quality); photometric 6 carries YCbCrSubsampling (h, v)
    of the encoder's luma unless sampling_tag is false."""
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    hgt, wid, spp = pixels.shape
    if tile is None:
        rps = rows_per_strip or hgt
        regions = [(0, y, wid, rps if full_last_strip else min(rps, hgt - y))
                   for y in range(0, hgt, rps)]
    else:
        regions = [(x, y, tile[0], tile[1]) for y in range(0, hgt, tile[1])
                   for x in range(0, wid, tile[0])]
    segments, table = [], None
    for x, y, rw, rh in regions:
        block = np.pad(pixels[y:y + rh, x:x + rw],
                       ((0, max(0, y + rh - hgt)), (0, max(0, x + rw - wid)),
                        (0, 0)), mode="edge")
        stream = jpeg_stream(block[..., 0] if spp == 1 else block, quality,
                             subsampling, keep_rgb)
        if tables:
            table, stream = split_tables(stream)
        segments.append(stream)
    extra_tags = list(kw.pop("tags", ()))
    if table is not None:
        extra_tags.append((347, UNDEFINED, list(table)))
    if photometric == 6 and sampling_tag:
        extra_tags.append((530, SHORT, [{0: 1, 1: 2, 2: 2}[subsampling],
                                        {0: 1, 1: 1, 2: 2}[subsampling]]))
    return tiff_file(pixels, bits=8, photometric=photometric, compression=7,
                     tile=tile, rows_per_strip=rows_per_strip,
                     segments=segments, tags=extra_tags, **kw)


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
    count = len(values) // 2 if typ == RATIONAL else len(values)
    return tag, typ, struct.pack(f"{endian}{len(values)}{_TYPE_FMT[typ]}",
                                 *values), count


def tiff_file(samples: np.ndarray, *, bits: int, photometric: int,
              order: str = "II", bigtiff: bool = False,
              sample_format: int = 1, extra: tuple = (),
              compression: int = 1, predictor: int = 1, tile=None,
              rows_per_strip: int | None = None, planar: int = 1,
              fill_order: int = 1, colormap: np.ndarray | None = None,
              truncate: int = 0, ifd_first: bool = False, drop=(),
              tags=(), segments=None) -> bytes:
    """One IFD over (H, W, S) samples (or (H, W)): strips of
    `rows_per_strip` rows (default all) or `tile` = (tw, th) tiles, each
    compressed alone; colormap (3, 2**bits) uint16; truncate drops that
    many bytes off the end of the last strip or tile; the IFD goes after
    the data, or before it with ifd_first (so cutting the file cuts the
    data); `drop` lists tags to leave out and `tags` adds (tag, type,
    values) entries (RATIONAL values as numerator, denominator pairs).
    segments: the stored bytes of every strip or tile, as given (samples
    then only give the image's shape)."""
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
    for plane in planes if segments is None else ():
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
    if segments is not None:
        chunks = [bytes(c) for c in segments]
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
