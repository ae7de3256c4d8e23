"""The port's TIFF reader: the pixels PIL returns for a TIFF file (Pillow
12.1's TiffImagePlugin, which reads uncompressed files itself and hands
every other compression to libtiff 4.7), bit for bit, without an
imaging library; and write_tiff, the writer of the demo scenes' TIFF
textures.

TracerBoy loads its textures through WIC, whose codecs include TIFF;
GDAL's GeoTIFF and COG writers add JPEG (YCbCr), Zstandard, LZMA and
CCITT. The header and the first IFD (PIL's frame 0) are parsed here,
with PIL's rules: OPEN_INFO maps (byte order, photometric, sample
format, fill order, bits, extra samples) to PIL's mode and raw mode,
exactly as TiffImagePlugin.OPEN_INFO does. The byte-serial loops are
C++: LZW (new- and old-style), PackBits and the predictors in
csrc/lzw_codecs.cpp; Zstandard, CCITT, ThunderScan, libtiff's YCbCr
conversion and Pillow's CIELab conversion in csrc/tiff_codecs.cpp; JPEG
in core/jpeg.py and csrc/jpeg_decode.cpp (all g++ at first use,
ctypes). Deflate is zlib's and LZMA the standard library's lzma (the
.xz container libtiff's lzma_stream_decoder reads).

Two decoders, as in PIL:
- Uncompressed files: PIL's raw decoder over its tile list. Strip and
  tile byte counts are ignored (rows are read from each offset), the
  predictor is ignored, FillOrder 2 is the raw mode's bit reversal, and
  with PlanarConfiguration 2 each plane is read with one letter of the
  raw mode (so 16-bit planes are read as 8-bit ones, and a raw mode
  whose letter has no unpacker is refused), as PIL does. YCbCr is read
  with its raw mode RGBX, 4 bytes a pixel, without conversion.
- Every compression: libtiff's decode of each strip or tile (byte counts
  honoured, or estimated as libtiff's EstimateStripByteCounts does for
  a single strip, or one a plane; the raw bytes bit-reversed for
  FillOrder 2; Predictor 2 and 3 undone for LZW, Deflate, LZMA and
  Zstandard; 16- and 32-bit samples swapped to native little-endian
  order), then PIL's unpacker of the raw mode with its libtiff fixes
  (";16B"/";16L" and "I;16" read as native; other big-endian raw modes
  read the native samples as big-endian, so a big-endian float file
  decodes to PIL's swapped values). PlanarConfiguration 2 with several
  bands copies plane i into byte i of PIL's 4-byte pixel (so an LA file
  loses its alpha; RGBA with associated or unspecified alpha is then
  unpremultiplied), and a strip's row must be the unpacker's row in
  size, as Pillow's TiffDecode.c checks. Per compression:
  - JPEG (7): each strip or tile a datastream after the JPEGTables
    tables, its size, component count and sampling factors checked as
    tif_jpeg.c's JPEGPreDecode checks them; YCbCr in one plane decoded
    to RGB (Pillow's JPEGCOLORMODE_RGB, raw mode RGB), any other
    photometric with no colour transform at all, whatever the markers
    say; the YCbCrSubsampling a stream must match is the tag's, or
    without the tag the first strip's (JPEGFixupTagsSubsampling);
  - YCbCr under any other compression: libtiff's TIFFRGBAImage, as
    Pillow's _decodeAsRGBA calls it (one strip or row of tiles a call,
    the read errors of a decode ignored: the part decoded before the
    error, zeros after it);
  - CCITT modified Huffman (2), Group 3 (3: T4Options 1D or 2D, fill
    bits) and Group 4 (4): tif_fax3.c, bad codes and short rows padded
    as libtiff pads them; a Group 4 strip that ends early keeps its
    decoded rows, the rest zero bits;
  - ThunderScan (32809, 4-bit), Zstandard (50000), LZMA (34925).
Orientation 2-8 transposes the image, as PIL's exif_transpose does.

read_ldr's conversion follows PIL's convert to RGB or RGBA: "1", L and
P (through the colour map's high bytes) to RGB; I;16 clipped at 255;
I clipped to 0-255; F with NaN as 0, clipped, truncated; CMYK by
Convert.c's cmyk2rgb; LA and PA to RGBA; associated alpha (RGBa)
unpremultiplied by the unpacker, v * 255 // a; LAB (CIELab, a and b
signed) to RGBA through littleCMS's Lab to sRGB transform, alpha 255.

Refused:
- what PIL refuses, with PIL's error: ValueError where PIL raises
  OSError or ValueError (a truncated strip, a broken stream, an
  unsupported predictor, a planar raw mode without an unpacker,
  WebP-compressed data, which this libtiff is built without, and SGI
  LogLuv, whose decoder refuses every photometric PIL opens),
  NotImplementedError where PIL cannot identify the file (an unknown
  compression or mode key, a missing dimension or data organisation, a
  big-endian BigTIFF, which PIL reads as a classic header);
- the layouts PIL reads but this port leaves out, NotImplementedError
  naming ROADMAP.md Queue 1 item 22c: old-style JPEG (6), JPEG in
  planes, a JPEG stream smaller than its strip or tile, libjpeg's
  recovery from damaged entropy-coded data, YCbCr or CIELab in planes,
  tiled ThunderScan, the palette with an extra sample in planar tiles,
  tags of non-integer types; and the files whose pixels libtiff leaves
  to memory it never wrote (a Group 3 or 4 strip that ends before its
  last row, a ThunderScan run that ends a row, a damaged YCbCr tile
  after the first of its row) or fails by a rule not ported (a 2D
  Group 3 strip that ends early).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tracerboy_tpu_torch.core.codecs import library, tiff_library
from tracerboy_tpu_torch.core.image_io import UnidentifiedImageError

II, MM = b"II", b"MM"
TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                 b"MM\x00\x2b", b"II\x2b\x00")
ITEM = ("ROADMAP.md, Queue 1: item 22c, the TIFF layouts texture tools do "
        "not write")

# (byte order, photometric, sample format, fill order, bits, extra
# samples) -> (PIL mode, PIL raw mode): TiffImagePlugin.OPEN_INFO.
OPEN_INFO = {}
for _o in (II, MM):
    for _pm, _fo, _bits, _mode, _raw in (
            (0, 1, 1, "1", "1;I"), (0, 2, 1, "1", "1;IR"),
            (1, 1, 1, "1", "1"), (1, 2, 1, "1", "1;R"),
            (0, 1, 2, "L", "L;2I"), (0, 2, 2, "L", "L;2IR"),
            (1, 1, 2, "L", "L;2"), (1, 2, 2, "L", "L;2R"),
            (0, 1, 4, "L", "L;4I"), (0, 2, 4, "L", "L;4IR"),
            (1, 1, 4, "L", "L;4"), (1, 2, 4, "L", "L;4R"),
            (0, 1, 8, "L", "L;I"), (0, 2, 8, "L", "L;IR"),
            (1, 1, 8, "L", "L"), (1, 2, 8, "L", "L;R"),
            (3, 1, 1, "P", "P;1"), (3, 2, 1, "P", "P;1R"),
            (3, 1, 2, "P", "P;2"), (3, 2, 2, "P", "P;2R"),
            (3, 1, 4, "P", "P;4"), (3, 2, 4, "P", "P;4R"),
            (3, 1, 8, "P", "P"), (3, 2, 8, "P", "P;R"),
            (6, 1, 8, "L", "L")):
        OPEN_INFO[(_o, _pm, (1,), _fo, (_bits,), ())] = (_mode, _raw)
    OPEN_INFO[(_o, 1, (2,), 1, (8,), ())] = ("L", "L")
    OPEN_INFO[(_o, 1, (1,), 1, (8, 8), (2,))] = ("LA", "LA")
    for _fo, _raw in ((1, "RGB"), (2, "RGB;R")):
        OPEN_INFO[(_o, 2, (1,), _fo, (8, 8, 8), ())] = ("RGB", _raw)
    for _extra, _mode, _raw in (
            ((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"),
            ((0, 0), "RGB", "RGBXX"), ((0, 0, 0), "RGB", "RGBXXX"),
            ((1,), "RGBA", "RGBa"), ((1, 0), "RGBA", "RGBaX"),
            ((1, 0, 0), "RGBA", "RGBaXX"), ((2,), "RGBA", "RGBA"),
            ((2, 0), "RGBA", "RGBAX"), ((2, 0, 0), "RGBA", "RGBAXX"),
            ((999,), "RGBA", "RGBA")):
        _n = 3 + max(len(_extra), 1)
        OPEN_INFO[(_o, 2, (1,), 1, (8,) * _n, _extra)] = (_mode, _raw)
    _e = "L" if _o == II else "B"
    for _extra, _mode, _raw in (
            ((), "RGB", "RGB"), ((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"),
            ((1,), "RGBA", "RGBa"), ((2,), "RGBA", "RGBA")):
        _n = len(_raw) if _raw != "RGB" else 3
        OPEN_INFO[(_o, 2, (1,), 1, (16,) * _n, _extra)] = (
            _mode, f"{_raw};16{_e}")
    OPEN_INFO[(_o, 3, (1,), 1, (8, 8), (0,))] = ("P", "PX")
    OPEN_INFO[(_o, 3, (1,), 1, (8, 8), (2,))] = ("PA", "PA")
    OPEN_INFO[(_o, 5, (1,), 1, (8,) * 4, ())] = ("CMYK", "CMYK")
    OPEN_INFO[(_o, 5, (1,), 1, (8,) * 5, (0,))] = ("CMYK", "CMYKX")
    OPEN_INFO[(_o, 5, (1,), 1, (8,) * 6, (0, 0))] = ("CMYK", "CMYKXX")
    OPEN_INFO[(_o, 5, (1,), 1, (16,) * 4, ())] = ("CMYK", f"CMYK;16{_e}")
    OPEN_INFO[(_o, 6, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGBX")
    OPEN_INFO[(_o, 8, (1,), 1, (8, 8, 8), ())] = ("LAB", "LAB")
    OPEN_INFO[(_o, 1, (2,), 1, (16,), ())] = (
        "I", "I;16S" if _o == II else "I;16BS")
    OPEN_INFO[(_o, 0, (3,), 1, (32,), ())] = (
        "F", "F;32F" if _o == II else "F;32BF")
    OPEN_INFO[(_o, 1, (3,), 1, (32,), ())] = (
        "F", "F;32F" if _o == II else "F;32BF")
OPEN_INFO.update({
    (II, 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    (II, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (II, 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (MM, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    (II, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (II, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
    (II, 1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (MM, 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
})
MAX_SAMPLESPERPIXEL = max(len(k[4]) for k in OPEN_INFO)

# PIL's COMPRESSION_INFO codes: those this port reads, those PIL opens
# but libtiff here fails to decode (with libtiff's message), and those
# left out.
COMPRESSIONS = {1: "raw", 2: "ccitt_rle", 3: "group3", 4: "group4",
                5: "lzw", 7: "jpeg", 8: "deflate", 32946: "deflate",
                32771: "ccitt_rlew", 32773: "packbits",
                32809: "thunderscan", 34925: "lzma", 50000: "zstd"}
FAILS_IN_LIBTIFF = {
    34676: "LogLuvSetupDecode: Inappropriate photometric interpretation "
           "for SGILog compression",
    34677: "LogLuvSetupDecode: Inappropriate photometric interpretation "
           "for SGILog compression",
    50001: "WEBP compression support is not configured"}
LEFT_OUT = {6: "old-style JPEG"}
# Compressions whose codec carries libtiff's predictor.
_PREDICTED = {"lzw", "deflate", "lzma", "zstd"}
_FAX = {"ccitt_rle": 2, "ccitt_rlew": 32771, "group3": 3, "group4": 4}

# IFD entry types: struct letter and unit size (PIL's _load_dispatch).
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("L", 4), 5: ("LL", 8),
          6: ("b", 1), 7: ("s", 1), 8: ("h", 2), 9: ("l", 4),
          10: ("ll", 8), 11: ("f", 4), 12: ("d", 8), 13: ("L", 4),
          16: ("Q", 8)}
_INT_TYPES = (3, 4, 6, 8, 9, 13, 16)
_FLOAT_TYPES = (5, 10, 11, 12)
# Tags whose PIL value is a single element (TiffTags length 1).
_SINGLE = {256, 257, 259, 262, 266, 274, 277, 278, 284, 292, 293, 317,
           322, 323}
# Orientation -> the numpy transpose of PIL's exif_transpose.
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
           6: lambda a: np.rot90(a, -1), 7: lambda a: np.rot90(a, 2).swapaxes(
               0, 1), 8: lambda a: np.rot90(a, 1)}
# Modes PIL stores in 4 bytes a pixel (LA as L, L, L, A; PA as P, -, -, A).
_SLOT_MODES = {"RGB", "RGBA", "CMYK", "LA", "PA", "LAB"}
_BITFLIP = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)

ROWS_PER_STRIP = 64      # write_tiff's strips


def is_tiff(data: bytes) -> bool:
    """PIL's _accept: one of the six TIFF prefixes."""
    return data[:4] in TIFF_PREFIXES


# ----------------------------------------------------------------------------
# The IFD


def read_ifd(data: bytes, path: str = "<tiff>"):
    """The first IFD as PIL reads it: (prefix, {tag: (type, values)}).
    BigTIFF only where byte 2 is 43 (PIL's test, so a big-endian BigTIFF
    reads as a classic header); an entry of an unknown type or count 0
    is skipped; an entry whose data lies past the end of the file ends
    the IFD (PIL's "Truncated File Read")."""
    prefix = data[:2]
    e = "<" if prefix == II else ">"
    big = len(data) > 2 and data[2] == 43
    try:
        first = struct.unpack_from(e + ("Q" if big else "L"), data,
                                   8 if big else 4)[0]
    except struct.error:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(truncated TIFF header)") from None
    if not first:
        raise ValueError(f"{path}: no more images in TIFF file (PIL raises "
                         "EOFError)")
    tags = {}
    pos = first
    try:
        (count,) = struct.unpack_from(e + ("Q" if big else "H"), data, pos)
        pos += 8 if big else 2
        for _ in range(count):
            tag, typ, n, field = struct.unpack_from(
                e + ("HHQ8s" if big else "HHL4s"), data, pos)
            pos += 20 if big else 12
            if typ not in _TYPES:
                continue
            letter, unit = _TYPES[typ]
            size = n * unit
            if size > len(field):
                (at,) = struct.unpack(e + ("Q" if big else "L"), field)
                raw = data[at:at + size]
                if len(raw) < size:
                    break                  # PIL: Truncated File Read
            else:
                raw = field[:size]
            if not raw:
                continue
            if typ in (1, 2, 7):           # bytes, as PIL keeps them
                values = (raw,)
            else:
                values = struct.unpack(e + letter * n, raw)
            tags[tag] = (typ, values)
    except struct.error:
        pass                               # PIL: Corrupt EXIF data
    return prefix, tags


def _float_tag(tags, tag, default, path="<tiff>"):
    """A tag libtiff reads as floats (YCbCrCoefficients,
    ReferenceBlackWhite): rationals as (float)(num / den), 0 for a zero
    denominator; integers as they are. float32 values."""
    if tag not in tags:
        return np.array(default, np.float32)
    typ, values = tags[tag]
    if typ in (5, 10):
        out = [np.float32(n / d) if d else np.float32(0)
               for n, d in zip(values[::2], values[1::2])]
    elif typ in _INT_TYPES or typ in (11, 12):
        out = [np.float32(v) for v in values]
    else:
        raise NotImplementedError(f"{path}: TIFF tag {tag} of type {typ} "
                                  f"({ITEM})")
    return np.array(out, np.float32)


def _tag(tags, tag, default=None, path="<tiff>"):
    """A tag's value as PIL's tag_v2 gives it: a single int for the
    single-element tags, else a tuple of ints."""
    if tag not in tags:
        return default
    typ, values = tags[tag]
    if typ not in _INT_TYPES:
        raise NotImplementedError(f"{path}: TIFF tag {tag} of type {typ} "
                                  f"({ITEM})")
    return values[0] if tag in _SINGLE else tuple(values)


# ----------------------------------------------------------------------------
# PIL's unpackers


def _raw_bits(rawmode: str) -> int:
    """Bits a pixel of a PIL raw mode."""
    if len(rawmode) == 1:
        return {"1": 1, "I": 32, "F": 32}.get(rawmode, 8)
    if rawmode.startswith(("1", "P;1")):
        return 1
    if rawmode.startswith(("L;2", "P;2")):
        return 2
    if rawmode.startswith(("L;4", "P;4")):
        return 4
    if rawmode == "I;12":
        return 12
    if rawmode.startswith("I;16"):
        return 16
    if rawmode.startswith(("I;32", "F;32")):
        return 32
    if ";16" in rawmode:
        return 16 * len(rawmode.split(";")[0])
    return 8 * len(rawmode.split(";")[0])


def _bits_msb(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    v = (rows[..., None] >> shifts) & ((1 << bits) - 1)
    return v.reshape(rows.shape[0], -1)[:, :width]


def _unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """PIL's RGBa unpacker: c * 255 // a (clipped), 0 where a is 0."""
    a = a.astype(np.int32)[..., None]
    v = rgb.astype(np.int32) * 255 // np.maximum(a, 1)
    return np.where(a == 0, 0, np.minimum(v, 255)).astype(np.uint8)


# Raw modes of one numeric band -> the numpy type PIL reads them as
# (I;16 modes keep uint16; I;32N is reinterpreted as int32, as PIL's
# mode I stores it).
_NUMERIC = {"I;16": "<u2", "I;16N": "<u2", "I;16L": "<u2", "I;16R": "<u2",
            "I;16B": ">u2", "I;16S": "<i2", "I;16BS": ">i2", "I;32N": "<i4",
            "I;32S": "<i4", "I;32BS": ">i4", "I": "<i4", "F;32F": "<f4",
            "F;32BF": ">f4", "F": "<f4"}


def unpack(rawmode: str, rows: np.ndarray, width: int):
    """PIL's unpacker for `rawmode` on (R, rowbytes) uint8 rows: returns
    (values, slots): values (R, width) for one-band modes (uint8, uint16
    for I;16, int32 for I, float32 for F) with slots None, or (R, width,
    k) uint8 for the 4-byte modes with the k slots they fill. ";16N"
    samples are little-endian (libtiff's native output here)."""
    r = rows.shape[0]
    if rawmode in ("P;1", "P;1R"):
        src = _BITFLIP[rows] if rawmode.endswith("R") else rows
        return _bits_msb(src, 1, width).astype(np.uint8), None
    if rawmode in ("1", "1;I", "1;R", "1;IR"):
        src = _BITFLIP[rows] if rawmode.endswith("R") else rows
        v = _bits_msb(src, 1, width)
        if "I" in rawmode:
            v = 1 - v
        return (v * 255).astype(np.uint8), None
    for bits in (2, 4):
        for pre in ("L", "P"):
            if rawmode.startswith(f"{pre};{bits}"):
                src = _BITFLIP[rows] if rawmode.endswith("R") else rows
                v = _bits_msb(src, bits, width)
                if pre == "P":
                    return v.astype(np.uint8), None
                if "I" in rawmode[3:]:
                    v = (1 << bits) - 1 - v
                return (v * (255 // ((1 << bits) - 1))).astype(
                    np.uint8), None
    if rawmode in ("L", "L;I", "L;R", "L;IR", "P", "P;R"):
        v = rows[:, :width]
        if rawmode.endswith("R"):
            v = _BITFLIP[v]
        if rawmode in ("L;I", "L;IR"):
            v = 255 - v
        return np.ascontiguousarray(v), None
    if rawmode == "I;12":
        b = rows.astype(np.uint16)
        n = (width + 1) // 2
        t = np.zeros((r, 3 * n), np.uint16)
        t[:, :b.shape[1]] = b[:, :3 * n]
        t = t.reshape(r, n, 3)
        v = np.stack([(t[..., 0] << 4) | (t[..., 1] >> 4),
                      ((t[..., 1] & 15) << 8) | t[..., 2]], -1)
        return v.reshape(r, -1)[:, :width].astype(np.uint16), None
    if rawmode in _NUMERIC:
        if rawmode == "I;16R":
            rows = _BITFLIP[rows]
        dt = np.dtype(_NUMERIC[rawmode])
        v = rows[:, :width * dt.itemsize].copy().view(dt).reshape(r, width)
        if dt.kind == "f":
            return v.astype(np.float32), None
        if dt.kind == "u":
            return v.astype(np.uint16), None
        return v.astype(np.int32), None
    if len(rawmode) == 1:                # one band of a planar file
        return np.ascontiguousarray(rows[:, :width]), None
    base, _, suffix = rawmode.partition(";")
    if suffix.startswith("16"):
        order = suffix[2:]
        n = len(base)
        px = rows[:, :width * 2 * n].reshape(r, width, n, 2)
        big = order == "B"
        hi = px[..., 0] if big else px[..., 1]
    elif rawmode == "RGB;R":
        hi = _BITFLIP[rows[:, :width * 3]].reshape(r, width, 3)
        base = "RGB"
    else:
        n = len(base)
        hi = rows[:, :width * n].reshape(r, width, n)
    if base in ("RGBa", "RGBaX", "RGBaXX"):
        rgb = _unpremultiply(hi[..., :3], hi[..., 3])
        return np.concatenate([rgb, hi[..., 3:4]], -1), (0, 1, 2, 3)
    if base in ("RGB", "RGBX", "RGBXX", "RGBXXX"):
        return np.ascontiguousarray(hi[..., :3]), (0, 1, 2)
    if base == "LAB":                    # a and b signed in the file
        return hi[..., :3] ^ np.array([0, 128, 128], np.uint8), (0, 1, 2)
    if base in ("RGBA", "RGBAX", "RGBAXX", "CMYK", "CMYKX", "CMYKXX"):
        return np.ascontiguousarray(hi[..., :4]), (0, 1, 2, 3)
    if base == "LA":
        return np.ascontiguousarray(hi[..., [0, 0, 0, 1]]), (0, 1, 2, 3)
    if base == "PA":
        return np.ascontiguousarray(hi[..., :2]), (0, 3)
    if base == "PX":
        return np.ascontiguousarray(hi[..., 0]), None
    raise NotImplementedError(f"no unpacker for raw mode {rawmode}")


# Raw modes in OPEN_INFO that PIL has no unpacker for (an uncompressed
# file of these fails to load; libtiff's path reads fill order 1 instead).
_NO_UNPACKER = {"P;1R", "P;2R", "P;4R", "L;IR"}
# Single-letter raw modes PIL unpacks for each mode (the planes of a
# planar uncompressed file): letter -> slot.
_PLANE_UNPACKERS = {"1": {"1": None}, "L": {"L": None}, "P": {"P": None},
                    "I": {"I": None}, "F": {"F": None},
                    "RGB": {"R": 0, "G": 1, "B": 2},
                    "RGBA": {"R": 0, "G": 1, "B": 2, "A": 3},
                    "LAB": {"L": 0, "A": 1, "B": 2},
                    "CMYK": {"C": 0, "M": 1, "Y": 2, "K": 3}}


def _new_image(mode: str, h: int, w: int) -> np.ndarray:
    if mode in _SLOT_MODES:
        return np.zeros((h, w, 4), np.uint8)
    dtype = {"I;16": np.uint16, "I;16B": np.uint16, "I": np.int32,
             "F": np.float32}.get(mode, np.uint8)
    return np.zeros((h, w), dtype)


def _put(img, y0, x0, values, slots):
    h, w = values.shape[:2]
    if slots is None:
        img[y0:y0 + h, x0:x0 + w] = values
    else:
        img[y0:y0 + h, x0:x0 + w][..., list(slots)] = values


# ----------------------------------------------------------------------------
# Decoding


def _layout(tags, xsize, ysize, path):
    """(offsets, byte counts or None, region width, region height,
    tiled) of the strips or tiles."""
    if 273 in tags:
        offsets = _tag(tags, 273, path=path)
        counts = _tag(tags, 279, path=path)
        h = _tag(tags, 278, ysize, path)
        return offsets, counts, xsize, h, False
    if 324 in tags:
        offsets = _tag(tags, 324, path=path)
        counts = _tag(tags, 325, path=path)
        w, h = _tag(tags, 322, path=path), _tag(tags, 323, path=path)
        if not isinstance(w, int) or not isinstance(h, int):
            raise ValueError(f"{path}: Invalid tile dimensions")
        return offsets, counts, w, h, True
    raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                 "(unknown data organization)")


# Modes ImageFile.load maps straight from the file (Image._MAPMODES) when
# a single raw tile has the mode as its raw mode, and their pixel bytes.
_MAPMODES = {"L": 1, "P": 1, "I;16": 2, "I;16B": 2, "RGBA": 4, "CMYK": 4}


def _mapped(data, mode, size, offset, stride, path):
    """ImageFile.load's memory-mapped read (Image.core.map_buffer): an
    image of `size` = (W, H) whose rows lie `stride` bytes apart (0: W
    pixels) from `offset`. size is PIL's size, swapped for orientations
    5-8, so such files map with their dimensions swapped, as in PIL."""
    w, h = size
    ps = _MAPMODES[mode]
    stride = stride or w * ps
    if offset + h * stride > len(data):
        raise ValueError(f"{path}: buffer is not large enough")
    buf = np.frombuffer(data, np.uint8, h * stride, offset)
    rows = np.lib.stride_tricks.as_strided(buf, (h, w * ps), (stride, 1))
    if mode in ("RGBA", "CMYK"):
        return rows.reshape(h, w, 4).copy()
    dtype = {"I;16": "<u2", "I;16B": ">u2"}.get(mode, np.uint8)
    return rows.copy().view(dtype).reshape(h, w).astype(
        np.uint16 if ps == 2 else np.uint8)


def _decode_raw(data, img, mode, rawmode, planar, bps, bps_count, offsets,
                w, h, xsize, ysize, swapped, path):
    """PIL's raw decoder over its tile list (TiffImagePlugin._setup and
    ImageFile.load; RawDecode.c), or its memory map of a single tile.
    Returns the image."""
    if w == xsize and h == ysize and planar != 2:
        offsets = offsets[-1:]
    x = y = layer = 0
    tiles = []
    for offset in offsets:
        stride = w * sum(bps) / 8 if x + w > xsize else 0
        tile_raw = rawmode
        if planar == 2:
            if layer >= len(rawmode):
                raise UnidentifiedImageError(f"{path}: cannot identify image "
                                             "file (more planes than bands)")
            tile_raw = rawmode[layer]
            stride /= bps_count
        tiles.append((tile_raw, int(stride), x, y, min(x + w, xsize),
                      min(y + h, ysize), offset))
        x += w
        if x >= xsize:
            x, y = 0, y + h
            if y >= ysize:
                y, layer = 0, layer + 1
    if len(tiles) == 1 and tiles[0][0] == mode and mode in _MAPMODES:
        size = (ysize, xsize) if swapped else (xsize, ysize)
        return _mapped(data, mode, size, tiles[0][6], tiles[0][1], path)
    tiles.sort(key=lambda t: t[6])       # ImageFile.load: file order
    for tile_raw, stride, x0, y0, x1, y1, offset in tiles:
        if tile_raw in _NO_UNPACKER:
            raise ValueError(f"{path}: unknown raw mode for given image "
                             f"mode ({tile_raw})")
        if len(tile_raw) == 1:
            slot = _PLANE_UNPACKERS.get(mode, {})
            if tile_raw not in slot:
                raise ValueError(f"{path}: unknown raw mode for given image "
                                 f"mode ({tile_raw} for {mode})")
        rw, rh = x1 - x0, y1 - y0
        if rw <= 0 or rh <= 0:
            continue
        nbytes = (rw * _raw_bits(tile_raw) + 7) // 8
        skip = stride - nbytes if stride else 0
        if skip < 0:
            raise ValueError(f"{path}: decoder error -8 (rows of {stride} "
                             f"bytes for {rw} {tile_raw} pixels)")
        pitch = nbytes + skip
        end = offset + (rh - 1) * pitch + nbytes
        if offset >= len(data) or end > len(data):
            raise ValueError(f"{path}: image file is truncated")
        buf = np.frombuffer(data, np.uint8, end - offset, offset)
        rows = np.lib.stride_tricks.as_strided(
            buf, (rh, nbytes), (pitch, 1)).copy()
        if len(tile_raw) == 1:
            values, _ = unpack(tile_raw, rows, rw)
            s = _PLANE_UNPACKERS[mode][tile_raw]
            _put(img, y0, x0, values[..., None] if s is not None else values,
                 None if s is None else (s,))
        else:
            _put(img, y0, x0, *unpack(tile_raw, rows, rw))
    return img


def _feed(d, raw, need, error):
    """The output of decompressor d (zlib's or lzma's) on raw, fed a
    byte at a time so that it stops where the stream met an error (or
    need bytes)."""
    out = bytearray()
    for i in range(len(raw)):
        try:
            out += d.decompress(raw[i:i + 1], need - len(out))
        except error:
            break
        if len(out) >= need or d.eof:
            break
    return bytes(out)


def _inflate(raw: bytes, need: int, path: str, lenient=False) -> bytes:
    """zlib's inflate of up to `need` bytes; lenient: what it inflated
    before an error instead of the error."""
    d = zlib.decompressobj()
    if lenient:
        return _feed(d, raw, need, zlib.error)
    try:
        return d.decompress(raw, need)
    except zlib.error as e:
        raise ValueError(f"{path}: decoder error -2 (ZIPDecode: {e})") \
            from None


def _unxz(raw: bytes, need: int, path: str, lenient=False) -> bytes:
    """libtiff's LZMADecode: one .xz stream, decoded until `need` bytes
    (liblzma's checks run as far as that reaches); lenient as _inflate."""
    import lzma

    d = lzma.LZMADecompressor(format=lzma.FORMAT_XZ)
    if lenient:
        return _feed(d, raw, need, lzma.LZMAError)
    try:
        return d.decompress(raw, need)
    except lzma.LZMAError as e:
        raise ValueError(f"{path}: decoder error -2 (LZMADecode: {e})") \
            from None


class _Segment:
    """What a strip or tile's decoder needs beyond its bytes: its rows and
    pixel width, the CCITT options (RLE-word: the parity of its file
    offset), the JPEG state and whether it is the last strip."""

    def __init__(self, rows, width, options=0, jpeg=None, last=False):
        self.rows, self.width, self.options = rows, width, options
        self.jpeg, self.last = jpeg, last
        self.failed = False              # a lenient decode met an error


def _decompress(raw: bytes, kind: str, need: int, path: str,
                seg: _Segment, lenient=False) -> np.ndarray:
    """One strip or tile as libtiff decodes it: exactly `need` bytes, or
    ValueError (PIL's "decoder error -2"). lenient (TIFFRGBAImage, which
    ignores read errors): the bytes decoded before an error, zeros
    after them, and seg.failed set."""
    src = np.frombuffer(raw, np.uint8)
    out = np.zeros(max(need, 1), np.uint8)
    if kind in ("deflate", "lzma"):
        got = (_inflate if kind == "deflate" else _unxz)(raw, need, path,
                                                         lenient)
        out[:len(got)] = np.frombuffer(got, np.uint8)
        if len(got) < need:
            if not lenient:
                raise ValueError(f"{path}: decoder error -2 ({kind}: not "
                                 "enough data)")
            seg.failed = True
        return out[:need]
    if kind == "jpeg":
        return _jpeg_segment(raw, need, path, seg)
    if kind == "lzw":
        old = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
        fn = (library().tb_tiff_lzw_decode_compat if old
              else library().tb_tiff_lzw_decode)
        got = fn(src.ctypes.data, src.size, out.ctypes.data, need)
        if got < 0 and not lenient:
            raise ValueError(f"{path}: decoder error -2 (LZWDecode: "
                             "corrupted LZW table)")
    elif kind == "zstd":
        got = tiff_library().tb_zstd_decode(src.ctypes.data, src.size,
                                            out.ctypes.data, need)
    elif kind in _FAX:
        got = tiff_library().tb_fax_decode(
            src.ctypes.data, src.size, out.ctypes.data, seg.rows, seg.width,
            _FAX[kind], seg.options)
        if got == -3:
            raise NotImplementedError(
                f"{path}: a 2D Group 3 strip that ends early, which libtiff "
                f"fails or fills from an uninitialised buffer ({ITEM})")
        if 0 <= got < seg.rows:
            raise NotImplementedError(
                f"{path}: a fax strip that ends before its last row, whose "
                f"remaining rows PIL takes from an uninitialised buffer "
                f"({ITEM})")
        if got >= 0:
            got = need
        elif not lenient:
            raise ValueError(f"{path}: decoder error -2 (Fax3Decode: "
                             "premature end of data)")
    elif kind == "thunderscan":
        got = tiff_library().tb_thunder_decode(
            src.ctypes.data, src.size, out.ctypes.data, seg.rows, seg.width)
        if got == -3:
            raise NotImplementedError(
                f"{path}: a ThunderScan run that ends a row, which libtiff "
                f"leaves unwritten ({ITEM})")
        got = need if got >= 0 else -1
    else:
        got = library().tb_packbits_decode(src.ctypes.data, src.size,
                                            out.ctypes.data, need)
    if got < need:
        if not lenient:
            raise ValueError(f"{path}: decoder error -2 ({kind}: not "
                             "enough data)")
        seg.failed = True
    return out[:need]


class _JpegState:
    """tif_jpeg.c's decoder state across a file's strips or tiles: the
    tables (JPEGTables, then each datastream's), the colour rule and the
    sampling factors the first component must have."""

    def __init__(self, tags, photo, spp, bits, path):
        from tracerboy_tpu_torch.core import jpeg

        self.tables = jpeg.JpegTables()
        if 347 in tags:
            table_bytes = tags[347][1][0]
            try:
                jpeg.read_tables(table_bytes, self.tables, path)
            except OSError as e:
                raise ValueError(f"{path}: decoder error -2 (Bogus "
                                 f"JPEGTables field: {e})") from None
        self.ycbcr = photo == 6
        self.spp, self.bits = spp, bits
        self.sampling = None
        if self.ycbcr and 530 in tags:
            self.sampling = tuple(_tag(tags, 530, path=path))[:2]
        if not self.ycbcr:
            self.sampling = (1, 1)


def _jpeg_segment(raw, need, path, seg):
    """One strip or tile of a JPEG-in-TIFF (JPEGPreDecode, JPEGDecode):
    `need` bytes of rows of seg.width pixels."""
    from tracerboy_tpu_torch.core import jpeg

    st, seg_w, seg_h = seg.jpeg, seg.width, seg.rows
    try:
        head = jpeg.frame_header(raw, path)
        if head is None:
            raise ValueError(f"{path}: decoder error -2 (JPEG datastream "
                             "without a frame)")
        prec, h, w, comps = head
        if prec != st.bits and prec in (8, 12):
            raise ValueError(f"{path}: decoder error -2 (Improper JPEG data "
                             "precision)")
        if w < seg_w or h < seg_h:
            raise NotImplementedError(
                f"{path}: a JPEG stream of {w}x{h} in a {seg_w}x{seg_h} "
                f"strip or tile ({ITEM})")
        if w > seg_w or (h > seg_h and not seg.last):
            raise ValueError(f"{path}: decoder error -2 (JPEG strip/tile "
                             "size exceeds expected dimensions)")
        if len(comps) != st.spp:
            raise ValueError(f"{path}: decoder error -2 (Improper JPEG "
                             "component count)")
        if len(comps) == 4:
            raise NotImplementedError(f"{path}: a 4-component JPEG strip "
                                      f"or tile ({ITEM})")
        if st.sampling is None:          # JPEGFixupTagsSubsampling
            hs, vs = comps[0][1:]
            st.sampling = ((hs, vs) if hs in (1, 2, 4) and vs in (1, 2, 4)
                           else (2, 2))
        if (comps[0][1:] != st.sampling
                or any(c[1:] != (1, 1) for c in comps[1:])):
            raise ValueError(f"{path}: decoder error -2 (Improper JPEG "
                             "sampling factors)")
        color = 1 if st.ycbcr else 0 if len(comps) == 1 else 2
        pixels = jpeg.decode_jpeg(raw, path, tables=st.tables, color=color)
    except OSError as e:
        if any(m in str(e) for m in jpeg.ENTROPY_DAMAGE):
            raise NotImplementedError(
                f"{path}: damaged JPEG data, which libjpeg patches ({e}; "
                f"{ITEM})") from None
        raise ValueError(f"{path}: decoder error -2 ({e})") from None
    pixels = pixels[:seg_h, :, :1] if len(comps) == 1 else pixels[:seg_h]
    return np.ascontiguousarray(pixels).reshape(-1)[:need]


def _estimate_counts(data, prefix, tags, offsets, planar, spp, path):
    """libtiff's EstimateStripByteCounts for a compressed file without
    StripByteCounts (TIFFReadDirectory allows it for one strip, or one
    strip a plane): the file less its header, IFD and the values stored
    outside it, split among the planes; the last strip cut at the end of
    the file."""
    need_strips = spp if planar == 2 else 1
    if len(offsets) != need_strips:
        raise ValueError(f"{path}: TIFF directory is missing required "
                         "StripByteCounts (PIL: OSError)")
    big = data[2] == 43
    e = "<" if prefix == II else ">"
    first = struct.unpack_from(e + ("Q" if big else "L"), data,
                               8 if big else 4)[0]
    count = struct.unpack_from(e + ("Q" if big else "H"), data, first)[0]
    space = (16 + 8 + count * 20 + 8) if big else (8 + 2 + count * 12 + 4)
    entry = 20 if big else 12
    for i in range(count):
        pos = first + (8 if big else 2) + i * entry
        typ, n = struct.unpack_from(e + ("HQ" if big else "HL"), data,
                                    pos + 2)
        width = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                 10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}.get(typ)
        if width is None:
            raise ValueError(f"{path}: cannot determine size of unknown tag "
                             f"type {typ}")
        size = width * n
        space += 0 if size <= (8 if big else 4) else size
    filesize = len(data)
    space = filesize if filesize < space else filesize - space
    if planar == 2:
        space //= spp
    counts = [space] * len(offsets)
    if offsets[-1] + counts[-1] > filesize:
        counts[-1] = max(filesize - offsets[-1], 0)
    return counts


def _decode_libtiff(data, img, mode, rawmode, kind, prefix, planar, spp,
                    bits, fill_order, predictor, sample_format, extra,
                    offsets, counts, w, h, xsize, ysize, tiled, path,
                    tags, photo):
    """libtiff's decode of every strip or tile, then Pillow's TiffDecode.c
    (_decodeStrip, _decodeTile) unpacking into img."""
    if counts is None:
        counts = _estimate_counts(data, prefix, tags, offsets, planar, spp,
                                  path)
    bands = {"LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}.get(mode, 1)
    if mode == "LAB" and planar == 2:
        raise NotImplementedError(f"{path}: CIELab in planes ({ITEM})")
    planes = 1
    if planar == 2 and bands > 1:
        if kind == "jpeg":
            raise NotImplementedError(f"{path}: JPEG in planes ({ITEM})")
        if bits not in (8, 16):
            raise ValueError(f"{path}: decoder error -2 (planar {bits}-bit "
                             "samples)")
        planes = bands
    if kind not in _PREDICTED:
        predictor = 1                    # the codec has no predictor
    if predictor != 1:
        ok = ((predictor == 2 and bits in (8, 16, 32))
              or (predictor == 3 and sample_format == 3
                  and bits in (16, 24, 32, 64)))
        if not ok:
            raise ValueError(f"{path}: decoder error -2 (PredictorSetup: "
                             f"predictor {predictor} with {bits}-bit "
                             "samples)")
    if kind in _FAX and bits != 1:
        raise ValueError(f"{path}: decoder error -2 (Bits/sample must be 1 "
                         "for Group 3/4 encoding/decoding)")
    if kind == "thunderscan":
        if bits != 4:
            raise ValueError(f"{path}: decoder error -2 (Wrong "
                             "bitspersample value, Thunder decoder only "
                             "supports 4bits per sample)")
        if tiled:
            raise NotImplementedError(f"{path}: tiled ThunderScan ({ITEM})")
    jpeg_state = (_JpegState(tags, photo, spp, bits, path)
                  if kind == "jpeg" else None)
    rawbits = _raw_bits(rawmode)
    sample_planes = spp if planar == 2 else 1
    per_pixel = bits * (1 if planar == 2 else spp)
    row_bytes = (w * per_pixel + 7) // 8
    if not tiled:
        rps = min(h, ysize) if h else ysize
        unpacker_row = (xsize * rawbits // planes + 7) // 8
        if unpacker_row != row_bytes:
            raise ValueError(f"{path}: decoder error -2 (unexpected row "
                             "byte size)")
        across, down = 1, -(-ysize // rps)
        th = rps
    else:
        across, down = -(-xsize // w), -(-ysize // h)
        th = h
    per_plane = across * down
    if len(offsets) < per_plane * sample_planes or len(counts) < len(offsets):
        raise ValueError(f"{path}: decoder error -2 (too few strips or "
                         "tiles)")
    stride = spp if planar == 1 else 1
    options = _tag(tags, 292 if kind == "group3" else 293, 0, path)
    # Predictor 3 weaves its byte planes straight into native order.
    swap = prefix == MM and bits in (16, 32) and predictor != 3
    for ty in range(down):
        y = ty * th
        rows = min(th, ysize - y) if not tiled else th
        for p in range(planes):
            for tx in range(across):
                x = tx * w
                i = p * per_plane + ty * across + tx
                off, cnt = offsets[i], counts[i]
                if off + cnt > len(data) or cnt == 0:
                    raise ValueError(f"{path}: decoder error -2 (read error "
                                     f"on strip {i})")
                raw = data[off:off + cnt]
                if fill_order == 2:
                    raw = _BITFLIP[np.frombuffer(raw, np.uint8)].tobytes()
                need = rows * row_bytes
                seg = _Segment(rows, w, off & 1 if kind == "ccitt_rlew"
                               else options, jpeg_state,
                               not tiled and ty == down - 1)
                buf = _decompress(raw, kind, need, path, seg)
                if swap:                 # to native order, before Predictor 2
                    buf = buf.view(f">u{bits // 8}").astype(
                        f"<u{bits // 8}").view(np.uint8)
                if predictor != 1:
                    buf = np.ascontiguousarray(buf)
                    if library().tb_tiff_unpredict(
                            buf.ctypes.data, rows, row_bytes, predictor,
                            bits, stride):
                        raise ValueError(f"{path}: decoder error -2 "
                                         "(predictor row size)")
                keep = min(rows, ysize - y)
                cw = min(w, xsize - x)
                rowsb = buf.reshape(rows, row_bytes)[:keep]
                if planes > 1:
                    if bits == 16:
                        v = rowsb[:, 1:2 * cw:2]
                    else:
                        v = rowsb[:, :cw]
                    img[y:y + keep, x:x + cw, p] = v
                else:
                    if (cw * rawbits + 7) // 8 > row_bytes:
                        raise NotImplementedError(
                            f"{path}: raw mode {rawmode} wider than a "
                            f"planar tile's row ({ITEM})")
                    _put(img, y, x, *unpack(rawmode, rowsb, cw))
    if planes > 1 and mode == "RGBA" and (not extra or extra[0] == 1):
        # Planes copied as they are, then alpha that libtiff calls
        # associated or unspecified (no ExtraSamples) unpremultiplied.
        img[..., :3] = _unpremultiply(img[..., :3], img[..., 3])


def _decode_ycbcr_rgba(data, img, kind, prefix, tags, planar, predictor,
                       offsets, counts, w, h, xsize, ysize, tiled, path):
    """libtiff's TIFFRGBAImage over a YCbCr file, as Pillow's
    _decodeAsRGBA drives it: one TIFFRGBAImageGet a strip (or a row of
    tiles), each strip or tile decoded into a zeroed buffer whose read
    errors are ignored (TIFFRGBAImageBegin's stop-on-error is off), then
    tif_getimage.c's putcontig8bitYCbCr*tile."""
    if planar == 2:
        raise NotImplementedError(f"{path}: YCbCr in planes ({ITEM})")
    if counts is None:
        counts = _estimate_counts(data, prefix, tags, offsets, planar, 3,
                                  path)
    hs, vs = (tuple(_tag(tags, 530, path=path)) + (2, 2))[:2] \
        if 530 in tags else (2, 2)
    if (hs << 4 | vs) not in (0x44, 0x42, 0x41, 0x22, 0x21, 0x12, 0x11):
        raise ValueError(f"{path}: decoder error -2 (TIFFRGBAImage can not "
                         f"handle YCbCr subsampling {hs}x{vs})")
    coeffs = _float_tag(tags, 529, (0.299, 0.587, 0.114), path)
    rbw = _float_tag(tags, 532, (0, 255, 128, 255, 128, 255), path)
    if (len(coeffs) < 3 or len(rbw) < 6 or np.isnan(coeffs).any()
            or coeffs[1] == 0):
        raise ValueError(f"{path}: decoder error -2 (Invalid values for "
                         "YCbCrCoefficients tag)")
    if kind not in _PREDICTED:
        predictor = 1
    if predictor not in (1, 2):
        raise ValueError(f"{path}: decoder error -2 (PredictorSetup: "
                         f"predictor {predictor} with 8-bit samples)")
    block = hs * vs + 2

    def size(width, nrows):              # TIFFVStripSize of YCbCr
        return -(-nrows // vs) * -(-width // hs) * block

    rgb = np.zeros((ysize, xsize, 3), np.uint8)
    coeffs = np.ascontiguousarray(coeffs[:3])
    rbw = np.ascontiguousarray(rbw[:6])

    def put(buf, data_w, out_w, out_h, y0, x0):
        tiff_library().tb_ycbcr_to_rgb(
            buf.ctypes.data, buf.size, data_w, out_w, out_h, hs, vs,
            coeffs.ctypes.data, rbw.ctypes.data,
            rgb.ctypes.data + 3 * (y0 * xsize + x0), xsize)

    def read(i, need, reused, rowsize):
        """A strip or tile into a zeroed buffer, as far as it decodes, then
        Predictor 2 undone over rows of `rowsize` bytes (libtiff's
        PredictorDecodeTile: a decode that fails, or a size that is no
        multiple of the row, leaves the bytes as decoded; horAcc8 leaves
        a row whose size is no multiple of 3). A tile whose decode fails
        after the first of its row is refused: libtiff decodes it into
        the buffer the tile before it left."""
        if i >= len(offsets) or i >= len(counts):
            raise ValueError(f"{path}: decoder error -2 (too few strips or "
                             "tiles)")
        off, cnt = offsets[i], counts[i]
        if off + cnt > len(data) or cnt == 0:
            raise ValueError(f"{path}: decoder error -2 (read error on "
                             f"strip {i})")
        seg = _Segment(0, 0)
        buf = _decompress(data[off:off + cnt], kind, need, path, seg,
                          lenient=True)
        if predictor == 2 and not seg.failed and not need % rowsize:
            buf = np.ascontiguousarray(buf)
            library().tb_tiff_unpredict(buf.ctypes.data, need // rowsize,
                                        rowsize, 2, 8, 3)
        if seg.failed and reused:
            raise NotImplementedError(
                f"{path}: a damaged YCbCr tile after the first of its row "
                f"({ITEM})")
        return buf

    if not tiled:
        rps = min(h, ysize) if h else ysize
        samplingrow = -(-xsize // hs) * block
        scanline = samplingrow // vs
        for k, y in enumerate(range(0, ysize, rps)):
            rows = min(rps, ysize - y)
            rows_sub = -(-rows // vs) * vs
            need = min(size(xsize, rows), rows_sub * scanline)
            buf = np.zeros(max(size(xsize, rps), 1), np.uint8)
            buf[:need] = read(k, need, False, scanline)
            put(buf, xsize, xsize, rows, y, 0)
    else:
        across = -(-xsize // w)
        for ty, y in enumerate(range(0, ysize, h)):
            for tx, x in enumerate(range(0, xsize, w)):
                need = size(w, h)
                buf = read(ty * across + tx, need, tx > 0, w * 3)
                put(buf, w, min(w, xsize - x), min(h, ysize - y), y, x)
    img[..., :3] = rgb


def decode_tiff(data: bytes, path: str = "<tiff>"):
    """A TIFF file's first image as PIL decodes it: (pixels, mode,
    palette). pixels is (H, W) for the one-band modes ("1" as 0/255, L,
    P, I;16 and I;16B as uint16, I as int32, F as float32) and (H, W, 4)
    uint8 in PIL's byte slots for RGB, RGBA, CMYK, LA (L, L, L, A), PA
    (P, -, -, A) and LAB (L, a, b as PIL holds them: offset by 128);
    palette the (256, 3) RGB table of a P or PA image."""
    if not is_tiff(data):
        raise ValueError(f"{path}: not a TIFF file")
    prefix, tags = read_ifd(data, path)
    if 0xBC01 in tags:
        raise ValueError(f"{path}: Windows Media Photo files not yet "
                         "supported")
    code = _tag(tags, 259, 1, path)
    if code in LEFT_OUT:
        raise NotImplementedError(f"{path}: {LEFT_OUT[code]}-compressed TIFF "
                                  f"({ITEM})")
    if code not in COMPRESSIONS and code not in FAILS_IN_LIBTIFF:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     f"(unknown TIFF compression {code})")
    kind = COMPRESSIONS.get(code)
    planar = _tag(tags, 284, 1, path)
    photo = _tag(tags, 262, 0, path)
    fill_order = _tag(tags, 266, 1, path)
    xsize, ysize = _tag(tags, 256, None, path), _tag(tags, 257, None, path)
    if xsize is None or ysize is None:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(missing dimensions)")
    sample_format = _tag(tags, 339, (1,), path)
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) \
            == 1:
        sample_format = (1,)
    bps = _tag(tags, 258, (1,), path)
    extra = _tag(tags, 338, (), path)
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(
        extra)
    spp = _tag(tags, 277, 3 if code == 6 and photo in (2, 6) else 1, path)
    if spp > MAX_SAMPLESPERPIXEL:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(invalid value for samples per pixel)")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(unknown data organization)")
    key = (prefix, photo, sample_format, fill_order, bps, extra)
    if key not in OPEN_INFO:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     f"(unknown pixel mode {key})")
    mode, rawmode = OPEN_INFO[key]
    offsets, counts, w, h, tiled = _layout(tags, xsize, ysize, path)
    if code in FAILS_IN_LIBTIFF:
        raise ValueError(f"{path}: decoder error -2 "
                         f"({FAILS_IN_LIBTIFF[code]})")
    if kind != "raw":
        if fill_order == 2:
            mode, rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
        if photo == 6 and kind == "jpeg" and planar == 1:
            rawmode = "RGB"
        elif rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    palette = None
    if mode in ("P", "PA"):
        if 320 not in tags:
            raise ValueError(f"{path}: palette TIFF without a ColorMap (PIL "
                             "raises KeyError)")
        cmap = np.array([v // 256 for v in _tag(tags, 320, path=path)],
                        np.uint8)
        n = len(cmap) // 3
        palette = np.zeros((256, 3), np.uint8)
        m = min(n, 256)
        palette[:m] = cmap[:3 * n].reshape(3, n).T[:m]
    img = _new_image(mode, ysize, xsize)
    orientation = _tag(tags, 274, 1, path)
    predictor = _tag(tags, 317, 1, path)
    if kind == "raw":
        img = _decode_raw(data, img, mode, rawmode, planar, bps, bps_count,
                          offsets, w, h, xsize, ysize,
                          orientation in (5, 6, 7, 8), path)
    elif photo == 6 and not (kind == "jpeg" and planar == 1):
        if spp != 3:
            raise ValueError(f"{path}: decoder error -2 (TIFFRGBAImage: "
                             f"{spp} colour channels for YCbCr)")
        _decode_ycbcr_rgba(data, img, kind, prefix, tags, planar, predictor,
                           offsets, counts, w, h, xsize, ysize, tiled, path)
    else:
        _decode_libtiff(data, img, mode, rawmode, kind, prefix, planar, spp,
                        bps[0], fill_order, predictor, sample_format[0],
                        extra, offsets, counts, w, h, xsize, ysize, tiled,
                        path, tags, photo)
    if orientation in _ORIENT:
        img = np.ascontiguousarray(_ORIENT[orientation](img))
    return img, mode, palette


def to_read_ldr(img: np.ndarray, mode: str, palette) -> np.ndarray:
    """PIL's convert to RGB (or RGBA for LA, PA, RGBA) of a decoded
    image, as the JAX read_ldr converts it: (H, W, 3|4) uint8."""
    if mode in ("1", "L"):
        return np.repeat(img[..., None], 3, axis=2)
    if mode == "P":
        return palette[img]
    if mode in ("I;16", "I;16B"):
        v = np.minimum(img, 255).astype(np.uint8)
        return np.repeat(v[..., None], 3, axis=2)
    if mode == "I":
        v = np.clip(img, 0, 255).astype(np.uint8)
        return np.repeat(v[..., None], 3, axis=2)
    if mode == "F":
        v = np.where(np.isnan(img), 0, np.clip(img, 0, 255)).astype(np.uint8)
        return np.repeat(v[..., None], 3, axis=2)
    if mode == "RGB":
        return np.ascontiguousarray(img[..., :3])
    if mode == "RGBA":
        return np.ascontiguousarray(img)
    if mode == "LA":
        return np.ascontiguousarray(img[..., [0, 0, 0, 3]])
    if mode == "PA":
        return np.concatenate([palette[img[..., 0]], img[..., 3:]], -1)
    if mode == "LAB":
        lab = np.ascontiguousarray(img[..., :3])
        rgb = np.empty_like(lab)
        tiff_library().tb_lab_to_rgb(lab.ctypes.data, lab.size // 3,
                                     rgb.ctypes.data)
        return np.concatenate([rgb, np.full_like(rgb[..., :1], 255)], -1)
    if mode == "CMYK":
        c = img.astype(np.int32)
        nk = 255 - c[..., 3:]
        t = c[..., :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    raise NotImplementedError(f"no conversion of mode {mode}")


def read_tiff(data: bytes, path: str = "<tiff>") -> np.ndarray:
    """A TIFF file's pixels as the JAX read_ldr gets them through PIL:
    (H, W, 3|4) uint8."""
    return to_read_ldr(*decode_tiff(data, path))


# ----------------------------------------------------------------------------
# Writing


def lzw_encode(raw: bytes) -> bytes:
    """TIFF LZW (csrc/lzw_codecs.cpp tb_tiff_lzw_encode)."""
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(2 * src.size + 16, np.uint8)
    n = library().tb_tiff_lzw_encode(src.ctypes.data, src.size,
                                      out.ctypes.data)
    return out[:n].tobytes()


def write_tiff(path: str, img: np.ndarray, compression: str,
               tile=None) -> None:
    """Write an 8-bit image, (H, W), (H, W, 3) or (H, W, 4) uint8 (or
    floats in [0,1], quantised as write_png quantises them), as a
    little-endian TIFF with Predictor 2: "lzw" or "deflate" compression,
    strips of ROWS_PER_STRIP rows or tile = (tw, th) tiles (multiples of
    16; edge tiles padded with zeros). A fourth channel is unassociated
    alpha (ExtraSamples 2)."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8

    img = _to_uint8(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    if spp not in (1, 3, 4):
        raise ValueError(f"TIFF needs 1, 3 or 4 channels, got {spp}")
    code = {"lzw": 5, "deflate": 8}[compression]
    if tile is None:
        regions = [(0, y, w, min(ROWS_PER_STRIP, h - y))
                   for y in range(0, h, ROWS_PER_STRIP)]
    else:
        tw, th = tile
        regions = [(x, y, tw, th) for y in range(0, h, th)
                   for x in range(0, w, tw)]
    chunks = []
    for x, y, rw, rh in regions:
        block = np.zeros((rh, rw, spp), np.uint8)
        part = img[y:y + rh, x:x + rw]
        block[:part.shape[0], :part.shape[1]] = part
        rows = block.reshape(rh, rw * spp)
        rows[:, spp:] = rows[:, spp:] - rows[:, :-spp]     # Predictor 2
        raw = rows.tobytes()
        chunks.append(lzw_encode(raw) if code == 5 else zlib.compress(raw, 6))
    offsets, pos = [], 8
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    pos += pos % 2
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
               (259, 3, [code]), (262, 3, [1 if spp == 1 else 2]),
               (277, 3, [spp]), (284, 3, [1]), (317, 3, [2])]
    if tile is None:
        entries += [(273, 4, offsets), (278, 4, [ROWS_PER_STRIP]),
                    (279, 4, [len(c) for c in chunks])]
    else:
        entries += [(322, 4, [tile[0]]), (323, 4, [tile[1]]),
                    (324, 4, offsets), (325, 4, [len(c) for c in chunks])]
    if spp == 4:
        entries.append((338, 3, [2]))
    entries.sort()
    ifd_size = 2 + 12 * len(entries) + 4
    far_pos = pos + ifd_size
    ifd, far = struct.pack("<H", len(entries)), b""
    for tag, typ, values in entries:
        payload = struct.pack(f"<{len(values)}{'H' if typ == 3 else 'L'}",
                              *values)
        ifd += struct.pack("<HHL", tag, typ, len(values))
        if len(payload) <= 4:
            ifd += payload.ljust(4, b"\0")
        else:
            ifd += struct.pack("<L", far_pos + len(far))
            far += payload
    ifd += b"\0\0\0\0"
    body = b"".join(chunks)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<L", pos) + body
                + bytes(pos - 8 - len(body)) + ifd + far)
