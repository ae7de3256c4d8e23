"""The formats image_io.write_png writes, picked and written as PIL 12.1's
Image.fromarray(img).save(path) picks and writes them, byte for byte,
without an imaging library.

The JAX package's write_png quantises a float image, builds a PIL image
of it and lets Image.save pick the format from the path's extension, so
`--out render.jpg` is a JPEG. save() does the same: the image's mode as
Image.fromarray gives it (image_mode), the format from PIL's EXTENSION
table, then the format's writer, one function a format, each following
the PIL plugin's _save named at its head:
- JPEG and MPO (JpegImagePlugin._save: libjpeg-turbo 3.1.3 at PIL's
  defaults, the entropy-coded data by csrc/jpeg_encode.cpp);
- PNG (PngImagePlugin._save and ZipEncode.c: PIL's filter a row, zlib at
  level 6 with PIL's strategy, IDAT chunks as PIL's buffer splits them);
- BMP, DIB, TGA, PPM, TIFF, SGI, IM, QOI, DDS and PCX, uncompressed or
  run-length coded as PIL writes them;
- JPEG 2000 (Jpeg2KImagePlugin._save: OpenJPEG 2.5.4's lossless 5/3
  codestream, the tile coder in csrc/j2k_encode.cpp, in JP2 boxes unless
  the name ends in .j2k);
- GIF (GifImagePlugin._save: PIL's median-cut or octree palette and
  GifEncode.c's LZW, in csrc/gif_encode.cpp);
- EPS/PS (EpsImagePlugin._save and EpsEncode.c's hex lines) and PDF
  (PdfImagePlugin._save and PdfParser: the JPEG or JPEG 2000 writer's
  bytes in one page; its two dates are the current time);
- ICO and ICNS (IcoImagePlugin._save and IcnsImagePlugin._save: PNG
  entries of the image's LANCZOS thumbnails or BICUBIC resizes, by
  core/resample.py and csrc/resample.cpp);
- WebP (WebPImagePlugin._save: libwebp 1.6's lossy VP8 encoder at
  quality 80, method 4, in csrc/webp_encode.cpp; an alpha below 255
  somewhere as libwebp's ALPH chunk, its lossless VP8L encoder in
  csrc/webp_alpha_encode.cpp).

What PIL refuses is refused with PIL's class and message: an extension
PIL does not know (ValueError), a format without a save handler
(KeyError), a mode the format cannot hold (OSError or ValueError, as the
plugin raises), the stub formats (OSError, "save handler not
installed"). What is not ported yet raises NotImplementedError naming
ITEM: AVIF.

As Image.save does, the file is opened (created or emptied) before the
writer runs, and removed again where the writer fails on a file that was
not there before.
"""

from __future__ import annotations

import codecs
import math
import os
import struct
import time
import zlib

import numpy as np

ITEM = "ROADMAP Queue 1 item 25 — PIL's AVIF encoder not yet ported"

# PIL 12.1's Image.EXTENSION after Image.init(): extension -> format.
EXTENSION = {
    ".avif": "AVIF", ".avifs": "AVIF", ".blp": "BLP", ".bmp": "BMP",
    ".dib": "DIB", ".bufr": "BUFR", ".cur": "CUR", ".pcx": "PCX",
    ".dcx": "DCX", ".dds": "DDS", ".ps": "EPS", ".eps": "EPS",
    ".fit": "FITS", ".fits": "FITS", ".fli": "FLI", ".flc": "FLI",
    ".ftc": "FTEX", ".ftu": "FTEX", ".gbr": "GBR", ".gif": "GIF",
    ".grib": "GRIB", ".h5": "HDF5", ".hdf": "HDF5", ".png": "PNG",
    ".apng": "PNG", ".jp2": "JPEG2000", ".j2k": "JPEG2000",
    ".jpc": "JPEG2000", ".jpf": "JPEG2000", ".jpx": "JPEG2000",
    ".j2c": "JPEG2000", ".icns": "ICNS", ".ico": "ICO", ".im": "IM",
    ".iim": "IPTC", ".jfif": "JPEG", ".jpe": "JPEG", ".jpg": "JPEG",
    ".jpeg": "JPEG", ".mpg": "MPEG", ".mpeg": "MPEG", ".tif": "TIFF",
    ".tiff": "TIFF", ".mpo": "MPO", ".msp": "MSP", ".palm": "PALM",
    ".pcd": "PCD", ".pdf": "PDF", ".pxr": "PIXAR", ".pbm": "PPM",
    ".pgm": "PPM", ".ppm": "PPM", ".pnm": "PPM", ".pfm": "PPM",
    ".psd": "PSD", ".qoi": "QOI", ".bw": "SGI", ".rgb": "SGI",
    ".rgba": "SGI", ".sgi": "SGI", ".ras": "SUN", ".tga": "TGA",
    ".icb": "TGA", ".vda": "TGA", ".vst": "TGA", ".webp": "WEBP",
    ".wmf": "WMF", ".emf": "WMF", ".xbm": "XBM", ".xpm": "XPM",
}

_MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}
_EMPTY = "tile cannot extend outside image"   # PIL's encoders' SystemError


def image_mode(img: np.ndarray):
    """(mode, (H, W, C) uint8) of an image as Image.fromarray makes it
    from write_png's uint8 array: (H, W) L, (H, W, 2) LA, (H, W, 3) RGB,
    (H, W, 4) RGBA; a 1-D array of n values an L column n pixels high.
    Other shapes raise as fromarray raises (IndexError for a 0-d array,
    TypeError for any other)."""
    img = np.asarray(img)
    if img.ndim == 0:
        raise IndexError("tuple index out of range")
    if img.ndim == 1:
        img = img[:, None]
    if img.ndim == 2:
        img = img[..., None]
    elif img.ndim != 3 or img.shape[2] not in (2, 3, 4):
        raise TypeError("Cannot handle this data type: "
                        f"{(1, 1) + img.shape[2:]}, |u1")
    return _MODES[img.shape[2]], np.ascontiguousarray(img)


def save(path, img: np.ndarray) -> None:
    """Image.fromarray(img).save(path) for a uint8 image: the mode, then
    the format of the path's extension, then its writer."""
    mode, px = image_mode(img)
    filename = os.fspath(path)
    ext = os.path.splitext(filename)[1].lower()
    try:
        fmt = EXTENSION[ext]
    except KeyError as e:
        raise ValueError(f"unknown file extension: {ext}") from e
    writer = SAVE[fmt]          # KeyError(fmt), as Image.SAVE[fmt]
    created = not os.path.exists(filename)
    with open(filename, "wb") as f:
        try:
            data = writer(px, mode, filename)
        except Exception:
            f.close()
            if created:
                os.remove(filename)
            raise
        f.write(data)


def _rows(px: np.ndarray, bottom_up: bool = False) -> np.ndarray:
    """(H, W x C) rows of the pixels, in file order."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c)
    return rows[::-1] if bottom_up else rows


def _planar_rows(px: np.ndarray) -> np.ndarray:
    """PIL's ";L" raw modes: each row's bands one after another."""
    return np.ascontiguousarray(px.transpose(0, 2, 1))


def _check_size(px: np.ndarray) -> None:
    if 0 in px.shape[:2]:
        raise SystemError(_EMPTY)


# ----------------------------------------------------------------------------
# JPEG


# jcparam.c's std_luminance_quant_tbl and std_chrominance_quant_tbl, in
# natural order.
_STD_QUANT = (
    (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99),
    (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99)
    + (99,) * 32,
)

_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
# jstdhuff.c's tables: (class and id, 16 code counts, symbols), in the
# order jcmarker.c writes them (luma DC, luma AC, chroma DC, chroma AC).
_STD_HUFFMAN = (
    (0x00, bytes((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)),
     bytes(range(12))),
    (0x10, bytes((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125)),
     _AC_LUMA),
    (0x01, bytes((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)),
     bytes(range(12))),
    (0x11, bytes((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119)),
     _AC_CHROMA),
)


# jpeg_set_quality(75, force_baseline=TRUE), PIL's default: the standard
# tables scaled by jpeg_quality_scaling's 50%, each entry clamped to 1..255.
_QUANT = [[min(max((q * 50 + 50) // 100, 1), 255) for q in table]
          for table in _STD_QUANT]


def _segment(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def save_jpeg(px: np.ndarray, mode: str, filename: str) -> bytes:
    """JpegImagePlugin._save at its defaults, through libjpeg-turbo 3.1's
    jpeg_set_defaults: quality 75 with force_baseline, an L image as one
    component, RGB as YCbCr at 4:2:0 (component 1 sampled 2x2); SOI, APP0
    JFIF 1.01 (density 1:1, units 0), one DQT a table, SOF0, the four
    standard DHTs, SOS, the entropy-coded data (csrc/jpeg_encode.cpp),
    EOI."""
    h, w, _ = px.shape
    if w == 0 or h == 0:
        raise ValueError("cannot write empty image as JPEG")
    if mode not in ("L", "RGB"):
        raise OSError(f"cannot write mode {mode} as JPEG")
    from tracerboy_tpu_torch.core.codecs import jpeg_encode_library

    nc = 1 if mode == "L" else 3
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\0\x01\x01\x00\0\x01\0\x01\0\0")]
    for t in range(min(nc, 2)):
        zigzag = [_QUANT[t][z] for z in _ZIGZAG]
        out.append(_segment(0xDB, bytes([t] + zigzag)))
    comps = [(1, 0x22 if nc == 3 else 0x11, 0), (2, 0x11, 1), (3, 0x11, 1)]
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes(c) for c in comps[:nc])))
    huff = _STD_HUFFMAN if nc == 3 else _STD_HUFFMAN[:2]
    out += [_segment(0xC4, bytes([tc]) + bits + vals)
            for tc, bits, vals in huff]
    out.append(_segment(0xDA, bytes([nc]) + b"".join(
        bytes((c[0], 0x11 * c[2])) for c in comps[:nc]) + b"\x00\x3f\x00"))
    specs = np.zeros((4, 272), np.uint8)
    for k, (_, bits, vals) in enumerate(_STD_HUFFMAN):
        specs[k, :16] = np.frombuffer(bits, np.uint8)
        specs[k, 16:16 + len(vals)] = np.frombuffer(vals, np.uint8)
    qt = np.array(_QUANT, np.uint16)
    cap = 1024 + 512 * (-(-w // 8) + 1) * (-(-h // 8) + 1) * 2
    scan = np.empty(cap, np.uint8)
    n = jpeg_encode_library().tb_jpeg_encode_scan(
        px.ctypes.data, h, w, nc, qt.ctypes.data, specs.ctypes.data,
        scan.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("JPEG scan larger than its buffer")
    return b"".join(out) + scan[:n].tobytes() + b"\xff\xd9"


# ----------------------------------------------------------------------------
# PNG

_PNG_TYPES = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6}
_MAXBLOCK = 65536                 # ImageFile.MAXBLOCK


def png_filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + W x C) filtered rows as ZipEncode.c chooses them a row (its
    filter byte first): none; Up where it costs less; then Sub ("prior")
    where that costs less still; then Paeth; each tried only while the
    best so far costs more than 0 (csrc/png_unfilter.cpp tb_png_filter)."""
    from tracerboy_tpu_torch.core.image_io import png_library

    rows = np.ascontiguousarray(rows, np.uint8)
    h, n = rows.shape
    out = np.empty((h, n + 1), np.uint8)
    png_library().tb_png_filter(rows.ctypes.data, out.ctypes.data, h, n, bpp)
    return out


def png_idat_stream(px: np.ndarray) -> bytes:
    """The filtered rows of an image, as the zlib stream inflates them."""
    h, w, c = px.shape
    return png_filter_rows(_rows(px), c).tobytes()


def save_png(px: np.ndarray, mode: str, filename: str) -> bytes:
    """PngImagePlugin._save at its defaults: signature, IHDR (8 bits, no
    interlace), IDAT chunks, IEND. ZipEncode.c deflates the filtered rows
    at level 6 (Z_DEFAULT_COMPRESSION), window 15, memory level 9 and
    Z_FILTERED; ImageFile._save hands its encoder buffers of max(65536,
    4 x width) bytes, each an IDAT chunk."""
    from tracerboy_tpu_torch.core.image_io import PNG_SIGNATURE, png_chunk

    h, w, c = px.shape
    head = PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, _PNG_TYPES[mode], 0, 0, 0))
    _check_size(px)
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    stream = z.compress(png_idat_stream(px)) + z.flush()
    bufsize = max(_MAXBLOCK, 4 * w)
    return head + b"".join(
        png_chunk(b"IDAT", stream[i:i + bufsize])
        for i in range(0, len(stream), bufsize)) + png_chunk(b"IEND", b"")


# ----------------------------------------------------------------------------
# The uncompressed and run-length formats


def save_bmp(px: np.ndarray, mode: str, filename: str,
             bitmap_header: bool = True) -> bytes:
    """BmpImagePlugin._save: a 40-byte info header, 96 dpi; L as 8 bits
    with a 256-grey palette, RGB as 24-bit BGR, RGBA as 32-bit BGRA
    (compression 0); rows bottom-up, each zero-padded to 4 bytes."""
    try:
        order, bits, colors = {"L": ((0,), 8, 256), "RGB": ((2, 1, 0), 24, 0),
                               "RGBA": ((2, 1, 0, 3), 32, 0)}[mode]
    except KeyError as e:
        raise OSError(f"cannot write mode {mode} as BMP") from e
    h, w, _ = px.shape
    ppm = int(96 * 39.3701 + 0.5)
    stride = ((w * bits + 7) // 8 + 3) & ~3
    image = stride * h
    out = []
    if bitmap_header:
        offset = 14 + 40 + colors * 4
        if offset + image > 2**32 - 1:
            raise ValueError("File size is too large for the BMP format")
        out.append(b"BM" + struct.pack("<III", offset + image, 0, offset))
    out.append(struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, image, ppm,
                           ppm, colors, colors))
    if mode == "L":
        out.append(bytes(np.repeat(np.arange(256, dtype=np.uint8), 4)
                         * np.tile(np.array([1, 1, 1, 0], np.uint8), 256)))
    _check_size(px)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * len(order)] = _rows(px[..., list(order)], bottom_up=True)
    return b"".join(out) + rows.tobytes()


def save_dib(px: np.ndarray, mode: str, filename: str) -> bytes:
    """BmpImagePlugin._dib_save: a BMP without its 14-byte file header."""
    return save_bmp(px, mode, filename, bitmap_header=False)


def save_tga(px: np.ndarray, mode: str, filename: str) -> bytes:
    """TgaImagePlugin._save, uncompressed: L and LA as grey (type 3), RGB
    and RGBA as BGR and BGRA (type 2), an alpha's 8 bits in the
    descriptor; rows bottom-up; the TGA 2.0 footer."""
    try:
        order, imagetype = {"L": ((0,), 3), "LA": ((0, 1), 3),
                            "RGB": ((2, 1, 0), 2),
                            "RGBA": ((2, 1, 0, 3), 2)}[mode]
    except KeyError as e:
        raise OSError(f"cannot write mode {mode} as TGA") from e
    h, w, _ = px.shape
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, imagetype, 0, 0, 0, 0, 0, w,
                         h, 8 * len(order), 8 if mode in ("LA", "RGBA") else 0)
    _check_size(px)
    return (header + _rows(px[..., list(order)], bottom_up=True).tobytes()
            + b"\0" * 8 + b"TRUEVISION-XFILE.\0")


def save_ppm(px: np.ndarray, mode: str, filename: str) -> bytes:
    """PpmImagePlugin._save: L as P5, RGB and RGBA as P6 (alpha dropped),
    maximum 255, whatever the extension (.pfm and .pbm too)."""
    if mode == "L":
        head = b"P5"
    elif mode in ("RGB", "RGBA"):
        head = b"P6"
        px = px[..., :3]
    else:
        raise OSError(f"cannot write mode {mode} as PPM")
    h, w, _ = px.shape
    _check_size(px)
    return (head + b"\n%d %d\n255\n" % (w, h)
            + np.ascontiguousarray(px).tobytes())


def save_tiff(px: np.ndarray, mode: str, filename: str) -> bytes:
    """TiffImagePlugin._save, uncompressed (PIL's own IFD writer, not
    libtiff): little-endian, the tags in order (ImageWidth, ImageLength,
    BitsPerSample, Compression 1, Photometric, StripOffsets,
    SamplesPerPixel where more than one, RowsPerStrip = the height, so one
    strip, StripByteCounts, PlanarConfiguration 1, ExtraSamples 2 for LA
    and RGBA); values of more than 4 bytes after the IFD, then the rows."""
    if mode not in _PNG_TYPES:
        raise OSError(f"cannot write mode {mode} as TIFF")
    h, w, c = px.shape
    entries = [(256, 4, (w,)), (257, 4, (h,)), (258, 3, (8,) * c),
               (259, 3, (1,)), (262, 3, (2 if c >= 3 else 1,)),
               (273, 4, (0,))]
    if c > 1:
        entries.append((277, 3, (c,)))
    entries += [(278, 4, (max(h, 1),)), (279, 4, (w * c * h,)),
                (284, 3, (1,))]
    if mode in ("LA", "RGBA"):
        entries.append((338, 3, (2,)))
    aux_at = 8 + 2 + 12 * len(entries) + 4
    ifd, aux = [struct.pack("<H", len(entries))], []
    for tag, typ, values in entries:
        data = struct.pack(f"<{len(values)}{'H' if typ == 3 else 'I'}",
                           *values)
        if len(data) <= 4:
            ifd.append(struct.pack("<HHI", tag, typ, len(values))
                       + data.ljust(4, b"\0"))
        else:
            ifd.append(struct.pack("<HHII", tag, typ, len(values),
                                   aux_at + sum(map(len, aux))))
            aux.append(data + b"\0" * (len(data) & 1))
    header = b"II*\0" + struct.pack("<I", 8)
    start = aux_at + sum(map(len, aux))
    ifd[6] = ifd[6][:8] + struct.pack("<I", start)     # StripOffsets
    _check_size(px)
    return (header + b"".join(ifd) + b"\0" * 4 + b"".join(aux)
            + px.tobytes())


def save_sgi(px: np.ndarray, mode: str, filename: str) -> bytes:
    """SgiImagePlugin._save, uncompressed at 1 byte a sample: the
    512-byte header (its name field the file's name without extension,
    ASCII), then each band's rows bottom-up."""
    if mode not in ("RGB", "RGBA", "L"):
        raise ValueError("Unsupported SGI image mode")
    h, w, c = px.shape
    dimension = (1 if h == 1 else 2) if mode == "L" else 3
    name = os.path.splitext(os.path.basename(filename))[0]
    name = name.encode("ascii", "ignore")
    header = (struct.pack(">hBBHHHHll", 474, 0, 1, dimension, w, h, c, 0,
                          255) + b"\0" * 4 + struct.pack("79s", name)
              + b"\0" + struct.pack(">l", 0) + b"\0" * 404)
    return header + np.ascontiguousarray(
        px[::-1].transpose(2, 0, 1)).tobytes()


def save_im(px: np.ndarray, mode: str, filename: str) -> bytes:
    """ImImagePlugin._save: the text header (type, the file's name,
    size, one frame), NUL-padded to 511 bytes and 0x1A, then the rows
    bottom-up, a colour image's bands one after another in each row."""
    try:
        kind = {"L": "Greyscale", "LA": "LA", "RGB": "RGB",
                "RGBA": "RGBA"}[mode]
    except KeyError as e:
        raise ValueError(f"Cannot save {mode} images as IM") from e
    h, w, _ = px.shape
    lines = [f"Image type: {kind} image\r\n"]
    if filename:
        name, ext = os.path.splitext(os.path.basename(filename))
        lines.append(f"Name: {name[:92 - len(ext)]}{ext}\r\n")
    lines += [f"Image size (x*y): {w}*{h}\r\n",
              "File size (no of images): 1\r\n"]
    header = "".join(lines).encode("ascii")
    header += b"\0" * (511 - len(header)) + b"\x1a"
    _check_size(px)
    return header + _planar_rows(px)[::-1].tobytes()


def save_qoi(px: np.ndarray, mode: str, filename: str) -> bytes:
    """QoiImagePlugin._save and its QoiEncoder (colourspace byte 1), by
    core/qoi.encode_qoi: RGB and RGBA only."""
    if mode not in ("RGB", "RGBA"):
        raise ValueError("Unsupported QOI image mode")
    if 0 in px.shape[:2]:
        raise ValueError("Size cannot be negative")
    from tracerboy_tpu_torch.core.qoi import encode_qoi

    return encode_qoi(px)


def save_dds(px: np.ndarray, mode: str, filename: str) -> bytes:
    """DdsImagePlugin._save, uncompressed: the 124-byte header with
    PITCH, L and LA as luminance (PIL's masks), RGB as BGR and RGBA as
    BGRA bytes; rows top-down."""
    h, w, c = px.shape
    if mode[0] == "L":
        flags = 0x20000 | (1 if c == 2 else 0)
        masks = [0xFF] * 3 + [0xFF000000] if c == 2 else [0xFF000000] * 3 + [0]
        data = px
    else:
        flags = 0x40 | (1 if c == 4 else 0)
        masks = [0xFF0000, 0xFF00, 0xFF, 0xFF000000 if c == 4 else 0]
        data = px[..., [2, 1, 0, 3][:c]]
    header = (b"DDS " + struct.pack("<7I", 124, 0x1 | 0x2 | 0x4 | 0x8 | 0x1000,
                                     h, w, (w * 8 * c + 7) // 8, 0, 0)
              + b"\0" * 44 + struct.pack("<4I", 32, flags, 0, 8 * c)
              + struct.pack("<4I", *masks)
              + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    _check_size(px)
    return header + np.ascontiguousarray(data).tobytes()


def pcx_rle(lines: np.ndarray, padding: int) -> bytes:
    """PcxEncode.c on (rows, bytes a line) plane lines: runs of equal
    bytes of at most 63, a run of one byte below 0xC0 as the byte itself,
    any other as 0xC0 | length and the byte; each line's `padding` zero
    bytes after its runs, uncoded."""
    from tracerboy_tpu_torch.core.sgi import packets, row_runs

    r, n = lines.shape
    row, _, length, value = row_runs(lines, 63)
    heads = np.where((length > 1) | (value >= 0xC0), 0xC0 | length, -1)
    stream = packets(heads, value)
    if not padding:
        return stream.tobytes()
    ends = np.cumsum(np.bincount(row, weights=1 + (heads >= 0),
                                 minlength=r)).astype(np.int64)
    out = np.zeros(len(stream) + r * padding, np.uint8)
    src = np.arange(len(stream))
    line_of = np.searchsorted(ends, src, side="right")
    out[src + line_of * padding] = stream
    return out.tobytes()


def save_pcx(px: np.ndarray, mode: str, filename: str) -> bytes:
    """PcxImagePlugin._save: version 5, 8 bits, one plane (L) or three
    (RGB, each line's planes in turn), 100 dpi, lines of an even number
    of bytes; PcxEncode.c's runs; an L image's grey palette after 0x0C."""
    try:
        planes = {"L": 1, "RGB": 3}[mode]
    except KeyError as e:
        raise ValueError(f"Cannot save {mode} images as PCX") from e
    h, w, _ = px.shape
    stride = w + w % 2
    header = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1,
                          100, 100) + b"\0" * 24 + b"\xff" * 24 + b"\0"
              + struct.pack("<BHHHH", planes, stride, 1, w, h) + b"\0" * 54)
    lines = _planar_rows(px)
    if w == 1:
        # PcxEncode.c's line loop ends before it flushes the last plane
        # of a one-byte line.
        lines = lines[:, :planes - 1 or 1]
    body = pcx_rle(lines.reshape(-1, w), stride - w)
    if mode == "L":
        body += b"\x0c" + bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    return header + body


# ----------------------------------------------------------------------------
# JPEG 2000

_J2K_COMMENT = b"Created by OpenJPEG version 2.5.4"


def j2k_codestream(px: np.ndarray) -> bytes:
    """OpenJPEG 2.5.4's codestream at PIL's defaults (Jpeg2KImagePlugin
    _save and Jpeg2KEncode.c): one tile, 6 resolutions or as many as the
    smaller side allows (2^(n-1) <= it), the reversible 5/3 wavelet, no
    component transform, 64x64 code-blocks, one lossless layer, LRCP;
    SOC, SIZ, COD, QCD (no quantisation, 2 guard bits, each band's
    exponent 8 + its gain), OpenJPEG's COM, SOT, SOD, the packets
    (csrc/j2k_encode.cpp), EOC."""
    from tracerboy_tpu_torch.core.codecs import j2k_encode_library

    h, w, c = px.shape
    _check_size(px)
    numres = 6
    while numres > 1 and 1 << (numres - 1) > min(w, h):
        numres -= 1
    levels = numres - 1
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, c) + (
        b"\x07\x01\x01" * c)
    cod = struct.pack(">BBHBBBBBB", 0, 0, 1, 0, levels, 4, 4, 0, 1)
    qcd = bytes([0x40, 8 << 3] + [9 << 3, 9 << 3, 10 << 3] * levels)
    cap = 4096 + 2 * px.size
    body = np.empty(cap, np.uint8)
    n = j2k_encode_library().tb_j2k_encode_tile(
        px.ctypes.data, h, w, c, numres, body.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("JPEG 2000 tile larger than its buffer")
    sot = struct.pack(">HIBB", 0, 12 + 2 + n, 0, 1)
    return (b"\xff\x4f" + _segment(0x51, siz) + _segment(0x52, cod)
            + _segment(0x5C, qcd) + _segment(0x64, b"\0\x01" + _J2K_COMMENT)
            + _segment(0x90, sot) + b"\xff\x93" + body[:n].tobytes()
            + b"\xff\xd9")


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def save_jpeg2000(px: np.ndarray, mode: str, filename: str) -> bytes:
    """Jpeg2KImagePlugin._save at its defaults: the bare codestream where
    the name ends in ".j2k" (as PIL tests it, case and all), else
    OpenJPEG's JP2 boxes around it: the signature, ftyp (jp2), jp2h with
    ihdr (8 bits, unknown colour space 0, no IPR), colr (sRGB or grey)
    and, for LA and RGBA, cdef naming the last channel opacity; jp2c."""
    stream = j2k_codestream(px)
    if filename.endswith(".j2k"):
        return stream
    h, w, c = px.shape
    header = (_box(b"ihdr", struct.pack(">IIHBBBB", h, w, c, 7, 7, 0, 0))
              + _box(b"colr", struct.pack(">BBBI", 1, 0, 0,
                                          16 if c >= 3 else 17)))
    if mode in ("LA", "RGBA"):
        channels = [(k, 0, k + 1) for k in range(c - 1)] + [(c - 1, 1, 0)]
        header += _box(b"cdef", struct.pack(">H", c) + b"".join(
            struct.pack(">HHH", *ch) for ch in channels))
    return (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", header) + _box(b"jp2c", stream))


# ----------------------------------------------------------------------------
# GIF


def _quantize(px: np.ndarray):
    """(indices (H, W), palette (n, bands)) as PIL's Image.convert("P",
    palette=ADAPTIVE) makes them: RGB by median cut, RGBA by the fast
    octree (csrc/gif_encode.cpp); no entry for an empty image."""
    from tracerboy_tpu_torch.core.codecs import gif_encode_library

    h, w, c = px.shape
    index = np.empty((h, w), np.uint8)
    palette = np.zeros((256, c), np.uint8)
    if not index.size:
        return index, palette[:0]
    lib = gif_encode_library()
    quantize = lib.tb_quantize_median if c == 3 else lib.tb_quantize_octree
    n = quantize(px.ctypes.data, h * w, index.ctypes.data,
                 palette.ctypes.data)
    return index, palette[:n]


def save_gif(px: np.ndarray, mode: str, filename: str) -> bytes:
    """GifImagePlugin._save of one frame at its defaults: L as it is and
    LA through convert("L") with a grey palette; RGB and RGBA quantised
    (_quantize; an RGBA palette's first entry of alpha 0 is the
    transparency). _get_optimize's palette, as optimize is on: an L
    image's used greys always; a quantised image's used entries under
    512 x 512 pixels where some entry is unused or the palette could be
    half its power-of-two size (an RGBA palette of more than 768 bytes
    kept with its alpha). GIF87a (89a with a transparency, which then
    gets a graphic control extension), the colour table padded to a
    power of two, the image descriptor (interlaced unless a side is below
    16), LZW minimum code size 8, the data sub-blocks
    (csrc/gif_encode.cpp), the block terminator and the trailer."""
    from tracerboy_tpu_torch.core.codecs import gif_encode_library

    h, w, c = px.shape
    transparency = None
    if mode in ("L", "LA"):
        index = px[..., 0]
        source = bytes(i // 3 for i in range(768))      # PIL's grey ramp
        alpha, optimise = False, True
    else:
        index, quantized = _quantize(px)
        source, alpha, optimise = quantized.tobytes(), c == 4, False
        if alpha:
            zero = np.flatnonzero(quantized[:, 3] == 0)
            transparency = int(zero[0]) if len(zero) else None
    palette = source
    used = np.flatnonzero(np.bincount(index.ravel(), minlength=256))
    if optimise or w * h < 512 * 512:
        remap = optimise
        if not optimise:
            if not len(used):
                raise ValueError("max() iterable argument is empty")
            size = 1 << (len(source) // (4 if alpha else 3) - 1).bit_length()
            remap = (used[-1] >= len(used)
                     or (len(used) <= size // 2 and size > 2))
        if remap:
            # Image.remap_palette: entries of 4 bytes where the palette
            # holds more than 768.
            bands = 4 if len(source) > 768 else 3
            palette = b"".join(source[k * bands:(k + 1) * bands] for k in used)
            alpha = bands == 4
            lut = np.zeros(256, np.uint8)
            lut[used] = np.arange(len(used))
            index = lut[index]
            if transparency is not None:
                hit = np.flatnonzero(used == transparency)
                transparency = int(hit[0]) if len(hit) else None
    rgb = b"".join(palette[i * 4:i * 4 + 3] for i in range(len(palette) // 3)
                   ) if alpha else palette
    size = 0 if not rgb else 1 if len(rgb) < 9 else (
        math.ceil(math.log(len(rgb) // 3, 2)) - 1)
    rgb += b"\0" * 3 * max((2 << size) - len(rgb) // 3, 0)
    out = [b"GIF" + (b"89a" if transparency is not None else b"87a")
           + struct.pack("<HHBBB", w, h, size + 128, 0, 0) + rgb]
    if transparency is not None:
        out.append(b"!\xf9\x04\x01\0\0" + bytes([transparency]) + b"\0")
    interlace = 1 if min(w, h) >= 16 else 0
    out.append(b"," + struct.pack("<HHHHB", 0, 0, w, h, 64 * interlace)
               + b"\x08")
    _check_size(px)
    index = np.ascontiguousarray(index, np.uint8)
    cap = 64 + 2 * index.size + index.size // 128
    data = np.empty(cap, np.uint8)
    n = gif_encode_library().tb_gif_lzw(index.ctypes.data, h, w, interlace,
                                        data.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("GIF data larger than its buffer")
    return b"".join(out) + data[:n].tobytes() + b"\0;"


# ----------------------------------------------------------------------------
# EPS/PS and PDF


def save_eps(px: np.ndarray, mode: str, filename: str) -> bytes:
    """EpsImagePlugin._save (EPS header, then the image operator) and
    EpsEncode.c: L as `image`, RGB as `false 3 colorimage`, the samples
    as lowercase hex, a newline before each run of 39 more bytes."""
    try:
        bands, operator = {"L": (1, b"image"),
                           "RGB": (3, b"false 3 colorimage")}[mode]
    except KeyError as e:
        raise ValueError("image mode is not supported") from e
    h, w, _ = px.shape
    head = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%Creator: PIL 0.1 EpsEncode\n"
            + b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h)
            + b"%%Pages: 1\n%%EndComments\n%%Page: 1 1\n"
            + b"%%ImageData: %d %d " % (w, h)
            + b'%d %d 0 1 1 "%s"\n' % (8, bands, operator)
            + b"gsave\n10 dict begin\n/buf %d string def\n" % (w * bands)
            + b"%d %d scale\n%d %d 8\n" % (w, h, w, h)
            + b"[%d 0 0 -%d 0 %d]\n" % (w, h, h)
            + b"{ currentfile buf readhexstring pop } bind\n"
            + operator + b"\n")
    _check_size(px)
    hexed = px.tobytes().hex().encode("ascii")
    lines = b"\n".join(hexed[i:i + 78] for i in range(0, len(hexed), 78))
    # PIL writes this line unformatted: four percent signs.
    return head + lines + b"\n%%%%EndBinary\ngrestore end\n"


def _pdf_repr(x) -> bytes:
    """PdfParser.pdf_repr of the values PdfImagePlugin writes: names
    (str starting "/"), references (tuples), dicts, lists, numbers,
    struct_time dates and byte strings."""
    if isinstance(x, str):
        return x.encode("ascii")
    if isinstance(x, time.struct_time):
        stamp = time.strftime("%Y%m%d%H%M%SZ", x).encode("ascii")
        return b"(D:" + stamp + b")"
    if isinstance(x, tuple):
        return b"%d %d R" % x
    if isinstance(x, dict):
        return b"<<" + b"".join(
            b"\n/" + k.encode("ascii") + b" " + _pdf_repr(v)
            for k, v in x.items()) + b"\n>>"
    if isinstance(x, list):
        return b"[ " + b" ".join(_pdf_repr(v) for v in x) + b" ]"
    if isinstance(x, (int, float)):
        return str(x).encode("ascii")
    x = x.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)")
    return b"(" + x + b")"


def save_pdf(px: np.ndarray, mode: str, filename: str) -> bytes:
    """PdfImagePlugin._save of one image at its defaults through
    PdfParser: the header and comment, the catalog (4) and pages (5)
    objects, the image XObject (1: L and RGB as DCTDecode through
    save_jpeg, LA and RGBA as JPXDecode through save_jpeg2000 with
    SMaskInData), the page (2, 72 dpi) and its contents (3), the info
    dictionary (6: the title, the file's name without its extension as
    UTF-16; the creation and modification dates from two time.gmtime()
    calls), the xref table and the trailer."""
    h, w, _ = px.shape
    info = {"Title": os.path.splitext(os.path.basename(filename))[0],
            "CreationDate": time.gmtime(), "ModDate": time.gmtime()}
    info = {k: v for k, v in info.items() if v}
    if mode in ("L", "RGB"):
        image = dict(Type="/XObject", Subtype="/Image", Width=w, Height=h,
                     Filter="/DCTDecode", BitsPerComponent=8,
                     ColorSpace="/DeviceGray" if mode == "L"
                     else "/DeviceRGB")
        stream = save_jpeg(px, mode, filename)
    else:
        image = dict(Type="/XObject", Subtype="/Image", Width=w, Height=h,
                     Filter="/JPXDecode", SMaskInData=1)
        stream = save_jpeg2000(px, mode, filename)
    procset = "/ImageB" if mode in ("L", "LA") else "/ImageC"
    out = [b"%PDF-1.4\n% created by Pillow PDF driver\n"]
    offsets = {}

    def obj(ref: int, body: dict, stream: bytes | None = None) -> None:
        offsets[ref] = sum(map(len, out))
        if stream is not None:
            body = dict(body, Length=len(stream))
        out.append(b"%d 0 obj" % ref + _pdf_repr(body))
        if stream is not None:
            out.append(b"stream\n" + stream + b"\nendstream\n")
        out.append(b"endobj\n")

    obj(4, dict(Type="/Catalog", Pages=(5, 0)))
    obj(5, dict(Type="/Pages", Count=1, Kids=[(2, 0)]))
    obj(1, image, stream)
    size = (w * 72.0 / 72.0, h * 72.0 / 72.0)
    obj(2, dict(Resources=dict(ProcSet=["/PDF", procset],
                               XObject=dict(image=(1, 0))),
                MediaBox=[0, 0, *size], Contents=(3, 0), Type="/Page",
                Parent=(5, 0)))
    obj(3, {}, b"q %f 0 0 %f 0 0 cm /image Do Q\n" % size)
    if "Title" in info:
        info["Title"] = codecs.BOM_UTF16_BE + info["Title"].encode(
            "utf_16_be")
    obj(6, info)
    xref = sum(map(len, out))
    out.append(b"xref\n0 7\n0000000000 65536 f \n" + b"".join(
        b"%010d %05d n \n" % (offsets[k], 0) for k in range(1, 7)))
    out.append(b"trailer\n" + _pdf_repr(dict(Root=(4, 0), Size=7,
                                             Info=(6, 0)))
               + b"\nstartxref\n%d\n%%%%EOF" % xref)
    return b"".join(out)


# ----------------------------------------------------------------------------
# ICO and ICNS

_ICO_SIZES = (16, 24, 32, 48, 64, 128, 256)
# IcnsImagePlugin._save's types and sizes, in its dict's order.
_ICNS_TYPES = ((b"ic07", 128), (b"ic08", 256), (b"ic09", 512),
               (b"ic10", 1024), (b"ic11", 32), (b"ic12", 64), (b"ic13", 256),
               (b"ic14", 512))


def save_ico(px: np.ndarray, mode: str, filename: str) -> bytes:
    """IcoImagePlugin._save at its defaults: for each of the seven
    sizes (16-256) that fits in the image, the image's LANCZOS thumbnail
    of that box (the image itself where it is that size) as a PNG; the
    header, 16-byte entries (width and height, 256 as 0; 32 bits; the
    PNG's length and offset), the PNGs. An image under 16 pixels a side
    has no entry."""
    from tracerboy_tpu_torch.core.resample import (
        LANCZOS,
        resize,
        thumbnail_size,
    )

    h, w, _ = px.shape
    frames = [resize(px, mode, thumbnail_size(w, h, (side, side)), LANCZOS)
              for side in _ICO_SIZES if side <= w and side <= h]
    pngs = [save_png(frame, mode, filename) for frame in frames]
    offset = 6 + 16 * len(frames)
    entries = []
    for frame, png in zip(frames, pngs):
        fh, fw = frame.shape[:2]
        entries.append(struct.pack("<BBBBHHII", fw % 256, fh % 256, 0, 0, 0,
                                   32, len(png), offset))
        offset += len(png)
    return (b"\0\0\1\0" + struct.pack("<H", len(frames)) + b"".join(entries)
            + b"".join(pngs))


def save_icns(px: np.ndarray, mode: str, filename: str) -> bytes:
    """IcnsImagePlugin._save: the image's BICUBIC resize to each of its
    six sizes (32-1024, an empty image's all zeros) as a PNG; the icns
    magic and total length, the TOC of the eight types and their entry
    lengths, then each type's entry (256 and 512 each written twice)."""
    from tracerboy_tpu_torch.core.resample import BICUBIC, resize

    streams = {}
    for _, side in _ICNS_TYPES:
        if side not in streams:
            streams[side] = save_png(resize(px, mode, (side, side), BICUBIC),
                                     mode, filename)
    entries = [(kind, 8 + len(streams[side]), streams[side])
               for kind, side in _ICNS_TYPES]
    toc = b"TOC " + struct.pack(">i", 8 + 8 * len(entries)) + b"".join(
        kind + struct.pack(">i", n) for kind, n, _ in entries)
    total = 8 + len(toc) + sum(n for _, n, _ in entries)
    return b"icns" + struct.pack(">i", total) + toc + b"".join(
        kind + struct.pack(">i", n) + stream for kind, n, stream in entries)


# ----------------------------------------------------------------------------
# WebP

_WEBP_MAX = 16383


def _call_encoder(fn, px, w, h, cap):
    """fn(px, w, h, out, cap) of a libwebp port: the bytes it writes, with
    more room where it asks for it (a return below -3 is -(the size); -1
    to -3 are errors)."""
    import ctypes

    def encode(cap):
        out = np.empty(cap, np.uint8)
        return out, fn(px.ctypes.data_as(ctypes.c_void_p), w, h,
                       out.ctypes.data_as(ctypes.c_void_p), cap)

    out, n = encode(cap)
    if n < -3:
        out, n = encode(-n)
    if n == -2:   # VP8_ENC_ERROR_PARTITION0_OVERFLOW, as _webp reports it
        raise ValueError("encoding error 6")
    if n < 0:
        raise RuntimeError(f"{fn.__name__} failed ({n})")
    return out[:n].tobytes()


def webp_encode(px: np.ndarray) -> bytes:
    """The .webp file libwebp's WebPEncode writes at quality 80 for an
    (H, W, 3) uint8 image, or an (H, W, 4) one whose alpha is below 255
    somewhere: a RIFF "VP8 " chunk (csrc/webp_encode.cpp); with alpha, a
    "VP8X" chunk with the alpha flag, the "ALPH" chunk of the alpha plane
    (csrc/webp_alpha_encode.cpp) and the "VP8 " chunk of the colours
    weighted by alpha, transparent blocks flattened (syntax_enc.c)."""
    from tracerboy_tpu_torch.core.codecs import (
        webp_alpha_library,
        webp_encode_library,
    )

    px = np.ascontiguousarray(px, np.uint8)
    h, w, c = px.shape
    lib = webp_encode_library()
    if c == 3:
        return _call_encoder(lib.tb_webp_encode, px, w, h, 4096 + 4 * h * w)
    vp8 = _call_encoder(lib.tb_webp_encode_rgba, px, w, h, 4096 + 4 * h * w)
    alpha = np.ascontiguousarray(px[..., 3])
    alph = _call_encoder(webp_alpha_library().tb_webp_alpha_encode, alpha, w,
                         h, 64 + h * w)
    chunk = (b"ALPH" + struct.pack("<I", len(alph)) + alph
             + b"\0" * (len(alph) & 1))
    vp8x = (b"VP8X" + struct.pack("<II", 10, 0x10)
            + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))
    body = b"WEBP" + vp8x + chunk + vp8[12:]
    return b"RIFF" + struct.pack("<I", len(body)) + body


def save_webp(px: np.ndarray, mode: str, filename: str) -> bytes:
    """WebPImagePlugin._save at its defaults (lossy, quality 80,
    alpha_quality 100, method 4): L as RGB and LA as RGBA
    (_convert_frame); an empty image raises MemoryError and a side over
    16383 ValueError, as _webp does; an image whose alpha is 255
    throughout is coded as its RGB, which is what libwebp does with it."""
    h, w, c = px.shape
    if c < 3:
        px = np.concatenate([np.repeat(px[..., :1], 3, axis=2), px[..., 1:]],
                            axis=2)
    if not px.size:
        raise MemoryError("can't allocate picture frame")
    if w > _WEBP_MAX or h > _WEBP_MAX:
        raise ValueError("encoding error 5: Image size exceeds WebP limit "
                         f"of {_WEBP_MAX} pixels")
    if px.shape[2] == 4 and (px[..., 3] != 255).any():
        return webp_encode(px)
    return webp_encode(px[..., :3])


# ----------------------------------------------------------------------------
# What PIL refuses, and what is not ported yet


def _refuse_mode(exc, message):
    def save_refused(px, mode, filename):
        raise exc(message.format(mode=mode))
    return save_refused


def _stub(fmt):
    def save_stub(px, mode, filename):
        raise OSError(f"{fmt} save handler not installed")
    return save_stub


def _later(fmt):
    def save_later(px, mode, filename):
        raise NotImplementedError(f"writing {fmt}: {ITEM}")
    return save_later


# Image.SAVE for the formats of EXTENSION: PIL 12.1's save handlers.
SAVE = {
    "JPEG": save_jpeg, "MPO": save_jpeg, "PNG": save_png, "BMP": save_bmp,
    "DIB": save_dib, "TGA": save_tga, "PPM": save_ppm, "TIFF": save_tiff,
    "SGI": save_sgi, "IM": save_im, "QOI": save_qoi, "DDS": save_dds,
    "PCX": save_pcx,
    "MSP": _refuse_mode(OSError, "cannot write mode {mode} as MSP"),
    "XBM": _refuse_mode(OSError, "cannot write mode {mode} as XBM"),
    "PALM": _refuse_mode(OSError, "cannot write mode {mode} as Palm"),
    "BLP": _refuse_mode(ValueError, "Unsupported BLP image mode"),
    **{fmt: _stub(fmt) for fmt in ("BUFR", "GRIB", "HDF5", "WMF")},
    "JPEG2000": save_jpeg2000, "GIF": save_gif, "EPS": save_eps,
    "PDF": save_pdf, "ICO": save_ico, "ICNS": save_icns,
    "WEBP": save_webp, "AVIF": _later("AVIF"),
}
