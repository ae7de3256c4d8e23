"""Image input/output: PNG, Radiance HDR (.hdr), PFM, and OpenEXR.

Replaces the reference's DirectXTex usage (TracerBoy/TracerBoy.cpp:2204-2227
loads WIC/HDR/TGA/DDS; D3D12App.cpp:341-364 writes PNG captures). Everything
here is host-side numpy; results feed the scene compiler which moves arrays to
device.

A numpy copy of tracerboy_tpu/core/image_io.py that needs no imaging
library (the port does not depend on PIL): PNG is read and written by the
codec below, on zlib and struct.

Formats:
- PNG: read by read_png (every colour type and bit depth, palettes,
  Adam7; row filters undone by csrc/png_unfilter.cpp) and converted as
  the JAX read_ldr's PIL calls convert it. write_png writes the format
  the path's extension names, byte for byte as PIL's Image.save writes
  it (core/image_save.py).
- TGA (read_tga: uncompressed and RLE; colour-mapped with 16- and
  24-bit maps, grey at 1, 8 and 16 bits, colour at 16, 24 and 32 bits;
  either origin) and BMP (read_bmp: OS/2 to V5 headers; 1-, 4- and
  8-bit palettes, 16-bit 555/565, 24- and 32-bit; the bit-field layouts
  PIL reads; RLE8 and RLE4; bottom-up and top-down), converted as PIL
  converts them, PIL's quirks included; write_tga and write_bmp write
  the uncompressed files the demo scenes need. Each format is
  recognised by its header, as PIL recognises it.
- DDS: read by core/dds.py (BC1-BC7 blocks by csrc/dds_decode.cpp),
  PIL's pixels bit for bit.
- TIFF (core/tiff.py: classic and BigTIFF, none/LZW/Deflate/PackBits,
  JPEG, Zstandard, LZMA, CCITT, ThunderScan, predictors 2 and 3, strips
  and tiles, planar 1 and 2, grey at 1-16 bits and float, RGB(A) at 8
  and 16 bits, palette, CMYK, YCbCr, CIELab), GIF (core/gif.py: the
  first frame) and ICO (core/ico.py: PNG and BMP entries), their loops
  in csrc/lzw_codecs.cpp and csrc/tiff_codecs.cpp; PIL's pixels bit for
  bit. With PNG, BMP, JPEG and DDS these are the formats the reference
  reads through WIC.
- JPEG: read by core/jpeg.py (csrc/jpeg_decode.cpp), PIL's pixels bit
  for bit.
- WebP (core/webp.py: simple and extended files, VP8, VP8L, ALPH, an
  animation's first frame) and QOI (core/qoi.py), their loops in
  csrc/webp_decode.cpp; PNM (core/pnm.py: P1-P6, Pf, PIL's own headers)
  and PSD (core/psd.py: the merged image, raw or PackBits); PIL's pixels
  bit for bit. pbrt-v4 reads QOI, PNM and PSD too.
- JPEG 2000 (core/jpeg2000.py: JP2 files and raw codestreams, the 5/3
  and 9/7 wavelets, every progression order, tiles, layers, precincts,
  palettes; csrc/j2k_decode.cpp decodes the tiles), PIL's pixels bit for
  bit as OpenJPEG and Pillow's decoder give them.
- AVIF (core/avif.py: the HEIF box tree as libavif walks it, alpha and
  premultiplied alpha, an animation's first frame; csrc/av1_decode.cpp
  decodes the AV1 intra frame, intra block copy, deblocking, CDEF, loop
  restoration and film grain included, and converts YUV to RGB as
  libavif and libyuv do), PIL's pixels bit for bit as dav1d and libavif
  give them; the rest of AVIF part 2 (superres, high bit depth, ...)
  raises NotImplementedError (ROADMAP item 22b).
- PIL's small texture formats: SGI (core/sgi.py), PCX and DCX
  (core/pcx.py), CUR and DIB (core/ico.py), FTEX (core/ftex.py), BLP
  (core/blp.py), ICNS (core/icns.py), IM (core/im.py), Sun raster
  (core/sun.py), XBM (core/xbm.py), XPM (core/xpm.py), MSP
  (core/msp.py), PIXAR, GBR, IMT, McIdas, SPIDER and XVThumb
  (core/rawformats.py), FITS (core/fits.py), FLI (core/fli.py), IPTC
  (core/iptc.py) and PCD (core/pcd.py), their RLE, hex, bit and FLI
  chunk loops in csrc/small_decode.cpp; PIL's pixels bit for bit.
  decode_ldr tries every reader in PIL's Image.open order (readers());
  PIL's stub plugins (BUFR, GRIB, HDF5, MPEG, WMF: core/stubs.py) and
  EPS (core/eps.py: rendered only by Ghostscript) are refused as PIL
  refuses them.
- Radiance HDR (RGBE, RLE): from the published file format spec.
- PFM: trivial float format (the reference renames .pfm -> .hdr as a hack;
  we read it natively).
- EXR: minimal scanline reader/writer (NONE, ZIP/ZIPS compressed; HALF/FLOAT
  channels). PIZ-compressed files (the Tungsten goldens) are handled by
  `read_exr` via the `piz` module.
"""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np


# ----------------------------------------------------------------------------
# PNG


def read_ldr(path: str, gamma_to_linear: bool = False) -> np.ndarray:
    """Read an LDR image to float32 RGB(A) in [0,1]: the values the JAX
    read_ldr gets through PIL (decode_ldr / 255; with gamma_to_linear the
    colour channels raised to 2.2)."""
    arr = decode_ldr(path).astype(np.float32) / 255.0
    if gamma_to_linear:
        arr = arr.copy()
        arr[..., :3] = np.power(arr[..., :3], 2.2)
    return arr


def decode_ldr(path: str) -> np.ndarray:
    """An LDR image file's pixels as (H, W, 3|4) uint8, as the JAX
    read_ldr gets them from PIL before its / 255 (grey and palette images
    become RGB, grey with alpha RGBA; PNG: 16-bit samples keep their high
    byte, 16-bit grey is clipped at 255, a tRNS chunk is ignored; BMP and
    DIB: 32-bit pixels without an alpha mask lose their fourth byte; JPEG:
    core/jpeg.py, grey replicated to RGB; DDS: core/dds.py; TIFF:
    core/tiff.py, the first image, 16-bit grey clipped at 255, float
    clipped and truncated, CMYK converted, CIELab to RGBA; GIF:
    core/gif.py, the first frame, its transparency dropped; ICO and CUR: core/ico.py, the largest
    entry (an ICO's DIB with its AND mask or fourth byte as alpha, a CUR's
    without); JPEG 2000: core/jpeg2000.py, 16-bit grey clipped at 255, a
    palette expanded, CMYK converted; PNM: core/pnm.py, 16-bit grey
    clipped at 255; PSD: core/psd.py, the merged image; QOI: core/qoi.py;
    WebP: core/webp.py, an animation's first frame on its canvas; AVIF:
    core/avif.py, an animation's first frame, alpha un-premultiplied; PCX
    and DCX's first page: core/pcx.py; SGI: core/sgi.py, 16-bit samples'
    high byte; FTEX: core/ftex.py, mipmap 0; BLP: core/blp.py, mipmap 0;
    ICNS: core/icns.py, its best entry, a PNG entry in its own mode;
    IM: core/im.py, the first frame, every type PIL reads, a colour Lut
    as a palette; Sun raster: core/sun.py, raw and RLE; XBM:
    core/xbm.py; XPM: core/xpm.py, P or RGB, "None" dropped; MSP:
    core/msp.py, DanM and LinS; PIXAR, GBR, IMT, McIdas, SPIDER (float
    truncated and clipped, a stack's first image) and XVThumb:
    core/rawformats.py; BUFR, GRIB, HDF5, MPEG and WMF: core/stubs.py,
    refused, as PIL has no loader for them; EPS: core/eps.py, refused
    where PIL identifies it, as PIL renders it only through
    Ghostscript;
    FITS: core/fits.py, raw and gzip tiles, PIL's little-endian raw modes
    on its big-endian samples; FLI: core/fli.py, the first frame; IPTC:
    core/iptc.py, raw or any file Image.open takes, a band merged; PCD:
    core/pcd.py, the base image, rotated).
    The readers are tried in PIL's order (readers()); a reader that
    cannot identify the file passes it on, as PIL's SyntaxError does, and
    a file no reader identifies raises NotImplementedError, as PIL raises
    UnidentifiedImageError."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_named(data, path)[1]


def decode_named(data: bytes, path: str = "<bytes>"):
    """decode_ldr on a file's bytes: (the format PIL's Image.open would
    read it as, its pixels)."""
    unidentified = None
    for name, accepts, read in readers():
        if not accepts(data):
            continue
        try:
            return name, read(data, path)
        except UnidentifiedImageError as e:   # PIL tries the next
            unidentified = unidentified or e
    raise UnidentifiedImageError(f"{path}: cannot identify image file") \
        from unidentified


_READERS = None


def readers():
    """PIL 12.1's Image.open order as (format, accepts, read) triples:
    the plugins preinit() registers (BMP, DIB, GIF, JPEG, PPM, PNG), then
    the rest in Image.ID's order after init(). accepts is the plugin's
    _accept where it has one (PCD, which has none, takes _open's check;
    IPTC, neither: its reader identifies the file), read the port's
    reader of the format. TGA, which has no signature, is taken where
    its header fields are ones PIL's plugin reads."""
    global _READERS
    if _READERS is None:
        from tracerboy_tpu_torch.core import (
            avif,
            blp,
            dds,
            eps,
            fits,
            fli,
            ftex,
            gif,
            icns,
            ico,
            im,
            iptc,
            jpeg2000,
            msp,
            pcd,
            pcx,
            pnm,
            psd,
            qoi,
            rawformats,
            sgi,
            stubs,
            sun,
            tiff,
            webp,
            xbm,
            xpm,
        )
        from tracerboy_tpu_torch.core.jpeg import open_jpeg

        _READERS = (
            ("BMP", lambda d: d.startswith(b"BM"), read_bmp),
            ("DIB", ico.is_dib, ico.read_dib),
            ("GIF", gif.is_gif, gif.read_gif),
            ("JPEG", lambda d: d.startswith(b"\xff\xd8\xff"), open_jpeg),
            ("PPM", pnm.is_pnm, pnm.read_pnm),
            ("PNG", lambda d: d.startswith(PNG_SIGNATURE), read_png_file),
            ("AVIF", avif.is_avif, avif.read_avif),
            ("BLP", blp.is_blp, blp.read_blp),
            ("BUFR", stubs.is_bufr, stubs.read_bufr),
            ("CUR", ico.is_cur, ico.read_cur),
            ("PCX", pcx.is_pcx, pcx.read_pcx),
            ("DCX", pcx.is_dcx, pcx.read_dcx),
            ("DDS", lambda d: d.startswith(DDS_MAGIC), dds.read_dds),
            ("EPS", eps.is_eps, eps.read_eps),
            ("FITS", fits.is_fits, fits.read_fits),
            ("FLI", fli.is_fli, fli.read_fli),
            ("FTEX", ftex.is_ftex, ftex.read_ftex),
            ("GBR", rawformats.is_gbr, rawformats.read_gbr),
            ("GRIB", stubs.is_grib, stubs.read_grib),
            ("HDF5", stubs.is_hdf5, stubs.read_hdf5),
            ("JPEG2000", jpeg2000.is_jpeg2000, jpeg2000.read_jpeg2000),
            ("ICNS", icns.is_icns, icns.read_icns),
            ("ICO", ico.is_ico, ico.read_ico),
            ("IM", im.is_im, im.read_im),
            ("IMT", rawformats.is_imt, rawformats.read_imt),
            ("IPTC", lambda d: True, iptc.read_iptc),
            ("MCIDAS", rawformats.is_mcidas, rawformats.read_mcidas),
            ("MPEG", stubs.is_mpeg, stubs.read_mpeg),
            ("TIFF", tiff.is_tiff, tiff.read_tiff),
            ("MSP", msp.is_msp, msp.read_msp),
            ("PCD", pcd.is_pcd, pcd.read_pcd),
            ("PIXAR", rawformats.is_pixar, rawformats.read_pixar),
            ("PSD", psd.is_psd, psd.read_psd),
            ("QOI", qoi.is_qoi, qoi.read_qoi),
            ("SGI", sgi.is_sgi, sgi.read_sgi),
            ("SPIDER", rawformats.is_spider, rawformats.read_spider),
            ("SUN", sun.is_sun, sun.read_sun),
            ("TGA", lambda d: _tga_header(d) is not None, read_tga),
            ("WEBP", webp.is_webp, webp.read_webp),
            ("WMF", stubs.is_wmf, stubs.read_wmf),
            ("XBM", xbm.is_xbm, xbm.read_xbm),
            ("XPM", xpm.is_xpm, xpm.read_xpm),
            ("XVTHUMB", rawformats.is_xvthumb, rawformats.read_xvthumb),
        )
    return _READERS


# PIL's Image.MAX_IMAGE_PIXELS: Image.open refuses twice as many.
MAX_IMAGE_PIXELS = int(1024 * 1024 * 1024 // 4 // 3)


def check_image_size(width: int, height: int, path: str) -> None:
    """Image.open's checks after a plugin's header: a side that is not
    positive is not identified (ImageFile's SyntaxError: PIL tries its
    other plugins), more than twice MAX_IMAGE_PIXELS is refused
    (DecompressionBombError, ValueError here)."""
    if width <= 0 or height <= 0:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     f"(size {width}x{height})")
    if width * height > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"{path}: {width}x{height} pixels is more than "
                         "PIL opens (decompression bomb)")


class UnidentifiedImageError(NotImplementedError, OSError):
    """A file whose header names a format that its reader then cannot
    identify (where PIL's plugin raises SyntaxError, IndexError, TypeError
    or struct.error): PIL passes such a file on to the formats it tries
    later, and raises UnidentifiedImageError where none takes it. An
    OSError, as PIL's is."""


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
DDS_MAGIC = b"DDS "
# Colour type -> (samples a pixel, allowed bit depths).
PNG_FORMATS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

_png_lib = None


def png_library():
    """csrc/png_unfilter.cpp (tb_png_unfilter for the reader, tb_png_filter
    for core/image_save.py's writer), built with g++ at first use."""
    global _png_lib
    if _png_lib is None:
        import ctypes

        from tracerboy_tpu_torch.utils.build import (
            REPO_ROOT,
            build_shared_library,
        )

        lib = ctypes.CDLL(str(build_shared_library(
            "tbpng", [REPO_ROOT / "tracerboy_tpu_torch" / "csrc"
                      / "png_unfilter.cpp"],
            ["g++", "-O2", "-shared", "-fPIC"])))
        for fn in (lib.tb_png_unfilter, lib.tb_png_filter):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int64]
        _png_lib = lib
    return _png_lib


def _unfilter(raw: np.ndarray, rows: int, rowbytes: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the row filters of one image or Adam7 pass
    (csrc/png_unfilter.cpp); (rows, rowbytes) uint8."""
    src = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((rows, rowbytes), np.uint8)
    bad = png_library().tb_png_unfilter(src.ctypes.data, out.ctypes.data,
                                        rows, rowbytes, bpp)
    if bad:
        raise ValueError(f"{path}: unknown PNG filter type "
                         f"{int(src[(bad - 1) * (rowbytes + 1)])} in row "
                         f"{bad - 1}")
    return out


def _png_chunks(data: bytes, path: str):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        n, kind = struct.unpack_from(">I4s", data, pos)
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated PNG ({kind!r} chunk cut "
                             "short)")
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def read_png(path: str):
    """Decode a PNG file to its samples: (samples, colour type, bit depth,
    palette). samples is (H, W, C) uint8, or uint16 at bit depth 16, the
    file's own sample values (palette indices for colour type 3); palette
    is (256, 3) uint8, zero past the PLTE entries (None without PLTE).
    Refuses a truncated file, a bad CRC or an unknown filter."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<png>"):
    """read_png on a PNG's bytes (data past its IEND chunk is ignored)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat, palette = None, [], None
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            n = len(body) // 3
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(body, np.uint8, 3 * n).reshape(n, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if (ctype not in PNG_FORMATS or depth not in PNG_FORMATS[ctype][1]
            or comp or filt or interlace > 1 or not w or not h):
        raise ValueError(f"{path}: unsupported PNG header {ihdr}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    chans = PNG_FORMATS[ctype][0]
    dec = zlib.decompressobj()
    raw = dec.decompress(b"".join(idat))
    if not dec.eof:
        raise ValueError(f"{path}: truncated PNG (image data cut short)")
    buf = np.frombuffer(raw, np.uint8)
    bits = depth * chans
    bpp = max(1, bits // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, chans), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw = (w - x0 + dx - 1) // dx
        ph = (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * bits + 7) // 8
        size = ph * (rowbytes + 1)
        if pos + size > buf.size:
            raise ValueError(f"{path}: truncated PNG (image data cut "
                             "short)")
        rows = _unfilter(buf[pos:pos + size], ph, rowbytes, bpp, path)
        pos += size
        if depth == 16:
            s = rows.view(">u2").astype(np.uint16)
        elif depth == 8:
            s = rows
        else:
            per = 8 // depth
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
            s = ((rows[..., None] >> shifts) & ((1 << depth) - 1)).reshape(
                ph, rowbytes * per)
        out[y0::dy, x0::dx] = s[:, :pw * chans].reshape(ph, pw, chans)
    return out, ctype, depth, palette


_CHUNK_TYPE = re.compile(rb"\w\w\w\w")


def read_png_file(data: bytes, path: str = "<png>") -> np.ndarray:
    """A PNG file as the JAX read_ldr gets it through PIL: PngImageFile's
    _open walks the chunks up to the first IDAT, and gives a file up
    (PIL's SyntaxError or struct.error: UnidentifiedImageError here, the
    file passed on) where a chunk's header or CRC is cut short, its type
    is not four word characters or its CRC does not match; a chunk's body
    cut short there is refused (PIL's OSError: ValueError). Then
    png_to_8bit of decode_png."""
    pos = len(PNG_SIGNATURE)
    while True:
        head = data[pos:pos + 8]
        if len(head) < 8 or not _CHUNK_TYPE.match(head[4:]):
            raise UnidentifiedImageError(f"{path}: cannot identify image "
                                         "file (broken PNG chunk header)")
        (n,) = struct.unpack_from(">I", head)
        if head[4:] == b"IDAT":
            break
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError(f"{path}: truncated PNG ({head[4:]!r} chunk "
                             "cut short: Truncated File Read)")
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(
                head[4:] + body) & 0xFFFFFFFF:
            raise UnidentifiedImageError(f"{path}: cannot identify image "
                                         f"file (broken PNG: {head[4:]!r} "
                                         "checksum)")
        pos += 12 + n
    return png_to_8bit(*decode_png(data, path))


def png_to_8bit(samples, ctype, depth, palette) -> np.ndarray:
    """What PIL's Image.open(...).convert("RGB" or "RGBA") gives for a
    decoded PNG, as (H, W, 3 or 4) uint8: grey (bit depth 1, 2 and 4
    scaled to 0-255, 16 clipped at 255) and palette images become RGB, grey
    with alpha RGBA; other 16-bit samples keep their high byte."""
    if ctype == 3:
        return palette[samples[..., 0]]
    if depth == 16:
        s = (np.minimum(samples, 255) if ctype == 0
             else samples >> 8).astype(np.uint8)
    elif depth < 8:
        s = (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    else:
        s = samples
    if ctype == 0:
        return np.repeat(s, 3, axis=2)
    if ctype == 4:
        return s[..., [0, 0, 0, 1]]
    return s


_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}   # channels -> gray, RGB, RGBA


def png_chunk(kind: bytes, data: bytes) -> bytes:
    """One PNG chunk: length, type, body and CRC."""
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a float image in [0,1] or a uint8 one, quantised as the JAX
    write_png quantises it (clip, then x*255+0.5 truncated), in the format
    its path's extension names, as the JAX write_png's PIL Image.save
    writes it (core/image_save.py: PNG, JPEG, BMP, TGA, TIFF, ...; an
    extension PIL does not know raises ValueError)."""
    from tracerboy_tpu_torch.core.image_save import save

    save(path, _to_uint8(img))


def encode_png(img: np.ndarray) -> bytes:
    """A float image in [0,1] (H, W), (H, W, 3|4) or uint8 as an 8-bit
    PNG, quantised as write_png quantises it: IHDR, one IDAT of filter-0
    rows, IEND (the layout of the demo ICNS entries, core/icns.py)."""
    img = _to_uint8(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _PNG_COLOR_TYPES:
        raise ValueError(f"PNG needs 1, 3 or 4 channels, got {c}")
    rows = np.zeros((h, 1 + w * c), np.uint8)   # filter byte 0 per row
    rows[:, 1:] = np.ascontiguousarray(img).reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    return (PNG_SIGNATURE + png_chunk(b"IHDR", ihdr)
            + png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + png_chunk(b"IEND", b""))


# ----------------------------------------------------------------------------
# TGA and BMP (the readers follow PIL's TgaImagePlugin and BmpImagePlugin)

# Bits a pixel of each PIL raw mode the readers unpack (TGA, BMP, PCX,
# SGI and PIL's other small formats).
_RAW_BITS = {"1": 1, "1;I": 1, "P;1": 1, "P;2": 2, "P;4": 4, "L;4": 4,
             "P": 8, "L": 8, "LA": 16, "BGR;15": 16, "BGR;16": 16,
             "BGRA;15Z": 16, "RGB": 24, "BGR": 24, "RGBX": 32, "BGRX": 32,
             "XBGR": 32, "BGXR": 32, "ABGR": 32, "RGBA": 32, "BGRA": 32,
             "BGAR": 32, "LA;L": 16, "PA;L": 16, "RGB;L": 24, "YCbCr;L": 24,
             "RGBA;L": 32, "RGBX;L": 32, "CMYK;L": 32}
# One-band raw modes of wider samples: their numpy layout (PIL's I;16*,
# I;32* and F;* unpackers; F;32 is unsigned).
_RAW_SAMPLES = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4",
                "I;32S": "<i4", "I;32B": ">i4", "F;8": "u1", "F;8S": "i1",
                "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4",
                "F;32BF": ">f4"}
_RAW_BITS.update({k: 8 * int(v[-1]) for k, v in _RAW_SAMPLES.items()})


def unpack_raw(rows: np.ndarray, width: int, rawmode: str) -> np.ndarray:
    """PIL's unpacker for `rawmode` on (H, rowbytes) uint8 rows: (H, W, C)
    in the image's mode: bi-level 0/255 ("1"; 1;I with set bits black),
    indices (P), L (L;4 scaled by 17), LA, RGB, RGBA, CMYK and YCbCr
    uint8; I;16* as uint16, I as int32, F as float32. 5- and 6-bit fields
    scale as v * 255 // 31 (// 63); the 1-bit alpha of BGRA;15Z is
    inverted (set bit: alpha 0). The ";L" modes are planar rows: each
    band's samples of the row in turn."""
    bits = _RAW_BITS[rawmode]
    h = rows.shape[0]
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        v = (rows[..., None] >> shifts) & ((1 << bits) - 1)
        v = v.reshape(h, -1)[:, :width, None]
        scale = {"1": 255, "1;I": 255, "L;4": 17}.get(rawmode)
        if rawmode == "1;I":
            v = 1 - v
        return v * np.uint8(scale) if scale else v
    px = rows[:, :width * bits // 8]
    if rawmode in _RAW_SAMPLES:
        v = np.ascontiguousarray(px).view(_RAW_SAMPLES[rawmode])
        kind = (np.float32 if rawmode[0] == "F" else np.uint16
                if rawmode.startswith("I;16") else np.int32)
        return v.reshape(h, width, 1).astype(kind)
    if rawmode.endswith(";L"):
        return np.ascontiguousarray(
            px.reshape(h, bits // 8, width).transpose(0, 2, 1))
    px = px.reshape(h, width, bits // 8)
    if bits == 16 and ";" in rawmode:
        v = px[..., 0].astype(np.int32) | (px[..., 1].astype(np.int32) << 8)
        g_bits = 6 if rawmode == "BGR;16" else 5
        r = (v >> (5 + g_bits)) & 31
        g = (v >> 5) & ((1 << g_bits) - 1)
        chans = [r * 255 // 31, g * 255 // ((1 << g_bits) - 1),
                 (v & 31) * 255 // 31]
        if rawmode == "BGRA;15Z":
            chans.append(np.where(v >> 15, 0, 255))
        return np.stack(chans, -1).astype(np.uint8)
    if rawmode in ("P", "L", "LA"):
        return np.ascontiguousarray(px)
    order = [rawmode.index(c) for c in ("RGBA" if "A" in rawmode else "RGB")]
    return np.ascontiguousarray(px[..., order])


# Convert.c's ycbcr2rgb tables: (i - 128) x 1.402, -0.34414, -0.71414 and
# 1.772, scaled by 64, rounded as int(x + 0.5) (towards zero).
_YCC = {name: np.trunc(c * (np.arange(256) - 128) * 64 + 0.5).astype(
    np.int32) for name, c in (("R_Cr", 1.402), ("G_Cb", -0.34414),
                              ("G_Cr", -0.71414), ("B_Cb", 1.772))}


def as_read_ldr(px: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """Pixels in a PIL mode, (H, W, C), as the JAX read_ldr converts
    them: "1", L and P (through the (256, 3+) palette) to RGB, LA and PA
    to RGBA, RGB's padding byte dropped; I;16* clipped at 255, I to 0-255, F truncated and clipped
    (NaN as 0) and repeated as L; CMYK and YCbCr as Convert.c converts
    them (YCbCr by its fixed-point tables, not libjpeg's)."""
    if mode.startswith("I;16") or mode == "I":
        px, mode = np.clip(px, 0, 255).astype(np.uint8), "L"
    elif mode == "F":
        px, mode = np.where(np.isnan(px), 0, np.clip(px, 0, 255)).astype(
            np.uint8), "L"
    if mode in ("1", "L"):
        return np.repeat(px, 3, axis=2)
    if mode == "LA":
        return np.ascontiguousarray(px[..., [0, 0, 0, 1]])
    if mode == "P":
        return np.ascontiguousarray(palette[px[..., 0], :3])
    if mode == "PA":
        return np.concatenate([palette[px[..., 0], :3], px[..., 1:]], -1)
    if mode == "CMYK":
        c = px.astype(np.int32)
        nk = 255 - c[..., 3:]
        t = c[..., :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    if mode == "YCbCr":
        y, cb, cr = (px[..., k].astype(np.int32) for k in range(3))
        rgb = np.stack([y + (_YCC["R_Cr"][cr] >> 6),
                        y + ((_YCC["G_Cb"][cb] + _YCC["G_Cr"][cr]) >> 6),
                        y + (_YCC["B_Cb"][cb] >> 6)], -1)
        return np.clip(rgb, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(px[..., :3] if mode == "RGB" else px)


def _raw_rows(data: bytes, offset: int, rows: int, stride: int, width: int,
              rawmode: str, path: str) -> np.ndarray:
    """`rows` rows of `stride` bytes at `offset`, as PIL's raw decoder
    takes them (a stride shorter than the raw mode's row is refused)."""
    if stride < (width * _RAW_BITS[rawmode] + 7) // 8:
        raise ValueError(f"{path}: cannot decode image data (rows of "
                         f"{stride} bytes for {width} {rawmode} pixels)")
    if len(data) < offset + rows * stride:
        raise ValueError(f"{path}: image file is truncated")
    return np.frombuffer(data, np.uint8, rows * stride, offset).reshape(
        rows, stride)


def _palette(entries: np.ndarray, first: int = 0) -> np.ndarray:
    """A (256, 3) RGB table with `entries` (n, 3+) from index `first`,
    black past them."""
    table = np.zeros((256, 3), np.uint8)
    n = max(0, min(len(entries), 256 - first))
    table[first:first + n] = entries[:n, :3]
    return table


# (image type & 7, bits a pixel) -> PIL's raw mode (TgaImagePlugin.MODES),
# and colour-map bits -> the raw mode of its entries. PIL takes a 32-bit
# map in the header but cannot load its palette.
_TGA_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
                 (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
_TGA_MAP_RAWMODES = {16: "BGRA;15Z", 24: "BGR"}


def _tga_header(data: bytes):
    """The header fields of a TGA file, or None where PIL would not take
    the file for one (TGA has no signature: PIL checks these fields)."""
    if len(data) < 18:
        return None
    cmap_type, image_type, depth = data[1], data[2], data[16]
    width, height = struct.unpack_from("<HH", data, 12)
    if (cmap_type not in (0, 1) or width <= 0 or height <= 0
            or depth not in (1, 8, 16, 24, 32)
            or image_type not in (1, 2, 3, 9, 10, 11)
            or data[17] & 0x30 not in (0x00, 0x10, 0x20, 0x30)
            or (cmap_type and data[7] not in (16, 24, 32))):
        return None
    return dict(id_len=data[0], cmap_type=cmap_type, image_type=image_type,
                cmap=struct.unpack_from("<HHB", data, 3), width=width,
                height=height, depth=depth, flags=data[17])


def _tga_rle(data: bytes, pos: int, rows: int, rowbytes: int, unit: int,
             path: str) -> bytes:
    """The rows of an RLE TGA as PIL's TgaRleDecode reads them: packets of
    a run (one pixel of `unit` bytes repeated) or of raw pixels. Raw
    packets may run on into the next row; a run that would cross the end
    of its row is refused, as PIL refuses it."""
    out = bytearray()
    need = rows * rowbytes
    while len(out) < need:
        if pos >= len(data):
            raise ValueError(f"{path}: image file is truncated (RLE TGA)")
        head = data[pos]
        n = unit * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + unit > len(data):
                raise ValueError(f"{path}: image file is truncated (RLE TGA)")
            if len(out) % rowbytes + n > rowbytes:
                raise ValueError(f"{path}: buffer overrun when reading "
                                 "image file (an RLE TGA run crosses a row)")
            out += data[pos + 1:pos + 1 + unit] * (n // unit)
            pos += 1 + unit
        else:
            if pos + 1 + n > len(data):
                raise ValueError(f"{path}: image file is truncated (RLE TGA)")
            out += data[pos + 1:pos + 1 + n]
            pos += 1 + n
    return bytes(out[:need])


def read_tga(data: bytes, path: str = "<tga>") -> np.ndarray:
    """A TGA file's pixels as PIL gives them after read_ldr's convert:
    (H, W, 3) uint8, or (H, W, 4) for 16-bit (the attribute bit as an
    inverted alpha) and 32-bit colour and 16-bit grey with alpha.
    Uncompressed and RLE; colour-mapped (16- and 24-bit maps: PIL cannot
    load a 32-bit one), grey at 1, 8 and 16 bits, colour at 16, 24 and 32
    bits; any origin. Where PIL refuses a file, ValueError."""
    h = _tga_header(data)
    if h is None:
        raise ValueError(f"{path}: not a TGA file")
    itype, depth = h["image_type"], h["depth"]
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if h["cmap_type"] else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    rawmode = _TGA_RAWMODES.get((itype & 7, depth))
    if rawmode is None:
        raise ValueError(f"{path}: cannot load this image (TGA image type "
                         f"{itype} at {depth} bits a pixel)")
    pos = 18 + h["id_len"]
    palette = None
    if h["cmap_type"]:
        start, size, cdepth = h["cmap"]
        if mode in ("1", "RGB", "RGBA"):
            raise ValueError(f"{path}: unrecognized image mode (a colour "
                             f"map on a {mode} TGA)")
        if cdepth not in _TGA_MAP_RAWMODES:
            raise ValueError(f"{path}: unrecognized raw mode (a "
                             f"{cdepth}-bit TGA colour map)")
        if start + size > 256:
            raise ValueError(f"{path}: invalid palette size ({start} + "
                             f"{size} TGA colour map entries)")
        nb = cdepth // 8
        entries = np.frombuffer(data, np.uint8, size * nb, pos)
        pos += size * nb
        palette = _palette(unpack_raw(entries.reshape(1, -1), size,
                                      _TGA_MAP_RAWMODES[cdepth])[0], start)
        mode = "P" + mode[1:]          # PIL's putpalette: L -> P, LA -> PA
    elif rawmode == "P":
        raise ValueError(f"{path}: unknown raw mode for given image mode "
                         "(a colour-mapped TGA without a colour map)")
    w, ht = h["width"], h["height"]
    rowbytes = (w * depth + 7) // 8
    if itype & 8:
        rows = np.frombuffer(_tga_rle(data, pos, ht, rowbytes,
                                      (depth + 7) // 8, path),
                             np.uint8).reshape(ht, rowbytes)
    else:
        rows = _raw_rows(data, pos, ht, rowbytes, w, rawmode, path)
    if not h["flags"] & 0x20:          # origin at the bottom
        rows = rows[::-1]
    px = unpack_raw(rows, w, rawmode)
    if h["flags"] & 0x10:              # origin at the right
        px = px[:, ::-1]
    return as_read_ldr(px, mode, palette)


def write_tga(path: str, img: np.ndarray) -> None:
    """Write a float image in [0,1] or uint8, (H, W, 3|4), as an
    uncompressed 24- or 32-bit TGA with its origin at the bottom left."""
    img = _to_uint8(img)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"TGA needs 3 or 4 channels, got {c}")
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                         8 * c, 8 if c == 4 else 0)
    with open(path, "wb") as f:
        f.write(header + np.ascontiguousarray(
            img[::-1][..., [2, 1, 0, 3][:c]]).tobytes())


# BMP bits a pixel -> PIL's mode and raw mode (BmpImagePlugin.BIT2MODE),
# and the bit-field layouts PIL reads: (bits, masks) -> raw mode. 32-bit
# layouts match on (r, g, b, a) masks, 16- and 24-bit on (r, g, b).
_BMP_BITS = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
             16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
_BMP_FIELDS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BMP_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)


def _bmp_rle(data: bytes, pos: int, width: int, height: int,
             rle4: bool) -> bytes:
    """The pixel indices of an RLE8 or RLE4 BMP as PIL's BmpRleDecoder
    reads them, row after row in file order. As there: an encoded run is
    cut at the end of its row, an absolute run is not; an RLE4 absolute
    run of an odd count drops its last pixel; a delta escape reads four
    bytes and takes the last two as (right, up); absolute runs align to
    an even file offset; reading stops at the end of the bitmap, the
    end of the data or once width x height indices are there."""
    data_out = bytearray()
    x = 0
    need = width * height
    while len(data_out) < need:
        if pos + 2 > len(data):
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes((byte >> 4, byte & 0x0F))
                data_out += (pair * ((count + 1) // 2))[:count]
            else:
                data_out += bytes((byte,)) * count
            x += count
        elif byte == 0:                                # end of line
            data_out += bytes(-len(data_out) % width)
            x = 0
        elif byte == 1:                                # end of bitmap
            break
        elif byte == 2:                                # delta
            if pos + 2 > len(data):
                break
            if pos + 4 > len(data):
                raise ValueError("not enough values to unpack in an RLE "
                                 "BMP delta")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            data_out += bytes(right + up * width)
            x = len(data_out) % width
        else:                                          # absolute run
            n = byte // 2 if rle4 else byte
            run = data[pos:pos + n]
            pos += len(run)
            if rle4:
                data_out += bytes(v for b in run for v in (b >> 4, b & 0x0F))
            else:
                data_out += run
            if len(run) < n:
                break
            x += byte
            pos += pos % 2
    return bytes(data_out)


def read_bmp(data: bytes, path: str = "<bmp>",
             mapped: bool = True) -> np.ndarray:
    """A BMP file's pixels as PIL gives them after read_ldr's convert:
    (H, W, 3) uint8, or (H, W, 4) where the bit-field masks carry alpha.
    OS/2 (12-byte) to V5 headers; 1-, 4- and 8-bit palettes (a grey ramp
    reads as L, a black-and-white pair as bi-level), 16-bit 555 and 565,
    24- and 32-bit, the bit-field layouts PIL reads, RLE8 and RLE4;
    bottom-up or top-down. mapped: PIL memory-maps the pixels (a file
    opened by its path); False for a bitmap inside another file (an ICO
    entry), which PIL's raw decoder reads instead."""
    if not data.startswith(b"BM") or len(data) < 26:
        raise ValueError(f"{path}: not a BMP file")
    offset, hsize = struct.unpack_from("<II", data, 10)
    if hsize not in _BMP_HEADER_SIZES:
        raise ValueError(f"{path}: Unsupported BMP header type ({hsize})")
    head = data[18:14 + hsize]
    if len(head) < hsize - 4:
        raise ValueError(f"{path}: Truncated File Read (BMP header)")
    pos = 14 + hsize
    direction = -1                     # bottom-up
    if hsize == 12:
        w, ht, _, bits = struct.unpack_from("<HHHH", head, 0)
        compression, colors, pad = 0, 0, 3
    else:
        if head[7] == 0xFF:
            direction = 1
        w, ht = struct.unpack_from("<iI", head, 0)
        if direction == 1:
            ht = 2**32 - ht
        bits, compression = struct.unpack_from("<HI", head, 10)
        colors = struct.unpack_from("<I", head, 28)[0]
        pad = 4
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_BITS:
        raise ValueError(f"{path}: Unsupported BMP pixel depth ({bits})")
    mode, rawmode = _BMP_BITS[bits]
    if compression == 3:               # bit fields
        if len(head) >= 48:
            masks = struct.unpack_from("<IIII" if len(head) >= 52
                                       else "<III", head, 36)
        else:
            masks = struct.unpack_from("<III", data, pos)
            pos += 12
        masks = tuple(masks) + (0,) * (4 - len(masks))
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _BMP_FIELDS:
            raise ValueError(f"{path}: Unsupported BMP bitfields layout "
                             f"({bits} bits, masks {masks})")
        rawmode = _BMP_FIELDS[key]
        if "A" in rawmode:
            mode = "RGBA"
    elif compression not in (0, 1, 2):
        raise ValueError(f"{path}: Unsupported BMP compression "
                         f"({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{path}: Unsupported BMP Palette size "
                             f"({colors})")
        pal = data[pos:pos + pad * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(pal[i * pad:i * pad + 3] == bytes((v & 255,)) * 3
               for i, v in enumerate(ramp)):
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            entries = np.frombuffer(pal, np.uint8, len(pal) // pad * pad)
            palette = _palette(entries.reshape(-1, pad)[:, 2::-1])
    if compression in (1, 2):          # RLE8, RLE4
        if mode not in ("P", "L"):
            raise ValueError(f"{path}: unknown raw mode for given image "
                             f"mode (an RLE BMP of mode {mode})")
        idx = _bmp_rle(data, offset, w, ht, compression == 2)
        if len(idx) < w * ht:
            raise ValueError(f"{path}: not enough image data (RLE BMP)")
        rows = np.frombuffer(idx, np.uint8, w * ht).reshape(ht, w)
        rawmode = "P" if mode == "P" else "L"
    elif rawmode == "L" and bits < 8:
        # A grey ramp under 1- or 4-bit pixels: PIL reads a byte a pixel,
        # w bytes at each row's start: from the mapped file (zeros past
        # its end), or through the raw decoder, which refuses rows wider
        # than the stride.
        stride = ((w * bits + 31) >> 3) & ~3
        if not mapped and stride < w:
            raise ValueError(f"{path}: codec configuration error when "
                             "reading image file")
        if len(data) < offset + ht * stride:
            raise ValueError(f"{path}: buffer is not large enough")
        buf = np.frombuffer(data + bytes(w), np.uint8)
        rows = np.stack([buf[offset + i * stride:offset + i * stride + w]
                         for i in range(ht)])
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        rows = _raw_rows(data, offset, ht, stride, w, rawmode, path)
    if direction == -1:
        rows = rows[::-1]
    return as_read_ldr(unpack_raw(rows, w, rawmode), mode, palette)


def write_bmp(path: str, img: np.ndarray) -> None:
    """Write a float image in [0,1] or uint8, (H, W, 3), as a 24-bit
    bottom-up BMP (what PIL writes for an RGB image)."""
    img = _to_uint8(img)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"BMP needs 3 channels, got {c}")
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1][..., ::-1].reshape(h, w * 3)
    ppm = int(96 * 39.3701 + 0.5)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size,
                            ppm, ppm, 0, 0))
        f.write(rows.tobytes())


def _to_uint8(img) -> np.ndarray:
    """A float image in [0,1] as write_png quantises it (clip, then
    x*255+0.5 truncated); uint8 as it is."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return img


# ----------------------------------------------------------------------------
# Radiance HDR (RGBE)


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr (RGBE) file to float32 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    # Header: lines until blank line, then resolution line.
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res_line = data[pos:eol].decode("ascii").split()
    pos = eol + 1
    if res_line[0] != "-Y" or res_line[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {res_line}")
    height, width = int(res_line[1]), int(res_line[3])

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or not (
            buf[bp] == 2 and buf[bp + 1] == 2 and (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) == width
        ):
            # Flat (non-RLE) scanline(s): remaining data is raw RGBE.
            n = (height - y) * width
            flat = buf[bp : bp + n * 4].reshape(height - y, width, 4)
            rgbe[y:] = flat
            bp += n * 4
            break
        bp += 4
        # New-style RLE: each of the 4 components run-length encoded.
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bp])
                bp += 1
                if count > 128:  # run
                    rgbe[y, x : x + count - 128, c] = buf[bp]
                    bp += 1
                    x += count - 128
                else:  # literal
                    rgbe[y, x : x + count, c] = buf[bp : bp + count]
                    bp += count
                    x += count
    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(
        exp[..., None] == 0, 0.0, 1.0
    )


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write float32 (H, W, 3) as flat (non-RLE) Radiance HDR."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = np.max(img, axis=-1)
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float32)
    nz = maxc > 1e-32
    mant[nz], exp[nz] = np.frexp(maxc[nz])
    scale = np.zeros((h, w), np.float32)
    scale[nz] = mant[nz] * 256.0 / maxc[nz]
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode("ascii"))
        f.write(rgbe.tobytes())


# ----------------------------------------------------------------------------
# PFM


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        count = w * h * (3 if color else 1)
        arr = np.frombuffer(f.read(count * 4), dtype).astype(np.float32)
    shape = (h, w, 3) if color else (h, w)
    return arr.reshape(shape)[::-1].copy()  # PFM rows are bottom-up


def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    color = img.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(img[::-1].astype("<f4").tobytes())


# ----------------------------------------------------------------------------
# OpenEXR (scanline; NONE/ZIPS/ZIP read+write, PIZ read via piz module)

_EXR_MAGIC = 20000630
_PT_HALF, _PT_FLOAT = 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 1, 2, 3, 4


def _read_exr_header(data):
    if struct.unpack_from("<i", data, 0)[0] != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        j = data.index(b"\0", pos)
        name = data[pos:j].decode()
        pos = j + 1
        j = data.index(b"\0", pos)
        typ = data[pos:j].decode()
        pos = j + 1
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        attrs[name] = (typ, data[pos : pos + size])
        pos += size
    return attrs, pos + 1


def _parse_chlist(raw):
    chans = []
    pos = 0
    while raw[pos] != 0:
        j = raw.index(b"\0", pos)
        name = raw[pos:j].decode()
        pos = j + 1
        ptype, _flags, xs, ys = struct.unpack_from("<iiii", raw, pos)
        pos += 16
        chans.append((name, ptype, xs, ys))
    return chans


def read_exr(path: str) -> dict:
    """Read a scanline EXR. Returns {channel_name: float32 (H, W)}.

    Supports NONE, ZIPS, ZIP, and PIZ compression with HALF/FLOAT channels —
    enough for the reference's Tungsten golden renders
    (PIZ-compressed).
    """
    with open(path, "rb") as f:
        data = f.read()
    attrs, pos = _read_exr_header(data)
    chans = _parse_chlist(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    width, height = x1 - x0 + 1, y1 - y0 + 1

    lines_per_block = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16, _COMP_PIZ: 32}.get(
        comp
    )
    if lines_per_block is None:
        raise ValueError(f"unsupported EXR compression: {comp}")
    nblocks = (height + lines_per_block - 1) // lines_per_block
    # Skip offset table.
    pos += nblocks * 8

    out = {
        name: np.zeros((height, width), np.float32) for name, *_ in chans
    }
    bytes_per_px = {_PT_HALF: 2, _PT_FLOAT: 4}

    if comp == _COMP_PIZ:
        from tracerboy_tpu_torch.core import piz as piz_mod

        return piz_mod.read_piz_blocks(
            data, pos, chans, width, height, nblocks, lines_per_block
        )

    for _ in range(nblocks):
        ystart, dsize = struct.unpack_from("<ii", data, pos)
        pos += 8
        raw = data[pos : pos + dsize]
        pos += dsize
        nlines = min(lines_per_block, height - (ystart - y0))
        expected = nlines * width * sum(bytes_per_px[pt] for _, pt, _, _ in chans)
        if comp in (_COMP_ZIPS, _COMP_ZIP) and dsize < expected:
            raw = zlib.decompress(raw)
            raw = _exr_unpredict(np.frombuffer(raw, np.uint8))
        buf = np.frombuffer(raw, np.uint8)
        off = 0
        for line in range(nlines):
            y = ystart - y0 + line
            for name, ptype, _, _ in chans:
                n = width * bytes_per_px[ptype]
                chunk = buf[off : off + n]
                off += n
                if ptype == _PT_HALF:
                    out[name][y] = chunk.view(np.float16).astype(np.float32)
                else:
                    out[name][y] = chunk.view(np.float32)
    return out


def _exr_unpredict(buf: np.ndarray) -> np.ndarray:
    """Undo EXR's ZIP delta predictor + two-buffer interleave.

    Predictor: out[i] = out[i-1] + in[i] - 128 (mod 256) -> a prefix sum.
    """
    deltas = buf.astype(np.int64) - 128
    deltas[0] = buf[0]
    out = (np.cumsum(deltas) % 256).astype(np.uint8)
    # de-interleave: first half -> even positions, second half -> odd
    result = np.empty_like(out)
    half = (len(out) + 1) // 2
    result[0::2] = out[:half]
    result[1::2] = out[half:]
    return result


def _exr_predict(buf: np.ndarray) -> bytes:
    """Apply EXR's interleave + delta predictor before ZIP compression."""
    half = (len(buf) + 1) // 2
    inter = np.empty_like(buf)
    inter[:half] = buf[0::2]
    inter[half:] = buf[1::2]
    d = inter.astype(np.int32)
    delta = np.empty_like(d)
    delta[0] = d[0]
    delta[1:] = d[1:] - d[:-1] + 128
    return (delta % 256).astype(np.uint8).tobytes()


def write_exr(path: str, channels: dict, compress: bool = True) -> None:
    """Write float32 channels {name: (H, W)} as a ZIP-compressed HALF EXR.

    Convenience overload: pass an (H, W, 3) array to write R, G, B.
    """
    if isinstance(channels, np.ndarray):
        channels = {
            "R": channels[..., 0],
            "G": channels[..., 1],
            "B": channels[..., 2],
        }
    names = sorted(channels)  # EXR requires sorted channel order
    h, w = next(iter(channels.values())).shape
    comp = _COMP_ZIP if compress else _COMP_NONE
    lines_per_block = 16 if compress else 1

    def attr(name, typ, val):
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(val)) + val

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\0" + struct.pack("<iiii", _PT_HALF, 0, 1, 1)
    chlist += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            struct.pack("<i", _EXR_MAGIC),
            struct.pack("<i", 2),  # version 2, scanline
            attr("channels", "chlist", chlist),
            attr("compression", "compression", bytes([comp])),
            attr("dataWindow", "box2i", box),
            attr("displayWindow", "box2i", box),
            attr("lineOrder", "lineOrder", b"\0"),
            attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
            attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )
    nblocks = (h + lines_per_block - 1) // lines_per_block
    blocks = []
    for b in range(nblocks):
        y = b * lines_per_block
        nlines = min(lines_per_block, h - y)
        lines = []
        for line in range(nlines):
            for n in names:
                lines.append(
                    np.asarray(channels[n][y + line], np.float32)
                    .astype(np.float16)
                    .tobytes()
                )
        raw = b"".join(lines)
        if compress:
            comp_data = zlib.compress(_exr_predict(np.frombuffer(raw, np.uint8)))
            if len(comp_data) >= len(raw):
                comp_data = raw
        else:
            comp_data = raw
        blocks.append((y, comp_data))
    offset = len(header) + nblocks * 8
    table = b""
    for y, bd in blocks:
        table += struct.pack("<Q", offset)
        offset += 8 + len(bd)
    with open(path, "wb") as f:
        f.write(header)
        f.write(table)
        for y, bd in blocks:
            f.write(struct.pack("<ii", y, len(bd)))
            f.write(bd)


def read_exr_rgb(path: str) -> np.ndarray:
    """Read an EXR and stack R, G, B channels to (H, W, 3)."""
    ch = read_exr(path)
    return np.stack([ch["R"], ch["G"], ch["B"]], axis=-1)


def read_texture(path: str, gamma_to_linear_ldr: bool = True) -> np.ndarray:
    """Dispatch on extension; returns float32 linear (H, W, 3+)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return read_hdr(path)
    if ext == ".pfm":
        return read_pfm(path)
    if ext == ".exr":
        return read_exr_rgb(path)
    return read_ldr(path, gamma_to_linear=gamma_to_linear_ldr)
