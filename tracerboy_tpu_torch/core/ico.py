"""The port's ICO reader: the pixels PIL returns for a Windows icon
(Pillow 12.1's IcoImagePlugin), bit for bit, without an imaging library.

ICO is one of WIC's codecs, which TracerBoy loads textures through.
PIL opens the entry it sorts first: the largest width x height, the
lowest colour depth among equals (IcoImagePlugin.py:197-199, :322).
Its payload is either
- a PNG (from its 8-byte signature), decoded by core/image_io's PNG
  reader and converted as read_ldr converts any PNG; or
- a DIB: a BITMAPINFOHEADER whose height counts the XOR image and the
  AND mask, decoded by core/image_io.read_bmp over the upper half's
  rows, then made RGBA: below 32 bits a pixel the AND mask (1:
  transparent) becomes alpha 0 or 255, read from the last bytes of the
  entry (PIL's offset + size - mask bytes); at 32 bits the fourth byte
  of each pixel is the alpha, read bottom-up as PIL reads it.

Refused as PIL refuses: NotImplementedError where PIL cannot identify
the file (no entries, a short directory), ValueError where PIL raises
OSError or ValueError (an AND mask or alpha cut short, the DIB's own
errors).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    _BMP_HEADER_SIZES,
    UnidentifiedImageError,
)

ICO_MAGIC = b"\0\0\1\0"


def is_ico(data: bytes) -> bool:
    return data.startswith(ICO_MAGIC)


def ico_entries(data: bytes, path: str = "<ico>") -> list:
    """The directory's entries as dicts, in PIL's order (largest first,
    then by colour depth)."""
    (count,) = struct.unpack_from("<H", data, 4)
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                         "(ICO directory cut short)")
        w, h, colors = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) \
            or 256
        entries.append(dict(width=w, height=h, bpp=bpp, size=size,
                            offset=offset, square=w * h, depth=depth))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    return entries


def _dib_as_bmp(data: bytes, offset: int, path: str, halve: bool = True):
    """The DIB at `offset` as a BMP file for image_io.read_bmp, its height
    halved where `halve` (an icon's or cursor's XOR image), the pixel
    offset where PIL's DIB reader finds the rows (after the header,
    bit-field masks and palette). Returns (bmp bytes, width, height,
    pixel offset in data)."""
    head = data[offset:offset + 40]
    if len(head) < 16:
        raise ValueError(f"{path}: Truncated File Read (bitmap header)")
    (hsize,) = struct.unpack_from("<I", head, 0)
    dib = bytearray(data[offset:])
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", dib, 4)
        if halve:
            h = int(h / 2)
            struct.pack_into("<H", dib, 6, h)
        compression, colors, pad = 0, 0, 3
    else:
        w, raw_h = struct.unpack_from("<iI", dib, 4)
        bits, compression = struct.unpack_from("<HI", dib, 14)
        (colors,) = struct.unpack_from("<I", dib, 32) if len(dib) >= 36 \
            else (0,)
        pad = 4
        if dib[11] == 0xFF:                 # top-down: height negative
            h = 2**32 - raw_h
            if halve:
                h = int(h / 2)
                struct.pack_into("<i", dib, 8, -h)
        else:
            h = raw_h
            if halve:
                h = int(h / 2)
                struct.pack_into("<I", dib, 8, h)
    pixels = hsize
    if compression == 3 and hsize == 40:
        pixels += 12
    if bits <= 8:
        pixels += pad * (colors or (1 << bits))
    bmp = b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, 14 + pixels) \
        + bytes(dib)
    return bmp, w, h, offset + pixels


def read_ico(data: bytes, path: str = "<ico>") -> np.ndarray:
    """An ICO's default entry as the JAX read_ldr gets it through PIL:
    (H, W, 3|4) uint8 (a PNG payload in its own mode's conversion, a DIB
    payload RGBA)."""
    from tracerboy_tpu_torch.core.image_io import (
        PNG_SIGNATURE,
        decode_png,
        png_to_8bit,
        read_bmp,
    )

    if not is_ico(data):
        raise ValueError(f"{path}: not an ICO file")
    if len(data) < 6:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(short ICO header)")
    entries = ico_entries(data, path)
    if not entries:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(an ICO without entries)")
    e = entries[0]
    offset = e["offset"]
    if data[offset:offset + 8] == PNG_SIGNATURE:
        return png_to_8bit(*decode_png(data[offset:], path))
    bmp, w, h, pixels = _dib_as_bmp(data, offset, path)
    rgb = read_bmp(bmp, path, mapped=False)[..., :3]
    if e["bpp"] == 32:
        raw = data[pixels:pixels + w * h * 4]
        if len(raw) < w * h * 4:
            raise ValueError(f"{path}: not enough image data (ICO alpha)")
        alpha = np.frombuffer(raw, np.uint8)[3::4].reshape(h, w)[::-1]
    else:
        padded = w + (32 - w % 32) % 32
        total = padded * h // 8
        at = offset + e["size"] - total
        if at < 0:
            raise ValueError(f"{path}: negative seek value (ICO AND mask)")
        mask = data[at:at + total]
        if len(mask) < total:
            raise ValueError(f"{path}: not enough image data (ICO AND mask)")
        rows = np.frombuffer(mask, np.uint8).reshape(h, padded // 8)[::-1]
        bits = np.unpackbits(rows, axis=1)[:, :w]
        alpha = np.where(bits == 1, 0, 255).astype(np.uint8)
    return np.concatenate([rgb, alpha[..., None]], -1)


CUR_MAGIC = b"\0\0\2\0"


def is_dib(data: bytes) -> bool:
    """BmpImagePlugin._dib_accept (a file shorter than 4 bytes is passed
    on: PIL's struct.error)."""
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] in \
        _BMP_HEADER_SIZES


def is_cur(data: bytes) -> bool:
    """CurImagePlugin._accept."""
    return data.startswith(CUR_MAGIC)


def _bitmap_at(data: bytes, pos: int, path: str, halve: bool):
    """BmpImageFile._bitmap's header reads at `pos`, then the bitmap as a
    BMP file for read_bmp: (bmp bytes, width, height, pixel offset)."""
    if len(data) < pos + 4:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(bitmap header size cut short)")
    (hsize,) = struct.unpack_from("<I", data, pos)
    if len(data) < pos + max(hsize, 4):
        raise ValueError(f"{path}: Truncated File Read (bitmap header)")
    if hsize not in _BMP_HEADER_SIZES:
        raise ValueError(f"{path}: Unsupported BMP header type ({hsize})")
    return _dib_as_bmp(data, pos, path, halve)


def read_dib(data: bytes, path: str = "<dib>") -> np.ndarray:
    """A DIB file (a BMP without its file header) as the JAX read_ldr gets
    it through PIL: read as a BMP whose pixels follow the header, masks
    and palette."""
    from tracerboy_tpu_torch.core.image_io import read_bmp

    return read_bmp(_bitmap_at(data, 0, path, False)[0], path)


def read_cur(data: bytes, path: str = "<cur>") -> np.ndarray:
    """A Windows cursor as the JAX read_ldr gets it through PIL
    (CurImagePlugin): the entry whose width and height bytes both exceed
    those of the one held so far (the first to start with; a 256-pixel
    entry, byte 0, never wins), its bitmap read by BmpImageFile._bitmap
    with the height halved and no AND mask; at 32 bits without bit fields
    the fourth byte is alpha only for the bitmap at offset 22 (PIL's
    single-entry cursor test), else dropped. An entry offset of 0 reads
    the bitmap after the directory. No entry, or a directory cut short,
    passes the file on (PIL's TypeError, IndexError and struct.error)."""
    from tracerboy_tpu_torch.core.image_io import read_bmp

    if len(data) < 6:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(CUR header cut short)")
    (count,) = struct.unpack_from("<H", data, 4)
    best = b""
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if not best:
            best = s
            continue
        # PIL's s[0] > m[0] and s[1] > m[1], IndexError where a short
        # entry is indexed.
        if not s or (s[0] > best[0] and min(len(s), len(best)) < 2):
            raise UnidentifiedImageError(f"{path}: cannot identify image "
                                         "file (CUR directory cut short)")
        if s[0] > best[0] and s[1] > best[1]:
            best = s
    if not best or len(best) < 16:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(No cursors were found)")
    (offset,) = struct.unpack_from("<I", best, 12)
    pos = offset if offset else min(len(data), 6 + 16 * count)
    bmp, w, h, pixels = _bitmap_at(data, pos, path, True)
    rgb = read_bmp(bmp, path)
    hsize, = struct.unpack_from("<I", data, pos)
    bits = struct.unpack_from("<H", data, pos + (10 if hsize == 12 else 14))[0]
    compression = 0 if hsize == 12 else struct.unpack_from(
        "<I", data, pos + 16)[0]
    if offset == 22 and bits == 32 and compression == 0:
        raw = data[pixels:pixels + w * h * 4]
        alpha = np.frombuffer(raw, np.uint8)[3::4].reshape(h, w)
        if data[pos + 11] != 0xFF:
            alpha = alpha[::-1]
        return np.concatenate([rgb[..., :3], alpha[..., None]], -1)
    return rgb
