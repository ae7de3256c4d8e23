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

from tracerboy_tpu_torch.core.image_io import UnidentifiedImageError

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


def _dib_as_bmp(data: bytes, offset: int, path: str):
    """The DIB at `offset` as a BMP file for image_io.read_bmp, its height
    halved (the XOR image), the pixel offset where PIL's DIB reader finds
    the rows (after the header, bit-field masks and palette). Returns
    (bmp bytes, width, height, pixel offset in data)."""
    head = data[offset:offset + 40]
    if len(head) < 16:
        raise ValueError(f"{path}: Truncated File Read (ICO bitmap header)")
    (hsize,) = struct.unpack_from("<I", head, 0)
    dib = bytearray(data[offset:])
    if hsize == 12:
        w, h2, _, bits = struct.unpack_from("<HHHH", dib, 4)
        h = int(h2 / 2)
        struct.pack_into("<H", dib, 6, h)
        compression, colors, pad = 0, 0, 3
    else:
        w, raw_h = struct.unpack_from("<iI", dib, 4)
        bits, compression = struct.unpack_from("<HI", dib, 14)
        (colors,) = struct.unpack_from("<I", dib, 32) if len(dib) >= 36 \
            else (0,)
        pad = 4
        if dib[11] == 0xFF:                 # top-down: height negative
            h = int((2**32 - raw_h) / 2)
            struct.pack_into("<i", dib, 8, -h)
        else:
            h = int(raw_h / 2)
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
