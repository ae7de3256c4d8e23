"""The port's GIF reader: the first frame's pixels as PIL returns them
(Pillow 12.1's GifImagePlugin and GifDecode.c), bit for bit, without an
imaging library.

GIF is one of WIC's codecs, which TracerBoy loads textures through.
Image.open gives the first frame, so that is all this reads:
- the logical screen, grown to hold the frame where the frame reaches
  past it; the global colour table, and the frame's local one, each
  dropped where it is the identity grey ramp (PIL's _is_palette_needed:
  the frame is then mode L, its indices the grey levels);
- extensions skipped, but for the graphic control extension's
  transparent index, which fills the screen around the frame (else
  index 0 does);
- the LZW data (csrc/lzw_codecs.cpp tb_gif_decode, Pillow's decoder:
  clear and end codes, codes of min + 1 to 12 bits, interlaced rows in
  four passes), which must reach the frame's last row.
read_ldr converts it as PIL's convert("RGB") does: indices through the
table (black past its end), grey replicated; transparency is dropped.

Refused as PIL refuses: ValueError where PIL raises OSError, ValueError
or EOFError (data that ends before the frame does, at an end code, a
zero-length block or the end of the file; a broken LZW stream;
a code size above 12, no image in the file), NotImplementedError where
PIL cannot identify the file (a short header or colour table).
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.codecs import library
from tracerboy_tpu_torch.core.image_io import UnidentifiedImageError

GIF_MAGIC = (b"GIF87a", b"GIF89a")


def is_gif(data: bytes) -> bool:
    return data.startswith(GIF_MAGIC)


def _palette_needed(p: bytes) -> bool:
    """PIL's _is_palette_needed; IndexError on a table cut mid-entry."""
    for i in range(0, len(p), 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


def _table(p: bytes) -> np.ndarray:
    """A (256, 3) RGB table from `p`, black past its entries."""
    out = np.zeros((256, 3), np.uint8)
    n = min(len(p) // 3, 256)
    out[:n] = np.frombuffer(p, np.uint8, 3 * n).reshape(n, 3)
    return out


def decode_gif(data: bytes, path: str = "<gif>"):
    """The first frame of a GIF as PIL decodes it: ((H, W) uint8 indices
    or grey levels, mode "P" or "L", (256, 3) table or None)."""
    if not is_gif(data):
        raise ValueError(f"{path}: not a GIF file")
    if len(data) < 13:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(short GIF header)")
    width, height = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    global_table = None
    try:
        if flags & 128:
            p = data[pos:pos + (3 << ((flags & 7) + 1))]
            pos += len(p)
            if _palette_needed(p):
                global_table = p
        frame_table = None
        transparency = None
        extent = None
        while True:
            if pos >= len(data) or data[pos] == 0x3B:
                break
            s = data[pos]
            pos += 1
            if s == 0x21:                               # extension
                label = data[pos]
                pos += 1
                block, pos = _sub_block(data, pos)
                if label == 249 and block is not None:
                    if block[0] & 1:
                        transparency = block[3]
                    struct.unpack_from("<H", block, 1)     # PIL's duration
                if label == 254:
                    while block:
                        block, pos = _sub_block(data, pos)
                    continue
                while True:
                    block, pos = _sub_block(data, pos)
                    if not block:
                        break
            elif s == 0x2C:                             # image descriptor
                d = data[pos:pos + 9]
                pos += 9
                x0, y0, w, h = struct.unpack_from("<HHHH", d)
                extent = (x0, y0, x0 + w, y0 + h)
                fl = d[8]
                interlace = bool(fl & 64)
                if fl & 128:
                    p = data[pos:pos + (3 << ((fl & 7) + 1))]
                    pos += len(p)
                    frame_table = p if _palette_needed(p) else False
                bits = data[pos]
                pos += 1
                break
    except (IndexError, struct.error):
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(GIF header cut short)") from None
    if extent is None:
        raise ValueError(f"{path}: no image in the GIF file (PIL raises "
                         "EOFError)")
    x0, y0, x1, y1 = extent
    width, height = max(x1, width), max(y1, height)
    table = frame_table if frame_table is not None else global_table
    mode = "P" if table else "L"
    if bits > 12:
        raise ValueError(f"{path}: bad number of bits ({bits})")
    img = np.full((height, width),
                  0 if transparency is None else transparency, np.uint8)
    if x1 > x0 and y1 > y0:
        frame = np.ascontiguousarray(img[y0:y1, x0:x1])
        src = np.frombuffer(data, np.uint8, len(data) - pos, pos)
        status = library().tb_gif_decode(
            src.ctypes.data, src.size, frame.ctypes.data, x1 - x0, y1 - y0,
            x1 - x0, bits, int(interlace))
        if status == 1:
            raise ValueError(f"{path}: image file is truncated (the GIF "
                             "data ends before the frame)")
        if status < 0:
            raise ValueError(f"{path}: decoder error {status} (broken GIF "
                             "LZW stream)")
        img[y0:y1, x0:x1] = frame
    return img, mode, _table(table) if table else None


def _sub_block(data: bytes, pos: int):
    """PIL's GifImageFile.data: the next sub-block, or None at a zero
    size byte or the end of the data; and the position after it."""
    if pos < len(data) and data[pos]:
        n = data[pos]
        return data[pos + 1:pos + 1 + n], pos + 1 + n
    return None, pos + 1


def read_gif(data: bytes, path: str = "<gif>") -> np.ndarray:
    """A GIF's first frame as the JAX read_ldr gets it through PIL:
    (H, W, 3) uint8."""
    img, mode, table = decode_gif(data, path)
    if mode == "P":
        return table[img]
    return np.repeat(img[..., None], 3, axis=2)
