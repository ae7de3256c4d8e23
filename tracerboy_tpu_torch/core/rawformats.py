"""The port's readers of PIL's small formats whose pixels come through
PIL's raw decoder: PIXAR, GBR, IMT, McIdas, SPIDER and XVThumb, each the
pixels Pillow 12.1's plugin of that name returns, bit for bit, without an
imaging library; and the raw layouts and mode conversions that these,
core/im.py and core/sun.py share.

- PIXAR (PixarImagePlugin): a 512-byte header, the size at bytes 418 and
  416 (little-endian), RGB where the channel/depth fields at 424 are
  (14, 2), the "dumped" RGB samples at byte 1024. PIL reads no other
  layout: any other pair leaves the mode empty, so the file is passed on.
- GBR (GbrImagePlugin): a GIMP brush, version 1 or 2 (the latter with
  "GIMP" and a spacing), depth 1 (L) or 4 (RGBA), the pixels right after
  the header's comment. A version-2 header shorter than 28 bytes makes
  PIL read its comment to the end of the file, so no pixels are left.
- IMT (ImtImagePlugin): IM Tools' text header of "key value" lines,
  width, height and "pixel n8" (L), then a form feed and the rows. A
  header that ends without the form feed names an image PIL cannot load.
- McIdas (McIdasImagePlugin): a 256-byte area directory of 64 big-endian
  words; L, I;16B or I;32B at the directory's offset and stride.
- SPIDER (SpiderImagePlugin): 27 floats, big- or little-endian, that
  isSpiderHeader takes, of a 2-D image (iform 1); 32-bit floats after
  the header, or after a second header in a stack (its first image).
- XVThumb (XVThumbImagePlugin): "P7 332", comment lines, "w h ...", then
  8-bit indices into the 3-3-2 palette the plugin builds.

Each reader makes its plugin's _open checks: UnidentifiedImageError
where PIL's _open raises SyntaxError (or IndexError, TypeError,
struct.error, KeyError), which passes the file on to PIL's later
plugins; ValueError where PIL lets another error out of Image.open or
load (a size that int() cannot read, data cut short, a negative offset).

raw_lines takes the rows as PIL's raw decoder does; image_io.unpack_raw
and as_read_ldr unpack and convert them, as the JAX read_ldr converts
what PIL decodes to RGB (or RGBA).
"""

from __future__ import annotations

import io
import re
import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    _RAW_BITS,
    UnidentifiedImageError,
    _palette,
    as_read_ldr,
    check_image_size,
    unpack_raw,
)


def unidentified(path: str, why: str) -> UnidentifiedImageError:
    return UnidentifiedImageError(f"{path}: cannot identify image file "
                                  f"({why})")


def raw_lines(data: bytes, offset: int, lines: int, width: int,
              rawmode: str, path: str, stride: int = 0) -> np.ndarray:
    """`lines` lines of `width` pixels in `rawmode` at `offset`, `stride`
    bytes apart (0: packed), as PIL's raw decoder takes them: (lines,
    linebytes) uint8. The padding after the last line is not needed; a
    stride shorter than a line is refused (PIL's bad configuration), and
    so is data cut short."""
    linebytes = (width * _RAW_BITS[rawmode] + 7) // 8
    stride = stride or linebytes
    if stride < linebytes:
        raise ValueError(f"{path}: decoder error (rows of {stride} bytes "
                         f"for {width} {rawmode} pixels)")
    if offset < 0:
        raise ValueError(f"{path}: negative seek position {offset}")
    if len(data) < offset + (lines - 1) * stride + linebytes:
        raise ValueError(f"{path}: image file is truncated")
    buf = np.frombuffer(data, np.uint8, len(data) - offset, offset)
    return np.lib.stride_tricks.as_strided(
        buf, (lines, linebytes), (stride, 1))


def palette_table(entries: bytes, planar: bool = False) -> np.ndarray:
    """A (256, 3) RGB table from a raw palette (PIL's "RGB" or "RGB;L"
    palette raw modes: len // 3 entries, interleaved or planar), black
    past its entries."""
    n = len(entries) // 3
    v = np.frombuffer(entries, np.uint8, 3 * n)
    return _palette(v.reshape(3, n).T if planar else v.reshape(n, 3))


# ----------------------------------------------------------------------------
# PIXAR


def is_pixar(data: bytes) -> bool:
    return data.startswith(b"\200\350\000\000")


def read_pixar(data: bytes, path: str = "<pixar>") -> np.ndarray:
    if len(data) < 428:
        raise unidentified(path, "PIXAR header cut short")
    h, w = struct.unpack_from("<2H", data, 416)
    chan, depth = struct.unpack_from("<2H", data, 424)
    if (chan, depth) != (14, 2):
        raise unidentified(path, f"PIXAR layout {(chan, depth)}, which "
                           "PIL leaves without a mode")
    check_image_size(w, h, path)
    return unpack_raw(raw_lines(data, 1024, h, w, "RGB", path), w, "RGB")


# ----------------------------------------------------------------------------
# GBR


def _be32(data: bytes, at: int) -> int:
    if len(data) < at + 4:
        raise struct.error("unpack requires a buffer of 4 bytes")
    return struct.unpack_from(">I", data, at)[0]


def is_gbr(data: bytes) -> bool:
    """GbrImagePlugin._accept."""
    return (len(data) >= 8 and _be32(data, 0) >= 20
            and _be32(data, 4) in (1, 2))


def read_gbr(data: bytes, path: str = "<gbr>") -> np.ndarray:
    try:
        header_size, version = _be32(data, 0), _be32(data, 4)
        if header_size < 20 or version not in (1, 2):
            raise unidentified(path, "not a GIMP brush")
        width, height, depth = (_be32(data, k) for k in (8, 12, 16))
        if not width or not height or depth not in (1, 4):
            raise unidentified(path, "GIMP brush size or depth")
        if version == 2:
            if data[20:24] != b"GIMP":
                raise unidentified(path, "GIMP brush without its magic")
            _be32(data, 24)                          # the spacing
    except struct.error as e:
        raise unidentified(path, f"GIMP brush header cut short: {e}")
    check_image_size(width, height, path)
    # A version-2 comment length below 0 reads the rest of the file.
    start = header_size if version == 1 or header_size >= 28 else len(data)
    mode = "L" if depth == 1 else "RGBA"
    need = width * height * depth
    if len(data) - start < need:
        raise ValueError(f"{path}: not enough image data (GIMP brush)")
    px = np.frombuffer(data, np.uint8, need, start)
    return as_read_ldr(px.reshape(height, width, depth), mode)


# ----------------------------------------------------------------------------
# IMT

_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def imt_header(data: bytes, path: str = "<imt>"):
    """ImtImageFile._open: (width, height, mode, offset of the rows or
    None where the header ends without a form feed)."""
    f = io.BytesIO(data)
    buffer = f.read(100)
    if b"\n" not in buffer:
        raise unidentified(path, "not an IM Tools file")
    width = height = 0
    mode, offset = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = f.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = f.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += f.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            width = int(v)
        elif k == b"height":
            height = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return width, height, mode, offset


def is_imt(data: bytes) -> bool:
    """ImtImageFile._open identifies the file: its header sets a size
    and the mode L (int() of a size that is not a number raises, as in
    PIL)."""
    try:
        w, h, mode, _ = imt_header(data)
    except UnidentifiedImageError:
        return False
    return bool(mode) and w > 0 and h > 0


def read_imt(data: bytes, path: str = "<imt>") -> np.ndarray:
    w, h, mode, offset = imt_header(data, path)
    if not mode:
        raise unidentified(path, "IM Tools header without pixel n8")
    check_image_size(w, h, path)
    if offset is None:
        raise ValueError(f"{path}: cannot load this image (IM Tools header "
                         "without a form feed)")
    return as_read_ldr(unpack_raw(raw_lines(data, offset, h, w, "L", path),
                                  w, "L"), "L")


# ----------------------------------------------------------------------------
# McIdas


def is_mcidas(data: bytes) -> bool:
    return data.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04")


def read_mcidas(data: bytes, path: str = "<mcidas>") -> np.ndarray:
    if len(data) < 256:
        raise unidentified(path, "McIdas area directory cut short")
    w = (0, *struct.unpack_from(">64i", data))
    modes = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}
    if w[11] not in modes:
        raise unidentified(path, f"McIdas format {w[11]}")
    mode, rawmode = modes[w[11]]
    width, height = w[10], w[9]
    check_image_size(width, height, path)
    offset = w[34] + w[15]
    stride = w[15] + w[10] * w[11] * w[14]
    linebytes = width * w[11]
    if (mode == rawmode and 0 < stride < linebytes and offset >= 0
            and offset + height * stride <= len(data)):
        # PIL maps the file for its L and I;16B rows: rows that overlap,
        # the last one read on past the end of the file, as zeros.
        buf = np.frombuffer(data + bytes(linebytes), np.uint8)[offset:]
        lines = np.lib.stride_tricks.as_strided(buf, (height, linebytes),
                                                (stride, 1))
    else:
        lines = raw_lines(data, offset, height, width, rawmode, path, stride)
    return as_read_ldr(unpack_raw(lines, width, rawmode), mode)


# ----------------------------------------------------------------------------
# SPIDER


def _spider_labbyt(t) -> int:
    """isSpiderHeader: the header's byte count, 0 where it is no SPIDER
    header."""
    h = (99,) + t

    def is_int(f):
        try:
            return f - int(f) == 0
        except (ValueError, OverflowError):
            return False

    if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def spider_header(data: bytes):
    """SpiderImageFile._open's header: (big-endian, the 27 floats with
    index 0 padded, header bytes), or None where PIL finds none."""
    if len(data) < 108:
        return None
    for big in (True, False):
        t = struct.unpack_from((">" if big else "<") + "27f", data)
        labbyt = _spider_labbyt(t)
        if labbyt:
            return big, (99,) + t, labbyt
    return None


def is_spider(data: bytes) -> bool:
    found = spider_header(data)
    return found is not None and int(found[1][5]) == 1


def read_spider(data: bytes, path: str = "<spider>") -> np.ndarray:
    found = spider_header(data)
    if found is None:
        raise unidentified(path, "not a valid Spider file")
    big, h, labbyt = found
    if int(h[5]) != 1:
        raise unidentified(path, "not a Spider 2D image")
    try:
        width, height = int(h[12]), int(h[2])
        istack, imgnumber = int(h[24]), int(h[27])
        if istack > 0 and imgnumber == 0:
            int(h[26])                               # the stack's count
    except (ValueError, OverflowError) as e:
        raise ValueError(f"{path}: SPIDER header field: {e}")
    if istack == 0 and imgnumber == 0:
        offset = labbyt
    elif istack > 0 and imgnumber == 0:
        offset = 2 * labbyt
    elif istack == 0 and imgnumber > 0:
        raise ValueError(f"{path}: SPIDER image within a stack opened "
                         "alone (PIL's AttributeError)")
    else:
        raise unidentified(path, "inconsistent stack header values")
    check_image_size(width, height, path)
    rawmode = "F;32BF" if big else "F;32F"
    lines = raw_lines(data, offset, height, width, rawmode, path)
    return as_read_ldr(unpack_raw(lines, width, rawmode), "F")


# ----------------------------------------------------------------------------
# XVThumb

# XVThumbImagePlugin.PALETTE: 3 bits of red, 3 of green, 2 of blue.
XV_PALETTE = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3)
                       for r in range(8) for g in range(8)
                       for b in range(4)], np.uint8)


def is_xvthumb(data: bytes) -> bool:
    return data.startswith(b"P7 332")


def read_xvthumb(data: bytes, path: str = "<xv>") -> np.ndarray:
    f = io.BytesIO(data)
    f.seek(6)
    f.readline()
    while True:
        s = f.readline()
        if not s:
            raise unidentified(path, "Unexpected EOF reading XV thumbnail "
                               "file")
        if s[0] != 35:
            break
    fields = s.strip().split(maxsplit=2)[:2]
    if len(fields) < 2:
        raise ValueError(f"{path}: XV thumbnail size line {s!r}")
    w, h = int(fields[0]), int(fields[1])
    check_image_size(w, h, path)
    px = unpack_raw(raw_lines(data, f.tell(), h, w, "P", path), w, "P")
    return as_read_ldr(px, "P", XV_PALETTE)
