"""The port's IM reader and writer: the pixels PIL returns for an IFUNC
Image Memory file (Pillow 12.1's ImImagePlugin, its raw unpackers and
BitDecode.c), bit for bit, without an imaging library.

Read as PIL reads it:
- a text header of "Key: value" lines (each at most 100 bytes, at least
  one of IM's own keys), ended by a NUL or 0x1A, then anything up to the
  0x1A; "Image type" picks the mode and raw mode from PIL's OPEN table,
  "Image size (x*y)" the size (int() or float() of each field, as PIL's
  number()), 512x512 L by default;
- "Lut" (any value): 768 bytes of a planar RGB table after the 0x1A. One
  that is not grey makes an L or P image P (its rows then 8-bit indices)
  and an LA image PA (P and A planes);
- the rows after that, bottom-up (the raw decoder's ystep -1), the
  first frame of a file of several: "1" (MSB first), L, P, P;2 and P;4,
  I;16 (little-endian), I;16L, I;16B, I;32 and I;32S (I), F;8, F;8S,
  F;16, F;16S, F;32 (unsigned), F;32F, the planar rows of RGB;L, RGBA;L,
  RGBX;L, LA;L, PA;L, CMYK;L and YCbCr;L, interleaved RGB, and RGB;T (a
  G, an R and a B plane, each the whole image); F;2-F;31 (the "L*j"
  types) packed by csrc/small_decode.cpp's tb_bit_decode.
- converted as the JAX read_ldr converts it (image_io.as_read_ldr): a
  P image without a palette is black, YCbCr goes through Convert.c's
  fixed-point ycbcr2rgb.

Refused as PIL refuses: UnidentifiedImageError where PIL's _open raises
SyntaxError (no LF in the first 100 bytes, a line too long or not
"Key: value", none of IM's keys, no 0x1A, a Lut cut short) or its size is
not two positive numbers; ValueError where PIL lets another error out
(a size field that is no number, an unknown type or one without an
unpacker, RLB and PA without a colour Lut, data cut short).

The writer is core/image_save.save_im, reached by image_io.write_png on
a path ending in .im.
"""

from __future__ import annotations

import io
import re

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    as_read_ldr,
    check_image_size,
    unpack_raw,
)
from tracerboy_tpu_torch.core.rawformats import (
    palette_table,
    raw_lines,
    unidentified,
)

COMMENT, FRAMES, LUT = "Comment", "File size (no of images)", "Lut"
SCALE, SIZE, MODE = "Scale (x,y)", "Image size (x*y)", "Image type"
TAGS = (COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name",
        SCALE, SIZE, MODE)

# ImImagePlugin.OPEN: image type -> (mode, raw mode).
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

# Image mode -> the raw modes PIL has an unpacker for.
_UNPACKS = {"1": ("1",), "L": ("L",), "P": ("P", "P;2", "P;4"),
            "I;16": ("I;16",), "I;16L": ("I;16L",), "I;16B": ("I;16B",),
            "I": ("I;32", "I;32S"), "F": ("F;8", "F;8S", "F;16", "F;16S",
                                          "F;32", "F;32F"),
            "RGB": ("RGB;L", "RGBX;L", "RGB", "RGB;T", "RYB;T"),
            "RGBA": ("RGBA;L",), "LA": ("LA;L",), "PA": ("PA;L",),
            "CMYK": ("CMYK;L",), "YCbCr": ("YCbCr;L",)}

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def is_im(data: bytes) -> bool:
    """Whether ImImageFile._open gets through the header (a size field
    that is no number raises ValueError here, as it escapes PIL)."""
    try:
        im_header(data)
    except UnidentifiedImageError:
        return False
    return True


def im_header(data: bytes, path: str = "<im>") -> dict:
    """ImImageFile._open: the size, the mode and raw mode, the Lut (or
    None) and the offset of the first frame's rows."""
    if b"\n" not in data[:100]:
        raise unidentified(path, "not an IM file")
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode = "L"
    f = io.BytesIO(data)
    n = 0
    while True:
        s = f.read(1)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        s += f.readline()
        if len(s) > 100:
            raise unidentified(path, "IM header line too long")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise unidentified(path, f"syntax error in IM header: {s!r}")
        k, v = (g.decode("latin-1") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        if k in TAGS:
            n += 1
    if not n:
        raise unidentified(path, "not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = f.read(1)
    if not s:
        raise unidentified(path, "IM file truncated before its 0x1A")
    mode, lut = info[MODE], None
    if LUT in info:
        lut = f.read(768)
        if len(lut) < 768:
            raise unidentified(path, "IM Lut cut short")
        planes = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((planes == planes[0]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
    return dict(size=info[SIZE], mode=mode, rawmode=rawmode, lut=lut,
                offset=f.tell())


def _size(size, path: str):
    """ImageFile's check of the size PIL's _open set: TypeError (passed
    on) for one number, SyntaxError for a side that is not positive; a
    size PIL then cannot make an image of is refused."""
    if not isinstance(size, tuple):
        raise unidentified(path, f"IM size {size!r} is one number")
    if size[0] <= 0 or size[1] <= 0:
        raise unidentified(path, f"IM size {size!r}")
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise ValueError(f"{path}: IM size {size!r} is no image size")
    check_image_size(*size, path)
    return size


def read_im(data: bytes, path: str = "<im>") -> np.ndarray:
    """An IM file's pixels as the JAX read_ldr gets them through PIL:
    (H, W, 3|4) uint8."""
    head = im_header(data, path)
    w, h = _size(head["size"], path)
    mode, rawmode, offset = head["mode"], head["rawmode"], head["offset"]
    if mode not in _UNPACKS:
        raise ValueError(f"{path}: unrecognized image mode {mode!r}")
    # A P image without a colour Lut has no palette: PIL's is black.
    palette = palette_table(head["lut"] if rawmode in ("P", "PA;L")
                            and head["lut"] is not None else b"", True)
    bits = rawmode[2:] if rawmode.startswith("F;") else ""
    if bits.isdigit() and int(bits) not in (8, 16, 32):
        from tracerboy_tpu_torch.core.codecs import small_library

        buf = np.frombuffer(data, np.uint8)[offset:].copy()
        px = np.zeros((h, w, 1), np.float32)
        if small_library().tb_bit_decode(buf.ctypes.data, buf.size,
                                         px.ctypes.data, w, h, int(bits)):
            raise ValueError(f"{path}: image file is truncated (IM)")
        return as_read_ldr(px, "F")
    if rawmode not in _UNPACKS[mode]:
        raise ValueError(f"{path}: unknown raw mode {rawmode} for an IM "
                         f"image of mode {mode}")
    if rawmode in ("RGB;T", "RYB;T"):
        page = w * h
        if len(data) < offset + 3 * page:
            raise ValueError(f"{path}: image file is truncated (IM)")
        planes = np.frombuffer(data, np.uint8, 3 * page, offset).reshape(
            3, h, w)[:, ::-1]
        return np.ascontiguousarray(np.stack(
            [planes[1], planes[0], planes[2]], -1))
    lines = raw_lines(data, offset, h, w, rawmode, path)[::-1]
    return as_read_ldr(unpack_raw(lines, w, rawmode), mode, palette)

