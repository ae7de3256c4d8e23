"""The port's XBM reader: the pixels PIL returns for an X11 bitmap
(Pillow 12.1's XbmImagePlugin and libImaging's XbmDecode.c), bit for bit,
without an imaging library.

Read as PIL reads it: the plugin's header expression on the first 512
bytes (the width and height #defines, an optional hot spot, then
anything up to the last "_bits[]" there), then csrc/small_decode.cpp's
tb_xbm_decode from the end of that match: each byte the two characters
after an 'x' as hex digits (one that is no hex digit counts 0),
(width + 7) // 8 bytes a row, bits least significant first (PIL's 1;R),
a set bit white.

Refused as PIL refuses: UnidentifiedImageError where the header does not
match or the size has a side of 0, passing the file on; ValueError for
data cut short.
"""

from __future__ import annotations

import re

import numpy as np

from tracerboy_tpu_torch.core.image_io import check_image_size
from tracerboy_tpu_torch.core.rawformats import unidentified

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)


def is_xbm(data: bytes) -> bool:
    """XbmImagePlugin._accept."""
    return data[:16].lstrip().startswith(b"#define")


def read_xbm(data: bytes, path: str = "<xbm>") -> np.ndarray:
    """An XBM file's pixels as the JAX read_ldr gets them through PIL:
    (H, W, 3) uint8, 0 or 255."""
    from tracerboy_tpu_torch.core.codecs import small_library

    m = _HEAD.match(data[:512])
    if not m:
        raise unidentified(path, "not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    check_image_size(w, h, path)
    linebytes = (w + 7) // 8
    src = np.frombuffer(data, np.uint8)[m.end():].copy()
    lines = np.empty((h, linebytes), np.uint8)
    if small_library().tb_xbm_decode(src.ctypes.data, src.size,
                                     lines.ctypes.data, linebytes, h):
        raise ValueError(f"{path}: image file is truncated (XBM)")
    bits = np.unpackbits(lines, axis=1, bitorder="little")[:, :w]
    return np.repeat((bits * np.uint8(255))[..., None], 3, axis=2)
