"""Pillow 12.1's Image.resize and Image.thumbnail's size rule for the 8-bit
images image_save writes, bit for bit: the resampling of ICO's
thumbnails (LANCZOS) and ICNS's resizes (BICUBIC), on the host as PIL
does it.

resize() follows Image.resize with no box and no reducing_gap: a copy
where the size is unchanged, else Resample.c's two passes
(csrc/resample.cpp), LA and RGBA premultiplied before them and divided
back after, as PIL converts them to La / RGBa and back (a lossy round
trip). An empty image resizes to zeros, as PIL's does. Only BICUBIC and
LANCZOS are ported: the writers reach no other filter.
"""

from __future__ import annotations

import math

import numpy as np

# PIL's Image.Resampling values.
LANCZOS = 1
BICUBIC = 3


def resize(px: np.ndarray, mode: str, size, filter: int) -> np.ndarray:
    """Image.resize(size, filter) of an (H, W, C) uint8 image of mode L,
    LA, RGB or RGBA; size is (width, height), each at least 1, and filter
    BICUBIC or LANCZOS."""
    from tracerboy_tpu_torch.core.codecs import resample_library

    w, h = size
    if (w, h) == (px.shape[1], px.shape[0]):
        return px.copy()
    lib = resample_library()
    src = np.ascontiguousarray(px, np.uint8)
    c = src.shape[2]
    premultiplied = mode in ("LA", "RGBA")
    if premultiplied:
        src = src.copy()
        lib.tb_premultiply(src.ctypes.data, src.shape[0] * src.shape[1], c)
    out = np.empty((h, w, c), np.uint8)
    if lib.tb_resample(src.ctypes.data, src.shape[0], src.shape[1], c,
                       out.ctypes.data, h, w, filter):
        raise ValueError(f"resize to {size} by filter {filter}: the size "
                         "must be at least 1x1 and the filter BICUBIC or "
                         "LANCZOS")
    if premultiplied:
        lib.tb_unpremultiply(out.ctypes.data, h * w, c)
    return out


def thumbnail_size(w: int, h: int, size) -> tuple:
    """The size Image.thumbnail(size) gives a w x h image: (w, h) where it
    already fits, else preserve_aspect_ratio's, each side rounded to the
    floor or ceiling whose aspect is nearer the image's (the floor on a
    tie), at least 1."""
    x, y = map(math.floor, size)
    if x >= w and y >= h:
        return w, h
    aspect = w / h

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y
