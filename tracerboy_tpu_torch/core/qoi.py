"""The port's QOI reader: the pixels PIL returns (Pillow 12.1's
QoiImagePlugin.py), bit for bit, without an imaging library.

pbrt-v4 reads QOI natively, so a pbrt-v4 scene may name one as a
texture; the JAX package reads it through PIL. The header's fourth
byte picks the mode (3 channels RGB, any other value RGBA); the ops
INDEX, DIFF, LUMA, RUN, RGB and RGBA are decoded by csrc/webp_decode.cpp
tb_qoi_decode as Pillow's decoder decodes them (its index starts empty,
so an unset slot reads 0, 0, 0, 0, and runs do not enter the index; the
end marker is not read). write_qoi writes QOI with the specification's
encoder, which Pillow's encoder follows.

Refused as PIL refuses: NotImplementedError (unidentified) for a header
shorter than 13 bytes, ValueError for a zero or oversized image and for
a stream that ends before the last pixel (Pillow's IndexError).
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.codecs import webp_library
from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    check_image_size,
)


def is_qoi(data: bytes) -> bool:
    return data.startswith(b"qoif")


def read_qoi(data: bytes, path: str = "<qoi>") -> np.ndarray:
    """(H, W, 3) RGB or (H, W, 4) RGBA uint8."""
    if not is_qoi(data):
        raise ValueError(f"{path}: not a QOI file")
    if len(data) < 13:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(short QOI header)")
    width, height = struct.unpack_from(">II", data, 4)
    channels = 3 if data[12] == 3 else 4
    check_image_size(width, height, path)
    out = np.empty((height, width, channels), np.uint8)
    stream = np.frombuffer(data, np.uint8, max(len(data) - 14, 0),
                           min(14, len(data)))
    if webp_library().tb_qoi_decode(stream.ctypes.data, stream.size,
                                    width * height, channels,
                                    out.ctypes.data):
        raise ValueError(f"{path}: QOI data ends before the last pixel")
    return out


def write_qoi(path: str, img: np.ndarray) -> None:
    """Write an 8-bit RGB or RGBA image, (H, W, 3|4) uint8 (or floats in
    [0,1], quantised as write_png quantises them), as QOI (encode_qoi)."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8

    with open(path, "wb") as f:
        f.write(encode_qoi(_to_uint8(img)))


def encode_qoi(img: np.ndarray) -> bytes:
    """An (H, W, 3|4) uint8 image as QOI with the specification's encoder,
    which Pillow's QoiEncoder follows (colourspace byte 1, as Pillow
    writes it): csrc/webp_decode.cpp tb_qoi_encode."""
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"QOI needs 3 or 4 channels, got {c}")
    out = np.empty(14 + h * w * (c + 1) + 8, np.uint8)
    n = webp_library().tb_qoi_encode(img.ctypes.data, h * w, c, w, h,
                                     out.ctypes.data)
    return out[:n].tobytes()
