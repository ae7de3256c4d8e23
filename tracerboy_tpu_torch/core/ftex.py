"""The port's FTEX reader: the pixels PIL returns for a Texture File
Format file (IW2:EOC; Pillow 12.1's FtexImagePlugin), bit for bit,
without an imaging library.

FTEX is a game texture: after the magic, version, width, height, mipmap
count and format count (little-endian int32s), one format entry (format,
offset), and at that offset the first mipmap's byte count and bytes.
Only mipmap 0 is read: format 0 is DXT1, decoded by the "bcn" decoder the
DDS reader uses (core/dds.py decode_bcn, csrc/dds_decode.cpp), RGBA;
format 1 is raw RGB.

Refused as PIL refuses: UnidentifiedImageError where PIL gives up with
struct.error (a header cut short, no mipmap size at the offset), passing
the file on; ValueError where PIL raises otherwise: a side that is not
positive (PIL's plugin closes the file it was handed before its size is
checked, so the next plugin's seek fails), a format count other than 1
(PIL's assert, an AssertionError Image.open does not catch), a negative
offset, a mipmap size below -1 (-1 reads the rest of the file), a format
other than 0 and 1, data cut short.

write_ftex writes one mipmap in DXT1 (core/blp.py encode_dxt), for the
demo scenes' textures.
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    check_image_size,
)

MAGIC = b"FTEX"


def is_ftex(data: bytes) -> bool:
    """FtexImagePlugin._accept."""
    return data.startswith(MAGIC)


def read_ftex(data: bytes, path: str = "<ftex>") -> np.ndarray:
    """An FTEX file's first mipmap as the JAX read_ldr gets it through
    PIL: (H, W, 4) uint8 for DXT1, (H, W, 3) for raw RGB."""
    from tracerboy_tpu_torch.core.dds import decode_bcn

    def unidentified(why):
        return UnidentifiedImageError(f"{path}: cannot identify image file "
                                      f"({why})")

    if len(data) < 24:
        raise unidentified("FTEX header cut short")
    width, height, _, format_count = struct.unpack_from("<4i", data, 8)
    if format_count != 1:
        raise ValueError(f"{path}: an FTEX of {format_count} formats (PIL's "
                         "assert format_count == 1)")
    if len(data) < 32:
        raise unidentified("FTEX format entry cut short")
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError(f"{path}: [Errno 22] Invalid argument (FTEX offset "
                         f"{where})")
    if len(data) < where + 4:
        raise unidentified("no FTEX mipmap size")
    (size,) = struct.unpack_from("<i", data, where)
    if size < -1:
        raise ValueError(f"{path}: read length must be non-negative or -1 "
                         f"(FTEX mipmap size {size})")
    mip = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"{path}: Invalid texture compression format: "
                         f"{fmt}")
    if width <= 0 or height <= 0:
        # PIL's plugin has closed the file it was handed by then, so the
        # next plugin's seek fails.
        raise ValueError(f"{path}: seek of closed file (an FTEX of "
                         f"{width}x{height})")
    check_image_size(width, height, path)
    if fmt == 0:
        return decode_bcn(mip, width, height, 1, path=path)
    need = width * height * 3
    if len(mip) < need:
        raise ValueError(f"{path}: image file is truncated (FTEX)")
    return np.frombuffer(mip, np.uint8, need).reshape(height, width, 3).copy()


def write_ftex(path: str, img: np.ndarray) -> None:
    """Write an 8-bit RGB(A) image (or floats in [0,1], quantised as
    write_png quantises them) as an FTEX of one DXT1 mipmap (format 0)."""
    from tracerboy_tpu_torch.core.blp import encode_dxt
    from tracerboy_tpu_torch.core.image_io import _to_uint8

    img = _to_uint8(img)
    h, w = img.shape[:2]
    mip = encode_dxt(img, 1)
    header = MAGIC + struct.pack("<5i2i", 1, w, h, 1, 1, 0, 32)
    with open(path, "wb") as f:
        f.write(header + struct.pack("<i", len(mip)) + mip)
