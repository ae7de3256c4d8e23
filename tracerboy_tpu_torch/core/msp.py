"""The port's MSP reader: the pixels PIL returns for a Windows Paint
(MSP) file (Pillow 12.1's MspImagePlugin and its MspDecoder), bit for
bit, without an imaging library.

Read as PIL reads it: a 32-byte little-endian header whose sixteen
16-bit words XOR to 0, the size at bytes 4 and 6; then
- "DanM" (version 1): bi-level rows, (width + 7) // 8 bytes each, most
  significant bit first, a set bit white;
- "LinS" (version 2): a map of one 16-bit row length per row, then the
  rows, each a run-length stream (csrc/small_decode.cpp's tb_msp_decode;
  a row of length 0 is white). PIL appends every row's bytes to one
  stream and cuts that into rows, so a row that decodes to more or fewer
  bytes than a row shifts the rows after it, as here.

Refused as PIL refuses: UnidentifiedImageError where PIL's _open raises
SyntaxError (a header cut short, a checksum that is not 0) or the size
has a side of 0, passing the file on; ValueError where PIL raises
otherwise (a row map or a row cut short, a run cut by its row's end, too
few bytes for the image).
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    as_read_ldr,
    check_image_size,
    unpack_raw,
)
from tracerboy_tpu_torch.core.rawformats import raw_lines, unidentified


def is_msp(data: bytes) -> bool:
    """MspImagePlugin._accept."""
    return data.startswith((b"DanM", b"LinS"))


def read_msp(data: bytes, path: str = "<msp>") -> np.ndarray:
    """An MSP file's pixels as the JAX read_ldr gets them through PIL:
    (H, W, 3) uint8, 0 or 255."""
    if len(data) < 32:
        raise unidentified(path, "MSP header cut short")
    words = np.frombuffer(data, "<u2", 16)
    if np.bitwise_xor.reduce(words):
        raise unidentified(path, "bad MSP checksum")
    w, h = struct.unpack_from("<HH", data, 4)
    check_image_size(w, h, path)
    linebytes = (w + 7) // 8
    if data.startswith(b"DanM"):
        lines = raw_lines(data, 32, h, w, "1", path)
    else:
        from tracerboy_tpu_torch.core.codecs import small_library

        if len(data) < 32 + 2 * h:
            raise ValueError(f"{path}: Truncated MSP file in row map")
        rowlen = np.frombuffer(data, "<u2", h, 32).astype(np.uint16)
        src = np.frombuffer(data, np.uint8)[32 + 2 * h:].copy()
        lines = np.empty((h, linebytes), np.uint8)
        got = small_library().tb_msp_decode(
            src.ctypes.data, src.size, rowlen.ctypes.data, h, linebytes,
            lines.ctypes.data, lines.size)
        if got < 0:
            raise ValueError(f"{path}: Truncated or corrupted MSP row")
        if got < lines.size:
            raise ValueError(f"{path}: not enough image data (MSP)")
    return as_read_ldr(unpack_raw(lines, w, "1"), "1")
