"""The port's FLI/FLC reader and writer: the pixels PIL returns for an
Autodesk FLI or FLC animation's first frame (Pillow 12.1's
FliImagePlugin and libImaging's FliDecode.c), bit for bit, without an
imaging library.

Read as PIL reads it: a 128-byte header (magic 0xAF11 or 0xAF12, flags
0 or 3, its reserved fields zero, the size at bytes 8 and 10); the
palette from the first colour chunk of the frame header at byte 128, or
of the frame after a 0xF100 prefix chunk (chunk 4, COLOR_256, as is;
chunk 11, COLOR_64, shifted left by 2, the low 8 bits kept; each packet
skips entries, a count of 0 is 256; entries not set keep the grey
ramp); then frame 0, always read at byte 128 (so a file with a prefix
chunk is refused where PIL's decoder finds no frame there), onto a
zeroed image by csrc/small_decode.cpp's tb_fli_decode, in ImageFile's
reads of the frame's size at a time.

Refused as PIL refuses: UnidentifiedImageError where PIL's _open raises
SyntaxError, IndexError, struct.error or EOFError (a header PIL does not
take, a frame header or colour chunk cut short, palette entries past
255, a partial entry), or the size has a side of 0, passing the file on;
ValueError where PIL's load raises (data cut short, a frame or chunk
the decoder refuses).

write_fli writes a one-frame FLC of an index image and its palette: a
COLOR_256 chunk and a BRUN chunk of runs, for the demo scenes' textures.
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import as_read_ldr, check_image_size
from tracerboy_tpu_torch.core.rawformats import unidentified

_ERRORS = {-1: "buffer overrun when reading image file",
           -2: "broken data stream when reading image file",
           -3: "unrecognized data stream contents when reading image file"}


def is_fli(data: bytes) -> bool:
    """FliImagePlugin._accept."""
    return (len(data) >= 16
            and struct.unpack_from("<H", data, 4)[0] in (0xAF11, 0xAF12)
            and struct.unpack_from("<H", data, 14)[0] in (0, 3))


def fli_layout(data: bytes, path: str = "<fli>") -> dict:
    """FliImageFile._open: the size and the (256, 3) palette."""
    try:
        return _open(data, path)
    except (IndexError, struct.error) as e:    # ImageFile: SyntaxError
        raise unidentified(path, f"FLI header cut short ({e})") from None


def _open(data: bytes, path: str) -> dict:
    s = data[:128]
    if not (is_fli(s) and s[20:22] == bytes(2) and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise unidentified(path, "not an FLI/FLC file")
    w, h = struct.unpack_from("<HH", s, 8)
    palette = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, 1)
    pos = 128
    s = data[pos:pos + 16]
    pos += len(s)
    if struct.unpack_from("<H", s, 4)[0] == 0xF100:    # a prefix chunk
        pos = 128 + struct.unpack_from("<I", s)[0]
        s = data[pos:pos + 16]
        pos += len(s)
    if struct.unpack_from("<H", s, 4)[0] == 0xF1FA:
        chunk_size = None
        for _ in range(struct.unpack_from("<H", s, 6)[0]):
            if chunk_size is not None:
                pos += chunk_size - 6
            s = data[pos:pos + 6]
            pos += len(s)
            kind = struct.unpack_from("<H", s, 4)[0]
            if kind in (4, 11):
                _palette(data, pos, palette, 2 if kind == 11 else 0)
                break
            chunk_size = struct.unpack_from("<I", s)[0]
            if not chunk_size:
                break
    s = data[128:132]
    if not s:
        raise unidentified(path, "missing frame size")
    (framesize,) = struct.unpack("<I", s)
    check_image_size(w, h, path)
    return dict(width=w, height=h, framesize=framesize,
                palette=(palette & 255).astype(np.uint8))


def _palette(data: bytes, pos: int, palette: np.ndarray, shift: int):
    """FliImageFile._palette: its packets into `palette`."""
    i = 0
    (packets,) = struct.unpack_from("<H", data[pos:pos + 2])
    pos += 2
    for _ in range(packets):
        s = data[pos:pos + 2]
        pos += len(s)
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        if len(s) % 3:
            raise IndexError("partial palette entry")
        if i + len(s) // 3 > 256:
            raise IndexError("palette index past 255")
        palette[i:i + len(s) // 3] = np.frombuffer(s, np.uint8).reshape(
            -1, 3).astype(np.int64) << shift
        i += len(s) // 3


def read_fli(data: bytes, path: str = "<fli>") -> np.ndarray:
    """An FLI/FLC file's first frame as the JAX read_ldr gets it through
    PIL: (H, W, 3) uint8."""
    import ctypes

    from tracerboy_tpu_torch.core.codecs import small_library

    lay = fli_layout(data, path)
    w, h, block = lay["width"], lay["height"], lay["framesize"]
    im = np.zeros((h, w), np.uint8)
    err = ctypes.c_int64(0)
    pos, buf = 128, b""
    while True:                          # ImageFile.load's reads
        s = data[pos:pos + block]
        pos += len(s)
        if not s:
            raise ValueError(f"{path}: image file is truncated (FLI)")
        buf = np.frombuffer(buf + s, np.uint8)
        n = small_library().tb_fli_decode(buf.ctypes.data, buf.size,
                                          im.ctypes.data, w, h,
                                          ctypes.byref(err))
        if n < 0:
            break
        buf = buf[n:].tobytes()
    if err.value:
        raise ValueError(f"{path}: {_ERRORS[err.value]} (FLI)")
    return as_read_ldr(im[..., None], "P", lay["palette"])


def _chunk(kind: int, body: bytes) -> bytes:
    return struct.pack("<IH", 6 + len(body), kind) + body


def brun(idx: np.ndarray) -> bytes:
    """A BRUN chunk's body of an (H, W) uint8 image: each line its
    packet count, then runs of at most 127 equal bytes."""
    from tracerboy_tpu_torch.core.sgi import row_runs

    h, _ = idx.shape
    row, _, length, value = row_runs(idx, 127)
    count = np.bincount(row, minlength=h)
    line_start = np.cumsum(1 + 2 * count) - (1 + 2 * count)
    first = np.cumsum(count) - count
    at = line_start[row] + 1 + 2 * (np.arange(len(row)) - first[row])
    out = np.empty(int((1 + 2 * count).sum()), np.uint8)
    out[line_start] = count & 255
    out[at] = length
    out[at + 1] = value
    return out.tobytes()


def fli_bytes(idx: np.ndarray, palette: np.ndarray) -> bytes:
    """A one-frame FLC of (H, W) uint8 indices into a (256, 3) uint8
    palette: a COLOR_256 chunk of the 256 entries and a BRUN chunk."""
    h, w = idx.shape
    colours = struct.pack("<HBB", 1, 0, 0) + np.ascontiguousarray(
        palette, np.uint8).tobytes()
    chunks = _chunk(4, colours) + _chunk(15, brun(idx))
    frame = struct.pack("<IHH8x", 16 + len(chunks), 0xF1FA, 2) + chunks
    head = struct.pack("<IHHHHHHI", 128 + len(frame), 0xAF12, 1, w, h, 8,
                       3, 70)
    return head.ljust(80, b"\0") + struct.pack("<II", 128, 128 + len(
        frame)).ljust(48, b"\0") + frame


def write_fli(path: str, idx: np.ndarray, palette: np.ndarray) -> None:
    """Write fli_bytes(idx, palette) to `path`."""
    with open(path, "wb") as f:
        f.write(fli_bytes(idx, palette))
