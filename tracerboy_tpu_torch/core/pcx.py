"""The port's PCX and DCX readers: the pixels PIL returns for a Paintbrush
image (Pillow 12.1's PcxImagePlugin and libImaging's PcxDecode.c) and for
the first page of an Intel DCX file (DcxImagePlugin), bit for bit,
without an imaging library.

PCX is the oldest texture format still met in game data. Read as PIL
reads it:
- the header's window (x0, y0, x1, y1) gives the size (x1 - x0 + 1,
  y1 - y0 + 1); the lines start at byte 128, each of planes x stride
  bytes, where the stride is (width x bits + 7) // 8, made even where
  the header's bytes-per-line disagrees with it (PIL does not trust the
  header's; CVE-2020-35653);
- 1 bit in 1 plane (bi-level), 1 bit in 2 or 4 planes (indices into the
  header's 16-colour palette, the planes moved together to
  (width + 7) // 8 bytes apart), 8 bits in 1 plane at version 5 (grey, or
  indices into the 256-colour palette of the file's last 769 bytes where
  they start with 0x0C and do not hold the linear grey ramp), 8 bits in
  3 planes at version 5 (RGB, each plane width bytes apart once
  csrc/small_decode.cpp has moved them together as PcxDecode.c does);
- the run lengths by csrc/small_decode.cpp's tb_pcx_decode.

A DCX is a directory of up to 1024 PCX offsets after its magic; PIL
opens the first page, the PCX at the first offset, its 8-bit palette
still read from the end of the whole file.

Refused as PIL refuses: UnidentifiedImageError where PIL's plugin gives
up with SyntaxError, IndexError or struct.error (a header shorter than
68 bytes, an empty window; for DCX a directory cut short, no pages, a
first page that is no PCX), which passes the file on to PIL's later
plugins; ValueError where PIL raises otherwise (an unknown mode, an 8-bit
version-5 file shorter than 769 bytes, whose palette seek fails, a run
across the end of a line, data cut short).

write_pcx writes an RGB image as version-5 PCX in 3 planes, its runs
within each line, for the demo scenes' textures.
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    as_read_ldr,
    check_image_size,
)

DCX_MAGIC = 0x3ADE68B1
# Bits a pixel of the unpacker of each raw mode (PcxDecode.c's state->bits).
UNPACK_BITS = {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}


def is_pcx(data: bytes) -> bool:
    """PcxImagePlugin._accept."""
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def is_dcx(data: bytes) -> bool:
    """DcxImagePlugin._accept."""
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] == DCX_MAGIC


def _unidentified(path: str, why: str):
    return UnidentifiedImageError(f"{path}: cannot identify image file "
                                  f"({why})")


def pcx_layout(data: bytes, at: int = 0, path: str = "<pcx>") -> dict:
    """The PCX header at `at` as PIL's _open reads it: size, mode, the
    unpacker's raw mode, planes, the line's bytes, the palette and where
    the lines start."""
    s = data[at:at + 68]
    if not is_pcx(s):
        raise _unidentified(path, "not a PCX file")
    if len(s) < 68:
        raise _unidentified(path, "PCX header cut short")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise _unidentified(path, "bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    (provided,) = struct.unpack_from("<H", s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(s, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        if len(data) < 769:
            raise ValueError(f"{path}: [Errno 22] Invalid argument (a "
                             "version-5 PCX shorter than its palette)")
        tail = data[-769:]
        if tail[0] == 12 and tail[1:] != bytes(
                v for i in range(256) for v in (i, i, i)):
            mode = rawmode = "P"
            palette = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError(f"{path}: unknown PCX mode (version {version}, "
                         f"{bits} bits, {planes} planes)")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    check_image_size(width, height, path)
    stride = (width * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    return dict(width=width, height=height, mode=mode, rawmode=rawmode,
                planes=planes, bytes=planes * stride, palette=palette,
                offset=at + 128)


def _lines(data: bytes, lay: dict, path: str) -> np.ndarray:
    """(height, bytes) uint8: the decoded lines (csrc/small_decode.cpp)."""
    from tracerboy_tpu_torch.core.codecs import small_library

    src = np.frombuffer(data, np.uint8)[lay["offset"]:]
    src = np.ascontiguousarray(src)
    out = np.zeros((lay["height"], lay["bytes"]), np.uint8)
    rc = small_library().tb_pcx_decode(src.ctypes.data, src.size,
                                       out.ctypes.data, lay["width"],
                                       lay["height"], lay["bytes"],
                                       UNPACK_BITS[lay["rawmode"]])
    if rc == -1:
        raise ValueError(f"{path}: buffer overrun when reading image file "
                         "(a PCX run crosses the end of a line)")
    if rc:
        raise ValueError(f"{path}: image file is truncated (PCX)")
    return out


def _unpack(lines: np.ndarray, lay: dict) -> np.ndarray:
    """PIL's unpacker for the layout's raw mode: (H, W, C) in its mode."""
    w, raw = lay["width"], lay["rawmode"]
    if raw == "1":
        bits = np.unpackbits(lines, axis=1)[:, :w]
        return (bits * np.uint8(255))[..., None]
    if raw.startswith("P;"):
        s = (w + 7) // 8
        planes = int(raw[2])
        idx = np.zeros((lines.shape[0], w), np.uint8)
        for k in range(planes):
            plane = np.unpackbits(lines[:, k * s:(k + 1) * s], axis=1)[:, :w]
            idx |= plane << np.uint8(k)
        return idx[..., None]
    if raw == "RGB;L":
        return np.stack([lines[:, k * w:(k + 1) * w] for k in range(3)], -1)
    return lines[:, :w, None]


def read_pcx(data: bytes, path: str = "<pcx>", at: int = 0) -> np.ndarray:
    """A PCX file's pixels (its header at `at`) as the JAX read_ldr gets
    them through PIL: (H, W, 3) uint8."""
    lay = pcx_layout(data, at, path)
    px = _unpack(_lines(data, lay, path), lay)
    return as_read_ldr(px, lay["mode"], lay["palette"])


def read_dcx(data: bytes, path: str = "<dcx>") -> np.ndarray:
    """A DCX file's first page as the JAX read_ldr gets it through PIL."""
    if not is_dcx(data):
        raise _unidentified(path, "not a DCX file")
    offsets = []
    for i in range(1024):
        entry = data[4 + 4 * i:8 + 4 * i]
        if len(entry) < 4:
            raise _unidentified(path, "DCX directory cut short")
        (offset,) = struct.unpack("<I", entry)
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise _unidentified(path, "a DCX without pages: PIL's EOFError")
    return read_pcx(data, path, offsets[0])


def write_pcx(path: str, img: np.ndarray) -> None:
    """Write an 8-bit RGB image, (H, W, 3) uint8 (or floats in [0,1],
    quantised as write_png quantises them), as a version-5 PCX of 3
    planes (each line's planes padded to an even width); every run of
    two or more bytes, and every byte of 0xC0 or more, a run packet."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.core.sgi import packets, row_runs

    img = _to_uint8(img)
    h, w, c = img.shape
    if c != 3 or w > 65535 or h > 65535:
        raise ValueError(f"PCX cannot hold a {w}x{h}x{c} image")
    stride = w + w % 2
    lines = np.zeros((h, 3, stride), np.uint8)
    lines[..., :w] = img.transpose(0, 2, 1)
    _, _, length, value = row_runs(lines.reshape(h, 3 * stride), 63)
    heads = np.where((length > 1) | (value >= 0xC0), 0xC0 | length, -1)
    header = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1,
                         72, 72) + bytes(49) + struct.pack(
        "<BHH", 3, stride, 1) + bytes(58)
    with open(path, "wb") as f:
        f.write(header + packets(heads, value).tobytes())
