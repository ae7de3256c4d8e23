"""The port's Sun raster reader and writer: the pixels PIL returns for a
Sun raster file (Pillow 12.1's SunImagePlugin and libImaging's
SunRleDecode.c), bit for bit, without an imaging library.

Read as PIL reads it: a 32-byte big-endian header (magic, width, height,
depth, length, type, colour-map type and length); depth 1 (bi-level,
set bits black: PIL's 1;I), 4 (L;4, nibbles scaled by 17), 8 (L), 24
and 32 (RGB, in RGB order for type 3 and BGR for the others, the fourth
byte of 32 dropped); a colour map (type 1, at most 1024 bytes, planar
R, G and B of length // 3 entries, black past them) makes an L image P;
then the rows:
- types 0, 1, 3, 4 and 5: raw, each row padded to 16 bits;
- type 2: csrc/small_decode.cpp's tb_sun_rle_decode, byte runs that
  ignore rows (a run carries on into the next row), the rows unpadded.

Refused as PIL refuses: UnidentifiedImageError where PIL's _open raises
SyntaxError or struct.error (a header cut short, another depth, a colour
map longer than 1024 bytes or of another type, another file type) or the
size has a side of 0, passing the file on; ValueError for data cut
short, a colour map on a 1-bit or RGB image or of more than 256
entries (PIL cannot put such a palette on the image).

write_sun writes a 24-bit RGB image in RLE (type 2) or raw (type 1), BGR
order, for the demo scenes' textures.
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    _RAW_BITS,
    as_read_ldr,
    check_image_size,
    unpack_raw,
)
from tracerboy_tpu_torch.core.rawformats import (
    palette_table,
    raw_lines,
    unidentified,
)

MAGIC = 0x59A66A95


def is_sun(data: bytes) -> bool:
    """SunImagePlugin._accept."""
    return len(data) >= 4 and struct.unpack_from(">I", data)[0] == MAGIC


def sun_layout(data: bytes, path: str = "<sun>") -> dict:
    """The header as PIL's _open reads it."""
    if len(data) < 32:
        raise unidentified(path, "Sun raster header cut short")
    w, h, depth, _, kind, map_type, map_len = struct.unpack_from(
        ">7I", data, 4)
    modes = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
             24: ("RGB", "RGB" if kind == 3 else "BGR"),
             32: ("RGB", "RGBX" if kind == 3 else "BGRX")}
    if depth not in modes:
        raise unidentified(path, f"Sun raster depth {depth}")
    mode, rawmode = modes[depth]
    palette = None
    if map_len:
        if map_len > 1024:
            raise unidentified(path, "Sun colour map longer than 1024")
        if map_type != 1:
            raise unidentified(path, f"Sun colour map type {map_type}")
        palette = palette_table(data[32:32 + map_len], planar=True)
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if kind not in (0, 1, 2, 3, 4, 5):
        raise unidentified(path, f"Sun raster file type {kind}")
    check_image_size(w, h, path)
    if palette is not None and (mode != "P" or map_len // 3 > 256):
        raise ValueError(f"{path}: a Sun colour map of {map_len} bytes on "
                         f"a {mode} image (PIL cannot load its palette)")
    return dict(width=w, height=h, depth=depth, kind=kind, mode=mode,
                rawmode=rawmode, palette=palette, offset=32 + map_len)


def read_sun(data: bytes, path: str = "<sun>") -> np.ndarray:
    """A Sun raster file's pixels as the JAX read_ldr gets them through
    PIL: (H, W, 3) uint8."""
    lay = sun_layout(data, path)
    w, h, rawmode = lay["width"], lay["height"], lay["rawmode"]
    if lay["kind"] == 2:
        from tracerboy_tpu_torch.core.codecs import small_library

        linebytes = (w * _RAW_BITS[rawmode] + 7) // 8
        buf = np.frombuffer(data, np.uint8)[lay["offset"]:].copy()
        lines = np.empty((h, linebytes), np.uint8)
        if small_library().tb_sun_rle_decode(buf.ctypes.data, buf.size,
                                             lines.ctypes.data, linebytes,
                                             h):
            raise ValueError(f"{path}: image file is truncated (Sun RLE)")
    else:
        stride = (w * lay["depth"] + 15) // 16 * 2
        lines = raw_lines(data, lay["offset"], h, w, rawmode, path, stride)
    return as_read_ldr(unpack_raw(lines, w, rawmode), lay["mode"],
                       lay["palette"])


def rle_encode(stream: np.ndarray) -> bytes:
    """Sun's byte RLE of a uint8 stream: runs of 3 to 256 bytes (and runs
    of two 0x80) as 0x80, n - 1, value; a lone 0x80 as 0x80, 0; the
    other bytes literal."""
    from tracerboy_tpu_torch.core.sgi import row_runs

    _, _, length, value = row_runs(stream.reshape(1, -1), 256)
    run = (length >= 3) | ((value == 0x80) & (length == 2))
    lone = ~run & (value == 0x80)
    lit = ~run & ~lone
    size = np.where(run, 3, np.where(lone, 2, length))
    start = np.cumsum(size) - size
    out = np.empty(int(size.sum()), np.uint8)
    out[start[run | lone]] = 0x80
    out[start[run] + 1] = length[run] - 1
    out[start[run] + 2] = value[run]
    out[start[lone] + 1] = 0
    n = length[lit]
    first = np.repeat(start[lit] - (np.cumsum(n) - n), n)
    out[first + np.arange(int(n.sum()))] = np.repeat(value[lit], n)
    return out.tobytes()


def write_sun(path: str, img: np.ndarray, rle: bool = True) -> None:
    """Write an RGB image, (H, W, 3) uint8 (or floats in [0,1], quantised
    as write_png quantises them), as a 24-bit Sun raster of BGR samples:
    RLE (type 2; the runs run on across rows, as Sun's RLE allows) or
    raw (type 1). Rows must be of an even length, so that neither layout
    pads them."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8

    img = _to_uint8(img)
    h, w, c = img.shape
    if c != 3 or w * 3 % 2:
        raise ValueError(f"write_sun takes RGB rows of even length, not "
                         f"{w}x{h}x{c}")
    body = np.ascontiguousarray(img[..., ::-1]).reshape(-1)
    body = rle_encode(body) if rle else body.tobytes()
    header = struct.pack(">8I", MAGIC, w, h, 24, len(body), 2 if rle else 1,
                         0, 0)
    with open(path, "wb") as f:
        f.write(header + body)
