"""The port's SGI reader: the pixels PIL returns for an SGI image file
(Pillow 12.1's SgiImagePlugin, its SGI16 decoder and libImaging's
SgiRleDecode.c), bit for bit, without an imaging library.

SGI (.sgi, .rgb, .rgba, .bw) is one of the oldest texture formats still
met. Read as PIL reads it: the 512-byte header's bytes per channel (1 or
2), dimension and channel count pick the mode (L, RGB or RGBA; PIL's MODES
table: 1 or 2 dimensions for one channel, 3 for 3 or 4); rows are stored
bottom-up, each channel a plane of its own:
- verbatim: planes of width x height samples one after another; at 2
  bytes a sample PIL keeps each big-endian sample's high byte (its
  L;16B, RGB;16B and RGBA;16B raw modes into an 8-bit image);
- RLE: csrc/small_decode.cpp's tb_sgi_rle_decode, the start and length
  tables and each row of each channel as SgiRleDecode.c expands them
  (rows after a row whose last control byte is not 0 stay zero, as PIL
  leaves them).

Refused as PIL refuses: UnidentifiedImageError where PIL gives up with
IndexError or struct.error (a header shorter than 12 bytes) or finds a
side of 0 (passing the file on); ValueError where PIL raises otherwise
(an unknown mode, a compression other than 0 and 1, data cut short, an
RLE table or row out of bounds).

write_sgi writes an 8-bit L, RGB or RGBA image in RLE (every run of two
or more samples a repeat packet, every other sample a one-sample copy
packet), for the demo scenes' textures.
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    as_read_ldr,
    check_image_size,
)

# (bytes per channel, dimension, channels) -> PIL's raw mode.
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
         (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
         (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}
HEADER = 512


def is_sgi(data: bytes) -> bool:
    """SgiImagePlugin._accept."""
    return len(data) >= 2 and struct.unpack_from(">H", data)[0] == 474


def sgi_layout(data: bytes, path: str = "<sgi>") -> dict:
    """The header as PIL's _open reads it."""
    if len(data) < 12:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(SGI header cut short)")
    compression, bpc = data[2], data[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">4H", data, 4)
    rawmode = MODES.get((bpc, dimension, zsize))
    if rawmode is None:
        raise ValueError(f"{path}: Unsupported SGI image mode ({bpc} bytes, "
                         f"dimension {dimension}, {zsize} channels)")
    if not xsize or not ysize:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     f"(size {xsize}x{ysize})")
    check_image_size(xsize, ysize, path)
    return dict(compression=compression, bpc=bpc, width=xsize,
                height=ysize, mode=rawmode.split(";")[0], rawmode=rawmode)


def read_sgi(data: bytes, path: str = "<sgi>") -> np.ndarray:
    """An SGI file's pixels as the JAX read_ldr gets them through PIL:
    (H, W, 3|4) uint8."""
    lay = sgi_layout(data, path)
    w, h, bpc, mode = lay["width"], lay["height"], lay["bpc"], lay["mode"]
    bands = len(mode)
    if lay["compression"] == 0:
        page = w * h * bpc
        planes = []
        for k in range(bands):
            raw = data[HEADER + k * page:HEADER + (k + 1) * page]
            if len(raw) < page:
                raise ValueError(f"{path}: image file is truncated (SGI "
                                 "plane)")
            plane = np.frombuffer(raw, np.uint8).reshape(h, w, bpc)[..., 0]
            planes.append(plane[::-1])
        px = np.stack(planes, -1)
    elif lay["compression"] == 1:
        from tracerboy_tpu_torch.core.codecs import small_library

        buf = np.frombuffer(data, np.uint8)[HEADER:]
        buf = np.ascontiguousarray(buf)
        out = np.zeros((h, w, bands, bpc), np.uint8)
        rc = small_library().tb_sgi_rle_decode(
            buf.ctypes.data, buf.size, out.ctypes.data, w, h, bands, bpc)
        if rc:
            raise ValueError(f"{path}: buffer overrun when reading image "
                             "file (SGI RLE)")
        px = np.ascontiguousarray(out[..., 0])
    else:
        raise ValueError(f"{path}: cannot load this image (SGI compression "
                         f"{lay['compression']})")
    return as_read_ldr(px, mode)


def row_runs(rows: np.ndarray, max_run: int):
    """The runs of equal bytes in each row of (R, W) uint8, none longer
    than max_run: (row, start, length, value) arrays in row order."""
    r, w = rows.shape
    new = np.ones((r, w), bool)
    new[:, 1:] = rows[:, 1:] != rows[:, :-1]
    idx = np.flatnonzero(new.reshape(-1))
    length = np.diff(np.append(idx, r * w))
    pieces = (length + max_run - 1) // max_run
    first = np.repeat(idx, pieces)
    k = np.arange(pieces.sum()) - np.repeat(np.cumsum(pieces) - pieces,
                                            pieces)
    start = first + k * max_run
    length = np.minimum(np.repeat(idx + length, pieces) - start, max_run)
    flat = rows.reshape(-1)
    return start // w, start % w, length, flat[start]


def packets(heads: np.ndarray, values: np.ndarray) -> np.ndarray:
    """A run-length stream of (head, value) byte pairs, a pair's head
    dropped where it is negative (a lone literal byte)."""
    keep = heads >= 0
    out = np.empty(int(keep.sum()) + len(values), np.uint8)
    pos = np.cumsum(1 + keep) - 1          # each value's place
    out[pos] = values
    out[(pos - 1)[keep]] = heads[keep]
    return out


def write_sgi(path: str, img: np.ndarray) -> None:
    """Write an 8-bit image, (H, W) or (H, W, 1|3|4) uint8 (or floats in
    [0,1], quantised as write_png quantises them), as an RLE SGI file."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8

    img = _to_uint8(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3, 4) or w > 65535 or h > 65535:
        raise ValueError(f"SGI cannot hold a {w}x{h}x{c} image")
    header = struct.pack(">hBBHHHH", 474, 1, 1, 2 if c == 1 else 3,
                         w, h, c) + bytes(HEADER - 12)
    # Planes of bottom-up rows: plane k's row j is rows[k * h + j].
    rows = np.ascontiguousarray(img[::-1].transpose(2, 0, 1)).reshape(
        c * h, w)
    row, _, length, value = row_runs(rows, 127)
    heads = np.where(length > 1, length, 0x81).astype(np.int64)
    stream = packets(heads, value.astype(np.uint8))
    # Each row's packets (2 bytes each) then its terminating 0.
    counts = np.bincount(row, minlength=c * h) * 2
    ends = np.cumsum(counts + 1)
    body = np.zeros(int(ends[-1]), np.uint8)
    src = np.arange(len(stream))
    body[src + np.repeat(np.arange(c * h), counts)] = stream
    starts = HEADER + 8 * c * h + ends - counts - 1
    tables = np.concatenate([starts, counts + 1]).astype(">u4").tobytes()
    with open(path, "wb") as f:
        f.write(header + tables + body.tobytes())
