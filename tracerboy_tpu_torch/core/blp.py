"""The port's BLP reader: the pixels PIL returns for a Blizzard Mipmap
texture (Pillow 12.1's BlpImagePlugin), bit for bit, without an imaging
library.

BLP is the texture format of Blizzard's games. Only the first mipmap is
read, as PIL reads it:
- BLP1, compression 0: a JPEG; the shared header (its size at byte 156)
  is put in front of the mipmap (at offsets[0], lengths[0] bytes) and
  the whole decoded by core/jpeg.py; PIL hands its RGB bytes to the
  image as BGR, so red and blue change places (grey stays grey); a
  4-component JPEG is read as CMYK whatever its Adobe marker says (PIL
  sets the decoder's JPEG colour space to CMYK, so a YCCK file's
  samples are not converted), then as a plain CMYK JPEG;
- BLP1, compression 1, encoding 4 or 5: the 256-entry BGRA palette after
  the mipmap tables, then lengths[0] index bytes read straight after the
  palette (offsets[0] is not looked at);
- BLP2, compression 1: the palette (always read), then from offsets[0]:
  encoding 1, lengths[0] index bytes; encoding 2, DXT blocks by
  alpha_encoding (0 DXT1, 1 DXT3, 7 DXT5), decoded by PIL's own Python
  (BlpImagePlugin's decode_dxt1/3/5: 565 colours widened by a shift, not
  by bit replication, the interpolations floored, DXT3's and DXT5's
  colours always in four-colour mode, DXT1's punch-through alpha only in
  an image with alpha), not by the "bcn" decoder DDS and FTEX use.
Where a palette is read, alpha is the palette entry's (the image has
alpha where the header's alpha depth is not 0). The decoded pixels are
a stream that PIL lays out at the image's width: DXT rows padded to a
multiple of 4, and DXT3 and DXT5 blocks decoded to 4 bytes a pixel in an
image without alpha, come out sheared, as in PIL.

Refused as PIL refuses: UnidentifiedImageError where PIL gives up with
struct.error (a header cut short) or a side of 0 (passing the file on);
NotImplementedError (PIL's BLPFormatError) for the encodings and
compressions PIL does not decode, BLP2's raw BGRA (encoding 3) among
them; ValueError where PIL raises otherwise (a file cut short in the
tables, palette or mipmap, too few pixels, a broken JPEG).

encode_dxt writes DXT1 or DXT5 blocks (each block's colour endpoints its
darkest and brightest texels, each texel the nearest of the four colours
by PIL's BLP decoder; DXT5's alpha endpoints the block's extremes), and
write_blp2 a BLP2 of one mipmap in those blocks, for the demo scenes'
textures (core/ftex.py's writer takes the DXT1 blocks too).
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    check_image_size,
)


def is_blp(data: bytes) -> bool:
    """BlpImagePlugin._accept."""
    return data.startswith((b"BLP1", b"BLP2"))


def blp_header(data: bytes, path: str = "<blp>") -> dict:
    """The header as PIL's _open reads it."""
    need = 24 if data.startswith(b"BLP1") else 20
    if len(data) < need:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(BLP header cut short)")
    (compression,) = struct.unpack_from("<i", data, 4)
    if data.startswith(b"BLP1"):
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        width, height, encoding = struct.unpack_from("<IIi", data, 12)
        alpha_encoding, tables = None, 28
    else:
        encoding, alpha_depth, alpha_encoding = struct.unpack_from(
            "<bbb", data, 8)
        alpha = alpha_depth != 0
        width, height = struct.unpack_from("<II", data, 12)
        tables = 20
    if not width or not height:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     f"(size {width}x{height})")
    check_image_size(width, height, path)
    return dict(version=data[3] - ord("0"), compression=compression,
                encoding=encoding, alpha=alpha,
                alpha_encoding=alpha_encoding, width=width, height=height,
                tables=tables)


class _Stream:
    """PIL's _safe_read over the file: a read past its end is refused."""

    def __init__(self, data: bytes, pos: int, path: str):
        self.data, self.pos, self.path = data, pos, path

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.path}: Truncated File Read (BLP)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


def _unpack_565(c: np.ndarray) -> np.ndarray:
    """BlpImagePlugin.unpack_565 of (...) uint16: (..., 3) int32."""
    c = c.astype(np.int32)
    return np.stack([(c >> 11 & 0x1F) << 3, (c >> 5 & 0x3F) << 2,
                     (c & 0x1F) << 3], -1)


def _colors(c0, c1, four: np.ndarray):
    """The four colours of each block, (..., 4, 3) int32; `four` marks
    the blocks in four-colour mode (else the third is the mean and the
    fourth black)."""
    p0, p1 = _unpack_565(c0), _unpack_565(c1)
    f = four[..., None]
    p2 = np.where(f, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(f, (2 * p1 + p0) // 3, 0)
    return np.stack([p0, p1, p2, p3], -2)


def _codes(words: np.ndarray, bits: int) -> np.ndarray:
    """(..., 16) of `bits`-bit codes, pixel k at bit bits x k."""
    k = np.arange(16, dtype=np.uint64) * np.uint64(bits)
    return ((words.astype(np.uint64)[..., None] >> k)
            & np.uint64((1 << bits) - 1)).astype(np.int64)


def decode_dxt(blocks: bytes, bx: int, by: int, kind: int,
               alpha: bool) -> np.ndarray:
    """PIL's decode_dxt1 (kind 1; 4 channels with alpha, else 3),
    decode_dxt3 (3) and decode_dxt5 (5) of by rows of bx blocks: (4 by,
    4 bx, C) uint8."""
    size = 8 if kind == 1 else 16
    b = np.frombuffer(blocks, np.uint8, bx * by * size).reshape(by, bx, size)
    col = b[..., size - 8:]
    c0 = col[..., 0].astype(np.uint16) | col[..., 1].astype(np.uint16) << 8
    c1 = col[..., 2].astype(np.uint16) | col[..., 3].astype(np.uint16) << 8
    bits = col[..., 4:8].copy().view("<u4")[..., 0]
    four = c0 > c1 if kind == 1 else np.ones(c0.shape, bool)
    table = _colors(c0, c1, four)
    code = _codes(bits, 2)
    rgb = np.take_along_axis(table, code[..., None], -2)
    if kind == 1:
        a = np.where((code == 3) & ~four[..., None], 0, 255)
    elif kind == 3:
        nib = b[..., :8, None] >> np.array([0, 4], np.uint8)
        a = (nib.reshape(by, bx, 16) & 0x0F).astype(np.int32) * 17
    else:
        a0 = b[..., 0].astype(np.int32)[..., None]
        a1 = b[..., 1].astype(np.int32)[..., None]
        word = np.zeros((by, bx), np.uint64)
        for k in range(6):
            word |= b[..., 2 + k].astype(np.uint64) << np.uint64(8 * k)
        ac = _codes(word, 3)
        interp7 = ((8 - ac) * a0 + (ac - 1) * a1) // 7
        interp5 = ((6 - ac) * a0 + (ac - 1) * a1) // 5
        a = np.where(ac == 0, a0, np.where(ac == 1, a1, np.where(
            a0 > a1, interp7, np.where(ac == 6, 0, np.where(
                ac == 7, 255, interp5)))))
    chans = [rgb] if kind == 1 and not alpha else [rgb, a[..., None]]
    px = np.concatenate(chans, -1).astype(np.uint8)
    c = px.shape[-1]
    return px.reshape(by, bx, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(
        4 * by, 4 * bx, c)


def _palette(s: _Stream) -> np.ndarray:
    """The 256 BGRA entries as (256, 4) RGBA."""
    return np.frombuffer(s.read(1024), np.uint8).reshape(256, 4)[
        :, [2, 1, 0, 3]]


def _as_raw(stream: bytes, h: dict, path: str) -> np.ndarray:
    """PIL's set_as_raw: the stream laid out at the image's size in its
    mode (RGB or RGBA); too short a stream is refused."""
    c = 4 if h["alpha"] else 3
    need = h["width"] * h["height"] * c
    if len(stream) < need:
        raise ValueError(f"{path}: not enough image data (BLP)")
    return np.frombuffer(stream, np.uint8, need).reshape(
        h["height"], h["width"], c).copy()


def _unsupported(path: str, what: str):
    return NotImplementedError(f"{path}: {what} (PIL's BLPFormatError)")


def read_blp(data: bytes, path: str = "<blp>") -> np.ndarray:
    """A BLP file's first mipmap as the JAX read_ldr gets it through PIL:
    (H, W, 3|4) uint8."""
    h = blp_header(data, path)
    s = _Stream(data, h["tables"], path)
    offsets = struct.unpack("<16I", s.read(64))
    lengths = struct.unpack("<16I", s.read(64))
    alpha = h["alpha"]
    if h["version"] == 1:
        if h["compression"] == 0:
            return _blp1_jpeg(data, s, offsets, lengths, h, path)
        if h["compression"] != 1:
            raise _unsupported(path, f"Unsupported BLP compression "
                                     f"{h['compression']}")
        if h["encoding"] not in (4, 5):
            raise _unsupported(path, f"Unsupported BLP encoding "
                                     f"{h['encoding']}")
        pal = _palette(s)
        idx = np.frombuffer(s.read(lengths[0]), np.uint8)
        return _as_raw(pal[idx, :4 if alpha else 3].tobytes(), h, path)
    pal = _palette(s)
    s.pos = offsets[0]
    if h["compression"] != 1:
        raise _unsupported(path, f"Unknown BLP compression "
                                 f"{h['compression']}")
    if h["encoding"] == 1:
        idx = np.frombuffer(s.read(lengths[0]), np.uint8)
        return _as_raw(pal[idx, :4 if alpha else 3].tobytes(), h, path)
    if h["encoding"] != 2:
        raise _unsupported(path, f"Unknown BLP encoding {h['encoding']}")
    kind = {0: 1, 1: 3, 7: 5}.get(h["alpha_encoding"])
    if kind is None:
        raise _unsupported(path, f"Unsupported alpha encoding "
                                 f"{h['alpha_encoding']}")
    bx, by = (h["width"] + 3) // 4, (h["height"] + 3) // 4
    blocks = s.read(bx * by * (8 if kind == 1 else 16))
    return _as_raw(decode_dxt(blocks, bx, by, kind, alpha).tobytes(), h,
                   path)


def _blp1_jpeg(data, s: _Stream, offsets, lengths, h, path) -> np.ndarray:
    """BLP1Decoder._decode_jpeg_stream: the JPEG's RGB (a 4-component
    one's colour space forced to CMYK), laid out as BGR."""
    from tracerboy_tpu_torch.core.jpeg import decode_jpeg, frame_header

    (header_size,) = struct.unpack("<I", s.read(4))
    header = s.read(header_size)
    s.read(offsets[0] - s.pos)
    jpeg = header + s.read(lengths[0])
    try:
        head = frame_header(jpeg, path)
        cmyk = head is not None and len(head[3]) == 4
        rgb = decode_jpeg(jpeg, path, color=3 if cmyk else None)
    except OSError as e:                # core/jpeg.py's corrupt data
        raise ValueError(str(e)) from None
    check_image_size(rgb.shape[1], rgb.shape[0], path)
    px = _as_raw(rgb[..., 2::-1].tobytes(), dict(h, alpha=False), path)
    if h["alpha"]:
        px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255,
                                         np.uint8)], -1)
    return px


def encode_dxt(img: np.ndarray, kind: int) -> bytes:
    """DXT1 (kind 1) or DXT5 (5) blocks of (H, W, 3|4) uint8, row by row
    of blocks, the image's edge texels repeated to whole blocks."""
    h, w = img.shape[:2]
    bx, by = (w + 3) // 4, (h + 3) // 4
    pad = np.pad(img, ((0, 4 * by - h), (0, 4 * bx - w), (0, 0)), "edge")
    blocks = pad.reshape(by, 4, bx, 4, -1).transpose(0, 2, 1, 3, 4).reshape(
        by, bx, 16, -1).astype(np.int32)
    rgb = blocks[..., :3]
    c565 = (rgb[..., 0] >> 3 << 11 | rgb[..., 1] >> 2 << 5
            | rgb[..., 2] >> 3)
    luma = 2 * rgb[..., 0] + 5 * rgb[..., 1] + rgb[..., 2]
    hi = np.take_along_axis(c565, luma.argmax(-1)[..., None], -1)[..., 0]
    lo = np.take_along_axis(c565, luma.argmin(-1)[..., None], -1)[..., 0]
    c0, c1 = np.maximum(hi, lo), np.minimum(hi, lo)
    table = _colors(c0.astype(np.uint16), c1.astype(np.uint16),
                    np.ones(c0.shape, bool))
    dist = ((rgb[..., None, :] - table[..., None, :, :]) ** 2).sum(-1)
    code = np.where((c0 == c1)[..., None], 0, dist.argmin(-1))
    bits = (code.astype(np.uint64) << (2 * np.arange(16, dtype=np.uint64))
            ).sum(-1)
    color = np.stack([c0 & 255, c0 >> 8, c1 & 255, c1 >> 8] + [
        (bits >> np.uint64(8 * k)) & np.uint64(255) for k in range(4)],
        -1).astype(np.uint8)
    if kind == 1:
        return color.tobytes()
    a = blocks[..., 3]
    a0, a1 = a.max(-1), a.min(-1)
    ac = np.arange(8)
    levels = np.where(ac == 0, a0[..., None], np.where(
        ac == 1, a1[..., None],
        ((8 - ac) * a0[..., None] + (ac - 1) * a1[..., None]) // 7))
    acode = np.abs(a[..., None] - levels[..., None, :]).argmin(-1)
    acode = np.where((a0 == a1)[..., None], 0, acode)
    word = (acode.astype(np.uint64) << (3 * np.arange(16, dtype=np.uint64))
            ).sum(-1)
    alpha = np.stack([a0, a1] + [(word >> np.uint64(8 * k)) & np.uint64(255)
                                 for k in range(6)], -1).astype(np.uint8)
    return np.concatenate([alpha, color], -1).tobytes()


def write_blp2(path: str, img: np.ndarray, kind: int) -> None:
    """Write an 8-bit image, (H, W, 3|4) uint8 (or floats in [0,1],
    quantised as write_png quantises them), as a BLP2 of one mipmap in
    DXT1 (kind 1, alpha depth 0: RGB) or, of an RGBA image, DXT5 (kind 5,
    alpha depth 8, alpha_encoding 7: RGBA)."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8

    img = _to_uint8(img)
    h, w = img.shape[:2]
    blocks = encode_dxt(img, kind)
    start = 20 + 128 + 1024
    header = b"BLP2" + struct.pack("<iBBBBII", 1, 2, 0 if kind == 1 else 8,
                                   0 if kind == 1 else 7, 0, w, h)
    tables = struct.pack("<16I", start, *(0,) * 15) + struct.pack(
        "<16I", len(blocks), *(0,) * 15)
    with open(path, "wb") as f:
        f.write(header + tables + bytes(1024) + blocks)
