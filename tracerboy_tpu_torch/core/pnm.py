"""The port's PNM reader (PBM, PGM, PPM, PFM's Pf, and PIL's own P0CMYK,
PyP, PyRGBA and PyCMYK headers): the pixels PIL returns (Pillow 12.1's
PpmImagePlugin.py), bit for bit, without an imaging library.

pbrt-v4 reads PNM through stb_image, so a pbrt-v4 scene may name one;
the JAX package reads it through PIL. The header is read as PIL reads it
(a magic of up to 6 bytes, tokens of up to 10 bytes, '#' comments to the
end of the line, even inside a token), then:
- P4 (raw bits, 1 is black) and P1 (plain '0'/'1' characters);
- P5/P6 and PIL's raw headers at maxval 255 as bytes; P5 at 65535 as
  big-endian 16-bit samples (mode I); other maxvals through PIL's "ppm"
  decoder: 1- or 2-byte samples scaled by round(v / maxval * out_max),
  Python's round (half to even), capped at out_max (65535 for grey with
  maxval > 255, mode I; else 255);
- P2/P3 through PIL's plain decoder: whitespace-separated decimal tokens
  (comments removed block by block), each at most 10 bytes, none
  negative or above maxval, scaled as above;
- Pf: 32-bit floats, little-endian when the scale is negative, rows
  bottom to top.
read_ldr converts as PIL's convert("RGB") does (core/tiff.to_read_ldr):
grey replicated, I clipped at 255, F with NaN as 0 clipped and
truncated, CMYK by Convert.c's cmyk2rgb, P through a palette that PIL's
PyP files never set (black).

Refused as PIL refuses: NotImplementedError (unidentified) for a magic
PIL's table does not hold; ValueError where PIL raises ValueError or
OSError (a bad or missing token, maxval outside 1-65535, a zero or
infinite scale, a bad sample, data that ends early).
"""

from __future__ import annotations

import math

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    check_image_size,
)

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"1": 1, "L": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
SAFEBLOCK = 1024 * 1024           # ImageFile.SAFEBLOCK: the plain reads


def is_pnm(data: bytes) -> bool:
    """PIL's _accept: P, then one of 0123456fy."""
    return len(data) >= 2 and data[0] == 0x50 and data[1] in b"0123456fy"


class _File:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def _read_token(f: _File, path: str) -> bytes:
    token = b""
    while len(token) <= 10:
        c = f.read(1)
        if not c:
            break
        if c in WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while f.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise ValueError(f"{path}: Reached EOF while reading header")
    if len(token) > 10:
        raise ValueError(f"{path}: Token too long in file header")
    return token


def _int(token: bytes, path: str) -> int:
    try:
        return int(token)
    except ValueError:
        raise ValueError(f"{path}: invalid PNM header token {token!r}") \
            from None


def _scale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """round(v / maxval * out_max), Python's float arithmetic and round."""
    return np.rint(values.astype(np.float64) / maxval * out_max).astype(
        np.int64)


def _comment_end(block: bytes, start: int = 0) -> int:
    a = block.find(b"\n", start)
    b = block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


class _Plain:
    """PpmPlainDecoder, block by block as PIL reads the file."""

    def __init__(self, f: _File):
        self.f = f
        self.spans = False

    def ignore_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.f.read(SAFEBLOCK)
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int, path: str) -> bytes:
        data = b""
        while len(data) != total:
            block = self.f.read(SAFEBLOCK)
            if not block:
                break
            tokens = b"".join(self.ignore_comments(block).split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise ValueError(f"{path}: Invalid token for this mode: "
                                 f"{bad[:1]!r}")
            data = (data + tokens)[:total]
        return data.translate(bytes.maketrans(b"01", b"\xff\x00"))

    def values(self, total: int, maxval: int, path: str) -> list:
        values, half = [], b""
        while len(values) != total:
            block = self.f.read(SAFEBLOCK)
            if not block:
                if not half:
                    break
                block = b" "
            block = self.ignore_comments(block)
            if half:
                block = half + block
                half = b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError(f"{path}: Token too long found in data")
            for token in tokens:
                if len(token) > 10:
                    raise ValueError(f"{path}: Token too long found in data")
                value = _int(token, path)
                if value < 0 or value > maxval:
                    raise ValueError(f"{path}: Channel value {value} out of "
                                     f"range for maxval {maxval}")
                values.append(value)
                if len(values) == total:
                    break
        return values


def decode_pnm(data: bytes, path: str = "<pnm>"):
    """A PNM file as PIL decodes it: (pixels, mode). pixels is (H, W) or
    (H, W, bands): uint8, int64 for mode I, float32 for mode F."""
    f = _File(data)
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in WHITESPACE:
            break
        magic += c
    if magic not in MODES:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     f"(PNM magic {magic!r})")
    mode = MODES[magic]
    width = _int(_read_token(f, path), path)
    height = _int(_read_token(f, path), path)
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "F":
        scale = float(_read_token(f, path))
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError(f"{path}: scale must be finite and non-zero")
        check_image_size(width, height, path)
        n = width * height * 4
        raw = data[f.pos:f.pos + n]
        if len(raw) < n:
            raise ValueError(f"{path}: image file is truncated")
        px = np.frombuffer(raw, "<f4" if scale < 0 else ">f4")
        return px.reshape(height, width)[::-1].astype(np.float32), "F"
    maxval = None
    if mode != "1":
        maxval = _int(_read_token(f, path), path)
        if not 0 < maxval < 65536:
            raise ValueError(f"{path}: maxval must be greater than 0 and "
                             "less than 65536")
    check_image_size(width, height, path)
    out_mode = "I" if mode == "L" and maxval > 255 else mode
    bands = BANDS[mode]
    shape = (height, width, bands) if bands > 1 else (height, width)
    if plain:
        pl = _Plain(f)
        if mode == "1":
            px = pl.bitonal(width * height, path)
            if len(px) < width * height:
                raise ValueError(f"{path}: not enough image data")
            return np.frombuffer(px, np.uint8).reshape(shape), "1"
        total = width * height * bands
        values = pl.values(total, maxval, path)
        if len(values) < total:
            raise ValueError(f"{path}: not enough image data")
        out_max = 65535 if out_mode == "I" else 255
        px = _scale(np.array(values, np.int64), maxval, out_max)
        return px.reshape(shape).astype(
            np.int64 if out_mode == "I" else np.uint8), out_mode
    rest = data[f.pos:]
    if mode == "1":
        row = (width + 7) // 8
        if len(rest) < row * height:
            raise ValueError(f"{path}: image file is truncated")
        bits = np.unpackbits(np.frombuffer(rest, np.uint8, row * height)
                             .reshape(height, row), axis=1)[:, :width]
        return np.where(bits == 1, 0, 255).astype(np.uint8), "1"
    if maxval == 255:
        n = width * height * bands
        if len(rest) < n:
            raise ValueError(f"{path}: image file is truncated")
        return np.frombuffer(rest, np.uint8, n).reshape(shape), mode
    if maxval == 65535 and mode == "L":
        n = width * height * 2
        if len(rest) < n:
            raise ValueError(f"{path}: image file is truncated")
        return (np.frombuffer(rest, ">u2", width * height).reshape(shape)
                .astype(np.int64), "I")
    # PpmDecoder: samples of 1 (maxval < 256) or 2 bytes, whole pixels.
    size = 1 if maxval < 256 else 2
    n = width * height * bands
    have = len(rest) // (size * bands) * bands
    if have < n:
        raise ValueError(f"{path}: not enough image data")
    samples = np.frombuffer(rest, np.uint8 if size == 1 else ">u2", n)
    out_max = 65535 if out_mode == "I" else 255
    px = np.minimum(_scale(samples, maxval, out_max), out_max)
    return px.reshape(shape).astype(
        np.int64 if out_mode == "I" else np.uint8), out_mode


def read_pnm(data: bytes, path: str = "<pnm>") -> np.ndarray:
    """(H, W, 3|4) uint8 as the JAX read_ldr gets it through PIL."""
    from tracerboy_tpu_torch.core.tiff import to_read_ldr

    px, mode = decode_pnm(data, path)
    return to_read_ldr(px, mode, np.zeros((256, 3), np.uint8))
