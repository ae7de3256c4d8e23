"""The port's PSD reader: the merged image as PIL returns it (Pillow
12.1's PsdImagePlugin.py), bit for bit, without an imaging library.

pbrt-v4 reads PSD through stb_image, so a pbrt-v4 scene may name one;
the JAX package reads it through PIL, which opens the composite image
only (layers are PIL's later frames). The file is read as PIL reads it:
- the 26-byte header (version 1 only); (colour mode, depth) from PIL's
  MODES: bitmap (1 bit), grey, duotone and multichannel (the first
  channel, as L), palette (768 bytes of colour mode data, planar R, G,
  B; without them the palette is black), RGB (RGBA with exactly four
  channels), CMYK (inverted samples), Lab;
- the image resources walked entry by entry as PIL walks them (a short
  entry ends the walk where it lies), the layer block skipped;
- raw channels at offset + c * width * height, or PackBits channels
  (PackBits row counts are 16-bit, one per row and channel, of the
  channels PIL keeps: where a file has more channels, PIL reads the
  first channel's data from inside the count table, and so does this),
  each decoded by Pillow's PackBitsDecode (csrc/lzw_codecs.cpp
  tb_pil_packbits_rows: packets cut at each row's end) from its
  offset on.
read_ldr converts as PIL's convert("RGB") does (core/tiff.to_read_ldr).
Lab goes to RGBA (the JAX read_ldr sees an "A" in "LAB") through
LittleCMS 2.17's transform as Pillow builds it (createProfile("LAB") to
createProfile("sRGB"), PT_LabV2 with one extra byte to TYPE_RGBA_8, the
default intent and flags): its RGB is core/tiff's (csrc/tiff_codecs.cpp
tb_lab_to_rgb, which equals PIL's on all 2^24 inputs), since PIL holds
the file's a and b bytes as they are (its PSD unpackers are band copies,
not the LAB unpacker's XOR of TIFF's signed a and b). Its alpha is 0:
Pillow's transform copies the image's fourth (extra) byte into the
output's alpha (pyCMScopyAux), and the PSD plugin's band unpackers leave
that byte as the new image holds it, 0 (a TIFF's LAB unpacker writes
255).

Refused as PIL refuses: NotImplementedError (unidentified: ImageFile
turns the plugin's KeyError and struct.error into SyntaxError) for a
short header, a version other than 1, a colour mode and depth PIL's
table lacks (16- and 32-bit files among them), resources or a layer
block cut short; ValueError where PIL raises OSError (too few channels,
a compression other than raw and PackBits, data that ends early).
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.codecs import library
from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    check_image_size,
)

# (Photoshop colour mode, bits) -> (PIL mode, channels read)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def is_psd(data: bytes) -> bool:
    return data.startswith(b"8BPS")


class _Short(Exception):
    """What PIL's plugin fails on with struct.error, IndexError or
    KeyError, which ImageFile reports as not identified."""


class _File:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def u(self, fmt: str) -> int:
        n = struct.calcsize(fmt)
        b = self.read(n)
        if len(b) < n:
            raise _Short
        return struct.unpack(fmt, b)[0]


def decode_psd(data: bytes, path: str = "<psd>"):
    """The merged image as PIL decodes it: ((H, W) or (H, W, C) uint8,
    PIL mode, (256, 3) palette)."""
    f = _File(data)
    try:
        s = f.read(26)
        if not is_psd(s) or len(s) < 26 or struct.unpack_from(">H", s, 4)[
                0] != 1:
            raise _Short
        channels_in_file, height, width, bits, cmode = struct.unpack_from(
            ">HIIHH", s, 12)
        if (cmode, bits) not in MODES:
            raise _Short
        mode, channels = MODES[(cmode, bits)]
        if channels > channels_in_file:
            raise ValueError(f"{path}: not enough channels")
        if mode == "RGB" and channels_in_file == 4:
            mode, channels = "RGBA", 4
        palette = np.zeros((256, 3), np.uint8)
        size = f.u(">I")
        if size:
            colours = f.read(size)
            if mode == "P" and size == 768:
                table = np.frombuffer(colours.ljust(768, b"\0"), np.uint8)
                palette = np.ascontiguousarray(table.reshape(3, 256).T)
        size = f.u(">I")
        if size:
            end = f.pos + size
            while f.pos < end:
                f.read(4)
                f.u(">H")
                name_len = f.read(1)
                if not name_len:
                    raise _Short
                name = f.read(name_len[0])
                if not len(name) & 1:
                    f.read(1)
                n = f.u(">I")
                if len(f.read(n)) & 1:
                    f.read(1)
        size = f.u(">I")
        if size:
            end = f.pos + size
            f.u(">I")
            f.pos = end
        compression = f.u(">H")
        offset = f.pos
        counts = None
        if compression == 1:
            table = f.read(channels * height * 2)
            offset = f.pos
            if len(table) < channels * height * 2:
                raise _Short
            counts = np.frombuffer(table, ">u2").reshape(channels, height)
    except _Short:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(PSD header cut short)") from None
    check_image_size(width, height, path)
    if compression not in (0, 1):
        raise ValueError(f"{path}: cannot load PSD compression "
                         f"{compression}")
    rowbytes = (width + 7) // 8 if mode == "1" else width
    planes = np.empty((channels, height, rowbytes), np.uint8)
    for c in range(channels):
        if compression == 0:
            start = offset + c * width * height
            n = rowbytes * height
            raw = data[start:start + n]
            if len(raw) < n:
                raise ValueError(f"{path}: image file is truncated")
            planes[c] = np.frombuffer(raw, np.uint8).reshape(height,
                                                              rowbytes)
        else:
            src = np.frombuffer(data, np.uint8)[offset:]
            src = np.ascontiguousarray(src)
            if library().tb_pil_packbits_rows(
                    src.ctypes.data, src.size, planes[c].ctypes.data, height,
                    rowbytes) < 0:
                raise ValueError(f"{path}: image file is truncated")
            offset += int(counts[c].sum())
    if mode == "1":
        bits = np.unpackbits(planes[0], axis=1)[:, :width]
        return np.where(bits == 1, 255, 0).astype(np.uint8), "1", palette
    if mode == "CMYK":
        planes = 255 - planes
    img = planes[0] if channels == 1 else np.moveaxis(planes, 0, -1)
    return np.ascontiguousarray(img), mode, palette


def read_psd(data: bytes, path: str = "<psd>") -> np.ndarray:
    """(H, W, 3|4) uint8 as the JAX read_ldr gets it through PIL."""
    from tracerboy_tpu_torch.core.tiff import to_read_ldr

    img, mode, palette = decode_psd(data, path)
    out = to_read_ldr(img, mode, palette)
    if mode == "LAB":
        out[..., 3] = 0             # the image's extra byte, copied
    return out
