"""The port's ICNS reader: the pixels PIL returns for a Mac OS icon
resource (Pillow 12.1's IcnsImagePlugin), bit for bit, without an
imaging library.

An icns file is a list of (type, length) entries after its own header.
PIL picks the largest (width, height, scale) of its SIZES table that has
any entry (IcnsFile.bestsize: a tuple maximum, so 48x48 beats 32x32 at
scale 2) and reads every entry of that size in the table's order:
- is32, il32, ih32 (and it32, after 4 zero bytes): 24-bit RGB, raw where
  the entry holds exactly 3 x pixels bytes, else three channels one
  after another in a PackBits-like code (csrc/small_decode.cpp's
  tb_icns_rle_decode), read on from the entry's start whatever its
  length; s8mk, l8mk, h8mk, t8mk: the 8-bit mask, made the alpha;
- ic07-ic14, icp4-icp6: a PNG (core/image_io's decoder) or a JPEG 2000
  (core/jpeg2000.py, made RGBA as PIL converts it). Such an entry is the
  image: its size must be one the file lists, and its mode is what PIL's
  PNG reader gives.
read_ldr does not convert an ICNS (it says RGBA until it is loaded), and
np.asarray then packs the loaded image with RGBA's raw mode: an RGB
image (a 24-bit entry without a mask, an RGB PNG) comes out as its RGBX
bytes (X 0 for an RLE or raw entry's bands put into a new image, 255 for
a PNG) laid out as RGB, sheared, as in PIL; a PNG of another mode (grey,
palette, grey with alpha, bi-level) is refused, as PIL's "No packer
found" is.

Refused as PIL refuses: UnidentifiedImageError where PIL gives up with
SyntaxError or struct.error while it opens the file (an entry header cut
short or of length 0, no entry of a known size), passing it on;
ValueError where PIL raises while it loads (an RLE channel that overruns
or ends early, a mask cut short, an it32 without its zero lead, an entry
that is neither PNG nor JPEG 2000, a PNG of a size the file does not
list, a size with a mask and no colour, a PNG that is neither RGB nor
RGBA).

write_icns writes PNG entries (core/image_io.encode_png), for the demo
scenes' textures.
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    check_image_size,
)

MAGIC = b"icns"
# IcnsFile.SIZES: (width, height, scale) -> its entry types in order.
SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",),
    (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"),
    (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
_RGB = (b"is32", b"il32", b"ih32", b"it32")
_MASKS = (b"s8mk", b"l8mk", b"h8mk", b"t8mk")


def is_icns(data: bytes) -> bool:
    """IcnsImagePlugin._accept."""
    return data.startswith(MAGIC)


def icns_entries(data: bytes, path: str = "<icns>") -> dict:
    """{type: (start, length)} as IcnsFile reads the directory: up to the
    header's file size, a later entry of a type replacing an earlier."""
    if len(data) < 8:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(icns header cut short)")
    (filesize,) = struct.unpack_from(">I", data, 4)
    entries = {}
    i = 8
    while i < filesize:
        if i + 8 > len(data):
            raise UnidentifiedImageError(f"{path}: cannot identify image "
                                         "file (icns entry cut short)")
        sig, block = struct.unpack_from(">4sI", data, i)
        if block <= 0:
            raise UnidentifiedImageError(f"{path}: cannot identify image "
                                         "file (invalid block header)")
        entries[sig] = (i + 8, block - 8)
        i += block
    return entries


def best_size(entries: dict) -> tuple:
    sizes = [size for size, codes in SIZES.items()
             if any(c in entries for c in codes)]
    return max(sizes) if sizes else None


def _rgb(data: bytes, start: int, length: int, side: int, path: str):
    """read_32: (side, side, 3) uint8 and the pad byte PIL's memory holds
    beside each pixel (_as_read_ldr)."""
    n = side * side
    if length == n * 3:
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError(f"{path}: not enough image data (icns RGB)")
        return np.frombuffer(raw, np.uint8).reshape(side, side, 3).copy(), \
            255
    from tracerboy_tpu_torch.core.codecs import small_library

    src = np.ascontiguousarray(np.frombuffer(data, np.uint8)[start:])
    out = np.zeros((3, side, side), np.uint8)
    rc = small_library().tb_icns_rle_decode(src.ctypes.data, src.size,
                                            out.ctypes.data, n)
    if rc == -2:
        raise ValueError(f"{path}: Error reading channel (icns RLE)")
    if rc:
        raise ValueError(f"{path}: buffer is not large enough (icns RLE)")
    return np.ascontiguousarray(out.transpose(1, 2, 0)), 0


def _png_as_pil(data: bytes, path: str) -> np.ndarray:
    """PIL's PngImageFile of a PNG entry, in its mode: RGB or RGBA
    (16-bit samples keep their high byte); a PNG of another mode cannot
    be handed out (_icns_bytes)."""
    from tracerboy_tpu_torch.core.image_io import decode_png

    s, ctype, depth, _ = decode_png(data, path)
    if ctype not in (2, 6):
        raise ValueError(f"{path}: No packer found from the icns PNG "
                         f"entry's mode (PNG colour type {ctype}) to RGBA")
    return (s >> 8).astype(np.uint8) if depth == 16 else s


def _as_read_ldr(px: np.ndarray, pad: int) -> np.ndarray:
    """What the JAX read_ldr's np.asarray makes of the loaded image:
    PIL's tobytes packs it with the raw mode of the mode the file had
    before it was loaded (RGBA), so an RGB image comes out as 4 bytes a
    pixel, the fourth its pad byte in PIL's memory (`pad`: 255 where an
    unpacker wrote the pixels, 0 where read_32 put the bands into a new
    image), and numpy lays the first 3 x pixels of those bytes out as
    RGB."""
    if px.shape[-1] == 4:
        return px
    h, w, _ = px.shape
    rgbx = np.concatenate([px, np.full((h, w, 1), pad, np.uint8)], -1)
    return np.frombuffer(rgbx.tobytes(), np.uint8, h * w * 3).reshape(
        h, w, 3).copy()


def _png_or_jpeg2000(data: bytes, start: int, length: int, path: str):
    sig = data[start:start + 12]
    if sig.startswith(b"\x89PNG\r\n\x1a\n"):
        return _png_as_pil(data[start:], path)
    if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) \
            or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        from tracerboy_tpu_torch.core.jpeg2000 import read_jpeg2000

        if length < -1:
            raise ValueError(f"{path}: read length must be non-negative or "
                             "-1 (icns entry)")
        px = read_jpeg2000(data[start:] if length < 0
                           else data[start:start + length], path)
        if px.shape[-1] == 3:
            px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255,
                                             np.uint8)], -1)
        return px
    raise ValueError(f"{path}: Unsupported icon subimage format")


def _allowed(sizes, w: int, h: int) -> bool:
    """IcnsImageFile's size setter: one of the listed sizes at an integer
    scale."""
    for sw, sh, scale in sizes:
        simple = sw * scale, sh * scale
        if simple[1] / h == simple[0] // w:
            return True
    return False


def read_icns(data: bytes, path: str = "<icns>") -> np.ndarray:
    """An icns file's best entry as the JAX read_ldr gets it through PIL:
    (H, W, 4) uint8, or (H, W, 3) sheared as the module's docstring
    says."""
    entries = icns_entries(data, path)
    size = best_size(entries)
    if size is None:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(No 32bit icon resources found)")
    w, h, scale = size
    check_image_size(w * scale, h * scale, path)
    side = w * scale
    channels = {}
    for code in SIZES[size]:
        if code not in entries:
            continue
        start, length = entries[code]
        if code in _RGB:
            if code == b"it32":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError(f"{path}: Unknown signature, expecting "
                                     "0x00000000 (it32)")
                start, length = start + 4, length - 4
            channels["RGB"] = _rgb(data, start, length, side, path)
        elif code in _MASKS:
            raw = data[start:start + side * side]
            if len(raw) < side * side:
                raise ValueError(f"{path}: buffer is not large enough "
                                 "(icns mask)")
            channels["A"] = np.frombuffer(raw, np.uint8).reshape(side, side)
        else:
            channels["RGBA"] = _png_or_jpeg2000(data, start, length, path)
    if "RGBA" in channels:
        px = channels["RGBA"]
        if not _allowed([s for s, codes in SIZES.items()
                         if any(c in entries for c in codes)],
                        px.shape[1], px.shape[0]):
            raise ValueError(f"{path}: This is not one of the allowed sizes "
                             "of this image")
        return _as_read_ldr(px, 255)
    if "RGB" not in channels:
        raise ValueError(f"{path}: an icns size with a mask and no colour "
                         "(PIL's KeyError 'RGB')")
    if "A" in channels:
        return np.concatenate([channels["RGB"][0],
                               channels["A"][..., None]], -1)
    rgb, pad = channels["RGB"]
    return _as_read_ldr(rgb, pad)


def write_icns(path: str, entries: dict) -> None:
    """Write an icns file of {type: (H, W, 3|4) image} PNG entries."""
    from tracerboy_tpu_torch.core.image_io import encode_png

    body = b"".join(code + struct.pack(">I", 8 + len(png)) + png
                    for code, png in ((c, encode_png(img))
                                      for c, img in entries.items()))
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack(">I", 8 + len(body)) + body)
