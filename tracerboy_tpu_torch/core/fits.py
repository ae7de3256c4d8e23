"""The port's FITS reader and writer: the pixels PIL returns for a FITS
file (Pillow 12.1's FitsImagePlugin and its FitsGzipDecoder), bit for
bit, without an imaging library.

Read as PIL reads it: 80-byte header cards, the first "SIMPLE = T"; an
END card skips to the next 2880-byte boundary and, the first time the
cards gathered so far (a primary unit and its extensions, later keys
overriding) name an image, fixes the decoder; the data then start where
the first card after that END that is no header keyword was read. PIL
reads that card as 80 bytes: where the data are shorter, the offset it
takes falls back into the header's padding, and this reader takes it
there too.
- BITPIX 8, 16, 32, -32 and -64 are modes L, I;16, I, F and F, read
  with PIL's little-endian raw modes on FITS's big-endian samples (a
  16-bit 1 reads as 256), a -64 image as float32 rows of 4 x width
  bytes; BZERO and BSCALE are ignored; the rows bottom-up. Another
  BITPIX leaves the mode unset: the file is not identified.
- NAXIS 1 is an image 1 pixel wide and NAXIS1 high; NAXIS 0 names no
  image, and the cards go on into the next unit.
- A BINTABLE with ZIMAGE T and ZCMPTYPE 'GZIP_1  ' ("fits_gzip"): past
  its table (NAXIS1 x NAXIS2 x BITPIX // 8 bytes) the rest of the file
  is gzip data of 4 bytes a pixel, of which the last min(ZBITPIX // 8,
  4) are kept (none for ZBITPIX -32 and -64: PIL then has too little
  data); rows bottom-up, in the mode's raw mode.

Refused as PIL refuses: UnidentifiedImageError where PIL's _open raises
SyntaxError or a KeyError (no SIMPLE = T first, a key missing, no mode,
a side not positive), passing the file on; ValueError where PIL raises
otherwise (header cards that never end: "Truncated FITS file"; no image
data; a value int() cannot read; data cut short; gzip data that is not).

write_fits writes an 8-bit grey image, raw or as one gzip tile, for the
demo scenes' textures.
"""

from __future__ import annotations

import gzip
import math
import struct
import zlib

import numpy as np

from tracerboy_tpu_torch.core.image_io import as_read_ldr, check_image_size
from tracerboy_tpu_torch.core.rawformats import unidentified

_MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"),
          -32: ("F", "<f4"), -64: ("F", "<f4")}


def is_fits(data: bytes) -> bool:
    """FitsImagePlugin._accept."""
    return data.startswith(b"SIMPLE")


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse_headers(headers: dict):
    """FitsImageFile._parse_headers: (decoder, offset, size, bits), the
    decoder "" where the cards name no image yet."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return "", 0, None, None
    return decoder, offset, size, int(headers[prefix + b"BITPIX"])


def fits_layout(data: bytes, path: str = "<fits>") -> dict:
    """FitsImageFile._open: the decoder, the data's offset, the size and
    BITPIX."""
    try:
        return _open(data, path)
    except KeyError as e:                 # ImageFile: SyntaxError
        raise unidentified(path, f"FITS key {e} missing") from None


def _open(data: bytes, path: str) -> dict:
    headers: dict = {}
    in_progress = False
    decoder = ""
    pos = 0
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError(f"{path}: Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break                         # a data unit
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not decoder:
                decoder, offset, size, bits = _parse_headers(headers)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not is_fits(keyword) or value != b"T"):
            raise unidentified(path, "not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError(f"{path}: No image data")
    if bits not in _MODES:
        raise unidentified(path, f"FITS BITPIX {bits}")
    check_image_size(*size, path)
    return dict(decoder=decoder, offset=offset + pos - 80, width=size[0],
                height=size[1], bits=bits)


def read_fits(data: bytes, path: str = "<fits>") -> np.ndarray:
    """A FITS file's pixels as the JAX read_ldr gets them through PIL:
    (H, W, 3) uint8."""
    lay = fits_layout(data, path)
    w, h, bits = lay["width"], lay["height"], lay["bits"]
    mode, dtype = _MODES[bits]
    rowbytes = w * np.dtype(dtype).itemsize
    if lay["decoder"] == "raw":
        start = lay["offset"]
        if start + h * rowbytes > len(data):
            raise ValueError(f"{path}: image file is truncated (FITS)")
        raw = data[start:start + h * rowbytes]
    else:
        try:
            value = gzip.decompress(data[lay["offset"]:])
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"{path}: FITS gzip data: {e}") from None
        keep = min(bits // 8, 4)
        px = np.frombuffer(value, np.uint8, len(value) // 4 * 4).reshape(
            -1, 4)[:w * h, 4 - keep:] if keep > 0 else np.zeros((0, 0))
        if px.size < h * rowbytes:
            raise ValueError(f"{path}: not enough image data (FITS gzip)")
        raw = np.ascontiguousarray(px).tobytes()
    rows = np.frombuffer(raw, dtype, h * w).reshape(h, w, 1)[::-1]
    return as_read_ldr(rows.astype(np.dtype(dtype).newbyteorder("=")),
                       mode)


def _card(key: str, value=None) -> bytes:
    card = key.ljust(8)
    if value is not None:
        card += "= " + (value if isinstance(value, str)
                        else str(value)).rjust(20)
    return card.ljust(80).encode()


def _unit(cards: list) -> bytes:
    head = b"".join(_card(*c) for c in cards) + _card("END")
    return head.ljust(-(-len(head) // 2880) * 2880, b" ")


def fits_bytes(img: np.ndarray, compress: bool = False) -> bytes:
    """An 8-bit grey image, (H, W) uint8, as a FITS file: a primary unit
    of BITPIX 8 and the rows bottom-up; or (compress) a primary unit
    without an image and a BINTABLE whose one tile is the image gzipped,
    4 bytes a pixel (the sample last), as FitsGzipDecoder reads it."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    rows = img[::-1]
    if not compress:
        body = rows.tobytes()
        return (_unit([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 2),
                       ("NAXIS1", w), ("NAXIS2", h)])
                + body.ljust(-(-len(body) // 2880) * 2880, b"\0"))
    words = np.zeros((h, w, 4), np.uint8)
    words[..., 3] = rows
    heap = gzip.compress(words.tobytes(), 6, mtime=0)
    table = struct.pack(">ii", len(heap), 0)
    body = table + heap
    return (_unit([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0),
                   ("EXTEND", "T")])
            + _unit([("XTENSION", "'BINTABLE'"), ("BITPIX", 8),
                     ("NAXIS", 2), ("NAXIS1", 8), ("NAXIS2", 1),
                     ("PCOUNT", len(heap)), ("GCOUNT", 1), ("TFIELDS", 1),
                     ("TFORM1", f"'1PB({len(heap)})'"), ("ZIMAGE", "T"),
                     ("ZBITPIX", 8), ("ZNAXIS", 2), ("ZNAXIS1", w),
                     ("ZNAXIS2", h), ("ZTILE1", w), ("ZTILE2", h),
                     ("ZCMPTYPE", "'GZIP_1  '")])
            + body.ljust(-(-len(body) // 2880) * 2880, b"\0"))


def write_fits(path: str, img: np.ndarray, compress: bool = False) -> None:
    """Write fits_bytes(img, compress) to `path`."""
    with open(path, "wb") as f:
        f.write(fits_bytes(img, compress))
