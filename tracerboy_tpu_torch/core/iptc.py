"""The port's IPTC/NAA reader and writer: the pixels PIL returns for an
IPTC/NAA image record (Pillow 12.1's IptcImagePlugin), bit for bit,
without an imaging library.

Read as PIL reads it (the plugin has no _accept: its _open is the
test): 5-byte field headers (0x1C, record, tag, a 16-bit size, or an
extended size of s[3] - 128 bytes; a first field of zeros ends them) up
to the first (8, 10) field; (3, 60) gives the mode, layers 1 with no
component L (no band), layers 3 or 4 with a component RGB or CMYK, and
their band from (3, 65), less 1 (0 without it); (3, 20) and (3, 30) the
size (the last 4 bytes of the field, big-endian); (3, 120) the
compression, 1 raw and 5 "jpeg". The pixels are the (8, 10) fields'
data run together:
- raw data behind a "P5 w h 255" header, read by core/pnm.py;
- "jpeg" data read as any file Image.open takes: image_io's table of
  readers on those bytes.
With a band, the inner image becomes that band of an RGB or CMYK image
whose other bands are black (PIL's merge): it must be single-band, L
(or, as band 0, which merge does not check, P's indices, "1" as 0/255,
or the first width bytes of each I;16 row). An RGB image is then read
at the header's size from the merged image's bytes; CMYK is converted
at the inner image's size. Without a band the inner image is kept and
converted to RGB, its alpha dropped, at its own size.

Refused as PIL refuses: UnidentifiedImageError where PIL's _open raises
SyntaxError, IndexError, TypeError, KeyError or struct.error (a bad
field header, a missing or empty mode, band or size field, no mode for
the layers), passing the file on; ValueError where PIL raises otherwise
(an illegal field length, a compression that is not 1 or 5, no image
records, data cut short, an inner image of the wrong mode or of a band
past the image's; an RGB image larger than the merged one, whose bytes
PIL reads past the end, and an inner I or F image as band 0, which
PIL's merge reads as 8-bit rows it does not have). An inner image no
reader takes raises NotImplementedError, as PIL's UnidentifiedImageError;
a band from an inner image of a format whose mode the port does not
track (not JPEG, PNG, PNM, FITS or SPIDER), and an inner TIFF, IM, PSD
or McIdas image, whose modes PIL may not convert, raise
NotImplementedError naming ROADMAP.md's item.

write_iptc writes a raw L image, for the demo scenes' textures.
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    as_read_ldr,
    check_image_size,
)
from tracerboy_tpu_torch.core.rawformats import unidentified

ITEM = ("ROADMAP.md, Queue 1: item 4b, an IPTC image's inner file in a "
        "format whose PIL mode the port does not track")
_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
_BANDS = {"RGB": 3, "CMYK": 4}


class _Fields:
    """IptcImageFile.field on a position in the data."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        s = self.data[self.pos:self.pos + n]
        self.pos += len(s)
        return s

    def field(self):
        s = self.read(5)
        if not s.strip(b"\0"):
            return None, 0
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in _RECORDS:
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _i(self.read(size - 128))
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        return tag, size


def _i(c) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def iptc_layout(data: bytes, path: str = "<iptc>") -> dict:
    """IptcImageFile._open: mode, band, size, compression and the (8, 10)
    field's offset (None: no image records)."""
    try:
        return _open(data, path)
    except (SyntaxError, IndexError, TypeError, KeyError,
            struct.error) as e:
        raise unidentified(path, f"IPTC: {e!r}") from None
    except UnidentifiedImageError:
        raise
    except OSError as e:
        raise ValueError(f"{path}: {e}") from None


def _open(data: bytes, path: str) -> dict:
    info: dict = {}
    f = _Fields(data)
    while True:
        offset = f.pos
        tag, size = f.field()
        if not tag or tag == (8, 10):
            break
        tagdata = f.read(size) if size else None
        if tag in info:
            old = info[tag]
            info[tag] = old + [tagdata] if isinstance(old, list) else [
                old, tagdata]
        else:
            info[tag] = tagdata
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode = band = None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _i(info[(3, 20)]), _i(info[(3, 30)])
    try:
        compression = {1: "raw", 5: "jpeg"}[_i(info[(3, 120)])]
    except KeyError:
        raise OSError("Unknown IPTC image compression") from None
    if not mode:
        raise SyntaxError("not identified by this driver")
    check_image_size(*size, path)
    return dict(mode=mode, band=band, width=size[0], height=size[1],
                compression=compression,
                offset=offset if tag == (8, 10) else None)


def _inner_mode(name: str, data: bytes, path: str):
    """The PIL mode of the inner image where the port tracks it (else
    None), and, for P and I;16, its band as PIL's merge reads it ((H, W)
    uint8: P's indices, the first width bytes of each I;16 row)."""
    from tracerboy_tpu_torch.core import fits, jpeg, pnm
    from tracerboy_tpu_torch.core.image_io import decode_png

    if name == "JPEG":
        head = jpeg.frame_header(data, path)
        return ("L" if head and len(head[3]) == 1 else "RGB"), None
    if name == "PPM":
        return pnm.decode_pnm(data, path)[1], None
    if name == "FITS":
        return fits._MODES[fits.fits_layout(data, path)["bits"]][0], None
    if name == "SPIDER":
        return "F", None
    if name == "PNG":
        samples, ctype, depth, _ = decode_png(data, path)
        if ctype == 3:
            return "P", samples[..., 0]
        if ctype != 0:
            return "RGB", None
        if depth == 16:
            rows = samples[..., 0].astype("<u2").view(np.uint8)
            return "I;16", np.ascontiguousarray(rows[:, :samples.shape[1]])
        return ("1" if depth == 1 else "L"), None
    return None, None


def read_iptc(data: bytes, path: str = "<iptc>") -> np.ndarray:
    """An IPTC/NAA file's image as the JAX read_ldr gets it through PIL:
    (H, W, 3) uint8."""
    from tracerboy_tpu_torch.core.image_io import decode_named

    lay = iptc_layout(data, path)
    if lay["offset"] is None:
        raise ValueError(f"{path}: cannot load this image (IPTC without "
                         "image records)")
    mode, band = lay["mode"], lay["band"]
    f = _Fields(data, lay["offset"])
    inner = [b"P5\n%d %d\n255\n" % (lay["width"], lay["height"])
             if lay["compression"] == "raw" else b""]
    try:
        while True:
            tag, size = f.field()
            if tag != (8, 10):
                break
            inner.append(f.read(size))
    except UnidentifiedImageError:
        raise
    except (SyntaxError, OSError, IndexError, struct.error) as e:
        raise ValueError(f"{path}: IPTC image records: {e}") from None
    inner = b"".join(inner)
    try:
        name, px = decode_named(inner, path)
    except UnidentifiedImageError as e:   # PIL's, out of load
        raise NotImplementedError(str(e)) from None
    except OSError as e:                  # core/jpeg.py's corrupt data
        raise ValueError(str(e)) from None
    if band is None:
        if name in ("TIFF", "IM", "PSD", "MCIDAS"):
            raise NotImplementedError(f"{path}: an IPTC image holding a "
                                      f"{name} file ({ITEM})")
        if _inner_mode(name, inner, path)[0] == "F":
            raise ValueError(f"{path}: conversion from F to RGB not "
                             "supported (IPTC)")
        return np.ascontiguousarray(px[..., :3])
    inner_mode, plane = _inner_mode(name, inner, path)
    if inner_mode is None:
        raise NotImplementedError(f"{path}: an IPTC band from a {name} "
                                  f"file ({ITEM})")
    nb = _BANDS[mode]
    if not -nb <= band < nb:
        raise ValueError(f"{path}: list assignment index out of range "
                         f"(IPTC band {band})")
    first = band % nb == 0
    if inner_mode != "L" and not first:
        raise ValueError(f"{path}: mode mismatch (IPTC band)")
    if inner_mode in ("I", "F"):
        raise ValueError(f"{path}: a mode {inner_mode} image as band 0 "
                         "(PIL's merge reads no 8-bit rows of it)")
    if inner_mode in ("L", "1"):
        plane = px[..., 0]
    elif plane is None:
        raise ValueError(f"{path}: image has wrong mode (IPTC band)")
    h, w = plane.shape
    merged = np.zeros((h, w, nb), np.uint8)
    merged[..., band] = plane
    if mode == "CMYK":
        return as_read_ldr(merged, "CMYK")
    oh, ow = lay["height"], lay["width"]
    if oh * ow > h * w:
        raise ValueError(f"{path}: an RGB IPTC of {ow}x{oh} from a "
                         f"{w}x{h} image (PIL reads past its bytes)")
    return merged.reshape(-1)[:oh * ow * 3].reshape(oh, ow, 3)


def _record(rec: int, tag: int, data: bytes) -> bytes:
    return bytes((0x1C, rec, tag)) + struct.pack(">H", len(data)) + data


def iptc_bytes(img: np.ndarray) -> bytes:
    """An (H, W) uint8 grey image as raw IPTC records: (3, 60) layers 1,
    the size, compression 1 and the rows in (8, 10) records of at most
    32,767 bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    px = img.tobytes()
    return (_record(3, 60, b"\x01\x00") + _record(3, 20, struct.pack(
        ">I", w)) + _record(3, 30, struct.pack(">I", h))
        + _record(3, 120, b"\x01") + b"".join(
            _record(8, 10, px[k:k + 32767]) for k in range(0, len(px),
                                                           32767)))


def write_iptc(path: str, img: np.ndarray) -> None:
    """Write iptc_bytes(img) to `path`."""
    with open(path, "wb") as f:
        f.write(iptc_bytes(img))
