"""PIL's stub plugins: BUFR, GRIB, HDF5, MPEG and WMF. PIL identifies such
a file but cannot load it: BUFR, GRIB, HDF5 and WMF load only through a
handler that an application registers (none is by default), and MPEG is
identified only. So the JAX read_ldr's convert or asarray raises OSError
("cannot find loader for this BUFR file", "cannot load this image"), and
the port raises ValueError where PIL raises OSError, after the header
checks the plugin's _open makes: a file they reject is passed on, as
PIL's SyntaxError passes it on. Each follows Pillow 12.1's plugin of that
name.
"""

from __future__ import annotations

import struct

from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    check_image_size,
)

WMF_PLACEABLE = b"\xd7\xcd\xc6\x9a\x00\x00"
WMF_ENHANCED = b"\x01\x00\x00\x00"


def is_bufr(d: bytes) -> bool:
    return d.startswith((b"BUFR", b"ZCZC"))


def is_grib(d: bytes) -> bool:
    return len(d) >= 8 and d.startswith(b"GRIB") and d[7] == 1


def is_hdf5(d: bytes) -> bool:
    return d.startswith(b"\x89HDF\r\n\x1a\n")


def is_mpeg(d: bytes) -> bool:
    return d.startswith(b"\x00\x00\x01\xb3")


def is_wmf(d: bytes) -> bool:
    return d.startswith((WMF_PLACEABLE, WMF_ENHANCED))


def _no_loader(fmt: str):
    """The reader of a stub whose _open checks only what _accept did and
    gives the image a size of 1x1: StubImageFile.load's refusal."""

    def read(data: bytes, path: str):
        raise ValueError(f"{path}: cannot find loader for this {fmt} file "
                         "(PIL's stub plugin, no handler registered)")

    return read


read_bufr = _no_loader("BUFR")
read_grib = _no_loader("GRIB")
read_hdf5 = _no_loader("HDF5")


def read_mpeg(data: bytes, path: str):
    """MpegImageFile._open: the sequence header's 12-bit width and
    height (a file cut before them is passed on, PIL's IndexError), then
    ImageFile.load's refusal of an image with no tile."""
    if len(data) < 7:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(MPEG header cut short)")
    w = data[4] << 4 | data[5] >> 4
    h = (data[5] & 15) << 8 | data[6]
    check_image_size(w, h, path)
    raise ValueError(f"{path}: cannot load this image (PIL identifies "
                     "MPEG streams only)")


def read_wmf(data: bytes, path: str):
    """WmfStubImageFile._open's two kinds, a placeable metafile (its
    units per inch, bounding box at 72 dpi and the standard header at
    byte 22) or an enhanced one (" EMF" at byte 40, its dpi from the
    bounding box over the frame), then StubImageFile.load's refusal."""
    s = data[:44]
    if s.startswith(WMF_PLACEABLE):
        if len(s) < 16:
            raise UnidentifiedImageError(f"{path}: cannot identify image "
                                         "file (WMF header cut short)")
        x0, y0, x1, y1, inch = struct.unpack_from("<4hH", s, 6)
        if inch == 0:
            raise ValueError(f"{path}: Invalid inch (WMF)")
        if s[22:26] != b"\x01\x00\t\x00":
            raise UnidentifiedImageError(f"{path}: cannot identify image "
                                         "file (unsupported WMF format)")
        size = (x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch
    elif s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        if f2 == f0 or f3 == f1:
            raise ValueError(f"{path}: float division by zero (the WMF's "
                             "frame is empty)")
        size = x1 - x0, y1 - y0
    else:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     "(unsupported WMF file format)")
    check_image_size(*size, path)
    raise ValueError(f"{path}: cannot find loader for this WMF file (PIL's "
                     "stub plugin, no handler registered)")
