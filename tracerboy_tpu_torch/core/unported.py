"""Which of PIL's plugins the port has not ported would take a file: each
function below says whether the plugin would identify it, so that
core/image_io.decode_ldr can refuse such a file with NotImplementedError
(ROADMAP item 22b) where PIL would read it, and pass it on where PIL's
plugin gives up with SyntaxError, IndexError, TypeError or struct.error.

For a plugin with an _accept, its _accept, plus the header checks its
_open makes before it first raises one of those for the formats whose
accept is weak enough to take another format's file (FLI, GBR); for
the plugins without one (IM, IMT, IPTC, PCD, SPIDER), their _open's
header checks up to where the file is identified. Each follows Pillow
12.1's plugin of that name. A file that one of these takes and whose
later header fields PIL then rejects with SyntaxError is refused here
where PIL may pass it on: only the checks above are made. PIL's stub
plugins (BUFR, GRIB, HDF5, MPEG, WMF) identify files that PIL cannot
load; core/stubs.py refuses them.
"""

from __future__ import annotations

import re
import struct


def _be32(data: bytes, at: int) -> int:
    return struct.unpack_from(">I", data, at)[0]



def eps(d: bytes) -> bool:
    return d.startswith(b"%!PS") or (
        len(d) >= 4 and struct.unpack_from("<I", d)[0] == 0xC6D3D0C5)


def fits(d: bytes) -> bool:
    return d.startswith(b"SIMPLE")


def fli(d: bytes) -> bool:
    s = d[:128]
    return (len(s) >= 16 and struct.unpack_from("<H", s, 4)[0]
            in (0xAF11, 0xAF12) and struct.unpack_from("<H", s, 14)[0]
            in (0, 3) and s[20:22] == bytes(2) and s[42:80] == bytes(38)
            and s[88:] == bytes(40))


def gbr(d: bytes) -> bool:
    if len(d) < 8 or _be32(d, 0) < 20 or _be32(d, 4) not in (1, 2):
        return False
    if len(d) < 20:
        return False                       # struct.error
    width, height, depth = struct.unpack_from(">3I", d, 8)
    if not width or not height or depth not in (1, 4):
        return False
    return _be32(d, 4) == 1 or d[20:24] == b"GIMP"




_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no "
            "of images)", "Lut", "Name", "Scale (x,y)", "Image size (x*y)",
            "Image type")


def im(d: bytes) -> bool:
    """ImImageFile._open up to its last SyntaxError: a text header of
    "Key: value" lines of at most 100 bytes, one of them a key IM knows,
    ended by a 0x1A."""
    if b"\n" not in d[:100]:
        return False
    pos, n, s = 0, 0, b""
    while True:
        s = d[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        nl = d.find(b"\n", pos)
        end = len(d) if nl < 0 else nl + 1
        s += d[pos:end]
        pos = end
        if len(s) > 100:
            return False
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_SPLIT.match(s)
        if not m:
            return False
        if m.group(1).decode("latin-1") in _IM_TAGS:
            n += 1
    if not n:
        return False
    while s and not s.startswith(b"\x1a"):
        s = d[pos:pos + 1]
        pos += 1
    return bool(s)


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def imt(d: bytes) -> bool:
    """ImtImageFile._open: its header lines set a width, a height and the
    pixel type n8 (mode L) before the file is identified."""
    buffer = d[:100]
    pos = len(buffer)
    if b"\n" not in buffer:
        return False
    width = height = 0
    mode = None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = d[pos:pos + 1]
            pos += len(s)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += d[pos:pos + 100]
            pos += len(d[pos:pos + 100])
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            width = int(v)
        elif k == b"height":
            height = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return mode is not None and width > 0 and height > 0


def iptc(d: bytes) -> bool:
    """IptcImageFile._open: valid field headers up to an empty one or the
    (8, 10) record, then the (3, 60) mode, (3, 65) band and (3, 20) and
    (3, 30) size fields it reads (ImageFile turns the IndexError,
    TypeError and KeyError of a missing or short one into SyntaxError);
    past them PIL goes on, or raises."""
    info: dict = {}
    pos = 0
    while True:
        s = d[pos:pos + 5]
        pos += 5
        if not s.strip(b"\0"):
            break
        if len(s) < 3 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7,
                                                       8, 9, 240):
            return False
        if len(s) < 4:
            return False                   # IndexError
        size = s[3]
        if size > 132:
            return True                    # OSError
        if size == 128:
            size = 0
        elif size > 128:
            size = int.from_bytes(d[pos:pos + size - 128][-4:], "big")
            pos += s[3] - 128
        else:
            if len(s) < 5:
                return False               # struct.error
            size = struct.unpack_from(">H", s, 3)[0]
        tag = (s[1], s[2])
        if tag == (8, 10):
            break
        data = d[pos:pos + size] if size else None
        pos += size
        if tag in info:
            old = info[tag]
            info[tag] = old + [data] if isinstance(old, list) else [old,
                                                                    data]
        else:
            info[tag] = data
    mode = info.get((3, 60))
    if not isinstance(mode, bytes) or len(mode) < 2:
        return False
    if not (mode[0] == 1 and not mode[1]) and (3, 65) in info:
        band = info[(3, 65)]
        if not isinstance(band, bytes) or not band:
            return False
    return all(isinstance(info.get(k), bytes) for k in ((3, 20), (3, 30)))


def mcidas(d: bytes) -> bool:
    return d.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04")



def msp(d: bytes) -> bool:
    return d.startswith((b"DanM", b"LinS"))


def pcd(d: bytes) -> bool:
    return d[2048:2052] == b"PCD_" and len(d) >= 2048 + 1539


def pixar(d: bytes) -> bool:
    return d.startswith(b"\200\350\000\000")


def _spider_header(t) -> int:
    h = (99,) + t

    def is_int(f):
        try:
            return f - int(f) == 0
        except (ValueError, OverflowError):
            return False

    if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def spider(d: bytes) -> bool:
    """SpiderImageFile._open: a header of 27 floats, big- or
    little-endian, that isSpiderHeader takes, of a 2-D image."""
    if len(d) < 108:
        return False
    for order in (">", "<"):
        t = struct.unpack_from(order + "27f", d)
        if _spider_header(t):
            return int(t[4]) == 1
    return False


def sun(d: bytes) -> bool:
    return len(d) >= 4 and _be32(d, 0) == 0x59A66A95


def xbm(d: bytes) -> bool:
    return d[:16].lstrip().startswith(b"#define")


def xpm(d: bytes) -> bool:
    return d.startswith(b"/* XPM */")


def xvthumb(d: bytes) -> bool:
    return d.startswith(b"P7 332")
