"""Which of PIL's plugins the port has not ported would take a file:
FITS, FLI, IPTC and PCD (ROADMAP item 22b, PIL's small formats part 3).
Each function below says whether the plugin would identify the file, so
that core/image_io.decode_ldr can refuse such a file with
NotImplementedError where PIL would read it, and pass it on where PIL's
plugin gives up with SyntaxError, IndexError, TypeError or struct.error.

FITS, FLI and PCD: their _accept (FLI's with the header checks its _open
makes before it first raises one of those, as its accept is weak enough
to take another format's file); IPTC, which has no _accept: its _open's
header checks up to where the file is identified. Each follows Pillow
12.1's plugin of that name. A file that one of these takes and whose
later header fields PIL then rejects with SyntaxError is refused here
where PIL may pass it on: only the checks above are made.
"""

from __future__ import annotations

import struct


def fits(d: bytes) -> bool:
    return d.startswith(b"SIMPLE")


def fli(d: bytes) -> bool:
    s = d[:128]
    return (len(s) >= 16 and struct.unpack_from("<H", s, 4)[0]
            in (0xAF11, 0xAF12) and struct.unpack_from("<H", s, 14)[0]
            in (0, 3) and s[20:22] == bytes(2) and s[42:80] == bytes(38)
            and s[88:] == bytes(40))


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


def pcd(d: bytes) -> bool:
    return d[2048:2052] == b"PCD_" and len(d) >= 2048 + 1539
