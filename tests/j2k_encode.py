"""Writers of the JPEG 2000 files the port's reader is tested on, around
the codestreams PIL's encoder (OpenJPEG) writes: JP2 boxes (ihdr, colr
enumerated or ICC, pclr + cmap, cdef, res, the jpx brand, unknown boxes),
codestreams taken apart into marker segments and tile-parts and put back
together with segments added or changed (COM, TLM, PLM, CRG, unknown
markers; tile-part COD, COC, QCD, QCC, POC, RGN; SIZ precision, sign and
Rsiz; code-block styles), and packets rewritten from the packet
boundaries the port's decoder reports (SOP and EPH markers inserted,
packet headers moved into PPT or PPM segments).

Used by tests/make_j2k_fixtures.py and tests/test_torch_jpeg2000.py.
"""

from __future__ import annotations

import io
import struct

import numpy as np

SIGNATURE_BOX = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"


def pil_codestream(img: np.ndarray, mode: str, **kw) -> bytes:
    """PIL's raw codestream of img in mode (its JPEG2000 save options)."""
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(img, mode if mode != "I;16" else None)
    if mode == "I;16" and im.mode != "I;16":
        im = im.convert("I;16")
    im.save(buf, "JPEG2000", no_jp2=True, **kw)
    return buf.getvalue()


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def xl_box(kind: bytes, body: bytes) -> bytes:
    """A box with the 8-byte XLBox length."""
    return struct.pack(">I4sQ", 1, kind, 16 + len(body)) + body


def ihdr(width: int, height: int, nc: int, bpc: int = 7) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", height, width, nc, bpc, 7,
                                    0, 0))


def colr(enumcs: int = 16) -> bytes:
    return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def colr_icc(profile: bytes) -> bytes:
    return box(b"colr", bytes([2, 0, 0]) + profile)


def pclr(entries: np.ndarray, depth: int = 8) -> bytes:
    """A palette box of (NE, NPC) entries of `depth` bits (one byte each
    up to 8 bits, two above)."""
    ne, npc = entries.shape
    body = struct.pack(">HB", ne, npc) + bytes([depth - 1] * npc)
    dt = ">u1" if depth <= 8 else ">u2"
    return box(b"pclr", body + entries.astype(dt).tobytes())


def cmap(channels: int) -> bytes:
    """Component 0 through each palette column."""
    return box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                 for i in range(channels)))


def cdef(defs) -> bytes:
    """Channel definitions: (channel, type, association) triples."""
    return box(b"cdef", struct.pack(">H", len(defs)) + b"".join(
        struct.pack(">HHH", *d) for d in defs))


def res_box(num: int = 2835, den: int = 1, exp: int = 0) -> bytes:
    resc = struct.pack(">HHHHbb", num, den, num, den, exp, exp)
    return box(b"res ", box(b"resc", resc) + box(b"resd", resc))


def ftyp(brand: bytes = b"jp2 ", compat=(b"jp2 ",)) -> bytes:
    return box(b"ftyp", brand + b"\0\0\0\0" + b"".join(compat))


def jp2_file(codestream: bytes, header=None, width=None, height=None,
             nc=None, bpc=7, brand=b"jp2 ", before=(), after=(),
             xl_codestream=False) -> bytes:
    """A JP2 file: signature, ftyp, jp2h (`header`: its sub-boxes; by
    default ihdr from the codestream's SIZ and colr sRGB or grey),
    `before` boxes between jp2h and jp2c, the jp2c box, `after` boxes."""
    if width is None:
        s = siz_fields(codestream)
        width, height, nc = s["x1"] - s["x0"], s["y1"] - s["y0"], s["nc"]
    if header is None:
        header = [ihdr(width, height, nc, bpc), colr(16 if nc >= 3 else 17)]
    jp2c = (xl_box if xl_codestream else box)(b"jp2c", codestream)
    return (SIGNATURE_BOX + ftyp(brand) + box(b"jp2h", b"".join(header))
            + b"".join(before) + jp2c + b"".join(after))


# ----------------------------------------------------------------------------
# Codestreams


class Codestream:
    """A codestream taken apart: `main` the main header's (marker, body)
    segments after SOC (SIZ first), `tiles` a list of tile-parts, each
    [sot_body (8 bytes), [(marker, body) ...], data]; `tail` the bytes
    after the last tile-part (EOC)."""

    def __init__(self, data: bytes):
        assert data[:2] == b"\xff\x4f"
        pos = 2
        self.main = []
        while True:
            marker = struct.unpack_from(">H", data, pos)[0]
            if marker == 0xFF90:
                break
            n = struct.unpack_from(">H", data, pos + 2)[0]
            self.main.append((marker, data[pos + 4:pos + 2 + n]))
            pos += 2 + n
        self.tiles = []
        while struct.unpack_from(">H", data, pos)[0] == 0xFF90:
            sot = data[pos + 4:pos + 12]
            psot = struct.unpack_from(">I", sot, 2)[0]
            end = pos + psot if psot else len(data) - 2
            p = pos + 12
            segs = []
            while struct.unpack_from(">H", data, p)[0] != 0xFF93:
                marker, n = struct.unpack_from(">HH", data, p)
                segs.append((marker, data[p + 4:p + 2 + n]))
                p += 2 + n
            self.tiles.append([sot, segs, data[p + 2:end]])
            pos = end
        self.tail = data[pos:]

    def segment(self, marker: int) -> bytes:
        return next(b for m, b in self.main if m == marker)

    def replace(self, marker: int, body: bytes) -> None:
        self.main = [(m, body if m == marker else b) for m, b in self.main]

    def insert_after(self, marker: int, new_marker: int, body: bytes) -> None:
        i = next(i for i, (m, _) in enumerate(self.main) if m == marker)
        self.main.insert(i + 1, (new_marker, body))

    def bytes(self, raw_main: bytes = b"") -> bytes:
        """The codestream again, Psot recomputed; `raw_main` is inserted
        as it is after the main header's segments."""
        out = [b"\xff\x4f"]
        out += [seg(m, b) for m, b in self.main]
        out.append(raw_main)
        for sot, segs, data in self.tiles:
            head = b"".join(seg(m, b) for m, b in segs)
            psot = 12 + len(head) + 2 + len(data)
            tile, _, tpsot, tnsot = struct.unpack(">HIBB", sot)
            out.append(seg(0xFF90, struct.pack(">HIBB", tile, psot, tpsot,
                                               tnsot)))
            out += [head, b"\xff\x93", data]
        out.append(self.tail)
        return b"".join(out)


def seg(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, 2 + len(body)) + body


def siz_fields(data: bytes) -> dict:
    s = Codestream(data).segment(0xFF51) if data[:2] == b"\xff\x4f" \
        else None
    (rsiz, x1, y1, x0, y0, tdx, tdy, tx0, ty0,
     nc) = struct.unpack_from(">HIIIIIIIIH", s)
    return dict(rsiz=rsiz, x1=x1, y1=y1, x0=x0, y0=y0, nc=nc)


def with_siz(data: bytes, rsiz=None, precision=None, signed=None,
             subsampling=None) -> bytes:
    """The codestream with its SIZ's Rsiz, every component's precision or
    sign bit, or components' (XRsiz, YRsiz) changed."""
    cs = Codestream(data)
    s = bytearray(cs.segment(0xFF51))
    if rsiz is not None:
        s[0:2] = struct.pack(">H", rsiz)
    nc = struct.unpack_from(">H", s, 34)[0]
    for i in range(nc):
        ssiz = s[36 + 3 * i]
        prec, sgn = (ssiz & 0x7F) + 1, ssiz >> 7
        if precision is not None:
            prec = precision
        if signed is not None:
            sgn = int(signed)
        s[36 + 3 * i] = (prec - 1) | (sgn << 7)
        if subsampling is not None and subsampling[i] is not None:
            s[37 + 3 * i:39 + 3 * i] = bytes(subsampling[i])
    cs.replace(0xFF51, bytes(s))
    return cs.bytes()


def with_cblk_style(data: bytes, style: int) -> bytes:
    """The codestream with its COD's code-block style byte set."""
    cs = Codestream(data)
    cod = bytearray(cs.segment(0xFF52))
    cod[8] = style
    cs.replace(0xFF52, bytes(cod))
    return cs.bytes()


def with_main_segments(data: bytes, segments, raw: bytes = b"") -> bytes:
    """The codestream with (marker, body) segments appended to its main
    header, then `raw` bytes."""
    cs = Codestream(data)
    cs.main += list(segments)
    return cs.bytes(raw)


def with_tile_segments(data: bytes, segments, tile_part: int = 0) -> bytes:
    """The codestream with (marker, body) segments added to a tile-part's
    header."""
    cs = Codestream(data)
    cs.tiles[tile_part][1] = list(segments) + cs.tiles[tile_part][1]
    return cs.bytes()


def tlm(cs: Codestream) -> bytes:
    """A TLM segment for the tile-parts (Ttlm 8 bits, Ptlm 32 bits)."""
    body = bytes([0, 0x10 | 0x40])
    for sot, segs, data in cs.tiles:
        psot = 12 + sum(4 + len(b) for _, b in segs) + 2 + len(data)
        body += struct.pack(">BI", struct.unpack(">H", sot[:2])[0], psot)
    return body


# ----------------------------------------------------------------------------
# Packets


def packets(data: bytes):
    """Each tile-part's packets as the port's decoder finds them: a list,
    for each tile in decoding order, of (tile, [(start, header_end,
    body_end), ...]) with offsets in the tile's concatenated data."""
    from tracerboy_tpu_torch.core import jpeg2000

    return jpeg2000.packet_boundaries(data)


def rewrite_packets(data: bytes, sop=False, eph=False, ppt=False,
                    ppm=False) -> bytes:
    """The single-tile-part-per-tile codestream `data` with SOP markers
    before its packets and/or EPH markers after their headers (the COD's
    Scod bits set), or with the packet headers moved into PPT segments
    (one per tile-part) or PPM segments of the main header."""
    cs = Codestream(data)
    found = dict(packets(data))
    if sop or eph:
        cod = bytearray(cs.segment(0xFF52))
        cod[0] |= (2 if sop else 0) | (4 if eph else 0)
        cs.replace(0xFF52, bytes(cod))
    ppm_chunks = []
    for part in cs.tiles:
        tile = struct.unpack(">H", part[0][:2])[0]
        body = part[2]
        headers, bodies = [], []
        for n, (start, hend, bend) in enumerate(found[tile]):
            head = body[start:hend]
            if eph:
                head += b"\xff\x92"
            if sop:
                bodies.append(b"\xff\x91\x00\x04" + struct.pack(">H",
                                                                n & 0xFFFF))
            headers.append(head)
            bodies.append(body[hend:bend])
        if ppt:
            part[1] = part[1] + [(0xFF61, b"\x00" + b"".join(headers))]
            part[2] = b"".join(bodies)
        elif ppm:
            ppm_chunks.append(b"".join(headers))
            part[2] = b"".join(bodies)
        else:
            merged = []
            k = 0
            for n in range(len(found[tile])):
                if sop:
                    merged.append(bodies[k])
                    k += 1
                merged += [headers[n], bodies[k]]
                k += 1
            part[2] = b"".join(merged)
    if ppm:
        body = b"".join(struct.pack(">I", len(c)) + c for c in ppm_chunks)
        cs.main.append((0xFF60, b"\x00" + body))
    return cs.bytes()
