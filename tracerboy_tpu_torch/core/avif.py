"""The port's AVIF reader: the pixels PIL returns (Pillow 12.1, which reads
AVIF through libavif 1.3 and dav1d 1.5), bit for bit, without an imaging
library or an AV1 library.

AVIF is the texture format web asset stores and browsers ship beside
WebP; the JAX package reads it through PIL. Three layers, each as its
original does it:
- PIL's plugin (AvifImagePlugin.py): _accept (an ftyp box at offset 4
  whose major brand is avif, avis, mif1 or msf1); the mode is RGBA where
  libavif finds an alpha item or track, else RGB. What libavif's parse
  refuses with a file-type, box-parse, truncation or no-content error
  PIL cannot identify (its SyntaxError: UnidentifiedImageError here);
  what fails later PIL raises (ValueError here).
- libavif 1.3 (read.c): the box tree as avifParse and avifDecoderReset
  walk it: top-level boxes until the ftyp, and the meta (brand avif) or
  moov (brand avis) the brands ask for, are read; the ftyp must name avif
  or avis among its brands; the meta's first child is an hdlr of type
  pict; pitm, iloc (versions 0-2, construction methods 0 and 1 with
  idat), iinf (infe versions 2 and 3), iref (auxl, prem, thmb, cdsc,
  dimg), iprp with ipco and ipma; the colour item is the primary item,
  an av01 item, which needs av1C, ispe and pixi (libavif's default
  strict flags), or a grid item; the alpha item is the av01 or grid item
  with an auxl reference to it and an auxC of
  urn:mpeg:mpegB:cicp:systems:auxiliary:alpha (or the HEVC URN). A grid
  (HEIF 6.6.2.3, MIAF 7.3.11.4.2) is read as libavif 1.3 reads it: its
  ImageGrid (version 0, flags bit 0 for 32-bit output sizes, exactly
  that long; an output size not 0 and within libavif's limits), its
  tiles the av01 items whose dimg references it names, in the order it
  names them, rows x columns of them, none with an unsupported essential
  property; the grid takes the first tile's av1C (every tile's must
  agree with it, and each tile needs an ispe), its pixi is optional and
  checked against that av1C, and colour comes from the grid's own nclx
  (the tiles' colr boxes are not read) or else the first tile's AV1
  sequence header. Every tile is decoded; the tiles must agree in size,
  depth, subsampling, range and CICP, be at least 64 samples a side,
  even where chroma is subsampled, cover the output and overlap it with
  their last row and column; their planes are stitched into one frame
  (chroma at the tiles' chroma offsets) and cropped to the output size,
  and that frame is converted whole, so chroma upsampling crosses tile
  borders as in libavif. With major brand avis the first sample of the
  first av01 track is the frame, and the alpha is the track whose auxl
  tref names it. Colour primaries, transfer and matrix come from the
  colr nclx property, and the range from its full_range_flag; without
  one, from the AV1 sequence header. irot, imir and clap do not move
  pixels (PIL reports orientation in info). Each rule of libavif's that
  the parser repeats was read off PIL's answers to one-byte edits of
  every box, the moov box's too (every trak's tkhd, the sample tables of
  the tracks libavif decodes, the alpha track's auxi URN and size).
- the AV1 frame: csrc/av1_decode.cpp, which decodes an 8-bit intra
  frame, intra block copy and its in-loop filters included (deblocking
  with delta LF, CDEF, loop restoration with Wiener and self-guided
  units: av1_filters.inc), applies its film grain to the planes it hands
  out as dav1d does (av1_grain.inc; the alpha item's too, where its
  frame carries grain), and converts YUV to RGB(A) as libavif does:
  where the libyuv in Pillow's wheel has the matrix, as libavif hands
  it to libyuv (bilinear chroma upsampling, libyuv's fixed-point
  matrices, libyuv's un-premultiply where a prem reference marks the
  alpha); else in libavif's own float routines (avif_reformat.inc: 4
  FCC, 7 SMPTE 240M, 8 YCgCo at full range, 12 with primaries other
  than BT.709, unspecified, BT.601 or BT.2020, 15, identity at limited
  range; bilinear chroma upsampling in float, its un-premultiply in
  float, or libyuv's after its 4:4:4 and 4:0:0 routines).

Refused with NotImplementedError naming ROADMAP item 22b, AVIF part 2,
where PIL reads the file: a frame that is not a shown key frame,
superres and high bit depth (10 and 12 bits). The matrices libavif
refuses ("Reformat failed": 3, 10, 11, 13, 14 and 16-255; identity
unless 4:4:4; YCgCo at limited range), a primary item of a type other
than av01 and grid (iovl among them: "missing or empty image item";
an iovl alpha item is no alpha) and each of libavif's grid checks above
raise ValueError, as PIL raises. So does an ispe (or a colour track's
tkhd size) that disagrees with the AV1 frame, where Pillow lays the
frame's pixels out at the ispe's size and returns what lies past them (a
grid's ispe against its output size too), a tile whose ispe disagrees
with its frame, which libavif scales to the ispe with libyuv, and an intra block copy vector that points
outside what is decoded (INVALID_DV), which dav1d copies from whatever
its frame buffer holds there.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from tracerboy_tpu_torch.core.codecs import av1_library
from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    check_image_size,
)

ITEM = ("ROADMAP.md, Queue 1: item 22b, AVIF part 2 (frames that are not "
        "shown key frames, superres, high bit depth)")
# The decoder's refusal of an intra block copy vector outside the decoded
# area (ValueError: corrupt).
INVALID_DV = "an intra block copy vector outside the decoded area"
BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
# libavif's limits (avifDecoderCreate): 16384 x 16384 pixels, 32768 a side.
SIZE_LIMIT = 16384 * 16384
DIMENSION_LIMIT = 32768


def is_avif(data: bytes) -> bool:
    """PIL's _accept (AvifImagePlugin.py)."""
    return data[4:8] == b"ftyp" and data[8:12] in BRANDS


class _Unidentified(Exception):
    """libavif's parse failed with an error Pillow maps to SyntaxError."""


class _Failed(Exception):
    """libavif or Pillow failed later (RuntimeError or SyntaxError at
    load): PIL raises."""


def _boxes(data: bytes, start: int, end: int, top: bool = False):
    """(type, body start, body end) of the boxes in data[start:end], as
    avifROStreamReadBoxHeader reads them: a size under the header's, or
    past the end (inside a box), fails the parse."""
    off = start
    while off < end:
        if end - off < 8:
            raise _Unidentified("box header past the end")
        size, typ = struct.unpack(">I4s", data[off:off + 8])
        hdr = 8
        if size == 1:
            if end - off < 16:
                raise _Unidentified("box header past the end")
            size = struct.unpack(">Q", data[off + 8:off + 16])[0]
            hdr = 16
        elif size == 0:
            if not top:
                raise _Unidentified("box of size 0")
            size = end - off
        if typ == b"uuid":
            hdr += 16
        if size < hdr:
            raise _Unidentified("box smaller than its header")
        if not top and off + size > end:
            raise _Unidentified("box past its parent")
        yield typ, off + hdr, off + size
        off += size


class _Reader:
    """A big-endian reader over one box's body; reads past the end fail
    the parse."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end

    def take(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise _Unidentified("box body too short")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def full(self, versions) -> tuple[int, int]:
        v, flags = self.u(1), self.u(3)
        if v not in versions:
            raise _Unidentified(f"unsupported box version {v}")
        return v, flags

    def string(self) -> bytes:
        i = self.data.find(b"\0", self.pos, self.end)
        if i < 0:
            raise _Unidentified("unterminated string")
        s = self.data[self.pos:i]
        self.pos = i + 1
        return s


class _Item:
    def __init__(self, iid: int):
        self.id = iid
        self.type = b""
        self.props: list[tuple[bytes, int, int, bool]] = []
        self.extents = None          # (construction method, [(off, len)])
        self.aux_for = None          # auxl target
        self.prem_by: list[int] = []
        self.dimg_for = None         # (grid item, index among its tiles)
        self.unsupported_essential = False


def _parse_meta(data: bytes, start: int, end: int):
    r = _Reader(data, start, end)
    r.full((0,))
    items: dict[int, _Item] = {}
    props: list[tuple[bytes, int, int]] = []
    primary = None
    idat = None
    seen = set()

    def item(iid):
        if iid not in items:
            items[iid] = _Item(iid)
        return items[iid]

    first = True
    for typ, s, e in _boxes(data, r.pos, end):
        if first and typ != b"hdlr":
            raise _Unidentified("the meta box does not start with an hdlr")
        first = False
        if typ in seen and typ in (b"hdlr", b"iloc", b"pitm", b"idat",
                                   b"iprp", b"iinf", b"iref"):
            raise _Unidentified(f"two {typ.decode()} boxes")
        seen.add(typ)
        b = _Reader(data, s, e)
        if typ == b"hdlr":
            if _hdlr(data, s, e) != b"pict":
                raise _Unidentified("the meta's handler is not pict")
        elif typ == b"pitm":
            v, _ = b.full((0, 1))
            primary = b.u(2 if v == 0 else 4)
        elif typ == b"idat":
            idat = (s, e)
        elif typ == b"iloc":
            v, _ = b.full((0, 1, 2))
            x = b.u(1)
            osz, lsz = x >> 4, x & 15
            x = b.u(1)
            bsz, isz = x >> 4, (x & 15) if v in (1, 2) else 0
            if any(n not in (0, 4, 8) for n in (osz, lsz, bsz, isz)):
                raise _Unidentified("iloc field size")
            count = b.u(2 if v < 2 else 4)
            for _ in range(count):
                iid = b.u(2 if v < 2 else 4)
                if iid == 0:
                    raise _Unidentified("iloc item ID 0")
                it = item(iid)
                if it.extents is not None:
                    raise _Unidentified("an item located twice")
                method = b.u(2) if v in (1, 2) else 0
                if method not in (0, 1):
                    raise _Unidentified("iloc construction method 2")
                b.u(2)                                  # data_reference
                base = b.u(bsz)
                exts = []
                for _ in range(b.u(2)):
                    b.u(isz)
                    off = base + b.u(osz)
                    exts.append((off, b.u(lsz)))
                it.extents = (method, exts)
        elif typ == b"iinf":
            v, _ = b.full((0, 1))
            count = b.u(2 if v == 0 else 4)
            entries = _boxes(data, b.pos, e)
            for _ in range(count):      # the first `count` boxes only
                t2, s2, e2 = next(entries, (None, 0, 0))
                if t2 is None:
                    raise _Unidentified("iinf holds fewer entries")
                if t2 != b"infe":
                    raise _Unidentified("a box other than infe in iinf")
                c = _Reader(data, s2, e2)
                iv, flags = c.u(1), c.u(3)
                if iv not in (2, 3):
                    raise _Unidentified("infe version")
                iid = c.u(2 if iv == 2 else 4)
                if iid == 0:
                    raise _Unidentified("infe item ID 0")
                it = item(iid)
                c.u(2)
                it.type = c.take(4)
                c.string()
        elif typ == b"iref":
            v, _ = b.u(1), b.u(3)
            if v > 1:                   # libavif skips other versions
                continue
            n = 2 if v == 0 else 4
            while b.pos < e:            # fields read on past an entry's
                start = b.pos           # size, not to its end
                size = b.u(4)
                t2 = b.take(4)
                if size < 8 or start + size > e:
                    raise _Unidentified("iref entry size")
                src = b.u(n)
                dsts = [b.u(n) for _ in range(b.u(2))]
                if src == 0 or 0 in dsts:
                    raise _Unidentified("iref item ID 0")
                if t2 == b"auxl" and dsts:
                    item(src).aux_for = dsts[0]
                elif t2 == b"prem":
                    item(src).prem_by += dsts
                elif t2 == b"dimg":     # derived images point the other way
                    for k, d in enumerate(dsts):
                        item(d).dimg_for = (src, k)
        elif typ == b"iprp":
            for t2, s2, e2 in _boxes(data, s, e):
                if t2 == b"ipco":
                    props = list(_boxes(data, s2, e2))
                    for t3, s3, e3 in props:
                        _check_property(data, t3, s3, e3)
                elif t2 == b"ipma":
                    c = _Reader(data, s2, e2)
                    v2, flags = c.full((0, 1))
                    for _ in range(c.u(4)):
                        it = item(c.u(2 if v2 == 0 else 4))
                        if it.props:
                            raise _Unidentified("an item in two ipma")
                        for _ in range(c.u(1)):
                            x = c.u(2 if flags & 1 else 1)
                            ess = bool(x >> (15 if flags & 1 else 7))
                            idx = x & (0x7FFF if flags & 1 else 0x7F)
                            if idx == 0:
                                if ess:
                                    raise _Unidentified("essential index 0")
                                continue
                            if idx > len(props):
                                raise _Unidentified("property index")
                            t3, s3, e3 = props[idx - 1]
                            it.props.append((t3, s3, e3, ess))
                            if ess and t3 not in _ESSENTIAL_OK:
                                it.unsupported_essential = True
    return items, primary, idat


def _check_property(data: bytes, typ: bytes, s: int, e: int) -> None:
    """What libavif's ipco parse refuses in a property, whatever item it
    belongs to."""
    r = _Reader(data, s, e)
    if typ in (b"ispe", b"pixi", b"auxC"):
        r.full((0,))
    if typ == b"av1C" and r.u(1) != 0x81:
        raise _Unidentified("av1C marker or version")
    if typ == b"colr":
        _nclx([(typ, s, e)], data)


# Properties libavif may see marked essential (avifParseItemProperty...).
_ESSENTIAL_OK = (b"av1C", b"ispe", b"pixi", b"colr", b"auxC", b"clap",
                 b"irot", b"imir", b"pasp", b"a1op", b"lsel")


def _prop(item: _Item, typ: bytes):
    for t, s, e, _ in item.props:
        if t == typ:
            return s, e
    return None


def _ispe(data: bytes, item: _Item) -> tuple[int, int]:
    ispe = _prop(item, b"ispe")
    if ispe is None:
        raise _Unidentified(f"item {item.id} has no ispe")
    r = _Reader(data, *ispe)
    r.full((0,))
    return r.u(4), r.u(4)


def _item_props(data: bytes, item: _Item, depth_check: bool = True) -> dict:
    """ispe, pixi and nclx of an item, as avifDecoderItemValidateProperties
    wants them."""
    out = {"size": _ispe(data, item)}
    av1c = _prop(item, b"av1C")
    out["av1C"] = av1c is not None
    if av1c is None:
        return out
    r = _Reader(data, *av1c)
    if r.u(1) != 0x81:
        raise _Unidentified("av1C marker or version")
    r.u(1)
    x = r.u(1)
    depth = 12 if x & 0x60 == 0x60 else 10 if x & 0x40 else 8
    pixi = _prop(item, b"pixi")
    if pixi is not None:
        r = _Reader(data, *pixi)
        r.full((0,))
        n = r.u(1)
        if n == 0 or n > 4:
            raise _Failed("pixi plane count")
        depths = [r.u(1) for _ in range(n)]
        if len(set(depths)) > 1:
            raise _Failed("pixi depths differ")
        if depth_check and depths[0] != depth:
            raise _Unidentified("pixi depth differs from av1C's")
        out["pixi_planes"] = n
    out["mono"] = bool(x & 0x10)
    nclx = _nclx(((t, s, e) for t, s, e, _ in item.props), data)
    if nclx is not None:
        out["nclx"] = nclx
    return out


def _nclx(props, data: bytes):
    """(primaries, transfer, matrix, full range) of the first colr nclx
    among (type, start, end) boxes, or None."""
    for t, s, e in props:
        if t == b"colr" and e - s >= 4 and data[s:s + 4] == b"nclx":
            if e - s < 11:
                raise _Unidentified("short nclx")
            cp, tc, mc = struct.unpack(">HHH", data[s + 4:s + 10])
            if data[s + 10] & 0x7F:
                raise _Unidentified("nclx reserved bits")
            return cp, tc, mc, data[s + 10] >> 7
    return None


def _item_data(data: bytes, item: _Item, idat) -> bytes:
    """The item's bytes. Items larger than the file are refused in the
    parse, extents past its end in the decode (as libavif)."""
    if item.extents is None:
        raise _Failed(f"item {item.id} has no location")
    method, exts = item.extents
    if sum(n for _, n in exts) > len(data):
        raise _Unidentified("an item larger than the file")
    if method == 1:
        if idat is None:
            raise _Failed("construction method 1 without an idat")
        base, end = idat
    else:
        base, end = 0, len(data)
    parts = []
    for off, length in exts:
        if base + off + length > end:
            raise _Failed("item data past the end of the file")
        parts.append(data[base + off:base + off + length])
    if not sum(map(len, parts)):
        raise _Failed("missing or empty image item")
    return b"".join(parts)


def _hdlr(data: bytes, s: int, e: int) -> bytes:
    """An hdlr box's handler type, as libavif parses it."""
    r = _Reader(data, s, e)
    r.full((0,))
    if r.u(4) != 0:
        raise _Unidentified("hdlr pre_defined is not 0")
    handler = r.take(4)
    r.take(12)
    r.string()
    return handler


def _parse_tracks(data: bytes, start: int, end: int):
    """The _Tracks of a moov box, with libavif's checks of the boxes it
    reads (avifParseTrackBox and its children): every trak needs a tkhd
    of version 0 or 1 and a size within libavif's limits, an auxi is a
    full box of version 0 with a terminated URN."""
    tracks = []
    for typ, s, e in _boxes(data, start, end):
        if typ != b"trak":
            continue
        tid, handler, aux_for, size, av01 = 0, b"", 0, None, False
        nclx, prem, urn, has_av1c = None, [], None, False
        timescale = 0
        chunk_offsets, sizes, stsc = [], [], []
        for t2, s2, e2 in _boxes(data, s, e):
            r = _Reader(data, s2, e2)
            if t2 == b"tkhd":
                v, _ = r.full((0, 1))
                r.take(8 if v == 0 else 16)
                tid = r.u(4)
                r.take(4 + (4 if v == 0 else 8) + 52)
                size = (r.u(4) >> 16, r.u(4) >> 16)
                w, h = size
                if not w or not h or w * h > SIZE_LIMIT \
                        or w > DIMENSION_LIMIT or h > DIMENSION_LIMIT:
                    raise _Unidentified(f"a track of {w}x{h}")
            elif t2 == b"tref":
                for t3, s3, e3 in _boxes(data, s2, e2):
                    ids = [int.from_bytes(data[k:k + 4], "big")
                           for k in range(s3, e3 - 3, 4)]
                    if t3 == b"auxl" and ids:
                        aux_for = ids[0]
                    elif t3 == b"prem":
                        prem += ids
            elif t2 == b"edts":
                kids = list(_boxes(data, s2, e2))
                if not kids or kids[0][0] != b"elst":
                    raise _Unidentified("edts without elst")
                r = _Reader(data, kids[0][1], kids[0][2])
                v, _ = r.full((0, 1))
                if r.u(4) != 1:
                    raise _Unidentified("elst entry count")
                if r.u(8 if v else 4) == 0:
                    raise _Unidentified("elst segment duration 0")
                r.take(12 if v else 8)
                if r.pos != r.end:
                    raise _Unidentified("elst size")
            elif t2 == b"mdia":
                for t3, s3, e3 in _boxes(data, s2, e2):
                    r = _Reader(data, s3, e3)
                    if t3 == b"mdhd":
                        v, _ = r.full((0, 1))
                        r.take(16 if v else 8)
                        timescale = r.u(4)
                    elif t3 == b"hdlr":
                        handler = _hdlr(data, s3, e3)
                    elif t3 == b"minf":
                        for t4, s4, e4 in _boxes(data, s3, e3):
                            if t4 != b"stbl":
                                continue
                            for t5, s5, e5 in _boxes(data, s4, e4):
                                r = _Reader(data, s5, e5)
                                if t5 == b"stsd":
                                    r.full((0, 1))
                                    count = r.u(4)
                                    entries = _boxes(data, r.pos, e5)
                                    for _ in range(count):
                                        t6, s6, e6 = next(entries,
                                                          (None, 0, 0))
                                        if t6 is None:
                                            raise _Unidentified("stsd")
                                        if t6 != b"av01" or av01:
                                            continue
                                        av01 = True
                                        # VisualSampleEntry: 78 bytes,
                                        # then its boxes.
                                        if e6 - s6 < 78:
                                            raise _Unidentified("stsd entry")
                                        props = list(_boxes(data, s6 + 78,
                                                            e6))
                                        for t7, s7, e7 in props:
                                            _check_property(data, t7, s7, e7)
                                            if t7 == b"auxi":
                                                r7 = _Reader(data, s7, e7)
                                                r7.full((0,))
                                                urn = r7.string()
                                        has_av1c = any(p[0] == b"av1C"
                                                       for p in props)
                                        nclx = _nclx(props, data)
                                elif t5 in (b"stco", b"co64"):
                                    r.full((0,))
                                    n = 4 if t5 == b"stco" else 8
                                    chunk_offsets = [r.u(n)
                                                     for _ in range(r.u(4))]
                                elif t5 == b"stsz":
                                    r.full((0,))
                                    fixed, count = r.u(4), r.u(4)
                                    sizes = ([fixed] * count if fixed else
                                             [r.u(4) for _ in range(count)])
                                elif t5 == b"stsc":
                                    r.full((0,))
                                    stsc = [(r.u(4), r.u(4), r.u(4))
                                            for _ in range(r.u(4))]
                                    firsts = [f for f, _, _ in stsc]
                                    if firsts and (firsts[0] != 1 or any(
                                            b <= a for a, b in
                                            zip(firsts, firsts[1:]))):
                                        raise _Unidentified("stsc")
                                elif t5 in (b"stss", b"stts"):
                                    r.full((0,))
                                    count = r.u(4)
                                    r.take(count * (4 if t5 == b"stss"
                                                    else 8))
        if size is None:
            raise _Unidentified("a trak without tkhd")
        tracks.append(_Track(tid, handler, aux_for, size, av01 and has_av1c,
                             av01, nclx, timescale, prem, urn,
                             (chunk_offsets, sizes, stsc)))
    return tracks


class _Track(NamedTuple):
    id: int
    handler: bytes
    aux_for: int
    size: tuple
    av1c: bool          # its av01 sample entry has an av1C
    av01: bool          # an av01 sample entry
    nclx: tuple | None
    timescale: int
    prem: list
    urn: bytes | None   # its av01 entry's auxi URN
    table: tuple        # (chunk offsets, sample sizes, stsc entries)

    def first_sample(self, data: bytes):
        """(offset, size) of the first sample, None without chunks, with
        libavif's checks of the sample table (avifCodecDecodeInputFill...
        FromSampleTable), made only for a track libavif decodes."""
        chunk_offsets, sizes, stsc = self.table
        if not chunk_offsets:
            return None
        declared = sum(next((n for f, n, _ in reversed(stsc) if f <= c), 0)
                       for c in range(1, len(chunk_offsets) + 1))
        if declared != len(sizes):
            raise _Unidentified("stsc and stsz disagree")
        samples = _samples(chunk_offsets, sizes, stsc)
        for off, n in samples:
            if n == 0 or off + n > len(data):
                raise _Unidentified("a sample past the end of the file")
        return samples[0] if samples else None


def _samples(chunk_offsets, sizes, stsc):
    """[(offset, size)] of a track's samples from its stco/co64, stsz and
    stsc (chunks numbered from 1, each run of chunks holding
    samples_per_chunk samples back to back)."""
    out, k = [], 0
    for c, off in enumerate(chunk_offsets, 1):
        per = 0
        for first, n, _ in stsc:
            if first <= c:
                per = n
        for _ in range(per):
            if k >= len(sizes):
                return out
            out.append((off, sizes[k]))
            off += sizes[k]
            k += 1
    return out


def _parse(data: bytes):
    """The colour and alpha AV1 payloads and what the conversion needs:
    (color bytes, alpha bytes or None, size, nclx or None, premultiplied).
    """
    ftyp = meta = moov = None
    need_meta = need_moov = False
    for typ, s, e in _boxes(data, 0, len(data), top=True):
        if typ in (b"ftyp", b"meta", b"moov") and e > len(data):
            raise _Unidentified("truncated box")
        if typ == b"ftyp":
            if ftyp is not None:
                raise _Unidentified("two ftyp boxes")
            if e - s < 8 or (e - s - 8) % 4:
                raise _Unidentified("ftyp size")
            brands = [data[s:s + 4]] + [data[k:k + 4]
                                        for k in range(s + 8, e, 4)]
            if b"avif" not in brands and b"avis" not in brands:
                raise _Unidentified("ftyp names neither avif nor avis")
            ftyp = data[s:s + 4]
            need_meta = b"avif" in brands
            need_moov = b"avis" in brands
        elif typ == b"meta":
            if meta is not None:
                raise _Unidentified("two meta boxes")
            meta = _parse_meta(data, s, e)
        elif typ == b"moov":
            if moov is not None:
                raise _Unidentified("two moov boxes")
            moov = _parse_tracks(data, s, e)
        if (ftyp is not None and (not need_meta or meta is not None)
                and (not need_moov or moov is not None)):
            break
        if e > len(data):
            raise _Unidentified("box past the end of the file")
    else:
        if ftyp is None:
            raise _Unidentified("no ftyp box")
        if (need_meta and meta is None) or (need_moov and moov is None):
            raise _Unidentified("the brands' meta or moov box is missing")
    use_tracks = ftyp == b"avis" or (ftyp != b"avif" and moov)
    if use_tracks and moov is not None:
        if meta is not None:    # libavif checks the primary item's
            _from_items(data, meta, props_only=True)    # properties too
        return _from_tracks(data, moov)
    if meta is None:
        raise _Unidentified("no meta box")
    return _from_items(data, meta)


class _Grid:
    """A grid item (HEIF 6.6.2.3): rows x cols tiles, their AV1 payloads
    in raster order, cropped to width x height."""

    def __init__(self, rows, cols, width, height, tiles, sizes):
        self.rows, self.cols = rows, cols
        self.width, self.height = width, height
        self.tiles, self.sizes = tiles, sizes      # payloads, tiles' ispe


def _grid(data: bytes, items: dict, it: _Item, idat):
    """The tiles of grid item `it` as libavif 1.3 reads them
    (avifParseImageGridBox, avifDecoderGenerateImageGridTiles), with its
    checks: (grid item, its tiles in dimg order)."""
    p = _item_data(data, it, idat)
    n = 4 if p[1:2] and p[1] & 1 else 2
    if p[0] != 0 or len(p) != 4 + 2 * n:
        raise _Failed("invalid image grid (version or payload size)")
    rows, cols = p[2] + 1, p[3] + 1
    w, h = (int.from_bytes(p[4 + k * n:4 + (k + 1) * n], "big")
            for k in (0, 1))
    if (not w or not h or w * h > SIZE_LIMIT or w > DIMENSION_LIMIT
            or h > DIMENSION_LIMIT):
        raise _Failed(f"invalid image grid (illegal or too large "
                      f"dimensions {w}x{h})")
    found = {t.dimg_for[1]: t for t in items.values()
             if t.dimg_for and t.dimg_for[0] == it.id}
    if sorted(found) != list(range(rows * cols)):
        raise _Failed(f"invalid image grid ({rows}x{cols} needs "
                      f"{rows * cols} tiles, {len(found)} were found)")
    tiles = [found[k] for k in range(rows * cols)]
    for t in tiles:
        if t.type != b"av01":
            raise _Failed("invalid image grid (a tile of unknown type)")
        if t.unsupported_essential:
            raise _Failed("invalid image grid (a tile with an unsupported "
                          "essential property)")
    if _prop(tiles[0], b"av1C") is None:
        raise _Failed("invalid image grid (the first tile is missing an "
                      "av1C property)")
    return rows, cols, w, h, tiles


def _av1c_fields(data: bytes, item: _Item) -> bytes:
    """An av1C's fields libavif compares between a grid's tiles (profile,
    level, tier, depth, monochrome, subsampling, sample position)."""
    s, e = _prop(item, b"av1C")
    if e - s < 4:
        raise _Unidentified("short av1C")
    return data[s + 1:s + 3]


def _grid_spec(data: bytes, items: dict, it: _Item, idat):
    """(_Grid, properties) of a grid item: libavif gives the grid the
    first tile's av1C and validates the grid's pixi against it; every
    tile needs an ispe and the first tile's av1C fields (the tiles' pixi
    and colr boxes are not read: nclx comes from the grid item alone)."""
    rows, cols, w, h, tiles = _grid(data, items, it, idat)
    first = _av1c_fields(data, tiles[0])
    for t in tiles:
        if _prop(t, b"av1C") is None or _av1c_fields(data, t) != first:
            raise _Unidentified("a tile's av1C differs from the first's")
    sizes = [_ispe(data, t) for t in tiles]
    adopted = _Item(it.id)
    adopted.props = [p for p in it.props if p[0] != b"av1C"] + [
        p for p in tiles[0].props if p[0] == b"av1C"][:1]
    props = _item_props(data, adopted)
    return (_Grid(rows, cols, w, h, [_item_data(data, t, idat)
                                     for t in tiles], sizes), props)


def _from_items(data: bytes, meta, props_only: bool = False):
    items, primary, idat = meta
    if primary is None or primary not in items or not items[primary].type:
        if props_only:
            return None
        raise _Failed("missing or empty image item")
    color = items[primary]
    if props_only:
        if color.type == b"av01":
            _item_props(data, color, depth_check=False)
        return None
    if color.type not in (b"av01", b"grid") or color.unsupported_essential:
        raise _Failed("missing or empty image item")
    if color.type == b"grid":
        color_data, cp = _grid_spec(data, items, color, idat)
    else:
        cp = _item_props(data, color)
        if not cp["av1C"]:
            raise _Failed("missing or empty image item")
        color_data = None
    alpha = None
    for it in items.values():
        if it.aux_for != primary or it.type not in (b"av01", b"grid"):
            continue
        if (it.type == b"av01" and (_prop(it, b"av1C") is None
                                    or not it.extents
                                    or not sum(n for _, n in it.extents[1]))):
            continue                    # libavif sees no alpha
        if it.type == b"grid" and it.unsupported_essential:
            continue
        auxc = _prop(it, b"auxC")
        if auxc is None:
            continue
        r = _Reader(data, *auxc)
        r.full((0,))
        if r.string() not in ALPHA_URNS:
            continue
        alpha = it
        break
    alpha_data = None
    if alpha is not None and alpha.type == b"grid":
        alpha_data = _grid_spec(data, items, alpha, idat)[0]
    elif alpha is not None:
        _item_props(data, alpha)
        alpha_data = _item_data(data, alpha, idat)
    prem = alpha is not None and alpha.id in color.prem_by
    if color_data is None:
        color_data = _item_data(data, color, idat)
    return color_data, alpha_data, cp["size"], cp.get("nclx"), prem


def _from_tracks(data: bytes, tracks):
    """libavif's choice of tracks: the colour track is the first av01
    track with an id, chunks and no auxl; the alpha track an av01 track
    with chunks whose auxl names it and whose sample entry has no auxi or
    one with an alpha URN (its av1C is not needed)."""
    color = next((t for t in tracks if t.id and t.av01 and not t.aux_for
                  and t.table[0]), None)
    if color is None or not color.av1c:
        raise _Unidentified("no AV1 track")
    first = color.first_sample(data)
    if first is None:
        raise _Unidentified("no AV1 track")
    if color.timescale == 0:            # Pillow divides by it
        raise _Failed("a track timescale of 0")
    alpha = next((t for t in tracks if t.id and t.av01 and t.table[0]
                  and t.aux_for == color.id
                  and (t.urn is None or t.urn in ALPHA_URNS)), None)
    alpha_first = alpha.first_sample(data) if alpha else None
    if alpha is not None and alpha.size != color.size:
        raise _Failed("the alpha track's size differs (Decoding of alpha "
                      "plane failed)")

    def sample(first):
        off, size = first
        return data[off:off + size]

    return (sample(first), sample(alpha_first) if alpha_first else None,
            color.size, color.nclx, alpha is not None
            and alpha.id in color.prem)


_ERRORS = {-1: "corrupt AV1 data", -2: "unsupported", -3: "buffer"}


def _av1_call(lib, payload: bytes, buf, info, path: str):
    import ctypes

    msg = ctypes.create_string_buffer(256)
    rc = lib.tb_av1_decode(payload, len(payload),
                           None if buf is None else buf.ctypes.data,
                           0 if buf is None else buf.size, info.ctypes.data,
                           msg, 256)
    if rc == -2:
        raise NotImplementedError(f"{path}: {msg.value.decode()}: {ITEM}")
    if rc:
        raise _Failed(f"{msg.value.decode()} ({_ERRORS.get(rc, rc)})")


def _av1_header(lib, payload: bytes, path: str):
    """info of a payload from its headers alone (the frame not decoded)."""
    info = np.zeros(16, np.int64)
    _av1_call(lib, payload, None, info, path)
    return info


def _decode_av1(lib, payload: bytes, path: str):
    w, h, mono, ssx, ssy = (int(v) for v in _av1_header(lib, payload,
                                                        path)[:5])
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    buf = np.zeros(w * h + (0 if mono else 2 * cw * ch), np.uint8)
    info = np.zeros(16, np.int64)
    _av1_call(lib, payload, buf, info, path)
    planes = [buf[:w * h].reshape(h, w)]
    if not mono:
        planes += [buf[w * h:w * h + cw * ch].reshape(ch, cw),
                   buf[w * h + cw * ch:].reshape(ch, cw)]
    return planes, info


def _decode_grid(lib, g: _Grid, path: str):
    """Every tile decoded and stitched into one frame's planes, cropped to
    the grid's output size, with libavif's checks of the tiles
    (avifDecoderDataFillImageGrid): tiles alike in size, depth,
    subsampling, range and CICP, covering the canvas with the last row
    and column overlapping it, at least 64 samples a side, even where
    chroma is subsampled. A tile whose ispe differs from its frame, which
    libavif scales to the ispe, is refused. The checks read every tile's
    headers before any tile is decoded."""
    heads = [_av1_header(lib, t, path) for t in g.tiles]
    for tile, size in zip(heads, g.sizes):
        if (int(tile[0]), int(tile[1])) != size:
            raise _Failed(f"a tile's frame is {tile[0]}x{tile[1]}, its "
                          f"ispe {size[0]}x{size[1]}")
    if any(not np.array_equal(h[:10], heads[0][:10]) for h in heads):
        raise _Failed("invalid image grid (mismatched tiles)")
    tw, th, mono, ssx, ssy = (int(v) for v in heads[0][:5])
    W, H = g.width, g.height
    if tw * g.cols < W or th * g.rows < H:
        raise _Failed("invalid image grid (the tiles do not cover it)")
    if tw * (g.cols - 1) >= W or th * (g.rows - 1) >= H:
        raise _Failed("invalid image grid (the last row or column does "
                      "not overlap it)")
    if tw < 64 or th < 64:
        raise _Failed("invalid image grid (tile width or height cannot be "
                      "smaller than 64)")
    if not mono and ((ssx and (W % 2 or tw % 2))
                     or (ssy and (H % 2 or th % 2))):
        raise _Failed("invalid image grid (odd sizes where chroma is "
                      "subsampled)")
    frames = [_decode_av1(lib, t, path) for t in g.tiles]
    shapes = [(H, W)] + ([] if mono else 2 * [((H + ssy) >> ssy,
                                               (W + ssx) >> ssx)])
    out = [np.empty(shape, np.uint8) for shape in shapes]
    for k, (planes, _) in enumerate(frames):
        r, c = divmod(k, g.cols)
        for p, plane in enumerate(planes):
            sx, sy = (ssx, ssy) if p else (0, 0)
            x0, y0 = (c * tw) >> sx, (r * th) >> sy
            dst = out[p][y0:y0 + (th >> sy), x0:x0 + (tw >> sx)]
            dst[...] = plane[:dst.shape[0], :dst.shape[1]]
    info = frames[0][1].copy()
    info[0], info[1] = W, H
    info[15] = np.bitwise_or.reduce([f[1][15] for f in frames])
    return out, info


def _decode(lib, spec, path: str):
    """(planes, info) of an item's payload or of a _Grid."""
    if isinstance(spec, _Grid):
        return _decode_grid(lib, spec, path)
    return _decode_av1(lib, spec, path)


def read_avif(data: bytes, path: str = "<avif>") -> np.ndarray:
    """The (H, W, 3|4) uint8 pixels PIL gives for an AVIF file."""
    try:
        color, alpha, size, nclx, prem = _parse(data)
    except _Unidentified as e:
        raise UnidentifiedImageError(f"{path}: cannot identify image file "
                                     f"({e})") from None
    except _Failed as e:
        raise ValueError(f"{path}: {e}") from None
    w, h = size
    if w * h > SIZE_LIMIT or w > DIMENSION_LIMIT or h > DIMENSION_LIMIT:
        raise UnidentifiedImageError(f"{path}: {w}x{h} is past libavif's "
                                     "limits")
    check_image_size(w, h, path)
    lib = av1_library()
    try:
        planes, info = _decode(lib, color, path)
        a_planes = None
        if alpha is not None:
            a_planes, _ = _decode(lib, alpha, path)
        fw, fh, mono, ssx, ssy, seq_full, cp, tc, mc = (int(v)
                                                        for v in info[:9])
        if (fw, fh) != (w, h):
            raise _Failed(f"the frame is {fw}x{fh}, the item {w}x{h}")
        if a_planes is not None and a_planes[0].shape != (h, w):
            raise _Failed("the alpha frame's size differs")
        full = seq_full
        if nclx is not None:
            cp, tc, mc, full = nclx
    except _Failed as e:
        raise ValueError(f"{path}: {e}") from None
    channels = 4 if a_planes is not None else 3
    out = np.empty((h, w, channels), np.uint8)
    u = v = None
    if not mono:
        u, v = (np.ascontiguousarray(p) for p in planes[1:])
    y = np.ascontiguousarray(planes[0])
    a = np.ascontiguousarray(a_planes[0]) if a_planes is not None else None
    rc = lib.tb_avif_to_rgb(
        y.ctypes.data, None if u is None else u.ctypes.data,
        None if v is None else v.ctypes.data, w, h, ssx, ssy, full,
        None if a is None else a.ctypes.data, int(prem), out.ctypes.data,
        cp, mc)
    if rc:
        raise ValueError(f"{path}: {_ROUTE_ERRORS[rc]} (matrix coefficients "
                         f"{mc}, colour primaries {cp}; Reformat failed)")
    return out


# csrc/avif_reformat.inc's avif_route, which alone picks libavif's
# conversion from the matrix coefficients and primaries: its refusals.
_ROUTE_ERRORS = {-1: "libavif cannot convert these matrix coefficients",
                 -2: "identity matrix coefficients need 4:4:4"}


# info[15]'s bits (csrc/av1_decode.cpp's kTool*) and info[14]'s.
TOOLS = ("palette", "filter_intra", "cfl", "angle_delta", "tx64", "tx1d",
         "wht", "directional", "smooth", "paeth", "edge_upsample",
         "edge_filter", "adst", "segments", "delta_q", "qm",
         "ext_partition")
# info[15]'s bits above the block tools: the in-loop filters the frame
# used (csrc/av1_decode.cpp's kFilter*).
FILTERS = ("deblocking", "deblocking_13_tap", "deblocking_chroma",
           "delta_lf", "cdef", "cdef_chroma", "wiener", "sgrproj",
           "sgrproj_r0_zero", "sgrproj_r1_zero", "switchable")
LR_TYPES = ("none", "wiener", "sgrproj", "switchable")
# info[15]'s bits above the filters: intra block copy (a block that used
# it, its vector from the stack or the default one, a var-tx split, the
# inter transform type sets read, a sub-8x8 block's chroma), then film
# grain (applied, the AR lag, overlap, chroma scaling from luma, the
# restricted clip, luma grain alone, chroma grain alone).
INTRABC = ("intrabc", "stack_dv", "default_dv", "var_tx", "inter_tx_set_1",
           "inter_tx_set_2", "inter_tx_set_3", "sub8x8_chroma")
GRAIN = ("grain", "ar_lag_0", "ar_lag_1", "ar_lag_2", "ar_lag_3",
         "overlap", "chroma_from_luma", "restricted_clip", "luma_only",
         "chroma_only")
HEADER_FLAGS = ("qm", "segmentation", "delta_q", "screen_content",
                "delta_lf", "reduced_tx_set", "tx_mode_select",
                "disable_cdf_update")


def frame_info(data: bytes, path: str = "<avif>",
               headers_only: bool = False) -> dict:
    """What the colour frame's headers say (its loop filter sharpness,
    CDEF bits, restoration types and unit sizes among it)
    and (unless headers_only, which reads the OBUs up to the first frame
    header, the feature checks included) which block tools, in-loop
    filters, intra block copy paths and film grain its decode used. For a
    grid, "grid" is (rows, columns, tile width, tile height), the headers
    are the first tile's, "size" is the grid's output size and the tools
    are those of every tile."""
    try:
        color = _parse(data)[0]
    except (_Unidentified, _Failed) as e:
        raise ValueError(f"{path}: {e}") from None
    lib = av1_library()
    grid = None
    if headers_only:
        first = color.tiles[0] if isinstance(color, _Grid) else color
        try:
            info = _av1_header(lib, first, path)
        except _Failed as e:
            raise ValueError(f"{path}: {e}") from None
        if isinstance(color, _Grid):
            grid = (color.rows, color.cols, int(info[0]), int(info[1]))
            info[:2] = color.width, color.height
    else:
        try:
            info = _decode(lib, color, path)[1]
        except _Failed as e:
            raise ValueError(f"{path}: {e}") from None
        if isinstance(color, _Grid):
            grid = (color.rows, color.cols, *color.sizes[0])
    return {"size": (int(info[0]), int(info[1])), "grid": grid,
            "mono": bool(info[2]),
            "subsampling": (int(info[3]), int(info[4])),
            "full_range": bool(info[5]), "cicp": tuple(map(int, info[6:9])),
            "lossless": bool(info[11]), "tiles": int(info[12]),
            "sb128": bool(info[13]),
            "flags": {f for k, f in enumerate(HEADER_FLAGS)
                      if info[14] >> k & 1},
            "lf_sharpness": int(info[14] >> 8 & 7),
            "lr_unit_size": (64 << int(info[14] >> 11 & 3),
                             64 << int(info[14] >> 11 & 3)
                             >> int(info[14] >> 13 & 1)),
            "cdef_bits": int(info[14] >> 14 & 3),
            "lr_types": tuple(LR_TYPES[int(info[14] >> (16 + 2 * p) & 3)]
                              for p in range(1 if info[2] else 3)),
            "tools": {t for k, t in enumerate(TOOLS) if info[15] >> k & 1},
            "filters": {f for k, f in enumerate(FILTERS)
                        if info[15] >> (len(TOOLS) + k) & 1},
            "intrabc": {f for k, f in enumerate(INTRABC)
                        if info[15] >> (len(TOOLS) + len(FILTERS) + k) & 1},
            "grain": {f for k, f in enumerate(GRAIN)
                      if info[15] >> (len(TOOLS) + len(FILTERS)
                                      + len(INTRABC) + k) & 1}}
