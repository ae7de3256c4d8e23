"""The port's JPEG 2000 reader: the pixels PIL returns (Pillow 12.1, which
reads JPEG 2000 through OpenJPEG 2.5), bit for bit, without an imaging
library.

JPEG 2000 is what digital cinema, medical and map pipelines write, and
texture tools export it; the JAX package reads it through PIL. Three
layers, each as its original does it:
- PIL's plugin (Jpeg2KImagePlugin.py): _accept; the raw codestream's
  SIZ (_parse_codestream) or the JP2 header box (_parse_jp2_header,
  BoxReader) gives the size and the mode (L, LA, RGB, RGBA, I;16; P and
  PA from a pclr box; CMYK from colr 12) and a pclr box the palette, as
  ImagePalette.getcolor builds it; _parse_comment walks the main header.
  What PIL cannot identify passes the file on (UnidentifiedImageError).
- OpenJPEG (jp2.c, j2k.c): the JP2 boxes as opj_jp2_read_header reads
  them (a colr box sets the colour space: 16 sRGB, 17 grey, 18 sYCC, 12
  CMYK, 24 eYCC; anything else, an ICC profile or no colr box among
  them, leaves it unspecified), the main
  header's and the tile-parts' marker segments as opj_j2k_read_header
  and opj_j2k_read_tile_header read them (SIZ, COD, COC, QCD, QCC, RGN,
  POC, PPM, PPT, TLM, PLM, PLT, CRG, COM; COD and QCD apply to every
  component, COC and QCC to one, in the order read; a tile-part POC adds
  to the main header's), the tiles in the order their last tile-part
  completes them. Each tile's packets, tier 1, dequantisation, wavelets,
  colour transform and DC level shift are csrc/j2k_decode.cpp's.
- Pillow's decoder (Jpeg2KDecode.c): the colour space and component
  count pick an unpacker for the mode (no unpacker, more than four
  components or an unknown colour space: an error); each tile's samples
  are narrowed to 1, 2 or 4 bytes as OpenJPEG hands them over, then
  shifted to 8 bits (16 for I;16) with Pillow's rounding offset (which
  wraps 16-bit white to 0), sYCC converted by Pillow's YCbCr tables.
The JAX read_ldr then converts to RGB or RGBA as PIL converts (core/
tiff.to_read_ldr: grey replicated, 16-bit grey clipped at 255, a palette
expanded, CMYK by Convert.c's cmyk2rgb).

Refused with NotImplementedError naming ROADMAP item 22d, where PIL reads
the file: HTJ2K code-blocks (Part 15), Part 2 codestreams (Rsiz bit 15,
MCT/MCC/MCO/CBD markers), and the code-block styles no encoder of the
tests writes (selective arithmetic coding bypass, context reset,
termination on each pass, vertical causal contexts, predictable
termination, segmentation symbols). Everything else OpenJPEG refuses,
PIL refuses and so does this reader (ValueError).
"""

from __future__ import annotations

import struct

import numpy as np

from tracerboy_tpu_torch.core.codecs import j2k_library
from tracerboy_tpu_torch.core.image_io import (
    UnidentifiedImageError,
    check_image_size,
)

SOC_SIZ = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
ITEM = ("ROADMAP.md, Queue 1: item 22d, the JPEG 2000 features no encoder "
        "of the tests writes")

# csrc/j2k_decode.cpp's error codes.
ERRORS = {-1: "bad tile parameters", -2: "unknown progression order",
          -3: "a code-block segment runs past the tile's data",
          -4: "invalid bit number in a packet header",
          -5: "a code-block with 31 or more bit-planes",
          -6: "invalid precinct", -7: "MCT on components of unequal sizes",
          -8: "runaway zero bit-plane tag tree"}


def is_jpeg2000(data: bytes) -> bool:
    """PIL's _accept (Jpeg2KImagePlugin.py)."""
    return data.startswith(SOC_SIZ) or data.startswith(JP2_SIGNATURE)


class _Broken(Exception):
    """OpenJPEG or Pillow's decoder gave up (PIL's OSError)."""


class _Refused(Exception):
    """A feature the port does not read (ROADMAP item 22d)."""


# ----------------------------------------------------------------------------
# PIL's plugin


class _PilError(Exception):
    """What Image.open would raise: `identify` False for the errors it
    catches (SyntaxError, IndexError, TypeError, struct.error) and then
    tries the next plugin; True for the others, which it lets through."""

    def __init__(self, msg, passes_on):
        super().__init__(msg)
        self.passes_on = passes_on


class _File:
    """A file object over bytes: read, seek and tell as io.BytesIO."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def seek_cur(self, n: int) -> None:
        if self.pos + n < 0:
            raise _PilError("negative seek position", False)
        self.pos += n


class _BoxReader:
    """PIL's BoxReader."""

    def __init__(self, fp: _File, length: int = -1):
        self.fp = fp
        self.has_length = length >= 0
        self.length = length
        self.remaining_in_box = -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.pos + n > self.length:
            return False
        if self.remaining_in_box >= 0:
            return n <= self.remaining_in_box
        return True

    def _read_bytes(self, n: int) -> bytes:
        if not self._can_read(n):
            raise _PilError("Not enough data in header", True)
        data = self.fp.read(n)
        if len(data) < n:
            raise _PilError(f"Expected to read {n} bytes but only got "
                            f"{len(data)}.", False)
        if self.remaining_in_box > 0:
            self.remaining_in_box -= n
        return data

    def read_fields(self, fmt: str):
        return struct.unpack(fmt, self._read_bytes(struct.calcsize(fmt)))

    def read_boxes(self) -> "_BoxReader":
        size = self.remaining_in_box
        return _BoxReader(_File(self._read_bytes(size)), size)

    def has_next_box(self) -> bool:
        if self.has_length:
            return self.fp.pos + self.remaining_in_box < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining_in_box > 0:
            self.fp.seek_cur(self.remaining_in_box)
        self.remaining_in_box = -1
        lbox, tbox = self.read_fields(">I4s")
        if lbox == 1:
            lbox = self.read_fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise _PilError("Invalid header length", True)
        self.remaining_in_box = lbox - hlen
        return tbox


class _Palette:
    """ImagePalette with getcolor's slot allocation (colours deduplicated;
    an RGBA palette's slots counted in threes, as PIL counts them)."""

    def __init__(self, mode: str):
        self.mode = mode
        self.palette = bytearray()
        self.colors: dict = {}

    def getcolor(self, color: tuple) -> int:
        if self.mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                raise _PilError("cannot add non-opaque RGBA color to RGB "
                                "palette", False)
            color = color[:3]
        elif self.mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in self.colors:
            return self.colors[color]
        index = len(self.palette) // 3
        if index >= 256:
            raise _PilError("cannot allocate more than 256 colors", False)
        self.colors[color] = index
        if index * 3 < len(self.palette):
            self.palette = (self.palette[:index * 3] + bytes(color)
                            + self.palette[index * 3 + 3:])
        else:
            self.palette += bytes(color)
        return index

    def table(self) -> np.ndarray:
        """The colours P and PA convert through: (256, 3) uint8, the
        palette's bytes taken three at a time (an RGBA palette too, whose
        slots getcolor packs that way), black past them."""
        out = np.zeros((256, 3), np.uint8)
        n = min(len(self.palette) // 3, 256)
        out[:n] = np.frombuffer(bytes(self.palette[:3 * n]),
                                np.uint8).reshape(n, 3)
        return out


def _parse_codestream(fp: _File):
    """PIL's _parse_codestream: (size, mode) from the SIZ segment."""
    hdr = fp.read(2)
    if len(hdr) < 2:
        raise _PilError("short SIZ length", True)
    lsiz = struct.unpack(">H", hdr)[0]
    siz = hdr + fp.read(lsiz - 2)
    if len(siz) < 38:
        raise _PilError("short SIZ", True)
    (_, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
     csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        if len(siz) < 39:
            raise _PilError("short SIZ", True)
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise _PilError("unable to determine J2K image mode", True)
    return size, mode


def _parse_jp2_header(fp: _File):
    """PIL's _parse_jp2_header: (size, mode, palette)."""
    reader = _BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        if tbox == b"ftyp":
            reader.read_fields(">4s")
    if header is None:
        raise _PilError("no jp2h box (AssertionError)", False)
    size = mode = nc = palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc == 1:
                mode = "L"
            elif nc in (2, 3, 4):
                mode = {2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            max_bitdepth = max([0, *header.read_fields(">" + "B" * npc)])
            if max_bitdepth <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(tuple(header.read_fields(">" + "B" * npc)))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise _PilError("Malformed JP2 header", True)
    return size, mode, palette


def _parse_comment(fp: _File) -> None:
    """PIL's _parse_comment: the main header's markers up to SOT, EOC or
    a COM (its errors are PIL's)."""
    while True:
        marker = fp.read(2)
        if not marker:
            return
        if len(marker) < 2:
            raise _PilError("short marker (IndexError)", True)
        if marker[1] in (0x90, 0xD9):
            return
        hdr = fp.read(2)
        if len(hdr) < 2:
            raise _PilError("short marker length", True)
        length = struct.unpack(">H", hdr)[0]
        if marker[1] == 0x64:
            fp.read(length - 2)
            return
        fp.seek_cur(length - 2)


def pil_open(data: bytes):
    """Jpeg2KImageFile._open: (codec, size, mode, palette)."""
    fp = _File(data, 4)
    if data[:4] == SOC_SIZ:
        size, mode = _parse_codestream(fp)
        _parse_comment(fp)
        return "j2k", size, mode, None
    fp.pos = 12
    if data[:12] != JP2_SIGNATURE:
        raise _PilError("not a JPEG 2000 file", True)
    size, mode, palette = _parse_jp2_header(fp)
    if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
        hdr = fp.read(2)
        if len(hdr) < 2:
            raise _PilError("short SIZ length", True)
        fp.seek_cur(struct.unpack(">H", hdr)[0] - 2)
        _parse_comment(fp)
    return "jp2", size, mode, palette


# ----------------------------------------------------------------------------
# OpenJPEG: the JP2 boxes


JP2_STATE_SIGNATURE, JP2_STATE_FILE_TYPE, JP2_STATE_HEADER = 1, 2, 4
TOP_BOXES = (b"jP  ", b"ftyp", b"jp2h")
IMG_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")
COLOUR_SPACES = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}


class _Jp2:
    """opj_jp2_read_header's state."""

    def __init__(self):
        self.state = 0
        self.ihdr = None          # (w, h, nc, bpc)
        self.enumcs = 0
        self.has_colr = False
        self.pclr = None          # number of channels
        self.cmap = False
        self.cdef = False
        self.has_jp2h = False

    def box(self, kind: bytes, body: bytes) -> None:
        getattr(self, "_" + kind.decode("latin-1").strip())(body)

    def _jP(self, body):
        if self.state != 0:
            raise _Broken("the signature box must be the first box")
        if len(body) != 4 or body != b"\x0d\x0a\x87\x0a":
            raise _Broken("bad JP2 signature box")
        self.state |= JP2_STATE_SIGNATURE

    def _ftyp(self, body):
        if self.state != JP2_STATE_SIGNATURE:
            raise _Broken("the ftyp box must be the second box")
        if len(body) < 8 or (len(body) - 8) % 4:
            raise _Broken("bad ftyp box size")
        self.state |= JP2_STATE_FILE_TYPE

    def _jp2h(self, body):
        if not self.state & JP2_STATE_FILE_TYPE:
            raise _Broken("jp2h box before ftyp")
        pos, has_ihdr = 0, False
        while pos < len(body):
            left = len(body) - pos
            if left < 8:
                raise _Broken("box of less than 8 bytes in jp2h")
            length, kind = struct.unpack_from(">I4s", body, pos)
            hlen = 8
            if length == 1:
                if left < 16:
                    raise _Broken("short XL box in jp2h")
                hi, length = struct.unpack_from(">II", body, pos + 8)
                if hi:
                    raise _Broken("box above 2^32 bytes")
                hlen = 16
            if length == 0:
                raise _Broken("box of undefined size in jp2h")
            if length < hlen or length > left:
                raise _Broken("inconsistent box length in jp2h")
            if kind in IMG_BOXES:
                self.box(kind, body[pos + hlen:pos + length])
            has_ihdr |= kind == b"ihdr"
            pos += length
        if not has_ihdr:
            raise _Broken("jp2h box without ihdr")
        self.state |= JP2_STATE_HEADER
        self.has_jp2h = True

    def _ihdr(self, body):
        if self.ihdr is not None:
            return
        if len(body) != 14:
            raise _Broken("bad ihdr box size")
        h, w, nc, bpc = struct.unpack_from(">IIHB", body)
        if h < 1 or w < 1 or nc < 1 or nc > 16384:
            raise _Broken("bad ihdr values")
        self.ihdr = (w, h, nc, bpc)

    def _colr(self, body):
        if len(body) < 3:
            raise _Broken("bad colr box size")
        if self.has_colr:
            return
        meth = body[0]
        if meth == 1:
            if len(body) < 7:
                raise _Broken("bad colr box size")
            self.enumcs = struct.unpack_from(">I", body, 3)[0]
            self.has_colr = True
        elif meth == 2:
            self.has_colr = True

    def _bpcc(self, body):
        nc = self.ihdr[2] if self.ihdr else 0
        if len(body) != nc:
            raise _Broken("bad bpcc box size")

    def _pclr(self, body):
        if self.pclr is not None or len(body) < 3:
            raise _Broken("bad pclr box")
        ne, npc = struct.unpack_from(">HB", body)
        if ne == 0 or ne > 1024 or npc == 0 or len(body) < 3 + npc:
            raise _Broken("bad pclr box")
        sizes = [min(((b & 0x7F) + 1 + 7) >> 3, 4) for b in body[3:3 + npc]]
        if len(body) < 3 + npc + ne * sum(sizes):
            raise _Broken("short pclr box")
        self.pclr = npc

    def _cmap(self, body):
        if self.pclr is None:
            raise _Broken("cmap box before pclr")
        if self.cmap:
            raise _Broken("second cmap box")
        if len(body) < 4 * self.pclr:
            raise _Broken("short cmap box")
        self.cmap = True

    def _cdef(self, body):
        if self.cdef or len(body) < 2:
            raise _Broken("bad cdef box")
        n = struct.unpack_from(">H", body)[0]
        if n == 0 or len(body) < 2 + 6 * n:
            raise _Broken("bad cdef box")
        self.cdef = True


def _read_jp2(data: bytes):
    """opj_jp2_read_header_procedure: (the codestream's offset, _Jp2)."""
    jp2 = _Jp2()
    pos = 0
    while True:
        if len(data) - pos < 8:
            break
        length, kind = struct.unpack_from(">I4s", data, pos)
        pos += 8
        nread = 8
        if length == 0:
            length = len(data) - pos + 8
        elif length == 1:
            if len(data) - pos < 8:
                break
            hi, length = struct.unpack_from(">II", data, pos)
            pos += 8
            nread = 16
            if hi:
                break
        if kind == b"jp2c":
            if not jp2.state & JP2_STATE_HEADER:
                raise _Broken("codestream box before jp2h")
            break
        if length < nread:
            raise _Broken("invalid box size")
        size = length - nread
        if kind in TOP_BOXES or kind in IMG_BOXES:
            if kind not in TOP_BOXES and not jp2.state & JP2_STATE_HEADER:
                if size > len(data) - pos:
                    raise _Broken("cannot skip a box")
                pos += size
                continue
            if size > len(data) - pos:
                raise _Broken("box larger than the file")
            if size:
                jp2.box(kind, data[pos:pos + size])
            pos += size
        else:
            if not jp2.state & JP2_STATE_SIGNATURE:
                raise _Broken("first box must be the signature box")
            if not jp2.state & JP2_STATE_FILE_TYPE:
                raise _Broken("second box must be the ftyp box")
            if size > len(data) - pos:
                raise _Broken("cannot skip a box")
            pos += size
    if not jp2.has_jp2h or jp2.ihdr is None:
        raise _Broken("JP2 without jp2h or ihdr")
    return pos, jp2


# ----------------------------------------------------------------------------
# OpenJPEG: the codestream


MS = dict(SOC=0xFF4F, SOT=0xFF90, SOD=0xFF93, EOC=0xFFD9, SIZ=0xFF51,
          COD=0xFF52, COC=0xFF53, RGN=0xFF5E, QCD=0xFF5C, QCC=0xFF5D,
          POC=0xFF5F, TLM=0xFF55, PLM=0xFF57, PLT=0xFF58, PPM=0xFF60,
          PPT=0xFF61, SOP=0xFF91, CRG=0xFF63, COM=0xFF64, MCT=0xFF74,
          CBD=0xFF78, CAP=0xFF50, CPF=0xFF59, MCC=0xFF75, MCO=0xFF77)
ST_MHSIZ, ST_MH, ST_TPHSOT, ST_TPH = 0x02, 0x04, 0x08, 0x10
ST_NEOC, ST_DATA, ST_EOC = 0x40, 0x80, 0x100
# Marker -> the states it may appear in (j2k_memory_marker_handler_tab).
STATES = {MS["SOT"]: ST_MH | ST_TPHSOT, MS["COD"]: ST_MH | ST_TPH,
          MS["COC"]: ST_MH | ST_TPH, MS["RGN"]: ST_MH | ST_TPH,
          MS["QCD"]: ST_MH | ST_TPH, MS["QCC"]: ST_MH | ST_TPH,
          MS["POC"]: ST_MH | ST_TPH, MS["SIZ"]: ST_MHSIZ,
          MS["TLM"]: ST_MH, MS["PLM"]: ST_MH, MS["PLT"]: ST_TPH,
          MS["PPM"]: ST_MH, MS["PPT"]: ST_TPH, MS["SOP"]: 0,
          MS["CRG"]: ST_MH, MS["COM"]: ST_MH | ST_TPH,
          MS["MCT"]: ST_MH | ST_TPH, MS["CBD"]: ST_MH, MS["CAP"]: ST_MH,
          MS["CPF"]: ST_MH, MS["MCC"]: ST_MH | ST_TPH,
          MS["MCO"]: ST_MH | ST_TPH}
UNKNOWN_STATES = ST_MH | ST_TPH
HT_CBLK_STYLE = 0x40


def _tccp():
    return dict(numres=1, cblkw=2, cblkh=2, cblksty=0, qmfbid=0,
                prc=[(15, 15)] * 33, qntsty=0, numgbits=0,
                steps=[(0, 0)] * 97, roishift=0)


def _tcp(numcomps):
    return dict(csty=0, prg=0, numlayers=0, mct=0, pocs=[],
                tccps=[_tccp() for _ in range(numcomps)], ppt={},
                data=None, cur_tp=-1, nb_tp=0)


def _copy_tcp(t):
    out = dict(t)
    out["pocs"] = list(t["pocs"])
    out["tccps"] = [dict(c) for c in t["tccps"]]
    out["ppt"] = {}
    return out


class _J2k:
    """OpenJPEG's codestream decoder state over the file's bytes: the main
    header on construction, then read_tile_header / the tile's data as
    opj_read_tile_header and opj_decode_tile_data hand them to Pillow."""

    def __init__(self, data: bytes, pos: int, ihdr=None):
        self.data, self.pos = data, pos
        self.ppm = None
        self.ppm_pos = 0
        self.state = 0
        self.can_decode = False
        self.last_tile_part = False
        self.sot_length = 0
        self.current_tile = 0
        self._main_header(ihdr)

    # -- stream
    def left(self) -> int:
        return len(self.data) - self.pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def read_marker(self) -> int:
        b = self.read(2)
        if len(b) != 2:
            raise _Broken("stream too short")
        return struct.unpack(">H", b)[0]

    def _segment(self, marker: int, body: bytes) -> None:
        handler = getattr(self, "_" + next(k for k, v in MS.items()
                                           if v == marker).lower(), None)
        if handler is not None:
            handler(body)

    def _tcp_now(self):
        return (self.tcps[self.current_tile] if self.state == ST_TPH
                else self.default)

    # -- main header
    def _main_header(self, ihdr) -> None:
        if self.read(2) != b"\xff\x4f":
            raise _Broken("expected a SOC marker")
        self.state = ST_MHSIZ
        self.ihdr = ihdr
        self.siz = None
        marker = self.read_marker()
        has = set()
        while marker != MS["SOT"]:
            if marker < 0xFF00:
                raise _Broken(f"a marker was expected, not {marker:#06x}")
            if marker not in STATES:
                marker = self._skip_unknown()
                if marker == MS["SOT"]:
                    break
            has.add(marker)
            if not self.state & STATES[marker]:
                raise _Broken(f"marker {marker:#06x} out of place")
            size = self.read(2)
            if len(size) != 2:
                raise _Broken("stream too short")
            n = struct.unpack(">H", size)[0]
            if n < 2:
                raise _Broken("invalid marker size")
            body = self.read(n - 2)
            if len(body) != n - 2:
                raise _Broken("stream too short")
            self._segment(marker, body)
            marker = self.read_marker()
        for need in ("SIZ", "COD", "QCD"):
            if MS[need] not in has:
                raise _Broken(f"no {need} marker in the main header")
        if self.ppm is not None:
            self._merge_ppm()
        self.state = ST_TPHSOT
        self.tcps = [_copy_tcp(self.default) for _ in range(self.ntiles)]

    def _skip_unknown(self) -> int:
        """opj_j2k_read_unk: 2-byte steps to the next known marker."""
        while True:
            b = self.read(2)
            if len(b) != 2:
                raise _Broken("stream too short")
            m = struct.unpack(">H", b)[0]
            if m >= 0xFF00:
                if not self.state & STATES.get(m, UNKNOWN_STATES):
                    raise _Broken("marker out of place")
                if m in STATES:
                    return m

    def _siz(self, b: bytes) -> None:
        if len(b) < 36 or (len(b) - 36) % 3:
            raise _Broken("bad SIZ marker size")
        (rsiz, x1, y1, x0, y0, tdx, tdy, tx0, ty0,
         nc) = struct.unpack_from(">HIIIIIIIIH", b)
        if nc > 16384 or nc != (len(b) - 36) // 3:
            raise _Broken("bad SIZ component count")
        if x0 >= x1 or y0 >= y1:
            raise _Broken("SIZ: negative or zero image size")
        if tdx == 0 or tdy == 0:
            raise _Broken("SIZ: invalid tile size")
        if tx0 > x0 or ty0 > y0 or tx0 + tdx <= x0 or ty0 + tdy <= y0:
            raise _Broken("SIZ: illegal tile offset")
        if self.ihdr and (self.ihdr[0] != x1 - x0 or self.ihdr[1] != y1 - y0):
            raise _Broken("SIZ size differs from ihdr")
        comps = []
        for i in range(nc):
            ssiz, dx, dy = b[36 + 3 * i:39 + 3 * i]
            prec, sgnd = (ssiz & 0x7F) + 1, ssiz >> 7
            if dx < 1 or dy < 1:
                raise _Broken("SIZ: bad subsampling")
            if prec > 31:
                raise _Broken("SIZ: precision above 31")
            comps.append(dict(prec=prec, sgnd=sgnd, dx=dx, dy=dy))
        tw = -(-(x1 - tx0) // tdx)
        th = -(-(y1 - ty0) // tdy)
        if tw == 0 or th == 0 or tw > 65535 // th:
            raise _Broken("SIZ: invalid number of tiles")
        if rsiz & 0x8000:
            raise _Refused("a Part 2 codestream (Rsiz bit 15)")
        self.siz = dict(rsiz=rsiz, x0=x0, y0=y0, x1=x1, y1=y1, tdx=tdx,
                        tdy=tdy, tx0=tx0, ty0=ty0, tw=tw, th=th)
        self.comps = comps
        self.ntiles = tw * th
        self.default = _tcp(nc)
        self.state = ST_MH

    def _spcod(self, tccp: dict, b: bytes, csty: int) -> int:
        """opj_j2k_read_SPCod_SPCoc into tccp; bytes read."""
        if len(b) < 5:
            raise _Broken("short SPcod")
        numres = b[0] + 1
        if numres > 33:
            raise _Broken("too many resolutions")
        cblkw, cblkh = b[1] + 2, b[2] + 2
        if cblkw > 10 or cblkh > 10 or cblkw + cblkh > 12:
            raise _Broken("invalid code-block size")
        cblksty, qmfbid = b[3], b[4]
        if cblksty & 0x80:
            raise _Broken("mixed HT code-blocks")
        if qmfbid > 1:
            raise _Broken("invalid wavelet")
        prc = [(15, 15)] * 33
        n = 5
        if csty & 1:
            if len(b) < 5 + numres:
                raise _Broken("short SPcod")
            prc = []
            for i in range(numres):
                v = b[5 + i]
                if i and ((v & 0xF) == 0 or (v >> 4) == 0):
                    raise _Broken("invalid precinct size")
                prc.append((v & 0xF, v >> 4))
            n += numres
        tccp.update(numres=numres, cblkw=cblkw, cblkh=cblkh,
                    cblksty=cblksty, qmfbid=qmfbid, prc=prc)
        return n

    def _cod(self, b: bytes) -> None:
        tcp = self._tcp_now()
        if len(b) < 5:
            raise _Broken("short COD")
        csty, prg, numlayers, mct = struct.unpack_from(">BBHB", b)
        if csty & ~0x07:
            raise _Broken("unknown Scod value")
        if prg > 4:
            prg = -1
        if numlayers < 1:
            raise _Broken("invalid number of layers")
        if mct > 1:
            raise _Broken("invalid multiple component transformation")
        tcp.update(csty=csty, prg=prg, numlayers=numlayers, mct=mct)
        first = dict(tcp["tccps"][0])
        if self._spcod(first, b[5:], csty) != len(b) - 5:
            raise _Broken("bad COD size")
        for t in tcp["tccps"]:
            for k in ("numres", "cblkw", "cblkh", "cblksty", "qmfbid", "prc"):
                t[k] = first[k]

    def _comp_index(self, b: bytes):
        room = 1 if len(self.comps) <= 256 else 2
        if len(b) < room:
            raise _Broken("short component index")
        return int.from_bytes(b[:room], "big"), room

    def _coc(self, b: bytes) -> None:
        tcp = self._tcp_now()
        compno, room = self._comp_index(b)
        if len(b) < room + 1 or compno >= len(self.comps):
            raise _Broken("bad COC")
        if self._spcod(tcp["tccps"][compno], b[room + 1:], b[room]) != \
                len(b) - room - 1:
            raise _Broken("bad COC size")

    def _sqcd(self, tccp: dict, b: bytes) -> int:
        if len(b) < 1:
            raise _Broken("short SQcd")
        qntsty, numgbits = b[0] & 0x1F, b[0] >> 5
        steps = list(tccp["steps"])
        if qntsty == 0:
            n = len(b) - 1
            for i in range(min(n, 97)):
                steps[i] = (b[1 + i] >> 3, 0)
            used = 1 + n
        else:
            n = 1 if qntsty == 1 else (len(b) - 1) // 2
            if len(b) < 1 + 2 * n:
                raise _Broken("short SQcd")
            for i in range(min(n, 97)):
                v = struct.unpack_from(">H", b, 1 + 2 * i)[0]
                steps[i] = (v >> 11, v & 0x7FF)
            used = 1 + 2 * n
            if qntsty == 1:
                e0, m0 = steps[0]
                for i in range(1, 97):
                    steps[i] = (max(e0 - (i - 1) // 3, 0), m0)
        tccp.update(qntsty=qntsty, numgbits=numgbits, steps=steps)
        return used

    def _qcd(self, b: bytes) -> None:
        tcp = self._tcp_now()
        first = dict(tcp["tccps"][0])
        if self._sqcd(first, b) != len(b):
            raise _Broken("bad QCD size")
        for t in tcp["tccps"]:
            t.update(qntsty=first["qntsty"], numgbits=first["numgbits"],
                     steps=first["steps"])

    def _qcc(self, b: bytes) -> None:
        tcp = self._tcp_now()
        compno, room = self._comp_index(b)
        if compno >= len(self.comps):
            raise _Broken("bad QCC component")
        if self._sqcd(tcp["tccps"][compno], b[room:]) != len(b) - room:
            raise _Broken("bad QCC size")

    def _rgn(self, b: bytes) -> None:
        tcp = self._tcp_now()
        room = 1 if len(self.comps) <= 256 else 2
        if len(b) != 2 + room:
            raise _Broken("bad RGN size")
        compno = int.from_bytes(b[:room], "big")
        if compno >= len(self.comps):
            raise _Broken("bad RGN component")
        tcp["tccps"][compno]["roishift"] = b[room + 1]

    def _poc(self, b: bytes) -> None:
        tcp = self._tcp_now()
        room = 1 if len(self.comps) <= 256 else 2
        chunk = 5 + 2 * room
        n = len(b) // chunk
        if n == 0 or len(b) % chunk:
            raise _Broken("bad POC size")
        if len(tcp["pocs"]) + n >= 32:
            raise _Broken("too many POCs")
        pocs = list(tcp["pocs"])
        for i in range(n):
            c = b[i * chunk:(i + 1) * chunk]
            resno0 = c[0]
            compno0 = int.from_bytes(c[1:1 + room], "big")
            layno1 = min(struct.unpack_from(">H", c, 1 + room)[0],
                         tcp["numlayers"])
            resno1 = c[3 + room]
            compno1 = min(int.from_bytes(c[4 + room:4 + 2 * room], "big"),
                          len(self.comps))
            prg = c[4 + 2 * room]
            pocs.append((resno0, compno0, layno1, resno1, compno1, prg))
        tcp["pocs"] = pocs

    def _tlm(self, b: bytes) -> None:
        if len(b) < 2:
            raise _Broken("bad TLM")
        st, sp = (b[1] >> 4) & 3, (b[1] >> 6) & 1
        if st == 3 or (len(b) - 2) % (st + 2 * (sp + 1)):
            raise _Broken("bad TLM")

    def _plm(self, b: bytes) -> None:
        if len(b) < 1:
            raise _Broken("bad PLM")

    def _plt(self, b: bytes) -> None:
        if len(b) < 1:
            raise _Broken("bad PLT")
        pending = 0
        for v in b[1:]:
            pending = (pending | (v & 0x7F)) << 7 if v & 0x80 else 0
        if pending:
            raise _Broken("bad PLT")

    def _ppm(self, b: bytes) -> None:
        if len(b) < 2:
            raise _Broken("bad PPM")
        if self.ppm is None:
            self.ppm = {}
        if b[0] in self.ppm:
            raise _Broken("Zppm read twice")
        self.ppm[b[0]] = b[1:]

    def _merge_ppm(self) -> None:
        out = bytearray()
        remaining = 0
        for z in sorted(self.ppm):
            chunk = self.ppm[z]
            if remaining >= len(chunk):
                remaining -= len(chunk)
                out += chunk
                continue
            out += chunk[:remaining]
            pos = remaining
            remaining = 0
            while pos < len(chunk):
                if len(chunk) - pos < 4:
                    raise _Broken("not enough bytes to read Nppm")
                n = struct.unpack_from(">I", chunk, pos)[0]
                pos += 4
                out += chunk[pos:pos + n]
                if len(chunk) - pos >= n:
                    pos += n
                else:
                    remaining = n - (len(chunk) - pos)
                    pos = len(chunk)
        if remaining:
            raise _Broken("corrupted PPM markers")
        self.ppm = bytes(out)

    def _ppt(self, b: bytes) -> None:
        if len(b) < 2:
            raise _Broken("bad PPT")
        if self.ppm is not None:
            raise _Broken("PPT after PPM")
        tcp = self.tcps[self.current_tile]
        if b[0] in tcp["ppt"]:
            raise _Broken("Zppt read twice")
        tcp["ppt"][b[0]] = b[1:]

    def _crg(self, b: bytes) -> None:
        if len(b) != 4 * len(self.comps):
            raise _Broken("bad CRG")

    def _mct(self, b):
        raise _Refused("Part 2 multiple component transform markers")

    _mcc = _mco = _cbd = _mct

    def _sot(self, b: bytes) -> None:
        if len(b) != 8:
            raise _Broken("bad SOT size")
        tile, psot, tpsot, tnsot = struct.unpack(">HIBB", b)
        if tile >= self.ntiles:
            raise _Broken("invalid tile number")
        self.current_tile = tile
        tcp = self.tcps[tile]
        if tcp["cur_tp"] + 1 != tpsot:
            raise _Broken("invalid tile-part index")
        tcp["cur_tp"] = tpsot
        if psot and psot < 14 and psot != 12:
            raise _Broken("invalid Psot")
        if psot == 0:
            self.last_tile_part = True
        if tcp["nb_tp"] and tpsot >= tcp["nb_tp"]:
            self.last_tile_part = True
            raise _Broken("invalid TPsot")
        if tnsot:
            if tpsot >= tnsot:
                self.last_tile_part = True
                raise _Broken("invalid TPsot")
            tcp["nb_tp"] = tnsot
        if tcp["nb_tp"] and tcp["nb_tp"] == tpsot + 1:
            self.can_decode = True
        self.sot_length = (psot - 12) & 0xFFFFFFFF
        self.state = ST_TPH

    def _sod(self) -> None:
        tcp = self.tcps[self.current_tile]
        if self.last_tile_part:
            self.sot_length = (self.left() - 2) & 0xFFFFFFFF
        elif self.sot_length >= 2:
            self.sot_length -= 2
        got = b""
        if self.sot_length:
            if self.sot_length > self.left():
                raise _Broken("tile-part length past the end of the stream")
            got = self.read(self.sot_length)
            tcp["data"] = (tcp["data"] or b"") + got
        self.state = ST_NEOC if len(got) != self.sot_length else ST_TPHSOT

    # -- tiles
    def read_tile_header(self):
        """opj_j2k_read_tile_header: the next tile's index, or None."""
        marker = MS["SOT"]
        if self.state == ST_EOC:
            marker = MS["EOC"]
        elif self.state != ST_TPHSOT:
            raise _Broken("read_tile_header in a bad state")
        while not self.can_decode and marker != MS["EOC"]:
            while marker != MS["SOD"]:
                if self.left() == 0:
                    self.state = ST_NEOC
                    break
                size = self.read(2)
                if len(size) != 2:
                    raise _Broken("stream too short")
                n = struct.unpack(">H", size)[0]
                if n < 2:
                    raise _Broken("inconsistent marker size")
                if marker == 0x8080 and self.left() == 0:
                    self.state = ST_NEOC
                    break
                if self.state & ST_TPH and self.sot_length:
                    if self.sot_length < n + 2:
                        raise _Broken("Psot less than the markers")
                    self.sot_length -= n + 2
                if not self.state & STATES.get(marker, UNKNOWN_STATES):
                    raise _Broken("marker out of place")
                if marker not in STATES or marker == MS["SOP"]:
                    raise _Broken("unknown marker in a tile-part header")
                body = self.read(n - 2)
                if len(body) != n - 2:
                    raise _Broken("stream too short")
                if marker == MS["SOT"]:
                    self._sot(body)
                else:
                    self._segment(marker, body)
                marker = self.read_marker()
            if self.left() == 0 and self.state == ST_NEOC:
                break
            self._sod()
            if not self.can_decode:
                b = self.read(2)
                if len(b) != 2:
                    if self.current_tile + 1 == self.ntiles:
                        idle = [i for i, t in enumerate(self.tcps)
                                if t["cur_tp"] == 0 and t["nb_tp"] == 0]
                        if idle:
                            self.current_tile = idle[0]
                            marker = MS["EOC"]
                            self.state = ST_EOC
                            break
                    raise _Broken("stream too short")
                marker = struct.unpack(">H", b)[0]
        if marker == MS["EOC"] and self.state != ST_EOC:
            self.current_tile = 0
            self.state = ST_EOC
        if not self.can_decode:
            while (self.current_tile < self.ntiles
                   and self.tcps[self.current_tile]["data"] is None):
                self.current_tile += 1
            if self.current_tile == self.ntiles:
                return None
        self.state |= ST_DATA
        return self.current_tile

    def finish_tile(self) -> None:
        """The end of opj_j2k_decode_tile: the tile's data dropped, then
        the marker after it read."""
        self.tcps[self.current_tile]["data"] = None
        self.can_decode = False
        self.state &= ~ST_DATA
        if self.left() == 0 and self.state == ST_NEOC:
            return
        if self.state != ST_EOC:
            marker = self.read_marker()
            if marker == MS["EOC"]:
                self.current_tile = 0
                self.state = ST_EOC
            elif marker != MS["SOT"]:
                if self.left() == 0:
                    self.state = ST_NEOC
                    return
                raise _Broken("stream too short, expected SOT")

    def tile_bounds(self, tile: int):
        s = self.siz
        p, q = tile % s["tw"], tile // s["tw"]
        x0 = max(s["tx0"] + p * s["tdx"], s["x0"])
        y0 = max(s["ty0"] + q * s["tdy"], s["y0"])
        x1 = min(s["tx0"] + (p + 1) * s["tdx"], s["x1"])
        y1 = min(s["ty0"] + (q + 1) * s["tdy"], s["y1"])
        return x0, y0, x1, y1

    def tile_params(self, tile: int) -> list:
        tcp = self.tcps[tile]
        x0, y0, x1, y1 = self.tile_bounds(tile)
        p = [len(self.comps), x0, y0, x1, y1, tcp["prg"], tcp["numlayers"],
             tcp["mct"], tcp["csty"], len(tcp["pocs"])]
        for poc in tcp["pocs"]:
            p += list(poc)
        for comp, t in zip(self.comps, tcp["tccps"]):
            nres = t["numres"]
            p += [comp["dx"], comp["dy"], comp["prec"], comp["sgnd"], nres,
                  t["cblkw"], t["cblkh"], t["cblksty"], t["qmfbid"],
                  t["qntsty"], t["numgbits"], t["roishift"]]
            for r in range(nres):
                p += list(t["prc"][r])
            for i in range(3 * (nres - 1) + 1):
                p += list(t["steps"][i])
        return p

    def refuse_styles(self, tile: int) -> None:
        if any(t["cblksty"] & HT_CBLK_STYLE for t in self.tcps[tile]["tccps"]):
            raise _Refused("HTJ2K (Part 15) code-blocks")

    def _call(self, tile: int, out, records, decode: bool):
        import ctypes

        tcp = self.tcps[tile]
        body = tcp["data"] or b""
        hdr = None
        if self.ppm is not None:
            hdr = self.ppm[self.ppm_pos:]
        elif tcp["ppt"]:
            hdr = b"".join(tcp["ppt"][z] for z in sorted(tcp["ppt"]))
        params = np.asarray(self.tile_params(tile), np.int64)
        info = np.zeros(3, np.int64)
        b = np.frombuffer(body, np.uint8) if body else np.zeros(1, np.uint8)
        h = np.frombuffer(hdr, np.uint8) if hdr else np.zeros(1, np.uint8)
        rc = j2k_library().tb_j2k_decode_tile(
            params.ctypes.data, len(params), b.ctypes.data, len(body),
            h.ctypes.data, -1 if hdr is None else len(hdr),
            out.ctypes.data if out is not None else None, info.ctypes.data,
            records.ctypes.data if records is not None else None,
            0 if records is None else len(records), int(decode))
        if rc:
            raise _Broken(ERRORS.get(rc, f"error {rc}"))
        return info

    def decode_tile(self, tile: int):
        """The tile's components (each (h, w) int32 on its own grid)."""
        x0, y0, x1, y1 = self.tile_bounds(tile)
        shapes = [(-(-y1 // c["dy"]) - -(-y0 // c["dy"]),
                   -(-x1 // c["dx"]) - -(-x0 // c["dx"]))
                  for c in self.comps]
        out = np.zeros(max(sum(h * w for h, w in shapes), 1), np.int32)
        info = self._call(tile, out, None, True)
        if self.ppm is not None:
            self.ppm_pos += int(info[0])
        comps, k = [], 0
        for hh, ww in shapes:
            comps.append(out[k:k + hh * ww].reshape(hh, ww))
            k += hh * ww
        return comps

    def tile_packets(self, tile: int) -> np.ndarray:
        """The tile's packets without decoding them: (N, 8) int64 rows of
        the body offset before SOP, the header's start and end (after EPH)
        in the header stream, the body's end, layer, resolution, component
        and precinct."""
        n = int(self._call(tile, None, None, False)[2])
        records = np.zeros((max(n, 1), 8), np.int64)
        info = self._call(tile, None, records, False)
        if self.ppm is not None:
            self.ppm_pos += int(info[0])
        return records[:n]


def packet_boundaries(data: bytes):
    """Each tile's packets in a codestream or JP2 file, in decoding order:
    [(tile, [(start, header_end, body_end), ...]), ...] with offsets in the
    tile's concatenated tile-part data (headers in the data: no PPM or
    PPT)."""
    pos = _read_jp2(data)[0] if data.startswith(JP2_SIGNATURE) else 0
    j2k = _J2k(data, pos)
    out = []
    while True:
        tile = j2k.read_tile_header()
        if tile is None:
            return out
        recs = j2k.tile_packets(tile)
        j2k.finish_tile()
        out.append((tile, [(int(r[0]), int(r[2]), int(r[3])) for r in recs]))


# ----------------------------------------------------------------------------
# Pillow's decoder (Jpeg2KDecode.c)


# (mode, colour space, components, takes subsampling) -> unpacker
UNPACKERS = (("L", "gray", 1, False, "gray_l"), ("P", "srgb", 1, False, "gray_l"),
             ("PA", "srgb", 2, False, "graya_la"),
             ("I;16", "gray", 1, False, "gray_i"),
             ("LA", "gray", 2, False, "graya_la"),
             ("RGB", "gray", 1, False, "gray_rgb"),
             ("RGB", "gray", 2, False, "gray_rgb"),
             ("RGB", "srgb", 3, True, "srgb_rgb"),
             ("RGB", "sycc", 3, True, "sycc_rgb"),
             ("RGB", "srgb", 4, True, "srgb_rgb"),
             ("RGB", "sycc", 4, True, "sycc_rgb"),
             ("RGBA", "gray", 1, False, "gray_rgb"),
             ("RGBA", "gray", 2, False, "graya_la"),
             ("RGBA", "srgb", 3, True, "srgb_rgb"),
             ("RGBA", "sycc", 3, True, "sycc_rgb"),
             ("RGBA", "srgb", 4, True, "srgba_rgba"),
             ("RGBA", "sycc", 4, True, "sycca_rgba"),
             ("CMYK", "cmyk", 4, True, "srgba_rgba"))


def _csiz(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _words(comps, info, w: int, h: int) -> list:
    """Each component's samples as Pillow's unpacker reads them from the
    buffer opj_decode_tile_data fills (a component's samples narrowed to
    1, 2 or 4 bytes, one component after the other): (h, w) int64 words.
    A subsampled component's row is w / dx samples long, short of its own
    width where w / dx rounds down, and Pillow then reads on into the
    next row."""
    masks = [(1 << (8 * _csiz(c["prec"]))) - 1 for c in info]
    if all(c.shape == (h, w) for c in comps):
        return [c.astype(np.int64) & m for c, m in zip(comps, masks)]
    flat = np.concatenate([c.ravel().astype(np.int64) & m
                           for c, m in zip(comps, masks)])
    offsets = np.cumsum([0] + [c.size for c in comps])
    out, start = [], 0
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    for c, words in zip(info, comps):
        cs = _csiz(c["prec"])
        cw, ch = w // c["dx"], h // c["dy"]
        idx = (ys // c["dy"]) * cw + xs // c["dx"]
        # byte offset start + cs * idx of the buffer: whole words, as the
        # components' byte sizes are multiples of every smaller size
        out.append(_buffer_words(flat, info, offsets, start + cs * idx, cs))
        start += cs * cw * ch
    return out


def _buffer_words(flat, info, offsets, byte_pos, cs):
    """Little-endian words of cs bytes at byte_pos of the tile buffer
    (zeros past its data)."""
    raw = []
    for c, words in zip(info, np.split(flat, offsets[1:-1])):
        raw.append(words.astype({1: "<u1", 2: "<u2", 4: "<u4"}[
            _csiz(c["prec"])]).view(np.uint8))
    data = np.concatenate(raw)
    buf = np.zeros(max(len(data), int(byte_pos.max()) + cs), np.uint8)
    buf[:len(data)] = data
    value = np.zeros(byte_pos.shape, np.int64)
    for k in range(cs):
        value |= buf[byte_pos + k].astype(np.int64) << (8 * k)
    return value


def _shifted(words: np.ndarray, prec: int, sgnd: int, bits: int):
    """j2ku_shift(offset + word, shift) to `bits` (8 or 16) bits."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = (words + offset) & 0xFFFFFFFF
    v = v >> -shift if shift < 0 else v << shift
    return (v & ((1 << bits) - 1)).astype(np.uint8 if bits == 8
                                          else np.uint16)


_I = np.arange(256)
_R_CR = np.trunc(1.40200 * 64 * (_I - 128) + 0.5).astype(np.int64)
_G_CB = np.trunc(-0.34414 * 64 * (_I - 128) + 0.5).astype(np.int64)
_G_CR = np.trunc(-0.71414 * 64 * (_I - 128) + 0.5).astype(np.int64)
_B_CB = np.trunc(1.77200 * 64 * (_I - 128) + 0.5).astype(np.int64)


def ycbcr_to_rgb(px: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB on (..., 4) uint8 (the fourth byte
    kept)."""
    y = px[..., 0].astype(np.int64)
    cb, cr = px[..., 1], px[..., 2]
    out = px.copy()
    out[..., 0] = np.clip(y + (_R_CR[cr] >> 6), 0, 255)
    out[..., 1] = np.clip(y + ((_G_CB[cb] + _G_CR[cr]) >> 6), 0, 255)
    out[..., 2] = np.clip(y + (_B_CB[cb] >> 6), 0, 255)
    return out


def _unpack(kind, info, words, w, h):
    """One tile through Pillow's unpacker from its components' words:
    (h, w) for L/P, (h, w) uint16 for I;16, else (h, w, 4) uint8."""
    if kind in ("gray_l", "gray_i"):
        return _shifted(words[0], info[0]["prec"], info[0]["sgnd"],
                        16 if kind == "gray_i" else 8)
    out = np.empty((h, w, 4), np.uint8)
    if kind in ("gray_rgb", "graya_la"):
        grey = _shifted(words[0], info[0]["prec"], info[0]["sgnd"], 8)
        out[..., 0] = out[..., 1] = out[..., 2] = grey
        out[..., 3] = 255 if kind == "gray_rgb" else _shifted(
            words[1], info[1]["prec"], info[1]["sgnd"], 8)
        return out
    n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    for i in range(n):
        out[..., i] = _shifted(words[i], info[i]["prec"], info[i]["sgnd"], 8)
    if n == 3:
        out[..., 3] = 255
    if kind.startswith("sycc"):
        out = ycbcr_to_rgb(out)
    return out


def _decode(data: bytes, codec: str, size, mode: str, path: str):
    """OpenJPEG through Pillow's j2k_decode_entry: Pillow's image of
    `mode` and `size`."""
    ihdr = None
    colour = "unspecified"
    if codec == "jp2":
        pos, jp2 = _read_jp2(data)
        ihdr = jp2.ihdr
        colour = COLOUR_SPACES.get(jp2.enumcs, "unspecified")
    else:
        pos = 0
    j2k = _J2k(data, pos, ihdr)
    nc = len(j2k.comps)
    if nc < 1 or nc > 4:
        raise _Broken(f"{nc} components")
    sub = [(c["dx"], c["dy"]) != (1, 1) for c in j2k.comps]
    if colour == "unspecified" and nc >= 3 and not sub[0] and any(sub[1:3]):
        colour = "sycc"   # full-size luma, subsampled chroma
    if colour == "unspecified":
        colour = "gray" if nc <= 2 else "srgb"
    kind = next((k for m, cs, n, takes, k in UNPACKERS
                 if cs == colour and n == nc and (takes or not any(sub))
                 and m == mode), None)
    if kind is None:
        raise _Broken(f"no unpacker for {mode} from {nc} {colour} "
                      "components")
    w, h = size
    img = None   # Pillow's image, zeroed (allocated at the first tile)
    s = j2k.siz
    while (tile := j2k.read_tile_header()) is not None:
        x0, y0, x1, y1 = j2k.tile_bounds(tile)
        if (x0 >= x1 or y0 >= y1 or x0 < s["x0"] or y0 < s["y0"]
                or x1 - s["x0"] > w or y1 - s["y0"] > h):
            raise _Broken("tile outside the image")
        j2k.refuse_styles(tile)
        comps = j2k.decode_tile(tile)
        j2k.finish_tile()
        words = _words(comps, j2k.comps, x1 - x0, y1 - y0)
        part = _unpack(kind, j2k.comps, words, x1 - x0, y1 - y0)
        if img is None:
            img = np.zeros((h, w) + part.shape[2:], part.dtype)
        img[y0 - s["y0"]:y1 - s["y0"], x0 - s["x0"]:x1 - s["x0"]] = part
    if img is None:
        img = (np.zeros((h, w), np.uint16 if kind == "gray_i" else np.uint8)
               if kind in ("gray_l", "gray_i") else
               np.zeros((h, w, 4), np.uint8))
    return img


def decode_jpeg2000(data: bytes, path: str = "<jpeg2000>"):
    """A JPEG 2000 file (JP2 or raw codestream) as PIL decodes it: (image,
    mode, palette) with image (H, W) uint8 for L and P, (H, W) uint16 for
    I;16, else (H, W, 4) uint8 in PIL's byte slots (LA as L, L, L, A; PA
    as P, P, P, A); palette (256, 3) uint8 for P and PA, else None."""
    try:
        codec, size, mode, palette = pil_open(data)
    except _PilError as e:
        if e.passes_on:
            raise UnidentifiedImageError(f"{path}: cannot identify image "
                                         f"file ({e})") from None
        raise ValueError(f"{path}: {e}") from None
    check_image_size(*size, path)
    try:
        img = _decode(data, codec, size, mode, path)
    except _Broken as e:
        raise ValueError(f"{path}: broken JPEG 2000 data stream ({e})") \
            from None
    except _Refused as e:
        raise NotImplementedError(
            f"{path}: JPEG 2000 {e} is not ported ({ITEM})") from None
    return img, mode, None if palette is None else palette.table()


def read_jpeg2000(data: bytes, path: str = "<jpeg2000>") -> np.ndarray:
    """A JPEG 2000 file's pixels as the JAX read_ldr gets them through
    PIL: (H, W, 3|4) uint8."""
    from tracerboy_tpu_torch.core.tiff import to_read_ldr

    img, mode, palette = decode_jpeg2000(data, path)
    if mode in ("LA", "RGB", "RGBA", "CMYK"):
        return to_read_ldr(img, mode, None)
    if mode == "PA":
        return np.concatenate([palette[img[..., 0]], img[..., 3:]], -1)
    if mode == "P":
        return palette[img]
    return to_read_ldr(img, mode, None)
