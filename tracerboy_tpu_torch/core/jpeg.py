"""The port's JPEG decoder: the pixels PIL returns for a JPEG file (on
libjpeg-turbo 3.1, default decompression settings), bit for bit, without
an imaging library.

Markers are parsed here; entropy decoding (Huffman and arithmetic), the
lossless frame's undifferencing, block smoothing, the islow inverse DCT,
chroma upsampling and the colour conversion run in csrc/jpeg_decode.cpp
(g++ at first use, ctypes), whose header lists where libjpeg's integer
arithmetic is easy to lose.

Inside a TIFF (core/tiff.py: compression 7) each strip or tile is its
own datastream, read after the JPEGTables tables-only stream through one
JpegTables (libjpeg's decompressor keeps its quantisation and Huffman
tables from one datastream to the next), and libtiff, not the markers,
chooses the colour transform (decode_jpeg's `color`).

Read: every frame libjpeg-turbo reads through PIL's 8-bit API, 1
component (grey), 3 (YCbCr or RGB, chosen by the JFIF, Adobe and
component-id rules of libjpeg's default_decompress_parms) or 4 (CMYK, or
YCCK where an Adobe marker's transform is not 0: libjpeg hands PIL CMYK
either way), any integral sampling factors, restart intervals:
- sequential and progressive DCT frames, Huffman-coded (SOF0-2) or
  arithmetic-coded (SOF9-10, jdarith.c, with the DAC conditioning each
  SOI resets); a progressive file whose scans leave one of the first 10
  coefficients incomplete is block-smoothed as libjpeg smooths it at its
  final output pass (jdcoefct.c decompress_smooth_data);
- lossless frames (SOF3: predictors 1-7, the point transform, restarts;
  jdlhuff.c, jddiffct.c, jdlossls.c), which libjpeg upsamples by
  replication and whose colour it does not convert (a YCbCr or YCCK
  lossless frame raises OSError, as PIL's load does; one with neither a
  JFIF nor an Adobe marker is RGB).
A 4-component file is read as PIL reads it, its samples inverted (the
CMYK;I raw mode) and converted to RGB; a BLP1 texture's JPEG is read as
CMYK whatever its Adobe marker says (decode_jpeg's `color` 3: PIL's BLP
plugin sets the JPEG's colour space to CMYK). EXIF orientation is not
applied (PIL's Image.open does not apply it). DNL segments are skipped,
as libjpeg skips them.

Refused as PIL refuses them: a frame of a precision other than 8 bits
(12-bit among them), of a component count other than 1, 3 or 4, or of
height or width 0 (a DNL-sized frame) is not identified by PIL's JPEG
plugin, nor is a file cut inside a header marker or a segment's length,
a bad DQT segment or a marker PIL does not know (open_jpeg's walk of the
header as JpegImageFile._open walks it: decode_ldr goes on to the
formats after JPEG, then raises "cannot identify image file");
hierarchical frames (SOF5-7, SOF13-15) and lossless arithmetic-coded
ones (SOF11) raise OSError, as libjpeg's errors do in PIL's load. Coefficients beyond the 16-bit range
of the SIMD IDCT PIL runs raise NotImplementedError naming their
ROADMAP.md item (no 8-bit encoder writes them; csrc/jpeg_decode.cpp
kMaxDequant). Truncated or corrupt data raises OSError, as PIL's load
does.
"""

from __future__ import annotations

import re
import struct

import numpy as np

UNSUPPORTED = ("ROADMAP.md, Queue 1: item 4, JPEG coefficients beyond the "
               "SIMD IDCT's range")
# The zigzag scan order: index k of a DQT table is natural index
# ZIGZAG[k] (row-major within the 8x8 block).
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# The entropy-coded segment ends at the first marker that is not a
# stuffed 0xFF00 or a restart marker (fill bytes 0xFF may precede it).
_SEGMENT_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
# The frame types libjpeg reads: (progressive, coding). jdmarker.c
# refuses the hierarchical ones (SOF5-7, SOF13-15), the decoder's master
# lossless arithmetic coding (SOF11).
_SOF_KINDS = {0xC0: (False, "huffman"), 0xC1: (False, "huffman"),
              0xC2: (True, "huffman"), 0xC3: (False, "lossless"),
              0xC9: (False, "arithmetic"), 0xCA: (True, "arithmetic")}
_SOF_REFUSED = {0xC5: "hierarchical", 0xC6: "hierarchical",
                0xC7: "hierarchical", 0xCB: "lossless arithmetic-coded",
                0xCD: "hierarchical", 0xCE: "hierarchical",
                0xCF: "hierarchical"}

_lib = None


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from tracerboy_tpu_torch.utils.build import (
            REPO_ROOT,
            build_shared_library,
        )

        lib = ctypes.CDLL(str(build_shared_library(
            "tbjpeg", [REPO_ROOT / "tracerboy_tpu_torch" / "csrc"
                       / "jpeg_decode.cpp"],
            ["g++", "-O2", "-shared", "-fPIC"])))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.tb_jpeg_scan.restype = i64
        lib.tb_jpeg_scan.argtypes = [p, i64, p, i64, p, p, p, i64, i64, i64,
                                     i64, i64, i64, i64, i64, p, p]
        lib.tb_jpeg_lossless_scan.restype = i64
        lib.tb_jpeg_lossless_scan.argtypes = [p, i64, p, i64, p, p, p, i64,
                                              i64, i64, i64, i64, p]
        lib.tb_jpeg_pixels.restype = i64
        lib.tb_jpeg_pixels.argtypes = [p, p, i64, p, p, p, i64, i64, i64,
                                       i64, p, p]
        _lib = lib
    return _lib


def _unsupported(path, what):
    return NotImplementedError(f"{path}: {what} JPEG is not read by the "
                               f"port ({UNSUPPORTED})")


def _corrupt(path, what):
    return OSError(f"{path}: corrupt JPEG data: {what}")


class _Frame:
    """SOF: the image size and each component's id, sampling factors and
    quantisation table; the coefficient arrays of every component (a
    lossless frame's sample planes)."""

    def __init__(self, seg, code, path):
        if len(seg) < 6:
            raise _corrupt(path, "short SOF segment")
        prec, self.H, self.W, nc = struct.unpack_from(">BHHB", seg)
        if prec != 8:         # libjpeg's 8-bit API (PIL does not open one)
            raise _corrupt(path, f"unsupported data precision {prec}")
        if nc not in (1, 3, 4):   # PIL does not open one
            raise _corrupt(path, f"{nc}-component frame")
        if self.W == 0 or self.H == 0 or len(seg) < 6 + 3 * nc:
            raise _corrupt(path, "bad SOF segment")
        self.progressive, self.coding = _SOF_KINDS[code]
        self.lossless = self.coding == "lossless"
        self.ids, self.hv, self.tq = [], [], []
        for c in range(nc):
            cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise _corrupt(path, "bad sampling factors or table id")
            self.ids.append(cid)
            self.hv.append((h, v))
            self.tq.append(tq)
        self.hmax = max(h for h, _ in self.hv)
        self.vmax = max(v for _, v in self.hv)
        # A lossless frame's data unit is one sample, a DCT frame's a block
        # of 8x8 (jdinput.c initial_setup).
        unit = 1 if self.lossless else 8
        self.mcus_per_row = -(-self.W // (unit * self.hmax))
        self.mcu_rows = -(-self.H // (unit * self.vmax))
        # Per component: element offset, blocks a row of its array (a
        # lossless plane's row stride), width and height in blocks (in
        # samples), h, v, downsampled width and height.
        self.geom = []
        off = 0
        for h, v in self.hv:
            dw = -(-self.W * h // self.hmax)
            dh = -(-self.H * v // self.vmax)
            if self.lossless:
                self.geom.append([off, dw, dw, dh, h, v, dw, dh])
                off += dw * dh
                continue
            bw, bh = self.mcus_per_row * h, self.mcu_rows * v
            self.geom.append([off, bw, -(-dw // 8), -(-dh // 8), h, v, dw,
                              dh])
            off += bw * bh * 64
        if self.lossless:
            self.samples = np.zeros(off, np.uint8)
        else:
            self.coef = np.zeros(off, np.int16)
        self.quant = [None] * nc    # latched at the component's first scan
        # jdphuff.c / jdarith.c coef_bits: per component and coefficient,
        # the Al still to refine (-1: never seen, 0: complete).
        self.coef_bits = np.full((nc, 64), -1, np.int64)
        self.scans = 0


def _scan(frame, seg, data, pos, tables, restart, path):
    """Decode the scan whose SOS header is seg and whose entropy-coded
    segment starts at data[pos]; returns the position of the marker that
    ends it."""
    import ctypes

    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
        raise _corrupt(path, "bad SOS segment")
    comps, slots = [], []
    for j in range(ns):
        cid, tt = seg[1 + 2 * j:3 + 2 * j]
        if cid not in frame.ids:
            raise _corrupt(path, f"scan names an unknown component {cid}")
        # Huffman tables 0-3 (a lossless scan names no AC table); the
        # arithmetic coder's statistics tables 0-15.
        if frame.coding == "huffman" and (tt >> 4 > 3 or tt & 15 > 3) or (
                frame.lossless and tt >> 4 > 3):
            raise _corrupt(path, "bad Huffman table selector")
        comps.append(frame.ids.index(cid))
        slots.append(tt)
    ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    frame.scans += 1
    if frame.lossless:      # jdlossls.c start_pass's checks
        if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:
            raise _corrupt(path, "bad progression parameters")
    elif frame.progressive:  # start_pass_phuff / jdarith.c start_pass
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
        if (ah != 0 and al != ah - 1) or al > 13 or bad:
            raise _corrupt(path, "bad progression parameters")
        for c in comps:
            frame.coef_bits[c, ss:se + 1] = al
    if ns > 1 and sum(frame.hv[c][0] * frame.hv[c][1] for c in comps) > 10:
        raise _corrupt(path, "MCU of more than 10 blocks")
    if not frame.lossless:
        for c in comps:       # jdinput.c latch_quant_tables
            if frame.quant[c] is None:
                if frame.tq[c] not in tables.qt:
                    raise _corrupt(path, "undefined quantisation table")
                frame.quant[c] = tables.qt[frame.tq[c]].copy()
    m = _SEGMENT_END.search(data, pos)
    end = m.start() if m else len(data)
    huff = np.zeros((8, 273), np.uint8)
    present = np.zeros(8, np.uint8)
    for slot, (bits, vals) in tables.ht.items():
        huff[slot, 1:17] = bits
        huff[slot, 17:17 + len(vals)] = np.frombuffer(vals, np.uint8)
        present[slot] = 1
    # Per component: offset, blocks a row of its array, h, v, width and
    # height in blocks, table slots. A non-interleaved scan covers the
    # component's own blocks, one an MCU.
    geom = np.array([[g[0], g[1], g[4], g[5], g[2], g[3], slots[j]]
                     for j, g in enumerate(frame.geom[c] for c in comps)],
                    np.int64)
    seg_bytes = np.frombuffer(data, np.uint8, end - pos, pos)
    msg = ctypes.create_string_buffer(256)
    if frame.lossless:
        # jddiffct.c start_input_pass: restarts come at whole MCU rows.
        mpr = frame.mcus_per_row if ns > 1 else frame.geom[comps[0]][2]
        if restart % mpr:
            raise _corrupt(path, f"restart interval {restart} is not a "
                           f"multiple of the {mpr} MCUs of a row")
        err = _library().tb_jpeg_lossless_scan(
            seg_bytes.ctypes.data, end - pos, frame.samples.ctypes.data, ns,
            geom.ctypes.data, huff.ctypes.data, present.ctypes.data,
            frame.mcus_per_row, frame.mcu_rows, ss, al, restart, msg)
    else:
        cond = (tables.dac.ctypes.data if frame.coding == "arithmetic"
                else None)
        err = _library().tb_jpeg_scan(
            seg_bytes.ctypes.data, end - pos, frame.coef.ctypes.data, ns,
            geom.ctypes.data, huff.ctypes.data, present.ctypes.data,
            frame.mcus_per_row, frame.mcu_rows, ss, se, ah, al,
            int(frame.progressive), restart, cond, msg)
    if err:
        raise _corrupt(path, msg.value.decode())
    return end


class JpegTables:
    """The quantisation and Huffman tables a libjpeg decompressor holds
    between datastreams: {slot: table} as each DQT and DHT defines them;
    and the arithmetic conditioning, which each SOI resets (dac: L, U and
    K of tables 0-15, jdmarker.c get_soi's defaults 0, 1 and 5)."""

    def __init__(self):
        self.qt, self.ht = {}, {}
        self.reset_dac()

    def reset_dac(self):
        self.dac = np.repeat(np.array([0, 1, 5], np.uint8), 16)


# Messages of tb_jpeg_scan for damaged entropy-coded data: libjpeg warns
# and substitutes zeros there (jdhuff.c), where the rest are fatal.
ENTROPY_DAMAGE = ("entropy-coded data ends early", "bad Huffman code",
                  "missing restart marker")


def _next_marker(data, pos, path):
    """The marker at data[pos] (fill bytes skipped, stray RSTn and TEM
    passed over): (code, its segment, the position after it); EOI has an
    empty segment."""
    while True:
        if pos >= len(data) or data[pos] != 0xFF:
            raise _corrupt(path, "truncated file or missing marker")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise _corrupt(path, "truncated file")
        code = data[pos]
        pos += 1
        if code == 0xD9:      # EOI
            return code, b"", pos
        if 0xD0 <= code <= 0xD7 or code == 0x01:
            continue          # stray RSTn / TEM: no segment
        if pos + 2 > len(data):
            raise _corrupt(path, "truncated marker segment")
        (n,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + n]
        if n < 2 or len(seg) != n - 2:
            raise _corrupt(path, "truncated marker segment")
        return code, seg, pos + n


def _segments(data, path):
    """(marker, segment) of every marker up to the first SOS or EOI."""
    if not data.startswith(b"\xff\xd8"):
        raise _corrupt(path, "no SOI marker")
    pos = 2
    while True:
        code, seg, pos = _next_marker(data, pos, path)
        yield code, seg
        if code in (0xD9, 0xDA):
            return


def frame_header(data: bytes, path: str = "<bytes>"):
    """The first frame header of a datastream: (precision, height, width,
    [(component id, h, v)]), or None when there is none before the first
    scan or EOI."""
    for code, seg in _segments(data, path):
        if 0xC0 <= code <= 0xCF and code not in (0xC4, 0xC8, 0xCC):
            if len(seg) < 6:
                raise _corrupt(path, "short SOF segment")
            prec, h, w, nc = struct.unpack_from(">BHHB", seg)
            if len(seg) < 6 + 3 * nc:
                raise _corrupt(path, "bad SOF segment")
            return prec, h, w, [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                                 seg[7 + 3 * c] & 15) for c in range(nc)]
    return None


def read_tables(data: bytes, tables: JpegTables, path: str = "<bytes>"):
    """Load a tables-only datastream (a TIFF's JPEGTables: SOI, DQT and
    DHT segments, EOI) into `tables`; a frame or scan in it is an error,
    as libjpeg's jpeg_read_header(require_image=FALSE) answers it."""
    for code, seg in _segments(data, path):
        if code == 0xDA or (0xC0 <= code <= 0xCF
                               and code not in (0xC4, 0xC8, 0xCC)):
            raise _corrupt(path, "JPEGTables holds an image")
        if code == 0xDB:
            _read_dqt(seg, tables.qt, path)
        elif code == 0xC4:
            _read_dht(seg, tables.ht, path)


def _read_dqt(seg, qt, path):
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        size = 128 if pq else 64
        if tq > 3 or i + 1 + size > len(seg):
            raise _corrupt(path, "bad DQT segment")
        vals = np.frombuffer(seg, ">u2" if pq else np.uint8, 64,
                             i + 1).astype(np.uint16)
        q = np.zeros(64, np.uint16)
        q[ZIGZAG] = vals
        qt[tq] = q
        i += 1 + size


def _read_dht(seg, ht, path):
    i = 0
    while i < len(seg):
        if i + 17 > len(seg):
            raise _corrupt(path, "bad DHT segment")
        tc, th = seg[i] >> 4, seg[i] & 15
        bits = np.frombuffer(seg, np.uint8, 16, i + 1)
        count = int(bits.sum())
        if tc > 1 or th > 3 or count > 256 or (i + 17 + count > len(seg)):
            raise _corrupt(path, "bad DHT segment")
        ht[tc * 4 + th] = (bits.copy(), seg[i + 17:i + 17 + count])
        i += 17 + count


def _read_dac(seg, dac, path):
    """jdmarker.c get_dac: (index, value) pairs, DC tables 0-15 taking L
    (low nibble) and U, AC tables 16-31 taking K."""
    if len(seg) % 2:
        raise _corrupt(path, "bad DAC segment")
    for i in range(0, len(seg), 2):
        index, val = seg[i], seg[i + 1]
        if index >= 32:
            raise _corrupt(path, f"bad DAC index {index}")
        if index >= 16:
            dac[32 + index - 16] = val
        else:
            if val & 15 > val >> 4:
                raise _corrupt(path, f"bad DAC value {val}")
            dac[index], dac[16 + index] = val & 15, val >> 4


def decode_jpeg(data: bytes, path: str = "<bytes>", tables=None,
                color=None) -> np.ndarray:
    """Decode a JPEG file's bytes to (H, W, 3) uint8 RGB: what
    np.asarray(Image.open(path).convert("RGB")) gives (a grey file is
    replicated to RGB, a 4-component one inverted and converted from
    CMYK). tables: a JpegTables the datastream reads its tables from and
    leaves its own in; color: the transform to apply whatever the
    markers say (0 grey, 1 YCbCr to RGB, 2 none; for 4 components 3
    CMYK, 4 YCCK to CMYK)."""
    import ctypes

    if not data.startswith(b"\xff\xd8"):
        raise _corrupt(path, "no SOI marker")
    pos = 2
    frame = None
    tables = tables if tables is not None else JpegTables()
    tables.reset_dac()
    qt, ht = tables.qt, tables.ht
    restart = 0
    jfif = False
    adobe = None
    while True:
        code, seg, pos = _next_marker(data, pos, path)
        if code == 0xD9:      # EOI
            break
        if code in _SOF_KINDS:
            if frame is not None:
                raise _corrupt(path, "more than one frame")
            frame = _Frame(seg, code, path)
        elif code in _SOF_REFUSED:   # libjpeg's "unsupported marker"
            raise _corrupt(path, f"{_SOF_REFUSED[code]} frames (SOF"
                           f"{code - 0xC0}) are not supported")
        elif code == 0xDB:    # DQT
            _read_dqt(seg, qt, path)
        elif code == 0xC4:    # DHT
            _read_dht(seg, ht, path)
        elif code == 0xCC:    # DAC
            _read_dac(seg, tables.dac, path)
        elif code == 0xDD:    # DRI
            if len(seg) < 2:
                raise _corrupt(path, "bad DRI segment")
            (restart,) = struct.unpack_from(">H", seg)
        elif code == 0xE0:    # jdmarker.c examine_app0
            jfif = jfif or (len(seg) >= 14 and seg[:5] == b"JFIF\0")
        elif code == 0xEE:    # examine_app14
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
        elif code == 0xDA:    # SOS
            if frame is None:
                raise _corrupt(path, "scan before the frame header")
            pos = _scan(frame, seg, data, pos, tables, restart, path)
        # Any other segment, DNL among them, is skipped, as libjpeg skips
        # it (a frame of height 0 is refused above, and PIL does not open
        # one).
    if frame is None or frame.scans == 0:
        raise _corrupt(path, "no image data")
    nc = len(frame.ids)
    smooth = _smoothing_bits(frame) if frame.progressive else None
    if not frame.lossless:
        for c in range(nc):   # a component no scan named reads as zeros
            if frame.quant[c] is None:
                frame.quant[c] = qt.get(frame.tq[c], np.zeros(64, np.uint16))
    if color is None:         # jdapimin.c default_decompress_parms
        if nc == 1:
            color = 0
        elif nc == 4:         # CMYK; YCCK for any Adobe transform but 0
            color = 3 if adobe in (None, 0) else 4
        elif jfif:
            color = 1
        elif adobe is not None:
            color = 2 if adobe == 0 else 1
        elif frame.ids == [82, 71, 66] or frame.lossless:
            color = 2         # 'R', 'G', 'B'; a lossless frame's guess
        else:
            color = 1
    if frame.lossless and color in (1, 4):   # jdcolor.c: no lossy
        raise _corrupt(path, "colour conversion in a lossless frame")
    out = np.empty((frame.H, frame.W, 4 if color >= 3 else 3), np.uint8)
    geom = np.array(frame.geom, np.int64)
    msg = ctypes.create_string_buffer(256)
    if frame.lossless:
        err = _library().tb_jpeg_pixels(
            None, frame.samples.ctypes.data, nc, geom.ctypes.data, None,
            None, frame.mcu_rows, frame.W, frame.H, color, out.ctypes.data,
            msg)
    else:
        quant = np.ascontiguousarray(np.stack(frame.quant), np.uint16)
        err = _library().tb_jpeg_pixels(
            frame.coef.ctypes.data, None, nc, geom.ctypes.data,
            quant.ctypes.data, None if smooth is None else smooth.ctypes.data,
            frame.mcu_rows, frame.W, frame.H, color, out.ctypes.data, msg)
    if err == 1:
        raise _corrupt(path, msg.value.decode())
    if err:
        raise _unsupported(path, msg.value.decode())
    if out.shape[2] == 4:     # PIL's CMYK;I raw mode, then convert("RGB")
        from tracerboy_tpu_torch.core.image_io import as_read_ldr

        return as_read_ldr(255 - out, "CMYK")
    return out


def _smoothing_bits(frame):
    """jdcoefct.c smoothing_ok at the final output pass: libjpeg smooths
    the blocks of a progressive file when every component's quantisation
    table is latched with its first 10 quantisers nonzero, every
    component's DC is at least partly known, and some coefficient 1-9 of
    some component is incomplete. Returns the coef_bits latch of the first
    10 coefficients, (components, 10) int64, or None. (libjpeg reads the
    bits from before the last scan in rows past the last complete one of
    a scan cut short; every scan here is complete, as PIL's load of a
    truncated file fails.)"""
    first10 = ZIGZAG[:10]
    for c in range(len(frame.ids)):
        q = frame.quant[c]
        if q is None or (q[first10] == 0).any() or frame.coef_bits[c, 0] < 0:
            return None
    latch = np.ascontiguousarray(frame.coef_bits[:, :10])
    if not (latch[:, 1:] != 0).any():
        return None
    return latch


# The markers PIL's JpegImagePlugin knows (MARKER) and how its _open
# reads each: "sof", "dqt", "app", or "skip" (a segment read past);
# None for the markers without a segment.
_PIL_MARKERS = {
    **{c: "sof" for c in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9,
                          0xCA, 0xCB, 0xCD, 0xCE, 0xCF, 0xDE)},
    **{c: "skip" for c in (0xC4, 0xCC, 0xDA, 0xDC, 0xDD, 0xDF, 0xFE)},
    **{c: "app" for c in range(0xE0, 0xF0)},
    0xDB: "dqt",
    **{c: None for c in (0xC8, *range(0xD0, 0xDA), *range(0xF0, 0xFE))},
}


def _pil_open(data: bytes, path: str):
    """PIL's JpegImageFile._open on a file that starts FF D8 FF: its
    marker walk up to the first SOS, past any EOI. Where PIL's walk
    raises SyntaxError, IndexError or struct.error (a file cut inside a
    marker or a segment's length, a bad DQT, SOF or ICC segment, a marker
    PIL does not know, a frame of a precision other than 8 bits or of a
    component count other than 1, 3 or 4, no frame or one of width or
    height 0), the file is not identified: the port's
    UnidentifiedImageError. A segment cut short raises OSError, as
    ImageFile._safe_read does."""
    from tracerboy_tpu_torch.core.image_io import UnidentifiedImageError

    def unidentified(why):
        return UnidentifiedImageError(f"{path}: cannot identify image file "
                                      f"({why})")

    pos, s = 3, b"\xff"
    size, icc = None, []
    while True:
        if not s:
            raise unidentified("no SOS before the end of the file")
        if s[0] != 0xFF:
            s, pos = data[pos:pos + 1], pos + 1
            continue
        if pos >= len(data):
            raise unidentified("file cut inside a marker")
        code, pos = data[pos], pos + 1
        if code in _PIL_MARKERS:
            kind = _PIL_MARKERS[code]
            if kind is not None:
                if pos + 2 > len(data):
                    raise unidentified("file cut inside a segment length")
                n = (data[pos] << 8 | data[pos + 1]) - 2
                pos += 2
                seg = data[pos:pos + max(n, 0)]
                if len(seg) < n:
                    raise _corrupt(path, "Truncated File Read")
                pos += len(seg)
                if kind == "app" and (
                        (code == 0xE0 and seg.startswith(b"JFIF"))
                        or (code == 0xEE and seg.startswith(b"Adobe"))) \
                        and len(seg) < 7:
                    raise unidentified("short JFIF or Adobe segment")
                if code == 0xE2 and seg.startswith(b"ICC_PROFILE\0"):
                    icc.append(seg)
                if kind == "dqt":
                    rest = seg
                    while rest:
                        length = 65 if rest[0] < 16 else 129
                        if len(rest) < length:
                            raise unidentified("bad quantization table "
                                               "marker")
                        rest = rest[length:]
                if kind == "sof":
                    if len(seg) < 6:
                        raise unidentified("short SOF segment")
                    prec, h, w, nc = struct.unpack_from(">BHHB", seg)
                    if prec != 8 or nc not in (1, 3, 4):
                        raise unidentified(f"a {prec}-bit, {nc}-component "
                                           "frame")
                    if icc and len(sorted(icc)[0]) < 14:
                        raise unidentified("short ICC_PROFILE segment")
                    icc = []
                    if len(seg) > 6 and (len(seg) - 6) % 3:
                        raise unidentified("SOF component cut short")
                    size = (w, h)
            if code == 0xDA:
                break
            s, pos = data[pos:pos + 1], pos + 1
        elif code == 0xFF:
            s = b"\xff"
        elif code == 0x00:
            s, pos = data[pos:pos + 1], pos + 1
        else:
            raise unidentified(f"no marker found (FF {code:02X})")
    if size is None or 0 in size:
        raise unidentified(f"frame size {size}")


def open_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """decode_jpeg of a file PIL's JPEG plugin identifies: _pil_open's
    walk first, whose unidentified files decode_ldr passes on to the
    formats after JPEG, as Image.open does."""
    _pil_open(data, path)
    return decode_jpeg(data, path)


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG file (decode_jpeg)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
