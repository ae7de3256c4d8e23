"""PIL 12.1's AVIF writer, part 1: what every later part writes through.

PIL's AvifImagePlugin._save hands libavif 1.3 an RGB or RGBA frame
(every other mode converted first); libavif converts it to YUV, has aom
3.12 code it (quality 75, speed 6, 4:2:0, full range) and wraps the AV1
payloads in its HEIF box tree. This module holds:
- pil_frame: the plugin's mode conversion (L as RGB, LA as RGBA);
- rgb_to_yuv: libavif's avifImageRGBToYUV on 8-bit RGB(A) into full-range
  4:2:0 with BT.601 coefficients, which it hands to libyuv (J420 rows:
  Y from each pixel, U and V from each 2x2 cell averaged with pavgb, the
  rows first; an odd last row or column paired with itself), and the
  alpha plane, which an image whose alpha is 255 throughout does not get;
- record / write: an AV1 payload's decision record (the decoder's syntax
  walk, csrc/av1_decode.cpp's tb_av1_record; its layout in
  csrc/av1_syntax.inc) and the payload aom writes from a record
  (csrc/av1_encode.cpp), byte for byte for every payload aom wrote;
- encode_avif: libavif's avifEncoderFinish for PIL's still image, its
  AV1 payloads given.

What is not here yet is aom's encoder proper (ROADMAP Queue 1 item 25,
parts 2-4): the forward transforms and quantizer, the frame-level
choices, the block search. So image_save still refuses .avif and .avifs.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

# Tags of the decision record's entries (csrc/av1_syntax.inc).
REC_SEQ, REC_FRAME, REC_TILE, REC_LR, REC_PART, REC_BLOCK, REC_MAP, \
    REC_TXB = range(1, 9)
# kRecBlock's fields (csrc/av1_syntax.inc's kB* order).
BLOCK_FIELDS = ("row", "col", "size", "skip", "segment", "cdef", "qindex",
                "delta_lf0", "delta_lf1", "delta_lf2", "delta_lf3",
                "intrabc", "mv_row", "mv_col", "y_mode", "angle_y",
                "uv_mode", "angle_uv", "cfl_u", "cfl_v", "filter_intra",
                "filter_mode", "pal_y", "pal_uv", *(f"pal{k}" for k in
                                                    range(24)), "tx_size")
B = {name: k for k, name in enumerate(BLOCK_FIELDS)}

ALPHA_URN = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
# libavif's colr for PIL's frames: BT.709 primaries, sRGB transfer,
# BT.601 matrix, full range.
NCLX = (1, 13, 6, 1)


def _call(fn, data, n: int, dtype, what: str):
    """An entry point that returns its output's length (more than the
    room given: call again with that much)."""
    cap = max(1024, 4 * n)
    while True:
        out = np.zeros(cap, dtype)
        msg = ctypes.create_string_buffer(256)
        got = fn(data, n, out.ctypes.data, cap, msg, 256)
        if got < 0:
            raise ValueError(f"{what}: {msg.value.decode()}")
        if got <= cap:
            return out[:got]
        cap = int(got)


def record(payload: bytes) -> np.ndarray:
    """The int32 decision record of an AV1 payload (one still frame)."""
    from tracerboy_tpu_torch.core.codecs import av1_library

    return _call(av1_library().tb_av1_record, payload, len(payload),
                 np.int32, "AV1 record")


def write(rec: np.ndarray) -> bytes:
    """The AV1 payload aom writes for a decision record."""
    from tracerboy_tpu_torch.core.codecs import av1_encode_library

    rec = np.ascontiguousarray(rec, np.int32)
    return _call(av1_encode_library().tb_av1_write, rec.ctypes.data,
                 rec.size, np.uint8, "AV1 write").tobytes()


def entries(rec: np.ndarray):
    """(tag, start, length) of each entry of a record: its values are
    rec[start:start + length]."""
    pos = 0
    while pos < len(rec):
        tag, n = int(rec[pos]), int(rec[pos + 1])
        yield tag, pos + 2, n
        pos += 2 + n


# ----------------------------------------------------------------------------
# The frame PIL hands libavif, and its YUV


def pil_frame(px: np.ndarray, mode: str) -> np.ndarray:
    """AvifImagePlugin._save's frame: L as RGB, LA as RGBA (LA has
    transparency data), RGB and RGBA as they are."""
    if mode in ("L", "LA"):
        px = np.concatenate([np.repeat(px[..., :1], 3, axis=2),
                             px[..., 1:]], axis=2)
    return np.ascontiguousarray(px)


def _avg(a, b):
    return (a + b + 1) >> 1


def rgb_to_yuv(rgb: np.ndarray):
    """(Y, U, V, alpha or None) libavif 1.3 makes of an (H, W, 3|4) uint8
    frame for PIL: libyuv's RGBToYJ, and its ARGBToUVJRow SIMD rows on
    pavgb averages (vertical, then horizontal) with the full-range BT.601
    weights 128, -85, -43 and 128, -107, -21 (+0x8000, >> 8); the alpha
    plane only where some alpha is not 255."""
    x = rgb[..., :3].astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = ((77 * r + 150 * g + 29 * b + 128) >> 8).astype(np.uint8)
    h, w = y.shape
    if w & 1:
        x = np.concatenate([x, x[:, -1:]], axis=1)
    if h & 1:
        x = np.concatenate([x, x[-1:]], axis=0)
    v = _avg(x[0::2], x[1::2])
    m = _avg(v[:, 0::2], v[:, 1::2])
    r, g, b = m[..., 0], m[..., 1], m[..., 2]
    u = ((128 * b - 85 * g - 43 * r + 0x8000) >> 8).astype(np.uint8)
    vv = ((128 * r - 107 * g - 21 * b + 0x8000) >> 8).astype(np.uint8)
    alpha = None
    if rgb.shape[2] == 4 and (rgb[..., 3] != 255).any():
        alpha = np.ascontiguousarray(rgb[..., 3])
    return y, u, vv, alpha


# ----------------------------------------------------------------------------
# The container (libavif 1.3's avifEncoderFinish for one still image)


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, payload: bytes, version: int = 0,
          flags: int = 0) -> bytes:
    return _box(typ, bytes([version]) + flags.to_bytes(3, "big") + payload)


class _Bits:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | (self.data[self.pos >> 3] >> (7 - (self.pos & 7))
                            & 1)
            self.pos += 1
        return v


def _obus(payload: bytes):
    """(type, body) of each OBU of a payload."""
    pos = 0
    while pos < len(payload):
        head = payload[pos]
        typ, ext, has_size = head >> 3 & 15, head >> 2 & 1, head >> 1 & 1
        pos += 1 + ext
        if has_size:
            size = shift = 0
            while True:
                byte = payload[pos]
                pos += 1
                size |= (byte & 0x7f) << shift
                shift += 7
                if not byte & 0x80:
                    break
        else:
            size = len(payload) - pos
        yield typ, payload[pos:pos + size]
        pos += size


def av1c(payload: bytes) -> bytes:
    """The av1C box libavif writes for a payload: its sequence header's
    profile, operating point 0's level and tier, depth, monochrome,
    subsampling and sample position, no configOBUs."""
    from tracerboy_tpu_torch.core import avif
    from tracerboy_tpu_torch.core.codecs import av1_library

    body = next(b for t, b in _obus(payload) if t == 1)
    bits = _Bits(body)
    profile, _still, reduced = bits.f(3), bits.f(1), bits.f(1)
    tier = 0
    if reduced:
        level = bits.f(5)
    else:
        delay_len = 0
        decoder_model = 0
        if bits.f(1):                                   # timing_info
            bits.f(64)
            if bits.f(1):                               # equal interval
                lz = 0
                while not bits.f(1):
                    lz += 1
                bits.f(lz)
            decoder_model = bits.f(1)
            if decoder_model:
                delay_len = bits.f(5) + 1
                bits.f(32 + 10)
        idd = bits.f(1)
        count = bits.f(5) + 1
        for i in range(count):
            bits.f(12)
            lv = bits.f(5)
            tr = bits.f(1) if lv > 7 else 0
            if i == 0:
                level, tier = lv, tr
            if decoder_model and bits.f(1):
                bits.f(2 * delay_len + 1)
            if idd and bits.f(1):
                bits.f(4)
    info = avif._av1_header(av1_library(), payload, "<avif>")
    mono, ssx, ssy, depth, csp = (int(info[k]) for k in (2, 3, 4, 9, 10))
    return _box(b"av1C", bytes([
        0x81, profile << 5 | level,
        tier << 7 | (depth > 8) << 6 | (depth == 12) << 5 | mono << 4
        | ssx << 3 | ssy << 2 | csp, 0]))


def encode_avif(width: int, height: int, color: bytes,
                alpha: bytes | None = None) -> bytes:
    """The file libavif 1.3 writes for PIL's still image of width x height
    with these AV1 payloads: ftyp, then meta (hdlr, pitm, iloc, iinf,
    iref for an alpha item, iprp: ispe shared, a pixi and an av1C each,
    colr for the colour item, auxC for the alpha one), then mdat with the
    alpha item's data first; the iloc offsets point into it."""
    from tracerboy_tpu_torch.core import avif
    from tracerboy_tpu_torch.core.codecs import av1_library

    info = avif._av1_header(av1_library(), color, "<avif>")
    mono, ssx, ssy, depth = (int(info[k]) for k in (2, 3, 4, 9))
    brands = b"avif" + b"mif1" + b"miaf"
    if depth in (8, 10) and not mono and ssx and ssy:
        brands += b"MA1B"
    elif depth in (8, 10) and not mono and not ssx and not ssy:
        brands += b"MA1A"
    ftyp = _box(b"ftyp", b"avif" + struct.pack(">I", 0) + brands)
    items = [(1, b"Color", color)] + ([(2, b"Alpha", alpha)]
                                      if alpha is not None else [])
    props, assoc = [], []

    def associate(iid, boxes):
        """ipma's entries of an item: libavif writes a property box once
        and points every item with the same bytes at it."""
        refs = []
        for box, essential in boxes:
            if box not in props:
                props.append(box)
            refs.append((props.index(box) + 1, essential))
        assoc.append((iid, refs))

    ispe = _full(b"ispe", struct.pack(">II", width, height))
    associate(1, [(ispe, False),
                  (_full(b"pixi", bytes([1 if mono else 3] + [depth] * (
                      1 if mono else 3))), False),
                  (av1c(color), True),
                  (_box(b"colr", b"nclx" + struct.pack(
                      ">HHHB", *NCLX[:3], NCLX[3] << 7)), False)])
    if alpha is not None:
        associate(2, [(ispe, False), (_full(b"pixi", bytes([1, depth])),
                                      False),
                      (av1c(alpha), True), (_full(b"auxC", ALPHA_URN),
                                            False)])
    ipma = _full(b"ipma", struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", iid, len(a)) + bytes(k | ess << 7 for k, ess in a)
        for iid, a in assoc))
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props)) + ipma)
    iinf = _full(b"iinf", struct.pack(">H", len(items)) + b"".join(
        _full(b"infe", struct.pack(">HH", iid, 0) + b"av01" + name + b"\0",
              version=2) for iid, name, _ in items))
    iref = (_full(b"iref", _box(b"auxl", struct.pack(">HHH", 2, 1, 1)))
            if alpha is not None else b"")
    hdlr = _full(b"hdlr", struct.pack(">I", 0) + b"pict" + bytes(13))
    pitm = _full(b"pitm", struct.pack(">H", 1))
    order = sorted(items, key=lambda it: it[0] != 2)     # alpha's data first

    def meta(offsets):
        iloc = _full(b"iloc", bytes([0x44, 0]) + struct.pack(
            ">H", len(items)) + b"".join(
            struct.pack(">HHHII", iid, 0, 1, offsets[iid], len(data))
            for iid, _, data in items))
        return _full(b"meta", hdlr + pitm + iloc + iinf + iref + iprp)

    start = len(ftyp) + len(meta({iid: 0 for iid, _, _ in items})) + 8
    offsets, pos = {}, start
    for iid, _, data in order:
        offsets[iid] = pos
        pos += len(data)
    mdat = _box(b"mdat", b"".join(data for _, _, data in order))
    return ftyp + meta(offsets) + mdat
