"""A small WebP writer for the tests of the port's WebP reader
(core/webp.py, csrc/webp_decode.cpp).

PIL's encoder (libwebp) writes what a real pipeline writes; this one
writes what it never does, so that PIL decodes it and the port must
agree:
- VP8 key frames of random syntax (vp8_frame): a random header (segment
  map and quantiser or filter deltas, absolute or relative, the simple
  or the normal loop filter at any level and sharpness, reference and
  mode filter deltas, 1, 2, 4 or 8 token partitions, quantiser deltas,
  coefficient probability updates, skip flags) and random macroblocks
  (16x16 and 4x4 intra modes through their contexts, chroma modes,
  coefficient tokens of every size class, blocks padded with zeros to
  16), written by the boolean encoder of RFC 6386 section 7.3;
- VP8L streams of random transforms (vp8l_transforms): every predictor
  mode 0-15 (libwebp writes 0-13), random cross-colour multipliers,
  subtract green, colour indexing with indices past the palette, pixels
  as 8-bit literals;
- containers: raw and lossless ALPH chunks with any filter, VP8X files
  with extra chunks and odd sizes, animations whose first frame is
  smaller than the canvas (riff, chunk, vp8x_file, anim_file).
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The tables are the decoder's (csrc/webp_vp8_tables.inc), read back.
_INC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "tracerboy_tpu_torch", "csrc", "webp_vp8_tables.inc")


def _tables():
    text = open(_INC).read()
    out = {}
    for name, shape in (("kCoeffsProba0", (4, 8, 3, 11)),
                        ("kCoeffsUpdateProba", (4, 8, 3, 11)),
                        ("kBModesProba", (10, 10, 9))):
        body = text[text.index(name):]
        body = body[body.index("=") + 1:body.index(";")]
        nums = [int(t) for t in body.replace("{", " ").replace("}", " ")
                .replace(",", " ").split()]
        out[name] = np.array(nums, np.int64).reshape(shape)
    return out


_T = _tables()
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135),
             (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's 4x4 mode tree (node i at 2i, 2i + 1; leaves are -mode).
YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8,
                 -8, -9)


class BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range = 255
        self.bottom = 0
        self.bit_count = 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit, prob=128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, bits):
        for i in range(bits - 1, -1, -1):
            self.put((v >> i) & 1)

    def signed(self, v, bits):
        self.value(abs(v), bits)
        self.put(v < 0)

    def flag_value(self, v, bits, signed=False):
        """A flag, then the value when it is non-zero."""
        self.put(v != 0)
        if v:
            (self.signed if signed else self.value)(v, bits)

    def finish(self) -> bytes:
        for _ in range(32):
            self.put(0)
        return bytes(self.out)


def _put_large(bw, v, p):
    if v == 2:
        bw.put(0, p[3]), bw.put(0, p[4])
    elif v <= 4:
        bw.put(0, p[3]), bw.put(1, p[4]), bw.put(v - 3, p[5])
    elif v <= 6:
        bw.put(1, p[3]), bw.put(0, p[6]), bw.put(0, p[7])
        bw.put(v - 5, 159)
    elif v <= 10:
        bw.put(1, p[3]), bw.put(0, p[6]), bw.put(1, p[7])
        bw.put((v - 7) >> 1, 165), bw.put((v - 7) & 1, 145)
    else:
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        bw.put(1, p[3]), bw.put(1, p[6])
        bw.put(cat >> 1, p[8]), bw.put(cat & 1, p[9 + (cat >> 1)])
        extra = v - (3 + (8 << cat))
        probs = CAT_PROBS[cat]
        for i, prob in enumerate(probs):
            bw.put((extra >> (len(probs) - 1 - i)) & 1, prob)


def _put_coeffs(bw, proba, ctx, levels, first, pad):
    """The tokens of one block (levels in zigzag order from `first`),
    mirroring the decoder's GetCoeffs; with `pad` a block with a non-zero
    level runs to 16 with zero tokens instead of ending. Returns the
    decoder's nz (the position after the last token)."""
    nonzero = [i for i in range(first, 16) if levels[i]]
    end = 16 if (pad and nonzero) else (nonzero[-1] + 1 if nonzero
                                        else first)
    n = first
    p = proba[BANDS[n]][ctx]
    while True:
        if n == end:
            bw.put(0, p[0])                  # end of block
            return n
        bw.put(1, p[0])
        while levels[n] == 0:
            bw.put(0, p[1])
            n += 1
            if n == 16:
                return 16
            p = proba[BANDS[n]][0]
        bw.put(1, p[1])
        v = abs(int(levels[n]))
        if v == 1:
            bw.put(0, p[2])
            nctx = 1
        else:
            bw.put(1, p[2])
            _put_large(bw, v, p)
            nctx = 2
        bw.put(levels[n] < 0)
        n += 1
        if n == 16:
            return 16
        p = proba[BANDS[n]][nctx]


def _random_levels(rng, first, scale):
    lv = np.zeros(16, np.int64)
    k = int(rng.integers(0, 17 - first))
    if k:
        pos = rng.choice(np.arange(first, 16), k, replace=False)
        mag = rng.choice([1, 1, 1, 2, 3, 5, 8, 12, 25, 50, 120, 600, 2000],
                         k)
        mag = np.minimum(mag * scale, 2048 + 66)
        lv[pos] = mag * rng.choice([-1, 1], k)
    return lv


def vp8_frame(rng, width, height, simple=False, partitions_log2=None,
              coeff_scale=1) -> bytes:
    """A VP8 key frame of random syntax (see the module docstring)."""
    bw = BoolEncoder()
    bw.put(0), bw.put(0)                     # colour space, clamping
    use_segment = bool(rng.random() < 0.6)
    update_map = False
    seg_probs = [255, 255, 255]
    bw.put(use_segment)
    if use_segment:
        update_map = bool(rng.random() < 0.8)
        bw.put(update_map)
        update_data = bool(rng.random() < 0.8)
        bw.put(update_data)
        if update_data:
            bw.put(rng.random() < 0.5)       # absolute or delta
            for _ in range(4):
                bw.flag_value(int(rng.integers(-127, 128)) * (rng.random()
                                                             < 0.7), 7, True)
            for _ in range(4):
                bw.flag_value(int(rng.integers(-63, 64)) * (rng.random()
                                                           < 0.7), 6, True)
        if update_map:
            for s in range(3):
                p = int(rng.integers(1, 256)) if rng.random() < 0.8 else 255
                seg_probs[s] = p
                bw.flag_value(p if p != 255 else 0, 8)
    bw.put(simple)
    bw.value(int(rng.integers(0, 64)), 6)    # filter level
    bw.value(int(rng.integers(0, 8)), 3)     # sharpness
    use_delta = bool(rng.random() < 0.5)
    bw.put(use_delta)
    if use_delta:
        bw.put(1)
        for _ in range(8):
            bw.flag_value(int(rng.integers(-63, 64)) * (rng.random() < 0.7),
                          6, True)
    plog = int(rng.integers(0, 4)) if partitions_log2 is None \
        else partitions_log2
    bw.value(plog, 2)
    bw.value(int(rng.integers(0, 128)), 7)
    for _ in range(5):
        bw.flag_value(int(rng.integers(-15, 16)) * (rng.random() < 0.5), 4,
                      True)
    bw.put(0)                                # refresh entropy probs
    proba = _T["kCoeffsProba0"].copy()
    upd = _T["kCoeffsUpdateProba"]
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    new = rng.random() < 0.08
                    bw.put(new, int(upd[t, b, c, p]))
                    if new:
                        v = int(rng.integers(1, 256))
                        bw.value(v, 8)
                        proba[t, b, c, p] = v
    use_skip = bool(rng.random() < 0.7)
    bw.put(use_skip)
    skip_p = int(rng.integers(1, 256))
    if use_skip:
        bw.value(skip_p, 8)
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    parts = [BoolEncoder() for _ in range(1 << plog)]
    intra_t = [0] * (4 * mb_w)
    top_nz = [[0] * 9 for _ in range(mb_w)]   # 4 y, 2 u, 2 v, dc
    bmodes = _T["kBModesProba"]
    for mb_y in range(mb_h):
        intra_l = [0] * 4
        left_nz = [0] * 9
        tb = parts[mb_y & ((1 << plog) - 1)]
        blocks = []
        for mb_x in range(mb_w):
            if update_map:
                seg = int(rng.integers(0, 4))
                if seg < 2:
                    bw.put(0, seg_probs[0]), bw.put(seg, seg_probs[1])
                else:
                    bw.put(1, seg_probs[0]), bw.put(seg - 2, seg_probs[2])
            skip = bool(use_skip and rng.random() < 0.3)
            if use_skip:
                bw.put(skip, skip_p)
            i4 = bool(rng.random() < 0.5)
            bw.put(not i4, 145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not i4:
                ymode = int(rng.integers(0, 4))     # DC, TM, V, H
                code = {0: (0, 0), 2: (0, 1), 3: (1, 0), 1: (1, 1)}[ymode]
                bw.put(code[0], 156)
                bw.put(code[1], 128 if code[0] else 163)
                intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = bmodes[top[x], ym]
                        mode = int(rng.integers(0, 10))
                        for node, bit in MODE_PATHS[mode]:
                            bw.put(bit, int(prob[node]))
                        ym = mode
                        top[x] = mode
                    intra_l[y] = ym
                intra_t[4 * mb_x:4 * mb_x + 4] = top
            uv = int(rng.integers(0, 4))
            bw.put(uv != 0, 142)
            if uv:
                bw.put(uv != 2, 114)
                if uv != 2:
                    bw.put(uv == 1, 183)
            blocks.append((i4, skip))
        for mb_x, (i4, skip) in enumerate(blocks):
            mb = top_nz[mb_x]
            if skip:
                for k in range(8):
                    mb[k] = left_nz[k] = 0
                if not i4:
                    mb[8] = left_nz[8] = 0
                continue
            pad = rng.random() < 0.1
            if not i4:
                ctx = mb[8] + left_nz[8]
                nz = _put_coeffs(tb, proba[1], ctx,
                                 _random_levels(rng, 0, coeff_scale), 0, pad)
                mb[8] = left_nz[8] = int(nz > 0)
                first, ac = 1, proba[0]
            else:
                first, ac = 0, proba[3]
            for y in range(4):
                for x in range(4):
                    ctx = left_nz[y] + mb[x]
                    nz = _put_coeffs(tb, ac, ctx,
                                     _random_levels(rng, first, coeff_scale),
                                     first, pad and rng.random() < 0.5)
                    left_nz[y] = mb[x] = int(nz > first)
            for ch in (4, 6):
                for y in range(2):
                    for x in range(2):
                        ctx = left_nz[ch + y] + mb[ch + x]
                        nz = _put_coeffs(tb, proba[2], ctx,
                                         _random_levels(rng, 0, coeff_scale),
                                         0, False)
                        left_nz[ch + y] = mb[ch + x] = int(nz > 0)
    first_part = bw.finish()
    part_data = [p.finish() for p in parts]
    tag = (0 | (int(rng.integers(0, 4)) << 1) | (1 << 4)
           | (len(first_part) << 5))
    out = bytearray(struct.pack("<I", tag)[:3])
    out += b"\x9d\x01\x2a" + struct.pack("<HH", width, height)
    out += first_part
    for p in part_data[:-1]:
        out += struct.pack("<I", len(p))[:3]
    for p in part_data:
        out += p
    return bytes(out)


def _mode_paths():
    """mode -> [(node, bit), ...] from the root of libwebp's 4x4 tree."""
    paths = {}

    def walk(i, path):
        for bit in (0, 1):
            v = YMODES_INTRA4[2 * i + bit]
            if v <= 0:
                paths[-v] = path + [(i, bit)]
            else:
                walk(v, path + [(i, bit)])
    walk(0, [])
    return paths


MODE_PATHS = _mode_paths()


# ----------------------------------------------------------------------------
# VP8L


class BitWriter:
    """VP8L's LSB-first bit writer."""

    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(v >> i) & 1 for i in range(n)]

    def code8(self, sym):
        """A symbol of a code where 256 symbols are 8 bits long: the
        canonical code is the symbol, first bit its most significant."""
        self.bits += [(sym >> i) & 1 for i in range(7, -1, -1)]

    def tobytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8][::-1])), 2)
                     for i in range(0, len(bits), 8))


def _put_literal_codes(bw, green_alphabet=280):
    """Five prefix codes: 8-bit literals for green (symbols 0-255 of the
    green alphabet), red, blue and alpha; a 0-bit distance code."""
    for alphabet in (green_alphabet, 256, 256, 256):
        bw.put(0, 1)                       # normal code
        bw.put(19 - 4, 4)                  # all 19 code-length lengths
        order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
                 14, 15)
        for sym in order:
            bw.put(1 if sym in (0, 8) else 0, 3)
        bw.put(0, 1)                       # max_symbol = alphabet
        # code-length code: symbols 0 and 8, 1 bit each (0 -> "0", 8 ->
        # "1"); then 256 eights and the zeros.
        bw.bits += [1] * 256 + [0] * (alphabet - 256)
    bw.put(1, 1), bw.put(0, 1), bw.put(0, 1), bw.put(0, 1)  # dist: 1 sym


def _put_pixels(bw, argb):
    """The five prefix codes, then every pixel a literal."""
    _put_literal_codes(bw)
    for p in np.asarray(argb, np.uint32).reshape(-1):
        p = int(p)
        bw.code8((p >> 8) & 0xFF)
        bw.code8((p >> 16) & 0xFF)
        bw.code8(p & 0xFF)
        bw.code8(p >> 24)


def _put_sub_image(bw, argb):
    """A transform's or palette's image: no colour cache, literals."""
    bw.put(0, 1)
    _put_pixels(bw, argb)


def vp8l_transforms(rng, width, height, order=("predictor", "cross",
                                               "green"), palette=None,
                    alpha=True) -> bytes:
    """A VP8L stream (with its 5-byte header) of random transforms in
    `order` (read order) over random coded pixels; `palette` (a colour
    count) adds colour indexing first, with indices up to 255."""
    bw = BitWriter()
    bw.put(0x2F, 8)
    bw.put(width - 1, 14), bw.put(height - 1, 14)
    bw.put(int(alpha), 1), bw.put(0, 3)
    xsize = width
    if palette:
        bw.put(1, 1), bw.put(3, 2)
        bw.put(palette - 1, 8)
        _put_sub_image(bw, rng.integers(0, 2**32, palette, dtype=np.uint64)
                       .astype(np.uint32))
        bits = 0 if palette > 16 else 1 if palette > 4 else 2 if \
            palette > 2 else 3
        xsize = (width + (1 << bits) - 1) >> bits
    for name in order:
        bw.put(1, 1)
        if name == "green":
            bw.put(2, 2)
            continue
        bw.put(0 if name == "predictor" else 1, 2)
        size_bits = int(rng.integers(2, 5))
        bw.put(size_bits - 2, 3)
        tw = (xsize + (1 << size_bits) - 1) >> size_bits
        th = (height + (1 << size_bits) - 1) >> size_bits
        data = rng.integers(0, 2**32, (th, tw), dtype=np.uint64).astype(
            np.uint32)
        if name == "predictor":
            data = (data & ~np.uint32(0xF00)) | (
                rng.integers(0, 16, (th, tw)).astype(np.uint32) << 8)
        _put_sub_image(bw, data)
    bw.put(0, 1)                           # no more transforms
    pixels = rng.integers(0, 2**32, (height, xsize), dtype=np.uint64).astype(
        np.uint32)
    if palette:
        pixels &= np.uint32(0xFF00)
    bw.put(0, 1)                           # no colour cache
    bw.put(0, 1)                           # no meta codes
    _put_pixels(bw, pixels)
    return bw.tobytes()


# ----------------------------------------------------------------------------
# Containers


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return (fourcc + struct.pack("<I", len(payload)) + payload
            + b"\0" * (len(payload) & 1))


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x_chunk(width, height, alpha=False, animation=False, extra=0):
    flags = (0x10 if alpha else 0) | (0x02 if animation else 0) | extra
    return chunk(b"VP8X", struct.pack("<I", flags)
                 + struct.pack("<I", width - 1)[:3]
                 + struct.pack("<I", height - 1)[:3])


def alph_chunk(plane_or_stream, method=0, filt=0) -> bytes:
    """An ALPH chunk: method 0 takes the (already filtered) plane's bytes,
    method 1 a VP8L stream without its header."""
    data = plane_or_stream if isinstance(plane_or_stream, bytes) else \
        np.ascontiguousarray(plane_or_stream, np.uint8).tobytes()
    return chunk(b"ALPH", bytes([method | filt << 2]) + data)


def green_stream(plane) -> bytes:
    """A headerless VP8L stream whose green channel is `plane` (ALPH
    method 1), every pixel a literal."""
    bw = BitWriter()
    bw.put(0, 1)                           # no transform
    bw.put(0, 1), bw.put(0, 1)             # no cache, no meta codes
    _put_pixels(bw, np.asarray(plane, np.uint32) << 8)
    return bw.tobytes()


def anmf_chunk(frame_chunks: bytes, width, height, x=0, y=0) -> bytes:
    """A 100 ms frame at (x, y) (even), blended, not disposed."""
    head = (struct.pack("<I", x // 2)[:3] + struct.pack("<I", y // 2)[:3]
            + struct.pack("<I", width - 1)[:3]
            + struct.pack("<I", height - 1)[:3]
            + struct.pack("<I", 100)[:3] + bytes([0]))
    return chunk(b"ANMF", head + frame_chunks)


def anim_file(canvas, frames, alpha=True) -> bytes:
    """An animation: frames are (frame chunks, w, h, x, y)."""
    return riff(vp8x_chunk(*canvas, alpha=alpha, animation=True),
                chunk(b"ANIM", struct.pack("<IH", 0xFF336699, 0)),
                *(anmf_chunk(c, w, h, x, y) for c, w, h, x, y in frames))


def image_chunks(webp: bytes) -> bytes:
    """The ALPH/VP8/VP8L chunks of a still WebP file (PIL-written)."""
    pos, out = 12, b""
    while pos + 8 <= len(webp):
        fourcc = webp[pos:pos + 4]
        size = struct.unpack_from("<I", webp, pos + 4)[0]
        end = pos + 8 + size + (size & 1)
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            out += webp[pos:end]
        pos = end
    return out


def filter_alpha(plane, filt: int) -> np.ndarray:
    """libwebp's forward alpha filters (filters.c): 1 horizontal, 2
    vertical, 3 gradient, each predicting from the unfiltered
    neighbours (the first row from the left, the first column from
    above), the residual mod 256."""
    a = np.asarray(plane, np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    if filt == 0:
        return a.astype(np.uint8)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if filt == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif filt == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0,
                               255)
    return ((a - pred) % 256).astype(np.uint8)


def lossless_alph(plane, filt: int) -> bytes:
    """An ALPH chunk of method 1: the filtered plane as the green channel
    of a VP8L stream written by PIL's lossless encoder (libwebp's own
    alpha encoder does the same), its 5-byte VP8L header dropped."""
    import io

    from PIL import Image

    g = filter_alpha(plane, filt)
    rgb = np.zeros(g.shape + (3,), np.uint8)
    rgb[..., 1] = g
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "WEBP", lossless=True, method=6)
    vp8l = image_chunks(buf.getvalue())
    assert vp8l[:4] == b"VP8L"
    size = struct.unpack_from("<I", vp8l, 4)[0]
    return alph_chunk(vp8l[8 + 5:8 + size], method=1, filt=filt)
