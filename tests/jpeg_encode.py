"""A baseline JPEG writer for the tests of the port's JPEG decoder.

PIL's encoder writes only the 4:4:4, 4:2:2 and 4:2:0 layouts and only
coefficients that come from an image. encode_coefficients writes any
quantised coefficient blocks under any sampling factors, component ids,
quantisation tables, restart interval and JFIF/Adobe markers, so that
tests/test_torch_jpeg.py can reach the layouts libjpeg accepts beyond
PIL's (h1v2, 4:1:1, 4x2 luma, ...) and out-of-range coefficients, and hold
the port's decoder against PIL's reading of the same file. encode_image
makes the blocks from an RGB, CMYK or grey image (float YCbCr, or YCCK
for a 4-channel image under an Adobe transform other than 0, box
downsampling, float DCT). Four components are written as any other
count: with or without an Adobe marker of any transform, and under any
sampling factors. The Huffman tables are flat: every DC category a 4-bit
code, every AC run/size symbol an 8-bit code.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
DC_SYMBOLS = list(range(12))
AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                             for s in range(1, 11)]


def _segment(code, body):
    return b"\xff" + bytes([code]) + struct.pack(">H", len(body) + 2) + body


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def _category(v):
    v = abs(int(v))
    return v.bit_length()


def _put_value(bits, v, s):
    if s:
        bits.put(v if v >= 0 else v + (1 << s) - 1, s)


def encode_coefficients(blocks, width, height, sampling, qtables,
                        ids=None, restart=0, jfif=True, adobe=None):
    """A baseline JPEG of quantised coefficients.

    blocks: per component an (rows, cols, 64) integer array in natural
      order, covering the MCU grid (mcu_rows * v, mcus_per_row * h)
      blocks of an interleaved scan (one scan of every component).
    sampling: per component (h, v). qtables: per component 64 quantisers
      in natural order (1-255). ids: component ids (default 1, 2, ...).
    adobe: None, or the APP14 transform flag to write."""
    nc = len(blocks)
    ids = list(ids or range(1, nc + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mpr = -(-width // (8 * hmax))
    mrows = -(-height // (8 * vmax))
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                adobe]))
    for c in range(nc):
        q = np.asarray(qtables[c]).astype(np.uint8)
        out += _segment(0xDB, bytes([c]) + q[ZIGZAG].tobytes())
    sof = struct.pack(">BHHB", 8, height, width, nc)
    for c in range(nc):
        h, v = sampling[c]
        sof += bytes([ids[c], (h << 4) | v, c])
    out += _segment(0xC0, sof)
    dc_bits = [0] * 16
    dc_bits[3] = len(DC_SYMBOLS)
    ac_bits = [0] * 16
    ac_bits[7] = len(AC_SYMBOLS)
    out += _segment(0xC4, bytes([0x00, *dc_bits, *DC_SYMBOLS]))
    out += _segment(0xC4, bytes([0x10, *ac_bits, *AC_SYMBOLS]))
    dc_code = {s: i for i, s in enumerate(DC_SYMBOLS)}
    ac_code = {s: i for i, s in enumerate(AC_SYMBOLS)}
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    sos = bytes([nc])
    for c in range(nc):
        sos += bytes([ids[c], 0x00])
    out += _segment(0xDA, sos + bytes([0, 63, 0]))
    bits = _Bits()
    pred = [0] * nc
    rst = 0
    for m in range(mpr * mrows):
        if restart and m and m % restart == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            pred = [0] * nc
        mr, mc = divmod(m, mpr)
        for c in range(nc):
            h, v = sampling[c]
            for y in range(v):
                for x in range(h):
                    blk = np.asarray(blocks[c][mr * v + y, mc * h + x])
                    zz = [int(t) for t in blk[ZIGZAG]]
                    diff = zz[0] - pred[c]
                    pred[c] = zz[0]
                    s = _category(diff)
                    bits.put(dc_code[s], 4)
                    _put_value(bits, diff, s)
                    run = 0
                    for k in range(1, 64):
                        if zz[k] == 0:
                            run += 1
                            continue
                        while run > 15:
                            bits.put(ac_code[0xF0], 8)
                            run -= 16
                        s = _category(zz[k])
                        bits.put(ac_code[(run << 4) | s], 8)
                        _put_value(bits, zz[k], s)
                        run = 0
                    if run:
                        bits.put(ac_code[0x00], 8)
    bits.flush()
    out += bits.out
    out += b"\xff\xd9"
    return bytes(out)


def _dct_matrix():
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return c[:, None] * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi
                               / 16)


def encode_image(img, sampling, qtables, **kwargs):
    """encode_coefficients of an (H, W, 3|4) or (H, W) uint8 image: JFIF
    YCbCr (RGB when kwargs asks for adobe=0), each component box-averaged
    down to its sampling factors, edge-replicated to the MCU grid. A
    4-channel image is written as its samples (CMYK: no Adobe marker, or
    transform 0) or as YCCK (another transform): the YCbCr of 255 less
    C, M and Y, and K."""
    img = np.asarray(img, np.float64)
    H, W = img.shape[:2]
    if img.ndim == 2:
        planes = [img]
    elif img.shape[2] == 4 and kwargs.get("adobe") in (None, 0):
        planes = [img[..., k] for k in range(4)]
    elif img.shape[2] == 4:
        r, g, b = 255 - img[..., 0], 255 - img[..., 1], 255 - img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128,
                  img[..., 3]]
    elif kwargs.get("adobe") == 0:
        planes = [img[..., k] for k in range(3)]
    else:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mpr = -(-W // (8 * hmax))
    mrows = -(-H // (8 * vmax))
    D = _dct_matrix()
    blocks = []
    for c, p in enumerate(planes):
        h, v = sampling[c]
        fx, fy = hmax // h, vmax // v
        full = np.pad(p, ((0, mrows * 8 * vmax - H), (0, mpr * 8 * hmax - W)),
                      mode="edge")
        small = full.reshape(full.shape[0] // fy, fy, full.shape[1] // fx,
                             fx).mean(axis=(1, 3))
        rows, cols = small.shape[0] // 8, small.shape[1] // 8
        b = small.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3) - 128
        coef = np.einsum("ij,rcjk,lk->rcil", D, b, D)
        q = np.asarray(qtables[c], np.float64).reshape(8, 8)
        blocks.append(np.round(coef / q).astype(np.int64).reshape(
            rows, cols, 64))
    return encode_coefficients(blocks, W, H, sampling, qtables, **kwargs)
