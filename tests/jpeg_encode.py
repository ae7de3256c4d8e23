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

PIL's encoder writes no arithmetic-coded and no lossless file, which
libjpeg-turbo (and so PIL) reads. encode_arithmetic writes the same
coefficient blocks arithmetic-coded (T.81 Annex D and F, the
statistics model of libjpeg's jcarith.c): sequential (SOF9) or
progressive (SOF10) under any scan script, any statistics table of each
component (0-15), DAC conditioning and restart intervals.
encode_lossless writes 8-bit sample planes as a lossless (SOF3) file:
Huffman-coded differences (jclhuff.c) under predictors 1-7, a point
transform, 1, 3 or 4 components interleaved or a scan each, restart
intervals, the predictions made as libjpeg's decoder makes them
(jddiffct.c restarts the predictors at the first row of the iMCU row in
which a restart marker falls).
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


def _frame_layout(width, height, sampling, unit=8):
    """(hmax, vmax, MCUs a row, MCU rows) of an interleaved frame."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    return (hmax, vmax, -(-width // (unit * hmax)),
            -(-height // (unit * vmax)))


def _markers(out, qtables, jfif, adobe):
    if jfif:
        out += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                adobe]))
    for c, q in enumerate(qtables or ()):
        q = np.asarray(q).astype(np.uint8)
        out += _segment(0xDB, bytes([c]) + q[ZIGZAG].tobytes())


def _sof(code, width, height, sampling, ids, tq=True):
    sof = struct.pack(">BHHB", 8, height, width, len(sampling))
    for c, (h, v) in enumerate(sampling):
        sof += bytes([ids[c], (h << 4) | v, c if tq else 0])
    return _segment(code, sof)


# jaricom.c jpeg_aritab (T.81 Table D.2): Qe << 16 | Next_Index_MPS << 8
# | Switch_MPS << 7 | Next_Index_LPS; state 113 the fixed estimate of 1/2.
ARITAB = [
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171]


class _ArithCoder:
    """jcarith.c's coder: arith_encode (D.1.4-D.1.6, with its 0xFF
    stacking and carry) and finish_pass (D.1.8)."""

    def __init__(self, out):
        self.out = out
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, byte):
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _flush_zeros(self):
        self.out.extend(bytes(self.zc))
        self.zc = 0

    def _byte_out(self, temp):
        """One byte of C (temp = C >> 19), with the carry into the
        buffered byte and the stacked 0xFF bytes."""
        if temp > 0xFF:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st, idx, val):
        sv = st[idx]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:                    # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[idx] = (sv & 0x80) ^ nl
        else:                                 # the more probable symbol
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[idx] = (sv & 0x80) ^ nm
        while True:                           # renormalise, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                self.out.extend(b"\xff\x00" * self.sc)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)


class _ArithModel:
    """The statistics of one scan (jcarith.c): 64 DC and 256 AC bins a
    table, the fixed bin, each component's DC predictor and context."""

    def __init__(self, coder, dac):
        self.e = coder
        self.L = [dac.get(t, 0x10) & 15 for t in range(16)]
        self.U = [dac.get(t, 0x10) >> 4 for t in range(16)]
        self.K = [dac.get(16 + t, 5) for t in range(16)]
        self.fixed = bytearray([113])
        self.dc, self.ac = {}, {}

    def reset(self, dc_tables, ac_tables, ncomp):
        for t in dc_tables:
            self.dc[t] = bytearray(64)
        for t in ac_tables:
            self.ac[t] = bytearray(256)
        self.last_dc = [0] * ncomp
        self.context = [0] * ncomp

    def magnitude(self, st, i, v, x1_stats, x1):
        """Figures F.8-F.9: the category and bits of v - 1 from bin i."""
        e = self.e
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            if x1 is None:                    # DC: X1 right away
                st, i = x1_stats, 20
                v2 >>= 1
                while v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
            else:                             # AC: a second bit at SE+2
                v2 >>= 1
                if v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    st, i = x1_stats, x1
                    v2 >>= 1
                    while v2:
                        e.encode(st, i, 1)
                        m <<= 1
                        i += 1
                        v2 >>= 1
        e.encode(st, i, 0)
        i += 14
        m >>= 1
        while m:
            e.encode(st, i, 1 if m & v else 0)
            m >>= 1
        return m

    def dc_diff(self, ci, tbl, value):
        """Figure F.4 with the conditioning of F.1.4.4.1.2."""
        st, s0 = self.dc[tbl], self.context[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            self.e.encode(st, s0, 0)
            self.context[ci] = 0
            return
        self.last_dc[ci] = value
        self.e.encode(st, s0, 1)
        sign = 1 if v < 0 else 0
        self.e.encode(st, s0 + 1, sign)
        a = abs(v)
        m = (a - 1).bit_length() and 1 << ((a - 1).bit_length() - 1)
        self.magnitude(st, s0 + 2 + sign, a, st, None)
        if m < (1 << self.L[tbl]) >> 1:
            self.context[ci] = 0
        elif m > (1 << self.U[tbl]) >> 1:
            self.context[ci] = 12 + 4 * sign
        else:
            self.context[ci] = 4 + 4 * sign

    def ac_band(self, tbl, zz, ss, se):
        """Figure F.5 over k = ss..se of the (point-transformed) zigzag
        values zz."""
        st = self.ac[tbl]
        ke = 0
        for k in range(se, ss - 1, -1):
            if zz[k]:
                ke = k
                break
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            self.e.encode(st, i, 0)           # not EOB
            while zz[k] == 0:
                self.e.encode(st, i + 1, 0)
                i += 3
                k += 1
            self.e.encode(st, i + 1, 1)
            v = zz[k]
            self.e.encode(self.fixed, 0, 1 if v < 0 else 0)
            self.magnitude(st, i + 2, abs(v), st,
                           189 if k <= self.K[tbl] else 217)
            k += 1
        if k <= se:
            self.e.encode(st, 3 * (k - 1), 1)  # EOB

    def ac_refine(self, tbl, mag, prev, ss, se):
        """Figure G.10: mag the |coefficients| >> Al, prev those >> Ah,
        signs in mag's sign."""
        st = self.ac[tbl]
        ke = 0
        for k in range(se, 0, -1):
            if mag[k]:
                ke = k
                break
        kex = 0
        for k in range(ke, 0, -1):
            if prev[k]:
                kex = k
                break
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                self.e.encode(st, i, 0)
            while True:
                v = mag[k]
                if v:
                    if prev[k]:
                        self.e.encode(st, i + 2, abs(v) & 1)
                    else:
                        self.e.encode(st, i + 1, 1)
                        self.e.encode(self.fixed, 0, 1 if v < 0 else 0)
                    break
                self.e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            self.e.encode(st, 3 * (k - 1), 1)


def simple_progression(nc):
    """libjpeg's jpeg_simple_progression script as (components, Ss, Se,
    Ah, Al) scans (for 3 components YCbCr's; otherwise its generic one)."""
    if nc == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    comps = tuple(range(nc))
    script = [(comps, 0, 0, 0, 1)]
    script += [((c,), 1, 5, 0, 2) for c in comps]
    script += [((c,), 6, 63, 0, 2) for c in comps]
    script += [((c,), 1, 63, 2, 1) for c in comps]
    script += [(comps, 0, 0, 1, 0)]
    script += [((c,), 1, 63, 1, 0) for c in comps]
    return script


def encode_arithmetic(blocks, width, height, sampling, qtables, ids=None,
                      restart=0, jfif=True, adobe=None, scans=None,
                      progressive=False, tables=None, dac=None):
    """An arithmetic-coded JPEG of quantised coefficient blocks (the
    arguments of encode_coefficients).

    scans: (components, Ss, Se, Ah, Al) tuples (default: one interleaved
      sequential scan, or simple_progression when progressive); a
      sequential frame (SOF9) codes each named component whole.
    tables: per component its (DC, AC) statistics table, 0-15 (default
      (0, 0) for the first component, (1, 1) for the others).
    dac: {table index: value} of a DAC segment, 0-15 a DC table's U << 4
      | L, 16-31 an AC table's K (none written by default: L 0, U 1,
      K 5)."""
    nc = len(blocks)
    ids = list(ids or range(1, nc + 1))
    tables = tables or [(0, 0)] + [(1, 1)] * (nc - 1)
    dac = dict(dac or {})
    hmax, vmax, mpr, mrows = _frame_layout(width, height, sampling)
    if scans is None:
        scans = (simple_progression(nc) if progressive
                 else [(tuple(range(nc)), 0, 63, 0, 0)])
    out = bytearray(b"\xff\xd8")
    _markers(out, qtables, jfif, adobe)
    out += _sof(0xCA if progressive else 0xC9, width, height, sampling, ids)
    if dac:
        out += _segment(0xCC, b"".join(bytes([k, v])
                                       for k, v in sorted(dac.items())))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    zz = [np.asarray(b, np.int64)[..., ZIGZAG] for b in blocks]
    for comps, ss, se, ah, al in scans:
        sos = bytes([len(comps)])
        for c in comps:
            sos += bytes([ids[c], (tables[c][0] << 4) | tables[c][1]])
        out += _segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        out += _arith_scan(zz, comps, ss, se, ah, al, progressive, sampling,
                           width, height, mpr, mrows, hmax, vmax, tables,
                           dac, restart)
    out += b"\xff\xd9"
    return bytes(out)


def _scan_blocks(comps, sampling, width, height, mpr, mrows, hmax, vmax):
    """The MCUs of a scan, each a list of (component, block row, block
    column): interleaved over the MCU grid, else the component's own
    blocks (ceil(downsampled size / 8) of them)."""
    if len(comps) > 1:
        for m in range(mpr * mrows):
            mr, mc = divmod(m, mpr)
            yield [(c, mr * sampling[c][1] + y, mc * sampling[c][0] + x)
                   for c in comps for y in range(sampling[c][1])
                   for x in range(sampling[c][0])]
        return
    (c,) = comps
    h, v = sampling[c]
    wib = -(-(-(-width * h // hmax)) // 8)
    hib = -(-(-(-height * v // vmax)) // 8)
    for r in range(hib):
        for col in range(wib):
            yield [(c, r, col)]


def _arith_scan(zz, comps, ss, se, ah, al, progressive, sampling, width,
                height, mpr, mrows, hmax, vmax, tables, dac, restart):
    data = bytearray()
    coder = _ArithCoder(data)
    model = _ArithModel(coder, dac)
    dc_scan = not progressive or ss == 0
    dc_tabs = ({tables[c][0] for c in comps}
               if not progressive or (ss == 0 and ah == 0) else set())
    ac_tabs = ({tables[c][1] for c in comps}
               if not progressive or se else set())
    slot = {c: j for j, c in enumerate(comps)}
    model.reset(dc_tabs, ac_tabs, len(comps))
    rst = 0
    for n, mcu in enumerate(_scan_blocks(comps, sampling, width, height,
                                         mpr, mrows, hmax, vmax)):
        if restart and n and n % restart == 0:
            coder.finish()
            data += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            model.reset(dc_tabs, ac_tabs, len(comps))
            coder.reset()
        for c, r, col in mcu:
            z = [int(t) for t in zz[c][r, col]]
            dct, act = tables[c]
            if not progressive:
                model.dc_diff(slot[c], dct, z[0])
                model.ac_band(act, z, 1, 63)
            elif dc_scan and ah == 0:
                model.dc_diff(slot[c], dct, z[0] >> al)
            elif dc_scan:
                coder.encode(model.fixed, 0, (z[0] >> al) & 1)
            else:
                mag = [(abs(t) >> al) * (1 if t >= 0 else -1) for t in z]
                if ah == 0:
                    model.ac_band(act, mag, ss, se)
                else:
                    prev = [abs(t) >> ah for t in z]
                    model.ac_refine(act, mag, prev, ss, se)
    coder.finish()
    return bytes(data)


def _predict(psv, ra, rb, rc):
    """jdlossls.c's predictors 1-7."""
    return (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]


def _differences(row, prev, first, psv, pt):
    """One row's differences as libjpeg undifferences them: the initial
    predictor 1 << (7 - pt) then Ra on a first row, Rb in the first column
    and predictor psv elsewhere after it."""
    d = [0] * len(row)
    for x, s in enumerate(row):
        if first:
            p = (1 << (7 - pt)) if x == 0 else row[x - 1]
        elif x == 0:
            p = prev[0]
        else:
            p = _predict(psv, row[x - 1], prev[x], prev[x - 1])
        d[x] = s - p
    return d


def encode_lossless(planes, width, height, sampling, psv=1, pt=0,
                    ids=None, restart=0, jfif=False, adobe=None,
                    interleaved=True):
    """A lossless (SOF3) JPEG of per-component uint8 sample planes, each
    (ceil(height * v / vmax), ceil(width * h / hmax)), their samples
    shifted right by pt before coding (so PIL reads each sample back with
    its low pt bits clear). One interleaved scan, or a scan a component;
    restart: the interval in MCUs (a multiple of the MCUs of a row, as
    libjpeg requires). Differences are Huffman-coded under a flat table of
    17 categories, a 5-bit code each."""
    nc = len(planes)
    ids = list(ids or range(1, nc + 1))
    hmax, vmax, mpr, mrows = _frame_layout(width, height, sampling, unit=1)
    out = bytearray(b"\xff\xd8")
    _markers(out, None, jfif, adobe)
    out += _sof(0xC3, width, height, sampling, ids, tq=False)
    bits = [0] * 16
    bits[4] = 17
    out += _segment(0xC4, bytes([0x00, *bits, *range(17)]))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    scans = [tuple(range(nc))] if interleaved else [(c,) for c in range(nc)]
    for comps in scans:
        sos = bytes([len(comps)]) + b"".join(bytes([ids[c], 0x00])
                                             for c in comps)
        out += _segment(0xDA, sos + bytes([psv, 0, pt]))
        out += _lossless_scan(planes, comps, sampling, mpr, mrows, psv, pt,
                              restart)
    out += b"\xff\xd9"
    return bytes(out)


def _lossless_scan(planes, comps, sampling, mpr, mrows, psv, pt, restart):
    """jddiffct.c's loop run backwards: per iMCU row, the restarts that
    fall in it, then its rows' differences (the first row after a restart
    predicted as a first row), then its MCU rows coded."""
    bits = _Bits()
    inter = len(comps) > 1
    if not inter:
        mpr = planes[comps[0]].shape[1]
    rows_to_go = restart // mpr if restart else 0
    first = {c: True for c in comps}
    prev = {c: None for c in comps}
    rst = 0
    for im in range(mrows):
        if inter:
            n_rows = 1
        else:
            h, v = planes[comps[0]].shape[0], sampling[comps[0]][1]
            n_rows = v if im < mrows - 1 or h % v == 0 else h % v
        restarts = []
        for y in range(n_rows):
            if restart and rows_to_go == 0:
                restarts.append(y)
                rows_to_go = restart // mpr
            if restart:
                rows_to_go -= 1
        if restarts:
            first = {c: True for c in comps}
        diffs = {}
        for c in comps:
            plane = planes[c].astype(np.int64) >> pt
            v = sampling[c][1]
            width = mpr * sampling[c][0] if inter else plane.shape[1]
            rows = []
            for r in range(v):
                y = im * v + r
                if y >= plane.shape[0]:
                    rows.append([0] * width)   # dummy rows
                    continue
                row = [int(t) for t in plane[y]]
                d = _differences(row, prev[c], first[c], psv, pt)
                first[c] = False
                prev[c] = row
                rows.append(d + [0] * (width - len(d)))
            diffs[c] = rows
        for y in range(n_rows):
            if y in restarts:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
            for m in range(mpr):
                if not inter:
                    _put_diff(bits, diffs[comps[0]][y][m])
                    continue
                for c in comps:
                    h, v = sampling[c]
                    for yy in range(v):
                        for xx in range(h):
                            _put_diff(bits, diffs[c][yy][m * h + xx])
    bits.flush()
    return bytes(bits.out)


def _put_diff(bits, d):
    s = _category(d)
    bits.put(s, 5)
    _put_value(bits, d, s)


def _dct_matrix():
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return c[:, None] * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi
                               / 16)


# The IJG example tables (T.81 Annex K), natural order.
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)


def quality_tables(quality, nc=3):
    """Per component the quantisers libjpeg's jpeg_set_quality makes of
    the example tables (luma for the first component, chroma after)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    luma, chroma = ((np.clip((t * scale + 50) // 100, 1, 255))
                    for t in (STD_LUMA, STD_CHROMA))
    return [luma] + [chroma] * (nc - 1)


def image_blocks(img, sampling, qtables, adobe=None):
    """The quantised coefficient blocks of an (H, W, 3|4) or (H, W) uint8
    image, per component (rows, cols, 64) over the MCU grid: JFIF YCbCr
    (RGB under adobe=0), each component box-averaged down to its
    sampling factors, edge-replicated to the MCU grid. A 4-channel image
    is taken as its samples (CMYK: no Adobe marker, or transform 0) or as
    YCCK (another transform): the YCbCr of 255 less C, M and Y, and K."""
    img = np.asarray(img, np.float64)
    H, W = img.shape[:2]
    if img.ndim == 2:
        planes = [img]
    elif img.shape[2] == 4 and adobe in (None, 0):
        planes = [img[..., k] for k in range(4)]
    elif img.shape[2] == 4:
        r, g, b = 255 - img[..., 0], 255 - img[..., 1], 255 - img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128,
                  img[..., 3]]
    elif adobe == 0:
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
    return blocks


def encode_image(img, sampling, qtables, **kwargs):
    """encode_coefficients of image_blocks(img, ...)."""
    H, W = np.shape(img)[:2]
    return encode_coefficients(
        image_blocks(img, sampling, qtables, kwargs.get("adobe")), W, H,
        sampling, qtables, **kwargs)


def arithmetic_image(img, sampling, qtables, **kwargs):
    """encode_arithmetic of image_blocks(img, ...)."""
    H, W = np.shape(img)[:2]
    return encode_arithmetic(
        image_blocks(img, sampling, qtables, kwargs.get("adobe")), W, H,
        sampling, qtables, **kwargs)
