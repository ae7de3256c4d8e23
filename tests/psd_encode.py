"""A small PSD and PNM writer for the tests of the port's readers
(core/psd.py, core/pnm.py).

PIL writes no PSD and only P4/P5/P6 (and Pf) PNMs; this writes:
- PSD composites in every colour mode PIL opens (bitmap, grey, palette,
  RGB, RGBA, CMYK, multichannel, duotone, Lab) at 8 bits (1 for bitmap,
  16 or 32 to be refused), raw or PackBits (per-row 16-bit counts,
  packets that may cross a row's end), with colour mode data, image
  resources and a layer block to skip (psd_file);
- PNMs PIL does not write: plain P1-P3 at any maxval with comments and
  odd spacing, raw P5/P6 at any maxval (1- or 2-byte samples), Pf in
  either byte order, and PIL's P0CMYK/PyP/PyRGBA/PyCMYK headers
  (pnm_file).
"""

from __future__ import annotations

import struct

import numpy as np


def packbits_row(row: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (257 - n, byte), literals
    of up to 128 bytes as (n - 1, bytes)."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), row[i]])
            i = j + 1
            continue
        j = i
        while (j + 1 < n and j - i < 127
               and not (j + 2 < n and row[j + 1] == row[j + 2])):
            j += 1
        out += bytes([j - i]) + row[i:j + 1]
        i = j + 1
    return bytes(out)


def psd_file(planes, cmode: int, bits: int = 8, compression: int = 0,
             colour_data: bytes = b"", resources=(), layer_block=b"",
             rows=None) -> bytes:
    """A PSD of `planes` ((C, H, rowbytes) uint8, bitmap rows packed MSB
    first): colour mode `cmode`, raw (0) or PackBits (1) composite data.
    resources are (id, name, data); `rows` replaces the PackBits rows (a
    list per channel), their counts written as they are."""
    planes = np.asarray(planes, np.uint8)
    c, h, rowbytes = planes.shape
    width = rowbytes * 8 if bits == 1 else rowbytes
    out = bytearray(b"8BPS" + struct.pack(">H", 1) + bytes(6))
    out += struct.pack(">HIIHH", c, h, width, bits, cmode)
    out += struct.pack(">I", len(colour_data)) + colour_data
    res = bytearray()
    for rid, name, data in resources:
        res += b"8BIM" + struct.pack(">H", rid) + bytes([len(name)]) + name
        if not len(name) & 1:
            res += b"\0"
        res += struct.pack(">I", len(data)) + data
        if len(data) & 1:
            res += b"\0"
    out += struct.pack(">I", len(res)) + res
    if layer_block:
        out += struct.pack(">I", len(layer_block) + 4)
        out += struct.pack(">I", len(layer_block)) + layer_block
    else:
        out += struct.pack(">I", 0)
    out += struct.pack(">H", compression)
    if compression == 1:
        if rows is None:
            rows = [[packbits_row(bytes(planes[k, y])) for y in range(h)]
                    for k in range(c)]
        for ch in rows:
            out += b"".join(struct.pack(">H", len(r)) for r in ch)
        for ch in rows:
            out += b"".join(ch)
    else:
        out += planes.tobytes()
    return bytes(out)


def pnm_file(magic: bytes, values, maxval=None, comments=False,
             sep=b" ", scale=None) -> bytes:
    """A PNM: magic, size, maxval (not for P1/P4, the scale for Pf),
    then the samples: plain decimal tokens for P1-P3 (P1 without
    separators when sep is b""), bytes (maxval < 256) or big-endian
    16-bit words for the raw headers, packed rows for P4, floats for
    Pf."""
    values = np.asarray(values)
    h, w = values.shape[:2]
    head = magic + b"\n"
    if comments:
        head += b"# a comment\n"
    head += b"%d %d\n" % (w, h)
    if magic == b"Pf":
        head += b"%r\n" % scale
        order = "<f4" if scale < 0 else ">f4"
        return head + values[::-1].astype(order).tobytes()
    if magic not in (b"P1", b"P4"):
        head += b"%d\n" % maxval
    if magic in (b"P1", b"P2", b"P3"):
        body = sep.join(b"%d" % v for v in values.reshape(-1))
        if comments:
            body = body.replace(b" ", b" #x\n", 3)
        return head + body + b"\n"
    if magic == b"P4":
        return head + np.packbits(values.astype(np.uint8), axis=1).tobytes()
    if maxval < 256:
        return head + values.astype(np.uint8).tobytes()
    return head + values.astype(">u2").tobytes()
