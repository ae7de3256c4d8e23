"""The port's XPM reader: the pixels PIL returns for an X11 pixmap
(Pillow 12.1's XpmImagePlugin and its XpmDecoder), bit for bit, without
an imaging library.

Read as PIL reads it: "/* XPM */", then the first line that starts with
a quoted "width height colours chars-per-pixel"; one line a colour after
it, each its key (the chars-per-pixel bytes after the first one) and
pairs of words up to the line's last two bytes, the first "c" pair
giving the colour: "#" and a number int(..., 16) reads (its low 24 bits
as R, G, B) or "None" (PIL's transparency, which read_ldr's convert
drops, and no palette entry). The pixels follow, the quoted part of each
line (a "/* pixels */" line skipped once), chars-per-pixel bytes a key;
every key is looked up and appended to one stream until it holds the
image, which is then cut into rows: a line of more or fewer keys than a
row shifts the rows after it, as PIL's does. At most 256 colours make a
P image (the palette in the order of the colour lines, later lines of
a key replacing its colour in place), more an RGB one.

Refused as PIL refuses: UnidentifiedImageError where PIL's _open raises
SyntaxError or IndexError (no header line, a size of 0, a "c" without a
colour), passing the file on; ValueError where PIL lets ValueError or
KeyError out (a size field that is empty, a colour that is neither "#"
and hex nor "None", a colour line without "c", a key that is not in the
palette, 0 chars a pixel, too few pixels).

write_xpm writes an image of at most 256 colours as an XPM of two chars
a pixel, for the demo scenes' textures.
"""

from __future__ import annotations

import io
import re

import numpy as np

from tracerboy_tpu_torch.core.image_io import check_image_size
from tracerboy_tpu_torch.core.rawformats import unidentified

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def is_xpm(data: bytes) -> bool:
    """XpmImagePlugin._accept."""
    return data.startswith(b"/* XPM */")


def xpm_header(data: bytes, path: str = "<xpm>"):
    """XpmImageFile._open: (width, height, chars a pixel, the palette
    {key: RGB bytes} in PIL's order, the reader after the colour
    lines)."""
    if not is_xpm(data):
        raise unidentified(path, "not an XPM file")
    f = io.BytesIO(data)
    f.seek(9)
    while True:
        line = f.readline()
        if not line:
            raise unidentified(path, "broken XPM file")
        m = _HEAD.match(line)
        if m:
            break
    w, h, colours, bpp = (int(g) for g in m.groups())
    palette = {}
    for _ in range(colours):
        line = f.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                if i + 1 >= len(s):
                    raise unidentified(path, "XPM colour key without a "
                                       "colour")
                rgb = s[i + 1]
                if rgb == b"None":
                    pass                          # PIL's transparency
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = bytes(((v >> 16) & 255, (v >> 8) & 255,
                                        v & 255))
                else:
                    raise ValueError(f"{path}: cannot read this XPM file "
                                     f"(colour {rgb!r})")
                break
        else:
            raise ValueError(f"{path}: cannot read this XPM file (a "
                             "colour line without a colour key)")
    check_image_size(w, h, path)
    return w, h, bpp, palette, f


def _keys(f: io.BytesIO, bpp: int, need: int, path: str) -> list:
    """XpmDecoder.decode's lines: the quoted part of each, until the
    keys cover `need` pixels; the keys, line by line."""
    if bpp == 0:
        raise ValueError(f"{path}: XPM of 0 chars a pixel")
    lines, got, pixel_header = [], 0, False
    while got < need:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        lines.append(line)
        got += -(-len(line) // bpp)
    return lines


def read_xpm(data: bytes, path: str = "<xpm>") -> np.ndarray:
    """An XPM file's pixels as the JAX read_ldr gets them through PIL:
    (H, W, 3) uint8."""
    w, h, bpp, palette, f = xpm_header(data, path)
    keys = list(palette)
    table = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    lines = _keys(f, bpp, w * h, path)
    # Keys as integers (bpp bytes, big-endian), looked up all at once
    # where every line splits into whole keys and every key is bpp long.
    if bpp <= 7 and all(len(k) == bpp for k in keys) and all(
            len(line) % bpp == 0 for line in lines):
        stream = np.frombuffer(b"".join(lines), np.uint8).reshape(-1, bpp)
        codes = np.zeros(len(stream), np.int64)
        for k in range(bpp):
            codes = codes << 8 | stream[:, k]
        known = np.array([int.from_bytes(k, "big") for k in keys], np.int64)
        order = np.argsort(known)
        at = np.searchsorted(known[order], codes)
        at = np.minimum(at, max(len(keys) - 1, 0))
        if not keys or (known[order][at] != codes).any():
            raise ValueError(f"{path}: XPM pixel key not in the palette")
        index = order[at]
    else:
        where = {k: i for i, k in enumerate(keys)}
        try:
            index = np.array([where[line[i:i + bpp]] for line in lines
                              for i in range(0, len(line), bpp)], np.int64)
        except KeyError as e:
            raise ValueError(f"{path}: XPM pixel key {e} not in the "
                             "palette") from None
    if len(index) < w * h:
        raise ValueError(f"{path}: not enough image data (XPM)")
    # P (at most 256 colours) and RGB images alike: the key's colour.
    return table[index[:w * h].reshape(h, w)]


# Two printable chars a key (no '"' or '\\'): 16 x 16 keys.
_KEY_CHARS = b"abcdefghijklmnop"


def write_xpm(path: str, img: np.ndarray) -> None:
    """Write an RGB image of at most 256 colours, (H, W, 3) uint8, as an
    XPM: two chars a pixel, the colours in first-seen order."""
    h, w, _ = img.shape
    colours, index = np.unique(img.reshape(-1, 3), axis=0,
                               return_inverse=True)
    if len(colours) > 256:
        raise ValueError(f"write_xpm takes at most 256 colours, not "
                         f"{len(colours)}")
    keys = np.frombuffer(_KEY_CHARS, np.uint8)
    code = np.stack([keys[np.arange(len(colours)) >> 4],
                     keys[np.arange(len(colours)) & 15]], -1)
    lines = [b"/* XPM */", b"static char *texture[] = {",
             f'"{w} {h} {len(colours)} 2",'.encode()]
    lines += [b'"' + code[k].tobytes() + b" c #%02x%02x%02x" % tuple(c)
              + b'",' for k, c in enumerate(colours)]
    rows = np.full((h, 2 * w + 4), ord(","), np.uint8)
    rows[:, 0] = rows[:, -3] = ord('"')
    rows[:, -1] = ord("\n")
    rows[:, 1:-3] = code[index.reshape(h, w)].reshape(h, 2 * w)
    rows[-1, -2] = ord(" ")
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n" + rows.tobytes() + b"};\n")
