"""AVIF files for the port's AVIF reader's tests: Pillow's encoder (aom
3.12 through libavif 1.3) with the in-loop filters off, aom's film grain
tables, and rewrites of the HEIF box tree where Pillow has no option:
the colr nclx values, a colr box dropped, the items' data moved into an
idat box (iloc construction method 1), iloc versions and field sizes,
the ftyp's brands, a 64-bit box size. No AV1 stream is written here: every frame
is aom's.
"""

from __future__ import annotations

import io
import struct

import numpy as np

# The in-loop filters off (deblocking, CDEF, loop restoration), and intra
# block copy, which aom turns on by itself for screen-like content.
FILTERS_OFF = {"enable-cdef": "0", "enable-restoration": "0",
               "loopfilter-control": "0", "enable-intrabc": "0"}


def pil_avif(img, advanced=None, **kw) -> bytes:
    """Pillow's AVIF of img (a PIL image or an array) with the filters
    off; advanced adds aom options, kw Pillow's own."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    adv = dict(FILTERS_OFF)
    adv.update(advanced or {})
    out = io.BytesIO()
    img.save(out, "AVIF", advanced=adv, **kw)
    return out.getvalue()


def pil_default(img, **kw) -> bytes:
    """Pillow's AVIF with aom's defaults (the in-loop filters on); an
    `advanced` keyword adds aom options."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    out = io.BytesIO()
    img.save(out, "AVIF", **kw)
    return out.getvalue()


def grain_table(seed=7391, lag=0, ar_shift=7, scale_shift=0,
                scaling_shift=8, from_luma=0, overlap=0, y_points=(),
                cb_points=(), cr_points=(), cb=(128, 192, 256),
                cr=(128, 192, 256), ar_y=(), ar_cb=(), ar_cr=()) -> str:
    """aom's film grain table (grain_table.c's "filmgrn1" text) of one
    entry for every time stamp: its field order, with the AR coefficients
    signed and cb/cr as (mult, luma mult, offset) as coded (128 and 256
    are 0). ar_cb and ar_cr hold 2 lag (lag + 1) + 1 values (aom writes
    the last, the luma term, even without luma points)."""
    n = 2 * lag * (lag + 1)
    ar_cb = list(ar_cb) + [0] * (n + 1 - len(ar_cb))
    ar_cr = list(ar_cr) + [0] * (n + 1 - len(ar_cr))
    ar_y = list(ar_y) + [0] * (n - len(ar_y))

    def points(tag, pts):
        return f"\t{tag} {len(pts)}" + "".join(f" {x} {y}" for x, y in pts)

    return "\n".join([
        "filmgrn1", f"E 0 9223372036854775807 1 {seed} 1",
        f"\tp {lag} {ar_shift} {scale_shift} {scaling_shift} {from_luma} "
        f"{overlap} {cb[0]} {cb[1]} {cb[2]} {cr[0]} {cr[1]} {cr[2]}",
        points("sY", y_points), points("sCb", cb_points),
        points("sCr", cr_points),
        "\tcY" + "".join(f" {v}" for v in ar_y[:n]),
        "\tcCb" + "".join(f" {v}" for v in ar_cb),
        "\tcCr" + "".join(f" {v}" for v in ar_cr), ""])


def pil_grain(img, table: str, **kw) -> bytes:
    """Pillow's default save with aom's film-grain-table option pointing
    at `table` (grain_table's text), written to a temporary file."""
    import os
    import tempfile

    adv = dict(kw.pop("advanced", {}))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grain.tbl")
        with open(path, "w") as f:
            f.write(table)
        adv["film-grain-table"] = path
        return pil_default(img, advanced=adv, **kw)


def box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def full_box(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(typ, bytes([version]) + flags.to_bytes(3, "big") + payload)


def boxes(data: bytes, start: int = 0, end: int | None = None):
    """[(type, payload start, payload end)] of the boxes in data."""
    end = len(data) if end is None else end
    out, off = [], start
    while off + 8 <= end:
        size, typ = struct.unpack(">I4s", data[off:off + 8])
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[off + 8:off + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - off
        out.append((typ, off + hdr, off + size))
        off += size
    return out


def _top(data: bytes) -> dict:
    return {t: (s, e) for t, s, e in boxes(data)}


def set_nclx(data: bytes, cp=None, tc=None, mc=None, full=None) -> bytes:
    """The colour item's colr nclx values rewritten in place."""
    d = bytearray(data)
    i = d.find(b"colrnclx")
    assert i >= 0, "no nclx colr box"
    p = i + 8
    for k, v in enumerate((cp, tc, mc)):
        if v is not None:
            d[p + 2 * k:p + 2 * k + 2] = struct.pack(">H", v)
    if full is not None:
        d[p + 6] = 0x80 if full else 0
    return bytes(d)


def drop_colr(data: bytes) -> bytes:
    """Every colr property renamed free (an unknown property libavif
    skips): CICP and range then come from the AV1 sequence header."""
    return data.replace(b"colrnclx", b"freenclx").replace(b"colrprof",
                                                          b"freeprof")


def set_brands(data: bytes, major: bytes, compatible) -> bytes:
    """The ftyp rewritten with these brands (the file's offsets kept by
    moving the first box after it only where the size is unchanged)."""
    t = _top(data)
    s, e = t[b"ftyp"]
    new = box(b"ftyp", major + b"\0\0\0\0" + b"".join(compatible))
    old = data[s - 8:e]
    assert len(new) == len(old), "the ftyp must keep its size"
    return data[:s - 8] + new + data[e:]


def _meta_parts(data: bytes):
    """(ftyp bytes, [(type, payload)] of the meta's children, {item:
    payload bytes}, the iloc's item order, trailing top-level boxes other
    than mdat)."""
    t = boxes(data)
    ftyp = next(data[s - 8:e] for typ, s, e in t if typ == b"ftyp")
    ms, me = next((s, e) for typ, s, e in t if typ == b"meta")
    children = [(typ, data[s:e]) for typ, s, e in boxes(data, ms + 4, me)]
    iloc = next(p for typ, p in children if typ == b"iloc")
    idat = next((p for typ, p in children if typ == b"idat"), b"")
    items, order = _read_iloc(iloc, data, idat)
    rest = [data[s - 8:e] for typ, s, e in t
            if typ not in (b"ftyp", b"meta", b"mdat")]
    return ftyp, children, items, order, rest


def _read_iloc(p: bytes, data: bytes, idat: bytes):
    v = p[0]
    pos = 4
    osz, lsz = p[pos] >> 4, p[pos] & 15
    bsz, isz = p[pos + 1] >> 4, (p[pos + 1] & 15) if v else 0
    pos += 2

    def rd(n):
        nonlocal pos
        x = int.from_bytes(p[pos:pos + n], "big") if n else 0
        pos += n
        return x

    items, order = {}, []
    for _ in range(rd(2 if v < 2 else 4)):
        iid = rd(2 if v < 2 else 4)
        method = rd(2) & 15 if v in (1, 2) else 0
        rd(2)
        base = rd(bsz)
        parts = []
        for _ in range(rd(2)):
            rd(isz)
            off, ln = base + rd(osz), rd(lsz)
            src = idat if method == 1 else data
            parts.append(src[off:off + ln])
        items[iid] = b"".join(parts)
        order.append(iid)
    return items, order


def relocate(data: bytes, idat: bool = False, version: int = 0,
             offset_size: int = 4, length_size: int = 4,
             base_offset_size: int = 0, split: int = 1,
             big_mdat: bool = False) -> bytes:
    """The file rebuilt with its items' data placed anew: in an idat box
    (construction method 1, iloc version 1 or 2) or an mdat after the
    meta; the iloc written at this version and with these field sizes;
    each item's data in `split` extents; the mdat's size as a 64-bit
    largesize where big_mdat."""
    ftyp, children, items, order, rest = _meta_parts(data)
    if idat and version == 0:
        version = 1
    count = 2 if version < 2 else 4

    def iloc(offsets):
        out = bytes([offset_size << 4 | length_size,
                     base_offset_size << 4])
        out += len(order).to_bytes(count, "big")
        for iid in order:
            out += iid.to_bytes(count, "big")
            if version in (1, 2):
                out += (1 if idat else 0).to_bytes(2, "big")
            out += b"\0\0" + (0).to_bytes(base_offset_size, "big")
            exts = offsets[iid]
            out += len(exts).to_bytes(2, "big")
            for off, ln in exts:
                out += off.to_bytes(offset_size, "big")
                out += ln.to_bytes(length_size, "big")
        return full_box(b"iloc", version, 0, out)

    def pieces(payload):
        step = -(-len(payload) // split)
        return [payload[k:k + step] for k in range(0, len(payload), step)]

    def build(base):
        offsets, pos, blob = {}, base, b""
        for iid in order:
            exts = []
            for piece in pieces(items[iid]):
                exts.append((pos, len(piece)))
                pos += len(piece)
                blob += piece
            offsets[iid] = exts
        kids = b""
        for typ, payload in children:
            if typ == b"iloc":
                kids += iloc(offsets)
            elif typ == b"idat":
                continue
            else:
                kids += box(typ, payload)
        if idat:
            kids += box(b"idat", blob)
        return full_box(b"meta", 0, 0, kids), blob

    meta, blob = build(0)
    if idat:
        return ftyp + meta + b"".join(rest)
    hdr = 16 if big_mdat else 8
    base = len(ftyp) + len(meta) + sum(map(len, rest)) + hdr
    meta, blob = build(base)
    mdat = (struct.pack(">I4sQ", 1, b"mdat", 16 + len(blob)) if big_mdat
            else struct.pack(">I4s", 8 + len(blob), b"mdat")) + blob
    return ftyp + meta + b"".join(rest) + mdat


def item_properties(data: bytes) -> dict:
    """{item ID: [(type, payload, essential)]} of a file's meta, in ipma
    order."""
    t = boxes(data)
    ms, me = next((s, e) for typ, s, e in t if typ == b"meta")
    kids = {typ: (s, e) for typ, s, e in boxes(data, ms + 4, me)}
    s, e = kids[b"iprp"]
    sub = {typ: (a, b) for typ, a, b in boxes(data, s, e)}
    props = [(typ, data[a:b]) for typ, a, b in boxes(data, *sub[b"ipco"])]
    a, b = sub[b"ipma"]
    v, flags = data[a], int.from_bytes(data[a + 1:a + 4], "big")
    pos, out = a + 8, {}
    for _ in range(int.from_bytes(data[a + 4:a + 8], "big")):
        n = 2 if v == 0 else 4
        iid = int.from_bytes(data[pos:pos + n], "big")
        pos += n
        count, pos = data[pos], pos + 1
        out[iid] = []
        for _ in range(count):
            k = 2 if flags & 1 else 1
            x = int.from_bytes(data[pos:pos + k], "big")
            pos += k
            ess = bool(x >> (8 * k - 1))
            idx = x & ((1 << (8 * k - 1)) - 1)
            out[iid].append((*props[idx - 1], ess))
    return out


def grid_payload(rows: int, cols: int, width: int, height: int,
                 big: bool = False, version: int = 0) -> bytes:
    """An ImageGrid (HEIF 6.6.2.3.2): version, flags (bit 0: 32-bit
    output sizes), rows - 1, columns - 1, output width and height."""
    n = 4 if big else 2
    return (bytes([version, int(big), rows - 1, cols - 1])
            + width.to_bytes(n, "big") + height.to_bytes(n, "big"))


def ispe(width: int, height: int) -> tuple:
    return (b"ispe", b"\0\0\0\0" + struct.pack(">II", width, height), False)


def make_grid(tiles, rows: int, cols: int, width: int, height: int,
              big: bool = False, alpha: bool = False, prem: bool = False,
              payload: bytes | None = None,
              alpha_payload: bytes | None = None,
              grid_props=None, alpha_grid_props=None, in_idat: bool = True,
              primary_type: bytes = b"grid",
              hidden: bool = True, tile_props=None, tile_types=None,
              dimg=None) -> bytes:
    """A grid image assembled from Pillow's AVIFs of its tiles (in raster
    order): one grid item (the primary) with a dimg reference to each
    tile's colour item, and with alpha an alpha grid item (auxl to the
    grid, auxC alpha, a prem reference where prem) with dimg references to
    each tile's alpha item. The grid items take an ispe of the output
    size and the first tile's pixi and colr (or grid_props and
    alpha_grid_props: [(type, payload, essential)]); each tile item keeps
    its own properties. The ImageGrid payloads (or `payload` and
    `alpha_payload`) lie in an idat (construction method 1) or the mdat;
    tile items are hidden as avifenc writes them. tile_props and
    tile_types ({tile index: properties or item type}) replace a tile's
    own, dimg (a list of tile indices) the grid's references."""
    parts = [(item_properties(t), _meta_parts(t)[2]) for t in tiles]
    n = len(tiles)
    grid_id, alpha_id = 1, n + 2
    first_props = parts[0][0]

    def pick(props, kinds):
        return [p for p in props if p[0] in kinds]

    if grid_props is None:
        grid_props = [ispe(width, height)] + pick(first_props[1],
                                                  (b"pixi", b"colr"))
    if alpha_grid_props is None and alpha:
        alpha_grid_props = [ispe(width, height)] + pick(
            first_props[2], (b"pixi", b"auxC"))
    payload = payload or grid_payload(rows, cols, width, height, big)
    alpha_payload = alpha_payload or payload
    items = [(grid_id, primary_type, b"Color", grid_props, payload, False)]
    for k, (props, data) in enumerate(parts):
        items.append((2 + k, (tile_types or {}).get(k, b"av01"), b"Tile",
                      (tile_props or {}).get(k, props[1]), data[1], hidden))
    if alpha:
        items.append((alpha_id, b"grid", b"Alpha", alpha_grid_props,
                      alpha_payload, False))
        for k, (props, data) in enumerate(parts):
            items.append((alpha_id + 1 + k, b"av01", b"Tile", props[2],
                          data[2], hidden))
    ipco, index = [], {}
    for it in items:
        for typ, p, _ in it[3]:
            if (typ, p) not in index:
                ipco.append(box(typ, p))
                index[typ, p] = len(ipco)
    ipma = struct.pack(">I", len(items))
    for iid, _, _, props, _, _ in items:
        ipma += struct.pack(">HB", iid, len(props))
        ipma += bytes((0x80 if ess else 0) | index[typ, p]
                      for typ, p, ess in props)
    infe = b"".join(full_box(b"infe", 2, int(hid),
                             struct.pack(">HH", iid, 0) + typ + name + b"\0")
                    for iid, typ, name, _, _, hid in items)
    refs = [(b"dimg", grid_id, [2 + k for k in (
        range(n) if dimg is None else dimg)])]
    if alpha:
        refs += [(b"auxl", alpha_id, [grid_id]),
                 (b"dimg", alpha_id, list(range(alpha_id + 1,
                                                alpha_id + 1 + n)))]
        if prem:
            refs.append((b"prem", grid_id, [alpha_id]))
    iref = full_box(b"iref", 0, 0, b"".join(
        box(t, struct.pack(">HH", src, len(dst))
            + b"".join(struct.pack(">H", d) for d in dst))
        for t, src, dst in refs))
    grids = [it for it in items if it[1] == b"grid" or it[0] == grid_id]
    stored = [it for it in items if it not in grids or not in_idat]

    def iloc(base):
        out = bytes([0x44, 0x00]) + struct.pack(">H", len(items))
        pos_idat, pos = 0, base
        for iid, _, _, _, data, _ in items:
            if in_idat and any(iid == g[0] for g in grids):
                out += struct.pack(">HHHHII", iid, 1, 0, 1, pos_idat,
                                   len(data))
                pos_idat += len(data)
            else:
                out += struct.pack(">HHHHII", iid, 0, 0, 1, pos, len(data))
                pos += len(data)
        return full_box(b"iloc", 1, 0, out)

    hdlr = full_box(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = full_box(b"pitm", 0, 0, struct.pack(">H", grid_id))
    iinf = full_box(b"iinf", 0, 0, struct.pack(">H", len(items)) + infe)
    iprp = box(b"iprp", box(b"ipco", b"".join(ipco))
               + full_box(b"ipma", 0, 0, ipma))
    idat = (box(b"idat", b"".join(g[4] for g in grids)) if in_idat
            else b"")
    ftyp = box(b"ftyp", b"avif\0\0\0\0avifmif1miafMA1B")

    def meta(base):
        return full_box(b"meta", 0, 0, hdlr + pitm + iloc(base) + iinf
                        + iref + iprp + idat)

    base = len(ftyp) + len(meta(0)) + 8
    blob = b"".join(it[4] for it in stored)
    return ftyp + meta(base) + box(b"mdat", blob)


def split_tiles(img: np.ndarray, rows: int, cols: int, tw: int, th: int,
                **kw) -> list:
    """Pillow's AVIFs (pil_default with kw) of the tiles of img, padded
    by repeating its last row and column to rows x cols tiles of tw x th,
    in raster order."""
    h, w = img.shape[:2]
    pad = np.pad(img, ((0, max(rows * th - h, 0)), (0, max(cols * tw - w, 0)))
                 + ((0, 0),) * (img.ndim - 2), mode="edge")
    return [pil_default(np.ascontiguousarray(
        pad[r * th:(r + 1) * th, c * tw:(c + 1) * tw]), **kw)
            for r in range(rows) for c in range(cols)]
