"""Write the DDS, TGA and BMP fixtures of the port's readers and their
manifest.

    PYTHONPATH=. python tests/make_dds_fixtures.py [OUT_DIR]

Writes into tests/data/dds/ (or OUT_DIR) a small file of each layout the
port's DDS reader (core/dds.py, csrc/dds_decode.cpp) and its TGA and BMP
variant readers (core/image_io.py) take: DDS written by PIL (uncompressed
RGB, RGBA, L and LA; DXT1, DXT3, DXT5, DX10 BC2, BC3 and BC5) and by
tests/dds_encode.py (the formats PIL will not write: DX10 BC1, BC4, BC5
SNORM, BC6H UF16 and SF16 and BC7 of random blocks, every mode; bit-mask
layouts 565, 1555, 4444, 332 and 2:10:10:10; palette; DX10 R8G8B8A8),
sizes that are not multiples of 4 among them; TGA and BMP variants
written here (16-bit colour, 16-bit colour maps, grey with alpha,
bi-level, RLE; OS/2 headers, 1-, 4- and 16-bit pixels, 565 bit fields,
RLE8 and RLE4 with deltas); and the two textures of the DDS scene, a
512x512 BC7 albedo (utils/demo_scene.albedo_image through
encode_bc7_mode6) and a 256x256 DXT1 leaf whose cutouts are BC1's 1-bit
alpha (leaf_image through encode_bc1_cutout). manifest.json holds, for
each file, the shape, dtype and sha256 of np.asarray of what the JAX
read_ldr decodes through PIL (Image.open(path), converted to RGB or RGBA
as read_ldr converts it), and PIL's version. The machine with the card
has no PIL: chip_smoke.py and tests/test_torch_dds_cuda.py hold the
port's readers against the manifest there; tests/test_torch_dds.py and
tests/test_torch_tga_bmp_variants.py hold the manifest against PIL.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from dds_encode import (  # noqa: E402
    DDPF_ALPHAPIXELS,
    DDPF_LUMINANCE,
    DDPF_PALETTEINDEXED8,
    DDPF_RGB,
    bcn_file,
    dds_header,
    encode_bc1_cutout,
    encode_bc7_mode6,
    n_blocks,
    random_blocks,
)

FIXTURE_DIR = os.path.join(HERE, "data", "dds")
ALBEDO = "albedo_bc7.dds"
LEAF = "leaf_dxt1.dds"
# (bits a pixel, masks r, g, b[, a]) of the uncompressed DDS layouts.
MASK_LAYOUTS = {
    "565": (16, (0xF800, 0x7E0, 0x1F)),
    "555": (16, (0x7C00, 0x3E0, 0x1F)),
    "1555": (16, (0x7C00, 0x3E0, 0x1F, 0x8000)),
    "4444": (16, (0xF00, 0xF0, 0xF, 0xF000)),
    "332": (8, (0xE0, 0x1C, 0x3)),
    "8332": (16, (0xE0, 0x1C, 0x3, 0xFF00)),
    "888": (24, (0xFF0000, 0xFF00, 0xFF)),
    "x888": (32, (0xFF0000, 0xFF00, 0xFF)),
    "8888": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "abgr8888": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "a2r10g10b10": (32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000)),
    "g16r16": (32, (0xFFFF, 0xFFFF0000, 0x0)),
}


def mask_file(width: int, height: int, bits: int, masks, payload: bytes):
    """An uncompressed DDPF_RGB DDS; alpha when there are four masks."""
    flags = DDPF_RGB | (DDPF_ALPHAPIXELS if len(masks) == 4 else 0)
    return dds_header(width, height, pfflags=flags, bitcount=bits,
                      masks=tuple(masks) + (0,) * (4 - len(masks))) + payload


def luminance_file(width: int, height: int, alpha: bool, payload: bytes):
    flags = DDPF_LUMINANCE | (DDPF_ALPHAPIXELS if alpha else 0)
    return dds_header(width, height, pfflags=flags,
                      bitcount=16 if alpha else 8) + payload


def palette_file(width: int, height: int, palette: bytes, indices: bytes):
    """DDPF_PALETTEINDEXED8: the 1024-byte RGBA palette, then indices."""
    return dds_header(width, height, pfflags=DDPF_PALETTEINDEXED8,
                      bitcount=8) + palette + indices


def rgba8_file(width: int, height: int, payload: bytes, dxgi: int = 28):
    """DX10 R8G8B8A8 (27 typeless, 28 unorm, 29 unorm sRGB)."""
    return dds_header(width, height, pfflags=0, dxgi=dxgi) + payload


# ----------------------------------------------------------------------------
# TGA and BMP variants


def tga_file(width: int, height: int, image_type: int, depth: int,
             pixels: bytes, cmap: tuple | None = None, flags: int = 0,
             cmap_type: int | None = None) -> bytes:
    """A TGA: 18-byte header, the colour map (bits, first index, entry
    bytes) and the pixel bytes as given (RLE packets for types 9-11)."""
    cm, first, count, cbits = b"", 0, 0, 0
    if cmap is not None:
        cbits, first, cm = cmap
        count = len(cm) // (cbits // 8)
    if cmap_type is None:
        cmap_type = int(cmap is not None)
    return struct.pack("<BBBHHBHHHHBB", 0, cmap_type, image_type, first,
                       count, cbits, 0, 0, width, height, depth,
                       flags) + cm + pixels


def tga_rle(rows: np.ndarray, unit: int) -> bytes:
    """Rows (H, rowbytes) as TGA RLE packets: a run for each stretch of
    equal pixels (within a row), raw packets between, which may run on
    into the next row as PIL allows."""
    out, lit = bytearray(), bytearray()

    def flush():
        while lit:
            chunk = lit[:128 * unit]
            out.append(len(chunk) // unit - 1)
            out.extend(chunk)
            del lit[:128 * unit]

    for row in rows:
        px = [bytes(row[i:i + unit]) for i in range(0, len(row), unit)]
        i = 0
        while i < len(px):
            j = i
            while j + 1 < len(px) and px[j + 1] == px[i] and j - i < 127:
                j += 1
            if j > i:
                flush()
                out.append(0x80 | (j - i))
                out.extend(px[i])
            else:
                lit.extend(px[i])
            i = j + 1
    flush()
    return bytes(out)


def bmp_file(width: int, height: int, bits: int, pixels: bytes, *,
             header_size: int = 40, compression: int = 0,
             palette: bytes = b"", masks: tuple | None = None,
             colors: int = 0, top_down: bool = False) -> bytes:
    """A BMP: file header, info header of `header_size` bytes (12: OS/2),
    masks after a 40-byte header for bit fields, palette, pixels."""
    if header_size == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header_size, width,
                           -height if top_down else height, 1, bits,
                           compression, len(pixels), 2835, 2835, colors, 0)
        if masks is not None and header_size >= 52:
            fit = masks[:(header_size - 40) // 4]
            info += struct.pack(f"<{len(fit)}I", *fit)
        info += bytes(header_size - len(info))
    extra = b""
    if masks is not None and header_size == 40:
        extra = struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + extra + palette + pixels)


def bmp_rows(values: np.ndarray, bits: int) -> bytes:
    """(H, W) values of `bits` (1, 4, 8) or (H, W) uint16 as bottom-up
    rows padded to 4 bytes."""
    h, w = values.shape
    if bits == 16:
        raw = values.astype("<u2").view(np.uint8).reshape(h, 2 * w)
    elif bits == 8:
        raw = values.astype(np.uint8)
    else:
        per = 8 // bits
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = values
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        raw = (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :raw.shape[1]] = raw
    return rows[::-1].tobytes()


def bmp_rle8(indices: np.ndarray) -> bytes:
    """(H, W) indices as RLE8, bottom-up: runs of equal indices, absolute
    runs (3+ pixels) between them, end of line after each row, a delta
    over the first row's last pixels, end of bitmap."""
    h, w = indices.shape
    out = bytearray()
    for r, row in enumerate(indices[::-1]):
        i = 0
        while i < w:
            j = i
            while j + 1 < w and row[j + 1] == row[i] and j - i < 254:
                j += 1
            if j - i >= 1:
                out += bytes((j - i + 1, int(row[i])))
                i = j + 1
                continue
            k = i
            while k + 1 < w and row[k + 1] != row[k] and k - i < 254:
                k += 1
            n = k - i + 1
            if n >= 3:
                out += bytes((0, n)) + bytes(row[i:i + n].astype(np.uint8))
                if n % 2:
                    out += b"\0"
            else:
                out += b"".join(bytes((1, int(v))) for v in row[i:i + n])
            i += n
        out += b"\0\0"
    return bytes(out) + b"\0\1"


def _palette_bytes(colors: np.ndarray, pad: int) -> bytes:
    """(n, 3) RGB as BMP palette entries: BGR plus `pad - 3` zero bytes."""
    bgr = colors[:, ::-1].astype(np.uint8)
    return np.concatenate([bgr, np.zeros((len(colors), pad - 3), np.uint8)],
                          1).tobytes()


def tga_bmp_specs(rng: np.random.Generator) -> dict:
    """name -> file bytes of the TGA and BMP variants."""
    w, h = 13, 7
    out = {}
    p16 = rng.integers(0, 65536, (h, w)).astype("<u2")
    raw16 = p16.view(np.uint8).reshape(h, 2 * w)
    p16_runs = np.repeat(p16[:, :5], [3, 1, 4, 2, 3], axis=1)
    runs16 = p16_runs.astype("<u2").view(np.uint8).reshape(h, 2 * w)
    out["tga_16bit.tga"] = tga_file(w, h, 2, 16, raw16.tobytes())
    out["tga_16bit_rle_topright.tga"] = tga_file(w, h, 10, 16,
                                                 tga_rle(runs16, 2),
                                                 flags=0x30)
    la = rng.integers(0, 256, (h, 2 * w), dtype=np.uint8)
    out["tga_grey_alpha.tga"] = tga_file(w, h, 3, 16, la.tobytes(),
                                         flags=0x20)
    bits = rng.integers(0, 256, (h, (w + 7) // 8), dtype=np.uint8)
    out["tga_bilevel.tga"] = tga_file(w, h, 3, 1, bits.tobytes())
    idx = rng.integers(0, 12, (h, w), dtype=np.uint8)
    cmap16 = rng.integers(0, 65536, 12).astype("<u2").tobytes()
    out["tga_cmap16.tga"] = tga_file(w, h, 1, 8, idx.tobytes(),
                                     cmap=(16, 0, cmap16))
    idx_runs = np.repeat(idx[:, :4], [4, 2, 5, 2], axis=1)
    out["tga_cmap16_rle.tga"] = tga_file(w, h, 9, 8, tga_rle(idx_runs, 1),
                                         cmap=(16, 3, cmap16))
    out["tga_grey_rle.tga"] = tga_file(w, h, 11, 8, tga_rle(idx_runs * 20, 1))

    pal16 = rng.integers(0, 256, (16, 3))
    v4 = rng.integers(0, 16, (h, w))
    v1 = rng.integers(0, 2, (h, w))
    out["bmp_os2_8bit.bmp"] = bmp_file(
        w, h, 8, bmp_rows(v4 * 13 % 16, 8), header_size=12,
        palette=_palette_bytes(np.resize(pal16, (256, 3)), 3))
    out["bmp_1bit.bmp"] = bmp_file(w, h, 1, bmp_rows(v1, 1),
                                   palette=_palette_bytes(pal16[:2], 4))
    out["bmp_1bit_bw.bmp"] = bmp_file(
        w, h, 1, bmp_rows(v1, 1),
        palette=_palette_bytes(np.array([[0] * 3, [255] * 3]), 4))
    out["bmp_4bit.bmp"] = bmp_file(w, h, 4, bmp_rows(v4, 4),
                                   palette=_palette_bytes(pal16, 4))
    out["bmp_4bit_v5_topdown.bmp"] = bmp_file(
        w, h, 4, bmp_rows(v4[::-1], 4), header_size=124, top_down=True,
        palette=_palette_bytes(pal16, 4))
    v16 = rng.integers(0, 65536, (h, w))
    out["bmp_16bit_555.bmp"] = bmp_file(w, h, 16, bmp_rows(v16, 16))
    out["bmp_16bit_565.bmp"] = bmp_file(w, h, 16, bmp_rows(v16, 16),
                                        compression=3,
                                        masks=(0xF800, 0x7E0, 0x1F))
    out["bmp_16bit_565_v4.bmp"] = bmp_file(
        w, h, 16, bmp_rows(v16, 16), header_size=108, compression=3,
        masks=(0xF800, 0x7E0, 0x1F, 0))
    out["bmp_16bit_555_fields.bmp"] = bmp_file(
        w, h, 16, bmp_rows(v16, 16), header_size=56, compression=3,
        masks=(0x7C00, 0x3E0, 0x1F, 0))
    runs = np.repeat(rng.integers(0, 16, (h, 5)), [4, 1, 3, 2, 3], axis=1)
    runs[:, 5:9] = rng.integers(0, 16, (h, 4))
    out["bmp_rle8.bmp"] = bmp_file(w, h, 8, bmp_rle8(runs), compression=1,
                                   palette=_palette_bytes(pal16, 4),
                                   colors=16)
    out["bmp_rle4.bmp"] = bmp_file(w, h, 4, _rle4(runs), compression=2,
                                   palette=_palette_bytes(pal16, 4),
                                   colors=16)
    return out


def _rle4(values: np.ndarray) -> bytes:
    """(H, W) 4-bit values as RLE4, bottom-up: an encoded run of two
    alternating pixels where two neighbours repeat, absolute runs of an
    even count elsewhere, a delta escape (whose first two bytes PIL
    skips) before the last row's end, end of line after each row."""
    h, w = values.shape
    out = bytearray()
    for r, row in enumerate(values[::-1]):
        i = 0
        last = r == h - 1
        stop = w - 2 if last else w
        while i < stop:
            n = min(4, stop - i)
            if n >= 4 and n % 2 == 0:
                pair = row[i:i + n]
                out += bytes((0, n)) + bytes(
                    int(pair[k] << 4 | pair[k + 1]) for k in range(0, n, 2))
                if (n // 2) % 2:
                    out += b"\0"
            else:
                out += bytes((n, int(row[i] << 4 | (row[i + 1] if n > 1
                                                    else row[i]))))
            i += n
        if last:
            out += bytes((0, 2, 9, 9, 2, 0))   # delta: 2 right (zeros)
        out += b"\0\0"
    return bytes(out) + b"\0\1"


# ----------------------------------------------------------------------------
# The manifest


def dds_specs(rng: np.random.Generator) -> dict:
    """name -> file bytes of the DDS fixtures but the scene's textures."""
    from PIL import Image

    import io

    out = {}
    img = rng.integers(0, 256, (13, 18, 4), dtype=np.uint8)
    img[4:9, 2:14] = img[5, 6]         # flat blocks beside noisy ones
    for mode in ("RGB", "RGBA", "L", "LA"):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, "DDS")
        out[f"pil_{mode.lower()}.dds"] = buf.getvalue()
    for fmt, mode in (("DXT1", "RGBA"), ("DXT3", "RGBA"), ("DXT5", "RGBA"),
                      ("BC2", "RGBA"), ("BC3", "RGBA"), ("BC5", "RGB")):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, "DDS", pixel_format=fmt)
        out[f"pil_{fmt.lower()}.dds"] = buf.getvalue()
    w, h = 18, 13
    nb = n_blocks(w, h)
    for fmt in ("BC1", "DXT1", "BC4", "ATI1", "BC4U", "ATI2", "BC5S",
                "BC5_SNORM"):
        out[f"random_{fmt.lower()}.dds"] = bcn_file(
            fmt, w, h, random_blocks(rng, fmt, nb))
    for m in range(9):                  # BC7 modes 0-7 and "mode 8"
        out[f"random_bc7_mode{m}.dds"] = bcn_file(
            "BC7_SRGB" if m == 6 else "BC7", w, h,
            random_blocks(rng, "BC7", nb, m))
    for fmt in ("BC6H", "BC6HS"):
        blocks = b"".join(random_blocks(rng, fmt, 1, m) for m in range(18))
        out[f"random_{fmt.lower()}.dds"] = bcn_file(fmt, 24, 12, blocks)
    for name, (bits, masks) in MASK_LAYOUTS.items():
        payload = rng.integers(0, 256, 11 * 7 * bits // 8,
                               dtype=np.uint8).tobytes()
        out[f"masks_{name}.dds"] = mask_file(11, 7, bits, masks, payload)
    out["luminance_l8.dds"] = luminance_file(
        11, 7, False, rng.integers(0, 256, 77, dtype=np.uint8).tobytes())
    out["luminance_la16.dds"] = luminance_file(
        11, 7, True, rng.integers(0, 256, 154, dtype=np.uint8).tobytes())
    out["palette_p8.dds"] = palette_file(
        11, 7, rng.integers(0, 256, 1024, dtype=np.uint8).tobytes(),
        rng.integers(0, 256, 77, dtype=np.uint8).tobytes())
    out["dx10_rgba8_srgb.dds"] = rgba8_file(
        11, 7, rng.integers(0, 256, 308, dtype=np.uint8).tobytes(), 29)
    return out


def scene_textures() -> dict:
    """The DDS scene's textures: the BC7 albedo and the DXT1 leaf."""
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image, leaf_image

    albedo = np.round(albedo_image(512) * 255).astype(np.uint8)
    albedo = np.concatenate([albedo, np.full((512, 512, 1), 255, np.uint8)],
                            -1)
    leaf = np.round(leaf_image(256) * 255).astype(np.uint8)
    return {ALBEDO: bcn_file("BC7", 512, 512, encode_bc7_mode6(albedo)),
            LEAF: bcn_file("DXT1", 256, 256, encode_bc1_cutout(leaf))}


def array_digest(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return dict(shape=list(arr.shape), dtype=str(arr.dtype),
                sha256=hashlib.sha256(arr.tobytes()).hexdigest())


def pil_pixels(path: str) -> np.ndarray:
    """What the JAX read_ldr decodes through PIL, before its / 255."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA"):
            im = im.convert("RGBA" if "A" in im.mode else "RGB")
        return np.asarray(im)


def main(out_dir: str = FIXTURE_DIR) -> dict:
    import PIL

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20261017)
    files = {**dds_specs(rng), **tga_bmp_specs(rng), **scene_textures()}
    manifest = {"pil": PIL.__version__, "files": {}}
    for name, data in files.items():
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest["files"][name] = array_digest(pil_pixels(path))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    main(*sys.argv[1:])
