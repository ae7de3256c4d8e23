"""Write the fixtures of the port's readers of PIL's small texture formats
and their manifest.

    PYTHONPATH=. python tests/make_small_fixtures.py [OUT_DIR]

Writes into tests/data/small/ (or OUT_DIR) a small file of each layout
the readers (core/sgi.py, core/pcx.py, core/ico.py for CUR and DIB,
core/ftex.py, core/blp.py, core/icns.py; csrc/small_decode.cpp) take:
- written by PIL: SGI verbatim (L, RGB, RGBA at 8 and 16 bits), PCX
  (bi-level, grey, palette, RGB, odd widths), DIB (RGB, palette, grey,
  bi-level), BLP1 and BLP2 of a palette (RGBA palettes too);
- written by tests/small_encode.py, where PIL has no writer: SGI RLE (8
  and 16 bits, 1-4 channels, rows that share data, a row table that
  leaves rows as the previous row left them, a last control byte that
  stops the decoder), PCX of 2 and 4 bit planes, 8-bit grey without a
  palette, a header stride PIL keeps, a window that does not start at 0,
  DCX of two pages, CUR (24, 8 and 32 bits, the entry PIL picks among
  several, 256-pixel entries, the single-entry 32-bit alpha), FTEX (DXT1
  and raw RGB, sizes that are not multiples of 4), BLP1 JPEG (with and
  without alpha), BLP1 palette (encodings 4 and 5), BLP2 palette (alpha
  depths 0, 1, 4, 8), BLP2 DXT1, DXT3 and DXT5 with and without alpha
  and at sizes that are not multiples of 4, ICNS of RLE and raw 24-bit
  entries with and without masks (is32, il32, ih32, it32), of PNG entries
  (RGBA and RGB) and a JPEG 2000 entry, and the best-size rule.
manifest.json holds, for each file, the shape, dtype and sha256 of
np.asarray of what the JAX read_ldr decodes through PIL, and PIL's
version; under "generated", for each file utils/demo_scene's
write_small_textures writes (the textured scene's albedo as an RLE SGI,
a PCX, a DXT1 BLP2, a DXT1 FTEX and an ICNS, its leaf as a DXT5 BLP2),
the sha256 of the file's bytes and PIL's digest of its pixels: those
files are not committed, the card's machine writes them again, and
chip_smoke.py and tests/test_torch_small_cuda.py hold the port's
readers against both digests there (it has no PIL).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import tempfile

import numpy as np

import small_encode as se
from make_dds_fixtures import array_digest, pil_pixels

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "data", "small")


def texture(rng, h: int, w: int, c: int = 3, levels: int = 5) -> np.ndarray:
    """Blocks of flat colour (runs for the RLE coders) and noisy rows."""
    img = (rng.integers(0, levels, (h, w, c)) * (255 // (levels - 1))
           ).astype(np.uint8)
    img[h // 3:h // 2] = rng.integers(0, 256, (h // 2 - h // 3, w, c))
    img[:, :w // 4] = img[:1, :w // 4]
    return img


def _pil(img, fmt, mode=None, **kw) -> bytes:
    from PIL import Image

    im = Image.fromarray(img)
    if mode is not None:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _palette_image(rng, h, w, alpha=False):
    from PIL import Image

    img = texture(rng, h, w, 4 if alpha else 3)
    im = Image.fromarray(img).quantize(16) if not alpha else \
        Image.fromarray(img).quantize(16, method=Image.Quantize.FASTOCTREE)
    return im


def sgi_files(rng) -> dict:
    out = {}
    for c, name in ((1, "l"), (3, "rgb"), (4, "rgba")):
        img = texture(rng, 11, 13, c)
        src = img[..., 0] if c == 1 else img
        out[f"sgi_{name}.sgi"] = _pil(src, "SGI")
        out[f"sgi_{name}_16.sgi"] = _pil(src, "SGI", bpc=2)
        out[f"sgi_rle_{name}.sgi"] = se.sgi_rle(img, rng=rng)
        wide = rng.integers(0, 65536, (7, 9, c)).astype(np.uint16)
        wide[:, :4] = wide[:, :1]
        out[f"sgi_rle_{name}_16.sgi"] = se.sgi_rle(wide, bpc=2, rng=rng)
    out["sgi_l_dimension1.sgi"] = se.sgi_rle(texture(rng, 1, 40, 1), rng=rng,
                                             dimension=1)
    img = texture(rng, 9, 300, 3)
    out["sgi_rle_long_runs.sgi"] = se.sgi_rle(img, rng=rng)
    # A row of length 0 keeps what the row before it left in the buffer;
    # a last control byte that is not 0 stops the decoder (the rows not
    # yet stored stay 0).
    img = texture(rng, 6, 10, 3)
    out["sgi_rle_stale_row.sgi"] = se.sgi_rle(img, rows={(2, 1): b"\0"})
    data = bytearray(se.sgi_rle(img, rows={(3, 0): b"\x02\x07\x81"}))
    out["sgi_rle_unterminated.sgi"] = bytes(data)
    return out


def pcx_files(rng) -> dict:
    from PIL import Image

    out = {}
    for w in (13, 16, 1):
        img = texture(rng, 7, w, 3)
        if w > 1:                    # PIL cannot read its own 1-wide RGB
            out[f"pcx_rgb_{w}.pcx"] = _pil(img, "PCX")
        out[f"pcx_l_{w}.pcx"] = _pil(img, "PCX", "L")
        out[f"pcx_1_{w}.pcx"] = _pil(img, "PCX", "1")
        pim = Image.fromarray(img).quantize(8)
        buf = io.BytesIO()
        pim.save(buf, "PCX")
        out[f"pcx_p_{w}.pcx"] = buf.getvalue()
    for planes in (2, 4):
        for w in (13, 3, 16):
            h = 5
            s = (w + 7) // 8
            stride = s + s % 2
            lines = rng.integers(0, 256, (h, planes * stride)).astype(
                np.uint8)
            pal = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
            out[f"pcx_p{planes}_{w}.pcx"] = se.pcx_header(
                w, h, 1, planes, stride, 5, pal) + se.pcx_encode(lines)
    lines = texture(rng, 6, 10, 1)[..., 0]
    out["pcx_grey_no_palette.pcx"] = se.pcx_header(10, 6, 8, 1, 10) \
        + se.pcx_encode(lines) + bytes(769)
    lines = texture(rng, 4, 7 * 3, 1)[..., 0]
    out["pcx_rgb_odd_stride_kept.pcx"] = se.pcx_header(7, 4, 8, 3, 7) \
        + se.pcx_encode(lines)
    lines = np.full((3, 2), 0xC5, np.uint8)
    out["pcx_1_window.pcx"] = se.pcx_header(9, 3, 1, 1, 2, 2, x0=5, y0=2) \
        + se.pcx_encode(lines)
    pages = [_pil(texture(rng, 5, 6, 3), "PCX"),
             _pil(texture(rng, 8, 3, 3), "PCX")]
    out["dcx_two_pages.dcx"] = se.dcx(pages)
    out["dcx_grey_page.dcx"] = se.dcx([_pil(texture(rng, 5, 6, 3), "PCX",
                                            "L")])
    return out


def dib_cur_files(rng) -> dict:
    from PIL import Image

    out = {}
    img = texture(rng, 9, 11, 3)
    out["dib_rgb.dib"] = _pil(img, "DIB")
    out["dib_l.dib"] = _pil(img, "DIB", "L")
    out["dib_1.dib"] = _pil(img, "DIB", "1")
    buf = io.BytesIO()
    Image.fromarray(img).quantize(12).save(buf, "DIB")
    out["dib_p.dib"] = buf.getvalue()
    rgba = texture(rng, 8, 8, 4)
    big = texture(rng, 12, 10, 3)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (6, 7)).astype(np.uint8)
    out["cur_24.cur"] = se.cur([(11, 9, se.dib_bitmap(img))])
    out["cur_32_alpha.cur"] = se.cur([(8, 8, se.dib_bitmap(rgba, 32))])
    out["cur_32_second.cur"] = se.cur([(4, 4, se.dib_bitmap(img[:4, :4])),
                                       (8, 8, se.dib_bitmap(rgba, 32))])
    out["cur_4bit.cur"] = se.cur([(7, 6, se.dib_bitmap(idx, 4, pal))])
    out["cur_8bit.cur"] = se.cur([(7, 6, se.dib_bitmap(
        idx, 8, rng.integers(0, 256, (16, 3))))])
    out["cur_picks_larger.cur"] = se.cur([(11, 9, se.dib_bitmap(img)),
                                          (10, 12, se.dib_bitmap(big)),
                                          (12, 10, se.dib_bitmap(big))])
    out["cur_256_never_wins.cur"] = se.cur([(11, 9, se.dib_bitmap(img)),
                                            (0, 0, se.dib_bitmap(big))])
    return out


def ftex_blp_files(rng) -> dict:
    from tracerboy_tpu_torch.core.blp import encode_dxt

    out = {}
    for w, h in ((16, 8), (13, 9)):
        img = texture(rng, h, w, 4)
        out[f"ftex_dxt1_{w}x{h}.ftex"] = se.ftex(w, h, [(0, encode_dxt(
            img, 1))])
        out[f"ftex_rgb_{w}x{h}.ftex"] = se.ftex(w, h, [(1, img[..., :3]
                                                        .tobytes())])
        blocks = rng.integers(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * 16,
                              dtype=np.uint8).tobytes()
        for kind, enc in ((1, 0), (3, 1), (5, 7)):
            data = encode_dxt(img, 1) if kind == 1 else blocks
            for depth in (0, 8):
                out[f"blp2_dxt{kind}_a{depth}_{w}x{h}.blp"] = se.blp2(
                    w, h, data, 2, depth, enc)
        out[f"blp2_dxt1_random_a1_{w}x{h}.blp"] = se.blp2(
            w, h, blocks[:len(blocks) // 2], 2, 1, 0)
    pal = rng.integers(0, 256, (256, 4))
    idx = rng.integers(0, 256, (7, 10))
    for depth in (0, 1, 4, 8):
        out[f"blp2_palette_a{depth}.blp"] = se.blp2(
            10, 7, idx.astype(np.uint8).tobytes(), 1, depth, 0, pal)
    for enc in (4, 5):
        out[f"blp1_palette_e{enc}.blp"] = se.blp1_palette(idx, pal, 8, enc)
    out["blp1_palette_a0.blp"] = se.blp1_palette(idx, pal, 0)
    img = texture(rng, 24, 40, 3)
    jpeg = _pil(img, "JPEG", quality=90)
    out["blp1_jpeg.blp"] = se.blp1_jpeg(jpeg, 40, 24)
    out["blp1_jpeg_alpha.blp"] = se.blp1_jpeg(jpeg, 40, 24, alpha=8)
    out["blp1_jpeg_grey.blp"] = se.blp1_jpeg(_pil(img, "JPEG", "L"), 40, 24)
    pim = _palette_image(rng, 9, 12)
    for version in ("BLP1", "BLP2"):
        buf = io.BytesIO()
        pim.save(buf, "BLP", blp_version=version)
        out[f"pil_{version.lower()}.blp"] = buf.getvalue()
    from PIL import Image

    rgba = Image.fromarray(texture(rng, 9, 12, 4)).quantize(
        16, method=Image.Quantize.FASTOCTREE)
    buf = io.BytesIO()
    rgba.save(buf, "BLP")
    out["pil_blp2_rgba_palette.blp"] = buf.getvalue()
    return out


def icns_files(rng) -> dict:
    out = {}

    def rgb_entry(side, raw=False):
        img = texture(rng, side, side, 3)
        ch = img.transpose(2, 0, 1).reshape(3, -1)
        return img, (ch.transpose(1, 0).tobytes() if raw
                     else se.icns_rle(ch, rng))

    _, is32 = rgb_entry(16)
    mask = texture(rng, 16, 16, 1)[..., 0].tobytes()
    out["icns_is32_s8mk.icns"] = se.icns([(b"is32", is32), (b"s8mk", mask)])
    _, il32 = rgb_entry(32, raw=True)
    out["icns_il32_raw_l8mk.icns"] = se.icns(
        [(b"il32", il32), (b"l8mk", texture(rng, 32, 32, 1).tobytes())])
    _, ih32 = rgb_entry(48)
    out["icns_ih32_no_mask.icns"] = se.icns([(b"ih32", ih32)])
    _, it32 = rgb_entry(128)
    out["icns_it32_t8mk.icns"] = se.icns(
        [(b"it32", bytes(4) + it32),
         (b"t8mk", texture(rng, 128, 128, 1).tobytes())])
    rgba = texture(rng, 32, 32, 4)
    out["icns_ic11_png_rgba.icns"] = se.icns([(b"ic11",
                                               se.png_bytes(rgba))])
    out["icns_ic11_png_rgb.icns"] = se.icns([(b"ic11",
                                              se.png_bytes(rgba[..., :3]))])
    # bestsize is a tuple maximum: 48x48 at scale 1 beats 32x32 at 2.
    out["icns_best_size.icns"] = se.icns(
        [(b"ic12", se.png_bytes(texture(rng, 64, 64, 4))),
         (b"ih32", ih32), (b"h8mk", texture(rng, 48, 48, 1).tobytes())])
    out["icns_jp2_entry.icns"] = se.icns(
        [(b"ic11", _pil(texture(rng, 32, 32, 3), "JPEG2000"))])
    return out


def generated_files(directory: str) -> dict:
    """name -> path of utils/demo_scene.write_small_textures' files."""
    from tracerboy_tpu_torch.utils.demo_scene import write_small_textures

    return write_small_textures(directory)


def main(out_dir: str = FIXTURE_DIR) -> dict:
    import PIL

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20261018)
    files = {**sgi_files(rng), **pcx_files(rng), **dib_cur_files(rng),
             **ftex_blp_files(rng), **icns_files(rng)}
    manifest = {"pil": PIL.__version__, "files": {}, "generated": {}}
    for name, data in files.items():
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest["files"][name] = array_digest(pil_pixels(path))
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in generated_files(tmp).items():
            with open(path, "rb") as f:
                file_sha = hashlib.sha256(f.read()).hexdigest()
            manifest["generated"][name] = dict(
                array_digest(pil_pixels(path)), file_sha256=file_sha)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    main(*sys.argv[1:])
