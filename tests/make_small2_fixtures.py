"""Write the fixtures of the port's readers of PIL's small formats, part 2,
and their manifest.

    PYTHONPATH=. python tests/make_small2_fixtures.py [OUT_DIR]

Writes into tests/data/small2/ (or OUT_DIR) a small file of each layout
the readers (core/im.py, core/sun.py, core/xbm.py, core/xpm.py,
core/msp.py and core/rawformats.py for PIXAR, GBR, IMT, McIdas, SPIDER
and XVThumb; csrc/small_decode.cpp) take:
- written by PIL: IM of every mode PIL saves (1, L, LA, P and PA with
  their Lut, I, I;16, I;16L, I;16B, F, RGB, RGBA, RGBX, CMYK, YCbCr), MSP
  (DanM), XBM (with and without a hot spot), SPIDER;
- written by tests/small_encode.py, where PIL has no writer or writes
  only some layouts: IM of the types PIL reads but does not write (RGB3,
  X 24, B2 and B4 with and without a colour Lut, a grey Lut, F;8S, F;16,
  F;16S, F;32, the packed F;j of the L*j types, two frames, a header
  ended by a NUL), Sun rasters (depths 1, 4, 8, 24 and 32, RGB and BGR
  order, colour maps, odd widths padded to 16 bits, RLE with runs across
  rows and escaped 0x80 bytes), LinS MSP (blank rows, rows that decode to
  more or fewer bytes than a line), XBM with upper-case and broken hex
  digits, XPM (P and RGB, "None", a "/* pixels */" line, rows that shift),
  PIXAR, GBR (versions 1 and 2, L and RGBA), IMT, McIdas (L, I;16B, I;32B,
  line prefixes, rows that overlap in PIL's mapped file), SPIDER
  (little-endian, a stack, NaN and values past 0-255) and XVThumb.
manifest.json holds, for each file, the shape, dtype and sha256 of
np.asarray of what the JAX read_ldr decodes through PIL, and PIL's
version; under "generated", for each file utils/demo_scene's
write_small2_textures writes (the textured scene's albedo as a Sun RLE,
a raw Sun, a planar IM and a 256-colour XPM, its leaf as an RGBA IM),
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
from make_small_fixtures import texture

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "data", "small2")


def _pil(img, fmt, mode=None, **kw) -> bytes:
    from PIL import Image

    im = Image.fromarray(img) if isinstance(img, np.ndarray) else img
    if mode is not None:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def im_files(rng) -> dict:
    from PIL import Image

    out = {}
    img = texture(rng, 7, 9, 4)
    for mode in ("1", "L", "LA", "I", "F", "RGB", "RGBA", "RGBX", "CMYK",
                 "YCbCr"):
        name = mode.lower().replace(";", "")
        out[f"im_{name}.im"] = _pil(img, "IM", mode)
    wide = Image.fromarray(rng.integers(0, 400, (5, 6)).astype(np.int32))
    for mode in ("I;16", "I;16L", "I;16B"):
        out[f"im_{mode.lower().replace(';', '')}.im"] = _pil(wide, "IM",
                                                             mode)
    pim = Image.fromarray(img[..., :3]).quantize(12)
    out["im_p.im"] = _pil(pim, "IM")
    pa = pim.convert("PA")
    pa.putalpha(Image.fromarray(img[..., 3]))
    out["im_pa.im"] = _pil(pa, "IM")
    rgb = texture(rng, 6, 5, 3)
    planes = np.ascontiguousarray(rgb[::-1].transpose(2, 0, 1))
    out["im_rgb3.im"] = se.im("RGB3 image", 5, 6, planes[[1, 0, 2]]
                              .tobytes())
    out["im_x24.im"] = se.im("X 24 image", 5, 6, se.im_rows(rgb, False))
    idx = rng.integers(0, 256, (6, 4)).astype(np.uint8)
    colour_lut = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    grey_lut = bytes(255 - i for i in range(256)) * 3
    out["im_b2.im"] = se.im("B2 image", 7, 3, rng.integers(
        0, 256, 6).astype(np.uint8).tobytes())
    out["im_b4_colour_lut.im"] = se.im("B4 image", 4, 6, se.im_rows(idx),
                                       lut=colour_lut)
    out["im_l_grey_lut.im"] = se.im("Greyscale image", 4, 6,
                                    se.im_rows(idx), lut=grey_lut)
    out["im_l_colour_lut.im"] = se.im("Greyscale image", 4, 6,
                                      se.im_rows(idx), lut=colour_lut)
    raw = rng.integers(0, 256, 4 * 6 * 5).astype(np.uint8).tobytes()
    for kind in ("L 8S", "L 16", "L 16S", "L 32", "L*32S"):
        out[f"im_{kind.lower().replace(' ', '_').replace('*', 'x')}.im"] = \
            se.im(f"{kind} image", 5, 6, raw)
    for bits in (5, 12, 27):
        out[f"im_lx{bits}.im"] = se.im(f"L*{bits} image", 5, 3, raw)
    out["im_two_frames.im"] = se.im("Greyscale image", 4, 3, raw[:24],
                                    ["File size (no of images): 2"])
    out["im_nul_ended.im"] = se.im("RGB image", 3, 2, raw[:18],
                                   ["Comment: one", "Comment: two"],
                                   end=b"\0junk")
    out["im_default_l.im"] = se.im(None, 4, 3, raw[:12], ["Name: x.im"])
    return out


def sun_files(rng) -> dict:
    out = {}
    img = texture(rng, 5, 7, 3)
    grey = img[..., 0]
    cmap = rng.integers(0, 256, 3 * 20).astype(np.uint8).tobytes()
    bits = np.packbits(grey > 100, axis=1)
    out["sun_1.ras"] = se.sun(7, 5, 1, 1, se.sun_rows(bits))
    nib = (grey >> 4).astype(np.uint8)
    packed = (np.pad(nib, ((0, 0), (0, 1)))[:, 0::2] << 4) | np.pad(
        nib, ((0, 0), (0, 1)))[:, 1::2]
    out["sun_4.ras"] = se.sun(7, 5, 4, 1, se.sun_rows(packed))
    out["sun_4_cmap.ras"] = se.sun(7, 5, 4, 0, se.sun_rows(packed),
                                   cmap[:48])
    out["sun_8.ras"] = se.sun(7, 5, 8, 1, se.sun_rows(grey))
    idx = (grey % 20).astype(np.uint8)
    out["sun_8_cmap.ras"] = se.sun(7, 5, 8, 1, se.sun_rows(idx), cmap)
    out["sun_8_short_cmap.ras"] = se.sun(7, 5, 8, 1, se.sun_rows(grey),
                                         cmap[:31])
    rows = img.reshape(5, 21)
    out["sun_24_bgr.ras"] = se.sun(7, 5, 24, 1, se.sun_rows(rows))
    out["sun_24_rgb.ras"] = se.sun(7, 5, 24, 3, se.sun_rows(rows))
    rgbx = np.concatenate([img, np.full((5, 7, 1), 9, np.uint8)], -1)
    out["sun_32_bgrx.ras"] = se.sun(7, 5, 32, 4, rgbx.tobytes())
    out["sun_32_rgbx.ras"] = se.sun(7, 5, 32, 3, rgbx.tobytes())
    # RLE rows are not padded: a run of 24 bytes crosses from row to row.
    flat = texture(rng, 6, 8, 3)
    flat[1, 2:] = flat[2, :2] = 0x80
    flat[4, 3, 1] = 0x80                      # a lone 0x80: 0x80 0
    out["sun_rle_24.ras"] = se.sun(8, 6, 24, 2, se.sun_rle(
        flat.tobytes(), rng))
    out["sun_rle_8.ras"] = se.sun(5, 4, 8, 2, se.sun_rle(
        grey[:4, :5].tobytes(), rng))
    out["sun_rle_8_cmap.ras"] = se.sun(5, 4, 8, 2, se.sun_rle(
        idx[:4, :5].tobytes()), cmap)
    out["sun_rle_1.ras"] = se.sun(9, 3, 1, 2, se.sun_rle(
        bytes([0xF0, 0x80, 0, 0, 0x80, 0x80])))
    out["sun_rle_32.ras"] = se.sun(7, 5, 32, 2, se.sun_rle(rgbx.tobytes()))
    return out


def msp_xbm_files(rng) -> dict:
    out = {}
    img = texture(rng, 9, 21, 1)[..., 0] > 90
    out["msp_danm.msp"] = _pil(img, "MSP")
    out["xbm_pil.xbm"] = _pil(img, "XBM")
    out["xbm_hotspot.xbm"] = _pil(img, "XBM", hotspot=(3, 4))
    text = _pil(img, "XBM").decode()
    head, body = text.split("{", 1)
    out["xbm_upper_hex.xbm"] = (head + "{" + body.upper().replace(
        "0X", "0x")).encode()
    broken = body.replace("0x", "0xg", 2).replace(",", " ,x1,", 1)
    out["xbm_broken_hex.xbm"] = (head + "{" + broken).encode()
    lines = np.packbits(img, axis=1)
    rows = [se.msp_row(line.tobytes(), rng) for line in lines]
    out["msp_lins.msp"] = se.msp_lins(21, 9, rows)
    rows[2] = b""
    rows[4] = rows[4] + b"\x00\x02\xaa"
    rows[6] = rows[6][:-1] if rows[6][-2] else rows[6]
    out["msp_lins_shifted.msp"] = se.msp_lins(21, 9, rows)
    return out


def xpm_files(rng) -> dict:
    out = {}
    keys = [bytes([c]) for c in b"abcdefgh"]
    cols = [(k, b"#%06x" % int(rng.integers(0, 1 << 24))) for k in keys]
    idx = rng.integers(0, 8, (5, 6))
    rows = [b"".join(keys[i] for i in r) for r in idx]
    out["xpm_p.xpm"] = se.xpm(6, 5, cols, rows)
    out["xpm_none_unused.xpm"] = se.xpm(6, 5, cols + [(b"z", b"None")],
                                        rows, pixels_comment=True)
    out["xpm_rows_shift.xpm"] = se.xpm(6, 5, cols, [rows[0] + b"a"]
                                       + rows[1:3] + [rows[3][:-1]]
                                       + rows[4:])
    out["xpm_hex_forms.xpm"] = se.xpm(2, 1, [(b"a", b"#0xff00ff"),
                                             (b"b", b"#+1f_00")], [b"ab"])
    two = [bytes((97 + i // 26, 97 + i % 26)) for i in range(300)]
    cols = [(k, b"#%06x" % int(rng.integers(0, 1 << 24))) for k in two]
    idx = rng.integers(0, 300, (4, 7))
    out["xpm_rgb_300.xpm"] = se.xpm(7, 4, cols, [b"".join(two[i] for i in r)
                                                 for r in idx])
    return out


def raw_files(rng) -> dict:
    out = {}
    rgb = texture(rng, 5, 6, 3)
    out["pixar_rgb.pxr"] = se.pixar(6, 5, rgb.tobytes())
    rgba = texture(rng, 4, 7, 4)
    out["gbr_v1_l.gbr"] = se.gbr(7, 4, 1, rgba[..., 0].tobytes(), 1)
    out["gbr_v2_l.gbr"] = se.gbr(7, 4, 1, rgba[..., 1].tobytes())
    out["gbr_v2_rgba.gbr"] = se.gbr(7, 4, 4, rgba.tobytes(), comment=b"")
    out["imt_l.imt"] = se.imt(6, 5, rgb[..., 0].tobytes() + b"tail")
    grey = texture(rng, 4, 5, 1)[..., 0]
    out["mcidas_l.area"] = se.mcidas(5, 4, 1, grey.tobytes())
    wide = rng.integers(0, 600, (4, 5)).astype(">u2")
    out["mcidas_i16.area"] = se.mcidas(5, 4, 2, wide.tobytes())
    deep = rng.integers(-300, 600, (4, 5)).astype(">i4")
    out["mcidas_i32.area"] = se.mcidas(5, 4, 4, deep.tobytes())
    prefixed = np.concatenate([rng.integers(0, 256, (4, 3)), grey], 1)
    out["mcidas_l_prefix.area"] = se.mcidas(5, 4, 1, prefixed.astype(
        np.uint8).tobytes(), prefix=3, data_offset=300)
    out["mcidas_l_overlap.area"] = se.mcidas(5, 4, 1, grey.tobytes(),
                                             prefix=2, bands=0)
    f = (rng.random((4, 6)) * 400 - 60).astype(np.float32)
    f[0, 0], f[1, 1] = np.nan, 254.9
    out["spider_pil.spi"] = _pil(f, "SPIDER")
    out["spider_le.spi"] = se.spider(f, big=False)
    out["spider_stack.spi"] = se.spider(f, stack=2)
    out["xv_thumb.xv"] = se.xvthumb(6, 5, rng.integers(
        0, 256, 30).astype(np.uint8).tobytes())
    return out


def generated_files(directory: str) -> dict:
    """name -> path of utils/demo_scene.write_small2_textures' files."""
    from tracerboy_tpu_torch.utils.demo_scene import write_small2_textures

    return write_small2_textures(directory)


def main(out_dir: str = FIXTURE_DIR) -> dict:
    import PIL

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20261026)
    files = {**im_files(rng), **sun_files(rng), **msp_xbm_files(rng),
             **xpm_files(rng), **raw_files(rng)}
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
