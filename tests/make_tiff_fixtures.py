"""Write the TIFF, GIF and ICO fixtures of the port's readers and their
manifest.

    PYTHONPATH=. python tests/make_tiff_fixtures.py [OUT_DIR]

Writes into tests/data/tiff/ (or OUT_DIR) a small file of each layout the
port's readers (core/tiff.py, core/gif.py, core/ico.py,
csrc/lzw_codecs.cpp) take:
- TIFF written by PIL (strips: none, LZW, Deflate and PackBits over RGB,
  RGBA, L, 1-bit, I;16, F, CMYK, P and LA) and by tests/tiff_encode.py
  (the layouts PIL's writer cannot: tiles with cropped edges, planar 2,
  big-endian files, BigTIFF, Predictor 2 at 8 and 16 bits, Predictor 3,
  associated alpha at 8 and 16 bits, 16-bit colour maps, FillOrder 2,
  2- and 4-bit grey at both photometrics, 16-bit RGB and CMYK, float
  with PIL's big-endian quirk);
- GIF written by PIL (global table, interlaced) and by tiff_encode (a
  local table, a frame smaller than the screen at an offset over a
  transparent fill, a grey-ramp table read as L, interlaced rows);
- ICO written by PIL (PNG entries of three sizes) and by tiff_encode
  (BMP entries at 1, 4, 8, 24 and 32 bits a pixel with AND masks);
- the TIFF scene's textures, utils/demo_scene.write_tiff_textures: the
  1024x1024 albedo in 160x160 Deflate tiles and the 512x512 RGBA LZW
  leaf whose alpha makes the cutouts.
manifest.json holds, for each file, the shape, dtype and sha256 of
np.asarray of what the JAX read_ldr decodes through PIL (Image.open,
converted to RGB or RGBA as read_ldr converts it), and PIL's version.
The machine with the card has no PIL: chip_smoke.py and
tests/test_torch_tiff_cuda.py hold the port against the manifest there;
tests/test_torch_tiff.py and tests/test_torch_gif_ico.py hold the
manifest against PIL.
"""

from __future__ import annotations

import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from make_dds_fixtures import array_digest, pil_pixels  # noqa: E402
from tiff_encode import dib, gif_file, ico_file, tiff_file  # noqa: E402

FIXTURE_DIR = os.path.join(HERE, "data", "tiff")
ALBEDO = "albedo.tif"
LEAF = "leaf.tif"
W, H = 37, 21            # odd sizes: partial tiles, padded sub-byte rows


def pil_tiffs(rng) -> dict:
    from PIL import Image

    out = {}
    img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    img[5:12, 3:30] = img[6, 7]             # a flat patch beside noise
    for mode in ("RGB", "RGBA", "L", "1", "P", "CMYK", "LA"):
        for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits"):
            im = Image.fromarray(img).convert(mode)
            buf = io.BytesIO()
            im.save(buf, "TIFF", compression=comp)
            out[f"pil_{mode.lower()}_{comp or 'raw'}.tif"] = buf.getvalue()
    i16 = (img[..., 0].astype(np.uint16) * 257 - 30000).astype(np.uint16)
    f32 = img[..., 1].astype(np.float32) * 1.37 - 40.25
    for name, im in (("i16", Image.fromarray(i16)),
                     ("f32", Image.fromarray(f32, "F"))):
        for comp in (None, "tiff_lzw"):
            buf = io.BytesIO()
            im.save(buf, "TIFF", compression=comp)
            out[f"pil_{name}_{comp or 'raw'}.tif"] = buf.getvalue()
    return out


def own_tiffs(rng) -> dict:
    def noise(c, bits=8, kind="u"):
        if kind == "f":
            return (rng.standard_normal((H, W, c)) * 120 + 100).astype(
                np.float32)
        return rng.integers(0, 1 << bits, (H, W, c)).astype(
            np.uint16 if bits > 8 else np.uint8)

    rgb, rgba = noise(3), noise(4)
    rgb16, rgba16 = noise(3, 16), noise(4, 16)
    cmap8 = rng.integers(0, 65536, (3, 256))
    cmap4 = rng.integers(0, 65536, (3, 16))
    out = {
        "tiles_rgb_lzw.tif": tiff_file(rgb, bits=8, photometric=2,
                                       compression=5, tile=(16, 16)),
        "tiles_rgba_deflate_pred2.tif": tiff_file(
            rgba, bits=8, photometric=2, extra=(2,), compression=8,
            predictor=2, tile=(32, 16)),
        "planar_rgb_deflate.tif": tiff_file(rgb, bits=8, photometric=2,
                                            compression=32946, planar=2,
                                            rows_per_strip=8),
        "planar_rgba_lzw_tiles.tif": tiff_file(
            rgba, bits=8, photometric=2, extra=(2,), compression=5,
            planar=2, tile=(16, 16)),
        "planar_rgb_raw.tif": tiff_file(rgb, bits=8, photometric=2,
                                        planar=2, rows_per_strip=5),
        "mm_rgb_lzw_pred2.tif": tiff_file(rgb, bits=8, photometric=2,
                                          order="MM", compression=5,
                                          predictor=2, rows_per_strip=6),
        "mm_grey16_deflate.tif": tiff_file(noise(1, 16), bits=16,
                                           photometric=1, order="MM",
                                           compression=8),
        "mm_grey16_raw.tif": tiff_file(noise(1, 16), bits=16,
                                       photometric=1, order="MM"),
        "mm_float_deflate.tif": tiff_file(noise(1, kind="f"), bits=32,
                                          photometric=1, sample_format=3,
                                          order="MM", compression=8),
        "bigtiff_rgb_deflate.tif": tiff_file(rgb, bits=8, photometric=2,
                                             bigtiff=True, compression=8),
        "bigtiff_grey_raw_tiles.tif": tiff_file(noise(1), bits=8,
                                                photometric=1, bigtiff=True,
                                                tile=(16, 16)),
        "rgb16_lzw_pred2.tif": tiff_file(rgb16, bits=16, photometric=2,
                                         compression=5, predictor=2),
        "mm_rgb16_packbits.tif": tiff_file(rgb16, bits=16, photometric=2,
                                           order="MM", compression=32773),
        "rgba16_deflate.tif": tiff_file(rgba16, bits=16, photometric=2,
                                        extra=(2,), compression=8),
        "float_deflate_pred3.tif": tiff_file(noise(1, kind="f"), bits=32,
                                             photometric=1, sample_format=3,
                                             compression=8, predictor=3),
        "float_lzw_pred3_tiles.tif": tiff_file(noise(1, kind="f"), bits=32,
                                               photometric=1,
                                               sample_format=3,
                                               compression=5, predictor=3,
                                               tile=(16, 16)),
        "assoc_alpha_lzw.tif": tiff_file(rgba, bits=8, photometric=2,
                                         extra=(1,), compression=5),
        "assoc_alpha_raw.tif": tiff_file(rgba, bits=8, photometric=2,
                                         extra=(1,)),
        "assoc_alpha16_deflate.tif": tiff_file(rgba16, bits=16,
                                               photometric=2, extra=(1,),
                                               compression=8),
        "palette8_cmap16_lzw.tif": tiff_file(noise(1), bits=8,
                                             photometric=3, compression=5,
                                             colormap=cmap8),
        "palette4_cmap16_raw_tiles.tif": tiff_file(
            noise(1, 4), bits=4, photometric=3, colormap=cmap4,
            tile=(16, 16)),
        "fillorder2_bilevel_raw.tif": tiff_file(noise(1, 1), bits=1,
                                                photometric=0, fill_order=2),
        "fillorder2_rgb_lzw.tif": tiff_file(rgb, bits=8, photometric=2,
                                            compression=5, fill_order=2),
        "cmyk16_lzw.tif": tiff_file(noise(4, 16), bits=16, photometric=5,
                                    compression=5),
        "cmyk_planar_packbits.tif": tiff_file(noise(4), bits=8,
                                              photometric=5,
                                              compression=32773, planar=2),
    }
    for bits in (1, 2, 4, 8, 16):
        for pm in (0, 1):
            if bits == 16 and pm == 0:
                continue                 # PIL reads 16-bit white-is-zero
            out[f"grey{bits}_pm{pm}_lzw.tif"] = tiff_file(
                noise(1, bits), bits=bits, photometric=pm, compression=5,
                rows_per_strip=7)
    out["grey16_pm0_raw.tif"] = tiff_file(noise(1, 16), bits=16,
                                          photometric=0)
    return out


def gifs(rng) -> dict:
    from PIL import Image

    out = {}
    idx = rng.integers(0, 200, (H, W), dtype=np.uint8)
    idx[4:10, :] = 7
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
    for interlace in (False, True):
        buf = io.BytesIO()
        im.save(buf, "GIF", interlace=interlace)
        out[f"pil_palette{'_interlaced' if interlace else ''}.gif"] = \
            buf.getvalue()
    small = rng.integers(0, 16, (13, 19), dtype=np.uint8)
    table16 = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    table4 = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    out["local_table_offset.gif"] = gif_file(
        small % 4, screen=(30, 24), offset=(5, 7), global_table=table16,
        local_table=table4, transparency=3)
    out["global_interlaced.gif"] = gif_file(small, global_table=table16,
                                            interlace=True)
    out["grey_ramp.gif"] = gif_file(
        small, global_table=np.repeat(np.arange(16, dtype=np.uint8)[:, None],
                                      3, 1))
    out["no_table_grows_screen.gif"] = gif_file(small, screen=(10, 10),
                                                offset=(2, 1))
    return out


def icos(rng) -> dict:
    from PIL import Image

    out = {}
    img = rng.integers(0, 256, (48, 48, 4), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "ICO", sizes=[(16, 16), (32, 32),
                                                 (48, 48)])
    out["pil_png_entries.ico"] = buf.getvalue()
    w, h = 21, 19
    mask = rng.integers(0, 2, (h, w), dtype=np.uint8)
    entries = []
    for bits in (1, 4, 8):
        pal = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
        px = rng.integers(0, 1 << bits, (h, w), dtype=np.uint8)
        entries.append((w, h, bits, dib(px, bits, pal, mask)))
    for bits in (24, 32):
        px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        entries.append((w, h, bits, dib(px, bits, None, mask)))
    for w_, h_, bits, payload in entries:
        out[f"bmp_{bits}bpp.ico"] = ico_file([(w_, h_, bits, payload)])
    # Two sizes and two depths: PIL opens the larger, lower depth first.
    big = rng.integers(0, 256, (24, 24, 4), dtype=np.uint8)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    mask24 = rng.integers(0, 2, (24, 24), dtype=np.uint8)
    out["mixed_entries.ico"] = ico_file(
        [entries[0], (24, 24, 32, dib(big, 32)),
         (24, 24, 4, dib(big[..., 0] % 16, 4, pal, mask24))])
    return out


def scene_textures(out_dir: str) -> dict:
    """The TIFF scene's albedo and leaf (demo_scene.write_tiff_textures)."""
    from tracerboy_tpu_torch.utils.demo_scene import write_tiff_textures

    paths = write_tiff_textures(out_dir)
    names = {ALBEDO: paths["albedo.png"], LEAF: paths["leaf.png"]}
    out = {}
    for name, path in names.items():
        with open(path, "rb") as f:
            out[name] = f.read()
    return out


def main(out_dir: str = FIXTURE_DIR) -> dict:
    import PIL

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20261018)
    files = {**pil_tiffs(rng), **own_tiffs(rng), **gifs(rng), **icos(rng),
             **scene_textures(out_dir)}
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
