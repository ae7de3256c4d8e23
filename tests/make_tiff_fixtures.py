"""Write the TIFF, GIF and ICO fixtures of the port's readers and their
manifest.

    PYTHONPATH=. python tests/make_tiff_fixtures.py [OUT_DIR]

Writes into tests/data/tiff/ (or OUT_DIR) a small file of each layout the
port's readers (core/tiff.py, core/gif.py, core/ico.py,
csrc/lzw_codecs.cpp, csrc/tiff_codecs.cpp) take:
- TIFF written by PIL (strips: none, LZW, Deflate and PackBits over RGB,
  RGBA, L, 1-bit, I;16, F, CMYK, P and LA; LZMA and Zstandard over the
  same, with and without Predictor 2; JPEG from RGB, L and YCbCr at two
  qualities; modified Huffman, Group 3 with T4Options 0, 1, 4 and 5 and
  Group 4 at an odd width; CIELab) and by tests/tiff_encode.py (the
  layouts PIL's writer cannot: tiles with cropped edges, planar 2,
  big-endian files, BigTIFF, Predictor 2 at 8 and 16 bits, Predictor 3,
  associated alpha at 8 and 16 bits, 16-bit colour maps, FillOrder 2,
  2- and 4-bit grey at both photometrics, 16-bit RGB and CMYK, float
  with PIL's big-endian quirk; JPEG in strips and cropped tiles at
  4:4:4, 4:2:2 and 4:2:0 with and without JPEGTables, YCbCr under LZW
  and Deflate at every subsampling libtiff converts, LZMA and Zstandard
  in tiles and planes, Zstandard frames of raw and RLE blocks with a
  checksum, CCITT with FillOrder 2 and damaged, old-style LZW,
  ThunderScan, RLE-word, files without StripByteCounts);
- GIF written by PIL (global table, interlaced) and by tiff_encode (a
  local table, a frame smaller than the screen at an offset over a
  transparent fill, a grey-ramp table read as L, interlaced rows);
- ICO written by PIL (PNG entries of three sizes) and by tiff_encode
  (BMP entries at 1, 4, 8, 24 and 32 bits a pixel with AND masks);
- the TIFF scenes' textures: utils/demo_scene.write_tiff_textures' 1024x1024
  albedo in 160x160 Deflate tiles and 512x512 RGBA LZW leaf, and the
  GDAL-style ones (gdal_textures): the albedo as GDAL writes
  COMPRESS=JPEG PHOTOMETRIC=YCBCR (quality 90, 4:2:0, 256x256 tiles,
  JPEGTables) and, with the leaf, as Zstandard with Predictor 2.
manifest.json holds, for each file, the shape, dtype and sha256 of
np.asarray of what the JAX read_ldr decodes through PIL (Image.open,
converted to RGB or RGBA as read_ldr converts it), and PIL's version.
The machine with the card has no PIL: chip_smoke.py and
tests/test_torch_tiff_cuda.py hold the port against the manifest there;
tests/test_torch_tiff.py, tests/test_torch_tiff_codecs.py and
tests/test_torch_gif_ico.py hold the manifest against PIL. PIL's TIFF
writer can leave libtiff broken after a refused save, so every PIL save
here is one PIL accepts.
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
from tiff_encode import (  # noqa: E402
    _REVERSE,
    LONG,
    RATIONAL,
    SHORT,
    compress,
    dib,
    gif_file,
    ico_file,
    jpeg_tiff,
    lzw_compat,
    mh_rows,
    thunderscan,
    tiff_file,
    ycbcr_segment,
    zstd_frame,
)

FIXTURE_DIR = os.path.join(HERE, "data", "tiff")
ALBEDO = "albedo.tif"
LEAF = "leaf.tif"
ALBEDO_JPEG = "albedo_jpeg_ycbcr.tif"
ALBEDO_ZSTD = "albedo_zstd.tif"
LEAF_ZSTD = "leaf_zstd.tif"
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


def _pil_save(im, **save) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **save)
    return buf.getvalue()


def pil_codec_tiffs(rng) -> dict:
    """LZMA, Zstandard, JPEG, CCITT and CIELab files from PIL's writer."""
    from PIL import Image

    out = {}
    img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    img[4:13, 2:31] = img[5, 9]
    for mode in ("RGB", "RGBA", "L", "1", "P", "CMYK", "LA", "I;16", "F"):
        im = Image.fromarray(img).convert(mode)
        for comp in ("lzma", "zstd"):
            tag = mode.lower().replace(";", "")
            out[f"pil_{tag}_{comp}.tif"] = _pil_save(im, compression=comp)
            if mode in ("RGB", "RGBA", "L", "I;16", "F"):
                out[f"pil_{tag}_{comp}_pred2.tif"] = _pil_save(
                    im, compression=comp, tiffinfo={317: 2})
    rgb = Image.fromarray(img[..., :3])
    for mode in ("RGB", "L", "YCbCr"):
        for q in (50, 90):
            out[f"pil_{mode.lower()}_jpeg_q{q}.tif"] = _pil_save(
                rgb.convert(mode), compression="jpeg", quality=q)
    bw = Image.fromarray(rng.random((29, 53)) > 0.4)
    out["pil_1_ccitt_mh.tif"] = _pil_save(bw, compression="tiff_ccitt")
    out["pil_1_group4.tif"] = _pil_save(bw, compression="group4")
    for t4 in (0, 1, 4, 5):
        out[f"pil_1_group3_t4_{t4}.tif"] = _pil_save(
            bw, compression="group3", tiffinfo={292: t4})
    lab = Image.frombytes("LAB", (W, H), img[..., :3].tobytes())
    out["pil_lab_raw.tif"] = _pil_save(lab)
    out["pil_lab_lzw.tif"] = _pil_save(lab, compression="tiff_lzw")
    return out


def _strip(data: bytes) -> bytes:
    """The one strip of a PIL-written TIFF."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        off, cnt = im.tag_v2[273][0], im.tag_v2[279][0]
    return data[off:off + cnt]


def codec_tiffs(rng) -> dict:
    """The GDAL and fax layouts PIL's writer cannot write."""
    from PIL import Image

    out = {}
    img = rng.integers(0, 256, (45, 53, 3), dtype=np.uint8)
    img[10:30, 5:40] = (200, 30, 90)
    for sub, name in ((0, "444"), (1, "422"), (2, "420")):
        for tables in (True, False):
            t = "tables" if tables else "full"
            out[f"jpeg_ycbcr_{name}_{t}_strips.tif"] = jpeg_tiff(
                img, photometric=6, subsampling=sub, tables=tables,
                rows_per_strip=16)
            out[f"jpeg_ycbcr_{name}_{t}_tiles.tif"] = jpeg_tiff(
                img, photometric=6, subsampling=sub, tables=tables,
                tile=(16, 32))
    out["jpeg_ycbcr_420_no_sampling_tag.tif"] = jpeg_tiff(
        img, photometric=6, subsampling=2, sampling_tag=False,
        rows_per_strip=16)
    out["jpeg_ycbcr_420_full_last_strip.tif"] = jpeg_tiff(
        img, photometric=6, subsampling=2, rows_per_strip=16,
        full_last_strip=True)
    out["jpeg_rgb_ycc_stream.tif"] = jpeg_tiff(
        img, photometric=2, subsampling=0, rows_per_strip=16)
    out["jpeg_rgb_keep_rgb_tiles.tif"] = jpeg_tiff(
        img, photometric=2, subsampling=0, keep_rgb=True, tile=(32, 16))
    out["jpeg_grey_strips.tif"] = jpeg_tiff(img[..., 1], photometric=1,
                                            subsampling=0, rows_per_strip=8)
    hgt, wid = 21, 37
    rbw = [15, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]
    coeffs = [2126, 10000, 7152, 10000, 722, 10000]
    for k, (hs, vs) in enumerate(((1, 1), (2, 1), (2, 2), (4, 1), (4, 2),
                                  (4, 4), (1, 2))):
        rps = {1: 5, 2: 6, 4: 8}[vs]
        comp = (5, 8)[k % 2]
        y = rng.integers(0, 256, (hgt, wid), dtype=np.uint8)
        segs = []
        for y0 in range(0, hgt, rps):
            r = min(rps, hgt - y0)
            chroma = rng.integers(0, 256, (2, -(-r // vs), -(-wid // hs)))
            segs.append(compress(ycbcr_segment(y[y0:y0 + r], *chroma, hs, vs),
                                 comp))
        for with_rbw in (False, True):
            tags = [(530, SHORT, [hs, vs])]
            if with_rbw:
                tags += [(529, RATIONAL, coeffs), (532, RATIONAL, rbw)]
            name = f"ycbcr_{hs}x{vs}_{'lzw' if comp == 5 else 'deflate'}"
            out[f"{name}{'_rbw' if with_rbw else ''}.tif"] = tiff_file(
                np.zeros((hgt, wid, 3), np.uint8), bits=8, photometric=6,
                compression=comp, rows_per_strip=rps, segments=segs,
                tags=tags)
    segs = []
    for _ in range(6):
        y = rng.integers(0, 256, (16, 16), dtype=np.uint8)
        segs.append(compress(ycbcr_segment(
            y, *rng.integers(0, 256, (2, 8, 8)), 2, 2), 5))
    # 4x4 in tiles cropped at the right, Predictor 2 over libtiff's rows:
    # the 4x4 routine's 10-byte skew and the predictor's row size.
    out["ycbcr_4x4_lzw_tiles_pred2.tif"] = tiff_file(
        rng.integers(0, 256, (hgt, wid, 3), dtype=np.uint8), bits=8,
        photometric=6, compression=5, predictor=2, tile=(16, 16),
        tags=[(530, SHORT, [4, 4])])
    out["ycbcr_2x2_lzw_tiles.tif"] = tiff_file(
        np.zeros((hgt, wid, 3), np.uint8), bits=8, photometric=6,
        compression=5, tile=(16, 16), segments=segs,
        tags=[(530, SHORT, [2, 2])])
    # Uncompressed: PIL's raw mode RGBX reads 4 bytes a pixel, here from
    # the samples and the IFD after them.
    out["ycbcr_raw_rgbx.tif"] = tiff_file(
        rng.integers(0, 256, (5, 6, 3), dtype=np.uint8), bits=8,
        photometric=6, tags=[(530, SHORT, [1, 1])])
    rgb = rng.integers(0, 256, (hgt, wid, 3), dtype=np.uint8)
    rgb[3:15, 4:30] = rgb[4, 4]
    for comp, name in ((34925, "lzma"), (50000, "zstd")):
        out[f"{name}_tiles_pred2.tif"] = tiff_file(
            rgb, bits=8, photometric=2, compression=comp, predictor=2,
            tile=(16, 16))
        out[f"{name}_planar.tif"] = tiff_file(
            rgb, bits=8, photometric=2, compression=comp, planar=2,
            rows_per_strip=8)
    raw = rgb.tobytes()
    out["zstd_raw_rle_blocks_checksum.tif"] = tiff_file(
        rgb, bits=8, photometric=2, compression=50000,
        segments=[zstd_frame(raw, block=700)])
    flat = np.full_like(rgb, 77)
    flat[10:] = rgb[10:]
    out["zstd_rle_blocks_no_size.tif"] = tiff_file(
        flat, bits=8, photometric=2, compression=50000,
        segments=[zstd_frame(flat.tobytes(), block=37 * 3,
                             content_size=False)])
    bits = rng.random((29, 53)) > 0.4
    bw = Image.fromarray(~bits)
    for comp, code, t4 in (("group4", 4, None), ("group3", 3, 5),
                           ("group3_1d", 3, 4)):
        info = {"tiffinfo": {292: t4}} if t4 is not None else {}
        strip = _strip(_pil_save(bw, compression=comp[:6], **info))
        tags = [(292, LONG, t4)] if t4 is not None else []
        if comp != "group3_1d":
            out[f"{comp}_fillorder2.tif"] = tiff_file(
                bits.astype(np.uint8), bits=1, photometric=1,
                compression=code, fill_order=2, tags=tags,
                segments=[_REVERSE[np.frombuffer(strip, np.uint8)]
                          .tobytes()])
        if comp == "group3":
            continue     # damage can end a 2D strip early: see tiff.py
        bad = bytearray(strip)
        for at in (len(bad) // 3, len(bad) // 2):
            bad[at] ^= 0x5A
        out[f"{comp}_damaged.tif"] = tiff_file(
            bits.astype(np.uint8), bits=1, photometric=0, compression=code,
            tags=tags, segments=[bytes(bad)])
    out["ccitt_rlew.tif"] = tiff_file(
        bits.astype(np.uint8), bits=1, photometric=0, compression=32771,
        rows_per_strip=10, segments=[mh_rows(bits[y:y + 10], True)
                                     for y in range(0, 29, 10)])
    out["lzw_old_style.tif"] = tiff_file(
        rgb, bits=8, photometric=2, compression=5, rows_per_strip=8,
        segments=[lzw_compat(rgb[y:y + 8].tobytes())
                  for y in range(0, hgt, 8)])
    grey4 = rng.integers(0, 16, (hgt, wid), dtype=np.uint8)
    grey4[5:12, 3:30] = 9
    for pm in (0, 1):
        out[f"thunderscan_pm{pm}.tif"] = tiff_file(
            grey4, bits=4, photometric=pm, compression=32809,
            rows_per_strip=8, segments=[thunderscan(grey4[y:y + 8], y)
                                        for y in range(0, hgt, 8)])
    for comp, name in ((5, "lzw"), (8, "deflate")):
        out[f"no_bytecounts_{name}.tif"] = tiff_file(
            rgb, bits=8, photometric=2, compression=comp, drop=(279,))
    return out


def gdal_textures() -> dict:
    """The GDAL-style TIFF scene's textures from utils/demo_scene's images:
    the 1024x1024 albedo as COMPRESS=JPEG PHOTOMETRIC=YCBCR (quality 90,
    4:2:0, 256x256 tiles, JPEGTables) and as Zstandard with Predictor 2,
    and the 512x512 RGBA leaf (unassociated alpha) as Zstandard with
    Predictor 2, both by PIL's writer."""
    from PIL import Image

    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image, leaf_image

    albedo = _to_uint8(albedo_image(1024))
    leaf = _to_uint8(leaf_image(512))
    return {
        ALBEDO_JPEG: jpeg_tiff(albedo, photometric=6, quality=90,
                               subsampling=2, tile=(256, 256)),
        ALBEDO_ZSTD: _pil_save(Image.fromarray(albedo), compression="zstd",
                               tiffinfo={317: 2}),
        LEAF_ZSTD: _pil_save(Image.fromarray(leaf), compression="zstd",
                             tiffinfo={317: 2}),
    }


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
    codec_rng = np.random.default_rng(20261020)
    files.update({**pil_codec_tiffs(codec_rng), **codec_tiffs(codec_rng),
                  **gdal_textures()})
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
