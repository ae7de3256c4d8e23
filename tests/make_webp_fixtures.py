"""Write the WebP, QOI, PNM and PSD fixtures of the port's readers and
their manifest.

    PYTHONPATH=. python tests/make_webp_fixtures.py [OUT_DIR]

Writes into tests/data/webp/ (or OUT_DIR) a small file of each layout the
port's readers (core/webp.py, core/qoi.py, core/pnm.py, core/psd.py,
csrc/webp_decode.cpp) take:
- WebP written by PIL: lossless RGB and RGBA at methods 0 and 6 with
  `exact` on and off; palettes of 2, 4, 16 and 256 colours; lossy at
  qualities 0, 50 and 100 and methods 0-6, without alpha and with alpha
  at alpha_quality 100 and 30; sizes 1x1, 1x37, 37x1 and 17x33 lossy and
  lossless; the first frame of 3-frame animations, lossy and lossless;
- WebP written by tests/webp_encode.py: raw and lossless ALPH chunks
  under each filter; VP8 frames of random syntax with the simple and
  the normal loop filter and 1, 2, 4 and 8 token partitions; VP8L
  streams of random transforms (predictor modes 14 and 15 among them);
  animations whose first frame is smaller than the canvas; VP8X files
  with ICCP, EXIF, XMP and unknown chunks of odd sizes;
- QOI (3 and 4 channels) and PNM (P4, P5 at 255 and 65535, P6) written
  by PIL; PNM and PSD written by tests/psd_encode.py: plain P1-P3 at
  several maxvals, raw P5/P6 at other maxvals, Pf both ways, PIL's
  P0CMYK/PyP/PyRGBA/PyCMYK; PSD raw and PackBits in every colour mode
  PIL converts without LittleCMS (bitmap, grey, palette, RGB, RGBA,
  CMYK, multichannel, duotone);
- the WebP scene's textures: utils/demo_scene's 1024x1024 albedo as a
  lossy WebP (quality 90) and as a lossless one, and its 512x512 leaf as
  a lossy WebP (VP8X + ALPH + VP8) whose alpha, lossless-coded under the
  gradient filter, makes the cutouts.
manifest.json holds, for each file, the shape, dtype and sha256 of
np.asarray of what the JAX read_ldr decodes through PIL (Image.open,
converted to RGB or RGBA as read_ldr converts it), and PIL's and
libwebp's versions. The machine with the card has no PIL: chip_smoke.py
and tests/test_torch_webp_cuda.py hold the port against the manifest
there; tests/test_torch_webp.py and tests/test_torch_qoi_pnm_psd.py hold
the manifest against PIL.
"""

from __future__ import annotations

import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import psd_encode as pe  # noqa: E402
import webp_encode as we  # noqa: E402
from make_dds_fixtures import array_digest, pil_pixels  # noqa: E402

FIXTURE_DIR = os.path.join(HERE, "data", "webp")
ALBEDO, ALBEDO_LOSSLESS, LEAF = ("albedo.webp", "albedo_lossless.webp",
                                 "leaf.webp")
W, H = 37, 21


def _image(rng, h=H, w=W, alpha=True):
    """Noise beside flat patches and a gradient, alpha of three levels."""
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[h // 4:h // 2, w // 5:] = img[0, 0]
    yy, xx = np.mgrid[0:h, 0:w]
    img[h // 2:, :, 1] = ((xx * 7 + yy * 3) % 256)[h // 2:]
    img[..., 3] = rng.choice([0, 128, 255], (h, w)) if alpha else 255
    return img


def _save(img, mode, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img if mode == "RGBA" else img[..., :3], mode).save(
        buf, "WEBP", **kw)
    return buf.getvalue()


def pil_webps(rng) -> dict:
    from PIL import Image

    out = {}
    img = _image(rng)
    for mode in ("RGB", "RGBA"):
        for method in (0, 6):
            for exact in (False, True):
                out[f"lossless_{mode.lower()}_m{method}"
                    f"{'_exact' if exact else ''}.webp"] = _save(
                    img, mode, lossless=True, method=method, exact=exact)
    for n in (2, 4, 16, 256):
        pal = rng.integers(0, 256, (n, 4), dtype=np.uint8)
        idx = rng.integers(0, n, (H, W))
        out[f"palette_{n}.webp"] = _save(pal[idx], "RGBA", lossless=True)
    for q in (0, 50, 100):
        for m in range(7):
            out[f"lossy_q{q}_m{m}.webp"] = _save(img, "RGB", quality=q,
                                                 method=m)
            for aq in (100, 30):
                out[f"lossy_alpha{aq}_q{q}_m{m}.webp"] = _save(
                    img, "RGBA", quality=q, method=m, alpha_quality=aq)
    for h, w in ((1, 1), (1, 37), (37, 1), (17, 33)):
        small = _image(rng, h, w)
        out[f"size_{w}x{h}_lossy.webp"] = _save(small, "RGBA", quality=75)
        out[f"size_{w}x{h}_lossless.webp"] = _save(small, "RGBA",
                                                   lossless=True)
    frames = [Image.fromarray(_image(rng), "RGBA") for _ in range(3)]
    for lossless in (False, True):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                       lossless=lossless, duration=40)
        out[f"anim_{'lossless' if lossless else 'lossy'}.webp"] = \
            buf.getvalue()
    return out


def own_webps(rng) -> dict:
    out = {}
    img = _image(rng)
    vp8 = we.image_chunks(_save(img, "RGB", quality=80))
    plane = img[..., 3]
    for filt in range(4):
        out[f"alph_raw_filter{filt}.webp"] = we.riff(
            we.vp8x_chunk(W, H, alpha=True),
            we.alph_chunk(we.filter_alpha(plane, filt), 0, filt), vp8)
        out[f"alph_lossless_filter{filt}.webp"] = we.riff(
            we.vp8x_chunk(W, H, alpha=True), we.lossless_alph(plane, filt),
            vp8)
    for simple in (False, True):
        for plog in range(4):
            frame = we.vp8_frame(rng, 45, 35, simple=simple,
                                 partitions_log2=plog)
            out[f"vp8_{'simple' if simple else 'normal'}_parts"
                f"{1 << plog}.webp"] = we.riff(we.chunk(b"VP8 ", frame))
    for i, (order, palette) in enumerate(((("predictor", "cross", "green"),
                                          None),
                                         (("green", "predictor"), None),
                                         (("predictor",), 11))):
        out[f"vp8l_transforms{i}.webp"] = we.riff(we.chunk(
            b"VP8L", we.vp8l_transforms(rng, 23, 19, order, palette)))
    lossy_a = we.image_chunks(_save(img, "RGBA", quality=70))
    lossless = we.image_chunks(_save(img, "RGBA", lossless=True))
    for name, chunks in (("lossy", lossy_a), ("lossless", lossless)):
        out[f"anim_offset_{name}.webp"] = we.anim_file(
            (W + 14, H + 9), [(chunks, W, H, 8, 6), (chunks, W, H, 0, 0)])
    extra = (we.chunk(b"ICCP", b"icc"), we.chunk(b"EXIF", b"exif!"),
             we.chunk(b"XMP ", b"<x/>"), we.chunk(b"ABCD", b"q"))
    out["vp8x_chunks_lossy.webp"] = we.riff(
        we.vp8x_chunk(W, H, alpha=True, extra=0x2C), extra[0], lossy_a,
        *extra[1:])
    out["vp8x_chunks_lossless.webp"] = we.riff(
        we.vp8x_chunk(W, H, alpha=True), extra[3], lossless, extra[1])
    return out


def qoi_pnm_psd(rng) -> dict:
    from PIL import Image

    out = {}
    img = _image(rng)
    for mode in ("RGB", "RGBA"):
        buf = io.BytesIO()
        Image.fromarray(img if mode == "RGBA" else img[..., :3], mode).save(
            buf, "QOI")
        out[f"pil_{mode.lower()}.qoi"] = buf.getvalue()
    for mode, ext in (("1", "pbm"), ("L", "pgm"), ("RGB", "ppm")):
        buf = io.BytesIO()
        Image.fromarray(img[..., :3]).convert(mode).save(buf, "PPM")
        out[f"pil_{mode.lower()}.{ext}"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 65536, (H, W)).astype(np.uint16)).save(
        buf, "PPM")
    out["pil_16bit.pgm"] = buf.getvalue()
    out["plain_p1.pbm"] = pe.pnm_file(b"P1", rng.integers(0, 2, (H, W)),
                                      comments=True, sep=b"")
    for maxval in (1, 100, 255, 1000, 65535):
        out[f"plain_p2_max{maxval}.pgm"] = pe.pnm_file(
            b"P2", rng.integers(0, maxval + 1, (H, W)), maxval,
            comments=True)
    for maxval in (7, 255, 4095):
        out[f"plain_p3_max{maxval}.ppm"] = pe.pnm_file(
            b"P3", rng.integers(0, maxval + 1, (H, W, 3)), maxval)
    for maxval in (100, 1000, 65535):
        out[f"raw_p5_max{maxval}.pgm"] = pe.pnm_file(
            b"P5", rng.integers(0, maxval + 1, (H, W)), maxval)
    for maxval in (15, 300):
        out[f"raw_p6_max{maxval}.ppm"] = pe.pnm_file(
            b"P6", rng.integers(0, maxval + 1, (H, W, 3)), maxval)
    f = (rng.standard_normal((H, W)) * 150 + 100).astype(np.float32)
    f[0, :3] = [np.nan, np.inf, -np.inf]
    out["pf_little.pfm.bin"] = pe.pnm_file(b"Pf", f, scale=-1.0)
    out["pf_big.bin"] = pe.pnm_file(b"Pf", f, scale=2.0)
    for magic, bands in ((b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyRGBA", 4),
                         (b"PyP", 1)):
        shape = (H, W, bands) if bands > 1 else (H, W)
        out[f"pil_{magic.decode().lower()}.pnm"] = pe.pnm_file(
            magic, rng.integers(0, 256, shape), 255)
    for cmode, name, c in ((0, "bitmap", 1), (1, "grey", 1),
                           (2, "palette", 1), (3, "rgb", 3), (3, "rgba", 4),
                           (4, "cmyk", 4), (7, "multichannel", 3),
                           (8, "duotone", 1)):
        rowbytes = (W + 7) // 8 if cmode == 0 else W
        planes = rng.integers(0, 256, (c, H, rowbytes), dtype=np.uint8)
        planes[:, H // 3:, :rowbytes // 2] = 9          # runs for PackBits
        colours = (bytes(rng.integers(0, 256, 768, dtype=np.uint8))
                   if cmode == 2 else b"")
        for comp in (0, 1):
            out[f"{name}_{'rle' if comp else 'raw'}.psd"] = pe.psd_file(
                planes, cmode, 1 if cmode == 0 else 8, comp,
                colour_data=colours,
                resources=[(1005, b"res", bytes(5)), (1039, b"", b"icc")],
                layer_block=bytes(12) if comp else b"")
    # Lab with 3, 4 and 5 channels (PIL reads three), raw and PackBits:
    # their own generator, so the files above keep their bytes.
    lab = np.random.default_rng(20261027)
    for c in (3, 4, 5):
        planes = lab.integers(0, 256, (c, H, W), dtype=np.uint8)
        planes[:, H // 3:, :W // 2] = 200
        for comp in (0, 1):
            out[f"lab_{c}ch_{'rle' if comp else 'raw'}.psd"] = pe.psd_file(
                planes, 9, 8, comp)
    return out


def scene_textures() -> dict:
    """The WebP scene's albedo (lossy and lossless) and cut-out leaf."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image, leaf_image

    albedo = _to_uint8(albedo_image(1024))
    leaf = _to_uint8(leaf_image(512))
    vp8 = we.image_chunks(_save(leaf, "RGB", quality=90))
    return {ALBEDO: _save(albedo, "RGB", quality=90),
            ALBEDO_LOSSLESS: _save(albedo, "RGB", lossless=True, method=6),
            LEAF: we.riff(we.vp8x_chunk(512, 512, alpha=True),
                          we.lossless_alph(leaf[..., 3], 3), vp8)}


def main(out_dir: str = FIXTURE_DIR) -> dict:
    import PIL
    from PIL import features

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20261019)
    files = {**pil_webps(rng), **own_webps(rng), **qoi_pnm_psd(rng),
             **scene_textures()}
    manifest = {"pil": PIL.__version__, "libwebp": features.version("webp"),
                "files": {}}
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
