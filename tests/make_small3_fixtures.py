"""Write the fixtures of the port's readers of PIL's small formats, part 3,
and of its 4-component JPEG reading, and their manifest.

    PYTHONPATH=. python tests/make_small3_fixtures.py [OUT_DIR]

Writes into tests/data/small3/ (or OUT_DIR) a small file of each layout
the readers (core/fits.py, core/fli.py, core/iptc.py; core/jpeg.py and
core/blp.py for CMYK and YCCK JPEGs; csrc/small_decode.cpp and
csrc/jpeg_decode.cpp) take, written by tests/small_encode.py and
tests/jpeg_encode.py where PIL has no writer:
- FITS: BITPIX 8, 16 (BZERO and BSCALE, which PIL ignores), 32, -32 and
  -64, one axis, an image extension after an empty primary unit, data
  shorter than a card (PIL's offset falls into the header's padding),
  and gzip tiles of 8, 16 and 32 bits;
- FLI and FLC: COLOR_256 and COLOR_64 palettes (skip packets, a count of
  0 for 256 entries, none at all), BRUN, COPY, LC and SS2 (line skips, a
  last byte) first frames, BLACK and a postage stamp;
- IPTC: raw L, raw RGB and CMYK bands, an inner grey JPEG with and
  without a band, an inner RGB PNG kept whole, extended field sizes and
  the image in several records;
- JPEG: PIL's CMYK saves (Adobe transform 0, baseline and progressive),
  4-component files without an Adobe marker, YCCK under transforms 1
  and 2, subsampled CMYK and YCCK components, a small BLP1 of each kind,
  and albedo_blp1_cmyk.blp: the textured scene's 1024x1024 albedo, in
  BLP's BGR order, as PIL's CMYK JPEG save at quality 75 in a BLP1 of
  alpha depth 0, which reads as the albedo (the card's run of kernel 1
  reads it; the card's machine has no JPEG encoder).
PCD files (786 KB each) are not written: the tests make them from a
seed.
manifest.json holds, for each file, the shape, dtype and sha256 of
np.asarray of what the JAX read_ldr decodes through PIL, and PIL's
version; under "generated", for each file utils/demo_scene's
write_small3_textures writes (the albedo as an FLC, a PhotoCD, raw and
gzip FITS and a raw IPTC image), the sha256 of the file's bytes and
PIL's digest of its pixels (the gzip FITS's bytes depend on zlib, so
the tests compare its pixels only): those files are not committed, the
card's machine writes them again, and chip_smoke.py and
tests/test_torch_small_cuda.py hold the port's readers against both
digests there (it has no PIL).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import tempfile

import numpy as np

import jpeg_encode as je
import small_encode as se
from make_dds_fixtures import array_digest, pil_pixels
from make_small_fixtures import texture

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "data", "small3")


def fits_files(rng) -> dict:
    out = {}
    img = texture(rng, 5, 7, 1)[..., 0]

    def head(bits, w, h, *extra):
        return [("SIMPLE", "T"), ("BITPIX", bits), ("NAXIS", 2),
                ("NAXIS1", w), ("NAXIS2", h), *extra]

    body = np.ascontiguousarray(img[::-1]).tobytes() + bytes(100)
    out["fits_8.fits"] = se.fits([(head(8, 7, 5), body)])
    wide = rng.integers(0, 1 << 16, (6, 9)).astype(">u2")
    out["fits_16_bzero.fits"] = se.fits([(head(16, 9, 6, ("BZERO", 32768),
                                                ("BSCALE", 2)),
                                          wide.tobytes())])
    deep = rng.integers(-400, 400, (4, 6)).astype(">i4")
    out["fits_32.fits"] = se.fits([(head(32, 6, 4), deep.tobytes())])
    f = (rng.random((5, 6)) * 400 - 80).astype(np.float32)
    f[0, 0], f[2, 3] = np.nan, np.inf
    out["fits_f32.fits"] = se.fits([(head(-32, 6, 5), f.astype(">f4")
                                     .tobytes())])
    d = (rng.random((4, 5)) * 300).astype(">f8")
    out["fits_f64.fits"] = se.fits([(head(-64, 5, 4), d.tobytes())])
    out["fits_naxis1.fits"] = se.fits([([("SIMPLE", "T"), ("BITPIX", 8),
                                         ("NAXIS", 1), ("NAXIS1", 90)],
                                        img.tobytes()[:35] * 3)])
    out["fits_extension.fits"] = se.fits([
        ([("SIMPLE", "T"), ("BITPIX", 16), ("NAXIS", 0), ("EXTEND", "T")],
         b""),
        ([("XTENSION", b"'IMAGE   '"), ("BITPIX", 8), ("NAXIS", 2),
          ("NAXIS1", 7), ("NAXIS2", 5), ("PCOUNT", 0), ("GCOUNT", 1)],
         body)])
    out["fits_short_data.fits"] = se.fits([(head(8, 4, 3), bytes(range(
        40, 52)))], pad=False)
    for bits, sample in ((8, img), (16, wide[:5, :7].astype(np.uint16)),
                         (32, deep[:, :5].astype(np.int32))):
        h, w = sample.shape
        heap = se.gzip_bytes(se.fits_gzip_words(sample, bits))
        table = struct.pack(">ii", len(heap), 0)
        out[f"fits_gzip_{bits}.fits"] = se.fits([
            ([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)], b""),
            ([("XTENSION", b"'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
              ("NAXIS1", 8), ("NAXIS2", 1), ("PCOUNT", len(heap)),
              ("GCOUNT", 1), ("TFIELDS", 1), ("ZIMAGE", "T"),
              ("ZBITPIX", bits), ("ZNAXIS", 2), ("ZNAXIS1", w),
              ("ZNAXIS2", h), ("ZCMPTYPE", b"'GZIP_1  '")], table + heap)])
    return out


def fli_files(rng) -> dict:
    out = {}
    w, h = 10, 6
    idx = texture(rng, h, w, 1)[..., 0] // 8
    pal = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    pal64 = rng.integers(0, 64, 768).astype(np.uint8).tobytes()
    colour256 = se.fli_chunk(4, se.fli_colour([(0, pal)]))
    colour64 = se.fli_chunk(11, se.fli_colour([(3, pal64[:30]),
                                                (10, pal64[:60])]))
    out["fli_brun.flc"] = se.fli(w, h, [se.fli_frame([
        colour256, se.fli_chunk(15, se.fli_brun(idx, rng))])])
    out["fli_copy.fli"] = se.fli(w, h, [se.fli_frame([
        colour64, se.fli_chunk(16, idx.tobytes())])], magic=0xAF11, flags=0)
    lc = se.fli_lc(1, [[(2, b"\x05\x06\x07"), (1, 3, 9)], [],
                       [(0, bytes(range(20, 30)))]])
    out["fli_lc.flc"] = se.fli(w, h, [se.fli_frame([colour256,
                                                    se.fli_chunk(12, lc)])])
    ss2 = se.fli_ss2([([0xFFFF], [(1, b"\x01\x02\x03\x04"),
                                  (0, 2, b"\x08\x09")]),
                      ([0x8000 | 77], [(4, b"\x0a\x0b")]),
                      ([], [(0, 5, b"\x10\x11")])])
    out["fli_ss2.flc"] = se.fli(w, h, [se.fli_frame([colour256,
                                                     se.fli_chunk(7, ss2)])])
    out["fli_black_pstamp.flc"] = se.fli(w, h, [se.fli_frame([
        se.fli_chunk(18, bytes(12)), se.fli_chunk(16, idx.tobytes()),
        se.fli_chunk(13, b""), se.fli_chunk(12, lc)])])
    out["fli_no_palette.flc"] = se.fli(w, h, [se.fli_frame([
        se.fli_chunk(15, se.fli_brun(idx * 9, rng))])])
    out["fli_two_frames.flc"] = se.fli(w, h, [
        se.fli_frame([colour256, se.fli_chunk(16, idx.tobytes())]),
        se.fli_frame([se.fli_chunk(13, b"")])])
    return out


def _pil_bytes(img, fmt, mode=None, **kw) -> bytes:
    from PIL import Image

    im = Image.fromarray(img)
    if mode is not None:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def iptc_files(rng) -> dict:
    out = {}
    grey = texture(rng, 5, 6, 1)[..., 0]
    out["iptc_raw_l.iim"] = se.iptc(6, 5, grey.tobytes())
    out["iptc_raw_rgb_band.iim"] = se.iptc(6, 5, grey.tobytes(), 3, 1,
                                           band=2)
    out["iptc_raw_cmyk_band.iim"] = se.iptc(6, 5, grey.tobytes(), 4, 1,
                                            band=4)
    jpeg_l = _pil_bytes(texture(rng, 9, 11, 1)[..., 0], "JPEG", quality=90)
    out["iptc_jpeg_l.iim"] = se.iptc(11, 9, jpeg_l, compression=5)
    out["iptc_jpeg_band.iim"] = se.iptc(11, 9, jpeg_l, 3, 1, 5, band=1,
                                        pieces=3)
    png_rgb = se.png_bytes(texture(rng, 4, 5, 3))
    out["iptc_png_rgb.iim"] = se.iptc(5, 4, png_rgb, compression=5)
    extra = (se.iptc_record(2, 5, b"a caption", extended=2)
             + se.iptc_record(2, 25, b"k1") + se.iptc_record(2, 25, b"k2"))
    out["iptc_extended.iim"] = se.iptc(6, 5, grey.tobytes(), extra=extra,
                                       pieces=4)
    return out


def jpeg_files(rng) -> dict:
    out = {}
    img = texture(rng, 13, 19, 4)
    out["cmyk_pil.jpg"] = _pil_bytes(img, "JPEG", "CMYK", quality=80)
    out["cmyk_pil_progressive.jpg"] = _pil_bytes(img, "JPEG", "CMYK",
                                                 quality=70,
                                                 progressive=True)
    q = [np.full(64, 3)] * 4
    sub = [(2, 2), (1, 1), (1, 1), (2, 2)]
    flat = [(1, 1)] * 4
    out["cmyk_no_adobe.jpg"] = je.encode_image(img, flat, q, jfif=False)
    out["cmyk_adobe0_subsampled.jpg"] = je.encode_image(
        img, [(1, 2), (1, 1), (2, 1), (1, 1)], q, jfif=False, adobe=0)
    out["ycck_adobe2.jpg"] = je.encode_image(img, flat, q, jfif=False,
                                             adobe=2)
    out["ycck_adobe1_subsampled.jpg"] = je.encode_image(img, sub, q,
                                                        jfif=False, adobe=1)
    out["ycck_restart.jpg"] = je.encode_image(img, [(2, 1), (1, 1), (1, 1),
                                                    (2, 1)], q, jfif=False,
                                              adobe=2, restart=2)
    small = _pil_bytes(img[:8, :9], "JPEG", "CMYK", quality=85)
    out["blp1_cmyk.blp"] = se.blp1_jpeg(small, 9, 8)
    out["blp1_ycck_alpha.blp"] = se.blp1_jpeg(je.encode_image(
        img[:8, :9], flat, q, jfif=False, adobe=2), 9, 8, alpha=8)
    return out


def albedo_blp1() -> bytes:
    """The textured scene's albedo as PIL's CMYK JPEG (quality 75) in a
    BLP1 of alpha depth 0, its channels in BLP's BGR order (PIL hands a
    BLP1 JPEG's RGB to the image as BGR), so that it reads as the
    albedo."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image

    bgr = np.ascontiguousarray(_to_uint8(albedo_image(1024))[..., ::-1])
    jpeg = _pil_bytes(bgr, "JPEG", "CMYK", quality=75)
    return se.blp1_jpeg(jpeg, 1024, 1024)


def generated_files(directory: str) -> dict:
    """name -> path of utils/demo_scene.write_small3_textures' files."""
    from tracerboy_tpu_torch.utils.demo_scene import write_small3_textures

    return write_small3_textures(directory)


def main(out_dir: str = FIXTURE_DIR) -> dict:
    import PIL

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20261027)
    files = {**fits_files(rng), **fli_files(rng), **iptc_files(rng),
             **jpeg_files(rng), "albedo_blp1_cmyk.blp": albedo_blp1()}
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
