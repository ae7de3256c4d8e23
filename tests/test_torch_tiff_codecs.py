"""The TIFF layouts of ROADMAP item 22c in the port's reader (core/tiff.py,
csrc/tiff_codecs.cpp, csrc/lzw_codecs.cpp, core/jpeg.py) against the JAX
package's read_ldr, which reads them through PIL and libtiff: JPEG
(YCbCr, RGB and grey, strips and tiles, 4:4:4, 4:2:2 and 4:2:0, with and
without JPEGTables), YCbCr under the other compressions (libtiff's RGBA
route), CIELab, CCITT (modified Huffman, RLE-word, Group 3 1D and 2D,
Group 4), Zstandard, LZMA, ThunderScan, old-style LZW and files without
StripByteCounts. Every case must be equal bit for bit (np.array_equal of
read_ldr's float32, with and without gamma_to_linear), or refused as PIL
refuses it (ValueError where PIL raises OSError or ValueError,
NotImplementedError where it cannot identify the file).

Bounded hypothesis sweeps draw random images through PIL's writer and
through tests/tiff_encode.py, then cut and damage the compressed data.
Where libtiff's answer depends on memory it never wrote (a Group 3 or 4
strip that ends before its last row, whose remaining rows PIL takes from
an uninitialised buffer; a ThunderScan run that ends a row) the port
raises NotImplementedError naming item 22c; for a 2D Group 3 strip that ends early it does so whether libtiff
fails the strip or not (which it fails is not ported), and libjpeg's
recovery from damaged entropy-coded data is not ported either, so JPEG
streams are drawn whole.
"""

import io
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from make_dds_fixtures import pil_pixels
from make_tiff_fixtures import (
    ALBEDO_JPEG,
    ALBEDO_ZSTD,
    FIXTURE_DIR,
    LEAF_ZSTD,
)
from test_torch_tiff import ITEM, KEYS, MANIFEST, assert_as_jax, layout_file
from tiff_encode import (
    _REVERSE,
    LONG,
    RATIONAL,
    SHORT,
    compress,
    jpeg_tiff,
    lzw_compat,
    mh_rows,
    thunderscan,
    tiff_file,
    ycbcr_segment,
    zstd_frame,
)
from tracerboy_tpu_torch.core import image_io, tiff

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("tiff_codecs")


def _pil_tiff(im, **save) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **save)
    return buf.getvalue()


def _strip(data: bytes) -> bytes:
    with Image.open(io.BytesIO(data)) as im:
        off, cnt = im.tag_v2[273][0], im.tag_v2[279][0]
    return data[off:off + cnt]


def test_fixtures_cover_item_22c():
    """The committed fixtures hold every layout of item 22c (each is read
    against PIL by test_torch_tiff.py's fixture test and against its
    manifest hash on the card)."""
    names = set(MANIFEST["files"])
    for part in ("pil_rgb_jpeg", "pil_l_jpeg", "pil_ycbcr_jpeg",
                 "jpeg_ycbcr_444_tables_strips", "jpeg_ycbcr_422_full_tiles",
                 "jpeg_ycbcr_420_tables_tiles", "ycbcr_1x1_lzw",
                 "ycbcr_2x1_deflate", "ycbcr_2x2_lzw", "ycbcr_4x4_deflate",
                 "pil_lab", "pil_1_ccitt_mh", "pil_1_group3_t4_0",
                 "pil_1_group3_t4_1", "pil_1_group4", "pil_rgb_zstd_pred2",
                 "pil_rgb_zstd.tif", "pil_rgb_lzma_pred2", "pil_rgb_lzma.tif",
                 "thunderscan", "lzw_old_style", "no_bytecounts",
                 "ccitt_rlew", "group4_damaged", ALBEDO_JPEG, ALBEDO_ZSTD,
                 LEAF_ZSTD):
        assert any(part in n for n in names), part


@pytest.mark.parametrize("name", [ALBEDO_JPEG, ALBEDO_ZSTD, LEAF_ZSTD])
def test_gdal_textures(name):
    """The GDAL-style scene's textures: 1024x1024 JPEG YCbCr 4:2:0 in
    256x256 tiles with JPEGTables, and Zstandard with Predictor 2 (the
    leaf RGBA, its alpha the cutouts)."""
    path = os.path.join(FIXTURE_DIR, name)
    prefix, tags = tiff.read_ifd(open(path, "rb").read())
    want = {ALBEDO_JPEG: (7, 6), ALBEDO_ZSTD: (50000, 2),
            LEAF_ZSTD: (50000, 2)}[name]
    assert (tags[259][1][0], tags[262][1][0]) == want
    got = image_io.decode_ldr(path)
    assert np.array_equal(got, pil_pixels(path))
    if name == ALBEDO_JPEG:
        assert tags[322][1][0] == 256 and 347 in tags
        assert tags[530][1][:2] == (2, 2) and got.shape == (1024, 1024, 3)
    else:
        assert tags[317][1][0] == 2
    if name == LEAF_ZSTD:
        assert got.shape == (512, 512, 4)
        assert 0.3 < (got[..., 3] == 0).mean() < 0.7


@pytest.mark.parametrize("compression", [34925, 50000])
@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), key=st.sampled_from(KEYS),
       tiled=st.booleans(), planar=st.sampled_from([1, 1, 2]),
       predictor=st.sampled_from([1, 2, 3]), w=st.integers(1, 40),
       h=st.integers(1, 30), rows=st.integers(1, 12))
def test_zstd_lzma_random_layouts(scratch, compression, seed, key, tiled,
                                  planar, predictor, w, h, rows):
    """Any mode key under LZMA (the standard library's .xz) or Zstandard
    (libzstd), strips or tiles, planar or not, with a predictor."""
    rng = np.random.default_rng(seed)
    raw = tiff.OPEN_INFO[key][1]
    if raw == "PX" and planar == 2 and tiled:
        planar = 1                       # left out (item 22c)
    data = layout_file(rng, key, h, w, compression=compression,
                       planar=planar, predictor=predictor,
                       **({"tile": (16, 16)} if tiled else
                          {"rows_per_strip": rows}))
    assert_as_jax(scratch / "z.tif", data)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       mode=st.sampled_from(["RGB", "RGBA", "L", "1", "P", "CMYK", "LA",
                             "I;16", "F", "LAB"]),
       comp=st.sampled_from(["zstd", "lzma", "tiff_lzw"]),
       predictor=st.booleans(), w=st.integers(1, 70), h=st.integers(1, 50))
def test_pil_written_codecs(scratch, seed, mode, comp, predictor, w, h):
    """Random images of every mode PIL writes with Zstandard and LZMA
    (LZW for CIELab too), with and without Predictor 2 where PIL's
    libtiff takes it."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[h // 3:h // 2] = img[0, 0]
    if mode == "LAB":
        im = Image.frombytes("LAB", (w, h), img[..., :3].tobytes())
    else:
        im = Image.fromarray(img).convert(mode)
    info = ({"tiffinfo": {317: 2}} if predictor and mode not in ("1", "P")
            else {})
    got = assert_as_jax(scratch / "p.tif",
                        _pil_tiff(im, compression=comp, **info))
    assert got is not None


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       photometric=st.sampled_from([6, 6, 2, 1]),
       subsampling=st.sampled_from([0, 1, 2]), quality=st.integers(20, 98),
       tiled=st.booleans(), tables=st.booleans(), w=st.integers(1, 60),
       h=st.integers(1, 45), rows=st.sampled_from([8, 16, 24]),
       keep_rgb=st.booleans(), full_last=st.booleans())
def test_jpeg_in_tiff(scratch, seed, photometric, subsampling, quality,
                      tiled, tables, w, h, rows, keep_rgb, full_last):
    """JPEG-in-TIFF from PIL's encoder: YCbCr (libjpeg's YCbCr to RGB and
    fancy upsampling whatever the sampling), RGB and grey (no colour
    transform, whatever the stream's markers say; a subsampled stream is
    libtiff's error), strips (a last strip short or full height) and
    cropped tiles, with and without JPEGTables."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[h // 4:h // 2, w // 5:] = rng.integers(0, 256, 3)
    if photometric == 1:
        img = img[..., 0]
    data = jpeg_tiff(img, photometric=photometric, quality=quality,
                     subsampling=subsampling, tables=tables,
                     keep_rgb=keep_rgb and photometric == 2,
                     full_last_strip=full_last,
                     **({"tile": (16, 32) if w > 16 else (16, 16)} if tiled
                        else {"rows_per_strip": rows}))
    assert_as_jax(scratch / "j.tif", data)


def _fax_file(bits, scheme, t4, fill_order, photometric, rows, tile, **kw):
    """A CCITT TIFF of `bits` (1 = black) whose strips or tiles are PIL's
    encoder's (an image each, its strip taken out), or mh_rows' for
    RLE-word."""
    regions = ([(0, y, bits.shape[1], min(rows, len(bits) - y))
                for y in range(0, len(bits), rows)] if tile is None else
               [(x, y, tile[0], tile[1]) for y in range(0, len(bits), tile[1])
                for x in range(0, bits.shape[1], tile[0])])
    segs = []
    for x, y, rw, rh in regions:
        part = np.zeros((rh, rw), bool)
        src = bits[y:y + rh, x:x + rw]
        part[:src.shape[0], :src.shape[1]] = src
        if scheme == 32771:
            seg = mh_rows(part, True)
        else:
            comp = {2: "tiff_ccitt", 3: "group3", 4: "group4"}[scheme]
            info = {"tiffinfo": {292: t4}} if scheme == 3 else {}
            seg = _strip(_pil_tiff(Image.fromarray(~part), compression=comp,
                                   **info))
        if fill_order == 2:
            seg = _REVERSE[np.frombuffer(seg, np.uint8)].tobytes()
        segs.append(seg)
    tags = [(292, LONG, t4)] if scheme == 3 else []
    return tiff_file(bits.astype(np.uint8), bits=1, photometric=photometric,
                     compression=scheme, fill_order=fill_order, tags=tags,
                     segments=segs, **kw, **({"tile": tile} if tile else
                                             {"rows_per_strip": rows}))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       scheme=st.sampled_from([2, 3, 3, 4, 32771]),
       t4=st.sampled_from([0, 1, 4, 5]), fill_order=st.sampled_from([1, 2]),
       photometric=st.sampled_from([0, 1]), w=st.integers(1, 90),
       h=st.integers(1, 40), rows=st.integers(1, 16), tiled=st.booleans(),
       density=st.floats(0.05, 0.95))
def test_ccitt(scratch, seed, scheme, t4, fill_order, photometric, w, h,
               rows, tiled, density):
    """Modified Huffman, RLE-word, Group 3 (T4Options 0, 1, 4, 5) and
    Group 4 at any width, FillOrder 1 and 2, both photometrics, strips
    and tiles."""
    rng = np.random.default_rng(seed)
    bits = rng.random((h, w)) < density
    bits[h // 2:, : w // 3] = True
    tile = (32, 16) if tiled and scheme != 32771 else None
    data = _fax_file(bits, scheme, t4, fill_order, photometric, rows, tile)
    got = assert_as_jax(scratch / "f.tif", data)
    # libtiff reads RLE-word rows by a rule of its own (csrc/tiff_codecs.cpp
    # fax_rle): refusing some of mh_rows' files is PIL's answer too.
    assert got is not None or scheme == 32771


def _ycbcr_file(rng, h, w, hs, vs, comp, rbw, tile, rows, predictor=1,
                **kw):
    regions = ([(0, y, w, min(rows, h - y)) for y in range(0, h, rows)]
               if tile is None else
               [(x, y, tile[0], tile[1]) for y in range(0, h, tile[1])
                for x in range(0, w, tile[0])])
    segs = []
    for _, _, rw, rh in regions:
        y = rng.integers(0, 256, (rh, rw), dtype=np.uint8)
        chroma = rng.integers(0, 256, (2, -(-rh // vs), -(-rw // hs)))
        # Predictor 2's stored bytes are any bytes: libtiff's decoder
        # accumulates them over its rows whatever an encoder meant.
        segs.append(compress(ycbcr_segment(y, *chroma, hs, vs), comp))
    tags = [(530, SHORT, [hs, vs])]
    if predictor != 1:
        tags.append((317, SHORT, predictor))
    if rbw:
        ref = rng.integers(0, 256, 6)
        tags += [(532, RATIONAL, [int(v) for r in ref for v in (r, 1)]),
                 (529, RATIONAL, [299, 1000, 587, 1000, 114, 1000])]
    return tiff_file(np.zeros((h, w, 3), np.uint8), bits=8, photometric=6,
                     compression=comp, segments=segs, tags=tags, **kw,
                     **({"tile": tile} if tile else {"rows_per_strip": rows}))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), hs=st.sampled_from([1, 2, 4]),
       vs=st.sampled_from([1, 2, 4]),
       comp=st.sampled_from([5, 8, 32773, 34925, 50000]),
       rbw=st.booleans(), tiled=st.booleans(), w=st.integers(1, 45),
       h=st.integers(1, 35), rows=st.sampled_from([4, 8, 12]),
       predictor=st.sampled_from([1, 1, 2, 3]))
def test_ycbcr(scratch, seed, hs, vs, comp, rbw, tiled, w, h, rows,
               predictor):
    """Subsampled YCbCr through libtiff's RGBA route: every subsampling
    (those TIFFRGBAImage has no routine for are its error), any
    compression, ReferenceBlackWhite and YCbCrCoefficients or their
    defaults, strips and cropped tiles, Predictor 2 over libtiff's rows
    of the block layout (3 is its error)."""
    rng = np.random.default_rng(seed)
    data = _ycbcr_file(rng, h, w, hs, vs, comp, rbw,
                       (16, 16) if tiled else None, rows, predictor)
    assert_as_jax(scratch / "y.tif", data)


def _damageable(rng, kind):
    """A file of the kind with its data after the IFD, so that cutting the
    file damages the data."""
    h, w = 23, 29
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgb[5:15] = rgb[5, 5]
    if kind in ("zstd", "lzma"):
        return tiff_file(rgb, bits=8, photometric=2, rows_per_strip=8,
                         compression={"zstd": 50000, "lzma": 34925}[kind],
                         predictor=2, ifd_first=True)
    if kind == "zstd_frame":
        return tiff_file(rgb, bits=8, photometric=2, compression=50000,
                         segments=[zstd_frame(rgb.tobytes(), block=300)],
                         ifd_first=True)
    if kind == "zstd_pil":               # libzstd's compressed blocks
        strip = _strip(_pil_tiff(Image.fromarray(rgb), compression="zstd"))
        return tiff_file(rgb, bits=8, photometric=2, compression=50000,
                         segments=[strip], ifd_first=True)
    if kind == "old_lzw":
        return tiff_file(rgb, bits=8, photometric=2, rows_per_strip=8,
                         compression=5, ifd_first=True,
                         segments=[lzw_compat(rgb[y:y + 8].tobytes())
                                   for y in range(0, h, 8)])
    if kind == "thunderscan":
        g = rng.integers(0, 16, (h, w), dtype=np.uint8)
        g[4:9] = 3
        return tiff_file(g, bits=4, photometric=1, compression=32809,
                         rows_per_strip=8, ifd_first=True,
                         segments=[thunderscan(g[y:y + 8], y)
                                   for y in range(0, h, 8)])
    if kind.startswith("ycbcr"):
        comp = 5 if kind == "ycbcr_lzw" else 8
        return _ycbcr_file(rng, h, w, 2, 2, comp, False, None, 8,
                           ifd_first=True)
    bits = rng.random((h, 61)) < 0.3
    bits[10:, :20] = True
    scheme, t4 = {"mh": (2, 0), "g3_1d": (3, 4), "g3_2d": (3, 5),
                  "g4": (4, 0), "rlew": (32771, 0)}[kind]
    return _fax_file(bits, scheme, t4, 1, 0, 12, None, ifd_first=True)


def _assert_as_jax_damaged(path, data, kind):
    """assert_as_jax, but where PIL returns pixels that depend on memory
    libtiff never wrote, or libtiff's rule for a 2D Group 3 strip that
    ends early, the port's NotImplementedError naming item 22c."""
    try:
        assert_as_jax(path, data)
    except (AssertionError, pytest.fail.Exception):
        try:
            image_io.read_ldr(str(path))
        except NotImplementedError as e:
            assert ITEM in str(e) and kind in ("g3_1d", "g3_2d", "g4",
                                               "thunderscan"), e
            assert "ends" in str(e)
            return
        raise


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       kind=st.sampled_from(["zstd", "zstd_frame", "zstd_pil", "lzma",
                             "old_lzw", "thunderscan", "ycbcr_lzw",
                             "ycbcr_deflate", "mh", "g3_1d", "g3_2d", "g4",
                             "rlew"]),
       cut=st.integers(0, 300), flips=st.integers(0, 3))
def test_truncated_and_damaged(scratch, seed, kind, cut, flips):
    """Each codec's data cut short and/or with bytes replaced: libtiff's
    errors are the port's ValueError, its leniency the port's pixels (a
    bad fax code pads the row; TIFFRGBAImage keeps what a YCbCr strip
    decoded before its error, zeros after it), a damaged Zstandard or LZMA
    stream fails where libzstd and liblzma fail."""
    rng = np.random.default_rng(seed)
    data = bytearray(_damageable(rng, kind))
    _, tags = tiff.read_ifd(bytes(data))
    start = min(tags[273][1])
    for _ in range(flips):
        data[int(rng.integers(start, len(data)))] = int(rng.integers(0, 256))
    if cut:                              # within the data, not the IFD
        data = data[:max(len(data) - cut, start + 1)]
    _assert_as_jax_damaged(scratch / "d.tif", bytes(data), kind)


def test_lab_conversion_sample():
    """Pillow's LAB to RGBA (littleCMS's Lab to sRGB transform) on a
    seeded sample of 2^16 of the 2^24 inputs, with every L, a and b
    value among them: the port's csrc/tiff_codecs.cpp tb_lab_to_rgb equal
    to PIL. (All 2^24 were checked once: equal.)"""
    rng = np.random.default_rng(20261020)
    lab = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    lab[0, :, 0] = lab[1, :, 1] = lab[2, :, 2] = np.arange(256)
    want = np.asarray(Image.frombytes("LAB", (256, 256),
                                      lab.tobytes()).convert("RGBA"))
    # frombytes reads LAB through Pillow's unpacker, as a TIFF's samples.
    img = np.zeros((256, 256, 4), np.uint8)
    img[..., :3] = lab ^ np.array([0, 128, 128], np.uint8)
    got = tiff.to_read_ldr(img, "LAB", None)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _refused():
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)

    def coded(code, photometric=2, spp=3, **kw):
        return tiff_file(rgb[..., :spp], bits=8, photometric=photometric,
                         drop=(259,), tags=[(259, SHORT, code)], **kw)

    return {
        # PIL: OSError (libtiff's decoder fails) -> ValueError
        "webp": (coded(50001), ValueError, "WEBP"),
        "logluv_rgb": (coded(34676), ValueError, "LogLuv"),
        "zstd_dictionary_id": (tiff_file(
            rgb, bits=8, photometric=2, compression=50000,
            segments=[zstd_frame(rgb.tobytes(), dict_id=7)]), ValueError,
            "decoder error"),
        "ycbcr_1x4": (_ycbcr_file(rng, 12, 10, 1, 4, 5, False, None, 4),
                      ValueError, "subsampling"),
        "jpeg_grey_subsampled": (jpeg_tiff(rgb[..., 0], photometric=1,
                                           subsampling=2, rows_per_strip=8),
                                 ValueError, "sampling factors"),
        "jpeg_sampling_tag_disagrees": (jpeg_tiff(
            rgb, photometric=6, subsampling=2, rows_per_strip=8,
            sampling_tag=False, tags=[(530, SHORT, [1, 1])]), ValueError,
            "sampling factors"),
        "thunderscan_8_bit": (tiff_file(rgb[..., 0], bits=8, photometric=1,
                                        compression=32809,
                                        segments=[bytes(120)]),
                              ValueError, "Thunder"),
        "no_bytecounts_two_strips": (tiff_file(
            rgb, bits=8, photometric=2, compression=5, rows_per_strip=6,
            drop=(279,)), ValueError, "StripByteCounts"),
        # PIL cannot identify it -> NotImplementedError
        "logluv_photometric": (coded(34676, photometric=32844),
                               NotImplementedError, "cannot identify"),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_refused_as_pil_refuses(tmp_path, case):
    """The layouts PIL refuses (WebP-in-TIFF, which this libtiff is built
    without, SGI LogLuv, a Zstandard frame with a dictionary ID,
    subsamplings TIFFRGBAImage has no routine for, JPEG sampling factors
    libtiff rejects, ThunderScan at 8 bits, missing StripByteCounts of
    several strips) raise as PIL does."""
    data, port_error, message = _refused()[case]
    path = tmp_path / "r.tif"
    path.write_bytes(data)
    with pytest.raises(Exception) as pil_error:
        pil_pixels(str(path))
    if port_error is NotImplementedError:
        assert "cannot identify" in str(pil_error.value)
    with pytest.raises(port_error, match=message):
        image_io.read_ldr(str(path))


def test_gdal_tiff_scene_compiles_as_jax(tmp_path):
    """utils/demo_scene's textured scene (small) with its albedo the
    JPEG-YCbCr tiles of GDAL's COMPRESS=JPEG PHOTOMETRIC=YCBCR and its
    leaf the Zstandard RGBA TIFF whose alpha makes the cutouts: the PBRT
    scene compiles in both packages to the same leaves, bit for bit. No
    wave is compiled."""
    from test_torch_instanced import assert_same, jax_compile, jax_tree
    from tracerboy_tpu_torch.scene.compile import compile_scene
    from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex, lit = write_textured_scene(str(tmp_path), grid=8, sky=(16, 8),
                                    leaves=8, albedo=8, normal=8, leaf=8)
    retexture(tex, {"albedo.png": os.path.join(FIXTURE_DIR, ALBEDO_JPEG),
                    "leaf.png": os.path.join(FIXTURE_DIR, LEAF_ZSTD)})
    got = compile_scene(parse_pbrt(lit))
    assert_same(jax_tree(jax_compile(lit)), got.as_numpy())
