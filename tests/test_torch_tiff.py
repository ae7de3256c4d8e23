"""The port's TIFF reader (core/tiff.py, csrc/lzw_codecs.cpp, through
core/image_io.read_ldr) against the JAX package's read_ldr, which reads
TIFF through PIL (its own raw decoder for uncompressed files, libtiff for
the rest): every case must be equal bit for bit (np.array_equal of
read_ldr's float32, with and without gamma_to_linear).

The committed fixtures (tests/data/tiff, written by
tests/make_tiff_fixtures.py) are held against PIL and their manifest.
Hypothesis sweeps every (byte order, photometric, sample format, fill
order, bits, extra samples) key of PIL's OPEN_INFO (YCbCr and CIELab
too: YCbCr without a YCbCrSubsampling tag is 2x2 in libtiff's RGBA
route), under every compression the port reads and tiff_encode writes
here, strips and tiles, planar 1 and 2, every predictor, classic and
BigTIFF headers, at 1x1 to 40x30 with random samples (floats with NaN,
infinities and negatives). Where PIL refuses a file the port raises:
ValueError where PIL raises OSError, ValueError, EOFError or KeyError,
NotImplementedError where PIL cannot identify it. The layouts that moved
out of ROADMAP item 22c (JPEG, CCITT, YCbCr, CIELab, no StripByteCounts)
read as the JAX read_ldr; those PIL reads and the port still leaves out
raise NotImplementedError naming item 22c. A PBRT scene whose image
textures and environment map are TIFFs compiles in both packages to the
same leaves, bit for bit. The codecs of item 22c have their own sweeps
in tests/test_torch_tiff_codecs.py.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st
from PIL import Image, UnidentifiedImageError

from make_dds_fixtures import array_digest, pil_pixels
from make_tiff_fixtures import ALBEDO, FIXTURE_DIR, LEAF
from tiff_encode import FLOAT, jpeg_stream, tiff_file
from tracerboy_tpu_torch.core import image_io, tiff

torch.set_num_threads(2)

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
TIFF_FIXTURES = sorted(n for n in MANIFEST["files"] if n.endswith(".tif"))
# PIL's mode keys, YCbCr (6) and CIELab (8) among them.
KEYS = sorted(tiff.OPEN_INFO, key=repr)
ITEM = "item 22c"


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("tiff")


def jax_read_ldr(path, **kw):
    from tracerboy_tpu.core.image_io import read_ldr

    return read_ldr(str(path), **kw)


def assert_as_jax(path, data: bytes):
    """Write `data` to `path` and read it with read_ldr in both packages:
    equal float32 images (returns the port's), or the matching refusal
    (returns None): NotImplementedError where PIL raises it or cannot
    identify the file, ValueError where it raises another OSError, a
    ValueError, an EOFError or a KeyError."""
    path.write_bytes(data)
    try:
        ref = jax_read_ldr(path)
    except (NotImplementedError, UnidentifiedImageError):
        with pytest.raises(NotImplementedError):
            image_io.read_ldr(str(path))
        return None
    except (OSError, ValueError, EOFError, KeyError):
        with pytest.raises(ValueError):
            image_io.read_ldr(str(path))
        return None
    got = image_io.read_ldr(str(path))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref), (
        np.abs(got - ref).max() * 255, (got != ref).mean())
    return got


def random_samples(rng, key, h, w):
    """Samples for a mode key: floats with NaN, infinities and negatives
    for sample format 3, else every value of the bit depth."""
    bits, spp = key[4][0], len(key[4])
    if key[2] == (3,):
        v = (rng.standard_normal((h, w, spp)) * 150 + 100).astype(np.float32)
        v.reshape(-1)[rng.integers(0, v.size, 3)] = [np.nan, np.inf, -np.inf]
        return v
    dtype = np.uint8 if bits <= 8 else np.uint16 if bits <= 16 else np.uint32
    return rng.integers(0, 1 << bits, (h, w, spp)).astype(dtype)


def layout_file(rng, key, h, w, **kw):
    order, photo, sf, fill, bps, extra = key
    cmap = (rng.integers(0, 65536, (3, 1 << bps[0])) if photo == 3
            else None)
    return tiff_file(random_samples(rng, key, h, w), bits=bps[0],
                     photometric=photo, order=order.decode(),
                     sample_format=sf[0], fill_order=fill, extra=extra,
                     colormap=cmap, **kw)


@pytest.mark.parametrize("name", TIFF_FIXTURES)
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    got = image_io.read_ldr(path)
    assert got.dtype == np.float32
    assert np.array_equal(got, jax_read_ldr(path))
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


def test_manifest_matches_the_files():
    """Every fixture (TIFF, GIF, ICO) is in the manifest, and PIL's decode
    of each has the recorded shape, dtype and sha256 (so the card's
    machine, which has no PIL, checks the port against PIL's arrays);
    the port's own decode too. The committed data stays under 1.5 MiB."""
    names = set(os.listdir(FIXTURE_DIR)) - {"manifest.json"}
    assert names == set(MANIFEST["files"])
    for name, entry in MANIFEST["files"].items():
        path = os.path.join(FIXTURE_DIR, name)
        assert array_digest(pil_pixels(path)) == entry, name
        assert array_digest(image_io.decode_ldr(path)) == entry, name
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, n))
                for n in os.listdir(FIXTURE_DIR))
    assert total < 1536 << 10


def test_open_info_is_pils():
    """The port's copy of PIL's (byte order, photometric, sample format,
    fill order, bits, extra samples) -> (mode, raw mode) table."""
    from PIL import TiffImagePlugin

    assert tiff.OPEN_INFO == TiffImagePlugin.OPEN_INFO


@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), key=st.sampled_from(KEYS),
       tiled=st.booleans(), planar=st.sampled_from([1, 1, 2]),
       predictor=st.sampled_from([1, 1, 2, 3]), bigtiff=st.booleans(),
       w=st.integers(1, 40), h=st.integers(1, 30),
       rows=st.integers(1, 12), tile=st.sampled_from([(16, 16), (16, 32),
                                                      (32, 16)]))
def test_random_layouts(scratch, compression, seed, key, tiled, planar,
                        predictor, bigtiff, w, h, rows, tile):
    """Any mode key under the compression, in strips of 1-12 rows or in
    tiles, planar or not, with a predictor (errors where libtiff has
    none for the samples, ignored where PIL's raw decoder or PackBits
    ignores it), classic or BigTIFF. Only big-endian BigTIFF is not
    drawn: PIL reads its header as a classic one (tested below)."""
    raw = tiff.OPEN_INFO[key][1]
    assume(not (bigtiff and key[0] == b"MM"))
    assume(not (raw == "PX" and planar == 2 and tiled))   # left out
    rng = np.random.default_rng(seed)
    data = layout_file(rng, key, h, w, compression=compression,
                       planar=planar, predictor=predictor, bigtiff=bigtiff,
                       **({"tile": tile} if tiled else
                          {"rows_per_strip": rows}))
    assert_as_jax(scratch / "r.tif", data)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), compression=st.sampled_from(
    [1, 5, 8, 32773]), cut=st.integers(1, 400), tiled=st.booleans())
def test_truncated_files(scratch, seed, compression, cut, tiled):
    """A file cut anywhere in its data (the IFD first, so it survives):
    PIL's raw decoder and libtiff refuse, or read what is there, alike."""
    rng = np.random.default_rng(seed)
    key = (b"II", 2, (1,), 1, (8, 8, 8), ())
    data = layout_file(rng, key, 19, 23, compression=compression,
                       ifd_first=True, **({"tile": (16, 16)} if tiled else
                                          {"rows_per_strip": 5}))
    assert_as_jax(scratch / "t.tif", data[:max(len(data) - cut, 40)])


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), compression=st.sampled_from(
    [5, 8, 32773]), flips=st.integers(1, 4))
def test_corrupt_streams(scratch, seed, compression, flips):
    """Random bytes of the compressed strips replaced: libtiff's errors
    (a bad LZW code, a broken Deflate stream, short PackBits data) are
    the port's, and a stream that still decodes decodes to PIL's
    pixels."""
    rng = np.random.default_rng(seed)
    key = (b"II", 2, (1,), 1, (8, 8, 8), ())
    data = bytearray(layout_file(rng, key, 17, 13, compression=compression,
                                 rows_per_strip=4, ifd_first=True))
    start = len(data) - 17 * 13 * 3 // 2
    for _ in range(flips):
        data[int(rng.integers(max(start, 200), len(data)))] = int(
            rng.integers(0, 256))
    assert_as_jax(scratch / "c.tif", bytes(data))


def test_16_bit_and_float_grey_convert_as_pil():
    """PIL's quirks kept: 16-bit grey clipped at 255 (not scaled), float
    grey with NaN as 0, clipped, then truncated; associated alpha opens
    as RGBA, unpremultiplied by PIL's unpacker (c * 255 // a)."""
    v16 = np.array([[0, 1, 254, 255, 256, 1000, 65535]], np.uint16)
    got = tiff.read_tiff(tiff_file(v16, bits=16, photometric=1))
    assert got[0, :, 0].tolist() == [0, 1, 254, 255, 255, 255, 255]
    f = np.array([[257.2, 10.07, 218.9, -3.7, np.nan, np.inf, 254.99]],
                 np.float32)
    got = tiff.read_tiff(tiff_file(f, bits=32, photometric=1,
                                   sample_format=3, compression=8))
    assert got[0, :, 0].tolist() == [255, 10, 218, 0, 0, 255, 254]
    rgba = np.array([[[100, 50, 255, 128], [10, 20, 30, 0],
                      [200, 201, 202, 255]]], np.uint8)
    got = tiff.read_tiff(tiff_file(rgba, bits=8, photometric=2, extra=(1,),
                                   compression=5))
    assert got.tolist() == [[[199, 99, 255, 128], [0, 0, 0, 0],
                             [200, 201, 202, 255]]]


def _pil_written(mode, **save):
    rng = np.random.default_rng(3)
    im = Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8))
    buf = io.BytesIO()
    im.convert(mode).save(buf, "TIFF", **save)
    return buf.getvalue()


def _former_left_out():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    return {
        "jpeg": _pil_written("RGB", compression="jpeg"),
        "group4": _pil_written("1", compression="group4"),
        "group3": _pil_written("1", compression="group3"),
        "ycbcr": tiff_file(rgb, bits=8, photometric=6, compression=5,
                           tags=[(530, 3, [1, 1])]),
        "cielab": _pil_written("LAB"),
        "no_bytecounts": tiff_file(rgb, bits=8, photometric=2,
                                   compression=5, drop=(279,)),
    }


@pytest.mark.parametrize("case", sorted(_former_left_out()))
def test_former_left_out_layouts_read_as_jax(tmp_path, case):
    """Layouts ROADMAP item 22c listed until the port read them: equal to
    the JAX read_ldr (CIELab as RGBA, as read_ldr converts PIL's LAB)."""
    got = assert_as_jax(tmp_path / "f.tif", _former_left_out()[case])
    assert got is not None and got.shape[-1] == (4 if case == "cielab"
                                                 else 3)


def _left_out():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    return {
        "planar_px_tiles": tiff_file(
            rng.integers(0, 256, (16, 24, 2), dtype=np.uint8), bits=8,
            photometric=3, extra=(0,), compression=5, planar=2,
            tile=(16, 16), colormap=rng.integers(0, 65536, (3, 256))),
        "old_style_jpeg": tiff_file(
            rgb, bits=8, photometric=6, compression=6,
            segments=[jpeg_stream(rgb, 90, 2)], tags=[(530, 3, [2, 2])]),
        "float_typed_tag": tiff_file(rgb, bits=8, photometric=2,
                                     tags=[(317, FLOAT, [1.0])]),
    }


@pytest.mark.parametrize("case", sorted(_left_out()))
def test_left_out_layouts_name_their_roadmap_item(tmp_path, case):
    """Layouts PIL reads that this port leaves out: NotImplementedError
    naming ROADMAP item 22c."""
    path = tmp_path / "l.tif"
    path.write_bytes(_left_out()[case])
    assert jax_read_ldr(path).ndim == 3
    with pytest.raises(NotImplementedError, match=ITEM):
        image_io.read_ldr(str(path))


def _lzw_bits(codes):
    """Codes of 9 bits, MSB first."""
    bits = "".join(f"{c:09b}" for c in codes)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _errors():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    grey4 = rng.integers(0, 16, (12, 10), dtype=np.uint8)
    good = tiff_file(rgb, bits=8, photometric=2, compression=5)
    bad_lzw = bytearray(tiff_file(rgb, bits=8, photometric=2, compression=5,
                                  ifd_first=True))
    stream = _lzw_bits([256, 7, 300, 257])       # 300: past the table
    bad_lzw[-len(stream):] = stream
    no_ifd = bytearray(good)
    no_ifd[4:8] = bytes(4)
    return {
        # PIL: OSError / ValueError / EOFError -> the port's ValueError
        "lzw_short": (tiff_file(rgb, bits=8, photometric=2, compression=5,
                                truncate=40), ValueError, "decoder error"),
        "lzw_bad_code": (bytes(bad_lzw), ValueError, "decoder error"),
        "deflate_short": (tiff_file(rgb, bits=8, photometric=2,
                                    compression=8, truncate=40),
                          ValueError, "decoder error"),
        "packbits_short": (tiff_file(rgb, bits=8, photometric=2,
                                     compression=32773, truncate=3),
                           ValueError, "decoder error"),
        "raw_past_the_end": (tiff_file(rgb, bits=8, photometric=2,
                                       ifd_first=True)[:-30],
                             ValueError, "truncated"),
        "predictor_4_bit": (tiff_file(grey4, bits=4, photometric=1,
                                      compression=5, predictor=2),
                            ValueError, "PredictorSetup"),
        "planar_rgbx_strips": (tiff_file(
            rng.integers(0, 256, (12, 10, 4), dtype=np.uint8), bits=8,
            photometric=2, extra=(0,), compression=8, planar=2),
            ValueError, "row byte size"),
        "planar_la_raw": (tiff_file(
            rng.integers(0, 256, (12, 10, 2), dtype=np.uint8), bits=8,
            photometric=1, extra=(2,), planar=2), ValueError,
            "unknown raw mode"),
        "palette_4_bit_fillorder_2_raw": (tiff_file(
            grey4, bits=4, photometric=3, fill_order=2,
            colormap=rng.integers(0, 65536, (3, 16))), ValueError,
            "unknown raw mode"),
        "ifd_offset_0": (bytes(no_ifd), ValueError, "no more images"),
        # PIL: cannot identify -> the port's NotImplementedError
        "mm_bigtiff": (tiff_file(rgb, bits=8, photometric=2, order="MM",
                                 bigtiff=True), NotImplementedError,
                       "cannot identify"),
        "unknown_compression": (tiff_file(rgb, bits=8, photometric=2,
                                          drop=(259,),
                                          tags=[(259, 3, 99)]),
                                NotImplementedError, "cannot identify"),
        "unknown_mode": (tiff_file(rgb[..., :2], bits=8, photometric=2),
                         NotImplementedError, "cannot identify"),
        "no_width": (tiff_file(rgb, bits=8, photometric=2, drop=(256,)),
                     NotImplementedError, "cannot identify"),
        "no_offsets": (tiff_file(rgb, bits=8, photometric=2, drop=(273,)),
                       NotImplementedError, "cannot identify"),
    }


@pytest.mark.parametrize("case", sorted(_errors()))
def test_bad_files_raise_as_pil_does(tmp_path, case):
    """The error PIL raises (OSError, ValueError, EOFError -> ValueError;
    cannot identify -> NotImplementedError), with a message naming the
    cause."""
    data, port_error, message = _errors()[case]
    path = tmp_path / "bad.tif"
    path.write_bytes(data)
    pil_error = (UnidentifiedImageError if port_error is NotImplementedError
                 else (OSError, ValueError, EOFError))
    with pytest.raises(pil_error):
        jax_read_ldr(path)
    with pytest.raises(port_error, match=message):
        image_io.read_ldr(str(path))


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_transposes_as_pil(scratch, order, orientation):
    """Orientation 2-8 applied as PIL's exif_transpose applies it, in both
    of PIL's decoders; a single uncompressed strip PIL maps from the
    file with its size swapped for 5-8, as PIL does."""
    rng = np.random.default_rng(orientation)
    for comp, spp in ((1, 1), (1, 3), (5, 3), (8, 4)):
        img = rng.integers(0, 256, (9, 14, spp), dtype=np.uint8)
        data = tiff_file(img, bits=8, photometric=2 if spp > 1 else 1,
                         extra=(2,) if spp == 4 else (), order=order,
                         compression=comp,
                         tags=[(274, 3, orientation)])
        assert_as_jax(scratch / "o.tif", data) is not None


def test_tiff_is_known_by_its_header(tmp_path):
    """A TIFF named .png reads as TIFF (PIL's _accept: the six prefixes,
    the two invalid-version ones too)."""
    data = open(os.path.join(FIXTURE_DIR, "tiles_rgb_lzw.tif"), "rb").read()
    (tmp_path / "t.png").write_bytes(data)
    assert np.array_equal(image_io.read_ldr(str(tmp_path / "t.png")),
                          jax_read_ldr(tmp_path / "t.png"))
    assert all(tiff.is_tiff(p + bytes(4)) for p in tiff.TIFF_PREFIXES)


def test_write_tiff_round_trips(tmp_path):
    """core/tiff.write_tiff (the demo scenes' writer): LZW and Deflate
    with Predictor 2, strips (several) and cropped tiles, grey, RGB and
    RGBA, read back by PIL and by the port as the pixels written."""
    rng = np.random.default_rng(6)
    for spp in (1, 3, 4):
        img = rng.integers(0, 256, (150, 45, spp), dtype=np.uint8)
        img[5:20] = img[5, 5]
        for comp in ("lzw", "deflate"):
            for tile in (None, (16, 32)):
                path = str(tmp_path / f"w{spp}{comp}{tile}.tif")
                tiff.write_tiff(path, img[..., 0] if spp == 1 else img, comp,
                                tile=tile)
                want = np.repeat(img, 3, 2) if spp == 1 else img
                assert np.array_equal(image_io.decode_ldr(path), want)
                assert np.array_equal(pil_pixels(path), want)


def test_tiff_textured_scene_compiles_as_jax(tmp_path):
    """utils/demo_scene's textured scene (small) with its albedo the tiled
    Deflate TIFF fixture, its leaf the RGBA LZW TIFF whose alpha makes the
    cutouts, and its environment map a 16-bit RGB LZW TIFF: the PBRT
    scene compiles in both packages to the same leaves, bit for bit (the
    textures' texels, the leaf's alpha companion and the environment
    map among them). No wave is compiled."""
    from test_torch_instanced import assert_same, jax_compile, jax_tree
    from tracerboy_tpu_torch.scene.compile import compile_scene
    from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex, lit = write_textured_scene(str(tmp_path), grid=8, sky=(16, 8),
                                    leaves=8, albedo=8, normal=8, leaf=8)
    rng = np.random.default_rng(7)
    (tmp_path / "env").mkdir()
    sky = tmp_path / "env" / "sky16.tif"
    sky.write_bytes(tiff_file(
        rng.integers(0, 65536, (8, 16, 3)).astype(np.uint16), bits=16,
        photometric=2, compression=5, predictor=2))
    retexture(tex, {"albedo.png": os.path.join(FIXTURE_DIR, ALBEDO),
                    "leaf.png": os.path.join(FIXTURE_DIR, LEAF),
                    "sky.hdr": str(sky)})
    got = compile_scene(parse_pbrt(lit))
    assert_same(jax_tree(jax_compile(lit)), got.as_numpy())
    leaf = pil_pixels(os.path.join(FIXTURE_DIR, LEAF))
    assert leaf.shape[-1] == 4
    assert 0.3 < (leaf[..., 3] == 0).mean() < 0.7     # the cutouts
