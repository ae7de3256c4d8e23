"""The port's WebP reader (core/webp.py, csrc/webp_decode.cpp, through
core/image_io.read_ldr) against the JAX package's read_ldr, which reads
WebP through PIL and so through libwebp's WebPAnimDecoder: every case
must be equal bit for bit (np.array_equal of read_ldr's float32, with
and without gamma_to_linear).

The committed fixtures (tests/data/webp, written by
tests/make_webp_fixtures.py) are held against PIL and their manifest.
Hypothesis sweeps random images through PIL's WebP encoder (size,
quality, method, lossless, exact, alpha, alpha quality), VP8 key frames
of random syntax and VP8L streams of random transforms from
tests/webp_encode.py (which PIL's encoder never writes: the simple loop
filter, several token partitions, huge coefficients, predictor modes 14
and 15), ALPH chunks of both methods under every filter, animations
whose first frame lies inside a larger canvas, truncated files and
corrupted bitstreams. Where PIL refuses a file the port raises:
ValueError where PIL raises OSError, ValueError, EOFError, KeyError or
IndexError, NotImplementedError where PIL cannot identify it. FITS files
(PIL's small formats part 3), AVIF files as Pillow saves them by default
(the in-loop filters on), with the filters off, with film grain and with
the matrix coefficients libavif converts in its own float path
(core/avif.py, tests/test_torch_avif.py) and JPEG 2000 files read as the
JAX read_ldr reads them (core/jpeg2000.py, tests/test_torch_jpeg2000.py).
A PBRT scene whose albedo and leaf are
WebPs and whose environment map is a QOI compiles in both packages to the
same leaves, bit for bit.
"""

import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, UnidentifiedImageError

import avif_encode as ae
import webp_encode as we
from make_dds_fixtures import array_digest, pil_pixels
from make_webp_fixtures import ALBEDO, ALBEDO_LOSSLESS, FIXTURE_DIR, LEAF
from tracerboy_tpu_torch.core import image_io, webp

torch.set_num_threads(2)

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
WEBP_FIXTURES = sorted(n for n in MANIFEST["files"] if n.endswith(".webp"))


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("webp")


def jax_read_ldr(path, **kw):
    from tracerboy_tpu.core.image_io import read_ldr

    return read_ldr(str(path), **kw)


def assert_as_jax(path, data: bytes):
    """Write `data` to `path` and read it with read_ldr in both packages:
    equal float32 images (returns the port's), or the matching refusal
    (returns None)."""
    path.write_bytes(data)
    try:
        ref = jax_read_ldr(path)
    except (NotImplementedError, UnidentifiedImageError):
        with pytest.raises(NotImplementedError):
            image_io.read_ldr(str(path))
        return None
    except (OSError, ValueError, EOFError, KeyError, IndexError):
        with pytest.raises(ValueError):
            image_io.read_ldr(str(path))
        return None
    got = image_io.read_ldr(str(path))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref), (
        np.abs(got - ref).max() * 255, (got != ref).mean())
    return got


def pil_webp(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def sample_image(rng, h, w):
    """Noise, a flat patch, a gradient and alpha of a few levels."""
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[h // 2:, :, 0] = ((xx * 5 + yy * 2) % 256)[h // 2:]
    img[:h // 3, :w // 2] = img[0, 0]
    img[..., 3] = rng.choice([0, 60, 255, 255], (h, w))
    return img


@pytest.mark.parametrize("name", WEBP_FIXTURES)
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    got = image_io.read_ldr(path)
    assert got.dtype == np.float32
    assert np.array_equal(got, jax_read_ldr(path))
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


def test_manifest_matches_the_files():
    """Every fixture (WebP, QOI, PNM, PSD) is in the manifest, and PIL's
    decode of each has the recorded shape, dtype and sha256 (so the
    card's machine, which has no PIL, checks the port against PIL's
    arrays); the port's own decode too. The manifest names the PIL and
    libwebp that wrote it; the directory stays under 1 MiB."""
    from PIL import features

    names = set(os.listdir(FIXTURE_DIR)) - {"manifest.json"}
    assert names == set(MANIFEST["files"])
    assert MANIFEST["libwebp"] == features.version("webp")
    for name, entry in MANIFEST["files"].items():
        path = os.path.join(FIXTURE_DIR, name)
        assert array_digest(pil_pixels(path)) == entry, name
        assert array_digest(image_io.decode_ldr(path)) == entry, name
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, n))
                for n in os.listdir(FIXTURE_DIR))
    assert total < 1 << 20


def test_scene_textures_are_what_the_scene_needs():
    """The 1024x1024 albedo (lossy VP8, and VP8L) and the 512x512 leaf: a
    VP8X file with an ALPH chunk of method 1 under the gradient filter
    before its VP8 chunk, whose alpha cuts about half the texels."""
    for name, size, fourcc in ((ALBEDO, 1024, b"VP8 "),
                               (ALBEDO_LOSSLESS, 1024, b"VP8L")):
        data = open(os.path.join(FIXTURE_DIR, name), "rb").read()
        assert data[12:16] == fourcc
        assert image_io.decode_ldr(os.path.join(FIXTURE_DIR, name)).shape \
            == (size, size, 3)
    data = open(os.path.join(FIXTURE_DIR, LEAF), "rb").read()
    assert data[12:16] == b"VP8X" and data[30:34] == b"ALPH"
    assert data[38] == 1 | 3 << 2
    leaf = image_io.decode_ldr(os.path.join(FIXTURE_DIR, LEAF))
    assert leaf.shape == (512, 512, 4)
    assert 0.3 < (leaf[..., 3] == 0).mean() < 0.7


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 48),
       h=st.integers(1, 40), lossless=st.booleans(),
       quality=st.integers(0, 100), method=st.integers(0, 6),
       exact=st.booleans(), alpha=st.booleans(),
       alpha_quality=st.integers(0, 100))
def test_pil_encoder_sweep(scratch, seed, w, h, lossless, quality, method,
                           exact, alpha, alpha_quality):
    """Random images through PIL's encoder at any setting decode to PIL's
    pixels."""
    img = sample_image(np.random.default_rng(seed), h, w)
    data = pil_webp(img if alpha else img[..., :3], lossless=lossless,
                    quality=quality, method=method, exact=exact,
                    alpha_quality=alpha_quality)
    assert assert_as_jax(scratch / "e.webp", data) is not None


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 70),
       h=st.integers(1, 50), simple=st.booleans(),
       parts=st.integers(0, 3), scale=st.sampled_from([1, 1, 4]),
       alpha=st.sampled_from([None, 0, 1]), filt=st.integers(0, 3))
def test_random_vp8_syntax(scratch, seed, w, h, simple, parts, scale, alpha,
                           filt):
    """VP8 key frames of random syntax (any header, modes, tokens, the
    simple or normal filter, 1-8 partitions, coefficients that overflow
    int16) as simple files or with an ALPH chunk of method 0 or 1."""
    rng = np.random.default_rng(seed)
    frame = we.chunk(b"VP8 ", we.vp8_frame(rng, w, h, simple=simple,
                                           partitions_log2=parts,
                                           coeff_scale=scale))
    if alpha is None:
        data = we.riff(frame)
    else:
        plane = rng.integers(0, 256, (h, w), dtype=np.uint8)
        alph = (we.alph_chunk(plane, 0, filt) if alpha == 0 else
                we.alph_chunk(we.green_stream(plane), 1, filt))
        data = we.riff(we.vp8x_chunk(w, h, alpha=True), alph, frame)
    assert assert_as_jax(scratch / "v.webp", data) is not None


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 40),
       h=st.integers(1, 30),
       order=st.permutations(["predictor", "cross", "green"]),
       n=st.integers(0, 3), palette=st.sampled_from([None, 2, 3, 5, 17,
                                                     256]),
       alpha=st.booleans())
def test_random_vp8l_transforms(scratch, seed, w, h, order, n, palette,
                                alpha):
    """VP8L streams of random transforms: every predictor mode (14 and 15
    too), random cross-colour multipliers, subtract green, colour
    indexing with bundled pixels and indices past the palette."""
    data = we.riff(we.chunk(b"VP8L", we.vp8l_transforms(
        np.random.default_rng(seed), w, h, tuple(order[:n]), palette,
        alpha)))
    assert assert_as_jax(scratch / "l.webp", data) is not None


@pytest.mark.parametrize("kind", ["lossy", "lossy_alpha", "lossless"])
@pytest.mark.parametrize("canvas,offset", [
    ((37, 21), (0, 0)), ((51, 30), (14, 8)), ((40, 24), (2, 2)),
    ((38, 22), (0, 0))])
@pytest.mark.parametrize("alpha_flag", [True, False])
def test_animation_first_frame(scratch, kind, canvas, offset, alpha_flag):
    """An animation's first frame on the decoder's canvas: transparent
    black around the frame, the frame at its (even) offset, never
    blended; RGBA or RGB as the VP8X alpha flag says."""
    img = sample_image(np.random.default_rng(11), 21, 37)
    chunks = we.image_chunks(pil_webp(
        img if kind != "lossy" else img[..., :3],
        **({"lossless": True} if kind == "lossless" else {"quality": 60})))
    data = we.anim_file(canvas, [(chunks, 37, 21, *offset),
                                 (chunks, 37, 21, 0, 0)], alpha=alpha_flag)
    got = assert_as_jax(scratch / "a.webp", data)
    assert got is not None and got.shape[:2] == (canvas[1], canvas[0])


def _containers():
    img = sample_image(np.random.default_rng(12), 21, 37)
    lossy_a = we.image_chunks(pil_webp(img, quality=70))
    alph = lossy_a[:lossy_a.index(b"VP8 ")]
    vp8 = lossy_a[lossy_a.index(b"VP8 "):]
    vp8l = we.image_chunks(pil_webp(img, lossless=True))
    vp8l_opaque = we.image_chunks(pil_webp(img[..., :3], lossless=True))
    simple = we.riff(vp8)
    vx = we.vp8x_chunk(37, 21, alpha=True)
    vx_plain = we.vp8x_chunk(37, 21)
    return {
        "simple_lossy": simple,
        "simple_lossless": we.riff(vp8l),
        "vp8x_alpha": we.riff(vx, alph, vp8),
        "vp8x_no_alpha_flag_with_alph": we.riff(vx_plain, alph, vp8),
        "vp8x_alpha_flag_without_alph": we.riff(vx, vp8),
        "vp8x_alpha_flag_opaque_vp8l": we.riff(vx, vp8l_opaque),
        "vp8x_no_alpha_flag_vp8l_alpha": we.riff(vx_plain, vp8l),
        "reserved_flag_bit0": we.riff(we.vp8x_chunk(37, 21, alpha=True,
                                                    extra=1), alph, vp8),
        "reserved_flag_bit6": we.riff(we.vp8x_chunk(37, 21, alpha=True,
                                                    extra=0x40), alph, vp8),
        "canvas_mismatch": we.riff(we.vp8x_chunk(38, 21, alpha=True), alph,
                                   vp8),
        "chunk_between_alph_and_vp8": we.riff(vx, alph, we.chunk(b"ABCD",
                                                                 b"12"), vp8),
        "alph_after_vp8": we.riff(vx, vp8, alph),
        "two_alph": we.riff(vx, alph, alph, vp8),
        "alph_before_vp8l": we.riff(vx, alph, vp8l),
        "trailing_short_bytes": we.riff(vp8, b"\0\0\0"),
        "trailing_chunk": we.riff(vp8, we.chunk(b"ABCD", b"")),
        "two_images": we.riff(vp8, vp8),
        "data_after_riff": simple + b"junk data",
        "riff_size_4": simple[:4] + struct.pack("<I", 4) + simple[8:],
        "riff_size_too_big": simple[:4] + struct.pack("<I", len(simple))
        + simple[8:],
        "vp8x_only": we.riff(vx),
        "anim_without_anim_chunk": we.riff(
            we.vp8x_chunk(37, 21, alpha=True, animation=True),
            we.anmf_chunk(lossy_a, 37, 21)),
        "anim_frame_past_canvas": we.anim_file((40, 24), [(lossy_a, 37, 21,
                                                           4, 4)]),
        "anim_no_frames": we.anim_file((40, 24), []),
        "anim_flag_with_still_image": we.riff(
            we.vp8x_chunk(37, 21, alpha=True, animation=True), alph, vp8),
        "short_header": simple[:18],
        "not_a_key_frame": we.riff(we.chunk(b"VP8 ", b"\x01" + vp8[9:])),
    }


@pytest.mark.parametrize("case", sorted(_containers()))
def test_containers_as_libwebp_parses_them(scratch, case):
    """libwebp's demuxer rules (chunk order and sizes, flags, the canvas,
    ALPH kept only under the alpha flag, frames inside the canvas) and
    Pillow's mode (RGBA unless WebPGetFeatures finds no alpha)."""
    assert_as_jax(scratch / "c.webp", _containers()[case])


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), source=st.integers(0, 3),
       cut=st.integers(1, 2000))
def test_truncated_files(scratch, seed, source, cut):
    """A file cut anywhere: libwebp's demuxer refuses a RIFF shorter than
    its size, and Pillow's _accept what lacks its first 16 bytes."""
    img = sample_image(np.random.default_rng(seed), 23, 31)
    data = [pil_webp(img, quality=60), pil_webp(img, lossless=True),
            pil_webp(img[..., :3], quality=90),
            we.anim_file((31, 23), [(we.image_chunks(pil_webp(
                img, quality=50)), 31, 23, 0, 0)])][source]
    assert_as_jax(scratch / "t.webp", data[:max(len(data) - cut, 1)])


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), source=st.integers(0, 3),
       flips=st.integers(1, 4))
def test_corrupt_streams(scratch, seed, source, flips):
    """Random bytes of the bitstreams replaced: what libwebp refuses
    (bad prefix codes, a copy before the start, a stream read past its
    end) the port refuses, and what it decodes the port decodes alike."""
    rng = np.random.default_rng(seed)
    img = sample_image(rng, 19, 27)
    data = bytearray([pil_webp(img, quality=60), pil_webp(img,
                                                          lossless=True),
                      pil_webp(img, quality=40, alpha_quality=30),
                      we.riff(we.chunk(b"VP8 ", we.vp8_frame(
                          rng, 27, 19, partitions_log2=1)))][source])
    for _ in range(flips):
        data[int(rng.integers(30, len(data)))] = int(rng.integers(0, 256))
    assert_as_jax(scratch / "x.webp", bytes(data))


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), quality=st.integers(0, 100),
       alpha_quality=st.integers(0, 100), cut=st.integers(1, 12))
def test_alpha_stream_cut_short(scratch, seed, quality, alpha_quality,
                                cut):
    """An ALPH chunk shortened inside a consistent container: libwebp's
    8-bit alpha decoder (colour indexing alone) reads past the data
    without error while its last pixels decode, from its bit window's
    wrapped bytes; its other decoders refuse."""
    rng = np.random.default_rng(seed)
    img = sample_image(rng, int(rng.integers(3, 30)), int(rng.integers(3,
                                                                        30)))
    chunks = we.image_chunks(pil_webp(img, quality=quality,
                                      alpha_quality=alpha_quality))
    size = struct.unpack_from("<I", chunks, 4)[0]
    alpha, rest = chunks[8:8 + size], chunks[8 + size + (size & 1):]
    data = we.riff(we.vp8x_chunk(img.shape[1], img.shape[0], alpha=True),
                   we.chunk(b"ALPH", alpha[:max(size - cut, 2)]), rest)
    assert_as_jax(scratch / "k.webp", data)


def test_unported_formats_name_item_22b(tmp_path):
    """A FITS image (PIL's small formats part 3) and an IM image read as
    the JAX read_ldr reads them. AVIF whose
    colr box names matrix coefficients 4 (FCC), which libavif converts
    in its own float path, AVIF as Pillow saves it by default (the
    in-loop filters on), with film grain (aom's film-grain-test) and
    with the filters off, and JPEG 2000, which PIL reads too, read as
    the JAX read_ldr reads them."""
    img = Image.fromarray(sample_image(np.random.default_rng(13), 16, 16)[
        ..., :3])
    path = tmp_path / "x.im"
    img.save(path, "IM")
    assert jax_read_ldr(path).shape == (16, 16, 3)
    assert np.array_equal(image_io.read_ldr(str(path)), jax_read_ldr(path))
    cards = [b"SIMPLE  = T", b"BITPIX  = 8", b"NAXIS   = 2",
             b"NAXIS1  = 4", b"NAXIS2  = 4", b"END"]
    fits = b"".join(c.replace(b"= ", b"=" + b" " * 20).ljust(80)
                    for c in cards).ljust(2880) + bytes(2880)
    path = tmp_path / "x.fits"
    path.write_bytes(fits)
    assert jax_read_ldr(path).shape == (4, 4, 3)
    assert np.array_equal(image_io.read_ldr(str(path)), jax_read_ldr(path))
    path = tmp_path / "x.avif"
    path.write_bytes(ae.set_nclx(ae.pil_default(img), mc=4))
    assert np.array_equal(image_io.read_ldr(str(path)), jax_read_ldr(path))
    img.save(path, "AVIF")
    assert np.array_equal(image_io.read_ldr(str(path)), jax_read_ldr(path))
    img.save(path, "AVIF", advanced={"film-grain-test": "1"})
    assert np.array_equal(image_io.read_ldr(str(path)), jax_read_ldr(path))
    img.save(path, "AVIF", advanced={"enable-cdef": "0",
                                     "enable-restoration": "0",
                                     "loopfilter-control": "0"})
    assert np.array_equal(image_io.read_ldr(str(path)), jax_read_ldr(path))
    path = tmp_path / "x.jp2"
    img.save(path, "JPEG2000")
    assert jax_read_ldr(path).shape == (16, 16, 3)
    assert np.array_equal(image_io.read_ldr(str(path)), jax_read_ldr(path))


def test_webp_is_known_by_its_header(tmp_path):
    """A WebP named .png reads as WebP (PIL's _accept: RIFF, WEBP, then a
    VP8, VP8L or VP8X chunk); another RIFF file is not one."""
    data = open(os.path.join(FIXTURE_DIR, LEAF), "rb").read()
    (tmp_path / "w.png").write_bytes(data)
    assert np.array_equal(image_io.read_ldr(str(tmp_path / "w.png")),
                          jax_read_ldr(tmp_path / "w.png"))
    assert webp.is_webp(data)
    assert not webp.is_webp(b"RIFF" + data[4:12] + b"WAVE")
    assert not webp.is_webp(data[:12] + b"VP8Y" + data[16:])


def test_webp_textured_scene_compiles_as_jax(tmp_path):
    """utils/demo_scene's textured scene (small) with its albedo the lossy
    WebP fixture, its leaf the VP8X + ALPH WebP whose alpha makes the
    cutouts, and its environment map a QOI written by core/qoi.write_qoi:
    the PBRT scene compiles in both packages to the same leaves, bit for
    bit (the textures' texels, the leaf's alpha companion and the
    environment map among them). No wave is compiled."""
    from test_torch_instanced import assert_same, jax_compile, jax_tree
    from tracerboy_tpu_torch.core.qoi import write_qoi
    from tracerboy_tpu_torch.scene.compile import compile_scene
    from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex, lit = write_textured_scene(str(tmp_path), grid=8, sky=(16, 8),
                                    leaves=8, albedo=8, normal=8, leaf=8)
    rng = np.random.default_rng(14)
    (tmp_path / "env").mkdir()
    sky = tmp_path / "env" / "sky.qoi"
    write_qoi(str(sky), rng.integers(0, 256, (8, 16, 3), dtype=np.uint8))
    retexture(tex, {"albedo.png": os.path.join(FIXTURE_DIR, ALBEDO),
                    "leaf.png": os.path.join(FIXTURE_DIR, LEAF),
                    "sky.hdr": str(sky)})
    got = compile_scene(parse_pbrt(lit))
    assert_same(jax_tree(jax_compile(lit)), got.as_numpy())
