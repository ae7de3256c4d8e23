"""The port's JPEG 2000 reader (core/jpeg2000.py, csrc/j2k_decode.cpp,
through core/image_io.read_ldr) against the JAX package's read_ldr, which
reads JPEG 2000 through PIL and so through OpenJPEG: every case must be
equal bit for bit (np.array_equal of read_ldr's float32, with and
without gamma_to_linear).

The committed fixtures (tests/data/j2k, written by
tests/make_j2k_fixtures.py) are held against PIL and their manifest.
Hypothesis sweeps random images through every save option of PIL's
encoder (mode, wavelet, MCT, sign, resolutions, layers, progression,
code-blocks, precincts, tiles, offsets, PLT, JP2 or raw), random packet
rewrites (SOP, EPH, PPT, PPM) and code-block styles, truncated files and
corrupted streams. Where PIL refuses a file the port raises: ValueError
where PIL raises OSError, ValueError, SyntaxError or AssertionError,
NotImplementedError where PIL cannot identify it. HTJ2K code-blocks and
Part 2 codestreams, which PIL reads, raise NotImplementedError naming
ROADMAP item 22d. A PBRT scene whose albedo is a 9/7 JP2 and whose leaf
is an RGBA raw codestream compiles in both packages to the same leaves,
bit for bit.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st
from PIL import Image, UnidentifiedImageError

import j2k_encode as je
from make_dds_fixtures import array_digest, pil_pixels
from make_j2k_fixtures import (
    ALBEDO,
    ALBEDO_LOSSLESS,
    FIXTURE_DIR,
    LEAF,
    PROGRESSIONS,
    sample,
)
from tracerboy_tpu_torch.core import image_io, jpeg2000

torch.set_num_threads(2)

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
FIXTURES = sorted(MANIFEST["files"])
ITEM = "item 22d"


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("j2k")


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
    except (OSError, ValueError, SyntaxError, AssertionError):
        with pytest.raises(ValueError):
            image_io.read_ldr(str(path))
        return None
    got = image_io.read_ldr(str(path))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref), (
        np.abs(got - ref).max() * 255, (got != ref).mean())
    return got


def pil_save(img, mode, **kw):
    """PIL's codestream, or None where PIL's encoder refuses the options."""
    try:
        return je.pil_codestream(img, mode, **kw)
    except OSError:
        return None


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    got = image_io.read_ldr(path)
    assert got.dtype == np.float32
    assert np.array_equal(got, jax_read_ldr(path))
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


def test_manifest_matches_the_files():
    """Every fixture is in the manifest, and PIL's decode of each has the
    recorded shape, dtype and sha256 (so the card's machine, which has no
    PIL, checks the port against PIL's arrays); the port's own decode
    too. The manifest names the PIL and OpenJPEG that wrote it; the
    directory stays under 1.5 MB."""
    from PIL import features

    names = set(os.listdir(FIXTURE_DIR)) - {"manifest.json"}
    assert names == set(MANIFEST["files"])
    assert MANIFEST["openjpeg"] == features.version("jpg_2000")
    for name, entry in MANIFEST["files"].items():
        path = os.path.join(FIXTURE_DIR, name)
        assert array_digest(pil_pixels(path)) == entry, name
        assert array_digest(image_io.decode_ldr(path)) == entry, name
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, n))
                for n in os.listdir(FIXTURE_DIR))
    assert total < 1_500_000


def test_scene_textures_are_what_the_scene_needs():
    """The 1024x1024 albedo as a lossless 5/3 JP2 (the pixels written) and
    as a 9/7 JP2; the 512x512 leaf an RGBA raw codestream, lossless, whose
    alpha cuts about half the texels."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image, leaf_image

    lossless = image_io.decode_ldr(os.path.join(FIXTURE_DIR, ALBEDO_LOSSLESS))
    assert np.array_equal(lossless, _to_uint8(albedo_image(1024)))
    data = open(os.path.join(FIXTURE_DIR, ALBEDO), "rb").read()
    assert data.startswith(je.SIGNATURE_BOX)
    cod = je.Codestream(data[data.index(b"\xff\x4f\xff\x51"):]).segment(
        0xFF52)
    assert cod[9] == 0                                  # the 9/7 wavelet
    data = open(os.path.join(FIXTURE_DIR, LEAF), "rb").read()
    assert data.startswith(jpeg2000.SOC_SIZ)
    leaf = image_io.decode_ldr(os.path.join(FIXTURE_DIR, LEAF))
    assert np.array_equal(leaf, _to_uint8(leaf_image(512)))
    assert 0.3 < (leaf[..., 3] == 0).mean() < 0.7


MODES = ("L", "LA", "RGB", "RGBA", "I;16")


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 70),
       h=st.integers(1, 50), mode=st.sampled_from(MODES),
       irreversible=st.booleans(), mct=st.booleans(), signed=st.booleans(),
       resolutions=st.integers(0, 6),
       layers=st.sampled_from([None, ("rates", [20, 5]),
                               ("rates", [40, 10, 1]), ("dB", [30, 45]),
                               ("dB", [38])]),
       progression=st.sampled_from(PROGRESSIONS),
       cblk=st.sampled_from([None, (4, 4), (8, 32), (64, 64), (16, 8)]),
       precinct=st.sampled_from([None, (16, 16), (32, 64), (128, 128)]),
       tiles=st.sampled_from([None, (16, 16), (24, 40)]),
       offsets=st.booleans(), plt=st.booleans(), jp2=st.booleans())
def test_pil_encoder_sweep(scratch, seed, w, h, mode, irreversible, mct,
                           signed, resolutions, layers, progression, cblk,
                           precinct, tiles, offsets, plt, jp2):
    """Random images through PIL's encoder at any setting (those its
    encoder accepts) decode to PIL's pixels, or are refused where PIL
    refuses them."""
    kw = dict(irreversible=irreversible, mct=int(mct), signed=signed,
              num_resolutions=resolutions, progression=progression,
              plt=plt)
    if layers:
        kw.update(quality_mode=layers[0], quality_layers=layers[1])
    if cblk:
        kw["codeblock_size"] = cblk
    if precinct:
        kw["precinct_size"] = precinct
    if tiles:
        kw["tile_size"] = tiles
    if offsets and min(w, h) >= 8:   # PIL's encoder crashes on tiny ones
        kw.update(offset=(3, 5), tile_offset=(1, 2),
                  tile_size=tiles or (w + 3, h + 5))
    data = pil_save(sample(np.random.default_rng(seed), mode, h, w), mode,
                    **kw)
    assume(data is not None)
    if jp2:
        data = je.jp2_file(data, bpc=15 if mode == "I;16" else 7)
    assert_as_jax(scratch / "e.jp2", data)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 60),
       h=st.integers(1, 40), irreversible=st.booleans(),
       style=st.integers(0, 0x3F), layers=st.integers(1, 3),
       rewrite=st.sampled_from(["", "sop", "eph", "sop_eph", "ppt", "ppm",
                                "ppt_eph", "ppm_sop"]),
       tiles=st.booleans())
def test_packets_and_code_block_styles(scratch, seed, w, h, irreversible,
                                       style, layers, rewrite, tiles):
    """PIL's codestreams with SOP and EPH markers inserted, the packet
    headers moved into PPT or PPM segments, and a code-block style byte
    set (every style but HT: PIL decodes the data under it as OpenJPEG
    would, deterministically)."""
    img = sample(np.random.default_rng(seed), "RGB", h, w)
    data = pil_save(img, "RGB", irreversible=irreversible,
                    quality_layers=[40, 10, 1][:layers],
                    tile_size=(16, 16) if tiles else None)
    assume(data is not None)
    if rewrite:
        data = je.rewrite_packets(data, **{k: True
                                           for k in rewrite.split("_")})
    assert_as_jax(scratch / "p.j2k", je.with_cblk_style(data, style))


def _containers():
    rng = np.random.default_rng(21)
    c3 = je.pil_codestream(sample(rng, "RGB"), "RGB")
    w, h = 37, 21
    head = [je.ihdr(w, h, 3), je.colr(16)]
    jp2c = je.box(b"jp2c", c3)
    sig, ftyp = je.SIGNATURE_BOX, je.ftyp()
    jp2h = je.box(b"jp2h", b"".join(head))
    pal = rng.integers(0, 256, (300, 3))
    return {
        "ftyp_first": ftyp + sig + jp2h + jp2c,
        "no_ftyp": sig + jp2h + jp2c,
        "no_jp2h": sig + ftyp + jp2c,
        "jp2h_after_jp2c": sig + ftyp + jp2c + jp2h,
        "jp2h_without_ihdr": sig + ftyp + je.box(b"jp2h", je.colr(16))
        + jp2c,
        "empty_jp2h": sig + ftyp + je.box(b"jp2h", b"") + jp2c,
        "jp2c_missing": sig + ftyp + jp2h,
        "jp2c_empty": sig + ftyp + jp2h + je.box(b"jp2c", b""),
        "short_ihdr": sig + ftyp + je.box(b"jp2h", je.box(b"ihdr", bytes(10))
                                          + je.colr(16)) + jp2c,
        "zero_width_ihdr": je.jp2_file(c3, header=[je.ihdr(0, h, 3),
                                                   je.colr(16)]),
        "ihdr_wrong_size": je.jp2_file(c3, header=[je.ihdr(w + 1, h, 3),
                                                   je.colr(16)]),
        "ihdr_fewer_components": je.jp2_file(c3, header=[je.ihdr(w, h, 1),
                                                         je.colr(16)]),
        "grey_colr_on_rgb": je.jp2_file(c3, header=[je.ihdr(w, h, 3),
                                                    je.colr(17)]),
        "eycc_colr": je.jp2_file(c3, header=[je.ihdr(w, h, 3), je.colr(24)]),
        "short_colr": je.jp2_file(c3, header=[je.ihdr(w, h, 3),
                                              je.box(b"colr", b"\x01\0")]),
        "pclr_257_colours": je.jp2_file(
            je.pil_codestream(rng.integers(0, 256, (h, w), dtype=np.uint8),
                              "L"),
            header=[je.ihdr(w, h, 1), je.colr(16), je.pclr(pal),
                    je.cmap(3)]),
        "pclr_16_bit": je.jp2_file(
            je.pil_codestream(rng.integers(0, 9, (h, w), dtype=np.uint8),
                              "L"),
            header=[je.ihdr(w, h, 1), je.colr(16), je.pclr(pal[:9], 16),
                    je.cmap(3)]),
        "cmap_without_pclr": je.jp2_file(c3, header=head + [je.cmap(3)]),
        "two_cdef": je.jp2_file(c3, header=head + [
            je.cdef([(0, 0, 1)]), je.cdef([(0, 0, 1)])]),
        "misplaced_colr_box": sig + ftyp + je.colr(16) + jp2h + jp2c,
        "box_past_the_end": sig + ftyp + jp2h + struct.pack(">I4s", 99999,
                                                            b"jp2c") + c3,
        "zero_length_jp2c": sig + ftyp + jp2h + struct.pack(">I4s", 0,
                                                            b"jp2c") + c3,
        "bad_signature": sig[:-1] + b"\x0b" + ftyp + jp2h + jp2c,
        "no_soc": sig + ftyp + jp2h + je.box(b"jp2c", c3[2:]),
        "siz_short": b"\xff\x4f\xff\x51\x00\x20" + bytes(30),
        "five_components": _five_components(c3),
        "zero_width_siz": _siz_word(c3, 2, 0),
        "tile_offset_past_image": _siz_word(c3, 26, 5),
        "no_eoc": c3[:-2],
        "eoc_only_after_soc": b"\xff\x4f\xff\x51" + c3[4:c3.index(
            b"\xff\x52")] + b"\xff\xd9",
        "unknown_marker_in_tile": je.with_tile_segments(c3, [(0xFF30,
                                                              b"abcd")]),
        "odd_unknown_marker": je.with_main_segments(c3, [(0xFF30, b"abc")]),
        "crg_wrong_size": je.with_main_segments(c3, [(0xFF63, bytes(4))]),
        "plt_unterminated": je.with_tile_segments(c3, [(0xFF58,
                                                        b"\x00\x81")]),
        "cod_unknown_progression": _cod_byte(c3, 1, 7),
        "cod_no_layers": _cod_byte(c3, 3, 0),
        "cod_mct_2": _cod_byte(c3, 4, 2),
        "cod_big_code_blocks": _cod_byte(c3, 7, 9),
        "cod_bad_wavelet": _cod_byte(c3, 9, 2),
        "cod_mixed_ht": _cod_byte(c3, 8, 0x80),
        "small_precincts": je.pil_codestream(
            sample(rng, "RGB", 48, 64), "RGB", precinct_size=(16, 16)),
        "two_sot_for_one_part": _twice_tile_part(c3),
    }


def _cod_byte(data: bytes, index: int, value: int) -> bytes:
    cs = je.Codestream(data)
    cod = bytearray(cs.segment(0xFF52))
    cod[index] = value
    cs.replace(0xFF52, bytes(cod))
    return cs.bytes()


def _five_components(data: bytes) -> bytes:
    cs = je.Codestream(data)
    siz = cs.segment(0xFF51)
    cs.replace(0xFF51, siz[:34] + b"\x00\x05" + siz[36:] + siz[-6:])
    return cs.bytes()


def _siz_word(data: bytes, offset: int, value: int) -> bytes:
    """The codestream with the SIZ's 32-bit field at `offset` set."""
    cs = je.Codestream(data)
    siz = bytearray(cs.segment(0xFF51))
    siz[offset:offset + 4] = struct.pack(">I", value)
    cs.replace(0xFF51, bytes(siz))
    return cs.bytes()


def _twice_tile_part(data: bytes) -> bytes:
    cs = je.Codestream(data)
    cs.tiles.append(list(cs.tiles[0]))
    return cs.bytes()


@pytest.mark.parametrize("case", sorted(_containers()))
def test_malformed_files_as_openjpeg_reads_them(scratch, case):
    """OpenJPEG's box and marker rules (box order and sizes, the ihdr
    against SIZ, the colour space against the mode, COD values, tile-part
    indices) and PIL's plugin (what it cannot identify, what it asserts)."""
    assert_as_jax(scratch / "c.jp2", _containers()[case])


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), source=st.integers(0, 3),
       cut=st.integers(1, 4000))
def test_truncated_files(scratch, seed, source, cut):
    """A file cut anywhere: OpenJPEG refuses a tile-part shorter than its
    Psot and a header cut short, reads a file missing only its EOC after
    a tile-part of unknown length as it is, and PIL cannot identify what
    lacks its SIZ."""
    rng = np.random.default_rng(seed)
    img = sample(rng, "RGBA", 29, 41)
    data = [je.pil_codestream(img, "RGBA"),
            je.jp2_file(je.pil_codestream(img[..., :3], "RGB",
                                          irreversible=True)),
            je.pil_codestream(img, "RGBA", tile_size=(16, 16),
                              quality_layers=[20, 2]),
            je.pil_codestream(img[..., 0], "L", progression="RPCL",
                              precinct_size=(32, 32))][source]
    assert_as_jax(scratch / "t.j2k", data[:max(len(data) - cut, 1)])


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), source=st.integers(0, 3),
       flips=st.integers(1, 4))
def test_corrupt_streams(scratch, seed, source, flips):
    """Random bytes replaced: what OpenJPEG refuses (bad marker segments,
    segments past the data, impossible tag trees) the port refuses, and
    what it decodes the port decodes alike."""
    rng = np.random.default_rng(seed)
    img = sample(rng, "RGB", 19, 27)
    data = bytearray([je.pil_codestream(img, "RGB"),
                      je.pil_codestream(img, "RGB", irreversible=True,
                                        quality_layers=[30, 5]),
                      je.jp2_file(je.pil_codestream(img, "RGB",
                                                    tile_size=(16, 16))),
                      je.rewrite_packets(je.pil_codestream(img, "RGB"),
                                         sop=True, ppt=True)][source])
    for _ in range(flips):
        data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
    data = bytes(data)
    if jpeg2000.is_jpeg2000(data):
        size = jpeg2000.pil_open(data)[1] if _identified(data) else (1, 1)
        assume(size[0] * size[1] < 1 << 22)   # no decompression bombs
        assume(not _refused_by_design(data))
    assert_as_jax(scratch / "x.j2k", data)


def _refused_by_design(data: bytes) -> bool:
    """A flipped byte that made the file a Part 2 codestream (Rsiz bit
    15) or gave it HT code-blocks, which the port refuses by design."""
    try:
        jpeg2000.decode_jpeg2000(data)
    except NotImplementedError as e:
        return ITEM in str(e)
    except ValueError:
        pass
    return False


def _identified(data: bytes) -> bool:
    try:
        jpeg2000.pil_open(data)
    except Exception:
        return False
    return True


def _refused():
    """Files PIL reads whose features the port refuses."""
    flat = je.pil_codestream(np.full((13, 19, 3), 128, np.uint8), "RGB")
    return {"ht_code_blocks": je.with_cblk_style(flat, 0x40),
            "part2_rsiz": je.with_siz(flat, rsiz=0x8000),
            "part2_mco_marker": je.with_main_segments(flat,
                                                      [(0xFF77, b"\x00")])}


@pytest.mark.parametrize("case", sorted(_refused()))
def test_refused_features_name_item_22d(tmp_path, case):
    """HTJ2K code-blocks (a file where no code-block is included, so PIL
    reads it whatever the code-block coder) and Part 2 codestreams (Rsiz
    bit 15, an MCO marker): PIL reads each file, the port raises
    NotImplementedError naming ROADMAP item 22d."""
    path = tmp_path / "r.j2k"
    path.write_bytes(_refused()[case])
    assert jax_read_ldr(path).shape == (13, 19, 3)
    with pytest.raises(NotImplementedError, match=ITEM):
        image_io.read_ldr(str(path))


def test_ycbcr_tables_are_pillows():
    """The sYCC conversion of Pillow's unpackers (ImagingConvertYCbCr2RGB)
    equals PIL's own YCbCr to RGB on every (Cb, Cr) at several Y."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 1, 77, 128, 200, 255):
        px = np.stack([np.full_like(cb, y), cb, cr, np.zeros_like(cb)],
                      -1).astype(np.uint8)
        ref = np.asarray(Image.fromarray(px[..., :3], "YCbCr").convert(
            "RGB"))
        assert np.array_equal(jpeg2000.ycbcr_to_rgb(px)[..., :3], ref)


def test_jpeg2000_is_known_by_its_header(tmp_path):
    """A JP2 named .png reads as JPEG 2000 (PIL's _accept: a codestream's
    SOC and SIZ, or the 12-byte signature box); other bytes are not it."""
    data = open(os.path.join(FIXTURE_DIR, "rgb_53.jp2"), "rb").read()
    (tmp_path / "j.png").write_bytes(data)
    assert np.array_equal(image_io.read_ldr(str(tmp_path / "j.png")),
                          jax_read_ldr(tmp_path / "j.png"))
    assert jpeg2000.is_jpeg2000(data)
    assert jpeg2000.is_jpeg2000(b"\xff\x4f\xff\x51")
    assert not jpeg2000.is_jpeg2000(b"\xff\x4f\xff\x52")
    assert not jpeg2000.is_jpeg2000(data[:11] + b"\x0b")


def test_jp2_textured_scene_compiles_as_jax(tmp_path):
    """utils/demo_scene's textured scene (small) with its albedo the 9/7
    JP2 fixture and its leaf the RGBA raw codestream whose alpha makes
    the cutouts: the PBRT scene compiles in both packages to the same
    leaves, bit for bit (the textures' texels and the leaf's alpha
    companion among them). No wave is compiled."""
    from test_torch_instanced import assert_same, jax_compile, jax_tree
    from tracerboy_tpu_torch.scene.compile import compile_scene
    from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex, lit = write_textured_scene(str(tmp_path), grid=8, sky=(16, 8),
                                    leaves=8, albedo=8, normal=8, leaf=8)
    retexture(tex, {"albedo.png": os.path.join(FIXTURE_DIR, ALBEDO),
                    "leaf.png": os.path.join(FIXTURE_DIR, LEAF)})
    got = compile_scene(parse_pbrt(lit))
    assert_same(jax_tree(jax_compile(lit)), got.as_numpy())
