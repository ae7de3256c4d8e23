"""The port's AVIF reader (core/avif.py, csrc/av1_decode.cpp, through
core/image_io.read_ldr) against the JAX package's read_ldr, which reads
AVIF through PIL and so through libavif and dav1d: every case must be
equal bit for bit (np.array_equal of read_ldr's float32, with and
without gamma_to_linear).

The committed fixtures (tests/data/avif, written by
tests/make_avif_fixtures.py) are held against PIL and their manifest.
Those of part 1 are checked to have their in-loop filters off and,
together, to use every block tool of the decoder; those of part 2
(filt_*, albedo_default, leaf_default), written with the filters on, to
use, together, every filter the decoder follows: deblocking (its 13-tap
luma filter and chroma edges, sharpness 0 and 7, delta LF), CDEF (luma
and chroma), and Wiener, self-guided (sets with r0 = 0 and with r1 = 0)
and switchable restoration units, reported by the decoder itself; those
of intra block copy and film grain (ibc_*, grain_*, albedo_plain,
albedo_grain, leaf_grain) to use, together, a vector from the stack and
the default one, var-tx splits, the three inter transform sets and a
sub-8x8 block's chroma, and grain of every AR lag, with and without
overlap, chroma scaling from luma, the restricted clip, luma grain alone
and chroma grain alone. A plain Image.save of the scene's albedo uses
intra block copy.
Hypothesis sweeps random images and animations through Pillow's encoder
(subsampling, range, speed, quality, alpha, tool switches, all with the
filters off), Pillow's default saves (the filters on), screen content
with intra block copy on, aom film grain tables, truncated files and
replaced bytes. Where PIL refuses a file the port raises: ValueError
where PIL raises OSError, ValueError, SyntaxError, RuntimeError or
AssertionError, NotImplementedError where PIL cannot identify it. Files
that need what the port still leaves out (superres or high bit depth, say)
raise NotImplementedError naming ROADMAP item 22b, AVIF part 2. The
fixtures of grids (grid_*, albedo_grid, leaf_grid) and of libavif's
float routines (float_*, albedo_fcc) are checked to cover every
subsampling, alpha grids, premultiplied alpha and each float matrix;
flat frames over every value hold the float routines to PIL's, and
hypothesis sweeps grids of 1-3 rows and columns of 64-160 sample tiles.
libavif's grid refusals (ImageGrid version and size, dimensions, tile
count and types, essential properties, the first tile's av1C, tiles
under 64 samples, odd sizes under subsampled chroma, mismatched tiles,
tiles that do not cover the canvas or whose last row or column does not
overlap it) raise ValueError as PIL raises. The AV1 tables in
csrc/av1_tables.inc equal those of the libraries present
(tests/make_av1_tables.py --check). PBRT scenes
whose albedo is an AVIF and whose leaf an RGBA AVIF compile in both
packages to the same leaves, bit for bit.
"""

import functools
import json
import os
import struct

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st
from PIL import Image, UnidentifiedImageError

import avif_encode as ae
from make_avif_fixtures import (
    ALBEDO,
    ALBEDO_DEFAULT,
    ALBEDO_FCC,
    ALBEDO_GRID,
    ALBEDO_LOSSLESS,
    ALBEDO_PLAIN,
    FIXTURE_DIR,
    FLOAT_MATRICES,
    LEAF,
    LEAF_DEFAULT,
    LEAF_GRAIN,
    LEAF_GRID,
    SCREEN,
    TOOLS_OFF,
    copy_or_grain,
    filtered,
    grid_or_float,
    sample,
    screen,
)
from make_dds_fixtures import array_digest, pil_pixels
from tracerboy_tpu_torch.core import avif, image_io

torch.set_num_threads(2)

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
FIXTURES = sorted(MANIFEST["files"])
ITEM = "item 22b, AVIF part 2"


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("avif")


def jax_read_ldr(path, **kw):
    from tracerboy_tpu.core.image_io import read_ldr

    return read_ldr(str(path), **kw)


def assert_as_jax(path, data: bytes, lenient=False):
    """Write `data` to `path` and read it with read_ldr in both packages:
    equal float32 images (returns the port's), or the matching refusal
    (returns None): NotImplementedError where PIL cannot identify the
    file, ValueError where it raises otherwise. With lenient (the
    truncated and corrupted files), the port raises, or reads as PIL
    reads: a refusal of either kind where PIL refuses, and where PIL
    reads a damaged file (libavif and dav1d read past some damage, an
    ispe that disagrees with the frame among it) the port may refuse it
    with ValueError."""
    path.write_bytes(data)
    either = (ValueError, NotImplementedError)
    try:
        ref = jax_read_ldr(path)
    except (NotImplementedError, UnidentifiedImageError):
        with pytest.raises(either if lenient else NotImplementedError):
            image_io.read_ldr(str(path))
        return None
    except (OSError, ValueError, SyntaxError, RuntimeError, AssertionError,
            ZeroDivisionError):
        with pytest.raises(either if lenient else ValueError):
            image_io.read_ldr(str(path))
        return None
    try:
        got = image_io.read_ldr(str(path))
    except ValueError:
        if lenient:
            return None
        raise
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref), (
        np.abs(got - ref).max() * 255, (got != ref).mean())
    return got


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
    too. The manifest names the Pillow, libavif, dav1d and aom that
    wrote it; the directory stays under 1.5 MiB."""
    from make_avif_fixtures import versions

    names = set(os.listdir(FIXTURE_DIR)) - {"manifest.json"}
    assert names == set(MANIFEST["files"])
    assert {k: MANIFEST[k] for k in versions()} == versions()
    for name, entry in MANIFEST["files"].items():
        path = os.path.join(FIXTURE_DIR, name)
        assert array_digest(pil_pixels(path)) == entry, name
        assert array_digest(image_io.decode_ldr(path)) == entry, name
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, n))
                for n in os.listdir(FIXTURE_DIR))
    assert total < 1.5 * 2**20


def test_fixtures_have_the_filters_off_and_cover_the_decoder():
    """The fixtures of part 1: the headers alone (up to the first frame
    header) find every one's in-loop filters off (no deblocking level,
    CDEF strength or restoration type), and its decode uses none;
    together they use every block tool of csrc/av1_decode.cpp but
    segmentation (aom writes none on a key frame), every header flag, all
    four subsamplings, tiles, both superblock sizes and a frame coded
    lossless."""
    tools, flags, layouts = set(), set(), set()
    lossless = tiles = sb128 = 0
    part1 = [name for name in FIXTURES if not filtered(name)
             and not copy_or_grain(name) and not grid_or_float(name)]
    for name in part1:
        data = open(os.path.join(FIXTURE_DIR, name), "rb").read()
        head = avif.frame_info(data, name, headers_only=True)
        assert head["lf_sharpness"] == head["cdef_bits"] == 0, name
        assert set(head["lr_types"]) == {"none"}, name
        info = avif.frame_info(data, name)
        assert info["filters"] == set(), name
        tools |= info["tools"]
        flags |= info["flags"]
        layouts.add((info["mono"], *info["subsampling"]))
        lossless += info["lossless"]
        tiles += info["tiles"] > 1
        sb128 += info["sb128"]
    assert tools == set(avif.TOOLS) - {"segments"}
    assert flags >= set(avif.HEADER_FLAGS) - {"segmentation", "delta_lf"}
    assert layouts == {(False, 1, 1), (False, 1, 0), (False, 0, 0),
                       (True, 1, 1)}
    assert lossless >= 2 and tiles >= 3 and 0 < sb128 < len(part1)


def test_filtered_fixtures_cover_the_filters():
    """The fixtures of part 2, written with the in-loop filters on: the
    decoder reports, together, deblocking (the 13-tap luma filter and
    chroma edges among it, sharpness 0 and 7, a delta LF), CDEF on luma
    and chroma, and Wiener, self-guided and switchable restoration units
    with self-guided sets whose r0 and whose r1 are 0 (every filter the
    decoder reports; aom never writes delta_lf_multi, so the delta LF
    seen is one a block), at all four subsamplings,
    with several tiles and both superblock sizes, frame restoration types
    Wiener, self-guided and switchable, units of 128 and 256 samples;
    and a default save at quality 100, coded lossless, with none."""
    filters, layouts, sharp, lr, units = set(), set(), set(), set(), set()
    tiles = sb = 0
    names = [name for name in FIXTURES if filtered(name)]
    assert len(names) >= 30
    for name in names:
        info = avif.frame_info(
            open(os.path.join(FIXTURE_DIR, name), "rb").read(), name)
        filters |= info["filters"]
        layouts.add((info["mono"], *info["subsampling"]))
        if "deblocking" in info["filters"]:
            sharp.add(info["lf_sharpness"])
        lr |= set(info["lr_types"])
        if set(info["lr_types"]) != {"none"}:
            units.add(info["lr_unit_size"][0])
        on = {"deblocking", "cdef", "wiener"} <= info["filters"]
        tiles += on and info["tiles"] > 1
        sb |= 1 << info["sb128"] if on else 0
        if name == "filt_lossless.avif":
            assert info["lossless"] and info["filters"] == set()
    assert filters == set(avif.FILTERS)
    assert layouts == {(False, 1, 1), (False, 1, 0), (False, 0, 0),
                       (True, 1, 1)}
    assert sharp >= {0, 7} and lr >= {"wiener", "sgrproj", "switchable"}
    assert units >= {128, 256} and tiles >= 2 and sb == 3


def test_copy_and_grain_fixtures_cover_the_decoder():
    """The fixtures of intra block copy and film grain: by the decoder's
    own report, together they use a vector from the stack and the default
    one, var-tx splits, inter transform sets 1, 2 and 3 and a sub-8x8
    block's chroma, and grain of AR lags 0-3 with and without overlap,
    chroma scaling from luma, the restricted clip, luma grain alone and
    chroma grain alone; each tool at all four subsamplings. No other
    fixture uses either."""
    ibc, grain, layouts, overlap_off = set(), set(), set(), 0
    for name in FIXTURES:
        info = avif.frame_info(
            open(os.path.join(FIXTURE_DIR, name), "rb").read(), name)
        if not copy_or_grain(name):
            assert grid_or_float(name) or (
                info["intrabc"] == info["grain"] == set()), name
            continue
        ibc |= info["intrabc"]
        grain |= info["grain"]
        layout = (info["mono"], *info["subsampling"])
        layouts |= {(layout, k) for k in ("intrabc", "grain") if info[k]}
        overlap_off += "grain" in info["grain"] and (
            "overlap" not in info["grain"])
    assert ibc == set(avif.INTRABC) and grain == set(avif.GRAIN)
    assert overlap_off >= 1
    assert layouts == {(layout, k) for layout in (
        (False, 1, 1), (False, 1, 0), (False, 0, 0), (True, 1, 1))
        for k in ("intrabc", "grain")}


def test_plain_save_albedo_uses_intra_block_copy():
    """The scene's 1024x1024 albedo as a plain Image.save (Pillow's and
    aom's defaults: speed 6): aom codes the flat procedural texture with
    intra block copy (vectors from the stack and the default one, var-tx
    splits, all three inter transform sets), and the port reads it as
    the JAX read_ldr reads it, with and without gamma_to_linear."""
    path = os.path.join(FIXTURE_DIR, ALBEDO_PLAIN)
    info = avif.frame_info(open(path, "rb").read(), ALBEDO_PLAIN)
    assert info["size"] == (1024, 1024)
    assert {"intrabc", "stack_dv", "default_dv", "var_tx", "inter_tx_set_1",
            "inter_tx_set_2", "inter_tx_set_3"} <= info["intrabc"]
    assert np.array_equal(image_io.read_ldr(path), jax_read_ldr(path))
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


def test_default_scene_textures_have_the_filters_on():
    """The scene's albedo and RGBA leaf as Pillow's default saves
    (aom's defaults): 1024x1024 and 512x512, deblocked with the 13-tap
    filter on luma and chroma edges; the leaf's alpha cuts about half the
    texels, its 4:0:0 alpha item deblocked too."""
    for name, size in ((ALBEDO_DEFAULT, 1024), (LEAF_DEFAULT, 512)):
        data = open(os.path.join(FIXTURE_DIR, name), "rb").read()
        info = avif.frame_info(data)
        assert info["size"] == (size, size)
        assert {"deblocking", "deblocking_13_tap",
                "deblocking_chroma"} <= info["filters"]
    data = open(os.path.join(FIXTURE_DIR, LEAF_DEFAULT), "rb").read()
    alpha = avif._parse(data)[1]
    _, info = avif._decode_av1(avif.av1_library(), alpha, LEAF_DEFAULT)
    assert info[2] == 1 and info[15] >> len(avif.TOOLS) & 1
    leaf = image_io.decode_ldr(os.path.join(FIXTURE_DIR, LEAF_DEFAULT))
    assert leaf.shape == (512, 512, 4)
    assert 0.3 < (leaf[..., 3] == 0).mean() < 0.7


def test_scene_textures_are_what_the_scene_needs():
    """The 1024x1024 albedo as a 4:2:0 AVIF and as a 4:4:4 AVIF coded
    lossless (the Walsh-Hadamard path); the 512x512 leaf an RGBA AVIF
    whose alpha cuts about half the texels."""
    for name, sub, lossless in ((ALBEDO, (1, 1), False),
                                (ALBEDO_LOSSLESS, (0, 0), True)):
        data = open(os.path.join(FIXTURE_DIR, name), "rb").read()
        info = avif.frame_info(data)
        assert info["size"] == (1024, 1024)
        assert info["subsampling"] == sub and info["lossless"] == lossless
    leaf = image_io.decode_ldr(os.path.join(FIXTURE_DIR, LEAF))
    assert leaf.shape == (512, 512, 4)
    assert 0.3 < (leaf[..., 3] == 0).mean() < 0.7


SUBSAMPLINGS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 90),
       h=st.integers(1, 70), sub=st.sampled_from(SUBSAMPLINGS),
       full=st.booleans(), speed=st.integers(2, 10),
       quality=st.integers(0, 100), rgba=st.booleans(),
       premultiplied=st.booleans(), animated=st.booleans(),
       tool=st.sampled_from((None, *TOOLS_OFF)),
       extra=st.sampled_from((None, ("enable-qm", "1"),
                              ("deltaq-mode", "3"), ("sb-size", "128"),
                              ("reduced-tx-type-set", "1"),
                              ("enable-palette", "1"))))
def test_pil_encoder_sweep(scratch, seed, w, h, sub, full, speed, quality,
                           rgba, premultiplied, animated, tool, extra):
    rng = np.random.default_rng(seed)
    img = sample(rng, h, w, 4 if rgba else 3)
    adv = dict([extra] if extra else [])
    if tool:
        adv[tool] = "0"
    more = [Image.fromarray(sample(rng, h, w, 4 if rgba else 3))]
    data = ae.pil_avif(img, quality=quality, speed=speed, subsampling=sub,
                       range="full" if full else "limited",
                       alpha_premultiplied=premultiplied, advanced=adv,
                       append_images=more if animated else [])
    assert assert_as_jax(scratch / "s.avif", data) is not None


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 64),
       h=st.integers(1, 64), sub=st.sampled_from(SUBSAMPLINGS),
       speed=st.integers(0, 10), quality=st.integers(0, 100),
       rgba=st.booleans())
def test_default_save_sweep(scratch, seed, w, h, sub, speed, quality, rgba):
    """Pillow's default save (aom's defaults: the in-loop filters on as
    aom picks them) of random images: read as PIL reads them."""
    img = sample(np.random.default_rng(seed), h, w, 4 if rgba else 3)
    data = ae.pil_default(img, quality=quality, speed=speed,
                          subsampling=sub)
    assert assert_as_jax(scratch / "d.avif", data) is not None


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), source=st.integers(0, 3),
       cut=st.integers(1, 3000))
def test_truncated_files(scratch, seed, source, cut):
    """A file cut anywhere: libavif cannot identify a file whose ftyp or
    meta (or moov) is cut short, and fails the decode of an item whose
    data is; the port raises as PIL raises."""
    rng = np.random.default_rng(seed)
    data = _sources(rng)[source]
    assert_as_jax(scratch / "t.avif", data[:max(len(data) - cut, 1)],
                  lenient=True)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), source=st.integers(0, 3),
       flips=st.integers(1, 3))
def test_corrupt_files(scratch, seed, source, flips):
    """Random bytes replaced, in the box tree or the AV1 data: what
    libavif refuses the port refuses, what dav1d decodes the port decodes
    alike (or refuses, where the stream breaks a rule of the AV1
    specification)."""
    rng = np.random.default_rng(seed)
    data = bytearray(_sources(rng)[source])
    for _ in range(flips):
        data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
    data = bytes(data)
    try:
        size = avif._parse(data)[2]
        assume(size[0] * size[1] < 1 << 22)    # no decompression bombs
    except Exception:
        pass
    assume(not _refused_by_design(data))
    assert_as_jax(scratch / "x.avif", data, lenient=True)


def _sources(rng):
    return [ae.pil_avif(sample(rng, 19, 27), quality=60, speed=8),
            ae.pil_avif(sample(rng, 17, 23, 4), quality=60, speed=8,
                        subsampling="4:4:4"),
            ae.relocate(ae.pil_avif(sample(rng, 16, 16), quality=60,
                                    speed=8), idat=True),
            ae.pil_avif(sample(rng, 12, 20), quality=60, speed=8,
                        append_images=[Image.fromarray(sample(rng, 12,
                                                              20))])]


def _refused_by_design(data: bytes) -> bool:
    """A replaced byte that made the frame ask for a feature the port
    still leaves out (superres or high bit depth, say), or an intra block
    copy vector that points outside what is decoded (which dav1d copies
    from whatever its frame buffer holds, so PIL's pixels there are not
    repeatable): the port refuses these by design where dav1d decodes
    them, and for no other reason."""
    try:
        avif.read_avif(data)
    except NotImplementedError as e:
        return ITEM in str(e)
    except ValueError as e:
        return avif.INVALID_DV in str(e)
    return False


def _refused():
    """Files the port refused before it read libavif's float routines."""
    img = sample(np.random.default_rng(7), 64, 64)
    return {
        "matrix_fcc": ae.set_nclx(ae.pil_avif(img), mc=4),
        "matrix_ycgco": ae.set_nclx(ae.pil_avif(img), mc=8, full=1),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_refused_features_name_avif_part_2(tmp_path, case):
    """Matrix coefficients libavif converts in its own float path: the
    port reads each file as the JAX read_ldr reads it, with and without
    gamma_to_linear."""
    data = _refused()[case]
    path = tmp_path / "r.avif"
    assert assert_as_jax(path, data).shape[:2] == (64, 64)
    assert np.array_equal(image_io.read_ldr(str(path), gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


@pytest.mark.parametrize("mc", (16, 17, 18, 100, 254))
def test_matrices_libavif_refuses_raise_value_error(tmp_path, mc):
    """Matrix coefficients 16-254, which libavif refuses ("Reformat
    failed": PIL's RuntimeError), raise ValueError, not
    NotImplementedError."""
    img = sample(np.random.default_rng(mc), 20, 24)
    for sub in ("4:2:0", "4:0:0"):
        data = ae.set_nclx(ae.pil_avif(img, subsampling=sub, speed=9), mc=mc)
        path = tmp_path / "m.avif"
        path.write_bytes(data)
        with pytest.raises(RuntimeError, match="Reformat failed"):
            jax_read_ldr(path)
        with pytest.raises(ValueError, match="Reformat failed"):
            image_io.read_ldr(str(path))


def test_primary_iovl_item_raises_value_error(tmp_path):
    """A primary item of type iovl, which libavif 1.3 does not read
    ("missing or empty image item": PIL's RuntimeError), raises
    ValueError; an iovl alpha item is no alpha, as in PIL."""
    tiles = ae.split_tiles(sample(np.random.default_rng(3), 128, 128, 4),
                           1, 2, 64, 128, speed=9)
    path = tmp_path / "o.avif"
    path.write_bytes(ae.make_grid(tiles, 1, 2, 128, 128,
                                  primary_type=b"iovl"))
    with pytest.raises(RuntimeError, match="Missing or empty image item"):
        jax_read_ldr(path)
    with pytest.raises(ValueError, match="missing or empty image item"):
        image_io.read_ldr(str(path))
    data = ae.make_grid(tiles, 1, 2, 128, 128, alpha=True).replace(
        b"gridAlpha", b"iovlAlpha")
    assert assert_as_jax(path, data).shape == (128, 128, 3)


def _copy_and_grain_saves():
    """The two cases the port refused before it read intra block copy and
    film grain, with what each must use."""
    img = sample(np.random.default_rng(7), 64, 64)
    scr = screen(np.random.default_rng(5), 128, 160)
    return {
        "film_grain": (ae.pil_default(img, advanced={
            "film-grain-test": "1"}), "grain"),
        "intrabc": (ae.pil_avif(scr, quality=40, speed=6, advanced={
            **SCREEN, "enable-palette": "1"}), "intrabc"),
    }


@pytest.mark.parametrize("case", sorted(_copy_and_grain_saves()))
def test_copy_and_grain_saves_read_as_the_jax_read_ldr(tmp_path, case):
    """Film grain (aom's film-grain-test 1) and screen content with intra
    block copy: the frame uses the tool, and the port reads the file as
    the JAX read_ldr reads it, with and without gamma_to_linear."""
    data, tool = _copy_and_grain_saves()[case]
    assert tool in avif.frame_info(data)[tool]
    assert assert_as_jax(tmp_path / "c.avif", data) is not None
    path = tmp_path / "c.avif"
    assert np.array_equal(image_io.read_ldr(str(path), gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


# Screen content aom codes with intra block copy at 128x160 (aom keeps it
# only where it pays, which in frames this small it seldom does).
SCREEN_128X160 = screen(np.random.default_rng(5), 128, 160)


@settings(max_examples=15, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1))
def test_intrabc_sweep(scratch, seed):
    """128x160 screen content recoloured (its channels permuted and
    XORed with a byte), saved with tune-content screen and intra block
    copy on at a speed 0-7, quality 30-100 and subsampling drawn
    uniformly from the seed, with or without alpha, Pillow's default
    save otherwise: read as PIL reads it (aom turns the tool off again on
    more than half of them, which then read with the in-loop filters
    on)."""
    rng = np.random.default_rng(seed)

    def recolour():
        return (SCREEN_128X160[..., rng.permutation(3)]
                ^ np.uint8(rng.integers(0, 256)))

    img = recolour()
    if rng.integers(0, 2):
        img = np.concatenate([img, recolour()[..., :1]], -1)
    data = ae.pil_default(img, quality=int(rng.integers(30, 101)),
                          speed=int(rng.integers(0, 8)),
                          subsampling=SUBSAMPLINGS[rng.integers(0, 4)],
                          advanced=SCREEN)
    assert assert_as_jax(scratch / "b.avif", data) is not None


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 64),
       h=st.integers(1, 64), sub=st.sampled_from(SUBSAMPLINGS),
       lag=st.integers(0, 3), ar_shift=st.integers(6, 9),
       scale_shift=st.integers(0, 3), scaling_shift=st.integers(8, 11),
       from_luma=st.booleans(), overlap=st.booleans(), full=st.booleans(),
       grain_seed=st.integers(0, 65535), rgba=st.booleans())
def test_grain_table_sweep(scratch, seed, w, h, sub, lag, ar_shift,
                           scale_shift, scaling_shift, from_luma, overlap,
                           full, grain_seed, rgba):
    """Film grain from aom's own table format (grain_table.c's filmgrn1
    text): random scaling points (none too), AR coefficients of every
    lag, chroma multipliers, chroma scaling from luma, overlap, seeds, at
    every subsampling and range: read as PIL reads it (with the grain
    dav1d adds). Where the syntax reads no chroma points (chroma scaling
    from luma, 4:0:0, 4:2:0 without luma points), or at 4:0:0 no chroma
    scaling from luma, aom writes the table's fields all the same, and
    the tile data is read from the wrong bit: such a stream reads as PIL
    reads it, or is refused where PIL refuses it. An RGBA image's alpha
    item, 4:0:0, takes the same table."""
    rng = np.random.default_rng(seed)

    def points(most):
        n = int(rng.integers(0, most + 1))
        xs = np.sort(rng.choice(256, n, replace=False))
        return [(int(x), int(y)) for x, y in zip(xs, rng.integers(0, 256, n))]

    y_pts, cb_pts, cr_pts = points(14), points(10), points(10)
    if sub == "4:2:0" and bool(cb_pts) != bool(cr_pts):
        cr_pts = cb_pts                 # dav1d refuses one without the other
    mono = sub == "4:0:0" or rgba
    no_chroma = from_luma or mono or (sub == "4:2:0" and not y_pts)
    conforming = (not (mono and from_luma)
                  and not (no_chroma and (cb_pts or cr_pts)))
    n = 2 * lag * (lag + 1)
    table = ae.grain_table(
        seed=grain_seed, lag=lag, ar_shift=ar_shift, scale_shift=scale_shift,
        scaling_shift=scaling_shift, from_luma=int(from_luma),
        overlap=int(overlap), y_points=y_pts, cb_points=cb_pts,
        cr_points=cr_pts, cb=(int(rng.integers(0, 256)),
                              int(rng.integers(0, 256)),
                              int(rng.integers(0, 512))),
        cr=(int(rng.integers(0, 256)), int(rng.integers(0, 256)),
            int(rng.integers(0, 512))),
        ar_y=rng.integers(-128, 128, n).tolist(),
        ar_cb=rng.integers(-128, 128, n + 1).tolist(),
        ar_cr=rng.integers(-128, 128, n + 1).tolist())
    img = sample(rng, h, w, 4 if rgba else 3)
    data = ae.pil_grain(img, table, quality=int(rng.integers(20, 90)),
                        subsampling=sub, range="full" if full else "limited")
    got = assert_as_jax(scratch / "g.avif", data)
    assert got is not None or not conforming


def test_grain_stream_aom_misaligns_reads_as_pil(tmp_path):
    """A grain table with chroma points and chroma scaling from luma: aom
    writes the chroma multipliers the syntax does not read, so the tile
    data is read from the wrong bit. The port reads what dav1d reads of
    it and refuses what dav1d refuses: at 4:2:2 a vertical partition,
    whose halves have no chroma size (PIL's RuntimeError, the port's
    ValueError)."""
    refused = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        h, w = int(rng.integers(30, 70)), int(rng.integers(30, 70))
        table = ae.grain_table(
            seed=seed, scale_shift=2, scaling_shift=11, from_luma=1,
            y_points=((59, 3), (127, 150), (196, 199)),
            cb_points=((17, 225), (94, 13)), cr_points=((45, 59), (90, 63)),
            cb=(100, 160, 300), cr=(150, 90, 220))
        data = ae.pil_grain(sample(rng, h, w), table,
                            quality=int(rng.integers(20, 90)),
                            subsampling="4:2:2")
        if assert_as_jax(tmp_path / "m.avif", data) is None:
            refused += 1
            with pytest.raises(ValueError, match="partition at 4:2:2"):
                image_io.read_ldr(str(tmp_path / "m.avif"))
    assert refused == 1


def _filtered_saves():
    """Pillow's default save and each in-loop filter on alone (the cases
    part 1 refused), with the filter each must use."""
    img = sample(np.random.default_rng(7), 64, 64)
    return {
        "default_save": (ae.pil_default(img, quality=50), "deblocking"),
        "deblocking_only": (ae.pil_avif(img, quality=30, advanced={
            "loopfilter-control": "1"}), "deblocking"),
        "cdef_only": (ae.pil_avif(img, quality=20, advanced={
            "enable-cdef": "1"}), "cdef"),
        "restoration_only": (ae.pil_avif(img, quality=20, speed=4, advanced={
            "enable-restoration": "1"}), "wiener"),
    }


@pytest.mark.parametrize("case", sorted(_filtered_saves()))
def test_filtered_saves_read_as_the_jax_read_ldr(tmp_path, case):
    """Pillow's default save (deblocking on) and deblocking, CDEF or loop
    restoration on alone: the frame uses the filter, and the port reads
    the file as the JAX read_ldr reads it."""
    data, used = _filtered_saves()[case]
    assert used in avif.frame_info(data)["filters"]
    assert assert_as_jax(tmp_path / "f.avif", data) is not None
    path = tmp_path / "f.avif"
    assert np.array_equal(image_io.read_ldr(str(path), gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


def _containers():
    """Box-tree variants and what libavif makes of them."""
    base = ae.pil_avif(sample(np.random.default_rng(11), 13, 17),
                       quality=60, speed=8)
    rgba = ae.pil_avif(sample(np.random.default_rng(12), 13, 17, 4),
                       quality=60, speed=8)
    meta = base.index(b"meta") + 4

    def rename(data, old, new, count=1):
        return data.replace(old, new, count)

    out = {
        "mif1_without_avif": ae.set_brands(base, b"mif1",
                                           [b"mif1", b"mif1", b"miaf",
                                            b"MA1B"]),
        "msf1_major": ae.set_brands(base, b"msf1",
                                    [b"avif", b"mif1", b"miaf", b"MA1B"]),
        "no_pixi": rename(base, b"pixi", b"pixz"),
        "no_ispe": rename(base, b"ispe", b"ispz"),
        "no_av1c": rename(base, b"av1C", b"av1Z"),
        "hdlr_not_first": rename(base, b"hdlr", b"hdlz"),
        "handler_vide": rename(base, b"pict", b"vide"),
        "no_pitm": rename(base, b"pitm", b"pitz"),
        "no_meta": rename(base, b"meta", b"metz"),
        "no_colr": ae.drop_colr(base),
        "alpha_urn_unknown": rename(rgba, b"auxiliary:alpha",
                                    b"auxiliary:depth"),
        "alpha_no_auxl": rename(rgba, b"auxl", b"auxz"),
        "primary_type_hvc1": rename(base, b"av01Color", b"hvc1Color"),
        "ipma_index_past_ipco": _poke(base, base.index(b"ipma") + 17, 0x7F),
        "iloc_extent_past_eof": base[:base.index(b"mdat") + 20],
        "meta_cut": base[:meta + 40],
        "two_ftyp": base[:base.index(b"meta") - 4] + base[:24]
        + base[base.index(b"meta") - 4:],
        "iinf_count_wrong": _poke(base, base.index(b"iinf") + 9, 3),
        "infe_version_1": _poke(base, base.index(b"infe") + 4, 1),
        "iloc_version_3": _poke(base, base.index(b"iloc") + 4, 3),
        "essential_unknown_property": rename(
            _poke(base, base.index(b"ipma") + 16, 0x80 | base[
                base.index(b"ipma") + 16]), b"pixi", b"pixz"),
    }
    return out


def _poke(data: bytes, pos: int, value: int) -> bytes:
    return data[:pos] + bytes([value]) + data[pos + 1:]


@pytest.mark.parametrize("case", sorted(_containers()))
def test_box_trees_as_libavif_reads_them(scratch, case):
    """libavif's box rules (the brands, the meta's hdlr, the mandatory
    av1C, ispe and pixi, pitm, iloc and iinf versions and counts,
    property indices, essential properties, the alpha item's auxl and
    URN, item data past the end of the file, the frame against ispe) and
    PIL's mapping of its errors: the port reads or refuses as PIL does."""
    assert_as_jax(scratch / f"{case}.avif", _containers()[case])


def test_avif_is_known_by_its_header(tmp_path):
    """An AVIF named .png reads as AVIF (PIL's _accept: ftyp at offset 4
    and a major brand avif, avis, mif1 or msf1; AVIF is PIL's first
    plugin); other brands are not it."""
    data = open(os.path.join(FIXTURE_DIR, LEAF), "rb").read()
    (tmp_path / "a.png").write_bytes(data)
    assert np.array_equal(image_io.read_ldr(str(tmp_path / "a.png")),
                          jax_read_ldr(tmp_path / "a.png"))
    assert avif.is_avif(data)
    for brand in (b"avis", b"mif1", b"msf1"):
        assert avif.is_avif(data[:8] + brand + data[12:])
    assert not avif.is_avif(data[:8] + b"heic" + data[12:])
    assert not avif.is_avif(b"\0\0\0\x18ftyq" + data[8:])


def test_yuv_to_rgb_is_libyuvs_on_every_value(tmp_path):
    """Flat frames over the whole Y range and the chroma corners, at both
    ranges and the three libyuv matrices and identity: the port's RGB is
    PIL's on every value (libyuv's fixed point, not a float formula)."""
    ys = np.repeat(np.arange(256, dtype=np.uint8), 4)
    img = np.stack([ys, np.roll(ys, 85), np.roll(ys, 170)], -1)
    img = np.tile(img[None], (8, 1, 1))
    for sub in ("4:4:4", "4:0:0"):
        data = ae.pil_avif(img, quality=100, speed=8, subsampling=sub)
        for mc in (0, 1, 6, 9):
            if mc == 0 and sub != "4:4:4":
                continue
            for full in (0, 1):
                assert_as_jax(tmp_path / "y.avif",
                              ae.set_nclx(data, mc=mc, full=full))


def test_unpremultiply_is_libyuvs(tmp_path):
    """Premultiplied alpha at every value, colours past their alpha
    included (what a lossy encode gives): libyuv's ARGBUnattenuate as its
    SIMD rows compute it, 16-bit products saturated as signed."""
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (16, 256, 4)).astype(np.uint8)
    img[..., 3] = np.arange(256)[None]
    img[8:, :, 3] %= 4
    for sub in ("4:4:4", "4:2:0"):
        data = ae.pil_avif(img, quality=100, speed=8, subsampling=sub,
                           alpha_premultiplied=True)
        assert assert_as_jax(tmp_path / "p.avif", data) is not None


def test_av1_tables_equal_the_libraries():
    """csrc/av1_tables.inc is what tests/make_av1_tables.py reads out of
    Pillow's libavif (aom 3.12.1's and dav1d 1.5.1's copies), and no
    system AV1 library present lays a table out alike with other values
    (--check; a library absent is reported and skipped)."""
    import make_av1_tables

    if make_av1_tables.wheel_path() is None:
        pytest.skip("Pillow's wheel libavif is not installed")
    assert make_av1_tables.main(["--check"]) == 0


def test_avif_textured_scene_compiles_as_jax(tmp_path):
    """utils/demo_scene's textured scene (small) with its albedo the 4:2:0
    AVIF fixture and its leaf the RGBA AVIF whose alpha item makes the
    cutouts: the PBRT scene compiles in both packages to the same leaves,
    bit for bit (the textures' texels and the leaf's alpha companion
    among them). No wave is compiled."""
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


def test_filtered_avif_scene_compiles_as_jax(tmp_path):
    """The same scene with its albedo and leaf Pillow's default saves
    (the in-loop filters on; what chip_smoke.py renders on the card):
    the same leaves in both packages, bit for bit."""
    from test_torch_instanced import assert_same, jax_compile, jax_tree
    from tracerboy_tpu_torch.scene.compile import compile_scene
    from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex, lit = write_textured_scene(str(tmp_path), grid=8, sky=(16, 8),
                                    leaves=8, albedo=8, normal=8, leaf=8)
    retexture(tex, {"albedo.png": os.path.join(FIXTURE_DIR, ALBEDO_DEFAULT),
                    "leaf.png": os.path.join(FIXTURE_DIR, LEAF_DEFAULT)})
    got = compile_scene(parse_pbrt(lit))
    assert_same(jax_tree(jax_compile(lit)), got.as_numpy())


def test_copy_and_grain_avif_scene_compiles_as_jax(tmp_path):
    """The same scene with its albedo a plain Image.save (intra block
    copy) and its RGBA leaf a default save with film grain, on its alpha
    item too (what chip_smoke.py renders on the card): the same leaves in
    both packages, bit for bit."""
    from test_torch_instanced import assert_same, jax_compile, jax_tree
    from tracerboy_tpu_torch.scene.compile import compile_scene
    from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex, lit = write_textured_scene(str(tmp_path), grid=8, sky=(16, 8),
                                    leaves=8, albedo=8, normal=8, leaf=8)
    retexture(tex, {"albedo.png": os.path.join(FIXTURE_DIR, ALBEDO_PLAIN),
                    "leaf.png": os.path.join(FIXTURE_DIR, LEAF_GRAIN)})
    got = compile_scene(parse_pbrt(lit))
    assert_same(jax_tree(jax_compile(lit)), got.as_numpy())


def test_ispe_and_frame_sizes(scratch):
    """An ispe that disagrees with the AV1 frame: libavif hands Pillow the
    frame's pixels and Pillow lays them out at the ispe's size (what it
    returns is the frame's bytes at the wrong stride, past them whatever
    memory follows); the port refuses the file (ValueError)."""
    base = ae.pil_avif(sample(np.random.default_rng(4), 12, 16), speed=8)
    i = base.index(b"ispe") + 8
    for w, h in ((16, 11), (15, 12), (32, 24)):
        data = base[:i] + struct.pack(">II", w, h) + base[i + 8:]
        path = scratch / "i.avif"
        path.write_bytes(data)
        assert jax_read_ldr(path).shape[:2] == (h, w)
        with pytest.raises(ValueError, match="the frame is 16x12"):
            image_io.read_ldr(str(path))


def test_grid_and_float_fixtures_cover_the_reader():
    """The fixtures of grids and of libavif's float routines: by the
    reader's own report, grids at all four subsamplings, 1x1 (one cropped
    below its tile) to 3x3, alpha grids with and without premultiplied
    alpha, a grid taking the float routines; each float matrix of
    FLOAT_MATRICES at all four subsamplings, with alpha, premultiplied
    alpha at 4:2:0 (the slow routine), 4:4:4 and 4:0:0."""
    grid_layouts, shapes, float_layouts, alpha = set(), set(), set(), set()
    for name in FIXTURES:
        if not grid_or_float(name):
            continue
        data = open(os.path.join(FIXTURE_DIR, name), "rb").read()
        color, a, size, nclx, prem = avif._parse(data)
        info = avif.frame_info(data, name)
        layout = (info["mono"], *info["subsampling"])
        mc = nclx[2] if nclx else 2
        if info["grid"]:
            rows, cols, tw, th = info["grid"]
            assert isinstance(color, avif._Grid) and size == info["size"]
            grid_layouts.add(layout)
            shapes.add((rows, cols, size[0] < tw))
            alpha.add(("grid", isinstance(a, avif._Grid), prem))
        if mc in (4, 7, 8, 12, 15) and (mc != 12 or nclx[0] not in (
                1, 2, 5, 6, 9)):
            float_layouts.add((mc, nclx[0], layout))
            alpha.add(("float", a is not None, prem, layout))
    every = {(False, 1, 1), (False, 1, 0), (False, 0, 0), (True, 1, 1)}
    assert grid_layouts == every
    assert {(1, 1, False), (1, 1, True), (3, 3, False)} <= shapes
    assert {("grid", True, False), ("grid", True, True)} <= alpha
    assert {(mc, cp, layout) for mc, cp, _ in FLOAT_MATRICES.values()
            for layout in every} <= float_layouts
    assert {("float", True, False, (False, 1, 1)),
            ("float", True, True, (False, 1, 1)),
            ("float", True, True, (False, 0, 0)),
            ("float", True, True, (True, 1, 1))} <= alpha


def test_float_routines_are_libavifs_on_every_value(tmp_path):
    """Flat frames over the whole Y range and the chroma corners (each
    value four samples wide, so subsampled chroma holds it too), at both
    ranges and every subsampling, through each float matrix: the port's
    RGB is PIL's on every value (libavif's single-precision steps and
    rounding); YCgCo at limited range raises ValueError as PIL raises.
    Premultiplied RGBA ramps through libavif's float un-premultiply
    (4:2:0) and libyuv's (4:4:4)."""
    ys = np.repeat(np.arange(256, dtype=np.uint8), 4)
    img = np.stack([ys, np.roll(ys, 85), np.roll(ys, 170)], -1)
    img = np.tile(img[None], (8, 1, 1))
    for sub in SUBSAMPLINGS:
        data = ae.pil_avif(img, quality=100, speed=8, subsampling=sub)
        for mc, cp, _ in FLOAT_MATRICES.values():
            for full in (0, 1):
                got = assert_as_jax(tmp_path / "f.avif",
                                    ae.set_nclx(data, cp=cp, mc=mc,
                                                full=full))
                assert (got is None) == (mc == 8 and not full)
    rgba = np.concatenate([img, np.tile(np.arange(256, dtype=np.uint8)
                                        .repeat(4)[None, :, None],
                                        (8, 1, 1))], -1)
    for sub in ("4:2:0", "4:4:4"):
        data = ae.pil_avif(rgba, quality=100, speed=8, subsampling=sub,
                           alpha_premultiplied=True)
        for mc, full in ((4, 1), (8, 1), (12, 0)):
            assert assert_as_jax(tmp_path / "p.avif", ae.set_nclx(
                data, cp=12, mc=mc, full=full)) is not None


@settings(max_examples=15, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), rows=st.integers(1, 3),
       cols=st.integers(1, 3), tw=st.integers(32, 80),
       th=st.integers(32, 80), sub=st.sampled_from(SUBSAMPLINGS),
       rgba=st.booleans(), prem=st.booleans(), cut_w=st.integers(0, 159),
       cut_h=st.integers(0, 159), mc=st.sampled_from((6, 4, 8)))
def test_grid_sweep(scratch, seed, rows, cols, tw, th, sub, rgba, prem,
                    cut_w, cut_h, mc):
    """Grids of 1-3 rows and columns of 64-160 sample tiles (even), at
    every subsampling, with an alpha grid (premultiplied or not) or
    none, cropped anywhere in the last row and column, through libyuv's
    matrix or a float one: read as PIL reads them."""
    tw, th = 2 * tw, 2 * th
    w = (cols - 1) * tw + 1 + cut_w % tw
    h = (rows - 1) * th + 1 + cut_h % th
    if sub != "4:0:0":
        w += w % 2
        h += h % 2 if sub == "4:2:0" else 0
    img = sample(np.random.default_rng(seed), rows * th, cols * tw,
                 4 if rgba else 3)
    tiles = ae.split_tiles(img, rows, cols, tw, th, subsampling=sub,
                           quality=50, speed=10,
                           alpha_premultiplied=rgba and prem)
    data = ae.set_nclx(ae.make_grid(tiles, rows, cols, w, h, alpha=rgba,
                                    prem=rgba and prem), mc=mc, full=1)
    got = assert_as_jax(scratch / "g.avif", data)
    assert got is not None and got.shape == (h, w, 4 if rgba else 3)


@functools.lru_cache(maxsize=None)
def _tiles(**kw):
    """Pillow's saves of a 216x160 RGBA sample as 2x3 tiles of 72x80 (or
    as kw says)."""
    kw = dict(kw)
    shape = kw.pop("shape", (2, 3, 72, 80))
    rgba = kw.pop("rgba", True)
    img = sample(np.random.default_rng(31), 160, 216, 4 if rgba else 3)
    return tuple(ae.split_tiles(img, *shape, quality=60, speed=10, **kw))


def _grid(**kw):
    tiles = list(_tiles())
    return ae.make_grid(tiles, 2, 3, kw.pop("width", 200),
                        kw.pop("height", 150), **kw)


def _tile_props(k: int, drop=(), add=()):
    props = [p for p in ae.item_properties(_tiles()[k])[1]
             if p[0] not in drop]
    return {k: props + list(add)}


def _grid_props(drop=(), add=()):
    props = [p for p in ae.item_properties(_tiles()[0])[1]
             if p[0] in (b"pixi", b"colr") and p[0] not in drop]
    return [ae.ispe(200, 150)] + props + list(add)


def _alpha_props(drop=(), add=()):
    props = [p for p in ae.item_properties(_tiles()[0])[2]
             if p[0] in (b"pixi", b"auxC") and p[0] not in drop]
    return [ae.ispe(200, 150)] + props + list(add)


PIXI_10 = (b"pixi", b"\0\0\0\0\x03\x0a\x0a\x0a", False)
UNKNOWN = (b"abcd", b"", True)


def _grid_reads():
    """Grid variants PIL reads, and what each shows: tiles in dimg order,
    colour from the grid item alone (no colr: the AV1 sequence header's),
    the grid's pixi optional and its plane count free, tiles' pixi and
    unknown non-essential properties ignored, an alpha grid without auxC
    or with an unsupported essential property ignored."""
    nclx4 = [(t, ae.set_nclx(b"colrnclx" + p[4:] if t == b"colr" else p,
                             mc=4)[4:] if t == b"colr" else p, e)
             for t, p, e in ae.item_properties(_tiles()[0])[1]]
    return {
        "dimg_order": _grid(dimg=[1, 0, 2, 5, 4, 3]),
        "flags_bit_1": _grid(payload=b"\0\2" + ae.grid_payload(
            2, 3, 200, 150)[2:]),
        "grid_no_colr": _grid(grid_props=_grid_props(drop=(b"colr",))),
        "grid_no_pixi": _grid(grid_props=_grid_props(drop=(b"pixi",))),
        "grid_pixi_2_planes": _grid(grid_props=_grid_props(
            drop=(b"pixi",), add=((b"pixi", b"\0" * 4 + b"\2\x08\x08",
                                   False),))),
        "tile_colr_ignored": _grid(tile_props={0: nclx4, 3: nclx4}),
        "tile_pixi_10": _grid(tile_props=_tile_props(
            3, drop=(b"pixi",), add=(PIXI_10,))),
        "tile_unknown_property": _grid(tile_props=_tile_props(
            1, add=((b"abcd", b"", False),))),
        "tiles_shown": _grid(hidden=False),
        "alpha_no_auxc": _grid(alpha=True, alpha_grid_props=_alpha_props(
            drop=(b"auxC",))),
        "alpha_essential_unknown": _grid(
            alpha=True, alpha_grid_props=_alpha_props(add=(UNKNOWN,))),
        "limited_range": ae.make_grid(list(_tiles(range="limited")), 2, 3,
                                      200, 150),
        "rgb_tiles_of_rgba": ae.make_grid(list(_tiles(rgba=False)), 2, 3,
                                          200, 150),
    }


def _grid_refusals():
    """libavif's grid refusals (PIL's RuntimeError "Invalid image grid"
    or "Missing or empty image item", or not identified), each from a
    one-field edit of a grid PIL reads."""
    big = ae.grid_payload
    return {
        "version_1": _grid(payload=big(2, 3, 200, 150, version=1)),
        "payload_short": _grid(payload=big(2, 3, 200, 150)[:7]),
        "payload_long": _grid(payload=big(2, 3, 200, 150) + b"\0"),
        "width_0": _grid(payload=big(2, 3, 0, 150)),
        "width_past_32768": _grid(payload=big(2, 3, 40000, 150, big=True)),
        "past_16384_squared": _grid(payload=big(2, 3, 20000, 20000,
                                                big=True)),
        "rows_past_tiles": _grid(payload=big(3, 3, 200, 150)),
        "dimg_fewer": _grid(dimg=[0, 1, 2, 3, 4]),
        "tile_type_hvc1": _grid(tile_types={2: b"hvc1"}),
        "tile_type_grid": _grid(tile_types={0: b"grid"}),
        "tile_essential_unknown": _grid(tile_props=_tile_props(
            1, add=(UNKNOWN,))),
        "first_tile_no_av1c": _grid(tile_props=_tile_props(
            0, drop=(b"av1C",))),
        "tile_no_av1c": _grid(tile_props=_tile_props(3, drop=(b"av1C",))),
        "tile_no_ispe": _grid(tile_props=_tile_props(3, drop=(b"ispe",))),
        "grid_no_ispe": _grid(grid_props=_grid_props()[1:]),
        "grid_pixi_10": _grid(grid_props=_grid_props(drop=(b"pixi",),
                                                     add=(PIXI_10,))),
        "grid_essential_unknown": _grid(grid_props=_grid_props(
            add=(UNKNOWN,))),
        "not_covered": _grid(payload=big(2, 3, 220, 150)),
        "last_column_outside": _grid(payload=big(2, 3, 144, 150)),
        "last_row_outside": _grid(payload=big(2, 3, 200, 80)),
        "odd_width_420": _grid(payload=big(2, 3, 199, 150)),
        "odd_height_420": _grid(payload=big(2, 3, 200, 149)),
        "tiles_under_64": ae.make_grid(list(_tiles(shape=(3, 4, 50, 50))),
                                       3, 4, 200, 150),
        "mismatched_range": ae.make_grid(
            list(_tiles()[:3] + _tiles(range="limited")[3:]), 2, 3, 200,
            150),
        "mismatched_size": ae.make_grid(
            list(_tiles()[:5] + _tiles(shape=(2, 3, 64, 80))[5:]), 2, 3,
            200, 150),
        "mismatched_subsampling": ae.make_grid(
            list(_tiles()[:3] + _tiles(subsampling="4:4:4")[3:]), 2, 3,
            200, 150),
        "mismatched_mono": ae.make_grid(
            list(_tiles()[:3] + _tiles(subsampling="4:0:0")[3:]), 2, 3,
            200, 150),
        "alpha_version_1": _grid(alpha=True, alpha_payload=big(
            2, 3, 200, 150, version=1)),
        "alpha_size_differs": _grid(alpha=True, alpha_payload=big(
            2, 3, 210, 150)),
        "alpha_no_ispe": _grid(alpha=True, alpha_grid_props=_alpha_props()[
            1:]),
    }


@pytest.mark.parametrize("case", sorted(_grid_reads()))
def test_grids_as_libavif_reads_them(scratch, case):
    """Grid variants libavif reads: the port reads each as PIL does."""
    assert assert_as_jax(scratch / f"{case}.avif",
                         _grid_reads()[case]) is not None


@pytest.mark.parametrize("case", sorted(_grid_refusals()))
def test_grid_refusals_as_libavifs(scratch, case):
    """Each of libavif's grid checks: PIL refuses the file, and the port
    raises ValueError where PIL raises, NotImplementedError where PIL
    cannot identify it."""
    assert assert_as_jax(scratch / f"{case}.avif",
                         _grid_refusals()[case]) is None


def test_grid_layout_is_checked_before_any_tile_is_decoded(scratch,
                                                           monkeypatch):
    """Flat 2048x2048 tiles, cheap in bytes, as a 2x2 grid over a 200x200
    output: PIL refuses it (the last row and column lie outside), and the
    port refuses it from the tiles' headers, decoding none of them."""
    tile = ae.pil_default(np.full((2048, 2048, 3), 90, np.uint8), speed=10)
    data = ae.make_grid([tile] * 4, 2, 2, 200, 200)
    assert assert_as_jax(scratch / "large.avif", data) is None

    def decode(*args):
        raise AssertionError("a tile was decoded")

    monkeypatch.setattr(avif, "_decode_av1", decode)
    with pytest.raises(ValueError, match="does not overlap"):
        image_io.read_ldr(str(scratch / "large.avif"))


def test_grid_ispe_and_tile_sizes(scratch):
    """A grid whose ispe differs from its output size (Pillow lays the
    grid's pixels out at the ispe's size) and tiles whose ispe differs
    from their frames (libavif scales each tile to its ispe with libyuv):
    PIL reads both, the port refuses them (ValueError)."""
    for data, match in (
            (_grid(grid_props=[ae.ispe(190, 150)] + _grid_props()[1:]),
             "the frame is 200x150, the item 190x150"),
            (_grid(tile_props={k: [ae.ispe(70, 80) if p[0] == b"ispe" else p
                                   for p in ae.item_properties(t)[1]]
                               for k, t in enumerate(_tiles())}),
             "its ispe 70x80")):
        path = scratch / "i.avif"
        path.write_bytes(data)
        assert jax_read_ldr(path).shape[2] == 3
        with pytest.raises(ValueError, match=match):
            image_io.read_ldr(str(path))


def test_grid_scene_textures_are_what_the_scene_needs():
    """The scene's albedo as a 3x3 grid of 384x384 tiles cropped to 1024
    (matrix 12 under primaries 12: the float routines) and its leaf as
    2x2 colour and alpha grids of 256x256 tiles (YCgCo at full range),
    whose alpha cuts about half the texels; the FCC albedo takes the
    float routines too."""
    for name, grid, nclx in ((ALBEDO_GRID, (3, 3, 384, 384), (12, 13, 12, 1)),
                             (LEAF_GRID, (2, 2, 256, 256), (1, 13, 8, 1)),
                             (ALBEDO_FCC, None, (1, 13, 4, 1))):
        data = open(os.path.join(FIXTURE_DIR, name), "rb").read()
        info = avif.frame_info(data, name, headers_only=True)
        assert info["grid"] == grid and avif._parse(data)[3] == nclx
    leaf = image_io.decode_ldr(os.path.join(FIXTURE_DIR, LEAF_GRID))
    assert leaf.shape == (512, 512, 4)
    assert 0.3 < (leaf[..., 3] == 0).mean() < 0.7
    assert isinstance(avif._parse(open(os.path.join(
        FIXTURE_DIR, LEAF_GRID), "rb").read())[1], avif._Grid)


def test_grid_avif_scene_compiles_as_jax(tmp_path):
    """The textured scene with its albedo and RGBA leaf as grid images
    (what chip_smoke.py renders on the card): the same leaves in both
    packages, bit for bit."""
    from test_torch_instanced import assert_same, jax_compile, jax_tree
    from tracerboy_tpu_torch.scene.compile import compile_scene
    from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex, lit = write_textured_scene(str(tmp_path), grid=8, sky=(16, 8),
                                    leaves=8, albedo=8, normal=8, leaf=8)
    retexture(tex, {"albedo.png": os.path.join(FIXTURE_DIR, ALBEDO_GRID),
                    "leaf.png": os.path.join(FIXTURE_DIR, LEAF_GRID)})
    got = compile_scene(parse_pbrt(lit))
    assert_same(jax_tree(jax_compile(lit)), got.as_numpy())
