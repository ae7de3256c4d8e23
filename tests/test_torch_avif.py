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
that need what the port still leaves out (the matrices libavif converts
in floating point, say) raise NotImplementedError naming ROADMAP item
22b, AVIF part 2. The AV1 tables in csrc/av1_tables.inc equal those of
the libraries present (tests/make_av1_tables.py --check). PBRT scenes
whose albedo is an AVIF and whose leaf an RGBA AVIF compile in both
packages to the same leaves, bit for bit.
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

import avif_encode as ae
from make_avif_fixtures import (
    ALBEDO,
    ALBEDO_DEFAULT,
    ALBEDO_LOSSLESS,
    ALBEDO_PLAIN,
    FIXTURE_DIR,
    LEAF,
    LEAF_DEFAULT,
    LEAF_GRAIN,
    SCREEN,
    TOOLS_OFF,
    copy_or_grain,
    filtered,
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
    part1 = [name for name in FIXTURES
             if not filtered(name) and not copy_or_grain(name)]
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
            assert info["intrabc"] == info["grain"] == set(), name
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
    """Files PIL reads whose features the port still leaves to part 2."""
    img = sample(np.random.default_rng(7), 64, 64)
    return {
        "matrix_fcc": ae.set_nclx(ae.pil_avif(img), mc=4),
        "matrix_ycgco": ae.set_nclx(ae.pil_avif(img), mc=8, full=1),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_refused_features_name_avif_part_2(tmp_path, case):
    """Matrix coefficients libavif converts in its own float path: PIL
    reads each file, the port raises NotImplementedError naming ROADMAP
    item 22b, AVIF part 2."""
    data = _refused()[case]
    path = tmp_path / "r.avif"
    path.write_bytes(data)
    assert jax_read_ldr(path).shape[:2] in ((64, 64), (128, 160))
    with pytest.raises(NotImplementedError, match=ITEM):
        image_io.read_ldr(str(path))


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
    dav1d adds)."""
    rng = np.random.default_rng(seed)

    def points(most):
        n = int(rng.integers(0, most + 1))
        xs = np.sort(rng.choice(256, n, replace=False))
        return [(int(x), int(y)) for x, y in zip(xs, rng.integers(0, 256, n))]

    y_pts, cb_pts, cr_pts = points(14), points(10), points(10)
    if sub == "4:2:0" and bool(cb_pts) != bool(cr_pts):
        cr_pts = cb_pts                 # dav1d refuses one without the other
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
    assert assert_as_jax(scratch / "g.avif", data) is not None


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
