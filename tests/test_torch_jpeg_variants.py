"""The JPEG variants PIL's encoder does not write, read by the port as PIL
reads them (core/jpeg.py, csrc/jpeg_decode.cpp): arithmetic coding
(sequential and progressive, DAC conditioning, statistics tables 0-15,
restarts), lossless frames (predictors 1-7, point transforms, sampling,
restarts) and progressive files cut after their first scans, which
libjpeg block-smooths. Files come from tests/jpeg_encode.py and from PIL
cut by make_jpeg_fixtures.drop_last_scans.

Every case is held bit for bit (np.array_equal) against the JAX package's
read_ldr, which reads through PIL, or where PIL raises, against PIL's
error class. The committed fixtures of tests/data/jpeg are checked to be
the variant their names say; hypothesis sweeps random images, sampling
factors, restart intervals, DAC values, predictors, point transforms and
cut points. Each place where libjpeg departs from the specification, or
is easy to lose, has a case of its own.
"""

import io
import json
import os
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from jpeg_encode import (
    arithmetic_image,
    encode_arithmetic,
    encode_lossless,
    image_blocks,
    quality_tables,
    simple_progression,
)
from make_jpeg_fixtures import FIXTURE_DIR, drop_last_scans, small_image
from tracerboy_tpu_torch.core import image_io
from tracerboy_tpu_torch.core.jpeg import decode_jpeg, frame_header

MANIFEST = json.load(open(os.path.join(FIXTURE_DIR, "manifest.json")))
S420 = [(2, 2), (1, 1), (1, 1)]
S444 = [(1, 1)] * 3


def jax_read_ldr(path):
    from tracerboy_tpu.core.image_io import read_ldr

    return read_ldr(path)


def assert_as_jax(data: bytes, tmp_path, name="v.jpg"):
    """The port's read_ldr of the file equals the JAX read_ldr's, or both
    raise (the port's error of the class PIL's has)."""
    path = os.path.join(tmp_path, name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        ref = jax_read_ldr(path)
    except OSError as e:
        with pytest.raises(OSError):
            image_io.read_ldr(path)
        return e
    got = image_io.read_ldr(path)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.array_equal(got, ref), (
        np.abs(got - ref).max() * 255, (got != ref).mean())
    return None


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def pil_bytes(img, **opts) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **opts)
    return b.getvalue()


def markers(data: bytes):
    """The marker codes of a file up to its first SOS."""
    out, pos = [], 2
    while True:
        code = data[pos + 1]
        out.append(code)
        if code == 0xDA:
            return out
        (n,) = struct.unpack_from(">H", data, pos + 2)
        pos += 2 + n


def test_huffman_and_arithmetic_coding_read_alike():
    """The same coefficients Huffman- and arithmetic-coded (every scan
    kind) decode to the same pixels in PIL and in the port."""
    img = small_image(3)
    q = quality_tables(75)
    blocks = image_blocks(img, S420, q)
    ref = pil_rgb(pil_bytes(img, quality=75, subsampling=2))
    H, W = img.shape[:2]
    huffman = decode_jpeg(encode_arithmetic(blocks, W, H, S420, q))
    for progressive in (False, True):
        data = encode_arithmetic(blocks, W, H, S420, q,
                                 progressive=progressive)
        assert np.array_equal(decode_jpeg(data), pil_rgb(data))
        assert np.array_equal(decode_jpeg(data), huffman)
    assert np.abs(huffman.astype(int) - ref).mean() < 3


# name -> (SOF code, what else the file must hold)
FIXTURE_KINDS = {
    "arith_grey.jpg": (0xC9, None), "arith_444.jpg": (0xC9, None),
    "arith_420.jpg": (0xC9, None), "arith_prog_420.jpg": (0xCA, None),
    "arith_prog_grey.jpg": (0xCA, None), "arith_cmyk.jpg": (0xC9, 0xEE),
    "arith_ycck_prog.jpg": (0xCA, 0xEE), "arith_dac.jpg": (0xC9, 0xCC),
    "arith_tables.jpg": (0xCA, 0xCC), "arith_restart.jpg": (0xC9, 0xDD),
    "arith_prog_restart.jpg": (0xCA, 0xDD),
    "smoothed_arith_k1.jpg": (0xCA, None),
    "smoothed_arith_k4.jpg": (0xCA, None),
    "albedo_1024_arith.jpg": (0xCA, None),
    **{f"lossless_p{p}.jpg": (0xC3, None) for p in range(1, 8)},
    **{f"smoothed_{k}.jpg": (0xC2, None)
       for k in ("k1", "k2", "k3", "k6", "grey_k2")},
}


@pytest.mark.parametrize("name", sorted(FIXTURE_KINDS))
def test_fixture_is_its_variant_and_reads_as_jax(name, tmp_path):
    with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
        data = f.read()
    sof, extra = FIXTURE_KINDS[name]
    codes = markers(data)
    assert sof in codes and (extra is None or extra in codes)
    if name.startswith("lossless_p"):     # the predictor is the name's
        sos = data.index(b"\xff\xda")
        ns = data[sos + 4]
        assert data[sos + 5 + 2 * ns] == int(name[10])
    if name.startswith("smoothed"):       # a scan short of the full file
        assert data.count(b"\xff\xda") < (6 if "grey" in name else 10)
    assert name in MANIFEST["files"]
    assert assert_as_jax(data, tmp_path) is None


@settings(max_examples=30, deadline=None, derandomize=True)
@given(w=st.integers(1, 70), h=st.integers(1, 70),
       sampling=st.sampled_from([[(1, 1)], [(2, 2)], S444, S420,
                                 [(2, 1), (1, 1), (1, 1)],
                                 [(1, 2), (1, 1), (1, 1)],
                                 [(1, 1), (2, 2), (1, 1)]]),
       quality=st.integers(5, 100), progressive=st.booleans(),
       restart=st.integers(0, 5),
       dac=st.dictionaries(st.integers(0, 31), st.integers(0, 255),
                           max_size=4),
       seed=st.integers(0, 2**31 - 1))
def test_arithmetic_sweep(w, h, sampling, quality, progressive, restart,
                          dac, seed, tmp_path_factory):
    """Random images, sampling factors, restart intervals and DAC values
    (a DC entry whose L exceeds its U is refused, as libjpeg refuses
    it)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(x / 4.0 + seed % 5),
                    128 + 90 * np.cos(y / 3.0), (x * 7 + y * 3) % 256], -1)
    img = np.clip(img + rng.normal(0, 25, img.shape), 0, 255).astype(
        np.uint8)
    nc = len(sampling)
    q = quality_tables(quality, nc)
    data = arithmetic_image(img if nc == 3 else img[..., 0], sampling, q,
                            progressive=progressive, restart=restart,
                            dac=dac)
    bad_dac = any(k < 16 and v & 15 > v >> 4 for k, v in dac.items())
    err = assert_as_jax(data, tmp_path_factory.mktemp("a"))
    assert (err is not None) == bad_dac


@settings(max_examples=30, deadline=None, derandomize=True)
@given(w=st.integers(1, 40), h=st.integers(1, 40),
       psv=st.integers(1, 7), pt=st.integers(0, 7),
       layout=st.sampled_from(["grey", "rgb", "420", "cmyk", "grey22"]),
       interleaved=st.booleans(), rows=st.integers(0, 3),
       seed=st.integers(0, 2**31 - 1))
def test_lossless_sweep(w, h, psv, pt, layout, interleaved, rows, seed,
                        tmp_path_factory):
    """Every predictor and point transform, sampling factors (replicated,
    not fancy-upsampled), a scan a component and restarts every `rows`
    MCU rows; PIL reads each sample back with its low pt bits clear."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.clip(np.stack([x * 6 + y, 255 - y * 5, (x * y) % 256, x + y],
                           -1) + rng.integers(-20, 20, (h, w, 4)), 0,
                  255).astype(np.uint8)
    sampling = {"grey": [(1, 1)], "rgb": S444, "420": S420,
                "cmyk": [(1, 1)] * 4, "grey22": [(2, 2)]}[layout]
    planes = [img[..., k] for k in range(len(sampling))]
    if layout == "420":
        planes[1:] = [img[::2, ::2, k] for k in (1, 2)]
    mpr = w if not interleaved or len(planes) == 1 else -(-w // 2) \
        if layout == "420" else w
    if not interleaved and layout == "420":
        rows = 0        # one interval fits the luma and chroma rows alike
    data = encode_lossless(planes, w, h, sampling, psv=psv, pt=pt,
                           restart=rows * mpr, interleaved=interleaved,
                           adobe=0 if layout == "cmyk" else None)
    assert assert_as_jax(data, tmp_path_factory.mktemp("l")) is None
    if layout in ("grey", "rgb"):
        want = (img[..., :len(planes)] >> pt) << pt
        got = decode_jpeg(data)
        assert np.array_equal(got[..., :len(planes)] if layout == "rgb"
                              else got[..., 0], want if layout == "rgb"
                              else want[..., 0])


@settings(max_examples=25, deadline=None, derandomize=True)
@given(w=st.integers(1, 90), h=st.integers(1, 90),
       subsampling=st.integers(0, 2), grey=st.booleans(),
       quality=st.integers(20, 95), keep=st.integers(1, 9),
       seed=st.integers(0, 2**31 - 1))
def test_cut_progressive_sweep(w, h, subsampling, grey, quality, keep,
                               seed, tmp_path_factory):
    """A PIL progressive file cut after `keep` scans: block smoothing at
    every cut, widths of 1-2 blocks and partial last iMCU rows among
    them."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.clip(np.stack([128 + 90 * np.sin(x / 5.0), 128 + 60 * np.cos(
        y / 4.0), (x * 5 + y * 3) % 256], -1) + rng.normal(0, 20, (h, w, 3)),
        0, 255).astype(np.uint8)
    data = pil_bytes(img[..., 0] if grey else img, quality=quality,
                     subsampling=subsampling, progressive=True)
    keep = min(keep, data.count(b"\xff\xda") - 1)
    assert assert_as_jax(drop_last_scans(data, keep),
                         tmp_path_factory.mktemp("c")) is None


@pytest.mark.parametrize("w,h,sampling", [
    (9, 40, [(1, 1)]),          # 2 blocks wide: the edge registers
    (16, 71, [(1, 2)]),         # 9 block rows of v = 2: the last iMCU row
    (28, 66, S420),             # both at once in the chroma
    (5, 18, [(2, 2)]),
])
def test_smoothing_edges(w, h, sampling, tmp_path):
    """decompress_smooth_data's sliding registers at a width of 2 blocks
    and its row index in a last iMCU row of fewer than v block rows, for
    the DC interpolation (DC scan only) and the AC estimates."""
    img = np.tile(small_image(11), (2, 1, 1))[:h, :w]
    nc = len(sampling)
    q = quality_tables(60, nc)
    blocks = image_blocks(img if nc == 3 else img[..., 1], sampling, q)
    for keep in (1, 2, 4):
        scans = (simple_progression(nc) if nc == 3 else
                 [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                  ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1)])[:keep]
        data = encode_arithmetic(blocks, w, h, sampling, q,
                                 progressive=True, scans=scans)
        assert assert_as_jax(data, tmp_path, f"s{keep}.jpg") is None


def test_arithmetic_overflow_stops_until_the_restart(tmp_path):
    """A refinement scan of coefficients 1-5, which no first scan sent,
    desyncs the coder until a magnitude or spectral overflow; libjpeg
    stops decoding blocks there (ct = -1) and starts again at the next
    restart, with a warning that PIL ignores."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:48, 0:40]
    img = np.clip(128 + 80 * np.sin(x / 3.0) + 60 * np.cos(y / 4.0)
                  + rng.normal(0, 30, (48, 40)), 0, 255).astype(np.uint8)
    q = [rng.integers(1, 40, 64)]
    blocks = image_blocks(img, [(1, 1)], q)
    script = [((0,), 0, 0, 0, 1), ((0,), 6, 63, 0, 2),
              ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0)]
    for restart in (0, 3):
        data = encode_arithmetic(blocks, 40, 48, [(1, 1)], q,
                                 progressive=True, scans=script,
                                 restart=restart)
        assert assert_as_jax(data, tmp_path, f"o{restart}.jpg") is None


def test_statistics_tables_are_shared_by_their_components(tmp_path):
    """Two components naming one statistics table share its bins within a
    scan; naming tables above 3 is legal in arithmetic coding."""
    img = small_image(13)
    q = quality_tables(70)
    for tables in ([(0, 0), (0, 0), (0, 0)], [(3, 7), (3, 7), (12, 1)]):
        data = arithmetic_image(img, S420, q, tables=tables,
                                dac={3: 0x31, 12: 0x00, 23: 1})
        assert assert_as_jax(data, tmp_path) is None


def test_lossless_restart_inside_an_imcu_row(tmp_path):
    """A restart that falls between the two sample rows of an iMCU row
    (a non-interleaved component of v = 2) resets the predictors at the
    iMCU row's first row, where libjpeg undifferences it; the file is
    written so and reads back exactly."""
    img = small_image(14)[:30, :20, 0]
    for rows in (1, 2, 3):
        data = encode_lossless([img], 20, 30, [(2, 2)], psv=6,
                               restart=20 * rows)
        assert assert_as_jax(data, tmp_path, f"r{rows}.jpg") is None
        assert np.array_equal(decode_jpeg(data)[..., 0], img)


@pytest.mark.parametrize("case", ["jfif", "adobe1", "ycck", "restart",
                                  "psv0", "pt8", "sof11"])
def test_lossless_refusals_match_pil(case, tmp_path):
    """libjpeg converts no colours in a lossless frame (YCbCr by JFIF or
    Adobe, YCCK), wants restarts at whole MCU rows and a predictor 1-7 and
    point transform below 8, and has no lossless arithmetic decoder: PIL
    raises OSError on each, and so does the port."""
    img = small_image(15)[:20, :24]
    planes = [img[..., k] for k in range(3)]
    kw = dict(jfif=dict(jfif=True), adobe1=dict(adobe=1),
              restart=dict(restart=25)).get(case, {})
    if case == "ycck":
        planes.append(img[..., 0])
        kw = dict(adobe=2)
    data = encode_lossless(planes, 24, 20, [(1, 1)] * len(planes), **kw)
    sos = data.index(b"\xff\xda") + 4 + 1 + 2 * len(planes)
    if case == "psv0":
        data = data[:sos] + b"\x00" + data[sos + 1:]
    elif case == "pt8":
        data = data[:sos + 2] + b"\x08" + data[sos + 3:]
    elif case == "sof11":
        data = data.replace(b"\xff\xc3", b"\xff\xcb", 1)
    assert isinstance(assert_as_jax(data, tmp_path), OSError)


def test_dnl_segment_is_skipped(tmp_path):
    """libjpeg skips a DNL segment in a frame of known height."""
    data = pil_bytes(small_image(16), quality=80)
    end = data.rindex(b"\xff\xd9")
    data = data[:end] + b"\xff\xdc\x00\x04\x00\x3d" + data[end:]
    assert assert_as_jax(data, tmp_path) is None
    assert frame_header(data)[1] == 61
