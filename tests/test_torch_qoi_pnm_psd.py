"""The port's QOI, PNM and PSD readers (core/qoi.py, core/pnm.py,
core/psd.py, through core/image_io.read_ldr) against the JAX package's
read_ldr, which reads them through PIL: every case must be equal bit for
bit (np.array_equal of read_ldr's float32, with and without
gamma_to_linear).

The committed fixtures of tests/data/webp that are not WebP are held
against the JAX read_ldr. Hypothesis sweeps random images through PIL's
QOI encoder, random QOI op streams (Pillow's index quirks), PNMs of every
header at random maxvals, plain or raw, with comments, and PSDs of every
colour mode PIL reads (Lab through LittleCMS among them), raw or
PackBits, with resources, a layer block and extra channels; truncated
files of each.
Where PIL refuses a file the port raises: ValueError where PIL raises
OSError, ValueError, EOFError, KeyError or IndexError,
NotImplementedError where PIL cannot identify it. The Lab transform is
PIL's on all 2^24 inputs. core/qoi.write_qoi writes PIL's bytes.
"""

import io
import os
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import psd_encode as pe
from test_torch_webp import MANIFEST, assert_as_jax, jax_read_ldr
from make_webp_fixtures import FIXTURE_DIR
from tracerboy_tpu_torch.core import image_io, pnm, psd, qoi

FIXTURES = sorted(n for n in MANIFEST["files"] if not n.endswith(".webp"))


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("qoi_pnm_psd")


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    got = image_io.read_ldr(path)
    assert got.dtype == np.float32
    assert np.array_equal(got, jax_read_ldr(path))
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


# ----------------------------------------------------------------------------
# QOI


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 40),
       h=st.integers(1, 30), rgba=st.booleans(), levels=st.integers(2, 256),
       cut=st.integers(0, 40))
def test_qoi_through_pils_encoder(scratch, seed, w, h, rgba, levels, cut):
    """Images of few or many levels (runs, index hits, DIFF and LUMA
    steps, RGB and RGBA ops) through PIL's encoder, whole or cut short;
    write_qoi writes PIL's bytes."""
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, levels, (h, w, 4)) * (255 // max(levels - 1, 1))
           ).astype(np.uint8)
    img[:h // 2, :w // 2] = img[0, 0]
    img = img if rgba else np.ascontiguousarray(img[..., :3])
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "QOI")
    data = buf.getvalue()
    qoi.write_qoi(str(scratch / "w.qoi"), img)
    assert (scratch / "w.qoi").read_bytes() == data
    got = assert_as_jax(scratch / "q.qoi", data[:len(data) - cut])
    assert (got is None) == (cut > 8)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(0, 9),
       h=st.integers(0, 9), channels=st.sampled_from([3, 4, 0, 7]),
       n=st.integers(0, 120))
def test_qoi_random_streams(scratch, seed, w, h, channels, n):
    """Random op streams: Pillow's index starts empty (an unset slot reads
    0, 0, 0, 0) and runs do not enter it; any channel count but 3 is
    RGBA; a zero size is not identified; a stream that ends early is
    refused."""
    rng = np.random.default_rng(seed)
    data = (b"qoif" + struct.pack(">II", w, h) + bytes([channels, 0])
            + rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    assert_as_jax(scratch / "r.qoi", data)


def test_qoi_header_cut_short(tmp_path):
    """Fewer than 13 header bytes: PIL's struct and index errors, which
    it reports as not identified."""
    for n in (4, 8, 12):
        assert assert_as_jax(tmp_path / "h.qoi",
                             b"qoif" + bytes(range(1, 9))[:n - 4]) is None


def test_qoi_index_quirk():
    """A first INDEX op of slot 53 (where the spec's decoder would have
    put the initial 0, 0, 0, 255) reads 0, 0, 0, 0 in Pillow."""
    data = (b"qoif" + struct.pack(">II", 2, 1) + bytes([4, 0])
            + bytes([0xC0, 53]))
    px = qoi.read_qoi(data)
    assert px.tolist() == [[[0, 0, 0, 255], [0, 0, 0, 0]]]


# ----------------------------------------------------------------------------
# PNM


@settings(max_examples=80, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       magic=st.sampled_from([b"P1", b"P2", b"P3", b"P4", b"P5", b"P6",
                              b"P0CMYK", b"PyP", b"PyRGBA", b"PyCMYK"]),
       maxval=st.sampled_from([1, 2, 3, 15, 100, 254, 255, 256, 300, 1000,
                               4095, 65534, 65535]),
       w=st.integers(1, 20), h=st.integers(1, 12), comments=st.booleans(),
       cut=st.sampled_from([0, 0, 0, 1, 5]))
def test_pnm_headers_and_maxvals(scratch, seed, magic, maxval, w, h,
                                 comments, cut):
    """Every PNM header at random maxvals, plain or raw, with comments;
    PIL's scaling (round half to even, 16-bit grey clipped at 255 by
    read_ldr's conversion) and its refusals of short data."""
    rng = np.random.default_rng(seed)
    bands = {b"P3": 3, b"P6": 3, b"P0CMYK": 4, b"PyRGBA": 4,
             b"PyCMYK": 4}.get(magic, 1)
    if magic in (b"P1", b"P4"):
        maxval = 1
    shape = (h, w, bands) if bands > 1 else (h, w)
    data = pe.pnm_file(magic, rng.integers(0, maxval + 1, shape), maxval,
                       comments=comments and magic not in (b"P4", b"P5",
                                                            b"P6"))
    assert_as_jax(scratch / "p.pnm", data[:len(data) - cut])


@pytest.mark.parametrize("data", [
    b"P6\n3 2\n255\n" + bytes(17), b"P6\n3 2\n0\n" + bytes(18),
    b"P6\n3 2\n65536\n", b"P6 3 2 255 " + bytes(18),
    b"P6\n3#c\n2\n255\n" + bytes(18), b"P6\n3 2\n25#c\n5\n" + bytes(18),
    b"P7\n3 2\n255\n", b"Px\n1 1\n", b"P6", b"P6\n",
    b"P6\n12345678901 1 255\n", b"P3\n2 1\n255\n1 2 3 4 5 -6",
    b"P3\n2 1\n255\n1 2 3 4 5 256", b"P3\n2 1\n255\n1 2 3 4 5",
    b"P3\n2 1\n255\n1 2 3 4 5 6 xx",
    b"P3\n2 1\n255\n1 2 3 4 5 6 1234567890123",
    b"P2\n2 1\n255\n1 2 123456789012", b"P1\n3 1\n0 1 2",
    b"P1\n3 1\n0 1 0 2", b"Pf\n2 1\n0\n" + bytes(8),
    b"Pf\n2 1\nnan\n" + bytes(8), b"Pf\n2 1\n1\n" + bytes(7),
    b"P5\n2 2\n255\n\x01\x02\x03", b"P5\n2 2\n300\n" + bytes(7),
    b"P5\n0 2\n255\n", b"P5\n2 -1\n255\n", b"P2\n2 1\n+3\n1 2",
    b"P2\n2 1\n1_0\n1 2", b"P2\n2 1\n255\n1#x\n2", b"P1\n2 1\n0#\n1",
    b"Py\n1 1\n255\n\0", b"P0CMYK 1 1 255 abcd"],
    ids=lambda d: repr(d[:24]))
def test_pnm_header_quirks(tmp_path, data):
    """PIL's reading of headers and data: comments anywhere (a token
    continues after one), Python's int() and float() on tokens, tokens of
    at most 10 bytes, and each of its refusals."""
    assert_as_jax(tmp_path / "q.pnm", data)


@pytest.mark.parametrize("scale", [1.0, -1.0, 0.5, -3.25])
def test_pf_float_grey(tmp_path, scale):
    """Pf: big-endian floats when the scale is positive, little-endian
    when negative, rows bottom to top; read_ldr clips and truncates, NaN
    to 0 (the file is named .bin: read_texture sends .pfm to read_pfm)."""
    rng = np.random.default_rng(15)
    v = (rng.standard_normal((5, 7)) * 200 + 80).astype(np.float32)
    v[0, :3] = [np.nan, np.inf, -np.inf]
    got = assert_as_jax(tmp_path / "f.bin", pe.pnm_file(b"Pf", v,
                                                        scale=scale))
    assert got is not None and got.shape == (5, 7, 3)


def test_pnm_16_bit_grey_clips_at_255(tmp_path):
    """A 16-bit raw grey file opens as mode I through I;16B and read_ldr's
    conversion clips it: 300 is white."""
    data = pe.pnm_file(b"P5", np.array([[0, 254, 255, 300, 65535]]), 65535)
    (tmp_path / "g.pgm").write_bytes(data)
    assert image_io.decode_ldr(str(tmp_path / "g.pgm"))[0, :, 0].tolist() \
        == [0, 254, 255, 255, 255]
    assert pnm.decode_pnm(data)[1] == "I"


# ----------------------------------------------------------------------------
# PSD

PSD_MODES = [(0, 1, 1), (1, 8, 1), (1, 8, 2), (2, 8, 1), (3, 8, 3),
             (3, 8, 4), (3, 8, 5), (4, 8, 4), (4, 8, 5), (7, 8, 3),
             (8, 8, 1), (9, 8, 3), (9, 8, 4), (9, 8, 5)]


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), mode=st.sampled_from(PSD_MODES),
       compression=st.sampled_from([0, 1]), w=st.integers(1, 30),
       h=st.integers(1, 12), resources=st.booleans(),
       layer=st.booleans(), cut=st.sampled_from([0, 0, 0, 1, 7, 60]))
def test_psd_modes(scratch, seed, mode, compression, w, h, resources,
                   layer, cut):
    """Every (colour mode, depth) PIL reads, Lab among them, raw or
    PackBits, with resources and a layer block to skip, more channels
    than PIL reads (PackBits then reads PIL's misplaced offsets), whole
    or cut short."""
    cmode, bits, channels = mode
    rng = np.random.default_rng(seed)
    rowbytes = (w + 7) // 8 if bits == 1 else w
    planes = rng.integers(0, 256, (channels, h, rowbytes), dtype=np.uint8)
    planes[:, h // 2:, :rowbytes // 2] = 3
    colours = (rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
               if cmode == 2 else b"")
    data = pe.psd_file(planes, cmode, bits, compression,
                       colour_data=colours,
                       resources=([(1005, b"abc", bytes(7)),
                                   (1039, b"", b"xy")] if resources else ()),
                       layer_block=bytes(9) if layer else b"")
    assert_as_jax(scratch / "s.psd", data[:len(data) - cut])


def _psd_cases():
    rng = np.random.default_rng(16)
    plane = rng.integers(0, 256, (1, 4, 6), dtype=np.uint8)
    rgb = rng.integers(0, 256, (3, 4, 6), dtype=np.uint8)
    version2 = bytearray(pe.psd_file(plane, 1))
    version2[5] = 2
    return {
        "packets_cross_rows": pe.psd_file(
            plane, 1, compression=1,
            rows=[[bytes([257 - 10, 9]), bytes([2, 1, 2, 3]),
                   bytes([0x80, 1, 5, 6]), bytes([5, 1, 2, 3, 4, 5, 6])]]),
        "packets_short": pe.psd_file(plane, 1, compression=1,
                                     rows=[[bytes([257 - 3, 9])] * 4]),
        "zip_compression": pe.psd_file(plane, 1, compression=2),
        "version_2": bytes(version2),
        "depth_16": pe.psd_file(rgb, 3, bits=16),
        "depth_32": pe.psd_file(plane, 1, bits=32),
        "unknown_mode": pe.psd_file(rgb, 5),
        "too_few_channels": pe.psd_file(rgb[:2], 3),
        "palette_without_table": pe.psd_file(plane, 2),
        "palette_short_table": pe.psd_file(plane, 2, colour_data=bytes(700)),
        "zero_height": pe.psd_file(np.zeros((1, 0, 6), np.uint8), 1),
        "header_only": pe.psd_file(plane, 1)[:20],
        "resources_cut": pe.psd_file(plane, 1, resources=[(1, b"n", bytes(
            40))])[:50],
        "counts_cut": pe.psd_file(rgb, 3, compression=1)[:40],
    }


@pytest.mark.parametrize("case", sorted(_psd_cases()))
def test_psd_quirks_and_refusals(tmp_path, case):
    """Pillow's PackBits decoder cuts a packet at its row's end and needs
    the data to last the image; compression 2 and 3 cannot load; version
    2 (PSB), 16- and 32-bit and unknown modes are not identified; a
    palette without its 768 bytes is black."""
    assert_as_jax(tmp_path / "q.psd", _psd_cases()[case])


def test_lab_psd_names_item_22b(tmp_path):
    """A Lab PSD, which PIL converts through LittleCMS (to RGBA: the JAX
    read_ldr sees an "A" in "LAB"), decodes (core/psd.decode_psd) to the
    file's planes, and read_ldr reads it as the JAX read_ldr reads it,
    alpha 0 included (Pillow copies the LAB image's extra byte, which its
    PSD band unpackers leave at 0, into the alpha)."""
    planes = np.random.default_rng(17).integers(0, 256, (3, 5, 7),
                                                dtype=np.uint8)
    path = tmp_path / "lab.psd"
    path.write_bytes(pe.psd_file(planes, 9))
    assert jax_read_ldr(path).shape == (5, 7, 4)
    img, mode, _ = psd.decode_psd(path.read_bytes())
    assert mode == "LAB" and np.array_equal(np.moveaxis(img, -1, 0), planes)
    assert assert_as_jax(path, path.read_bytes()) is not None
    assert not image_io.read_ldr(str(path))[..., 3].any()
    assert np.array_equal(image_io.read_ldr(str(path), gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


def test_lab_transform_is_pils_on_every_input(tmp_path):
    """All 2^24 (L, a, b) bytes as one 4096x4096 Lab PSD: the port's RGBA
    is PIL's convert("RGBA") (LittleCMS 2.17's Lab to sRGB transform with
    its 8-bit optimisation) on every input."""
    v = np.arange(1 << 24, dtype=np.uint32)
    planes = np.stack([v >> 16, v >> 8 & 255, v & 255]).astype(
        np.uint8).reshape(3, 4096, 4096)
    data = pe.psd_file(planes, 9)
    del v, planes
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert np.array_equal(psd.read_psd(data), ref)


def test_formats_are_known_by_their_headers(tmp_path):
    """A PNM, a PSD and a QOI named .png read by content, in PIL's order
    (PNM among its preinit plugins); a 'P' file PIL's PNM table lacks is
    not identified."""
    for name in ("pil_rgb.ppm", "rgb_rle.psd", "pil_rgba.qoi"):
        data = open(os.path.join(FIXTURE_DIR, name), "rb").read()
        (tmp_path / "x.png").write_bytes(data)
        assert np.array_equal(image_io.read_ldr(str(tmp_path / "x.png")),
                              jax_read_ldr(tmp_path / "x.png"))
    assert pnm.is_pnm(b"Py") and not pnm.is_pnm(b"P7") and psd.is_psd(
        b"8BPS") and qoi.is_qoi(b"qoif")
    assert assert_as_jax(tmp_path / "y.png", b"PyX 1 1 255\n\0") is None
