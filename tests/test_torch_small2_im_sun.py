"""The port's IM and Sun raster readers (core/im.py, core/sun.py,
core/rawformats.py, csrc/small_decode.cpp, through core/image_io.read_ldr)
against the JAX package's read_ldr, which reads them through PIL: equal
float32 images (np.array_equal, with and without gamma_to_linear) on every
IM and Sun fixture of tests/data/small2 (tests/make_small2_fixtures.py),
and on hypothesis sweeps of the header fields of small IM files (every
image type PIL's OPEN table names and a few it does not, sizes of one,
two and three numbers, a colour or grey Lut, the header ended by NUL or
0x1A, data cut short) and Sun rasters (every depth and file type, colour
maps of any length and type, raw rows and RLE streams of runs, escaped
0x80 bytes and runs across rows, data cut short). Where PIL refuses a
file the port raises: NotImplementedError where PIL cannot identify it,
ValueError where it raises otherwise.
"""

import json
import os
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import small_encode as se
from make_dds_fixtures import array_digest, pil_pixels
from make_small2_fixtures import FIXTURE_DIR
from test_torch_small_sgi_pcx import assert_as_jax, jax_read_ldr
from tracerboy_tpu_torch.core import image_io, im, sun

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)


def fixtures(*suffixes):
    return sorted(n for n in MANIFEST["files"] if n.endswith(suffixes))


@pytest.mark.parametrize("name", fixtures(".im", ".ras"))
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    got = assert_as_jax(path)
    assert got is not None, f"{name}: PIL refuses a fixture"
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


@pytest.mark.parametrize("name", fixtures(".im", ".ras"))
def test_manifest_matches_the_files(name):
    assert MANIFEST["files"][name] == array_digest(
        pil_pixels(os.path.join(FIXTURE_DIR, name)))


def test_fixtures_cover_the_readers():
    """Every IM mode PIL saves, the types it only reads, packed floats at
    both of BitDecode.c's bit-buffer paths; every Sun depth, both orders,
    colour maps, RLE at each depth."""
    names = set(MANIFEST["files"])
    for mode in ("1", "l", "la", "p", "pa", "i", "i16", "i16l", "i16b",
                 "f", "rgb", "rgba", "rgbx", "cmyk", "ycbcr", "rgb3", "x24",
                 "b2", "b4_colour_lut", "l_grey_lut", "lx5", "lx27"):
        assert f"im_{mode}.im" in names, mode
    for kind in ("1", "4", "4_cmap", "8", "8_cmap", "24_bgr", "24_rgb",
                 "32_bgrx", "32_rgbx", "rle_1", "rle_8", "rle_8_cmap",
                 "rle_24", "rle_32"):
        assert f"sun_{kind}.ras" in names, kind
    data = open(os.path.join(FIXTURE_DIR, "sun_rle_24.ras"), "rb").read()
    assert b"\x80\x00" in data[32:] and b"\x80\x17\x80" in data[32:]


@pytest.mark.parametrize("name", ("albedo.ras", "albedo_raw.ras",
                                  "albedo.im", "leaf.im"))
def test_writers_round_trip_through_pil(tmp_path, name):
    """write_sun (RLE and raw) and write_png to .im (RGB, RGBA) write what PIL
    reads back as the image written, and the port reads it the same."""
    rng = np.random.default_rng(len(name))
    img = (rng.integers(0, 4, (9, 12, 4 if "leaf" in name else 3))
           * 85).astype(np.uint8)
    img[2:4] = 0x80
    path = tmp_path / name
    if name.endswith(".ras"):
        sun.write_sun(str(path), img, rle="raw" not in name)
    else:
        image_io.write_png(str(path), img)
    assert np.array_equal(pil_pixels(str(path)), img)
    assert np.array_equal(image_io.decode_ldr(str(path)), img)


# ----------------------------------------------------------------------------
# Hypothesis sweeps

IM_TYPES = sorted(im.OPEN) + ["Foo image", "RGB", "L 64 image"]


@st.composite
def im_files(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    kind = draw(st.sampled_from(IM_TYPES + [None]))
    w, h = draw(st.integers(1, 9)), draw(st.integers(1, 6))
    size = draw(st.sampled_from([f"{w}*{h}", f"{w}*{h}", f"{w},{h}",
                                 f"{w}", f"{w}*{h}*2", f"{w}.5*{h}",
                                 f"0*{h}", f"{w}*x", f"-{w}*{h}"]))
    lines = [f"Image size (x*y): {size}"]
    if draw(st.booleans()):
        lines.append(draw(st.sampled_from(
            ["Comment: a", "Name: x.im", "File size (no of images): 2",
             "Scale (x,y): 1,2", "Other: 5", "bad line", "9: x",
             "Date: " + "x" * 99])))
    lut = None
    if draw(st.integers(0, 3)) == 0:
        lut = (bytes(range(256)) * 3 if draw(st.booleans())
               else rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    need = 4 * w * h * 4 + 768
    body = rng.integers(0, 256, need).astype(np.uint8).tobytes()
    cut = draw(st.sampled_from([len(body), len(body), 0, w * h // 2,
                                w * h + 3]))
    head = [f"Image type: {kind}"] if kind is not None else []
    text = "".join(f"{x}\r\n" for x in head + lines + (
        ["Lut: 1"] if lut is not None else [])).encode()
    end = draw(st.sampled_from([b"\0", b"\x1a", b"\0junk", b""]))
    data = text + end
    if end != b"":
        data = data.ljust(511, b"\0") + b"\x1a"
    return data + (lut or b"") + body[:cut]


@settings(max_examples=120, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=im_files())
def test_im_headers_read_or_refuse_as_pil(tmp_path, data):
    assert_as_jax(tmp_path / "x.im", data)


@st.composite
def sun_files(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    depth = draw(st.sampled_from([1, 4, 8, 24, 32, 16]))
    kind = draw(st.sampled_from([0, 1, 2, 2, 3, 4, 5, 6]))
    w, h = draw(st.integers(0, 11)), draw(st.integers(1, 7))
    map_len = draw(st.sampled_from([0, 0, 0, 6, 7, 48, 768, 770, 771, 1023,
                                    1025]))
    map_type = draw(st.sampled_from([1, 1, 2]))
    cmap = rng.integers(0, 256, map_len).astype(np.uint8).tobytes()
    rowbytes = (w * depth + 7) // 8
    if kind == 2:
        stream = rng.choice(np.array([0, 0x80, 7, 200], np.uint8),
                            rowbytes * h + 4).tobytes()
        body = se.sun_rle(stream, rng)
        if draw(st.booleans()):            # runs that cross rows
            body = bytes((0x80, int(rng.integers(1, 40)), 0x33)) + body
    else:
        body = rng.integers(0, 256, (rowbytes + 2) * h).astype(
            np.uint8).tobytes()
    body = body[:draw(st.sampled_from([len(body), len(body), len(body) // 2,
                                       max(0, len(body) - 1)]))]
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), kind,
                       map_type, map_len)
    return head[:draw(st.sampled_from([32, 32, 32, 20]))] + cmap + body


@settings(max_examples=120, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=sun_files())
def test_sun_headers_read_or_refuse_as_pil(tmp_path, data):
    assert_as_jax(tmp_path / "x.ras", data)


# ----------------------------------------------------------------------------
# Refusals


def _im_refusals():
    rows = bytes(range(48))
    return {
        "no_newline": b"Image type: L image" + bytes(200),
        "no_known_key": se.im(None, 4, 3, rows).replace(b"Image size (x*y)",
                                                        b"Image area (x*y)"),
        "no_1a": b"Image type: L image\r\nImage size (x*y): 4*3\r\n\0" +
                 bytes(50),
        "size_one_number": se.im("L image", 4, 3, rows).replace(b"4*3",
                                                                b"4"),
        "size_not_a_number": se.im("L image", 4, 3, rows).replace(b"4*3",
                                                                  b"4*q"),
        "size_float": se.im("L image", 4, 3, rows).replace(b"4*3", b"4*3.5"),
        "rlb": se.im("RLB image", 4, 3, rows),
        "pa_without_lut": se.im("PA image", 4, 3, rows),
        "unknown_type": se.im("Zebra image", 4, 3, rows),
        "lut_cut": se.im("Greyscale image", 4, 3, b"", lut=bytes(100)),
        "rows_cut": se.im("RGB image", 4, 3, rows[:30]),
        "packed_cut": se.im("L*12 image", 4, 3, rows[:10]),
        "line_too_long": se.im("L image", 4, 3, rows, ["Name: " + "n" * 99]),
    }


@pytest.mark.parametrize("case", sorted(_im_refusals()))
def test_im_refusals_match_pil(tmp_path, case):
    assert assert_as_jax(tmp_path / f"{case}.im", _im_refusals()[case]) \
        is None


def _sun_refusals():
    rows = bytes(range(40))
    return {
        "header_cut": se.sun(4, 2, 8, 1, rows)[:20],
        "depth_16": se.sun(4, 2, 16, 1, rows),
        "map_too_long": se.sun(4, 2, 8, 1, rows, bytes(1026)),
        "map_type_2": se.sun(4, 2, 8, 1, rows, bytes(6), map_type=2),
        "type_6": se.sun(4, 2, 8, 6, rows),
        "width_0": se.sun(0, 2, 8, 1, rows),
        "raw_cut": se.sun(4, 2, 24, 1, rows[:20]),
        "rle_cut": se.sun(4, 2, 24, 2, b"\x80\x05\x01"),
        "map_on_rgb": se.sun(4, 2, 24, 1, rows, bytes(6)),
        "map_257_entries": se.sun(4, 2, 8, 1, rows, bytes(771)),
    }


@pytest.mark.parametrize("case", sorted(_sun_refusals()))
def test_sun_refusals_match_pil(tmp_path, case):
    assert assert_as_jax(tmp_path / f"{case}.ras", _sun_refusals()[case]) \
        is None
