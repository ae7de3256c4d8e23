"""The port's 4-component JPEG reading (core/jpeg.py, csrc/jpeg_decode.cpp;
core/blp.py for a BLP1 texture's JPEG) against the JAX package's
read_ldr, which reads them through PIL: equal float32 images on every
CMYK, YCCK and BLP1 fixture of tests/data/small3
(tests/make_small3_fixtures.py), and on hypothesis sweeps of PIL's CMYK
saves (quality, progressive, optimised tables) and of 4-component
coefficient files (tests/jpeg_encode.py: sampling factors, restart
intervals, no Adobe marker or transforms 0, 1, 2 and others, a JFIF
marker or none), plain and inside a BLP1. libjpeg reads a 4-component
file as CMYK without an Adobe marker or under transform 0 and as YCCK
under any other (ycck_cmyk_convert), and PIL's CMYK;I raw mode inverts
the samples before read_ldr's convert; a BLP1's JPEG is read as CMYK
whatever its marker says. A 4-sample JPEG inside a TIFF stays refused
(ROADMAP item 22c).
"""

import io
import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import jpeg_encode as je
import small_encode as se
from make_dds_fixtures import array_digest, pil_pixels
from make_small3_fixtures import FIXTURE_DIR
from make_small_fixtures import texture
from test_torch_small_sgi_pcx import assert_as_jax, jax_read_ldr
from tracerboy_tpu_torch.core import image_io
from tracerboy_tpu_torch.core.jpeg import decode_jpeg

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
FIXTURES = sorted(n for n in MANIFEST["files"]
                  if n.startswith(("cmyk_", "ycck_", "blp1_", "albedo_")))


def sweep(n: int):
    return settings(max_examples=n, deadline=None, suppress_health_check=[
        HealthCheck.function_scoped_fixture])


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    got = assert_as_jax(path)
    assert got is not None, f"{name}: PIL refuses a fixture"
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


@pytest.mark.parametrize("name", FIXTURES)
def test_manifest_matches_the_files(name):
    assert MANIFEST["files"][name] == array_digest(
        pil_pixels(os.path.join(FIXTURE_DIR, name)))


def test_fixtures_cover_the_colour_spaces():
    """CMYK without an Adobe marker and under transform 0, YCCK under 1
    and 2, subsampled components, restarts, progressive, BLP1 of CMYK
    and YCCK, and the card's BLP1 albedo (1024x1024, no alpha)."""
    assert {"cmyk_pil.jpg", "cmyk_pil_progressive.jpg", "cmyk_no_adobe.jpg",
            "cmyk_adobe0_subsampled.jpg", "ycck_adobe2.jpg",
            "ycck_adobe1_subsampled.jpg", "ycck_restart.jpg",
            "blp1_cmyk.blp", "blp1_ycck_alpha.blp",
            "albedo_blp1_cmyk.blp"} <= set(FIXTURES)
    assert MANIFEST["files"]["albedo_blp1_cmyk.blp"]["shape"] == [1024,
                                                                  1024, 3]


def test_albedo_blp1_reads_as_the_albedo():
    """The card's BLP1-CMYK albedo is written in BLP's BGR order, so PIL
    (and the port) read it as the scene's albedo, within the JPEG's loss
    at quality 75, not with red and blue swapped."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.utils.demo_scene import (
        SMALL3_ALBEDO,
        albedo_image,
    )

    got = image_io.decode_ldr(SMALL3_ALBEDO).astype(np.int32)
    want = _to_uint8(albedo_image(1024)).astype(np.int32)
    assert np.abs(got - want).mean(axis=(0, 1)).max() < 3
    assert np.abs(got - want[..., ::-1]).mean(axis=(0, 1)).max() > 10


def test_ycck_is_not_read_as_cmyk_outside_a_blp1(tmp_path):
    """The same YCCK stream reads differently plain (converted to CMYK by
    libjpeg) and inside a BLP1 (PIL forces its colour space to CMYK), and
    the port reads each as PIL does."""
    img = texture(np.random.default_rng(4), 8, 8, 4)
    stream = je.encode_image(img, [(1, 1)] * 4, [np.full(64, 2)] * 4,
                             jfif=False, adobe=2)
    plain = assert_as_jax(tmp_path / "y.jpg", stream)
    blp = assert_as_jax(tmp_path / "y.blp", se.blp1_jpeg(stream, 8, 8))
    assert plain is not None and blp is not None
    assert not np.array_equal(plain, blp[..., ::-1])


# ----------------------------------------------------------------------------
# Sweeps


@st.composite
def pil_cmyk_saves(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    w, h = draw(st.integers(1, 40)), draw(st.integers(1, 30))
    img = Image.fromarray(texture(rng, h, w, 4), "CMYK")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=draw(st.sampled_from([20, 75, 95])),
             progressive=draw(st.booleans()), optimize=draw(st.booleans()))
    return buf.getvalue()


@sweep(40)
@given(data=pil_cmyk_saves())
def test_pil_cmyk_saves_read_as_pil(data):
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(decode_jpeg(data), ref)


SAMPLING = [(1, 1), (2, 1), (1, 2), (2, 2)]


@st.composite
def four_component_files(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    w, h = draw(st.integers(1, 33)), draw(st.integers(1, 25))
    sampling = [draw(st.sampled_from(SAMPLING)) for _ in range(4)]
    if sum(a * b for a, b in sampling) > 10:     # libjpeg's MCU limit
        sampling[1:] = [(1, 1)] * 3
    q = [rng.integers(1, 12, 64) for _ in range(4)]
    adobe = draw(st.sampled_from([None, 0, 1, 2, 7]))
    img = texture(rng, h, w, 4)
    return je.encode_image(img, sampling, q, jfif=draw(st.booleans()),
                           adobe=adobe, restart=draw(st.sampled_from(
                               [0, 0, 1, 3])))


@sweep(40)
@given(data=four_component_files(), blp=st.booleans())
def test_four_component_files_read_as_pil(tmp_path, data, blp):
    if blp:
        from tracerboy_tpu_torch.core.jpeg import frame_header

        _, h, w, _ = frame_header(data)
        assert assert_as_jax(tmp_path / "f.blp", se.blp1_jpeg(
            data, w, h)) is not None
    else:
        assert assert_as_jax(tmp_path / "f.jpg", data) is not None


def test_tiff_four_sample_jpeg_stays_item_22c(tmp_path):
    """A JPEG-in-TIFF strip of 4 components (CMYK): PIL reads it through
    libtiff; the port refuses it, naming ROADMAP item 22c."""
    from tiff_encode import tiff_file

    img = texture(np.random.default_rng(9), 8, 8, 4)
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=90)
    path = tmp_path / "c.tif"
    path.write_bytes(tiff_file(img, bits=8, photometric=5, compression=7,
                               segments=[buf.getvalue()]))
    assert jax_read_ldr(path).shape == (8, 8, 3)
    with pytest.raises(NotImplementedError, match="item 22c"):
        image_io.read_ldr(str(path))


def test_radiance_peaks_summary():
    """utils/radiance_peaks.peaks, which reports how close the BLP1-CMYK
    albedo run's fireflies come to the half-float EXR's range: samples
    past 65,504 and the pixels past 100 and 1,000, in row-major order."""
    from tracerboy_tpu_torch.utils.radiance_peaks import peaks

    rad = np.zeros((4, 5, 3), np.float32)
    rad[1, 2] = (10.0, 70000.0, 3.0)
    rad[3, 0] = (500.0, 1.0, 2.0)
    got = peaks(rad)
    assert got["finite"] and got["max"] == 70000.0
    assert (got["over_half"], got["over_1000"], got["over_100"]) == (1, 1, 2)
    assert got["where"] == [[1, 2], [3, 0]]
    assert got["values"][1] == [500.0, 1.0, 2.0]
