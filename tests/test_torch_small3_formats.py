"""The port's FITS, FLI, IPTC and PCD readers (core/fits.py, core/fli.py,
core/iptc.py, core/pcd.py, csrc/small_decode.cpp, through
core/image_io.read_ldr) against the JAX package's read_ldr, which reads
them through PIL: equal float32 images (np.array_equal, with and without
gamma_to_linear) on every such fixture of tests/data/small3
(tests/make_small3_fixtures.py), on hypothesis sweeps of FITS headers
and data, FLI chunk streams and IPTC records, on PCD files of every
orientation, and on each reader's refusals; the PhotoYCC tables against
PIL's YCC;P unpacker on all 2^24 inputs; the textures
utils/demo_scene.write_small3_textures writes decode to the manifest's
(PIL's) digests. Where PIL refuses a file the port raises:
NotImplementedError where PIL cannot identify it, ValueError where it
raises otherwise.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import small_encode as se
from make_dds_fixtures import array_digest, pil_pixels
from make_small3_fixtures import FIXTURE_DIR
from test_torch_small_sgi_pcx import PIL_ERRORS, assert_as_jax, jax_read_ldr
from tracerboy_tpu_torch.core import image_io, pcd

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
SUFFIXES = (".fits", ".fli", ".flc", ".iim")


def sweep(n: int):
    return settings(max_examples=n, deadline=None, suppress_health_check=[
        HealthCheck.function_scoped_fixture])


def fixtures(*suffixes):
    return sorted(n for n in MANIFEST["files"] if n.endswith(suffixes))


@pytest.mark.parametrize("name", fixtures(*SUFFIXES))
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    got = assert_as_jax(path)
    assert got is not None, f"{name}: PIL refuses a fixture"
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


@pytest.mark.parametrize("name", fixtures(*SUFFIXES))
def test_manifest_matches_the_files(name):
    assert MANIFEST["files"][name] == array_digest(
        pil_pixels(os.path.join(FIXTURE_DIR, name)))


def test_fixtures_cover_the_readers():
    names = set(MANIFEST["files"])
    assert {"fits_8.fits", "fits_16_bzero.fits", "fits_32.fits",
            "fits_f32.fits", "fits_f64.fits", "fits_naxis1.fits",
            "fits_extension.fits", "fits_short_data.fits",
            "fits_gzip_8.fits", "fits_gzip_16.fits", "fits_gzip_32.fits",
            "fli_brun.flc", "fli_copy.fli", "fli_lc.flc", "fli_ss2.flc",
            "fli_black_pstamp.flc", "fli_no_palette.flc",
            "fli_two_frames.flc", "iptc_raw_l.iim", "iptc_raw_rgb_band.iim",
            "iptc_raw_cmyk_band.iim", "iptc_jpeg_l.iim",
            "iptc_jpeg_band.iim", "iptc_png_rgb.iim",
            "iptc_extended.iim"} <= names
    assert {"albedo.fli", "albedo.pcd", "albedo.fits", "albedo_gzip.fits",
            "albedo.iptc"} == set(MANIFEST["generated"])


def test_written_textures_match_the_manifest(tmp_path):
    """write_small3_textures' files: the bytes the manifest names (not
    for the gzip FITS, whose bytes are zlib's) and PIL's pixels, which
    the port's readers give too."""
    from tracerboy_tpu_torch.utils.demo_scene import write_small3_textures

    for name, path in write_small3_textures(str(tmp_path)).items():
        entry = dict(MANIFEST["generated"][name])
        with open(path, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        if name != "albedo_gzip.fits":
            assert sha == entry["file_sha256"], name
        entry.pop("file_sha256")
        assert array_digest(image_io.decode_ldr(path)) == entry, name


# ----------------------------------------------------------------------------
# FITS sweep


@st.composite
def fits_files(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    bits = draw(st.sampled_from([8, 16, 32, -32, -64, 64]))
    naxis = draw(st.sampled_from([2, 2, 2, 1, 0, 3]))
    w, h = draw(st.integers(0, 6)), draw(st.integers(1, 5))
    cards = [("SIMPLE", draw(st.sampled_from(["T", "T", "T", "F"]))),
             ("BITPIX", bits), ("NAXIS", naxis), ("NAXIS1", w),
             ("NAXIS2", h)]
    if draw(st.integers(0, 9)) == 0:
        del cards[int(rng.integers(1, len(cards)))]        # a key missing
    if draw(st.booleans()):
        cards += [("BZERO", 32768), ("BSCALE", 2)]
    if draw(st.integers(0, 9)) == 0:
        cards[1] = ("BITPIX", b"8.0")                     # int() refuses
    if draw(st.integers(0, 9)) == 0:
        cards.insert(1, se.fits_card("COMMENT"))
    size = max(w, 1) * (h if naxis != 1 else 1) * abs(bits) // 8
    n = max(0, size + draw(st.sampled_from([0, 0, 0, -1, 3, -size])))
    data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    kind = draw(st.sampled_from(["raw", "raw", "gzip", "extension"]))
    if kind == "raw":
        return se.fits([(cards, data)], pad=draw(st.booleans()))
    if kind == "extension":
        return se.fits([([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)],
                         b""), ([("XTENSION", b"'IMAGE   '")] + cards[1:],
                                data)], pad=draw(st.booleans()))
    zcards = [("Z" + c[0], c[1]) for c in cards[1:] if isinstance(c, tuple)]
    words = rng.integers(0, 256, 4 * max(w, 1) * h + draw(
        st.sampled_from([0, 0, -4, -1, 8]))).astype(np.uint8).tobytes()
    heap = se.gzip_bytes(words)
    if draw(st.integers(0, 9)) == 0:
        heap = heap[:len(heap) // 2]                      # gzip cut short
    table = struct.pack(">ii", len(heap), 0)
    ext = [("XTENSION", b"'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
           ("NAXIS1", 8), ("NAXIS2", 1), ("ZIMAGE", "T"),
           ("ZCMPTYPE", draw(st.sampled_from([b"'GZIP_1  '",
                                              b"'RICE_1  '"])))] + zcards
    return se.fits([([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)], b""),
                    (ext, table + heap)])


@sweep(150)
@given(data=fits_files())
def test_fits_files_read_or_refuse_as_pil(tmp_path, data):
    assert_as_jax(tmp_path / "x.fits", data)


# ----------------------------------------------------------------------------
# FLI sweep


def _packets(rng, w, words=False):
    """Random LC (bytes) or SS2 (words) packets of a line, some past its
    end."""
    out = []
    for _ in range(int(rng.integers(0, 4))):
        skip = int(rng.integers(0, w + 1))
        n = int(rng.integers(1, w // 2 + 2))
        if rng.random() < 0.5:
            body = rng.integers(0, 256, 2 * n if words else n)
            out.append((skip, body.astype(np.uint8).tobytes()))
        else:
            value = rng.integers(0, 256, 2 if words else 1).astype(np.uint8)
            out.append((skip, n, value.tobytes() if words else int(
                value[0])))
    return out


def _fli_chunk(kind, w, h, rng):
    if kind in (4, 11):
        packets = []
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.choice([1, 5, 40, 40, 256]))
            extra = int(rng.integers(0, 3)) if rng.random() < 0.1 else 0
            skip = 0 if n == 256 else int(rng.integers(0, 120))
            packets.append((skip, rng.integers(0, 256, 3 * n + extra)
                            .astype(np.uint8).tobytes()))
        return se.fli_colour(packets)
    if kind == 7:
        lines = []
        for _ in range(int(rng.integers(0, h + 2))):
            flags = [int(f) for f in rng.choice(
                [0xFFFF, 0xFFFE, 0x8000 | 0x5A, 0xC000], int(rng.integers(
                    0, 3)), p=[0.4, 0.2, 0.35, 0.05])]
            lines.append((flags, _packets(rng, w, True)))
        return se.fli_ss2(lines)
    if kind == 12:
        return se.fli_lc(int(rng.integers(0, h + 1)), [
            _packets(rng, w) for _ in range(int(rng.integers(0, h + 2)))])
    if kind == 13:
        return b""
    if kind == 15:
        idx = (rng.integers(0, 3, (h, w)) * 40).astype(np.uint8)
        return se.fli_brun(idx, rng)
    if kind == 16:
        return rng.integers(0, 256, w * h).astype(np.uint8).tobytes()
    return rng.integers(0, 256, int(rng.integers(0, 12))).astype(
        np.uint8).tobytes()


@st.composite
def fli_files(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    w, h = draw(st.integers(1, 12)), draw(st.integers(1, 7))
    kinds = draw(st.lists(st.sampled_from([4, 11, 7, 12, 13, 15, 16, 18,
                                           99]), max_size=4))
    chunks = []
    for kind in kinds:
        body = _fli_chunk(kind, w, h, rng)
        if draw(st.integers(0, 7)) == 0:
            body = body[:int(rng.integers(0, len(body) + 1))]
        size = draw(st.sampled_from([None] * 8 + [0, 3, 1 << 20]))
        chunks.append(se.fli_chunk(kind, body, size))
    frame = se.fli_frame(chunks, size=draw(st.sampled_from(
        [None] * 6 + [0, 10, 1 << 31])), magic=draw(st.sampled_from(
            [0xF1FA] * 9 + [0xF100])))
    prefix = b""
    if draw(st.integers(0, 7)) == 0:
        prefix = se.fli_chunk(0xF100, bytes(10))
        prefix = prefix[:4] + struct.pack("<H", 0xF100) + prefix[6:]
    data = se.fli(w, h, [frame], magic=draw(st.sampled_from([0xAF11,
                                                             0xAF12])),
                  flags=draw(st.sampled_from([0, 3])), prefix=prefix)
    if draw(st.integers(0, 7)) == 0:
        data = data[:int(rng.integers(100, len(data) + 1))]
    return data


@sweep(200)
@given(data=fli_files())
def test_fli_chunk_streams_read_or_refuse_as_pil(tmp_path, data):
    assert_as_jax(tmp_path / "x.flc", data)


# ----------------------------------------------------------------------------
# IPTC sweep


def _inner(kind, w, h, rng):
    """An inner file of `kind` near w x h pixels, and its size."""
    if kind == "raw":
        return rng.integers(0, 256, w * h + int(rng.choice(
            [0, 0, -1, 5]))).astype(np.uint8).tobytes(), (w, h)
    if kind == "garbage":
        return rng.integers(0, 256, 30).astype(np.uint8).tobytes(), (0, 0)
    iw, ih = w + int(rng.choice([0, 0, 1, -1])), h
    iw = max(iw, 1)
    img = rng.integers(0, 256, (ih, iw, 3)).astype(np.uint8)
    buf = io.BytesIO()
    if kind.startswith("jpeg"):
        Image.fromarray(img).convert("L" if kind == "jpeg_l" else
                                     "RGB").save(buf, "JPEG", quality=90)
    else:
        mode = {"png_l": "L", "png_rgb": "RGB", "png_p": "P", "png_1": "1",
                "png_16": "I;16"}[kind]
        im = Image.fromarray(img).convert("L" if mode == "I;16" else mode)
        if mode == "I;16":
            im = Image.fromarray(np.asarray(im).astype(np.uint16) * 257)
        im.save(buf, "PNG")
    return buf.getvalue(), (iw, ih)


@st.composite
def iptc_files(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    w, h = draw(st.integers(1, 7)), draw(st.integers(1, 6))
    layers, component = draw(st.sampled_from(
        [(1, 0), (1, 0), (3, 1), (3, 1), (4, 1), (4, 1), (2, 1), (1, 1),
         (3, 0)]))
    band = draw(st.sampled_from([None, None, 0, 1, 2, 3, 4, 5]))
    compression = draw(st.sampled_from([1, 1, 5, 5, 5, 3]))
    kind = "raw" if compression == 1 else draw(st.sampled_from(
        ["jpeg_l", "jpeg_rgb", "png_l", "png_rgb", "png_p", "png_1",
         "png_16", "garbage"]))
    payload, inner = _inner(kind, w, h, rng)
    extra = b""
    if draw(st.integers(0, 4)) == 0:
        extra = se.iptc_record(2, 5, b"caption", extended=draw(
            st.integers(1, 4)))
    data = se.iptc(w, h, payload, layers, component, compression, band,
                   pieces=draw(st.integers(1, 3)), extra=extra)
    if draw(st.integers(0, 9)) == 0:
        data = data.replace(b"\x1c\x03\x14", b"\x1c\x03\x15", 1)  # no width
    if kind in ("raw", "garbage") and draw(st.integers(0, 9)) == 0:
        data = data[:int(rng.integers(1, len(data) + 1))]
    # PIL reads an RGB band image of more pixels than the merged inner
    # image from past the end of its bytes.
    past_end = (layers == 3 and component and inner[0] * inner[1] < w * h)
    return data, past_end


@sweep(150)
@given(case=iptc_files())
def test_iptc_records_read_or_refuse_as_pil(tmp_path, case):
    data, past_end = case
    path = tmp_path / "x.iim"
    path.write_bytes(data)
    if past_end:
        try:
            jax_read_ldr(path)
        except (NotImplementedError, *PIL_ERRORS):
            pass
        else:
            with pytest.raises(ValueError):
                image_io.read_ldr(str(path))
            return
    assert_as_jax(path)


# ----------------------------------------------------------------------------
# PCD


def test_photoycc_tables_match_pils_unpacker():
    """pcd.ycc_to_rgb against PIL's YCC;P unpacker on every (Y, C1, C2)."""
    v = np.arange(256, dtype=np.uint8)
    for y0 in range(0, 256, 32):
        y, cb, cr = np.meshgrid(v[y0:y0 + 32], v, v, indexing="ij")
        ycc = np.stack([y, cb, cr], -1).reshape(-1, 3)
        ref = np.asarray(Image.frombytes("RGB", (4096, 512), ycc.tobytes(),
                                         "raw", "YCC;P")).reshape(-1, 3)
        assert np.array_equal(pcd.ycc_to_rgb(ycc[:, 0], ycc[:, 1],
                                             ycc[:, 2]), ref), y0


@pytest.fixture(scope="module")
def pcd_chunks():
    rng = np.random.default_rng(27)
    return rng.integers(0, 256, 256 * pcd.CHUNK).astype(np.uint8).tobytes()


@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 0xFD, 0x81])
def test_pcd_orientations_read_as_pil(tmp_path, pcd_chunks, orientation):
    """Orientation & 3: 1 and 3 rotate by 90 and 270 degrees (512x768),
    0 and 2 do not."""
    got = assert_as_jax(tmp_path / "x.pcd", se.pcd(pcd_chunks, orientation))
    assert got is not None
    assert got.shape == ((768, 512, 3) if orientation & 1 else (512, 768, 3))


def test_pcd_writer_round_trip(tmp_path):
    """write_pcd's file of a 768x512 image and of a 512x768 one reads as
    PIL reads it, close to the image (PhotoYCC's 4:2:0 chroma)."""
    rng = np.random.default_rng(8)
    img = np.repeat(np.repeat(rng.integers(40, 200, (256, 384, 3)), 2, 0),
                    2, 1).astype(np.uint8)
    for pic in (img, np.rot90(img)):
        path = tmp_path / "w.pcd"
        pcd.write_pcd(str(path), pic)
        got = assert_as_jax(path)
        assert got.shape == pic.shape
        assert np.abs(got * 255 - pic).max() <= 4


# ----------------------------------------------------------------------------
# Refusals


def _fits_head(*cards):
    return se.fits([(list(cards), bytes(200))])


def _refusals():
    fli_ok = se.fli(4, 2, [se.fli_frame([se.fli_chunk(16, bytes(8))])])
    prefix = se.fli_chunk(0xF100, bytes(10))
    prefix = prefix[:4] + struct.pack("<H", 0xF100) + prefix[6:]
    pal_past = se.fli_chunk(4, se.fli_colour([(250, bytes(30))]))
    return {
        "fits_simple_f.fits": _fits_head(("SIMPLE", "F"), ("BITPIX", 8),
                                         ("NAXIS", 0)),
        "fits_no_end.fits": b"".join(se.fits_card(k, v) for k, v in (
            ("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 2),
            ("NAXIS2", 2))),
        "fits_no_image.fits": se.fits([([("SIMPLE", "T"), ("BITPIX", 8),
                                         ("NAXIS", 0)], b"x" * 100)]),
        "fits_naxis_0_only.fits": se.fits([([("SIMPLE", "T"),
                                             ("BITPIX", 8),
                                             ("NAXIS", 0)], b"")]),
        "fits_bitpix_64.fits": _fits_head(("SIMPLE", "T"), ("BITPIX", 64),
                                          ("NAXIS", 1), ("NAXIS1", 3)),
        "fits_no_naxis.fits": _fits_head(("SIMPLE", "T"), ("BITPIX", 8)),
        "fits_bad_int.fits": _fits_head(("SIMPLE", "T"), ("BITPIX", 8),
                                        ("NAXIS", b"2.0")),
        "fits_cut.fits": se.fits([([("SIMPLE", "T"), ("BITPIX", 16),
                                    ("NAXIS", 2), ("NAXIS1", 40),
                                    ("NAXIS2", 40)], bytes(100))],
                                 pad=False),
        "fits_gzip_float.fits": se.fits([
            ([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)], b""),
            ([("XTENSION", b"'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
              ("NAXIS1", 8), ("NAXIS2", 1), ("ZIMAGE", "T"),
              ("ZCMPTYPE", b"'GZIP_1  '"), ("ZBITPIX", -32), ("ZNAXIS", 2),
              ("ZNAXIS1", 2), ("ZNAXIS2", 2)],
             bytes(8) + se.gzip_bytes(bytes(16)))]),
        "fits_gzip_no_cmptype.fits": se.fits([
            ([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)], b""),
            ([("XTENSION", b"'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
              ("NAXIS1", 8), ("NAXIS2", 1), ("ZIMAGE", "T")], bytes(8))]),
        "fli_reserved.flc": fli_ok[:20] + b"\x01" + fli_ok[21:],
        "fli_header_cut.flc": fli_ok[:127],
        "fli_no_frame.flc": fli_ok[:128],
        "fli_frame_cut.flc": fli_ok[:133],
        "fli_prefix.flc": se.fli(4, 2, [se.fli_frame([se.fli_chunk(
            16, bytes(8))])], prefix=prefix),
        "fli_palette_past_255.flc": se.fli(4, 2, [se.fli_frame([
            pal_past, se.fli_chunk(16, bytes(8))])]),
        "fli_unknown_chunk.flc": se.fli(4, 2, [se.fli_frame([se.fli_chunk(
            99, bytes(4))])]),
        "fli_copy_short.flc": se.fli(4, 2, [se.fli_frame([se.fli_chunk(
            16, bytes(5))])]),
        "fli_chunk_size_0.flc": se.fli(4, 2, [se.fli_frame([se.fli_chunk(
            13, bytes(4), size=0)])]),
        "fli_brun_short_line.flc": se.fli(4, 2, [se.fli_frame([
            se.fli_chunk(15, b"\x00\x02\x07\x00\x04\x01")])]),
        "fli_size_0.flc": se.fli(0, 2, [se.fli_frame([])]),
        "iptc_bad_record.iim": b"\x1c\x0b\x3c\x00\x02\x01\x00",
        "iptc_long_field.iim": b"\x1c\x03\x3c\x90\x00",
        "iptc_no_mode.iim": se.iptc_record(3, 20, b"\x04"),
        "iptc_layers_2.iim": se.iptc(2, 2, bytes(4), 2, 1),
        "iptc_compression_3.iim": se.iptc(2, 2, bytes(4), compression=3),
        "iptc_no_records.iim": se.iptc(2, 2, b"")[:-5] + bytes(5),
        "iptc_raw_cut.iim": se.iptc(4, 4, bytes(10)),
        "iptc_band_past.iim": se.iptc(2, 2, bytes(4), 3, 1, band=7),
        "iptc_garbage_inner.iim": se.iptc(2, 2, b"\x7f" * 20,
                                          compression=5),
        "pcd_cut.pcd": se.pcd(bytes(1000)),
        "pcd_block_cut.pcd": se.pcd(b"")[:2048 + 1000],
        "pcd_no_magic.pcd": b"PCD_" + se.pcd(bytes(10))[4:2048] + b"PCDX",
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals_match_pil(tmp_path, case):
    assert assert_as_jax(tmp_path / case, _refusals()[case]) is None
