"""The port's SGI, PCX and DCX readers (core/sgi.py, core/pcx.py,
csrc/small_decode.cpp, through core/image_io.read_ldr) against the JAX
package's read_ldr, which reads them through PIL: equal float32 images
(np.array_equal, with and without gamma_to_linear) on every committed
fixture of tests/data/small (tests/make_small_fixtures.py) and on
hypothesis sweeps of small random SGI RLE files (8 and 16 bits, 1-4
channels, random copy and repeat packets, rows left short, tables and
bytes broken, row lengths of 2^31 or more) and PCX files (every layout
PIL reads, random runs, runs across lines, data cut short). Where PIL refuses a file the port raises:
NotImplementedError where PIL cannot identify it (or raises its own
NotImplementedError), ValueError where it raises otherwise. The manifest
holds PIL's digests of every fixture, for the card's machine, which has
no PIL.
"""

import json
import os
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, UnidentifiedImageError

import small_encode as se
from make_dds_fixtures import array_digest, pil_pixels
from make_small_fixtures import FIXTURE_DIR, texture
from tracerboy_tpu_torch.core import image_io

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
# What PIL raises besides NotImplementedError and UnidentifiedImageError.
PIL_ERRORS = (OSError, ValueError, SyntaxError, RuntimeError, AssertionError,
              EOFError, KeyError, IndexError, TypeError, struct.error,
              ZeroDivisionError, Image.DecompressionBombError)


def jax_read_ldr(path, **kw):
    from tracerboy_tpu.core.image_io import read_ldr

    return read_ldr(str(path), **kw)


def assert_as_jax(path, data: bytes | None = None):
    """Read `path` (written with `data` first) with read_ldr in both
    packages: equal float32 images (returns the port's), or the matching
    refusal (returns None)."""
    if data is not None:
        path.write_bytes(data)
    try:
        ref = jax_read_ldr(path)
    except (NotImplementedError, UnidentifiedImageError):
        with pytest.raises(NotImplementedError):
            image_io.read_ldr(str(path))
        return None
    except PIL_ERRORS:
        with pytest.raises(ValueError):
            image_io.read_ldr(str(path))
        return None
    got = image_io.read_ldr(str(path))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref), (np.abs(got - ref).max() * 255,
                                      (got != ref).mean())
    return got


def fixtures(*suffixes):
    return sorted(n for n in MANIFEST["files"] if n.endswith(suffixes))


@pytest.mark.parametrize("name", fixtures(".sgi", ".pcx", ".dcx"))
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    got = assert_as_jax(path)
    assert got is not None, f"{name}: PIL refuses a fixture"
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


@pytest.mark.parametrize("name", fixtures(".sgi", ".pcx", ".dcx"))
def test_manifest_matches_the_files(name):
    assert MANIFEST["files"][name] == array_digest(
        pil_pixels(os.path.join(FIXTURE_DIR, name)))


def test_fixtures_cover_the_readers():
    """Every SGI mode at both depths and both codings, every PCX layout,
    and a DCX; the RLE fixtures use both packet kinds."""
    names = set(MANIFEST["files"])
    for c in ("l", "rgb", "rgba"):
        assert {f"sgi_{c}.sgi", f"sgi_{c}_16.sgi", f"sgi_rle_{c}.sgi",
                f"sgi_rle_{c}_16.sgi"} <= names
    for kind in ("rgb_13", "l_1", "1_13", "p_16", "p2_3", "p4_13"):
        assert f"pcx_{kind}.pcx" in names
    data = open(os.path.join(FIXTURE_DIR, "sgi_rle_rgb.sgi"), "rb").read()
    assert b"\x02" in data[512:] and any(b & 0x80 for b in data[600:])


def _rle_file(rng, h, w, c, bpc, damage):
    img = rng.integers(0, 4, (h, w, c)) * 60
    img[:, w // 2:] = rng.integers(0, 256, (h, w - w // 2, c))
    img = img.astype(np.uint16 if bpc == 2 else np.uint8)
    if bpc == 2:
        img = img * 257
    rows = {}
    if damage == "short_row":
        rows[(int(rng.integers(h)), int(rng.integers(c)))] = b"\x81\x05"
    elif damage == "empty_row":
        rows[(int(rng.integers(h)), int(rng.integers(c)))] = b"\0"
    data = bytearray(se.sgi_rle(img, bpc=bpc, rng=rng, rows=rows))
    if damage == "byte":
        pos = int(rng.integers(512, len(data)))
        data[pos] = int(rng.integers(256))
    elif damage == "cut":
        del data[int(rng.integers(512, len(data))):]
    elif damage == "table":
        k = int(rng.integers(2 * h * c))
        struct.pack_into(">I", data, 512 + 4 * k, int(rng.integers(0, 2000)))
    elif damage == "huge_length":          # negative as SgiRleDecode's int
        k = h * c + int(rng.integers(h * c))
        struct.pack_into(">I", data, 512 + 4 * k,
                         int(rng.integers(2**31, 2**32)))
    return bytes(data)


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("small")


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), h=st.integers(1, 9),
       w=st.integers(1, 140), c=st.sampled_from([1, 3, 4]),
       bpc=st.sampled_from([1, 2]),
       damage=st.sampled_from([None, None, "short_row", "empty_row",
                               "byte", "cut", "table", "huge_length"]))
def test_sgi_rle_sweep(scratch, seed, h, w, c, bpc, damage):
    data = _rle_file(np.random.default_rng(seed), h, w, c, bpc, damage)
    assert_as_jax(scratch / "s.sgi", data)


PCX_LAYOUTS = {"1": (1, 1), "p2": (1, 2), "p4": (1, 4), "l": (8, 1),
               "rgb": (8, 3)}


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), h=st.integers(1, 8),
       w=st.integers(1, 70), layout=st.sampled_from(sorted(PCX_LAYOUTS)),
       stride_kept=st.booleans(), palette=st.sampled_from([None, "grey",
                                                           "colour"]),
       damage=st.sampled_from([None, None, None, "across", "cut", "byte"]))
def test_pcx_rle_sweep(scratch, seed, h, w, layout, stride_kept, palette,
                       damage):
    rng = np.random.default_rng(seed)
    bits, planes = PCX_LAYOUTS[layout]
    stride = (w * bits + 7) // 8
    provided = stride if stride_kept else stride + 1
    if not stride_kept:
        stride += stride % 2
    lines = rng.integers(0, 256, (h, planes * stride)).astype(np.uint8)
    lines[:, ::3] = lines[:, :1]                 # runs
    body = se.pcx_encode(lines, per_line=damage != "across")
    if damage == "cut":
        body = body[:int(rng.integers(0, len(body) + 1))]
    elif damage == "byte" and body:
        pos = int(rng.integers(len(body)))
        body = body[:pos] + bytes([int(rng.integers(256))]) + body[pos + 1:]
    tail = b""
    if bits == 8 and planes == 1 and palette is not None:
        pal = (np.repeat(np.arange(256, dtype=np.uint8), 3)
               if palette == "grey" else rng.integers(0, 256, 768)
               .astype(np.uint8))
        tail = b"\x0c" + pal.tobytes()
    head = se.pcx_header(w, h, bits, planes, provided, 5,
                         rng.integers(0, 256, 48).astype(np.uint8).tobytes())
    assert_as_jax(scratch / "p.pcx", head + body + tail)


def _refusals():
    rng = np.random.default_rng(7)
    img = texture(rng, 5, 6, 3)
    sgi = bytearray(se.sgi_rle(img))
    pcx = se.pcx_header(6, 5, 8, 3, 6) + se.pcx_encode(
        img.transpose(0, 2, 1).reshape(5, 18))
    rgb1 = Image.fromarray(img[:, :1])
    import io

    buf = io.BytesIO()
    rgb1.save(buf, "PCX")
    return {
        "sgi_unknown_mode": bytes(sgi[:3]) + b"\x03" + bytes(sgi[4:]),
        "sgi_compression_2": bytes(sgi[:2]) + b"\x02" + bytes(sgi[3:]),
        "sgi_header_cut": bytes(sgi[:10]),
        "sgi_zero_width": bytes(sgi[:6]) + b"\0\0" + bytes(sgi[8:]),
        "sgi_verbatim_cut": se.sgi_header(6, 5, 3, 1, False) + bytes(50),
        "sgi_16_verbatim_cut": se.sgi_header(6, 5, 3, 2, False) + bytes(99),
        "sgi_table_cut": bytes(sgi[:512 + 20]),
        "sgi_row_before_header": bytes(sgi[:512]) + struct.pack(">I", 100)
        + bytes(sgi[516:]),
        "sgi_run_past_width": se.sgi_rle(img, rows={(0, 0): b"\x07\x01\0"}),
        "sgi_copy_to_last_byte": se.sgi_rle(img[:1, :1, :1],
                                            rows={(0, 0): b"\x81\x05"}),
        "pcx_unknown_mode": pcx[:3] + b"\x04" + pcx[4:],
        "pcx_8bit_shorter_than_palette": se.pcx_header(4, 2, 8, 1, 4)
        + bytes(8),
        "pcx_run_across_lines": se.pcx_header(6, 5, 8, 3, 6) + bytes(
            (0xC0 | 40, 7)) * 3,
        "pcx_cut": pcx[:140],
        "pcx_empty_window": pcx[:4] + struct.pack("<H", 100) + pcx[6:],
        "pcx_header_cut": pcx[:60],
        "pcx_pil_rgb_1_wide": buf.getvalue(),
        "dcx_no_pages": struct.pack("<II", 0x3ADE68B1, 0),
        "dcx_directory_cut": struct.pack("<II", 0x3ADE68B1, 12),
        "dcx_page_not_pcx": se.dcx([b"\x0b" + pcx[1:]]),
        "dcx_page_past_end": struct.pack("<III", 0x3ADE68B1, 999, 0),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals_as_pil_refuses(scratch, case):
    """Each file PIL refuses is refused by the port, with the mapped
    error; none of them reads."""
    assert assert_as_jax(scratch / f"{case}.bin", _refusals()[case]) is None


@pytest.mark.parametrize("ext", ["sgi", "pcx"])
def test_writers_round_trip_through_pil(tmp_path, ext):
    """core/sgi.write_sgi (RLE) and core/pcx.write_pcx, which
    write the demo scenes' textures, write files PIL reads back to the
    image, and so does the port."""
    from tracerboy_tpu_torch.core import pcx, sgi
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image

    img = image_io._to_uint8(albedo_image(96))[:77]
    write = sgi.write_sgi if ext == "sgi" else pcx.write_pcx
    path = tmp_path / f"a.{ext}"
    write(str(path), img)
    assert np.array_equal(pil_pixels(str(path)), img)
    assert np.array_equal(image_io.decode_ldr(str(path)), img)
