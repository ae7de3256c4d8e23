"""The port's XBM, XPM, MSP, PIXAR, GBR, IMT, McIdas, SPIDER and XVThumb
readers (core/xbm.py, core/xpm.py, core/msp.py, core/rawformats.py,
csrc/small_decode.cpp, through core/image_io.read_ldr) against the JAX
package's read_ldr, which reads them through PIL: equal float32 images
(np.array_equal, with and without gamma_to_linear) on every such fixture
of tests/data/small2 (tests/make_small2_fixtures.py), on a hypothesis
sweep of XPM headers and colour lines (sizes, colour counts of P and RGB
images, chars a pixel, "None", colour specs int(..., 16) reads or not,
keys missing from the palette, rows that shift or end early), and on
each reader's refusals; the textures utils/demo_scene.write_small2_textures
writes decode to the manifest's (PIL's) digests. Where PIL refuses a file
the port raises: NotImplementedError where PIL cannot identify it,
ValueError where it raises otherwise.
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
from make_small2_fixtures import FIXTURE_DIR
from test_torch_small_sgi_pcx import assert_as_jax, jax_read_ldr
from tracerboy_tpu_torch.core import image_io

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
SUFFIXES = (".xbm", ".xpm", ".msp", ".pxr", ".gbr", ".imt", ".area",
            ".spi", ".xv")


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
    assert {"msp_danm.msp", "msp_lins.msp", "msp_lins_shifted.msp",
            "xbm_pil.xbm", "xbm_hotspot.xbm", "xbm_broken_hex.xbm",
            "xpm_p.xpm", "xpm_rgb_300.xpm", "xpm_rows_shift.xpm",
            "xpm_none_unused.xpm", "pixar_rgb.pxr", "gbr_v1_l.gbr",
            "gbr_v2_rgba.gbr", "imt_l.imt", "mcidas_l.area",
            "mcidas_i16.area", "mcidas_i32.area", "mcidas_l_overlap.area",
            "spider_pil.spi", "spider_le.spi", "spider_stack.spi",
            "xv_thumb.xv"} <= names
    assert {"albedo.ras", "albedo_raw.ras", "albedo.im", "albedo.xpm",
            "leaf.im"} == set(MANIFEST["generated"])


def test_written_textures_match_the_manifest(tmp_path):
    """write_small2_textures' files: the bytes the manifest names and
    PIL's pixels, which the port's readers give too."""
    from tracerboy_tpu_torch.utils.demo_scene import write_small2_textures

    for name, path in write_small2_textures(str(tmp_path)).items():
        entry = dict(MANIFEST["generated"][name])
        with open(path, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == entry.pop(
                "file_sha256"), name
        assert array_digest(image_io.decode_ldr(path)) == entry, name


# ----------------------------------------------------------------------------
# XPM sweep

CHARS = b"abcdefgh.#@ABCD"


@st.composite
def xpm_files(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    w, h = draw(st.integers(0, 6)), draw(st.integers(1, 5))
    bpp = draw(st.sampled_from([1, 2, 2, 3, 0]))
    count = draw(st.sampled_from([1, 3, 8, 257, 300]))
    alphabet = [bytes(k) for k in rng.choice(list(CHARS), (count * 2,
                                                           max(bpp, 1)))]
    keys = list(dict.fromkeys(k[:bpp] for k in alphabet))[:count]
    specs = [b"#%06x" % int(rng.integers(0, 1 << 24)) for _ in keys]
    if keys and draw(st.booleans()):
        specs[int(rng.integers(len(keys)))] = draw(st.sampled_from(
            [b"None", b"red", b"#0x1f", b"#+ff_00", b"#", b"#zz",
             b"#1234567890"]))
    colours = list(zip(keys, specs))
    if keys and draw(st.integers(0, 5)) == 0:
        colours.append((keys[0], b"#ffffff"))          # a key again
    rows = []
    for _ in range(h + draw(st.sampled_from([0, 0, 1, -1]))):
        n = max(0, w + draw(st.sampled_from([0, 0, 0, 1, -1])))
        pool = keys if keys else [b"?" * bpp]
        rows.append(b"".join(pool[int(i)] for i in rng.integers(
            0, len(pool), n)))
    if rows and draw(st.integers(0, 5)) == 0:
        rows[0] = rows[0][:-1]                           # a partial key
    data = se.xpm(w, h, colours, rows, draw(st.booleans()))
    if bpp == 0 or len(colours) != count:
        data = data.replace(f'"{w} {h} {len(colours)} {max(bpp, 1)}"'
                            .encode(), f'"{w} {h} {count} {bpp}"'.encode())
    if draw(st.integers(0, 9)) == 0:
        data = data.replace(b'c #', b'm #', 1)            # no colour key
    return data


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=xpm_files())
def test_xpm_files_read_or_refuse_as_pil(tmp_path, data):
    assert_as_jax(tmp_path / "x.xpm", data)


# ----------------------------------------------------------------------------
# Refusals


def _refusals():
    xbm = (b"#define a_width 9\n#define a_height 3\nstatic char a_bits[] "
           b"= {\n0x01, 0x02, 0x03, 0x04,\n};\n")
    spider = se.spider(np.ones((3, 4), np.float32))
    spider_nan = bytearray(spider)
    struct.pack_into(">f", spider_nan, 4 * 23, float("nan"))
    spider_inconsistent = bytearray(spider)
    struct.pack_into(">f", spider_inconsistent, 4 * 23, -1.0)
    mcidas = se.mcidas(5, 4, 1, bytes(20))
    return {
        "xbm_no_bits.xbm": xbm.replace(b"_bits", b"_data"),
        "xbm_cut.xbm": xbm,
        "xbm_width_0.xbm": xbm.replace(b"width 9", b"width 0"),
        "xpm_no_header.xpm": b"/* XPM */\nstatic char *x[] = {\n};\n",
        "xpm_size_0.xpm": se.xpm(0, 2, [(b"a", b"#000000")], [b"", b""]),
        "xpm_empty_size.xpm": se.xpm(2, 1, [(b"a", b"#000000")],
                                     [b"aa"]).replace(b'"2 1', b'" 1'),
        "xpm_c_last.xpm": b'/* XPM */\n"1 1 1 1",\n"a m #000 c",\n"a"\n',
        "msp_checksum.msp": se.msp_lins(8, 1, [b"\x01\xff"])[:30]
        + b"\x01\x00" + b"\x02\x00\x01\xff",
        "msp_cut.msp": se.msp_lins(8, 4, [b"\x01\xff"] * 4)[:40],
        "msp_run_cut.msp": se.msp_lins(8, 1, [b"\x00\x01"]),
        "msp_short.msp": se.msp_lins(16, 2, [b"\x01\xff", b"\x01\xff"]),
        "msp_danm_cut.msp": _danm(16, 4)[:38],
        "pixar_layout.pxr": se.pixar(2, 2, bytes(12), (14, 1)),
        "pixar_cut.pxr": se.pixar(2, 2, bytes(11)),
        "gbr_depth_3.gbr": se.gbr(2, 2, 3, bytes(12)),
        "gbr_no_magic.gbr": se.gbr(2, 2, 1, bytes(4)).replace(b"GIMP",
                                                              b"GIMQ"),
        "gbr_cut.gbr": se.gbr(2, 2, 4, bytes(15)),
        "gbr_v2_header_24.gbr": struct.pack(">5I", 24, 2, 2, 2, 1)
        + b"GIMP" + bytes(8),
        "imt_no_form_feed.imt": b"width 2\nheight 2\npixel n8\n",
        "imt_bad_width.imt": b"width x\nheight 2\npixel n8\n\x0c" + bytes(4),
        "imt_no_mode.imt": b"width 2\nheight 2\n\x0c" + bytes(4),
        "mcidas_format_3.area": se.mcidas(5, 4, 3, bytes(60)),
        "mcidas_cut.area": mcidas[:270],
        "mcidas_dir_cut.area": mcidas[:200],
        "spider_nan_stack.spi": bytes(spider_nan),
        "spider_inconsistent.spi": bytes(spider_inconsistent),
        "spider_cut.spi": spider[:-3],
        "xv_no_size.xv": b"P7 332\n#c\n5\n" + bytes(20),
        "xv_eof.xv": b"P7 332\n#c\n",
        "xv_cut.xv": se.xvthumb(4, 4, bytes(10)),
    }


def _danm(w, h):
    buf = io.BytesIO()
    Image.new("1", (w, h)).save(buf, "MSP")
    return buf.getvalue()


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals_match_pil(tmp_path, case):
    assert assert_as_jax(tmp_path / case, _refusals()[case]) is None


def test_spider_image_within_a_stack_is_refused(tmp_path):
    """A header of an image within a stack (istack 0, imgnumber > 0),
    opened alone: PIL's _open reads an offset it has not set
    (AttributeError, out of Image.open); the port raises ValueError."""
    data = bytearray(se.spider(np.ones((3, 4), np.float32)))
    struct.pack_into(">f", data, 4 * 26, 2.0)
    path = tmp_path / "x.spi"
    path.write_bytes(bytes(data))
    with pytest.raises(AttributeError):
        jax_read_ldr(path)
    with pytest.raises(ValueError):
        image_io.read_ldr(str(path))
