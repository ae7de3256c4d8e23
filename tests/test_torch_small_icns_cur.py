"""The port's ICNS, CUR and DIB readers (core/icns.py, core/ico.py,
csrc/small_decode.cpp, through core/image_io.read_ldr) against the JAX
package's read_ldr (PIL): equal float32 images on every committed ICNS,
CUR and DIB fixture of tests/data/small, on a hypothesis sweep of random
24-bit ICNS entries in the RLE code (runs, literals, overruns, streams
cut short, with and without masks, it32's lead), and the matching
refusal where PIL refuses.

read_ldr does not convert an ICNS, which says RGBA until it is loaded:
np.asarray packs an RGB result with RGBA's raw mode, so PIL hands out an
RGB icon sheared (the test pins it), and refuses a PNG entry of any mode
but RGB and RGBA ("No packer found").
"""

import os
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import small_encode as se
from make_dds_fixtures import array_digest, pil_pixels
from make_small_fixtures import FIXTURE_DIR, texture
from test_torch_small_sgi_pcx import MANIFEST, assert_as_jax, jax_read_ldr
from tracerboy_tpu_torch.core import image_io

NAMES = sorted(n for n in MANIFEST["files"]
               if n.endswith((".icns", ".cur", ".dib")))


@pytest.mark.parametrize("name", NAMES)
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    assert assert_as_jax(path) is not None, f"{name}: PIL refuses it"
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


@pytest.mark.parametrize("name", NAMES)
def test_manifest_matches_the_files(name):
    assert MANIFEST["files"][name] == array_digest(
        pil_pixels(os.path.join(FIXTURE_DIR, name)))


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("icns")


SIDES = {b"is32": 16, b"il32": 32, b"ih32": 48, b"it32": 128}
MASKS = {b"is32": b"s8mk", b"il32": b"l8mk", b"ih32": b"h8mk",
         b"it32": b"t8mk"}


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       code=st.sampled_from(sorted(SIDES)), mask=st.booleans(),
       damage=st.sampled_from([None, None, "byte", "cut", "overrun",
                               "short_mask", "lead"]))
def test_icns_rle_sweep(scratch, seed, code, mask, damage):
    rng = np.random.default_rng(seed)
    side = SIDES[code]
    img = texture(rng, side, side, 3, levels=3)
    body = bytearray(se.icns_rle(img.transpose(2, 0, 1).reshape(3, -1),
                                 rng))
    if damage == "byte":
        body[int(rng.integers(len(body)))] = int(rng.integers(256))
    elif damage == "cut":
        del body[int(rng.integers(len(body))):]
    elif damage == "overrun":
        body = bytes((0xFF, 7)) * (3 * side * side // 130 + 2)
    lead = bytes(4) if code == b"it32" else b""
    if damage == "lead" and lead:
        lead = b"\0\0\0\1"
    entries = [(code, lead + bytes(body))]
    if mask:
        m = texture(rng, side, side, 1)[..., 0].tobytes()
        if damage == "short_mask":
            m = m[:len(m) // 2]
        entries.append((MASKS[code], m))
    if damage == "short_mask" and not mask:
        entries.append((MASKS[code], b"\1\2"))
    assert_as_jax(scratch / "i.icns", se.icns(entries))


def test_rgb_icons_come_out_sheared_as_in_pil(scratch):
    """An ICNS whose best entry is RGB without a mask (an RLE entry, an
    RGB PNG) reads as PIL's RGBX bytes laid out as RGB: not the icon."""
    for name in ("icns_ih32_no_mask.icns", "icns_ic11_png_rgb.icns"):
        got = image_io.decode_ldr(os.path.join(FIXTURE_DIR, name))
        assert got.shape[-1] == 3
    rgb = texture(np.random.default_rng(4), 32, 32, 4)[..., :3]
    got = assert_as_jax(scratch / "s.icns",
                        se.icns([(b"ic11", se.png_bytes(rgb))]))
    assert not np.array_equal(np.round(got * 255).astype(np.uint8), rgb)


def _refusals():
    rng = np.random.default_rng(5)
    rgba = texture(rng, 32, 32, 4)
    png = se.png_bytes(rgba)
    ok = se.icns([(b"ic11", png)])
    img = texture(rng, 6, 5, 3)
    bmp = se.dib_bitmap(img)
    return {
        "icns_header_cut": b"icns\0\0",
        "icns_entry_cut": ok[:12],
        "icns_entry_length_0": b"icns" + struct.pack(">I", 100) + b"ic11"
        + bytes(4),
        "icns_no_known_size": se.icns([(b"xx32", bytes(20))]),
        "icns_mask_only": se.icns([(b"s8mk", bytes(256))]),
        "icns_png_grey": se.icns([(b"ic11", se.png_bytes(rgba[..., 0]))]),
        "icns_png_palette": se.icns([(b"ic11", _palette_png(rgba))]),
        "icns_png_wrong_size": se.icns([(b"ic11", se.png_bytes(
            rgba[:20, :20]))]),
        "icns_not_png": se.icns([(b"ic11", b"GIF89a" + bytes(40))]),
        "icns_filesize_past_end": ok[:4] + struct.pack(">I", 9999) + ok[8:],
        "cur_no_entries": struct.pack("<HHH", 0, 2, 0),
        "cur_header_cut": b"\0\0\2\0\1",
        "cur_directory_cut": se.cur([(5, 6, bmp)])[:14],
        "cur_short_second_entry": se.cur([(5, 6, bmp)])[:6 + 16]
        + b"\7",
        "cur_bad_header_size": se.cur([(5, 6, b"\x20\0\0\0" + bmp[4:])]),
        "cur_bitmap_cut": se.cur([(5, 6, bmp)])[:40],
        "cur_offset_0": se.cur([(5, 6, bmp)], offsets=[0]),
        "dib_header_cut": bmp[:30],
        "dib_bad_bits": bmp[:14] + b"\x03\0" + bmp[16:],
        "dib_pixels_cut": bmp[:50],
        "dib_short": b"\x28\0\0",
    }


def _palette_png(rgba):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgba[..., :3]).quantize(8).save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals_as_pil_refuses(scratch, case):
    """Each file reads or is refused as PIL reads or refuses it (a few of
    them PIL reads after all: a bitmap after the cursor directory)."""
    assert_as_jax(scratch / f"{case}.bin", _refusals()[case])


def test_icns_writer_reads_back(tmp_path):
    """core/icns.write_icns, which writes the demo scene's ic10 albedo,
    writes files PIL reads back to the image."""
    from tracerboy_tpu_torch.core.icns import write_icns

    rgba = texture(np.random.default_rng(6), 64, 64, 4)
    path = tmp_path / "w.icns"
    write_icns(str(path), {b"ic12": rgba})
    assert np.array_equal(pil_pixels(str(path)), rgba)
    assert np.array_equal(image_io.decode_ldr(str(path)), rgba)
