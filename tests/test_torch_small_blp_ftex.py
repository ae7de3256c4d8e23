"""The port's BLP and FTEX readers (core/blp.py, core/ftex.py, through
core/image_io.read_ldr) against the JAX package's read_ldr (PIL): equal
float32 images on every committed BLP and FTEX fixture of
tests/data/small, on hypothesis sweeps of random DXT blocks in BLP2 and
FTEX files of random sizes, and on BLP1 JPEG files; the matching refusal
where PIL refuses (its BLPFormatError is a NotImplementedError, and so is
the port's refusal of what PIL does not decode, BLP2's raw BGRA among
it).

PIL decodes BLP2's DXT blocks in its own Python, not with the C "bcn"
decoder that DDS and FTEX go through, and the two differ (565 colours
widened by a shift against bit replication, DXT1's three-colour blocks,
the interpolations' rounding): the same blocks read differently as a
BLP2 and as an FTEX, in PIL and in the port alike, which a test pins.
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
from tracerboy_tpu_torch.core import blp, image_io

NAMES = sorted(n for n in MANIFEST["files"] if n.endswith((".blp", ".ftex")))


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
    return tmp_path_factory.mktemp("blp")


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), w=st.integers(1, 30),
       h=st.integers(1, 30), enc=st.sampled_from([0, 1, 7]),
       depth=st.sampled_from([0, 1, 8]), cut=st.booleans())
def test_blp2_dxt_sweep(scratch, seed, w, h, enc, depth, cut):
    """Random DXT1, DXT3 and DXT5 blocks (equal endpoints, c0 <= c1 and
    every alpha code among them) at every size: the padded rows PIL lays
    out at the image's width, alpha or none."""
    rng = np.random.default_rng(seed)
    size = 8 if enc == 0 else 16
    n = ((w + 3) // 4) * ((h + 3) // 4)
    blocks = rng.integers(0, 256, (n, size)).astype(np.uint8)
    blocks[::3, size - 8:size - 6] = blocks[::3, size - 6:size - 4]
    data = blocks.tobytes()
    if cut:
        data = data[:int(rng.integers(len(data)))]
    assert_as_jax(scratch / "d.blp", se.blp2(w, h, data, 2, depth, enc))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), w=st.integers(1, 30),
       h=st.integers(1, 30), fmt=st.sampled_from([0, 1]),
       cut=st.booleans())
def test_ftex_sweep(scratch, seed, w, h, fmt, cut):
    rng = np.random.default_rng(seed)
    n = ((w + 3) // 4) * ((h + 3) // 4) * 8 if fmt == 0 else w * h * 3
    data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    if cut:
        data = data[:int(rng.integers(n))]
    assert_as_jax(scratch / "f.ftex", se.ftex(w, h, [(fmt, data)]))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), w=st.integers(1, 40),
       h=st.integers(1, 40), mode=st.sampled_from(["L", "RGB", "CMYK"]),
       alpha=st.booleans(), split=st.integers(0, 3),
       size=st.sampled_from(["same", "larger", "smaller"]))
def test_blp1_jpeg_sweep(scratch, seed, w, h, mode, alpha, split, size):
    """BLP1 JPEGs: the shared header cut at each marker boundary, grey,
    colour and CMYK (PIL's save: Adobe transform 0), with and without
    alpha, the BLP size equal to, smaller and larger than the JPEG's
    (PIL lays the JPEG's pixels out at the BLP's size)."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(texture(rng, h, w, 4 if mode == "CMYK" else 3),
                          "CMYK" if mode == "CMYK" else "RGB")
    buf = io.BytesIO()
    img.convert(mode).save(buf, "JPEG", quality=85)
    jpeg = buf.getvalue()
    cuts = [k for k in range(2, len(jpeg) - 1)
            if jpeg[k] == 0xFF and jpeg[k + 1] not in (0, 0xFF)]
    header_len = cuts[min(split, len(cuts) - 1)] if split else None
    bw, bh = {"same": (w, h), "larger": (w + 3, h + 1),
              "smaller": (max(1, w - 2), h)}[size]
    assert_as_jax(scratch / "j.blp", se.blp1_jpeg(jpeg, bw, bh,
                                                  8 if alpha else 0,
                                                  header_len))


def test_blp_dxt_is_pils_python_not_bcn(scratch):
    """The same DXT1 blocks as a BLP2 (PIL's Python decode_dxt1) and as
    an FTEX (libImaging's bcn decoder) read differently in PIL, and the
    port reads each as PIL does."""
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, 256, (16, 8)).astype(np.uint8)
    blocks[:8, 0:2], blocks[:8, 2:4] = (0x10, 0x84), (0xF8, 0x07)
    data = blocks.tobytes()
    a = assert_as_jax(scratch / "b.blp", se.blp2(16, 16, data, 2, 8, 0))
    f = assert_as_jax(scratch / "b.ftex", se.ftex(16, 16, [(0, data)]))
    assert a is not None and f is not None
    assert not np.array_equal(a, f)


def _refusals():
    rng = np.random.default_rng(9)
    img = texture(rng, 8, 8, 4)
    dxt = blp.encode_dxt(img, 1)
    good = se.blp2(8, 8, dxt, 2, 0, 0)
    pal = rng.integers(0, 256, (256, 4))
    idx = rng.integers(0, 256, (8, 8))
    ftex = se.ftex(8, 8, [(0, dxt)])
    return {
        "blp2_raw_bgra": se.blp2(8, 8, img.tobytes(), 3, 8, 0),
        "blp2_jpeg": se.blp2(8, 8, dxt, 2, 0, 0, compression=0),
        "blp2_compression_2": se.blp2(8, 8, dxt, 2, 0, 0, compression=2),
        "blp2_alpha_encoding_3": se.blp2(8, 8, dxt, 2, 8, 3),
        "blp2_header_cut": good[:15],
        "blp2_zero_width": good[:12] + bytes(4) + good[16:],
        "blp2_tables_cut": good[:60],
        "blp2_palette_cut": good[:20 + 128 + 500],
        "blp2_blocks_cut": good[:-10],
        "blp2_too_few_indices": se.blp2(8, 8, bytes(40), 1, 0, 0, pal),
        "blp1_encoding_3": se.blp1_palette(idx, pal, 8, 3),
        "blp1_compression_2": b"BLP1" + struct.pack("<i", 2) + se.blp1_palette(
            idx, pal)[8:],
        "blp1_header_cut": se.blp1_palette(idx, pal)[:22],
        "blp1_indices_cut": se.blp1_palette(idx, pal)[:-5],
        "blp1_jpeg_broken": se.blp1_jpeg(b"\xff\xd8\xff\xdb" + bytes(80),
                                         8, 8, header_len=10),
        "ftex_two_formats": se.ftex(8, 8, [(0, dxt), (1, bytes(192))]),
        "ftex_format_2": se.ftex(8, 8, [(2, dxt)]),
        "ftex_header_cut": ftex[:20],
        "ftex_negative_offset": ftex[:28] + struct.pack("<i", -4) + ftex[32:],
        "ftex_offset_past_end": ftex[:28] + struct.pack("<i", 999)
        + ftex[32:],
        "ftex_size_minus_2": ftex[:32] + struct.pack("<i", -2) + ftex[36:],
        "ftex_blocks_cut": ftex[:-4],
        "ftex_zero_height": ftex[:12] + bytes(4) + ftex[16:],
        "ftex_rgb_cut": se.ftex(8, 8, [(1, bytes(100))]),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals_as_pil_refuses(scratch, case):
    assert assert_as_jax(scratch / f"{case}.bin", _refusals()[case]) is None


def test_size_minus_1_reads_the_rest(scratch):
    """An FTEX mipmap size of -1 reads the rest of the file, as PIL's
    read(-1) does."""
    dxt = blp.encode_dxt(texture(np.random.default_rng(2), 8, 8, 4), 1)
    data = bytearray(se.ftex(8, 8, [(0, dxt)]))
    struct.pack_into("<i", data, 32, -1)
    assert assert_as_jax(scratch / "m.ftex", bytes(data)) is not None


@pytest.mark.parametrize("kind", [1, 5])
def test_writers_read_back_through_pil(tmp_path, kind):
    """core/blp.write_blp2 and core/ftex.write_ftex, which write the demo
    scenes' textures, write files PIL reads, as the port does; DXT5's
    alpha of 0 and 255 stays exact (the leaf's cutouts)."""
    from tracerboy_tpu_torch.core.ftex import write_ftex
    from tracerboy_tpu_torch.utils.demo_scene import leaf_image

    leaf = image_io._to_uint8(leaf_image(40))
    path = tmp_path / "l.blp"
    blp.write_blp2(str(path), leaf, kind)
    got = assert_as_jax(path)
    assert got is not None and got.shape[-1] == (4 if kind == 5 else 3)
    if kind == 5:
        assert np.array_equal(np.round(got[..., 3] * 255), leaf[..., 3])
    path = tmp_path / "l.ftex"
    write_ftex(str(path), leaf)
    assert assert_as_jax(path) is not None
