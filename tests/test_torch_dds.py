"""The port's DDS reader (core/dds.py, csrc/dds_decode.cpp, through
core/image_io.read_ldr) against the JAX package's read_ldr, which reads
DDS through PIL: every case must be equal bit for bit (np.array_equal),
as read_ldr returns it (float32 / 255, with and without gamma_to_linear).

The committed fixtures (tests/data/dds, written by
tests/make_dds_fixtures.py) are held against PIL and their manifest.
Hypothesis sweeps random blocks of every BCn format (random bits under
each BC7 mode prefix and BC6H mode code, the reserved ones included) and
random pixels under every uncompressed layout at 8x8 to 20x12, sizes
that are not multiples of 4 among them. Bad headers and unknown formats
raise PIL's errors (ValueError where PIL raises OSError). A textured
scene with a BC7 albedo and a DXT1 cutout leaf compiles to the JAX
package's leaves bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, UnidentifiedImageError

from dds_encode import (
    BC6H_CODES,
    BCN,
    DDPF_FOURCC,
    DDPF_LUMINANCE,
    bcn_file,
    dds_header,
    n_blocks,
    random_blocks,
)
from make_dds_fixtures import (
    ALBEDO,
    FIXTURE_DIR,
    LEAF,
    MASK_LAYOUTS,
    array_digest,
    luminance_file,
    mask_file,
    palette_file,
    pil_pixels,
    rgba8_file,
)
from tracerboy_tpu_torch.core import dds, image_io

torch.set_num_threads(2)

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
DDS_FIXTURES = sorted(n for n in MANIFEST["files"] if n.endswith(".dds"))
SIZES = dict(w=st.integers(8, 20), h=st.integers(8, 12))


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("dds")


def jax_read_ldr(path, **kw):
    from tracerboy_tpu.core.image_io import read_ldr

    return read_ldr(str(path), **kw)


def assert_as_jax(path, data: bytes):
    """Write `data` to `path` and read it with read_ldr in both packages:
    equal float32 images (returns the port's), or the matching refusal
    (returns None): NotImplementedError where PIL raises it or cannot
    identify the file, ValueError where it raises another OSError or a
    ValueError."""
    path.write_bytes(data)
    try:
        ref = jax_read_ldr(path)
    except (NotImplementedError, UnidentifiedImageError):
        with pytest.raises(NotImplementedError):
            image_io.read_ldr(str(path))
        return None
    except (OSError, ValueError):
        with pytest.raises(ValueError):
            image_io.read_ldr(str(path))
        return None
    got = image_io.read_ldr(str(path))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got, ref), (
        np.abs(got - ref).max() * 255, (got != ref).mean())
    return got


@pytest.mark.parametrize("name", DDS_FIXTURES)
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
    too. The committed data stays under 400 KiB."""
    names = set(os.listdir(FIXTURE_DIR)) - {"manifest.json"}
    assert names == set(MANIFEST["files"])
    for name, entry in MANIFEST["files"].items():
        path = os.path.join(FIXTURE_DIR, name)
        assert array_digest(pil_pixels(path)) == entry, name
        assert array_digest(image_io.decode_ldr(path)) == entry, name
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, n))
                for n in os.listdir(FIXTURE_DIR))
    assert total < 400 << 10


@pytest.mark.parametrize("fmt", sorted(set(BCN) - {"BC6H", "BC6HS", "BC7",
                                                   "BC7_SRGB",
                                                   "BC7_TYPELESS"}))
@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), **SIZES)
def test_random_bc1_to_bc5_blocks(scratch, fmt, seed, w, h):
    """BC1-BC5 under every FourCC and DXGI code: BC1's 3-colour mode,
    BC3/BC4 6- and 8-value ramps, BC5S's signed endpoints."""
    rng = np.random.default_rng(seed)
    data = bcn_file(fmt, w, h, random_blocks(rng, fmt, n_blocks(w, h)))
    assert assert_as_jax(scratch / "bc.dds", data) is not None


@pytest.mark.parametrize("fmt", ["BC7", "BC7_SRGB", "BC7_TYPELESS"])
@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), mode=st.integers(0, 8), **SIZES)
def test_random_bc7_blocks(scratch, fmt, seed, mode, w, h):
    """Random bits under each BC7 mode prefix (mode 8: a first byte of 0)
    cover every partition, rotation, index selection and p-bit."""
    rng = np.random.default_rng(seed)
    data = bcn_file(fmt, w, h, random_blocks(rng, fmt, n_blocks(w, h),
                                             mode))
    assert assert_as_jax(scratch / "bc7.dds", data) is not None


@pytest.mark.parametrize("fmt", ["BC6H", "BC6HS"])
@settings(max_examples=50, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       mode=st.integers(0, len(BC6H_CODES) - 1), **SIZES)
def test_random_bc6h_blocks(scratch, fmt, seed, mode, w, h):
    """Random bits under each BC6H mode code, the reserved ones included,
    unsigned and signed (PIL's unmasked signed delta sums)."""
    rng = np.random.default_rng(seed)
    data = bcn_file(fmt, w, h, random_blocks(rng, fmt, n_blocks(w, h),
                                             mode))
    assert assert_as_jax(scratch / "bc6.dds", data) is not None


@pytest.mark.parametrize("layout", sorted(MASK_LAYOUTS))
@settings(max_examples=20, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), short=st.integers(0, 5), **SIZES)
def test_random_mask_layouts(scratch, layout, seed, short, w, h):
    """PIL's dds_rgb decoder by its masks, up to 5 bytes of the pixel data
    missing (read as zeros, as PIL reads them)."""
    bits, masks = MASK_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, w * h * bits // 8 - short,
                           dtype=np.uint8).tobytes()
    data = mask_file(w, h, bits, masks, payload)
    assert assert_as_jax(scratch / "m.dds", data) is not None


@settings(max_examples=50, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), bits=st.sampled_from([8, 16, 24, 32]),
       alpha=st.booleans(), **SIZES)
def test_random_masks(scratch, seed, bits, alpha, w, h):
    """Any masks of the pixel's bits, contiguous or not, overlapping or
    zero: each channel is int(field / (mask >> shift) * 255)."""
    rng = np.random.default_rng(seed)
    masks = [int(rng.integers(0, 1 << bits)) >> int(rng.integers(0, bits))
             for _ in range(4 if alpha else 3)]
    payload = rng.integers(0, 256, w * h * bits // 8, dtype=np.uint8)
    data = mask_file(w, h, bits, masks, payload.tobytes())
    assert assert_as_jax(scratch / "rm.dds", data) is not None


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       kind=st.sampled_from(["L", "LA", "P", "RGBA8", "RGBA8_SRGB"]),
       **SIZES)
def test_random_luminance_palette_and_rgba8(scratch, seed, kind, w, h):
    rng = np.random.default_rng(seed)

    def noise(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    data = {"L": lambda: luminance_file(w, h, False, noise(w * h)),
            "LA": lambda: luminance_file(w, h, True, noise(2 * w * h)),
            "P": lambda: palette_file(w, h, noise(1024), noise(w * h)),
            "RGBA8": lambda: rgba8_file(w, h, noise(4 * w * h)),
            "RGBA8_SRGB": lambda: rgba8_file(w, h, noise(4 * w * h), 29),
            }[kind]()
    got = assert_as_jax(scratch / "l.dds", data)
    assert got.shape[-1] == (4 if kind in ("LA", "RGBA8", "RGBA8_SRGB")
                             else 3)


def _errors():
    head = dds_header(12, 8, pfflags=DDPF_LUMINANCE, bitcount=8)
    return {
        "header_size": (dds_header(12, 8, pfflags=DDPF_LUMINANCE, bitcount=8,
                                   header_size=100) + bytes(96),
                        ValueError, "Unsupported header size 100"),
        "short_header": (head[:60], ValueError, "Incomplete header"),
        "luminance_bits": (dds_header(12, 8, pfflags=DDPF_LUMINANCE,
                                      bitcount=16) + bytes(192),
                           ValueError, "Unsupported bitcount 16"),
        "fourcc": (dds_header(12, 8, pfflags=DDPF_FOURCC, fourcc=b"BC4S")
                   + bytes(48), NotImplementedError,
                   "Unimplemented pixel format"),
        "dxgi": (dds_header(12, 8, pfflags=0, dxgi=2) + bytes(1536),
                 NotImplementedError, "Unimplemented DXGI format 2"),
        "flags": (dds_header(12, 8, pfflags=0x2) + bytes(96),
                  NotImplementedError, "Unknown pixel format flags 2"),
        "truncated_blocks": (bcn_file("DXT5", 12, 8, bytes(80)), ValueError,
                             "truncated"),
        "truncated_pixels": (head + bytes(95), ValueError, "truncated"),
    }


@pytest.mark.parametrize("case", sorted(_errors()))
def test_bad_files_raise_as_pil_does(tmp_path, case):
    """The error PIL raises (OSError -> ValueError; NotImplementedError
    as it is), with PIL's message."""
    data, port_error, message = _errors()[case]
    path = tmp_path / "bad.dds"
    path.write_bytes(data)
    pil_error = OSError if port_error is ValueError else port_error
    with pytest.raises(pil_error):
        jax_read_ldr(path)
    with pytest.raises(port_error, match=message):
        image_io.read_ldr(str(path))


def test_dds_is_known_by_its_magic(tmp_path):
    """A DDS named .tga and .png reads as DDS (PIL's _accept: the magic
    "DDS "), ahead of the TGA header heuristic."""
    data = open(os.path.join(FIXTURE_DIR, "random_bc7_mode4.dds"),
                "rb").read()
    for name in ("t.tga", "t.png"):
        (tmp_path / name).write_bytes(data)
        assert np.array_equal(image_io.read_ldr(str(tmp_path / name)),
                              jax_read_ldr(tmp_path / name))
    assert dds.decode_dds(data)[1] == "RGBA"


def test_bcn_surface_crops_and_orders_blocks():
    """decode_bcn against a numpy assembly of one-block decodes: blocks in
    rows, cropped at the right and bottom edges (18x13: a partial column
    and row of blocks)."""
    rng = np.random.default_rng(7)
    w, h = 18, 13
    blocks = random_blocks(rng, "BC7", n_blocks(w, h))
    got = dds.decode_bcn(blocks, w, h, 7)
    bw = (w + 3) // 4
    for i in range(n_blocks(w, h)):
        one = dds.decode_bcn(blocks[16 * i:16 * i + 16], 4, 4, 7)
        y, x = 4 * (i // bw), 4 * (i % bw)
        part = got[y:y + 4, x:x + 4]
        assert np.array_equal(part, one[:part.shape[0], :part.shape[1]])


def test_dds_textured_scene_compiles_as_jax(tmp_path):
    """utils/demo_scene's textured scene (small) with its albedo the BC7
    fixture and its leaf the DXT1 cutout fixture: the PBRT scene compiles
    in both packages to the same leaves, bit for bit (the textures' texels
    and the leaf's alpha among them)."""
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
    leaf = np.asarray(Image.open(os.path.join(FIXTURE_DIR, LEAF)))
    assert 0.3 < (leaf[..., 3] == 0).mean() < 0.7     # BC1's 1-bit alpha
