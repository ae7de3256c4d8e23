"""The port's JPEG decoder (core/jpeg.py, csrc/jpeg_decode.cpp) against
PIL, which the JAX package's read_ldr calls: every case must be equal bit
for bit (np.array_equal), as read_ldr returns it (float32 / 255) and as
the uint8 array. The committed fixtures (tests/data/jpeg, written by
tests/make_jpeg_fixtures.py) are held against PIL and their manifest; a
hypothesis sweep encodes random images with PIL; tests/jpeg_encode.py
writes the layouts PIL's encoder does not (h1v2, 4:1:1, chroma sampled
above luma, grey at 2x2, RGB by Adobe marker or component ids) and
coefficients beyond the range of an image. Each place where libjpeg's
arithmetic is easy to lose has a case of its own.
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

from jpeg_encode import encode_coefficients, encode_image, encode_lossless
from make_jpeg_fixtures import FIXTURE_DIR, array_digest, small_image
from tracerboy_tpu_torch.core import image_io
from tracerboy_tpu_torch.core.jpeg import UNSUPPORTED, decode_jpeg

MANIFEST = json.load(open(os.path.join(FIXTURE_DIR, "manifest.json")))


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def pil_bytes(img, **opts) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **opts)
    return b.getvalue()


def assert_as_pil(data: bytes):
    got = decode_jpeg(data)
    ref = pil_rgb(data)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.array_equal(got, ref), (
        np.abs(got.astype(int) - ref).max(), (got != ref).mean())


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_reads_as_the_jax_read_ldr(name):
    from tracerboy_tpu.core.image_io import read_ldr as jax_read_ldr

    path = os.path.join(FIXTURE_DIR, name)
    got = image_io.read_ldr(path)
    ref = jax_read_ldr(path)
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


def test_manifest_matches_the_files():
    """Every fixture is in the manifest, and PIL's decode of each has the
    recorded shape, dtype and sha256 (so the card's machine, which has no
    PIL, checks the port against PIL's arrays)."""
    names = {n for n in os.listdir(FIXTURE_DIR) if n.endswith(".jpg")}
    assert names == set(MANIFEST["files"])
    for name, entry in MANIFEST["files"].items():
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            data = f.read()
        assert array_digest(pil_rgb(data)) == entry, name
        assert array_digest(decode_jpeg(data)) == entry, name
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, n)) for n in
                os.listdir(FIXTURE_DIR))
    assert total < 1 << 20


@settings(max_examples=40, deadline=None, derandomize=True)
@given(w=st.integers(1, 130), h=st.integers(1, 130),
       quality=st.integers(1, 100), subsampling=st.integers(0, 2),
       progressive=st.booleans(), optimize=st.booleans(),
       restart=st.integers(0, 4), grey=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_pil_encoded_images(w, h, quality, subsampling, progressive,
                            optimize, restart, grey, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(x / 5.0 + seed % 7),
                    128 + 90 * np.cos(y / 3.0), (x * 7 + y * 3) % 256], -1)
    img = np.clip(img + rng.normal(0.0, 25.0, img.shape), 0,
                  255).astype(np.uint8)
    opts = dict(quality=quality, subsampling=subsampling,
                progressive=progressive, optimize=optimize)
    if restart:
        opts["restart_marker_blocks"] = restart
    assert_as_pil(pil_bytes(img[..., 0] if grey else img, **opts))


def test_idct_output_saturates():
    """jidctint.c's lookup through prepare_range_limit_table (index &
    RANGE_MASK) wraps pass-2 values beyond +-512; the SIMD IDCT that PIL
    runs saturates them. Quality 1 noise, and a block whose two large AC
    coefficients push samples far out of range, read as PIL reads them;
    coefficients beyond the SIMD's 16-bit range are refused."""
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    for subsampling in (0, 2):
        assert_as_pil(pil_bytes(noise, quality=1, subsampling=subsampling))
    block = np.zeros((1, 1, 64), np.int64)
    block[0, 0, [0, 1, 9]] = (50, 200, -200)
    data = encode_coefficients([block], 8, 8, [(1, 1)], [np.full(64, 8)])
    got = decode_jpeg(data)
    assert (got == 0).any() and (got == 255).any()
    assert_as_pil(data)
    block[0, 0, [0, 1, 9]] = (1500, 0, 0)
    data = encode_coefficients([block], 8, 8, [(1, 1)], [np.full(64, 8)])
    with pytest.raises(NotImplementedError, match=UNSUPPORTED):
        decode_jpeg(data)


@pytest.mark.parametrize("subsampling", [1, 2])
def test_narrow_chroma_replicates(subsampling):
    """Fancy h2v1/h2v2 upsampling only where the chroma's downsampled
    width is above 2 (widths 1-4 give 1-2 chroma columns: replication),
    and at widths 5-6 the fancy path's first and last columns."""
    rng = np.random.default_rng(subsampling)
    for w in range(1, 7):
        for h in (1, 2, 3, 9):
            img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            assert_as_pil(pil_bytes(img, quality=90,
                                    subsampling=subsampling))


def test_non_interleaved_block_counts():
    """A non-interleaved scan covers ceil(component width / 8) blocks a
    row, not the MCU-padded count: a grey image sampled 2x2 (one scan of
    one component whose MCU would be 16 pixels wide) and progressive
    4:2:0 AC scans at odd sizes."""
    img = small_image(3)
    data = encode_image(img[..., 1], [(2, 2)], [np.full(64, 3)])
    assert_as_pil(data)
    for w, h in ((97, 61), (17, 9), (8, 23)):
        assert_as_pil(pil_bytes(img[:h, :w], quality=75, subsampling=2,
                                progressive=True))


@pytest.mark.parametrize("sampling", [
    [(1, 2), (1, 1), (1, 1)],       # h1v2_fancy_upsample
    [(4, 1), (1, 1), (1, 1)],       # int_upsample 4x1
    [(3, 1), (1, 1), (1, 1)],       # int_upsample 3x1
    [(1, 4), (1, 1), (1, 1)],       # int_upsample 1x4
    [(2, 2), (1, 2), (1, 1)],       # h2v1 fancy and h2v2 fancy
    [(1, 1), (2, 2), (1, 1)],       # chroma sampled above luma
])
def test_sampling_layouts(sampling):
    img = small_image(4)
    q = [np.full(64, 4), np.full(64, 6), np.full(64, 6)]
    for w, h in ((97, 61), (5, 3), (1, 1), (33, 17)):
        assert_as_pil(encode_image(img[:h, :w], sampling, q))


def test_fractional_sampling_raises_as_pil_does():
    data = encode_image(small_image(4), [(3, 2), (2, 1), (1, 1)],
                        [np.full(64, 4)] * 3)
    with pytest.raises(OSError):
        pil_rgb(data)
    with pytest.raises(OSError, match="fractional"):
        decode_jpeg(data)


@pytest.mark.parametrize("restart", [1, 2, 5])
def test_restart_resets_predictors(restart):
    """Each restart interval resets the DC predictors (sequential) and
    EOBRUN (progressive)."""
    img = small_image(6)
    q = [np.full(64, 5)] * 3
    assert_as_pil(encode_image(img, [(2, 2), (1, 1), (1, 1)], q,
                               restart=restart))
    assert_as_pil(pil_bytes(img, quality=60, subsampling=2,
                            progressive=True,
                            restart_marker_blocks=restart))


@pytest.mark.parametrize("markers", [
    dict(jfif=True), dict(jfif=False, adobe=0), dict(jfif=False, adobe=1),
    dict(jfif=False, adobe=7), dict(jfif=False, ids=[82, 71, 66]),
    dict(jfif=False, ids=[5, 6, 7]), dict(jfif=False)])
def test_colour_space_rules(markers):
    """libjpeg's default_decompress_parms: JFIF means YCbCr; else the
    Adobe transform (0 RGB, any other YCbCr); else component ids 'R',
    'G', 'B' mean RGB and any others YCbCr."""
    q = [np.full(64, 3)] * 3
    assert_as_pil(encode_image(small_image(7)[:20, :30], [(1, 1)] * 3, q,
                               **markers))


def _drop_last_scans(data: bytes, keep: int) -> bytes:
    """A progressive file cut after its first `keep` scans, closed by
    EOI."""
    pos, seen = 0, 0
    while True:
        pos = data.index(b"\xff\xda", pos + 1)
        seen += 1
        if seen > keep:
            return data[:pos] + b"\xff\xd9"


def test_cmyk_variant_reads_as_pil():
    """A CMYK JPEG as PIL saves it (Adobe transform 0), once refused as
    out of scope, decodes to PIL's pixels (tests/test_torch_jpeg_cmyk.py
    covers YCCK, sampling and BLP1)."""
    b = io.BytesIO()
    Image.fromarray(small_image(8)).convert("CMYK").save(b, "JPEG")
    assert np.array_equal(decode_jpeg(b.getvalue()), pil_rgb(b.getvalue()))


@pytest.mark.parametrize("kind", ["arithmetic", "lossless", "incomplete"])
def test_variants_read_as_pil(kind):
    """Once refused as out of scope, now read as PIL reads them: a PIL
    file whose SOF0 says SOF9 (its Huffman-coded data decoded as
    arithmetic-coded, as libjpeg decodes it), a lossless file, and a
    progressive file cut after 3 scans (block-smoothed).
    tests/test_torch_jpeg_variants.py covers each in depth."""
    img = small_image(8)
    if kind == "incomplete":
        data = _drop_last_scans(pil_bytes(img, progressive=True), 3)
    elif kind == "lossless":
        data = encode_lossless([img[..., k] for k in range(3)], 97, 61,
                               [(1, 1)] * 3, psv=4)
    else:
        data = pil_bytes(img).replace(b"\xff\xc0", b"\xff\xc9", 1)
    assert_as_pil(data)


def _patch_sof(data: bytes, code=None, precision=None, height=None):
    i = data.index(b"\xff\xc0")
    d = bytearray(data)
    if code is not None:
        d[i + 1] = code
    if precision is not None:
        d[i + 4] = precision
    if height is not None:
        d[i + 5:i + 7] = struct.pack(">H", height)
    return bytes(d)


@pytest.mark.parametrize("kind", ["hierarchical", "12-bit", "dnl"])
def test_out_of_scope_variants_raise(kind, tmp_path):
    """Refused as PIL refuses them, through decode_ldr: a hierarchical
    frame (SOF5-7, SOF13-15) or a lossless arithmetic-coded one (SOF11)
    raises OSError at load; a frame of a precision other than 8 bits, or
    of height 0 (a DNL-sized frame, with its DNL segment), is not
    identified (UnidentifiedImageError, "cannot identify image file")."""
    from PIL import UnidentifiedImageError as PilUnidentified

    from tracerboy_tpu_torch.core.image_io import UnidentifiedImageError

    data = pil_bytes(small_image(8)[:16, :16])
    if kind == "hierarchical":
        files = [_patch_sof(data, code=c)
                 for c in (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF)]
        want, port = OSError, OSError
    elif kind == "12-bit":
        files = [_patch_sof(data, precision=p) for p in (12, 16, 7)]
        files.append(_patch_sof(data, code=0xC1, precision=12))
        want, port = PilUnidentified, UnidentifiedImageError
    else:
        end = data.rindex(b"\xff\xd9")
        dnl = data[:end] + b"\xff\xdc\x00\x04\x00\x10" + data[end:]
        files = [_patch_sof(dnl, height=0), _patch_sof(data, height=0)]
        want, port = PilUnidentified, UnidentifiedImageError
    for n, f in enumerate(files):
        path = os.path.join(tmp_path, f"{n}.jpg")
        with open(path, "wb") as fh:
            fh.write(f)
        with pytest.raises(want):
            with Image.open(path) as im:
                im.convert("RGB")
        with pytest.raises(port, match="cannot identify image file"
                           if port is not OSError else "corrupt JPEG"):
            image_io.decode_ldr(path)


def test_corrupt_data_raises():
    data = pil_bytes(small_image(9), quality=80)
    for bad in (data[:len(data) // 2], data[:200], b"\xff\xd8\xff\xe0"):
        with pytest.raises(OSError):
            pil_rgb(bad)
        with pytest.raises(OSError):
            decode_jpeg(bad)
