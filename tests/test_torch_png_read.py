"""The port's PNG reader (core/image_io.read_ldr, read_png) against the
JAX package's read_ldr, which reads through PIL: pixel for pixel, with
and without the gamma decode, on files PIL writes in modes L, LA, P (with
and without tRNS), RGB, RGBA and I;16, and on files built with zlib by
tests/png_encode.encode_png: 16-bit RGB and RGBA, grey and palette images
at bit depths 1, 2 and 4, each row filter alone and all five mixed, and
Adam7. A truncated file, a bad CRC and an unknown filter are refused;
JPEG is read by core/jpeg.py. The port's side loads no PIL.
"""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

from png_encode import encode_png, seeded_rgba

from tracerboy_tpu.core.image_io import read_ldr as jax_read_ldr
from tracerboy_tpu_torch.core import image_io

torch.set_num_threads(2)


def _same_as_jax(path):
    """Assert the port reads `path` as the JAX read_ldr does, with and
    without the gamma decode; returns the port's plain read."""
    got = {}
    for gamma in (False, True):
        want = jax_read_ldr(str(path), gamma_to_linear=gamma)
        got[gamma] = image_io.read_ldr(str(path), gamma_to_linear=gamma)
        assert got[gamma].dtype == want.dtype == np.float32
        assert got[gamma].shape == want.shape
        np.testing.assert_array_equal(got[gamma], want)
    return got[False]


def _pil_file(tmp_path, name, arr, mode=None, **save):
    path = tmp_path / name
    Image.fromarray(arr, mode).save(path, **save) if mode else \
        Image.fromarray(arr).save(path, **save)
    return path


RNG = np.random.default_rng(3)
RGBA = RNG.integers(0, 256, (13, 17, 4), dtype=np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P_trns",
                                  "I;16"])
def test_pil_written_modes_match_jax(tmp_path, mode):
    if mode == "I;16":
        # Values across the clip at 255 that PIL's conversion applies.
        arr = RNG.integers(0, 700, (13, 17)).astype(np.uint16)
        arr[0, :4] = (0, 255, 256, 65535)
        path = _pil_file(tmp_path, "i16.png", arr)
        assert Image.open(path).mode == "I;16"
    elif mode.startswith("P"):
        idx = RNG.integers(0, 7, (13, 17), dtype=np.uint8)
        img = Image.fromarray(idx, "P")
        img.putpalette(list(RNG.integers(0, 256, 21, dtype=np.uint8)))
        path = tmp_path / "p.png"
        if mode == "P_trns":
            img.save(path, transparency=bytes([0, 128, 255, 7]))
            assert "transparency" in Image.open(path).info
        else:
            img.save(path)
    else:
        chans = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = RGBA[..., :chans] if chans > 1 else RGBA[..., 0]
        path = _pil_file(tmp_path, f"{mode}.png", arr, mode)
    got = _same_as_jax(path)
    assert got.shape[-1] == (4 if "A" in mode else 3)


@pytest.mark.parametrize("ctype,depth", [(2, 16), (6, 16), (0, 16), (4, 16),
                                         (4, 8), (0, 1), (0, 2), (0, 4),
                                         (3, 1), (3, 2), (3, 4), (3, 8)])
def test_depths_and_colour_types_match_jax(tmp_path, ctype, depth):
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) if ctype != 3 else min(1 << depth, 9)
    samples = RNG.integers(0, top, (11, 19, chans))
    pal = RNG.integers(0, 256, (9, 3), dtype=np.uint8) if ctype == 3 \
        else None
    path = tmp_path / "f.png"
    path.write_bytes(encode_png(samples, ctype, depth, filters=(0, 1, 2, 3, 4),
                                palette=pal))
    raw, ct, dp, _ = image_io.read_png(str(path))
    assert (ct, dp) == (ctype, depth)
    np.testing.assert_array_equal(raw, samples)
    _same_as_jax(path)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("interlace", [False, True])
def test_each_filter_and_adam7_match_jax(tmp_path, filt, interlace):
    img = seeded_rgba(37, seed=5)[:29]        # odd sizes: partial passes
    filters = (0, 1, 2, 3, 4) if filt == "mixed" else (filt,)
    path = tmp_path / "f.png"
    path.write_bytes(encode_png(img, 6, 8, filters=filters,
                                interlace=interlace))
    got = _same_as_jax(path)
    np.testing.assert_array_equal(got, img / np.float32(255.0))


@pytest.mark.parametrize("size", [(1, 1), (1, 9), (9, 1), (3, 5)])
def test_tiny_interlaced_images(tmp_path, size):
    """Images smaller than the 8x8 Adam7 tile leave passes empty."""
    samples = RNG.integers(0, 65536, size + (3,))
    path = tmp_path / "t.png"
    path.write_bytes(encode_png(samples, 2, 16, filters=(4, 3),
                                interlace=True))
    np.testing.assert_array_equal(image_io.read_png(str(path))[0], samples)
    _same_as_jax(path)


def test_written_pngs_read_back(tmp_path):
    """The port's own writer (PIL's row filters) round-trips."""
    img = RGBA[..., :3] / np.float32(255.0)
    image_io.write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(
        _same_as_jax(tmp_path / "w.png"), img)


def _good_file():
    return encode_png(RGBA, 6, 8, filters=(1, 4))


def test_truncated_file_is_refused(tmp_path):
    """A file cut short in its image data is refused (ValueError); one
    cut in a chunk header or CRC before the first IDAT is not
    identified, as PIL's PNG plugin gives it up (NotImplementedError,
    PIL's UnidentifiedImageError), and one cut in the IHDR chunk's body
    is refused as PIL's Truncated File Read."""
    from test_torch_small_sgi_pcx import assert_as_jax

    data = _good_file()
    for cut in (len(data) - 12, len(data) // 2):
        p = tmp_path / f"cut{cut}.png"
        p.write_bytes(data[:cut])
        with pytest.raises(ValueError, match="truncated"):
            image_io.read_ldr(str(p))
    for cut in (40, 30, 20, 12):
        assert assert_as_jax(tmp_path / f"cut{cut}.png", data[:cut]) is None
    with pytest.raises(NotImplementedError):
        image_io.read_ldr(str(tmp_path / "cut40.png"))
    with pytest.raises(ValueError):
        image_io.read_ldr(str(tmp_path / "cut20.png"))


def test_bad_crc_is_refused(tmp_path):
    data = bytearray(_good_file())
    data[len(data) // 2] ^= 0x40         # a byte inside an IDAT chunk
    p = tmp_path / "crc.png"
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_ldr(str(p))


def test_unknown_filter_is_refused(tmp_path):
    import struct
    import zlib

    data = encode_png(RGBA, 6, 8)
    # The same file with its image data rebuilt: filter byte 5 in row 3.
    rows = np.zeros((13, 1 + 17 * 4), np.uint8)
    rows[:, 1:] = RGBA.reshape(13, -1)
    rows[3, 0] = 5
    body = zlib.compress(rows.tobytes())
    idat = (struct.pack(">I", len(body)) + b"IDAT" + body
            + struct.pack(">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF))
    start = data.index(b"IDAT") - 4
    end = data.index(b"IEND") - 4
    p = tmp_path / "f.png"
    p.write_bytes(data[:start] + idat + data[end:])
    with pytest.raises(ValueError, match="filter type 5 in row 3"):
        image_io.read_ldr(str(p))


def test_jpeg_still_raises(tmp_path):
    """A JPEG beside the PNGs reads as the JAX read_ldr reads it
    (core/jpeg.py; tests/test_torch_jpeg.py covers the decoder)."""
    from tracerboy_tpu.core.image_io import read_ldr as jax_read_ldr

    p = tmp_path / "x.jpg"
    Image.fromarray(RGBA[..., :3]).save(p)
    assert np.array_equal(image_io.read_ldr(str(p)), jax_read_ldr(str(p)))


def test_texture_dispatch_reads_png(tmp_path):
    """read_texture sends .png to read_ldr with the gamma decode on by
    default, as the JAX dispatch does."""
    from tracerboy_tpu.core.image_io import read_texture as jax_read_texture

    p = _pil_file(tmp_path, "t.png", RGBA, "RGBA")
    for kw in ({}, {"gamma_to_linear_ldr": False}):
        np.testing.assert_array_equal(image_io.read_texture(str(p), **kw),
                                      jax_read_texture(str(p), **kw))


def test_port_reader_imports_no_pil(tmp_path):
    import subprocess

    p = tmp_path / "a.png"
    p.write_bytes(encode_png(np.ones((4, 4, 3), np.uint8), 2, 8,
                             filters=(4,)))
    code = ("import sys; "
            "from tracerboy_tpu_torch.core import image_io as m; "
            f"m.read_ldr({str(p)!r}); "
            "assert 'PIL' not in sys.modules, 'PIL loaded'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_decoder_timing_script(capsys):
    """The timing entry point decodes its mixed-filter file and prints one
    JSON line."""
    import json

    import png_encode

    png_encode.main(["--size", "64", "--runs", "2"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["size"] == 64 and len(res["seconds"]) == 2
    assert res["file_bytes"] > 0 and res["median_s"] > 0
