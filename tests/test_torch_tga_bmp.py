"""The port's TGA and BMP readers (core/image_io.read_tga, read_bmp, through
read_ldr) against PIL-written files and the JAX package's read_ldr, which
reads them through PIL; and the port's writers (write_tga, write_bmp)
read back by PIL.

Tolerances: none. Each decoded image equals the JAX read_ldr's, value for
value, mode conversion included (grey and palette images become RGB,
32-bit TGA stays RGBA, a 32-bit BMP without an alpha mask drops its
fourth byte as PIL does).
"""

import struct

import numpy as np
import pytest
from PIL import Image

from tracerboy_tpu.core import image_io as jio
from tracerboy_tpu_torch.core import image_io as tio

RNG = np.random.default_rng(20261017)
RGBA = RNG.integers(0, 256, (13, 17, 4), dtype=np.uint8)
RGBA[2:5, 3:12] = RGBA[2, 3]          # runs for the RLE packets


def pil_image(mode):
    if mode == "P":
        return Image.fromarray(RGBA[..., :3]).quantize(37)
    if mode == "RGBA":
        return Image.fromarray(RGBA)
    return Image.fromarray(RGBA[..., :3]).convert(mode)


def same_as_jax(path):
    want = jio.read_ldr(str(path))
    got = tio.read_ldr(str(path))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
@pytest.mark.parametrize("layout", [
    {}, {"compression": "tga_rle"}, {"orientation": 1},
    {"compression": "tga_rle", "orientation": 1}])
def test_pil_written_tga(tmp_path, mode, layout):
    """8-bit grey and colour-mapped, 24- and 32-bit; uncompressed and RLE;
    bottom-left (PIL's default) and top-left origins."""
    p = tmp_path / "t.tga"
    pil_image(mode).save(p, **layout)
    got = same_as_jax(p)
    assert got.shape[-1] == (4 if mode == "RGBA" else 3)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_pil_written_bmp(tmp_path, mode):
    """24-bit, 32-bit (PIL reads it back as RGB), 8-bit grey ramp and
    8-bit palette, bottom-up."""
    p = tmp_path / "t.bmp"
    pil_image(mode).save(p)
    got = same_as_jax(p)
    assert got.shape[-1] == 3


def _bmp_v5(img, top_down, masks):
    """A 32-bit BITMAPV5HEADER BMP with bit-field masks (r, g, b, a)."""
    h, w, _ = img.shape
    px = np.zeros((h, w), "<u4")
    for c, m in enumerate(masks):
        if m:
            shift = (m & -m).bit_length() - 1
            px |= img[..., c].astype("<u4") << shift
    rows = px if top_down else px[::-1]
    head = struct.pack("<IiiHHIIiiII", 124, w, -h if top_down else h, 1, 32,
                       3, rows.nbytes, 2835, 2835, 0, 0)
    head += struct.pack("<IIII", *masks) + bytes(124 - len(head) - 16)
    return (b"BM" + struct.pack("<IHHI", 14 + 124 + rows.nbytes, 0, 0,
                                14 + 124) + head + rows.tobytes())


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("masks", [
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000),     # BGRA
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000),     # RGBA
    (0xFF0000, 0xFF00, 0xFF, 0x0)])           # BGRX
def test_bitfield_bmp(tmp_path, top_down, masks):
    p = tmp_path / "v5.bmp"
    p.write_bytes(_bmp_v5(RGBA, top_down, masks))
    got = same_as_jax(p)
    assert got.shape[-1] == (4 if masks[3] else 3)


@pytest.mark.parametrize("top_down", [False, True])
def test_24bit_bmp_both_directions(tmp_path, top_down):
    """A BITMAPINFOHEADER 24-bit BMP with a negative height (top-down) and
    padded rows (17 x 3 bytes rounds up to 52)."""
    h, w, _ = RGBA.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = RGBA[..., 2::-1].reshape(h, w * 3)
    rows = rows if top_down else rows[::-1]
    head = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, 24,
                       0, rows.size, 0, 0, 0, 0)
    p = tmp_path / "td.bmp"
    p.write_bytes(b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
                  + head + rows.tobytes())
    got = same_as_jax(p)
    np.testing.assert_array_equal(got, RGBA[..., :3] / np.float32(255))


@pytest.mark.parametrize("channels", [3, 4])
def test_port_writers_read_back_by_pil(tmp_path, channels):
    img = RGBA[..., :channels]
    p = tmp_path / "w.tga"
    tio.write_tga(str(p), img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    same_as_jax(p)
    if channels == 3:
        p = tmp_path / "w.bmp"
        tio.write_bmp(str(p), img)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
        same_as_jax(p)


def test_gamma_and_texture_dispatch(tmp_path):
    p = tmp_path / "t.tga"
    pil_image("RGB").save(p)
    np.testing.assert_array_equal(tio.read_texture(str(p)),
                                  jio.read_texture(str(p)))
    np.testing.assert_array_equal(
        tio.read_ldr(str(p), gamma_to_linear=True),
        jio.read_ldr(str(p), gamma_to_linear=True))


def test_formats_are_known_by_their_headers(tmp_path):
    """A TGA named .png, a BMP named .tga, a JPEG named .bmp and an IM
    named .bin decode by content as the JAX read_ldr decodes them, and
    so does a FITS named .bin (PIL's small formats part 3)."""
    tga = tmp_path / "is_tga.png"
    pil_image("RGB").save(tmp_path / "x.tga")
    tga.write_bytes((tmp_path / "x.tga").read_bytes())
    same_as_jax(tga)
    bmp = tmp_path / "is_bmp.tga"
    pil_image("RGB").save(tmp_path / "x.bmp")
    bmp.write_bytes((tmp_path / "x.bmp").read_bytes())
    same_as_jax(bmp)
    jpg = tmp_path / "is_jpeg.bmp"
    Image.fromarray(RGBA[..., :3]).save(tmp_path / "x.jpg")
    jpg.write_bytes((tmp_path / "x.jpg").read_bytes())
    same_as_jax(jpg)
    pil_image("RGB").save(tmp_path / "x.im")
    (tmp_path / "im.bin").write_bytes((tmp_path / "x.im").read_bytes())
    same_as_jax(tmp_path / "im.bin")
    cards = [b"SIMPLE  = T", b"BITPIX  = 8", b"NAXIS   = 2",
             b"NAXIS1  = 4", b"NAXIS2  = 4", b"END"]
    fits = b"".join(c.replace(b"= ", b"=" + b" " * 20).ljust(80)
                    for c in cards).ljust(2880) + bytes(2880)
    (tmp_path / "fits.bin").write_bytes(fits)
    same_as_jax(tmp_path / "fits.bin")
