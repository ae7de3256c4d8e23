"""The port's JPEG 2000, GIF, EPS/PS and PDF writers (core/image_save.py;
the JPEG 2000 tile coder in csrc/j2k_encode.cpp, the GIF palettes and
LZW in csrc/gif_encode.cpp) against PIL 12.1's Image.save, byte for byte.

Hypothesis sweeps sizes 1-300 on each side, each mode, flat, gradient,
noise and few-colour content; a PDF is compared with both writers under
one patched time.gmtime (its dates equal). The sweeps cover .j2k against
.jpc (the bare codestream and the JP2 around the same codestream), .ps,
1x1 images, RGB GIFs of at most 256 colours (median cut then loses
nothing) and of more, RGBA GIFs with and without fully transparent
pixels. A JPEG 2000 file of the port decodes through core/jpeg2000.py to
its input exactly; a GIF of the port reads back through core/gif.py as
PIL reads it.
"""

import io
import time
from unittest import mock

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tracerboy_tpu_torch.core import image_save
from tracerboy_tpu_torch.core.gif import decode_gif, read_gif
from tracerboy_tpu_torch.core.jpeg2000 import decode_jpeg2000

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
CLOCK = time.struct_time((2026, 10, 18, 12, 34, 56, 6, 291, 0))


def content(kind: int, rng, h: int, w: int, c: int) -> np.ndarray:
    """(H, W, C) uint8: noise, black and white, a ramp, flat, Gaussian, or
    a few colours."""
    shape = (h, w, c)
    if kind == 0:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == 1:
        return rng.choice(np.array([0, 255], np.uint8), shape)
    if kind == 2:
        ramp = np.arange(w) * 255 // max(w - 1, 1)
        return np.broadcast_to(ramp.astype(np.uint8)[None, :, None],
                               shape).copy()
    if kind == 3:
        return np.full(shape, rng.integers(0, 256), np.uint8)
    if kind == 4:
        return rng.normal(128, 60, shape).clip(0, 255).astype(np.uint8)
    return (rng.integers(0, 6, shape) * 51).astype(np.uint8)


def image(mode: str, kind: int, seed: int, h: int, w: int) -> np.ndarray:
    img = content(kind, np.random.default_rng(seed), h, w, MODES[mode])
    return img[..., 0] if mode == "L" else img


def pil_bytes(img: np.ndarray, name: str) -> bytes:
    """Image.fromarray(img).save into memory under `name` (the plugins
    read the name: .j2k, the PDF title)."""
    b = io.BytesIO()
    b.name = name
    with mock.patch("time.gmtime", return_value=CLOCK):
        Image.fromarray(img).save(b, image_save.EXTENSION[
            name[name.rindex("."):]])
    return b.getvalue()


def port_bytes(img: np.ndarray, name: str) -> bytes:
    mode, px = image_save.image_mode(img)
    fmt = image_save.EXTENSION[name[name.rindex("."):]]
    with mock.patch("time.gmtime", return_value=CLOCK):
        return image_save.SAVE[fmt](px, mode, name)


def assert_as_pil(img: np.ndarray, name: str) -> bytes:
    got = port_bytes(img, name)
    assert got == pil_bytes(img, name), name
    return got


sizes = st.integers(1, 300)


@settings(max_examples=60, deadline=None)
@given(w=sizes, h=sizes, mode=st.sampled_from(list(MODES)),
       kind=st.integers(0, 5), seed=st.integers(0, 2**31))
def test_jpeg2000_sweep(w, h, mode, kind, seed):
    """.j2k (the codestream) against .jpc (its JP2), each PIL's bytes, and
    the codestream of one inside the other; the port's file decodes to
    its input exactly."""
    img = image(mode, kind, seed, h, w)
    stream = assert_as_pil(img, "x.j2k")
    jp2 = assert_as_pil(img, "x.jpc")
    assert jp2.endswith(b"jp2c" + stream)
    assert_round_trip(img, mode, stream)


def assert_round_trip(img, mode, data):
    got, got_mode, _ = decode_jpeg2000(data)
    assert got_mode == mode
    if mode == "L":
        assert np.array_equal(got, img)
    elif mode == "LA":
        assert np.array_equal(got[..., [0, 3]], img)
    else:
        assert np.array_equal(got[..., :MODES[mode]], img)


@settings(max_examples=80, deadline=None)
@given(w=sizes, h=sizes, mode=st.sampled_from(list(MODES)),
       kind=st.integers(0, 5), seed=st.integers(0, 2**31),
       transparent=st.floats(0, 0.5))
def test_gif_sweep(w, h, mode, kind, seed, transparent):
    """GIF of each mode; an RGBA image with a share of its pixels fully
    transparent (none at 0); read back through core/gif.py as PIL reads
    the file."""
    img = image(mode, kind, seed, h, w)
    if mode == "RGBA":
        cut = np.random.default_rng(seed + 1).random((h, w)) < transparent
        img[..., 3][cut] = 0
    data = assert_as_pil(img, "x.gif")
    assert_reads_as_pil(data)


def assert_reads_as_pil(data: bytes) -> None:
    with Image.open(io.BytesIO(data)) as im:
        index, mode, table = decode_gif(data)
        assert mode == im.mode
        assert np.array_equal(index, np.asarray(im))
        assert np.array_equal(read_gif(data), np.asarray(im.convert("RGB")))


@settings(max_examples=30, deadline=None)
@given(w=sizes, h=sizes, mode=st.sampled_from(["L", "RGB"]),
       kind=st.integers(0, 5), seed=st.integers(0, 2**31),
       ext=st.sampled_from([".eps", ".ps"]))
def test_eps_sweep(w, h, mode, kind, seed, ext):
    assert_as_pil(image(mode, kind, seed, h, w), "x" + ext)


@settings(max_examples=30, deadline=None)
@given(w=sizes, h=sizes, mode=st.sampled_from(list(MODES)),
       kind=st.integers(0, 5), seed=st.integers(0, 2**31))
def test_pdf_sweep(w, h, mode, kind, seed):
    assert_as_pil(image(mode, kind, seed, h, w), "page.pdf")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["x.jp2", "x.j2k", "x.jpc", "x.gif",
                                  "x.eps", "x.ps", "x.pdf"])
def test_one_pixel(name, mode):
    """1x1 images: JPEG 2000 with no wavelet level, a GIF table of 4
    entries, EPS's single hex line, PDF; EPS refuses LA and RGBA with
    PIL's ValueError."""
    img = np.array([[[200, 10, 99, 0]]], np.uint8)[..., :MODES[mode]]
    img = img[..., 0] if mode == "L" else img
    if name.endswith("ps") and mode in ("LA", "RGBA"):
        with pytest.raises(ValueError):
            pil_bytes(img, name)
        with pytest.raises(ValueError):
            port_bytes(img, name)
        return
    assert_as_pil(img, name)


@pytest.mark.parametrize("colours", [1, 2, 3, 17, 256, 257, 4000])
def test_gif_rgb_palette_sizes(colours):
    """RGB images of 1 to 256 colours come back exactly (median cut splits
    every colour into a box of its own); of more, PIL's palette all the
    same."""
    rng = np.random.default_rng(colours)
    table = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    img = table[rng.integers(0, colours, (40, 61))]
    data = assert_as_pil(img, "x.gif")
    assert_reads_as_pil(data)
    if len(np.unique(img.reshape(-1, 3), axis=0)) <= 256:
        assert np.array_equal(read_gif(data), img)


@pytest.mark.parametrize("transparent", [False, True])
@pytest.mark.parametrize("size", [(7, 9), (40, 61), (300, 257)])
def test_gif_rgba_transparency(size, transparent):
    """The fast octree's palette; with fully transparent pixels, of
    several colours, the palette entry PIL makes transparent (GIF89a and
    a graphic control extension) where one is used."""
    h, w = size
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[: h // 2, : w // 2] = (10, 20, 30, 255)
    if transparent:
        img[..., 3][rng.random((h, w)) < 0.25] = 0
    data = assert_as_pil(img, "x.gif")
    assert_reads_as_pil(data)


def test_gif_large_image_keeps_its_palette():
    """At 512 x 512 pixels and more PIL keeps the quantiser's whole
    palette (no remap), and the LZW data spans ImageFile's 65,536-byte
    buffers."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (512, 520, 3), dtype=np.uint8)
    img[:100] //= 16
    data = assert_as_pil(img, "x.gif")
    assert len(data) > 3 * 65536
    assert_reads_as_pil(data)


def test_l_gif_and_jpeg2000_round_trip_exactly():
    """A grey GIF and every mode's JPEG 2000 give their inputs back."""
    rng = np.random.default_rng(11)
    grey = rng.integers(0, 256, (33, 70), dtype=np.uint8)
    assert np.array_equal(read_gif(port_bytes(grey, "g.gif"))[..., 0], grey)
    for mode, c in MODES.items():
        img = rng.integers(0, 256, (45, 66, c), dtype=np.uint8)
        img = img[..., 0] if mode == "L" else img
        assert_round_trip(img, mode, port_bytes(img, "x.jp2"))


def test_pdf_dates_are_the_current_time(tmp_path):
    """Unpatched, the port's PDF carries the time of the save in PIL's
    format, and equals PIL's file with both dates masked."""
    from make_write_fixtures import PDF_DATE, mask_pdf_dates

    img = np.random.default_rng(2).integers(0, 256, (20, 30, 3), np.uint8)
    (tmp_path / "t").mkdir()
    (tmp_path / "p").mkdir()
    before = time.strftime("%Y%m%d%H%M%S", time.gmtime())
    image_save.save(str(tmp_path / "t" / "d.pdf"), img)
    after = time.strftime("%Y%m%d%H%M%S", time.gmtime())
    data = (tmp_path / "t" / "d.pdf").read_bytes()
    dates = [m.group()[3:17].decode() for m in PDF_DATE.finditer(data)]
    assert len(dates) == 2 and all(before <= d <= after for d in dates)
    Image.fromarray(img).save(tmp_path / "p" / "d.pdf")
    assert mask_pdf_dates(data) == mask_pdf_dates(
        (tmp_path / "p" / "d.pdf").read_bytes())
