"""The port's ICO and ICNS writers (core/image_save.py save_ico, save_icns)
and their resampler (core/resample.py, csrc/resample.cpp) against PIL
12.1, which the JAX write_png writes them through.

resize() is held bit for bit to Image.resize for BICUBIC and LANCZOS
over hypothesis sweeps of sides 1-300 (and outputs up to 1024, ICNS's
largest), each mode write_png makes (LA and RGBA through PIL's
premultiplied round trip), noise, flat, ramp and alpha of 0, 1, 128, 254
and 255; thumbnail_size to Image.thumbnail's size over a sweep of image
sizes and boxes. The writers' bytes are held to Image.fromarray(img).save
on a few swept images (an ICNS holds a 1024x1024 PNG), the empty and 1x1
images; the written files are read back by the port's read_ldr as the
JAX read_ldr reads PIL's, and both CLIs write --out x.ico and its
--capture-every frames alike. tests/test_torch_image_write.py holds the
committed inputs (and their manifest) in every mode, uint8 and float.
"""

import io
import textwrap

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tracerboy_tpu_torch.core import image_io, image_save, resample

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
FILTERS = {"BICUBIC": resample.BICUBIC, "LANCZOS": resample.LANCZOS}


def content(kind: int, rng, h: int, w: int, c: int) -> np.ndarray:
    """(h, w, c) uint8: noise, flat, a ramp or black and white; an alpha
    band drawn from 0, 1, 128, 254 and 255 (or flat at one of them)."""
    shape = (h, w, c)
    if kind == 0:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
    elif kind == 1:
        img = np.full(shape, rng.integers(0, 256), np.uint8)
    elif kind == 2:
        ramp = (np.arange(w) * 255 // max(w - 1, 1)).astype(np.uint8)
        img = np.broadcast_to(ramp[None, :, None], shape).copy()
    else:
        img = rng.choice(np.array([0, 255], np.uint8), shape)
    if c in (2, 4):
        alphas = np.array([0, 1, 128, 254, 255], np.uint8)
        img[..., -1] = (rng.choice(alphas, (h, w)) if rng.random() < 0.7
                        else rng.choice(alphas))
    return img


def pil_image(img: np.ndarray) -> Image.Image:
    return Image.fromarray(img[..., 0] if img.shape[2] == 1 else img)


def pil_resize(img: np.ndarray, size, filter_id) -> np.ndarray:
    out = np.asarray(pil_image(img).resize(size, filter_id))
    return out.reshape(size[1], size[0], img.shape[2])


def check_resize(w, h, ow, oh, mode, kind, name, seed):
    c = MODES[mode]
    img = content(kind, np.random.default_rng(seed), h, w, c)
    got = resample.resize(img, mode, (ow, oh), FILTERS[name])
    np.testing.assert_array_equal(got, pil_resize(img, (ow, oh),
                                                  FILTERS[name]))


@settings(max_examples=400, deadline=None)
@given(w=st.integers(1, 300), h=st.integers(1, 300),
       ow=st.integers(1, 300), oh=st.integers(1, 300),
       mode=st.sampled_from(list(MODES)), kind=st.integers(0, 3),
       name=st.sampled_from(list(FILTERS)), seed=st.integers(0, 2**31))
def test_resize_sweep(w, h, ow, oh, mode, kind, name, seed):
    """Shrinks and stretches of every side 1-300, each axis alone or
    both."""
    check_resize(w, h, ow, oh, mode, kind, name, seed)


@settings(max_examples=60, deadline=None)
@given(w=st.integers(1, 300), h=st.integers(1, 300),
       ow=st.integers(301, 1024), oh=st.integers(1, 1024),
       mode=st.sampled_from(list(MODES)), kind=st.integers(0, 3),
       name=st.sampled_from(list(FILTERS)), seed=st.integers(0, 2**31))
def test_resize_up_to_1024_sweep(w, h, ow, oh, mode, kind, name, seed):
    """Outputs up to ICNS's 1024: the kernel at the filter's own support
    where the image grows."""
    check_resize(w, h, ow, oh, mode, kind, name, seed)


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", [((1, 1), (1024, 1024)),
                                  ((37, 53), (1024, 1024)),
                                  ((257, 131), (1024, 1024)),
                                  ((1280, 720), (16, 9)),
                                  ((1280, 720), (256, 144)),
                                  ((5, 7), (5, 3)), ((5, 7), (2, 7))])
def test_resize_named_cases(case, mode, name):
    """ICNS's upscales of the committed input sizes, ICO's thumbnails of a
    1280x720 render, one axis resized alone."""
    (w, h), (ow, oh) = case
    for kind in range(4):
        check_resize(w, h, ow, oh, mode, kind, name, 7 + kind)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", [(0, 5), (5, 0), (0, 0)])
def test_resize_of_empty_images_is_zeros(shape, mode):
    h, w = shape
    img = np.zeros((h, w, MODES[mode]), np.uint8)
    for name, f in FILTERS.items():
        got = resample.resize(img, mode, (32, 32), f)
        np.testing.assert_array_equal(got, pil_resize(img, (32, 32), f))
        assert not got.any()


def test_resize_of_the_same_size_is_a_copy():
    img = content(0, np.random.default_rng(1), 9, 11, 4)
    got = resample.resize(img, "RGBA", (11, 9), resample.LANCZOS)
    assert got is not img
    np.testing.assert_array_equal(got, img)


def test_premultiplied_round_trip_loses_what_pil_loses():
    """Every colour value under every alpha through La / RGBa and back."""
    c, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for mode in ("LA", "RGBA"):
        img = np.stack([c] * (MODES[mode] - 1) + [a], -1).astype(np.uint8)
        got = resample.resize(img, mode, (256, 255), resample.BICUBIC)
        np.testing.assert_array_equal(
            got, pil_resize(img, (256, 255), resample.BICUBIC))
    one = np.array([[[200, 100, 50, 128]]], np.uint8)
    got = resample.resize(one, "RGBA", (4, 4), resample.BICUBIC)
    assert (got == np.array([199, 99, 49, 128], np.uint8)).all()


def test_thumbnail_size_is_pils():
    """Image.thumbnail's size for image sizes 1-400 against square and
    oblong boxes, the ties of round_aspect included."""
    seen = set()
    for w in range(1, 401, 3):
        for h in range(1, 401, 4):
            for box in ((16, 16), (24, 24), (48, 48), (128, 128),
                        (256, 256), (100, 30), (7, 300)):
                # The size rule does not depend on the mode or the filter:
                # a bilevel image's NEAREST resize is the quickest.
                im = Image.new("1", (w, h))
                im.thumbnail(box, Image.Resampling.NEAREST, reducing_gap=None)
                got = resample.thumbnail_size(w, h, box)
                assert got == im.size, (w, h, box)
                seen.add(got == (w, h))
    assert seen == {True, False}
    assert resample.thumbnail_size(257, 131, (128, 128)) == (128, 65)
    assert resample.thumbnail_size(1280, 720, (16, 16)) == (16, 9)


def pil_save(img: np.ndarray, fmt: str) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, fmt)
    return b.getvalue()


def port_save(img: np.ndarray, fmt: str) -> bytes:
    mode, px = image_save.image_mode(img)
    return image_save.SAVE[fmt](px, mode, "x." + fmt.lower())


@settings(max_examples=60, deadline=None)
@given(w=st.integers(1, 300), h=st.integers(1, 300),
       mode=st.sampled_from(list(MODES)), kind=st.integers(0, 3),
       seed=st.integers(0, 2**31))
def test_ico_sweep(w, h, mode, kind, seed):
    img = content(kind, np.random.default_rng(seed), h, w, MODES[mode])
    img = img[..., 0] if mode == "L" else img
    assert port_save(img, "ICO") == pil_save(img, "ICO")


@settings(max_examples=8, deadline=None)
@given(w=st.integers(1, 300), h=st.integers(1, 300),
       mode=st.sampled_from(list(MODES)), kind=st.integers(0, 3),
       seed=st.integers(0, 2**31))
def test_icns_sweep(w, h, mode, kind, seed):
    img = content(kind, np.random.default_rng(seed), h, w, MODES[mode])
    img = img[..., 0] if mode == "L" else img
    assert port_save(img, "ICNS") == pil_save(img, "ICNS")


@pytest.mark.parametrize("fmt", ["ICO", "ICNS"])
@pytest.mark.parametrize("shape", [(0, 5, 3), (5, 0), (0, 0, 4), (0, 3, 2),
                                   (1, 1), (1, 1, 2), (1, 1, 3), (1, 1, 4),
                                   (16, 16, 3), (256, 300, 4)])
def test_empty_small_and_exact_sizes(shape, fmt):
    """An empty or 1x1 image: ICO's 6-byte file of no entry, ICNS's
    resizes of zeros or of the pixel; an image of exactly an ICO size
    (16), one where 256 is written as 0."""
    img = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    got = port_save(img, fmt)
    assert got == pil_save(img, fmt)
    if fmt == "ICO" and 0 in shape[:2] + (shape[0] * shape[1],):
        assert got == b"\0\0\1\0\0\0"


@pytest.mark.parametrize("ext", [".ico", ".icns"])
@pytest.mark.parametrize("mode", list(MODES))
def test_written_files_read_back_as_jax_reads_pils(ext, mode, tmp_path):
    """write_png of a float image; the port's read_ldr of its file equals
    the JAX read_ldr of the JAX write_png's (PIL's) file, which is the
    same bytes, or raises the same class (an L or LA ICNS: PIL has no
    packer from its PNG's mode to the RGBA the plugin reports)."""
    from tracerboy_tpu.core.image_io import read_ldr as jax_read_ldr
    from tracerboy_tpu.core.image_io import write_png as jax_write_png

    rng = np.random.default_rng(11)
    img = rng.random((131, 257, MODES[mode])).astype(np.float32)
    img = img[..., 0] if mode == "L" else img
    ours, theirs = str(tmp_path / ("t" + ext)), str(tmp_path / ("j" + ext))
    image_io.write_png(ours, img)
    jax_write_png(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, ref = outcome(image_io.read_ldr, ours), outcome(jax_read_ldr,
                                                         theirs)
    if isinstance(ref, Exception):
        assert type(got) is type(ref), (got, ref)
        assert ext == ".icns" and mode in ("L", "LA")
        return
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def outcome(read, path):
    try:
        return read(path)
    except Exception as e:
        return e


SCENE = """
    LookAt 0 2 4  0 0 0  0 1 0
    Camera "perspective" "float fov" [ 35 ]
    Film "image" "integer xresolution" [ 32 ] "integer yresolution" [ 24 ]
    WorldBegin
    LightSource "infinite" "rgb L" [ 1 1 1 ]
    Material "matte" "rgb Kd" [ 0.6 0.4 0.3 ]
    Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -5 0 -5  5 0 -5  5 0 5  -5 0 5 ]
    WorldEnd
"""


def test_cli_writes_ico_as_the_jax_cli(tmp_path):
    """Both CLIs at 32x24, 8 spp, --out x.ico --capture-every 4: ICO files
    of the same names with entries of 16x12 and 24x18, read back within
    tests/test_torch_cli.py's tolerance of the JAX CLI's; the last capture
    is the final image, byte for byte."""
    from tracerboy_tpu.app.cli import main as jax_main
    from tracerboy_tpu.core.image_io import read_ldr
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.core.ico import ico_entries

    scene = tmp_path / "s.pbrt"
    scene.write_text(textwrap.dedent(SCENE))
    common = [str(scene), "--spp", "8", "--size", "32x24", "--quiet",
              "--capture-every", "4"]
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    assert jax_main([*common, "--out", str(tmp_path / "j" / "x.ico")]) == 0
    assert cli.main([*common, "--out", str(tmp_path / "t" / "x.ico"),
                     "--device", "cpu"]) == 0
    names = ["x.ico", "x_00004.ico", "x_00008.ico"]
    for d in ("j", "t"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == names
    for n in names:
        got = (tmp_path / "t" / n).read_bytes()
        sizes = sorted((e["width"], e["height"]) for e in ico_entries(got))
        assert sizes == [(16, 12), (24, 18)]
        a, b = (image_io.read_ldr(str(tmp_path / "t" / n)),
                read_ldr(str(tmp_path / "j" / n)))
        assert a.shape == b.shape == (18, 24, 3)
        assert (np.abs(a - b) <= 2 / 255 + 1e-6).all(-1).mean() >= 0.99
    assert (tmp_path / "t" / "x.ico").read_bytes() == (
        tmp_path / "t" / "x_00008.ico").read_bytes()
