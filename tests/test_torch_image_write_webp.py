"""The port's WebP writer (core/image_save.py save_webp, libwebp 1.6's
lossy VP8 encoder in csrc/webp_encode.cpp) against PIL 12.1, which the
JAX write_png writes it through (lossy, quality 80, method 4).

The bytes are held to Image.fromarray(img).save(..., "WEBP") over
hypothesis sweeps of sides 1-300 in L, RGB and opaque LA and RGBA, of
flat, ramp, noise, blocky and mixed content; over the small and odd
sizes where macroblocks are cut (sides 1-17, one macroblock row or
column, 16383 x 1); on a 1280x720 image; and on tests/data/write's
webp_extra.json, which is checked against PIL here as chip_smoke.py's
writers phase holds the port to it on the card's machine. PIL's errors
for empty and oversized images are raised with PIL's class and message
(an image with alpha below 255: tests/test_torch_image_write_webp_alpha.py).
The written files are read back by the port's read_ldr as the JAX read_ldr reads
PIL's, and both CLIs write --out x.webp and its --capture-every frames.

The stages are held to PIL's own libwebp through ctypes (the advanced
API; skipped where pillow.libs has no libwebp): the YUV 4:2:0 planes of
the RGB import, and per macroblock the type, segment, quantiser, I16
mode, UV mode and segment alpha of WebPPicture.extra_info.
"""

import ctypes
import glob
import hashlib
import io
import json
import os
import textwrap

import numpy as np
import PIL
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from make_write_fixtures import FIXTURE_DIR, webp_extra_image
from tracerboy_tpu_torch.core import image_io, image_save
from tracerboy_tpu_torch.core.codecs import webp_encode_library

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
KINDS = ("flat", "ramp", "noise", "blocky", "mixed")
EXTRA = json.load(open(os.path.join(FIXTURE_DIR, "webp_extra.json")))


def pixels(kind: str, rng, h: int, w: int, c: int) -> np.ndarray:
    """(h, w, c) values of one kind: flat, ramp (steps of 0-7 a pixel,
    wrapping), noise, blocky (blocks of 2-16), mixed (16x16 tiles of
    noise, ramp and flat)."""
    y, x = np.mgrid[:h, :w]
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, c), (h, w, c))
    if kind == "ramp":
        steps = rng.integers(0, 8, (2, c))
        return (x[..., None] * steps[0] + y[..., None] * steps[1]) % 256
    if kind == "noise":
        return rng.integers(0, 256, (h, w, c))
    if kind == "blocky":
        b = int(rng.integers(2, 17))
        cells = rng.integers(0, 256, ((h + b - 1) // b, (w + b - 1) // b, c))
        return cells[y // b, x // b]
    tile = ((x // 16 + y // 16) % 3)[..., None]
    return np.where(tile == 0, pixels("noise", rng, h, w, c),
                    np.where(tile == 1, pixels("ramp", rng, h, w, c),
                             pixels("flat", rng, h, w, c)))


def content(kind: str, rng, h: int, w: int, c: int) -> np.ndarray:
    """An image of c channels ((h, w) for one) of one kind, alpha 255
    where there is alpha."""
    img = np.array(pixels(kind, rng, h, w, c), np.uint8)
    if c in (2, 4):
        img[..., -1] = 255
    return img[..., 0] if c == 1 else img


def pil_webp(img: np.ndarray) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "WEBP")
    return b.getvalue()


def port_webp(img: np.ndarray) -> bytes:
    mode, px = image_save.image_mode(img)
    return image_save.SAVE["WEBP"](px, mode, "x.webp")


@settings(max_examples=120, deadline=None)
@given(w=st.integers(1, 300), h=st.integers(1, 300),
       mode=st.sampled_from(list(MODES)), kind=st.sampled_from(KINDS),
       seed=st.integers(0, 2**31))
def test_webp_sweep(w, h, mode, kind, seed):
    img = content(kind, np.random.default_rng(seed), h, w, MODES[mode])
    assert port_webp(img) == pil_webp(img)


SIZES = ([(s, s) for s in range(1, 18)] + [(s, 9) for s in range(1, 18, 2)]
         + [(16, 1), (1, 16), (17, 16), (16, 17), (300, 16), (16, 300),
            (301, 15), (15, 301), (16383, 1), (1, 16383), (2, 16383)])


@pytest.mark.parametrize("w,h", SIZES)
def test_small_and_odd_sizes(w, h):
    """Edge macroblocks cut in width, height or both (odd chroma), a
    single macroblock row or column, the widest and tallest images."""
    rng = np.random.default_rng(w * 131 + h)
    for kind in ("noise", "mixed"):
        img = content(kind, rng, h, w, 3)
        assert port_webp(img) == pil_webp(img), kind


def test_1280x720():
    img = content("mixed", np.random.default_rng(720), 720, 1280, 3)
    assert port_webp(img) == pil_webp(img)


def test_opaque_alpha_is_its_rgb():
    """An RGBA (LA) image whose alpha is 255 throughout is coded as its
    RGB (L), as libwebp does."""
    rng = np.random.default_rng(9)
    rgba = content("noise", rng, 37, 53, 4)
    la = content("ramp", rng, 37, 53, 2)
    assert port_webp(rgba) == port_webp(rgba[..., :3]) == pil_webp(rgba)
    assert port_webp(la) == port_webp(la[..., 0]) == pil_webp(la)


@pytest.mark.parametrize("k", range(len(EXTRA["entries"])))
def test_webp_extra(k):
    """webp_extra.json's image, made from its seed: PIL's file is the
    recorded one, and the port's is PIL's."""
    e = EXTRA["entries"][k]
    img = webp_extra_image(e["kind"], e["width"], e["height"], e["seed"])
    assert EXTRA["pil"] == PIL.__version__
    for data in (pil_webp(img), port_webp(img)):
        assert hashlib.sha256(data).hexdigest() == e["sha256"]
        assert len(data) == e["size"]


@pytest.mark.parametrize("shape", [(0, 5, 3), (5, 0), (0, 0, 4), (0, 3, 2),
                                   (0, 20000, 3), (1, 16384, 3), (16384, 1),
                                   (16384, 2, 2), (16384, 16384 // 4096, 4)])
def test_errors_are_pils(shape, tmp_path):
    """An empty image: MemoryError; a side over 16383: ValueError (before
    anything looks at alpha); PIL's messages; no file left."""
    img = np.zeros(shape, np.uint8)
    with pytest.raises(Exception) as ref:
        Image.fromarray(img).save(str(tmp_path / "j.webp"))
    with pytest.raises(type(ref.value)) as got:
        image_io.write_png(str(tmp_path / "t.webp"), img)
    assert str(got.value) == str(ref.value)
    assert not (tmp_path / "t.webp").exists()
    assert not (tmp_path / "j.webp").exists()


@pytest.mark.parametrize("mode", list(MODES))
def test_written_files_read_back_as_jax_reads_pils(mode, tmp_path):
    """write_png of a float image (alpha 1.0); the port's read_ldr of its
    file equals the JAX read_ldr of the JAX write_png's (PIL's) file,
    which is the same bytes."""
    from tracerboy_tpu.core.image_io import read_ldr as jax_read_ldr
    from tracerboy_tpu.core.image_io import write_png as jax_write_png

    rng = np.random.default_rng(12)
    img = rng.random((131, 257, MODES[mode])).astype(np.float32)
    if mode in ("LA", "RGBA"):
        img[..., -1] = 1.0
    img = img[..., 0] if mode == "L" else img
    ours, theirs = str(tmp_path / "t.webp"), str(tmp_path / "j.webp")
    image_io.write_png(ours, img)
    jax_write_png(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, ref = image_io.read_ldr(ours), jax_read_ldr(theirs)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


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


def test_cli_writes_webp_as_the_jax_cli(tmp_path, monkeypatch):
    """Both CLIs at 32x24, 8 spp, --out x.webp --capture-every 4: WebP
    files of the same names, each the bytes PIL writes for the image its
    CLI wrote (so the JAX CLI's file for the port's image is the port's),
    read back at 24x32 close to the JAX CLI's; the last capture is the
    final image, byte for byte."""
    from tracerboy_tpu.app.cli import main as jax_main
    from tracerboy_tpu.core.image_io import read_ldr
    from tracerboy_tpu_torch.app import cli

    scene = tmp_path / "s.pbrt"
    scene.write_text(textwrap.dedent(SCENE))
    common = [str(scene), "--spp", "8", "--size", "32x24", "--quiet",
              "--capture-every", "4"]
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    written = {}
    real_write = image_io.write_png

    def keep(path, img):
        written[os.path.basename(path)] = image_io._to_uint8(img)
        real_write(path, img)

    assert jax_main([*common, "--out", str(tmp_path / "j" / "x.webp")]) == 0
    monkeypatch.setattr(image_io, "write_png", keep)
    assert cli.main([*common, "--out", str(tmp_path / "t" / "x.webp"),
                     "--device", "cpu"]) == 0
    names = ["x.webp", "x_00004.webp", "x_00008.webp"]
    for d in ("j", "t"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == names
    assert sorted(written) == names
    for n in names:
        got = (tmp_path / "t" / n).read_bytes()
        assert got == pil_webp(written[n])
        a, b = (image_io.read_ldr(str(tmp_path / "t" / n)),
                read_ldr(str(tmp_path / "j" / n)))
        assert a.shape == b.shape == (24, 32, 3)
        assert np.abs(a - b).mean() <= 2 / 255
    assert (tmp_path / "t" / "x.webp").read_bytes() == (
        tmp_path / "t" / "x_00008.webp").read_bytes()


# ----------------------------------------------------------------------------
# The stages against PIL's libwebp (the advanced API through ctypes)

def _libwebp():
    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    webp = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    sharp = glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))
    if not webp or not sharp:
        return None
    ctypes.CDLL(sharp[0], mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(webp[0])


LIBWEBP = _libwebp()
needs_libwebp = pytest.mark.skipif(LIBWEBP is None,
                                   reason="pillow.libs has no libwebp")
ABI = 0x020f   # WEBP_ENCODER_ABI_VERSION of libwebp 1.x's encode.h
C = ctypes


class _Config(C.Structure):
    _fields_ = [(n, C.c_float if n in ("quality", "target_PSNR") else C.c_int)
                for n in (
        "lossless quality method image_hint target_size target_PSNR "
        "segments sns_strength filter_strength filter_sharpness filter_type "
        "autofilter alpha_compression alpha_filtering alpha_quality pass_ "
        "show_compressed preprocessing partitions partition_limit "
        "emulate_jpeg_size thread_level low_memory near_lossless exact "
        "use_delta_palette use_sharp_yuv qmin qmax").split()]


class _Picture(C.Structure):
    _fields_ = [
        ("use_argb", C.c_int), ("colorspace", C.c_int), ("width", C.c_int),
        ("height", C.c_int), ("y", C.c_void_p), ("u", C.c_void_p),
        ("v", C.c_void_p), ("y_stride", C.c_int), ("uv_stride", C.c_int),
        ("a", C.c_void_p), ("a_stride", C.c_int), ("pad1", C.c_uint32 * 2),
        ("argb", C.c_void_p), ("argb_stride", C.c_int),
        ("pad2", C.c_uint32 * 3), ("writer", C.c_void_p),
        ("custom_ptr", C.c_void_p), ("extra_info_type", C.c_int),
        ("extra_info", C.c_void_p), ("stats", C.c_void_p),
        ("error_code", C.c_int), ("progress_hook", C.c_void_p),
        ("user_data", C.c_void_p), ("pad3", C.c_uint32 * 3),
        ("pad4", C.c_void_p), ("pad5", C.c_void_p), ("pad6", C.c_uint32 * 8),
        ("memory_", C.c_void_p), ("memory_argb_", C.c_void_p),
        ("pad7", C.c_void_p * 2)]


class _MemoryWriter(C.Structure):
    _fields_ = [("mem", C.c_void_p), ("size", C.c_size_t),
                ("max_size", C.c_size_t), ("pad", C.c_uint32 * 1)]


def _picture(img: np.ndarray) -> _Picture:
    """A WebPPicture of an (H, W, 3) or (H, W, 4) uint8 image, imported as
    YUV(A) (WebPPictureImportRGB or WebPPictureImportRGBA)."""
    h, w, c = img.shape
    pic = _Picture()
    assert LIBWEBP.WebPPictureInitInternal(C.byref(pic), ABI)
    pic.width, pic.height = w, h
    importer = (LIBWEBP.WebPPictureImportRGB if c == 3
                else LIBWEBP.WebPPictureImportRGBA)
    assert importer(C.byref(pic), C.c_void_p(img.ctypes.data), c * w)
    return pic


def libwebp_yuv(img: np.ndarray, cleanup: bool = False):
    """The Y, U and V planes WebPPictureImportRGB makes of an RGB image, or
    the Y, U, V and A planes WebPPictureImportRGBA makes of an RGBA one,
    after WebPCleanupTransparentArea where cleanup is set."""
    h, w, c = img.shape
    pic = _picture(img)
    if cleanup:
        LIBWEBP.WebPCleanupTransparentArea(C.byref(pic))

    def plane(ptr, stride, pw, ph):
        return np.array([np.frombuffer(C.string_at(ptr + r * stride, pw),
                                       np.uint8) for r in range(ph)])

    uw, uh = (w + 1) // 2, (h + 1) // 2
    planes = (plane(pic.y, pic.y_stride, w, h),
              plane(pic.u, pic.uv_stride, uw, uh),
              plane(pic.v, pic.uv_stride, uw, uh))
    if c == 4 and pic.a:
        planes += (plane(pic.a, pic.a_stride, w, h),)
    LIBWEBP.WebPPictureFree(C.byref(pic))
    return planes


def libwebp_extra_info(img: np.ndarray, kind: int):
    """(file, WebPPicture.extra_info of type `kind`) of WebPEncode at
    quality 80, the default preset, as WebPEncodeRGB runs it."""
    h, w, _ = img.shape
    cfg = _Config()
    assert LIBWEBP.WebPConfigInitInternal(C.byref(cfg), 0, C.c_float(80.0),
                                          ABI)
    pic = _picture(img)
    info = np.zeros(((h + 15) // 16, (w + 15) // 16), np.uint8)
    pic.extra_info_type = kind
    pic.extra_info = info.ctypes.data
    writer = _MemoryWriter()
    LIBWEBP.WebPMemoryWriterInit(C.byref(writer))
    pic.writer = C.cast(LIBWEBP.WebPMemoryWrite, C.c_void_p).value
    pic.custom_ptr = C.addressof(writer)
    ok = LIBWEBP.WebPEncode(C.byref(cfg), C.byref(pic))
    data = C.string_at(writer.mem, writer.size)
    LIBWEBP.WebPMemoryWriterClear(C.byref(writer))
    LIBWEBP.WebPPictureFree(C.byref(pic))
    assert ok
    return data, info


STAGE_IMAGES = [("noise", 1, 1), ("smooth", 7, 5), ("mixed", 33, 17),
                ("blocky", 50, 37), ("ramp", 1, 40), ("smooth", 131, 97),
                ("mixed", 160, 90), ("flat", 48, 32)]


@needs_libwebp
@pytest.mark.parametrize("kind,w,h", STAGE_IMAGES)
def test_yuv_planes_are_libwebps(kind, w, h):
    img = webp_extra_image(kind, w, h, w + h)
    uw, uh = (w + 1) // 2, (h + 1) // 2
    y = np.zeros((h, w), np.uint8)
    u, v = np.zeros((uh, uw), np.uint8), np.zeros((uh, uw), np.uint8)
    assert webp_encode_library().tb_webp_yuv(
        img.ctypes.data, w, h, y.ctypes.data, u.ctypes.data,
        v.ctypes.data) == 0
    for got, ref in zip((y, u, v), libwebp_yuv(img)):
        np.testing.assert_array_equal(got, ref)


@needs_libwebp
@pytest.mark.parametrize("kind,w,h", STAGE_IMAGES)
def test_macroblock_decisions_are_libwebps(kind, w, h):
    """Per macroblock: intra type (extra_info 1), segment (2), quantiser
    (3), I16 mode or 0xff (4), UV mode (5), the segment's alpha (7); and
    the file."""
    img = webp_extra_image(kind, w, h, w + h)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    info = np.zeros((mb_h, mb_w, 6), np.uint8)
    assert webp_encode_library().tb_webp_mb_info(
        img.ctypes.data, w, h, info.ctypes.data) == mb_w * mb_h
    for k, kind_id in enumerate((1, 2, 3, 4, 5, 7)):
        data, ref = libwebp_extra_info(img, kind_id)
        np.testing.assert_array_equal(info[..., k], ref, err_msg=str(kind_id))
    assert port_webp(img) == data == pil_webp(img)
