"""The port's WebP writer for images whose alpha is below 255 somewhere
(core/image_save.py save_webp; the colours by csrc/webp_encode.cpp, the
ALPH plane by csrc/webp_alpha_encode.cpp) against PIL 12.1, which the
JAX write_png writes it through (lossy, quality 80, alpha_quality 100,
method 4, through libwebp 1.6).

The bytes are held to Image.fromarray(img).save(..., "WEBP") on
tests/data/write's webp_alpha.json (each alpha kind of
make_write_fixtures.WEBP_ALPHA_KINDS at 1x1, 2x3, 7x9, 37x53, 257x131 and
16383x1, and a 1280x720 soft cutout; checked against PIL here as
chip_smoke.py's writers phase holds the port to it on the card's
machine), over a hypothesis sweep of sides 1-300, on the demo scene's
512x512 leaf texture, and in LA. The ALPH chunks of the fixture files
take each branch of alpha_enc.c: raw, lossless unfiltered and lossless
filtered. The written files are read back by the port's read_ldr as the
JAX read_ldr reads PIL's.

The stages are held to PIL's own libwebp through ctypes (skipped where
pillow.libs has no libwebp): the Y, U, V and A planes of the RGBA import,
the planes after WebPCleanupTransparentArea, and the VP8L stream of the
alpha plane against libwebp's lossless WebPEncode of the same picture
(alpha in green, quality 32, method 4, exact), which is what the ALPH
payload holds after its header byte.
"""

import ctypes as C
import hashlib
import json
import os

import numpy as np
import PIL
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from make_write_fixtures import (
    FIXTURE_DIR,
    WEBP_ALPHA_KINDS,
    WEBP_KINDS,
    webp_alpha_image,
)
from test_torch_image_write_webp import (
    ABI,
    LIBWEBP,
    _Config,
    _MemoryWriter,
    _Picture,
    libwebp_yuv,
    needs_libwebp,
    pil_webp,
    port_webp,
)
from tracerboy_tpu_torch.core import image_io
from tracerboy_tpu_torch.core.codecs import (
    webp_alpha_library,
    webp_encode_library,
)

ALPHA = json.load(open(os.path.join(FIXTURE_DIR, "webp_alpha.json")))


def chunks(data: bytes) -> dict:
    """The RIFF chunks of a .webp file: fourcc -> payload."""
    out, p = {}, 12
    while p + 8 <= len(data):
        n = int.from_bytes(data[p + 4:p + 8], "little")
        out[data[p:p + 4].decode()] = data[p + 8:p + 8 + n]
        p += 8 + n + (n & 1)
    return out


def fixture_image(e: dict) -> np.ndarray:
    return webp_alpha_image(e["kind"], e["alpha"], e["width"], e["height"],
                            e["seed"])


@pytest.mark.parametrize("k", range(len(ALPHA["entries"])))
def test_webp_alpha_fixture(k):
    """webp_alpha.json's image, made from its seed: PIL's file is the
    recorded one, and the port's is PIL's."""
    e = ALPHA["entries"][k]
    img = fixture_image(e)
    assert (img[..., 3] < 255).any()
    assert ALPHA["pil"] == PIL.__version__
    for data in (pil_webp(img), port_webp(img)):
        assert hashlib.sha256(data).hexdigest() == e["sha256"]
        assert len(data) == e["size"]


def test_fixture_takes_every_alpha_branch():
    """The ALPH header byte (method | filter << 2) of PIL's fixture files:
    the raw plane, the lossless stream unfiltered, and filtered."""
    headers = {chunks(pil_webp(fixture_image(e)))["ALPH"][0]
               for e in ALPHA["entries"]}
    assert 0 in headers and 1 in headers
    assert any(h & 1 and h >> 2 for h in headers)


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 300), h=st.integers(1, 300),
       alpha=st.sampled_from(WEBP_ALPHA_KINDS),
       kind=st.sampled_from(("mixed",) + WEBP_KINDS),
       seed=st.integers(0, 2**31))
def test_webp_alpha_sweep(w, h, alpha, kind, seed):
    img = webp_alpha_image(kind, alpha, w, h, seed)
    assert port_webp(img) == pil_webp(img)


@pytest.mark.parametrize("alpha", ["cutout", "soft", "many", "one"])
def test_la_is_its_rgba(alpha):
    """LA is written as RGBA (_convert_frame)."""
    rgba = webp_alpha_image("smooth", alpha, 61, 47, 5)
    la = np.ascontiguousarray(rgba[..., ::2])
    assert port_webp(la) == pil_webp(la)


def test_leaf_texture(tmp_path):
    """The demo scene's 512x512 leaf (float RGBA, alpha 0 outside an
    ellipse) through both write_png: the same file."""
    from tracerboy_tpu.core.image_io import write_png as jax_write_png
    from tracerboy_tpu_torch.utils.demo_scene import leaf_image

    img = leaf_image(512)
    image_io.write_png(str(tmp_path / "t.webp"), img)
    jax_write_png(str(tmp_path / "j.webp"), img)
    got = (tmp_path / "t.webp").read_bytes()
    assert got == (tmp_path / "j.webp").read_bytes()
    assert got[12:16] == b"VP8X"


@pytest.mark.parametrize("channels", [2, 4])
def test_written_files_read_back_as_jax_reads_pils(channels, tmp_path):
    """write_png of a float image with soft alpha; the port's read_ldr of
    its file equals the JAX read_ldr of the JAX write_png's (PIL's) file,
    which is the same bytes."""
    from tracerboy_tpu.core.image_io import read_ldr as jax_read_ldr
    from tracerboy_tpu.core.image_io import write_png as jax_write_png

    rng = np.random.default_rng(channels)
    img = rng.random((131, 257, channels)).astype(np.float32)
    y, x = np.mgrid[:131, :257]
    img[..., -1] = np.clip(1.5 - np.hypot(x - 128, y - 65) / 60, 0, 1)
    ours, theirs = str(tmp_path / "t.webp"), str(tmp_path / "j.webp")
    image_io.write_png(ours, img)
    jax_write_png(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, ref = image_io.read_ldr(ours), jax_read_ldr(theirs)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------------------
# The stages against PIL's libwebp (through ctypes)

STAGE_IMAGES = [("noise", "cutout", 1, 1), ("smooth", "soft", 7, 5),
                ("mixed", "few", 33, 17), ("blocky", "blocks", 50, 37),
                ("ramp", "one", 1, 40), ("smooth", "many", 131, 97),
                ("mixed", "zero", 40, 24), ("flat", "some", 48, 32)]


def port_yuva(img: np.ndarray, cleanup: bool):
    h, w, _ = img.shape
    uw, uh = (w + 1) // 2, (h + 1) // 2
    y, a = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
    u, v = np.zeros((uh, uw), np.uint8), np.zeros((uh, uw), np.uint8)
    assert webp_encode_library().tb_webp_yuva(
        img.ctypes.data, w, h, int(cleanup), y.ctypes.data, u.ctypes.data,
        v.ctypes.data, a.ctypes.data) == 0
    return y, u, v, a


@needs_libwebp
@pytest.mark.parametrize("cleanup", [False, True])
@pytest.mark.parametrize("kind,alpha,w,h", STAGE_IMAGES)
def test_yuva_planes_are_libwebps(kind, alpha, w, h, cleanup):
    """The alpha-weighted YUVA import, and the planes after
    WebPCleanupTransparentArea (flattened transparent 8x8 blocks,
    smoothed partly transparent ones)."""
    img = webp_alpha_image(kind, alpha, w, h, w * h)
    ref = libwebp_yuv(img, cleanup)
    assert len(ref) == 4
    for got, want in zip(port_yuva(img, cleanup), ref):
        np.testing.assert_array_equal(got, want)


def libwebp_lossless_green(alpha: np.ndarray) -> bytes:
    """libwebp's lossless WebPEncode (quality 32, method 4, exact) of the
    picture EncodeLossless makes of an alpha plane (alpha << 8): its VP8L
    stream without the 5-byte header."""
    h, w = alpha.shape
    cfg = _Config()
    assert LIBWEBP.WebPConfigInitInternal(C.byref(cfg), 0, C.c_float(75.0),
                                          ABI)
    cfg.lossless, cfg.quality, cfg.method, cfg.exact = 1, 32.0, 4, 1
    pic = _Picture()
    assert LIBWEBP.WebPPictureInitInternal(C.byref(pic), ABI)
    pic.width, pic.height, pic.use_argb = w, h, 1
    assert LIBWEBP.WebPPictureAlloc(C.byref(pic))
    argb = alpha.astype(np.uint32) << 8
    for r in range(h):
        C.memmove(pic.argb + 4 * r * pic.argb_stride, argb[r].ctypes.data,
                  4 * w)
    writer = _MemoryWriter()
    LIBWEBP.WebPMemoryWriterInit(C.byref(writer))
    pic.writer = C.cast(LIBWEBP.WebPMemoryWrite, C.c_void_p).value
    pic.custom_ptr = C.addressof(writer)
    ok = LIBWEBP.WebPEncode(C.byref(cfg), C.byref(pic))
    data = C.string_at(writer.mem, writer.size)
    LIBWEBP.WebPMemoryWriterClear(C.byref(writer))
    LIBWEBP.WebPPictureFree(C.byref(pic))
    assert ok
    return chunks(data)["VP8L"][5:]


def port_call(fn, alpha: np.ndarray) -> bytes:
    h, w = alpha.shape
    out = np.empty(64 + 8 * h * w, np.uint8)
    n = fn(alpha.ctypes.data, w, h, out.ctypes.data, out.size)
    assert n >= 0
    return out[:n].tobytes()


@needs_libwebp
@pytest.mark.parametrize("kind,alpha,w,h", STAGE_IMAGES + [
    ("noise", "soft", 160, 90), ("noise", "few", 300, 200),
    ("noise", "blocks", 257, 131), ("noise", "some", 700, 450)])
def test_alpha_stream_is_libwebps_lossless(kind, alpha, w, h):
    """The VP8L stream of the plane (palette, predictor or none; LZ77,
    RLE and box references with TraceBackwards; the colour cache; the
    histogram image's clusters; the prefix codes) is libwebp's lossless
    coding of the same picture, and PIL's ALPH chunk is the port's."""
    img = webp_alpha_image(kind, alpha, w, h, w + h)
    plane = np.ascontiguousarray(img[..., 3])
    lib = webp_alpha_library()
    assert port_call(lib.tb_vp8l_encode_green, plane) == \
        libwebp_lossless_green(plane)
    assert port_call(lib.tb_webp_alpha_encode, plane) == \
        chunks(pil_webp(img))["ALPH"]
