"""The port's image writer (core/image_save.py, behind image_io.write_png;
JPEG's pixel stages and entropy coder in csrc/jpeg_encode.cpp) against
the JAX write_png, which writes through PIL's Image.fromarray(img).save
and so picks the format from the path's extension.

For every extension of PIL 12.1's EXTENSION table with a save handler
and every mode write_png can make (L, LA, RGB, RGBA), in uint8 and float,
on the committed inputs of tests/data/write (1x1, 37x53, 257x131): the
same bytes (a PNG's, ICO's or ICNS's bytes where this machine's zlib is
PIL's, else its chunks and inflated streams; a PDF's with both writers
run under one patched time.gmtime, so its dates are equal too), or the
same exception class, or, for what is not ported yet (AVIF) only,
NotImplementedError naming ROADMAP item 25 (WebP in
tests/test_torch_image_write_webp.py and, with alpha,
tests/test_torch_image_write_webp_alpha.py too; ICO and ICNS, with their resampler, in
tests/test_torch_image_write_icons.py too). The committed manifest
(PDFs by their bytes with both dates masked) is checked against PIL
here, so that it cannot drift from what chip_smoke.py's writers phase
holds the port to on the card's machine. Hypothesis sweeps JPEG and PNG
sizes and contents (JPEG 2000, GIF, EPS and PDF in
tests/test_torch_image_write_formats.py); both CLIs write
--out x.jpg and its --capture-every frames as JPEG. JPEG files cut inside
their headers are not identified by the port's reader where PIL does
not identify them (core/jpeg.py _pil_open).
"""

import glob
import hashlib
import io
import json
import os
import subprocess
import sys
import textwrap
import time
import zlib
from unittest import mock

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, features

from make_write_fixtures import (
    FIXTURE_DIR,
    LATER,
    icon_parts,
    MODES,
    image_of,
    mask_pdf_dates,
    pil_entry,
    png_parts,
    ported,
)
from tracerboy_tpu_torch.core import image_io, image_save

# PIL's EXTENSION table in a fresh process: a test that saves a SPIDER
# file registers its file's extension (SpiderImagePlugin._save_spider),
# which changes what Image.save picks in that process afterwards.
FRESH_EXTENSION = json.loads(subprocess.run(
    [sys.executable, "-c", "import json; from PIL import Image; "
     "Image.init(); print(json.dumps(Image.EXTENSION))"],
    capture_output=True, text=True, check=True).stdout)
MANIFEST = json.load(open(os.path.join(FIXTURE_DIR, "manifest.json")))
with np.load(os.path.join(FIXTURE_DIR, "inputs.npz")) as _npz:
    INPUTS = {name: _npz[name] for name in _npz.files}
SAME_ZLIB = zlib.ZLIB_RUNTIME_VERSION == features.version("zlib")
Image.init()
EXTENSIONS = [e for e, f in FRESH_EXTENSION.items() if f in Image.SAVE]


@pytest.fixture(autouse=True)
def fresh_pil_extensions(monkeypatch):
    """Image.save picks formats from the fresh process's table."""
    monkeypatch.setattr(Image, "EXTENSION", dict(FRESH_EXTENSION))


def jax_write_png(path, img):
    from tracerboy_tpu.core.image_io import write_png

    write_png(path, img)


# The one clock both writers read a PDF's dates from.
CLOCK = time.struct_time((2026, 10, 18, 12, 34, 56, 6, 291, 0))


def outcome(write, path, img):
    """The bytes write(path, img) wrote, or the exception it raised (and
    whether it left a file); time.gmtime patched to CLOCK."""
    try:
        with mock.patch("time.gmtime", return_value=CLOCK):
            write(path, img)
    except Exception as e:
        return e, os.path.exists(path)
    with open(path, "rb") as f:
        return f.read(), True


def without_idat_lengths(parts: dict) -> dict:
    """icon_parts without the IDAT lengths another zlib changes."""
    return dict(parts, pngs=[{k: v for k, v in p.items() if k != "idat"}
                             for p in parts["pngs"]])


def assert_same_file(got: bytes, ref: bytes, fmt: str):
    if fmt in ("ICO", "ICNS") and not SAME_ZLIB:
        assert without_idat_lengths(icon_parts(got)) == without_idat_lengths(
            icon_parts(ref))
    elif fmt == "PNG" and not SAME_ZLIB:
        assert png_parts(got)["stream_sha256"] == png_parts(ref)[
            "stream_sha256"]
        assert png_parts(got)["frame_sha256"] == png_parts(ref)[
            "frame_sha256"]
    else:
        assert got == ref


def assert_as_jax(img, ext, tmp_path, name="img"):
    """write_png of the port and of the JAX package on one image, into
    files of one name in two directories: equal bytes, or the same
    exception class (and the same file left or not); NotImplementedError
    naming item 25 only for what the port does not write yet (ported()
    false: AVIF) where PIL writes it (or for an empty image in AVIF)."""
    fmt = image_save.EXTENSION.get(ext.lower())
    (tmp_path / "j").mkdir(exist_ok=True)
    (tmp_path / "t").mkdir(exist_ok=True)
    ref, ref_left = outcome(jax_write_png, str(tmp_path / "j" / (name + ext)),
                            img)
    got, got_left = outcome(image_io.write_png,
                            str(tmp_path / "t" / (name + ext)), img)
    if isinstance(got, NotImplementedError) and (
            not isinstance(ref, Exception) or np.asarray(img).size == 0):
        # What is not ported yet is refused after PIL's mode checks, and
        # AVIF before the checks of an empty image inside its encoder.
        u8 = image_io._to_uint8(img)
        assert fmt in LATER and image_save.ITEM in str(got), (ext, got)
        assert not ported(fmt, u8) and (u8.size or fmt == "AVIF"), (ext, got)
        return
    if isinstance(ref, Exception):
        assert type(got) is type(ref), (ext, ref, got)
        assert got_left == ref_left
        return
    assert not isinstance(got, Exception), (ext, got)
    assert_same_file(got, ref, fmt)


def float_image(rgba: np.ndarray, mode: str, seed: int) -> np.ndarray:
    """A float image of the input's shape: values in [-0.1, 1.1] (the
    clip) and exact x*255+0.5 ties."""
    rng = np.random.default_rng(seed)
    img = (rng.random(image_of(rgba, mode).shape) * 1.2 - 0.1).astype(
        np.float32)
    img.flat[:4] = np.array([0.5, 1.5, 254.5, 255.0], np.float32)[
        :img.size] / 255
    return img


def test_extension_table_is_pils():
    assert image_save.EXTENSION == FRESH_EXTENSION
    formats = {f for f in FRESH_EXTENSION.values() if f in Image.SAVE}
    assert set(image_save.SAVE) == formats
    assert set(LATER) <= formats


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ext", EXTENSIONS)
def test_write_matches_jax(ext, mode, tmp_path):
    """Every committed input in uint8 and as floats (AVIF's floats at 1x1
    only: the port refuses it before quantising matters)."""
    later = image_save.EXTENSION[ext] == "AVIF"
    for k, (name, rgba) in enumerate(INPUTS.items()):
        assert_as_jax(image_of(rgba, mode), ext, tmp_path, f"u{name}")
        if not later or name == "1x1":
            assert_as_jax(float_image(rgba, mode, k), ext, tmp_path,
                          f"f{name}")


@pytest.mark.parametrize("ext", [".cur", ".dcx", ".fits", ".flc", ".ftc",
                                 ".gbr", ".iim", ".mpeg", ".pcd", ".pxr",
                                 ".psd", ".ras", ".xpm"])
def test_extension_without_a_save_handler_is_a_key_error(ext, tmp_path):
    """PIL's Image.SAVE[format] raises KeyError before the file is
    opened."""
    img = INPUTS["37x53"][..., :3]
    assert_as_jax(img, ext, tmp_path)
    with pytest.raises(KeyError):
        image_io.write_png(str(tmp_path / ("k" + ext)), img)
    assert not (tmp_path / ("k" + ext)).exists()


@pytest.mark.parametrize("name", ["x.exr", "x.hdr", "x.xyz", "x", "x.",
                                  "dir.png/x", "X.JPG", "x.Tif", "x.PnG"])
def test_extension_rules(name, tmp_path):
    """os.path.splitext's extension, lowercased: an unknown or missing one
    is PIL's ValueError; case does not matter."""
    (tmp_path / "j" / "dir.png").mkdir(parents=True)
    (tmp_path / "t" / "dir.png").mkdir(parents=True)
    img = INPUTS["37x53"][..., :3]
    ref, _ = outcome(jax_write_png, str(tmp_path / "j" / name), img)
    got, _ = outcome(image_io.write_png, str(tmp_path / "t" / name), img)
    if isinstance(ref, Exception):
        assert type(got) is ValueError and type(ref) is ValueError
        assert str(got) == str(ref)
    else:
        assert got == ref


@pytest.mark.parametrize("shape", [(3, 4, 1), (3, 4, 5), (2, 3, 4, 3), (),
                                   (7,), (0, 3, 3), (3, 0), (0, 0, 4),
                                   (0, 5, 2), (2, 0, 3)])
def test_other_shapes_as_fromarray_takes_them(shape, tmp_path):
    """Shapes Image.fromarray refuses (TypeError, IndexError), a 1-D
    array (an L column) and empty images, for every extension."""
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    for ext in EXTENSIONS:
        assert_as_jax(img, ext, tmp_path)


def test_existing_file_is_emptied_on_error(tmp_path):
    """Image.save opens the file before its writer refuses the mode: a
    file that was there is left empty, one that was not is removed."""
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "a.jpg").write_bytes(b"old")
    rgba = INPUTS["37x53"]
    with pytest.raises(OSError):
        jax_write_png(str(tmp_path / "j" / "a.jpg"), rgba)
    with pytest.raises(OSError):
        image_io.write_png(str(tmp_path / "t" / "a.jpg"), rgba)
    assert (tmp_path / "t" / "a.jpg").read_bytes() == (
        tmp_path / "j" / "a.jpg").read_bytes() == b""


def _entries():
    return sorted(MANIFEST["entries"].items())


def test_manifest_is_pils(tmp_path):
    """The committed hashes are what PIL on this machine writes (the
    entries of what is not ported yet are held by
    test_write_matches_jax)."""
    import PIL

    assert MANIFEST["pil"] == PIL.__version__
    for key, entry in _entries():
        name, mode, ext = key.split("/")
        if "later" in entry:
            continue
        got = pil_entry(image_of(INPUTS[name], mode), ext, str(tmp_path))
        if "stream_sha256" in entry and not SAME_ZLIB:
            got = {k: got[k] for k in ("stream_sha256", "frame_sha256")}
            entry = {k: entry[k] for k in got}
        elif "pngs" in entry and not SAME_ZLIB:
            got, entry = (without_idat_lengths(
                {k: e[k] for k in ("container_sha256", "pngs")})
                for e in (got, entry))
        assert got == entry, key


def test_port_matches_the_manifest(tmp_path):
    """The check chip_smoke.py's writers phase makes on the card's
    machine: each input x mode x extension through image_save.save, its
    sha256 (a PNG's stream and chunks where zlib differs, an ICO's or
    ICNS's container and embedded PNGs' streams and chunks) or PIL's
    error class (a PDF's with its dates masked); NotImplementedError
    naming item 25 for what is not ported yet."""
    for key, entry in _entries():
        name, mode, ext = key.split("/")
        path = str(tmp_path / ("img" + ext))
        got, _ = outcome(image_save.save, path,
                         image_of(INPUTS[name], mode))
        if "later" in entry:
            assert isinstance(got, NotImplementedError), key
            assert image_save.ITEM in str(got)
        elif "error" in entry:
            assert type(got).__name__ == entry["error"], (key, got)
        elif "stream_sha256" in entry and not SAME_ZLIB:
            parts = png_parts(got)
            assert parts["stream_sha256"] == entry["stream_sha256"], key
            assert parts["frame_sha256"] == entry["frame_sha256"], key
        elif "pngs" in entry and not SAME_ZLIB:
            assert without_idat_lengths(icon_parts(got)) == \
                without_idat_lengths({k: entry[k] for k in (
                    "container_sha256", "pngs")}), key
        elif entry.get("dates") == "masked":
            assert hashlib.sha256(mask_pdf_dates(got)).hexdigest() == entry[
                "sha256"], key
        else:
            assert hashlib.sha256(got).hexdigest() == entry["sha256"], key


def test_png_rows_take_pils_filters():
    """The filter byte of each row is the one PIL's ZipEncode.c chose
    (PIL's IDAT inflated), for each committed input and mode."""
    for rgba in INPUTS.values():
        for mode in MODES:
            img = image_of(rgba, mode)
            b = io.BytesIO()
            Image.fromarray(img).save(b, "PNG")
            pos, idat, data = 8, b"", b.getvalue()
            while pos < len(data):
                n = int.from_bytes(data[pos:pos + 4], "big")
                if data[pos + 4:pos + 8] == b"IDAT":
                    idat += data[pos + 8:pos + 8 + n]
                pos += 12 + n
            _, px = image_save.image_mode(img)
            assert image_save.png_idat_stream(px) == zlib.decompress(idat)


def _pil_bytes(img, fmt):
    b = io.BytesIO()
    Image.fromarray(img).save(b, fmt)
    return b.getvalue()


def _content(draw_kind, rng, h, w, c):
    shape = (h, w, c)
    if draw_kind == 0:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if draw_kind == 1:
        return rng.choice(np.array([0, 255], np.uint8), shape)
    if draw_kind == 2:
        ramp = np.arange(w) * 255 // max(w - 1, 1)
        return np.broadcast_to(ramp.astype(np.uint8)[None, :, None],
                               shape).copy()
    if draw_kind == 3:
        return np.full(shape, rng.integers(0, 256), np.uint8)
    return rng.normal(128, 60, shape).clip(0, 255).astype(np.uint8)


@settings(max_examples=60, deadline=None)
@given(w=st.integers(1, 70), h=st.integers(1, 70),
       mode=st.sampled_from(["L", "RGB"]), kind=st.integers(0, 4),
       seed=st.integers(0, 2**31))
def test_jpeg_sweep(w, h, mode, kind, seed):
    """Sizes of every remainder modulo the MCU (1-70), grey and 4:2:0,
    noise, black and white, ramps, flat and Gaussian content."""
    img = _content(kind, np.random.default_rng(seed), h, w, MODES[mode])
    img = img[..., 0] if mode == "L" else img
    _, px = image_save.image_mode(img)
    assert image_save.save_jpeg(px, mode, "x.jpg") == _pil_bytes(img, "JPEG")


@settings(max_examples=60, deadline=None)
@given(w=st.integers(1, 60), h=st.integers(1, 40),
       mode=st.sampled_from(list(MODES)), kind=st.integers(0, 4),
       seed=st.integers(0, 2**31))
def test_png_sweep(w, h, mode, kind, seed):
    img = _content(kind, np.random.default_rng(seed), h, w, MODES[mode])
    img = img[..., 0] if mode == "L" else img
    _, px = image_save.image_mode(img)
    assert_same_file(image_save.save_png(px, mode, "x.png"),
                     _pil_bytes(img, "PNG"), "PNG")


def test_png_idat_chunks_split_as_pils_buffer():
    """IDAT chunks of max(65536, 4 x width) bytes, the last shorter."""
    img = np.random.default_rng(4).integers(0, 256, (40, 17000, 3),
                                            dtype=np.uint8)
    _, px = image_save.image_mode(img)
    got = png_parts(image_save.save_png(px, "RGB", "x.png"))["idat"]
    assert got[:-1] == [4 * 17000] * (len(got) - 1) and got[-1] <= 68000
    assert got == png_parts(_pil_bytes(img, "PNG"))["idat"]


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


def test_cli_writes_jpeg_as_the_jax_cli(tmp_path):
    """Both CLIs on tests/test_torch_cli.py's scene at 32x24, 8 spp (two
    batches of 4), with --out x.jpg --capture-every 4: JPEG files (the
    captures named as the JAX CLI names them), decoded within
    tests/test_torch_cli.py's tolerance of the JAX CLI's; the last capture
    is the final image, byte for byte.
    An extension PIL does not know raises ValueError in both."""
    from tracerboy_tpu.app.cli import main as jax_main
    from tracerboy_tpu.core.image_io import read_ldr
    from tracerboy_tpu_torch.app import cli

    scene = tmp_path / "s.pbrt"
    scene.write_text(textwrap.dedent(SCENE))
    common = [str(scene), "--spp", "8", "--size", "32x24", "--quiet",
              "--capture-every", "4"]
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    assert jax_main([*common, "--out", str(tmp_path / "j" / "x.jpg")]) == 0
    assert cli.main([*common, "--out", str(tmp_path / "t" / "x.jpg"),
                     "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == ["x.jpg", "x_00004.jpg", "x_00008.jpg"]
    assert sorted(os.listdir(tmp_path / "t")) == names
    for n in names:
        got, ref = (tmp_path / "t" / n).read_bytes(), (
            tmp_path / "j" / n).read_bytes()
        assert got[:11] == ref[:11] == b"\xff\xd8\xff\xe0\x00\x10JFIF\x00"
        a, b = read_ldr(str(tmp_path / "t" / n)), read_ldr(
            str(tmp_path / "j" / n))
        assert a.shape == b.shape == (24, 32, 3)
        assert (np.abs(a - b) <= 2 / 255 + 1e-6).all(-1).mean() >= 0.99
    assert (tmp_path / "t" / "x.jpg").read_bytes() == (
        tmp_path / "t" / "x_00008.jpg").read_bytes()
    short = [str(scene), "--spp", "4", "--size", "32x24", "--quiet",
             "--capture-every", "4"]
    with pytest.raises(ValueError, match="unknown file extension"):
        jax_main([*short, "--out", str(tmp_path / "j" / "x.exr")])
    with pytest.raises(ValueError, match="unknown file extension"):
        cli.main([*short, "--out", str(tmp_path / "t" / "x.exr"),
                  "--device", "cpu"])


def _cut_files():
    """The committed JPEG fixtures and the port's own JPEGs of the
    committed inputs."""
    files = {os.path.basename(p): open(p, "rb").read() for p in sorted(
        glob.glob(os.path.join(FIXTURE_DIR, "..", "jpeg", "*.jpg")))}
    for name, rgba in INPUTS.items():
        for mode in ("L", "RGB"):
            _, px = image_save.image_mode(image_of(rgba, mode))
            files[f"written_{name}_{mode}"] = image_save.save_jpeg(
                px, mode, "x.jpg")
    return files


CUT_FILES = _cut_files()


def _class_of(read, path):
    from PIL import UnidentifiedImageError as PilUnidentified

    try:
        read(path)
    except (PilUnidentified, image_io.UnidentifiedImageError):
        return "unidentified"
    except NotImplementedError:
        return "NotImplementedError"
    except OSError:
        return "OSError"
    except Exception as e:
        return type(e).__name__
    return "read"


@pytest.mark.parametrize("name", sorted(CUT_FILES))
def test_cut_headers_are_refused_as_pil_refuses_them(name, tmp_path):
    """Every cut length up to the end of the first SOS segment: where the
    JAX read_ldr's PIL does not identify the file (cut inside a marker or
    a segment's length), neither does the port's decode_ldr; where PIL's
    _safe_read finds a segment cut short, both raise OSError."""
    from tracerboy_tpu.core.image_io import read_ldr

    data = CUT_FILES[name]
    sos = data.index(b"\xff\xda")
    end = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    path = str(tmp_path / "c.jpg")
    seen = set()
    for n in range(1, end + 1):
        with open(path, "wb") as f:
            f.write(data[:n])
        ref = _class_of(read_ldr, path)
        assert _class_of(image_io.decode_ldr, path) == ref, n
        seen.add(ref)
    assert "unidentified" in seen and "OSError" in seen


def test_viewer_capture_and_turntable_write_as_the_jax_viewer(
        tmp_path, monkeypatch):
    """The viewer's capture key and run_turntable write their .png files
    through write_png, byte for byte as the JAX viewer's (renders stubbed
    with one float image, as tests/test_torch_viewer.py stubs them)."""
    from test_torch_viewer import _jax_renderer, _renderer
    from tracerboy_tpu.app import viewer as jax_viewer
    from tracerboy_tpu_torch.app import viewer

    img = np.random.default_rng(5).random((6, 8, 3)).astype(np.float32)
    for name, mod, r in (("j", jax_viewer, _jax_renderer((8, 6))),
                         ("t", viewer, _renderer((8, 6)))):
        r.render_sample = lambda spp: None
        r.current_image = lambda: img
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert mod.ViewerController(r).on_key("p") == "capture"
        mod.run_turntable(r, 2, "frames", spp=1)
    names = ["capture_00000.png", "frames/frame_0000.png",
             "frames/frame_0001.png"]
    for n in names:
        assert_same_file((tmp_path / "t" / n).read_bytes(),
                         (tmp_path / "j" / n).read_bytes(), "PNG")
