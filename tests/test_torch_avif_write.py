"""The port's AVIF writer, part 1 (core/avif_save.py; the AV1 bitstream
writer in csrc/av1_encode.cpp, the decision record in
csrc/av1_decode.cpp's tb_av1_record) against what PIL 12.1 writes through
libavif 1.3 and aom 3.12, which the JAX write_png's .avif and .avifs are.

- Every AV1 payload of tests/data/avif (colour and alpha items, grid
  tiles, a track's first sample), decoded to its record and written back,
  is the fixture's payload byte for byte, and the first av1C box's fields
  are what avif_save.av1c reads from the first payload.
- The JAX write_png's AVIF of every committed input of tests/data/write,
  in L, LA, RGB and RGBA, uint8 and float, is the port's container around
  the payloads it rewrites from that file's records, with the alpha item
  where the port's RGB-to-YUV makes an alpha plane.
- A hypothesis sweep of PIL's saves (default, the in-loop filters off,
  4:4:4, quality 0 and 100, speed 0 and 10) is rewritten the same way.
- The port's RGB-to-YUV and alpha equal the planes of PIL's quality=100
  (lossless) saves, odd sizes and opaque RGBA (no alpha item) included.
- Records whose levels and intra modes are changed within their ranges
  are written and read back as they are.

.avif and .avifs stay refused by write_png (ROADMAP Queue 1 item 25:
tests/test_torch_image_write.py holds it): aom's search is parts 2-4.
"""

import glob
import io
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from make_write_fixtures import FIXTURE_DIR, MODES, image_of
from tracerboy_tpu_torch.core import avif, avif_save, image_io, image_save
from tracerboy_tpu_torch.core.codecs import av1_library

torch.set_num_threads(2)

AVIF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "avif")
FIXTURES = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(AVIF_DIR, "*.avif")))
with np.load(os.path.join(FIXTURE_DIR, "inputs.npz")) as _npz:
    INPUTS = {name: _npz[name] for name in _npz.files}
FILTERS_OFF = {"enable-cdef": "0", "enable-restoration": "0",
               "loopfilter-control": "0", "enable-intrabc": "0"}
SAVES = ({}, {"advanced": FILTERS_OFF}, {"subsampling": "4:4:4"},
         {"quality": 0}, {"quality": 100}, {"speed": 0}, {"speed": 10})


def payloads(data: bytes):
    """The colour and alpha payloads core/avif.py reads (a grid's tiles
    each)."""
    out = []
    for spec in avif._parse(data)[:2]:
        if isinstance(spec, avif._Grid):
            out += spec.tiles
        elif spec is not None:
            out.append(spec)
    return out


def rewrite(payload):
    return None if payload is None else avif_save.write(
        avif_save.record(payload))


def port_file(img, pil_bytes: bytes) -> bytes:
    """The port's AVIF of write_png's image around the payloads it
    rewrites from PIL's file: the alpha item only where rgb_to_yuv makes
    an alpha plane."""
    mode, px = image_save.image_mode(image_io._to_uint8(img))
    frame = avif_save.pil_frame(px, mode)
    alpha_plane = avif_save.rgb_to_yuv(frame)[3]
    color, alpha = avif._parse(pil_bytes)[:2]
    assert (alpha_plane is None) == (alpha is None)
    return avif_save.encode_avif(frame.shape[1], frame.shape[0],
                                 rewrite(color), rewrite(alpha))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_payloads_rewritten(name):
    with open(os.path.join(AVIF_DIR, name), "rb") as f:
        data = f.read()
    found = payloads(data)
    assert found
    for payload in found:
        assert rewrite(payload) == payload
    # The first av1C's fields are the first payload's sequence header's
    # (full sequence headers too: the animations').
    at = data.find(b"av1C")
    assert data[at + 4:at + 8] == avif_save.av1c(found[0])[8:]


def float_image(rgba: np.ndarray, mode: str, seed: int) -> np.ndarray:
    """Floats in [-0.1, 1.1] (the clip) with exact x*255+0.5 ties."""
    rng = np.random.default_rng(seed)
    img = (rng.random(image_of(rgba, mode).shape) * 1.2 - 0.1).astype(
        np.float32)
    img.flat[:4] = np.array([0.5, 1.5, 254.5, 255.0], np.float32)[
        :img.size] / 255
    return img


@pytest.mark.parametrize("kind", ["uint8", "float"])
@pytest.mark.parametrize("ext", [".avif", ".avifs"])
@pytest.mark.parametrize("mode", list(MODES))
def test_write_png_files(mode, ext, kind, tmp_path):
    from tracerboy_tpu.core.image_io import write_png

    for k, (name, rgba) in enumerate(INPUTS.items()):
        img = (image_of(rgba, mode) if kind == "uint8"
               else float_image(rgba, mode, k))
        path = str(tmp_path / (name + ext))
        write_png(path, img)
        with open(path, "rb") as f:
            ref = f.read()
        assert port_file(img, ref) == ref, (name, mode)


def content(rng, h: int, w: int, c: int, kind: str) -> np.ndarray:
    y, x = np.mgrid[:h, :w]
    if kind == "noise":
        img = rng.integers(0, 256, (h, w, c))
    elif kind == "ramp":
        steps = rng.integers(0, 8, (2, c))
        img = (x[..., None] * steps[0] + y[..., None] * steps[1]) % 256
    else:           # blocks of few colours: palette and intra block copy
        b = int(rng.integers(2, 9))
        cells = rng.integers(0, 4, ((h + b - 1) // b, (w + b - 1) // b))
        colours = rng.integers(0, 256, (4, c))
        img = colours[cells[y // b, x // b]]
    return np.ascontiguousarray(img, np.uint8)


@settings(max_examples=10, deadline=None)
@given(w=st.integers(1, 96), h=st.integers(1, 96),
       mode=st.sampled_from(list(MODES)),
       kind=st.sampled_from(["noise", "ramp", "blocks"]),
       save=st.integers(0, len(SAVES) - 1), seed=st.integers(0, 2**31))
def test_pil_saves_rewritten(w, h, mode, kind, save, seed):
    rng = np.random.default_rng(seed)
    px = content(rng, h, w, MODES[mode], kind)
    if mode in ("LA", "RGBA") and rng.random() < 0.5:
        px[..., -1] = 255
    out = io.BytesIO()
    Image.fromarray(px[..., 0] if mode == "L" else px, mode).save(
        out, "AVIF", **SAVES[save])
    ref = out.getvalue()
    color, alpha = avif._parse(ref)[:2]
    assert rewrite(color) == color
    assert rewrite(alpha) == alpha
    frame = avif_save.pil_frame(px, mode)
    assert (avif_save.rgb_to_yuv(frame)[3] is None) == (alpha is None)
    assert avif_save.encode_avif(w, h, rewrite(color), rewrite(alpha)) == ref


def tiles_image(case: str) -> np.ndarray:
    """Images whose tiles aom codes to chosen sizes: the last tile of
    noise and the rest flat, every tile alike, or one large last column
    of tiles."""
    rng = np.random.default_rng(7)
    if case == "last_largest":
        img = np.full((256, 256, 3), 90, np.uint8)
        img[128:, 128:] = rng.integers(0, 256, (128, 128, 3))
    elif case == "all_alike":
        img = np.full((256, 256, 3), 90, np.uint8)
    else:
        img = np.full((128, 512, 3), 30, np.uint8)
        img[:, 448:] = rng.integers(0, 256, (128, 64, 3))
    return img


@pytest.mark.parametrize("case,tiles", [
    ("last_largest", {"tile_rows": 1, "tile_cols": 1}),
    ("all_alike", {"tile_rows": 1, "tile_cols": 1}),
    ("last_column", {"tile_cols": 3})])
def test_tile_choices(case, tiles):
    """context_update_tile_id (the first of the largest tiles, the last
    tile counted) and tile_size_bytes as aom chooses them."""
    out = io.BytesIO()
    Image.fromarray(tiles_image(case)).save(out, "AVIF", **tiles)
    color = avif._parse(out.getvalue())[0]
    assert avif.frame_info(out.getvalue(), headers_only=True)["tiles"] > 1
    assert rewrite(color) == color


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "opaque"])
@pytest.mark.parametrize("size", [(1, 1), (2, 3), (3, 2), (7, 9), (33, 17),
                                  (64, 48), (97, 65)])
def test_rgb_to_yuv_is_libavifs(size, mode):
    w, h = size
    rng = np.random.default_rng(w * 131 + h)
    c = 4 if mode == "opaque" else MODES[mode]
    px = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if mode == "opaque":
        px[..., 3] = 255
        mode = "RGBA"
    out = io.BytesIO()
    Image.fromarray(px[..., 0] if mode == "L" else px, mode).save(
        out, "AVIF", quality=100)
    assert avif.frame_info(out.getvalue(), headers_only=True)["lossless"]
    color, alpha = avif._parse(out.getvalue())[:2]
    lib = av1_library()
    planes = avif._decode_av1(lib, color, "<avif>")[0]
    y, u, v, a = avif_save.rgb_to_yuv(avif_save.pil_frame(px, mode))
    for got, ref in zip((y, u, v), planes):
        np.testing.assert_array_equal(got, ref)
    if a is None:
        assert alpha is None
    else:
        np.testing.assert_array_equal(
            a, avif._decode_av1(lib, alpha, "<avif>")[0][0])


def edited(rec: np.ndarray, rng) -> np.ndarray:
    """The record with levels and luma intra modes changed within their
    ranges: each coded level of a transform block with levels may become
    any value of -40..40 (the last one never 0, so the end of block
    stays), the mode of a block without intra block copy, palette or
    filter intra any of the 13, its angle delta any of -3..3 where the
    mode is directional and the block 8x8 or larger."""
    rec = rec.copy()
    kinds = ("skip", "y_mode", "angle_y", "intrabc", "pal_y",
             "filter_intra", "size")
    for tag, s, n in avif_save.entries(rec):
        if tag == avif_save.REC_TXB and rec[s + 5] > 0:
            cnt = int(rec[s + 5])
            lv = rec[s + 6:s + 6 + cnt]
            new = rng.integers(-40, 41, cnt)
            keep = rng.random(cnt) < 0.5
            lv[:] = np.where(keep, lv, new)
            if lv[-1] == 0:
                lv[-1] = 1
        elif tag == avif_save.REC_BLOCK:
            f = {k: int(rec[s + avif_save.B[k]]) for k in kinds}
            if f["intrabc"] or f["pal_y"] or f["filter_intra"]:
                continue
            mode = int(rng.integers(0, 13))
            rec[s + avif_save.B["y_mode"]] = mode
            directional = 1 <= mode <= 8 and f["size"] >= 3   # BLOCK_8X8
            rec[s + avif_save.B["angle_y"]] = (int(rng.integers(-3, 4))
                                              if directional else 0)
    return rec


@pytest.mark.parametrize("name", [
    "size_141x130.avif", "tiles_4x4.avif", "lossless.avif", "sb_128.avif",
    "deltaq_2.avif", "filt_switchable.avif", "palette.avif",
    "screen_palette.avif", "ibc_sub_420.avif", "grain_test_3.avif",
    "qm.avif", "filt_delta_lf.avif", "ibc_sb_128.avif"])
def test_edited_records_read_back(name):
    with open(os.path.join(AVIF_DIR, name), "rb") as f:
        data = f.read()
    rng = np.random.default_rng(len(name))
    for payload in payloads(data):
        rec = edited(avif_save.record(payload), rng)
        np.testing.assert_array_equal(avif_save.record(avif_save.write(rec)),
                                      rec)


def test_record_refuses_out_of_place_entries():
    """A record the writer cannot follow raises, naming what it found."""
    with open(os.path.join(AVIF_DIR, "size_3x2.avif"), "rb") as f:
        rec = avif_save.record(payloads(f.read())[0])
    tile = next(s for tag, s, n in avif_save.entries(rec)
                if tag == avif_save.REC_TILE)
    bad = rec.copy()
    bad[tile] = 5
    with pytest.raises(ValueError, match="a tile out of place"):
        avif_save.write(bad)
    with pytest.raises(ValueError, match="entries past the last tile"):
        avif_save.write(np.concatenate([rec, [avif_save.REC_TILE, 1, 0]]))


def test_avif_still_refused(tmp_path):
    for ext in (".avif", ".avifs"):
        with pytest.raises(NotImplementedError, match="item 25"):
            image_io.write_png(str(tmp_path / ("x" + ext)),
                               INPUTS["37x53"])
