"""The port's GIF and ICO readers (core/gif.py, core/ico.py,
csrc/lzw_codecs.cpp, through core/image_io.read_ldr) against the JAX
package's read_ldr, which reads them through PIL: every case equal bit
for bit (np.array_equal of read_ldr's float32), and where PIL refuses a
file the port raises too (ValueError where PIL raises OSError,
ValueError or EOFError, NotImplementedError where PIL cannot identify
it).

GIF: the committed fixtures (tests/data/tiff, tests/make_tiff_fixtures.py)
and hypothesis sweeps of the first frame: global and local tables of 2 to
256 entries (grey ramps read as L), LZW code sizes up to 8, interlaced
rows, frames at offsets, smaller or larger than the screen, transparent
indices filling the screen around them, data cut short. ICO: the
fixtures and sweeps of directories of one to three entries, PNG entries
of every mode and BMP entries at 1, 4, 8, 24 and 32 bits a pixel with
random AND masks, PIL's choice among them.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, UnidentifiedImageError

from make_tiff_fixtures import FIXTURE_DIR
from test_torch_tiff import assert_as_jax, jax_read_ldr
from tiff_encode import dib, gif_file, ico_file
from tracerboy_tpu_torch.core import gif, ico, image_io

torch.set_num_threads(2)

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
FIXTURES = sorted(n for n in MANIFEST["files"] if n.endswith((".gif",
                                                              ".ico")))


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("gif_ico")


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    got = image_io.read_ldr(path)
    assert got.dtype == np.float32
    assert np.array_equal(got, jax_read_ldr(path))
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


def _table(rng, bits, grey):
    if grey:
        return np.repeat(np.arange(1 << bits, dtype=np.uint8)[:, None], 3, 1)
    return rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)


@settings(max_examples=120, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), w=st.integers(1, 48),
       h=st.integers(1, 36), bits=st.integers(1, 8),
       table=st.sampled_from(["global", "local", "both", "none", "grey"]),
       interlace=st.booleans(), offset=st.tuples(st.integers(0, 9),
                                                 st.integers(0, 9)),
       screen=st.integers(-4, 6), transparency=st.booleans(),
       runs=st.booleans(), cut=st.sampled_from([0, 0, 0, 1, 3, 20]))
def test_random_gifs(scratch, seed, w, h, bits, table, interlace, offset,
                     screen, transparency, runs, cut):
    """Indices of `bits` bits (noise, or runs that build long LZW
    strings), under any table arrangement, offset and screen size; the
    code size one above the indices' where the seed says so; the last
    `cut` bytes dropped (PIL: truncated)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
    if runs:
        idx = np.repeat(idx, 5, axis=1)[:, :w]
    glob = _table(rng, bits, table == "grey") if table in (
        "global", "both", "grey") else None
    local = _table(rng, int(rng.integers(1, 9)), False) if table in (
        "local", "both") else None
    scr = (max(1, w + offset[0] + screen), max(1, h + offset[1] + screen))
    data = gif_file(idx, screen=scr, offset=offset, global_table=glob,
                    local_table=local, interlace=interlace,
                    transparency=int(rng.integers(0, 1 << bits))
                    if transparency else None,
                    min_bits=min(8, max(2, bits) + int(rng.integers(0, 2))),
                    truncate=cut)
    assert_as_jax(scratch / "r.gif", data)


@pytest.mark.parametrize("colors", [2, 16, 256])
@pytest.mark.parametrize("interlace", [False, True])
def test_pil_written_gifs(scratch, colors, interlace):
    """GIFs PIL's own encoder writes (its code widths and clear codes),
    P and L images, up to the 4096-entry table's reset."""
    rng = np.random.default_rng(colors)
    for w, h in ((1, 1), (67, 45), (130, 100)):
        idx = rng.integers(0, colors, (h, w), dtype=np.uint8)
        for mode in ("P", "L"):
            im = Image.fromarray(idx, mode)
            if mode == "P":
                im.putpalette(rng.integers(0, 256, 3 * colors,
                                           dtype=np.uint8).tobytes())
            buf = io.BytesIO()
            im.save(buf, "GIF", interlace=interlace)
            assert assert_as_jax(scratch / "p.gif",
                                 buf.getvalue()) is not None


@settings(max_examples=80, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 3),
       kinds=st.lists(st.sampled_from([1, 4, 8, 24, 32, "png"]), min_size=3,
                      max_size=3),
       square=st.booleans())
def test_random_icos(scratch, seed, n, kinds, square):
    """Directories of n entries of random sizes (some equal, so PIL's
    colour-depth order decides), PNG entries in RGBA, RGB, LA, L and P,
    BMP entries with random palettes (grey ramps read as L, which PIL
    then reads a byte a pixel, refusing rows wider than the stride) and
    AND masks; PIL opens the first after its sort."""
    rng = np.random.default_rng(seed)
    entries = []
    side = int(rng.integers(1, 70))
    for kind in kinds[:n]:
        w = side if square else int(rng.integers(1, 70))
        h = side if square else int(rng.integers(1, 70))
        if kind == "png":
            img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            mode = str(rng.choice(["RGBA", "RGB", "LA", "L", "P"]))
            buf = io.BytesIO()
            Image.fromarray(img).convert(mode).save(buf, "PNG")
            entries.append((w, h, 32, buf.getvalue()))
            continue
        mask = rng.integers(0, 2, (h, w), dtype=np.uint8)
        if kind <= 8:
            pal = _table(rng, kind, rng.random() < 0.2)
            px = rng.integers(0, 1 << kind, (h, w), dtype=np.uint8)
            entries.append((w, h, kind, dib(px, kind, pal, mask)))
        else:
            px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            entries.append((w, h, kind, dib(px, kind, None, mask)))
    assert_as_jax(scratch / "r.ico", ico_file(entries))


def _errors():
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 4, (9, 11)).astype(np.uint8)
    table = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    good = gif_file(idx, global_table=table)
    short = bytearray(gif_file(idx[:4], global_table=table))
    at = short.index(b",")
    short[at + 7:at + 9] = (9).to_bytes(2, "little")   # 9 rows, data for 4
    mask = rng.integers(0, 2, (9, 11), dtype=np.uint8)
    one = dib(idx, 4, _table(rng, 4, False), mask)
    return {
        "gif_truncated": (good[:-6], ValueError, "truncated"),
        "gif_end_code_early": (bytes(short), ValueError, "truncated"),
        "gif_no_image": (good[:good.index(b",")] + b";", ValueError,
                         "no image"),
        "gif_short_header": (good[:10], NotImplementedError,
                             "cannot identify"),
        "ico_no_entries": (b"\0\0\1\0\0\0", NotImplementedError,
                           "cannot identify"),
        "ico_mask_cut": (ico_file([(11, 9, 4, one)])[:-20], ValueError,
                         "not enough image data"),
    }


@pytest.mark.parametrize("case", sorted(_errors()))
def test_bad_files_raise_as_pil_does(tmp_path, case):
    data, port_error, message = _errors()[case]
    path = tmp_path / ("bad.gif" if case.startswith("gif") else "bad.ico")
    path.write_bytes(data)
    pil_error = (UnidentifiedImageError if port_error is NotImplementedError
                 else (OSError, ValueError, EOFError))
    with pytest.raises(pil_error):
        jax_read_ldr(path)
    with pytest.raises(port_error, match=message):
        image_io.read_ldr(str(path))


def test_gif_frame_fill_and_modes():
    """The first frame at an offset on a larger screen: the transparent
    index fills around it (index 0 without one); a grey-ramp table reads
    as L, the indices the grey levels."""
    idx = np.arange(12, dtype=np.uint8).reshape(3, 4) % 4
    table = np.array([[9, 9, 9], [50, 60, 70], [1, 2, 3], [200, 100, 0]],
                     np.uint8)
    img, mode, tab = gif.decode_gif(gif_file(
        idx, screen=(7, 5), offset=(2, 1), global_table=table,
        transparency=3))
    assert mode == "P" and img.shape == (5, 7)
    assert (img[0] == 3).all() and np.array_equal(img[1:4, 2:6], idx)
    img, mode, _ = gif.decode_gif(gif_file(
        idx, global_table=np.repeat(np.arange(4, dtype=np.uint8)[:, None],
                                    3, 1)))
    assert mode == "L" and np.array_equal(img, idx)


def test_ico_picks_pils_entry():
    """PIL opens the largest entry, the lowest colour depth among equal
    sizes."""
    rng = np.random.default_rng(9)
    small = dib(rng.integers(0, 2, (8, 8), dtype=np.uint8), 1,
                _table(rng, 1, False))
    big = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    entries = [(8, 8, 1, small), (16, 16, 32, dib(big, 32)),
               (16, 16, 8, dib(big[..., 0], 8, _table(rng, 8, False)))]
    order = ico.ico_entries(ico_file(entries))
    assert [(e["width"], e["bpp"]) for e in order] == [(16, 8), (16, 32),
                                                       (8, 1)]
