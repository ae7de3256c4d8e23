"""The TGA and BMP layouts PIL reads beyond the common ones, in the port's
readers (core/image_io.read_tga, read_bmp, through read_ldr) against the
JAX package's read_ldr, which reads them through PIL: every decoded image
equal bit for bit (np.array_equal of read_ldr's float32), and where PIL
refuses a file the port raises too (ValueError where PIL raises OSError
or ValueError, NotImplementedError where PIL cannot identify the file).

TGA: 16-bit colour (5:5:5 and the attribute bit as an inverted alpha),
16- and 24-bit colour maps at any first index (PIL refuses 32-bit maps
and maps on grey-level 1 or colour images), grey with alpha,
bi-level, RLE packets (raw packets run on across rows, a run that crosses
its row is refused, as in PIL), every origin. BMP: OS/2 to V5 headers,
1-, 4- and 8-bit palettes (grey ramps read as L), 16-bit 555 and the
bit fields PIL reads (565 among them), RLE8 and RLE4 with PIL's own
reading of the delta escape, odd absolute runs and early ends. The
committed variant fixtures (tests/data/dds, tests/make_dds_fixtures.py)
and hypothesis sweeps of random headers and data at 8x8 to 20x12.
"""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from make_dds_fixtures import (
    FIXTURE_DIR,
    bmp_file,
    bmp_rle8,
    bmp_rows,
    tga_file,
    tga_rle,
)
from test_torch_dds import assert_as_jax, jax_read_ldr
from tracerboy_tpu_torch.core import image_io

torch.set_num_threads(2)

with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)
VARIANTS = sorted(n for n in MANIFEST["files"]
                  if n.endswith((".tga", ".bmp")))
SIZES = dict(w=st.integers(8, 20), h=st.integers(8, 12))


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("tga_bmp")


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_fixture_reads_as_the_jax_read_ldr(name):
    path = os.path.join(FIXTURE_DIR, name)
    assert np.array_equal(image_io.read_ldr(path), jax_read_ldr(path))
    assert np.array_equal(image_io.read_ldr(path, gamma_to_linear=True),
                          jax_read_ldr(path, gamma_to_linear=True))


def _tga_packets(rng, units: int, row: int, unit: int, cross: bool):
    """Random RLE packets for `units` pixels of `unit` bytes: runs that
    stay inside their row of `row` pixels (or, with cross, may leave it),
    raw packets that may run on into the next rows."""
    out, done = bytearray(), 0
    while done < units:
        left_in_row = row - done % row
        if rng.random() < 0.5:
            cap = units - done if cross else left_in_row
            n = int(rng.integers(1, min(128, cap) + 1))
            out.append(0x80 | (n - 1))
            out += rng.integers(0, 256, unit, dtype=np.uint8).tobytes()
        else:
            n = int(rng.integers(1, min(128, units - done) + 1))
            out.append(n - 1)
            out += rng.integers(0, 256, n * unit, dtype=np.uint8).tobytes()
        done += n
    return bytes(out)


# (image type, bits a pixel, colour map) of the random TGAs: every layout
# PIL decodes, and a few it refuses (no colour map on a colour-mapped
# type, an unloadable depth, a colour map on a colour image).
TGA_LAYOUTS = [(1, 8, True), (9, 8, True), (2, 16, False), (10, 16, False),
               (2, 24, False), (10, 24, False), (2, 32, False),
               (10, 32, False), (3, 1, False), (3, 8, False), (11, 8, False),
               (3, 16, False), (11, 16, False), (3, 8, True), (1, 8, False),
               (2, 8, False), (2, 24, True)]


@settings(max_examples=50, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), layout=st.sampled_from(TGA_LAYOUTS),
       cmap=st.sampled_from([16, 24, 16, 24, 15, 32]),
       first=st.integers(0, 6), count=st.integers(1, 24),
       flags=st.integers(0, 0x3F), cross=st.integers(0, 4), **SIZES)
def test_random_tga(scratch, seed, layout, cmap, first, count, flags,
                    cross, w, h):
    """Random TGAs over every image type, depth, colour map and origin,
    with random pixels or RLE packets (cross == 0: runs that may cross
    their row)."""
    itype, depth, mapped = layout
    rng = np.random.default_rng(seed)
    cm = None
    if mapped:
        cm = (cmap, first, rng.integers(0, 256, count * (cmap + 7) // 8,
                                        dtype=np.uint8).tobytes())
    if itype & 8:
        unit = (depth + 7) // 8
        row = -(-w * depth // 8) // unit
        pixels = _tga_packets(rng, row * h, row, unit, cross == 0)
    else:
        pixels = rng.integers(0, 256, -(-w * depth // 8) * h,
                              dtype=np.uint8).tobytes()
    if itype in (1, 9) and cm is not None:
        pixels = bytes(b % (first + count + 2) for b in pixels)
    assert_as_jax(scratch / "r.tga", tga_file(w, h, itype, depth, pixels, cm,
                                        flags))


@pytest.mark.parametrize("depth,itype", [(16, 2), (16, 10), (16, 3),
                                         (1, 3), (8, 9), (8, 11)])
def test_tga_variants_decode(tmp_path, depth, itype):
    """Each new (type, depth) decodes, as in PIL, with and without RLE."""
    rng = np.random.default_rng(depth * 16 + itype)
    w, h = 11, 6
    rowbytes = -(-w * depth // 8)
    rows = rng.integers(0, 256, (h, rowbytes), dtype=np.uint8)
    cm = (16, 2, rng.integers(0, 256, 40, dtype=np.uint8).tobytes()) \
        if itype in (1, 9) else None
    if cm is not None:
        rows %= 22
    pixels = tga_rle(rows, max(1, depth // 8)) if itype & 8 else \
        rows.tobytes()
    got = assert_as_jax(tmp_path / "v.tga", tga_file(w, h, itype, depth, pixels,
                                               cm, 0x20))
    assert got is not None
    assert got.shape[-1] == (4 if depth == 16 and itype != 9 else 3)


def test_tga_run_across_a_row_is_refused(tmp_path):
    """PIL's TgaRleDecode refuses a run packet that crosses the end of its
    row (buffer overrun); a raw packet may."""
    w, h = 5, 3
    across = bytes([0x86, 7]) + bytes([0x87, 9])       # 7 + 8 pixels
    assert assert_as_jax(tmp_path / "a.tga", tga_file(w, h, 11, 8, across)) \
        is None
    raw = bytes([6]) + bytes(range(7)) + bytes([0x82, 9, 4]) + bytes(5)
    assert assert_as_jax(tmp_path / "b.tga", tga_file(w, h, 11, 8, raw)) \
        is not None


def _rle_stream(rng, w: int, h: int, rle4: bool) -> bytes:
    """Random BMP RLE commands: encoded runs (sometimes past the row's
    end), absolute runs (odd counts too), end of line, delta escapes,
    and an end of bitmap, until about w * h pixels are written."""
    out, n = bytearray(), 0
    while n < w * h + w:
        r = rng.random()
        if r < 0.45:
            k = int(rng.integers(1, w + 3))
            out += bytes((k, int(rng.integers(0, 256))))
            n += k
        elif r < 0.75:
            k = int(rng.integers(3, w + 1))
            body = rng.integers(0, 256, (k + 1) // 2 if rle4 else k,
                                dtype=np.uint8).tobytes()
            out += bytes((0, k)) + body
            if len(out) % 2:
                out += b"\0"
            n += k
        elif r < 0.9:
            out += b"\0\0"
            n += w - n % w
        else:
            out += bytes((0, 2, *rng.integers(0, 4, 4).tolist()))
            n += 2
    return bytes(out) + b"\0\1"


@settings(max_examples=50, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       header=st.sampled_from([12, 40, 52, 56, 64, 108, 124]),
       bits=st.sampled_from([1, 4, 8, 16, 24, 32]),
       compression=st.sampled_from([0, 0, 1, 2, 3]),
       grey=st.booleans(), top_down=st.booleans(), colors=st.integers(0, 20),
       masks=st.sampled_from([(0xF800, 0x7E0, 0x1F, 0),
                              (0x7C00, 0x3E0, 0x1F, 0),
                              (0xFF0000, 0xFF00, 0xFF, 0),
                              (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                              (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                              (0xF00, 0xF0, 0xF, 0)]), **SIZES)
def test_random_bmp(scratch, seed, header, bits, compression, grey,
                    top_down, colors, masks, w, h):
    """Random BMP headers over every header size, depth, compression,
    bit-field layout, palette size and direction, with random rows or
    random RLE8/RLE4 streams."""
    rng = np.random.default_rng(seed)
    if header == 12:
        compression, colors, top_down = 0, 0, False
    n_pal = colors or (1 << bits if bits <= 8 else 0)
    pad = 3 if header == 12 else 4
    if grey:
        ramp = [0, 255] if n_pal == 2 else list(range(n_pal))
        palette = b"".join(bytes((v % 256,) * 3) + bytes(pad - 3)
                           for v in ramp)
    else:
        palette = rng.integers(0, 256, n_pal * pad, dtype=np.uint8).tobytes()
    if compression in (1, 2):
        pixels = _rle_stream(rng, w, h, compression == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        pixels = rng.integers(0, 256, stride * h, dtype=np.uint8).tobytes()
    data = bmp_file(w, h, bits, pixels, header_size=header,
                    compression=compression, palette=palette,
                    masks=masks if compression == 3 else None, colors=colors,
                    top_down=top_down)
    assert_as_jax(scratch / "r.bmp", data)


BMP_VARIANTS = [(1, 0, None), (4, 0, None), (16, 0, None),
                (16, 3, (0xF800, 0x7E0, 0x1F)), (16, 3, (0x7C00, 0x3E0, 0x1F)),
                (8, 1, None), (4, 2, None)]


@pytest.mark.parametrize("bits,compression,masks,header", [
    (*v, header) for v in BMP_VARIANTS for header in (12, 40, 124)
    if header != 12 or not (v[1] or v[2])])
def test_bmp_variants_decode(tmp_path, bits, compression, masks, header):
    """Each new depth, bit-field layout and RLE decodes, as in PIL (an
    OS/2 header has no compression field)."""
    rng = np.random.default_rng(bits * 7 + compression)
    w, h = 13, 6
    if bits == 16:
        pixels = bmp_rows(rng.integers(0, 65536, (h, w)), 16)
    elif compression == 1:
        pixels = bmp_rle8(np.repeat(rng.integers(0, 16, (h, 5)),
                                    [4, 1, 3, 2, 3], axis=1))
    elif compression == 2:
        pixels = bytes([0, 4, 0x12, 0x34, 5, 0x56, 4, 0x78, 0, 0]) * h \
            + b"\0\1"
    else:
        pixels = bmp_rows(rng.integers(0, 1 << bits, (h, w)), bits)
    pad = 3 if header == 12 else 4
    palette = rng.integers(0, 256, (1 << min(bits, 8)) * pad,
                           dtype=np.uint8).tobytes() if bits <= 8 else b""
    data = bmp_file(w, h, bits, pixels, header_size=header,
                    compression=compression, palette=palette,
                    masks=None if masks is None else masks + (0,))
    assert assert_as_jax(tmp_path / "v.bmp", data) is not None


@pytest.mark.parametrize("case", ["delta_reads_four_bytes", "odd_rle4",
                                  "run_past_row_end", "early_end"])
def test_bmp_rle_quirks(tmp_path, case):
    """PIL's BmpRleDecoder as it reads: a delta escape skips two bytes and
    takes the next two as (right, up); an odd RLE4 absolute run drops its
    last pixel but counts it; an encoded run is cut at its row's end; an
    end of bitmap before the last row leaves too few pixels (refused)."""
    w, h = 8, 4
    body = {
        "delta_reads_four_bytes": bytes([0, 2, 1, 1, 3, 0]) + bytes(
            [5, 1, 0, 0]) + bytes([8, 2, 0, 0]) * 3,
        "odd_rle4": bytes([0, 5, 0x12, 0x34, 3, 0x77, 0, 0])
        + bytes([8, 0x21, 0, 0]) * 3,
        "run_past_row_end": bytes([12, 3, 0, 0]) + bytes([8, 5, 0, 0]) * 3,
        "early_end": bytes([8, 1, 0, 1]),
    }[case]
    rle4 = case == "odd_rle4"
    palette = np.random.default_rng(5).integers(0, 256, 64,
                                                dtype=np.uint8).tobytes()
    data = bmp_file(w, h, 4 if rle4 else 8, body,
                    compression=2 if rle4 else 1, palette=palette,
                    colors=16)
    got = assert_as_jax(tmp_path / "q.bmp", data)
    assert (got is None) == (case == "early_end")


def test_refusal_names_what_is_not_ported(tmp_path):
    """A variant PIL reads that the port does not (a JPEG whose
    coefficients pass the 16-bit range of PIL's SIMD IDCT) raises
    NotImplementedError naming its ROADMAP item; an arithmetic-coded JPEG
    and FITS, which the port now reads (PIL's small formats part 3, the
    JPEG variants), read as the JAX read_ldr reads them."""
    import io

    from PIL import Image

    from jpeg_encode import encode_coefficients

    block = np.zeros((1, 1, 64), np.int64)
    block[0, 0, 0] = 1500
    (tmp_path / "big.jpg").write_bytes(encode_coefficients(
        [block], 8, 8, [(1, 1)], [np.full(64, 8)]))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        image_io.read_ldr(str(tmp_path / "big.jpg"))
    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(buf, "JPEG")
    assert assert_as_jax(tmp_path / "a.jpg", buf.getvalue().replace(
        b"\xff\xc0", b"\xff\xc9", 1)) is not None
    cards = [b"SIMPLE  = T", b"BITPIX  = 8", b"NAXIS   = 2",
             b"NAXIS1  = 4", b"NAXIS2  = 4", b"END"]
    fits = b"".join(c.replace(b"= ", b"=" + b" " * 20).ljust(80)
                    for c in cards).ljust(2880) + bytes(2880)
    assert assert_as_jax(tmp_path / "g.fits", fits) is not None
