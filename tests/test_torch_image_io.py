"""The port's image files (core/image_io.py, core/piz.py) against the JAX
package's, on seeded images (np.random.default_rng).

Tolerances: none. The writers' files are byte-equal (HDR, PFM, EXR with
ZIP and without compression); the readers' arrays are bit-equal (HDR flat
and run-length, PFM colour and grey, every committed goldens/*.exr and
renders/*.exr); the port's own PNG encoder, decoded by the JAX package's
PIL reader, gives exactly the pixels of the JAX writer's PNG.
"""

import glob
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from tracerboy_tpu.core import image_io as jio
from tracerboy_tpu.core import piz as jpiz
from tracerboy_tpu_torch.core import image_io as tio
from tracerboy_tpu_torch.core import piz as tpiz

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXRS = sorted(glob.glob(str(REPO / "goldens" / "*.exr"))
              + glob.glob(str(REPO / "renders" / "*.exr")))


def _hdr_image(seed, shape=(19, 23, 3)):
    rng = np.random.default_rng(seed)
    img = rng.lognormal(0.0, 2.0, size=shape).astype(np.float32)
    img[0, :3] = 0.0                       # black texels: exponent 0
    return img


@pytest.mark.parametrize("writer", ["hdr", "pfm", "pfm_grey", "exr_zip",
                                    "exr_none", "exr_channels"])
def test_writers_are_byte_equal(tmp_path, writer):
    img = _hdr_image(1)
    calls = {
        "hdr": lambda m, p: m.write_hdr(p, img),
        "pfm": lambda m, p: m.write_pfm(p, img),
        "pfm_grey": lambda m, p: m.write_pfm(p, img[..., 1]),
        "exr_zip": lambda m, p: m.write_exr(p, img),
        "exr_none": lambda m, p: m.write_exr(p, img, compress=False),
        "exr_channels": lambda m, p: m.write_exr(
            p, {"Y": img[..., 0], "A": img[..., 2], "Z": img[..., 1]}),
    }
    calls[writer](jio, str(tmp_path / "j"))
    calls[writer](tio, str(tmp_path / "t"))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()


@pytest.mark.parametrize("kind", ["rgb", "rgba", "uint8", "grey"])
def test_png_pixels_equal_the_jax_writer(tmp_path, kind):
    rng = np.random.default_rng(2)
    shape = {"rgb": (13, 17, 3), "rgba": (13, 17, 4), "uint8": (13, 17, 3),
             "grey": (13, 17)}[kind]
    if kind == "uint8":
        img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
        # Out-of-range values exercise the clip; x*255+0.5 ties too.
        img = (rng.random(shape) * 1.2 - 0.1).astype(np.float32)
        img.flat[:4] = np.array([0.5 / 255, 1.5 / 255, 254.5 / 255, 1.0],
                                np.float32)
    jio.write_png(str(tmp_path / "j.png"), img)
    tio.write_png(str(tmp_path / "t.png"), img)
    from PIL import Image

    ref = np.asarray(Image.open(tmp_path / "j.png"))
    got = np.asarray(Image.open(tmp_path / "t.png"))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    if kind != "grey":
        np.testing.assert_array_equal(jio.read_ldr(str(tmp_path / "t.png")),
                                      jio.read_ldr(str(tmp_path / "j.png")))


def _png_idat(data):
    """A PNG's chunk types and its concatenated IDAT bodies, each chunk's
    CRC checked."""
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, kinds, idat = 8, [], b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        idat += body if kind == b"IDAT" else b""
        kinds.append(kind)
        pos += 12 + n
    return kinds, idat


def test_png_chunks(tmp_path):
    """IHDR of an 8-bit RGB image, one IDAT, IEND, each chunk's CRC; the
    rows filtered as PIL's encoder filters them (the JAX writer's inflated
    stream), unfiltered to the quantised pixels."""
    import zlib

    img = np.linspace(0, 1, 5 * 7 * 3, dtype=np.float32).reshape(5, 7, 3)
    tio.write_png(str(tmp_path / "t.png"), img)
    jio.write_png(str(tmp_path / "j.png"), img)
    data = (tmp_path / "t.png").read_bytes()
    kinds, idat = _png_idat(data)
    assert struct.unpack(">IIBBBBB", data[16:29]) == (7, 5, 8, 2, 0, 0, 0)
    _, ref_idat = _png_idat((tmp_path / "j.png").read_bytes())
    assert kinds == [b"IHDR", b"IDAT", b"IEND"]
    assert zlib.decompress(idat) == zlib.decompress(ref_idat)
    q = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    assert np.array_equal(tio.read_png(str(tmp_path / "t.png"))[0], q)


def _write_rle_hdr(path, rgbe):
    """A new-style run-length Radiance file (the JAX writer writes flat
    ones): per scanline and channel, runs of equal bytes and literals."""
    h, w, _ = rgbe.shape
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
           f"-Y {h} +X {w}\n".encode()]
    for y in range(h):
        out.append(bytes([2, 2, w >> 8, w & 0xFF]))
        for c in range(4):
            row = rgbe[y, :, c]
            x = 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out.append(bytes([128 + run, row[x]]))
                    x += run
                else:
                    n = min(128, w - x)
                    out.append(bytes([n]) + row[x:x + n].tobytes())
                    x += n
    Path(path).write_bytes(b"".join(out))


def test_readers_are_bit_equal(tmp_path):
    img = _hdr_image(3, (11, 40, 3))
    jio.write_hdr(str(tmp_path / "flat.hdr"), img)
    jio.write_pfm(str(tmp_path / "c.pfm"), img)
    jio.write_pfm(str(tmp_path / "g.pfm"), img[..., 0])
    jio.write_exr(str(tmp_path / "z.exr"), img)
    jio.write_exr(str(tmp_path / "n.exr"), img, compress=False)
    rng = np.random.default_rng(4)
    rgbe = rng.integers(0, 256, size=(6, 40, 4), dtype=np.uint8)
    rgbe[:, 10:30] = rgbe[:, 10:11]          # runs
    _write_rle_hdr(tmp_path / "rle.hdr", rgbe)
    for name in ("flat.hdr", "rle.hdr", "c.pfm", "g.pfm", "z.exr", "n.exr"):
        p = str(tmp_path / name)
        a, b = jio.read_texture(p), tio.read_texture(p)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in ("z.exr", "n.exr"):
        ja, ta = (m.read_exr(str(tmp_path / name)) for m in (jio, tio))
        assert sorted(ja) == sorted(ta) == ["B", "G", "R"]
        assert all(ja[k].tobytes() == ta[k].tobytes() for k in ja)


@pytest.mark.parametrize("path", EXRS, ids=[Path(p).name for p in EXRS])
def test_committed_exrs_read_bit_equal(path):
    a, b = jio.read_exr_rgb(path), tio.read_exr_rgb(path)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()
    assert np.isfinite(b).all()


def _piz_block(rng, n_symbols, corrupt=False):
    """One PIZ block payload for n_symbols u16 values: a seeded 2-byte
    bitmap, then a Huffman stream with a fixed 5-bit code (symbols 0..16,
    16 the run code, unused; canonical codes give symbol i the code i)
    over seeded symbols 0..15. corrupt cuts the stream short."""
    im, iM = 0, 16
    table = np.unpackbits(np.full(iM - im + 1, 5, np.uint8)[:, None],
                          axis=1)[:, 2:].reshape(-1)          # 6 bits each
    symbols = rng.integers(0, 16, n_symbols).astype(np.uint8)
    data = np.unpackbits(symbols[:, None], axis=1)[:, 3:].reshape(-1)
    if corrupt:
        data = data[:-7]
    huf = (struct.pack("<iiiii", im, iM, 0, data.size, 0)
           + np.packbits(table).tobytes() + np.packbits(data).tobytes())
    return (struct.pack("<HH", 0, 1)
            + rng.integers(0, 256, 2).astype(np.uint8).tobytes()
            + struct.pack("<i", len(huf)) + huf)


@pytest.mark.parametrize("seed", range(4))
def test_piz_blocks_equal_on_seeded_data(seed):
    """read_piz_blocks of both packages on seeded PIZ blocks (half, float
    and uint channels; a cut-short stream fails alike): the same planes,
    or the same decoder error."""
    rng = np.random.default_rng(seed)
    width, lines = 9, 3
    chans = [("A", 0, 1, 1), ("B", 1, 1, 1), ("G", 2, 1, 1)]
    n = width * lines * sum(tpiz._PT_SIZES[c[1]] for c in chans)
    body = _piz_block(rng, n, corrupt=seed == 3)
    data = struct.pack("<ii", 0, len(body)) + body

    def run(mod):
        try:
            out = mod.read_piz_blocks(data, 0, chans, width, lines, 1, 32)
            return {k: v.tobytes() for k, v in out.items()}
        except ValueError as e:
            return str(e)

    got = run(tpiz)
    assert got == run(jpiz)
    assert isinstance(got, str) == (seed == 3), got
    assert tpiz._PT_SIZES == jpiz._PT_SIZES


def test_ldr_reading_is_refused(tmp_path):
    """A real JPEG reads as the JAX read_texture reads it through PIL,
    whether it is named .jpg or .png (both packages go by the file's
    signature); a 4-byte fake JPEG raises OSError in both."""
    from PIL import Image

    from tracerboy_tpu.core.image_io import read_texture as jax_read_texture

    img = np.random.default_rng(0).integers(0, 256, (13, 17, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "t.jpg", quality=90)
    (tmp_path / "t.png").write_bytes((tmp_path / "t.jpg").read_bytes())
    for name in ("t.jpg", "t.png"):
        path = str(tmp_path / name)
        got = tio.read_texture(path)
        assert got.shape == (13, 17, 3)
        assert np.array_equal(got, jax_read_texture(path))
    (tmp_path / "f.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    for read in (tio.read_texture, jax_read_texture):
        with pytest.raises(OSError):
            read(str(tmp_path / "f.jpg"))