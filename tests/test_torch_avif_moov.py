"""libavif's moov checks in the port's AVIF reader (core/avif.py
_parse_tracks and _from_tracks, csrc/av1_decode.cpp's parse ahead): every
one-byte edit of every box of a Pillow-saved animation's moov box reads,
or is refused, as the JAX package's read_ldr (PIL, so libavif and dav1d)
reads or refuses it. Each byte takes four values (its low bit flipped,
0, 255, its high bit flipped). Equal float32 images where PIL reads;
NotImplementedError where PIL cannot identify the file, ValueError where
it raises otherwise.

One kind of edit is refused where PIL reads: a colour track's tkhd size
that disagrees with the AV1 frame. Pillow then lays the frame's pixels
out at the track's size and returns what lies past them, as it does for
an item's ispe; the port raises ValueError, and the test pins that.

The colour animation's boxes are swept here, the RGBA animation's (its
alpha track, auxl and auxi among them) in test_torch_avif_moov_alpha.py.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

from make_avif_fixtures import sample
from tracerboy_tpu_torch.core import image_io

CONTAINERS = (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"tref",
              b"dinf")


def animation(channels: int) -> bytes:
    """Two 16x16 frames saved by Pillow, RGB or RGBA (an alpha track)."""
    rng = np.random.default_rng(5 + channels)
    frames = [Image.fromarray(sample(rng, 16, 16, channels))
              for _ in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:],
                   quality=60, speed=8)
    return buf.getvalue()


def moov_boxes(data: bytes, start: int, end: int, prefix: str = ""):
    """{path: (start, end)} of every box under moov, a container's own
    header counted as its own box; sample entries (stsd, av01) keep their
    fixed fields and their child boxes apart."""
    out = {}
    pos, n = start, 0
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", data, pos)
        name = f"{prefix}/{typ.decode('latin1')}#{n}"
        if typ in CONTAINERS:
            out[name] = (pos, pos + 8)
            out.update(moov_boxes(data, pos + 8, pos + size, name))
        elif typ in (b"stsd", b"av01"):
            fixed = 16 if typ == b"stsd" else 86
            out[name] = (pos, pos + fixed)
            out.update(moov_boxes(data, pos + fixed, pos + size, name))
        else:
            out[name] = (pos, pos + size)
        pos += size
        n += 1
    return out


def cases(channels: int):
    data = animation(channels)
    moov = data.index(b"moov") - 4
    (size,) = struct.unpack_from(">I", data, moov)
    return data, moov_boxes(data, moov, moov + size)


def edits(data: bytes, start: int, end: int):
    for pos in range(start, end):
        for v in sorted({data[pos] ^ 1, 0, 255, data[pos] ^ 0x80}
                        - {data[pos]}):
            yield pos, data[:pos] + bytes([v]) + data[pos + 1:]


def frame_size_of(data: bytes):
    """The first colour frame's size, as the port's AV1 decoder reads
    its headers (None where the file does not parse that far)."""
    from tracerboy_tpu_torch.core import avif
    from tracerboy_tpu_torch.core.codecs import av1_library

    try:
        color = avif._parse(data)[0]
        info = avif._av1_header(av1_library(), color, "<avif>")
    except Exception:
        return None
    return int(info[0]), int(info[1])


def check_edit(path, data: bytes):
    """The port against the JAX read_ldr on one edited file."""
    from tracerboy_tpu.core.image_io import read_ldr

    path.write_bytes(data)
    try:
        ref = read_ldr(str(path))
    except (NotImplementedError, UnidentifiedImageError):
        with pytest.raises(NotImplementedError):
            image_io.read_ldr(str(path))
        return "refused"
    except (OSError, ValueError, SyntaxError, RuntimeError, AssertionError,
            ZeroDivisionError):
        with pytest.raises(ValueError):
            image_io.read_ldr(str(path))
        return "refused"
    if ref.shape[:2] != (frame_size_of(data) or ref.shape[:2])[::-1]:
        # Pillow's layout of a frame at a track size it does not have.
        with pytest.raises(ValueError, match="the frame is"):
            image_io.read_ldr(str(path))
        return "listed"
    got = image_io.read_ldr(str(path))
    assert got.shape == ref.shape and np.array_equal(got, ref)
    return "read"


DATA, BOXES = cases(3)


@pytest.mark.parametrize("box", sorted(BOXES))
def test_moov_edits_read_as_pil_reads_them(tmp_path, box):
    seen = set()
    for pos, data in edits(DATA, *BOXES[box]):
        try:
            seen.add(check_edit(tmp_path / "edit.avif", data))
        except AssertionError as e:
            raise AssertionError(f"{box} byte {pos - BOXES[box][0]}: "
                                 f"{e}") from None
    assert seen


def test_the_sweep_covers_every_box_libavif_reads():
    names = {k.rsplit("/", 1)[-1].split("#")[0] for k in BOXES}
    assert {"tkhd", "mdia", "mdhd", "hdlr", "minf", "stbl", "stsd", "av01",
            "av1C", "stts", "stsc", "stsz", "stco", "stss", "edts",
            "elst"} <= names, names
