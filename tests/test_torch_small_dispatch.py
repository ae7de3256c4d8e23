"""core/image_io.decode_ldr's order against PIL's Image.open: the port's
reader table (image_io.readers()) names PIL 12.1's formats in the order
Image.open tries them (preinit's plugins, then the rest of Image.ID after
init), each ported format's test is PIL's _accept on the file's first
16 bytes, and files that two plugins accept reach the same reader in both
packages (or the same refusal). Every plugin PIL opens files with has its
reader (FITS, FLI, IPTC and PCD, PIL's small formats part 3, the last);
a file that a stub plugin or EPS (no Ghostscript) identifies is refused
as PIL refuses it, and one that no plugin identifies raises
NotImplementedError, PIL's UnidentifiedImageError.
"""

import glob
import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

from test_torch_small_sgi_pcx import assert_as_jax, jax_read_ldr
from tracerboy_tpu_torch.core import image_io
from tracerboy_tpu_torch.core.stubs import WMF_PLACEABLE

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pil_open_order() -> list:
    """Image.open's order in a fresh interpreter (other tests may have
    imported plugins, which registers them early)."""
    code = ("from PIL import Image; Image.preinit(); a = list(Image.ID); "
            "Image.init(); print(' '.join(a + [x for x in Image.ID "
            "if x not in a]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return out.stdout.split()


def test_reader_table_is_in_image_opens_order():
    assert [name for name, _, _ in image_io.readers()] == pil_open_order()


def _pil_accept(name: str, data: bytes) -> bool | None:
    Image.init()
    accept = Image.OPEN[name][1]
    if accept is None:
        return None
    try:
        return bool(accept(data[:16]))
    except (IndexError, struct.error):
        return False


# The formats whose test is PIL's own _accept.
ACCEPT_ONLY = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP",
               "BUFR", "CUR", "PCX", "DCX", "DDS", "EPS", "FITS", "FLI",
               "FTEX",
               "GBR", "GRIB", "HDF5", "JPEG2000", "ICNS", "ICO", "MCIDAS",
               "MPEG", "TIFF", "MSP", "PIXAR", "PSD", "QOI", "SGI", "SUN",
               "WEBP", "WMF", "XBM", "XPM", "XVTHUMB")


def _probes():
    files = sorted(glob.glob(os.path.join(DATA, "*", "*.*")))
    files = [f for f in files if not f.endswith(".json")][::7]
    rng = np.random.default_rng(1)
    extra = [bytes(rng.integers(0, 256, 20, dtype=np.uint8))
             for _ in range(40)]
    extra += [b"", b"\n", b"\x0a\x05", b"\0\0\2\0", b"\x28\0\0\0" + bytes(12),
              b"BLP2", b"FTEX", b"icns", b"\x01\xda", b"SIMPLE",
              b"\x89HDF\r\n\x1a\n", b"  #define x", b"P7 332",
              b"\xd7\xcd\xc6\x9a\0\0", b"\x01\0\0\0"]
    return [open(f, "rb").read(64) for f in files] + extra


def test_ported_formats_accept_as_pil_accepts():
    table = {name: accepts for name, accepts, _ in image_io.readers()}
    for data in _probes():
        for name in ACCEPT_ONLY:
            assert table[name](data) == _pil_accept(name, data), (name,
                                                                  data[:16])


def _tga(id_len=0, cmap_type=0, image_type=2, cmap=(0, 0, 0), origin=(0, 0),
         w=4, h=3, depth=24, flags=0):
    head = struct.pack("<BBBHHBHHHHBB", id_len, cmap_type, image_type, *cmap,
                       *origin, w, h, depth, flags)
    rng = np.random.default_rng(id_len + w)
    pal = bytes(cmap[1] * 3) if cmap_type else b""
    px = rng.integers(0, 256, w * h * (depth // 8), dtype=np.uint8)
    return head + bytes(id_len) + pal + px.tobytes()


def _collisions():
    rng = np.random.default_rng(3)
    iptc = bytes((0x1C, 1, 2, 0, 4)) + bytes(4)
    return {
        # PCX takes a TGA whose ID is 10 bytes long: its header cut short
        # passes it on, a whole one is an unknown PCX mode.
        "tga_pcx_id_10_small": _tga(id_len=10),
        "tga_pcx_id_10": _tga(id_len=10, w=8, h=4),
        # CUR takes an uncompressed TGA's 00 00 02 00; no cursors: on.
        "tga_cur_no_entries": _tga(),
        # ... with a colour-map length, 256 entries past the end: on.
        "tga_cur_entries": _tga(cmap=(0, 1, 0)),
        # ... one entry, whose bitmap offset (the TGA's bytes 18-21)
        # points at a header size CUR cannot read: PIL fails on the TGA.
        "tga_cur_one_entry": (lambda d: d[:18] + struct.pack("<I", 24)
                              + d[22:24] + b"\x99" * 4 + d[28:])(
            _tga(cmap=(256, 0, 0), w=8, h=4)),
        # IPTC takes a TGA whose ID is 0x1C long and has a colour map;
        # its next field is no IPTC field: on to TGA.
        "tga_iptc": _tga(id_len=0x1C, cmap_type=1, image_type=1,
                         cmap=(0, 8, 24), depth=8),
        # GBR takes x origin 256 as its version; the depth is no brush's.
        "tga_gbr": _tga(origin=(256, 0)),
        # DIB takes a header size of 40 and fails on the rest.
        "dib_garbage": b"\x28\0\0\0" + bytes(rng.integers(0, 256, 60,
                                                          dtype=np.uint8)),
        # IPTC's empty first field, then nothing PIL reads.
        "zeros": bytes(32),
        # BLP, FTEX, ICNS and SGI cut in their headers: passed on.
        "blp_cut": b"BLP2\1\0\0\0\2",
        "ftex_cut": b"FTEX\1\0\0\0",
        "icns_cut": b"icns\0\0\0\x20ic11",
        "sgi_cut": b"\x01\xda\0\1\0\2",
        "dcx_cut": struct.pack("<II", 0x3ADE68B1, 40),
        "iptc_no_mode": iptc,
    }


@pytest.mark.parametrize("case", sorted(_collisions()))
def test_files_two_plugins_accept_reach_the_same_reader(tmp_path, case):
    assert_as_jax(tmp_path / f"{case}.bin", _collisions()[case])


def _pil_saved(fmt, mode, **kw):
    img = Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (6, 8, 3), dtype=np.uint8)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _fli(w=6, h=4):
    """An FLI of one frame: a COLOR_64 chunk of 256 entries and a COPY
    chunk of w x h indices."""
    rng = np.random.default_rng(5)
    colour = struct.pack("<H", 1) + bytes(2) + rng.integers(
        0, 64, 768).astype(np.uint8).tobytes()
    px = rng.integers(0, 256, w * h).astype(np.uint8).tobytes()
    chunks = (struct.pack("<IH", 6 + len(colour), 11) + colour
              + struct.pack("<IH", 6 + len(px), 16) + px)
    frame = struct.pack("<IHH8x", 16 + len(chunks), 0xF1FA, 2) + chunks
    return struct.pack("<IHHHHHHI", 128 + len(frame), 0xAF11, 1, w, h, 8,
                       3, 5).ljust(128, b"\0") + frame


def _iptc(w=5, h=3):
    """IPTC records of an L image (layers 1), raw, its pixels in one
    (8, 10) record."""
    def rec(r, t, data):
        return bytes((0x1C, r, t)) + struct.pack(">H", len(data)) + data

    px = np.random.default_rng(6).integers(0, 256, w * h).astype(np.uint8)
    return (rec(3, 60, b"\x01\x00") + rec(3, 20, bytes((w,)))
            + rec(3, 30, bytes((h,))) + rec(3, 120, b"\x01")
            + rec(8, 10, px.tobytes()))


def _pcd():
    """A PCD: "PCD_" at 2048, the base image's planes at sector 96."""
    data = bytearray(96 * 2048 + 768 * 512 * 3 // 2)
    data[2048:2052] = b"PCD_"
    data[96 * 2048:] = np.random.default_rng(7).integers(
        0, 256, len(data) - 96 * 2048).astype(np.uint8).tobytes()
    return bytes(data)


def _part3():
    cards = [b"SIMPLE  = T", b"BITPIX  = 8", b"NAXIS   = 2",
             b"NAXIS1  = 2", b"NAXIS2  = 1", b"END"]
    fits = b"".join(c.replace(b"= ", b"=" + b" " * 20).ljust(80)
                    for c in cards).ljust(2880) + bytes(2880)
    return {"FITS": fits, "FLI": _fli(), "IPTC": _iptc(), "PCD": _pcd()}


def _ported_now():
    """Files of the formats PIL's small formats parts 2 and 3 ported, as
    the item-22b test wrote them before."""
    sun = struct.pack(">8I", 0x59A66A95, 4, 2, 8, 8, 1, 0, 0) + bytes(8)
    xpm = (b'/* XPM */\nstatic char *x[] = {\n"2 1 1 1",\n"a c #ff0000",\n'
           b'"aa"\n};\n')
    return {
        "IM": _pil_saved("IM", "RGB"),
        "MSP": _pil_saved("MSP", "1"),
        "XBM": _pil_saved("XBM", "1"),
        "SPIDER": _pil_saved("SPIDER", "F"),
        "SUN": sun,
        "XPM": xpm,
        **_part3(),
    }


@pytest.mark.parametrize("fmt", sorted(_ported_now()))
def test_formats_ported_from_item_22b_read_as_jax(tmp_path, fmt):
    """PIL identifies the file as `fmt`; the port, which now reads it,
    gives the JAX read_ldr's pixels."""
    path = tmp_path / f"x.{fmt.lower()}"
    path.write_bytes(_ported_now()[fmt])
    with Image.open(path) as im:
        assert im.format == fmt
    assert assert_as_jax(path) is not None


def _wmf(kind=WMF_PLACEABLE, inch=1440, box=(0, 0, 200, 100), std=True):
    head = kind + struct.pack("<4hH", *box, inch) + bytes(6)
    return head + (b"\x01\x00\t\x00" if std else bytes(4)) + bytes(40)


def _emf(box=(0, 0, 10, 8), frame=(0, 0, 2540, 2032)):
    return b"\x01\0\0\0" + bytes(4) + struct.pack("<8i", *box, *frame) \
        + b" EMF" + bytes(40)


EPS_OK = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 10 20\n"
          b"%%EndComments\nshowpage\n%%EOF\n")


def _eps_dos(ps: bytes) -> bytes:
    """A DOS EPS binary header (magic, PostScript offset and length)
    before `ps`."""
    return struct.pack("<III", 0xC6D3D0C5, 30, len(ps)) + bytes(18) + ps


# PIL's stub plugins and EPS: (identified as, file); None where PIL passes
# it on.
STUBS = {
    "bufr": ("BUFR", b"BUFR" + bytes(60)),
    "bufr_zczc": ("BUFR", b"ZCZC" + bytes(60)),
    "grib": ("GRIB", b"GRIB\0\0\0\1" + bytes(60)),
    "hdf5": ("HDF5", b"\x89HDF\r\n\x1a\n" + bytes(60)),
    "mpeg": ("MPEG", b"\0\0\1\xb3\x01\x00\x10" + bytes(60)),
    "mpeg_cut": (None, b"\0\0\1\xb3\x01\x00"),
    "mpeg_no_width": (None, b"\0\0\1\xb3\x00\x00\x10" + bytes(60)),
    "wmf": ("WMF", _wmf()),
    "wmf_72dpi_rounds_down": ("WMF", _wmf(inch=1000, box=(-7, 3, 20, 40))),
    "wmf_inch_0": ("WMF", _wmf(inch=0)),
    "wmf_not_standard": (None, _wmf(std=False)),
    "wmf_empty_box": (None, _wmf(box=(5, 0, 5, 100))),
    "wmf_cut": (None, WMF_PLACEABLE + bytes(8)),
    "emf": ("WMF", _emf()),
    "emf_empty_frame": ("WMF", _emf(frame=(0, 0, 0, 2032))),
    "emf_negative_box": (None, _emf(box=(10, 0, 0, 8))),
    "emf_no_signature": (None, b"\x01\0\0\0" + bytes(60)),
    # EPS: PIL identifies these and cannot load them without Ghostscript.
    "eps": ("EPS", EPS_OK),
    "eps_dos": ("EPS", _eps_dos(EPS_OK)),
    "eps_imagedata": ("EPS", EPS_OK.replace(b"%%EndComments\n", b"")
                      + b"%ImageData: 7 3 8 3 0 1 1 \"x\"\n"),
    # PIL keeps the line that ends the header and reads the next one on
    # after it: an empty line clears it, so %%Trailer is seen.
    "eps_atend": ("EPS", b"%!PS-Adobe-3.0\n%%BoundingBox: (atend)\n"
                  b"%%EndComments\n\n%%Trailer\n%%BoundingBox: 1 2 30 "
                  b"40\n"),
    # ... and refuses these with OSError in _open (no bounding box; here
    # %%Trailer is read as "%%EndComments%%Trailer").
    "eps_atend_trailer_unseen": ("EPS", b"%!PS-Adobe-3.0\n%%BoundingBox: "
                                 b"(atend)\n%%EndComments\n%%Trailer\n"
                                 b"%%BoundingBox: 1 2 30 40\n"),
    "eps_no_box_value": ("EPS", b"%!PS-Adobe-3.0\n%%BoundingBox: x\n"),
    "eps_dos_no_box_value": ("EPS", _eps_dos(
        b"%!PS-Adobe-3.0\n%%BoundingBox: x\n")),
    # ... and a %%BeginBinary seek before the file's start (OSError).
    "eps_binary_seek_back": ("EPS", b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 1 "
                             b"1\n%%EndComments\n\n%%BeginBinary: -500\n"),
    # _open's SyntaxError (and the IndexError ImageFile turns into one):
    # passed on.
    "eps_no_adobe": (None, b"%!PS\n%%BoundingBox: 0 0 10 20\n"),
    "eps_no_box": (None, b"%!PS-Adobe-3.0\n%%Creator: x\n\nfoo\n"),
    "eps_long_comment": (None, b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 1 1\n%"
                         + b"a" * 300 + b"\n"),
    "eps_short_box": (None, b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 10\n"),
    "eps_empty_box": (None, b"%!PS-Adobe-3.0\n%%BoundingBox: 5 5 5 20\n"),
    "eps_dos_cut": (None, struct.pack("<II", 0xC6D3D0C5, 30)),
    "eps_dos_no_adobe": (None, _eps_dos(b"%!PS\n%%BoundingBox: 0 0 1 1\n")),
}


@pytest.mark.parametrize("case", sorted(STUBS))
def test_stub_formats_refuse_as_pil_refuses(tmp_path, case):
    """A stub plugin's file: PIL identifies it and the JAX read_ldr
    raises (OSError: no loader), and the port raises ValueError; or PIL's
    _open rejects the header and both pass it on (here to no reader)."""
    fmt, data = STUBS[case]
    path = tmp_path / f"{case}.bin"
    path.write_bytes(data)
    if fmt is None:
        with pytest.raises(UnidentifiedImageError):
            Image.open(path)
    elif case not in ("wmf_inch_0", "emf_empty_frame", "eps_no_box_value",
                      "eps_dos_no_box_value", "eps_binary_seek_back",
                      "eps_atend_trailer_unseen"):  # _open raises
        with Image.open(path) as im:
            assert im.format == fmt
    assert assert_as_jax(path) is None


def test_unidentified_names_what_is_left(tmp_path):
    """A file no plugin takes raises NotImplementedError that says only
    that, as PIL's UnidentifiedImageError does: no format is left to
    name (the JAX read_ldr raises UnidentifiedImageError on it)."""
    path = tmp_path / "junk.bin"
    path.write_bytes(b"\x7f" * 40)
    with pytest.raises(UnidentifiedImageError):
        jax_read_ldr(path)
    with pytest.raises(NotImplementedError, match="cannot identify") as e:
        image_io.decode_ldr(str(path))
    assert "item" not in str(e.value)
    for done in ("SGI", "PCX", "DCX", "CUR", "ICNS", "BLP", "FTEX", "IM",
                 "MSP", "SUN", "XBM", "XPM", "EPS", "GBR", "IMT", "MCIDAS",
                 "PIXAR", "SPIDER", "XVTHUMB", "FITS", "FLI", "IPTC",
                 "PCD"):
        assert done not in str(e.value)
