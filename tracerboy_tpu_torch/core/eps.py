"""EPS as PIL meets it: Pillow 12.1's EpsImagePlugin identifies an
Encapsulated PostScript file by its header comments and renders it only
through Ghostscript, which the JAX read_ldr's PIL may not have (and the
port does not run). So the port identifies the file as _open does, and
refuses it where PIL identifies it:

- accepted: "%!PS", or the DOS EPS binary header 0xC6D3D0C5 (the
  PostScript's offset and length at bytes 4 and 8);
- passed on (UnidentifiedImageError, PIL's SyntaxError and the
  struct.error, KeyError and TypeError ImageFile turns into it): a DOS
  header cut short, a header without "%!PS-Adobe" or "%%BoundingBox" when
  its comments end, a comment line over 255 bytes, an %ImageData mode
  PIL has no mode for, a size that is not positive;
- refused (ValueError): where _open raises OSError (a header line that is
  neither a DSC comment nor a comment, no bounding box PIL can read) or
  ValueError (%ImageData or %%BeginBinary fields that are not numbers, a
  seek before the file's start); and where _open succeeds, since load
  needs Ghostscript ("Unable to locate Ghostscript": OSError).
"""

from __future__ import annotations

import io
import re
import struct

from tracerboy_tpu_torch.core.image_io import check_image_size
from tracerboy_tpu_torch.core.rawformats import unidentified

_SPLIT = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
_FIELD = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")
_MODES = {1: "L", 2: "LAB", 3: "RGB", 4: "CMYK"}
DOS_MAGIC = 0xC6D3D0C5


def is_eps(data: bytes) -> bool:
    """EpsImagePlugin._accept."""
    return data.startswith(b"%!PS") or (
        len(data) >= 4 and struct.unpack_from("<I", data)[0] == DOS_MAGIC)


def eps_size(data: bytes, path: str = "<eps>") -> tuple:
    """EpsImageFile._open on the file's bytes: the size PIL gives the
    image, or the refusal it makes."""
    f = io.BytesIO(data)
    if data.startswith(b"%!PS"):
        pass
    elif len(data) >= 12 and struct.unpack_from("<I", data)[0] == DOS_MAGIC:
        f.seek(struct.unpack_from("<I", data, 4)[0])
    else:
        raise unidentified(path, "not an EPS file")
    info: dict = {}
    bounding_box = imagedata_size = None
    # PIL's 255-byte line buffer: the prefix tests below look at its
    # first bytes whatever the line's length, as PIL's do.
    buf, n = bytearray(255), 0
    header, trailer_comments, trailer = True, False, False

    def check_required() -> None:
        if "PS-Adobe" not in info:
            raise unidentified(path, 'EPS header missing "%!PS-Adobe"')
        if "BoundingBox" not in info:
            raise unidentified(path, 'EPS header missing "%%BoundingBox"')

    def read_comment(s: str) -> bool:
        nonlocal bounding_box, trailer_comments
        m = _SPLIT.match(s)
        if not m:
            return False
        k, v = m.group(1, 2)
        info[k] = v
        if k == "BoundingBox":
            if v == "(atend)":
                trailer_comments = True
            elif not bounding_box or (trailer and trailer_comments):
                try:
                    bounding_box = [int(float(i)) for i in v.split()]
                except Exception:
                    pass
        return True

    while True:
        byte = f.read(1)
        if byte == b"":
            if n == 0:
                if header:
                    check_required()
                break
        elif byte in b"\r\n":
            if n == 0:
                continue
        else:
            if n >= 255:
                if buf[0] == ord("%"):
                    raise unidentified(path, "EPS comment line too long")
                if header:
                    check_required()
                    header = False
                n = 0
            buf[n] = byte[0]
            n += 1
            continue
        if header:
            # The line is kept (PIL does not reset its count here): the
            # next line is read on after it.
            if buf[0] != ord("%") or buf[:13] == b"%%EndComments":
                check_required()
                header = False
                continue
            s = buf[:n].decode("latin-1")
            if not read_comment(s):
                m = _FIELD.match(s)
                if m:
                    k = m.group(1)
                    if k.startswith("PS-Adobe"):
                        info["PS-Adobe"] = k[9:]
                    else:
                        info[k] = ""
                elif s[0] != "%":
                    raise ValueError(f"{path}: bad EPS header")
        elif buf[:11] == b"%ImageData:":
            if not imagedata_size:
                values = bytes(buf[11:n]).split(None, 7)
                if len(values) < 4:
                    raise ValueError(f"{path}: %ImageData of {len(values)} "
                                     "fields")
                columns, rows, bit_depth, mode_id = (int(v)
                                                     for v in values[:4])
                if bit_depth == 8 and mode_id not in _MODES:
                    raise unidentified(path, f"EPS %ImageData mode "
                                       f"{mode_id} (PIL's KeyError)")
                if bit_depth not in (1, 8):
                    break
                imagedata_size = columns, rows
        elif buf[:5] == b"%%EOF":
            break
        elif trailer and trailer_comments:
            read_comment(buf[:n].decode("latin-1"))
        elif buf[:9] == b"%%Trailer":
            trailer = True
        elif buf[:14] == b"%%BeginBinary:":
            to = f.tell() + int(bytes(buf[14:n]))
            if to < 0:                  # a file's seek raises OSError
                raise ValueError(f"{path}: EPS %%BeginBinary seeks before "
                                 "the start of the file")
            f.seek(to)
        n = 0
    if not bounding_box:
        raise ValueError(f"{path}: cannot determine EPS bounding box")
    if imagedata_size:
        size = imagedata_size
    elif len(bounding_box) < 4:
        raise unidentified(path, f"EPS bounding box {bounding_box} (PIL's "
                           "IndexError)")
    else:
        size = (bounding_box[2] - bounding_box[0],
                bounding_box[3] - bounding_box[1])
    check_image_size(*size, path)
    return size


def read_eps(data: bytes, path: str = "<eps>"):
    """Where PIL identifies the file, its load needs Ghostscript: the
    JAX read_ldr raises OSError, the port ValueError."""
    w, h = eps_size(data, path)
    raise ValueError(f"{path}: EPS ({w}x{h}) is rendered only by "
                     "Ghostscript, which PIL's loader needs and the port "
                     "does not run (PIL's OSError)")
