"""The port's DDS reader: the pixels PIL returns for a DDS file (Pillow
12.1's DdsImagePlugin and its "bcn" and "dds_rgb" decoders), bit for bit,
without an imaging library.

DDS is the container TracerBoy loads its textures from (through
DirectXTex). The 124-byte header and the DX10 extension are parsed here;
the 4x4 blocks of the compressed formats are decoded by
csrc/dds_decode.cpp (g++ at first use, ctypes), whose header lists where
PIL departs from the D3D specification.

Read, as PIL reads them (only the first surface and mip level):
- DDPF_RGB: uncompressed pixels by their bit masks, RGB, or RGBA with
  DDPF_ALPHAPIXELS; each channel scaled to 8 bits as
  int(v / max * 255) of the mask's own range;
- DDPF_LUMINANCE: 8-bit L, 16-bit L with alpha (LA);
- DDPF_PALETTEINDEXED8: 8-bit indices into the 1024-byte RGBA palette;
- FourCC DXT1, DXT3, DXT5 (BC1-BC3), BC4U/ATI1 (BC4), BC5U/ATI2 and
  BC5S (BC5), and DX10: BC1-BC5 (BC5 SNORM too), BC6H UF16 and SF16,
  BC7 (UNORM, sRGB, typeless) and R8G8B8A8 (UNORM, sRGB, typeless).
  The sRGB formats decode as the UNORM ones (PIL only notes a gamma).
Anything else raises PIL's error: ValueError where PIL raises OSError
(a header size other than 124, a short header, unsupported luminance
bits, truncated pixel data), NotImplementedError for an unknown FourCC,
DXGI format or pixel-format flag set.
"""

from __future__ import annotations

import struct

import numpy as np

DDS_MAGIC = b"DDS "
# DDS_PIXELFORMAT flags.
DDPF_ALPHAPIXELS = 0x1
DDPF_FOURCC = 0x4
DDPF_PALETTEINDEXED8 = 0x20
DDPF_RGB = 0x40
DDPF_LUMINANCE = 0x20000
HEADER_END = 128              # magic + the 124-byte header
DX10_END = HEADER_END + 20    # + the DX10 extension header

# FourCC -> (block decoder n, signed, PIL mode); see csrc/dds_decode.cpp.
FOURCC_FORMATS = {
    b"DXT1": (1, 0, "RGBA"), b"DXT3": (2, 0, "RGBA"),
    b"DXT5": (3, 0, "RGBA"), b"BC4U": (4, 0, "L"), b"ATI1": (4, 0, "L"),
    b"BC5S": (5, 1, "RGB"), b"BC5U": (5, 0, "RGB"), b"ATI2": (5, 0, "RGB"),
}
# DXGI_FORMAT -> (block decoder n, signed, PIL mode); n 0: raw RGBA bytes.
DXGI_FORMATS = {
    70: (1, 0, "RGBA"), 71: (1, 0, "RGBA"),          # BC1 typeless, unorm
    73: (2, 0, "RGBA"), 74: (2, 0, "RGBA"),          # BC2
    76: (3, 0, "RGBA"), 77: (3, 0, "RGBA"),          # BC3
    79: (4, 0, "L"), 80: (4, 0, "L"),                # BC4
    82: (5, 0, "RGB"), 83: (5, 0, "RGB"),            # BC5
    84: (5, 1, "RGB"),                               # BC5 snorm
    95: (6, 0, "RGB"), 96: (6, 1, "RGB"),            # BC6H uf16, sf16
    97: (7, 0, "RGBA"), 98: (7, 0, "RGBA"), 99: (7, 0, "RGBA"),   # BC7
    27: (0, 0, "RGBA"), 28: (0, 0, "RGBA"), 29: (0, 0, "RGBA"),   # R8G8B8A8
}
MODE_CHANNELS = {"L": 1, "LA": 2, "P": 1, "RGB": 3, "RGBA": 4}

_lib = None


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from tracerboy_tpu_torch.utils.build import (
            REPO_ROOT,
            build_shared_library,
        )

        lib = ctypes.CDLL(str(build_shared_library(
            "tbdds", [REPO_ROOT / "tracerboy_tpu_torch" / "csrc"
                      / "dds_decode.cpp"],
            ["g++", "-O2", "-shared", "-fPIC"])))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.tb_dds_decode_bcn.restype = i64
        lib.tb_dds_decode_bcn.argtypes = [p, p, i64, i64, i64, i64]
        _lib = lib
    return _lib


def decode_bcn(blocks: bytes, width: int, height: int, n: int,
               sign: int = 0, path: str = "<dds>") -> np.ndarray:
    """ceil(w/4) * ceil(h/4) BCn blocks (n: 1-7 for BC1-BC7) as PIL's
    "bcn" decoder gives them: (height, width, 4) uint8 RGBA for BC1-BC3
    and BC7, (.., 1) for BC4, (.., 3) for BC5 and BC6H."""
    block_bytes = 8 if n in (1, 4) else 16
    need = ((width + 3) // 4) * ((height + 3) // 4) * block_bytes
    if len(blocks) < need:
        raise ValueError(f"{path}: image file is truncated ({len(blocks)} "
                         f"of {need} bytes of BC{n} blocks)")
    src = np.frombuffer(blocks, np.uint8, need)
    channels = 1 if n == 4 else 3 if n in (5, 6) else 4
    out = np.empty((height, width, channels), np.uint8)
    if _library().tb_dds_decode_bcn(src.ctypes.data, out.ctypes.data, width,
                                    height, n, sign):
        raise ValueError(f"unknown BCn format {n}")
    return out


def decode_rgb_masks(data: bytes, width: int, height: int, bitcount: int,
                     masks) -> np.ndarray:
    """PIL's "dds_rgb" decoder: little-endian pixels of bitcount // 8
    bytes (zero past the end of the data), each mask's field scaled to 8
    bits as int(field / (mask >> shift) * 255); a zero mask gives 0."""
    n = width * height
    nb = bitcount // 8
    raw = np.frombuffer(data[:n * nb].ljust(n * nb, b"\0"), np.uint8)
    value = np.zeros(n, np.uint64)
    for k in range(nb):
        value |= raw[k::nb].astype(np.uint64) << np.uint64(8 * k)
    out = np.zeros((n, len(masks)), np.uint8)
    for c, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        field = (value & np.uint64(mask)) >> np.uint64(shift)
        out[:, c] = (field.astype(np.float64) / (mask >> shift)
                     * 255.0).astype(np.uint8)
    return out.reshape(height, width, len(masks))


def decode_dds(data: bytes, path: str = "<dds>"):
    """A DDS file's pixels as PIL decodes them: ((H, W, C) uint8, mode,
    palette), mode one of L, LA, P, RGB, RGBA; palette the (256, 4) RGBA
    table of a P image, else None."""
    if not data.startswith(DDS_MAGIC):
        raise ValueError(f"{path}: not a DDS file")
    if len(data) < 8:
        raise ValueError(f"{path}: truncated DDS header")
    (header_size,) = struct.unpack_from("<I", data, 4)
    if header_size != 124:
        raise ValueError(f"{path}: Unsupported header size {header_size!r}")
    header = data[8:HEADER_END]
    if len(header) != 120:
        raise ValueError(f"{path}: Incomplete header: {len(header)} bytes")
    _, height, width = struct.unpack_from("<3I", header, 0)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", header, 72)
    pixels = data[HEADER_END:]
    if pfflags & DDPF_RGB:
        mode = "RGBA" if pfflags & DDPF_ALPHAPIXELS else "RGB"
        masks = struct.unpack_from(f"<{len(mode)}I", header, 84)
        return (decode_rgb_masks(pixels, width, height, bitcount, masks),
                mode, None)
    palette = None
    if pfflags & DDPF_LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & DDPF_ALPHAPIXELS:
            mode = "LA"
        else:
            raise ValueError(f"{path}: Unsupported bitcount {bitcount} for "
                             f"{pfflags}")
    elif pfflags & DDPF_PALETTEINDEXED8:
        mode = "P"
        entries = np.frombuffer(pixels, np.uint8,
                                min(len(pixels), 1024) // 4 * 4)
        palette = np.zeros((256, 4), np.uint8)
        palette.reshape(-1)[:entries.size] = entries
        pixels = pixels[1024:]
    elif pfflags & DDPF_FOURCC:
        if fourcc == b"DX10":
            if len(data) < DX10_END:
                raise ValueError(f"{path}: truncated DX10 header")
            (dxgi,) = struct.unpack_from("<I", data, HEADER_END)
            fmt = DXGI_FORMATS.get(dxgi)
            if fmt is None:
                raise NotImplementedError(
                    f"{path}: Unimplemented DXGI format {dxgi}")
            pixels = data[DX10_END:]
        else:
            fmt = FOURCC_FORMATS.get(fourcc)
            if fmt is None:
                raise NotImplementedError(
                    f"{path}: Unimplemented pixel format "
                    f"{struct.unpack('<I', fourcc)[0]!r}")
        n, sign, mode = fmt
        if n:
            return decode_bcn(pixels, width, height, n, sign, path), mode, None
    else:
        raise NotImplementedError(
            f"{path}: Unknown pixel format flags {pfflags}")
    # Raw rows of the mode's bytes, top-down, unpadded.
    c = MODE_CHANNELS[mode]
    need = width * height * c
    if len(pixels) < need:
        raise ValueError(f"{path}: image file is truncated ({len(pixels)} "
                         f"of {need} bytes)")
    arr = np.frombuffer(pixels, np.uint8, need).reshape(height, width, c)
    return arr, mode, palette


def read_dds(data: bytes, path: str = "<dds>") -> np.ndarray:
    """A DDS file's pixels as the JAX read_ldr gets them through PIL:
    Image.open(path) converted to RGB (L, P) or RGBA (LA); (H, W, 3|4)
    uint8."""
    from tracerboy_tpu_torch.core.image_io import as_read_ldr

    return as_read_ldr(*decode_dds(data, path))
