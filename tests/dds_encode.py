"""A small numpy DDS writer for the tests of the port's DDS reader.

Writes the 124-byte header, legacy (FourCC or bit masks) or with the DX10
extension, around any payload, so the tests can build the formats PIL
will not write: BC1 under DX10, BC4, BC6H and BC7. Random blocks are
valid input for every BCn format once the mode prefix is fixed (the 1-8
leading bits of BC7, the 2- or 5-bit mode code of BC6H, the reserved ones
included), so random_blocks covers every mode, partition, rotation and
index selection without an encoder. Two plain encoders make the
textures of the DDS scene: encode_bc7_mode6 (one subset, 7-bit endpoints
and a p-bit, 4-bit indices) and encode_bc1_cutout (BC1 with the 3-colour
mode's transparent black wherever alpha < 128).
"""

from __future__ import annotations

import struct

import numpy as np

DDPF_ALPHAPIXELS = 0x1
DDPF_FOURCC = 0x4
DDPF_PALETTEINDEXED8 = 0x20
DDPF_RGB = 0x40
DDPF_LUMINANCE = 0x20000
# DDSD_CAPS | HEIGHT | WIDTH | PIXELFORMAT, and LINEARSIZE or PITCH.
DDSD_TEXTURE = 0x1 | 0x2 | 0x4 | 0x1000
DDSD_LINEARSIZE = 0x80000
DDSD_PITCH = 0x8
DDSCAPS_TEXTURE = 0x1000

# Block formats: name -> (FourCC, DXGI format, bytes a block). A FourCC
# of None is written only under DX10.
BCN = {
    "DXT1": (b"DXT1", 71, 8), "BC1": (None, 71, 8),
    "DXT3": (b"DXT3", 74, 16), "BC2": (None, 74, 16),
    "DXT5": (b"DXT5", 77, 16), "BC3": (None, 77, 16),
    "BC4U": (b"BC4U", 80, 8), "ATI1": (b"ATI1", 80, 8), "BC4": (None, 80, 8),
    "BC5U": (b"BC5U", 83, 16), "ATI2": (b"ATI2", 83, 16),
    "BC5S": (b"BC5S", 84, 16), "BC5": (None, 83, 16),
    "BC5_SNORM": (None, 84, 16),
    "BC6H": (None, 95, 16), "BC6HS": (None, 96, 16),
    "BC7": (None, 98, 16), "BC7_SRGB": (None, 99, 16),
    "BC7_TYPELESS": (None, 97, 16),
}
# The BC6H mode codes (low 2 or 5 bits of the block); the last four are
# reserved and decode to black.
BC6H_CODES = (0b00, 0b01, 0b00010, 0b00110, 0b01010, 0b01110, 0b10010,
              0b10110, 0b11010, 0b11110, 0b00011, 0b00111, 0b01011,
              0b01111, 0b10011, 0b10111, 0b11011, 0b11111)


def dds_header(width: int, height: int, *, pfflags: int,
               fourcc: bytes = b"\0\0\0\0", bitcount: int = 0,
               masks=(0, 0, 0, 0), dxgi: int | None = None,
               header_size: int = 124, pitch: int = 0) -> bytes:
    """The magic, the DDS_HEADER and, with dxgi, the DX10 header (a 2D
    texture, one array slice)."""
    if dxgi is not None:
        fourcc, pfflags = b"DX10", pfflags | DDPF_FOURCC
    flags = DDSD_TEXTURE | (DDSD_LINEARSIZE if pfflags & DDPF_FOURCC
                            else DDSD_PITCH)
    head = (b"DDS " + struct.pack("<7I", header_size, flags, height, width,
                                  pitch, 0, 0)
            + struct.pack("<11I", *(0,) * 11)
            + struct.pack("<2I4sI", 32, pfflags, fourcc, bitcount)
            + struct.pack("<4I", *masks)
            + struct.pack("<5I", DDSCAPS_TEXTURE, 0, 0, 0, 0))
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head


def bcn_file(fmt: str, width: int, height: int, blocks: bytes) -> bytes:
    """A DDS file of BCn blocks in format `fmt` (a key of BCN): legacy
    FourCC where the format has one, else DX10."""
    fourcc, dxgi, _ = BCN[fmt]
    if fourcc is not None:
        head = dds_header(width, height, pfflags=DDPF_FOURCC, fourcc=fourcc,
                          pitch=len(blocks))
    else:
        head = dds_header(width, height, pfflags=0, dxgi=dxgi,
                          pitch=len(blocks))
    return head + blocks


def n_blocks(width: int, height: int) -> int:
    return ((width + 3) // 4) * ((height + 3) // 4)


def random_blocks(rng: np.random.Generator, fmt: str, count: int,
                  mode: int | None = None) -> bytes:
    """`count` random blocks of `fmt`. mode fixes the BC7 mode (0-7, or 8
    for a first byte of 0) or the BC6H mode code (an index into
    BC6H_CODES); None leaves the bits random."""
    size = BCN[fmt][2]
    b = rng.integers(0, 256, (count, size), dtype=np.uint8)
    if mode is not None and fmt.startswith("BC7"):
        if mode == 8:
            b[:, 0] = 0
        else:
            b[:, 0] = (b[:, 0] & ((0xFF << (mode + 1)) & 0xFF)) | (1 << mode)
    elif mode is not None and fmt.startswith("BC6H"):
        code = BC6H_CODES[mode]
        nbits = 2 if code < 2 else 5
        b[:, 0] = (b[:, 0] & ((0xFF << nbits) & 0xFF)) | code
    return b.tobytes()


def _pack_fields(fields) -> bytes:
    """(value, bits) fields, least significant bit first, into 16 bytes."""
    v, pos = 0, 0
    for value, n in fields:
        v |= (int(value) & ((1 << n) - 1)) << pos
        pos += n
    return v.to_bytes(16, "little")


def _tiles(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H/4 * W/4, 16, C) 4x4 tiles, edge-padded to a
    multiple of 4."""
    h, w, c = img.shape
    ph, pw = -h % 4, -w % 4
    img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    H, W = img.shape[:2]
    return img.reshape(H // 4, 4, W // 4, 4, c).transpose(
        0, 2, 1, 3, 4).reshape(-1, 16, c)


def encode_bc7_mode6(img: np.ndarray) -> bytes:
    """RGBA uint8 (H, W, 4) -> BC7 mode-6 blocks: each block's per-channel
    min and max as 7-bit endpoints with a p-bit (8-bit values), 4-bit
    indices from the projection onto the endpoint line (pixel 0's index
    swapped into the 3-bit anchor range)."""
    out = []
    for t in _tiles(img).astype(np.int64):
        e0, e1 = t.min(0), t.max(0)
        q = [e0 >> 1, e1 >> 1]
        p = [e0 & 1, e1 & 1]
        lo = (q[0] << 1) | p[0]
        hi = (q[1] << 1) | p[1]
        span = hi - lo
        den = max(int((span * span).sum()), 1)
        idx = np.clip(np.rint(((t - lo) * span).sum(1) * 15.0 / den), 0,
                      15).astype(np.int64)
        if idx[0] > 7:
            q, p = q[::-1], p[::-1]
            idx = 15 - idx
        fields = [(1 << 6, 7)]
        for c in range(4):
            fields += [(q[0][c], 7), (q[1][c], 7)]
        fields += [(p[0][0], 1), (p[1][0], 1), (idx[0], 3)]
        fields += [(i, 4) for i in idx[1:]]
        out.append(_pack_fields(fields))
    return b"".join(out)


def _to565(rgb) -> int:
    r, g, b = (int(x) for x in rgb)
    return ((r * 31 + 127) // 255 << 11) | ((g * 63 + 127) // 255 << 5) | (
        (b * 31 + 127) // 255)


def _from565(c: int) -> np.ndarray:
    """A 5:6:5 word as the decoders expand it to 8 bits a channel."""
    r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
    return np.array([r << 3 | r >> 2, g << 2 | g >> 4, b << 3 | b >> 2])


def encode_bc1_cutout(img: np.ndarray) -> bytes:
    """RGBA uint8 (H, W, 4) -> BC1 blocks between each block's darkest and
    brightest opaque texel. A block with a texel of alpha < 128 (or equal
    endpoints) uses the 3-colour mode (c0 <= c1) and gives its cut texels
    index 3, transparent black; the others take the nearest colour of the
    block's palette."""
    out = []
    for t in _tiles(img).astype(np.int64):
        cut = t[:, 3] < 128
        opaque = t[~cut, :3] if (~cut).any() else t[:, :3]
        lum = opaque.sum(1)
        lo, hi = _to565(opaque[lum.argmin()]), _to565(opaque[lum.argmax()])
        if cut.any() or lo == hi:
            c0, c1 = min(lo, hi), max(lo, hi)
        else:
            c0, c1 = max(lo, hi), min(lo, hi)
        e0, e1 = _from565(c0), _from565(c1)
        if c0 <= c1:
            pal = np.stack([e0, e1, (e0 + e1) // 2])
        else:
            pal = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3])
        idx = ((t[:, None, :3] - pal[None]) ** 2).sum(-1).argmin(1)
        idx[cut] = 3
        lut = sum(int(i) << (2 * n) for n, i in enumerate(idx))
        out.append(struct.pack("<HHI", c0, c1, lut))
    return b"".join(out)
