"""The port's PhotoCD reader and writer: the pixels PIL returns for a
Kodak PhotoCD (PCD) file (Pillow 12.1's PcdImagePlugin, libImaging's
PcdDecode.c and UnpackYCC.c), bit for bit, without an imaging library.

Read as PIL reads it: "PCD_" at byte 2048 and 1539 bytes of that block
(no other check: PIL's plugin has no _accept); the orientation byte 1538
of it, & 3, rotates the image by 90 (1) or 270 (3) degrees
counterclockwise, which makes it 512x768. Only the 768x512 base image
is read, at sector 96 (byte 196,608): chunks of 3 x 768 bytes, each two
luma rows, then 384 bytes of one chroma and 384 of the other, both rows
taking the chroma at x // 2; the PhotoYCC values go through the YCC;P
unpacker's tables to RGB, clamped to 0-255.

Refused as PIL refuses: UnidentifiedImageError where "PCD_" is not at
2048 or the block is cut short, passing the file on; ValueError where
the base image is cut short ("image file is truncated").

write_pcd writes an RGB image of 768x512 (or 512x768, rotated) through
an approximate inverse of those tables, for the demo scenes' textures.
"""

from __future__ import annotations

import numpy as np

from tracerboy_tpu_torch.core.rawformats import unidentified

BASE = 96 * 2048                 # the 768x512 image's sector
WIDTH, HEIGHT = 768, 512
CHUNK = 3 * WIDTH                # two luma rows and their chroma

# UnpackYCC.c's PhotoYCC tables: each entry c * (v - offset) for v in
# 0..255, converted to int as C converts (int)(x + 0.5), i.e. truncated
# towards zero. R = L[y] + CR[cr], G = L[y] + GR[cr] + GB[cb],
# B = L[y] + CB[cb].
_YCC = {name: np.trunc(c * (np.arange(256) - off) + 0.5).astype(np.int32)
        for name, c, off in (("L", 1.3584, 0), ("CR", 1.8215, 137),
                             ("GR", -0.9271, 137), ("GB", -0.4303, 156),
                             ("CB", 2.2179, 156))}


def is_pcd(data: bytes) -> bool:
    """PcdImageFile._open's check: "PCD_" at 2048, and byte 1538 of that
    block (its orientation) there."""
    return data[2048:2052] == b"PCD_" and len(data) >= 2048 + 1539


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """The YCC;P unpacker: uint8 PhotoYCC samples to (..., 3) uint8 RGB."""
    lum = _YCC["L"][y]
    rgb = np.stack([lum + _YCC["CR"][cr], lum + _YCC["GR"][cr]
                    + _YCC["GB"][cb], lum + _YCC["CB"][cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def read_pcd(data: bytes, path: str = "<pcd>") -> np.ndarray:
    """A PCD file's base image as the JAX read_ldr gets it through PIL:
    (512, 768, 3) uint8, or (768, 512, 3) rotated."""
    if not is_pcd(data):
        raise unidentified(path, "not a PCD file")
    orientation = data[2048 + 1538] & 3
    need = HEIGHT // 2 * CHUNK
    if len(data) < BASE + need:
        raise ValueError(f"{path}: image file is truncated (PCD)")
    chunks = np.frombuffer(data, np.uint8, need, BASE).reshape(
        HEIGHT // 2, CHUNK)
    y = chunks[:, :2 * WIDTH].reshape(HEIGHT, WIDTH)
    half = np.arange(WIDTH) // 2
    cb = np.repeat(chunks[:, 2 * WIDTH + half], 2, axis=0)
    cr = np.repeat(chunks[:, 2 * WIDTH + WIDTH // 2 + half], 2, axis=0)
    rgb = ycc_to_rgb(y, cb, cr)
    if orientation == 1:
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, 3)
    return np.ascontiguousarray(rgb)


def pcd_bytes(img: np.ndarray) -> bytes:
    """A PCD of an (512, 768, 3) uint8 RGB image (orientation 0), or of a
    (768, 512, 3) one (orientation 1, stored rotated back): PhotoYCC
    solved in floats from the tables' coefficients, each 2x2 block's
    chroma averaged, rounded and clipped."""
    img = np.asarray(img, np.uint8)
    orientation = 0
    if img.shape[:2] == (WIDTH, HEIGHT):
        img, orientation = np.rot90(img, -1), 1
    if img.shape != (HEIGHT, WIDTH, 3):
        raise ValueError(f"a PCD holds 768x512 RGB, not {img.shape}")
    m = np.array([[1.3584, 0.0, 1.8215], [1.3584, -0.4303, -0.9271],
                  [1.3584, 2.2179, 0.0]])
    ycc = img.astype(np.float64) @ np.linalg.inv(m).T
    y = np.clip(np.round(ycc[..., 0]), 0, 255).astype(np.uint8)
    c = ycc[..., 1:].reshape(HEIGHT // 2, 2, WIDTH // 2, 2, 2).mean((1, 3))
    c = np.clip(np.round(c + np.array([156, 137])), 0, 255).astype(np.uint8)
    chunks = np.concatenate([y.reshape(HEIGHT // 2, 2 * WIDTH), c[..., 0],
                             c[..., 1]], 1)
    head = bytearray(BASE)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + chunks.tobytes()


def write_pcd(path: str, img: np.ndarray) -> None:
    """Write pcd_bytes(img) to `path`."""
    with open(path, "wb") as f:
        f.write(pcd_bytes(img))
