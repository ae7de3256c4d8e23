"""Write the inputs of the port's image writer tests and PIL's hashes of
what Image.save writes for them.

    PYTHONPATH=. python tests/make_write_fixtures.py [OUT_DIR]

Writes into tests/data/write/ (or OUT_DIR):
- inputs.npz: three RGBA uint8 images made from a seed, named W x H:
  1x1, 37x53 and 257x131 (odd widths: BMP's and PCX's row padding, a
  JPEG's partial MCUs), each a flat block (QOI runs, PNG's Up and Sub
  rows), a gradient of small steps (QOI's DIFF and LUMA ops) and noise;
  an input's L, LA and RGB images are its first 1, 2 and 3 channels
  (L the first channel alone);
- manifest.json: for each input, mode and extension of PIL 12.1's
  EXTENSION table with a save handler, what
  Image.fromarray(img).save("img" + ext) gave: the sha256 and size of
  the file, or the class of PIL's error; for PNG also the sha256 of the
  inflated IDAT stream and of the file without its IDAT chunks, and the
  IDAT lengths (another zlib writes other deflate bytes); for ICO and
  ICNS also icon_parts (the container without its PNGs and their
  lengths, and each embedded PNG's parts); for PDF the
  sha256 of the file with its two dates masked (mask_pdf_dates: PIL
  writes the time of the save); for what the port does not write yet
  (ported() false: AVIF, and a WebP whose converted image has alpha
  below 255, which libwebp codes with its lossless encoder) only whether
  PIL wrote one. PIL's and zlib's versions are recorded;
- webp_extra.json: PIL's sha256 and size of the WebP of each image of
  WEBP_EXTRA, opaque images of 1x1 to 1280x720 (flat, ramps, smooth
  gradients, noise, blocks and tiles of them mixed) that webp_extra_image
  makes from a seed with numpy integer arithmetic alone, so that any
  machine makes the same pixels;
- webp_alpha.json: the same for each image of WEBP_ALPHA, RGBA images of
  1x1 to 1280x720 whose alpha is below 255 somewhere (cutouts, soft
  edges, few and many levels, all transparent, one transparent pixel,
  transparent 8x8 blocks), which webp_alpha_image makes the same way.

tests/test_torch_image_write.py holds the port's image_save against the
manifest and checks the manifest against PIL on this machine (and
tests/test_torch_image_write_webp.py webp_extra.json,
tests/test_torch_image_write_webp_alpha.py webp_alpha.json); chip_smoke.py's
writers phase holds it against both on the card's machine, which has no
PIL.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import struct
import sys
import tempfile
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "data", "write")
SIZES = ((1, 1), (37, 53), (257, 131))          # (width, height)
MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
# The formats whose encoders the port has not ported (ROADMAP item 25).
LATER = ("AVIF",)
# webp_extra.json's images: (kind, width, height, seed).
WEBP_EXTRA = (
    ("flat", 1, 1, 1), ("noise", 1, 1, 2), ("ramp", 2, 3, 3),
    ("noise", 3, 2, 4), ("mixed", 5, 17, 5), ("blocky", 17, 5, 6),
    ("smooth", 16, 16, 7), ("noise", 17, 17, 8), ("ramp", 1, 40, 9),
    ("noise", 40, 1, 10), ("flat", 64, 48, 11), ("blocky", 100, 75, 12),
    ("mixed", 16, 300, 13), ("smooth", 300, 16, 14), ("noise", 131, 257, 15),
    ("ramp", 255, 3, 16), ("mixed", 320, 240, 17), ("blocky", 640, 480, 18),
    ("noise", 16383, 1, 19), ("smooth", 641, 479, 20),
    ("mixed", 1280, 720, 21), ("smooth", 1280, 720, 22))
WEBP_KINDS = ("flat", "ramp", "smooth", "noise", "blocky")
# webp_alpha.json's images: each alpha kind at each size (width, height),
# the RGB kinds in turn, and a 1280x720 soft cutout of mixed content.
WEBP_ALPHA_KINDS = ("cutout", "soft", "few", "some", "many", "zero", "one",
                    "blocks")
WEBP_ALPHA_SIZES = ((1, 1), (2, 3), (7, 9), (37, 53), (257, 131),
                    (16383, 1))
WEBP_ALPHA = tuple(
    ((("mixed",) + WEBP_KINDS)[(i + j) % 6], alpha, w, h, 100 + 8 * i + j)
    for i, (w, h) in enumerate(WEBP_ALPHA_SIZES)
    for j, alpha in enumerate(WEBP_ALPHA_KINDS)) + (
    ("mixed", "soft", 1280, 720, 200),)
# A PDF date as PdfParser writes a time.struct_time, and its mask.
PDF_DATE = re.compile(rb"\(D:\d{14}Z\)")
PDF_DATE_MASK = b"(D:00000000000000Z)"


def mask_pdf_dates(data: bytes) -> bytes:
    """A PDF with every /CreationDate and /ModDate value masked (the
    masked file keeps its length, so its xref offsets hold)."""
    return PDF_DATE.sub(PDF_DATE_MASK, data)


def make_input(width: int, height: int, seed: int) -> np.ndarray:
    """(H, W, 4) uint8: noise, a flat block at the top left, small steps
    at the bottom left, alpha 255 outside the noise."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (height, width, 4), dtype=np.uint8)
    hh, hw = (height + 1) // 2, (width + 1) // 2
    img[:hh, :hw] = (200, 120, 40, 255)
    y, x = np.mgrid[hh:height, 0:hw]
    img[hh:, :hw, 0] = (2 * x + y) % 256
    img[hh:, :hw, 1] = (x + 3 * y) % 256
    img[hh:, :hw, 2] = (5 * x) % 256
    img[hh:, :hw, 3] = 255
    return img


def ported(fmt: str, img: np.ndarray) -> bool:
    """Whether the port writes format fmt for image img (as write_png
    makes it): every format but AVIF."""
    return fmt != "AVIF"


def _splitmix64(seed: int, n: int) -> np.ndarray:
    """n pseudo-random uint64 from seed: SplitMix64 of seed's n next
    states, in numpy's wrapping uint64 arithmetic."""
    gamma = 0x9E3779B97F4A7C15
    z = (np.arange(1, n + 1, dtype=np.uint64) * np.uint64(gamma)
         + np.uint64(seed * gamma % 2**64))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def webp_extra_image(kind: str, width: int, height: int,
                     seed: int) -> np.ndarray:
    """(H, W, 3) uint8 of one kind, from seed, in integer arithmetic:
    flat (one colour), ramp (steps of 0-7 a pixel, wrapping at 256),
    smooth (a gradient plus noise of 0-7), noise, blocky (blocks of 2-16
    pixels), mixed (16x16 tiles, each of one of the other kinds)."""
    h, w = height, width
    rnd = _splitmix64(seed, 16 + 3 * h * w)
    par = (rnd[:16] % np.uint64(256)).astype(np.int64)
    noise = (rnd[16:] >> np.uint64(24)).astype(np.int64).reshape(h, w, 3)
    y, x = np.mgrid[:h, :w]
    x, y = x[..., None], y[..., None]
    if kind == "flat":
        img = np.broadcast_to(par[:3], (h, w, 3))
    elif kind == "ramp":
        img = (x * (par[:3] % 8) + y * (par[3:6] % 8) + par[6:9]) % 256
    elif kind == "smooth":
        span = max(w + h - 2, 1)
        img = (x * par[:3] + y * par[3:6]) // span + noise % 8
        img = np.minimum(img, 255)
    elif kind == "noise":
        img = noise % 256
    elif kind == "blocky":
        b = 2 + int(par[9] % 15)
        img = noise[(y // b * b)[..., 0], (x // b * b)[..., 0]] % 256
    else:
        tiles = _splitmix64(seed + 1, ((h + 15) // 16) * ((w + 15) // 16))
        pick = (tiles % np.uint64(len(WEBP_KINDS))).astype(np.int64).reshape(
            (h + 15) // 16, (w + 15) // 16)[y[..., 0] // 16, x[..., 0] // 16]
        img = np.zeros((h, w, 3), np.int64)
        for k, other in enumerate(WEBP_KINDS):
            img = np.where((pick == k)[..., None],
                           webp_extra_image(other, w, h, seed + 2 + k), img)
    return np.ascontiguousarray(img, dtype=np.uint8)


def webp_extra() -> list:
    """PIL's WebP of each WEBP_EXTRA image: kind, width, height, seed,
    the file's sha256 and size."""
    from PIL import Image

    entries = []
    for kind, w, h, seed in WEBP_EXTRA:
        b = io.BytesIO()
        Image.fromarray(webp_extra_image(kind, w, h, seed)).save(b, "WEBP")
        data = b.getvalue()
        entries.append(dict(kind=kind, width=w, height=h, seed=seed,
                            sha256=hashlib.sha256(data).hexdigest(),
                            size=len(data)))
    return entries


def webp_alpha_image(kind: str, alpha: str, width: int, height: int,
                     seed: int) -> np.ndarray:
    """(H, W, 4) uint8: webp_extra_image's RGB of kind, and an alpha of
    one of WEBP_ALPHA_KINDS, in integer arithmetic: cutout (0 or 255, an
    ellipse), soft (an ellipse whose edge falls from 255 to 0 over about
    a fifth of it), few (2-16 levels in blocks), some (17-192 levels of a
    gradient), many (noise over 0-255), zero (0 throughout), one (255
    but at one pixel), blocks (8x8 blocks transparent or opaque, the
    right and bottom leftovers half transparent); the first pixel 0 where
    all would be 255."""
    h, w = height, width
    rgb = webp_extra_image(kind, w, h, seed)
    rnd = _splitmix64(seed + 7, 8 + h * w)
    par = (rnd[:8] % np.uint64(65536)).astype(np.int64)
    noise = (rnd[8:] >> np.uint64(24)).astype(np.int64).reshape(h, w)
    y, x = np.mgrid[:h, :w].astype(np.int64)
    # squared distance from the centre, in units of (w*h)^2 / 4
    d2 = (2 * x + 1 - w) ** 2 * h * h + (2 * y + 1 - h) ** 2 * w * w
    r2 = (w * h) ** 2 * 36 // 100
    if alpha == "cutout":
        a = np.where(d2 <= r2, 255, 0)
    elif alpha == "soft":
        a = np.clip((r2 - d2) * 255 * 5 // max(r2, 1) + 128, 0, 255)
    elif alpha == "few":
        levels = 2 + int(par[0] % 15)
        b = 1 + int(par[1] % 8)
        a = noise[y // b * b, x // b * b] % levels * (255 // (levels - 1))
    elif alpha == "some":
        levels = 17 + int(par[0] % 176)
        a = (x * 3 + y * 2) * levels // max(3 * w + 2 * h, 1) * 255 // (
            levels - 1)
        a = np.minimum(a, 255)
    elif alpha == "many":
        a = noise % 256
    elif alpha == "zero":
        a = np.zeros((h, w), np.int64)
    elif alpha == "one":
        a = np.full((h, w), 255)
        a[int(par[0] % h), int(par[1] % w)] = int(par[2] % 255)
    else:   # blocks
        cells = _splitmix64(seed + 8, ((h + 7) // 8) * ((w + 7) // 8))
        cells = (cells % np.uint64(2)).astype(np.int64).reshape(
            (h + 7) // 8, (w + 7) // 8)
        a = cells[y // 8, x // 8] * 255
        a = np.where((x >= w // 8 * 8) | (y >= h // 8 * 8),
                     np.where(noise % 2 == 1, 0, a), a)
    if (a == 255).all():   # a tiny cutout, soft edge or level set
        a.flat[0] = 0
    return np.ascontiguousarray(np.dstack([rgb, a]), dtype=np.uint8)


def webp_alpha() -> list:
    """PIL's WebP of each WEBP_ALPHA image: kind, alpha, width, height,
    seed, the file's sha256 and size."""
    from PIL import Image

    entries = []
    for kind, alpha, w, h, seed in WEBP_ALPHA:
        b = io.BytesIO()
        Image.fromarray(webp_alpha_image(kind, alpha, w, h, seed)).save(
            b, "WEBP")
        data = b.getvalue()
        entries.append(dict(kind=kind, alpha=alpha, width=w, height=h,
                            seed=seed, sha256=hashlib.sha256(data).hexdigest(),
                            size=len(data)))
    return entries


def inputs() -> dict:
    return {f"{w}x{h}": make_input(w, h, 20261018 + k)
            for k, (w, h) in enumerate(SIZES)}


def image_of(rgba: np.ndarray, mode: str) -> np.ndarray:
    c = MODES[mode]
    return rgba[..., 0] if c == 1 else np.ascontiguousarray(rgba[..., :c])


def png_parts(data: bytes) -> dict:
    """The sha256 of a PNG's inflated IDAT stream and of its chunks other
    than IDAT, and its IDAT lengths."""
    pos, idat, frame, lengths = 8, b"", data[:8], []
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        chunk = data[pos:pos + 12 + n]
        if kind == b"IDAT":
            idat += chunk[8:8 + n]
            lengths.append(n)
        else:
            frame += chunk
        pos += 12 + n
    return dict(stream_sha256=hashlib.sha256(zlib.decompress(idat))
                .hexdigest(),
                frame_sha256=hashlib.sha256(frame).hexdigest(),
                idat=lengths)


def icon_parts(data: bytes) -> dict:
    """An ICO's or ICNS's embedded PNGs taken apart: the sha256 of the
    file with each PNG cut out and each field that holds a PNG's length or
    offset (or the file's length) zeroed, and each PNG's png_parts in file
    order (ICNS's 256 and 512 twice)."""
    buf, spans = bytearray(data), []
    if data[:4] == b"icns":
        buf[4:8] = bytes(4)
        pos = 8
        while pos < len(data):
            kind, n = struct.unpack_from(">4si", data, pos)
            if kind == b"TOC ":
                for q in range(pos + 8, pos + n, 8):
                    buf[q + 4:q + 8] = bytes(4)
            else:
                buf[pos + 4:pos + 8] = bytes(4)
                spans.append((pos + 8, pos + n))
            pos += n
    else:
        for k in range(struct.unpack_from("<H", data, 4)[0]):
            n, offset = struct.unpack_from("<II", data, 6 + 16 * k + 8)
            buf[6 + 16 * k + 8:6 + 16 * k + 16] = bytes(8)
            spans.append((offset, offset + n))
    container, last = b"", 0
    for start, end in sorted(spans):
        container += bytes(buf[last:start])
        last = end
    container += bytes(buf[last:])
    return dict(container_sha256=hashlib.sha256(container).hexdigest(),
                pngs=[png_parts(data[start:end]) for start, end in spans])


def pil_entry(img: np.ndarray, ext: str, directory: str) -> dict:
    """What PIL's Image.fromarray(img).save(directory/"img" + ext) gives."""
    from PIL import Image

    path = os.path.join(directory, "img" + ext)
    fmt = Image.EXTENSION[ext]
    try:
        Image.fromarray(img).save(path)
    except Exception as e:
        return dict(error=type(e).__name__)
    with open(path, "rb") as f:
        data = f.read()
    os.remove(path)
    if not ported(fmt, img):
        return dict(later=True)
    if fmt == "PDF":
        data = mask_pdf_dates(data)
    entry = dict(sha256=hashlib.sha256(data).hexdigest(), size=len(data))
    if fmt == "PDF":
        entry["dates"] = "masked"
    if fmt == "PNG":
        entry.update(png_parts(data))
    if fmt in ("ICO", "ICNS"):
        entry.update(icon_parts(data))
    return entry


def save_extensions() -> list:
    """The extensions of PIL's EXTENSION table whose format has a save
    handler, in the table's order."""
    from PIL import Image

    Image.init()
    return [e for e, f in Image.EXTENSION.items() if f in Image.SAVE]


def manifest(images: dict) -> dict:
    import PIL
    from PIL import features

    entries = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, rgba in images.items():
            for mode in MODES:
                for ext in save_extensions():
                    entries[f"{name}/{mode}/{ext}"] = pil_entry(
                        image_of(rgba, mode), ext, tmp)
    return dict(pil=PIL.__version__, zlib=features.version("zlib"),
                libjpeg_turbo=features.version("libjpeg_turbo"),
                bufsize=65536, entries=entries)


def main(out_dir: str = FIXTURE_DIR) -> None:
    os.makedirs(out_dir, exist_ok=True)
    images = inputs()
    np.savez_compressed(os.path.join(out_dir, "inputs.npz"), **images)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest(images), f, indent=1, sort_keys=True)
        f.write("\n")
    import PIL
    from PIL import features

    with open(os.path.join(out_dir, "webp_extra.json"), "w") as f:
        json.dump(dict(pil=PIL.__version__, libwebp=features.version("webp"),
                       entries=webp_extra()), f, indent=1, sort_keys=True)
        f.write("\n")
    with open(os.path.join(out_dir, "webp_alpha.json"), "w") as f:
        json.dump(dict(pil=PIL.__version__, libwebp=features.version("webp"),
                       entries=webp_alpha()), f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main(*sys.argv[1:])
