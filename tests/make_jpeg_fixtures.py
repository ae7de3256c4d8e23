"""Write the JPEG fixtures of the port's decoder and their manifest.

    PYTHONPATH=. python tests/make_jpeg_fixtures.py [OUT_DIR]

Writes into tests/data/jpeg/ (or OUT_DIR) a set of small JPEG files that
covers the decoder's paths, and manifest.json: for each file the shape,
dtype and sha256 of the array PIL decodes from it,
np.asarray(Image.open(path).convert("RGB")), and the PIL and
libjpeg-turbo versions that decoded it. The files:
- saved by PIL (fixture_specs): grey; 4:4:4, 4:2:2 and 4:2:0 at an odd
  size; progressive; restart intervals; optimised Huffman tables; quality
  5 and 100; a 1024x1024 progressive 4:2:0 stone-tile albedo
  (utils/demo_scene.albedo_image);
- written by tests/jpeg_encode.py (written_specs), which PIL's encoder
  cannot write: arithmetic-coded sequential and progressive files (grey,
  4:4:4, 4:2:0, CMYK, YCCK), with DAC conditioning, statistics tables
  above 3 and restarts; a lossless file of each predictor (grey, RGB,
  point transforms, 4:2:0, CMYK, restarts, a scan a component);
  progressive files cut after their first scans, which libjpeg
  block-smooths (PIL's own and arithmetic-coded ones); and the albedo as
  an arithmetic-coded progressive 4:2:0 file (albedo_1024_arith.jpg,
  what chip_smoke.py's jpeg phase times and renders).
The machine with the card has no PIL: chip_smoke.py and
tests/test_torch_jpeg_cuda.py hold the port's decoder against the
manifest there; tests/test_torch_jpeg.py holds the manifest against PIL.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "data", "jpeg")
SMALL = (97, 61)


def small_image(seed: int = 0) -> np.ndarray:
    """(61, 97, 3) uint8: smooth colour ramps under seeded noise."""
    w, h = SMALL
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0),
                  128 + 100 * np.cos(x / 5.0), (x * y) % 256], -1)
    noise = np.random.default_rng(seed).normal(0.0, 20.0, a.shape)
    return np.clip(a + noise, 0, 255).astype(np.uint8)


# name -> (image, PIL save options)
def fixture_specs():
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image

    img = small_image()
    albedo = np.round(albedo_image(1024) * 255).astype(np.uint8)
    return {
        "grey.jpg": (img[..., 0], dict(quality=85)),
        "rgb444.jpg": (img, dict(quality=85, subsampling=0)),
        "rgb422.jpg": (img, dict(quality=85, subsampling=1)),
        "rgb420.jpg": (img, dict(quality=85, subsampling=2)),
        "progressive.jpg": (img, dict(quality=85, subsampling=2,
                                      progressive=True)),
        "restart.jpg": (img, dict(quality=85, subsampling=2,
                                  restart_marker_blocks=3)),
        "optimize.jpg": (img, dict(quality=85, optimize=True)),
        "q5.jpg": (img, dict(quality=5)),
        "q100.jpg": (img, dict(quality=100, subsampling=0)),
        "albedo_1024.jpg": (albedo, dict(quality=90, subsampling=2,
                                         progressive=True)),
    }


def drop_last_scans(data: bytes, keep: int) -> bytes:
    """A progressive file cut after its first `keep` scans, closed by
    EOI."""
    pos, seen = 0, 0
    while True:
        pos = data.index(b"\xff\xda", pos + 1)
        seen += 1
        if seen > keep:
            return data[:pos] + b"\xff\xd9"


def _pil_bytes(img, **opts) -> bytes:
    import io

    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **opts)
    return b.getvalue()


# name -> a function writing its bytes
def written_specs():
    from jpeg_encode import (
        arithmetic_image,
        encode_lossless,
        quality_tables,
    )
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image

    img = small_image()
    q85 = quality_tables(85)
    s420 = [(2, 2), (1, 1), (1, 1)]
    s444 = [(1, 1)] * 3
    cmyk = np.concatenate([img, 255 - img[..., 1:2]], -1)
    small = small_image(1)[:45, :60]
    H, W = small.shape[:2]
    planes = [small[..., k] for k in range(3)]
    chroma = [small[::2, ::2, k] for k in (1, 2)]
    tables = [(5, 5), (9, 9), (15, 15)]
    return {
        "arith_grey.jpg": lambda: arithmetic_image(img[..., 0], [(1, 1)],
                                                   q85[:1]),
        "arith_444.jpg": lambda: arithmetic_image(img, s444, q85),
        "arith_420.jpg": lambda: arithmetic_image(img, s420, q85),
        "arith_prog_420.jpg": lambda: arithmetic_image(img, s420, q85,
                                                       progressive=True),
        "arith_prog_grey.jpg": lambda: arithmetic_image(
            img[..., 0], [(1, 1)], q85[:1], progressive=True),
        "arith_cmyk.jpg": lambda: arithmetic_image(
            cmyk, [(1, 1)] * 4, quality_tables(85, 4), jfif=False, adobe=0),
        "arith_ycck_prog.jpg": lambda: arithmetic_image(
            cmyk, [(2, 2), (1, 1), (1, 1), (2, 2)], quality_tables(85, 4),
            jfif=False, adobe=2, progressive=True),
        "arith_dac.jpg": lambda: arithmetic_image(
            img, s420, q85, dac={0: 0x52, 1: 0x30, 16: 1, 17: 40}),
        "arith_tables.jpg": lambda: arithmetic_image(
            img, s420, q85, progressive=True, tables=tables,
            dac={5: 0x41, 9: 0x20, 15: 0xFF, 21: 12, 25: 63, 31: 0}),
        "arith_restart.jpg": lambda: arithmetic_image(img, s420, q85,
                                                      restart=2),
        "arith_prog_restart.jpg": lambda: arithmetic_image(
            img, s420, q85, progressive=True, restart=5),
        "lossless_p1.jpg": lambda: encode_lossless(planes[:1], W, H,
                                                   [(1, 1)], psv=1),
        "lossless_p2.jpg": lambda: encode_lossless(planes, W, H, s444,
                                                   psv=2),
        "lossless_p3.jpg": lambda: encode_lossless(planes, W, H, s444,
                                                   psv=3, pt=2),
        "lossless_p4.jpg": lambda: encode_lossless(
            planes[:1] + chroma, W, H, s420, psv=4),
        "lossless_p5.jpg": lambda: encode_lossless(
            [cmyk[:45, :60, k] for k in range(4)], W, H, [(1, 1)] * 4,
            psv=5, adobe=0),
        "lossless_p6.jpg": lambda: encode_lossless(
            planes, W, H, s444, psv=6, pt=1, restart=2 * W, adobe=0),
        "lossless_p7.jpg": lambda: encode_lossless(
            planes[:1] + chroma, W, H, s420, psv=7, restart=W,
            interleaved=False),
        "smoothed_k1.jpg": lambda: drop_last_scans(
            _pil_bytes(img, quality=85, subsampling=2, progressive=True), 1),
        "smoothed_k2.jpg": lambda: drop_last_scans(
            _pil_bytes(img, quality=85, subsampling=2, progressive=True), 2),
        "smoothed_k3.jpg": lambda: drop_last_scans(
            _pil_bytes(img, quality=85, subsampling=2, progressive=True), 3),
        "smoothed_k6.jpg": lambda: drop_last_scans(
            _pil_bytes(img, quality=85, subsampling=2, progressive=True), 6),
        "smoothed_grey_k2.jpg": lambda: drop_last_scans(
            _pil_bytes(img[..., 0], quality=85, progressive=True), 2),
        "smoothed_arith_k1.jpg": lambda: drop_last_scans(
            arithmetic_image(img, s420, q85, progressive=True), 1),
        "smoothed_arith_k4.jpg": lambda: drop_last_scans(
            arithmetic_image(img, s420, q85, progressive=True), 4),
        "albedo_1024_arith.jpg": lambda: arithmetic_image(
            np.round(albedo_image(1024) * 255).astype(np.uint8), s420,
            quality_tables(90), progressive=True),
    }


def array_digest(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return dict(shape=list(arr.shape), dtype=str(arr.dtype),
                sha256=hashlib.sha256(arr.tobytes()).hexdigest())


def main(out_dir: str = FIXTURE_DIR) -> dict:
    import PIL
    from PIL import Image, features

    os.makedirs(out_dir, exist_ok=True)
    manifest = {"pil": PIL.__version__,
                "libjpeg_turbo": features.version("libjpeg_turbo"),
                "files": {}}
    for name, (img, opts) in fixture_specs().items():
        Image.fromarray(img).save(os.path.join(out_dir, name), "JPEG",
                                  **opts)
    for name, write in written_specs().items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(write())
    for name in list(fixture_specs()) + list(written_specs()):
        with Image.open(os.path.join(out_dir, name)) as im:
            decoded = np.asarray(im.convert("RGB"))
        manifest["files"][name] = array_digest(decoded)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    main(*sys.argv[1:])
