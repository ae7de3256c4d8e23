"""Write the JPEG fixtures of the port's decoder and their manifest.

    PYTHONPATH=. python tests/make_jpeg_fixtures.py [OUT_DIR]

Writes, with PIL, into tests/data/jpeg/ (or OUT_DIR) a set of small JPEG
files that covers the decoder's paths (grey; 4:4:4, 4:2:2 and 4:2:0 at
an odd size; progressive; restart intervals; optimised Huffman tables;
quality 5 and 100) and a 1024x1024 progressive 4:2:0 stone-tile albedo
(utils/demo_scene.albedo_image), and manifest.json: for each file the
shape, dtype and sha256 of the array PIL decodes from it,
np.asarray(Image.open(path).convert("RGB")), and the PIL and
libjpeg-turbo versions that decoded it. The machine with the card has no
PIL: chip_smoke.py and tests/test_torch_jpeg_cuda.py hold the port's
decoder against the manifest there; tests/test_torch_jpeg.py holds the
manifest against PIL.
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
        path = os.path.join(out_dir, name)
        Image.fromarray(img).save(path, "JPEG", **opts)
        with Image.open(path) as im:
            decoded = np.asarray(im.convert("RGB"))
        manifest["files"][name] = array_digest(decoded)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    main(*sys.argv[1:])
