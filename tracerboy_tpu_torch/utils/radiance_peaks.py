"""The brightest pixels of the CLI's radiance on utils/demo_scene's
textured_lit.pbrt, with its albedo swapped for other textures.

    python -m tracerboy_tpu_torch.utils.radiance_peaks [--size 1280x720]
        [--spp 2] [--device cuda]

Renders the scene three times through app/cli.main (its --hdr-out
radiance taken as float32, before the EXR writer's cast to half floats):
with the committed BLP1-CMYK albedo (demo_scene.SMALL3_ALBEDO), with the
albedo PNG with red and blue swapped (what a BLP1 written in RGB order
reads as), and with the albedo PNG. Prints one JSON line a run: the
radiance's maximum and mean, how many samples pass half's largest value
(65,504) and how many pixels pass 100 and 1,000, and the first ten of
those pixels with their values. It shows how close the scene's
fireflies come to the half-float EXR's range.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

HALF_MAX = 65504.0


def peaks(rad: np.ndarray) -> dict:
    """The summary printed for one float32 (H, W, 3) radiance image."""
    lum = rad.max(-1)
    big = np.argwhere(lum > 100)
    return dict(finite=bool(np.isfinite(rad).all()),
                max=float(np.nanmax(rad)), mean=float(np.nanmean(rad)),
                over_half=int((rad > HALF_MAX).sum()),
                over_1000=int((lum > 1000).sum()),
                over_100=int(len(big)), where=big[:10].tolist(),
                values=rad[tuple(big[:10].T)].tolist())


def main(argv=None) -> int:
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.core import image_io
    from tracerboy_tpu_torch.utils.demo_scene import (
        SMALL3_ALBEDO,
        albedo_image,
        retexture,
        write_textured_scene,
    )

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", default="1280x720")
    p.add_argument("--spp", default="2")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    captured = {}
    write_exr = image_io.write_exr

    def grab(path, rad, *a, **k):
        captured["rad"] = np.asarray(rad, np.float32).copy()
        return write_exr(path, rad, *a, **k)

    with tempfile.TemporaryDirectory(prefix="tb_peaks_") as tmp:
        swapped = os.path.join(tmp, "albedo_bgr.png")
        image_io.write_png(swapped, albedo_image(1024)[..., ::-1])
        image_io.write_exr = grab
        try:
            for label, tex in (("blp1_cmyk", SMALL3_ALBEDO),
                               ("png_red_blue_swapped", swapped),
                               ("png", None)):
                d = os.path.join(tmp, label)
                tex_scene, lit = write_textured_scene(d)
                if tex:
                    retexture(tex_scene, {"albedo.png": tex})
                rc = cli.main([lit, "--size", args.size, "--spp", args.spp,
                               "--device", args.device, "--out",
                               os.path.join(d, "o.png"), "--hdr-out",
                               os.path.join(d, "o.exr"), "--quiet"])
                print(label, json.dumps(dict(rc=rc, **peaks(
                    captured.pop("rad")))), flush=True)
        finally:
            image_io.write_exr = write_exr
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
