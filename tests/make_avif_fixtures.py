"""Write the AVIF fixtures of the port's reader and their manifest.

    PYTHONPATH=. python tests/make_avif_fixtures.py [OUT_DIR]

Writes into tests/data/avif/ (or OUT_DIR) a small file of each layout the
port's reader (core/avif.py, csrc/av1_decode.cpp) takes, every AV1 frame
aom's through Pillow. The files of AVIF part 1 have the in-loop filters
off (tests/avif_encode.FILTERS_OFF):
- Pillow's save options: speeds 0-10; qualities 0-100 and lossless;
  4:2:0, 4:2:2, 4:4:4 and 4:0:0 at full and limited range; sizes 1x1,
  1x37, 37x1, odd sizes and sizes past one 128x128 superblock; tiles
  (tile_rows, tile_cols, autotiling); RGBA, premultiplied alpha, an
  animation (RGB and RGBA: the first frame), an ICC profile, EXIF
  orientation;
- aom's options: 64x64 and 128x128 superblocks; each intra tool switched
  off alone (filter intra, CfL, smooth, Paeth, angle deltas, directional
  and diagonal modes, the intra edge filter, 64-point transforms,
  rectangular, AB and 1:4 partitions, flipped and identity transforms),
  the reduced transform set, partition size limits, CDF update modes;
  quantizer matrices, the delta q modes, the adaptive quantisation modes
  (which aom does not turn into segmentation on a key frame) and chroma
  delta q; screen content with palettes;
- tests/avif_encode.py's rewrites: the colr nclx matrix (BT.709, BT.2020,
  unspecified, identity at 4:4:4, chroma-derived), its range flag, no
  colr box, the items' data in an idat (construction method 1), iloc
  versions 1 and 2 with 8-byte fields and split extents, a 64-bit mdat
  size, a mif1 major brand naming avif among its compatible brands;
- the AVIF scene's textures: utils/demo_scene's 1024x1024 albedo as a
  4:2:0 AVIF and as a 4:4:4 AVIF coded lossless (the Walsh-Hadamard
  path), and its 512x512 leaf as an RGBA AVIF whose alpha makes the
  cutouts.
Those of part 2 (named filt_*, and the scene's albedo_default and
leaf_default) have them on:
- Pillow's default save (aom's defaults) at a few qualities, and the
  scene's albedo (quality 80, speed 8: at slower speeds aom codes the
  flat procedural albedo with intra block copy, which turns the filters
  off) and RGBA leaf, whose 4:0:0 alpha item is filtered too;
- each filter alone (deblocking, CDEF, loop restoration) at three
  qualities; loop filter sharpness 0 and 7; delta LF (aom writes one
  value a block: its delta_lf_multi is always 0);
- every filter on at 4:2:0, 4:2:2, 4:4:4 and 4:0:0, at odd sizes, with
  64x64 and 128x128 superblocks, with 2x2 and 4x4 tiles, with alpha;
- half-noisy, half-flat frames at slow speeds, where aom picks
  switchable restoration and self-guided sets with r0 = 0 and r1 = 0;
- a default save at quality 100, coded lossless, where the
  specification keeps every filter off.
Those of intra block copy and film grain (ibc_*, grain_*, and the scene's
albedo_plain, albedo_grain and leaf_grain):
- screen content saved with intra block copy on at 4:2:0, 4:2:2, 4:4:4,
  4:0:0, with alpha, with 128x128 superblocks, at 1x1, 3x2 and 33x65;
- each of aom's 16 film-grain-test vectors, one vector at the other
  subsamplings and an odd size, and aom film grain tables (AR lags 0
  and 1, chroma grain alone, chroma scaling from luma);
- the scene's albedo as a plain Image.save (intra block copy), and its
  albedo and RGBA leaf with film grain.
Those of libavif's float routines and of grid images (float_*, grid_*,
and the scene's albedo_grid, leaf_grid and albedo_fcc; default saves):
- the colr nclx of Pillow's files rewritten to each of FLOAT_MATRICES at
  every subsampling, with alpha and premultiplied alpha;
- grids assembled by tests/avif_encode.make_grid from Pillow's saves of
  their tiles: every subsampling, 32-bit output sizes, the ImageGrid in
  the mdat, 64-sample tiles, 1x1 grids (one cropped), alpha grids,
  premultiplied too, a float-path matrix; the scene's albedo as a 3x3
  grid and its leaf as colour and alpha grids.
manifest.json holds, for each file, the shape, dtype and sha256 of
np.asarray of what the JAX read_ldr decodes through PIL, and the
versions of Pillow, libavif, dav1d and aom. The machine with the card
has no PIL: chip_smoke.py and tests/test_torch_avif_cuda.py hold the port
against the manifest there; tests/test_torch_avif.py holds the manifest
against PIL.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import avif_encode as ae  # noqa: E402
from make_dds_fixtures import array_digest, pil_pixels  # noqa: E402

FIXTURE_DIR = os.path.join(HERE, "data", "avif")
ALBEDO, ALBEDO_LOSSLESS, LEAF = ("albedo.avif", "albedo_lossless.avif",
                                 "leaf.avif")
# The scene's textures as Pillow's default saves, the in-loop filters on.
ALBEDO_DEFAULT, LEAF_DEFAULT = "albedo_default.avif", "leaf_default.avif"
# The albedo as a plain Image.save (speed 6: aom codes the flat albedo
# with intra block copy), and the albedo and RGBA leaf as default saves
# with film grain (aom's film-grain-test vector GRAIN_VECTOR: luma and
# chroma grain, AR lag 3, overlap; libavif hands the option to the alpha
# item's encoder too, so the leaf's alpha carries grain).
ALBEDO_PLAIN, ALBEDO_GRAIN, LEAF_GRAIN = ("albedo_plain.avif",
                                          "albedo_grain.avif",
                                          "leaf_grain.avif")
GRAIN_VECTOR = "2"
# The scene's textures as grid images (AVIF part 2, step 3): the albedo a
# 3x3 grid of 384x384 default-saved tiles cropped to 1024, its colr
# rewritten to matrix 12 under primaries 12 (libavif's float routines);
# the RGBA leaf a 2x2 colour grid and a 2x2 alpha grid of 256x256 tiles,
# YCgCo (matrix 8) at full range; and the default-save albedo with
# matrix 4 (FCC, the float routines) for a host decode time.
ALBEDO_GRID, LEAF_GRID, ALBEDO_FCC = ("albedo_grid.avif", "leaf_grid.avif",
                                      "albedo_fcc.avif")
# Screen content with intra block copy on.
SCREEN = {"tune-content": "screen", "enable-intrabc": "1"}
# Every filter on (aom turns CDEF and restoration off at some speeds).
ALL_ON = {"enable-cdef": "1", "enable-restoration": "1",
          "loopfilter-control": "1", "enable-intrabc": "0"}


def filtered(name: str) -> bool:
    """A fixture of part 2: its frame written with the filters on."""
    return name.startswith("filt_") or name in (ALBEDO_DEFAULT,
                                                LEAF_DEFAULT)


def grid_or_float(name: str) -> bool:
    """A fixture of grid images or of libavif's float routines (grid_*,
    float_*, and the scene's albedo_grid, leaf_grid and albedo_fcc)."""
    return name.startswith(("grid_", "float_")) or name in (
        ALBEDO_GRID, LEAF_GRID, ALBEDO_FCC)


def copy_or_grain(name: str) -> bool:
    """A fixture of intra block copy or film grain (ibc_*, grain_*, and the
    scene's plain-save albedo and grain albedo and leaf)."""
    return name.startswith(("ibc_", "grain_")) or name in (
        ALBEDO_PLAIN, ALBEDO_GRAIN, LEAF_GRAIN)
TOOLS_OFF = ("enable-filter-intra", "enable-cfl-intra", "enable-smooth-intra",
             "enable-paeth-intra", "enable-angle-delta",
             "enable-directional-intra", "enable-diagonal-intra",
             "enable-intra-edge-filter", "enable-tx64",
             "enable-rect-partitions", "enable-ab-partitions",
             "enable-1to4-partitions", "enable-flip-idtx")


def sample(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    """Smooth colour fields with noise, a bright band and a dark bar, so
    that every intra mode has something to predict; an alpha ramp as the
    fourth channel."""
    from PIL import Image

    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(base).resize((w, h), Image.BICUBIC),
                     np.float32)
    img = img + rng.normal(0, 10, (h, w, 3))
    img[h // 3:h // 2, :, 0] += 70
    img[:, w // 4:w // 4 + 3, 1] -= 80
    img = np.clip(img, 0, 255).astype(np.uint8)
    if channels == 4:
        yy, xx = np.mgrid[0:h, 0:w]
        alpha = ((xx * 37 + yy * 11) % 256).astype(np.uint8)
        img = np.concatenate([img, alpha[..., None]], -1)
    return img


def screen(rng, h: int, w: int) -> np.ndarray:
    """Flat rectangles of six colours on white: screen content."""
    img = np.full((h, w, 3), 255, np.uint8)
    colours = rng.integers(0, 256, (6, 3))
    for _ in range(30):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(2, 20), x:x + rng.integers(2, 40)] = \
            colours[rng.integers(0, 6)]
    return img


def text(rng, h: int, w: int) -> np.ndarray:
    """Rows of 5x3 two-colour glyphs, twelve of them, in four inks on
    white: text, whose repeats aom codes with intra block copy."""
    img = np.full((h, w, 3), 255, np.uint8)
    glyphs = rng.integers(0, 2, (12, 5, 3)).astype(bool)
    inks = rng.integers(0, 200, (4, 3))
    for y in range(1, h - 5, 7):
        ink = inks[rng.integers(0, 4)]
        for x in range(1, w - 3, 4):
            img[y:y + 5, x:x + 3][glyphs[rng.integers(0, 12)]] = ink
    return img


def pil_files(rng) -> dict:
    """Files Pillow writes: its save options and aom's."""
    from PIL import Image, ImageCms

    out = {}
    save = ae.pil_avif
    img = sample(rng, 40, 48)
    for speed in range(11):
        out[f"speed_{speed}.avif"] = save(img, quality=60, speed=speed)
    for q in (0, 10, 25, 50, 75, 90, 100):
        out[f"quality_{q}.avif"] = save(img, quality=q, speed=6)
    # Quality 100 codes the frame lossless (base_q_idx 0: the
    # Walsh-Hadamard transform); the RGB to YUV step before it is not.
    out["lossless.avif"] = save(img, quality=100, speed=6,
                                subsampling="4:4:4")
    out["lossless_aom.avif"] = save(img, speed=6, subsampling="4:4:4",
                                    advanced={"lossless": "1"})
    for sub in ("4:2:0", "4:2:2", "4:4:4", "4:0:0"):
        for rng_ in ("full", "limited"):
            tag = sub.replace(":", "")
            out[f"sub_{tag}_{rng_}.avif"] = save(
                sample(rng, 21, 35), quality=70, speed=6, subsampling=sub,
                range=rng_)
    for h, w in ((1, 1), (1, 37), (37, 1), (2, 3), (65, 33), (130, 141),
                 (9, 200)):
        out[f"size_{w}x{h}.avif"] = save(sample(rng, h, w), quality=70,
                                         speed=6)
    big = sample(rng, 200, 260)
    out["tiles_2x2.avif"] = save(big, quality=50, speed=8, tile_rows=1,
                                 tile_cols=1)
    out["tiles_4x4.avif"] = save(big, quality=50, speed=8, tile_rows=2,
                                 tile_cols=2)
    out["autotiling.avif"] = save(big, quality=50, speed=8, autotiling=True)
    for sb in ("64", "128"):
        out[f"sb_{sb}.avif"] = save(big, quality=50, speed=4,
                                    advanced={"sb-size": sb})
    mid = sample(rng, 72, 96)
    for tool in TOOLS_OFF:
        out[f"off_{tool[7:]}.avif"] = save(mid, quality=55, speed=4,
                                           advanced={tool: "0"})
    for name, adv in (
            ("reduced_tx_set", {"reduced-tx-type-set": "1"}),
            ("partition_16_32", {"min-partition-size": "16",
                                 "max-partition-size": "32"}),
            ("cdf_update_0", {"cdf-update-mode": "0"}),
            ("cdf_update_2", {"cdf-update-mode": "2"}),
            ("qm", {"enable-qm": "1"}),
            ("qm_all_levels", {"enable-qm": "1", "qm-min": "0",
                               "qm-max": "15"}),
            ("deltaq_1", {"deltaq-mode": "1"}),
            ("deltaq_2", {"deltaq-mode": "2"}),
            ("deltaq_3", {"deltaq-mode": "3"}),
            ("aq_1", {"aq-mode": "1"}), ("aq_2", {"aq-mode": "2"}),
            ("aq_3", {"aq-mode": "3"}),
            ("chroma_deltaq", {"enable-chroma-deltaq": "1",
                               "deltaq-mode": "3"})):
        out[f"{name}.avif"] = save(big if name[:2] in ("aq", "de", "ch")
                                   else mid, quality=45, speed=4,
                                   advanced=adv)
    scr = screen(rng, 64, 96)
    out["screen_palette.avif"] = save(
        scr, quality=60, speed=4,
        advanced={"tune-content": "screen", "enable-palette": "1"})
    out["palette.avif"] = save(scr, quality=60, speed=4,
                               advanced={"enable-palette": "1"})
    out["palette_444.avif"] = save(scr, quality=60, speed=4,
                                   subsampling="4:4:4",
                                   advanced={"enable-palette": "1"})
    rgba = sample(rng, 30, 44, 4)
    out["rgba.avif"] = save(rgba, quality=70, speed=6)
    out["rgba_premultiplied.avif"] = save(rgba, quality=70, speed=6,
                                          alpha_premultiplied=True)
    out["rgba_444_limited.avif"] = save(rgba, quality=70, speed=6,
                                        subsampling="4:4:4", range="limited")
    out["gray_alpha.avif"] = save(rgba, quality=70, speed=6,
                                  subsampling="4:0:0", range="limited")
    frames = [Image.fromarray(sample(rng, 24, 32)) for _ in range(3)]
    out["animation.avif"] = save(frames[0], quality=60, speed=6,
                                 append_images=frames[1:])
    frames = [Image.fromarray(sample(rng, 24, 32, 4)) for _ in range(2)]
    out["animation_rgba.avif"] = save(frames[0], quality=60, speed=6,
                                      append_images=frames[1:])
    out["animation_premultiplied.avif"] = save(
        frames[0], quality=60, speed=6, append_images=frames[1:],
        alpha_premultiplied=True)
    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    out["icc.avif"] = save(img, quality=60, speed=6, icc_profile=icc)
    exif = Image.Exif()
    exif[0x0112] = 6
    out["exif_orientation.avif"] = save(img, quality=60, speed=6,
                                        exif=exif.tobytes())
    return out


def mixed(rng, h: int, w: int) -> np.ndarray:
    """A smooth field, its right half under heavy noise, its lower left
    quarter screen content: restoration units that want different
    filters."""
    img = sample(rng, h, w)
    noisy = np.clip(sample(rng, h, w).astype(int)
                    + rng.normal(0, 30, (h, w, 3)), 0, 255)
    img[:, w // 2:] = noisy[:, w // 2:].astype(np.uint8)
    img[h // 2:, :w // 2] = screen(rng, h - h // 2, w // 2)
    return img


def filter_files(rng) -> dict:
    """Pillow's files with the in-loop filters on (part 2)."""
    out = {}
    default, save = ae.pil_default, ae.pil_avif
    mid = sample(rng, 72, 96)
    for q in (10, 40, 75):
        out[f"filt_default_q{q}.avif"] = default(mid, quality=q)
    for tag, opt, speed in (("deblocking", "loopfilter-control", 6),
                            ("cdef", "enable-cdef", 6),
                            ("restoration", "enable-restoration", 4)):
        for q in (15, 40, 70):
            out[f"filt_{tag}_only_q{q}.avif"] = save(
                mid, quality=q, speed=speed, advanced={opt: "1"})
    for sharp in (0, 7):
        out[f"filt_sharpness_{sharp}.avif"] = default(
            mid, quality=30, advanced={"sharpness": str(sharp)})
    big = sample(rng, 200, 260)
    out["filt_delta_lf.avif"] = default(big, quality=35, speed=4, advanced={
        "deltaq-mode": "2", "delta-lf-mode": "1"})
    for sub in ("4:2:0", "4:2:2", "4:4:4", "4:0:0"):
        out[f"filt_sub_{sub.replace(':', '')}.avif"] = default(
            sample(rng, 60, 90), quality=35, speed=4, subsampling=sub,
            advanced=ALL_ON)
    for h, w in ((1, 1), (2, 3), (65, 33), (130, 141), (9, 200)):
        out[f"filt_size_{w}x{h}.avif"] = default(
            sample(rng, h, w), quality=35, speed=4, advanced=ALL_ON)
    for sb in ("64", "128"):
        out[f"filt_sb_{sb}.avif"] = default(big, quality=35, speed=4,
                                            advanced={**ALL_ON,
                                                      "sb-size": sb})
    out["filt_tiles_2x2.avif"] = default(big, quality=35, speed=4,
                                         tile_rows=1, tile_cols=1,
                                         advanced=ALL_ON)
    out["filt_tiles_4x4.avif"] = default(big, quality=35, speed=4,
                                         tile_rows=2, tile_cols=2,
                                         advanced=ALL_ON)
    out["filt_rgba.avif"] = default(sample(rng, 50, 70, 4), quality=35,
                                    speed=4, advanced=ALL_ON)
    # Their own seeds: aom's choice of unit types is fragile.
    for name, seed in (("switchable", 1), ("sgrproj", 2)):
        out[f"filt_{name}.avif"] = default(
            mixed(np.random.default_rng(seed), 384, 384), quality=50,
            speed=1, advanced={"enable-restoration": "1",
                               "enable-intrabc": "0"})
    out["filt_lossless.avif"] = default(mid, quality=100)
    return out


def intrabc_files(rng) -> dict:
    """Screen content saved with intra block copy on (Pillow's default
    save otherwise): text at every subsampling, with an alpha of
    rectangles and with 128x128 superblocks, small and odd sizes."""
    out = {}
    save = ae.pil_default
    txt = text(rng, 192, 256)
    for sub in ("4:2:0", "4:2:2", "4:4:4", "4:0:0"):
        out[f"ibc_sub_{sub.replace(':', '')}.avif"] = save(
            txt, quality=50, speed=4, subsampling=sub, advanced=SCREEN)
    rgba = np.concatenate([text(rng, 192, 256),
                           screen(rng, 192, 256)[..., :1]], -1)
    out["ibc_rgba.avif"] = save(rgba, quality=50, speed=4, advanced=SCREEN)
    out["ibc_sb_128.avif"] = save(text(rng, 200, 260), quality=50,
                                  speed=4, advanced={**SCREEN,
                                                     "sb-size": "128"})
    for h, w in ((1, 1), (2, 3), (65, 33)):
        out[f"ibc_size_{w}x{h}.avif"] = save(screen(rng, h, w), quality=50,
                                             speed=4, advanced=SCREEN)
    return out


def grain_files(rng) -> dict:
    """Film grain: each of aom's 16 film-grain-test vectors (odd ones at
    limited range, where the vectors that ask for it clip to the
    restricted range), vector GRAIN_VECTOR at the other subsamplings and
    an odd size, and tables of aom's own text format for what the vectors
    leave out: AR lags 0 and 1, chroma grain without luma grain, chroma
    scaling from luma at 4:2:2."""
    out = {}
    save = ae.pil_default
    img = sample(rng, 40, 48)
    for k in range(1, 17):
        out[f"grain_test_{k}.avif"] = save(
            img, quality=60, range="limited" if k % 2 else "full",
            advanced={"film-grain-test": str(k)})
    for sub in ("4:2:2", "4:4:4", "4:0:0"):
        out[f"grain_sub_{sub.replace(':', '')}.avif"] = save(
            sample(rng, 30, 44), quality=60, subsampling=sub,
            advanced={"film-grain-test": GRAIN_VECTOR})
    out["grain_size_33x65.avif"] = save(
        sample(rng, 65, 33), quality=60,
        advanced={"film-grain-test": GRAIN_VECTOR})
    out["grain_table_lag0.avif"] = ae.pil_grain(img, ae.grain_table(
        seed=4321, lag=0, overlap=1, y_points=((0, 20), (128, 60), (255, 30)),
        cb_points=((0, 40), (255, 40)), cr_points=((64, 20), (192, 70)),
        cb=(100, 160, 300), cr=(150, 90, 220), ar_cb=(12,), ar_cr=(-20,)),
        quality=60)
    out["grain_table_lag1_444.avif"] = ae.pil_grain(img, ae.grain_table(
        seed=99, lag=1, scale_shift=1, cb_points=((16, 64), (200, 90)),
        cr_points=((0, 50),), ar_cb=(10, -20, 30, 5), ar_cr=(-8, 4, 0, 12)),
        quality=60, subsampling="4:4:4")
    out["grain_table_cfl_422.avif"] = ae.pil_grain(img, ae.grain_table(
        seed=17, lag=1, ar_shift=8, scaling_shift=10, from_luma=1,
        overlap=1, y_points=((10, 90), (240, 120)), ar_y=(6, -12, 20, 30),
        ar_cb=(3, 5, -7, 9, 40), ar_cr=(-3, 8, 2, -1, -30)),
        quality=60, subsampling="4:2:2")
    return out


def box_files(rng) -> dict:
    """tests/avif_encode.py's rewrites of Pillow's files."""
    out = {}
    save = ae.pil_avif
    img = sample(rng, 27, 38)
    f420 = save(img, quality=70, speed=6)
    f444 = save(img, quality=70, speed=6, subsampling="4:4:4")
    for mc, full in ((1, 1), (1, 0), (9, 1), (9, 0), (2, 1), (5, 0)):
        out[f"nclx_mc{mc}_{'full' if full else 'limited'}.avif"] = \
            ae.set_nclx(f420, mc=mc, full=full)
    out["nclx_identity.avif"] = ae.set_nclx(f444, mc=0, full=1)
    out["nclx_identity_limited.avif"] = ae.set_nclx(f444, mc=0, full=0)
    for cp in (1, 5, 9):
        out[f"nclx_mc12_cp{cp}.avif"] = ae.set_nclx(f420, cp=cp, mc=12)
    out["no_colr.avif"] = ae.drop_colr(save(img, quality=70, speed=6,
                                            range="limited"))
    rgba = save(sample(rng, 19, 23, 4), quality=70, speed=6)
    out["idat.avif"] = ae.relocate(f420, idat=True)
    out["idat_rgba.avif"] = ae.relocate(rgba, idat=True, version=2)
    out["iloc_v1_split.avif"] = ae.relocate(rgba, version=1, split=3,
                                            offset_size=8, length_size=8,
                                            base_offset_size=4)
    out["iloc_v2.avif"] = ae.relocate(f420, version=2, offset_size=8)
    out["mdat_largesize.avif"] = ae.relocate(f420, big_mdat=True)
    out["brand_mif1.avif"] = ae.set_brands(f420, b"mif1",
                                           [b"avif", b"mif1", b"miaf",
                                            b"MA1B"])
    return out


def scene_textures() -> dict:
    """The AVIF scene's albedo (4:2:0 and lossless 4:4:4) and leaf."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image, leaf_image

    albedo = _to_uint8(albedo_image(1024))
    leaf = _to_uint8(leaf_image(512))
    grain = {"film-grain-test": GRAIN_VECTOR}
    return {ALBEDO: ae.pil_avif(albedo, quality=80, speed=6),
            ALBEDO_LOSSLESS: ae.pil_avif(albedo, quality=100, speed=6,
                                         subsampling="4:4:4"),
            LEAF: ae.pil_avif(leaf, quality=90, speed=6),
            ALBEDO_DEFAULT: ae.pil_default(albedo, quality=80, speed=8),
            LEAF_DEFAULT: ae.pil_default(leaf),
            ALBEDO_PLAIN: ae.pil_default(albedo),
            ALBEDO_GRAIN: ae.pil_default(albedo, advanced=grain),
            LEAF_GRAIN: ae.pil_default(leaf, advanced=grain)}


# (matrix coefficients, colour primaries, full range) of the float-path
# fixtures: FCC, SMPTE 240M, YCgCo (full range only), chroma-derived under
# BT.470M, SMPTE 240M and P3 primaries, and 15, which libavif's table
# lacks (BT.601's Kr and Kb).
FLOAT_MATRICES = {"mc4": (4, 1, 0), "mc7": (7, 1, 1), "mc8": (8, 1, 1),
                  "mc12_cp4": (12, 4, 0), "mc12_cp7": (12, 7, 1),
                  "mc12_cp12": (12, 12, 0), "mc15": (15, 1, 1)}


def float_files(rng) -> dict:
    """libavif's float routines (part 2, step 3): Pillow's files (33x27,
    odd sizes for chroma's edges) with their colr nclx rewritten to each
    of FLOAT_MATRICES at every subsampling; RGBA, premultiplied RGBA at
    4:2:0 (the slow routine's float un-premultiply) and 4:4:4 (libyuv's),
    4:0:0 with alpha, premultiplied too, and identity at limited range
    premultiplied (the slow routine's too)."""
    out = {}
    save = ae.pil_default
    for sub in ("4:2:0", "4:2:2", "4:4:4", "4:0:0"):
        data = save(sample(rng, 27, 33), quality=70, speed=8,
                    subsampling=sub)
        for tag, (mc, cp, full) in FLOAT_MATRICES.items():
            out[f"float_{tag}_{sub.replace(':', '')}.avif"] = ae.set_nclx(
                data, cp=cp, mc=mc, full=full)
    rgba = sample(rng, 27, 33, 4)
    for name, sub, prem, mc, cp, full in (
            ("rgba_420", "4:2:0", False, 4, 1, 1),
            ("rgba_prem_420", "4:2:0", True, 12, 12, 0),
            ("rgba_prem_444", "4:4:4", True, 7, 1, 0),
            ("ycgco_prem_444", "4:4:4", True, 8, 1, 1),
            ("gray_alpha", "4:0:0", False, 15, 1, 0),
            ("gray_alpha_prem", "4:0:0", True, 4, 1, 1),
            ("identity_limited_prem", "4:4:4", True, 0, 1, 0)):
        out[f"float_{name}.avif"] = ae.set_nclx(save(
            rgba, quality=70, speed=8, subsampling=sub,
            alpha_premultiplied=prem), cp=cp, mc=mc, full=full)
    return out


def grid_files(rng) -> dict:
    """Grid images (part 2, step 3) assembled by tests/avif_encode.make_grid
    from Pillow's default saves of their tiles: 2x3 grids of 72x80 tiles
    at 4:2:0, 4:2:2 (200x150), 4:4:4 and 4:0:0 (199x149: odd sizes where
    nothing is subsampled), with 32-bit output sizes, with the ImageGrid
    in the mdat rather than an idat, tiles of exactly 64, 1x1 grids (one
    cropped), RGBA with an alpha grid, premultiplied too, and a float-path
    matrix."""
    out = {}
    save = dict(quality=60, speed=9)
    img = sample(rng, 160, 216, 4)
    for sub, (w, h) in (("4:2:0", (200, 150)), ("4:2:2", (200, 150)),
                        ("4:4:4", (199, 149)), ("4:0:0", (199, 149))):
        tiles = ae.split_tiles(img[..., :3], 2, 3, 72, 80, subsampling=sub,
                               **save)
        out[f"grid_{sub.replace(':', '')}.avif"] = ae.make_grid(
            tiles, 2, 3, w, h)
    tiles = ae.split_tiles(img[..., :3], 2, 3, 72, 80, **save)
    out["grid_32bit_sizes.avif"] = ae.make_grid(tiles, 2, 3, 200, 150,
                                                big=True)
    out["grid_mdat.avif"] = ae.make_grid(tiles, 2, 3, 200, 150,
                                         in_idat=False)
    out["grid_float_mc12_cp12.avif"] = ae.set_nclx(
        ae.make_grid(tiles, 2, 3, 200, 150), cp=12, mc=12, full=1)
    out["grid_3x3_64.avif"] = ae.make_grid(ae.split_tiles(
        img[..., :3], 3, 3, 64, 64, **save), 3, 3, 180, 150)
    one = ae.split_tiles(img[:90, :100, :3], 1, 1, 100, 90, **save)
    out["grid_1x1.avif"] = ae.make_grid(one, 1, 1, 100, 90)
    out["grid_1x1_cropped.avif"] = ae.make_grid(one, 1, 1, 96, 74)
    rgba = ae.split_tiles(img, 2, 3, 72, 80, **save)
    out["grid_rgba.avif"] = ae.make_grid(rgba, 2, 3, 200, 150, alpha=True)
    prem = ae.split_tiles(img, 2, 3, 72, 80, alpha_premultiplied=True,
                          **save)
    out["grid_rgba_prem.avif"] = ae.make_grid(prem, 2, 3, 200, 150,
                                              alpha=True, prem=True)
    prem444 = ae.split_tiles(img, 2, 3, 72, 80, alpha_premultiplied=True,
                             subsampling="4:4:4", **save)
    out["grid_rgba_prem_444_ycgco.avif"] = ae.set_nclx(ae.make_grid(
        prem444, 2, 3, 199, 149, alpha=True, prem=True), mc=8, full=1)
    return out


def grid_scene_textures() -> dict:
    """The scene's albedo and leaf as grids, and the albedo with matrix 4
    (ALBEDO_GRID, LEAF_GRID, ALBEDO_FCC)."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image, leaf_image

    albedo = _to_uint8(albedo_image(1024))
    leaf = _to_uint8(leaf_image(512))
    grid = ae.make_grid(ae.split_tiles(albedo, 3, 3, 384, 384), 3, 3,
                        1024, 1024)
    leaf_grid = ae.make_grid(ae.split_tiles(leaf, 2, 2, 256, 256), 2, 2,
                             512, 512, alpha=True)
    default = ae.pil_default(albedo, quality=80, speed=8)
    return {ALBEDO_GRID: ae.set_nclx(grid, cp=12, mc=12),
            LEAF_GRID: ae.set_nclx(leaf_grid, mc=8, full=1),
            ALBEDO_FCC: ae.set_nclx(default, mc=4)}


def versions() -> dict:
    import PIL
    from PIL import _avif, features

    codecs = dict(part.split(":", 1) for part in
                  _avif.codec_versions().split(", "))
    return {"pil": PIL.__version__, "libavif": features.version("avif"),
            "dav1d": codecs.get("dav1d [dec]"),
            "aom": codecs.get("aom [enc]")}


def main(out_dir: str = FIXTURE_DIR) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20261021)
    files = {**pil_files(rng), **box_files(rng), **scene_textures(),
             **filter_files(np.random.default_rng(20261022)),
             **intrabc_files(np.random.default_rng(20261023)),
             **grain_files(np.random.default_rng(20261024)),
             **float_files(np.random.default_rng(20261025)),
             **grid_files(np.random.default_rng(20261026)),
             **grid_scene_textures()}
    manifest = {**versions(), "files": {}}
    for name, data in files.items():
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest["files"][name] = array_digest(pil_pixels(path))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    main(*sys.argv[1:])
