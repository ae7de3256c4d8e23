"""A PBRT scene written from code, for runs that need a scene file and
have none: it reaches every part of the PBRT ingestion path.

write_demo_scene(directory, grid, sky) writes
  ground.ply  a height field of grid x grid quads (2 grid^2 triangles) as
              a binary little-endian PLY with normals and uvs;
  sky.hdr     a sky of sky[0] x sky[1] texels (lat-long, Radiance RGBE);
  env.pbrt    camera, film, a checkerboard-textured ground, three spheres
              (matte, metal, glass), a curve, and the sky as the only
              light (LightSource "infinite" with mapname);
  lit.pbrt    env.pbrt by Include, plus a distant and a point light.
It returns the paths of env.pbrt and lit.pbrt.

write_textured_scene(directory, grid, sky, leaves, albedo, normal, leaf)
writes the textured scene: the same height field (uber, with an
albedo x albedo sRGB image and a normal x normal normal map), a canopy of
`leaves` alpha-cut quads (leaves.ply) sharing a leaf x leaf RGBA image
about half of whose texels have alpha 0 (the albedo-alpha companion
path), a screen cut by an explicit "texture alpha" greyscale mask, an fbm
and a marble sphere, the glass sphere, and the sky as the only light
(textured.pbrt, so environment NEE is on); textured_lit.pbrt includes it
and adds a distant light. It returns the paths of both. retexture(scene,
swaps) points such a scene's image textures at other files (a JPEG or
DDS albedo, a DXT1 leaf); write_tiff_textures(directory) writes the
albedo as a tiled Deflate TIFF and the leaf as an RGBA LZW TIFF with
unassociated alpha, and returns the swaps that put them in;
write_small_textures(directory) writes the albedo in PIL's small texture
formats (an RLE SGI, a PCX, a BLP2 and an FTEX in DXT1, an ICNS of one
PNG entry) and the leaf as a BLP2 in DXT5 (alpha encoding 7);
write_small2_textures(directory) the albedo as a Sun raster (RLE and
raw), a planar IM and a 256-colour XPM, and the leaf as an RGBA IM;
write_small3_textures(directory) the albedo as a 256-colour FLC, a
PhotoCD of a 768x512 crop, and its grey as FITS (raw and gzip tiles) and
a raw IPTC image; SMALL3_ALBEDO is the committed BLP1 texture whose
JPEG is the albedo as a CMYK JPEG.

write_forest_scene(directory, grid, sky, trees, rocks, seed) writes
forest.pbrt: the height field, and two objects in ObjectBegin blocks, a
"tree" (tree.ply, 16,128 triangles, textured by tree.tga) and a "rock"
(rock.ply, 6,080 triangles, textured by the BMP rock.bmp), instanced
`trees` and `rocks` times, rotated and scaled, the trees in clusters of
overlapping boxes; one instanced emissive "lantern", a flat panel of 2
triangles facing down (flat, so that it cannot shadow itself: the TLAS
path, like the JAX one, lets instanced emitters occlude shadow rays);
the sky. At the defaults (64 trees, 24 rocks) the instances flatten to
1,178,114 triangles, so the compiler's "auto" rule keeps them as a
TLAS. The placement is drawn from `seed`.

write_mesh_scenes(directory) writes the tree alone as tree.obj with
tree.mtl (map_Kd tree.tga), as a binary tree.stl, and as tree.glb, whose
baseColorTexture is tree.png beside it.

The other scenes depend on the arguments only (no random numbers). Run as
  python -m tracerboy_tpu_torch.utils.demo_scene DIR [KIND]
with KIND textured, tiff (the textured scene with its albedo and leaf
swapped for TIFFs), small (swapped for an RLE SGI and a DXT5 BLP2),
small2 (swapped for an RLE Sun raster and an RGBA IM), small3 (the
albedo swapped for the BLP1 of a CMYK JPEG), forest or meshes.
"""

from __future__ import annotations

import json
import os
import struct
import textwrap

import numpy as np

from tracerboy_tpu_torch.core.image_io import (
    write_bmp,
    write_hdr,
    write_png,
    write_tga,
)

EXTENT = 12.0     # the ground spans [-EXTENT, EXTENT] in x and z


def _height(x, z):
    return (0.35 * np.sin(0.45 * x) * np.cos(0.35 * z)
            + 0.15 * np.sin(1.3 * x + 0.7 * z))


def write_quads_ply(path: str, verts: dict, quads: np.ndarray,
                    comment: str) -> None:
    """A binary little-endian PLY of quads: verts maps each of x, y, z,
    nx, ny, nz, u, v to a float array; quads is (n, 4) vertex indices."""
    keys = ("x", "y", "z", "nx", "ny", "nz", "u", "v")
    n = np.asarray(verts["x"]).size
    table = np.zeros(n, dtype=[(k, "<f4") for k in keys])
    for key in keys:
        table[key] = np.asarray(verts[key]).reshape(-1)
    faces = np.zeros(len(quads), dtype=[("n", "u1"), ("i", "<i4", (4,))])
    faces["n"] = 4
    faces["i"] = quads
    props = "".join(f"property float {k}\n" for k in keys)
    header = (f"ply\nformat binary_little_endian 1.0\ncomment {comment}\n"
              f"element vertex {n}\n{props}element face {len(quads)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(table.tobytes())
        f.write(faces.tobytes())


def write_ground_ply(path: str, grid: int) -> int:
    """The height field as a binary little-endian PLY of grid^2 quads;
    returns its triangle count."""
    n = grid + 1
    s = np.linspace(-EXTENT, EXTENT, n)
    x, z = np.meshgrid(s, s, indexing="xy")
    y = _height(x, z)
    # Normal of the surface y = h(x, z): (-dh/dx, 1, -dh/dz), normalised.
    dx = (0.35 * 0.45 * np.cos(0.45 * x) * np.cos(0.35 * z)
          + 0.15 * 1.3 * np.cos(1.3 * x + 0.7 * z))
    dz = (-0.35 * 0.35 * np.sin(0.45 * x) * np.sin(0.35 * z)
          + 0.15 * 0.7 * np.cos(1.3 * x + 0.7 * z))
    nrm = np.stack([-dx, np.ones_like(dx), -dz], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    u, v = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                       indexing="xy")
    i, j = np.meshgrid(np.arange(grid), np.arange(grid), indexing="xy")
    a = (j * n + i).reshape(-1)
    # Counter-clockwise seen from above (+y).
    quads = np.stack([a, a + n, a + n + 1, a + 1], -1).astype("<i4")
    write_quads_ply(path, dict(x=x, y=y, z=z, nx=nrm[..., 0],
                               ny=nrm[..., 1], nz=nrm[..., 2], u=u, v=v),
                    quads, f"height field, {grid}x{grid} quads")
    return 2 * grid * grid


def sky_image(width: int, height: int) -> np.ndarray:
    """A lat-long sky (z up in the map's frame): blue zenith, bright
    horizon, a sun, dark ground below the horizon."""
    theta = (np.arange(height) + 0.5) / height * np.pi
    phi = (np.arange(width) + 0.5) / width * 2 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    cz = np.cos(th)
    up = np.clip(cz, 0.0, 1.0)[..., None]
    zenith = np.array([0.25, 0.45, 1.0])
    horizon = np.array([1.1, 1.05, 0.95])
    img = horizon + (zenith - horizon) * up ** 0.5
    img = np.where(cz[..., None] > 0, img, np.array([0.08, 0.07, 0.06]))
    sun = np.array([np.sin(0.8) * np.cos(1.0), np.sin(0.8) * np.sin(1.0),
                    np.cos(0.8)])
    d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), cz], -1)
    img = img + 40.0 * (d @ sun > np.cos(0.06))[..., None]
    return img.astype(np.float32)


def write_demo_scene(directory: str, grid: int = 256,
                     sky: tuple = (512, 256)) -> tuple[str, str]:
    os.makedirs(directory, exist_ok=True)
    write_ground_ply(os.path.join(directory, "ground.ply"), grid)
    write_hdr(os.path.join(directory, "sky.hdr"), sky_image(*sky))
    spheres = "".join(
        f"AttributeBegin\n"
        f"  Translate {x} {_height(x, z) + 1.05:.4f} {z}\n"
        f"  {material}\n"
        f'  Shape "sphere" "float radius" [ 1 ]\n'
        f"AttributeEnd\n"
        for x, z, material in (
            (-3.0, 0.0, 'Material "matte" "rgb Kd" [ 0.7 0.2 0.2 ]'),
            (0.0, -1.0, 'Material "metal" "float roughness" [ 0.05 ]'),
            (3.0, 0.0, 'Material "glass" "float index" [ 1.5 ]'),
        ))
    env = textwrap.dedent("""\
        LookAt 0 4 13  0 0.6 0  0 1 0
        Camera "perspective" "float fov" [ 40 ]
        Film "image" "integer xresolution" [ 1280 ]
          "integer yresolution" [ 720 ]
        Sampler "halton" "integer pixelsamples" [ 8 ]
        Integrator "path" "integer maxdepth" [ 6 ]
        WorldBegin
        AttributeBegin
          Rotate -90 1 0 0
          LightSource "infinite" "string mapname" [ "sky.hdr" ]
            "rgb L" [ 1 1 1 ]
        AttributeEnd
        Texture "checks" "spectrum" "checkerboard"
          "float uscale" [ 24 ] "float vscale" [ 24 ]
          "rgb tex1" [ 0.75 0.75 0.7 ] "rgb tex2" [ 0.2 0.35 0.2 ]
        AttributeBegin
          Material "matte" "texture Kd" "checks"
          Shape "plymesh" "string filename" [ "ground.ply" ]
        AttributeEnd
        AttributeBegin
          Material "matte" "rgb Kd" [ 0.9 0.7 0.2 ]
          Shape "curve" "point P" [ -1.5 0.5 2  -0.5 3 2.5  0.5 3 1.5
                                    1.5 0.5 2 ]
            "float width0" [ 0.12 ] "float width1" [ 0.04 ]
        AttributeEnd
        """) + spheres + "WorldEnd\n"
    lit = textwrap.dedent("""\
        Include "env.pbrt"
        LightSource "distant" "point from" [ 1 3 2 ] "point to" [ 0 0 0 ]
          "rgb L" [ 2 1.9 1.7 ]
        LightSource "point" "point from" [ -2 3 3 ] "rgb I" [ 4 4 4 ]
        """)
    paths = []
    for name, text in (("env.pbrt", env), ("lit.pbrt", lit)):
        paths.append(os.path.join(directory, name))
        with open(paths[-1], "w") as f:
            f.write(text)
    return paths[0], paths[1]


def albedo_image(size: int) -> np.ndarray:
    """An sRGB-encoded ground albedo: stone tiles with mortar lines and a
    slow colour drift."""
    t = (np.arange(size) + 0.5) / size
    y, x = np.meshgrid(t, t, indexing="ij")
    fx, fy = (x * 8) % 1.0, (y * 8) % 1.0
    mortar = (np.minimum(np.minimum(fx, 1 - fx), np.minimum(fy, 1 - fy))
              < 0.04)
    tone = 0.55 + 0.25 * np.sin(17.0 * np.floor(x * 8) + 5.0 * np.floor(
        y * 8)) * np.cos(3.0 * np.floor(y * 8))
    base = np.stack([tone, 0.9 * tone, 0.75 * tone], -1)
    base = base * (0.9 + 0.1 * np.sin(40 * x)[..., None])
    return np.where(mortar[..., None], 0.25, base).clip(0, 1)


def normal_image(size: int) -> np.ndarray:
    """A tangent-space normal map of round bumps, encoded as 0.5 + 0.5 n
    with the JAX package's sign convention (tx = (0.5 - r) * 2)."""
    t = (np.arange(size) + 0.5) / size
    y, x = np.meshgrid(t, t, indexing="ij")
    k = 2 * np.pi * 6
    dhdx = 0.3 * k * np.cos(k * x) * np.sin(k * y) / k
    dhdy = 0.3 * k * np.sin(k * x) * np.cos(k * y) / k
    n = np.stack([dhdx, dhdy, np.ones_like(x)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.stack([0.5 - 0.5 * n[..., 0], 0.5 - 0.5 * n[..., 1],
                     n[..., 2]], -1)


def leaf_image(size: int) -> np.ndarray:
    """An RGBA leaf: alpha 1 inside an ellipse of semi-axes 0.5 x 0.32 of
    the image (half its texels), 0 outside; green with a lighter vein."""
    t = (np.arange(size) + 0.5) / size - 0.5
    y, x = np.meshgrid(t, t, indexing="ij")
    inside = (x / 0.5) ** 2 + (y / 0.32) ** 2 <= 1.0
    vein = np.abs(y) < 0.012
    rgb = np.where(vein[..., None], [0.55, 0.7, 0.3], [0.2, 0.45, 0.12])
    rgb = rgb * (0.8 + 0.4 * (x + 0.5))[..., None]
    return np.concatenate([rgb.clip(0, 1), inside[..., None] * 1.0], -1)


def mask_image(size: int) -> np.ndarray:
    """A greyscale cutout mask: a grid of round holes (0) in white (1)."""
    t = (np.arange(size) + 0.5) / size
    y, x = np.meshgrid(t, t, indexing="ij")
    fx, fy = (x * 6) % 1.0 - 0.5, (y * 6) % 1.0 - 0.5
    return (fx * fx + fy * fy > 0.09).astype(np.float64)


def write_leaves_ply(path: str, count: int) -> int:
    """A canopy of `count` leaf quads over the back of the ground, on a
    grid of 2 : 1 cells, each tilted by a pattern of its cell; returns
    the triangle count."""
    nz = max(1, int(round(np.sqrt(count / 2))))
    nx = count // nz
    i, j = np.meshgrid(np.arange(nx), np.arange(nz), indexing="xy")
    i, j = i.reshape(-1), j.reshape(-1)
    cx = -EXTENT + 2 * EXTENT * (i + 0.5) / nx
    cz = -10.0 + 8.0 * (j + 0.5) / nz
    cy = 2.8 + 2.5 * ((i * 7 + j * 13) % 29) / 29
    yaw = 0.7 * ((i * 5 + j * 3) % 17)
    tilt = 0.25 + 0.6 * ((i * 3 + j * 11) % 7) / 7
    size = 1.6 * 2 * EXTENT / nx
    # The leaf's frame: along (cos yaw, 0, sin yaw), across it tilted up.
    ax = np.stack([np.cos(yaw), np.zeros_like(yaw), np.sin(yaw)], -1)
    bx = np.stack([-np.sin(yaw) * np.cos(tilt), np.sin(tilt),
                   np.cos(yaw) * np.cos(tilt)], -1)
    nrm = np.cross(bx, ax)
    c = np.stack([cx, cy, cz], -1)
    corners = [c - size * (ax + bx) / 2, c + size * (ax - bx) / 2,
               c + size * (ax + bx) / 2, c + size * (bx - ax) / 2]
    pos = np.stack(corners, 1).reshape(-1, 3)
    uvs = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64),
                  (len(cx), 1))
    n4 = np.repeat(nrm, 4, axis=0)
    quads = np.arange(4 * len(cx), dtype="<i4").reshape(-1, 4)
    write_quads_ply(path, dict(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                               nx=n4[:, 0], ny=n4[:, 1], nz=n4[:, 2],
                               u=uvs[:, 0], v=uvs[:, 1]),
                    quads, f"leaf canopy, {len(cx)} quads")
    return 2 * len(cx)


def retexture(scene: str, swaps: dict) -> None:
    """Point a scene file's image textures at other files: `swaps` maps a
    file name the scene names (e.g. "albedo.png") to the path of the file
    to use instead, which is copied beside the scene under its own base
    name. Raises ValueError if the scene does not name one of them."""
    import shutil

    with open(scene) as f:
        text = f.read()
    for old, new in swaps.items():
        if f'"{old}"' not in text:
            raise ValueError(f"{scene} names no {old}")
        name = os.path.basename(new)
        shutil.copy(new, os.path.join(os.path.dirname(scene), name))
        text = text.replace(f'"{old}"', f'"{name}"')
    with open(scene, "w") as f:
        f.write(text)


def write_tiff_textures(directory: str) -> dict:
    """The textured scene's albedo and leaf as TIFFs (core/tiff.write_tiff)
    in `directory`: albedo.tif, 1024x1024 RGB in 160x160 Deflate tiles
    with Predictor 2 (the edge tiles cropped), and leaf.tif, 512x512 RGBA
    in LZW strips with Predictor 2 and unassociated alpha (ExtraSamples
    2), whose alpha makes the cutouts. Returns the retexture swaps
    {"albedo.png": ..., "leaf.png": ...}."""
    from tracerboy_tpu_torch.core.tiff import write_tiff

    os.makedirs(directory, exist_ok=True)
    paths = {"albedo.png": os.path.join(directory, "albedo.tif"),
             "leaf.png": os.path.join(directory, "leaf.tif")}
    write_tiff(paths["albedo.png"], albedo_image(1024), "deflate",
               tile=(160, 160))
    write_tiff(paths["leaf.png"], leaf_image(512), "lzw")
    return paths


def write_small_textures(directory: str) -> dict:
    """The textured scene's albedo (1024x1024 RGB) and leaf (512x512 RGBA)
    in PIL's small texture formats, in `directory`: albedo.sgi (RLE,
    core/sgi.write_sgi), albedo.pcx (3 planes, core/pcx.write_pcx),
    albedo_dxt1.blp (BLP2, DXT1, core/blp.write_blp2), albedo.ftex (DXT1,
    core/ftex.write_ftex), albedo.icns (one ic10 PNG entry, RGBA with
    alpha 255, core/icns.write_icns) and leaf.blp (BLP2, DXT5 with alpha
    encoding 7, its alpha the cutouts). Returns {file name: path}; the retexture
    swaps are {"albedo.png": paths["albedo.sgi"], "leaf.png":
    paths["leaf.blp"]}."""
    from tracerboy_tpu_torch.core import blp, ftex, icns, pcx, sgi
    from tracerboy_tpu_torch.core.image_io import _to_uint8

    os.makedirs(directory, exist_ok=True)
    paths = {name: os.path.join(directory, name) for name in (
        "albedo.sgi", "albedo.pcx", "albedo_dxt1.blp", "albedo.ftex",
        "albedo.icns", "leaf.blp")}
    albedo = _to_uint8(albedo_image(1024))
    sgi.write_sgi(paths["albedo.sgi"], albedo)
    pcx.write_pcx(paths["albedo.pcx"], albedo)
    blp.write_blp2(paths["albedo_dxt1.blp"], albedo, 1)
    ftex.write_ftex(paths["albedo.ftex"], albedo)
    icns.write_icns(paths["albedo.icns"], {b"ic10": np.concatenate(
        [albedo, np.full((1024, 1024, 1), 255, np.uint8)], -1)})
    blp.write_blp2(paths["leaf.blp"], leaf_image(512), 5)
    return paths


def write_small2_textures(directory: str) -> dict:
    """The textured scene's albedo (1024x1024 RGB) and leaf (512x512 RGBA)
    in more of PIL's small formats, in `directory`: albedo.ras (24-bit
    Sun RLE, core/sun.write_sun), albedo_raw.ras (24-bit raw Sun),
    albedo.im (IM, planar RGB rows, image_io.write_png), albedo.xpm (the
    albedo cut to 3-3-2 bits, 256 colours, two chars a pixel,
    core/xpm.write_xpm) and leaf.im (IM, planar RGBA rows, its alpha the
    cutouts). Returns {file name: path}; the retexture swaps are
    {"albedo.png": paths["albedo.ras"], "leaf.png": paths["leaf.im"]}."""
    from tracerboy_tpu_torch.core import sun, xpm
    from tracerboy_tpu_torch.core.image_io import _to_uint8, write_png

    os.makedirs(directory, exist_ok=True)
    paths = {name: os.path.join(directory, name) for name in (
        "albedo.ras", "albedo_raw.ras", "albedo.im", "albedo.xpm",
        "leaf.im")}
    albedo = _to_uint8(albedo_image(1024))
    sun.write_sun(paths["albedo.ras"], albedo)
    sun.write_sun(paths["albedo_raw.ras"], albedo, rle=False)
    write_png(paths["albedo.im"], albedo)
    xpm.write_xpm(paths["albedo.xpm"], albedo & np.array([0xE0, 0xE0, 0xC0],
                                                         np.uint8))
    write_png(paths["leaf.im"], leaf_image(512))
    return paths


# The BLP1 texture of the albedo (in BLP's BGR order, so that it reads as
# the albedo) as PIL's CMYK JPEG save at quality 75, alpha depth 0
# (tests/make_small3_fixtures.py; the port has no JPEG encoder).
SMALL3_ALBEDO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "data", "small3",
    "albedo_blp1_cmyk.blp")


def albedo_grey(size: int) -> np.ndarray:
    """The albedo's grey, (size, size) uint8: PIL's L weights (299, 587,
    114) / 1000 on the 8-bit albedo, truncated."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8

    rgb = _to_uint8(albedo_image(size)).astype(np.int64)
    return ((rgb @ np.array([299, 587, 114])) // 1000).astype(np.uint8)


def write_small3_textures(directory: str) -> dict:
    """The textured scene's albedo (1024x1024 RGB) in PIL's small formats
    of part 3, in `directory`: albedo.fli (an FLC of one BRUN frame, the
    albedo cut to 3-3-2 bits as indices into that palette,
    core/fli.write_fli), albedo.pcd (its top-left 768x512 as a PhotoCD,
    core/pcd.write_pcd), albedo.fits and albedo_gzip.fits (its grey,
    8-bit, raw and in one gzip tile, core/fits.write_fits) and
    albedo.iptc (its grey as a raw IPTC image, core/iptc.write_iptc).
    Returns {file name: path}; the retexture swap is {"albedo.png":
    paths["albedo.fli"]} (or SMALL3_ALBEDO, the committed BLP1)."""
    from tracerboy_tpu_torch.core import fits, fli, iptc, pcd
    from tracerboy_tpu_torch.core.image_io import _to_uint8

    os.makedirs(directory, exist_ok=True)
    paths = {name: os.path.join(directory, name) for name in (
        "albedo.fli", "albedo.pcd", "albedo.fits", "albedo_gzip.fits",
        "albedo.iptc")}
    albedo = _to_uint8(albedo_image(1024))
    idx = ((albedo[..., 0] >> 5 << 5) | (albedo[..., 1] >> 5 << 2)
           | (albedo[..., 2] >> 6)).astype(np.uint8)
    k = np.arange(256)
    palette = np.stack([k >> 5 << 5, (k >> 2 & 7) << 5, (k & 3) << 6],
                       -1).astype(np.uint8)
    fli.write_fli(paths["albedo.fli"], idx, palette)
    pcd.write_pcd(paths["albedo.pcd"], albedo[:512, :768])
    grey = albedo_grey(1024)
    fits.write_fits(paths["albedo.fits"], grey)
    fits.write_fits(paths["albedo_gzip.fits"], grey, compress=True)
    iptc.write_iptc(paths["albedo.iptc"], grey)
    return paths


def write_textured_scene(directory: str, grid: int = 256,
                         sky: tuple = (512, 256), leaves: int = 8192,
                         albedo: int = 1024, normal: int = 512,
                         leaf: int = 512) -> tuple[str, str]:
    os.makedirs(directory, exist_ok=True)
    write_ground_ply(os.path.join(directory, "ground.ply"), grid)
    write_leaves_ply(os.path.join(directory, "leaves.ply"), leaves)
    write_hdr(os.path.join(directory, "sky.hdr"), sky_image(*sky))
    write_png(os.path.join(directory, "albedo.png"), albedo_image(albedo))
    write_png(os.path.join(directory, "normal.png"), normal_image(normal))
    write_png(os.path.join(directory, "leaf.png"), leaf_image(leaf))
    write_png(os.path.join(directory, "mask.png"), mask_image(256))
    spheres = "".join(
        f"AttributeBegin\n"
        f"  Translate {x} {_height(x, z) + 1.05:.4f} {z}\n"
        f"  {material}\n"
        f'  Shape "sphere" "float radius" [ 1 ]\n'
        f"AttributeEnd\n"
        for x, z, material in (
            (-3.0, 0.0, 'Material "matte" "texture Kd" "cloud"'),
            (0.0, -1.0, 'Material "plastic" "texture Kd" "marb" '
                        '"float roughness" [ 0.15 ]'),
            (3.0, 0.0, 'Material "glass" "float index" [ 1.5 ]'),
        ))
    textured = textwrap.dedent("""\
        LookAt 0 4 13  0 0.6 0  0 1 0
        Camera "perspective" "float fov" [ 40 ]
        Film "image" "integer xresolution" [ 1280 ]
          "integer yresolution" [ 720 ]
        Sampler "halton" "integer pixelsamples" [ 8 ]
        Integrator "path" "integer maxdepth" [ 6 ]
        WorldBegin
        AttributeBegin
          Rotate -90 1 0 0
          LightSource "infinite" "string mapname" [ "sky.hdr" ]
            "rgb L" [ 1 1 1 ]
        AttributeEnd
        Texture "albedo" "spectrum" "imagemap"
          "string filename" [ "albedo.png" ]
          "float uscale" [ 4 ] "float vscale" [ 4 ]
        Texture "bumps" "spectrum" "imagemap"
          "string filename" [ "normal.png" ] "bool gamma" "false"
          "float uscale" [ 4 ] "float vscale" [ 4 ]
        Texture "leaf" "spectrum" "imagemap" "string filename" [ "leaf.png" ]
        Texture "holes" "float" "imagemap" "string filename" [ "mask.png" ]
        Texture "cloud" "spectrum" "fbm" "integer octaves" [ 5 ]
          "float roughness" [ 0.6 ] "float scale" [ 1.5 ]
        Texture "marb" "spectrum" "marble" "integer octaves" [ 6 ]
          "float scale" [ 2 ] "float variation" [ 0.4 ]
        AttributeBegin
          Material "uber" "texture Kd" "albedo" "texture normalmap" "bumps"
          Shape "plymesh" "string filename" [ "ground.ply" ]
        AttributeEnd
        AttributeBegin
          Material "matte" "texture Kd" "leaf"
          Shape "plymesh" "string filename" [ "leaves.ply" ]
        AttributeEnd
        AttributeBegin
          Material "matte" "rgb Kd" [ 0.8 0.3 0.25 ]
          Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
            "point P" [ -7 0 1  -4.5 0 -1  -4.5 3 -1  -7 3 1 ]
            "float uv" [ 0 0  1 0  1 1  0 1 ]
            "texture alpha" "holes"
        AttributeEnd
        """) + spheres + "WorldEnd\n"
    lit = textwrap.dedent("""\
        Include "textured.pbrt"
        LightSource "distant" "point from" [ 1 3 2 ] "point to" [ 0 0 0 ]
          "rgb L" [ 2 1.9 1.7 ]
        """)
    paths = []
    for name, text in (("textured.pbrt", textured),
                       ("textured_lit.pbrt", lit)):
        paths.append(os.path.join(directory, name))
        with open(paths[-1], "w") as f:
            f.write(text)
    return paths[0], paths[1]


def _lat_long(lat: int, lon: int, radius_fn):
    """A closed lat-long surface: vertices at (theta, phi) scaled by
    radius_fn(unit direction) (N, 3) -> (N, 3) positions; returns (pos,
    uv, quads) with the seam duplicated for the uvs."""
    th = np.linspace(0.0, np.pi, lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, lon + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    unit = np.stack([np.sin(T) * np.cos(P), np.cos(T),
                     np.sin(T) * np.sin(P)], -1).reshape(-1, 3)
    pos = radius_fn(unit)
    uv = np.stack([P / (2 * np.pi), 1.0 - T / np.pi], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(lat), np.arange(lon), indexing="ij")
    a = (i * (lon + 1) + j).reshape(-1)
    quads = np.stack([a, a + 1, a + lon + 2, a + lon + 1], -1)
    return pos, uv, quads


def _vertex_normals(pos, tris):
    """Area-weighted vertex normals of a triangle list."""
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]],
                  pos[tris[:, 2]] - pos[tris[:, 0]])
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, tris[:, k], fn)
    return nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                            1e-12)


def tree_mesh():
    """The tree in object space, base at the origin, 4.1 units tall: a
    crown of 64 x 124 quads on a lumpy ellipsoid over a 16 x 8 quad
    trunk; uv v in [0, 0.25) is bark, [0.25, 1] leaves (tree_image).
    Returns (pos, nrm, uv, tris), 16,128 triangles."""
    def crown(u):
        bumps = 1.0 + 0.08 * np.sin(7 * u[:, 0] + 3 * u[:, 1]) * np.cos(
            5 * u[:, 2] - 2 * u[:, 1])
        return u * bumps[:, None] * [1.1, 1.5, 1.1] + [0.0, 2.6, 0.0]

    cpos, cuv, cq = _lat_long(64, 124, crown)
    cuv[:, 1] = 0.25 + 0.75 * cuv[:, 1]
    ang = np.linspace(0, 2 * np.pi, 17)
    hgt = np.linspace(0.0, 1.6, 9)
    A, H = np.meshgrid(ang, hgt, indexing="ij")
    tpos = np.stack([0.15 * np.cos(A), H, 0.15 * np.sin(A)],
                    -1).reshape(-1, 3)
    tuv = np.stack([A / (2 * np.pi), 0.25 * H / 1.6], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(16), np.arange(8), indexing="ij")
    a = (i * 9 + j).reshape(-1)
    tq = np.stack([a, a + 1, a + 10, a + 9], -1) + len(cpos)
    pos = np.concatenate([cpos, tpos])
    uv = np.concatenate([cuv, tuv])
    quads = np.concatenate([cq, tq])
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    return (pos.astype(np.float32), _vertex_normals(pos, tris).astype(
        np.float32), uv.astype(np.float32), tris.astype(np.int32))


def rock_mesh():
    """A lumpy boulder of 40 x 76 quads, radius about 0.6, resting on the
    origin; returns (pos, nrm, uv, tris), 6,080 triangles."""
    def lumps(u):
        r = 0.6 * (1.0 + 0.12 * np.sin(5 * u[:, 0]) * np.sin(4 * u[:, 2])
                   + 0.06 * np.cos(9 * u[:, 1] + 2 * u[:, 0]))
        return u * r[:, None] * [1.0, 0.7, 1.0] + [0.0, 0.3, 0.0]

    pos, uv, quads = _lat_long(40, 76, lumps)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    return (pos.astype(np.float32), _vertex_normals(pos, tris).astype(
        np.float32), uv.astype(np.float32), tris.astype(np.int32))


def write_tris_ply(path: str, pos, nrm, uv, tris, comment: str) -> None:
    """A binary little-endian PLY of triangles with normals and uvs."""
    keys = ("x", "y", "z", "nx", "ny", "nz", "u", "v")
    table = np.zeros(len(pos), dtype=[(k, "<f4") for k in keys])
    for k, col in zip(keys, np.concatenate([pos, nrm, uv], 1).T):
        table[k] = col
    faces = np.zeros(len(tris), dtype=[("n", "u1"), ("i", "<i4", (3,))])
    faces["n"] = 3
    faces["i"] = tris
    props = "".join(f"property float {k}\n" for k in keys)
    header = (f"ply\nformat binary_little_endian 1.0\ncomment {comment}\n"
              f"element vertex {len(pos)}\n{props}element face {len(tris)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + table.tobytes() + faces.tobytes())


def tree_image(size: int) -> np.ndarray:
    """The tree's albedo: bark below v = 0.25 (rows of the bottom
    quarter), leaves above, both striped."""
    t = (np.arange(size) + 0.5) / size
    v, u = np.meshgrid(1.0 - t, t, indexing="ij")
    bark = np.stack([0.35 + 0.08 * np.sin(60 * u), 0.22 + 0.05 * np.sin(
        60 * u), 0.12 + 0 * u], -1)
    leaf = np.stack([0.12 + 0.1 * np.sin(40 * u + 30 * v) ** 2,
                     0.35 + 0.2 * np.cos(25 * u - 40 * v) ** 2,
                     0.08 + 0 * u], -1)
    return np.where((v < 0.25)[..., None], bark, leaf).clip(0, 1)


def rock_image(size: int) -> np.ndarray:
    """Granite: grey with dark and light speckles on a slow banding."""
    t = (np.arange(size) + 0.5) / size
    y, x = np.meshgrid(t, t, indexing="ij")
    band = 0.45 + 0.1 * np.sin(9 * x + 4 * np.sin(7 * y))
    speck = 0.12 * np.sign(np.sin(173 * x) * np.sin(157 * y + 3 * x))
    g = (band + speck).clip(0, 1)
    return np.stack([g, 0.95 * g, 0.9 * g], -1)


def _instance_block(obj: str, pos, yaw: float, scale) -> str:
    return (f"AttributeBegin\n"
            f"  Translate {pos[0]:.4f} {pos[1]:.4f} {pos[2]:.4f}\n"
            f"  Rotate {yaw:.3f} 0 1 0\n"
            f"  Scale {scale[0]:.4f} {scale[1]:.4f} {scale[2]:.4f}\n"
            f'  ObjectInstance "{obj}"\n'
            f"AttributeEnd\n")


def write_forest_scene(directory: str, grid: int = 256,
                       sky: tuple = (512, 256), trees: int = 64,
                       rocks: int = 24, seed: int = 11) -> str:
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    write_ground_ply(os.path.join(directory, "ground.ply"), grid)
    write_hdr(os.path.join(directory, "sky.hdr"), sky_image(*sky))
    write_tris_ply(os.path.join(directory, "tree.ply"), *tree_mesh(),
                   "tree")
    write_tris_ply(os.path.join(directory, "rock.ply"), *rock_mesh(),
                   "rock")
    write_tga(os.path.join(directory, "tree.tga"), tree_image(256))
    write_bmp(os.path.join(directory, "rock.bmp"), rock_image(256))
    # Trees in clusters of 4 whose crowns overlap, so that rays through a
    # cluster have more than 4 candidate boxes.
    blocks = []
    n_clusters = max(1, trees // 4)
    centres = np.stack([rng.uniform(-10, 10, n_clusters),
                        rng.uniform(-10, 4, n_clusters)], -1)
    for k in range(trees):
        cx, cz = centres[k % n_clusters] + rng.normal(0, 0.7, 2)
        s = rng.uniform(0.7, 1.3)
        blocks.append(_instance_block(
            "tree", (cx, _height(cx, cz) - 0.05, cz), rng.uniform(0, 360),
            (s, s * rng.uniform(0.85, 1.2), s)))
    for _ in range(rocks):
        cx, cz = rng.uniform(-10, 10), rng.uniform(-10, 6)
        s = rng.uniform(0.5, 1.2)
        blocks.append(_instance_block(
            "rock", (cx, _height(cx, cz) - 0.1, cz), rng.uniform(0, 360),
            (s * rng.uniform(0.8, 1.3), s, s * rng.uniform(0.8, 1.3))))
    blocks.append(_instance_block("lantern", (2.0, 2.2, 3.0), 30.0,
                                  (1, 1, 1)))
    forest = textwrap.dedent("""\
        LookAt 0 9 15  0 0 -2  0 1 0
        Camera "perspective" "float fov" [ 40 ]
        Film "image" "integer xresolution" [ 1280 ]
          "integer yresolution" [ 720 ]
        Sampler "halton" "integer pixelsamples" [ 8 ]
        Integrator "path" "integer maxdepth" [ 6 ]
        WorldBegin
        AttributeBegin
          Rotate -90 1 0 0
          LightSource "infinite" "string mapname" [ "sky.hdr" ]
            "rgb L" [ 1 1 1 ]
        AttributeEnd
        Texture "bark" "spectrum" "imagemap" "string filename" [ "tree.tga" ]
        Texture "granite" "spectrum" "imagemap"
          "string filename" [ "rock.bmp" ]
        AttributeBegin
          Material "matte" "rgb Kd" [ 0.35 0.32 0.22 ]
          Shape "plymesh" "string filename" [ "ground.ply" ]
        AttributeEnd
        ObjectBegin "tree"
          Material "matte" "texture Kd" "bark"
          Shape "plymesh" "string filename" [ "tree.ply" ]
        ObjectEnd
        ObjectBegin "rock"
          Material "plastic" "texture Kd" "granite" "float roughness" [ 0.3 ]
          Shape "plymesh" "string filename" [ "rock.ply" ]
        ObjectEnd
        ObjectBegin "lantern"
          Material "matte" "rgb Kd" [ 0.8 0.8 0.8 ]
          AreaLightSource "diffuse" "rgb L" [ 40 30 18 ]
          Shape "trianglemesh" "integer indices" [ 0 1 2  0 2 3 ]
            "point P" [ -0.3 0 -0.3  0.3 0 -0.3  0.3 0 0.3  -0.3 0 0.3 ]
        ObjectEnd
        """) + "".join(blocks) + "WorldEnd\n"
    path = os.path.join(directory, "forest.pbrt")
    with open(path, "w") as f:
        f.write(forest)
    return path


def write_mesh_scenes(directory: str) -> dict:
    """tree.obj (+ tree.mtl, tree.tga), tree.stl and tree.glb (+ tree.png);
    returns their paths by format."""
    os.makedirs(directory, exist_ok=True)
    pos, nrm, uv, tris = tree_mesh()
    write_tga(os.path.join(directory, "tree.tga"), tree_image(256))
    write_png(os.path.join(directory, "tree.png"), tree_image(256))
    paths = {k: os.path.join(directory, f"tree.{k}")
             for k in ("obj", "stl", "glb")}
    with open(os.path.join(directory, "tree.mtl"), "w") as f:
        f.write("newmtl tree\nKd 1 1 1\nmap_Kd tree.tga\n")
    lines = ["mtllib tree.mtl", "usemtl tree"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"vt {u:.6f} {v:.6f}" for u, v in uv]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in nrm]
    lines += ["f " + " ".join(f"{i}/{i}/{i}" for i in t + 1) for t in tris]
    with open(paths["obj"], "w") as f:
        f.write("\n".join(lines) + "\n")
    # Binary STL: 80-byte header, count, then normal, 3 vertices and an
    # attribute word a facet.
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]],
                  pos[tris[:, 2]] - pos[tris[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    rec = np.zeros(len(tris), dtype=[("n", "<f4", (3,)),
                                     ("v", "<f4", (3, 3)), ("a", "<u2")])
    rec["n"] = fn
    rec["v"] = pos[tris]
    with open(paths["stl"], "wb") as f:
        f.write(b"tree".ljust(80, b" ") + struct.pack("<I", len(tris)))
        f.write(rec.tobytes())
    _write_glb(paths["glb"], pos, nrm, uv, tris, "tree.png")
    return paths


def _write_glb(path, pos, nrm, uv, tris, image_uri):
    """A one-mesh binary glTF: positions, normals, TEXCOORD_0 (glTF's v
    points down) and uint32 indices in the BIN chunk, a material whose
    baseColorTexture is the image file image_uri."""
    parts = [pos, nrm, np.stack([uv[:, 0], 1.0 - uv[:, 1]], 1),
             tris.astype(np.uint32)]
    blob, views, accessors = b"", [], []
    for k, a in enumerate(parts):
        a = np.ascontiguousarray(a)
        views.append(dict(buffer=0, byteOffset=len(blob),
                          byteLength=a.nbytes))
        kind = "SCALAR" if k == 3 else ("VEC2" if k == 2 else "VEC3")
        acc = dict(bufferView=k, componentType=5125 if k == 3 else 5126,
                   count=a.size if k == 3 else len(a), type=kind)
        if k == 0:
            acc.update(min=a.min(0).tolist(), max=a.max(0).tolist())
        accessors.append(acc)
        blob += a.astype(a.dtype.newbyteorder("<")).tobytes()
    doc = dict(
        asset=dict(version="2.0"), scene=0, scenes=[dict(nodes=[0])],
        nodes=[dict(mesh=0)],
        meshes=[dict(primitives=[dict(
            attributes=dict(POSITION=0, NORMAL=1, TEXCOORD_0=2),
            indices=3, material=0)])],
        materials=[dict(name="tree", pbrMetallicRoughness=dict(
            baseColorTexture=dict(index=0), metallicFactor=0.0,
            roughnessFactor=0.8))],
        textures=[dict(source=0)], images=[dict(uri=image_uri)],
        buffers=[dict(byteLength=len(blob))], bufferViews=views,
        accessors=accessors)
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    with open(path, "wb") as f:
        f.write(b"glTF" + struct.pack("<II", 2, 20 + len(js) + len(blob)))
        f.write(struct.pack("<I", len(js)) + b"JSON" + js)
        f.write(struct.pack("<I", len(blob)) + b"BIN\0" + blob)


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "demo"
    kind = sys.argv[2] if len(sys.argv) > 2 else "env"
    if kind == "textured":
        print(write_textured_scene(out))
    elif kind == "tiff":
        scenes = write_textured_scene(out)
        retexture(scenes[0], write_tiff_textures(os.path.join(out, "tif")))
        print(scenes)
    elif kind == "small":
        scenes = write_textured_scene(out)
        paths = write_small_textures(os.path.join(out, "small"))
        retexture(scenes[0], {"albedo.png": paths["albedo.sgi"],
                              "leaf.png": paths["leaf.blp"]})
        print(scenes)
    elif kind == "small2":
        scenes = write_textured_scene(out)
        paths = write_small2_textures(os.path.join(out, "small2"))
        retexture(scenes[0], {"albedo.png": paths["albedo.ras"],
                              "leaf.png": paths["leaf.im"]})
        print(scenes)
    elif kind == "small3":
        scenes = write_textured_scene(out)
        write_small3_textures(os.path.join(out, "small3"))
        retexture(scenes[0], {"albedo.png": SMALL3_ALBEDO})
        print(scenes)
    elif kind == "forest":
        print(write_forest_scene(out))
    elif kind == "meshes":
        print(write_mesh_scenes(out))
    else:
        print(write_demo_scene(out))
