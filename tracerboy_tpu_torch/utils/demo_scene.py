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
and adds a distant light. It returns the paths of both.

The scenes depend on the arguments only (no random numbers). Run as
  python -m tracerboy_tpu_torch.utils.demo_scene DIR [textured]
"""

from __future__ import annotations

import os
import textwrap

import numpy as np

from tracerboy_tpu_torch.core.image_io import write_hdr, write_png

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


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "demo"
    if sys.argv[2:] == ["textured"]:
        print(write_textured_scene(out))
    else:
        print(write_demo_scene(out))
