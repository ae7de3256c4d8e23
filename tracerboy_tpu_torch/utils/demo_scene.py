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
It returns the paths of env.pbrt and lit.pbrt. The scene depends on the
arguments only (no random numbers).
"""

from __future__ import annotations

import os
import textwrap

import numpy as np

from tracerboy_tpu_torch.core.image_io import write_hdr

EXTENT = 12.0     # the ground spans [-EXTENT, EXTENT] in x and z


def _height(x, z):
    return (0.35 * np.sin(0.45 * x) * np.cos(0.35 * z)
            + 0.15 * np.sin(1.3 * x + 0.7 * z))


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
    verts = np.zeros(n * n, dtype=[(k, "<f4") for k in
                                   ("x", "y", "z", "nx", "ny", "nz", "u",
                                    "v")])
    for key, val in (("x", x), ("y", y), ("z", z), ("nx", nrm[..., 0]),
                     ("ny", nrm[..., 1]), ("nz", nrm[..., 2]), ("u", u),
                     ("v", v)):
        verts[key] = val.reshape(-1)
    i, j = np.meshgrid(np.arange(grid), np.arange(grid), indexing="xy")
    a = (j * n + i).reshape(-1)
    # Counter-clockwise seen from above (+y).
    quads = np.stack([a, a + n, a + n + 1, a + 1], -1).astype("<i4")
    faces = np.zeros(grid * grid, dtype=[("n", "u1"), ("i", "<i4", (4,))])
    faces["n"] = 4
    faces["i"] = quads
    header = textwrap.dedent(f"""\
        ply
        format binary_little_endian 1.0
        comment height field, {grid}x{grid} quads
        element vertex {n * n}
        property float x
        property float y
        property float z
        property float nx
        property float ny
        property float nz
        property float u
        property float v
        element face {grid * grid}
        property list uchar int vertex_indices
        end_header
        """).encode("ascii")
    with open(path, "wb") as f:
        f.write(header)
        f.write(verts.tobytes())
        f.write(faces.tobytes())
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


if __name__ == "__main__":
    import sys

    print(write_demo_scene(sys.argv[1] if len(sys.argv) > 1 else "demo"))
