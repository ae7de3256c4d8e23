"""PBRT ingestion of the port (scene/pbrt_parser.py, ply.py, curves.py,
volume.py, and the PBRT half of scene/compile.py) against the JAX
package's, on scene files written to tmp_path.

The scenes reach every directive the parser takes: Include,
AttributeBegin/End, TransformBegin/End, ObjectBegin/End and
ObjectInstance, ReverseOrientation, MakeNamedMaterial/NamedMaterial,
Texture, AreaLightSource, LightSource infinite (mapname .hdr, .pfm, .exr
or none), distant and point, trianglemesh, plymesh (ASCII, binary little-
and big-endian), sphere, curve and MakeNamedMedium.

Tolerances: none. The SceneIR equals the JAX parser's field by field
(arrays bit for bit), and every leaf of the compiled scene equals the JAX
package's load_scene(path, use_cache=False).as_pytree(pack_pallas=True)
bit for bit (as tests/test_torch_scene.py holds the procedural scenes).
"""

import dataclasses
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
from tracerboy_tpu.scene.pbrt_parser import parse_pbrt as jax_parse
from tracerboy_tpu_torch.core.image_io import write_exr, write_hdr, write_pfm
from tracerboy_tpu_torch.scene import types as ir
from tracerboy_tpu_torch.scene.compile import load_scene
from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
from tracerboy_tpu_torch.utils.demo_scene import sky_image, write_ground_ply
from test_torch_scene import _assert_same_leaves

torch.set_num_threads(2)

FILM = (24, 18)

HEADER = """\
LookAt 0 3 8  0 0.5 0  0 1 0
Camera "perspective" "float fov" [ 45 ]
Film "image" "integer xresolution" [ 40 ] "integer yresolution" [ 30 ]
Sampler "halton" "integer pixelsamples" [ 4 ]
Integrator "path" "integer maxdepth" [ 5 ]
WorldBegin
"""

LIGHTS = {
    "infinite": """\
AttributeBegin
  Rotate -90 1 0 0
  LightSource "infinite" {map} "rgb L" [ 0.8 0.9 1 ]
    "rgb scale" [ 1.5 1.5 1.5 ]
AttributeEnd
""",
    "distant": """\
LightSource "distant" "point from" [ 0 4 1 ] "point to" [ 0 0 0 ]
  "rgb L" [ 3 3 3 ]
""",
    "point": """\
TransformBegin
  Translate 1 3 0
  LightSource "point" "point from" [ 0 0.5 0 ] "rgb I" [ 5 5 5 ]
TransformEnd
""",
    "area": """\
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 4 4 4 ]
  Material "matte" "rgb Kd" [ 0 0 0 ]
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point P" [ -0.5 4 -0.5  0.5 4 -0.5  0.5 4 0.5  -0.5 4 0.5 ]
AttributeEnd
""",
}

GEOMETRY = """\
Texture "checks" "spectrum" "checkerboard" "float uscale" [ 8 ]
  "float vscale" [ 8 ] "rgb tex1" [ 0.1 0.1 0.1 ] "rgb tex2" [ 0.9 0.9 0.9 ]
Texture "scaled" "spectrum" "scale" "texture tex1" "checks"
  "rgb tex2" [ 0.5 0.8 0.5 ]
MakeNamedMaterial "floor" "string type" [ "matte" ] "texture Kd" "scaled"
MakeNamedMaterial "chrome" "string type" [ "metal" ] "float roughness" [ 0.1 ]
AttributeBegin
  NamedMaterial "floor"
  Shape "plymesh" "string filename" [ "ground_le.ply" ]
AttributeEnd
AttributeBegin
  Translate 0 0 -3
  Rotate 30 0 1 0
  Material "plastic" "rgb Kd" [ 0.2 0.3 0.7 ] "rgb Ks" [ 0.4 0.4 0.4 ]
  Shape "plymesh" "string filename" [ "block_be.ply" ]
AttributeEnd
AttributeBegin
  Translate -2 0 0
  Material "matte" "rgb Kd" [ 0.7 0.3 0.2 ]
  Shape "plymesh" "string filename" [ "block_ascii.ply" ]
AttributeEnd
AttributeBegin
  NamedMaterial "chrome"
  Translate 0 1 0
  Scale 0.7 0.7 0.7
  Shape "sphere" "float radius" [ 1 ]
AttributeEnd
AttributeBegin
  Translate 2 1 0
  ReverseOrientation
  Material "glass" "float index" [ 1.45 ]
  Shape "sphere" "float radius" [ 0.6 ]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [ 0.9 0.8 0.1 ]
  Shape "curve" "point P" [ -1 0 1  -0.5 2 1.5  0.5 2 0.5  1 0 1 ]
    "float width0" [ 0.1 ] "float width1" [ 0.02 ]
AttributeEnd
"""

INSTANCES = """\
ObjectBegin "post"
  Material "matte" "rgb Kd" [ 0.5 0.5 0.5 ]
  Shape "sphere" "float radius" [ 0.3 ]
ObjectEnd
AttributeBegin
  Translate 3 0.3 2
  ObjectInstance "post"
AttributeEnd
AttributeBegin
  Translate -3 0.3 2
  ObjectInstance "post"
AttributeEnd
"""

MEDIUM = """\
MakeNamedMedium "smoke" "string type" [ "heterogeneous" ]
  "integer nx" [ 2 ] "integer ny" [ 2 ] "integer nz" [ 2 ]
  "float density" [ 0 0.1 0.2 0.3 0.4 0.5 0.6 0.7 ]
  "point p0" [ -1 0 -1 ] "point p1" [ 1 2 1 ] "rgb sigma_a" [ 0.2 0.2 0.2 ]
  "rgb sigma_s" [ 1 1 1 ] "float scale" [ 2 ] "float g" [ 0.3 ]
"""


def _block(seed):
    """A closed box of 12 triangles, jittered by a seed."""
    rng = np.random.default_rng(seed)
    p = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (0, 1)
                  for z in (-0.5, 0.5)], np.float32)
    p += rng.normal(scale=0.02, size=p.shape).astype(np.float32)
    f = np.array([[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6],
                  [0, 2, 6, 4], [1, 5, 7, 3]])
    return p, f


def write_ply_binary_be(path, seed):
    """Big-endian, triangles (quads split), no normals or uvs."""
    p, f = _block(seed)
    tri = np.concatenate([f[:, [0, 1, 2]], f[:, [0, 2, 3]]])
    faces = np.zeros(len(tri), dtype=[("n", "u1"), ("i", ">i4", (3,))])
    faces["n"], faces["i"] = 3, tri
    head = (f"ply\nformat binary_big_endian 1.0\nelement vertex {len(p)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(tri)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    Path(path).write_bytes(head.encode() + p.astype(">f4").tobytes()
                           + faces.tobytes())


def write_ply_ascii(path, seed):
    """ASCII quads with per-vertex normals and s/t coordinates."""
    p, f = _block(seed)
    n = p - p.mean(0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    lines = ["ply", "format ascii 1.0", f"element vertex {len(p)}",
             *(f"property float {k}" for k in ("x", "y", "z", "nx", "ny",
                                                "nz", "s", "t")),
             f"element face {len(f)}",
             "property list uchar int vertex_indices", "end_header"]
    for k in range(len(p)):
        st = (k % 2, k // 4)
        lines.append(" ".join(f"{v:.6f}" for v in (*p[k], *n[k], *st)))
    lines += [f"4 {' '.join(map(str, q))}" for q in f]
    Path(path).write_text("\n".join(lines) + "\n")


def write_env_map(path):
    img = sky_image(32, 16)
    ext = Path(path).suffix
    {".hdr": write_hdr, ".pfm": write_pfm, ".exr": write_exr}[ext](
        str(path), img)


def write_scene(tmp_path, lights=("infinite", "distant", "point", "area"),
                mapname="sky.hdr", extra="", name="scene.pbrt"):
    write_ground_ply(tmp_path / "ground_le.ply", 24)
    write_ply_binary_be(tmp_path / "block_be.ply", 1)
    write_ply_ascii(tmp_path / "block_ascii.ply", 2)
    if mapname:
        write_env_map(tmp_path / mapname)
    (tmp_path / "geometry.pbrt").write_text(GEOMETRY)
    mp = f'"string mapname" [ "{mapname}" ]' if mapname else ""
    body = "".join(LIGHTS[k].format(map=mp) for k in lights)
    text = (HEADER + body + 'Include "geometry.pbrt"\n' + extra
            + "WorldEnd\n")
    (tmp_path / name).write_text(textwrap.dedent(text))
    return str(tmp_path / name)


def assert_same_ir(ref, got, path="scene"):
    """Field by field: dataclasses, dicts, lists, arrays bit for bit."""
    if dataclasses.is_dataclass(ref):
        assert type(ref).__name__ == type(got).__name__, path
        for f in dataclasses.fields(ref):
            assert_same_ir(getattr(ref, f.name), getattr(got, f.name),
                           f"{path}.{f.name}")
    elif isinstance(ref, dict):
        assert list(ref) == list(got), path
        for k in ref:
            assert_same_ir(ref[k], got[k], f"{path}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), path
        for k, (a, b) in enumerate(zip(ref, got)):
            assert_same_ir(a, b, f"{path}[{k}]")
    elif isinstance(ref, np.ndarray) or isinstance(got, np.ndarray):
        a, b = np.asarray(ref), np.asarray(got)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(ref) is type(got) and ref == got, (path, ref, got)


def _jax_leaves(path):
    tree = jax_load_scene(path, use_cache=False, film_size=FILM).as_pytree(
        pack_pallas=True)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("extra", ["", "instances", "medium"])
def test_scene_ir_matches_jax_field_by_field(tmp_path, extra):
    path = write_scene(tmp_path, extra={"": "", "instances": INSTANCES,
                                        "medium": MEDIUM}[extra])
    ref, got = jax_parse(path), parse_pbrt(path)
    assert_same_ir(ref, got)
    assert len(got.shapes) == 7 and len(got.lights) == 3
    if extra == "instances":
        assert len(got.instances) == 2 and "post" in got.objects
    if extra == "medium":
        assert got.volume is not None and got.volume.density.shape == (2,
                                                                       2, 2)


@pytest.mark.parametrize("mapname", ["sky.hdr", "sky.pfm", "sky.exr", ""])
def test_compiled_scene_matches_jax_bit_for_bit(tmp_path, mapname):
    path = write_scene(tmp_path, mapname=mapname)
    got = load_scene(path, film_size=FILM)
    _assert_same_leaves(_jax_leaves(path), got.as_numpy())
    assert got.has_env and (got.film_width, got.film_height) == FILM
    assert got.env_map.shape == ((16, 32, 3) if mapname else (1, 1, 3))
    # 2 area triangles, the distant light, the point light's quad.
    assert got.num_lights == 5
    assert list(got.lights["ltype"]) == [0, 0, 1, 0, 0]


@pytest.mark.parametrize("lights", [("infinite",), ("distant",), ("point",),
                                    ("area",), ("point", "infinite")])
def test_each_light_type_matches_jax(tmp_path, lights):
    path = write_scene(tmp_path, lights=lights)
    got = load_scene(path)
    _assert_same_leaves(_jax_leaves(path), got.as_numpy())
    assert got.has_env == ("infinite" in lights)
    assert (got.film_width, got.film_height) == (40, 30)


def test_missing_env_map_warns_and_shades_white(tmp_path):
    path = write_scene(tmp_path, lights=("infinite",), mapname="")
    text = Path(path).read_text().replace(
        'LightSource "infinite"',
        'LightSource "infinite" "string mapname" [ "absent.hdr" ]')
    Path(path).write_text(text)
    with pytest.warns(UserWarning, match="env map not found"):
        got = load_scene(path)
    assert got.env_map.shape == (1, 1, 3) and (got.env_map == 1).all()


@pytest.mark.parametrize("what,item", [
    ("instances", "22b"), ("png_map", "22b"), ("image_texture", "22b")])
def test_unported_pbrt_features_raise(tmp_path, what, item):
    """A JPEG imagemap inside an instanced object, a JPEG `infinite`
    mapname and a JPEG imagemap load as the JAX load_scene loads them,
    compiled leaves bit for bit; a 4-byte fake JPEG in their place raises
    OSError in both packages."""
    from PIL import Image

    from test_torch_instanced import assert_same, jax_tree

    name = "sky.jpg" if what == "png_map" else "wood.jpg"
    if what == "instances":
        extra = INSTANCES.replace(
            'Material "matte" "rgb Kd" [ 0.5 0.5 0.5 ]',
            'Texture "wood" "spectrum" "imagemap" "string filename" '
            '[ "wood.jpg" ]\n  Material "matte" "texture Kd" "wood"')
        assert extra != INSTANCES
        path = write_scene(tmp_path, extra=extra)
    elif what == "png_map":
        path = write_scene(tmp_path, lights=("infinite",), mapname="")
        text = Path(path).read_text().replace(
            'LightSource "infinite"',
            'LightSource "infinite" "string mapname" [ "sky.jpg" ]')
        Path(path).write_text(text)
    else:
        path = write_scene(tmp_path, lights=("distant",), extra="""\
Texture "wood" "spectrum" "imagemap" "string filename" [ "wood.jpg" ]
Material "matte" "texture Kd" "wood"
Shape "sphere" "float radius" [ 0.2 ]
""")
    img = np.random.default_rng(2).integers(0, 256, (16, 32, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / name, quality=80)
    got = load_scene(path, use_cache=False)
    assert_same(jax_tree(jax_load_scene(path, use_cache=False)),
                got.as_numpy())
    (tmp_path / name).write_bytes(b"\xff\xd8\xff\xe0")
    for load in (load_scene, jax_load_scene):
        with pytest.raises(OSError):
            load(path, use_cache=False)


def test_heterogeneous_medium_compiles_like_jax(tmp_path):
    """A MakeNamedMedium "heterogeneous" block compiles into the scene's
    volume (scale folded into sigma_a and sigma_s), every leaf as the JAX
    package builds it, the volume's stencil table and MIS areas too."""
    path = write_scene(tmp_path, extra=MEDIUM)
    got = load_scene(path)
    assert got.has_volume and got.vol_density.shape == (2, 2, 2)
    np.testing.assert_array_equal(got.vol_sigma_a,
                                  np.float32([0.2, 0.2, 0.2]) * 2)
    assert got.vol_g == pytest.approx(0.3)
    leaves = got.as_numpy()
    assert {"vol_oct", "vol_majorant", "tri_area", "pk_tri_area"} <= set(
        leaves)
    _assert_same_leaves(_jax_leaves(path), leaves)


def test_demo_scene_parses_like_jax(tmp_path):
    """utils/demo_scene.py at a small grid: both files (lit.pbrt includes
    env.pbrt) compile as the JAX package compiles them."""
    from tracerboy_tpu_torch.utils.demo_scene import write_demo_scene

    env, lit = write_demo_scene(str(tmp_path), grid=16, sky=(32, 16))
    for path, lights in ((env, 0), (lit, 3)):
        got = load_scene(path, film_size=FILM)
        _assert_same_leaves(_jax_leaves(path), got.as_numpy())
        assert got.num_lights == lights and got.has_env
        # The ground, three 960-triangle spheres, the curve's 18.
        assert got.num_tris == 2 * 16 * 16 + 3 * 960 + 18


def test_ply_readers_match_jax(tmp_path):
    from tracerboy_tpu.scene.ply import read_ply as jax_read
    from tracerboy_tpu_torch.scene.ply import read_ply

    write_ground_ply(tmp_path / "le.ply", 5)
    write_ply_binary_be(tmp_path / "be.ply", 3)
    write_ply_ascii(tmp_path / "a.ply", 4)
    for name in ("le.ply", "be.ply", "a.ply"):
        ref, got = jax_read(str(tmp_path / name)), read_ply(
            str(tmp_path / name))
        assert_same_ir(list(ref), list(got), name)
    pos, idx, nrm, uv = read_ply(str(tmp_path / "le.ply"))
    assert idx.shape == (2 * 25, 3) and nrm is not None and uv is not None


@pytest.mark.parametrize("seed", range(3))
def test_curve_tessellation_matches_jax(seed):
    from tracerboy_tpu.scene.curves import tessellate_curve as jax_tess
    from tracerboy_tpu_torch.scene.curves import tessellate_curve

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(4 + 3 * seed, 3)).astype(np.float32)
    ref = jax_tess(pts, 0.1, 0.03)
    got = tessellate_curve(pts, 0.1, 0.03)
    assert_same_ir(list(ref), list(got))


def test_parse_lights_and_shapes_are_typed(tmp_path):
    got = parse_pbrt(write_scene(tmp_path))
    kinds = [type(s).__name__ for s in got.shapes]
    assert kinds.count("SphereIR") == 2 and kinds.count("CurveIR") == 1
    assert [type(x) for x in got.lights] == [
        ir.InfiniteLightIR, ir.DistantLightIR, ir.PointLightIR]
    glass = [s for s in got.shapes if isinstance(s, ir.SphereIR)][1]
    assert glass.reverse_orientation
