"""The port's mesh importers (scene/mesh_import.py: OBJ with MTL, ASCII
and binary STL, glTF and .glb) and the mesh branch of load_scene against
the JAX package's.

Cases: tests/test_scene.py's (an OBJ quad with an MTL, a one-facet
binary STL, its glTF quad, embedded and binary), an ASCII STL, and the
tree of utils/demo_scene.py's `meshes` (16,128 triangles as .obj with a
TGA map_Kd, binary .stl, and .glb with a PNG baseColorTexture beside
it).

Tolerances: none for ingestion (SceneIR field by field, arrays bit for
bit; compiled leaves bit for bit). The renders of the glTF quad through
load_scene and Renderer: tests/test_torch_renderer.py's, accum |d| <=
1e-3 (1 + |ref|) on >= 99% of pixels and its mean to 1e-4 relative.
"""

import struct

import numpy as np
import pytest
import torch

from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
from tracerboy_tpu.scene.mesh_import import import_mesh_scene as jax_import
from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.scene.compile import load_scene
from tracerboy_tpu_torch.scene.mesh_import import import_mesh_scene
from tracerboy_tpu_torch.utils.demo_scene import write_mesh_scenes
from test_torch_cut_wave import assert_accum_matches
from test_torch_instanced import assert_same, jax_tree
from test_torch_pbrt import assert_same_ir
import tests.test_scene as jax_scene_tests

torch.set_num_threads(2)


def obj_quad(tmp_path):
    (tmp_path / "m.mtl").write_text("newmtl red\nKd 0.8 0.1 0.1\nNs 20\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "usemtl red\nf 1 2 3\nf 2 4 3\n")
    return str(tmp_path / "m.obj")


def stl_binary(tmp_path):
    tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    buf = b"\0" * 80 + struct.pack("<I", 1)
    buf += np.zeros(3, np.float32).tobytes()
    buf += tris[0].astype("<f4").tobytes() + b"\0\0"
    (tmp_path / "t.stl").write_bytes(buf)
    return str(tmp_path / "t.stl")


def stl_ascii(tmp_path):
    (tmp_path / "a.stl").write_text(
        "solid a\n facet normal 0 0 1\n  outer loop\n   vertex 0 0 0\n"
        "   vertex 1 0 0\n   vertex 0 1 0\n  endloop\n endfacet\n"
        " facet normal 0 0 1\n  outer loop\n   vertex 1 0 0\n"
        "   vertex 1 1 0\n   vertex 0 1 0\n  endloop\n endfacet\n"
        "endsolid a\n")
    return str(tmp_path / "a.stl")


def gltf_quad(tmp_path, binary):
    return jax_scene_tests.TestGLTF._quad_gltf(tmp_path, binary)


CASES = {
    "obj": obj_quad,
    "stl_binary": stl_binary,
    "stl_ascii": stl_ascii,
    "gltf": lambda p: gltf_quad(p, False),
    "glb": lambda p: gltf_quad(p, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_matches_jax(tmp_path, case):
    path = CASES[case](tmp_path)
    scene = import_mesh_scene(path)
    assert_same_ir(jax_import(path), scene)
    assert scene.camera is not None and scene.lights
    assert scene.triangle_count() == (1 if case == "stl_binary" else 2)


def test_tests_scene_facts(tmp_path):
    """tests/test_scene.py's checks on the port's importers."""
    scene = import_mesh_scene(obj_quad(tmp_path))
    assert scene.materials["red"].kd[0] == pytest.approx(0.8)
    scene = import_mesh_scene(gltf_quad(tmp_path, True))
    mesh = scene.shapes[0]
    assert mesh.positions[:, 0].min() == pytest.approx(2.0)
    assert mesh.positions[:, 0].max() == pytest.approx(4.0)
    assert mesh.uvs[0, 1] == pytest.approx(1.0)
    m = scene.materials["redmetal"]
    assert m.type == "disney" and m.metallic == 1.0
    assert m.color[0] == pytest.approx(0.8)


@pytest.mark.parametrize("kind", ["obj", "stl", "glb"])
def test_demo_tree_loads_like_jax(tmp_path, kind):
    """The meshes scene through load_scene: the SceneIR and every compiled
    leaf equal the JAX package's (the TGA and PNG textures decoded by the
    port's readers, the JAX package's through PIL)."""
    path = write_mesh_scenes(str(tmp_path))[kind]
    assert_same_ir(jax_import(path), import_mesh_scene(path))
    cs = load_scene(path, use_cache=False)
    ref = jax_load_scene(path, use_cache=False)
    assert cs.num_tris >= 16128
    assert_same(jax_tree(ref), cs.as_numpy())
    if kind != "stl":
        assert cs.tex_images.shape[1:3] == (256, 256)


def test_gltf_render_matches_jax(tmp_path):
    from tracerboy_tpu import Renderer as JaxRenderer

    path = gltf_quad(tmp_path, True)
    ref = JaxRenderer(path, film_size=(16, 16))
    ref.render_sample(2)
    r = Renderer(path, film_size=(16, 16), device="cpu")
    assert r.traversal == "brute"
    r.render_sample(2)
    acc = r.state.accum.numpy()
    assert_accum_matches(acc, np.asarray(ref.state.accum))
    img = r.resolve_radiance().numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01


def test_gltf_jpeg_texture_still_raises(tmp_path):
    """A glTF whose baseColorTexture is a JPEG compiles as the JAX
    load_scene compiles it, leaves bit for bit; with a 4-byte fake JPEG
    both packages raise OSError."""
    import json

    from PIL import Image

    path = gltf_quad(tmp_path, False)
    doc = json.loads(open(path).read())
    pbr = doc["materials"][0]["pbrMetallicRoughness"]
    pbr["baseColorTexture"] = {"index": 0}
    pbr["metallicFactor"] = 0.0     # uber, which reads the texture
    doc["textures"] = [{"source": 0}]
    doc["images"] = [{"uri": "wood.jpg"}]
    with open(path, "w") as f:
        json.dump(doc, f)
    wood = np.random.default_rng(1).integers(0, 256, (24, 40, 3), np.uint8)
    Image.fromarray(wood).save(tmp_path / "wood.jpg", quality=85)
    got = load_scene(path, use_cache=False)
    assert_same(jax_tree(jax_load_scene(path, use_cache=False)),
                got.as_numpy())
    assert got.tex_images.shape[0] > 0
    (tmp_path / "wood.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    for load in (load_scene, jax_load_scene):
        with pytest.raises(OSError):
            load(path, use_cache=False)
