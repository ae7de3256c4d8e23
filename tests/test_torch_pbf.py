"""The port's .pbf reader and writer (scene/pbf.py, the reference's binary
scene format) against the JAX package's, and the .pbf branch of
load_scene.

Scenes: tests/test_torch_pbrt.py's (PLY meshes of three encodings, named
materials, area, infinite, distant and point lights; with and without
its two instances) and a small forest of utils/demo_scene.py (two
instanced objects with TGA and BMP image textures, an instanced emitter),
plus tests/test_pbf.py's hand-built SceneIRs.

Tolerances: none. write_pbf gives the same bytes in both packages for
the same scene file; each package reads the other's file to a SceneIR
equal field by field (arrays bit for bit); load_scene of a .pbf gives the
JAX package's leaves bit for bit; a render of the .pbf round trip equals
the render of the parsed scene to 1e-4 (tests/test_pbf.py's bound).
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu.scene import pbf as jax_pbf
from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
from tracerboy_tpu.scene.pbrt_parser import parse_pbrt as jax_parse
from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.scene import pbf as port_pbf
from tracerboy_tpu_torch.scene import types as ir
from tracerboy_tpu_torch.scene.compile import compile_scene, load_scene
from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
from tracerboy_tpu_torch.utils.demo_scene import write_forest_scene
from test_torch_instanced import assert_same, jax_tree
from test_torch_pbrt import INSTANCES, assert_same_ir, write_scene

torch.set_num_threads(2)

PACKAGES = {"jax": jax_pbf, "port": port_pbf}


def scene_file(tmp_path, which):
    if which == "pbrt":
        return write_scene(tmp_path)
    if which == "pbrt_instances":
        return write_scene(tmp_path, extra=INSTANCES)
    return write_forest_scene(str(tmp_path), grid=16, sky=(32, 16),
                              trees=4, rocks=2)


@pytest.mark.parametrize("which", ["pbrt", "pbrt_instances", "forest"])
def test_write_pbf_bytes_and_cross_reads(tmp_path, which):
    path = scene_file(tmp_path, which)
    jax_file, port_file = tmp_path / "jax.pbf", tmp_path / "port.pbf"
    jax_pbf.write_pbf(str(jax_file), jax_parse(path))
    port_pbf.write_pbf(str(port_file), parse_pbrt(path))
    assert jax_file.read_bytes() == port_file.read_bytes()
    assert_same_ir(jax_pbf.read_pbf(str(port_file)),
                   port_pbf.read_pbf(str(jax_file)))
    back = port_pbf.read_pbf(str(port_file))
    assert not back.instances       # read_pbf flattens the instances
    # Every triangle mesh, the instances' included (spheres and curves
    # are not written; triangle_count counts meshes only).
    assert back.triangle_count() == parse_pbrt(path).triangle_count() > 0


@pytest.mark.parametrize("which", ["pbrt_instances", "forest"])
def test_load_scene_of_a_pbf_matches_jax(tmp_path, which):
    path = scene_file(tmp_path, which)
    out = str(tmp_path / "scene.pbf")
    port_pbf.write_pbf(out, parse_pbrt(path))
    cs = load_scene(out, use_cache=False)
    ref = jax_load_scene(out, use_cache=False)
    assert not cs.has_instances and not ref.has_instances
    assert_same(jax_tree(ref), cs.as_numpy())


def test_render_of_the_round_trip_matches(tmp_path):
    """The scene without its point light: write_pbf, in both packages,
    writes a point light's position without the light's transform (its
    CTM), so a moved point light comes back elsewhere."""
    path = write_scene(tmp_path, lights=("infinite", "distant", "area"),
                       extra=INSTANCES)
    out = str(tmp_path / "scene.pbf")
    scene = parse_pbrt(path)
    # write_pbf keeps triangle meshes only: compare with the scene
    # without its spheres and curves.
    scene.shapes = [s for s in scene.shapes
                    if isinstance(s, ir.TriangleMeshIR)]
    for obj in scene.objects.values():
        obj.shapes = [s for s in obj.shapes
                      if isinstance(s, ir.TriangleMeshIR)]
    port_pbf.write_pbf(out, scene)
    r1 = Renderer(compile_scene(scene, film_size=(24, 24)), device="cpu")
    r1.render_sample(2)
    r2 = Renderer(out, film_size=(24, 24), device="cpu")
    r2.render_sample(2)
    img1 = r1.resolve_radiance().numpy()
    img2 = r2.resolve_radiance().numpy()
    assert img1.mean() > 0
    np.testing.assert_allclose(img1, img2, atol=1e-4)


# tests/test_pbf.py's cases, in both packages.

@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_counts_and_materials_survive(tmp_path, pkg):
    mod = PACKAGES[pkg]
    scene = (jax_parse if pkg == "jax" else parse_pbrt)(
        write_scene(tmp_path))
    p = str(tmp_path / "s.pbf")
    mod.write_pbf(p, scene)
    back = mod.read_pbf(p)
    meshes = sum(len(s.indices) for s in scene.all_shapes()
                 if type(s).__name__ == "TriangleMeshIR")
    assert back.triangle_count() == meshes > 0
    assert len(back.materials) >= len({s.material for s in back.shapes})
    assert back.film.xresolution == scene.film.xresolution
    np.testing.assert_allclose(back.camera.camera_to_world,
                               scene.camera.camera_to_world, atol=1e-6)
    assert back.camera.fov == pytest.approx(scene.camera.fov)
    emissive = [s for s in back.shapes if s.emission is not None]
    assert emissive and emissive[0].emission.max() > 1.0


def _types(pkg):
    if pkg == "port":
        return ir
    from tracerboy_tpu.scene import types
    return types


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_instances_round_trip(tmp_path, pkg):
    t = _types(pkg)
    scene = t.SceneIR()
    scene.materials["m"] = t.MaterialIR(name="m", type="matte",
                                        kd=np.full(3, 0.5, np.float32))
    tri = t.TriangleMeshIR(
        indices=np.array([[0, 1, 2]], np.int32),
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        material="m")
    scene.objects["obj"] = t.ObjectIR(name="obj", shapes=[tri])
    xf = np.eye(4, dtype=np.float32)
    xf[0, 3] = 5.0
    scene.instances.append(t.InstanceIR(object_name="obj", transform=xf))
    scene.instances.append(t.InstanceIR(object_name="obj",
                                        transform=np.eye(4)))
    p = str(tmp_path / "inst.pbf")
    PACKAGES[pkg].write_pbf(p, scene)
    back = PACKAGES[pkg].read_pbf(p)
    assert back.triangle_count() == 2
    xs = sorted(s.transform[0, 3] for s in back.shapes)
    assert xs == pytest.approx([0.0, 5.0])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_mix_and_glass_materials(tmp_path, pkg):
    t = _types(pkg)
    scene = t.SceneIR()
    scene.materials["g"] = t.MaterialIR(name="g", type="glass", index=1.6)
    scene.materials["d"] = t.MaterialIR(name="d", type="matte",
                                        kd=np.full(3, 0.3, np.float32))
    scene.materials["mx"] = t.MaterialIR(name="mx", type="mix",
                                         material0="g", material1="d",
                                         amount=0.3)
    scene.shapes.append(t.TriangleMeshIR(
        indices=np.array([[0, 1, 2]], np.int32),
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        material="mx"))
    p = str(tmp_path / "mix.pbf")
    PACKAGES[pkg].write_pbf(p, scene)
    back = PACKAGES[pkg].read_pbf(p)
    mx = back.materials[back.shapes[0].material]
    assert mx.type == "mix" and mx.amount == pytest.approx(0.3)
    m0 = back.materials[mx.material0]
    m1 = back.materials[mx.material1]
    assert {m0.type, m1.type} == {"glass", "matte"}
    glass = m0 if m0.type == "glass" else m1
    assert glass.index == pytest.approx(1.6)
