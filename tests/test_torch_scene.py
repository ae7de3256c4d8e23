"""Scene ingestion of the PyTorch port against the JAX package.

The port carries a jax-free numpy copy of scene compilation and BVH
packing; every leaf it builds must equal the JAX package's
CompiledScene.as_pytree(pack_pallas=True) in shape, dtype and value, bit
for bit. The JAX side here loads the committed native/libtbbvh.so, the
port compiles native/bvh_builder.cpp with the same flags: equal packed
tables show the two builds give the same trees.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tracerboy_tpu.scene.compile import load_scene as jax_load_scene
from tracerboy_tpu_torch.scene.compile import (
    from_jax_pytree,
    load_scene as torch_load_scene,
)

torch.set_num_threads(2)

SCENES = ["shadertoy:cornell", "shadertoy"]
FILM = (32, 24)


def _jax_leaves(name):
    tree = jax_load_scene(name, film_size=FILM).as_pytree(pack_pallas=True)
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_leaves(ref, got, path=""):
    assert set(ref) == set(got), (path, set(ref) ^ set(got))
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_same_leaves(ref[k], got[k], f"{path}{k}.")
            continue
        a = np.asarray(ref[k])
        b = got[k]
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype, (path + k, a.dtype, b.dtype)
        assert a.shape == b.shape, (path + k, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), f"{path}{k} differs"


@pytest.mark.parametrize("name", SCENES)
def test_ingestion_matches_jax_bit_for_bit(name):
    ref = _jax_leaves(name)
    port = torch_load_scene(name, film_size=FILM)
    _assert_same_leaves(ref, port.as_numpy())
    _assert_same_leaves(ref, port.as_tensors("cpu"))


@pytest.mark.parametrize("name,env", [
    ("shadertoy", {"TB_CUT": "1", "TB_BINNED": "1"}),
    ("shadertoy", {"TB_CUT": "1", "TB_CUT_TRIS": "2048"}),
    ("shadertoy:cornell", {"TB_CUT": "1", "TB_BINNED": "1"}),
])
def test_opt_in_tables_match_jax_bit_for_bit(monkeypatch, name, env):
    """The cut tables (above 2048 triangles) and the binned tables, built
    when the environment asks for them, as the JAX package gates them."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ref = _jax_leaves(name)
    got = torch_load_scene(name, film_size=FILM).as_numpy()
    _assert_same_leaves(ref, got)
    big = name == "shadertoy"
    assert ("pk_cut_top" in got) == big and ("pk_sh_cut_roots" in got) == big
    assert ("bn_mot" in got) == ("TB_BINNED" in env)


@pytest.mark.parametrize("name", SCENES)
def test_from_jax_pytree_gives_the_ports_tensors(name):
    ref = _jax_leaves(name)
    carried = from_jax_pytree(ref, "cpu")
    _assert_same_leaves(ref, carried)
    assert carried["pk_nodes"].dtype == torch.int32
    assert carried["tri_shadow_opaque"].dtype == torch.bool


def test_benchmark_scene_takes_the_kernel_path():
    """The benchmark scene is above the brute-force cutoff; cornell is
    below it."""
    from tracerboy_tpu_torch.renderer import Renderer

    big = torch_load_scene("shadertoy", film_size=FILM)
    small = torch_load_scene("shadertoy:cornell", film_size=FILM)
    assert big.tri_v0.shape[0] > 2048
    assert Renderer._pick_traversal(big) == "kernel"
    assert Renderer._pick_traversal(small) == "brute"


def _write_jpeg(path, seed):
    from PIL import Image

    img = np.random.default_rng(seed).integers(0, 256, (16, 24, 3), np.uint8)
    Image.fromarray(img).save(path, quality=85)


@pytest.mark.parametrize("path", ["scene.pbf", "mesh.obj"])
def test_unported_scene_files_raise(path, tmp_path):
    """A .pbf scene and an OBJ whose MTL names a JPEG texture load as the
    JAX load_scene loads them, compiled leaves bit for bit; with a 4-byte
    fake JPEG both packages raise OSError."""
    from test_torch_instanced import assert_same, jax_tree

    _write_jpeg(tmp_path / "wood.jpg", 3)
    if path.endswith(".obj"):
        (tmp_path / "m.mtl").write_text("newmtl wood\nmap_Kd wood.jpg\n")
        (tmp_path / path).write_text(
            "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\n"
            "vt 0 1\nusemtl wood\nf 1/1 2/2 3/3\n")
        path = str(tmp_path / path)
    elif path.endswith(".pbf"):
        from tracerboy_tpu_torch.scene import types as ir
        from tracerboy_tpu_torch.scene.pbf import write_pbf
        from tracerboy_tpu_torch.scene.procedural import _cornell_scene

        scene = _cornell_scene()
        scene.textures["img"] = ir.TextureIR(name="img", type="imagemap",
                                             filename="wood.jpg")
        scene.materials["wall"].map_kd = "img"
        write_pbf(str(tmp_path / path), scene)
        path = str(tmp_path / path)
    got = torch_load_scene(path, use_cache=False)
    assert_same(jax_tree(jax_load_scene(path, use_cache=False)),
                got.as_numpy())
    (tmp_path / "wood.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    for load in (torch_load_scene, jax_load_scene):
        with pytest.raises(OSError):
            load(path, use_cache=False)


@pytest.mark.parametrize("keys", ["g_only", "full"])
def test_cache_with_volume_keys_loads(keys, tmp_path):
    """A compiled .npz with vol.* keys loads as the JAX package's
    load_compiled reads it: a grid makes a volume scene, a lone vol.g
    none."""
    from tracerboy_tpu.scene.compile import load_compiled as jax_load
    from tracerboy_tpu_torch.scene.compile import save_compiled

    path = tmp_path / "cache.npz"
    save_compiled(str(path), torch_load_scene("shadertoy:cornell",
                                              film_size=FILM))
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    flat["vol.g"] = np.asarray(0.25)
    if keys == "full":
        flat["vol.density"] = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
        flat["vol.lo"] = np.zeros(3, np.float32)
        flat["vol.hi"] = np.ones(3, np.float32)
        flat["vol.sigma_a"] = np.full(3, 0.5, np.float32)
        flat["vol.sigma_s"] = np.full(3, 2.0, np.float32)
    np.savez(path, **flat)
    got, want = torch_load_scene(str(path)), jax_load(str(path))
    assert got.has_volume == want.has_volume == (keys == "full")
    assert got.vol_g == want.vol_g == 0.25
    if keys == "full":
        np.testing.assert_array_equal(got.vol_density, want.vol_density)
        assert got.as_numpy()["vol_oct"].shape == (8, 8)


def test_volume_scene_compiles_like_jax():
    """scene.volume (a PBRT MakeNamedMedium, or Renderer(volume=)) compiles
    into the JAX package's volume fields and leaves."""
    from tracerboy_tpu.scene.compile import compile_scene as jax_compile
    from tracerboy_tpu.scene.procedural import _cornell_scene as jax_cornell
    from tracerboy_tpu.scene.volume import procedural_cloud as jax_cloud
    from tracerboy_tpu_torch.scene.compile import compile_scene
    from tracerboy_tpu_torch.scene.procedural import _cornell_scene
    from tracerboy_tpu_torch.scene.volume import procedural_cloud

    s, js = _cornell_scene(), jax_cornell()
    s.volume, js.volume = procedural_cloud(8), jax_cloud(8)
    got, want = compile_scene(s), jax_compile(js)
    assert got.has_volume and want.has_volume
    leaves, ref = got.as_numpy(), want.as_pytree(pack_pallas=True)
    for key in ("vol_density", "vol_oct", "vol_dims", "vol_majorant",
                "vol_g", "tri_area", "pk_tri_area"):
        np.testing.assert_array_equal(leaves[key], np.asarray(ref[key]),
                                      err_msg=key)


def test_import_leaves_jax_out():
    code = ("import sys, tracerboy_tpu_torch\n"
            "from tracerboy_tpu_torch.trace import (wavefront, traverse,\n"
            "                                       cut, binned)\n"
            "from tracerboy_tpu_torch.post import pipeline\n"
            "from tracerboy_tpu_torch.app import cli\n"
            "from tracerboy_tpu_torch.scene import pbrt_parser, volume\n"
            "from tracerboy_tpu_torch.core import image_io, piz\n"
            "from tracerboy_tpu_torch.utils import checkpoint, demo_scene\n"
            "from tracerboy_tpu_torch.scene import compile, textures\n"
            "from tracerboy_tpu_torch.scene import pbf, mesh_import\n"
            "from tracerboy_tpu_torch.trace import instanced\n"
            "from tracerboy_tpu_torch.shade import volumetric\n"
            "from tracerboy_tpu_torch.scene import vdb\n"
            "from tracerboy_tpu_torch.core import filters\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m.startswith('tracerboy_tpu.')\n"
            "             or m == 'tracerboy_tpu'\n"
            "             or m == 'PIL' or m.startswith('PIL.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("feature", ["instance", "light",
                                     "image_texture"])
def test_unported_scene_features_raise(feature, tmp_path):
    """compile_scene of the cornell scene with a JPEG texture on an
    instanced object, a JPEG environment map, or a JPEG image texture
    gives the JAX compile_scene's leaves bit for bit; with a 4-byte fake
    JPEG both packages raise OSError."""
    from tracerboy_tpu.scene import procedural as jax_procedural
    from tracerboy_tpu.scene import types as jax_ir
    from tracerboy_tpu.scene.compile import compile_scene as jax_compile
    from tracerboy_tpu_torch.scene import procedural
    from tracerboy_tpu_torch.scene import types as ir
    from tracerboy_tpu_torch.scene.compile import compile_scene
    from test_torch_instanced import assert_same, jax_tree

    def build(ir, s):
        s.base_dir = str(tmp_path)
        if feature == "light":
            s.lights.append(ir.InfiniteLightIR(mapname="sky.jpg"))
            return s
        s.textures["img"] = ir.TextureIR(name="img", type="imagemap",
                                         filename="wood.jpg")
        if feature == "image_texture":
            s.materials["wall"].map_kd = "img"
            return s
        s.materials["inst"] = ir.MaterialIR(name="inst", type="matte",
                                            map_kd="img")
        s.objects["x"] = ir.ObjectIR(name="x", shapes=[ir.TriangleMeshIR(
            indices=np.array([[0, 1, 2]], np.int32),
            positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                               np.float32),
            uvs=np.zeros((3, 2), np.float32), material="inst")])
        s.instances.append(ir.InstanceIR(object_name="x"))
        return s

    name = "sky.jpg" if feature == "light" else "wood.jpg"
    _write_jpeg(tmp_path / name, 4)
    kw = {"instancing": "tlas"} if feature == "instance" else {}
    got = compile_scene(build(ir, procedural._cornell_scene()), **kw)
    ref = jax_compile(build(jax_ir, jax_procedural._cornell_scene()), **kw)
    assert_same(jax_tree(ref), got.as_numpy())
    (tmp_path / name).write_bytes(b"\xff\xd8\xff\xe0")
    with pytest.raises(OSError):
        compile_scene(build(ir, procedural._cornell_scene()), **kw)
    with pytest.raises(OSError):
        jax_compile(build(jax_ir, jax_procedural._cornell_scene()), **kw)
