"""Image and noise textures of the port (scene/textures.py, the texture
half of scene/compile.py) against the JAX package's.

Tolerances: none. The noise bakes are bit-equal to the JAX ones for all
four types; TextureAllocator.to_arrays gives the same images, sizes and
records for PNG images (with and without the gamma flag), an .hdr image,
an RGBA image whose alpha makes a companion record, a missing file (the
magenta stand-in and its warning) and baked noise; a textured PBRT scene
compiles to leaves equal bit for bit to the JAX package's
load_scene(path, use_cache=False).as_pytree(pack_pallas=True), with
use_cache=False on both sides; and an infinite light's PNG map loads as
the JAX package loads it.
"""

import textwrap
import warnings

import numpy as np
import pytest
import torch

from tracerboy_tpu.scene import textures as jax_textures
from tracerboy_tpu.scene.types import TextureIR as JaxTextureIR
from tracerboy_tpu_torch.core.image_io import write_hdr, write_png
from tracerboy_tpu_torch.scene import textures
from tracerboy_tpu_torch.scene.compile import load_scene
from tracerboy_tpu_torch.scene.types import TextureIR
from test_torch_pbrt import _jax_leaves
from test_torch_scene import _assert_same_leaves

torch.set_num_threads(2)

NOISE = [dict(), dict(octaves=3, roughness=0.7, scale=2.5),
         dict(octaves=6, roughness=0.4, scale=0.5, variation=0.3)]


@pytest.mark.parametrize("kind", ["fbm", "wrinkled", "marble", "windy"])
@pytest.mark.parametrize("params", range(len(NOISE)))
def test_noise_bake_is_bit_equal(kind, params):
    kw = NOISE[params]
    got = textures.bake_noise_texture(TextureIR(name="n", type=kind, **kw),
                                      res=64)
    want = jax_textures.bake_noise_texture(
        JaxTextureIR(name="n", type=kind, **kw), res=64)
    assert got.dtype == want.dtype == np.float32 and got.shape == (64, 64, 3)
    assert got.tobytes() == want.tobytes()
    assert got.std() > 0.01


def write_images(d):
    """Seeded images beside a scene: an sRGB albedo, an RGBA leaf whose
    left half has alpha 0, a greyscale mask, a normal map and an .hdr."""
    rng = np.random.default_rng(21)
    write_png(str(d / "albedo.png"), rng.random((12, 20, 3)))
    leaf = rng.random((16, 16, 4))
    leaf[:, :8, 3] = 0.0
    leaf[:, 8:, 3] = 1.0
    write_png(str(d / "leaf.png"), leaf)
    write_png(str(d / "mask.png"), (rng.random((8, 8)) > 0.5) * 1.0)
    nm = np.full((8, 8, 3), 0.5)
    nm[..., 0] = 0.3 + 0.4 * rng.random((8, 8))
    nm[..., 2] = 1.0
    write_png(str(d / "nm.png"), nm)
    write_hdr(str(d / "glow.hdr"),
              (0.5 + 3 * rng.random((6, 10, 3))).astype(np.float32))


def _allocate(mod, tex_ir, base_dir, refs):
    irs = {k: tex_ir(name=k, **v) for k, v in refs.items()}
    alloc = mod.TextureAllocator(str(base_dir), irs)
    ids = [alloc(name, gamma) for name, gamma in (
        ("albedo", True), ("albedo", False), ("leaf", True), ("mask", False),
        ("glow", True), ("nm", False), ("missing", True), ("marb", False),
        ("wood.png", True), ("fbm", False))]
    return ids, alloc.alpha_companion, alloc.to_arrays()


def test_allocator_arrays_equal_jax(tmp_path):
    write_images(tmp_path)
    (tmp_path / "wood.png").write_bytes((tmp_path / "albedo.png")
                                        .read_bytes())
    refs = {
        "albedo": dict(type="imagemap", filename="albedo.png", uscale=2.0),
        "leaf": dict(type="imagemap", filename="leaf.png", vscale=3.0),
        "mask": dict(type="imagemap", filename="mask.png", gamma=False),
        "glow": dict(type="imagemap", filename="glow.hdr"),
        "nm": dict(type="imagemap", filename="nm.png", gamma=False),
        "missing": dict(type="imagemap", filename="absent.png"),
        "marb": dict(type="marble", octaves=4, scale=2.0),
        "fbm": dict(type="fbm", octaves=3, roughness=0.6),
    }
    with pytest.warns(UserWarning, match="texture not found"):
        got = _allocate(textures, TextureIR, tmp_path, refs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _allocate(jax_textures, JaxTextureIR, tmp_path, refs)
    assert got[0] == want[0] and got[1] == want[1]
    # The RGBA leaf has a companion; the RGB images do not.
    assert list(got[1]) == [got[0][2]]
    images, sizes, records = got[2]
    ref_images, ref_sizes, ref_records = want[2]
    assert images.tobytes() == ref_images.tobytes()
    assert images.shape == ref_images.shape
    np.testing.assert_array_equal(sizes, ref_sizes)
    assert list(records) == list(ref_records)
    for k in records:
        assert records[k].dtype == ref_records[k].dtype, k
        assert records[k].tobytes() == ref_records[k].tobytes(), k
    # The gamma flag: on for the sRGB albedo, off for the .hdr image.
    flags = records["flags"]
    assert flags[got[0][0]] == textures.GAMMA_FLAG
    assert flags[got[0][4]] == 0


TEXTURED = """\
LookAt 0 4 7  0 0.5 0  0 1 0
Camera "perspective" "float fov" [ 45 ]
Film "image" "integer xresolution" [ 40 ] "integer yresolution" [ 30 ]
Integrator "path" "integer maxdepth" [ 4 ]
WorldBegin
AttributeBegin
  Rotate -90 1 0 0
  LightSource "infinite" "string mapname" [ "{env}" ] "rgb L" [ 1 1 1 ]
AttributeEnd
LightSource "distant" "point from" [ 1 4 2 ] "point to" [ 0 0 0 ]
  "rgb L" [ 2 2 2 ]
Texture "albedo" "spectrum" "imagemap" "string filename" [ "albedo.png" ]
  "float uscale" [ 3 ] "float vscale" [ 3 ]
Texture "nm" "spectrum" "imagemap" "string filename" [ "nm.png" ]
  "bool gamma" "false"
Texture "leaf" "spectrum" "imagemap" "string filename" [ "leaf.png" ]
Texture "mask" "float" "imagemap" "string filename" [ "mask.png" ]
Texture "marb" "spectrum" "marble" "integer octaves" [ 4 ] "float scale" [ 2 ]
Texture "cloud" "spectrum" "fbm" "integer octaves" [ 3 ]
AttributeBegin
  Material "uber" "texture Kd" "albedo" "texture normalmap" "nm"
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point P" [ -6 0 -6  6 0 -6  6 0 6  -6 0 6 ]
    "float uv" [ 0 0  1 0  1 1  0 1 ]
AttributeEnd
AttributeBegin
  Material "matte" "texture Kd" "leaf"
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point P" [ -2 0.5 -1  0 0.5 -1  0 2.5 -1  -2 2.5 -1 ]
    "float uv" [ 0 0  1 0  1 1  0 1 ]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [ 0.7 0.2 0.2 ]
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point P" [ 0.5 0.5 -1  2.5 0.5 -1  2.5 2.5 -1  0.5 2.5 -1 ]
    "float uv" [ 0 0  1 0  1 1  0 1 ]
    "texture alpha" "mask"
AttributeEnd
AttributeBegin
  Translate -1.5 0.8 1.5
  Material "matte" "texture Kd" "marb"
  Shape "sphere" "float radius" [ 0.8 ]
AttributeEnd
AttributeBegin
  Translate 1.5 0.8 1.5
  Material "plastic" "texture Kd" "cloud" "float roughness" [ 0.2 ]
  Shape "sphere" "float radius" [ 0.8 ]
AttributeEnd
WorldEnd
"""


def write_textured_scene(d, env="sky.hdr", name="textured.pbrt"):
    """TEXTURED and its images in directory d; env is the infinite
    light's map (sky.hdr or sky.png, both written)."""
    write_images(d)
    rng = np.random.default_rng(5)
    sky = 0.3 + rng.random((16, 32, 3)).astype(np.float32)
    write_hdr(str(d / "sky.hdr"), sky)
    write_png(str(d / "sky.png"), np.clip(sky - 0.3, 0, 1))
    p = d / name
    p.write_text(textwrap.dedent(TEXTURED).replace("{env}", env))
    return str(p)


@pytest.mark.parametrize("env", ["sky.hdr", "sky.png"])
def test_textured_scene_compiles_like_jax(tmp_path, env):
    path = write_textured_scene(tmp_path, env)
    got = load_scene(path, use_cache=False, film_size=(24, 18))
    assert not list(tmp_path.glob("*.tbcache.npz"))
    _assert_same_leaves(_jax_leaves(path), got.as_numpy())
    mats = got.materials
    # The mask quad and the RGBA leaf (its companion) carry alpha; the
    # uber ground its normal map.
    assert (mats["alpha_tex"] >= 0).sum() == 2
    assert (mats["normal_tex"] >= 0).sum() == 1
    # albedo, nm, leaf + companion, mask, marble, fbm.
    assert got.tex_images.shape[0] == 7
    assert got.env_map.shape == (16, 32, 3)


def test_png_environment_map_matches_jax(tmp_path):
    from tracerboy_tpu.core.image_io import read_texture as jax_read_texture

    path = write_textured_scene(tmp_path, "sky.png")
    got = load_scene(path, use_cache=False)
    want = jax_read_texture(str(tmp_path / "sky.png")).astype(np.float32)
    assert got.env_map.tobytes() == want.tobytes()
    # An LDR map is gamma-decoded on load, as the JAX package does.
    assert got.env_map.max() <= 1.0 and got.env_map.min() >= 0.0


def test_textured_demo_scene_compiles_like_jax(tmp_path):
    """utils/demo_scene.py's textured scene at a small size: both files
    (textured_lit.pbrt includes textured.pbrt) compile as the JAX package
    compiles them; the leaf image is about half alpha 0."""
    from tracerboy_tpu_torch.utils.demo_scene import (
        leaf_image,
        write_textured_scene as write_demo,
    )

    tex, lit = write_demo(str(tmp_path), grid=8, sky=(32, 16), leaves=32,
                          albedo=32, normal=16, leaf=16)
    for path, lights in ((tex, 0), (lit, 1)):
        got = load_scene(path, use_cache=False, film_size=(24, 18))
        _assert_same_leaves(_jax_leaves(path), got.as_numpy())
        assert got.num_lights == lights and got.has_env
        # The ground, 32 leaves, the mask screen, three 960-triangle
        # spheres.
        assert got.num_tris == 2 * 8 * 8 + 2 * 32 + 2 + 3 * 960
        assert (got.materials["alpha_tex"] >= 0).sum() == 2
        assert (got.materials["normal_tex"] >= 0).sum() == 1
    assert 0.45 < (leaf_image(512)[..., 3] == 0).mean() < 0.55


def test_blue_noise_matches_jax():
    """The port's noise pair is the JAX package's, bit for bit: its
    seeded fallback, since the reference's blue-noise images are not in
    the repository."""
    from tracerboy_tpu.scene.compile import _load_blue_noise as jax_noise
    from tracerboy_tpu_torch.scene import compile as port_compile

    for got, want in zip(port_compile._load_blue_noise(), jax_noise()):
        assert got.dtype == np.float32 and got.shape == (256, 256, 4)
        assert got.tobytes() == want.tobytes()

