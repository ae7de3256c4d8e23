"""TLAS/BLAS instancing in the port (scene/compile.py's `instancing`,
trace/instanced.py, the wave's instanced hooks, Renderer's instance
methods) against the JAX package, on tests/test_instanced.py's 25-ball
scene and on a two-object scene written here (a plastic ball instanced 24
times, 16 of them scaled and rotated into one cluster whose boxes all
overlap, and an emissive panel instanced twice).

Tolerances:
- the compiled tables, every inst_* leaf, the objects' packed tables and
  the concatenated pk_attr_rows: bit for bit;
- instanced_closest against the JAX function (Pallas in interpret mode)
  on 512 rays, 128 of them inside more than KI * ROUNDS = 12 boxes: ids
  and instances equal, t to 1e-6 relative, u and v to 1e-5;
- the port's TLAS render against its flat render: tests/test_instanced.py's
  rule, isclose(rtol=1e-3, atol=5e-3) on more than 98% of the values;
- update_instance_transforms' tables and world bounds: bit for bit;
- the geometry bytes: tests/test_instanced.py's bound (TLAS < 1/5 flat).
The wave against the JAX wave is tests/test_torch_instanced_wave.py.

Under the `cuda` marker (skipped without a card; run on the card with
`python -m pytest --noconftest -m cuda tests/test_torch_instanced.py`):
every closest-hit launch of a TLAS render, the BLAS launches included,
against the plain version. This module imports jax (and the JAX package)
only inside the tests that compare with it.
"""

import os
import sys
import subprocess

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.scene.compile import (
    compile_scene,
    from_jax_pytree,
    load_scene,
)
from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
from tracerboy_tpu_torch.trace import instanced, kernels, traverse

torch.set_num_threads(2)

GRID = 5


def ball_grid_text():
    """tests/test_instanced.py's scene: 25 instances of one sphere."""
    insts = "".join(
        f"AttributeBegin\nTranslate {i * 3.0} 0 {j * 3.0 - 12.0}\n"
        f'ObjectInstance "ball"\nAttributeEnd\n'
        for i in range(GRID) for j in range(GRID))
    return f"""Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [48] "integer yresolution" [32]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "matte" "rgb Kd" [0.6 0.4 0.3]
ObjectBegin "ball"
Shape "sphere" "float radius" [1.0]
ObjectEnd
Translate 0 -12 0
{insts}WorldEnd
"""


CLUSTER_CENTRE = (0.0, 1.2, 0.0)


def two_object_text(cluster=16, row=8, lamps=(-1.5, 2.0)):
    """Two objects: "ball" (a plastic sphere; `cluster` instances scaled
    and rotated around CLUSTER_CENTRE, all containing it, and a row of
    `row`) and "lamp" (an emissive panel facing down, one instance at each
    x of `lamps`), over a flat ground, under a dim sky."""
    rng = np.random.default_rng(7)
    blocks = []
    for _ in range(cluster):
        c = rng.normal(0, 0.08, 3) + CLUSTER_CENTRE
        blocks.append(
            f"AttributeBegin\nTranslate {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n"
            f"Rotate {rng.uniform(0, 360):.3f} {rng.normal():.3f} "
            f"{rng.normal():.3f} {rng.normal():.3f}\n"
            f"Scale {rng.uniform(0.6, 1.0):.3f} {rng.uniform(0.6, 1.0):.3f} "
            f"{rng.uniform(0.6, 1.0):.3f}\n"
            f'ObjectInstance "ball"\nAttributeEnd\n')
    for k in range(row):
        blocks.append(f"AttributeBegin\nTranslate {-4 + 1.1 * k:.3f} 0.4 "
                      f'-2.5\nObjectInstance "ball"\nAttributeEnd\n')
    for x in lamps:
        blocks.append(f"AttributeBegin\nTranslate {x} 3.2 1.0\n"
                      f'ObjectInstance "lamp"\nAttributeEnd\n')
    return f"""LookAt 0 2.5 8  0 1 0  0 1 0
Camera "perspective" "float fov" [ 45 ]
Film "image" "integer xresolution" [ 16 ] "integer yresolution" [ 12 ]
Integrator "path" "integer maxdepth" [ 2 ]
WorldBegin
LightSource "infinite" "rgb L" [ 0.4 0.45 0.5 ]
AttributeBegin
  Material "matte" "rgb Kd" [ 0.5 0.5 0.5 ]
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point P" [ -10 0 -10  10 0 -10  10 0 10  -10 0 10 ]
AttributeEnd
ObjectBegin "ball"
  Material "plastic" "rgb Kd" [ 0.7 0.3 0.2 ] "float roughness" [ 0.2 ]
  Shape "sphere" "float radius" [ 0.5 ]
ObjectEnd
ObjectBegin "lamp"
  Material "matte" "rgb Kd" [ 0.8 0.8 0.8 ]
  AreaLightSource "diffuse" "rgb L" [ 8 7 6 ]
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point P" [ -0.3 0 -0.3  0.3 0 -0.3  0.3 0 0.3  -0.3 0 0.3 ]
ObjectEnd
{''.join(blocks)}WorldEnd
"""


SCENES = {"balls": ball_grid_text, "two_objects": two_object_text,
          # KI instances: one round of the BLAS pass (the JAX wave's
          # compile in interpret mode grows with the rounds).
          "two_objects_small": lambda: two_object_text(1, 2, (2.0,))}


def write(tmp_path, name):
    path = str(tmp_path / f"{name}.pbrt")
    with open(path, "w") as f:
        f.write(SCENES[name]())
    return path


def jax_tree(cs):
    import jax

    return jax.tree_util.tree_map(np.asarray, cs.as_pytree(pack_pallas=True))


def jax_compile(path, instancing="auto"):
    from tracerboy_tpu.scene.compile import compile_scene
    from tracerboy_tpu.scene.pbrt_parser import parse_pbrt as jax_parse

    return compile_scene(jax_parse(path), instancing=instancing)


def assert_same(ref, got, path=""):
    """Leaves equal bit for bit, through dicts and lists."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), (path, set(ref) ^ set(got))
        for k in ref:
            assert_same(ref[k], got[k], f"{path}{k}.")
        return
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_same(a, b, f"{path}{i}.")
        return
    a = np.asarray(ref)
    b = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got)
    assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    assert a.tobytes() == b.tobytes(), f"{path} differs"


@pytest.fixture(scope="module")
def two_objects(tmp_path_factory):
    """The two-object scene compiled to a TLAS by both packages."""
    path = write(tmp_path_factory.mktemp("two"), "two_objects")
    return (compile_scene(parse_pbrt(path), instancing="tlas"),
            jax_compile(path, instancing="tlas"))


@pytest.mark.parametrize("name", ["balls", "two_objects"])
def test_compile_matches_jax_bit_for_bit(tmp_path, name):
    path = write(tmp_path, name)
    for mode in ("tlas", "flatten"):
        cs = compile_scene(parse_pbrt(path), instancing=mode)
        ref = jax_compile(path, instancing=mode)
        assert cs.has_instances == ref.has_instances == (mode == "tlas")
        leaves = jax_tree(ref)
        assert_same(leaves, cs.as_numpy())
        assert_same(leaves, cs.as_tensors("cpu"))
        assert cs.num_lights == ref.num_lights
    # The TLAS rows, the per-object tables, the combined attribute rows.
    cs = compile_scene(parse_pbrt(path), instancing="tlas")
    ref = jax_compile(path, instancing="tlas")
    assert_same(ref.inst_tables, cs.inst_tables)
    assert_same([{k: o[k] for k in ("attrs", "attrs_topo", "verts", "lo",
                                    "hi")} for o in ref.inst_objects],
                [{k: o[k] for k in ("attrs", "attrs_topo", "verts", "lo",
                                    "hi")} for o in cs.inst_objects])
    assert_same(ref.inst_world_lo, cs.inst_world_lo)
    assert_same(ref.inst_world_hi, cs.inst_world_hi)
    if name == "two_objects":
        assert len(cs.inst_objects) == 2 and cs.num_lights == 4


def test_auto_takes_the_tlas_by_the_jax_rule(tmp_path):
    """auto flattens the small scenes (under 1M instanced triangles) and
    keeps a TLAS for 16 instances of a 65,536-triangle object."""
    path = write(tmp_path, "two_objects")
    assert not compile_scene(parse_pbrt(path)).has_instances
    big = _write_big_instanced(tmp_path)
    cs = compile_scene(parse_pbrt(big))
    ref = jax_compile(big)
    assert cs.has_instances and ref.has_instances
    assert_same(ref.inst_tables, cs.inst_tables)


def _write_big_instanced(tmp_path):
    """16 instances of a 128x256-quad PLY grid (65,536 triangles): 1,048,576
    flattened instanced triangles, the least the auto rule keeps."""
    from tracerboy_tpu_torch.utils.demo_scene import write_ground_ply

    write_ground_ply(str(tmp_path / "sheet.ply"), 128)
    with open(tmp_path / "sheet.ply", "rb") as f:
        assert b"element face 16384" in f.read(400)
    # 16384 quads = 32,768 triangles a sheet; two sheets an object.
    insts = "".join(
        f"AttributeBegin\nTranslate {3 * (k % 4)} {k // 4} 0\n"
        f'ObjectInstance "sheets"\nAttributeEnd\n' for k in range(16))
    text = f"""LookAt 0 4 13  0 0.6 0  0 1 0
Camera "perspective" "float fov" [ 40 ]
WorldBegin
LightSource "infinite" "rgb L" [ 1 1 1 ]
ObjectBegin "sheets"
  Material "matte" "rgb Kd" [ 0.5 0.5 0.5 ]
  Shape "plymesh" "string filename" [ "sheet.ply" ]
  AttributeBegin
    Translate 0 0.5 0
    Shape "plymesh" "string filename" [ "sheet.ply" ]
  AttributeEnd
ObjectEnd
{insts}WorldEnd
"""
    path = str(tmp_path / "big.pbrt")
    with open(path, "w") as f:
        f.write(text)
    return path


def cluster_rays(n=512, seed=3):
    """n rays: the first n // 4 from CLUSTER_CENTRE (inside all 16 cluster
    boxes), the rest from around the camera; some dead, some short."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[: n // 4] = CLUSTER_CENTRE
    o[n // 4:] = (rng.normal(size=(n - n // 4, 3)) * [3, 1, 3]
                  + [0, 1.5, 4]).astype(np.float32)
    tm = np.full(n, 1e30, np.float32)
    tm[::17] = 0.0
    tm[5::13] = 2.0
    return o, d, tm


def test_instanced_closest_matches_jax(two_objects):
    import jax.numpy as jnp

    from tracerboy_tpu.trace.instanced import instanced_closest as jax_ic

    cs, ref = two_objects
    scene = cs.as_tensors("cpu")
    o, d, tm = cluster_rays()
    to = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    # More than KI * ROUNDS boxes hold the cluster rays' origin: entry t
    # is 0 for all of them, and the stable sort must keep the lowest ids.
    inside = (instanced._slab(to[0], to[1], scene["inst_lo"],
                              scene["inst_hi"]) == 0).sum(1)
    assert (inside[: len(o) // 4] > instanced.KI * instanced.ROUNDS).all()
    want = [np.asarray(x) for x in jax_ic(
        ref.as_pytree(pack_pallas=True), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tm), interpret=True)]
    kernels.reset_counters()
    got = [x.numpy() for x in instanced.instanced_closest(scene, *to)]
    # One closest-hit call an object a round, on the CPU its plain twin.
    assert kernels.TWIN_CALLS["closest"] == instanced.ROUNDS * 2
    t, tri, u, v, inst = got
    hit = want[1] >= 0
    assert hit.sum() > 100 and (hit[: len(o) // 4]).mean() > 0.9
    np.testing.assert_array_equal(tri, want[1])
    np.testing.assert_array_equal(inst, want[4])
    np.testing.assert_allclose(t[hit], want[0][hit], rtol=1e-6)
    assert (t[~hit] == instanced.BIG).all()
    np.testing.assert_allclose(u[hit], want[2][hit], atol=1e-5)
    np.testing.assert_allclose(v[hit], want[3][hit], atol=1e-5)
    assert (tri[tm <= 0] == -1).all()


def test_candidates_break_ties_by_the_lower_id(two_objects):
    """jax.lax.top_k's order: nearest entry t first, ties to the lower
    instance id; rays inside > 12 boxes keep the 12 lowest ids."""
    import jax
    import jax.numpy as jnp

    cs, ref = two_objects
    scene = cs.as_tensors("cpu")
    o, d, tm = cluster_rays(64)
    t, ids = instanced.select_candidates(
        scene, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    tn = instanced._slab(torch.from_numpy(o), torch.from_numpy(d),
                         scene["inst_lo"], scene["inst_hi"])
    tn = torch.where(torch.from_numpy(tm)[:, None] > 0, tn, instanced.BIG)
    neg, want = jax.lax.top_k(-jnp.asarray(tn.numpy()), ids.shape[1])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.numpy(), -np.asarray(neg))
    live = torch.from_numpy(tm) > 0
    assert (ids[:16][live[:16]] == torch.arange(12, dtype=torch.int32)).all()


def test_tlas_render_matches_flat(tmp_path):
    """tests/test_instanced.py's pixel-parity rule on the two-object
    scene: the same sampler streams over the same geometry."""
    path = write(tmp_path, "two_objects")
    imgs = {}
    for mode in ("tlas", "flatten"):
        r = Renderer(compile_scene(parse_pbrt(path), film_size=(24, 16),
                                   instancing=mode), device="cpu")
        assert r.traversal == "kernel"
        assert r.wave_config().has_instances == (mode == "tlas")
        r.render_sample(2)
        imgs[mode] = r.resolve_radiance().numpy()
    assert np.isfinite(imgs["tlas"]).all() and imgs["tlas"].mean() > 0.01
    close = np.isclose(imgs["tlas"], imgs["flatten"], rtol=1e-3, atol=5e-3)
    assert close.mean() > 0.98, close.mean()


def test_update_instance_transforms_matches_jax(two_objects):
    from tracerboy_tpu.renderer import Renderer as JaxRenderer

    cs, ref = two_objects
    n = cs.inst_tables["inst_obj"].shape[0]
    rng = np.random.default_rng(5)
    M = np.tile(np.eye(4), (n, 1, 1))
    M[:, :3, 3] = rng.normal(size=(n, 3))
    M[:, 0, 0] = rng.uniform(0.5, 2.0, n)
    jr = JaxRenderer(ref, film_size=(16, 12))
    jr.update_instance_transforms(M)
    r = Renderer(cs, film_size=(16, 12), device="cpu")
    r.render_sample(1)
    r.update_instance_transforms(M)
    assert r.state.spp == 0
    for k in ("inst_obj", "inst_inv", "inst_lo", "inst_hi", "world_lo",
              "world_hi"):
        assert_same(np.asarray(jr.scene_pytree[k]), r.scene[k], k)
    with pytest.raises(ValueError, match="transforms"):
        r.update_instance_transforms(M[:-1])
    # The object's BLAS rebuilt in place (accel/bvh_device.py): the same
    # instance boxes as the JAX method's refit.
    verts = cs.inst_objects[0]["verts"].transpose(1, 0, 2).copy()
    jr.update_object_geometry(0, *verts)
    r.render_sample(1)
    r.update_object_geometry(0, *verts)
    assert r.state.spp == 0
    for k in ("inst_lo", "inst_hi", "world_lo", "world_hi"):
        assert_same(np.asarray(jr.scene_pytree[k]), r.scene[k], k)
    assert_same(np.asarray(jr.scene_pytree["inst_objs"][0]["packed"][
        "nodes"]), r.scene["inst_objs"][0]["packed"]["nodes"])
    with pytest.raises(NotImplementedError, match="update_instance"):
        r.update_geometry(cs.tri_v0, cs.tri_v1, cs.tri_v2)


def test_from_jax_pytree_carries_a_tlas_scene(two_objects):
    """The JAX pytree of a TLAS scene, inst_objs list and all, becomes the
    port's tensors, and instanced_closest gives the same hits on it."""
    cs, ref = two_objects
    carried = from_jax_pytree(jax_tree(ref), "cpu")
    own = cs.as_tensors("cpu")
    assert_same(own, carried)
    assert isinstance(carried["inst_objs"], list)
    o, d, tm = (torch.from_numpy(x) for x in cluster_rays(128))
    for a, b in zip(instanced.instanced_closest(carried, o, d, tm),
                    instanced.instanced_closest(own, o, d, tm)):
        assert torch.equal(a, b)


def test_tlas_scene_skips_the_cache(tmp_path):
    """load_scene writes no .tbcache.npz for a TLAS scene (either
    package) and still caches a flattened instanced scene."""
    from tracerboy_tpu.scene.compile import load_scene as jax_load_scene

    big = _write_big_instanced(tmp_path)
    cs = load_scene(big)
    assert cs.has_instances
    assert not os.path.exists(big + ".tbcache.npz")
    assert jax_load_scene(big).has_instances
    assert not os.path.exists(big + ".tbcache.npz")
    small = write(tmp_path, "two_objects")
    assert not load_scene(small).has_instances
    assert os.path.exists(small + ".tbcache.npz")


def _geometry_bytes(leaves):
    """tests/test_instanced.py's count: 4 bytes an element of every pk_,
    bn_, tri and bvh leaf and of the objects' packed tables."""
    total = 0
    for k, v in leaves.items():
        if k.startswith(("pk_", "bn_", "tri", "bvh")) or k == "inst_objs":
            stack = [v]
            while stack:
                x = stack.pop()
                if isinstance(x, dict):
                    stack.extend(x.values())
                elif isinstance(x, list):
                    stack.extend(x)
                else:
                    total += 4 * int(np.prod(np.shape(x)))
    return total


def test_tlas_memory_scales_with_unique_geometry(tmp_path):
    path = write(tmp_path, "balls")
    sc = parse_pbrt(path)
    tlas = compile_scene(sc, film_size=(48, 32), instancing="tlas")
    flat = compile_scene(sc, film_size=(48, 32), instancing="flatten")
    assert tlas.has_instances and not flat.has_instances
    assert flat.tri_v0.shape[0] >= GRID * GRID * 900
    b_tlas = _geometry_bytes(tlas.as_tensors("cpu"))
    b_flat = _geometry_bytes(flat.as_tensors("cpu"))
    assert b_tlas * 5 < b_flat, (b_tlas, b_flat)
    assert tlas.as_tensors("cpu")["inst_obj"].shape[0] == GRID * GRID


def test_instanced_modules_import_no_jax():
    code = ("import sys\n"
            "from tracerboy_tpu_torch.trace import instanced\n"
            "from tracerboy_tpu_torch.scene import pbf, mesh_import\n"
            "from tracerboy_tpu_torch.utils import demo_scene\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'tracerboy_tpu'\n"
            "             or m.startswith('tracerboy_tpu.')\n"
            "             or m == 'PIL' or m.startswith('PIL.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# ---------------------------------------------------------------------------
# On the card.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_blas_launches_equal_their_plain_version(cuda_device, tmp_path,
                                                 monkeypatch):
    """Every closest-hit launch of a TLAS render on the card (the flat
    scene's and each object's BLAS launch a round) against
    traverse.closest_hit_plain on the same rays: hits equal, ids equal
    outside 1e-4 of the hit lanes, t to 1e-6 relative, no stack
    overflow."""
    path = write(tmp_path, "two_objects")
    r = Renderer(compile_scene(parse_pbrt(path), film_size=(96, 64),
                               instancing="tlas"), device="cuda")
    assert r.traversal == "kernel" and r.wave_config().has_instances
    calls = []
    real = traverse.closest_hit

    def recording(o, d, t_max, nodes, tris_bw, roots=None):
        calls.append((o.clone(), d.clone(), t_max.clone(), nodes, tris_bw))
        return real(o, d, t_max, nodes, tris_bw, roots)

    monkeypatch.setattr(traverse, "closest_hit", recording)
    r.render_sample(2)
    monkeypatch.setattr(traverse, "closest_hit", real)
    blas = [c for c in calls if any(c[3] is ob["packed"]["nodes"]
                                    for ob in r.scene["inst_objs"])]
    assert blas and len(blas) % (instanced.ROUNDS * 2) == 0
    kernels.reset_counters()
    for o, d, tm, nodes, tris in calls:
        t_k, tri_k, u_k, v_k = real(o, d, tm, nodes, tris)
        t_p, tri_p, u_p, v_p = traverse.closest_hit_plain(o, d, tm, nodes,
                                                          tris)
        assert torch.equal(tri_k >= 0, tri_p >= 0)
        both = (tri_k >= 0) & (tri_p >= 0)
        if not both.any():
            continue
        rel = ((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[both]
        assert rel.max().item() <= 1e-6
        assert (tri_k != tri_p)[both].float().mean().item() <= 1e-4
    assert kernels.stack_overflows() == 0
