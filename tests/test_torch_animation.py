"""Animated geometry: Renderer.update_geometry and update_object_geometry of
the port against the JAX package's, on the CPU.

- Every leaf the JAX method refreshes, leaf by leaf against the JAX
  Renderer's scene_pytree after the same update, on the brute backend and
  on the packed one (shadertoy:cornell under TB_TRAVERSAL=pallas, which
  packs both BVHs; no JAX packed-path render is needed). Bit-equal but
  the Baldwin-Weber rows (tests/test_torch_bvh_device.py says why).
- One render after a move against the JAX brute render (the module's one
  JAX wave compile), the packed ("twin") render after a rebuild against
  the brute one, an identity update, a move, and the error contracts.
- The reference's faults the port keeps or refuses (ROADMAP.md Queue 3):
  stale light records and triangle areas (kept, for parity), stale cut
  and binned tables (the JAX method keeps them; the port refuses), the
  wide backend (refused by both).
- update_object_geometry on test_torch_instanced.py's two-object TLAS
  scene: the object's tables against JAX's, and its hits against a
  recompile of the deformed scene.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.scene.compile import compile_scene
from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
from tracerboy_tpu_torch.trace import instanced

torch.set_num_threads(2)

FILM = (16, 12)
BW_REL = 2e-5     # Baldwin-Weber rows, port vs JAX, of max(|value|, 1)
BW_KEYS = ("pk_tris_bw", "pk_sh_tris_bw")


@contextlib.contextmanager
def traversal_env(**env):
    """TB_* variables set for the block (the renderers read them when
    built), restored after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: v for k, v in env.items() if v is not None})
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sine_field(v0, v1, v2, phase=0.5, share=0.01):
    """Each vertex moved by a smooth sine field of about `share` of the
    scene's extent (a function of position, so shared vertices stay
    shared)."""
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    ext = float((hi - lo).max())
    k = 2.0 * np.pi / ext

    def move(p):
        s = np.sin(k * p[:, [1, 2, 0]] * 2.0 + phase)
        return (p + share * ext * s).astype(np.float32)

    return move(v0), move(v1), move(v2)


def port_renderer(name="shadertoy:cornell", traversal=None, film=FILM,
                  **env):
    with traversal_env(TB_TRAVERSAL=traversal, **env):
        return Renderer(name, film_size=film, device="cpu")


def jax_renderer(name="shadertoy:cornell", traversal=None, film=FILM, **env):
    from tracerboy_tpu.renderer import Renderer as JaxRenderer

    with traversal_env(TB_TRAVERSAL=traversal, **env):
        return JaxRenderer(name, film_size=film)


def assert_leaves_equal(jax_leaves, scene, keys):
    for k in keys:
        a = np.asarray(jax_leaves[k])
        b = scene[k].cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in BW_KEYS:
            assert (np.abs(a - b) <= BW_REL * np.maximum(np.abs(a), 1)).all()
        else:
            assert np.array_equal(a, b), k


REFRESHED = ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
             "tri9", "tri_attr_rows", "tri_attr_t", "world_lo", "world_hi")
PACKED = ("pk_nodes", "pk_tris_bw", "pk_tri_map", "pk_attr_rows",
          "pk_sh_nodes", "pk_sh_tris_bw", "pk_sh_tri_map", "pk_sh_attr_rows")


@pytest.mark.parametrize("traversal", ["brute", "pallas"])
def test_update_geometry_leaves_match_jax(traversal):
    jr = jax_renderer(traversal=traversal)
    r = port_renderer(traversal=traversal)
    assert r.traversal == {"brute": "brute", "pallas": "kernel"}[traversal]
    v = [r.compiled.tri_v0, r.compiled.tri_v1, r.compiled.tri_v2]
    moved = sine_field(*v)
    before = {k: r.scene[k].clone() for k in REFRESHED + PACKED
              if k in r.scene}
    jr.update_geometry(*moved)
    r.render_sample(1)
    r.update_geometry(*moved)
    assert r.state.spp == 0
    keys = REFRESHED + (PACKED if traversal == "pallas" else ())
    assert_leaves_equal(jr.scene_pytree, r.scene, keys)
    # Every refreshed leaf moved (the flat normals too: the field bends
    # the walls).
    for k in keys:
        assert not torch.equal(before[k], r.scene[k]), k
    # Leaves the update does not touch are the JAX ones still.
    assert_leaves_equal(jr.scene_pytree, r.scene,
                        ("tri_uv0", "tri_material", "tri_shadow_opaque"))


def test_render_after_move_matches_jax():
    jr = jax_renderer(traversal="brute")
    r = port_renderer(traversal="brute")
    moved = sine_field(r.compiled.tri_v0, r.compiled.tri_v1,
                       r.compiled.tri_v2, phase=0.7, share=0.03)
    jr.update_geometry(*moved)
    r.update_geometry(*moved)
    jr.render_sample(1)
    r.render_sample(1)
    ref = np.asarray(jr.state.accum)
    acc = r.state.accum.numpy()
    assert np.isfinite(acc).all() and acc[..., :3].mean() > 0
    close = (np.abs(acc - ref) <= 1e-3 * (1 + np.abs(ref))).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(acc.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


def test_packed_render_matches_brute_after_rebuild():
    """After a rebuild on the device (here the CPU), the packed backend's
    plain walk over the new tables gives the brute-force image."""
    rb = port_renderer(traversal="brute")
    rp = port_renderer(traversal="pallas")
    rp.traversal = "twin"
    moved = sine_field(rb.compiled.tri_v0, rb.compiled.tri_v1,
                       rb.compiled.tri_v2, phase=0.3, share=0.02)
    for r in (rb, rp):
        r.update_geometry(*moved)
        r.render_sample(1)
    np.testing.assert_allclose(rp.resolve_radiance().numpy(),
                               rb.resolve_radiance().numpy(), atol=1e-4)


@pytest.mark.parametrize("traversal", ["brute", "pallas"])
def test_identity_update_keeps_the_image_and_a_move_changes_it(traversal):
    r = port_renderer(traversal=traversal)
    r.render_sample(1)
    ref = r.resolve_radiance().numpy()
    sc = r.scene
    r.update_geometry(sc["tri_v0"], sc["tri_v1"], sc["tri_v2"],
                      normals=sc["tri_n0"])
    assert r.state.spp == 0
    r.render_sample(1)
    np.testing.assert_allclose(r.resolve_radiance().numpy(), ref, atol=1e-5)
    delta = torch.tensor([0.35, 0.0, 0.0])
    r.update_geometry(sc["tri_v0"] + delta, sc["tri_v1"] + delta,
                      sc["tri_v2"] + delta)
    r.render_sample(1)
    moved = r.resolve_radiance().numpy()
    assert np.isfinite(moved).all()
    assert np.abs(moved - ref).mean() > 1e-3


def test_update_geometry_error_contracts():
    r = port_renderer(traversal="brute")
    with pytest.raises(ValueError, match="keeps topology"):
        r.update_geometry(np.zeros((3, 3)), np.zeros((3, 3)),
                          np.zeros((3, 3)))
    with pytest.raises(ValueError, match="no TLAS"):
        r.update_object_geometry(0, np.zeros((3, 3)), np.zeros((3, 3)),
                                 np.zeros((3, 3)))


def test_wide_backend_refuses_in_both_packages():
    """TB_TRAVERSAL=jnp: JAX's lock-step jnp oracle keeps its host build,
    and so does the port's wide backend (ROADMAP.md Queue 3)."""
    jr = jax_renderer(traversal="jnp")
    r = port_renderer(traversal="jnp")
    assert r.traversal == "wide"
    v = (r.compiled.tri_v0, r.compiled.tri_v1, r.compiled.tri_v2)
    with pytest.raises(NotImplementedError, match="jnp oracle"):
        jr.update_geometry(*v)
    with pytest.raises(NotImplementedError, match="wide backend"):
        r.update_geometry(*v)


def test_jax_keeps_stale_cut_and_binned_tables_and_the_port_refuses():
    """A scene compiled with TB_CUT=1 and TB_BINNED=1 carries cut and
    binned tables of the load-time tree. The JAX update_geometry rebuilds
    pk_nodes and leaves them as they were, so its cut and binned waves
    would walk them against the new nodes (a fault of the reference,
    ROADMAP.md Queue 3); the port refuses the update."""
    env = dict(TB_CUT="1", TB_BINNED="1")
    jr = jax_renderer("shadertoy", traversal="pallas", film=(8, 8), **env)
    sp = jr.scene_pytree
    stale = ("pk_cut_top", "pk_cut_roots", "pk_sh_cut_top",
             "pk_sh_cut_roots", "bn_nodes", "bn_mot", "bn_base")
    before = {k: np.asarray(sp[k]) for k in stale + ("pk_nodes",)}
    moved = sine_field(*(np.asarray(sp[k]) for k in ("tri_v0", "tri_v1",
                                                     "tri_v2")))
    jr.update_geometry(*moved)
    for k in stale:
        assert np.array_equal(np.asarray(jr.scene_pytree[k]), before[k]), k
    assert not np.array_equal(np.asarray(jr.scene_pytree["pk_nodes"]),
                              before["pk_nodes"])
    # The cut table's roots name nodes of the old tree: the rebuilt node
    # table is C rows long, its live part shorter than the old tree.
    r = port_renderer("shadertoy", traversal="pallas", film=(8, 8), **env)
    assert {"pk_cut_top", "bn_nodes"} <= set(r.scene)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        r.update_geometry(*moved)


def test_light_records_and_areas_keep_their_load_time_values():
    """Both packages keep the light records (NEE samples emitters where
    they were loaded) and, in volume scenes, tri_area and pk_tri_area (the
    phase/light MIS reads the old areas in the old packed order) through
    update_geometry: a fault of the reference the port keeps for parity
    (ROADMAP.md Queue 3)."""
    from tracerboy_tpu.renderer import Renderer as JaxRenderer
    from tracerboy_tpu.scene.volume import procedural_cloud as jax_cloud
    from tracerboy_tpu_torch.scene.volume import procedural_cloud

    with traversal_env(TB_TRAVERSAL="pallas"):
        jr = JaxRenderer("shadertoy:cornell", film_size=FILM,
                         volume=jax_cloud(8))
        r = Renderer("shadertoy:cornell", film_size=FILM, device="cpu",
                     volume=procedural_cloud(8))
    keys = ("tri_area", "pk_tri_area")
    jbefore = {k: np.asarray(jr.scene_pytree[k]) for k in keys}
    jlights = {k: np.asarray(v) for k, v in jr.scene_pytree["lights"].items()}
    before = {k: r.scene[k].clone() for k in keys}
    lights = {k: v.clone() for k, v in r.scene["lights"].items()}
    moved = sine_field(r.compiled.tri_v0, r.compiled.tri_v1,
                       r.compiled.tri_v2, share=0.05)
    jr.update_geometry(*moved)
    r.update_geometry(*moved)
    for k in keys:
        assert np.array_equal(np.asarray(jr.scene_pytree[k]), jbefore[k])
        assert torch.equal(r.scene[k], before[k])
    for k, v in lights.items():
        assert np.array_equal(np.asarray(jr.scene_pytree["lights"][k]),
                              jlights[k])
        assert torch.equal(r.scene["lights"][k], v), k
    # The emitters did move: the records no longer lie on them.
    p0 = r.scene["lights"]["p0"][0]
    assert not (r.scene["tri_v0"] == p0).all(1).any()


# ---------------------------------------------------------------------------
# update_object_geometry on the two-object TLAS scene
# ---------------------------------------------------------------------------

def _two_objects(tmp_path, radius=None):
    from test_torch_instanced import two_object_text

    text = two_object_text()
    if radius is not None:
        text = text.replace('"float radius" [ 0.5 ]',
                            f'"float radius" [ {radius} ]')
        assert f"[ {radius} ]" in text
    path = tmp_path / f"two_{radius}.pbrt"
    path.write_text(text)
    return str(path)


def test_update_object_geometry_matches_jax(tmp_path):
    from test_torch_instanced import jax_compile

    from tracerboy_tpu.renderer import Renderer as JaxRenderer

    path = _two_objects(tmp_path)
    cs = compile_scene(parse_pbrt(path), instancing="tlas")
    jr = JaxRenderer(jax_compile(path, instancing="tlas"), film_size=FILM)
    r = Renderer(cs, film_size=FILM, device="cpu")
    verts = cs.inst_objects[0]["verts"]
    new = [verts[:, k] * 1.25 for k in range(3)]
    jr.update_object_geometry(0, *new)
    r.render_sample(1)
    r.update_object_geometry(0, *new)
    assert r.state.spp == 0
    jent = jr.scene_pytree["inst_objs"][0]["packed"]
    ent = r.scene["inst_objs"][0]["packed"]
    assert np.array_equal(np.asarray(jent["nodes"]), ent["nodes"].numpy())
    a, b = np.asarray(jent["tris_bw"]), ent["tris_bw"].numpy()
    assert a.shape == b.shape
    assert (np.abs(a - b) <= BW_REL * np.maximum(np.abs(a), 1)).all()
    for k in ("pk_attr_rows", "inst_obj", "inst_inv", "inst_lo", "inst_hi",
              "world_lo", "world_hi"):
        ref = np.asarray(jr.scene_pytree[k])
        got = r.scene[k].numpy()
        assert ref.dtype == got.dtype and ref.shape == got.shape, k
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # The lamp object keeps its load-time tables.
    assert torch.equal(r.scene["inst_objs"][1]["packed"]["nodes"],
                       torch.from_numpy(cs.inst_objects[1]["packed"][
                           "nodes"]))
    # A shape change of the object is refused, as in JAX.
    with pytest.raises(ValueError, match="keeps topology"):
        r.update_object_geometry(0, *(x[:-1] for x in new))


def test_update_object_geometry_hits_match_a_recompile(tmp_path):
    """Scaling the ball object by 1.25 gives the hits of the scene
    compiled with a 0.625 sphere: same t (to float32 rounding of the
    vertices), same instance, same triangle attributes."""
    from test_torch_instanced import cluster_rays

    cs = compile_scene(parse_pbrt(_two_objects(tmp_path)), instancing="tlas")
    big = compile_scene(parse_pbrt(_two_objects(tmp_path, radius=0.625)),
                        instancing="tlas")
    r = Renderer(cs, film_size=FILM, device="cpu")
    verts = cs.inst_objects[0]["verts"]
    r.update_object_geometry(0, *(verts[:, k] * 1.25 for k in range(3)))
    ref_scene = big.as_tensors("cpu")
    o, d, tm = (torch.from_numpy(x) for x in cluster_rays(512))
    t, tri, _, _, inst = instanced.instanced_closest(r.scene, o, d, tm)
    t_r, tri_r, _, _, inst_r = instanced.instanced_closest(ref_scene, o, d,
                                                           tm)
    hit, hit_r = tri >= 0, tri_r >= 0
    assert hit_r.float().mean() > 0.2
    assert (hit == hit_r).float().mean() >= 0.99
    both = hit & hit_r
    assert (inst[both] == inst_r[both]).float().mean() >= 0.99
    rel = ((t - t_r).abs() / t_r.abs())[both]
    assert rel.max().item() <= 1e-4
    # The hit triangle's UVs and material (the rows keep them; the
    # normals are flat now, where the compiled sphere's are smooth).
    a = r.scene["pk_attr_rows"][tri[both].long(), 9:16]
    a_r = ref_scene["pk_attr_rows"][tri_r[both].long(), 9:16]
    assert ((a - a_r).abs().amax(1) <= 1e-6).float().mean() >= 0.99
    for k in ("inst_lo", "inst_hi"):
        np.testing.assert_allclose(r.scene[k].numpy(), ref_scene[k].numpy(),
                                   atol=1e-5)
