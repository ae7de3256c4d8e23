"""The wide traversal of the port (trace/traverse.py traverse_wide, the
lock-step walk of the scene's own 8-wide BVH in plain torch) and the
row-layout intersection tests (trace/intersect.py) against the JAX package
(tracerboy_tpu/trace/traverse.py, intersect.py).

- traverse_wide closest hit, any hit (with the shadow mask) and the
  per-ray cost on both procedural scenes, camera rays and random rays,
  finite and dead t_max: hit sets equal, ids equal outside ties in t, t to
  rtol 1e-5, u and v to 1e-4 absolute (Moller-Trumbore's u, v are
  differences of products; XLA contracts them otherwise), the cost equal on
  at least 99% of rays (one box test that rounds otherwise changes a ray's
  count) and its mean to 1e-3.
- ray_triangle, ray_triangle_watertight, ray_shear and ray_aabb on seeded
  rays and triangles: hit masks equal on at least 99.9%; on the common
  hits t to 1e-5 relative and u, v to 1e-5 absolute on at least 99% of
  them, and to 2e-6 / |det| on all: a ray grazing its triangle divides
  sums rounded at about 1e-7 by a small determinant (measured: the error
  times |det| stays below 1e-6; 2.3e-3 in v at |det| = 1.1e-4).
- A 32x24 render with TB_TRAVERSAL=jnp: the port takes its "wide" backend
  and agrees with the JAX package under the same variable (|d| <= 1e-3
  (1 + |ref|) on at least 99% of pixels) and with its own default backend
  (the kernels' plain twins; another tree and another triangle test, same
  bound). TB_TRAVERSAL's three names map to the port's backends.
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.scene.compile import load_scene
from tracerboy_tpu_torch.trace import intersect, traverse

torch.set_num_threads(2)

f32 = np.float32
FILM = (32, 24)
N_RAYS = 1024


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rays(cs, rng, n):
    """Half rays from the camera position into the scene, half random
    rays from inside the scene bounds; infinite, finite and dead t_max."""
    lo = np.minimum(np.minimum(cs.tri_v0, cs.tri_v1), cs.tri_v2).min(0)
    hi = np.maximum(np.maximum(cs.tri_v0, cs.tri_v1), cs.tri_v2).max(0)
    half = n // 2
    o1 = np.tile(cs.camera.position, (half, 1))
    tgt = lo + (hi - lo) * rng.random((half, 3))
    d1 = tgt - o1
    o2 = lo + (hi - lo) * rng.random((n - half, 3))
    d2 = rng.normal(size=(n - half, 3))
    o = np.concatenate([o1, o2]).astype(f32)
    d = np.concatenate([d1, d2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(f32)
    tm = np.full(n, 1e30, f32)
    kind = rng.random(n)
    tm[kind < 0.25] = (rng.random(int((kind < 0.25).sum()))
                       * np.linalg.norm(hi - lo)).astype(f32)
    tm[kind > 0.9] = 0.0
    return o, d, tm


@pytest.mark.parametrize("name", ["shadertoy:cornell", "shadertoy"])
def test_traverse_wide_matches_jax(name):
    import jax.numpy as jnp

    from tracerboy_tpu.trace.traverse import traverse_wide as jax_wide

    cs = load_scene(name, film_size=FILM)
    rng = np.random.default_rng(len(name))
    o, d, tm = _rays(cs, rng, N_RAYS)
    tables = (cs.bvh_lo, cs.bvh_hi, cs.bvh_children, cs.tri_v0, cs.tri_v1,
              cs.tri_v2)
    opaque = (cs.materials["flags"][cs.tri_material] & 0x1) == 0
    ref = jax_wide(*(jnp.asarray(x) for x in (o, d, tm, *tables)),
                   leaf_size=cs.leaf_size)
    got = traverse.traverse_wide(*(_t(x) for x in (o, d, tm, *tables)),
                                 leaf_size=cs.leaf_size)
    t_r, tri_r, u_r, v_r, cost_r = (np.asarray(x) for x in ref)
    t_g, tri_g, u_g, v_g, cost_g = (x.numpy() for x in got)
    hit = tri_r >= 0
    assert hit.sum() > N_RAYS // 4
    np.testing.assert_array_equal(tri_g >= 0, hit)
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=1e-5)
    np.testing.assert_array_equal(t_g[~hit], f32(1e30))
    diff = hit & (tri_g != tri_r)
    assert (np.abs(t_g - t_r)[diff] <= 1e-6 * np.abs(t_r[diff])).all()
    same = hit & ~diff
    np.testing.assert_allclose(u_g[same], u_r[same], atol=1e-4)
    np.testing.assert_allclose(v_g[same], v_r[same], atol=1e-4)
    assert (cost_g == cost_r).mean() >= 0.99
    np.testing.assert_allclose(cost_g.mean(), cost_r.mean(), rtol=1e-3)
    assert cost_g.min() >= 8.0               # every ray pops the root

    mask = _t(opaque)
    occ_r = np.asarray(jax_wide(
        *(jnp.asarray(x) for x in (o, d, tm, *tables)),
        leaf_size=cs.leaf_size, any_hit=True, tri_mask=jnp.asarray(opaque)))
    occ_g = traverse.traverse_wide(
        *(_t(x) for x in (o, d, tm, *tables)), leaf_size=cs.leaf_size,
        any_hit=True, tri_mask=mask).numpy()
    assert occ_g.dtype == bool
    assert (occ_g == occ_r).mean() >= 0.999
    assert not occ_g[tm <= 0].any()
    # Occlusion by the unmasked scene is the closest hit's hit set.
    occ_all = traverse.traverse_wide(
        *(_t(x) for x in (o, d, tm, *tables)), leaf_size=cs.leaf_size,
        any_hit=True).numpy()
    np.testing.assert_array_equal(occ_all, tri_g >= 0)


def _tri_inputs(seed, n=4096):
    rng = np.random.default_rng(seed)
    v0 = ((rng.random((n, 3)) - 0.5) * 4).astype(f32)
    v1 = (v0 + rng.normal(size=(n, 3)) * 0.7).astype(f32)
    v2 = (v0 + rng.normal(size=(n, 3)) * 0.7).astype(f32)
    b = rng.random((n, 2))
    b = np.where(b.sum(1, keepdims=True) > 1, 1 - b, b) * 1.4 - 0.2
    p = v0 + (v1 - v0) * b[:, :1] + (v2 - v0) * b[:, 1:]
    o = ((rng.random((n, 3)) - 0.5) * 12).astype(f32)
    d = p - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(f32)
    return o, d, v0, v1, v2


@pytest.mark.parametrize("fn", ["ray_triangle", "ray_triangle_watertight"])
@pytest.mark.parametrize("capped", [False, True], ids=["free", "t_max"])
def test_triangle_tests_match_jax(fn, capped):
    import jax.numpy as jnp

    from tracerboy_tpu.trace import intersect as ji

    o, d, v0, v1, v2 = _tri_inputs(1)
    kw = {}
    jkw = {}
    if capped:
        tm = np.full(o.shape[0], 6.0, f32)
        kw, jkw = dict(t_max=_t(tm)), dict(t_max=jnp.asarray(tm))
    ref = getattr(ji, fn)(*(jnp.asarray(x) for x in (o, d, v0, v1, v2)),
                          **jkw)
    got = getattr(intersect, fn)(*(_t(x) for x in (o, d, v0, v1, v2)), **kw)
    t_r, u_r, v_r, hit_r = (np.asarray(x) for x in ref)
    t_g, u_g, v_g, hit_g = (x.numpy() for x in got)
    assert 0.2 < hit_r.mean() < 0.9
    assert (hit_g == hit_r).mean() >= 0.999
    both = hit_g & hit_r
    e1, e2 = (v1 - v0).astype(np.float64), (v2 - v0).astype(np.float64)
    det = np.abs(np.einsum("ij,ij->i", e1, np.cross(d.astype(np.float64),
                                                    e2)))[both]
    rel = np.abs(t_g[both] - t_r[both]) / np.abs(t_r[both])
    assert (rel <= 1e-5).mean() >= 0.99 and (rel * det).max() <= 2e-6
    for g, r in ((u_g, u_r), (v_g, v_r)):
        err = np.abs(g[both] - r[both])
        assert (err <= 1e-5).mean() >= 0.99 and (err * det).max() <= 2e-6
    assert (t_g[~hit_g] == f32(1e30)).all()
    if capped:
        assert (t_g[hit_g] < 6.0).all()


def test_watertight_broadcasts_rays_against_triangles():
    import jax.numpy as jnp

    from tracerboy_tpu.trace import intersect as ji

    o, d, v0, v1, v2 = _tri_inputs(2, n=64)
    ref = ji.ray_triangle_watertight(
        jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
        *(jnp.asarray(x)[None] for x in (v0, v1, v2)))
    got = intersect.ray_triangle_watertight(
        _t(o)[:, None], _t(d)[:, None], *(_t(x)[None] for x in (v0, v1, v2)))
    assert got[0].shape == (64, 64)
    assert (got[3].numpy() == np.asarray(ref[3])).mean() >= 0.999
    both = got[3].numpy() & np.asarray(ref[3])
    np.testing.assert_allclose(got[0].numpy()[both], np.asarray(ref[0])[both],
                               rtol=2e-4)


def test_ray_shear_and_aabb_match_jax():
    import jax.numpy as jnp

    from tracerboy_tpu.trace import intersect as ji

    o, d, v0, v1, v2 = _tri_inputs(3)
    ref = ji.ray_shear(jnp.asarray(d))
    got = intersect.ray_shear(_t(d))
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(got[3:], ref[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    lo, hi = np.minimum(v0, v1), np.maximum(v0, v1) + 0.3
    inv = (1.0 / d).astype(f32)
    tm = np.full(o.shape[0], 8.0, f32)
    tn_r, hit_r = ji.ray_aabb(*(jnp.asarray(x) for x in (o, inv, lo, hi, tm)))
    tn_g, hit_g = intersect.ray_aabb(*(_t(x) for x in (o, inv, lo, hi, tm)))
    np.testing.assert_array_equal(hit_g.numpy(), np.asarray(hit_r))
    np.testing.assert_array_equal(tn_g.numpy(), np.asarray(tn_r))
    assert 0.05 < hit_g.numpy().mean() < 0.95


def test_tb_traversal_names(monkeypatch):
    cs = load_scene("shadertoy:cornell", film_size=(8, 8))
    for forced, backend in (("brute", "brute"), ("pallas", "kernel"),
                            ("jnp", "wide"), ("other", "brute")):
        monkeypatch.setenv("TB_TRAVERSAL", forced)
        assert Renderer._pick_traversal(cs) == backend
    monkeypatch.delenv("TB_TRAVERSAL")
    assert Renderer._pick_traversal(cs) == "brute"


def _close_share(got, ref):
    return (np.abs(got - ref) <= 1e-3 * (1 + np.abs(ref))).all(-1).mean()


def test_render_through_the_wide_backend(monkeypatch):
    from tracerboy_tpu import Renderer as JaxRenderer

    monkeypatch.setenv("TB_TRAVERSAL", "jnp")
    ref = JaxRenderer("shadertoy", film_size=FILM)
    r = Renderer("shadertoy", film_size=FILM, device="cpu")
    assert ref.traversal == "jnp" and r.traversal == "wide"
    assert r.wave_config().leaf_size == ref.wave_config().leaf_size
    ref.render_sample(1)
    r.render_sample(1)
    want = np.asarray(ref.state.accum)
    got = r.state.accum.numpy()
    assert _close_share(got, want) >= 0.99
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=2e-2)
    # The heatmap AOV of this backend is the wide traversal's cost.
    hm_r = np.asarray(ref._last_aovs["heatmap"])
    hm_g = r._last_aovs["heatmap"].numpy()
    assert (hm_g == hm_r).mean() >= 0.99 and hm_g.min() >= 8

    monkeypatch.delenv("TB_TRAVERSAL")
    default = Renderer("shadertoy", film_size=FILM, device="cpu")
    assert default.traversal == "kernel"
    default.render_sample(1)
    assert _close_share(default.state.accum.numpy(), got) >= 0.99


def test_cornell_through_the_wide_backend_equals_brute(monkeypatch):
    """On cornell both backends return scene-order ids from the same
    Moller-Trumbore test: the renders agree pixel for pixel but for
    ties."""
    monkeypatch.setenv("TB_TRAVERSAL", "jnp")
    wide = Renderer("shadertoy:cornell", film_size=FILM, device="cpu")
    monkeypatch.setenv("TB_TRAVERSAL", "brute")
    brute = Renderer("shadertoy:cornell", film_size=FILM, device="cpu")
    assert (wide.traversal, brute.traversal) == ("wide", "brute")
    wide.render_sample(2)
    brute.render_sample(2)
    assert _close_share(wide.state.accum.numpy(),
                        brute.state.accum.numpy()) >= 0.99
