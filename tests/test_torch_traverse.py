"""Traversal of the PyTorch port (trace/traverse.py, trace/intersect.py)
against the JAX package.

- The plain twins against the TPU kernels traverse_packets2 /
  anyhit_packets2 in Pallas interpret mode, on the same packed tables:
  hit masks equal, t to rtol 1e-5 (atol 1e-6), packed ids equal where t
  is not tied. Both evaluate the same Baldwin-Weber expressions; the
  tolerances cover XLA contracting or reordering float32 products
  differently (see _assert_closest_match for the measured causes).
- The edge-crack and vertex-fan cases of TestWatertightProduction.
- Brute force against the JAX brute-force backend.
- Under the `cuda` marker (skipped without a card): the CUDA kernels
  against the twins, which must agree exactly (both built without FMA
  contraction). The machine with the card has no JAX, so this module
  imports JAX only inside the tests that compare with it; run the card's
  tests there with
      python -m pytest --noconftest -m cuda tests/test_torch_traverse.py
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.accel.pack import pack_scene
from tracerboy_tpu_torch.trace import kernels, traverse

torch.set_num_threads(2)

N_RAYS = 2048


def make_scene(rng, n, spread=10.0, size=0.4):
    """Random triangles (tests/test_pallas.py's generator)."""
    base = (rng.random((n, 3)) - 0.5).astype(np.float32) * spread
    v1 = base + rng.normal(size=(n, 3)).astype(np.float32) * size
    v2 = base + rng.normal(size=(n, 3)).astype(np.float32) * size
    return base, v1.astype(np.float32), v2.astype(np.float32)


def make_rays(rng, n_rays, toward=8.0, spread=30.0):
    """Random rays aimed into the scene (tests/test_pallas.py's)."""
    o = ((rng.random((n_rays, 3)) - 0.5) * spread).astype(np.float32)
    tgt = ((rng.random((n_rays, 3)) - 0.5) * toward).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _pallas():
    """The JAX package's TPU kernels, run in interpret mode."""
    import jax.numpy as jnp

    from tracerboy_tpu.trace import pallas_traverse2

    def closest(o, d, tm, jpk):
        return pallas_traverse2.traverse_packets2(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jpk,
            interpret=True)

    def anyhit(o, d, tm, jpk):
        return np.asarray(pallas_traverse2.anyhit_packets2(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jpk,
            interpret=True))

    return closest, anyhit


def _mixed_tmax(rng, n):
    """Infinite, capped (10 and random) and dead (0) lanes."""
    tm = np.full(n, 1e30, np.float32)
    kind = rng.random(n)
    tm[kind < 0.25] = 10.0
    sel = (kind >= 0.25) & (kind < 0.5)
    tm[sel] = (rng.random(int(sel.sum())) * 20).astype(np.float32)
    tm[kind > 0.875] = 0.0
    return tm


def _tables(v0, v1, v2):
    """Port and JAX packings of the same triangles; the packed tables
    must be identical."""
    from tracerboy_tpu.trace.pallas_traverse import pack_scene_for_pallas

    pk, _ = pack_scene(v0, v1, v2)
    jpk, _ = pack_scene_for_pallas(v0, v1, v2)
    np.testing.assert_array_equal(pk["nodes"], np.asarray(jpk["nodes"]))
    np.testing.assert_array_equal(pk["tris_bw"], np.asarray(jpk["tris_bw"]))
    return (torch.from_numpy(pk["nodes"]),
            torch.from_numpy(pk["tris_bw"])), jpk


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_closest_match(ref, got):
    t_r, tri_r = np.asarray(ref[0]), np.asarray(ref[1])
    t_g, tri_g = got[0].numpy(), got[1].numpy()
    hit = tri_r >= 0
    np.testing.assert_array_equal(tri_g >= 0, hit)
    # t = -(n.o - d) / (n.dir): near the origin the difference n.o - d
    # cancels, so t carries an absolute rounding error of the size of
    # the terms (measured 4.9e-7 at t = 0.013), hence atol 1e-6.
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t_g[~hit], np.float32(1e30))
    # Ids may differ only at ties: two triangles hit at the same t (a
    # shared edge accepted twice).
    diff = hit & (tri_g != tri_r)
    assert (np.abs(t_g - t_r)[diff] <= 1e-6 * np.abs(t_r[diff])).all()
    # u = g1.o + h1 + t (g1.d) sums terms of size |g1| |o| (hundreds for
    # the smallest random triangles here) to a result in [0, 1]: the
    # terms' float32 rounding, in whatever order XLA evaluates them,
    # leaves up to 1.3e-4 absolute (measured), hence atol 1e-3.
    same = hit & ~diff
    for k in (2, 3):
        np.testing.assert_allclose(got[k].numpy()[same],
                                   np.asarray(ref[k])[same], rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("n_tris", [37, 2000, 20_000])
def test_twins_match_pallas_kernels(n_tris):
    rng = np.random.default_rng(1234 + n_tris)
    v0, v1, v2 = make_scene(rng, n_tris)
    (nodes, tris), jpk = _tables(v0, v1, v2)
    o, d = make_rays(rng, N_RAYS)
    tm = _mixed_tmax(rng, N_RAYS)
    closest, anyhit = _pallas()
    ref = closest(o, d, tm, jpk)
    got = traverse.closest_hit(_t(o), _t(d), _t(tm), nodes, tris)
    _assert_closest_match(ref, got)
    assert (got[1].numpy()[tm <= 0] == -1).all()
    occ_ref = anyhit(o, d, tm, jpk)
    occ = traverse.any_hit(_t(o), _t(d), _t(tm), nodes, tris).numpy()
    np.testing.assert_array_equal(occ, occ_ref)
    assert not occ[tm <= 0].any()


def _quad_diagonal_rays():
    """TestWatertightProduction's edge-crack case: rays through the
    shared diagonal of a two-triangle quad."""
    a = np.array([0, 0, 0], np.float32)
    b = np.array([1, 0, 0], np.float32)
    c = np.array([1, 1, 0], np.float32)
    dd = np.array([0, 1, 0], np.float32)
    s = np.linspace(0.001, 0.999, 997, dtype=np.float32)
    pts = np.stack([s, s, np.zeros_like(s)], axis=1)
    o = np.array([[0.3, -0.2, 5.0]], np.float32) + np.array(
        [[0.1, 0.05, 0.0]], np.float32) * s[:, None]
    d = pts - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.stack([a, a]), np.stack([b, c]), np.stack([c, dd])), o, d


def _vertex_fan_rays():
    """TestWatertightProduction's vertex-fan case: rays at the apex of
    an 8-triangle fan."""
    apex = np.array([0.5, 0.5, 0.0], np.float32)
    k = 8
    ang = np.linspace(0, 2 * np.pi, k + 1)
    ring = np.stack([0.5 + np.cos(ang), 0.5 + np.sin(ang), np.zeros(k + 1)],
                    axis=1).astype(np.float32)
    v0 = np.broadcast_to(apex, (k, 3)).copy()
    o = np.tile(np.array([[1.7, -2.1, 7.0]], np.float32), (64, 1))
    o += np.linspace(0, 0.3, 64, dtype=np.float32)[:, None] * np.array(
        [[0.5, 1.0, 0.0]], np.float32)
    d = apex - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (v0, ring[:-1], ring[1:]), o.astype(np.float32), d.astype(
        np.float32)


@pytest.mark.parametrize("case", ["edge_crack", "vertex_fan"])
def test_watertight_cases(case):
    (v0, v1, v2), o, d = (_quad_diagonal_rays() if case == "edge_crack"
                          else _vertex_fan_rays())
    (nodes, tris), jpk = _tables(v0, v1, v2)
    n = o.shape[0]
    tm = np.full(n, 1e30, np.float32)
    got = traverse.closest_hit(_t(o), _t(d), _t(tm), nodes, tris)
    assert int((got[1] < 0).sum()) == 0, "cracks on the shared edge/vertex"
    ref = _pallas()[0](o, d, tm, jpk)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5)
    assert traverse.any_hit(_t(o), _t(d), _t(tm), nodes, tris).all()


@pytest.mark.parametrize("n_tris", [36, 300])
def test_brute_force_matches_jax(n_tris):
    import jax.numpy as jnp

    from tracerboy_tpu.core import vec3 as jv3
    from tracerboy_tpu.trace.intersect import (
        brute_force_anyhit_soa as janyhit,
        brute_force_closest_soa as jclosest,
    )
    from tracerboy_tpu_torch.core import vec3 as tv3
    from tracerboy_tpu_torch.trace.intersect import (
        brute_force_anyhit_soa as tanyhit,
        brute_force_closest_soa as tclosest,
    )

    rng = np.random.default_rng(n_tris)
    v0, v1, v2 = make_scene(rng, n_tris)
    tris = np.concatenate([v0, v1, v2], axis=1).astype(np.float32)
    o, d = make_rays(rng, N_RAYS)
    tm = _mixed_tmax(rng, N_RAYS)
    opaque = rng.random(n_tris) < 0.8
    jo = jv3.V3(*(jnp.asarray(o[:, k]) for k in range(3)))
    jd = jv3.V3(*(jnp.asarray(d[:, k]) for k in range(3)))
    to = tv3.V3(*(_t(o[:, k]) for k in range(3)))
    td = tv3.V3(*(_t(d[:, k]) for k in range(3)))
    ref = jclosest(jo, jd, jnp.asarray(tris), jnp.asarray(tm))
    got = tclosest(to, td, _t(tris), _t(tm))
    _assert_closest_match(ref, got)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    occ_ref = np.asarray(janyhit(jo, jd, jnp.asarray(tris), jnp.asarray(tm),
                                 tri_opaque=jnp.asarray(opaque)))
    occ = tanyhit(to, td, _t(tris), _t(tm), tri_opaque=_t(opaque)).numpy()
    np.testing.assert_array_equal(occ, occ_ref)


def test_wrappers_take_the_twins_on_cpu():
    rng = np.random.default_rng(7)
    v0, v1, v2 = make_scene(rng, 500)
    pk, _ = pack_scene(v0, v1, v2)
    nodes, tris = _t(pk["nodes"]), _t(pk["tris_bw"])
    o, d = make_rays(rng, 256)
    tm = _mixed_tmax(rng, 256)
    kernels.reset_counters()
    a = traverse.closest_hit(_t(o), _t(d), _t(tm), nodes, tris)
    b = traverse.closest_hit_plain(_t(o), _t(d), _t(tm), nodes, tris)
    traverse.any_hit(_t(o), _t(d), _t(tm), nodes, tris)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert kernels.TWIN_CALLS == dict(dict.fromkeys(kernels.LAUNCHES, 0),
                                       closest=1, anyhit=1)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_hit_attributes_reproduce_the_twins_hits():
    """Re-testing each hit's own packed triangle gives back exactly the
    twin's t, u, v (the check the card applies to the kernel's picks at
    ties)."""
    rng = np.random.default_rng(9)
    v0, v1, v2 = make_scene(rng, 2000)
    pk, _ = pack_scene(v0, v1, v2)
    nodes, tris = _t(pk["nodes"]), _t(pk["tris_bw"])
    o, d = (_t(x) for x in make_rays(rng, N_RAYS))
    t, tri, u, v = traverse.closest_hit_plain(
        o, d, _t(_mixed_tmax(rng, N_RAYS)), nodes, tris)
    hit = tri >= 0
    assert hit.sum() > N_RAYS // 4
    got = traverse.hit_attributes(o[hit], d[hit], tri[hit], tris)
    for g, want in zip(got, (t, u, v)):
        assert torch.equal(g, want[hit])


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity", "device"])
def test_wrappers_reject_bad_inputs(bad):
    rng = np.random.default_rng(8)
    v0, v1, v2 = make_scene(rng, 50)
    pk, _ = pack_scene(v0, v1, v2)
    nodes, tris = _t(pk["nodes"]), _t(pk["tris_bw"])
    o, d = make_rays(rng, 64)
    o, d, tm = _t(o), _t(d), torch.full((64,), 1e30)
    if bad == "shape":
        d = d[:32]
    elif bad == "dtype":
        tm = tm.double()
    elif bad == "contiguity":
        o = torch.cat([o, o], dim=1)[:, ::2]
    else:
        nodes = nodes.to("meta")
    with pytest.raises(ValueError):
        traverse.closest_hit(o, d, tm, nodes, tris)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def mixed_roots(rng, nodes, n):
    """Per-ray roots: a third node 0, a third another node, a third a leaf
    cluster (negative)."""
    ch = nodes[:, 48:56].cpu().numpy()
    leaves = ch[ch < 0]
    roots = np.zeros(n, np.int32)
    kind = rng.integers(0, 3, n)
    roots[kind == 1] = rng.integers(0, nodes.shape[0], int((kind == 1).sum()))
    roots[kind == 2] = rng.choice(leaves, int((kind == 2).sum()))
    return roots


def _assert_kernels_match_twins(o, d, tm, nodes, tris, roots=None):
    kernels.reset_counters()
    k = traverse.closest_hit(o, d, tm, nodes, tris, roots)
    p = traverse.closest_hit_plain(o, d, tm, nodes, tris, roots)
    occ_k = traverse.any_hit(o, d, tm, nodes, tris, roots)
    occ_p = traverse.anyhit_plain(o, d, tm, nodes, tris, roots)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(dict.fromkeys(kernels.LAUNCHES, 0),
                                     closest=1, anyhit=1)
    assert kernels.stack_overflows() == 0
    assert torch.equal(k[0], p[0])
    hit = p[1] >= 0
    assert torch.equal(k[1] >= 0, hit)
    same = hit & (k[1] == p[1])
    for j in (2, 3):
        assert torch.equal(k[j][same], p[j][same])
        assert (k[j][~hit] == 0).all()
    # Where the ids differ the t values are equal (asserted above), so the
    # kernel's pick must be a tie: its triangle hit at the same t, with
    # the u, v the kernel returned.
    diff = hit & ~same
    t_r, u_r, v_r = traverse.hit_attributes(o[diff], d[diff], k[1][diff],
                                            tris)
    assert torch.equal(t_r, k[0][diff])
    assert torch.equal(u_r, k[2][diff])
    assert torch.equal(v_r, k[3][diff])
    assert torch.equal(occ_k, occ_p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whole_tree", "rooted", "ray_counts"])
@pytest.mark.parametrize("n_tris", [37, 2000, 20_000])
def test_kernels_match_twins_on_the_card(cuda_device, n_tris, case):
    """Random rays in no order (make_rays), from node 0 or from per-ray
    node and leaf roots, and ray counts that fill no octet, warp or block
    (0, 1, 7, 33, 129) with and without roots."""
    rng = np.random.default_rng(99 + n_tris)
    v0, v1, v2 = make_scene(rng, n_tris)
    pk, _ = pack_scene(v0, v1, v2)
    nodes = _t(pk["nodes"]).to(cuda_device)
    tris = _t(pk["tris_bw"]).to(cuda_device)
    o, d = make_rays(rng, N_RAYS)
    tm = _mixed_tmax(rng, N_RAYS)
    if case != "whole_tree":
        tm[5] = np.nan      # dead, like t_max <= 0
    roots = _t(mixed_roots(rng, nodes, N_RAYS)).to(cuda_device)
    o, d, tm = (_t(x).to(cuda_device) for x in (o, d, tm))
    if case == "whole_tree":
        _assert_kernels_match_twins(o, d, tm, nodes, tris)
    elif case == "rooted":
        _assert_kernels_match_twins(o, d, tm, nodes, tris, roots)
    else:
        for n in (0, 1, 7, 33, 129):
            sub = [x[:n].contiguous() for x in (o, d, tm)]
            _assert_kernels_match_twins(*sub, nodes, tris)
            _assert_kernels_match_twins(*sub, nodes, tris,
                                        roots[:n].contiguous())
