"""The v1 closest-hit traversal of the PyTorch port (trace/traverse_v1.py)
against the JAX package's first-generation TPU kernel
(trace/pallas_traverse.py traverse_packets), run in Pallas interpret mode
on the same packed tables.

Tolerances, on tests/test_pallas.py's random scenes (37, 2,000 and 20,000
triangles, 1,024 rays) with infinite and with mixed finite/dead t_max:
hit sets equal, t to rtol 1e-5, u and v to 1e-5 absolute on at least 99%
of the hits and to 1e-4 on all of them, packed ids equal outside ties in
t (the packet walk tests every ray of a packet against every leaf any ray
wanted, so at an exact tie its id can differ from a per-ray walk's). Both
sides evaluate the same Moller-Trumbore expressions; the tolerances cover
XLA contracting float32 products into fused multiply-adds: u and v are
differences of products of size |o - v0| |d x e2| / |det| (origins 15
units from triangles of size 0.4), and the largest difference measured
is 2.1e-5, on 3 of 811 hits.

Also: the raw `tris` rows bit for bit against pack_scene_for_pallas; the
plain version against brute force; an independent scalar numpy walk that
pins the plain version (hits, ids and the pop and cluster counts of
walk_footprint_v1) exactly; one case of triangles so small that
|det| <= 1e-9 rejects what the Baldwin-Weber test of the second-generation
kernel (closest_hit_plain) accepts, so that difference is on record; the
stack a tree can ask for.

Under the `cuda` marker (skipped without a card): the CUDA kernel against
the plain version, which must agree exactly. Run it on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_traverse_v1.py
This module imports JAX only inside the tests that compare with it.
"""

import numpy as np
import pytest
import torch

from test_torch_traverse import _mixed_tmax, _t, make_rays, make_scene
from tracerboy_tpu_torch.accel.bvh import INVALID
from tracerboy_tpu_torch.accel.pack import pack_scene
from tracerboy_tpu_torch.trace import kernels, traverse, traverse_v1

torch.set_num_threads(2)

N_RAYS = 1024     # one packet of the TPU kernel
f32 = np.float32


def _tables(v0, v1, v2):
    """Port and JAX packings of the same triangles; nodes and the raw
    rows must be identical."""
    from tracerboy_tpu.trace.pallas_traverse import pack_scene_for_pallas

    pk, _ = pack_scene(v0, v1, v2, raw_rows=True)
    jpk, _ = pack_scene_for_pallas(v0, v1, v2)
    np.testing.assert_array_equal(pk["nodes"], np.asarray(jpk["nodes"]))
    np.testing.assert_array_equal(pk["tris"], np.asarray(jpk["tris"]))
    np.testing.assert_array_equal(pk["tri_map"], np.asarray(jpk["tri_map"]))
    return pk, jpk


def _packets(o, d, tm, jpk):
    import jax.numpy as jnp

    from tracerboy_tpu.trace.pallas_traverse import traverse_packets

    return tuple(np.asarray(x) for x in traverse_packets(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jpk,
        interpret=True))


def _assert_match(ref, got):
    t_r, tri_r, u_r, v_r = ref
    t_g, tri_g, u_g, v_g = (x.numpy() for x in got)
    hit = tri_r >= 0
    np.testing.assert_array_equal(tri_g >= 0, hit)
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=1e-5)
    np.testing.assert_array_equal(t_g[~hit], f32(1e30))
    # Ids may differ only at ties in t.
    diff = hit & (tri_g != tri_r)
    assert (np.abs(t_g - t_r)[diff] <= 1e-6 * np.abs(t_r[diff])).all()
    same = hit & ~diff
    for g, r in ((u_g, u_r), (v_g, v_r)):
        err = np.abs(g[same] - r[same])
        assert (err <= 1e-5).mean() >= 0.99
        assert err.max() <= 1e-4
    assert (u_g[~hit] == 0).all() and (v_g[~hit] == 0).all()


@pytest.mark.parametrize("finite", [False, True], ids=["inf", "mixed"])
@pytest.mark.parametrize("n_tris", [37, 2000, 20_000])
def test_plain_matches_the_tpu_kernel(n_tris, finite):
    rng = np.random.default_rng(1234 + n_tris)
    pk, jpk = _tables(*make_scene(rng, n_tris))
    o, d = make_rays(rng, N_RAYS)
    tm = (_mixed_tmax(rng, N_RAYS) if finite
          else np.full(N_RAYS, 1e30, f32))
    ref = _packets(o, d, tm, jpk)
    kernels.reset_counters()
    got = traverse_v1.closest_hit_v1(_t(o), _t(d), _t(tm), _t(pk["nodes"]),
                                     _t(pk["tris"]))
    assert kernels.TWIN_CALLS["closest_v1"] == 1
    assert kernels.LAUNCHES["closest_v1"] == 0
    assert kernels.stack_overflows() == 0
    assert int((ref[1] >= 0).sum()) >= 8
    if finite:
        live_hits = ref[1] >= 0
        assert (ref[0][live_hits] < tm[live_hits]).all()
        assert (got[1].numpy()[tm <= 0] == -1).all()
    _assert_match(ref, got)


@pytest.mark.parametrize("n_tris", [37, 2000])
def test_plain_matches_brute_force(n_tris):
    from tracerboy_tpu_torch.core.vec3 import V3
    from tracerboy_tpu_torch.trace.intersect import brute_force_closest_soa

    rng = np.random.default_rng(99 + n_tris)
    v0, v1, v2 = make_scene(rng, n_tris)
    pk, _ = pack_scene(v0, v1, v2, raw_rows=True)
    o, d = make_rays(rng, N_RAYS)
    tm = np.full(N_RAYS, 1e30, f32)
    t, tri, u, v = traverse_v1.closest_hit_v1_plain(
        _t(o), _t(d), _t(tm), _t(pk["nodes"]), _t(pk["tris"]))
    ot, dt = _t(o), _t(d)
    tb, trib, ub, vb = brute_force_closest_soa(
        V3(*(ot[:, k] for k in range(3))), V3(*(dt[:, k] for k in range(3))),
        _t(np.concatenate([v0, v1, v2], axis=1)))
    hit = trib.numpy() >= 0
    np.testing.assert_array_equal(tri.numpy() >= 0, hit)
    # The same Moller-Trumbore expressions on the same vertices.
    np.testing.assert_array_equal(t.numpy(), tb.numpy())
    mapped = pk["tri_map"][np.clip(tri.numpy(), 0, None)]
    diff = hit & (mapped != trib.numpy())
    assert diff.sum() <= 2      # ties in t only
    np.testing.assert_array_equal(u.numpy()[hit & ~diff],
                                  ub.numpy()[hit & ~diff])
    np.testing.assert_array_equal(v.numpy()[hit & ~diff],
                                  vb.numpy()[hit & ~diff])


def _scalar_walk(o, d, tm, nodes, tris):
    """One ray's v1 walk in float32 numpy scalars, written independently
    of the port: (t, tri, u, v, pops, clusters)."""
    if not tm > 0:
        return f32(1e30), -1, f32(0), f32(0), 0, 0
    eps = f32(1e-12)
    fix = [(-eps if x < 0 else eps) if abs(x) < eps else x for x in d]
    inv = [f32(1.0) / x for x in fix]
    box = nodes[:, :48].view(f32)
    best, tri_best, ub, vb = f32(tm), -1, f32(0), f32(0)
    stack, pops, clusters = [0], 0, 0
    while stack:
        node = stack.pop()
        pops += 1
        for c in range(8):
            cid = int(nodes[node, 48 + c])
            if cid == INVALID:
                continue
            t0 = [(box[node, 8 * k + c] - o[k]) * inv[k] for k in range(3)]
            t1 = [(box[node, 24 + 8 * k + c] - o[k]) * inv[k]
                  for k in range(3)]
            t_near = max(max(min(t0[0], t1[0]), min(t0[1], t1[1])),
                         min(t0[2], t1[2]))
            t_far = min(min(max(t0[0], t1[0]), max(t0[1], t1[1])),
                        max(t0[2], t1[2]))
            if not (t_far >= max(t_near, f32(0)) and t_near < best):
                continue
            if cid >= 0:
                stack.append(cid)
                continue
            clusters += 1
            row = tris[-cid - 1]
            for k in range(8):
                a, b, cc = row[9 * k:9 * k + 3], row[9 * k + 3:9 * k + 6], \
                    row[9 * k + 6:9 * k + 9]
                e1, e2 = b - a, cc - a
                p = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                     d[0] * e2[1] - d[1] * e2[0]]
                det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
                if not abs(det) > f32(1e-9):
                    continue
                inv_det = f32(1.0) / det
                tv = o - a
                uu = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv_det
                q = [tv[1] * e1[2] - tv[2] * e1[1],
                     tv[2] * e1[0] - tv[0] * e1[2],
                     tv[0] * e1[1] - tv[1] * e1[0]]
                vv = (d[0] * q[0] + d[1] * q[1] + d[2] * q[2]) * inv_det
                tt = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv_det
                if (uu >= 0 and vv >= 0 and uu + vv <= f32(1.0)
                        and tt > f32(1e-5) and tt < best):
                    best, tri_best, ub, vb = tt, (-cid - 1) * 8 + k, uu, vv
    return (best if tri_best >= 0 else f32(1e30)), tri_best, ub, vb, pops, \
        clusters


def test_scalar_walk_pins_the_plain_version():
    rng = np.random.default_rng(5)
    pk, _ = pack_scene(*make_scene(rng, 2000), raw_rows=True)
    o, d = make_rays(rng, 64)
    tm = _mixed_tmax(rng, 64)
    args = (_t(o), _t(d), _t(tm), _t(pk["nodes"]), _t(pk["tris"]))
    t, tri, u, v = (x.numpy() for x in
                    traverse_v1.closest_hit_v1_plain(*args))
    node_rows, cl_rows, pops, clusters = traverse_v1.walk_footprint_v1(*args)
    assert (tri >= 0).sum() >= 8
    with np.errstate(over="ignore", invalid="ignore"):
        for i in range(64):
            ref = _scalar_walk(o[i], d[i], tm[i], pk["nodes"], pk["tris"])
            assert (t[i], tri[i], u[i], v[i], int(pops[i]),
                    int(clusters[i])) == ref, i
    assert int(node_rows.sum()) > 0 and int(cl_rows.sum()) > 0
    assert int(pops[tm <= 0].sum()) == 0


def test_small_triangles_v1_misses_what_kernel_1_hits():
    """Triangles of edge 1e-5: |det| = |e1 . (d x e2)| ~ 1e-10 <= 1e-9, so
    the Moller-Trumbore test rejects every one of them, while the
    Baldwin-Weber rows (degenerate only below n.n = 1e-24) accept them."""
    rng = np.random.default_rng(3)
    n = 64
    c = ((rng.random((n, 3)) - 0.5) * 2).astype(f32)
    v0 = c
    v1 = (c + np.array([1e-5, 0, 0], f32)).astype(f32)
    v2 = (c + np.array([0, 1e-5, 0], f32)).astype(f32)
    pk, _ = pack_scene(v0, v1, v2, raw_rows=True)
    # One ray per triangle, along -z through a point well inside it.
    inside = (v0.astype(np.float64) * 0.5 + v1 * 0.25 + v2 * 0.25)
    o = (inside + np.array([0, 0, 3.0])).astype(f32)
    d = np.tile(np.array([0, 0, -1], f32), (n, 1))
    tm = np.full(n, 1e30, f32)
    rays = (_t(o), _t(d), _t(tm), _t(pk["nodes"]))
    hit_1 = traverse.closest_hit_plain(*rays, _t(pk["tris_bw"]))[1] >= 0
    hit_v1 = traverse_v1.closest_hit_v1_plain(*rays, _t(pk["tris"]))[1] >= 0
    assert int(hit_1.sum()) >= n // 2
    assert int(hit_v1.sum()) == 0


def test_stack_need_covers_the_trees():
    rng = np.random.default_rng(8)
    for n_tris in (8, 2000, 20_000):
        pk, _ = pack_scene(*make_scene(rng, n_tris), raw_rows=True)
        need = traverse.stack_need(_t(pk["nodes"]))
        assert 8 <= need <= traverse_v1.STACK_DEPTH, (n_tris, need)


def test_wrong_table_shape_raises():
    rng = np.random.default_rng(2)
    pk, _ = pack_scene(*make_scene(rng, 37), raw_rows=True)
    o, d = make_rays(rng, 8)
    with pytest.raises(ValueError):
        traverse_v1.closest_hit_v1(_t(o), _t(d), _t(np.ones(8, f32)),
                                   _t(pk["nodes"]), _t(pk["tris"][:, :72]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [37, 2000, 20_000])
def test_kernel_matches_plain_on_the_card(cuda_device, n_tris):
    rng = np.random.default_rng(77 + n_tris)
    pk, _ = pack_scene(*make_scene(rng, n_tris), raw_rows=True)
    o, d = make_rays(rng, 65_536)
    tm = _mixed_tmax(rng, 65_536)
    args = tuple(_t(x).to(cuda_device)
                 for x in (o, d, tm, pk["nodes"], pk["tris"]))
    kernels.reset_counters()
    k = traverse_v1.closest_hit_v1(*args)
    assert kernels.LAUNCHES["closest_v1"] == 1
    p = traverse_v1.closest_hit_v1_plain(*args)
    torch.cuda.synchronize()
    assert kernels.stack_overflows() == 0
    for a, b in zip(k, p):
        assert torch.equal(a, b)
