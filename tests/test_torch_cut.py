"""The binned-subtree ("cut") path of the PyTorch port (trace/cut.py, and
the per-ray roots of trace/traverse.py) against the JAX package.

Inputs: tests/test_cut.py's scene (4,096 random triangles, cut at 512)
and 1,024 random rays from inside it, of which a third have t_max 0 or a
finite cap. The JAX kernels run in Pallas interpret mode with SUB = 8
(1,024-ray packets), computed once per module.

- build_cut and subtree_tri_counts: bit for bit.
- emit_cuts (its plain twin on the CPU) against emit_packets2: the sorted
  per-ray sets equal on >= 99.9% of live rays, and every ray that differs
  still gets closest_hit's hit through traverse_binned2. The twin
  reproduces the kernels' slot order, which is compared too.
- Per-ray roots: closest_hit_plain / anyhit_plain with each ray rooted at
  its packet's root against traverse_packets2 / anyhit_packets2 with the
  same packet_roots, on the JAX pipeline's own binned phase-2 inputs.
- traverse_binned2 / anyhit_binned2 against the JAX functions (hit and
  occlusion masks equal; t to rtol 1e-5 and atol 1e-5, ids equal but at
  ties, u, v to 1e-3: XLA contracts and
  reorders the float32 products, see _assert_matches_jax) and
  against the port's own whole-tree closest_hit / any_hit, which evaluate
  the same expressions: t and ids equal bit for bit outside ties, u, v to
  1e-6.
- Under the `cuda` marker (skipped without a card): the emit kernel and
  the rooted traversal kernels against their twins; run them on the card
  with  python -m pytest --noconftest -m cuda tests/test_torch_cut.py
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.accel.pack import pack_scene
from tracerboy_tpu_torch.trace import cut, kernels, traverse

torch.set_num_threads(2)

SUB = 8          # JAX packet height: 1,024-ray packets
K = 8            # the wave's TB_CUT_K
N_RAYS = 1024


def make_scene(n_tris=4096, seed=3):
    """tests/test_cut.py's scene."""
    rng = np.random.default_rng(seed)
    c = rng.random((n_tris, 3), np.float32) * 20.0
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.4
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.4
    return c, c + e1, c + e2


def make_rays(n=N_RAYS, seed=5):
    """tests/test_cut.py's rays, a third of them dead or capped."""
    rng = np.random.default_rng(seed)
    o = rng.random((n, 3), np.float32) * 20.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full((n,), 1e30, np.float32)
    tm[::6] = 0.0
    tm[3::6] = (rng.random(len(tm[3::6])) * 6.0).astype(np.float32)
    return o, d, tm


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


@pytest.fixture(scope="module")
def tables():
    v0, v1, v2 = make_scene()
    pk, bvh = pack_scene(v0, v1, v2)
    tc = cut.build_cut(pk["nodes"], bvh.children, bvh.leaf_size, 512)
    return dict(pk=pk, bvh=bvh, cut=tc, tris=(v0, v1, v2),
                nodes=_t(pk["nodes"]), tris_bw=_t(pk["tris_bw"]),
                top=_t(tc["top_nodes"]), roots=_t(tc["roots"]))


@pytest.fixture(scope="module")
def jax_ref(tables):
    """The JAX package's cut pipeline on the module's rays: emit ids, the
    phase-2 inputs with their packet roots, the phase-2 results, and the
    whole traverse_binned2 / anyhit_binned2."""
    import jax.numpy as jnp

    from tracerboy_tpu.trace import cut as jcut
    from tracerboy_tpu.trace import pallas_traverse2 as pt2
    from tracerboy_tpu.trace.pallas_traverse import pack_scene_for_pallas

    jpk, _ = pack_scene_for_pallas(*tables["tris"])
    np.testing.assert_array_equal(np.asarray(jpk["nodes"]),
                                  tables["pk"]["nodes"])
    jpk = dict(jpk, cut_top=jnp.asarray(tables["cut"]["top_nodes"]),
               cut_roots=jnp.asarray(tables["cut"]["roots"]))
    S = tables["cut"]["n_cuts"]
    o, d, tm = (jnp.asarray(x) for x in make_rays())
    ids = pt2.emit_packets2(o, d, tm, jpk["cut_top"], n_cuts=S, K=K,
                            interpret=True, sub=SUB)
    o_s, d_s, t_s, _, pk_seg = jcut._bin_pairs_sorted(ids, o, d, tm, S,
                                                      SUB * 128)
    pk_root = jpk["cut_roots"][pk_seg]
    phase2 = pt2.traverse_packets2(o_s, d_s, t_s, jpk, interpret=True,
                                   sub=SUB, packet_roots=pk_root)
    occ2 = pt2.anyhit_packets2(o_s, d_s, t_s, jpk, interpret=True, sub=SUB,
                               packet_roots=pk_root)
    closest = jcut.traverse_binned2(o, d, tm, jpk, K=K, interpret=True,
                                    sub=SUB)
    occ = jcut.anyhit_binned2(o, d, tm, jpk, K=K, interpret=True, sub=SUB)
    a = np.asarray
    return dict(ids=a(ids), o_s=a(o_s), d_s=a(d_s), t_s=a(t_s),
                pk_root=a(pk_root), phase2=tuple(a(x) for x in phase2),
                occ2=a(occ2), closest=tuple(a(x) for x in closest),
                occ=a(occ))


def _port_rays():
    return tuple(_t(x) for x in make_rays())


def _assert_matches_jax(ref, got):
    """test_torch_traverse.py's _assert_closest_match, with t's absolute
    bound widened from 1e-6 to 1e-5 for these rays, which start inside
    the triangle cloud: t = -(n.o - d) / (n.dir) then sums terms of size
    |n| |o| (o up to 20 from the origin) to small results, and XLA rounds
    the products differently (measured 1.34e-6 at t = 0.0062, against
    the packet kernel in interpret mode)."""
    t_r, tri_r = np.asarray(ref[0]), np.asarray(ref[1])
    t_g, tri_g = got[0].numpy(), got[1].numpy()
    hit = tri_r >= 0
    np.testing.assert_array_equal(tri_g >= 0, hit)
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_g[~hit], np.float32(1e30))
    # Ids may differ only at ties: two triangles hit at the same t.
    diff = hit & (tri_g != tri_r)
    assert (np.abs(t_g - t_r)[diff] <= 1e-6 * np.abs(t_r[diff])).all()
    same = hit & ~diff
    for k in (2, 3):          # u, v: _assert_closest_match's 1e-3
        np.testing.assert_allclose(got[k].numpy()[same],
                                   np.asarray(ref[k])[same], rtol=0,
                                   atol=1e-3)


def test_build_cut_matches_jax(tables):
    from tracerboy_tpu.trace import cut as jcut

    pk, bvh = tables["pk"], tables["bvh"]
    np.testing.assert_array_equal(
        cut.subtree_tri_counts(bvh.children, bvh.leaf_size),
        jcut.subtree_tri_counts(bvh.children, bvh.leaf_size))
    for cut_tris in (64, 512):
        got = cut.build_cut(pk["nodes"], bvh.children, bvh.leaf_size,
                            cut_tris)
        ref = jcut.build_cut(pk["nodes"], bvh.children, bvh.leaf_size,
                             cut_tris)
        assert got["n_cuts"] == ref["n_cuts"]
        for key in ("top_nodes", "roots"):
            assert got[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(got[key], ref[key])


def test_emit_matches_jax(tables, jax_ref):
    o, d, tm = _port_rays()
    S = tables["cut"]["n_cuts"]
    kernels.reset_counters()
    ids = cut.emit_cuts(o, d, tm, tables["top"], S, K).numpy()
    assert kernels.TWIN_CALLS["emit"] == 1 and kernels.LAUNCHES["emit"] == 0
    ref = jax_ref["ids"]
    live = tm.numpy() > 0
    assert (ids[~live] == -1).all()
    same_set = np.array([sorted(a) == sorted(b) for a, b in zip(ids, ref)])
    assert same_set[live].mean() >= 0.999, same_set[live].mean()
    # Measured: the sets and the slot order agree on every ray here.
    assert (ids == ref).all(axis=1)[live].mean() >= 0.999
    assert ((ids[:, K - 1] == S) == (ref[:, K - 1] == S)).mean() >= 0.999
    # A ray whose set differs (slab rounding at a shared face) must still
    # find the whole tree's closest hit.
    diff = torch.from_numpy(np.flatnonzero(~same_set))
    if diff.numel():
        got = cut.traverse_binned2(o[diff], d[diff], tm[diff],
                                   tables["nodes"], tables["tris_bw"],
                                   tables["top"], tables["roots"], K=K)
        want = traverse.closest_hit(o[diff], d[diff], tm[diff],
                                    tables["nodes"], tables["tris_bw"])
        assert torch.equal(got[0], want[0])


def test_emit_twin_overflow_and_order():
    """K = 2 on the module's scene: rays with more than two subtrees hold
    n_cuts in the last slot; the first slot is the first subtree the
    kernel would append."""
    v0, v1, v2 = make_scene()
    pk, bvh = pack_scene(v0, v1, v2)
    tc = cut.build_cut(pk["nodes"], bvh.children, bvh.leaf_size, 512)
    o, d, tm = _port_rays()
    S = tc["n_cuts"]
    ids8 = cut.emit_cuts_plain(o, d, tm, _t(tc["top_nodes"]), S, 8)
    ids2 = cut.emit_cuts_plain(o, d, tm, _t(tc["top_nodes"]), S, 2)
    n8 = (ids8 >= 0).sum(1)
    many = n8 > 2
    assert many.any() and not (ids8 == S).all(1).any()
    assert torch.equal(ids2[:, 0], ids8[:, 0])
    assert (ids2[many, 1] == S).all()
    two = n8 == 2
    assert torch.equal(ids2[two], ids8[two, :2])


def test_per_ray_roots_match_jax_packet_roots(tables, jax_ref):
    """Each ray of the JAX phase 2 rooted at its packet's root."""
    o, d, tm = (_t(jax_ref[k]) for k in ("o_s", "d_s", "t_s"))
    roots = _t(np.repeat(jax_ref["pk_root"], SUB * 128).astype(np.int32))
    assert (roots > 0).any()      # subtree roots; leaf roots are below
    got = traverse.closest_hit(o, d, tm, tables["nodes"], tables["tris_bw"],
                               roots)
    _assert_matches_jax(jax_ref["phase2"], got)
    occ = traverse.any_hit(o, d, tm, tables["nodes"], tables["tris_bw"],
                           roots).numpy()
    np.testing.assert_array_equal(occ, jax_ref["occ2"])


def test_leaf_and_node_roots_restrict_the_twins(tables):
    """A leaf root tests only its cluster's 8 triangles, with no box
    test; a node root reaches only the clusters of its subtree."""
    nodes, tris = tables["nodes"], tables["tris_bw"]
    o, d, tm = _port_rays()
    tw, triw, uw, vw = traverse.closest_hit_plain(o, d, tm, nodes, tris)
    hit = triw >= 0
    # Rooted at the cluster of its whole-tree hit, a ray finds that hit.
    leaf = torch.where(hit, torch.div(triw, 8, rounding_mode="floor"), 0)
    got = traverse.closest_hit_plain(o, d, tm, nodes, tris,
                                     (-leaf - 1).to(torch.int32))
    for g, w in zip(got, (tw, triw, uw, vw)):
        assert torch.equal(g[hit], w[hit])
    assert torch.equal(traverse.anyhit_plain(
        o, d, tm, nodes, tris, (-leaf - 1).to(torch.int32))[hit],
        torch.ones(int(hit.sum()), dtype=torch.bool))
    # Rooted at a cluster, a ray hits nothing outside it.
    other = (leaf + 1) % tris.shape[0]
    got = traverse.closest_hit_plain(o, d, tm, nodes, tris,
                                     (-other - 1).to(torch.int32))
    h = got[1] >= 0
    assert torch.equal(torch.div(got[1][h], 8, rounding_mode="floor"),
                       other[h])
    # A node root: the hit lies in that node's subtree, and it is the
    # whole tree's hit whenever the whole tree's hit lies there.
    perm, start, end = traverse.subtree_clusters(nodes)
    node = int(np.argmax((end - start) < tris.shape[0] // 2))
    mine = torch.zeros(tris.shape[0], dtype=torch.bool)
    mine[torch.from_numpy(perm[start[node]:end[node]])] = True
    roots = torch.full((o.shape[0],), node, dtype=torch.int32)
    t, tri, _, _ = traverse.closest_hit_plain(o, d, tm, nodes, tris, roots)
    assert mine[torch.div(tri[tri >= 0], 8, rounding_mode="floor")].all()
    inside = hit & mine[leaf]
    assert inside.any()
    assert torch.equal(t[inside], tw[inside])


def test_traverse_binned2_matches_jax_and_whole_tree(tables, jax_ref):
    o, d, tm = _port_rays()
    args = (tables["nodes"], tables["tris_bw"], tables["top"],
            tables["roots"])
    got = cut.traverse_binned2(o, d, tm, *args, K=K)
    _assert_matches_jax(jax_ref["closest"], got)
    # The port's own whole-tree traversal: the same expressions.
    want = traverse.closest_hit(o, d, tm, tables["nodes"], tables["tris_bw"])
    assert torch.equal(got[1] >= 0, want[1] >= 0)
    assert torch.equal(got[0], want[0])
    same = got[1] == want[1]
    tie = ~same & (got[0] == want[0])
    assert (same | tie).all()
    for k in (2, 3):
        assert (got[k] - want[k])[same].abs().max() <= 1e-6
    assert (got[1][tm <= 0] == -1).all()
    # plain=True takes the twins throughout: the same result on the CPU.
    plain = cut.traverse_binned2(o, d, tm, *args, K=K, plain=True)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)


def test_anyhit_binned2_matches_jax_and_whole_tree(tables, jax_ref):
    o, d, tm = _port_rays()
    args = (tables["nodes"], tables["tris_bw"], tables["top"],
            tables["roots"])
    occ = cut.anyhit_binned2(o, d, tm, *args, K=K)
    np.testing.assert_array_equal(occ.numpy(), jax_ref["occ"])
    want = traverse.any_hit(o, d, tm, tables["nodes"], tables["tris_bw"])
    assert torch.equal(occ, want)
    assert not occ[tm <= 0].any()


def test_small_k_overflow_still_exact(tables):
    """K = 2 sends many rays to the whole-tree root (test_cut.py's
    case): the hits stay the whole tree's."""
    o, d, tm = _port_rays()
    cut.reset_stats()
    got = cut.traverse_binned2(o, d, tm, tables["nodes"], tables["tris_bw"],
                               tables["top"], tables["roots"], K=2)
    assert int(cut.STATS["overflow_rays"]) > 0
    assert int(cut.STATS["rays"]) == int((tm > 0).sum())
    want = traverse.closest_hit(o, d, tm, tables["nodes"], tables["tris_bw"])
    assert torch.equal(got[0], want[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cut_kernels_match_twins_on_the_card(cuda_device):
    dev = cuda_device
    v0, v1, v2 = make_scene()
    pk, bvh = pack_scene(v0, v1, v2)
    tc = cut.build_cut(pk["nodes"], bvh.children, bvh.leaf_size, 512)
    nodes, tris, top, roots = (_t(x).to(dev) for x in (
        pk["nodes"], pk["tris_bw"], tc["top_nodes"], tc["roots"]))
    o, d, tm = (_t(x).to(dev) for x in make_rays(4096, seed=9))
    S = tc["n_cuts"]
    kernels.reset_counters()
    for k in (2, K):
        ids = cut.emit_cuts(o, d, tm, top, S, k)
        assert torch.equal(ids, cut.emit_cuts_plain(o, d, tm, top, S, k))
    # Rooted kernels: every pair of the cut path, then random leaf roots.
    pos, key = kernels.bin_pairs(cut.emit_cuts(o, d, tm, top, S, K))
    ray = torch.div(pos, K, rounding_mode="floor")
    pr = roots[key.long()]
    rng = np.random.default_rng(2)
    leaf = -torch.from_numpy(rng.integers(0, tris.shape[0], o.shape[0])
                             ).to(dev, torch.int32) - 1
    for args in ((o[ray], d[ray], tm[ray], pr), (o, d, tm, leaf)):
        oo, dd, tt, rr = args
        kc = traverse.closest_hit(oo, dd, tt, nodes, tris, rr)
        pc = traverse.closest_hit_plain(oo, dd, tt, nodes, tris, rr)
        assert torch.equal(kc[0], pc[0])
        same = kc[1] == pc[1]
        t_r, _, _ = traverse.hit_attributes(oo[~same], dd[~same],
                                            kc[1][~same], tris)
        assert torch.equal(t_r, kc[0][~same])        # ties only
        for j in (2, 3):
            assert torch.equal(kc[j][same], pc[j][same])
        assert torch.equal(traverse.any_hit(oo, dd, tt, nodes, tris, rr),
                           traverse.anyhit_plain(oo, dd, tt, nodes, tris, rr))
    got = cut.traverse_binned2(o, d, tm, nodes, tris, top, roots, K=K)
    want = traverse.closest_hit(o, d, tm, nodes, tris)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert kernels.stack_overflows() == 0
    assert kernels.LAUNCHES["emit"] >= 3 and kernels.LAUNCHES["closest"] >= 3
