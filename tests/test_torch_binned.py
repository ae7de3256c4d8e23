"""The binned-cluster backend of the PyTorch port (trace/binned.py,
accel/bvh.py's build_bvh, the raw rows of accel/pack.py) against the JAX
package.

Inputs: tests/test_binned.py's scenes (tests/test_pallas.py's random
triangles) and 2,048 random rays aimed into them, a third of them with
t_max 0 or a finite cap. The JAX kernels run in Pallas interpret mode,
computed once per module.

- build_bvh (the numpy LBVH), the raw 9-float rows and pack_scene_binned:
  bit for bit.
- select_clusters (its plain twin on the CPU) against the JAX kernel:
  slot sets equal; the twin's dropped holds K-th nearest entry t <=
  dropped <= the entry t of every entered cluster outside the set.
- dense_pairs (its twin) against the JAX kernel on the same sorted pairs:
  hit masks equal, ids equal but at ties, t to rtol 1e-5 and atol 1e-5
  (measured at most 2.2e-5 relative, 1.1e-6 absolute: XLA evaluates the
  4-term products in another order than the written-out twin, and t =
  -A / B cancels for rays near a triangle's plane) and u, v to 1e-3
  (measured 1.1e-4: the terms |g1| |o| are large beside u in [0, 1]).
- binned_closest against the JAX binned_closest and against the port's
  whole-tree closest_hit, both to the same tolerances. Against
  closest_hit they are not bit for bit: the binned tables hold the
  Baldwin-Weber rows of the float32 vertices and the traversal tables
  those of the float64 ones (as in the JAX package), and dense t is a
  division where the traversal multiplies by 1/B (measured 9.7e-7
  absolute at t = 0.0137).
- Under the `cuda` marker (skipped without a card): the selection and
  dense kernels against their twins; run them on the card with
      python -m pytest --noconftest -m cuda tests/test_torch_binned.py
"""

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch.accel.bvh import build_bvh
from tracerboy_tpu_torch.accel.pack import pack_scene
from tracerboy_tpu_torch.trace import binned, kernels, traverse
from tracerboy_tpu_torch.trace.kernels import bin_pairs

torch.set_num_threads(2)

N_RAYS = 2048            # one JAX selection packet


def make_scene(rng, n, spread=10.0, size=0.4):
    """tests/test_pallas.py's random triangles."""
    base = (rng.random((n, 3)) - 0.5).astype(np.float32) * spread
    v1 = base + rng.normal(size=(n, 3)).astype(np.float32) * size
    v2 = base + rng.normal(size=(n, 3)).astype(np.float32) * size
    return base, v1.astype(np.float32), v2.astype(np.float32)


def make_rays(rng, n_rays=N_RAYS, toward=8.0, spread=30.0):
    """tests/test_pallas.py's rays, a third of them dead or capped."""
    o = ((rng.random((n_rays, 3)) - 0.5) * spread).astype(np.float32)
    tgt = ((rng.random((n_rays, 3)) - 0.5) * toward).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n_rays, 1e30, np.float32)
    tm[::6] = 0.0
    tm[3::6] = (10.0 + rng.random(len(tm[3::6])) * 15.0).astype(np.float32)
    return o, d.astype(np.float32), tm


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


def port_tables(v0, v1, v2):
    pk, _ = pack_scene(v0, v1, v2, raw_rows=True)
    scene = {k: _t(v) for k, v in binned.pack_scene_binned(pk["tris"]).items()}
    scene.update(pk_nodes=_t(pk["nodes"]), pk_tris_bw=_t(pk["tris_bw"]))
    return pk, scene


def jax_scene(v0, v1, v2):
    """The JAX package's packed and binned tables (test_binned.make_env)."""
    import jax.numpy as jnp

    from tracerboy_tpu.trace.binned import pack_scene_binned
    from tracerboy_tpu.trace.pallas_traverse import pack_scene_for_pallas

    packed, _ = pack_scene_for_pallas(v0, v1, v2)
    return packed, dict(
        pk_nodes=packed["nodes"], pk_tris_bw=packed["tris_bw"],
        world_lo=jnp.asarray(np.minimum(np.minimum(v0, v1), v2).min(0)),
        world_hi=jnp.asarray(np.maximum(np.maximum(v0, v1), v2).max(0)),
        **pack_scene_binned(packed["tris"]),
    )


def assert_matches_jax(ref, got):
    """Hit masks equal; t to rtol 1e-5, atol 1e-5; ids equal but at ties;
    u, v to 1e-3 (the module docstring gives the measured causes)."""
    t_r, tri_r = (np.asarray(x) for x in ref[:2])
    t_g, tri_g = (x.numpy() for x in got[:2])
    hit = tri_r >= 0
    np.testing.assert_array_equal(tri_g >= 0, hit)
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=1e-5, atol=1e-5)
    assert (t_g[~hit] == np.float32(1e30)).all()
    diff = hit & (tri_g != tri_r)
    assert (np.abs(t_g - t_r)[diff] <= 1e-6 * np.abs(t_r[diff])).all()
    same = hit & ~diff
    for k in (2, 3):
        np.testing.assert_allclose(got[k].numpy()[same],
                                   np.asarray(ref[k])[same], rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("leaf_size,n", [(1, 333), (4, 5000), (8, 1)])
def test_build_bvh_matches_jax(leaf_size, n):
    from tracerboy_tpu.accel.bvh import build_bvh as jbuild

    v0, v1, v2 = make_scene(np.random.default_rng(n), n)
    got, ref = build_bvh(v0, v1, v2, leaf_size), jbuild(v0, v1, v2, leaf_size)
    for f in ("bounds_lo", "bounds_hi", "children", "tri_order", "world_lo",
              "world_hi"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("leaf_size", "num_tris", "num_clusters"):
        assert getattr(got, f) == getattr(ref, f)


@pytest.mark.parametrize("n_tris", [300, 5000])
def test_raw_rows_and_binned_tables_match_jax(n_tris):
    from tracerboy_tpu.trace.binned import pack_scene_binned as jpack
    from tracerboy_tpu.trace.pallas_traverse import pack_scene_for_pallas

    v0, v1, v2 = make_scene(np.random.default_rng(n_tris), n_tris)
    pk, _ = pack_scene(v0, v1, v2, raw_rows=True)
    jpk, _ = pack_scene_for_pallas(v0, v1, v2)
    np.testing.assert_array_equal(pk["tris"], np.asarray(jpk["tris"]))
    assert "tris" not in pack_scene(v0, v1, v2)[0]
    got, ref = binned.pack_scene_binned(pk["tris"]), jpack(jpk["tris"])
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


@pytest.fixture(scope="module")
def env():
    """test_binned.py's 5,000-triangle scene, the module's rays, and the
    JAX selection and binned_closest on them."""
    import jax.numpy as jnp

    from tracerboy_tpu.trace import binned as jbn

    rng = np.random.default_rng(1234)
    tris = make_scene(rng, 5000)
    o, d, tm = make_rays(rng)
    pk, scene = port_tables(*tris)
    _, jscene = jax_scene(*tris)
    sub, lanes = jbn.SUB, jbn.LANES
    o_t, d_t = (jnp.asarray(x.T.reshape(3, 1, sub, lanes).swapaxes(0, 1))
                for x in (o, d))
    tm_t = jnp.asarray(tm.reshape(1, sub, lanes))
    st, sc, dr = jbn.select_clusters(o_t, d_t, tm_t, jnp.zeros_like(tm_t),
                                     jscene["bn_nodes"], K=binned.KSEL,
                                     interpret=True)
    slots = np.stack([np.asarray(sc)[0, k * sub:(k + 1) * sub].reshape(-1)
                      for k in range(binned.KSEL)], axis=1)
    closest = jbn.binned_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tm), interpret=True)
    return dict(tris=tris, rays=(_t(o), _t(d), _t(tm)), scene=scene,
                jscene=jscene, jslots=slots,
                jdropped=np.asarray(dr).reshape(-1),
                jclosest=tuple(np.asarray(x) for x in closest))


def _entries(o, d, tm, nodes):
    """Every (ray, cluster) entry t by an exhaustive box test (1e30 where
    the ray does not enter the cluster within t_max)."""
    n_cl = binned.n_clusters(nodes)
    lo, hi = traverse.cluster_boxes(nodes, n_cl)
    t_near, t_far = traverse.box_entry(o[:, None], 1.0 / traverse.fix_dir(
        d)[:, None], lo[None], hi[None])
    entry = torch.clamp_min(t_near, 0.0)
    hit = (t_far >= entry) & (entry < tm[:, None]) & (tm[:, None] > 0)
    return torch.where(hit, entry, 1e30)


def test_select_matches_jax(env):
    o, d, tm = env["rays"]
    kernels.reset_counters()
    slot_t, slot_c, dropped = binned.select_clusters(o, d, tm,
                                                     env["scene"]["bn_nodes"])
    assert kernels.TWIN_CALLS["select"] == 1
    got = slot_c.numpy()
    same = np.array([set(a[a >= 0]) == set(b[b >= 0])
                     for a, b in zip(got, env["jslots"])])
    assert same.all(), np.flatnonzero(~same)[:10]
    live = tm > 0
    assert (slot_c[~live] == -1).all() and (dropped[~live] == 1e30).all()
    # The dropped bound, against an exhaustive box test.
    entry = _entries(o, d, tm, env["scene"]["bn_nodes"])
    full = (slot_c >= 0).all(1)
    kth = torch.where(full, slot_t.max(1).values, 1e30)
    assert (kth <= dropped).all()
    outside = entry.clone()
    rows = torch.arange(o.shape[0])[:, None].expand_as(slot_c)
    outside[rows[slot_c >= 0], slot_c[slot_c >= 0].long()] = 1e30
    assert (dropped <= outside.min(1).values).all()
    assert (dropped < 1e30).any()
    assert torch.equal(slot_t, torch.where(slot_c >= 0, entry.gather(
        1, slot_c.clamp_min(0).long()), 1e30))


def _sorted_pairs(o, d, tm, slot_c):
    """The (ray, cluster) pairs of all slots, sorted by cluster."""
    pos, cl = bin_pairs(slot_c)
    ray = torch.div(pos, slot_c.shape[1], rounding_mode="floor")
    return o[ray], d[ray], tm[ray], cl


def jax_dense(o, d, cap, cl, jscene):
    """The JAX dense kernel on sorted pairs, with binned_closest's segment
    tables (one run per cluster, pairs padded to whole tiles)."""
    import jax.numpy as jnp

    from tracerboy_tpu.trace import binned as jbn

    M = o.shape[0]
    n_cl = int(jscene["bn_mot"].shape[0])
    Mp = -(-M // jbn.TILE_P) * jbn.TILE_P
    key = np.concatenate([cl, np.full(Mp - M, n_cl, np.int32)])
    rank = np.cumsum(np.concatenate([[1], key[1:] != key[:-1]])) - 1
    seg_start = np.searchsorted(rank, np.arange(n_cl + 2)).astype(np.int32)
    rank_cluster = key[np.clip(seg_start[:-1], 0, Mp - 1)].astype(np.int32)
    base = np.asarray(jscene["bn_base"])
    rank_base = np.where(rank_cluster < n_cl,
                         base[np.clip(rank_cluster, 0, n_cl)], -1)

    def pad(x, v):
        return np.concatenate([x, np.full(Mp - M, v, np.float32)])

    rays8 = np.stack([pad(o[:, 0], 0), pad(o[:, 1], 0), pad(o[:, 2], 0),
                      pad(d[:, 0], 1), pad(d[:, 1], 0), pad(d[:, 2], 0),
                      pad(cap, 0), rank.astype(np.int32).view(np.float32)])
    out = np.asarray(jbn.dense_pairs(
        jnp.asarray(rays8), jnp.asarray(rank[::jbn.TILE_P].astype(np.int32)),
        jnp.asarray(seg_start), jnp.asarray(rank_base.astype(np.int32)),
        jnp.asarray(rank_cluster), jscene["bn_mot"], n_cl=n_cl,
        interpret=True))
    assert (out[4, :M] == 1.0).all()          # every pair covered
    return out[0, :M], out[1, :M].view(np.int32), out[2, :M], out[3, :M]


def test_dense_matches_jax(env):
    o, d, tm = env["rays"]
    _, slot_c, _ = binned.select_clusters_plain(o, d, tm,
                                                env["scene"]["bn_nodes"])
    po, pd, pc, cl = _sorted_pairs(o, d, tm, slot_c)
    assert cl.shape[0] > 10_000
    kernels.reset_counters()
    got = binned.dense_pairs(po, pd, pc, cl, env["scene"]["bn_mot"],
                             env["scene"]["bn_base"])
    assert kernels.TWIN_CALLS["dense"] == 1
    ref = jax_dense(po.numpy(), pd.numpy(), pc.numpy(), cl.numpy(),
                    env["jscene"])
    assert (got[1] >= 0).any()
    assert_matches_jax(ref, got)
    assert ((got[1] < 0) == (got[0] == 1e30)).all()


def test_binned_closest_matches_jax_and_whole_tree(env):
    o, d, tm = env["rays"]
    scene = env["scene"]
    binned.reset_stats()
    got = binned.binned_closest(scene, o, d, tm)
    assert int(binned.STATS["rays"]) == int((tm > 0).sum())
    assert int(binned.STATS["fallback_rays"]) > 0
    assert_matches_jax(env["jclosest"], got)
    want = traverse.closest_hit(o, d, tm, scene["pk_nodes"],
                                scene["pk_tris_bw"])
    assert_matches_jax(want, got)
    plain = binned.binned_closest(scene, o, d, tm, plain=True)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_binned_kernels_match_twins_on_the_card(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(77)
    tris = make_scene(rng, 20_000)
    o, d, tm = (_t(x).to(dev) for x in make_rays(rng, 8192))
    _, scene = port_tables(*tris)
    scene = {k: v.to(dev) for k, v in scene.items()}
    kernels.reset_counters()
    st, sc, dr = binned.select_clusters(o, d, tm, scene["bn_nodes"])
    pt, pc, pdr = binned.select_clusters_plain(o, d, tm, scene["bn_nodes"])
    torch.cuda.synchronize()
    assert kernels.stack_overflows() == 0
    ks, ps = sc.sort(1).values, pc.sort(1).values
    # Slot sets equal but where two clusters tie at the K-th entry t.
    kth = torch.where((pc >= 0).all(1), pt.max(1).values, 1e30)
    diff = (ks != ps).any(1)
    assert ((pdr == kth) | ~diff).all()
    entry = _entries(o, d, tm, scene["bn_nodes"])
    outside = entry.clone()
    rows = torch.arange(o.shape[0], device=dev)[:, None].expand_as(sc)
    outside[rows[sc >= 0], sc[sc >= 0].long()] = 1e30
    kth_k = torch.where((sc >= 0).all(1), st.max(1).values, 1e30)
    assert (kth_k <= dr).all() and (dr <= outside.min(1).values).all()
    po, pd, pcap, cl = _sorted_pairs(o, d, tm, sc)
    k = binned.dense_pairs(po, pd, pcap, cl, scene["bn_mot"],
                           scene["bn_base"])
    p = binned.dense_pairs_plain(po, pd, pcap, cl, scene["bn_mot"],
                                 scene["bn_base"])
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    got = binned.binned_closest(scene, o, d, tm)
    want = traverse.closest_hit(o, d, tm, scene["pk_nodes"],
                                scene["pk_tris_bw"])
    torch.cuda.synchronize()
    assert torch.equal(got[1] >= 0, want[1] >= 0)
    assert kernels.LAUNCHES["select"] == 2 and kernels.LAUNCHES["dense"] >= 3
