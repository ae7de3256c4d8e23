"""The walk order of the port's closest-hit and any-hit kernels
(csrc/bvh_traverse.cu: a ray per 8 lanes, children ranked by entry t,
leaves after the pushes) as trace/traverse.py octet_walk runs it in plain
PyTorch.

Checked here, on the CPU:

- octet_walk against the kernels' twins closest_hit_plain / anyhit_plain:
  t bit for bit, ids equal outside ties (a differing id is re-tested by
  hit_attributes), occlusion equal; also over the packed "shadertoy"
  scene;
- against the TPU kernels traverse_packets2 / anyhit_packets2 in Pallas
  interpret mode, with the tolerances of test_twins_match_pallas_kernels;
- against an independent scalar walk of the same order in float32 numpy:
  hits, pops, clusters and the stack entries held, exactly;
- per-ray roots (node roots and leaf roots), dead lanes (0, negative,
  NaN), ray counts 0, 1, 7, 33;
- the tie rules on hand-made tables: at equal entry t the higher slot is
  on top of the stack and the lower leaf slot is tested first; a push
  past the stack drops the nearest children and is counted;
- stack_need and the wrappers' per-table cache of it.

The kernels themselves run only on a card: the `cuda`-marked
test_kernels_match_twins_on_the_card of tests/test_torch_traverse.py.
"""

import numpy as np
import pytest
import torch

from test_torch_traverse import (
    _assert_closest_match,
    _mixed_tmax,
    _pallas,
    _t,
    _tables,
    make_rays,
    make_scene,
    mixed_roots,
)
from tracerboy_tpu_torch.accel.bvh import INVALID
from tracerboy_tpu_torch.accel.pack import bw_rows, pack_scene
from tracerboy_tpu_torch.trace import kernels, traverse

torch.set_num_threads(2)

f32 = np.float32
N_RAYS = 2048


def _random_tables(seed, n_tris, copies=1):
    """Packed tables of n_tris random triangles, each `copies` times (the
    copies give sibling boxes with equal entry t and hits at equal t)."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (np.tile(x, (copies, 1)) for x in make_scene(rng, n_tris))
    pk, _ = pack_scene(v0, v1, v2)
    return rng, _t(pk["nodes"]), _t(pk["tris_bw"])


def _assert_hits_equal_twin(o, d, tris, got, ref):
    """t bit for bit; ids equal or, at a tie, the walk's pick re-tested."""
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1] >= 0, ref[1] >= 0)
    same = got[1] == ref[1]
    diff = ~same
    t_r, u_r, v_r = traverse.hit_attributes(o[diff], d[diff], got[1][diff],
                                            tris)
    assert torch.equal(t_r, got[0][diff])
    for k, redo in ((2, u_r), (3, v_r)):
        assert torch.equal(got[k][same], ref[k][same])
        assert torch.equal(got[k][diff], redo)
    return int(diff.sum())


@pytest.mark.parametrize("n_tris", [37, 2000, 20_000])
def test_octet_walk_equals_the_twins(n_tris):
    rng, nodes, tris = _random_tables(300 + n_tris, n_tris)
    o, d = (_t(x) for x in make_rays(rng, N_RAYS))
    tm = _t(_mixed_tmax(rng, N_RAYS))
    kernels.reset_counters()
    got = traverse.octet_walk(o, d, tm, nodes, tris)
    ref = traverse.closest_hit_plain(o, d, tm, nodes, tris)
    assert int((ref[1] >= 0).sum()) > 8
    _assert_hits_equal_twin(o, d, tris, got, ref)
    occ = traverse.octet_walk(o, d, tm, nodes, tris, any_hit=True)[1] >= 0
    assert torch.equal(occ, traverse.anyhit_plain(o, d, tm, nodes, tris))
    live = tm > 0
    assert (got[4][live] >= 1).all() and (got[4][~live] == 0).all()
    assert int(got[6].max()) <= traverse.stack_need(nodes)
    assert kernels.stack_overflows() == 0


def test_octet_walk_equals_the_twins_on_shadertoy():
    from test_torch_traverse_stats import _shadertoy_rays

    rng = np.random.default_rng(32)
    (nodes, tris), o, d = _shadertoy_rays(rng, N_RAYS)
    tm = _t(_mixed_tmax(rng, N_RAYS))
    got = traverse.octet_walk(o, d, tm, nodes, tris)
    ref = traverse.closest_hit_plain(o, d, tm, nodes, tris)
    assert int((ref[1] >= 0).sum()) > 256
    _assert_hits_equal_twin(o, d, tris, got, ref)
    occ = traverse.octet_walk(o, d, tm, nodes, tris, any_hit=True)[1] >= 0
    assert torch.equal(occ, traverse.anyhit_plain(o, d, tm, nodes, tris))
    # The serial walk of the stats kernel finds the same t.
    assert torch.equal(
        got[0], traverse.closest_hit_stats_plain(o, d, tm, nodes, tris)[0])


@pytest.mark.parametrize("n_tris", [37, 2000])
def test_octet_walk_matches_pallas_kernels(n_tris):
    rng = np.random.default_rng(4321 + n_tris)
    v0, v1, v2 = make_scene(rng, n_tris)
    (nodes, tris), jpk = _tables(v0, v1, v2)
    o, d = make_rays(rng, N_RAYS)
    tm = _mixed_tmax(rng, N_RAYS)
    closest, anyhit = _pallas()
    got = traverse.octet_walk(_t(o), _t(d), _t(tm), nodes, tris)
    _assert_closest_match(closest(o, d, tm, jpk), got[:4])
    occ = traverse.octet_walk(_t(o), _t(d), _t(tm), nodes, tris,
                              any_hit=True)[1] >= 0
    np.testing.assert_array_equal(occ.numpy(), anyhit(o, d, tm, jpk))


# ----------------------------------------------------------------------------
# An independent scalar walk in the octet kernels' order.

def _bw(r, o, d):
    """One Baldwin-Weber row against one ray: (accepted, t, u, v)."""
    A = r[0] * o[0] + r[1] * o[1] + r[2] * o[2] + r[3]
    B = r[0] * d[0] + r[1] * d[1] + r[2] * d[2]
    inv_b = f32(1.0) / B if abs(B) > f32(1e-12) else f32(0)
    t = -A * inv_b
    u = (r[4] * o[0] + r[5] * o[1] + r[6] * o[2] + r[7]) + t * (
        r[4] * d[0] + r[5] * d[1] + r[6] * d[2])
    v = (r[8] * o[0] + r[9] * o[1] + r[10] * o[2] + r[11]) + t * (
        r[8] * d[0] + r[9] * d[1] + r[10] * d[2])
    ok = (abs(B) > f32(1e-12) and u >= f32(-1e-5) and v >= f32(-1e-5)
          and u + v <= f32(1 + 1e-5) and t > f32(1e-5))
    return ok, t, u, v


def _scalar_octet_walk(o, d, t_max, nodes, tris, root=0, any_hit=False,
                       size=10**6, rows=None):
    """One ray by the octet kernels' rules in float32 numpy scalars:
    (t, tri, u, v, pops, clusters, held, dropped pushes)."""
    def fix(x):
        return (f32(-1e-12) if x < 0 else f32(1e-12)) if abs(x) < f32(
            1e-12) else x

    state = dict(best=f32(t_max), tri=-1, u=f32(0), v=f32(0), clusters=0)

    def test(cl):
        state["clusters"] += 1
        if rows is not None:
            rows[1].add(cl)
        found = None
        for k in range(8):
            ok, t, u, v = _bw(tris[cl, 12 * k:12 * k + 12], o, d)
            if ok and t < state["best"] and (found is None or t < found[0]):
                found = (t, cl * 8 + k, u, v)
        if found is not None:
            state["best"], state["tri"], state["u"], state["v"] = found

    def result(pops, held, dropped):
        hit = state["tri"] >= 0
        return (state["best"] if hit else f32(1e30), state["tri"],
                state["u"], state["v"], pops, state["clusters"], held,
                dropped)

    if not t_max > 0:
        return result(0, 0, 0)
    inv = [f32(1.0) / fix(d[k]) for k in range(3)]
    boxes = nodes[:, :48].view(f32)
    pops = dropped = 0
    stack = []
    if root >= 0:
        stack.append((root, f32(-1e30)))
    else:
        test(-root - 1)
    held = len(stack)
    while stack and not (any_hit and state["tri"] >= 0):
        node, entry = stack.pop()
        if not any_hit and not entry < state["best"]:
            continue
        pops += 1
        if rows is not None:
            rows[0].add(node)
        cap = f32(t_max) if any_hit else state["best"]
        inner, leaves = [], []
        for c in range(8):
            cid = int(nodes[node, 48 + c])
            if cid == INVALID:
                continue
            t0 = [(boxes[node, 8 * k + c] - o[k]) * inv[k] for k in range(3)]
            t1 = [(boxes[node, 24 + 8 * k + c] - o[k]) * inv[k]
                  for k in range(3)]
            near = max(max(min(t0[0], t1[0]), min(t0[1], t1[1])),
                       min(t0[2], t1[2]))
            far = min(min(max(t0[0], t1[0]), max(t0[1], t1[1])),
                      max(t0[2], t1[2]))
            if far >= max(near, f32(0)) and near < cap:
                (inner if cid >= 0 else leaves).append((near, c, cid))
        # Bottom to top: farthest first, the lower slot below an equal one.
        for near, c, cid in sorted(inner, key=lambda e: (-e[0], e[1])):
            if len(stack) < size:
                stack.append((cid, near))
            else:
                dropped += 1
        held = max(held, len(stack))
        for near, c, cid in sorted(leaves, key=lambda e: (e[0], e[1])):
            if any_hit and state["tri"] >= 0:
                break
            if not any_hit and not near < state["best"]:
                break
            test(-cid - 1)
    return result(pops, held, dropped)


def _assert_equals_scalar(got, want, any_hit):
    cols = [np.array([w[k] for w in want]) for k in range(7)]
    names = ("t", "tri", "u", "v", "pops", "clusters", "held")
    if any_hit:     # the any-hit kernel keeps no hit: occlusion and counts
        np.testing.assert_array_equal(got[1].numpy() >= 0, cols[1] >= 0)
        start = 4
    else:
        start = 0
    for k in range(start, 7):
        np.testing.assert_array_equal(got[k].numpy(), cols[k],
                                      err_msg=names[k])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris,copies", [(300, 1), (5000, 1), (200, 16)])
def test_octet_walk_equals_a_scalar_walk(n_tris, copies, any_hit):
    rng, nodes, tris = _random_tables(50 + n_tris, n_tris, copies)
    o, d = make_rays(rng, 64)
    tm = _mixed_tmax(rng, 64)
    seen = (torch.zeros(nodes.shape[0], dtype=torch.bool),
            torch.zeros(tris.shape[0], dtype=torch.bool))
    got = traverse.octet_walk(_t(o), _t(d), _t(tm), nodes, tris,
                              any_hit=any_hit, seen=seen)
    rows = (set(), set())
    want = [_scalar_octet_walk(o[i], d[i], tm[i], nodes.numpy(),
                               tris.numpy(), any_hit=any_hit, rows=rows)
            for i in range(64)]
    assert sum(w[4] for w in want) > 64 and sum(w[5] for w in want) > 32
    _assert_equals_scalar(got, want, any_hit)
    assert set(seen[0].nonzero()[:, 0].tolist()) == rows[0]
    assert set(seen[1].nonzero()[:, 0].tolist()) == rows[1]
    if copies > 1 and not any_hit:
        # The copies make ties in t: the serial walk still finds the same t.
        assert torch.equal(got[0], traverse.closest_hit_stats_plain(
            _t(o), _t(d), _t(tm), nodes, tris)[0])


@pytest.mark.parametrize("n_tris", [300, 5000])
def test_octet_walk_with_per_ray_roots(n_tris):
    rng, nodes, tris = _random_tables(70 + n_tris, n_tris)
    n = 512
    o, d = make_rays(rng, n)
    tm = _mixed_tmax(rng, n)
    roots = mixed_roots(rng, nodes, n)
    assert (roots < 0).any() and (roots > 0).any()
    args = (_t(o), _t(d), _t(tm), nodes, tris, _t(roots))
    got = traverse.octet_walk(*args)
    ref = traverse.closest_hit_plain(*args)
    assert int((ref[1] >= 0).sum()) > 16
    _assert_hits_equal_twin(args[0], args[1], tris, got, ref)
    occ = traverse.octet_walk(*args, any_hit=True)
    assert torch.equal(occ[1] >= 0, traverse.anyhit_plain(*args))
    for any_hit, out in ((False, got), (True, occ)):
        want = [_scalar_octet_walk(o[i], d[i], tm[i], nodes.numpy(),
                                   tris.numpy(), root=int(roots[i]),
                                   any_hit=any_hit) for i in range(64)]
        _assert_equals_scalar([x[:64] for x in out], want, any_hit)
    # A live leaf root tests its cluster and pops nothing.
    leaf_root = _t((roots < 0) & (tm > 0))
    assert (got[4][leaf_root] == 0).all() and (got[5][leaf_root] == 1).all()


def test_octet_walk_dead_lanes():
    rng, nodes, tris = _random_tables(5, 500)
    o, d = (_t(x) for x in make_rays(rng, 128))
    tm = torch.full((128,), 1e30)
    tm[::4] = 0.0
    tm[1::4] = -1.0
    tm[2::4] = float("nan")
    dead = ~(tm > 0)
    for any_hit in (False, True):
        t, tri, u, v, pops, clusters, held = traverse.octet_walk(
            o, d, tm, nodes, tris, any_hit=any_hit)
        assert (tri[dead] == -1).all() and (t[dead] == 1e30).all()
        assert (u[dead] == 0).all() and (v[dead] == 0).all()
        for count in (pops, clusters, held):
            assert (count[dead] == 0).all()
        assert (pops[~dead] >= 1).all()


@pytest.mark.parametrize("n_rays", [0, 1, 7, 33])
def test_octet_walk_ray_counts(n_rays):
    rng, nodes, tris = _random_tables(11, 2000)
    o, d = (_t(x) for x in make_rays(rng, n_rays))
    tm = torch.full((n_rays,), 1e30)
    got = traverse.octet_walk(o, d, tm, nodes, tris)
    ref = traverse.closest_hit_plain(o, d, tm, nodes, tris)
    assert all(x.shape == (n_rays,) for x in got)
    _assert_hits_equal_twin(o, d, tris, got, ref)
    occ = traverse.octet_walk(o, d, tm, nodes, tris, any_hit=True)[1] >= 0
    assert torch.equal(occ, traverse.anyhit_plain(o, d, tm, nodes, tris))


# ----------------------------------------------------------------------------
# The tie rules, on hand-made tables.

def _node_row(children):
    """A node row whose given slots {slot: child id} all have the box
    [0, 1]^3; the other slots are empty."""
    row = np.zeros(128, np.int32)
    lo = np.full((8, 3), 1e30, f32)
    hi = np.full((8, 3), -1e30, f32)
    ids = np.full(8, INVALID, np.int32)
    for slot, cid in children.items():
        lo[slot], hi[slot], ids[slot] = 0.0, 1.0, cid
    row[:48] = np.concatenate([lo, hi], 1).T.reshape(48).view(np.int32)
    row[48:56] = ids
    return row


def _cluster_row(z):
    """A cluster whose triangle 0 covers the unit square at height z."""
    row = np.zeros(128, f32)
    row[:12] = bw_rows(np.array([[-1.0, -1.0, z]]), np.array([[3.0, -1.0, z]]),
                       np.array([[-1.0, 3.0, z]])).reshape(12)
    return row


def _ray_up():
    return (torch.tensor([[0.3, 0.3, -1.0]]), torch.tensor([[0.0, 0.0, 1.0]]),
            torch.tensor([1e30]))


@pytest.mark.parametrize("case", ["order", "overflow"])
def test_equal_entry_pushes_the_higher_slot_on_top(case):
    """Root slots 1, 3, 6 hold inner nodes 1, 2, 3 with one box, so one
    entry t; node k's leaf is hit at z = 0.2 k. With room the walk pops
    nodes 3, 2, 1 and ends at the nearest hit; with 2 entries the rank-2
    push, the higher slot's node 3, is the one dropped, so with a 1-entry
    stack only the lowest slot's node 1 is walked."""
    nodes = _t(np.stack([_node_row({1: 1, 3: 2, 6: 3}), _node_row({0: -1}),
                         _node_row({0: -2}), _node_row({0: -3})]))
    tris = _t(np.stack([_cluster_row(0.2), _cluster_row(0.4),
                        _cluster_row(0.6)]))
    o, d, tm = _ray_up()
    kernels.reset_counters()
    if case == "order":
        seen = (torch.zeros(4, dtype=torch.bool),
                torch.zeros(3, dtype=torch.bool))
        t, tri, _, _, pops, clusters, held = traverse.octet_walk(
            o, d, tm, nodes, tris, seen=seen)
        assert (float(t), int(tri)) == (pytest.approx(1.2), 0)
        # Node 3 first (hit at 1.6), then 2 (1.4), then 1 (1.2): every
        # node is expanded and every leaf tested, since each box starts
        # (t = 1) before the best hit so far.
        assert (int(pops), int(clusters), int(held)) == (4, 3, 3)
        assert kernels.stack_overflows() == 0
        want = _scalar_octet_walk(o[0].numpy(), d[0].numpy(), f32(1e30),
                                  nodes.numpy(), tris.numpy())
        assert (want[1], want[4:7]) == (0, (4, 3, 3))
        return
    for size, reached, hit_tri in ((2, [0, 1], 0), (1, [0], 0)):
        kernels.reset_counters()
        seen = (torch.zeros(4, dtype=torch.bool),
                torch.zeros(3, dtype=torch.bool))
        out = traverse.octet_walk(o, d, tm, nodes, tris, stack_size=size,
                                  seen=seen)
        assert seen[1].nonzero()[:, 0].tolist() == reached
        assert int(out[1]) == hit_tri and int(out[6]) == size
        assert kernels.stack_overflows() == 3 - size
        want = _scalar_octet_walk(o[0].numpy(), d[0].numpy(), f32(1e30),
                                  nodes.numpy(), tris.numpy(), size=size)
        assert (want[1], want[5], want[7]) == (hit_tri, size, 3 - size)
    kernels.reset_counters()


def test_equal_entry_tests_the_lower_leaf_slot_first():
    """Two leaf slots with one box and the same triangle: the lower slot
    is tested first and the strict t < best keeps its triangle, though
    its cluster id is the higher one."""
    nodes = _t(np.stack([_node_row({2: -2, 5: -1})]))
    tris = _t(np.stack([_cluster_row(0.5), _cluster_row(0.5)]))
    o, d, tm = _ray_up()
    t, tri, _, _, pops, clusters, _ = traverse.octet_walk(o, d, tm, nodes,
                                                           tris)
    assert (float(t), int(tri)) == (1.5, 8)       # cluster 1, triangle 0
    # The second leaf's box starts (t = 1) before the hit, so it is tested
    # too; its equal t does not replace the first.
    assert (int(pops), int(clusters)) == (1, 2)
    # The exhaustive twin keeps the lowest id at the tie; same t.
    ref = traverse.closest_hit_plain(o, d, tm, nodes, tris)
    assert (float(ref[0]), int(ref[1])) == (1.5, 0)
    occ = traverse.octet_walk(o, d, tm, nodes, tris, any_hit=True)
    assert int(occ[1]) >= 0 and int(occ[5]) == 1


# ----------------------------------------------------------------------------
# The stack size the wrappers hand the kernels.

def test_stack_need_counts_the_tree_levels():
    one_level = _t(np.stack([_node_row({0: -1})]))
    assert traverse.stack_need(one_level) == 8
    three = _t(np.stack([_node_row({0: 1}), _node_row({3: 2, 4: -1}),
                         _node_row({7: -2})]))
    assert traverse.stack_need(three) == 22
    _, nodes, _ = _random_tables(3, 5000)
    need = traverse.stack_need(nodes)
    assert 8 < need <= traverse.MAX_STACK_ENTRIES


def test_stack_entries_are_kept_per_table(monkeypatch):
    _, nodes, _ = _random_tables(3, 500)
    calls = []
    real = traverse.stack_need
    monkeypatch.setattr(traverse, "stack_need",
                        lambda n: calls.append(1) or real(n))
    assert traverse.stack_entries(nodes) == real(nodes)
    assert traverse.stack_entries(nodes) == real(nodes)
    assert len(calls) == 1
    other = nodes.clone()
    assert traverse.stack_entries(other) == real(nodes)
    assert len(calls) == 2
    monkeypatch.setattr(traverse, "MAX_STACK_ENTRIES", 4)
    with pytest.raises(ValueError):
        traverse.stack_entries(nodes)
