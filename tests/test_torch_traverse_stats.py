"""The traversal-cost (stats) kernel of the port and its plain twin
(trace/traverse.py closest_hit_stats / closest_hit_stats_plain).

The TPU kernel's stats option counts per 2048-ray packet, so no
value-level comparison with the JAX package exists; the port counts per
ray (csrc/bvh_traverse.cu's header defines pops and clusters). Checked
here:

- the twin's hits equal the exhaustive twin's (closest_hit_plain): t bit
  for bit and the same ids, on mixed rays over a random scene and over
  the packed "shadertoy" scene (its camera rays and random rays);
- its counts equal, exactly, an independent scalar walk in float32 numpy
  written below (64 rays), as do its hits;
- dead lanes count 0 and 0;
- walk_footprint's rows and counts equal the scalar walk's, for the
  closest-hit walk and the any-hit walk (whose occlusion equals
  anyhit_plain's);
- under the `cuda` marker (skipped without a card): the CUDA kernel
  against the twin (hits and counts equal) and the stats-free kernel (t
  equal; ids, u, v equal outside ties) -- run on the card with
      python -m pytest --noconftest -m cuda tests/test_torch_traverse_stats.py
  This module imports no JAX.
"""

import numpy as np
import pytest
import torch

from test_torch_traverse import _mixed_tmax, _t, make_rays, make_scene
from tracerboy_tpu_torch.accel.bvh import INVALID
from tracerboy_tpu_torch.accel.pack import pack_scene
from tracerboy_tpu_torch.trace import kernels, traverse

torch.set_num_threads(2)

f32 = np.float32


def _random_tables(seed, n_tris):
    rng = np.random.default_rng(seed)
    pk, _ = pack_scene(*make_scene(rng, n_tris))
    return rng, _t(pk["nodes"]), _t(pk["tris_bw"])


def _shadertoy_rays(rng, n):
    """The packed "shadertoy" tables, with half camera rays through random
    pixels and half random rays from inside the scene bounds."""
    from tracerboy_tpu_torch.core import vec3 as v3
    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.trace.camera import generate_primary_rays_soa

    w, h = 32, 24
    scene = load_scene("shadertoy", film_size=(w, h)).as_tensors("cpu")
    half = n // 2
    pix = torch.from_numpy(rng.integers(0, w * h, half))
    ju, jv = (torch.from_numpy(rng.random(half, dtype=f32)) for _ in "uv")
    o1, d1 = generate_primary_rays_soa(scene["camera"], w, h, pix, ju, jv)
    lo, hi = scene["world_lo"].numpy(), scene["world_hi"].numpy()
    o2 = (lo + (hi - lo) * rng.random((n - half, 3))).astype(f32)
    d2 = rng.normal(size=(n - half, 3))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(f32)
    o = torch.cat([v3.to_rows(o1), _t(o2)]).contiguous()
    d = torch.cat([v3.to_rows(d1), _t(d2)]).contiguous()
    return (scene["pk_nodes"], scene["pk_tris_bw"]), o, d


@pytest.mark.parametrize("case", ["random_2000", "shadertoy"])
def test_stats_twin_hits_equal_the_exhaustive_twin(case):
    if case == "shadertoy":
        rng = np.random.default_rng(31)
        (nodes, tris), o, d = _shadertoy_rays(rng, 2048)
    else:
        rng, nodes, tris = _random_tables(17, 2000)
        o, d = (_t(x) for x in make_rays(rng, 2048))
    tm = _t(_mixed_tmax(rng, o.shape[0]))
    got = traverse.closest_hit_stats_plain(o, d, tm, nodes, tris)
    ref = traverse.closest_hit_plain(o, d, tm, nodes, tris)
    assert int((ref[1] >= 0).sum()) > 256
    # The walk culls a box whose entry t is not below its best hit; the
    # exhaustive twin culls by t_max only. They agree unless a box entry
    # rounds beyond a hit it bounds (none on these rays) or two triangles
    # tie at t (ids are then compared by re-testing, as on the card).
    assert torch.equal(got[0], ref[0])
    same = got[1] == ref[1]
    diff = ~same
    t_r, u_r, v_r = traverse.hit_attributes(o[diff], d[diff], got[1][diff],
                                            tris)
    assert torch.equal(t_r, got[0][diff])
    for k, redo in ((2, u_r), (3, v_r)):
        assert torch.equal(got[k][same], ref[k][same])
        assert torch.equal(got[k][diff], redo)
    pops, clusters = got[4], got[5]
    live = tm > 0
    assert (pops[live] >= 1).all() and (clusters[live] >= 0).all()
    assert kernels.stack_overflows() == 0


def _scalar_walk(o, d, t_max, nodes, tris, any_hit=False, rows=None):
    """One ray through the packed tables by the kernel's rules, in float32
    numpy scalars: returns (t, tri, u, v, pops, clusters). any_hit: the
    any-hit kernel's walk (no pop-time cull, t_max caps the boxes, the ray
    stops at its first hit). rows: a pair of sets that collect the node
    rows popped and the cluster rows tested."""
    def fix(x):
        return (f32(-1e-12) if x < 0 else f32(1e-12)) if abs(x) < f32(
            1e-12) else x

    inv = [f32(1.0) / fix(d[k]) for k in range(3)]
    best, best_tri, best_u, best_v = f32(t_max), -1, f32(0), f32(0)
    pops = clusters = 0
    if not t_max > 0:
        return f32(1e30), -1, best_u, best_v, 0, 0
    boxes = nodes[:, :48].view(f32)
    stack = [(0, f32(-1e30))]
    while stack:
        node, entry = stack.pop()
        if not any_hit and not entry < best:
            continue
        pops += 1
        if rows is not None:
            rows[0].add(node)
        push = []
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
            if not (far >= max(near, f32(0)) and near < best):
                continue
            if cid >= 0:
                k = len(push)
                while k > 0 and push[k - 1][0] < near:
                    k -= 1
                push.insert(k, (near, cid))
                continue
            clusters += 1
            cl = -cid - 1
            if rows is not None:
                rows[1].add(cl)
            for j in range(8):
                r = tris[cl, 12 * j:12 * j + 12]
                A = r[0] * o[0] + r[1] * o[1] + r[2] * o[2] + r[3]
                B = r[0] * d[0] + r[1] * d[1] + r[2] * d[2]
                inv_b = f32(1.0) / B if abs(B) > f32(1e-12) else f32(0)
                t = -A * inv_b
                u = (r[4] * o[0] + r[5] * o[1] + r[6] * o[2] + r[7]) + t * (
                    r[4] * d[0] + r[5] * d[1] + r[6] * d[2])
                v = (r[8] * o[0] + r[9] * o[1] + r[10] * o[2] + r[11]) + t * (
                    r[8] * d[0] + r[9] * d[1] + r[10] * d[2])
                ok = (abs(B) > f32(1e-12) and u >= f32(-1e-5)
                      and v >= f32(-1e-5) and u + v <= f32(1 + 1e-5)
                      and t > f32(1e-5))
                if ok and t < best:
                    best, best_tri, best_u, best_v = t, cl * 8 + j, u, v
                    if any_hit:
                        break
            if any_hit and best_tri >= 0:
                break
        if any_hit and best_tri >= 0:
            break
        stack.extend((cid, near) for near, cid in push)
        assert len(stack) <= traverse.STACK_DEPTH
    return (best if best_tri >= 0 else f32(1e30)), best_tri, best_u, best_v, \
        pops, clusters


@pytest.mark.parametrize("n_tris", [300, 5000])
def test_stats_twin_counts_equal_a_scalar_walk(n_tris):
    rng, nodes, tris = _random_tables(40 + n_tris, n_tris)
    o, d = make_rays(rng, 64)
    tm = _mixed_tmax(rng, 64)
    got = traverse.closest_hit_stats_plain(_t(o), _t(d), _t(tm), nodes,
                                           tris)
    nodes_np, tris_np = nodes.numpy(), tris.numpy()
    want = [_scalar_walk(o[i], d[i], tm[i], nodes_np, tris_np)
            for i in range(64)]
    cols = [np.array([w[k] for w in want]) for k in range(6)]
    assert cols[4].sum() > 64 and cols[5].sum() > 64
    for k in range(6):
        np.testing.assert_array_equal(got[k].numpy(), cols[k], err_msg=k)


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_footprint_equals_a_scalar_walk(any_hit):
    rng, nodes, tris = _random_tables(91, 3000)
    o, d = make_rays(rng, 64)
    tm = _mixed_tmax(rng, 64)
    node_rows, cl_rows, pops, clusters = traverse.walk_footprint(
        _t(o), _t(d), _t(tm), nodes, tris, any_hit=any_hit)
    rows = (set(), set())
    want = [_scalar_walk(o[i], d[i], tm[i], nodes.numpy(), tris.numpy(),
                         any_hit, rows) for i in range(64)]
    assert len(rows[0]) > 8 and len(rows[1]) > 8
    assert set(node_rows.nonzero()[:, 0].tolist()) == rows[0]
    assert set(cl_rows.nonzero()[:, 0].tolist()) == rows[1]
    np.testing.assert_array_equal(pops.numpy(), [w[4] for w in want])
    np.testing.assert_array_equal(clusters.numpy(), [w[5] for w in want])
    occluded = np.array([w[1] >= 0 for w in want])
    if any_hit:
        np.testing.assert_array_equal(
            occluded, traverse.anyhit_plain(_t(o), _t(d), _t(tm), nodes,
                                            tris).numpy())
        assert 0 < occluded.sum() < 64


def test_dead_lanes_count_nothing():
    rng, nodes, tris = _random_tables(5, 500)
    o, d = (_t(x) for x in make_rays(rng, 128))
    tm = torch.full((128,), 1e30)
    tm[::2] = 0.0
    tm[1::4] = -1.0
    t, tri, u, v, pops, clusters = traverse.closest_hit_stats(o, d, tm,
                                                              nodes, tris)
    dead = tm <= 0
    assert (pops[dead] == 0).all() and (clusters[dead] == 0).all()
    assert (tri[dead] == -1).all() and (t[dead] == 1e30).all()
    assert (pops[~dead] >= 1).all()


def test_stats_wrapper_takes_the_twin_on_cpu():
    rng, nodes, tris = _random_tables(6, 500)
    o, d = (_t(x) for x in make_rays(rng, 64))
    tm = _t(_mixed_tmax(rng, 64))
    kernels.reset_counters()
    a = traverse.closest_hit_stats(o, d, tm, nodes, tris)
    b = traverse.closest_hit_stats_plain(o, d, tm, nodes, tris)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert kernels.TWIN_CALLS == dict(dict.fromkeys(kernels.LAUNCHES, 0),
                                       closest_stats=1)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [37, 2000, 20_000])
def test_stats_kernel_matches_its_twin_on_the_card(cuda_device, n_tris):
    rng, nodes, tris = _random_tables(77 + n_tris, n_tris)
    nodes, tris = nodes.to(cuda_device), tris.to(cuda_device)
    o, d = make_rays(rng, 2048)
    tm = _mixed_tmax(rng, 2048)
    o, d, tm = (_t(x).to(cuda_device) for x in (o, d, tm))
    kernels.reset_counters()
    k = traverse.closest_hit_stats(o, d, tm, nodes, tris)
    free = traverse.closest_hit(o, d, tm, nodes, tris)
    p = traverse.closest_hit_stats_plain(o, d, tm, nodes, tris)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(dict.fromkeys(kernels.LAUNCHES, 0),
                                     closest=1, closest_stats=1)
    assert kernels.stack_overflows() == 0
    # The stats-free kernel walks in another order (a ray per 8 lanes):
    # the same t; the same triangle, u and v outside ties, and at a tie
    # its pick re-tested gives the t, u, v it returned.
    assert torch.equal(k[0], free[0])
    same = k[1] == free[1]
    for j in (2, 3):
        assert torch.equal(k[j][same], free[j][same])
    redo = traverse.hit_attributes(o[~same], d[~same], free[1][~same], tris)
    for got, j in zip(redo, (0, 2, 3)):
        assert torch.equal(got, free[j][~same])
    for j in range(6):      # the twin repeats the walk
        assert torch.equal(k[j], p[j]), j
