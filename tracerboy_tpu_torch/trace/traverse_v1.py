"""The first-generation ("v1") closest-hit traversal of the packed BVH: a
CUDA kernel and its plain PyTorch version.

The counterpart of tracerboy_tpu/trace/pallas_traverse.py
(traverse_packets). The kernel lives in csrc/bvh_traverse_v1.cu: the
serial walk below on the octet schedule of the closest-hit kernel (a ray
per 8 lanes, lane c testing child c and triangle c, an id stack per octet
in shared memory, persistent blocks drawing rays from a counter the
wrapper zeroes). It is built with nvcc for sm_90a at first use
(utils/build.py) and called through ctypes. No wave of the renderer takes
it; the traversal study (utils/bench_traverse.py) times it beside the
second-generation kernels of trace/traverse.py.

Tables (accel/pack.py, pack_scene(..., raw_rows=True)):
- nodes (W, 128) int32, as in trace/traverse.py;
- tris (C, 128) float32: 8 triangles of 9 raw floats (v0, v1, v2), 72 of
  the 128 lanes used.

Contract (kernel and plain version):
- a lane with t_max <= 0 is dead: a miss;
- a child box is entered iff t_far >= max(t_near, 0) and t_near < best,
  with inv = 1 / d and |d| < 1e-12 replaced by +-1e-12. best is the best
  hit at the moment the child is tested (the TPU kernel uses the best hit
  at the pop of the parent; entering more boxes changes no result);
- no child ordering: inner children are pushed in slot order 0..7 and
  popped last first, leaf children are tested in slot order when their
  parent is expanded;
- Moller-Trumbore on the raw vertices, accepted iff |det| > 1e-9, u >= 0,
  v >= 0, u + v <= 1, t > 1e-5 and t < best, strictly, so the first
  triangle found wins a tie in t. This is not the Baldwin-Weber test of
  trace/traverse.py: |det| > 1e-9 rejects small or grazing triangles that
  test accepts, so the two kernels may differ on such rays;
- returns t (1e30 on a miss, whatever t_max was), the packed triangle id
  cluster * 8 + k (-1 on a miss) and u, v (0 on a miss);
- a push past STACK_DEPTH entries is dropped, as on the TPU, and counted
  in kernels.stack_overflows(); traverse.stack_need(nodes) is what a tree
  can ask for (7 entries per level and one), and the kernel's stack holds
  that many, at most STACK_DEPTH.

The plain version repeats the kernel's walk in lock step over the rays
that still have a stack, with the same float32 expressions in the same
order (the kernel is built with --fmad=false), so the two agree bit for
bit.

The wrapper takes the plain version only for CPU tensors; on a CUDA
tensor it launches the kernel or raises. It counts under "closest_v1" in
trace/kernels.py's LAUNCHES and TWIN_CALLS.
"""

from __future__ import annotations

import ctypes

import torch

from tracerboy_tpu_torch.accel.bvh import INVALID
from tracerboy_tpu_torch.trace import kernels
from tracerboy_tpu_torch.trace.traverse import (
    BIG,
    LEAF,
    box_entry,
    fix_dir,
    stack_entries,
)

STACK_DEPTH = 96    # kStackDepthV1 of csrc/bvh_traverse_v1.cu
DET_EPS = 1e-9
_SOURCE = kernels.CSRC / "bvh_traverse_v1.cu"
kernels.register("closest_v1")
_lib = None


def build_kernels():
    """Build (or reuse) and load the v1 traversal kernel's library."""
    global _lib
    if _lib is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _lib = kernels.load_library("tbtraverse_v1", _SOURCE, {
            "tb_closest_hit_v1": [p, p, p, p, p, i, i, p, p, p, p, p, p,
                                  p],
        })
    return _lib


def _check(o, d, t_max, nodes, tris):
    kernels.check_inputs(
        o, *kernels.ray_specs(o, d, t_max),
        ("nodes", nodes, (nodes.shape[0], 128), torch.int32),
        ("tris", tris, (tris.shape[0], 128), torch.float32))


def closest_hit_v1(o, d, t_max, nodes, tris):
    """Closest hit in (1e-5, t_max) by the v1 walk. o, d: (N, 3) f32;
    t_max: (N,) f32; tris: the raw 9-float rows. Returns (t, packed tri
    id int32, u, v)."""
    _check(o, d, t_max, nodes, tris)
    if o.device.type == "cpu":
        kernels.TWIN_CALLS["closest_v1"] += 1
        return closest_hit_v1_plain(o, d, t_max, nodes, tris)
    n = o.shape[0]
    t, u, v = (torch.empty(n, dtype=torch.float32, device=o.device)
               for _ in range(3))
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    # The zeroed counter from which the persistent blocks draw their rays.
    next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
    kernels.launch(build_kernels(), "tb_closest_hit_v1", o.device, o, d,
                   t_max, nodes, tris, n,
                   stack_entries(nodes, STACK_DEPTH), t, tri, u, v, next_ray)
    kernels.LAUNCHES["closest_v1"] += 1
    return t, tri, u, v


def mt_tests(o, d, rows):
    """Moller-Trumbore tests of P rays against the 8 triangles of their
    raw cluster rows (P, 128): (t, u, v, ok), each (P, 8), in the
    kernel's order of operations (products and sums term by term)."""
    r = rows[:, : LEAF * 9].reshape(-1, LEAF, 9)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    e1x, e1y, e1z = r[:, :, 3] - v0x, r[:, :, 4] - v0y, r[:, :, 5] - v0z
    e2x, e2y, e2z = r[:, :, 6] - v0x, r[:, :, 7] - v0y, r[:, :, 8] - v0z
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    good = torch.abs(det) > DET_EPS
    inv_det = torch.where(good, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
    return t, u, v, ok


def closest_hit_v1_plain(o, d, t_max, nodes, tris):
    """Plain PyTorch version of closest_hit_v1 (same outputs; a push past
    STACK_DEPTH entries is dropped and counted, as the kernel does)."""
    return _walk(o, d, t_max, nodes, tris)[:4]


def walk_footprint_v1(o, d, t_max, nodes, tris):
    """What the v1 walk of these rays reads and does: (node_rows (W,)
    bool, cluster_rows (C,) bool, pops (N,) int32, clusters (N,) int32).
    A node row is read when a ray pops it, a cluster row when a ray tests
    its triangles; a kernel's bound counts each such row once."""
    seen = (torch.zeros(nodes.shape[0], dtype=torch.bool, device=o.device),
            torch.zeros(tris.shape[0], dtype=torch.bool, device=o.device))
    out = _walk(o, d, t_max, nodes, tris, seen)
    return (*seen, out[4], out[5])


def _walk(o, d, t_max, nodes, tris, seen=None):
    n = o.shape[0]
    dev = o.device
    best = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    pops = torch.zeros(n, dtype=torch.int32, device=dev)
    clusters = torch.zeros(n, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = (t_max > 0).to(torch.int64)       # node 0 on every live stack
    inv = 1.0 / fix_dir(d)
    box = nodes[:, :48].contiguous().view(torch.float32)
    child = nodes[:, 48:56]
    overflow = 0
    while True:
        r = (sp > 0).nonzero(as_tuple=True)[0]
        if r.numel() == 0:
            break
        sp[r] -= 1
        node = stack[r, sp[r]].to(torch.int64)
        pops[r] += 1
        if seen is not None:
            seen[0][node] = True
        b, cid = box[node], child[node]
        o_r, inv_r = o[r], inv[r]
        for c in range(LEAF):
            t_near, t_far = box_entry(o_r, inv_r, b[:, c:24:8],
                                      b[:, 24 + c::8])
            enter = ((cid[:, c] != INVALID)
                     & (t_far >= torch.clamp_min(t_near, 0.0))
                     & (t_near < best[r]))
            leaf = (enter & (cid[:, c] < 0)).nonzero(as_tuple=True)[0]
            if leaf.numel():
                rays = r[leaf]
                cl = -cid[leaf, c].to(torch.int64) - 1
                _test_leaf(o, d, tris, rays, cl, best, best_tri, best_u,
                           best_v)
                clusters[rays] += 1
                if seen is not None:
                    seen[1][cl] = True
            want = enter & (cid[:, c] >= 0)
            room = want & (sp[r] < STACK_DEPTH)
            overflow += int((want & ~room).sum())
            rr = r[room]
            stack[rr, sp[rr]] = cid[room, c]
            sp[rr] += 1
    if overflow:
        kernels.add_overflows(dev, overflow)
    t = torch.where(best_tri < 0, BIG, best)
    return t, best_tri, best_u, best_v, pops, clusters


def _test_leaf(o, d, tris, rays, cl, best, best_tri, best_u, best_v):
    """The 8 triangles of cluster cl[j] against ray rays[j], in order: the
    first triangle at the least t below best wins."""
    t, u, v, ok = mt_tests(o[rays], d[rays], tris[cl])
    t = torch.where(ok & (t < best[rays][:, None]), t, float("inf"))
    k = torch.argmin(t, dim=1, keepdim=True)
    tk = t.gather(1, k)[:, 0]
    upd = tk < float("inf")
    r = rays[upd]
    best[r] = tk[upd]
    best_tri[r] = (cl[upd] * LEAF + k[upd, 0]).to(torch.int32)
    best_u[r] = u.gather(1, k)[upd, 0]
    best_v[r] = v.gather(1, k)[upd, 0]


def hit_attributes_v1(o, d, tri, tris):
    """(t, u, v) of each ray against the one packed triangle id it names
    (all tri >= 0), by the kernel's Moller-Trumbore arithmetic: shows
    whether a pick that differs from another walk's is a hit at the same
    t (a tie)."""
    tri = tri.to(torch.int64)
    rows = tris[torch.div(tri, LEAF, rounding_mode="floor")]
    t, u, v, _ = mt_tests(o, d, rows)
    k = (tri % LEAF)[:, None]
    return tuple(x.gather(1, k)[:, 0] for x in (t, u, v))
