"""Closest-hit and any-hit traversal of the packed BVH: CUDA kernels and
their plain PyTorch twins.

The counterpart of tracerboy_tpu/trace/pallas_traverse2.py
(traverse_packets2, anyhit_packets2). The kernels live in
csrc/bvh_traverse.cu; they are built with nvcc for sm_90a at first use
(utils/build.py) and called through ctypes.

Thread map of closest_hit and any_hit: one ray per group of 8 lanes (an
octet), four rays a warp. Lane c tests child c of a popped node and
triangle c of a leaf cluster; entered inner children are pushed ranked
by entry t (the nearest on top; at equal t the higher slot on top), then
the entered leaves are tested nearest first. Each octet keeps its stack
in shared memory, stack_need(nodes) entries of it (7 a tree level plus
one: a pop frees one entry and pushes at most 8), at most
MAX_STACK_ENTRIES; a push past it is dropped and counted in
kernels.stack_overflows(). The blocks are persistent: an octet draws its
next 8 rays (a ticket) from a device counter that the wrapper zeroes, and
dead lanes get their miss at the draw. The four octets of a warp step
through one loop together, so their shuffles and ballots name the full
warp. octet_walk is that walk in plain PyTorch, for the tests and for
counting what it does; it is not the kernels' twin.

Tables (accel/pack.py):
- nodes (W, 128) int32: lanes 0-47 the 8 child boxes as f32 bits,
  [lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8]; lanes 48-55 the child
  ids (INVALID = empty, negative = leaf cluster -id-1). Node 0 is the
  root.
- tris_bw (C, 128) float32: 8 triangles of 12 Baldwin-Weber floats.

Contract (both kernels and both twins):
- a lane with t_max <= 0 is dead: a miss, not occluded;
- a child box is entered iff t_far >= max(t_near, 0) and t_near < t_cap
  (the best hit so far for closest hit, t_max for any hit), with
  inv = 1 / d and |d| < 1e-12 replaced by +-1e-12;
- a triangle hit is accepted iff |B| > 1e-12, u >= -1e-5, v >= -1e-5,
  u + v <= 1 + 1e-5, t > 1e-5 and t < best (closest hit, strictly) or
  t < t_max (any hit);
- closest hit returns t (1e30 on a miss), the packed triangle id
  cluster*8 + k (-1 on a miss) and u, v (0 on a miss). At equal t the
  kernel keeps the first triangle it found and the twin the lowest id,
  so ids are compared only where t differs; at a tie, hit_attributes
  re-tests the kernel's pick.

Per-ray roots (optional, int32 (N,)): ray i starts at roots[i] instead
of node 0 -- a node id >= 0, whose children are tested as usual, or a
leaf cluster -root-1, whose 8 triangles are tested with no box test (the
TPU kernels' packet_roots option; phase 2 of trace/cut.py). The twins
restrict each ray to the clusters under its root, from a host-side map of
each node to the clusters of its subtree.

Traversal cost (closest_hit_stats, the TPU kernel's stats=True variant,
for the heatmap AOV): the closest hit from node 0 plus two int32 counts
per ray, pops (nodes popped and expanded; a node the pop-time cull skips
does not count) and clusters (leaf clusters whose triangles were tested);
0 and 0 on a dead lane. The counts are those of the serial walk, which
the stats kernel keeps and its twin, closest_hit_stats_plain, repeats
step for step: a per-ray stack (stack_need entries, at most
STACK_DEPTH), the same slab test, children pushed sorted by descending
entry t (a later child goes above an equal one), the cull !(entry t <
best) at pop, leaf clusters tested as they are met, in slot order. The
kernel walks one ray per thread in persistent warps that draw 32 rays in
a row from a counter the wrapper zeroes, with the top of each stack in
shared memory (its one launch a render is the HEATMAP view's
raster-ordered primary wave, where a thread per ray beats octets). Its t
equals closest_hit's; at equal t the two walk orders may keep different
triangles. The exhaustive twin closest_hit_plain stays the twin of the
stats-free kernel. walk_footprint runs the serial walk (or its any-hit
form) to mark the node and cluster rows it reads, for a kernel's bound:
the least work, whatever walk implements it.

The wrappers take the twin only for CPU tensors; on a CUDA tensor they
launch the kernel or raise. They count under "closest", "closest_stats"
and "anyhit" in trace/kernels.py's LAUNCHES and TWIN_CALLS.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from tracerboy_tpu_torch.accel.bvh import INVALID
from tracerboy_tpu_torch.trace import kernels

LEAF = 8
BIG = 1e30
STACK_DEPTH = 96    # kStackDepth of csrc/bvh_common.cuh: the stats walk
# A block's 16 octet stacks of (id, t) entries fit the 48 KB of shared
# memory a launch gets without opting in to more.
MAX_STACK_ENTRIES = 384
_SOURCE = kernels.CSRC / "bvh_traverse.cu"
kernels.register("closest", "closest_stats", "anyhit")
_lib = None


def build_kernels():
    """Build (or reuse) and load the traversal kernels' library."""
    global _lib
    if _lib is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _lib = kernels.load_library("tbtraverse", _SOURCE, {
            "tb_closest_hit": [p, p, p, p, p, p, i, i, p, p, p, p, p, p, p],
            "tb_closest_hit_stats": [p, p, p, p, p, i, i, p, p, p, p, p, p,
                                     p, p, p],
            "tb_any_hit": [p, p, p, p, p, p, i, i, p, p, p, p],
        })
    return _lib


def _check(o, d, t_max, nodes, tris_bw, roots):
    specs = [*kernels.ray_specs(o, d, t_max),
             ("nodes", nodes, (nodes.shape[0], 128), torch.int32),
             ("tris_bw", tris_bw, (tris_bw.shape[0], 128), torch.float32)]
    if roots is not None:
        specs.append(("roots", roots, (o.shape[0],), torch.int32))
    kernels.check_inputs(o, *specs)
    if tris_bw.data_ptr() % 16:
        raise ValueError("tris_bw must be 16-byte aligned")


def stack_need(nodes) -> int:
    """The most stack entries a walk can hold on this tree: 7 per level (a
    popped node pushes up to 8 children and the next pop takes one) and
    one."""
    ch = nodes[:, 48:56].cpu().numpy().astype(np.int64)
    depth, level = 0, np.zeros(1, np.int64)
    while level.size:
        depth += 1
        kids = ch[level].reshape(-1)
        level = kids[(kids >= 0) & (kids != INVALID)]
    return 7 * depth + 1


_stack_entries: dict = {}   # id(nodes) -> (weak reference, stack_need)


def stack_entries(nodes, depth=None) -> int:
    """stack_need(nodes), kept per node table (it reads the table on the
    host). With depth, the stack of a walk that drops pushes past depth
    entries: at most depth. Without, raises if the octet stacks would not
    fit a block."""
    known = _stack_entries.get(id(nodes))
    if known is None or known[0]() is not nodes:
        for key in [k for k, (ref, _) in _stack_entries.items()
                    if ref() is None]:
            del _stack_entries[key]
        known = (weakref.ref(nodes), stack_need(nodes))
        _stack_entries[id(nodes)] = known
    if depth is not None:
        return min(known[1], depth)
    if known[1] > MAX_STACK_ENTRIES:
        raise ValueError(f"the tree can ask for {known[1]} stack entries; "
                         f"the kernels hold {MAX_STACK_ENTRIES}")
    return known[1]


def closest_hit(o, d, t_max, nodes, tris_bw, roots=None):
    """Closest hit in (1e-5, t_max). o, d: (N, 3) f32; t_max: (N,) f32;
    roots: optional (N,) int32 per-ray roots. Returns (t, packed tri id
    int32, u, v)."""
    _check(o, d, t_max, nodes, tris_bw, roots)
    if o.device.type == "cpu":
        kernels.TWIN_CALLS["closest"] += 1
        return closest_hit_plain(o, d, t_max, nodes, tris_bw, roots)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty(n, dtype=torch.float32, device=o.device)
    v = torch.empty(n, dtype=torch.float32, device=o.device)
    # The zeroed counter from which the persistent blocks draw their rays.
    next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
    kernels.launch(build_kernels(), "tb_closest_hit", o.device, o, d, t_max,
                   nodes, tris_bw, roots, n, stack_entries(nodes), t, tri, u,
                   v, next_ray)
    kernels.LAUNCHES["closest"] += 1
    return t, tri, u, v


def closest_hit_stats(o, d, t_max, nodes, tris_bw):
    """closest_hit from node 0 with the per-ray traversal cost. Returns
    (t, packed tri id, u, v, pops, clusters), the counts int32 (N,)."""
    _check(o, d, t_max, nodes, tris_bw, None)
    if o.device.type == "cpu":
        kernels.TWIN_CALLS["closest_stats"] += 1
        return closest_hit_stats_plain(o, d, t_max, nodes, tris_bw)
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    i32 = dict(dtype=torch.int32, device=o.device)
    t, u, v = (torch.empty(n, **f32) for _ in range(3))
    tri, pops, clusters = (torch.empty(n, **i32) for _ in range(3))
    # The zeroed counter from which the persistent warps draw their rays.
    next_ray = torch.zeros(1, **i32)
    kernels.launch(build_kernels(), "tb_closest_hit_stats", o.device, o, d,
                   t_max, nodes, tris_bw, n, stack_entries(nodes, STACK_DEPTH),
                   t, tri, u, v, pops, clusters, next_ray)
    kernels.LAUNCHES["closest_stats"] += 1
    return t, tri, u, v, pops, clusters


def any_hit(o, d, t_max, nodes, tris_bw, roots=None):
    """Occlusion by any triangle in (1e-5, t_max). Returns (N,) bool."""
    _check(o, d, t_max, nodes, tris_bw, roots)
    if o.device.type == "cpu":
        kernels.TWIN_CALLS["anyhit"] += 1
        return anyhit_plain(o, d, t_max, nodes, tris_bw, roots)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
    kernels.launch(build_kernels(), "tb_any_hit", o.device, o, d, t_max,
                   nodes, tris_bw, roots, n, stack_entries(nodes), occ,
                   next_ray)
    kernels.LAUNCHES["anyhit"] += 1
    return occ


# ----------------------------------------------------------------------------
# Plain twins: every (ray, cluster) pair whose cluster box the ray enters
# within t_max gets the kernel's Baldwin-Weber test. The cluster boxes are
# the leaf boxes stored in the node rows, so this tests a superset of what
# the kernel's traversal reaches and needs no stack.

PAIR_BUDGET = 1 << 22   # (ray, cluster) slab tests per chunk


def cluster_boxes(nodes, n_clusters):
    """Per-cluster (lo, hi), each (C, 3), from the leaf slots of the
    node rows; clusters no node references get an empty box."""
    W = nodes.shape[0]
    cid = nodes[:, 48:56].to(torch.int64)
    b = nodes[:, :48].contiguous().view(torch.float32).reshape(W, 6, 8)
    leaf = (cid < 0)
    cl = -cid[leaf] - 1
    lo = torch.full((n_clusters, 3), BIG, dtype=torch.float32,
                    device=nodes.device)
    hi = torch.full((n_clusters, 3), -BIG, dtype=torch.float32,
                    device=nodes.device)
    lo[cl] = b[:, 0:3, :].permute(0, 2, 1)[leaf]
    hi[cl] = b[:, 3:6, :].permute(0, 2, 1)[leaf]
    return lo, hi


def fix_dir(v):
    eps = 1e-12
    return torch.where(torch.abs(v) < eps,
                       torch.where(v < 0, -eps, eps).to(v.dtype), v)


def box_entry(o, inv, lo, hi):
    """(t_near, t_far) of rays (o, inv = 1 / fixed d, (..., 3)) against
    boxes (lo, hi, (..., 3)), broadcast, in the kernels' order."""
    t0 = [(lo[..., k] - o[..., k]) * inv[..., k] for k in range(3)]
    t1 = [(hi[..., k] - o[..., k]) * inv[..., k] for k in range(3)]
    t_near = torch.maximum(
        torch.maximum(torch.minimum(t0[0], t1[0]),
                      torch.minimum(t0[1], t1[1])),
        torch.minimum(t0[2], t1[2]))
    t_far = torch.minimum(
        torch.minimum(torch.maximum(t0[0], t1[0]),
                      torch.maximum(t0[1], t1[1])),
        torch.maximum(t0[2], t1[2]))
    return t_near, t_far


def _box_hit(o, inv, tmax, lo, hi):
    t_near, t_far = box_entry(o, inv, lo, hi)
    return (t_far >= torch.clamp_min(t_near, 0.0)) & (t_near < tmax)


def _pairs(o, inv, tmax, lo, hi):
    """(ray, cluster) index pairs whose box the ray enters in t_max."""
    hit = _box_hit(o[:, None], inv[:, None], tmax[:, None], lo[None],
                   hi[None])
    return hit.nonzero(as_tuple=True)


def _bw_tests(o, d, rows):
    """Baldwin-Weber tests of P rays against the 8 triangles of their
    cluster rows (P, 128): (t, u, v, ok), each (P, 8), in the kernel's
    order of operations."""
    r = rows[:, : LEAF * 12].reshape(-1, LEAF, 12)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    c = [r[:, :, k] for k in range(12)]
    A = c[0] * ox + c[1] * oy + c[2] * oz + c[3]
    B = c[0] * dx + c[1] * dy + c[2] * dz
    good = torch.abs(B) > 1e-12
    inv_b = torch.where(good, 1.0 / B, 0.0)
    t = -A * inv_b
    co = c[4] * ox + c[5] * oy + c[6] * oz + c[7]
    cd = c[4] * dx + c[5] * dy + c[6] * dz
    u = co + t * cd
    eo = c[8] * ox + c[9] * oy + c[10] * oz + c[11]
    ed = c[8] * dx + c[9] * dy + c[10] * dz
    v = eo + t * ed
    ok = (good & (u >= -1e-5) & (v >= -1e-5) & (u + v <= 1.0 + 1e-5)
          & (t > 1e-5))
    return t, u, v, ok


def _chunks(o, d, t_max, nodes, tris_bw):
    """Yield per chunk of live rays: (ray ids, pair ray index into the
    chunk, pair cluster, t, u, v, ok & t < t_max), all pairs (P, 8)."""
    C = tris_bw.shape[0]
    lo, hi = cluster_boxes(nodes, C)
    live = (t_max > 0).nonzero(as_tuple=True)[0]
    step = max(1, PAIR_BUDGET // max(C, 1))
    for s in range(0, live.shape[0], step):
        ids = live[s:s + step]
        oc, dc, tc = o[ids], d[ids], t_max[ids]
        inv = 1.0 / fix_dir(dc)
        ri, ci = _pairs(oc, inv, tc, lo, hi)
        if ri.numel() == 0:
            continue
        t, u, v, ok = _bw_tests(oc[ri], dc[ri], tris_bw[ci])
        ok = ok & (t < tc[ri][:, None])
        yield ids, ri, ci, t, u, v, ok


def subtree_clusters(nodes):
    """Host-side map of every node to the clusters of its subtree: the
    clusters in depth-first order (perm) and each node's range
    [start, end) in it. Returns three int64 numpy arrays."""
    ch = nodes[:, 48:56].cpu().numpy().astype(np.int64)
    start = np.zeros(ch.shape[0], np.int64)
    end = np.zeros(ch.shape[0], np.int64)
    perm: list = []

    def visit(n):     # recursion depth = tree depth
        start[n] = len(perm)
        for c in ch[n]:
            if c == INVALID:
                continue
            if c < 0:
                perm.append(-1 - c)
            else:
                visit(c)
        end[n] = len(perm)

    visit(0)
    return np.asarray(perm, np.int64), start, end


def _root_chunks(o, d, t_max, nodes, tris_bw, roots):
    """_chunks for per-ray roots: each live ray is paired with the
    clusters under its root (box-tested) or with its root cluster (not
    box-tested), in chunks of at most PAIR_BUDGET pairs."""
    dev = o.device
    C = tris_bw.shape[0]
    lo, hi = cluster_boxes(nodes, C)
    perm, start, end = (torch.from_numpy(a).to(dev)
                        for a in subtree_clusters(nodes))
    live = (t_max > 0).nonzero(as_tuple=True)[0]
    r = roots[live].to(torch.int64)
    is_node = r >= 0
    node = torch.clamp_min(r, 0)
    first = torch.where(is_node, start[node], 0)
    count = torch.where(is_node, end[node] - start[node], 1)
    cum = torch.cumsum(count, 0).cpu().numpy()
    s = 0
    while s < live.shape[0]:
        base = cum[s - 1] if s else 0
        e = max(s + 1, int(np.searchsorted(cum, base + PAIR_BUDGET,
                                           side="right")))
        ids = live[s:e]
        n_c = count[s:e]
        ri = torch.repeat_interleave(torch.arange(e - s, device=dev), n_c)
        offs = (torch.arange(ri.shape[0], device=dev)
                - torch.repeat_interleave(torch.cumsum(n_c, 0) - n_c, n_c))
        nd = is_node[s:e][ri]
        ci = torch.where(nd, perm[torch.where(nd, first[s:e][ri] + offs, 0)],
                         -r[s:e][ri] - 1)
        oc, dc, tc = o[ids][ri], d[ids][ri], t_max[ids][ri]
        keep = ~nd | _box_hit(oc, 1.0 / fix_dir(dc), tc, lo[ci], hi[ci])
        ri, ci, oc, dc, tc = ri[keep], ci[keep], oc[keep], dc[keep], tc[keep]
        s = e
        if ri.numel() == 0:
            continue
        t, u, v, ok = _bw_tests(oc, dc, tris_bw[ci])
        ok = ok & (t < tc[:, None])
        yield ids, ri, ci, t, u, v, ok


def _pair_chunks(o, d, t_max, nodes, tris_bw, roots):
    if roots is None:
        return _chunks(o, d, t_max, nodes, tris_bw)
    return _root_chunks(o, d, t_max, nodes, tris_bw, roots)


def closest_hit_plain(o, d, t_max, nodes, tris_bw, roots=None):
    """Plain PyTorch closest hit over the packed tables (same contract as
    closest_hit; ties go to the lowest packed id)."""
    n = o.shape[0]
    dev = o.device
    t_best = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(n, dtype=torch.float32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    k8 = torch.arange(LEAF, device=dev)
    for ids, ri, ci, t, u, v, ok in _pair_chunks(o, d, t_max, nodes,
                                                 tris_bw, roots):
        pid = (ci[:, None] * LEAF + k8[None, :])[ok]
        rr = ri[:, None].expand_as(ok)[ok]
        tt, uu, vv = t[ok], u[ok], v[ok]
        R = ids.shape[0]
        tmin = torch.full((R,), float("inf"), device=dev).scatter_reduce(
            0, rr, tt, "amin")
        at_min = tt == tmin[rr]
        idmin = torch.full((R,), 2**62, dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, rr[at_min], pid[at_min], "amin")
        sel = at_min & (pid == idmin[rr])
        dst = ids[rr[sel]]
        t_best[dst] = tt[sel]
        tri[dst] = pid[sel].to(torch.int32)
        u_best[dst] = uu[sel]
        v_best[dst] = vv[sel]
    return t_best, tri, u_best, v_best


def hit_attributes(o, d, tri, tris_bw):
    """(t, u, v) of each ray against the one packed triangle id it names
    (all tri >= 0), by the kernels' Baldwin-Weber arithmetic. Where the
    kernel and its twin pick different ids, this shows whether the
    kernel's pick is a real hit at the same t (a tie)."""
    tri = tri.to(torch.int64)
    rows = tris_bw[torch.div(tri, LEAF, rounding_mode="floor")]
    t, u, v, _ = _bw_tests(o, d, rows)
    k = (tri % LEAF)[:, None]
    return tuple(x.gather(1, k)[:, 0] for x in (t, u, v))


def anyhit_plain(o, d, t_max, nodes, tris_bw, roots=None):
    """Plain PyTorch occlusion over the packed tables."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for ids, ri, _, _, _, _, ok in _pair_chunks(o, d, t_max, nodes,
                                                tris_bw, roots):
        occ[ids[ri[ok.any(dim=1)]]] = True
    return occ


# ----------------------------------------------------------------------------
# Plain twin of the stats kernel: the kernel's own stack walk, one step per
# pop, in lock step over the rays that still have a stack.

def _test_leaf(o, d, tris_bw, rays, cl, best, best_tri, best_u, best_v):
    """The 8 triangles of cluster cl[j] against ray rays[j], in order, as
    test_cluster does: the first triangle at the least t below best wins."""
    t, u, v, ok = _bw_tests(o[rays], d[rays], tris_bw[cl])
    t = torch.where(ok & (t < best[rays][:, None]), t, float("inf"))
    k = torch.argmin(t, dim=1, keepdim=True)
    tk = t.gather(1, k)[:, 0]
    upd = tk < float("inf")
    r = rays[upd]
    best[r] = tk[upd]
    best_tri[r] = (cl[upd] * LEAF + k[upd, 0]).to(torch.int32)
    best_u[r] = u.gather(1, k)[upd, 0]
    best_v[r] = v.gather(1, k)[upd, 0]


def closest_hit_stats_plain(o, d, t_max, nodes, tris_bw):
    """Plain PyTorch twin of closest_hit_stats (same outputs, same
    counts). A push past STACK_DEPTH entries is dropped and counted in
    kernels.stack_overflows(), as the kernel does."""
    return _stack_walk(o, d, t_max, nodes, tris_bw)


def walk_footprint(o, d, t_max, nodes, tris_bw, any_hit=False):
    """What the closest-hit kernel's walk of these rays reads, or with
    any_hit the any-hit kernel's (which culls by t_max only and stops a
    ray at its first hit): (node_rows (W,) bool, cluster_rows (C,) bool,
    pops (N,) int32, clusters (N,) int32). A node row is read when a ray
    pops and expands it, a cluster row when a ray tests its triangles.
    The stats twin's walk; a kernel's bound counts each such row once."""
    seen = (torch.zeros(nodes.shape[0], dtype=torch.bool, device=o.device),
            torch.zeros(tris_bw.shape[0], dtype=torch.bool, device=o.device))
    out = _stack_walk(o, d, t_max, nodes, tris_bw, any_hit, seen)
    return (*seen, out[4], out[5])


def _stack_walk(o, d, t_max, nodes, tris_bw, any_hit=False, seen=None,
                held=None):
    """The kernels' stack walk in lock step (closest_hit_stats_plain);
    any_hit and seen as in walk_footprint; held, an int64 (N,) tensor,
    takes the most entries each ray's stack held."""
    n = o.shape[0]
    dev = o.device
    best = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    pops = torch.zeros(n, dtype=torch.int32, device=dev)
    clusters = torch.zeros(n, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    stack_t = torch.full((n, STACK_DEPTH), -BIG, dtype=torch.float32,
                         device=dev)
    sp = (t_max > 0).to(torch.int64)       # node 0 on every live stack
    inv = 1.0 / fix_dir(d)
    box = nodes[:, :48].contiguous().view(torch.float32)
    child = nodes[:, 48:56]
    slot = torch.arange(LEAF, device=dev)[None, :]
    overflow = 0
    while True:
        act = (sp > 0).nonzero(as_tuple=True)[0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        top = sp[act]
        keep = stack_t[act, top] < best[act]     # the pop-time cull
        r, node = act[keep], stack[act, top][keep].to(torch.int64)
        if r.numel() == 0:
            continue
        pops[r] += 1
        if seen is not None:
            seen[0][node] = True
        b, cid = box[node], child[node]
        o_r, inv_r = o[r], inv[r]
        push_t = torch.zeros((r.shape[0], LEAF), dtype=torch.float32,
                             device=dev)
        push_id = torch.zeros((r.shape[0], LEAF), dtype=torch.int32,
                              device=dev)
        n_push = torch.zeros(r.shape[0], dtype=torch.int64, device=dev)
        for c in range(LEAF):
            t_near, t_far = box_entry(o_r, inv_r, b[:, c:24:8],
                                      b[:, 24 + c::8])
            enter = ((cid[:, c] != INVALID)
                     & (t_far >= torch.clamp_min(t_near, 0.0))
                     & (t_near < best[r]))
            if any_hit:     # an occluded ray tests no further child
                enter &= best_tri[r] < 0
            inner = enter & (cid[:, c] >= 0)
            # Sorted insertion by descending t_near: the new child is
            # pushed after, so above, every entry with t >= its own.
            filled = slot < n_push[:, None]
            pos = ((push_t >= t_near[:, None]) & filled).sum(1, keepdim=True)
            shift = inner[:, None] & (slot > pos) & (slot <= n_push[:, None])
            put = inner[:, None] & (slot == pos)
            prev_t = torch.cat([push_t[:, :1], push_t[:, :-1]], 1)
            prev_id = torch.cat([push_id[:, :1], push_id[:, :-1]], 1)
            push_t = torch.where(put, t_near[:, None],
                                 torch.where(shift, prev_t, push_t))
            push_id = torch.where(put, cid[:, c:c + 1],
                                  torch.where(shift, prev_id, push_id))
            n_push += inner
            leaf = (enter & (cid[:, c] < 0)).nonzero(as_tuple=True)[0]
            if leaf.numel():
                rays = r[leaf]
                cl = -cid[leaf, c].to(torch.int64) - 1
                _test_leaf(o, d, tris_bw, rays, cl, best, best_tri, best_u,
                           best_v)
                clusters[rays] += 1
                if seen is not None:
                    seen[1][cl] = True
        if any_hit:         # an occluded ray pushes nothing and stops
            done = best_tri[r] >= 0
            n_push = torch.where(done, 0, n_push)
            sp[r[done]] = 0
        for k in range(LEAF):
            want = k < n_push
            room = want & (sp[r] < STACK_DEPTH)
            overflow += int((want & ~room).sum())
            rr = r[room]
            stack[rr, sp[rr]] = push_id[room, k]
            stack_t[rr, sp[rr]] = push_t[room, k]
            sp[rr] += 1
        if held is not None:
            torch.maximum(held, sp, out=held)
    if overflow:
        kernels.add_overflows(dev, overflow)
    t = torch.where(best_tri < 0, BIG, best)
    return t, best_tri, best_u, best_v, pops, clusters


# ----------------------------------------------------------------------------
# The octet kernels' walk in plain PyTorch, in lock step over the rays that
# still have a stack. Not the kernels' twin (that stays closest_hit_plain /
# anyhit_plain): it shows on a CPU that the walk order of csrc/bvh_traverse.cu
# gives the contract's outputs, and counts what that walk does.

def octet_walk(o, d, t_max, nodes, tris_bw, roots=None, any_hit=False,
               stack_size=None, seen=None):
    """The walk of the closest-hit kernel, or with any_hit of the any-hit
    kernel, step for step: a popped node is culled by !(entry t < best)
    (closest hit); its 8 children are tested against the best hit as it
    stands at the pop (t_max for any hit); the entered inner children go
    to stack[sp + rank], rank = the entered inner children with a larger
    entry t, or an equal one and a lower slot; then the entered leaves
    are tested nearest first (at equal t the lower slot first), each
    culled again by entry t < best (closest hit); an occluded ray stops
    (any hit). roots as in closest_hit. stack_size: the entries of each
    ray's stack (default stack_need(nodes)); a push past it is dropped and
    counted in kernels.stack_overflows(). seen: a pair of bool masks
    (W,), (C,) in which the node rows expanded and the cluster rows
    tested are marked.

    Returns (t, tri, u, v, pops, clusters, held): the closest hit as
    closest_hit returns it (with any_hit, tri >= 0 says occluded and t,
    u, v are the hit that ended the ray), and per ray int32 the nodes
    expanded, the clusters tested and the most stack entries held."""
    n = o.shape[0]
    dev = o.device
    size = stack_need(nodes) if stack_size is None else stack_size
    best = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    pops = torch.zeros(n, dtype=torch.int32, device=dev)
    clusters = torch.zeros(n, dtype=torch.int32, device=dev)
    held = torch.zeros(n, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, size), dtype=torch.int32, device=dev)
    stack_t = torch.full((n, size), -BIG, dtype=torch.float32, device=dev)
    inv = 1.0 / fix_dir(d)
    box = nodes[:, :48].contiguous().view(torch.float32)
    child = nodes[:, 48:56]
    slot = torch.arange(LEAF, device=dev)
    lower = slot[None, :] < slot[:, None]      # [c, j]: slot j below slot c

    def test(rays, cl):
        _test_leaf(o, d, tris_bw, rays, cl, best, best_tri, best_u, best_v)
        clusters[rays] += 1
        if seen is not None:
            seen[1][cl] = True

    live = t_max > 0
    root = (torch.zeros(n, dtype=torch.int64, device=dev) if roots is None
            else roots.to(torch.int64))
    stack[:, 0] = torch.clamp_min(root, 0).to(torch.int32)
    sp = (live & (root >= 0)).to(torch.int64)
    held[:] = sp.to(torch.int32)
    leaf_root = (live & (root < 0)).nonzero(as_tuple=True)[0]
    if leaf_root.numel():
        test(leaf_root, -root[leaf_root] - 1)
    overflow = 0
    while True:
        act = (sp > 0).nonzero(as_tuple=True)[0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        top = sp[act]
        if any_hit:
            r, node = act, stack[act, top].to(torch.int64)
        else:
            keep = stack_t[act, top] < best[act]     # the pop-time cull
            r, node = act[keep], stack[act, top][keep].to(torch.int64)
            if r.numel() == 0:
                continue
        pops[r] += 1
        if seen is not None:
            seen[0][node] = True
        b = box[node].reshape(-1, 6, LEAF)
        cid = child[node]
        t_near, t_far = box_entry(o[r][:, None], inv[r][:, None],
                                  b[:, 0:3].permute(0, 2, 1),
                                  b[:, 3:6].permute(0, 2, 1))
        cap = t_max[r] if any_hit else best[r]
        enter = ((cid != INVALID) & (t_far >= torch.clamp_min(t_near, 0.0))
                 & (t_near < cap[:, None]))
        inner, leaf = enter & (cid >= 0), enter & (cid < 0)
        mine, other = t_near[:, :, None], t_near[:, None, :]
        tie_low = (other == mine) & lower[None]
        rank = (inner[:, None, :] & ((other > mine) | tie_low)).sum(2)
        leaf_rank = (leaf[:, None, :] & ((other < mine) | tie_low)).sum(2)
        pos = sp[r][:, None] + rank
        put = inner & (pos < size)
        overflow += int((inner & ~put).sum())
        rr = r[:, None].expand_as(put)[put]
        stack[rr, pos[put]] = cid[put]
        stack_t[rr, pos[put]] = t_near[put]
        sp[r] = torch.clamp_max(sp[r] + inner.sum(1), size)
        held[r] = torch.maximum(held[r], sp[r].to(torch.int32))
        for q in range(LEAF):
            pick = leaf & (leaf_rank == q)
            has = pick.any(1)
            if not bool(has.any()):
                break
            c = pick[has].to(torch.int8).argmax(1, keepdim=True)
            rays = r[has]
            entry = t_near[has].gather(1, c)[:, 0]
            go = (best_tri[rays] < 0) if any_hit else (entry < best[rays])
            cl = -cid[has].gather(1, c)[:, 0].to(torch.int64) - 1
            if bool(go.any()):
                test(rays[go], cl[go])
        if any_hit:         # an occluded ray stops
            sp[r[best_tri[r] >= 0]] = 0
    if overflow:
        kernels.add_overflows(dev, overflow)
    t = torch.where(best_tri < 0, BIG, best)
    return t, best_tri, best_u, best_v, pops, clusters, held


# ----------------------------------------------------------------------------
# The wide traversal: the lock-step walk of the unpacked 8-wide BVH
# (tracerboy_tpu/trace/traverse.py traverse_wide), plain PyTorch. The
# portable oracle (WaveConfig.traversal "wide", Renderer's TB_TRAVERSAL=jnp)
# and the traversal study's per-ray need.

WIDE_STACK_DEPTH = 48


def traverse_wide(orig, direc, t_max, bounds_lo, bounds_hi, children,
                  tri_v0, tri_v1, tri_v2, leaf_size: int,
                  max_steps: int = 100_000, any_hit: bool = False,
                  tri_mask=None):
    """Closest-hit (or any-hit) traversal of the 8-wide BVH bounds_lo,
    bounds_hi (W, 8, 3), children (W, 8) int32 over leaf clusters of
    leaf_size consecutive triangles tri_v0/1/2 (C * leaf_size, 3). All
    rays advance in lock step through their own (N, 48) stacks; inner
    children are pushed in slot order (a push past the stack is dropped),
    leaf clusters are tested slot by slot by Moller-Trumbore
    (intersect.ray_triangle) with tri_mask (T,) bool leaving triangles
    out. Returns (t, tri index into the triangle arrays or -1, u, v,
    cost): t = 1e30 on a miss, cost the ray's box tests (8 a pop) plus
    triangle tests (leaf_size a cluster). With any_hit, the (N,) bool
    occlusion mask instead."""
    from tracerboy_tpu_torch.trace.intersect import ray_aabb, ray_triangle

    N = orig.shape[0]
    dev = orig.device
    K = leaf_size
    W = children.shape[0]
    rows = torch.arange(N, device=dev)
    inv_dir = 1.0 / fix_dir(direc)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    stack = torch.zeros((N, WIDE_STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.ones(N, dtype=torch.int64, device=dev)   # root at slot 0
    t_best = t_max.expand(N).clone()
    tri_best = torch.full((N,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(N, dtype=torch.float32, device=dev)
    v_best = torch.zeros(N, dtype=torch.float32, device=dev)
    occluded = torch.zeros(N, dtype=torch.bool, device=dev)
    box_tests = torch.zeros(N, dtype=torch.float32, device=dev)
    tri_tests = torch.zeros(N, dtype=torch.float32, device=dev)
    ks = torch.arange(K, device=dev)[None, :]
    for _ in range(max_steps):
        live = sp > 0
        if any_hit:
            live = live & ~occluded
        if not bool(live.any()):
            break
        spm1 = torch.clamp_min(sp - 1, 0)
        node = stack[rows, spm1].to(torch.int64)
        sp = torch.where(live, spm1, sp)
        node_c = torch.clamp(node, 0, W - 1)
        ch = children[node_c]
        _, box_hit = ray_aabb(orig[:, None, :], inv_dir[:, None, :],
                              bounds_lo[node_c], bounds_hi[node_c],
                              t_best[:, None])
        valid = box_hit & (ch != INVALID) & live[:, None]
        is_leaf = valid & (ch < 0)
        is_inner = valid & (ch >= 0)
        box_tests = box_tests + torch.where(live, 8.0, 0.0)
        tri_tests = tri_tests + is_leaf.sum(1).to(torch.float32) * K

        # Push the inner children in slot order; slots past the stack drop.
        slot_pos = sp[:, None] + torch.cumsum(is_inner, 1) - 1
        put = is_inner & (slot_pos < WIDE_STACK_DEPTH)
        r8 = rows[:, None].expand(N, 8)
        stack[r8[put], slot_pos[put]] = ch[put]
        sp = torch.clamp_max(sp + is_inner.sum(1), WIDE_STACK_DEPTH)

        # Leaf clusters slot by slot, over the rays that hold one there (a
        # ray without one changes nothing, so it is left out of the test).
        for sl in range(8):
            r = is_leaf[:, sl].nonzero(as_tuple=True)[0]
            if r.numel() == 0:
                continue
            cluster = (-ch[r, sl] - 1).to(torch.int64)
            tri_ids = cluster[:, None] * K + ks
            t, uu, vv, hit = ray_triangle(
                orig[r, None, :], direc[r, None, :], tri_v0[tri_ids],
                tri_v1[tri_ids], tri_v2[tri_ids], t_max=t_best[r, None])
            if tri_mask is not None:
                hit = hit & tri_mask[tri_ids]
            t = torch.where(hit, t, BIG)
            k_best = torch.argmin(t, dim=1, keepdim=True)
            t_k = t.gather(1, k_best)[:, 0]
            better = t_k < t_best[r]
            rb, kb = r[better], k_best[better]
            t_best[rb] = t_k[better]
            tri_best[rb] = tri_ids[better].gather(1, kb)[:, 0].to(torch.int32)
            u_best[rb] = uu[better].gather(1, kb)[:, 0]
            v_best[rb] = vv[better].gather(1, kb)[:, 0]
            occluded[r] |= (t < BIG).any(1)
    if any_hit:
        return occluded
    miss = tri_best < 0
    return (torch.where(miss, BIG, t_best), tri_best, u_best, v_best,
            box_tests + tri_tests)
