"""Binned-cluster traversal (tracerboy_tpu/trace/binned.py).

Rays are sorted to the clusters they need, and each 128-triangle cluster
is tested against exactly the rays that asked for it:
 1. SELECT - select_clusters: a walk over a coarse BVH whose leaves are
    128-triangle clusters keeps each ray's K = 16 nearest clusters by box
    entry t, plus `dropped`, a lower bound on the entry t of every entered
    cluster outside the set;
 2. EXPAND + SORT - the (ray, cluster) pairs of KCHUNK = 8 slots at a
    time, sorted by cluster;
 3. DENSE - dense_pairs: each pair's nearest hit in its cluster;
 4. COMBINE - per ray, the nearest of its pairs (the lowest slot at a
    tie);
 5. FALLBACK - a ray whose best hit lies beyond `dropped` may have missed
    a nearer cluster, so it runs the closest-hit kernel over the whole
    packed BVH below its best hit.
Triangle ids are packed ids, the traversal kernels' id space.

Tables (pack_scene_binned, from the packed 9-float triangle rows):
- bn_nodes (W, 128) int32: the coarse 8-wide BVH in the node-row layout
  of trace/traverse.py; a leaf child -c-1 is cluster c (coarse order);
- bn_mot (n_cl, 3*128, 4) float32: per cluster the Baldwin-Weber rows of
  its 128 triangles, [n|-d] rows 0-127, [g1|h1] 128-255, [g2|h2] 256-383;
- bn_base (n_cl + 1,) int32: packed id of each cluster's first triangle
  (-1 last).

The JAX package's dense kernel tests 256-pair tiles spanning at most
DSEG = 8 cluster runs, and a pair in a tile spanning more is "uncovered"
and sent to the fallback. Here each pair's thread is handed its cluster
directly, so every pair is covered; the port has no `covered` output and
no uncovered poisoning, and binned_closest's outputs are the JAX
package's.

The selection kernel also folds into `dropped` the clusters (and nodes)
it prunes because its K slots are full; the JAX package's folds only the
slots it evicts and the leaves it rejects within one node. See
csrc/binned.cu and ROADMAP.md Queue 3.

select_clusters and dense_pairs launch their CUDA kernels
(csrc/binned.cu, whose header gives their design) on CUDA tensors and
take their plain twins on CPU tensors; binned_closest takes the twins
throughout with plain=True. The selection kernel's slots come out nearest
first, as the twin's; its stack holds traverse.stack_need(bn_nodes)
entries a ray, and a push past it is counted in kernels.stack_overflows().
STATS counts live rays and fallback rays (device tensors, read with
int()).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tracerboy_tpu_torch.accel.bvh import INVALID, build_bvh
from tracerboy_tpu_torch.accel.pack import bw_rows
from tracerboy_tpu_torch.trace import kernels, traverse

CLUSTER = 128          # triangles per cluster (16 packed rows)
KSEL = 16              # nearest clusters kept per ray
KCHUNK = 8             # selection slots expanded into pairs at a time
BIG = 1e30
_SOURCE = kernels.CSRC / "binned.cu"
kernels.register("select", "dense")
_lib = None
STATS: dict = {"rays": 0, "fallback_rays": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


# ---------------------------------------------------------------------------
# Packing (a numpy copy of the JAX package's)


def pack_scene_binned(pk_tris, num_pk_rows: int | None = None) -> dict:
    """The binned tables from the packed 9-float triangle rows pk_tris
    (Cpk, 128) f32 (accel/pack.py, raw_rows=True), sharing their
    triangle id space. Returns numpy dict(bn_nodes, bn_mot, bn_base)."""
    rows = np.asarray(pk_tris, np.float32)
    if num_pk_rows is not None:
        rows = rows[:num_pk_rows]
    Cpk = rows.shape[0]
    per = CLUSTER // 8                       # pk rows per cluster
    n_cl = (Cpk + per - 1) // per
    pad_rows = n_cl * per - Cpk
    if pad_rows:
        rows = np.concatenate(
            [rows, np.zeros((pad_rows, 128), np.float32)], axis=0
        )
    tri = rows[:, : 8 * 9].reshape(-1, 9)      # (n_cl*CLUSTER, 9) pk order
    v0, v1, v2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]

    # Chunk AABBs (pk-order chunks of CLUSTER tris); degenerate padding
    # triangles (zero area) are excluded from the bounds.
    area = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    ok = (area > 0)[:, None]
    lo3 = np.where(ok, np.minimum(np.minimum(v0, v1), v2), BIG)
    hi3 = np.where(ok, np.maximum(np.maximum(v0, v1), v2), -BIG)
    lo = lo3.reshape(n_cl, CLUSTER, 3).min(axis=1)
    hi = hi3.reshape(n_cl, CLUSTER, 3).max(axis=1)
    empty = (hi < lo).any(axis=1)
    ctr = np.where(empty[:, None], 0.0, (lo + hi) * 0.5)
    lo = np.where(empty[:, None], np.float32(BIG), lo)
    hi = np.where(empty[:, None], np.float32(-BIG), hi)

    # Coarse 8-wide BVH over cluster boxes: (lo, hi, centroid) as the
    # three "vertices" -- their min/max is exactly the box.
    bvh = build_bvh(lo, hi, ctr, leaf_size=1)
    corder = np.asarray(bvh.tri_order)[: len(lo)]  # coarse id -> chunk

    W = bvh.num_nodes
    blo = np.asarray(bvh.bounds_lo)
    bhi = np.asarray(bvh.bounds_hi)
    ch = np.asarray(bvh.children).astype(np.int32)
    valid = ch != INVALID
    blo = np.where(valid[..., None], blo, np.float32(BIG))
    bhi = np.where(valid[..., None], bhi, np.float32(-BIG))
    nrows = np.zeros((W, 128), np.int32)
    bounds = np.concatenate([blo, bhi], axis=2)
    nrows[:, :48] = (
        bounds.transpose(0, 2, 1).reshape(W, 48).astype(np.float32)
        .view(np.int32)
    )
    nrows[:, 48:56] = ch

    bw = bw_rows(v0, v1, v2).reshape(n_cl, CLUSTER, 3, 4)[corder]
    mot = bw.transpose(0, 2, 1, 3).reshape(n_cl, 3 * CLUSTER, 4)
    base = np.concatenate(
        [corder.astype(np.int32) * CLUSTER, np.full(1, -1, np.int32)]
    )
    return dict(bn_nodes=nrows, bn_mot=np.ascontiguousarray(mot),
                bn_base=base)


# ---------------------------------------------------------------------------
# Kernels and twins


def build_kernels():
    """Build (or reuse) and load the selection and dense kernels' library."""
    global _lib
    if _lib is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _lib = kernels.load_library("tbbinned", _SOURCE, {
            "tb_select_clusters": [p, p, p, p, i, i, p, p, p, p, p, p],
            "tb_dense_pairs": [p, p, p, p, p, p, i, p, p, p, p, p],
        })
    return _lib


def select_clusters(o, d, t_max, nodes):
    """The KSEL nearest clusters of each ray by box entry t (max(t_near,
    0), entered iff t_far >= it and it < t_max). Returns slot_t (N, KSEL)
    f32 (1e30 = empty), slot_c (N, KSEL) int32 (-1 = empty) and dropped
    (N,) f32 (1e30 = nothing dropped), with the K-th nearest entry t <=
    dropped <= the entry t of every entered cluster outside the slots.
    The JAX package's t_lo window is always 0 on the wave and is not
    ported."""
    kernels.check_inputs(
        o, *kernels.ray_specs(o, d, t_max),
        ("nodes", nodes, (nodes.shape[0], 128), torch.int32))
    if o.device.type == "cpu":
        kernels.TWIN_CALLS["select"] += 1
        return select_clusters_plain(o, d, t_max, nodes)
    # At most traverse.MAX_STACK_ENTRIES (else it raises): 48 KB a block.
    entries = traverse.stack_entries(nodes)
    n = o.shape[0]
    slot_t = torch.empty((n, KSEL), dtype=torch.float32, device=o.device)
    slot_c = torch.empty((n, KSEL), dtype=torch.int32, device=o.device)
    dropped = torch.empty(n, dtype=torch.float32, device=o.device)
    next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
    kernels.launch(build_kernels(), "tb_select_clusters", o.device, o, d,
                   t_max, nodes, n, entries, slot_t, slot_c, dropped,
                   next_ray)
    kernels.LAUNCHES["select"] += 1
    return slot_t, slot_c, dropped


def n_clusters(nodes) -> int:
    """Clusters a coarse node table references (largest leaf id + 1)."""
    cid = nodes[:, 48:56]
    leaf = (cid < 0) & (cid != INVALID)
    return int((-cid[leaf] - 1).max()) + 1 if bool(leaf.any()) else 0


def cluster_entries(o, d, t_max, lo, hi):
    """(N, C) entry t of every ray into every cluster box (lo, hi, (C,
    3)): max(t_near, 0) where the ray enters the box within t_max, else
    1e30."""
    inv = 1.0 / traverse.fix_dir(d)
    t_near, t_far = traverse.box_entry(o[:, None], inv[:, None], lo[None],
                                       hi[None])
    entry = torch.clamp_min(t_near, 0.0)
    hit = (t_far >= entry) & (entry < t_max[:, None])
    return torch.where(hit, entry, BIG)


def select_clusters_plain(o, d, t_max, nodes):
    """Plain PyTorch twin of select_clusters: every (ray, cluster) box
    test, then the KSEL + 1 nearest; dropped is the (KSEL+1)-th entry t.
    The slots come out nearest first."""
    dev = o.device
    n = o.shape[0]
    n_cl = n_clusters(nodes)
    lo, hi = traverse.cluster_boxes(nodes, n_cl)
    slot_t = torch.full((n, KSEL), BIG, dtype=torch.float32, device=dev)
    slot_c = torch.full((n, KSEL), -1, dtype=torch.int32, device=dev)
    dropped = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    live = (t_max > 0).nonzero(as_tuple=True)[0]
    step = max(1, traverse.PAIR_BUDGET // max(n_cl, 1))
    for s in range(0, live.shape[0] if n_cl else 0, step):
        ids = live[s:s + step]
        entry = cluster_entries(o[ids], d[ids], t_max[ids], lo, hi)
        if n_cl < KSEL + 1:
            entry = torch.cat([entry, torch.full(
                (ids.shape[0], KSEL + 1 - n_cl), BIG, device=dev)], dim=1)
        vals, idx = torch.topk(entry, KSEL + 1, dim=1, largest=False,
                               sorted=True)
        slot_t[ids] = vals[:, :KSEL]
        slot_c[ids] = torch.where(vals[:, :KSEL] < BIG, idx[:, :KSEL],
                                  -1).to(torch.int32)
        dropped[ids] = vals[:, KSEL]
    return slot_t, slot_c, dropped


def dense_pairs(o, d, cap, cluster, mot, base):
    """Each pair's nearest accepted triangle of its cluster within
    (1e-5, cap): pairs (M,) of rays o, d (M, 3), cap (M,) and cluster
    (M,) int32, best sorted by cluster. Returns (t f32, 1e30 on a miss;
    packed tri id int32, -1; u, v f32, 0)."""
    m = o.shape[0]
    n_cl = mot.shape[0]
    kernels.check_inputs(
        o, *kernels.ray_specs(o, d, cap),
        ("cluster", cluster, (m,), torch.int32),
        ("mot", mot, (n_cl, 3 * CLUSTER, 4), torch.float32),
        ("base", base, (n_cl + 1,), torch.int32))
    if o.device.type == "cpu":
        kernels.TWIN_CALLS["dense"] += 1
        return dense_pairs_plain(o, d, cap, cluster, mot, base)
    outs = (torch.empty(m, dtype=torch.float32, device=o.device),
            torch.empty(m, dtype=torch.int32, device=o.device),
            torch.empty(m, dtype=torch.float32, device=o.device),
            torch.empty(m, dtype=torch.float32, device=o.device))
    kernels.launch(build_kernels(), "tb_dense_pairs", o.device, o, d, cap,
                   cluster, mot, base, m, *outs, overflow=False)
    kernels.LAUNCHES["dense"] += 1
    return outs


def dense_pairs_plain(o, d, cap, cluster, mot, base, chunk: int = 1 << 14):
    """Plain PyTorch twin of dense_pairs: the same 4-term dot products,
    written out in the kernel's order (no matmul, so no TF32)."""
    dev = o.device
    m = o.shape[0]
    t_out = torch.full((m,), BIG, dtype=torch.float32, device=dev)
    tri_out = torch.full((m,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros(m, dtype=torch.float32, device=dev)
    v_out = torch.zeros(m, dtype=torch.float32, device=dev)
    rows = torch.arange(CLUSTER, device=dev)
    for s in range(0, m, chunk):
        cl = cluster[s:s + chunk].to(torch.int64)
        tab = mot[cl]                                   # (P, 384, 4)
        a, g, h = (tab[:, k * CLUSTER:(k + 1) * CLUSTER] for k in range(3))
        ox, oy, oz = (o[s:s + chunk, k:k + 1] for k in range(3))
        dx, dy, dz = (d[s:s + chunk, k:k + 1] for k in range(3))
        A = a[..., 0] * ox + a[..., 1] * oy + a[..., 2] * oz + a[..., 3]
        B = a[..., 0] * dx + a[..., 1] * dy + a[..., 2] * dz
        t = -A / torch.where(torch.abs(B) < 1e-12, 1e-12, B)
        u = ((g[..., 0] * ox + g[..., 1] * oy + g[..., 2] * oz + g[..., 3])
             + t * (g[..., 0] * dx + g[..., 1] * dy + g[..., 2] * dz))
        v = ((h[..., 0] * ox + h[..., 1] * oy + h[..., 2] * oz + h[..., 3])
             + t * (h[..., 0] * dx + h[..., 1] * dy + h[..., 2] * dz))
        ok = ((t > 1e-5) & (u >= -1e-5) & (v >= -1e-5)
              & (u + v <= 1.0 + 1e-5) & (torch.abs(B) >= 1e-12)
              & (t < cap[s:s + chunk, None]))
        tm = torch.where(ok, t, BIG)
        tmin = tm.min(dim=1, keepdim=True).values
        rmin = torch.where(tm <= tmin, rows, CLUSTER).min(dim=1,
                                                          keepdim=True).values
        hit = ok.any(dim=1)
        t_out[s:s + chunk] = tmin[:, 0]
        tri_out[s:s + chunk] = torch.where(
            hit, base[cl] + rmin[:, 0], -1).to(torch.int32)
        u_out[s:s + chunk] = torch.where(hit, u.gather(1, rmin)[:, 0], 0.0)
        v_out[s:s + chunk] = torch.where(hit, v.gather(1, rmin)[:, 0], 0.0)
    return t_out, tri_out, u_out, v_out


# ---------------------------------------------------------------------------
# Orchestrator


def binned_closest(scene, o, d, t_max, plain: bool = False):
    """Closest hit over the binned backend: the contract of
    traverse.closest_hit, (t, packed tri id, u, v), on scene tensors
    bn_nodes, bn_mot, bn_base and (for the fallback) pk_nodes,
    pk_tris_bw."""
    select = select_clusters_plain if plain else select_clusters
    dense = dense_pairs_plain if plain else dense_pairs
    closest = traverse.closest_hit_plain if plain else traverse.closest_hit
    mot, base = scene["bn_mot"], scene["bn_base"]
    dev = o.device
    N = o.shape[0]

    _, slot_c, dropped = select(o, d, t_max, scene["bn_nodes"])

    tb = torch.full((N,), BIG, dtype=torch.float32, device=dev)
    ib = torch.full((N,), -1, dtype=torch.int32, device=dev)
    ub = torch.zeros(N, dtype=torch.float32, device=dev)
    vb = torch.zeros(N, dtype=torch.float32, device=dev)
    for c0 in range(0, KSEL, KCHUNK):
        chunk = slot_c[:, c0:c0 + KCHUNK]
        KC = chunk.shape[1]
        pos, cl = kernels.bin_pairs(chunk)
        ray = torch.div(pos, KC, rounding_mode="floor")
        t_c, i_c, u_c, v_c = kernels.nearest_of(
            pos, N, KC, dense(o[ray], d[ray], t_max[ray], cl, mot, base))
        better = t_c < tb
        tb = torch.where(better, t_c, tb)
        ib = torch.where(better, i_c, ib)
        ub = torch.where(better, u_c, ub)
        vb = torch.where(better, v_c, vb)
    ib = torch.where(tb < BIG, ib, -1)

    unresolved = (tb > dropped) & (t_max > 0.0)
    STATS["rays"] = STATS["rays"] + (t_max > 0.0).sum()
    STATS["fallback_rays"] = STATS["fallback_rays"] + unresolved.sum()
    fb_tmax = torch.where(unresolved, torch.minimum(t_max, tb), 0.0)
    t2, tri2, u2, v2 = closest(o, d, fb_tmax, scene["pk_nodes"],
                               scene["pk_tris_bw"])
    closer = (tri2 >= 0) & (t2 < tb)
    tb = torch.where(closer, t2, tb)
    ib = torch.where(closer, tri2, ib)
    ub = torch.where(closer, u2, ub)
    vb = torch.where(closer, v2, vb)

    return torch.where(ib >= 0, tb, BIG), ib, ub, vb
