"""Binned-subtree ("cut") traversal (tracerboy_tpu/trace/cut.py).

The whole tree is cut into subtrees of at most cut_tris triangles. A wave
then runs in two phases:
  1. emit_cuts: a walk over the TOP of the tree (build_cut's patched node
     table, where every child at or under the cut is an emit id) collects
     up to K subtree ids per ray; a ray with more than K holds the
     whole-tree root in its last slot (correct, only slower for it).
  2. The (ray, subtree) pairs, sorted by subtree, go through the
     traversal kernels with per-ray roots (trace/traverse.py), and each
     ray takes the nearest of its pairs' hits (closest hit) or their OR
     (any hit).

The JAX package pads each subtree's run of pairs to whole 2048-ray
packets, carries the ray data through a payload sort and starts each
packet at its root. A packet is TPU scheduling: here every pair carries
its own root, and the sort by subtree only keeps warps coherent.

emit_cuts launches the CUDA kernel (csrc/cut_emit.cu) on CUDA tensors and
takes its plain twin emit_cuts_plain on CPU tensors; traverse_binned2 and
anyhit_binned2 take the twins throughout with plain=True. STATS counts
live rays and emit overflows on the path (device tensors, read with
int()).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tracerboy_tpu_torch.accel.bvh import INVALID
from tracerboy_tpu_torch.trace import kernels, traverse

_SOURCE = kernels.CSRC / "cut_emit.cu"
kernels.register("emit")
_lib = None
STATS: dict = {"rays": 0, "overflow_rays": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


# ----------------------------------------------------------------------------
# Host side: the cut tables (a numpy copy of the JAX package's)


def subtree_tri_counts(children: np.ndarray, leaf_size: int) -> np.ndarray:
    """(W,) padded-triangle count under each node (leaves count as
    leaf_size; padding slack is irrelevant for cut selection)."""
    W = children.shape[0]
    count = np.zeros((W,), np.int64)
    order: list[int] = []
    stack = [0]
    seen = np.zeros((W,), bool)
    seen[0] = True
    while stack:
        n = stack.pop()
        order.append(n)
        for c in children[n]:
            if 0 <= c < INVALID and not seen[c]:
                seen[c] = True
                stack.append(int(c))
    for n in reversed(order):
        t = 0
        for c in children[n]:
            if c == INVALID:
                continue
            t += leaf_size if c < 0 else int(count[c])
        count[n] = t
    return count


def build_cut(packed_nodes: np.ndarray, children: np.ndarray,
              leaf_size: int, cut_tris: int = 512):
    """Build the phase-1 top table and the phase-2 roots.

    packed_nodes: (W, 128) i32 rows from pack_bvh; children: (W, 8) i32
    WideBVH child encoding. Returns dict(top_nodes (W, 128) i32, a copy
    of packed_nodes with each child slot whose subtree holds at most
    cut_tris triangles replaced by -(cut index)-1; roots (S+1,) i32, cut
    index -> original child encoding (node id >= 0 or leaf
    -cluster-1), entry S being the whole-tree root 0 (the overflow
    target); n_cuts = S)."""
    ch = np.asarray(children)
    counts = subtree_tri_counts(ch, leaf_size)
    top = np.array(packed_nodes, copy=True)

    roots: list[int] = []
    # Walk top-down; only nodes that stay ABOVE the cut are visited.
    stack = [0]
    visited = np.zeros(ch.shape[0], bool)
    visited[0] = True
    while stack:
        n = stack.pop()
        for k in range(8):
            c = int(ch[n, k])
            if c == INVALID:
                continue
            size = leaf_size if c < 0 else int(counts[c])
            if c < 0 or size <= cut_tris:
                top[n, 48 + k] = -len(roots) - 1
                roots.append(c)
            elif not visited[c]:
                visited[c] = True
                stack.append(c)
    roots.append(0)  # overflow: degrade to the whole tree
    return dict(
        top_nodes=top.astype(np.int32),
        roots=np.asarray(roots, np.int32),
        n_cuts=len(roots) - 1,
    )


# ----------------------------------------------------------------------------
# Phase 1: emit kernel and twin


def build_kernels():
    """Build (or reuse) and load the emit kernel's library."""
    global _lib
    if _lib is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _lib = kernels.load_library("tbcut", _SOURCE, {
            "tb_emit_cuts": [p, p, p, p, i, i, i, p, p, p]})
    return _lib


def emit_cuts(o, d, t_max, top_nodes, n_cuts: int, K: int = 8):
    """Per-ray cut-subtree lists: (N, K) int32, cut indices in
    [0, n_cuts), n_cuts in slot K-1 of a ray with more than K, -1 in
    unused slots; dead rays (t_max <= 0) emit nothing."""
    kernels.check_inputs(
        o, *kernels.ray_specs(o, d, t_max),
        ("top_nodes", top_nodes, (top_nodes.shape[0], 128), torch.int32))
    if K < 1:
        raise ValueError(f"K must be at least 1, got {K}")
    if o.device.type == "cpu":
        kernels.TWIN_CALLS["emit"] += 1
        return emit_cuts_plain(o, d, t_max, top_nodes, n_cuts, K)
    n = o.shape[0]
    ids = torch.empty((n, K), dtype=torch.int32, device=o.device)
    kernels.launch(build_kernels(), "tb_emit_cuts", o.device, o, d, t_max,
                   top_nodes, n, K, int(n_cuts), ids)
    kernels.LAUNCHES["emit"] += 1
    return ids


def _pop_ranks(top_nodes):
    """Rank of every node in the emit kernel's pop order over the whole
    top tree (children pushed in slot order, the last pushed popped
    first), as a host array; unreached rows keep rank 0."""
    ch = top_nodes[:, 48:56].cpu().numpy()
    rank = np.zeros(ch.shape[0], np.int64)
    stack, r = [0], 0
    while stack:
        n = stack.pop()
        rank[n] = r
        r += 1
        stack.extend(int(c) for c in ch[n] if 0 <= c < INVALID)
    return rank


def emit_cuts_plain(o, d, t_max, top_nodes, n_cuts: int, K: int = 8,
                    ray_chunk: int = 1 << 16):
    """Plain PyTorch twin of emit_cuts: a breadth-first walk of (ray,
    node) pairs with the kernel's slab test, each ray's emits ordered as
    the kernel appends them (by its node's pop rank, then by slot)."""
    dev = o.device
    N = o.shape[0]
    ids = torch.full((N, K), -1, dtype=torch.int32, device=dev)
    W = top_nodes.shape[0]
    cid = top_nodes[:, 48:56].to(torch.int64)
    b = top_nodes[:, :48].contiguous().view(torch.float32).reshape(W, 6, 8)
    lo = b[:, 0:3, :].permute(0, 2, 1)                       # (W, 8, 3)
    hi = b[:, 3:6, :].permute(0, 2, 1)
    rank = torch.from_numpy(_pop_ranks(top_nodes)).to(dev)
    live = (t_max > 0).nonzero(as_tuple=True)[0]
    for s in range(0, live.shape[0], ray_chunk):
        rays = live[s:s + ray_chunk]
        o_c, t_c = o[rays], t_max[rays]
        inv = 1.0 / traverse.fix_dir(d[rays])
        fr = torch.arange(rays.shape[0], device=dev)   # frontier: ray, node
        fn = torch.zeros_like(fr)
        rec_ray, rec_key, rec_id = [], [], []
        while fr.numel():
            t_near, t_far = traverse.box_entry(
                o_c[fr][:, None], inv[fr][:, None], lo[fn], hi[fn])
            c = cid[fn]
            hit = ((c != INVALID) & (t_far >= torch.clamp_min(t_near, 0.0))
                   & (t_near < t_c[fr][:, None]))
            em = hit & (c < 0)
            ri, si = em.nonzero(as_tuple=True)
            rec_ray.append(fr[ri])
            rec_key.append(rank[fn[ri]] * 8 + si)
            rec_id.append(-c[ri, si] - 1)
            ri, si = (hit & (c >= 0)).nonzero(as_tuple=True)
            fr, fn = fr[ri], c[ri, si]
        rr, key, eid = (torch.cat(x) for x in (rec_ray, rec_key, rec_id))
        if rr.numel() == 0:
            continue
        order = torch.argsort(rr * (8 * W) + key)
        rr, eid = rr[order], eid[order]
        cnt = torch.bincount(rr, minlength=rays.shape[0])
        first = torch.cumsum(cnt, 0) - cnt
        pos = torch.arange(rr.shape[0], device=dev) - first[rr]
        out = ids[rays]
        lead = pos < K - 1
        out[rr[lead], pos[lead]] = eid[lead].to(torch.int32)
        last = pos == K - 1
        out[rr[last], K - 1] = torch.where(
            cnt[rr[last]] == K, eid[last], n_cuts).to(torch.int32)
        ids[rays] = out
    return ids


# ----------------------------------------------------------------------------
# Phase 2 and the per-ray combine


def _phase2_inputs(o, d, t_max, cut_top, cut_roots, K, plain):
    S = cut_roots.shape[0] - 1
    emit = emit_cuts_plain if plain else emit_cuts
    ids = emit(o, d, t_max, cut_top, S, K)
    STATS["rays"] = STATS["rays"] + (t_max > 0).sum()
    STATS["overflow_rays"] = (STATS["overflow_rays"]
                              + (ids[:, K - 1] == S).sum())
    pos, key = kernels.bin_pairs(ids)
    ray = torch.div(pos, K, rounding_mode="floor")
    return pos, (o[ray], d[ray], t_max[ray]), cut_roots[key.to(torch.int64)]


def traverse_binned2(o, d, t_max, nodes, tris_bw, cut_top, cut_roots,
                     K: int = 8, plain: bool = False):
    """Closest hit through the cut pipeline; the contract of
    traverse.closest_hit: (t, packed tri id, u, v). Of a ray's pairs the
    nearest wins, the lowest slot at a tie (the JAX package's argmin)."""
    pos, rays, roots = _phase2_inputs(o, d, t_max, cut_top, cut_roots, K,
                                      plain)
    closest = traverse.closest_hit_plain if plain else traverse.closest_hit
    return kernels.nearest_of(pos, o.shape[0], K,
                              closest(*rays, nodes, tris_bw, roots))


def anyhit_binned2(o, d, t_max, nodes, tris_bw, cut_top, cut_roots,
                   K: int = 8, plain: bool = False):
    """Occlusion through the cut pipeline: (N,) bool."""
    N = o.shape[0]
    pos, rays, roots = _phase2_inputs(o, d, t_max, cut_top, cut_roots, K,
                                      plain)
    anyhit = traverse.anyhit_plain if plain else traverse.any_hit
    occ = torch.zeros(N * K, dtype=torch.bool, device=o.device)
    occ[pos] = anyhit(*rays, nodes, tris_bw, roots)
    return occ.reshape(N, K).any(dim=1)
