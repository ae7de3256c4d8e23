"""The 8-wide BVH record shared by the builder and the packer.

Child encoding (the same as tracerboy_tpu/accel/bvh.py):
  child >= 0           : index of another wide node
  child == INVALID     : empty slot
  child <  0 (not INV) : leaf cluster -child-1, i.e. triangles
                         [cluster*leaf_size, (cluster+1)*leaf_size)
                         of tri_order.

The scene's packed BVHs come from the native SAH builder
(accel/native.py). build_bvh below is a jax-free numpy copy of the JAX
package's vectorized LBVH (morton codes, Karras 2012 radix tree, bottom-up
AABB fit, collapse to 8-wide nodes); the binned backend builds its coarse
tree over cluster boxes with it (trace/binned.py::pack_scene_binned).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INVALID = np.int32(2**31 - 1)
WIDE_FACTOR = 8


@dataclass
class WideBVH:
    """8-wide SoA BVH over triangle clusters."""

    bounds_lo: np.ndarray      # (W, 8, 3) child AABB min
    bounds_hi: np.ndarray      # (W, 8, 3) child AABB max
    children: np.ndarray       # (W, 8) int32, see encoding above
    tri_order: np.ndarray      # (C*K,) map: new index -> original tri id
    leaf_size: int
    num_tris: int              # real (unpadded) triangle count
    world_lo: np.ndarray       # (3,) scene bounds
    world_hi: np.ndarray
    num_clusters: int = 0      # leaf clusters (tri_order length / leaf_size)

    @property
    def num_nodes(self) -> int:
        return self.children.shape[0]


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10-bit x/y/z into 30-bit morton codes (uint32).

    Same quantization role as the reference's CalculateMortonCodes kernels
    (MortonCodesCalculator.cpp:36-60).
    """

    def expand_bits(v):
        v = v.astype(np.uint64)
        v = (v * 0x00010001) & 0xFF0000FF
        v = (v * 0x00000101) & 0x0F00F00F
        v = (v * 0x00000011) & 0xC30C30C3
        v = (v * 0x00000005) & 0x49249249
        return v

    return (
        (expand_bits(x) << 2) | (expand_bits(y) << 1) | expand_bits(z)
    ).astype(np.uint64)


def _common_prefix(codes: np.ndarray, i: np.ndarray, j: np.ndarray, n: int):
    """Length of the common bit prefix of augmented codes at i and j.

    Codes are augmented with the index in the low bits (codes are shifted
    up) so equal morton codes still have distinct keys — the standard
    Karras tie-break. Out-of-range j yields -1.
    """
    valid = (j >= 0) & (j < n)
    jj = np.clip(j, 0, n - 1)
    x = codes[i] ^ codes[jj]
    # count leading zeros of 64-bit ints
    lz = 64 - _bit_length(x)
    return np.where(valid, lz, -1)


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Vectorized bit_length for uint64."""
    x = x.astype(np.uint64)
    out = np.zeros(x.shape, np.int64)
    cur = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = cur >= (np.uint64(1) << np.uint64(shift))
        out = np.where(mask, out + shift, out)
        cur = np.where(mask, cur >> np.uint64(shift), cur)
    return out + (cur > 0)


def build_karras_topology(codes_sorted: np.ndarray):
    """Binary radix-tree topology from sorted (augmented) morton codes.

    Vectorized Karras 2012: every internal node's range direction, extent
    and split are found with binary searches run simultaneously for all
    nodes (the per-thread algorithm of the reference's
    BuildBVHSplits.hlsli:11-141, lifted to array form).

    Returns (left, right, leaf_mask_left, leaf_mask_right) with n-1
    internal nodes; child index < n-1 means internal node, otherwise
    (child - (n-1)) is a leaf id.
    """
    n = codes_sorted.shape[0]
    if n == 1:
        return (
            np.full((0,), 0, np.int64),
            np.full((0,), 0, np.int64),
        )
    i = np.arange(n - 1)

    d = np.sign(
        _common_prefix(codes_sorted, i, i + 1, n)
        - _common_prefix(codes_sorted, i, i - 1, n)
    ).astype(np.int64)
    d = np.where(d == 0, 1, d)

    # Upper bound on range length, then binary search the exact end.
    delta_min = _common_prefix(codes_sorted, i, i - d, n)
    lmax = np.full(n - 1, 2, np.int64)
    while True:
        probe = _common_prefix(codes_sorted, i, i + lmax * d, n)
        grow = probe > delta_min
        if not grow.any():
            break
        lmax = np.where(grow, lmax * 2, lmax)

    l = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while t.max() >= 1:
        probe = _common_prefix(codes_sorted, i, i + (l + t) * d, n)
        l = np.where(probe > delta_min, l + t, l)
        t = t // 2
    j = i + l * d  # other end of the range

    # Binary search the split position (highest differing bit within range).
    delta_node = _common_prefix(codes_sorted, i, j, n)
    s = np.zeros(n - 1, np.int64)
    t = (l + 1) // 2
    while True:
        probe = _common_prefix(codes_sorted, i, i + (s + t) * d, n)
        s = np.where(probe > delta_node, s + t, s)
        if (t <= 1).all():
            break
        t = (t + 1) // 2
    gamma = i + s * d + np.minimum(d, 0)

    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    # left child covers [lo, gamma], right covers [gamma+1, hi]
    left = np.where(lo == gamma, gamma + (n - 1), gamma)
    right = np.where(hi == gamma + 1, gamma + 1 + (n - 1), gamma + 1)
    return left, right


def fit_aabbs_bottom_up(left, right, leaf_lo, leaf_hi):
    """Bottom-up AABB fit over the binary topology (ConstructAABBPass
    analog), done as vectorized sweeps until all nodes are resolved."""
    n_int = left.shape[0]
    n_leaf = leaf_lo.shape[0]
    node_lo = np.full((n_int, 3), np.inf, np.float32)
    node_hi = np.full((n_int, 3), -np.inf, np.float32)
    done = np.zeros(n_int, bool)

    def child_box(c):
        is_leaf = c >= n_int
        li = np.clip(np.where(is_leaf, c - n_int, 0), 0, max(n_leaf - 1, 0))
        ii = np.clip(np.where(is_leaf, 0, c), 0, max(n_int - 1, 0))
        lo = np.where(is_leaf[:, None], leaf_lo[li], node_lo[ii])
        hi = np.where(is_leaf[:, None], leaf_hi[li], node_hi[ii])
        ready = np.where(is_leaf, True, done[ii])
        return lo, hi, ready

    for _ in range(64):  # max depth of a 2^30-key radix tree is bounded
        llo, lhi, lready = child_box(left)
        rlo, rhi, rready = child_box(right)
        can = lready & rready & ~done
        if not can.any():
            break
        node_lo[can] = np.minimum(llo[can], rlo[can])
        node_hi[can] = np.maximum(lhi[can], rhi[can])
        done |= can
    assert done.all(), "BVH AABB fit did not converge"
    return node_lo, node_hi


def collapse_to_wide(left, right, node_lo, node_hi, leaf_lo, leaf_hi):
    """Collapse the binary tree into 8-wide nodes via a depth-3 cut.

    Every wide node's children are the binary tree's descendants exactly 3
    levels down (leaves surface early). Fully vectorized level-order
    construction: each level's wide roots expand simultaneously.
    """
    n_int = left.shape[0]
    n_leaf = leaf_lo.shape[0]
    if n_int == 0:
        # Single-leaf scene: one wide node whose first child is leaf 0.
        children = np.full((1, WIDE_FACTOR), INVALID, np.int32)
        children[0, 0] = -1  # ~0 = leaf cluster 0
        b_lo = np.full((1, WIDE_FACTOR, 3), np.inf, np.float32)
        b_hi = np.full((1, WIDE_FACTOR, 3), -np.inf, np.float32)
        b_lo[0, 0] = leaf_lo[0]
        b_hi[0, 0] = leaf_hi[0]
        return b_lo, b_hi, children

    SENTINEL = np.int64(-1)

    def expand(nodes):
        """One binary step: (k, m) node ids -> (k, 2m)."""
        k, m = nodes.shape
        is_inner = (nodes >= 0) & (nodes < n_int)
        idx = np.clip(np.where(is_inner, nodes, 0), 0, n_int - 1)
        l = np.where(is_inner, left[idx], nodes)
        r = np.where(is_inner, right[idx], SENTINEL)
        out = np.empty((k, 2 * m), np.int64)
        out[:, 0::2] = l
        out[:, 1::2] = r
        return out

    all_children = []
    # First pass: discover all wide roots level by level.
    frontier = np.array([0], np.int64)
    wide_ids = {0: 0}  # binary node id -> wide node id
    order = [0]
    while frontier.size:
        slots = expand(expand(expand(frontier[:, None])))  # (k, 8)
        inner_mask = (slots >= 0) & (slots < n_int)
        new_roots = slots[inner_mask]
        fresh = []
        for nid in new_roots.tolist():
            if nid not in wide_ids:
                wide_ids[nid] = len(order)
                order.append(nid)
                fresh.append(nid)
        all_children.append((frontier, slots, inner_mask))
        frontier = np.array(fresh, np.int64)

    W = len(order)
    children = np.full((W, WIDE_FACTOR), INVALID, np.int32)
    b_lo = np.full((W, WIDE_FACTOR, 3), np.inf, np.float32)
    b_hi = np.full((W, WIDE_FACTOR, 3), -np.inf, np.float32)

    remap = np.full(n_int, -1, np.int64)
    for nid, wid in wide_ids.items():
        remap[nid] = wid

    for frontier_nodes, slots, inner_mask in all_children:
        wids = remap[frontier_nodes]  # (k,)
        k = slots.shape[0]
        is_leaf = slots >= n_int
        is_valid = slots >= 0
        leaf_idx = np.clip(np.where(is_leaf, slots - n_int, 0), 0, n_leaf - 1)
        inner_idx = np.clip(np.where(inner_mask, slots, 0), 0, n_int - 1)
        slot_children = np.where(
            is_leaf,
            -(leaf_idx + 1),  # ~cluster == -(cluster+1)
            np.where(inner_mask, remap[inner_idx], np.int64(INVALID)),
        )
        slot_children = np.where(is_valid, slot_children, np.int64(INVALID))
        children[wids] = slot_children.astype(np.int32)
        lo = np.where(
            is_leaf[..., None],
            leaf_lo[leaf_idx],
            np.where(inner_mask[..., None], node_lo[inner_idx], np.inf),
        )
        hi = np.where(
            is_leaf[..., None],
            leaf_hi[leaf_idx],
            np.where(inner_mask[..., None], node_hi[inner_idx], -np.inf),
        )
        lo = np.where(is_valid[..., None], lo, np.inf)
        hi = np.where(is_valid[..., None], hi, -np.inf)
        b_lo[wids] = lo.astype(np.float32)
        b_hi[wids] = hi.astype(np.float32)

    return b_lo, b_hi, children


def build_bvh(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = 4
) -> WideBVH:
    """Build an 8-wide BVH over triangles given as three (T, 3) vertex arrays.

    Returns a WideBVH whose tri_order permutation must be applied to all
    per-triangle scene arrays (the analog of the reference's
    RearrangeElementsPass scattering sorted triangles).
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    assert T > 0, "empty scene"

    centroid = (v0 + v1 + v2) / 3.0
    scene_lo = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    scene_hi = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
    extent = np.maximum(scene_hi - scene_lo, 1e-12)

    q = np.clip(((centroid - scene_lo) / extent) * 1023.0, 0, 1023).astype(
        np.uint32
    )
    codes = morton3d(q[:, 0], q[:, 1], q[:, 2])
    tri_order = np.argsort(codes, kind="stable").astype(np.int64)

    # Cluster consecutive sorted triangles into leaves of `leaf_size`.
    n_clusters = (T + leaf_size - 1) // leaf_size
    pad = n_clusters * leaf_size - T
    order_padded = np.concatenate([tri_order, np.repeat(tri_order[-1:], pad)])
    cl = order_padded.reshape(n_clusters, leaf_size)

    w0, w1, w2 = v0[cl], v1[cl], v2[cl]  # (C, K, 3)
    leaf_lo = np.minimum(np.minimum(w0, w1), w2).min(axis=1)
    leaf_hi = np.maximum(np.maximum(w0, w1), w2).max(axis=1)

    # Build the radix tree over *clusters* keyed by their first tri's code,
    # augmented with the cluster index to break ties.
    cl_codes = codes[cl[:, 0]].astype(np.uint64)
    aug = (cl_codes << np.uint64(32)) | np.arange(n_clusters, dtype=np.uint64)

    if n_clusters == 1:
        b_lo, b_hi, children = collapse_to_wide(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            leaf_lo, leaf_hi,
        )
    else:
        left, right = build_karras_topology(aug)
        node_lo, node_hi = fit_aabbs_bottom_up(left, right, leaf_lo, leaf_hi)
        b_lo, b_hi, children = collapse_to_wide(
            left, right, node_lo, node_hi, leaf_lo, leaf_hi
        )

    return WideBVH(
        bounds_lo=b_lo,
        bounds_hi=b_hi,
        children=children,
        tri_order=order_padded,
        leaf_size=leaf_size,
        num_tris=T,
        world_lo=scene_lo,
        world_hi=scene_hi,
        num_clusters=n_clusters,
    )
