"""BVH validation: containment + leaf reachability checks.

A numpy copy of tracerboy_tpu/accel/validate.py, over the port's own
WideBVH (accel/bvh.py). The reference's validators are the fallback
layer's CPU checks (D3D12RaytracingFallback/src/BVHValidator.h:14-51:
parent/child AABB containment and leaf equality vs the input primitive
set). Used by the tests and by chip_smoke.py on a tree built on the card
(accel/bvh_device.to_host_widebvh).
"""

from __future__ import annotations

import numpy as np

from tracerboy_tpu_torch.accel.bvh import INVALID, WideBVH


def validate_bvh(bvh: WideBVH, v0, v1, v2, eps: float = 1e-4) -> list:
    """Return a list of violation strings (empty = valid)."""
    errors = []
    W = bvh.num_nodes
    children = bvh.children
    lo, hi = bvh.bounds_lo, bvh.bounds_hi

    # 1. Every child box must contain its subtree's contents.
    # 2. Every cluster must be referenced exactly once.
    seen_clusters = np.zeros(bvh.num_clusters, np.int64)
    seen_nodes = np.zeros(W, np.int64)
    seen_nodes[0] = 1

    tri_lo = np.minimum(np.minimum(v0, v1), v2)[bvh.tri_order]
    tri_hi = np.maximum(np.maximum(v0, v1), v2)[bvh.tri_order]
    K = bvh.leaf_size
    C = bvh.num_clusters
    cl_lo = tri_lo[: C * K].reshape(C, K, 3).min(axis=1)
    cl_hi = tri_hi[: C * K].reshape(C, K, 3).max(axis=1)

    for w in range(W):
        for s in range(children.shape[1]):
            c = children[w, s]
            if c == INVALID:
                continue
            if c < 0:
                cluster = -int(c) - 1
                if cluster >= C:
                    errors.append(f"node {w} slot {s}: cluster {cluster} out of range")
                    continue
                seen_clusters[cluster] += 1
                if (cl_lo[cluster] < lo[w, s] - eps).any() or (
                    cl_hi[cluster] > hi[w, s] + eps
                ).any():
                    errors.append(
                        f"node {w} slot {s}: leaf cluster {cluster} not contained"
                    )
            else:
                if c >= W:
                    errors.append(f"node {w} slot {s}: child {c} out of range")
                    continue
                seen_nodes[c] += 1
                # child's own slots must be inside this slot's box
                valid = children[c] != INVALID
                if valid.any():
                    clo = lo[c][valid].min(axis=0)
                    chi = hi[c][valid].max(axis=0)
                    if (clo < lo[w, s] - eps).any() or (chi > hi[w, s] + eps).any():
                        errors.append(
                            f"node {w} slot {s}: inner child {c} not contained"
                        )

    missing = np.where(seen_clusters == 0)[0]
    if missing.size:
        errors.append(f"unreachable leaf clusters: {missing[:10].tolist()}...")
    dup = np.where(seen_clusters > 1)[0]
    if dup.size:
        errors.append(f"clusters referenced more than once: {dup[:10].tolist()}")
    dup_nodes = np.where(seen_nodes > 1)[0]
    if dup_nodes.size:
        errors.append(f"nodes with multiple parents: {dup_nodes[:10].tolist()}")
    orphan = np.where(seen_nodes == 0)[0]
    if orphan.size:
        errors.append(f"orphan wide nodes: {orphan[:10].tolist()}")
    return errors
