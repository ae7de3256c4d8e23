"""Packed BVH tables for the traversal kernels (trace/traverse.py).

A numpy copy of the JAX package's packing (pack_scene_for_pallas and
pack_bvh in tracerboy_tpu/trace/pallas_traverse.py, _bw_rows in
tracerboy_tpu/trace/binned.py), so both packages traverse the same
tables:

- nodes (W, 128) int32: one row per 8-wide node. Lanes 0-47 hold the
  child bounds as f32 bits, [lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 |
  hiz*8]; lanes 48-55 the child ids (INVALID = empty, negative = leaf
  cluster -id-1). Empty slots get inverted boxes.
- tris_bw (C, 128) float32: one row per 8-triangle cluster, 12
  Baldwin-Weber floats per triangle ([n|-d], [g1|h1], [g2|h2]).
- tri_map (C*8,) int32: packed triangle id -> input triangle index.
- tris (C, 128) float32, only when asked for (raw_rows=True): the raw
  rows of pack_scene_for_pallas's "tris", 8 triangles of 9 floats
  (v0, v1, v2), from which the binned backend packs its tables
  (trace/binned.py::pack_scene_binned).
"""

from __future__ import annotations

import numpy as np

from tracerboy_tpu_torch.accel.bvh import INVALID, WideBVH

LEAF = 8          # triangles per cluster row
BIG = 1e30


def pack_scene(tri_v0, tri_v1, tri_v2, raw_rows: bool = False):
    """Build and pack the leaf-8 BVH over scene-order triangles.
    Returns (dict(nodes, tris_bw, tri_map[, tris]), WideBVH)."""
    from tracerboy_tpu_torch.accel.native import build_bvh_native

    v0 = np.asarray(tri_v0, np.float32)
    v1 = np.asarray(tri_v1, np.float32)
    v2 = np.asarray(tri_v2, np.float32)
    bvh = build_bvh_native(v0, v1, v2, leaf_size=LEAF)
    return pack_bvh(bvh, v0, v1, v2, raw_rows=raw_rows), bvh


def pack_bvh(bvh: WideBVH, tri_v0, tri_v1, tri_v2,
             raw_rows: bool = False) -> dict:
    """Pack a WideBVH (leaf_size == 8) + original-order triangles."""
    if bvh.leaf_size != LEAF:
        raise ValueError(f"packing needs leaf_size {LEAF}, "
                         f"got {bvh.leaf_size}")
    W = bvh.num_nodes
    ch = np.asarray(bvh.children).astype(np.int32)
    valid = ch != INVALID
    lo = np.where(valid[..., None], bvh.bounds_lo, np.float32(BIG))
    hi = np.where(valid[..., None], bvh.bounds_hi, np.float32(-BIG))

    rows = np.zeros((W, 128), np.int32)
    bounds = np.concatenate([lo, hi], axis=2)  # (W, 8, 6)
    rows[:, :48] = (
        bounds.transpose(0, 2, 1).reshape(W, 48).astype(np.float32)
        .view(np.int32)
    )
    rows[:, 48:56] = ch

    order = np.asarray(bvh.tri_order)
    C = bvh.num_clusters
    w0 = np.asarray(tri_v0)[order]
    w1 = np.asarray(tri_v1)[order]
    w2 = np.asarray(tri_v2)[order]
    bw = bw_rows(w0.astype(np.float64), w1.astype(np.float64),
                 w2.astype(np.float64))                 # (C*LEAF, 3, 4)
    bw_table = np.zeros((C, 128), np.float32)
    bw_table[:, : LEAF * 12] = bw.reshape(C, LEAF * 12)
    out = dict(nodes=rows, tris_bw=bw_table, tri_map=order.astype(np.int32))
    if raw_rows:
        tri = np.concatenate([w0, w1, w2], axis=1).astype(np.float32)
        out["tris"] = np.zeros((C, 128), np.float32)
        out["tris"][:, : LEAF * 9] = tri.reshape(C, LEAF * 9)
    return out


def bw_rows(v0, v1, v2):
    """Baldwin-Weber rows for (T, 3) triangle vertices.

    Returns (T, 3, 4): [n | -d], [g1 | h1], [g2 | h2] with
    n = e1 x e2, d = n.v0, g1 = (e2 x n)/n.n, g2 = (n x e1)/n.n, so that
    t = -(n.o - d)/(n.dir), u = g1.P + h1, v = g2.P + h2 at P = o + t d.
    Degenerate triangles (n ~ 0) get all-zero rows, which no ray hits.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    nn = (n * n).sum(axis=1)
    good = nn > 1e-24
    inv = np.where(good, 1.0 / np.maximum(nn, 1e-24), 0.0)[:, None]
    g1 = np.cross(e2, n) * inv
    g2 = np.cross(n, e1) * inv
    d = (n * v0).sum(axis=1)
    h1 = -(g1 * v0).sum(axis=1)
    h2 = -(g2 * v0).sum(axis=1)
    n = np.where(good[:, None], n, 0.0)
    d = np.where(good, d, 0.0)
    return np.stack(
        [
            np.concatenate([n, -d[:, None]], axis=1),
            np.concatenate([g1, h1[:, None]], axis=1),
            np.concatenate([g2, h2[:, None]], axis=1),
        ],
        axis=1,
    ).astype(np.float32)
