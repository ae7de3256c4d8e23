"""Brute-force closest-hit and any-hit over every triangle: the backend for
small scenes (tracerboy_tpu/trace/intersect.py: brute_force_closest_soa,
brute_force_anyhit_soa).

Moller-Trumbore, two-sided, one triangle at a time over the whole wave,
so hit ids are in scene (BVH) order and fetch from tri_attr_rows.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e30
TRI_EPS = 1e-9


def _triangles(tris):
    """(T, 9) [v0 v1 v2] -> per triangle (v0, e1, e2) as 3-tuples of
    python floats holding float32 values: the edges are rounded to
    float32 as the JAX package's float32 scalar subtraction rounds them,
    and a float32 tensor op with such a scalar computes in float32."""
    v = tris.detach().cpu().numpy().astype(np.float32)
    e1 = v[:, 3:6] - v[:, 0:3]
    e2 = v[:, 6:9] - v[:, 0:3]
    return [tuple(map(tuple, rows.tolist()))
            for rows in np.stack([v[:, 0:3], e1, e2], axis=1)]


def _mt(o, d, tri):
    """Moller-Trumbore of every ray against one triangle.
    Returns (t, u, v, ok)."""
    (v0x, v0y, v0z), (e1x, e1y, e1z), (e2x, e2y, e2z) = tri
    px = d.y * e2z - d.z * e2y
    py = d.z * e2x - d.x * e2z
    pz = d.x * e2y - d.y * e2x
    det = e1x * px + e1y * py + e1z * pz
    good = torch.abs(det) > TRI_EPS
    inv_det = torch.where(good, 1.0 / det, 0.0)
    tvx, tvy, tvz = o.x - v0x, o.y - v0y, o.z - v0z
    uu = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vv = (d.x * qx + d.y * qy + d.z * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = good & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 1e-5)
    return tt, uu, vv, ok


def brute_force_closest_soa(o, d, tris, t_max=None):
    """Closest hit over all triangles. o, d: V3 of (N,); tris: (T, 9).
    Returns (t (N,), tri (N,) int32, u, v); ties keep the lower index."""
    N = o.x.shape[0]
    dev = o.x.device
    t_best = (torch.full((N,), BIG, dtype=torch.float32, device=dev)
              if t_max is None else t_max.to(torch.float32).clone())
    tri = torch.full((N,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(N, dtype=torch.float32, device=dev)
    v_best = torch.zeros(N, dtype=torch.float32, device=dev)
    for i, tr in enumerate(_triangles(tris)):
        tt, uu, vv, ok = _mt(o, d, tr)
        ok = ok & (tt < t_best)
        t_best = torch.where(ok, tt, t_best)
        tri = torch.where(ok, i, tri)
        u_best = torch.where(ok, uu, u_best)
        v_best = torch.where(ok, vv, v_best)
    return torch.where(tri < 0, BIG, t_best), tri, u_best, v_best


def brute_force_anyhit_soa(o, d, tris, t_max, tri_opaque=None):
    """Occlusion over all triangles; tri_opaque (T,) bool leaves out the
    triangles that cast no shadow."""
    occ = torch.zeros(o.x.shape[0], dtype=torch.bool, device=o.x.device)
    keep = (None if tri_opaque is None
            else tri_opaque.detach().cpu().tolist())
    for i, tr in enumerate(_triangles(tris)):
        if keep is not None and not keep[i]:
            continue
        tt, _, _, ok = _mt(o, d, tr)
        occ = occ | (ok & (tt < t_max))
    return occ
