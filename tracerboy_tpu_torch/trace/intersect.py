"""Ray-primitive intersection (tracerboy_tpu/trace/intersect.py).

- brute_force_closest_soa, brute_force_anyhit_soa: closest hit and any hit
  over every triangle, the backend for small scenes. Moller-Trumbore,
  two-sided, one triangle at a time over the whole wave, so hit ids are
  in scene (BVH) order and fetch from tri_attr_rows.
- ray_triangle, ray_triangle_watertight (with ray_shear) and ray_aabb: the
  row-layout tests over (..., 3) tensors that broadcast rays against
  triangles or boxes; the wide traversal (trace/traverse.py
  traverse_wide) is built from ray_aabb and ray_triangle.
- brute_force_closest, brute_force_anyhit: the (N, T) broadcast oracles of
  the traversal tests, on (N, 3) rays and (T, 3) vertices.
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


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def ray_triangle(orig, direc, v0, v1, v2, t_max=None):
    """Moller-Trumbore, two-sided. orig, direc: (..., 3); v0, v1, v2:
    (..., 3), broadcast against the rays. Returns (t, u, v, hit), t = 1e30
    where missed."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(direc, e2)
    det = _dot(e1, pvec)
    good = torch.abs(det) > TRI_EPS
    inv_det = torch.where(good, 1.0 / det, 0.0)
    tvec = orig - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(direc, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-5)
    if t_max is not None:
        hit = hit & (t < t_max)
    return torch.where(hit, t, BIG), u, v, hit


def ray_shear(direc):
    """Shear constants of the watertight test for ray directions
    (..., 3): the dominant axis kz, kx and ky cycled after it (swapped
    where d[kz] < 0, to keep the winding), and the shear that maps the ray
    to +z. Returns (kx, ky, kz, sx, sy, sz), k* int64, s* float."""
    ax, ay, az = (torch.abs(direc[..., k]) for k in range(3))
    kz = torch.where((az >= ax) & (az >= ay), 2,
                     torch.where(ay >= ax, 1, 0))
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    def take(k):
        return torch.gather(direc, -1, k[..., None])[..., 0]

    dz = take(kz)
    swap = dz < 0.0
    kx, ky = torch.where(swap, ky, kx), torch.where(swap, kx, ky)
    dx, dy = take(kx), take(ky)
    safe = torch.where(dz == 0.0, 1e-30, dz)
    return kx, ky, kz, dx / safe, dy / safe, 1.0 / safe


def ray_triangle_watertight(orig, direc, v0, v1, v2, t_max=None):
    """Watertight Woop/Benthin/Wald test, two-sided: the triangle is
    sheared into ray space and the three 2D edge functions decide, so two
    triangles that share an edge compute that edge's function exactly
    negated and no ray slips between them. Same arguments and results as
    ray_triangle; u weights v1 and v weights v2."""
    kx, ky, kz, sx, sy, sz = ray_shear(direc)

    def shear(p):
        rel = torch.broadcast_tensors(p, orig)[0] - orig
        shape = rel.shape[:-1]
        px, py, pz = (torch.gather(rel, -1, k.expand(shape)[..., None])[..., 0]
                      for k in (kx, ky, kz))
        return px - sx * pz, py - sy * pz, pz

    ax_, ay_, az_ = shear(v0)
    bx_, by_, bz_ = shear(v1)
    cx_, cy_, cz_ = shear(v2)
    u = cx_ * by_ - cy_ * bx_
    v = ax_ * cy_ - ay_ * cx_
    w = bx_ * ay_ - by_ * ax_
    det = u + v + w
    same_sign = (((u >= 0.0) & (v >= 0.0) & (w >= 0.0))
                 | ((u <= 0.0) & (v <= 0.0) & (w <= 0.0)))
    inv_det = torch.where(det != 0.0, 1.0 / det, 0.0)
    t = (u * az_ + v * bz_ + w * cz_) * sz * inv_det
    hit = same_sign & (det != 0.0) & (t > 1e-5)
    if t_max is not None:
        hit = hit & (t < t_max)
    return torch.where(hit, t, BIG), v * inv_det, w * inv_det, hit


def brute_force_closest(orig, direc, v0, v1, v2, t_max=None,
                        watertight=False):
    """Closest hit of each of N rays over all T triangles by an (N, T)
    broadcast: (t, triangle index or -1, u, v). The oracle of the
    traversal tests (watertight: the Woop/Benthin/Wald test)."""
    tri_test = ray_triangle_watertight if watertight else ray_triangle
    t, u, v, _ = tri_test(
        orig[:, None, :], direc[:, None, :], v0[None], v1[None], v2[None],
        t_max=None if t_max is None else t_max[:, None])
    best = torch.argmin(t, dim=1)
    n = torch.arange(t.shape[0], device=t.device)
    t_best = t[n, best]
    return (t_best, torch.where(t_best < BIG, best, -1), u[n, best],
            v[n, best])


def brute_force_anyhit(orig, direc, v0, v1, v2, t_max):
    """Whether each ray hits any triangle before t_max (shadow rays)."""
    hit = ray_triangle(orig[:, None, :], direc[:, None, :], v0[None],
                       v1[None], v2[None], t_max=t_max[:, None])[3]
    return torch.any(hit, dim=1)


def ray_aabb(orig, inv_dir, lo, hi, t_max):
    """Slab test. orig, inv_dir: (..., 3); lo, hi broadcast against them.
    Returns (t_near, hit): entered at t_near >= 0, or the ray starts
    inside."""
    t0 = (lo - orig) * inv_dir
    t1 = (hi - orig) * inv_dir
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_far >= torch.clamp_min(t_near, 0.0)) & (t_near < t_max)
    return t_near, hit
