"""Two-level (TLAS/BLAS) instanced traversal
(tracerboy_tpu/trace/instanced.py).

The reference builds one BLAS per instanced object and a TLAS whose
leaves carry per-instance transforms, and moves the ray into object space
at BLAS entry (TracerBoy.cpp:1305-1410, 2031-2116). The JAX package, and
this port of it, treat the TLAS level as a dense problem instead of a
per-ray stack walk:

 1. CULL and SELECT: slab-test every ray against every instance box, in
    chunks of rays, and keep each ray's K_eff = min(KI * ROUNDS, I)
    nearest boxes by entry t (ties to the lower instance index, as
    jax.lax.top_k breaks them: a stable sort here).
 2. BLAS: in ROUNDS rounds of KI candidates, lane k * N + i carries ray i
    against its k-th candidate of the round, moved into the instance's
    object space (the direction stays unnormalised, so the object-space t
    is the world-space t). Each unique object's packed BVH takes one
    closest-hit launch a round (trace/traverse.py, kernel 1), in which the
    lanes of other objects, and the inactive ones, have t_max = 0.
 3. COMBINE: a strictly nearer hit wins, in the order round, object, k.

Triangle ids are offset by each object's base into the combined attribute
rows (the flat scene's pk_attr_rows, then each object's; the scene
compiler builds them). pack_instanced is the JAX package's standalone
table builder, which no path of the scene compiler calls.
"""

from __future__ import annotations

import numpy as np
import torch

from tracerboy_tpu_torch.trace import traverse

BIG = 1e30
KI = 4          # instances tested per round per ray
ROUNDS = 3      # rounds (KI * ROUNDS overlapped instances a ray)
# Rays x instances of one chunk of the cull: each (chunk, I, 3) float32
# temporary of _slab holds 4 * 3 * CULL_ELEMS bytes (400 MB).
CULL_ELEMS = 1 << 25


def pack_instanced(objects, instances, convert_mesh, pack_object):
    """TLAS/BLAS tables from object-space triangle soups.

    objects: name -> (v0, v1, v2, attr_rows) in object space;
    instances: (object name, 4x4 world <- object transform) pairs;
    pack_object: (v0, v1, v2) -> (packed dict with "tri_map", ...);
    convert_mesh is not used (the signature of the JAX package's).
    Returns (tables of CPU tensors inst_obj (I,) int32, inst_inv (I, 12)
    world -> object affine rows, inst_lo / inst_hi (I, 3) world boxes;
    meta with obj_names, obj_packed, obj_base; the packed objects'
    attribute rows concatenated, (R, 19) float32 without objects)."""
    names = sorted({n for n, _ in instances if n in objects})
    obj_packed, obj_base, attr_chunks = {}, {}, []
    base = 0
    for n in names:
        v0, v1, v2, attrs = objects[n]
        pk, _ = pack_object(v0, v1, v2)
        order = np.asarray(pk["tri_map"])
        obj_packed[n] = pk
        obj_base[n] = base
        attr_chunks.append(attrs[np.clip(order, 0, attrs.shape[0] - 1)])
        base += order.shape[0]
    inst_obj, inst_inv, inst_lo, inst_hi = [], [], [], []
    for n, m in instances:
        if n not in obj_packed:
            continue
        v0, v1, v2, _ = objects[n]
        inst_obj.append(names.index(n))
        inst_inv.append(np.linalg.inv(m)[:3, :4].reshape(12).astype(
            np.float32))
        lo = np.minimum(np.minimum(v0, v1), v2).min(0)
        hi = np.maximum(np.maximum(v0, v1), v2).max(0)
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        world = corners @ m[:3, :3].T + m[:3, 3]
        inst_lo.append(world.min(0).astype(np.float32))
        inst_hi.append(world.max(0).astype(np.float32))
    tables = dict(
        inst_obj=torch.from_numpy(np.asarray(inst_obj, np.int32)),
        inst_inv=torch.from_numpy(np.stack(inst_inv)),
        inst_lo=torch.from_numpy(np.stack(inst_lo)),
        inst_hi=torch.from_numpy(np.stack(inst_hi)),
    )
    meta = dict(obj_names=names, obj_packed=obj_packed, obj_base=obj_base)
    return tables, meta, (np.concatenate(attr_chunks) if attr_chunks
                          else np.zeros((0, 19), np.float32))


def _slab(o, d, lo, hi):
    """(N, I) entry t of rays (N, 3) against instance boxes (I, 3); BIG
    where the box is missed (the JAX _slab, expression for expression)."""
    eps = 1e-12
    invd = 1.0 / torch.where(torch.abs(d) < eps,
                             torch.where(d < 0, -eps, eps), d)
    t0 = (lo[None, :, :] - o[:, None, :]) * invd[:, None, :]
    t1 = (hi[None, :, :] - o[:, None, :]) * invd[:, None, :]
    tn = torch.clamp_min(torch.minimum(t0, t1).amax(-1), 0.0)
    tf = torch.maximum(t0, t1).amin(-1)
    return torch.where(tf >= tn, tn, BIG)


def select_candidates(scene, origin, direction, t_max):
    """Each ray's K_eff nearest instance boxes: (entry t, instance id),
    both (N, K_eff), nearest first, ties to the lower id; t is BIG for
    lanes with t_max <= 0 and for boxes the ray misses."""
    lo, hi = scene["inst_lo"], scene["inst_hi"]
    n_inst = lo.shape[0]
    k_eff = min(KI * ROUNDS, n_inst)
    chunk = max(1, CULL_ELEMS // n_inst)
    ts, ids = [], []
    for s in range(0, origin.shape[0], chunk):
        tn = _slab(origin[s:s + chunk], direction[s:s + chunk], lo, hi)
        tn = torch.where(t_max[s:s + chunk, None] > 0.0, tn, BIG)
        tn, idx = torch.sort(tn, dim=1, stable=True)
        ts.append(tn[:, :k_eff])
        ids.append(idx[:, :k_eff].to(torch.int32))
        del tn, idx
    return torch.cat(ts), torch.cat(ids)


def _to_object(inv, p, translate: bool):
    """Rows of p (M, 3) through the 3x4 world->object affines inv (M, 12),
    left to right with the translation last (the JAX expression order)."""
    rows = []
    for r in range(3):
        x = (inv[:, 4 * r] * p[:, 0] + inv[:, 4 * r + 1] * p[:, 1]
             + inv[:, 4 * r + 2] * p[:, 2])
        rows.append(x + inv[:, 4 * r + 3] if translate else x)
    return torch.stack(rows, dim=1)


def instanced_closest(scene, origin, direction, t_max, plain: bool = False):
    """Closest hit against the instanced geometry only.

    scene needs inst_obj (I,), inst_inv (I, 12), inst_lo / inst_hi (I, 3)
    and inst_objs, one dict a unique object: packed (nodes, tris_bw) and
    base (its first row in pk_attr_rows). origin, direction: (N, 3) f32;
    t_max: (N,) f32. plain walks with traverse.closest_hit_plain (the
    "twin" backend); otherwise traverse.closest_hit, which launches kernel
    1 on CUDA tensors. Returns (t, tri, u, v, inst): t BIG and tri -1 on
    a miss; tri in the combined id space; inst the hit instance (-1 for
    none), with which shading rotates object-space normals."""
    closest = traverse.closest_hit_plain if plain else traverse.closest_hit
    n = origin.shape[0]
    t_all, i_all = select_candidates(scene, origin, direction, t_max)
    k_eff = t_all.shape[1]

    tb = torch.full_like(t_max, BIG)
    ib = torch.full((n,), -1, dtype=torch.int32, device=t_max.device)
    ub = torch.zeros_like(t_max)
    vb = torch.zeros_like(t_max)
    nb = torch.full_like(ib, -1)
    for rr in range(ROUNDS):
        cols = [c for c in range(rr * KI, (rr + 1) * KI) if c < k_eff]
        if not cols:
            break
        kk = len(cols)
        t_p = t_all[:, cols].T.reshape(-1)          # lane k * N + i
        i_p = i_all[:, cols].T.reshape(-1)
        cap_p = torch.minimum(t_max, tb).repeat(kk)
        active = (t_p < cap_p) & (t_p < BIG)
        inst = torch.where(active, i_p, 0).long()
        inv = scene["inst_inv"][inst]               # (kk * N, 12)
        o_l = _to_object(inv, origin.repeat(kk, 1), True)
        d_l = _to_object(inv, direction.repeat(kk, 1), False)
        del inv, t_p
        obj_of = scene["inst_obj"][inst]
        del inst
        for oi, obj in enumerate(scene["inst_objs"]):
            tm_o = torch.where(active & (obj_of == oi), cap_p, 0.0)
            t2, tri2, u2, v2 = (x.reshape(kk, n) for x in closest(
                o_l, d_l, tm_o, obj["packed"]["nodes"],
                obj["packed"]["tris_bw"]))
            del tm_o
            for k in range(kk):
                hit2 = (tri2[k] >= 0) & (t2[k] < tb)
                tb = torch.where(hit2, t2[k], tb)
                ib = torch.where(hit2, tri2[k] + obj["base"], ib)
                ub = torch.where(hit2, u2[k], ub)
                vb = torch.where(hit2, v2[k], vb)
                nb = torch.where(hit2, i_all[:, cols[k]], nb)
            del t2, tri2, u2, v2
        del o_l, d_l, obj_of, active, cap_p, i_p
    return tb, ib, ub, vb, nb
